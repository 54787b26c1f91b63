"""The port's one ``nvcc`` builder: each CUDA source under ``csrc/`` is
compiled for ``sm_90a`` into its own shared library with a plain C
interface under ``build/repro_torch/`` in the checkout, at first use
(rebuilt when the source or a header beside it is newer), and bound
with ctypes by its wrapper module. Importing this module needs no
compiler and no card.

``build_many`` starts one ``nvcc`` per source, all together, and waits
for them all: ``chip_smoke.py`` builds every library that way.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the "
                           "port's CUDA kernels cannot be built")
    return found


def _fresh(source: Path, library: Path) -> bool:
    """The library is newer than its source and every header beside it."""
    if not library.exists():
        return False
    built = library.stat().st_mtime
    return all(built >= f.stat().st_mtime
               for f in [source, *source.parent.glob("*.cuh")])


def build_many(pairs, *, force: bool = False) -> list:
    """Compile each (source, library) pair that has no up-to-date build,
    one ``nvcc`` process per source, all started together. Returns the
    library paths; raises with the compiler's output if any build
    failed."""
    pairs = [(Path(s), Path(lib)) for s, lib in pairs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source, library in pairs:
        if not force and _fresh(source, library):
            continue
        tmp = library.with_name(f".{library.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((cmd, proc, tmp, library))
    errors = []
    for cmd, proc, tmp, library in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, library)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library for _, library in pairs]


def build(source: Path, library: Path, *, force: bool = False) -> Path:
    """Compile one source into its library unless it is up to date."""
    return build_many([(source, library)], force=force)[0]
