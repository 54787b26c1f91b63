"""Production meshes and the card's constants.

The port of ``repro.launch.mesh``. Mesh axes:
  single-pod:  (16, 16)    ('data', 'model')
  multi-pod:   (2, 16, 16) ('pod', 'data', 'model')  — 512 devices

``make_production_mesh`` is a FUNCTION (not a module constant), so
importing this module initialises nothing: the mesh is built over the
default process group, which the dry run (``launch.dryrun``) first makes
the ``fake`` backend at world 256 or 512. One process holds one default
group, so the production meshes and a host mesh over real cards never
share a process. The training launcher builds JAX's ``(n, 1)``
``('data', 'model')`` mesh over its ranks with ``_mesh`` directly, as
JAX's calls ``jax.make_mesh``; ``make_host_mesh`` stays 1-D, as JAX's is.

The constants are the NVIDIA H100 SXM's (the card the port runs on, an
"NVIDIA H100 80GB HBM3" at its 700.00 W limit), each beside its source.
No link latency is given: one card has no link to time, and the data
sheet states none.
"""
from __future__ import annotations

from typing import Optional


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ('data', 'model'), or (2, 16, 16) with 'pod', over the
    default process group (its world size must be 256 or 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cuda", shape, axes)


def make_host_mesh(n: Optional[int] = None, *, axes=("data",)):
    """A 1-D ('data',) mesh over the real cards (the default group's
    world size, one rank a card)."""
    import torch
    import torch.distributed as dist
    if len(axes) != 1:
        raise ValueError("host mesh supports a single axis")
    n = n if n is not None else dist.get_world_size()
    return _mesh("cuda" if torch.cuda.is_available() else "cpu", (n,),
                 tuple(axes))


# The card's constants for the roofline (NVIDIA H100 SXM5 data sheet,
# dense rates; the port's PERF.md §3 uses the same).
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4 bytes/s per direction (900 GB/s
                                # bidirectional, 18 links)
SMEM_BYTES = 227 * 1024         # shared memory per block (opt-in maximum;
                                # the counterpart of a TPU core's VMEM)
HBM_BYTES = 80 * 10**9          # 80 GB (the data sheet's; chip_smoke
                                # prints the card's total_memory beside it)
