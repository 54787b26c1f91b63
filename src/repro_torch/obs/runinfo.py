"""Run identity: every emitted artifact (BENCH_*.json rows, exported
timelines, flight-recorder dumps) carries the same ``run_id`` — the git
SHA of the working tree plus the seed — and a ``schema_version``, so
benches, traces, and dumps from one run cross-reference exactly.

``stamp_rows`` is what a benchmark writer calls right before
``json.dump``; both fields are identity, not measurement.
"""
from __future__ import annotations

import functools
import subprocess

# bump when the shape of BENCH rows / flight dumps / timeline args
# changes incompatibly
SCHEMA_VERSION = 2


@functools.lru_cache(maxsize=1)
def git_sha(short: bool = True) -> str:
    """Current git SHA (short by default); 'nogit' outside a checkout."""
    cmd = ["git", "rev-parse"] + (["--short"] if short else []) + ["HEAD"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=5, check=False)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "nogit"
    except (OSError, subprocess.TimeoutExpired):
        return "nogit"


def run_id(seed: int = 0) -> str:
    return f"{git_sha()}-s{seed}"


def stamp_rows(rows: list, *, seed: int = 0) -> list:
    """Add run_id + schema_version to every row dict, in place."""
    rid = run_id(seed)
    for row in rows:
        row["run_id"] = rid
        row["schema_version"] = SCHEMA_VERSION
    return rows
