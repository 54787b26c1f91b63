"""Export a cluster trace as a Perfetto-loadable timeline.

    PYTHONPATH=src python -m repro_torch.obs.export trace --out timeline.json

schedules the demo scenario — sync-PS with a first-6-of-8 quorum under
10% message drop plus one mid-run crash/restart — cross-validates its
fault ledger (``faults.validate``), renders the wire + fault ledgers as
per-worker tracks (``trace.timeline_from_trace``), **verifies the
rendered event counts against the ledgers exactly**
(``verify_timeline``), and writes Chrome trace JSON openable at
https://ui.perfetto.dev.

Flags pick protocol / rounds / fault mix; ``--protocol async_ps`` runs
the free-running loop instead (``--rounds`` then sets the sync-makespan
horizon). ``--metrics-out`` additionally snapshots the metrics registry
the scheduling pass filled.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.obs import metrics, runinfo, state
from repro_torch.obs import trace as obs_trace


def demo_plan(n: int, *, p_drop: float, crash: bool, makespan_hint: float,
              seed: int):
    from repro_torch.cluster import faults

    # the hint is the HEALTHY sync makespan (gated on the 4x straggler);
    # the faulty quorum run cuts the straggler and finishes in roughly
    # half that, so the restart must land well before 0.5*hint for the
    # rejoin/checkpoint-pull to appear inside the run
    crashes = ((1, 0.15 * makespan_hint, 0.3 * makespan_hint),) if crash \
        else ()
    return faults.FaultPlan(n, seed=seed, p_drop=p_drop, crashes=crashes)


def build_trace(*, protocol: str = "sync_ps", n: int = 8, rounds: int = 8,
                p_drop: float = 0.1, crash: bool = True,
                quorum: Optional[int] = 6, seed: int = 0):
    """Schedule the faulty demo scenario and return its Trace."""
    from repro_torch import cluster

    spec = cluster.ClusterSpec(
        n_workers=n, t_compute=1.0,
        multipliers=cluster.straggler_multipliers(n, factor=4.0),
        t_lat=1e-2, t_tr=2e-3, size_mb=1.0, codec="rq4", seed=seed)
    healthy = cluster.make_protocol("sync_ps").schedule(spec, rounds=rounds)
    plan = demo_plan(n, p_drop=p_drop, crash=crash,
                     makespan_hint=healthy.makespan, seed=seed)
    kw = {"quorum": quorum} if protocol in ("sync_ps", "local_sgd",
                                            "laq") else {}
    proto = cluster.make_protocol(protocol, **kw)
    if protocol == "async_ps":
        return proto.schedule(spec, horizon=healthy.makespan, plan=plan)
    return proto.schedule(spec, rounds=rounds, plan=plan)


def expected_counts(cluster_trace) -> dict:
    """Event counts the timeline must reproduce, from the ledgers alone."""
    led = cluster_trace.faults
    n_fault_instants = 0
    n_quorum_spans = 0
    if led is not None:
        n_fault_instants = (len(led.drops) + len(led.retries)
                            + len(led.duplicates) + len(led.corrupt)
                            + len(led.shortfalls) + len(led.epochs)
                            + len(led.rejoins) + len(led.lost_compute))
        n_quorum_spans = len(led.timeouts)
    by_status = {"ok": 0, "lost": 0, "dup": 0, "corrupted": 0}
    for d in cluster_trace.comm:
        by_status[getattr(d, "status", "ok")] += 1
    return {"wire_spans": len(cluster_trace.comm),
            "wire_by_status": by_status,
            "event_instants": len(cluster_trace.events),
            "fault_instants": n_fault_instants,
            "quorum_spans": n_quorum_spans}


def timeline_counts(events: list) -> dict:
    """The same tally, read back from exported traceEvents."""
    cats = [(e.get("cat", ""), e.get("ph")) for e in events]
    by_status = {"ok": 0, "lost": 0, "dup": 0, "corrupted": 0}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") == "X" and cat.startswith("wire,"):
            by_status[cat.rsplit(",", 1)[1]] += 1
    return {
        "wire_spans": sum(1 for c, ph in cats
                          if ph == "X" and c.startswith("wire,")),
        "wire_by_status": by_status,
        "event_instants": sum(1 for c, ph in cats
                              if ph == "i" and c.startswith("event,")),
        "fault_instants": sum(1 for c, ph in cats
                              if ph == "i" and c.startswith("fault,")),
        "quorum_spans": sum(1 for c, ph in cats
                            if ph == "X" and c.startswith("fault,quorum")),
    }


def verify_timeline(cluster_trace, tracer: obs_trace.Tracer) -> dict:
    """Assert the rendered timeline and the scheduler's ledgers agree
    event for event (the export-side twin of ``faults.validate``)."""
    want = expected_counts(cluster_trace)
    got = timeline_counts(tracer.events())
    assert got == want, f"timeline/ledger mismatch: {got} != {want}"
    # the ok+lost+dup+corrupted == comm partition, per faults.validate
    assert sum(want["wire_by_status"].values()) == len(cluster_trace.comm)
    return want


def export_trace(cluster_trace, out_path: str, *,
                 into: Optional[obs_trace.Tracer] = None,
                 seed: int = 0) -> dict:
    """Render, verify, and write one cluster trace; returns the tally."""
    tracer = obs_trace.timeline_from_trace(cluster_trace, into=into)
    counts = verify_timeline(cluster_trace, tracer)
    doc = tracer.to_chrome_trace()
    doc["metadata"] = {"run_id": runinfo.run_id(seed),
                       "schema_version": runinfo.SCHEMA_VERSION,
                       "protocol": cluster_trace.protocol,
                       "n_workers": cluster_trace.n_workers,
                       "makespan_s": cluster_trace.makespan,
                       "counts": counts}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd")
    tp = sub.add_parser("trace", help="export a faulty cluster timeline")
    tp.add_argument("--protocol", default="sync_ps",
                    choices=["sync_ps", "async_ps", "local_sgd", "laq",
                             "dsgd"])
    tp.add_argument("--n", type=int, default=8)
    tp.add_argument("--rounds", type=int, default=8)
    tp.add_argument("--drop", type=float, default=0.1,
                    help="per-message drop probability")
    tp.add_argument("--no-crash", action="store_true",
                    help="disable the mid-run crash/restart window")
    tp.add_argument("--quorum", type=int, default=6,
                    help="backup-worker quorum for PS rounds (0: full "
                         "barrier)")
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--out", default="timeline.json")
    tp.add_argument("--metrics-out", default=None,
                    help="also snapshot the metrics registry to this path")
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2

    from repro_torch.cluster import faults

    # live tracing during scheduling captures the compute spans the
    # ledgers alone cannot reconstruct; metrics ride along for free
    state.enable(trace=True, metrics=True, flight=True)
    live = obs_trace.tracer()
    live.reset()
    tr = build_trace(protocol=args.protocol, n=args.n, rounds=args.rounds,
                     p_drop=args.drop, crash=not args.no_crash,
                     quorum=args.quorum or None, seed=args.seed)
    tally = faults.validate(tr)
    counts = export_trace(tr, args.out, into=live, seed=args.seed)
    if args.metrics_out:
        metrics.registry().write(args.metrics_out)
        print(f"# wrote {args.metrics_out}")
    print(f"# {tr.protocol}: {tr.n_workers} workers, "
          f"makespan {tr.makespan:.2f}s simulated")
    print(f"# wire ledger: {tally['attempted']} attempted = "
          f"{tally['delivered']} ok + {tally['dropped']} lost + "
          f"{tally['duplicated']} dup | retries {tally['retried']}, "
          f"timeouts {tally['timed_out']}, rejoins {tally['rejoins']}")
    print(f"# timeline: {counts['wire_spans']} wire spans "
          f"{counts['wire_by_status']}, {counts['event_instants']} event "
          f"+ {counts['fault_instants']} fault instants, "
          f"{counts['quorum_spans']} quorum-wait spans — counts verified "
          "against the ledgers")
    print(f"# wrote {args.out} (open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
