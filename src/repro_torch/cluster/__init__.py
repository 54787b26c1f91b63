"""Virtual cluster engine: event-driven heterogeneous workers running
real async / local-SGD / decentralized training. The port of
``repro.cluster``: the scheduler, protocols and faults are numpy copies
(traces equal the JAX package's field for field); the aggregators and
the replay run on torch tensors, the codec on K1 + K4 on the card.

  scheduler.py  discrete-event loop over the §1.3 switch model; emits a
                Trace of (worker, version_pulled, version_applied,
                staleness, t_wall) per applied gradient plus the full
                per-message wire ledger (cross-checks eventsim).
  protocols.py  registry of protocol objects (sync_ps / async_ps /
                local_sgd / dsgd / dcd / ecd / laq), mirroring EXCHANGES.
  execute.py    replays a Trace against real training (quadratic or
                repro-100m LM) through the fused flat-codec gradient
                path -> loss-vs-simulated-wall-clock curves.
  faults.py     seeded deterministic fault injection (FaultPlan) +
                the fault ledger, quorum/timeout aggregation, and the
                live-set mixing-matrix re-derivation every protocol's
                graceful degradation builds on; the corruption class
                (bit-flips, NaN poison, Byzantine workers).
  aggregators.py  Byzantine-robust PS aggregation registry (mean /
                norm_clip / trimmed_mean / coordinate_median).
"""
from repro_torch.cluster.aggregators import AGGREGATORS, aggregator
from repro_torch.cluster.execute import (ClusterRunResult, Workload,
                                         lm_workload, quadratic_workload,
                                         replay)
from repro_torch.cluster.faults import (FaultLedger, FaultPlan,
                                        byzantine_workers, churn,
                                        corrupt_wire, crash_restart,
                                        live_mixing_matrix, lossy_network)
from repro_torch.cluster.faults import validate as validate_trace
from repro_torch.cluster.protocols import (PROTOCOLS, make_protocol,
                                           staleness_schedule)
from repro_torch.cluster.scheduler import (ClusterSpec, Trace, TraceEvent,
                                           straggler_multipliers)

__all__ = [
    "AGGREGATORS", "ClusterRunResult", "ClusterSpec", "FaultLedger",
    "FaultPlan", "PROTOCOLS", "Trace", "TraceEvent", "Workload",
    "aggregator", "byzantine_workers", "churn", "corrupt_wire",
    "crash_restart", "live_mixing_matrix", "lm_workload", "lossy_network",
    "make_protocol", "quadratic_workload", "replay", "staleness_schedule",
    "straggler_multipliers", "validate_trace",
]
