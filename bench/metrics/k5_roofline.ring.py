"""``k5_roofline.ring``: K5's byte bound over its device time on rank 0,
a step: N - 1 hops, each the incoming partition message and the rank's
fp32 slice read once and the outgoing message written once."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.K5_KERNEL) / len(run.units)
    if s <= 0:
        return None
    n = run.world
    hop = yardstick.k5_hop_bytes(yardstick.param_count(run.model), n)
    return 100.0 * (n - 1) * hop / yardstick.HBM_BYTES_PER_S / s
