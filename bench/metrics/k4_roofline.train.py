"""``k4_roofline.train``: K4's byte bound over its device time, a step:
the flat gradient message of every parameter read and written once and
its buckets' (lo, scale) read once, at the HBM rate (``yardstick``)."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.K4_KERNEL) / len(run.units)
    if s <= 0:
        return None
    bound = yardstick.k4_bytes(yardstick.param_count(run.model)) / \
        yardstick.HBM_BYTES_PER_S
    return 100.0 * bound / s
