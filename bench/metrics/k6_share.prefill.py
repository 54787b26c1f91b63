"""``k6_share.prefill``: K6's device time over the traced window."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.K6_KERNEL)
    return 100.0 * s / trace.window_s if s > 0 else None
