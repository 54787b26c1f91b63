"""``codec_ms.train``: device ms a training step in the codec's kernels,
K1 (``minmax_kernel``) and K4 (``qdq_kernel``), by name."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.K1_KERNEL) + \
        trace.kernel_s(yardstick.K4_KERNEL)
    return 1e3 * s / len(run.units) if s > 0 else None
