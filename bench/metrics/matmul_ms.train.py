"""``matmul_ms.train``: device ms a training step in GEMM kernels (by
the profiler's kernel names), over the steps run while tracing."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.GEMM_KERNELS)
    return 1e3 * s / len(run.units) if s > 0 else None
