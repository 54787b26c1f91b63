"""``mla_roofline.prefill``: K6 at MLA's head dims (192, 128), its bound
over its device time, summed over every prompt run while tracing: per
layer the larger of its flops at the fp32 peak and q, k, v, out moved
once (``yardstick_moe``)."""
import yardstick_moe


def read(run, trace):
    s = trace.kernel_s(yardstick_moe.MLA_KERNEL)
    if s <= 0:
        return None
    bound = sum(run.model["n_layers"] * yardstick_moe.mla_bound_s(
        run.model, u["work"]) for u in run.units)
    return 100.0 * bound / s
