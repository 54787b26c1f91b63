"""``k6_roofline.prefill``: K6's bound over its device time, summed over
every prompt run while tracing: per layer the larger of its forward
flops at the fp32 peak and q, k, v, o moved once (``yardstick``)."""
import yardstick


def read(run, trace):
    s = trace.kernel_s(yardstick.K6_KERNEL)
    if s <= 0:
        return None
    bound = sum(run.model["n_layers"] * yardstick.k6_bound_s(run.model,
                                                             u["work"])
                for u in run.units)
    return 100.0 * bound / s
