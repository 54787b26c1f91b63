"""``mfu.train``: model FLOPs of the training steps completed in the
traced window a second of it, over the fp32 peak (``yardstick``)."""
import harness
import yardstick


def read(run, trace):
    t = run.traffic
    steps = len(harness.window_units(run))
    if not steps:
        return None
    flops = steps * yardstick.train_step_flops(run.model, t["batch"],
                                               t["seq"])
    return 100.0 * flops / run.elapsed / yardstick.PEAK_FP32_FLOPS
