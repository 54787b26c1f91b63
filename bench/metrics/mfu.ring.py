"""``mfu.ring``: model FLOPs of the global batch's steps completed in the
traced window a second of it, over the fp32 peak of all the cards."""
import harness
import yardstick


def read(run, trace):
    t = run.traffic
    steps = len(harness.window_units(run))
    if not steps:
        return None
    flops = steps * yardstick.train_step_flops(run.model, t["batch"],
                                               t["seq"])
    return 100.0 * flops / run.elapsed / (run.world *
                                          yardstick.PEAK_FP32_FLOPS)
