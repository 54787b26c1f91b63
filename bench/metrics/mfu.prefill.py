"""``mfu.prefill``: model FLOPs of the prompts completed in the traced
window (layers, attention's causal pairs, the head on the last position)
a second of it, over the fp32 peak (``yardstick``)."""
import harness
import yardstick


def read(run, trace):
    done = harness.window_units(run)
    if not done:
        return None
    flops = sum(yardstick.prefill_flops(run.model, u["work"]) for u in done)
    return 100.0 * flops / run.elapsed / yardstick.PEAK_FP32_FLOPS
