"""``mfu.moe_prefill``: active model FLOPs of the prompts completed in
the traced window (``yardstick_moe``: MLA, the dense layer, the router,
the shared and top-k routed experts, attention's causal pairs, the head
on the last position) a second of it, over the fp32 peak."""
import harness
import yardstick_moe


def read(run, trace):
    done = harness.window_units(run)
    if not done:
        return None
    flops = sum(yardstick_moe.prefill_flops(run.model, u["work"])
                for u in done)
    return 100.0 * flops / run.elapsed / yardstick_moe.PEAK_FP32_FLOPS
