"""``mixer_share.prefill``: the stream time of the program's
``block.mixer`` spans inside ``prefill.step`` (each layer's norm, QKV,
RoPE, K6, output projection and residual) over that of ``prefill.step``,
summed over the prompts the traced window ran."""
import spans


def read(run, trace):
    mixer = spans.stats("block.mixer", under="prefill.step")
    step = spans.stats("prefill.step")
    if mixer is None or step is None or step.stream_s <= 0:
        return None
    return 100.0 * mixer.stream_s / step.stream_s
