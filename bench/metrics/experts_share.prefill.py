"""``experts_share.prefill``: the stream time of the program's
``moe.experts`` spans (the routed experts' GEMMs) inside ``prefill.step``
over that of ``prefill.step``, over the prompts the traced window ran."""
import spans


def read(run, trace):
    experts = spans.stats("moe.experts", under="prefill.step")
    step = spans.stats("prefill.step")
    if experts is None or step is None or step.stream_s <= 0:
        return None
    return 100.0 * experts.stream_s / step.stream_s
