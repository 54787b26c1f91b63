"""``dispatch_share.prefill``: the stream time of the program's
``moe.route`` (router, top-k, sort, gather) and ``moe.combine`` (rows put
back, gate-weighted sum) spans inside ``prefill.step`` over that of
``prefill.step``."""
import spans


def read(run, trace):
    route = spans.stats("moe.route", under="prefill.step")
    combine = spans.stats("moe.combine", under="prefill.step")
    step = spans.stats("prefill.step")
    if route is None or combine is None or step is None \
            or step.stream_s <= 0:
        return None
    return 100.0 * (route.stream_s + combine.stream_s) / step.stream_s
