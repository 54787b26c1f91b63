"""``exchange_dev_ms.ring``: mean stream ms of the program's
``ring.exchange`` span (the partitioned ring's encode, hops, gathers and
decode), on the rank where it is largest."""
import spans


def read(run, trace):
    return spans.worst(run, spans.mean_ms("ring.exchange"))
