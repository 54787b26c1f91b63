"""``sendrecv_ms.ring``: stream ms a ring exchange spends in the
program's ``comm.sendrecv`` spans (each hop's and gather's one batch of
NCCL sends and receives and its wait: the wire and the wait for the
neighbour), on the rank where it is largest."""
import spans


def read(run, trace):
    wire = spans.stats("comm.sendrecv", under="ring.exchange")
    ex = spans.stats("ring.exchange")
    mine = 1e3 * wire.stream_s / ex.count if wire and ex else None
    return spans.worst(run, mine)
