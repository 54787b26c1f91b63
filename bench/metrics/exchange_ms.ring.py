"""``exchange_ms.ring``: the mean host ms of a step's
``CSGDRingExchange`` call on rank 0, between synchronizes (traced runs
only)."""


def read(run, trace):
    xs = run.state.get("exchange_s") or []
    return 1e3 * sum(xs) / len(xs) if xs else None
