"""``wire_bytes.ring``: bytes a rank sends a step, from the worker axis's
own count (``RankAxis.sent_bytes``) over the window's steps."""


def read(run, trace):
    sent = run.state["axis"].sent_bytes - run.state["sent0"]
    return sent / len(run.units) if sent > 0 else None
