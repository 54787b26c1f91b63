"""``device_idle.ring``: the largest share, over the ranks' cards, of the
traced window in which no kernel, copy or set ran on the card."""


def read(run, trace):
    idle = run.gather(1.0 - trace.busy_s / trace.window_s)
    return 100.0 * max(idle)
