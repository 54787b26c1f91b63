"""``device_idle.prefill``: share of the traced window in which no kernel,
copy or set ran on the card."""


def read(run, trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
