"""Device: share of the traced window in which no kernel, copy or set ran
on the card."""


def read(tr):
    if not tr.window_s or not tr.busy_s:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
