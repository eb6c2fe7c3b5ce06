"""The device: the share of the traced window in which no operation ran
on the card, in percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.window_s > 0 else None
