"""The device's idle share of the traced window: 1 - device-busy seconds
(every device operation's interval, merged) / the window's seconds."""


def read(run):
    if run.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
