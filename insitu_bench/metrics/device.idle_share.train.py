"""device.idle_share.train (%): the share of the profiled sub-window in
which no operation ran on the card, from the profiler's timeline."""


def read(raw):
    trace = raw.get("trace")
    if trace is None or not trace.window_s or "steps" not in raw:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
