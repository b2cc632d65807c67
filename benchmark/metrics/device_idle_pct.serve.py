"""device_idle_pct.serve: the share of the traced sub-window in which no
operation ran on the device. It is read under `torch.profiler`, which slows
the host's side of serving (the traced seconds serve about half the frames
of untraced ones), so it is the idle share of a host so slowed: higher than
an untraced run's."""


def read(run, outcome):
    t = outcome.trace
    if t is None or t.window_s <= 0 or t.device_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
