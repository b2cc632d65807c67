"""steady_frames_per_s.serve: frames completed a second, over the traced
run's window before its profiled sub-window (tracing, and processing the
trace when it stops, slow the host). In a cell whose `frames_per_s` spreads
too widely from run to run to hold a bound end to end, it stands there as
the frame rate beside the cell's tail latency."""


def read(run, outcome):
    frames = outcome.observed.get("steady_frames")
    secs = outcome.observed.get("steady_seconds")
    return frames / secs if frames and secs else None
