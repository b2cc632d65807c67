"""mfu_pct.serve: the model's FLOPs of the frames served (`flops_per_frame`
of the configuration, counted from the plain reference) over the seconds
they took, times one H100's dense bf16 peak; read in the traced run's window
before its profiled sub-window (tracing, and processing the trace when it
stops, slow the host)."""

from benchmark.lib.peaks import H100_BF16_FLOPS


def read(run, outcome):
    frames = outcome.observed.get("steady_frames")
    secs = outcome.observed.get("steady_seconds")
    if not frames or not secs:
        return None
    return 100.0 * frames * outcome.observed["flops_per_frame"] / (secs * H100_BF16_FLOPS)
