"""forward_fetch_ms.serve: the serving engine's own host clock around its
graph replay and fetch (`batch_seconds`), ms, the mean over the frames
served in the traced run's window before its profiled sub-window."""


def read(run, outcome):
    secs = outcome.observed.get("batch_seconds")
    return 1e3 * sum(secs) / len(secs) if secs else None
