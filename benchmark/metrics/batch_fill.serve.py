"""batch_fill.serve: frames a forward, the mean over the frames served in the
traced run's window before its profiled sub-window of the `batch_size` the
serving engine returns with each (`cli/serve`)."""


def read(run, outcome):
    sizes = outcome.observed.get("batch_sizes")
    return sum(sizes) / len(sizes) if sizes else None
