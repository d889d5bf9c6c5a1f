"""kernels_per_batch: device kernel launches a batch, from the trace
(copies and fills are not counted)."""
from portbench.devtrace import is_copy


def read(run):
    if run.trace is None:
        return None
    n = run.trace.count(lambda name: not is_copy(name))
    return n / run.window.calls if n else None
