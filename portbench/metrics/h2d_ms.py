"""h2d_ms: device time of host-to-device copies a batch, from the trace."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.seconds(lambda name: name.startswith("Memcpy HtoD"))
    return s / run.window.calls * 1e3 if s > 0 else None
