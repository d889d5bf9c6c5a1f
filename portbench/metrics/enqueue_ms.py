"""enqueue_ms: host time of one stream call while the card still works
on the calls before it: the median of five bursts of 16 calls from a
drained card, each burst timed whole (host clock). Only a mix whose
calls are dispatched ahead has it."""
import statistics


def read(run):
    if not run.enqueue:
        return None
    return statistics.median(run.enqueue) * 1e3
