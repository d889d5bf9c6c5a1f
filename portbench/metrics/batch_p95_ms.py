"""batch_p95_ms: the 95th percentile (nearest rank) of every batch's
time in the window, from the call that hands the batch over to its
outputs in host memory (host clock). Only host-handover mixes time
batches one by one."""
import math


def read(run):
    lat = sorted(run.window.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
