"""stream_mfu: the net's useful operations (Σ 2 · d_in · d_out an item)
times the items of the traced window, over its length, as a share of
the published dense peak of the route's tensor-core precision, in %."""
from portbench import roofline


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    rate = (roofline.net_ops_per_item(run.config["dims"]) *
            run.window.items / run.trace.window_s)
    return 100.0 * rate / roofline.PEAKS[run.config["roofline"]["peak"]]
