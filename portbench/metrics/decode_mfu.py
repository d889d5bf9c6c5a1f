"""decode_mfu: a decode step's useful operations
(``roofline_lm.step_ops``: the grid products with the held experts' rows
from the ``lm.expert_assignments`` counter, the head, the attention over
the window's mean cached length) a second of the traced window, as a
share of the TF32 dense peak, in %."""
from portbench import roofline, roofline_lm


def read(run):
    n = getattr(run.window, "readings", {}).get("lm.expert_assignments")
    if run.trace is None or n is None or run.trace.window_s <= 0:
        return None
    ops = roofline_lm.step_ops(run.config, run.window.lanes, n,
                               run.window.mean_kv)
    rate = ops * run.window.calls / run.trace.window_s
    return 100.0 * rate / roofline.PEAKS[run.config["roofline"]["peak"]]
