"""k1_roofline.lm: a decode step's grid products' bound
(``roofline_lm.step_bound``, with the held experts' rows from the
``lm.expert_assignments`` counter) over K1's device time a step, in %."""
from portbench import roofline_lm

KERNEL = "crossbar_mvm_kernel"


def read(run):
    n = getattr(run.window, "readings", {}).get("lm.expert_assignments")
    if run.trace is None or n is None:
        return None
    t = run.trace.seconds(lambda name: KERNEL in name) / run.window.calls
    if t <= 0:
        return None
    return 100.0 * roofline_lm.step_bound(run.config, run.window.lanes,
                                          n) / t
