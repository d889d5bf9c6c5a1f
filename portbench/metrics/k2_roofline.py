"""k2_roofline: the stream layers' roofline bound (``roofline.py``) over
K2's device time, a batch, summed over the layers, in %."""
from portbench import roofline

KERNEL = "int8_matmul_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(lambda name: KERNEL in name) / run.window.calls
    if t <= 0:
        return None
    return 100.0 * roofline.stream_bound(run.config, run.batch)[0] / t
