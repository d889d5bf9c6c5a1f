"""glue_ms: device time a batch of the kernels other than K1 and K2
(pads, the Fig. 11 combiner, bias, activations, quantisation, casts),
from the trace. Copies are not kernels."""
from portbench.devtrace import is_copy

# K1 (crossbar_mvm.cu) and K2 (int8_matmul.cu), by their kernels' names
KERNELS = ("crossbar_mvm_kernel", "int8_matmul_kernel")


def read(run):
    if run.trace is None:
        return None
    if run.trace.count(lambda name: not is_copy(name)) == 0:
        return None
    s = run.trace.seconds(lambda name: not is_copy(name) and
                          not any(k in name for k in KERNELS))
    return s / run.window.calls * 1e3
