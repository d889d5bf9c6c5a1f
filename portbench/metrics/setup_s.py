"""setup_s: from the start of the process to the first timed batch:
imports, the card's start, weights, compile and programming, the inputs,
the kernels' build where the checkout has none yet, and the warm-up."""


def read(run):
    return run.setup_s
