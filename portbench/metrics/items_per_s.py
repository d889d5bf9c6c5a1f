"""items_per_s: items whose outputs the window completed, over the
window's whole time (host clock; the window ends in a synchronize)."""


def read(run):
    return run.window.items / run.window.seconds
