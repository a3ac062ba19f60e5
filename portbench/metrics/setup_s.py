"""setup_s: seconds from the process's start to the window's opening
(loading, the kernels' build where the checkout has none yet, the weights,
the engine's graph captures, the warm-up)."""


def read(run):
    return run["setup_s"]
