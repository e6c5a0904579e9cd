"""Host-clock seconds from the process's start to the window's start: imports,
the CUDA context, the weights, the kernels' build (on a checkout's first run)
and the warm-up."""


def read(run):
    return run["setup_s"]
