"""Seconds from the process's start to the first timed call: imports, the
CUDA context, loading (or, in a checkout's first run, building) the
kernels, making the inputs and the warm-up."""


def read(run):
    return run.setup_s
