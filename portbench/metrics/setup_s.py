"""End to end: process start to the first timed step (host clock): imports
and CUDA start-up, the kernels built or loaded, weights and scans from the
seed, the int8 calibration, and one step of every kind the window runs."""


def read(ctx):
    return ctx["setup_s"]
