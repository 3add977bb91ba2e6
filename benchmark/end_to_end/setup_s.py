"""From process start to the first timed request, s: imports, the CUDA
context, kernel builds or loads, inputs, and one warm request a ring slot."""


def read(run):
    return run.setup_s
