"""Process start to the window's first timed request: imports, CUDA
start-up, the model's parse and weights, the engine's profiling and
bucket warm-up, kernel builds where none are cached, and the loop's
warm-up."""


def read(run):
    return run.setup_s
