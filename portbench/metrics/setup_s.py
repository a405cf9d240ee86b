"""setup_s: from the start of the benchmark's process (the first line of
``portbench/run.py``) to the call of the first timed solve: imports, CUDA's
start, the kernels' build or load, the inputs and the warm-up."""


def read(run):
    return run.setup_s
