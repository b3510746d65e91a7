"""Seconds from the process's start (the first line of ``run.py``) to the
first timed batch: imports, the kernels' build or load, weights and inputs
made from the seed, the program built and this cell's shapes warmed
(compiles included)."""


def read(run):
    return run.setup_s
