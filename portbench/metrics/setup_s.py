"""``setup_s``: from the start of ``run.py``, before torch loads, to the
window's start: imports, the card's start, the data made on the card, the
plain inputs, the program built and every shape warmed up (and, in a
checkout's first run, the kernels' nvcc build)."""


def read(run):
    return run.setup_s
