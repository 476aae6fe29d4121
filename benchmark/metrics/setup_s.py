"""Set-up: from the start of the harness's process (torch's import, the
CUDA context, the inputs made from the seed, the kernels' build where it
is not on disk) through one whole warm-up job of the cell's traffic, to
the window's start."""

NAME = "setup_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
