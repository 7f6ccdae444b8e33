"""The program's counter ``train.host_waits`` a tick: the tick's copies
from pageable host memory (the noise), calls that CUDA may make wait for
the card."""

from benchmark.common import program_spans


def read(run):
    return program_spans.count(run, "train.host_waits")
