"""Device ms a tick of the kernels launched inside the benchmark's span
around the resident tier's batch draw and gather (``step.batch_at``)."""

from benchmark.common import readers


def read(run):
    return readers.span_ms(run, "data")
