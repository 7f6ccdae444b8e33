"""Device ms a tick in the program's spans ``train.d_step``: both
critic updates, forward, gradient penalty, backward and Adam."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.named("train.d_step"))
