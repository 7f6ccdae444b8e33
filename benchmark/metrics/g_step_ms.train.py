"""Device ms a tick in the program's span ``train.g_step``: the
generator's update, forward through the critic, backward and Adam."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.named("train.g_step"))
