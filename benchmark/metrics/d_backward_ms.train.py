"""Device ms a tick in the program's spans ``train.d_step.backward``:
the critic's backward with the gradient penalty's double backward."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(
        run, program_spans.named("train.d_step.backward"))
