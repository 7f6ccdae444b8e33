"""Device ms a tick in the program's span ``data.draw``: the resident
tier's draw and gather of the tick's batch (``data/device.py``)."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.named("data.draw"))
