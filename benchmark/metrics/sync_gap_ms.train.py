"""Device ms a tick in the program's wait spans (``train.noise``: the
tick's noise drawn on the host and copied to the card): the card's idle
while it waits on that host work, until the host's next enqueue, and the
copies themselves."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.waits)
