"""Device ms a tick in the program's spans ``train.adam`` (each
network's Adam update) and ``train.ema`` (the generator's EMA)."""

from benchmark.common import program_spans


def read(run):
    return program_spans.device_ms(
        run, program_spans.named("train.adam", "train.ema"))
