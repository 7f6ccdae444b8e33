"""% of the bf16 peak: a tick's products (the layer table) times the
ticks of the window, over the window's host-clock seconds."""

from benchmark.common import readers


def read(run):
    return readers.mfu(run)
