"""% of the up-block's least time a tick (forward, dx and dw, counted
from the layer table's four-tap form) over its kernels' device time."""

from benchmark.common import readers


def read(run):
    return readers.roofline(run, "upconv3x3")
