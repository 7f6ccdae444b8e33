"""% of the up-block's least time a tick (forward, dx and dw, counted
from the layer table's four-tap form) over the device time of the
program's spans ``kernels.upconv3x3``, ``kernels.upconv3x3_dx`` and
``kernels.upconv3x3_dw``: keyed by the wrappers, not by kernel names."""

from benchmark.common import program_spans


def read(run):
    return program_spans.roofline(run, "upconv3x3")
