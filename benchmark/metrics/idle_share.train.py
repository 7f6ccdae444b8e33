"""% of the traced stretch in which no operation ran on the card."""

from benchmark.common import readers


def read(run):
    return readers.idle_share(run)
