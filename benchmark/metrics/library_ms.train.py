"""Device ms a tick in cuBLAS and cuDNN kernels (the library
convolutions and matrix products of ``ops/layers.py`` and the models)."""

from benchmark.common import kernels, readers


def read(run):
    return readers.device_ms(run, kernels.LIBRARY)
