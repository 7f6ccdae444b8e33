"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in a ``launches`` attribute (a plain integer), so a run can show that its
path went through the kernel.
"""
