"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in a ``launches`` attribute (a plain integer), so a run can show that its
path went through the kernel, and runs inside a span ``kernels.<op>``
(``utils/profiling.spanned``: live only under a profiler; the plain version
on the CPU too), so a trace names the op's launches by its wrapper.
"""
