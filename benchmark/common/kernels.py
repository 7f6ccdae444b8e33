"""Device operations of a profile grouped by family, by name.

A frozen copy of the program's ``tools/ticks.kernel_family`` (the kernel
names of ``csrc/`` and of the libraries), so that the benchmark's grouping
does not move with the program; memory copies and fills, which the
program's table never saw, get families of their own.  A kernel renamed by
a later change falls into "other torch elementwise", and the reader of its
roofline then finds nothing to read.
"""

from __future__ import annotations

_FAMILIES = (
    (("deconv5x5_s2", "namespace)::deconv", "namespace)::thin::"),
     "deconv5x5_s2 (CUDA)"),
    (("namespace)::cdw",), "conv5x5_s2_dw (CUDA)"),
    (("cdxring", "namespace)::cdxp::"), "conv5x5_s2_dx (CUDA)"),
    (("ddxring", "ddxthin"), "deconv5x5_s2_dx (CUDA)"),
    (("namespace)::upconvdx", "namespace)::dx_", "namespace)::dw_",
      "dx90::"), "upconv3x3 backward (CUDA)"),
    (("namespace)::upconv", "combine_kernel", "up32::"), "upconv3x3 (CUDA)"),
    (("namespace)::conv", "down0_mma_kernel", "down0::kernel"),
     "conv5x5_s2_act (CUDA)"),
    (("namespace)::join", "join_text_kernel"), "conditioning_join (CUDA)"),
    (("bn_stats_kernel", "bn_apply_kernel", "bn_reduce_kernel",
      "bn_dx_kernel"), "batch norm (CUDA)"),
    (("gemm", "gemv"), "matmul (cuBLAS)"),
    (("conv", "cudnn", "dgrad", "wgrad", "xmma"), "conv backward (cuDNN)"),
    (("multi_tensor_apply", "foreach"), "Adam and EMA (foreach)"),
    (("reduce",), "reductions (BN statistics, grad sums)"),
    (("copy", "cat"), "casts, copies, concatenation"),
    (("fill",), "fills (zeros)"))

# the library's convolutions and matrix products ("conv backward (cuDNN)"
# holds cuDNN's forward kernels too: the frozen table names it so)
LIBRARY = ("matmul (cuBLAS)", "conv backward (cuDNN)")

# the kernel families of an op and of its gradients
OP_FAMILIES = {
    "upconv3x3": ("upconv3x3 (CUDA)", "upconv3x3 backward (CUDA)"),
    # in the StackGAN discriminator the transposed conv runs only as the
    # RGB layer's dx
    "conv5x5_s2": ("conv5x5_s2_act (CUDA)", "conv5x5_s2_dx (CUDA)",
                   "conv5x5_s2_dw (CUDA)", "deconv5x5_s2 (CUDA)"),
}


def kernel_family(name: str) -> str:
    low = name.lower()
    for keys, fam in _FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other torch elementwise"


def family(cat: str, name: str) -> str:
    """The family of a device event of a Chrome trace: its category
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``) and name."""
    if cat == "gpu_memcpy":
        words = name.split()       # "Memcpy DtoH (Device -> Pageable)"
        return f"memcpy {words[1]}" if len(words) > 1 else "memcpy"
    if cat == "gpu_memset":
        return "memset"
    return kernel_family(name)
