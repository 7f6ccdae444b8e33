"""PyTorch + CUDA port of ``text_to_image_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports neither it nor JAX.
Public functions keep the JAX package's layouts (NHWC activations, HWIO
conv weights, ``[in, out]`` linear weights), so the two compare like with
like.  Every kernel the JAX package wrote in Pallas is a hand-written
Hopper kernel here (``ops/kernels``), with its plain PyTorch version beside
it: a CUDA tensor always takes the kernel, a CPU tensor the plain version.
"""
