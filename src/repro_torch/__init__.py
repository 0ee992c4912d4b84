"""PyTorch/CUDA port of the Origami private-inference system.

Mirrors the module layout of the JAX package ``repro`` (the reference):
``repro_torch/core/slalom.py`` corresponds to ``repro/core/slalom.py``.
Public functions keep the reference layouts (NHWC images, HWIO conv
weights, ``(3, M, K)`` int8 limb planes). The TPU kernels of the serving
path are hand-written CUDA kernels for Hopper (``kernels/csrc``), built
with nvcc at first use; on a CPU tensor each kernel wrapper takes its
plain PyTorch version instead.
"""
