"""ditsep_tpu_torch: the DiffSep separation system in PyTorch for NVIDIA Hopper.

A port of ``ditsep_tpu`` (the JAX package, kept as the reference) that
mirrors its module paths. Plain tensor code is PyTorch; the TPU's Pallas
kernels become hand-written CUDA kernels under ``csrc/``, built with nvcc
at first use (see ``ops/cuda_kernels.py``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` / ``--cpu``). Importing the package changes no global
torch setting.
"""
