"""PyTorch/CUDA port of ``vfidkr_tpu`` for NVIDIA Hopper (H100).

Tensors are NCHW throughout.  Flow channel 0 is ``fx`` and channel 1 is
``fy``; the 4x4 filter channel index is ``dj * 4 + di`` (row-major window
position).  The ops in ``vfidkr_torch.ops`` launch hand-written sm_90a CUDA
kernels (``vfidkr_torch/csrc``) on CUDA tensors and run their plain PyTorch
versions on CPU tensors.

This package imports torch and numpy only; the JAX package ``vfidkr_tpu`` is
the reference it is tested against.
"""
