"""Parallelism of the port: counterpart of ``vfidkr_tpu/parallel``.

``spatial``: row sharding of a frame over devices (or over threads of one
card) with halo exchange, for frames too large for one card.  ``mesh``:
data-parallel training over ranks started by ``torchrun``.
"""
