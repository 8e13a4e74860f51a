"""Wrapper of the port's Keccak-f[1600] CUDA kernel; the counterpart of the
JAX package's ``ops/pallas_keccak.py``.

:func:`f1600` launches ``csrc/keccak_f1600.cu`` for CUDA tensors, or raises;
for CPU tensors it calls the plain version in
:mod:`quisquis_tpu_torch.ops.device_keccak`. Each launch adds one to
``LAUNCHES["keccak_f1600"]`` of :mod:`quisquis_tpu_torch.ops.cuda_build`.
"""

from __future__ import annotations

import torch

from . import device_keccak
from .cuda_build import check_tensor, launch


def f1600(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on uint8 states [..., 200]; returns a new tensor."""
    dev = state.device
    if dev.type == "cpu":
        return device_keccak.f1600_plain(state)
    if dev.type != "cuda":
        raise ValueError(f"f1600: unsupported device {dev}")
    check_tensor(state, "state", (None,) * (state.dim() - 1) + (200,), dev, torch.uint8)
    if state.data_ptr() % 8:
        raise ValueError("state: the kernel reads 64-bit words; storage must be 8-byte aligned")
    out = torch.empty_like(state)
    n = state.numel() // 200
    if n:
        launch("keccak_f1600", dev, state.data_ptr(), out.data_ptr(), n)
    return out
