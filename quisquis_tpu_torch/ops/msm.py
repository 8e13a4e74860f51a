"""Multiscalar multiplication: sum_i s_i * P_i over batched points.

    sum_i s_i P_i = sum_w 16^w T_w,   T_w = sum_i digit[i, w] * P_i.

Three stages, each a CUDA kernel (``csrc/msm_table.cu``, ``csrc/msm_acc.cu``,
``csrc/msm_tail.cu``) with its plain PyTorch version in
:mod:`quisquis_tpu_torch.ops.msm_plain`, re-exported here:
:func:`msm_table`, :func:`msm_window_sums`, :func:`msm_tail`.

:func:`msm`, :func:`msm_rows` and :func:`pad_rows` are those of
:mod:`quisquis_tpu_torch.ops.cuda_point`, which pads the rows and runs the
three stages' wrappers: the kernels for CUDA tensors, the plain versions
for CPU tensors, at every size (the JAX package's size thresholds were
measured on a TPU and are not carried over). Imports go one way:
this module -> ``cuda_point`` -> ``msm_plain``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import exact as ex
from . import point as pt
from .cuda_point import msm, msm_rows, pad_rows  # noqa: F401  (callers take them from here)
from .msm_plain import (MSM_LANES, msm_slices, msm_table, msm_tail,  # noqa: F401  (plain versions)
                        msm_window_sums, select)


def msm_shared_base(nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """Batched MSM against one shared point set, in plain torch: nibbles
    [..., N, 64] over points [N] -> totals [...]. The table of the N points
    is built once and shared by every batch element and window."""
    table = pt.window_table(points)

    def window_sum(w: int) -> pt.ExtPoint:
        return pt.sum_points(select(table, nibbles[..., w]), axis=-1)

    acc = window_sum(pt.NWINDOWS - 1)
    for w in range(pt.NWINDOWS - 2, -1, -1):
        for i in range(pt.WINDOW_BITS):
            acc = pt.double(acc, need_t=(i == pt.WINDOW_BITS - 1))
        acc = pt.add(acc, window_sum(w))
    return acc


def msm_host(scalars, host_points, device="cuda") -> ex.Point:
    """Host scalars and points -> device MSM -> host point."""
    dev = resolve_device(device)
    nibbles = torch.as_tensor(pt.scalars_to_nibbles(scalars), device=dev)
    out = msm(nibbles, pt.from_exact_batch(host_points, dev))
    return pt.to_exact_batch(pt.ExtPoint(*(c[None] for c in out)))[0]
