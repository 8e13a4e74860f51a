"""Multiscalar multiplication: sum_i s_i * P_i over batched points.

    sum_i s_i P_i = sum_w 16^w T_w,   T_w = sum_i digit[i, w] * P_i.

Three stages, each a CUDA kernel with its plain PyTorch version here:

1. :func:`msm_table`: per point its multiples 0..15 (``csrc/msm_table.cu``);
2. :func:`msm_window_sums`: per row, window and lane the sum of the selected
   multiples of the lane's points (``csrc/msm_acc.cu``);
3. :func:`msm_tail`: per lane a Horner fold over the 64 windows, then the sum
   over the lanes (``csrc/msm_tail.cu``).

The plain versions keep the kernels' schedules, operand order, ``need_t``
choices and memory layouts, so both agree limb for limb. :func:`msm` and
:func:`msm_rows` go through :mod:`quisquis_tpu_torch.ops.cuda_point`, which
launches the kernels for CUDA tensors and calls the plain versions for CPU
tensors, at every size: the JAX package's size thresholds were measured on a
TPU and are not carried over.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import exact as ex
from . import field as fe
from . import point as pt

#: lanes of a row's accumulators; the constant MSM_LANES of csrc/msm_layout.cuh
MSM_LANES = 128


def _select(table: pt.ExtPoint, digit: torch.Tensor) -> pt.ExtPoint:
    """table coords [..., 16, NL] (broadcast against digit's shape), digit
    int [...] -> entry digit of each table, coords [..., NL]."""
    shape = tuple(digit.shape)
    idx = digit.long()[..., None, None].expand(*shape, 1, fe.NLIMBS)
    return pt.ExtPoint(*(torch.gather(c.expand(*shape, 16, fe.NLIMBS), -2, idx)[..., 0, :]
                         for c in table))


# ---------------------------------------------------------------------------
# plain versions of the three kernels
# ---------------------------------------------------------------------------

def msm_table(p: pt.ExtPoint) -> pt.ExtPoint:
    """coords [n, NL] -> [16, NL, n]: entry k is k * P."""
    return pt.ExtPoint(*(c.permute(1, 2, 0).contiguous() for c in pt.window_table(p)))


def msm_window_sums(digits: torch.Tensor, table: pt.ExtPoint, rows: int) -> pt.ExtPoint:
    """digits int32 [64, n], table coords [16, NL, n], n = rows * tiles *
    MSM_LANES -> coords [rows, 64, NL, MSM_LANES]. Lane j of a row starts
    from the identity and adds its points in order, one per tile."""
    n = digits.shape[1]
    tiles = n // (rows * MSM_LANES)
    if rows < 1 or rows * tiles * MSM_LANES != n:
        raise ValueError(f"{n} points are not {rows} rows of whole {MSM_LANES}-lane tiles")
    d = digits.reshape(pt.NWINDOWS, rows, tiles, MSM_LANES)
    tab = [c.reshape(16, fe.NLIMBS, rows, tiles, MSM_LANES) for c in table]
    acc = pt.identity((rows, pt.NWINDOWS, MSM_LANES), digits.device)
    for t in range(tiles):
        # [rows, 1, lanes, 16, NL], shared by the 64 windows
        tile = pt.ExtPoint(*(c[:, :, :, t].permute(2, 3, 0, 1)[:, None] for c in tab))
        acc = pt.add(acc, _select(tile, d[:, :, t].permute(1, 0, 2)))
    return pt.ExtPoint(*(c.permute(0, 1, 3, 2).contiguous() for c in acc))


def msm_tail(sums: pt.ExtPoint) -> pt.ExtPoint:
    """coords [rows, 64, NL, MSM_LANES] -> [rows, NL]: per lane acc = W_63,
    then 63 x (3 doublings without T, 1 with T, + W_w); then lane j takes
    lane j + step for step = MSM_LANES/2 .. 1."""
    w = pt.ExtPoint(*(c.permute(1, 0, 3, 2) for c in sums))  # [64, rows, lanes, NL]
    acc = pt.ExtPoint(*(c[pt.NWINDOWS - 1] for c in w))
    for k in range(pt.NWINDOWS - 2, -1, -1):
        for i in range(pt.WINDOW_BITS):
            acc = pt.double(acc, need_t=(i == pt.WINDOW_BITS - 1))
        acc = pt.add(acc, pt.ExtPoint(*(c[k] for c in w)))
    step = MSM_LANES // 2
    while step:
        acc = pt.add(pt.ExtPoint(*(c[:, :step] for c in acc)),
                     pt.ExtPoint(*(c[:, step:2 * step] for c in acc)))
        step //= 2
    return pt.ExtPoint(*(c[:, 0].contiguous() for c in acc))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def msm_rows(nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """Per-row MSM: nibbles int32 [R, k, 64] over points [R, k] -> [R]."""
    from . import cuda_point as kp
    return kp.msm_rows(nibbles, points)


def msm(nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """nibbles int32 [n, 64], points [n] -> one point (coords [NL])."""
    from . import cuda_point as kp
    return kp.msm(nibbles, points)


def msm_shared_base(nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """Batched MSM against one shared point set, in plain torch: nibbles
    [..., N, 64] over points [N] -> totals [...]. The table of the N points
    is built once and shared by every batch element and window."""
    table = pt.window_table(points)

    def window_sum(w: int) -> pt.ExtPoint:
        return pt.sum_points(_select(table, nibbles[..., w]), axis=-1)

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
