"""Plain PyTorch versions of the three MSM kernels.

    sum_i s_i P_i = sum_w 16^w T_w,   T_w = sum_i digit[i, w] * P_i.

1. :func:`msm_table`: per point its multiples 0..15 (``csrc/msm_table.cu``);
2. :func:`msm_window_sums`: per row, window and lane the sum of the selected
   multiples of the lane's points, in slices folded by a tree
   (``csrc/msm_acc.cu``);
3. :func:`msm_tail`: per row and window the sum over the lanes, then one
   Horner chain over the 64 window totals (``csrc/msm_tail.cu``).

Each keeps its kernel's schedule, operand order, ``need_t`` choices and
memory layout, so both agree limb for limb. This module is a leaf: the
wrappers in :mod:`quisquis_tpu_torch.ops.cuda_point` fall back to it for
CPU tensors, and :mod:`quisquis_tpu_torch.ops.msm` composes the stages.
"""

from __future__ import annotations

import torch

from . import field as fe
from . import point as pt

#: lanes of a row's accumulators; the constant MSM_LANES of csrc/msm_layout.cuh
MSM_LANES = 128
#: the most slices a lane's tiles are split into (csrc/msm_acc.cu)
MSM_MAX_SLICES = 4


def select(table: pt.ExtPoint, digit: torch.Tensor) -> pt.ExtPoint:
    """table coords [..., 16, NL] (broadcast against digit's shape), digit
    int [...] -> entry digit of each table, coords [..., NL]."""
    shape = tuple(digit.shape)
    idx = digit.long()[..., None, None].expand(*shape, 1, fe.NLIMBS)
    return pt.ExtPoint(*(torch.gather(c.expand(*shape, 16, fe.NLIMBS), -2, idx)[..., 0, :]
                         for c in table))


def msm_table(p: pt.ExtPoint) -> pt.ExtPoint:
    """coords [n, NL] -> [16, NL, n]: entry k is k * P."""
    return pt.ExtPoint(*(c.permute(1, 2, 0).contiguous() for c in pt.window_table(p)))


def msm_slices(tiles: int) -> int:
    """Slices of a lane's tiles in ``csrc/msm_acc.cu`` (``msm_slices``): the
    largest power of two S <= MSM_MAX_SLICES with 2 * S <= tiles. It depends
    on the tiles alone, so a row's sums do not depend on the other rows."""
    s = 1
    while 4 * s <= tiles and 2 * s <= MSM_MAX_SLICES:
        s <<= 1
    return s


def msm_window_sums(digits: torch.Tensor, table: pt.ExtPoint, rows: int) -> pt.ExtPoint:
    """digits int32 [64, n], table coords [16, NL, n], n = rows * tiles *
    MSM_LANES -> coords [rows, 64, NL, MSM_LANES]. Per lane and window,
    slice s of S = msm_slices(tiles) starts from the identity and adds the
    lane's points of tiles s, s + S, ...; then slice s takes slice s + step
    for step = S/2 .. 1."""
    n = digits.shape[1]
    tiles = n // (rows * MSM_LANES)
    if rows < 1 or rows * tiles * MSM_LANES != n:
        raise ValueError(f"{n} points are not {rows} rows of whole {MSM_LANES}-lane tiles")
    slices = msm_slices(tiles)
    d = digits.reshape(pt.NWINDOWS, rows, tiles, MSM_LANES)
    tab = [c.reshape(16, fe.NLIMBS, rows, tiles, MSM_LANES) for c in table]
    acc = pt.identity((rows, pt.NWINDOWS, slices, MSM_LANES), digits.device)
    for t0 in range(0, tiles, slices):
        a = min(slices, tiles - t0)  # the slices that have tile t0 + slice
        # [rows, 1, a, lanes, 16, NL], shared by the 64 windows
        tile = pt.ExtPoint(*(c[:, :, :, t0:t0 + a].permute(2, 3, 4, 0, 1)[:, None] for c in tab))
        head = pt.add(pt.ExtPoint(*(c[:, :, :a] for c in acc)),
                      select(tile, d[:, :, t0:t0 + a].permute(1, 0, 2, 3)))
        acc = pt.ExtPoint(*(torch.cat([h, c[:, :, a:]], dim=2) for h, c in zip(head, acc)))
    step = slices // 2
    while step:
        acc = pt.add(pt.ExtPoint(*(c[:, :, :step] for c in acc)),
                     pt.ExtPoint(*(c[:, :, step:2 * step] for c in acc)))
        step //= 2
    return pt.ExtPoint(*(c[:, :, 0].permute(0, 1, 3, 2).contiguous() for c in acc))


def msm_tail(sums: pt.ExtPoint) -> pt.ExtPoint:
    """coords [rows, 64, NL, MSM_LANES] -> [rows, NL]. Per row and window
    the lanes are added in a tree (lane j takes lane j + step for step =
    MSM_LANES/2 .. 1), the totals put in cached form, then
    :func:`~quisquis_tpu_torch.ops.point.horner16` runs over windows 63 .. 0."""
    acc = pt.ExtPoint(*(c.permute(0, 1, 3, 2) for c in sums))  # [rows, 64, lanes, NL]
    step = MSM_LANES // 2
    while step:
        acc = pt.add(pt.ExtPoint(*(c[:, :, :step] for c in acc)),
                     pt.ExtPoint(*(c[:, :, step:2 * step] for c in acc)))
        step //= 2
    totals = pt.to_cached(pt.ExtPoint(*(c[:, :, 0] for c in acc)))  # [rows, 64, NL]
    out = pt.horner16(sums.x.shape[:1], sums.x.device, pt.NWINDOWS - 1,
                      lambda w: pt.CachedPoint(*(c[:, w] for c in totals)))
    return pt.ExtPoint(*(c.contiguous() for c in out))


def shared_comb(points: pt.ExtPoint) -> pt.ExtPoint:
    """The fixed-base comb of a shared point set: coords [64, N, 16, NL],
    entry [w, i, d] = d 16^w P_i (252 doublings and one window table, once
    per point set)."""
    bases = [points]
    for _ in range(pt.NWINDOWS - 1):
        b = bases[-1]
        for i in range(pt.WINDOW_BITS):
            b = pt.double(b, need_t=(i == pt.WINDOW_BITS - 1))
        bases.append(b)
    n = points.x.shape[0]
    flat = pt.ExtPoint(*(torch.cat(cs) for cs in zip(*bases)))      # [64 N, NL]
    return pt.ExtPoint(*(c.reshape(pt.NWINDOWS, n, 16, fe.NLIMBS) for c in pt.window_table(flat)))


def msm_comb(nibbles: torch.Tensor, comb: pt.ExtPoint) -> pt.ExtPoint:
    """Rows over one shared point set from its comb: nibbles [..., N, 64],
    comb [64, N, 16, NL] -> totals [...], one tree of additions over the
    64 N selected entries of each row (no doubling chain)."""
    sel = select(comb, nibbles.transpose(-1, -2))                    # [..., 64, N, NL]
    lead = tuple(nibbles.shape[:-2])
    return pt.sum_points(pt.ExtPoint(*(c.reshape(lead + (-1, fe.NLIMBS)) for c in sel)),
                         axis=-1)


def msm_shared_base(nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """Batched MSM against one shared point set: nibbles [..., N, 64] over
    points [N] -> totals [...]. The plain version of
    ``cuda_point.msm_shared_rows``, equal as points, not limb for limb: it
    sums each row's entries of the set's comb (:func:`shared_comb`, which
    ``SharedBasis`` keeps) in one tree, in place of the kernels' window
    sums and Horner chain: eager torch on a CPU pays per operation, and a
    chain of 315 point operations a call would set the CPU tests' time."""
    return msm_comb(nibbles, shared_comb(points))
