"""Wrappers of the port's CUDA point kernels; the counterpart of the JAX
package's ``ops/pallas_point.py``.

* :func:`decode_bytes` and :func:`encode_bytes` launch
  ``csrc/ristretto_codec.cu`` (ristretto255 decode and encode), in the
  spans ``ops.point.decode`` and ``ops.point.encode``,
* :func:`scalar_mul` launches ``csrc/scalar_mul.cu`` (variable-base s*P),
* :func:`base_mul` launches ``csrc/base_mul.cu`` (fixed-base s*B),
* :func:`msm_table`, :func:`msm_window_sums` and :func:`msm_tail` launch
  ``csrc/msm_table.cu``, ``csrc/msm_acc.cu`` and ``csrc/msm_tail.cu``, the
  three stages of a multiscalar multiplication; :func:`msm_rows` and
  :func:`msm` pad their input and run the three; :func:`msm_shared_rows`
  runs rows over one :class:`SharedBasis`, whose table it builds once.

For tensors on the CPU each calls its plain version in
:mod:`quisquis_tpu_torch.ops.point` or :mod:`quisquis_tpu_torch.ops.msm_plain`;
for CUDA tensors it launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES`. :mod:`quisquis_tpu_torch.ops.cuda_build` builds and loads
the kernels. Each multiscalar multiplication is a span ``ops.msm`` and adds
the terms it hands the kernels, padding included, to the counter
``ops.msm.terms`` (``utils.metrics``).
"""

from __future__ import annotations

import torch

from ..utils.metrics import metrics, span
from . import field as fe
from . import msm_plain as qmsm
from . import point as pt
from .cuda_build import LAUNCHES, check_tensor, launch  # noqa: F401  (LAUNCHES: for callers)


def _device_kind(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _check_point(p: pt.ExtPoint, name: str, shape, device: torch.device) -> None:
    for c_name, c in zip("xyzt", p):
        check_tensor(c, f"{name}.{c_name}", shape, device)


def _empty_point(shape, device: torch.device) -> pt.ExtPoint:
    return pt.ExtPoint(*(torch.empty(shape, dtype=torch.int32, device=device)
                         for _ in range(4)))


def _ptrs(p: pt.ExtPoint):
    return (c.data_ptr() for c in p)


def decode_bytes(b: torch.Tensor):
    """Ristretto decode: uint8 [..., 32] -> (ok bool [...], ExtPoint [...]),
    non-canonical encodings rejected (:func:`point.decompress_bytes_tensor`)."""
    if _device_kind(b, "decode_bytes") == "cpu":
        return pt.decompress_bytes_tensor(b)
    with span("ops.point.decode"):
        if b.dim() == 0 or b.shape[-1] != 32:
            raise ValueError(f"decode_bytes: expected [..., 32] bytes, got {list(b.shape)}")
        dev, lead = b.device, b.shape[:-1]
        flat = b.reshape(-1, 32).contiguous()
        n = flat.shape[0]
        check_tensor(flat, "b", (n, 32), dev, torch.uint8)
        ok = torch.empty((n,), dtype=torch.bool, device=dev)  # the kernel writes 0 or 1
        out = _empty_point((n, fe.NLIMBS), dev)
        if n:
            launch("ristretto_decode", dev, flat.data_ptr(), ok.data_ptr(), *_ptrs(out), n)
        return ok.reshape(lead), pt.ExtPoint(*(c.reshape(*lead, fe.NLIMBS) for c in out))


def encode_bytes(p: pt.ExtPoint) -> torch.Tensor:
    """Ristretto encode: coords int32 [..., 10] -> canonical uint8 [..., 32]
    (:func:`point.compress_to_bytes_tensor`)."""
    if _device_kind(p.x, "encode_bytes") == "cpu":
        return pt.compress_to_bytes_tensor(p)
    with span("ops.point.encode"):
        if any(c.shape != p.x.shape for c in p) or p.x.shape[-1:] != (fe.NLIMBS,):
            raise ValueError(f"encode_bytes: expected four [..., {fe.NLIMBS}] coordinates, "
                             f"got {[list(c.shape) for c in p]}")
        dev, lead = p.device, p.x.shape[:-1]
        flat = pt.ExtPoint(*(c.reshape(-1, fe.NLIMBS).contiguous() for c in p))
        n = flat.x.shape[0]
        _check_point(flat, "p", (n, fe.NLIMBS), dev)
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        if n:
            launch("ristretto_encode", dev, *_ptrs(flat), out.data_ptr(), n)
        return out.reshape(*lead, 32)


def scalar_mul(nibbles: torch.Tensor, p: pt.ExtPoint) -> pt.ExtPoint:
    """s*P per lane: nibbles int32 [B, 64], P coords int32 [B, 10]."""
    if _device_kind(nibbles, "scalar_mul") == "cpu":
        return pt.scalar_mul(nibbles, p)
    dev, n = nibbles.device, nibbles.shape[0]
    check_tensor(nibbles, "nibbles", (None, pt.NWINDOWS), dev)
    _check_point(p, "p", (n, fe.NLIMBS), dev)
    out = _empty_point((n, fe.NLIMBS), dev)
    if n:
        launch("scalar_mul", dev, nibbles.data_ptr(), *_ptrs(p), *_ptrs(out), n)
    return out


def base_mul(nibbles: torch.Tensor) -> pt.ExtPoint:
    """s*B per lane: nibbles int32 [B, 64]."""
    if _device_kind(nibbles, "base_mul") == "cpu":
        return pt.base_mul(nibbles)
    dev, n = nibbles.device, nibbles.shape[0]
    check_tensor(nibbles, "nibbles", (None, pt.NWINDOWS), dev)
    out = _empty_point((n, fe.NLIMBS), dev)
    if n:
        table = pt.niels_base_table(dev)
        launch("base_mul", dev, table.data_ptr(), nibbles.data_ptr(), *_ptrs(out), n)
    return out


# ---------------------------------------------------------------------------
# multiscalar multiplication: table -> window sums -> tail
# ---------------------------------------------------------------------------

def msm_table(p: pt.ExtPoint) -> pt.ExtPoint:
    """The multiples 0..15 of each point: coords [n, 10] -> [16, 10, n]."""
    if _device_kind(p.x, "msm_table") == "cpu":
        return qmsm.msm_table(p)
    dev, n = p.device, p.x.shape[0]
    _check_point(p, "p", (n, fe.NLIMBS), dev)
    out = _empty_point((16, fe.NLIMBS, n), dev)
    if n:
        launch("msm_table", dev, *_ptrs(p), *_ptrs(out), n)
    return out


def msm_window_sums(digits: torch.Tensor, table: pt.ExtPoint, rows: int) -> pt.ExtPoint:
    """Per row, window and lane the sum of digit * P_i over the row's points
    with i % MSM_LANES equal to the lane. digits int32 [64, n] (0..15), table
    coords [16, 10, n], n = rows * tiles * MSM_LANES -> coords
    [rows, 64, 10, MSM_LANES]."""
    if _device_kind(digits, "msm_window_sums") == "cpu":
        return qmsm.msm_window_sums(digits, table, rows)
    dev, n = digits.device, digits.shape[1]
    if rows < 1 or n % (rows * qmsm.MSM_LANES):
        raise ValueError(f"msm_window_sums: {n} points are not {rows} rows of whole "
                         f"{qmsm.MSM_LANES}-lane tiles")
    check_tensor(digits, "digits", (pt.NWINDOWS, n), dev)
    _check_point(table, "table", (16, fe.NLIMBS, n), dev)
    out = _empty_point((rows, pt.NWINDOWS, fe.NLIMBS, qmsm.MSM_LANES), dev)
    launch("msm_acc", dev, digits.data_ptr(), *_ptrs(table), *_ptrs(out), rows,
           n // (rows * qmsm.MSM_LANES), qmsm.MSM_LANES)
    return out


def msm_tail(sums: pt.ExtPoint) -> pt.ExtPoint:
    """Sum over the lanes per window, then Horner's rule over the 64
    windows: coords [rows, 64, 10, MSM_LANES] -> [rows, 10]."""
    if _device_kind(sums.x, "msm_tail") == "cpu":
        return qmsm.msm_tail(sums)
    dev, rows = sums.device, sums.x.shape[0]
    _check_point(sums, "sums", (rows, pt.NWINDOWS, fe.NLIMBS, qmsm.MSM_LANES), dev)
    out = _empty_point((rows, fe.NLIMBS), dev)
    if rows:
        # the kernel's scratch: cached window totals, and a count of the
        # windows finished per row
        totals = torch.empty((rows, pt.NWINDOWS, 4, fe.NLIMBS), dtype=torch.int32, device=dev)
        done = torch.zeros((rows,), dtype=torch.int32, device=dev)
        launch("msm_tail", dev, *_ptrs(sums), totals.data_ptr(), done.data_ptr(), *_ptrs(out),
               rows, qmsm.MSM_LANES)
    return out


def pad_rows(nibbles: torch.Tensor, p: pt.ExtPoint):
    """nibbles int32 [R, k, 64], points [R, k] -> (digits int32 [64, n], flat
    points [n]), n = R * k padded: every row is filled up to whole MSM_LANES
    tiles with zero digits on identity points, which add nothing."""
    rows, k = nibbles.shape[0], nibbles.shape[1]
    pad = (-k) % qmsm.MSM_LANES if k else qmsm.MSM_LANES
    if pad:
        nibbles = torch.cat([nibbles, nibbles.new_zeros((rows, pad, pt.NWINDOWS))], dim=1)
        ident = pt.identity((rows, pad), nibbles.device)
        p = pt.ExtPoint(*(torch.cat([c, e], dim=1) for c, e in zip(p, ident)))
    n = rows * (k + pad)
    return (nibbles.reshape(n, pt.NWINDOWS).t().contiguous(),
            pt.ExtPoint(*(c.reshape(n, fe.NLIMBS).contiguous() for c in p)))


def _msm_rows(nibbles: torch.Tensor, p: pt.ExtPoint) -> pt.ExtPoint:
    rows = nibbles.shape[0]
    if rows == 0:
        return _empty_point((0, fe.NLIMBS), nibbles.device)
    digits, flat = pad_rows(nibbles, p)
    metrics.count("ops.msm.terms", digits.shape[1])
    return msm_tail(msm_window_sums(digits, msm_table(flat), rows))


@span("ops.msm")
def msm_rows(nibbles: torch.Tensor, p: pt.ExtPoint) -> pt.ExtPoint:
    """One multiscalar multiplication per row: nibbles int32 [R, k, 64] over
    points [R, k] -> points [R]."""
    return _msm_rows(nibbles, p)


@span("ops.msm")
def msm(nibbles: torch.Tensor, p: pt.ExtPoint) -> pt.ExtPoint:
    """sum_i s_i * P_i: nibbles int32 [n, 64], points [n] -> one point
    (coords [10])."""
    out = _msm_rows(nibbles[None], pt.ExtPoint(*(c[None] for c in p)))
    return pt.ExtPoint(*(c[0] for c in out))


# ---------------------------------------------------------------------------
# rows over one shared basis (the provers' commitments)
# ---------------------------------------------------------------------------

class SharedBasis:
    """A point set [k] that every row of :func:`msm_shared_rows` multiplies.

    On CUDA its ``msm_table`` is built once, at first use, over the points
    padded with identities to whole MSM_LANES tiles, and kept: a prover
    holds its bases for its lifetime, so each prove reuses the tables. On
    the CPU it keeps the plain version's comb the same way."""

    def __init__(self, points: pt.ExtPoint):
        self.points = points
        self.k = points.x.shape[0]
        self._table = None
        self._comb = None

    def comb(self) -> pt.ExtPoint:
        """The plain version's comb (``msm_plain.shared_comb``)."""
        if self._comb is None:
            self._comb = qmsm.shared_comb(self.points)
        return self._comb

    def table(self) -> pt.ExtPoint:
        """coords [16, 10, kp], kp = k padded to whole MSM_LANES tiles."""
        if self._table is None:
            pad = (-self.k) % qmsm.MSM_LANES
            ident = pt.identity((pad,), self.points.device)
            self._table = msm_table(pt.ExtPoint(*(torch.cat([c, e]).contiguous()
                                                  for c, e in zip(self.points, ident))))
        return self._table


@span("ops.msm")
def msm_shared_rows(nibbles: torch.Tensor, basis: SharedBasis) -> pt.ExtPoint:
    """One multiscalar multiplication per row over one shared basis:
    nibbles int32 [R, k', 64], k' <= basis.k (missing digits are zeros) ->
    points [R]. On CUDA the basis's cached table is tiled to the R rows by a
    device copy and the msm_acc and msm_tail kernels run in rows mode; on
    the CPU the plain version (``msm_plain.msm_shared_base`` on the basis's
    cached comb)."""
    rows, k = nibbles.shape[0], nibbles.shape[1]
    if k < basis.k:
        nibbles = torch.cat([nibbles, nibbles.new_zeros((rows, basis.k - k, pt.NWINDOWS))], dim=1)
    elif k > basis.k:
        raise ValueError(f"msm_shared_rows: {k} digits a row over a basis of {basis.k} points")
    metrics.count("ops.msm.terms", rows * (basis.k + (-basis.k) % qmsm.MSM_LANES))
    if _device_kind(nibbles, "msm_shared_rows") == "cpu":
        return qmsm.msm_comb(nibbles, basis.comb())
    if rows == 0:
        return _empty_point((0, fe.NLIMBS), nibbles.device)
    table = basis.table()
    kpad = table.x.shape[-1]
    nibbles = torch.cat([nibbles, nibbles.new_zeros((rows, kpad - basis.k, pt.NWINDOWS))], dim=1)
    digits = nibbles.reshape(rows * kpad, pt.NWINDOWS).t().contiguous()
    tiled = pt.ExtPoint(*(c[:, :, None, :].expand(16, fe.NLIMBS, rows, kpad)
                          .reshape(16, fe.NLIMBS, rows * kpad) for c in table))
    return msm_tail(msm_window_sums(digits, tiled, rows))
