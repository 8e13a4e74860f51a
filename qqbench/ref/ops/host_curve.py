"""The C++ curve library of ``csrc/host_curve.cpp``, for the host points.

51-bit-limb GF(2^255-19), extended twisted-Edwards points, windowed scalar
multiplication, a threaded Pippenger MSM and ristretto255 encode/decode,
tens of times faster than the pure-Python functions of :mod:`.exact`. Once
the package has loaded, :func:`.exact._try_enable_native` points the exact
backend's point functions here; the pure-Python ones stay as the plain
versions (``exact.*_py``, ``tests/test_torch_host_curve.py``).

g++ builds the library at first use into
``build/quisquis_tpu_torch/host_curve/<hash of the source and flags>/``,
through :class:`.host_build.HostLibrary`, and ctypes loads it. Where
g++ is missing, or the build or the load fails, :func:`available` is False
(:func:`build_error` says why) and the exact backend keeps pure Python.

Every entry point takes and returns canonical little-endian bytes (32-byte
scalars and field elements, 4 x 32-byte extended points).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

from .host_build import CSRC, HostLibrary

SOURCE = CSRC / "host_curve.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_CP, _U64 = ctypes.c_char_p, ctypes.c_uint64
#: entry point -> (argument types, return type)
_SIGNATURES = {
    "qq_curve_init": ([_CP] * 7, None),
    "qq_pt_add": ([_CP] * 3, None),
    "qq_pt_double": ([_CP] * 2, None),
    "qq_pt_scalar_mul": ([_CP] * 3, None),
    "qq_pt_msm": ([_U64] + [_CP] * 3, None),
    "qq_ristretto_encode": ([_CP] * 2, None),
    "qq_ristretto_decode": ([_CP] * 2, ctypes.c_int),
    "qq_initialized": ([], ctypes.c_int),
    "qq_set_basepoint": ([_CP], None),
    "qq_pt_base_mul": ([_CP] * 2, None),
    "qq_base_ready": ([], ctypes.c_int),
    "qq_pt_mul_batch": ([_U64] + [_CP] * 3, None),
    "qq_fold_batch": ([_U64] + [_CP] * 5, None),
    "qq_pt_msm_many": ([_U64, ctypes.POINTER(_U64), _CP, _CP, _CP], None),
    "qq_ristretto_encode_batch": ([_U64, _CP, _CP], None),
    "qq_ristretto_decode_batch": ([_U64, _CP, _CP], ctypes.c_longlong),
}

_HOST = HostLibrary(SOURCE, CXX_FLAGS, _SIGNATURES)
load_library = _HOST.load
available = _HOST.available
build_seconds = _HOST.build_seconds
compiled = _HOST.compiled
build_error = _HOST.build_error


def init_constants(ex) -> bool:
    """Give the library the exact backend's field constants and base
    point; returns whether the library is available."""
    lib = load_library()
    if lib is None:
        return False
    if lib.qq_initialized():
        return True
    P = ex.P

    def fb(v):
        return (v % P).to_bytes(32, "little")

    lib.qq_curve_init(fb(ex.D), fb(ex.D2), fb(ex.SQRT_M1),
                      fb(ex.INVSQRT_A_MINUS_D), fb(ex.SQRT_AD_MINUS_ONE),
                      fb(ex.ONE_MINUS_D_SQ), fb(ex.D_MINUS_ONE_SQ))
    lib.qq_set_basepoint(_pt_to_bytes(ex.BASEPOINT))
    return True


# point wire form: 4 x 32-byte LE (x, y, z, t)

class _WirePoint(tuple):
    """Point tuple that remembers its 128-byte wire form.

    Behaves exactly like the plain 4-tuple ``exact.Point``; the cached
    ``wire`` attribute lets points that flow from library call to library
    call (decode -> MSM, add -> MSM, ...) skip the int <-> bytes marshal.
    (tuple subtypes cannot declare nonempty __slots__, so instances carry a
    small __dict__.)"""


def _pt_to_bytes(p: tuple) -> bytes:
    w = getattr(p, "wire", None)
    if w is not None:
        return w
    x, y, z, t = p
    return (x.to_bytes(32, "little") + y.to_bytes(32, "little") +
            z.to_bytes(32, "little") + t.to_bytes(32, "little"))


def _pt_from_bytes(b: bytes) -> tuple:
    p = _WirePoint((int.from_bytes(b[0:32], "little"),
                    int.from_bytes(b[32:64], "little"),
                    int.from_bytes(b[64:96], "little"),
                    int.from_bytes(b[96:128], "little")))
    p.wire = bytes(b)
    return p


def _points(raw: bytes, n: int) -> List[tuple]:
    return [_pt_from_bytes(raw[128 * i:128 * (i + 1)]) for i in range(n)]


def _scalars(scalars, order: int) -> bytes:
    return b"".join((s % order).to_bytes(32, "little") for s in scalars)


def pt_add(p: tuple, q: tuple) -> tuple:
    out = ctypes.create_string_buffer(128)
    _HOST.lib.qq_pt_add(_pt_to_bytes(p), _pt_to_bytes(q), out)
    return _pt_from_bytes(out.raw)


def pt_double(p: tuple) -> tuple:
    out = ctypes.create_string_buffer(128)
    _HOST.lib.qq_pt_double(_pt_to_bytes(p), out)
    return _pt_from_bytes(out.raw)


def pt_mul(s: int, p: tuple, order: int) -> tuple:
    out = ctypes.create_string_buffer(128)
    _HOST.lib.qq_pt_scalar_mul((s % order).to_bytes(32, "little"), _pt_to_bytes(p), out)
    return _pt_from_bytes(out.raw)


def pt_msm(scalars, points, order: int) -> tuple:
    out = ctypes.create_string_buffer(128)
    _HOST.lib.qq_pt_msm(len(scalars), _scalars(scalars, order),
                        b"".join(_pt_to_bytes(p) for p in points), out)
    return _pt_from_bytes(out.raw)


def pt_mul_batch(scalars, points, order: int) -> List[tuple]:
    """out[i] = s_i * P_i, one marshal for the whole batch."""
    n = len(scalars)
    out = ctypes.create_string_buffer(128 * n)
    _HOST.lib.qq_pt_mul_batch(n, _scalars(scalars, order),
                              b"".join(_pt_to_bytes(p) for p in points), out)
    return _points(out.raw, n)


def fold_batch(a_scalars, b_scalars, ps, qs, order: int) -> List[tuple]:
    """out[i] = a_i*P_i + b_i*Q_i (Strauss shared doubling per element)."""
    n = len(ps)
    out = ctypes.create_string_buffer(128 * n)
    _HOST.lib.qq_fold_batch(n, _scalars(a_scalars, order), _scalars(b_scalars, order),
                            b"".join(_pt_to_bytes(p) for p in ps),
                            b"".join(_pt_to_bytes(q) for q in qs), out)
    return _points(out.raw, n)


def pt_msm_many(items, order: int) -> List[tuple]:
    """Independent MSMs threaded across rows: items = [(scalars, points), ...]."""
    rows = len(items)
    ns = (_U64 * rows)(*[len(s) for s, _ in items])
    sbuf = b"".join(_scalars(ss, order) for ss, _ in items)
    pbuf = b"".join(_pt_to_bytes(p) for _, pp in items for p in pp)
    out = ctypes.create_string_buffer(128 * rows)
    _HOST.lib.qq_pt_msm_many(rows, ns, sbuf, pbuf, out)
    return _points(out.raw, rows)


def pt_base_mul(s: int, order: int) -> tuple:
    out = ctypes.create_string_buffer(128)
    _HOST.lib.qq_pt_base_mul((s % order).to_bytes(32, "little"), out)
    return _pt_from_bytes(out.raw)


def ristretto_encode(p: tuple) -> bytes:
    out = ctypes.create_string_buffer(32)
    _HOST.lib.qq_ristretto_encode(_pt_to_bytes(p), out)
    return out.raw[:32]


def ristretto_decode(b: bytes) -> Optional[tuple]:
    if len(b) != 32:
        return None
    out = ctypes.create_string_buffer(128)
    ok = _HOST.lib.qq_ristretto_decode(bytes(b), out)
    return _pt_from_bytes(out.raw) if ok else None


def ristretto_encode_batch(points) -> List[bytes]:
    n = len(points)
    out = ctypes.create_string_buffer(32 * n)
    _HOST.lib.qq_ristretto_encode_batch(n, b"".join(_pt_to_bytes(p) for p in points), out)
    raw = out.raw
    return [raw[32 * i:32 * (i + 1)] for i in range(n)]


def ristretto_decode_batch(blobs) -> Optional[List[tuple]]:
    """Decode many 32-byte encodings; None if ANY is invalid."""
    n = len(blobs)
    if any(len(b) != 32 for b in blobs):
        return None
    out = ctypes.create_string_buffer(128 * n)
    bad = _HOST.lib.qq_ristretto_decode_batch(n, b"".join(bytes(b) for b in blobs), out)
    if bad >= 0:
        return None
    return _points(out.raw, n)
