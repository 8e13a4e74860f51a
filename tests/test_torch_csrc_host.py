"""The CUDA sources' arithmetic, compiled for the host with g++.

``field25519.cuh``, ``point25519.cuh`` and the per-lane bodies of
``scalar_mul.cu``, ``base_mul.cu``, the three MSM kernels and the Keccak
permutation build as plain C++ (their CUDA-only parts sit behind
``#ifdef __CUDACC__``). A small C harness exposes them
through ctypes; each result must equal the port's ``exact.py`` at the
canonical value and the plain torch version limb for limb. The kernels
themselves run only on the GPU (``chip_smoke.py``).
"""

import ctypes
import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quisquis_tpu_torch.ops import cuda_point as kp
from quisquis_tpu_torch.ops import device_keccak as dk
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import field as fe
from quisquis_tpu_torch.ops import keccak
from quisquis_tpu_torch.ops import msm as qmsm
from quisquis_tpu_torch.ops import point as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "quisquis_tpu_torch", "csrc")
P = ex.P

HARNESS = r"""
#include <string.h>
#include <vector>
#include "scalar_mul.cu"
#include "base_mul.cu"
#include "msm_table.cu"
#include "msm_acc.cu"
#include "msm_tail.cu"
#include "keccak_f1600.cu"

using namespace qq;

static ge ld(const int32_t* p) {
  ge r;
  for (int i = 0; i < NL; ++i) {
    r.x.v[i] = p[i]; r.y.v[i] = p[NL + i]; r.z.v[i] = p[2 * NL + i]; r.t.v[i] = p[3 * NL + i];
  }
  return r;
}

static void st(int32_t* p, const ge& a) {
  for (int i = 0; i < NL; ++i) {
    p[i] = a.x.v[i]; p[NL + i] = a.y.v[i]; p[2 * NL + i] = a.z.v[i]; p[3 * NL + i] = a.t.v[i];
  }
}

static fe fld(const int32_t* p) { fe r; for (int i = 0; i < NL; ++i) r.v[i] = p[i]; return r; }
static void fst(int32_t* p, const fe& a) { for (int i = 0; i < NL; ++i) p[i] = a.v[i]; }

extern "C" {
// op: 0 mul, 1 sq, 2 add, 3 sub, 4 neg, 5 invert, 6 mul_small<2>
void h_fe(int op, const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    const fe x = fld(a + k * NL), y = fld(b + k * NL);
    fe r;
    switch (op) {
      case 0: r = fe_mul(x, y); break;
      case 1: r = fe_sq(x); break;
      case 2: r = fe_add(x, y); break;
      case 3: r = fe_sub(x, y); break;
      case 4: r = fe_neg(x); break;
      case 5: r = fe_invert(x); break;
      default: r = fe_mul_small<2>(x); break;
    }
    fst(out + k * NL, r);
  }
}

// op: 0 double (T), 1 double (no T), 2 add, 3 scalar_mul (nib = digits)
void h_ge(int op, const int32_t* p, const int32_t* q, const int32_t* nib, int32_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    const ge a = ld(p + k * 4 * NL);
    ge r;
    switch (op) {
      case 0: r = ge_double<true>(a); break;
      case 1: r = ge_double<false>(a); break;
      case 2: r = ge_add<true>(a, ld(q + k * 4 * NL)); break;
      default: r = scalar_mul_lane(nib + k * 64, a); break;
    }
    st(out + k * 4 * NL, r);
  }
}

void h_base_mul(const int32_t* table, const int32_t* nib, int32_t* out, int n) {
  for (int k = 0; k < n; ++k) st(out + k * 4 * NL, base_mul_lane(table, nib + k * 64));
}

// p [n, 4, NL] -> table coordinates [16, NL, n] each: the four parts'
// chains in turn, each quad's roles in turn
void h_msm_table(const int32_t* p, int32_t* tx, int32_t* ty, int32_t* tz, int32_t* tt, int n) {
  for (int i = 0; i < n; ++i) msm_table_lane(ld(p + i * 4 * NL), tx, ty, tz, tt, i, n);
}

// what msm_acc_kernel does for every (row, window, lane)
void h_msm_acc(const int32_t* digits, const int32_t* tx, const int32_t* ty, const int32_t* tz,
               const int32_t* tt, int32_t* wx, int32_t* wy, int32_t* wz, int32_t* wt, int rows,
               int tiles) {
  const long n = (long)rows * tiles * MSM_LANES;
  for (int r = 0; r < rows; ++r)
    for (int w = 0; w < MSM_WINDOWS; ++w)
      for (int j = 0; j < MSM_LANES; ++j) {
        const long first = (long)r * tiles * MSM_LANES + j;
        const ge acc =
            msm_acc_lane(digits + w * n, tx, ty, tz, tt, first, tiles, msm_slices(tiles), n);
        ge_store_strided(wx, wy, wz, wt, ((long)r * MSM_WINDOWS + w) * NL * MSM_LANES + j,
                         MSM_LANES, acc);
      }
}

// what msm_tail_kernel does for every row: the 64 lane trees in the
// kernel's order, then the quad's Horner chain with its roles run in turn
void h_msm_tail(const int32_t* wx, const int32_t* wy, const int32_t* wz, const int32_t* wt,
                int32_t* out, int rows) {
  for (int r = 0; r < rows; ++r) {
    const long row = (long)r * MSM_WINDOWS * NL * MSM_LANES;
    st(out + r * 4 * NL, msm_tail_row(wx + row, wy + row, wz + row, wt + row));
  }
}

// the quads' point operations, roles run in turn: op 0 double (T), 1 double
// (no T), 2 p + cached(q), 3 cached(p)
void h_quad(int op, const int32_t* p, const int32_t* q, int32_t* out, int n) {
  const QuadHost h;
  for (int k = 0; k < n; ++k) {
    const ge a = ld(p + k * 4 * NL), b = ld(q + k * 4 * NL);
    QuadHost::V v{{a.x, a.y, a.z, a.t}};
    const QuadHost::V w{{b.x, b.y, b.z, b.t}};
    switch (op) {
      case 0: quad_double<true>(h, v); break;
      case 1: quad_double<false>(h, v); break;
      case 2: quad_add(h, v, quad_to_cached(h, w)); break;
      default: v = quad_to_cached(h, v); break;
    }
    st(out + k * 4 * NL, ge{v.c[0], v.c[1], v.c[2], v.c[3]});
  }
}

// nibbles int32 [n, 64] -> signed digits int8 [n, 65]
void h_signed_radix16(const int32_t* nib, int8_t* out, int n) {
  for (int k = 0; k < n; ++k) signed_radix16(nib + k * 64, out + k * SIGNED_DIGITS, 1);
}

int h_msm_lanes() { return MSM_LANES; }

// states uint8 [n, 200], little-endian lanes (this harness runs on x86);
// split 1: the kernel's round with its 25 lanes run in turn, 0: the
// one-thread reference
void h_keccak(const uint8_t* in, uint8_t* out, int n, int split) {
  for (int i = 0; i < n; ++i) {
    uint64_t a[25];
    memcpy(a, in + i * 200, 200);
    if (split)
      keccak_f1600_split(a);
    else
      keccak_f1600_lanes(a);
    memcpy(out + i * 200, a, 200);
  }
}
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    h = hashlib.sha256(HARNESS.encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    out_dir = os.path.join(REPO, "build", "quisquis_tpu_torch_host", h.hexdigest()[:16])
    so = os.path.join(out_dir, "libqq_host.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "harness.cpp")
        with open(src, "w") as f:
            f.write(HARNESS)
        tmp = f"{so}.{os.getpid()}"
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC,
                        "-o", tmp, src], check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.h_fe.argtypes = [ci, vp, vp, vp, ci]
    lib.h_ge.argtypes = [ci, vp, vp, vp, vp, ci]
    lib.h_base_mul.argtypes = [vp, vp, vp, ci]
    lib.h_msm_table.argtypes = [vp] * 5 + [ci]
    lib.h_msm_acc.argtypes = [vp] * 9 + [ci, ci]
    lib.h_msm_tail.argtypes = [vp] * 5 + [ci]
    lib.h_quad.argtypes = [ci, vp, vp, vp, ci]
    lib.h_signed_radix16.argtypes = [vp, vp, ci]
    lib.h_keccak.argtypes = [vp, vp, ci, ci]
    for fn in (lib.h_fe, lib.h_ge, lib.h_base_mul, lib.h_msm_table, lib.h_msm_acc,
               lib.h_msm_tail, lib.h_quad, lib.h_signed_radix16, lib.h_keccak):
        fn.restype = None
    lib.h_msm_lanes.restype = ci
    return lib


def test_each_source_compiles_alone():
    """Every .cu file compiles on its own as C++ (its includes complete
    without the harness's other files); the CUDA-only parts are skipped
    there, the GPU build checks them."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    sources = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    assert set(sources) >= {"scalar_mul.cu", "msm_tail.cu"}
    procs = [(f, subprocess.Popen([cxx, "-std=c++17", "-fsyntax-only", "-x", "c++",
                                   os.path.join(CSRC, f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for f in sources]
    results = {f: (p.communicate(timeout=300)[0], p.returncode) for f, p in procs}
    assert {f: out for f, (out, rc) in results.items() if out or rc} == {}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _fe_call(lib, op, a, b):
    out = np.zeros_like(a)
    lib.h_fe(op, _ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def _points_np(points) -> np.ndarray:
    ep = pt.from_exact_batch(points, device="cpu")
    return np.ascontiguousarray(np.stack([c.numpy() for c in ep], axis=1))


def _ext(arr: np.ndarray) -> pt.ExtPoint:
    return pt.ExtPoint(*(torch.as_tensor(arr[:, i].copy()) for i in range(4)))


def _inputs():
    r = random.Random(4242)
    xs = [r.randrange(P) for _ in range(28)] + [0, 1, P - 1, P - 19]
    ys = [r.randrange(P) for _ in range(32)]
    a, b = fe.from_int_batch(xs), fe.from_int_batch(ys)
    # every limb at its largest allowed value (non-canonical: value > p)
    worst = np.array([fe.CONTRACT] * 4, dtype=np.int32)
    return np.concatenate([a, worst]), np.concatenate([b, worst]), \
        xs + fe.to_int_batch(worst), ys + fe.to_int_batch(worst)


@pytest.mark.parametrize("op,name", [(0, "mul"), (1, "square"), (2, "add"), (3, "sub"),
                                     (4, "neg"), (6, "mul_small2")])
def test_field_ops(lib, op, name):
    a, b, xs, ys = _inputs()
    got = _fe_call(lib, op, a, b)
    ref = {
        "mul": lambda x, y: x * y, "square": lambda x, y: x * x,
        "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
        "neg": lambda x, y: -x, "mul_small2": lambda x, y: 2 * x,
    }[name]
    assert fe.to_int_batch(got) == [ref(x, y) % P for x, y in zip(xs, ys)]
    assert all(int(v) <= c for row in got for v, c in zip(row, fe.CONTRACT))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    plain = {
        "mul": lambda: fe.mul(ta, tb), "square": lambda: fe.square(ta),
        "add": lambda: fe.add(ta, tb), "sub": lambda: fe.sub(ta, tb),
        "neg": lambda: fe.neg(ta), "mul_small2": lambda: fe.mul_small(ta, 2),
    }[name]()
    assert np.array_equal(got, plain.numpy())


def test_invert(lib):
    a, b, xs, _ = _inputs()
    got = _fe_call(lib, 5, a, b)
    assert fe.to_int_batch(got) == [pow(x, P - 2, P) for x in xs]


def test_point_double_add(lib):
    r = random.Random(99)
    ps = [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(8)]
    qs = [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(8)]
    pa, qa = _points_np(ps), _points_np(qs)
    nib = np.zeros((8, 64), dtype=np.int32)
    for op, ref in ((0, [ex.pt_double(p) for p in ps]),
                    (2, [ex.pt_add(p, q) for p, q in zip(ps, qs)])):
        out = np.zeros_like(pa)
        lib.h_ge(op, _ptr(pa), _ptr(qa), _ptr(nib), _ptr(out), 8)
        got = pt.to_exact_batch(_ext(out))
        assert all(ex.pt_eq(g, e) for g, e in zip(got, ref))
        plain = pt.double(_ext(pa)) if op == 0 else pt.add(_ext(pa), _ext(qa))
        assert np.array_equal(out, np.stack([c.numpy() for c in plain], axis=1))
    # without T the doubling keeps the input's T and the same X, Y, Z
    out = np.zeros_like(pa)
    lib.h_ge(1, _ptr(pa), _ptr(qa), _ptr(nib), _ptr(out), 8)
    assert np.array_equal(out[:, 3], pa[:, 3])
    full = pt.double(_ext(pa))
    assert np.array_equal(out[:, :3], np.stack([c.numpy() for c in full[:3]], axis=1))
    # the quads' operations, roles run in turn: limb for limb the one-thread
    # doubling, add_cached and to_cached, and exact
    def quad(op):
        out = np.zeros_like(pa)
        lib.h_quad(op, _ptr(pa), _ptr(qa), _ptr(out), 8)
        return out

    tp, tq = _ext(pa), _ext(qa)
    for op, plain in ((0, pt.double(tp)), (1, pt.double(tp, need_t=False)),
                      (2, pt.add_cached(tp, pt.to_cached(tq))), (3, pt.to_cached(tp))):
        assert np.array_equal(quad(op), np.stack([c.numpy() for c in plain], axis=1))
    assert all(ex.pt_same(g, ex.pt_add(p, q))
               for g, p, q in zip(pt.to_exact_batch(_ext(quad(2))), ps, qs))


def _nibbles_of(values) -> np.ndarray:
    """256-bit integers, not reduced mod l -> int32 [n, 64] nibbles."""
    return np.array([[(v >> (4 * w)) & 15 for w in range(64)] for v in values],
                    dtype=np.int32)


def _edge_cases():
    """(integers, points) at the signed recoding's edges: 0, 1, l-1, 2^256-1
    (every nibble 15), top nibbles 8 and 15 (a carry into digit 64), on
    random points, the identity, a point of order 8 and one with an 8-torsion
    component."""
    r = random.Random(5)
    t8 = ex.eight_torsion()
    p = [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(10)]
    top8, top15 = 8 * 16**63 + r.randrange(16**63), 15 * 16**63 + r.randrange(16**63)
    values = [0, 1, ex.L - 1, 2**256 - 1, top8, top15, 2**256 - 1, top15, ex.L - 1,
              r.randrange(2**256)]
    points = p[:6] + [ex.IDENTITY, t8, ex.pt_add(p[8], t8), t8]
    return values, points


def test_scalar_mul_lane(lib):
    values, points = _edge_cases()
    pa = _points_np(points)
    nib = _nibbles_of(values)
    out = np.zeros_like(pa)
    lib.h_ge(3, _ptr(pa), _ptr(pa), _ptr(nib), _ptr(out), len(values))
    got = pt.to_exact_batch(_ext(out))
    assert all(ex.pt_same(g, ex.pt_mul_int(v, p)) for g, v, p in zip(got, values, points))
    plain = pt.scalar_mul(torch.as_tensor(nib), _ext(pa))
    assert np.array_equal(out, np.stack([c.numpy() for c in plain], axis=1))
    digits = np.zeros((len(values), pt.SIGNED_DIGITS), dtype=np.int8)
    lib.h_signed_radix16(_ptr(nib), _ptr(digits), len(values))
    assert np.array_equal(digits, pt.signed_digits(torch.as_tensor(nib)).numpy())
    assert digits.min() >= -8 and digits.max() <= 8 and set(digits[:, 64]) == {0, 1}
    assert [sum(int(d) << (4 * w) for w, d in enumerate(row)) for row in digits] == values


def test_base_mul_lane(lib):
    """base_mul.cu's lane (its four parts run in turn, then the fold) against
    the plain version limb for limb and exact.py, edge nibbles included: all
    zeros, all 15s (2^256 - 1), top nibbles 8 and 15 (a carry into the 65th
    signed digit) and scalars >= l, which B's order l reduces."""
    scalars = [0, 1, 2, ex.L - 1, 2**252, int("f" * 63, 16) % ex.L, 16, 12345678,
               2**256 - 1, 8 * 16**63 + 98765, 15 * 16**63 + 4321, ex.L, ex.L + 5, 2**253 + 3]
    nib = _nibbles_of(scalars)
    assert nib[0].max() == 0 and nib[8].min() == 15 and (nib[9, 63], nib[10, 63]) == (8, 15)
    table = np.ascontiguousarray(pt.niels_base_table_np())
    out = np.zeros((len(scalars), 4, fe.NLIMBS), dtype=np.int32)
    lib.h_base_mul(_ptr(table), _ptr(nib), _ptr(out), len(scalars))
    enc = pt.compress_to_bytes(_ext(out))
    for row, s in zip(enc, scalars):
        assert bytes(row) == ex.ristretto_encode(ex.pt_base_mul(s % ex.L))
    plain = pt.base_mul(torch.as_tensor(nib))
    assert np.array_equal(out, np.stack([c.numpy() for c in plain], axis=1))


def _coords_np(p: pt.ExtPoint):
    return [np.ascontiguousarray(c.numpy()) for c in p]


def test_msm_stages_equal_plain(lib):
    """The per-lane bodies of msm_table.cu, msm_acc.cu and msm_tail.cu, driven
    over (row, window, lane) as the kernels' grids are, against the plain
    versions limb for limb: 2 rows of 2 tiles, the last tile identity padding.
    Row 0 starts with the edge cases of scalar_mul (integers up to 2^256-1,
    the identity, a point of order 8)."""
    assert lib.h_msm_lanes() == qmsm.MSM_LANES
    rows, k = 2, qmsm.MSM_LANES + 3
    r = random.Random(77)
    scalars = [r.randrange(ex.L) for _ in range(rows * k)]
    points = [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(rows * k)]
    edge_values, edge_points = _edge_cases()
    scalars[:len(edge_values)], points[:len(edge_points)] = edge_values, edge_points
    nib = torch.as_tensor(_nibbles_of(scalars)).reshape(rows, k, 64)
    flat = pt.from_exact_batch(points, "cpu")
    digits, padded = kp.pad_rows(nib, pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS) for c in flat)))
    n = padded.x.shape[0]
    assert n == rows * 2 * qmsm.MSM_LANES

    want_table = qmsm.msm_table(padded)
    table = [np.zeros((16, fe.NLIMBS, n), dtype=np.int32) for _ in range(4)]
    p_np = np.ascontiguousarray(np.stack(_coords_np(padded), axis=1))
    lib.h_msm_table(_ptr(p_np), *map(_ptr, table), n)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(table, want_table))

    want_sums = qmsm.msm_window_sums(digits, want_table, rows)
    sums = [np.zeros((rows, 64, fe.NLIMBS, qmsm.MSM_LANES), dtype=np.int32) for _ in range(4)]
    d_np = np.ascontiguousarray(digits.numpy())
    lib.h_msm_acc(_ptr(d_np), *map(_ptr, table), *map(_ptr, sums), rows, 2)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(sums, want_sums))

    want = qmsm.msm_tail(want_sums)
    out = np.zeros((rows, 4, fe.NLIMBS), dtype=np.int32)
    lib.h_msm_tail(*map(_ptr, sums), _ptr(out), rows)
    assert np.array_equal(out, np.stack(_coords_np(want), axis=1))
    e = len(edge_values)
    edge = ex.IDENTITY
    for v, p in zip(edge_values, edge_points):
        edge = ex.pt_add(edge, ex.pt_mul_int(v, p))
    want_rows = [ex.pt_add(edge, ex.pt_msm(scalars[e:k], points[e:k])),
                 ex.pt_msm(scalars[k:], points[k:])]
    assert all(ex.pt_same(g, w) for g, w in zip(pt.to_exact_batch(_ext(out)), want_rows))


@pytest.fixture(scope="module")
def tile_table():
    """The table of one tile's points (random multiples of B)."""
    rng = np.random.default_rng(128)
    nib = torch.as_tensor(rng.integers(0, 16, size=(qmsm.MSM_LANES, 64), dtype=np.int32))
    return qmsm.msm_table(pt.base_mul(nib))


@pytest.mark.parametrize("rows,tiles", [(1, 5), (1, 11), (2, 5)])
def test_msm_window_sums_in_uneven_slices(lib, tile_table, rows, tiles):
    """Rows whose tiles do not split evenly into msm_acc.cu's slices (5 tiles
    in 2 slices; 11 in 4, so slice 3 gets one tile fewer; 5 in 2 at two
    rows), so that the fold adds sums of different lengths in the kernel's
    order. Limb for limb against the plain version."""
    slices = qmsm.msm_slices(tiles)
    assert (slices, tiles % slices) == {5: (2, 1), 11: (4, 3)}[tiles]
    n = rows * tiles * qmsm.MSM_LANES
    rng = np.random.default_rng(tiles)
    digits = torch.as_tensor(rng.integers(0, 16, size=(64, n), dtype=np.int32))
    # one tile's points in every tile (the digits differ)
    table = pt.ExtPoint(*(c.repeat(1, 1, n // qmsm.MSM_LANES) for c in tile_table))
    want = qmsm.msm_window_sums(digits, table, rows)
    sums = [np.zeros((rows, 64, fe.NLIMBS, qmsm.MSM_LANES), dtype=np.int32) for _ in range(4)]
    lib.h_msm_acc(_ptr(np.ascontiguousarray(digits.numpy())), *map(_ptr, _coords_np(table)),
                  *map(_ptr, sums), rows, tiles)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(sums, want))


def test_keccak_permutation_equals_plain_and_host(lib):
    """keccak_f1600.cu's round, its 25 lanes run in turn through the host
    exchange policy, and the one-thread reference: byte for byte the plain
    version and ops/keccak.py on the zero state, the all-0xFF state and
    random states."""
    states = np.random.default_rng(8).integers(0, 256, (5, 200), dtype=np.uint8)
    states[0] = 0
    states[1] = 255
    want = dk.f1600_plain(torch.as_tensor(states)).numpy()
    for row, got in zip(states, want):
        st_ = bytearray(row.tobytes())
        keccak.keccak_f1600(st_)
        assert bytes(st_) == got.tobytes()
    for split in (1, 0):
        out = np.zeros_like(states)
        lib.h_keccak(_ptr(states), _ptr(out), 5, split)
        assert np.array_equal(out, want)


def test_msm_table_parts_equal_plain(lib):
    """msm_table.cu's body: the four parts' chains, each quad's roles run in
    turn through QuadHost, store every entry (the table starts as -1s),
    limb for limb the plain msm_table and exact.py, on the identity, a
    point of order 8, a point with an 8-torsion component and random
    points."""
    r = random.Random(16)
    t8 = ex.eight_torsion()
    points = [ex.IDENTITY, t8] + [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(5)]
    points[2] = ex.pt_add(points[2], t8)
    p = pt.from_exact_batch(points, "cpu")
    n = len(points)
    table = [np.full((16, fe.NLIMBS, n), -1, dtype=np.int32) for _ in range(4)]
    p_np = np.ascontiguousarray(np.stack(_coords_np(p), axis=1))
    lib.h_msm_table(_ptr(p_np), *map(_ptr, table), n)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(table, qmsm.msm_table(p)))
    # point-major [n * 16, NL]: row 16 i + k is k * points[i]
    got = pt.to_exact_batch(pt.ExtPoint(*(
        torch.as_tensor(c.transpose(2, 0, 1).reshape(n * 16, fe.NLIMBS).copy()) for c in table)))
    assert all(ex.pt_same(got[i * 16 + k], ex.pt_mul_int(k, q))
               for i, q in enumerate(points) for k in range(16))
