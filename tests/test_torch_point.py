"""The port's plain point functions and scalar multiplications against its
exact backend and the JAX package (mirrors tests/test_point_jax.py and, at
the same scalars and shapes, tests/test_pallas_kernels.py)."""

import hashlib
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quisquis_tpu.ops import point as jpt
from quisquis_tpu.ops.pallas_point import base_mul_pallas
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt

rng = random.Random(777)
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_points(n):
    return [ex.pt_mul(rng.randrange(1, ex.L), ex.BASEPOINT) for _ in range(n)]


def assert_pt_eq(p: pt.ExtPoint, expected):
    got = pt.to_exact_batch(p)
    assert len(got) == len(expected)
    assert all(ex.pt_eq(g, e) for g, e in zip(got, expected))


def encodings(p: pt.ExtPoint):
    return [bytes(r) for r in pt.compress_to_bytes(p)]


def jax_encodings(p: jpt.ExtPoint):
    """Encode a JAX result with the exact backend (no JAX compress compile)."""
    return [ex.ristretto_encode(q) for q in jpt.to_exact_batch(p)]


def test_scalar_mul_matches_jax():
    """tests/test_pallas_kernels.py's scalars and points; the JAX side is
    pt.scalar_mul, which that file holds bit-exact against the kernel."""
    scalars = [0, 1, 7, ex.L - 1, 2**200 + 12345, 3, 2**64, 55555]
    host_pts = [ex.pt_base_mul(s) for s in [11, 22, 33, 44, 55, 66, 77, 88]]
    nib_np = pt.scalars_to_nibbles(scalars)
    jout = jpt.scalar_mul(jnp.asarray(nib_np), jpt.from_exact_batch(host_pts))
    out = pt.scalar_mul(torch.as_tensor(nib_np), pt.from_exact_batch(host_pts, device="cpu"))
    expected = [ex.ristretto_encode(ex.pt_mul(s, p)) for s, p in zip(scalars, host_pts)]
    assert encodings(out) == expected
    assert jax_encodings(jout) == expected
    # the JAX result carried into the port compares equal point for point
    carried = interop.ext_point_from_jax([np.asarray(c) for c in jout], device="cpu")
    assert bool(torch.all(pt.eq(carried, out)))


def test_base_mul_matches_jax_pallas_interpret():
    """tests/test_pallas_kernels.py's scalars through the Pallas fixed-base
    kernel in interpret mode, its XLA reference and the port."""
    scalars = [0, 1, 2, ex.L - 1, 2**180 + 7, 16, 255, 12345678]
    nib_np = pt.scalars_to_nibbles(scalars)
    expected = [ex.ristretto_encode(ex.pt_base_mul(s)) for s in scalars]
    out = pt.base_mul(torch.as_tensor(nib_np))
    assert encodings(out) == expected
    kern = base_mul_pallas(jnp.asarray(nib_np), tile=8, interpret=True)
    assert jax_encodings(kern) == expected
    ref = jpt.base_mul(jnp.asarray(nib_np))
    assert jax_encodings(ref) == expected


def test_scalar_mul_edge_scalars():
    many15 = int("f" * 63, 16) % ex.L
    scalars = [0, 1, ex.L - 1, 2**252, many15, 15, 16, 2**252 - 1]
    pts = rand_points(len(scalars))
    nib = torch.as_tensor(pt.scalars_to_nibbles(scalars))
    out = pt.scalar_mul(nib, pt.from_exact_batch(pts, device="cpu"))
    assert encodings(out) == [ex.ristretto_encode(ex.pt_mul(s, p)) for s, p in zip(scalars, pts)]
    assert encodings(pt.base_mul(nib)) == [ex.ristretto_encode(ex.pt_base_mul(s)) for s in scalars]
    # any 256-bit integer, as the JAX function takes: a top nibble of 8 or
    # 15 carries into the 65th signed digit; the identity and points with
    # 8-torsion, where s is not reduced mod l
    t8 = ex.eight_torsion()
    values = [2**256 - 1, 8 * 16**63 + 9, 15 * 16**63 + 3, 2**256 - 1, 15 * 16**63 + 1,
              ex.L - 1, 2**256 - 1, ex.L]
    points = pts[:3] + [ex.IDENTITY, t8, ex.pt_add(pts[5], t8), t8, pts[7]]
    nib_np = np.array([[(v >> (4 * w)) & 15 for w in range(64)] for v in values],
                      dtype=np.int32)
    assert pt.signed_digits(torch.as_tensor(nib_np))[:, 64].tolist() == [1, 1, 1, 1, 1, 0, 1, 0]
    out = pt.scalar_mul(torch.as_tensor(nib_np), pt.from_exact_batch(points, device="cpu"))
    want = [ex.pt_mul_int(v, p) for v, p in zip(values, points)]
    assert all(ex.pt_same(g, w) for g, w in zip(pt.to_exact_batch(out), want))
    jout = jpt.scalar_mul(jnp.asarray(nib_np), jpt.from_exact_batch(points))
    assert all(ex.pt_same(g, w) for g, w in zip(jpt.to_exact_batch(jout), want))


def test_add_double_neg_sub():
    ps, qs = rand_points(B), rand_points(B)
    tp, tq = pt.from_exact_batch(ps, device="cpu"), pt.from_exact_batch(qs, device="cpu")
    assert_pt_eq(pt.add(tp, tq), [ex.pt_add(p, q) for p, q in zip(ps, qs)])
    assert_pt_eq(pt.double(tp), [ex.pt_double(p) for p in ps])
    assert_pt_eq(pt.neg(tp), [ex.pt_neg(p) for p in ps])
    assert_pt_eq(pt.sub(tp, tq), [ex.pt_sub(p, q) for p, q in zip(ps, qs)])
    # without T: same X, Y, Z; T passed through
    no_t = pt.double(tp, need_t=False)
    full = pt.double(tp)
    assert all(torch.equal(a, b) for a, b in zip(no_t[:3], full[:3]))
    assert torch.equal(no_t.t, tp.t)


def test_eq_and_identity():
    ps = rand_points(B)
    tp = pt.from_exact_batch(ps, device="cpu")
    assert bool(torch.all(pt.eq(tp, tp)))
    assert not bool(torch.any(pt.eq(tp, pt.from_exact_batch(ps[1:] + ps[:1], device="cpu"))))
    assert bool(torch.all(pt.is_identity(pt.identity((B,), device="cpu"))))
    assert not bool(torch.any(pt.is_identity(tp)))
    assert bool(torch.all(pt.eq(pt.double(tp), pt.add(tp, tp))))
    # coset-aware: P + T4 (a 4-torsion point) equals P as a ristretto element
    t4 = (0, ex.P - 1, 1, 0)  # (0, -1): order 2, in the ristretto identity coset
    shifted = pt.from_exact_batch([ex.pt_add(p, t4) for p in ps], device="cpu")
    assert bool(torch.all(pt.eq(tp, shifted)))


def test_compress_decompress():
    ps = rand_points(B)
    tp = pt.from_exact_batch(ps, device="cpu")
    assert encodings(tp) == [ex.ristretto_encode(p) for p in ps]
    assert encodings(pt.identity((2,), device="cpu"))[0] == b"\x00" * 32
    encs = np.stack([np.frombuffer(ex.ristretto_encode(p), dtype=np.uint8) for p in ps])
    ok, dp = pt.decompress_from_bytes(encs, device="cpu")
    assert bool(torch.all(ok))
    assert_pt_eq(dp, ps)
    bad = encs.copy()
    bad[0] = 0
    bad[0, 0] = 1  # field element 1: 1-ss=0 -> y=0 -> reject
    bad[1, 31] |= 0x80  # high bit set: non-canonical
    ok2, _ = pt.decompress_from_bytes(bad, device="cpu")
    assert ok2.tolist() == [False, False] + [True] * (B - 2)


def test_elligator_map_and_sum():
    uni = np.stack([np.frombuffer(hashlib.sha3_512(b"seed%d" % i).digest(), dtype=np.uint8)
                    for i in range(B)])
    assert_pt_eq(pt.from_uniform_bytes(uni, device="cpu"),
                 [ex.ristretto_from_uniform_bytes(bytes(u)) for u in uni])
    ps = rand_points(7)  # odd length exercises padding
    total = pt.sum_points(pt.from_exact_batch(ps, device="cpu"), 0)
    expected = ps[0]
    for p in ps[1:]:
        expected = ex.pt_add(expected, p)
    assert_pt_eq(pt.ExtPoint(*(c[None] for c in total)), [expected])
