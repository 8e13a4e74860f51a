"""The port's torch field engine against its exact backend and the JAX
package's field, at canonical values (mirrors tests/test_field_jax.py)."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quisquis_tpu.ops import field as jfe
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import field as fe

rng = random.Random(12345)
P = ex.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_ints(n):
    return [rng.randrange(P) for _ in range(n - 4)] + [0, 1, P - 1, P - 19]


def T(xs):
    return torch.as_tensor(fe.from_int_batch(xs))


def worst(n=4):
    """Every limb at its contract maximum: a non-canonical value > p."""
    return torch.tensor([fe.CONTRACT] * n, dtype=torch.int32)


def test_roundtrip_int():
    xs = rand_ints(32)
    assert fe.to_int_batch(T(xs)) == xs
    assert fe.to_int(fe.from_int(P + 5)) == 5


def test_add_sub_neg_mul():
    xs, ys = rand_ints(64), rand_ints(64)
    a, b = T(xs), T(ys)
    assert fe.to_int_batch(fe.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert fe.to_int_batch(fe.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert fe.to_int_batch(fe.neg(a)) == [(-x) % P for x in xs]
    assert fe.to_int_batch(fe.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert fe.to_int_batch(fe.square(a)) == [x * x % P for x in xs]


def test_mul_worst_limbs_keep_contract():
    w = worst()
    wv = sum(c << o for c, o in zip(fe.CONTRACT, fe.OFF))
    assert wv > P
    acc, ref = w, wv % P
    for op, f in ((fe.mul, lambda r: r * wv), (fe.add, lambda r: r + wv),
                  (fe.sub, lambda r: r - wv), (fe.mul, lambda r: r * wv)):
        acc, ref = op(acc, w), f(ref) % P
        assert all(int(v) <= c for v, c in zip(acc[0], fe.CONTRACT))
    assert fe.to_int_batch(acc) == [ref] * 4
    assert fe.to_int_batch(fe.neg(w)) == [(-wv) % P] * 4


def test_mul_small():
    xs = rand_ints(32)
    a = T(xs)
    for c in (2, 19, 121665, 19 << 9, fe.MAX_SMALL):
        assert fe.to_int_batch(fe.mul_small(a, c)) == [x * c % P for x in xs]
    with pytest.raises(ValueError):
        fe.mul_small(a, fe.MAX_SMALL + 1)


def test_invert_and_pow():
    xs = rand_ints(16)
    inv = fe.to_int_batch(fe.invert(T(xs)))
    assert inv == [pow(x, P - 2, P) for x in xs]
    assert fe.to_int_batch(fe.pow_p58(T(xs))) == [pow(x, (P - 5) // 8, P) for x in xs]


def test_canonicalize_and_eq():
    xs = rand_ints(32)
    a = T(xs)
    b = fe.add(a, fe.add(T([P - 1] * 32), fe.ones((32,), device="cpu")))  # a + p
    assert bool(torch.all(fe.eq(a, b)))
    assert fe.to_int_batch(fe.canonicalize(b)) == xs
    assert bool(torch.all(fe.is_zero(fe.sub(a, a))))
    c = fe.canonicalize(worst())
    assert fe.to_int_batch(c) == [fe.to_int_batch(worst())[0] % P] * 4
    assert all(int(v) <= m for v, m in zip(c[0], fe.MASKS))


def test_is_negative_abs():
    xs = rand_ints(64)
    a = T(xs)
    assert fe.is_negative(a).tolist() == [bool(x & 1) for x in xs]
    assert fe.to_int_batch(fe.cabs(a)) == [ex.fe_abs(x) for x in xs]


def test_bytes_roundtrip():
    xs = rand_ints(64)
    bts = fe.to_bytes(T(xs))
    assert [bytes(r) for r in bts] == [ex.fe_to_bytes(x) for x in xs]
    assert fe.to_int_batch(fe.from_bytes(bts, device="cpu")) == xs
    top = np.full((1, 32), 0xFF, dtype=np.uint8)  # bit 255 ignored, value >= p
    assert fe.to_int_batch(fe.from_bytes(top, device="cpu")) == [((1 << 255) - 1) % P]


def test_sqrt_ratio_batched():
    cases = [(4, 1), (2, 1), (1, 1), (0, 1), (5, 7), (12345, 6789), (P - 1, 2), (3, P - 3)]
    ws, r = fe.sqrt_ratio_m1(T([c[0] for c in cases]), T([c[1] for c in cases]))
    rs = fe.to_int_batch(r)
    for i, (u, v) in enumerate(cases):
        assert (bool(ws[i]), rs[i]) == ex.sqrt_ratio_m1(u, v)


def test_matches_jax_field():
    """The same inputs through the JAX field and the port, B = 8, including
    the JAX package's all-max-limb inputs carried across by interop."""
    xs, ys = rand_ints(8), rand_ints(8)
    ja, jb = jfe.from_int_batch(xs), jfe.from_int_batch(ys)
    jworst = np.array([jfe.CONTRACT] * 8, dtype=np.int32)
    a = interop.limbs_from_jax(ja, device="cpu")
    b = interop.limbs_from_jax(jb, device="cpu")
    w = interop.limbs_from_jax(jworst, device="cpu")
    pairs = [
        (fe.mul(a, b), jfe.mul(jnp.asarray(ja), jnp.asarray(jb))),
        (fe.sub(a, b), jfe.sub(jnp.asarray(ja), jnp.asarray(jb))),
        (fe.mul(w, w), jfe.mul(jnp.asarray(jworst), jnp.asarray(jworst))),
        (fe.invert(a), jfe.invert(jnp.asarray(ja))),
    ]
    for port, jax_out in pairs:
        assert fe.to_int_batch(port) == jfe.to_int_batch(np.asarray(jax_out))
    jws, jr = jfe.sqrt_ratio_m1(jnp.asarray(ja), jnp.asarray(jb))
    ws, r = fe.sqrt_ratio_m1(a, b)
    assert ws.tolist() == np.asarray(jws).tolist()
    assert fe.to_int_batch(r) == jfe.to_int_batch(np.asarray(jr))
    assert [bytes(x) for x in fe.to_bytes(a)] == [bytes(x) for x in jfe.to_bytes(jnp.asarray(ja))]
