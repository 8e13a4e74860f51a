"""The port's scalar field (mod l) against ``exact.sc_*`` and against the JAX
package's ``ops/scalar_field.py``, at canonical ints mod l. Exact: no
tolerance. JAX functions are called at shape [4] only (small jits)."""

import random

import numpy as np
import pytest
import torch

from quisquis_tpu.ops import scalar_field as jsf
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt
from quisquis_tpu_torch.ops import scalar_field as sf

L = ex.L
rng = random.Random(20262)
XS = [rng.randrange(L) for _ in range(20)] + [0, 1, L - 1, L - 2]
YS = [rng.randrange(L) for _ in range(24)]
WORST = torch.full((2, sf.NLIMBS), sf.LOOSE, dtype=torch.int64)  # loose: value > l


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands():
    a = torch.cat([sf.scalars_to_dev(XS, "cpu"), WORST])
    b = torch.cat([sf.scalars_to_dev(YS, "cpu"), WORST])
    return a, b, XS + sf.to_int_batch(WORST), YS + sf.to_int_batch(WORST)


def _check(t, want):
    """t is within the loose contract, has the wanted values mod l, and
    canonicalize gives their exact digits."""
    want = [v % L for v in want]
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) <= sf.LOOSE
    assert sf.to_int_batch(t) == want
    c = sf.canonicalize(t)
    assert 0 <= int(c.min()) and int(c.max()) <= sf.MASK
    assert np.array_equal(c.reshape(-1, sf.NLIMBS).numpy(), sf.from_int_batch(want))


@pytest.mark.parametrize("name", ["mul", "add", "sub", "neg"])
def test_ring_ops_equal_exact(name):
    a, b, xs, ys = _operands()
    got = {"mul": lambda: sf.mul(a, b), "add": lambda: sf.add(a, b),
           "sub": lambda: sf.sub(a, b), "neg": lambda: sf.neg(a)}[name]()
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y, "neg": lambda x, y: -x}[name]
    _check(got, [ref(x, y) for x, y in zip(xs, ys)])


def test_canonicalize_around_multiples_of_l():
    vals = [k * L + d for k in range(6) for d in (-1, 0, 1) if k * L + d >= 0]
    limbs = torch.tensor([[(v >> (sf.BITS * i)) & sf.MASK for i in range(sf.NLIMBS)]
                          for v in vals])
    _check(limbs, vals)
    a, b, _, _ = _operands()
    assert sf.eq(sf.add(a, b), sf.add(b, a)).all()
    assert sf.is_zero(sf.sub(a, a)).all() and not sf.is_zero(a)[0]


def test_bytes_and_nibbles():
    a, _, xs, _ = _operands()
    assert [bytes(r) for r in sf.to_bytes_array(a).numpy()] == [ex.sc_to_bytes(x % L) for x in xs]
    assert np.array_equal(sf.to_nibbles(a).numpy(), pt.scalars_to_nibbles([x % L for x in xs]))
    b = np.random.default_rng(5).integers(0, 256, size=(6, 64), dtype=np.uint8)
    b[0] = 255  # the largest 512-bit and 256-bit values
    ints = [int.from_bytes(bytes(r), "little") for r in b]
    _check(sf.from_bytes_wide(torch.as_tensor(b)), ints)
    _check(sf.from_bytes(torch.as_tensor(b[:, :32])), [v % (1 << 256) for v in ints])
    assert sf.to_int_batch(sf.from_bytes_wide(torch.as_tensor(b))) == \
        [ex.sc_from_bytes_mod_order_wide(bytes(r)) for r in b]


def test_powers_inversion_and_sums():
    a = sf.scalars_to_dev(XS[:6] + [1], "cpu")
    xs = XS[:6] + [1]
    _check(sf.invert(a), [ex.sc_invert(x) for x in xs])
    _check(sf.powers(a, 7), [pow(x, k, L) for x in xs for k in range(7)])
    _check(sf.powers(a, 1), [1] * 7)
    _check(sf.pow_const(a, 0), [1] * 7)
    _check(sf.pow_const(a, 37), [pow(x, 37, L) for x in xs])
    rows = [[rng.randrange(1, L) for _ in range(5)] for _ in range(3)]
    m = sf.scalars_to_dev(sum(rows, []), "cpu").reshape(3, 5, sf.NLIMBS)
    _check(sf.batch_invert_rows(m), sum((ex.sc_batch_invert(r) for r in rows), []))
    _check(sf.sum_over(m, 1), [sum(r) for r in rows])
    big = WORST[:1].expand(4096, 1, sf.NLIMBS)
    _check(sf.sum_over(big, 0), [4096 * sf.to_int_batch(WORST[:1])[0]])
    assert sf.dev_to_scalars(sf.const(L + 5, (2,), "cpu")) == [5, 5]
    assert sf.to_int(sf.zeros((), "cpu")) == 0 and sf.to_int(sf.one((), "cpu")) == 1
    assert sf.to_int(sf.from_int(L + 3)) == 3


def test_equals_jax_scalar_field():
    """The same seeded inputs through the JAX functions and the port's, at
    shape [4]; limbs carried across by interop."""
    xs, ys = XS[:3] + [L - 1], YS[:4]
    ja, jb = jsf.scalars_to_dev(xs), jsf.scalars_to_dev(ys)
    a = interop.scalar_limbs_from_jax(np.asarray(ja), device="cpu")
    b = interop.scalar_limbs_from_jax(np.asarray(jb), device="cpu")
    assert sf.to_int_batch(a) == xs
    for port, jax_out in ((sf.mul(a, b), jsf.mul(ja, jb)), (sf.add(a, b), jsf.add(ja, jb)),
                          (sf.sub(a, b), jsf.sub(ja, jb)), (sf.neg(a), jsf.neg(ja)),
                          (sf.invert(a), jsf.invert(ja))):
        assert sf.to_int_batch(port) == jsf.to_int_batch(np.asarray(jax_out))
        assert np.array_equal(interop.scalar_limbs_to_jax(port),
                              np.asarray(jsf.canonicalize(jax_out)))
    wide = np.random.default_rng(6).integers(0, 256, size=(4, 64), dtype=np.uint8)
    jw = jsf.from_bytes_wide(wide.astype(np.int32))
    pw = sf.from_bytes_wide(torch.as_tensor(wide))
    assert sf.to_int_batch(pw) == jsf.to_int_batch(np.asarray(jw))
    assert np.array_equal(sf.to_bytes_array(pw).numpy(), np.asarray(jsf.to_bytes_array(jw)))
    assert np.array_equal(sf.to_nibbles(pw).numpy(), np.asarray(jsf.to_nibbles(jw)))
    # loose JAX limbs arrive as their value mod l
    loose = np.full((2, jsf.NLIMBS), jsf.LOOSE, dtype=np.int32)
    assert sf.to_int_batch(interop.scalar_limbs_from_jax(loose, device="cpu")) == \
        jsf.to_int_batch(loose)
    with pytest.raises(ValueError):
        interop.scalar_limbs_from_jax(np.zeros((2, 10), np.int32), device="cpu")
