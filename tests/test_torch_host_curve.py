"""The C++ curve library of ``csrc/host_curve.cpp`` against the port's
pure-Python point functions, its plain versions, on the CPU (mirrors the
JAX package's tests/test_native_curve.py). Every comparison is exact: equal
ristretto encodings, or the same curve point. The oracle is both the
``exact.*_py`` aliases and a fresh copy of ``ops/exact.py`` loaded without
the dispatch, whose point functions are pure Python all the way down. Skips
without g++, as the host STROBE's tests do."""

import importlib.util
import random
import shutil

import pytest
import torch

from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import host_curve as hc

rng = random.Random(20261017)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    assert hc.available(), hc.build_error()
    assert ex.NATIVE_CURVE


@pytest.fixture(scope="module")
def plain():
    """ops/exact.py as a module of its own, never switched to the library."""
    spec = importlib.util.spec_from_file_location("exact_plain", ex.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not mod.NATIVE_CURVE
    return mod


def _points(k, plain):
    return [plain.pt_mul(rng.randrange(1, ex.L), plain.BASEPOINT) for _ in range(k)]


def test_the_exact_backend_dispatches_to_the_library():
    assert ex.pt_msm is not ex.pt_msm_py and ex.pt_add is hc.pt_add
    assert ex.ristretto_encode is hc.ristretto_encode
    assert hc.build_seconds() >= 0 and hc.build_error() == ""


def test_point_ops_equal_python(plain):
    for _ in range(20):
        s1, s2 = rng.randrange(ex.L), rng.randrange(ex.L)
        p, q = plain.pt_mul(s1, plain.BASEPOINT), ex.pt_mul(s1, ex.BASEPOINT)
        assert ex.ristretto_encode(q) == plain.ristretto_encode(p) == ex.ristretto_encode_py(p)
        a = plain.pt_add(p, plain.pt_mul(s2, plain.BASEPOINT))
        b = ex.pt_add(q, ex.pt_mul(s2, ex.BASEPOINT))
        assert ex.pt_same(a, b) and ex.ristretto_encode(b) == plain.ristretto_encode(a)
        assert ex.pt_same(ex.pt_double(q), plain.pt_double(p))
        assert ex.pt_same(ex.pt_base_mul(s2), plain.pt_base_mul(s2))


@pytest.mark.parametrize("s", [0, 1, 2, 8, ex.L - 2, ex.L - 1, ex.L, 2**252, 2**256 - 1])
def test_edge_scalars(s, plain):
    p = _points(1, plain)[0]
    assert ex.pt_same(ex.pt_mul(s, p), plain.pt_mul(s, p))
    assert ex.pt_same(ex.pt_mul(s, p), ex.pt_mul_py(s, p))
    assert ex.pt_same(ex.pt_base_mul(s), plain.pt_base_mul(s))


@pytest.mark.parametrize("n", [0, 1, 2, 15, 16, 33, 200])
def test_msm_equals_python(n, plain):
    ss = [rng.randrange(ex.L) for _ in range(n)]
    ps = _points(n, plain)
    assert ex.ristretto_encode(ex.pt_msm(ss, ps)) == plain.ristretto_encode(plain.pt_msm(ss, ps))
    assert ex.ristretto_encode(ex.pt_msm(ss, ps)) == ex.ristretto_encode_py(ex.pt_msm_py(ss, ps))


def test_msm_with_zero_scalars(plain):
    zs, ps = [0, 5, 0, ex.L - 1], _points(4, plain)
    assert ex.pt_same(ex.pt_msm(zs, ps), plain.pt_msm(zs, ps))
    assert ex.pt_same(ex.pt_msm([0, 0], ps[:2]), plain.IDENTITY)


def test_threaded_msm_equals_python(plain):
    """2,048 terms: the library splits them across threads (512 a thread)."""
    n = 2048
    base = _points(32, plain)
    ss = [rng.randrange(ex.L) for _ in range(n)]
    ps = [base[i % 32] for i in range(n)]
    assert ex.ristretto_encode(ex.pt_msm(ss, ps)) == plain.ristretto_encode(plain.pt_msm(ss, ps))


def test_batch_ops_equal_python(plain):
    n = 11
    ss = [rng.randrange(ex.L) for _ in range(n)]
    ts = [rng.randrange(ex.L) for _ in range(n)]
    ps, qs = _points(n, plain), _points(n, plain)
    got, want = ex.pt_mul_batch(ts, ps), plain.pt_mul_batch(ts, ps)
    assert all(ex.pt_same(g, w) for g, w in zip(got, want))
    aa, bb = [0] + ss[1:], ts[:-1] + [0]   # zero scalars start from the identity
    got, want = ex.pt_fold_batch(aa, bb, ps, qs), plain.pt_fold_batch(aa, bb, ps, qs)
    assert all(ex.pt_same(g, w) for g, w in zip(got, want))
    items = [(ss[:3], ps[:3]), (ts[:7], qs[:7]), ([0, 0], ps[:2]), ([], []), (ss, ps)]
    got, want = ex.pt_msm_many(items), plain.pt_msm_many(items)
    assert [ex.ristretto_encode(g) for g in got] == [plain.ristretto_encode(w) for w in want]
    assert ex.ristretto_encode_batch(ps) == plain.ristretto_encode_batch(ps)
    decoded = ex.ristretto_decode_batch(ex.ristretto_encode_batch(ps))
    assert all(ex.pt_eq(d, p) for d, p in zip(decoded, ps))


def test_decode_equals_python_and_rejects_invalid_encodings(plain):
    for k in (1, 7, 123456):
        enc = plain.ristretto_encode(plain.pt_mul(k, plain.BASEPOINT))
        got, want = ex.ristretto_decode(enc), plain.ristretto_decode(enc)
        assert got is not None and ex.pt_same(got, want)
    good = plain.ristretto_encode(plain.BASEPOINT)
    bad = bytearray(good)
    bad[0] |= 1                                    # odd: a "negative" field element
    noncanon = (ex.P + 3).to_bytes(32, "little")   # not reduced mod p
    high = good[:31] + bytes([good[31] | 0x80])    # the top bit set
    for blob in (bytes(bad), noncanon, high, good[:31], good + b"\0"):
        assert ex.ristretto_decode(blob) is None
        assert plain.ristretto_decode(blob) is None
    assert ex.ristretto_decode_batch([good, bytes(bad)]) is None
    assert ex.ristretto_decode_batch([good, good[:31]]) is None


def test_wire_form_is_cached_and_equal_to_the_coordinates():
    p = ex.pt_mul(12345, ex.BASEPOINT)
    assert p.wire == b"".join(c.to_bytes(32, "little") for c in p)
    from quisquis_tpu_torch.accounts.deferred import _pt_wire
    assert _pt_wire(p) == p.wire and _pt_wire(tuple(p)) == p.wire
