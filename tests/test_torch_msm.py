"""The port's multiscalar multiplication on the CPU (the plain versions of
the three CUDA kernels) against the exact backend and against the JAX
package's MSM. Exact: Ristretto encodings.

The JAX side is ``quisquis_tpu.ops.msm.msm``, which on the CPU is the XLA
form that the Pallas pipeline is itself tested against: tracing
``msm_pallas(interpret=True)`` takes 40-50 s and is not cached between
runs. The inputs are those of tests/test_pallas_kernels.py (seed b"pmsm",
n = 20), where the Pallas pipeline is held against the same
``exact.pt_msm`` value."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quisquis_tpu.ops import point as jpt
from quisquis_tpu.ops import msm as jmsm
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.ops import cuda_point as kp
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import field as fe
from quisquis_tpu_torch.ops import msm as qmsm
from quisquis_tpu_torch.ops import point as pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(tag: bytes, rows: int, k: int):
    r = SeededRng(seed=tag)
    scalars = [[r.random_scalar() for _ in range(k)] for _ in range(rows)]
    scalars[0][:3] = [0, 1, ex.L - 1][:k]
    points = [[ex.pt_base_mul(r.random_scalar()) for _ in range(k)] for _ in range(rows)]
    nib = torch.as_tensor(np.stack([pt.scalars_to_nibbles(s) for s in scalars]))
    flat = pt.from_exact_batch(sum(points, []), "cpu")
    return scalars, points, nib, pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS) for c in flat))


def _encodings(p: pt.ExtPoint):
    return [bytes(r) for r in pt.compress_to_bytes(p).reshape(-1, 32)]


def _recording(monkeypatch, module, name):
    """Keep (arguments, result) of every call of module.name, unchanged."""
    calls, real = [], getattr(module, name)

    def wrapper(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_msm_equals_jax_msm_and_exact(monkeypatch):
    """n = 20 as in tests/test_pallas_kernels.py: one padded tile in both.
    ``msm_host`` is the one call of the port's ``msm`` here: the Horner tail
    is 315 dependent point operations whatever the size."""
    scalars, points, nib, p = _inputs(b"pmsm", 1, 20)
    total = ex.pt_msm(scalars[0], points[0])
    want = ex.ristretto_encode(total)
    calls = _recording(monkeypatch, qmsm, "msm")
    assert ex.pt_eq(qmsm.msm_host(scalars[0], points[0], device="cpu"), total)
    [((got_nib, got_p), out)] = calls
    assert torch.equal(got_nib, nib[0])
    assert all(torch.equal(a[0], b) for a, b in zip(p, got_p))
    assert out.x.shape == (fe.NLIMBS,)
    assert _encodings(out) == [want]
    jout = jmsm.msm(jnp.asarray(nib[0].numpy()), jpt.from_exact_batch(points[0]))
    carried = interop.ext_point_from_jax([np.asarray(c)[None] for c in jout], device="cpu")
    assert _encodings(carried) == [want]


def test_msm_rows_pads_each_row_and_equals_exact(monkeypatch):
    """k = 129: two tiles a row, the second all identity padding but one."""
    scalars, points, nib, p = _inputs(b"rows", 2, 129)
    tails = _recording(monkeypatch, kp, "msm_tail")
    out = qmsm.msm_rows(nib, p)
    assert out.x.shape == (2, fe.NLIMBS)
    assert _encodings(out) == [ex.ristretto_encode(ex.pt_msm(s, q))
                               for s, q in zip(scalars, points)]
    # the stages, through the wrappers' CPU path, are the plain versions, and
    # msm_rows ran the tail on just these window sums
    digits, flat = kp.pad_rows(nib, p)
    assert digits.shape == (64, 2 * 256) and flat.x.shape == (2 * 256, fe.NLIMBS)
    table = kp.msm_table(flat)
    assert table.x.shape == (16, fe.NLIMBS, 512)
    want_table = pt.window_table(flat)
    assert all(torch.equal(a.permute(2, 0, 1), b) for a, b in zip(table, want_table))
    sums = kp.msm_window_sums(digits, table, 2)
    assert sums.x.shape == (2, 64, fe.NLIMBS, qmsm.MSM_LANES)
    [((ran_sums,), ran_out)] = tails
    assert all(torch.equal(a, b) for a, b in zip(ran_sums, sums))
    assert all(torch.equal(a, b) for a, b in zip(ran_out, out))
    with pytest.raises(ValueError):
        kp.msm_window_sums(digits[:, :500], table, 2)
    assert kp.msm_rows(nib[:0], pt.ExtPoint(*(c[:0] for c in p))).x.shape == (0, fe.NLIMBS)


def test_msm_shared_base_equals_exact():
    r = SeededRng(seed=b"shared")
    points = [ex.pt_base_mul(r.random_scalar()) for _ in range(5)]
    scalars = [[r.random_scalar() for _ in range(5)] for _ in range(3)]
    nib = torch.as_tensor(np.stack([pt.scalars_to_nibbles(s) for s in scalars]))
    out = qmsm.msm_shared_base(nib, pt.from_exact_batch(points, "cpu"))
    assert _encodings(out) == [ex.ristretto_encode(ex.pt_msm(s, points)) for s in scalars]
