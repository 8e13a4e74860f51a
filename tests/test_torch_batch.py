"""The port's batched commitments and account updates against the JAX
package's ops/batch.py at B = 8, and the port's flagship step."""

import random

import jax.numpy as jnp
import pytest
import torch

from quisquis_tpu.ops import batch as jqb
from quisquis_tpu.ops import point as jpt
from quisquis_tpu_torch import entry
from quisquis_tpu_torch.ops import batch as qb
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt

B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def state():
    r = random.Random(31337)
    sks = [r.randrange(1, ex.L) for _ in range(B)]
    gr = [ex.pt_base_mul(r.randrange(1, ex.L)) for _ in range(B)]
    grsk = [ex.pt_mul(sk, p) for sk, p in zip(sks, gr)]
    rs = [r.randrange(ex.L) for _ in range(B)]
    vs = [r.randrange(2**32) for _ in range(B - 2)] + [0, ex.L - 1]
    return sks, gr, grsk, rs, vs


@pytest.fixture(scope="module")
def committed(state):
    """The batch's keys and commitments in the port, made once for the module."""
    sks, gr, grsk, rs, vs = state
    pk = qb.BatchPk(pt.from_exact_batch(gr, device="cpu"), pt.from_exact_batch(grsk, device="cpu"))
    return pk, qb.generate_commitments(pk, _nib(rs), _nib(vs))


def _twice(p):
    """A point batch followed by itself: two checks in one call."""
    return pt.ExtPoint(*(torch.cat([c, c]) for c in p))


def _nib(xs):
    return torch.as_tensor(pt.scalars_to_nibbles(xs))


def _enc(p):
    return [bytes(x) for x in pt.compress_to_bytes(p)]


def _jenc(p):
    return [ex.ristretto_encode(q) for q in jpt.to_exact_batch(p)]


def test_generate_verify_matches_jax(state, committed):
    sks, gr, grsk, rs, vs = state
    _, comm = committed
    jpk = jqb.BatchPk(jpt.from_exact_batch(gr), jpt.from_exact_batch(grsk))
    jn = lambda xs: jnp.asarray(pt.scalars_to_nibbles(xs))  # noqa: E731
    jcomm = jqb.generate_commitments(jpk, jn(rs), jn(vs))
    assert _enc(comm.c) == _jenc(jcomm.c)
    assert _enc(comm.d) == _jenc(jcomm.d)
    expected_d = [ex.ristretto_encode(ex.pt_add(ex.pt_base_mul(v), ex.pt_mul(r_, h)))
                  for v, r_, h in zip(vs, rs, grsk)]
    assert _enc(comm.d) == expected_d
    # the right values, then the same lanes with lane 0's value off by one
    both = qb.verify_commitments(qb.BatchCommitment(_twice(comm.c), _twice(comm.d)),
                                 _nib(sks + sks), _nib(vs + [vs[0] + 1] + vs[1:]))
    assert both.tolist() == [True] * B + [False] + [True] * (B - 1)


def test_update_scale_add_sub(state, committed):
    sks, gr, grsk, rs, vs = state
    r = random.Random(7)
    uks = [r.randrange(ex.L) for _ in range(B)]
    cs = [r.randrange(ex.L) for _ in range(B)]
    bl = [r.randrange(2**32) for _ in range(B)]
    pk, comm = committed
    new_pk, new_comm = qb.update_accounts(pk, comm, _nib(bl), _nib(uks), _nib(cs))
    assert _enc(new_pk.gr) == [ex.ristretto_encode(ex.pt_mul(u, p)) for u, p in zip(uks, gr)]
    assert _enc(new_pk.grsk) == [ex.ristretto_encode(ex.pt_mul(u, p)) for u, p in zip(uks, grsk)]
    # the updated account still opens under the same key to v + bl
    # ... and not under its neighbour's key (second half of the same call)
    keys_ok = qb.verify_keypairs(qb.BatchPk(_twice(new_pk.gr), _twice(new_pk.grsk)),
                                 _nib(sks + sks[1:] + sks[:1]))
    assert keys_ok.tolist() == [True] * B + [False] * B
    vsum = [(v + b) % ex.L for v, b in zip(vs, bl)]
    assert qb.verify_commitments(new_comm, _nib(sks), _nib(vsum)).tolist() == [True] * B
    scaled = qb.scale_commitments(comm, _nib(uks))
    assert _enc(scaled.c) == [ex.ristretto_encode(ex.pt_mul(u, ex.pt_mul(r_, g)))
                              for u, r_, g in zip(uks, rs, gr)]
    diff = qb.sub_commitments(qb.add_commitments(comm, scaled), scaled)
    assert _enc(diff.c) == _enc(comm.c) and _enc(diff.d) == _enc(comm.d)


def test_flagship_step_and_entry_inputs():
    step, args = entry.entry(device="cpu")
    ok, cx, dx = step(*args)
    assert ok.tolist() == [True] * 8
    assert cx.shape == dx.shape == (8, 10)
    nibs = args[8:]
    assert all(n.shape == (8, 64) and n.dtype == torch.int32 for n in nibs)


def test_to_device_helpers_cpu():
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey
    from quisquis_tpu_torch.primitives.elgamal import ElGamalCommitment
    pts = [ex.pt_base_mul(s) for s in (3, 5)]
    pks = [RistrettoPublicKey.from_points(p, ex.pt_double(p)) for p in pts]
    bpk = qb.pks_to_device(pks, device="cpu")
    assert _enc(bpk.grsk) == [ex.ristretto_encode(ex.pt_double(p)) for p in pts]
    comms = [ElGamalCommitment.from_points(p, p) for p in pts]
    assert _enc(qb.comms_to_device(comms, device="cpu").d) == [ex.ristretto_encode(p) for p in pts]
    assert qb.scalars_to_device([1, 16], device="cpu")[:, :2].tolist() == [[1, 0], [0, 1]]
