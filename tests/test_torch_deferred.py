"""The port's deferred point checks (accounts/deferred.py) on the CPU: the
"host" and "device" backends give the same verdict, and the JAX package's
host backend gives it too, on honest and tampered shuffle batches, on terms
carried across a process boundary in wire form, and through
DeviceBatchCollector. Exact: accept or reject."""

import pytest
import torch

from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.accounts.verifier import Verifier as JaxVerifier
from quisquis_tpu.shuffle.shuffle import batch_verify_shuffle_proofs as jax_batch_verify
from quisquis_tpu_torch.accounts.deferred import (DeferredPointChecks, DeviceBatchCollector,
                                                  assert_identity)
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.shuffle.shuffle import batch_verify_shuffle_proofs
from tests.test_torch_shuffle import jax_entries, tampered

L = ex.L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def honest():
    return jax_entries(b"torch-deferred", 2, 2)


def _wrap(entries, port=True):
    make = (lambda: Verifier(b"Shuffle", Transcript(b"ShuffleProof"))) if port else \
        (lambda: JaxVerifier(b"Shuffle", JaxTranscript(b"ShuffleProof")))
    return [(p, make(), st, ins, outs) for p, st, ins, outs in entries]


def _accepts(fn) -> bool:
    try:
        fn()
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("what", ["honest", "hadamard a_bar", "multiexpo E_k_0"])
def test_host_and_device_backends_agree(honest, what):
    entries = honest if what == "honest" else tampered(honest, what)
    port = host_object_from_jax(entries)
    verdicts = {
        backend: _accepts(lambda: batch_verify_shuffle_proofs(
            _wrap(port), backend=backend, seed=b"d-" + what.encode(), device="cpu"))
        for backend in ("host", "device")}
    verdicts["jax host"] = _accepts(lambda: jax_batch_verify(
        _wrap(entries, port=False), backend="host", seed=b"d-" + what.encode()))
    assert set(verdicts.values()) == {what == "honest"}, verdicts


def _checks(seed, bad=False):
    """Two accumulators of identity checks (H = 7G); the second one's terms
    cross in wire form or by merge. With `bad`, check "d" is false."""
    g = ex.BASEPOINT
    h = ex.pt_base_mul(7)
    one = DeferredPointChecks(seed)
    two = one.derive(1)
    one.check([7, L - 1], [g, h], "a")                  # 7G - H == 0
    one.check_eq([7], [g], h, "b")                      # 7G == H
    two.check([1, L - 1], [h, h], "c")                  # H - H == 0
    two.check_eq([2, 3 if bad else 5], [h, g], ex.pt_base_mul(19), "d")  # 2H + 5G == 19G
    return one, two


def test_wire_export_absorb_and_merge():
    for bad in (False, True):
        verdicts = []
        for backend in ("host", "device"):
            one, two = _checks(b"wire", bad)
            sbuf, pbuf, labels = two.export_wire()
            assert len(sbuf) == 32 * two.num_terms and len(pbuf) == 128 * two.num_terms
            one.absorb_wire(sbuf, pbuf, labels)
            verdicts.append(_accepts(lambda: one.verify(backend=backend, device="cpu")))
        for backend in ("device", "auto"):   # "auto", the default, takes the host here
            merged, part = _checks(b"wire", bad)
            merged.merge(part)
            verdicts.append(_accepts(lambda: merged.verify(backend=backend, device="cpu")))
        assert verdicts == [not bad] * 4, (bad, verdicts)
    with pytest.raises(ValueError, match="malformed"):
        DeferredPointChecks(b"x").absorb_wire(b"\0" * 31, b"\0" * 128, [])
    with pytest.raises(ValueError, match="sharded backend requires a mesh"):
        _checks(b"x")[0].verify(backend="sharded")
    with pytest.raises(ValueError, match="unknown backend"):
        _checks(b"x")[0].verify(backend="tpu")
    DeferredPointChecks(b"empty").verify(backend="device", device="cpu")
    assert_identity(None, [1, L - 1], [ex.BASEPOINT, ex.BASEPOINT], "zero")
    with pytest.raises(ValueError, match="nonzero"):
        assert_identity(None, [1], [ex.BASEPOINT], "nonzero")


def _range_instance(tag, flip_at=None):
    rng = SeededRng(seed=tag)
    proof, V = RangeProof.prove_multiple(Transcript(b"RangeProof"), [5, 9],
                                         [rng.random_scalar() for _ in range(2)], 8, rng=rng)
    if flip_at is not None:
        blob = bytearray(proof.to_bytes())
        blob[flip_at] ^= 1
        proof = RangeProof.from_bytes(bytes(blob))
    return proof, V, Transcript(b"RangeProof")


def test_device_batch_collector(honest):
    collector = DeviceBatchCollector()
    p, st, ins, outs = host_object_from_jax(honest[0])
    t = Transcript(b"ShuffleProof")
    Verifier(b"Shuffle", t)
    collector.add_shuffle((p, st, ins, outs), t)
    collector.add_range(*_range_instance(b"coll")[:2], Transcript(b"RangeProof"), 8)
    assert collector.num_proofs == 2
    collector.verify(rng=SeededRng(seed=b"coll-w"), device="cpu")
    bad = DeviceBatchCollector()
    proof, V, _ = _range_instance(b"coll", flip_at=130)
    bad.add_range(proof, V, Transcript(b"RangeProof"), 8)
    with pytest.raises(ValueError):
        bad.verify(rng=SeededRng(seed=b"coll-w"), device="cpu")
