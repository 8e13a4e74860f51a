"""The sharded device verifiers on the CPU: ``DeviceRangeVerifier.verify_sharded``
at n = 8, m = 1, B = 2 and ``DeviceShuffleVerifier.verify_sharded`` at m = 2,
B = 2, on two ranks of ``parallel.launch(..., device="cpu")`` (gloo), one
lane a rank. On an honest batch, a batch with a tampered lane on rank 1 and
a batch whose lane on rank 0 holds a point that does not decode, both ranks
return or raise alike, and the verdict is that of the JAX host verifiers
(``verify_multiple``, ``ShuffleProof.verify``) and of the port's
single-device ``verify()``. Proofs come from the JAX host provers. The
ranks run every case once, in a module fixture with a hard time limit,
while this process runs the single-device verifiers. Exact: accept or
reject."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.bulletproofs.range_proof import RangeProof as JaxRangeProof
from quisquis_tpu_torch import parallel
from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.bulletproofs import device_verify as rdv
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.shuffle import device_verify as sdv
from tests.test_torch_shuffle import host_accepts, jax_entries, tampered

PROGRAM = "quisquis_tpu_torch.parallel.programs:run_calls"
N_BITS, B = 8, 2
CASES = ("honest", "tampered on rank 1", "undecodable on rank 0")
BAD_POINT = b"\xff" * 32        # not canonical: no point decodes from it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _range_batches():
    """{case: [(proof bytes, value commitments)] x B} from the JAX host prover."""
    rng = JaxSeededRng(seed=b"torch-sharded-verify-range")
    honest = []
    for v in (1, 200):
        proof, V = JaxRangeProof.prove_multiple(JaxTranscript(b"RangeProof"), [v],
                                                [rng.random_scalar()], N_BITS, rng=rng)
        honest.append((proof.to_bytes(), list(V)))
    t_x = bytearray(honest[1][0])
    t_x[130] ^= 1                                    # lane 1's t_x
    return {"honest": honest,
            "tampered on rank 1": [honest[0], (bytes(t_x), honest[1][1])],
            "undecodable on rank 0": [(BAD_POINT + honest[0][0][32:], honest[0][1]), honest[1]]}


def _shuffle_batches():
    honest = jax_entries(b"torch-sharded-verify-shuffle", 2, B)
    p, s, ins, outs = honest[0]
    bad = dataclasses.replace(p, c_A=[BAD_POINT] + p.c_A[1:])
    return {"honest": honest,
            "tampered on rank 1": tampered(honest, "hadamard a_bar", lane=1),
            "undecodable on rank 0": [(bad, s, ins, outs)] + honest[1:]}


def _jax_range_accepts(batch) -> bool:
    try:
        for blob, V in batch:
            JaxRangeProof.from_bytes(blob).verify_multiple(JaxTranscript(b"RangeProof"), V, N_BITS)
    except ValueError:
        return False
    return True


def _accepts(fn) -> bool:
    try:
        fn()
    except ValueError:
        return False
    return True


def _port_range(batch):
    return [RangeProof.from_bytes(blob) for blob, _ in batch], [V for _, V in batch]


@pytest.fixture(scope="module")
def verdicts():
    """{(kind, case): {"jax host", "verify", "sharded": [each rank's outcome]}}."""
    ranges, shuffles = _range_batches(), _shuffle_batches()
    port_shuffles = {c: host_object_from_jax(e) for c, e in shuffles.items()}
    calls = [(f"range {c}", "range_verify", (N_BITS, 1, *_port_range(b), b"w")) for c, b in
             ranges.items()]
    calls += [(f"shuffle {c}", "shuffle_verify", (2, e, b"w2")) for c, e in port_shuffles.items()]
    out = {}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.launch, PROGRAM, 2, device="cpu", timeout_s=150,
                            args=(calls,))
        for c, batch in ranges.items():
            drv = rdv.get_device_range_verifier(N_BITS, 1, B, device="cpu")
            out["range", c] = {
                "jax host": _jax_range_accepts(batch),
                "verify": _accepts(lambda: drv.verify(*_port_range(batch),
                                                      rng=SeededRng(seed=b"w")))}
        for c, entries in shuffles.items():
            dsv = sdv.get_device_shuffle_verifier(2, B, device="cpu")
            out["shuffle", c] = {
                "jax host": all(host_accepts(e, port=False) for e in entries),
                "verify": _accepts(lambda: dsv.verify(port_shuffles[c],
                                                      rng=SeededRng(seed=b"w2")))}
        reports = ranks.result()
    for (kind, c), v in out.items():
        assert all(r["backend"] == "gloo" for r in reports)
        v["sharded"] = [r[f"{kind} {c}"]["outcome"] for r in reports]
    return out


@pytest.mark.parametrize("kind", ["range", "shuffle"])
@pytest.mark.parametrize("case", CASES)
def test_verify_sharded_gives_the_host_and_single_device_verdict(verdicts, kind, case):
    v = verdicts[kind, case]
    first, second = v["sharded"]
    assert first == second, "the two ranks disagree"
    assert v["jax host"] == v["verify"] == (first == ("ok", None)) == (case == "honest"), v
    if case != "honest":
        assert first[0] == "ValueError" and "failed (sharded)" in first[1]
