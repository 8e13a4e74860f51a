"""The port's multi-GPU layer (quisquis_tpu_torch/parallel/) on the CPU:
ranks of ``parallel.launch(..., device="cpu")`` over gloo, one process
each, against the JAX package and the host (``exact.pt_msm``), the
counterpart of tests/test_batch_parallel.py. Every world's ranks run their
scenarios once, in a module fixture with a hard time limit; each test
asserts one scenario on every rank. Exact: Ristretto encodings and
accept/reject."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quisquis_tpu.accounts.deferred import DeferredPointChecks as JaxDeferred
from quisquis_tpu.ops import exact as jex
from quisquis_tpu.ops import point as jpt
from quisquis_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quisquis_tpu.parallel.sharded_msm import sharded_msm as jax_sharded_msm
from quisquis_tpu_torch import config as qconfig
from quisquis_tpu_torch import parallel
from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.accounts.verifier import Verifier
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt
from quisquis_tpu_torch.primitives import schnorr
from quisquis_tpu_torch.transaction import transaction as ptx
from quisquis_tpu_torch.transaction.workloads import benchmark_requests
from tests.test_torch_schnorr_address import _batch as schnorr_batch
from tests.test_torch_shuffle import jax_entries, tampered
from tests.test_torch_transaction_verify import _tampered as tampered_tx

PROGRAM = "quisquis_tpu_torch.parallel.programs:run_calls"
WORLDS = (1, 2, 4)
N_POINTS = 37           # no world of 2 or 4 divides it: the MSM pads
N_BITS = 8
L = ex.L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def msm_inputs():
    r = SeededRng(seed=b"torch-parallel-msm")
    scalars = [r.random_scalar() for _ in range(N_POINTS)]
    points = [ex.pt_base_mul(r.random_scalar()) for _ in range(N_POINTS)]
    perm = np.random.default_rng(3).permutation(N_POINTS)
    return scalars, points, [scalars[i] for i in perm], [points[i] for i in perm]


def _checks(bad: bool):
    """Identity checks (H = 7G); with `bad`, the last one is false."""
    g, h = ex.BASEPOINT, ex.pt_base_mul(7)
    return [([7, L - 1], [g, h], "a"),
            ([7, L - 1], [g, h], "b"),
            ([1, L - 1], [h, h], "c"),
            ([2, 3 if bad else 5, L - 1], [h, g, ex.pt_base_mul(19)], "d")]


def _commitment_inputs():
    r = SeededRng(seed=b"torch-parallel-comm")
    sks = [r.random_scalar() for _ in range(4)]
    rs = [r.random_scalar() for _ in range(4)]
    gr = [ex.pt_base_mul(r.random_scalar()) for _ in range(4)]
    return sks, rs, [5, 6, 7, 8], gr


@pytest.fixture(scope="module")
def world2_calls():
    """The scenarios that only world 2 runs, and the port's host verdicts."""
    items = schnorr_batch(schnorr, SeededRng, Transcript, count=4)
    forged = [(schnorr.Signature((items[0][0].s + 1) % L, items[0][0].R),) + items[0][1:]] \
        + items[1:]
    shuffles = host_object_from_jax(jax_entries(b"torch-parallel-shuffle", 2, 2))

    def wrap(entries):
        return [(p, Verifier(b"Shuffle", Transcript(b"ShuffleProof")), st, ins, outs)
                for p, st, ins, outs in entries]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qconfig, "DEFAULT", dataclasses.replace(qconfig.DEFAULT, range_bits=N_BITS))
        txs = ptx.batch_create_transactions(benchmark_requests(b"torch-parallel-tx", 2, 1, 9),
                                            range_backend="host")
        bad_txs = tampered_tx(txs, "range t_x")
        host = {}
        for label, batch in (("transactions honest", txs), ("transactions tampered", bad_txs)):
            try:
                ptx.batch_verify_transactions(batch, backend="host", seed=b"tx", device="cpu")
                host[label] = True
            except ValueError:
                host[label] = False
    calls = [
        ("commitments honest", "commitments", _commitment_inputs()),
        ("commitments wrong value", "commitments", _commitment_inputs() + (3,)),
        ("schnorr honest", "schnorr", (items, b"w")),
        ("schnorr forged", "schnorr", (forged, b"w")),
        ("shuffles honest", "shuffles", (wrap(shuffles), b"sh")),
        ("shuffles tampered", "shuffles", (wrap(tampered(shuffles, "hadamard a_bar")), b"sh")),
        ("transactions honest", "transactions", (txs, b"tx", N_BITS)),
        ("transactions tampered", "transactions", (bad_txs, b"tx", N_BITS)),
        ("indivisible", "range_verify", (8, 1, [None] * 3, [None] * 3, None)),
    ]
    return calls, host


def _jax_sharded_msm(scalars, points) -> bytes:
    """The JAX ``sharded_msm`` on the 8-device virtual mesh, the point axis
    padded to a multiple of 8 with zero scalars on the identity, as the JAX
    deferred backend pads it."""
    pad = (-len(scalars)) % 8
    nib = jnp.asarray(jpt.scalars_to_nibbles(list(scalars) + [0] * pad))
    ext = jpt.from_exact_batch([tuple(p) for p in points] + [jex.IDENTITY] * pad)
    out = jax_sharded_msm(jax_make_mesh(8), nib, ext)
    single = jpt.ExtPoint(out.x[None], out.y[None], out.z[None], out.t[None])
    return bytes(jpt.compress_to_bytes(single)[0])


@pytest.fixture(scope="module")
def runs(msm_inputs, world2_calls):
    """{world: [each rank's report], "jax": the JAX sharded MSM's encoding}.
    The worlds' ranks run at once, one launch a thread, while this process
    runs the JAX function."""
    sc, pts, sc_p, pts_p = msm_inputs

    def tensors(scalars, points):
        return (torch.as_tensor(pt.scalars_to_nibbles(scalars)),
                pt.from_exact_batch(points, "cpu"))

    common = [("msm", "msm", tensors(sc, pts)), ("msm permuted", "msm", tensors(sc_p, pts_p)),
              ("deferred honest", "deferred", (_checks(False), b"s" * 32)),
              ("deferred tampered", "deferred", (_checks(True), b"s" * 32)),
              ("deferred unseeded", "deferred", (_checks(False), None))]
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        futures = {w: pool.submit(parallel.launch, PROGRAM, w, device="cpu", timeout_s=150,
                                  args=(common + (world2_calls[0] if w == 2 else []),))
                   for w in WORLDS}
        # a rank that fails: its program does not exist
        futures["failing"] = pool.submit(parallel.launch, PROGRAM, 2, device="cpu",
                                         timeout_s=60, args=([("x", "no_such_program", ())],))
        out = {"jax": _jax_sharded_msm(sc, pts)}
        out.update({w: futures[w].result() for w in WORLDS})
        out["failing"] = futures["failing"].exception()
    return out


def _outcomes(runs, world, label):
    reports = runs[world]
    assert len(reports) == world and all(r["backend"] == "gloo" for r in reports)
    return [r[label]["outcome"] for r in reports]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msm_equals_host(runs, msm_inputs, world):
    sc, pts, _, _ = msm_inputs
    want = jex.ristretto_encode(jex.pt_msm(sc, [tuple(p) for p in pts]))
    assert want == ex.ristretto_encode(ex.pt_msm(sc, pts))
    assert _outcomes(runs, world, "msm") == [("ok", want)] * world


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msm_deterministic_under_permutation(runs, world):
    assert _outcomes(runs, world, "msm permuted") == _outcomes(runs, world, "msm")


def test_sharded_msm_equals_jax_sharded_msm(runs):
    assert _outcomes(runs, 2, "msm")[0] == ("ok", runs["jax"])


@pytest.mark.parametrize("world", WORLDS)
def test_deferred_sharded_gives_the_host_verdict(runs, world):
    for bad in (False, True):
        port = DeferredPointChecks(b"s" * 32)
        jax = JaxDeferred(b"s" * 32)
        for scalars, points, label in _checks(bad):
            port.check(scalars, points, label)
            jax.check(scalars, [tuple(p) for p in points], label)
        verdicts = []
        for fn in (lambda: port.verify(backend="host"), lambda: jax.verify(backend="host")):
            try:
                fn()
                verdicts.append(True)
            except ValueError:
                verdicts.append(False)
        assert verdicts == [not bad] * 2
    assert _outcomes(runs, world, "deferred honest") == [("ok", None)] * world
    # rank 0's weights on every rank: the ranks' own unseeded weights differ
    assert _outcomes(runs, world, "deferred unseeded") == [("ok", None)] * world
    tampered_out = _outcomes(runs, world, "deferred tampered")
    assert len(set(tampered_out)) == 1 and tampered_out[0][0] == "ValueError"
    assert "Batched point-check verification failed" in tampered_out[0][1]


def test_sharded_commitment_verify(runs):
    assert _outcomes(runs, 2, "commitments honest") == [("ok", True)] * 2
    # lane 3, on rank 1, checked against a wrong value: both ranks say so
    assert _outcomes(runs, 2, "commitments wrong value") == [("ok", False)] * 2


def _rejected_alike(outcomes) -> bool:
    return len(set(outcomes)) == 1 and outcomes[0][0] == "ValueError"


def test_schnorr_batch_verify_sharded(runs):
    assert _outcomes(runs, 2, "schnorr honest") == [("ok", None)] * 2
    assert _rejected_alike(_outcomes(runs, 2, "schnorr forged"))


def test_batch_verify_shuffle_proofs_sharded(runs):
    assert _outcomes(runs, 2, "shuffles honest") == [("ok", None)] * 2
    assert _rejected_alike(_outcomes(runs, 2, "shuffles tampered"))


def test_batch_verify_transactions_sharded_gives_the_host_verdict(runs, world2_calls):
    host = world2_calls[1]
    assert host == {"transactions honest": True, "transactions tampered": False}
    assert _outcomes(runs, 2, "transactions honest") == [("ok", None)] * 2
    assert _rejected_alike(_outcomes(runs, 2, "transactions tampered"))


def test_indivisible_batch_and_missing_mesh_raise(runs):
    assert _outcomes(runs, 2, "indivisible") == \
        [("ValueError", "batch 3 not divisible by 2 devices")] * 2
    defer = DeferredPointChecks(b"x")
    defer.check([1, L - 1], [ex.BASEPOINT, ex.BASEPOINT], "a")
    with pytest.raises(ValueError, match="sharded backend requires a mesh"):
        defer.verify(backend="sharded")


def test_a_failing_rank_makes_launch_raise(runs):
    err = runs["failing"]
    assert isinstance(err, RuntimeError) and "failed:" in str(err), err
    assert "KeyError: 'no_such_program'" in str(err)


def test_make_mesh_and_launch_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        parallel.launch(PROGRAM, 2)
    with pytest.raises(ValueError, match="expected 'quisquis_tpu_torch"):
        parallel.launch("tests.test_torch_parallel:_checks", 1, device="cpu")
