"""The device shuffle verifier's three segments, the parts of its program
that CUDA graphs capture, on the CPU: a run after the first touches no host
data inside them (no upload, no fetch, no host branch on a device value),
and the eager CPU path's verdict equals the JAX host verifier's on an
honest batch and on each tampering of the benchmark's ``shuffle64`` mix at
m = 2 and m = 3 (B = 2). The identity test of the final MSM's point, which
the last graph holds, is guarded too; the MSMs themselves run eagerly
between the graphs and are not. Also the capture policy: no capture on a frame's
first sighting, a capture on its second, replays after that, a bounded
number of frames with graphs, and never a capture on the CPU; a capture
keeps every constant of the STROBE constants' bounded cache that its
segments read; and the staging buffers that hold a call's inputs. Exact:
accept or reject."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.interop import host_object_from_jax
from quisquis_tpu_torch.ops import device_strobe
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt
from quisquis_tpu_torch.shuffle import device_verify as sdv
from quisquis_tpu_torch.utils import staging
from quisquis_tpu_torch.utils.metrics import metrics
from tests.test_torch_shuffle import host_accepts, jax_entries

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _moved_by_basepoint(blob: bytes) -> bytes:
    return ex.ristretto_encode(ex.pt_add(ex.ristretto_decode(blob), ex.BASEPOINT))


#: the tamperings of the benchmark's shuffle64 mix, on a JAX (proof, statement)
TAMPERS = {
    "ddh_z": lambda p: dataclasses.replace(p, ddh_proof=dataclasses.replace(
        p.ddh_proof, z=(p.ddh_proof.z + 1) % ex.L)),
    "multiexpo_commit_E_k_0": lambda p: dataclasses.replace(
        p, multi_exponen_commit=dataclasses.replace(
            p.multi_exponen_commit,
            E_k_0=[_moved_by_basepoint(p.multi_exponen_commit.E_k_0[0])]
            + list(p.multi_exponen_commit.E_k_0[1:]))),
    "product_svp_r_twildle": lambda p: dataclasses.replace(
        p, product_proof=dataclasses.replace(p.product_proof, svp_proof=dataclasses.replace(
            p.product_proof.svp_proof, r_twildle=(p.product_proof.svp_proof.r_twildle + 1)
            % ex.L))),
}

#: what the segments may not call: each crosses between host and device
HOST_TRAFFIC = [(torch, "as_tensor"), (torch, "tensor"), (torch.Tensor, "item"),
                (torch.Tensor, "tolist"), (torch.Tensor, "cpu"), (torch.Tensor, "__bool__")]


@contextlib.contextmanager
def no_host_traffic():
    """Every call of :data:`HOST_TRAFFIC` raises inside the block."""
    def refuse(name):
        def refused(*a, **k):
            raise AssertionError(f"{name} inside a captured segment")
        return refused

    with pytest.MonkeyPatch.context() as mp:
        for owner, name in HOST_TRAFFIC:
            mp.setattr(owner, name, refuse(name))
        yield


def guarded(segments):
    """`segments` (a verifier's bound ``_segments``) with each of its
    steps run under :func:`no_host_traffic`."""
    def wrapper(*args):
        steps = segments(*args)
        with no_host_traffic():
            out = next(steps)
        for _ in range(2):
            sent = yield out
            with no_host_traffic():
                out = steps.send(sent)
        yield out
    return wrapper


def under_guard(fn):
    def wrapper(*args):
        with no_host_traffic():
            return fn(*args)
    return wrapper


def device_accepts(dsv, entries, seed: bytes) -> bool:
    try:
        dsv.verify(host_object_from_jax(entries), rng=SeededRng(seed=seed))
    except ValueError:
        return False
    return True


@pytest.fixture(scope="module", params=[2, 3])
def warm(request):
    """(m, honest JAX entries, a verifier of B lanes that has run once)."""
    m = request.param
    entries = jax_entries(b"torch-dsv-graph-%d" % m, m, B)
    dsv = sdv.DeviceShuffleVerifier(m, B, device="cpu")
    assert device_accepts(dsv, entries, b"warm")
    return m, entries, dsv


def test_the_guard_refuses_host_traffic():
    t = torch.ones(())
    with no_host_traffic():
        for call in (lambda: bool(t), t.item, t.tolist, t.cpu, lambda: torch.as_tensor([1]),
                     lambda: torch.tensor([1])):
            with pytest.raises(AssertionError, match="inside a captured segment"):
                call()
    assert bool(t) and torch.tensor([1]).tolist() == [1]


@pytest.mark.parametrize("what", ["honest"] + sorted(TAMPERS))
def test_segments_stay_on_the_device_and_verdicts_equal_host(warm, what, monkeypatch):
    m, entries, dsv = warm
    if what != "honest":
        p, s, ins, outs = entries[1]
        entries = [entries[0], (TAMPERS[what](p), s, ins, outs)]
    want = all(host_accepts(e, port=False) for e in entries)
    assert want is (what == "honest")
    monkeypatch.setattr(dsv, "_segments", guarded(dsv._segments))
    # the final MSM's identity test runs inside the last graph too
    monkeypatch.setattr(pt, "is_identity", under_guard(pt.is_identity))
    assert device_accepts(dsv, entries, b"graph-" + what.encode()) is want


def test_graph_cache_policy():
    cache = staging.GraphCache(2)
    assert cache.get("f") == (None, False)          # first sighting: eager
    assert cache.get("f") == (None, True)           # second: capture
    cache.put("f", "graphs f")
    assert cache.get("f") == ("graphs f", False)    # then replays
    for frame in ("g", "h"):
        cache.get(frame)
        cache.get(frame)
        cache.put(frame, "graphs " + frame)
    assert len(cache) == 2
    assert cache.get("f") == (None, False)          # the least recently run went first
    assert cache.get("g") == ("graphs g", False) and cache.get("h") == ("graphs h", False)
    cache.get("f")
    cache.put("f", "graphs f")
    assert cache.get("g") == (None, False)          # h and f were run after g


class _Card:
    type = "cuda"


def test_run_captures_on_the_second_sighting(monkeypatch):
    """``_run`` on a device of type "cuda", with the capture, the replay
    and the program itself stood in for: eager, capture then replay,
    replay; a new frame starts eager again."""
    dsv = sdv.DeviceShuffleVerifier(2, B, device="cpu")
    done = []
    monkeypatch.setattr(dsv, "device", _Card())
    monkeypatch.setattr(dsv, "_upload", lambda *a: list(a))
    monkeypatch.setattr(dsv, "_program", lambda *a: done.append("eager") or torch.tensor(True))
    monkeypatch.setattr(dsv, "_capture", lambda inputs, frame: done.append("capture") or frame)
    monkeypatch.setattr(dsv, "_replay", lambda g: done.append("replay " + g) or torch.tensor(True))
    metrics.reset()
    arrays = [np.zeros((B, 1), np.uint8)] * 4
    for frame in ("f", "f", "f", "f", "g"):
        assert dsv._run(*arrays, frame)
    assert done == ["eager", "capture", "replay f", "replay f", "replay f", "eager"]
    assert metrics.counters["dev.shuffle_verify.runs"] == 5
    assert metrics.counters["dev.shuffle_verify.graph_replays"] == 2   # the capture's run is not one


def test_the_cpu_never_captures():
    entries = host_object_from_jax(jax_entries(b"torch-dsv-graph-cpu", 2, 1)) * B
    dsv = sdv.DeviceShuffleVerifier(2, B, device="cpu")
    metrics.reset()
    calls = []
    real = dsv._segments

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    dsv._segments = counted
    for _ in range(2):
        dsv.verify(entries, rng=SeededRng(seed=b"cpu"))
    assert len(calls) == 2 and len(dsv._graphs) == 0
    assert metrics.counters["dev.shuffle_verify.runs"] == 2
    assert "dev.shuffle_verify.graph_captures" not in metrics.counters
    assert "dev.shuffle_verify.graph_replays" not in metrics.counters


def test_a_capture_holds_the_strobe_constants_its_segments_read(warm, monkeypatch):
    """Run inside ``staging.holding()``, as ``_capture`` runs them, the
    segments pass every tensor of the bounded ``_bytes_tensor`` cache that
    they read to the list that the graphs keep, so that an eviction cannot
    free one under a graph."""
    m, entries, dsv = warm
    handed = {}

    def recorded(data, device, _real=device_strobe._bytes_tensor):
        t = _real(data, device)
        handed[id(t)] = t
        return t

    monkeypatch.setattr(device_strobe, "_bytes_tensor", recorded)
    comp, scal, states, frame = dsv._pack(host_object_from_jax(entries), None)
    weights = np.zeros((B, dsv.NCHECKS, 64), np.uint8)
    with staging.holding() as held:
        steps = dsv._segments(*dsv._upload(comp, scal, weights, states), frame)
        rows = next(steps)
        checks = steps.send(pt.ExtPoint(*(torch.zeros(rows[0].shape[0], 10, dtype=torch.int32)
                                           for _ in range(4))))
        checks.terms()
        steps.send(torch.tensor(True))
    assert len(handed) > 10
    assert {id(t) for t in held} == set(handed)


def test_holding_nests_and_ends():
    a, b = torch.zeros(1), torch.ones(1)
    assert staging.hold(a) is a                  # no block open: nothing kept
    with staging.holding() as outer:
        staging.hold(a)
        with staging.holding() as inner:
            staging.hold(b)
        assert inner == [b]
    assert outer == [a, b]                       # an outer capture keeps what the inner read
    with staging.holding() as again:
        pass
    assert again == []


def test_staging_puts_arrays_back_to_back_in_the_same_memory():
    st = staging.Staging(2 * 3 + 4, torch.device("cpu"))
    x = np.arange(6, dtype=np.uint8).reshape(2, 3)
    y = np.full((2, 2), 9, np.uint8)
    vx, vy = st.put([x, y])
    assert vx.shape == (2, 3) and vy.shape == (2, 2)
    assert vx.tolist() == x.tolist() and vy.tolist() == y.tolist()
    wx, wy = st.put([x + 1, y + 1])
    assert wx.data_ptr() == vx.data_ptr() and wy.data_ptr() == vy.data_ptr()
    assert wx.tolist() == (x + 1).tolist() and vy.tolist() == (y + 1).tolist()
