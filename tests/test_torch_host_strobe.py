"""The C++ STROBE of ``csrc/host_strobe.cpp`` against the pure-Python
Strobe128, its plain version, on the CPU: byte for byte on the merlin
crate's equivalence vector, on random operation sequences across the
166-byte rate, through the batched transcript operations, and in the
snapshots that resume a host transcript on the device. Skips without g++,
as the host build of the CUDA sources does."""

import shutil
import struct

import numpy as np
import pytest
import torch

from quisquis_tpu_torch.accounts import transcript as tr
from quisquis_tpu_torch.ops import host_strobe as hs
from quisquis_tpu_torch.ops.device_strobe import (DeviceStrobe, DeviceTranscript,
                                                  snapshot_host_strobe)
from quisquis_tpu_torch.ops.strobe import STROBE_R, Strobe128

rng = np.random.default_rng(20261017)
MERLIN_VECTOR = "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


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
    assert hs.available(), hs.build_error()


def _transcript(cls, label: bytes) -> tr.Transcript:
    t = object.__new__(tr.Transcript)
    t.strobe = cls(tr.MERLIN_PROTOCOL_LABEL)
    t.append_message(b"dom-sep", label)
    return t


def test_transcripts_take_the_native_class_and_the_merlin_vector():
    assert tr.Strobe128 is hs.NativeStrobe128
    for cls in (hs.NativeStrobe128, Strobe128):
        t = _transcript(cls, b"test protocol")
        t.append_message(b"some label", b"some data")
        assert t.challenge_bytes(b"challenge", 32).hex() == MERLIN_VECTOR


@pytest.mark.parametrize("seed", range(4))
def test_random_operations_across_the_rate(seed):
    r = np.random.default_rng(seed)
    a, b = hs.NativeStrobe128(b"proto"), Strobe128(b"proto")
    for _ in range(40):
        op = int(r.integers(0, 4))
        n = int(r.choice([0, 1, 31, 64, STROBE_R - 1, STROBE_R, STROBE_R + 1, 400]))
        data = r.integers(0, 256, n, dtype=np.uint8).tobytes()
        more = bool(r.integers(0, 2)) and op != 2
        if op == 0:
            a.meta_ad(data, False), b.meta_ad(data, False)
            if more:
                a.meta_ad(data, True), b.meta_ad(data, True)
        elif op == 1:
            a.ad(data, False), b.ad(data, False)
        elif op == 2:
            assert a.prf(n, False) == b.prf(n, False)
        else:
            a.key(data, False), b.key(data, False)
        assert snapshot_host_strobe(a) == snapshot_host_strobe(b)
    c = a.clone()
    assert c.prf(64, False) == b.clone().prf(64, False)
    assert snapshot_host_strobe(a) != snapshot_host_strobe(c)  # the clone is a copy


def test_batched_transcript_operations_equal_their_loops():
    items = [(b"label-%d" % i, rng.integers(0, 256, int(n), dtype=np.uint8).tobytes())
             for i, n in enumerate([0, 32, 170, 5, 333])]
    wits = rng.integers(0, 256, 32 * 9, dtype=np.uint8).tobytes()
    native, plain = _transcript(hs.NativeStrobe128, b"t"), _transcript(Strobe128, b"t")
    native.append_messages(items)
    for label, msg in items:  # the pure-Python class has no batched call
        plain.strobe.meta_ad(label, False)
        plain.strobe.meta_ad(struct.pack("<I", len(msg)), True)
        plain.strobe.ad(msg, False)
    assert snapshot_host_strobe(native.strobe) == snapshot_host_strobe(plain.strobe)
    rn = native.build_rng().rekey_with_witness_batch(b"w", wits, 32).finalize(b"\x05" * 32)
    rp = plain.build_rng().rekey_with_witness_batch(b"w", wits, 32).finalize(b"\x05" * 32)
    assert rn.fill_bytes(200) == rp.fill_bytes(200)
    assert native.get_challenge(b"c") == plain.get_challenge(b"c")
    # SeededRng (native) against its construction on the pure-Python class
    t = _transcript(Strobe128, b"quisquis-tpu-seeded-rng")
    t.append_message(b"seed", b"s")
    plain_rng = t.build_rng().finalize(entropy=b"\x00" * 32)
    seeded = tr.SeededRng(b"s")
    assert [seeded.random_scalar() for _ in range(5)] == \
        [plain_rng.random_scalar() for _ in range(5)]
    with pytest.raises(ValueError):
        native.strobe.rekey_witnesses(b"w", wits[:40], 32, 2)


def test_snapshots_resume_on_the_device_from_either_class():
    B = 3
    hosts = {cls: [] for cls in (hs.NativeStrobe128, Strobe128)}
    for cls, ts in hosts.items():
        for i in range(B):
            t = _transcript(cls, b"resume")
            t.append_message(b"ctx", bytes([i]) * 180)  # across the rate
            ts.append(t)
    snaps = {cls: [snapshot_host_strobe(t.strobe) for t in ts] for cls, ts in hosts.items()}
    assert snaps[hs.NativeStrobe128] == snaps[Strobe128]
    for cls, ts in hosts.items():
        state, *frame = zip(*snaps[cls])
        assert len(set(frame[0])) == 1  # one frame for the batch
        dev = DeviceStrobe.from_host_states(
            torch.as_tensor(np.stack([np.frombuffer(s, np.uint8) for s in state])),
            frame[0][0], frame[1][0], frame[2][0])
        dt = DeviceTranscript.from_strobe(dev)
        got = dt.get_challenge_bytes(b"c")
        for i, t in enumerate(ts):
            assert t.challenge_bytes(b"c", 64) == got[i].numpy().tobytes()
    fresh = DeviceStrobe(b"proto", (2,), device="cpu")
    want = snapshot_host_strobe(hs.NativeStrobe128(b"proto"))
    assert (fresh.state[1].numpy().tobytes(), fresh.pos, fresh.pos_begin,
            fresh.cur_flags) == want
