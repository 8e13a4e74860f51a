"""The port's batched Keccak-f[1600], STROBE and merlin transcripts on the
CPU against the host implementations and the JAX package's device versions.
Exact: bytes.

The JAX permutation is the XLA form (``_f1600_xla``), which is what the JAX
package runs on a CPU: its Pallas kernel is unrolled over 24 rounds of 25
lanes and takes many minutes to trace in interpret mode, and the package's
own tests run it on TPU hardware only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quisquis_tpu.accounts.transcript import Transcript as JaxHostTranscript
from quisquis_tpu.ops import device_keccak as jdk
from quisquis_tpu.ops.device_strobe import DeviceTranscript as JaxDeviceTranscript
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.accounts.transcript import Transcript
from quisquis_tpu_torch.ops import cuda_keccak
from quisquis_tpu_torch.ops import device_keccak as dk
from quisquis_tpu_torch.ops import keccak
from quisquis_tpu_torch.ops import scalar_field as sf
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops.device_strobe import (DeviceStrobe, DeviceTranscript,
                                                  DeviceTranscriptRng, snapshot_host_strobe)
from quisquis_tpu_torch.ops.strobe import Strobe128

rng = np.random.default_rng(11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _host_f1600(row: np.ndarray) -> bytes:
    st = bytearray(row.tobytes())
    keccak.keccak_f1600(st)
    return bytes(st)


def test_f1600_equals_host_and_jax():
    states = rng.integers(0, 256, (3, 200), dtype=np.uint8)
    states[0] = 0
    states[1] = 255
    st = torch.as_tensor(states)
    got = dk.f1600(st)
    assert got.dtype == torch.uint8 and got.shape == (3, 200)
    assert torch.equal(st, torch.as_tensor(states)), "the input is not written to"
    assert [bytes(r) for r in got.numpy()] == [_host_f1600(r) for r in states]
    assert torch.equal(cuda_keccak.f1600(st.reshape(3, 1, 200)).reshape(3, 200), got)
    jst = jnp.asarray(interop.keccak_states_to_jax(st))
    assert np.array_equal(np.asarray(jdk._f1600_xla(jst)), interop.keccak_states_to_jax(got))
    back = interop.keccak_states_from_jax(np.asarray(jst), device="cpu")
    assert torch.equal(back, st)
    with pytest.raises(ValueError):
        interop.keccak_states_from_jax(np.full((1, 200), 256), device="cpu")


def test_strobe_equals_host_across_rate_boundaries():
    B = 3
    dev = DeviceStrobe(b"test proto", (B,), device="cpu")
    host = [Strobe128(b"test proto") for _ in range(B)]
    blobs = [rng.bytes(300) for _ in range(B)]
    arr = torch.as_tensor(np.stack([np.frombuffer(b, np.uint8) for b in blobs]))
    dev.meta_ad(b"label-1", False)
    dev.ad(arr, False, 300)       # crosses the 166-byte rate
    dev.ad(b"more", True)
    clone = dev.clone()
    first = dev.prf(64)
    kept = first.clone()
    dev.key(arr[:, :40], False, 40)
    second = dev.prf(200)         # squeezing across the rate
    for i, (h, b) in enumerate(zip(host, blobs)):
        h.meta_ad(b"label-1", False)
        h.ad(b, False)
        h.ad(b"more", True)
        hc = h.clone()
        assert first[i].numpy().tobytes() == h.prf(64, False)
        h.key(b[:40], False)
        assert second[i].numpy().tobytes() == h.prf(200, False)
        # the clone taken before the squeeze still has the earlier state
        assert snapshot_host_strobe(hc) == (clone.state[i].numpy().tobytes(), clone.pos,
                                            clone.pos_begin, clone.cur_flags)
    assert torch.equal(first, kept), "a squeezed view is not changed by later operations"
    with pytest.raises(ValueError):
        dev.ad(arr.int(), False, 300)
    with pytest.raises(ValueError):
        dev.meta_ad(b"x", True)  # continuing an operation of another kind


def test_device_transcript_equals_jax_device_and_host_transcripts():
    """One short schedule (a point-sized message, a u64, a scalar, two
    challenges) through the port's device transcript, the JAX package's, and
    the host transcripts of both."""
    B = 3
    msgs = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    scal = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    dt = DeviceTranscript(b"sched", (B,), device="cpu")
    jt = JaxDeviceTranscript(b"sched", (B,))
    for t, conv in ((dt, torch.as_tensor), (jt, lambda a: jnp.asarray(a.astype(np.int32)))):
        t.append_message(b"A", conv(msgs), 32)
        t.append_u64(b"n", 64)
        t.append_point_var(b"pt", conv(msgs))
        t.append_scalar_var(b"t_x", conv(scal))
        t.domain_sep(b"next")
    c1, j1 = dt.get_challenge_bytes(b"y"), jt.get_challenge_bytes(b"y")
    c2, j2 = dt.challenge_bytes(b"z", 40), jt.challenge_bytes(b"z", 40)
    assert np.array_equal(c1.numpy(), np.asarray(j1)) and np.array_equal(c2.numpy(), np.asarray(j2))
    assert np.array_equal(interop.keccak_states_to_jax(dt.strobe.state), np.asarray(jt.strobe.state))
    ys = sf.to_int_batch(sf.from_bytes_wide(c1))
    for i in range(B):
        for cls in (Transcript, JaxHostTranscript):
            h = cls(b"sched")
            h.append_message(b"A", msgs[i].tobytes())
            h.append_u64(b"n", 64)
            h.append_point_var(b"pt", msgs[i].tobytes())
            h.append_message(b"t_x", scal[i].tobytes())
            h.domain_sep(b"next")
            assert h.challenge_bytes(b"y", 64) == c1[i].numpy().tobytes()
            assert h.challenge_bytes(b"z", 40) == c2[i].numpy().tobytes()
        assert ys[i] == ex.sc_from_bytes_mod_order_wide(c1[i].numpy().tobytes())


def test_from_host_transcripts_and_transcript_rng():
    B = 2
    hosts = []
    for i in range(B):
        t = Transcript(b"prefix")
        t.append_message(b"ctx", bytes([i]) * 16)
        hosts.append(t)
    dt = DeviceTranscript.from_host_transcripts(hosts, device="cpu")
    wit = torch.as_tensor(rng.integers(0, 256, (B, 32), dtype=np.uint8))
    drng = DeviceTranscriptRng(dt.strobe).rekey_with_witness_bytes(b"w", wit, 32)
    drawn = drng.finalize(b"\x07" * 32).random_scalar_bytes()
    after = dt.get_challenge_bytes(b"c")  # the rng worked on a clone
    for i, h in enumerate(hosts):
        hr = h.build_rng().rekey_with_witness_bytes(b"w", wit[i].numpy().tobytes())
        assert hr.finalize(b"\x07" * 32).fill_bytes(64) == drawn[i].numpy().tobytes()
        assert h.challenge_bytes(b"c", 64) == after[i].numpy().tobytes()
    hosts[1].append_message(b"x", b"y" * 200)  # another frame
    with pytest.raises(ValueError):
        DeviceTranscript.from_host_transcripts(hosts, device="cpu")
