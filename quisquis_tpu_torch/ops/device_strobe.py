"""Batched STROBE-128 / merlin transcripts on the device.

A verifier's Fiat-Shamir replay is sequential within one proof but parallel
across proofs of one shape: the framing schedule (labels, operation kinds,
byte counts) is the same for every lane, only the absorbed byte values
differ. So the sponge positions (``pos``, ``pos_begin``, ``cur_flags``) are
plain Python ints, functions of the schedule alone, while the 200-byte
states are one ``[..., 200]`` uint8 tensor on the device, and every byte
XOR, overwrite and squeeze is a slice operation around the batched Keccak
permutation (:mod:`quisquis_tpu_torch.ops.device_keccak`).

``state`` is never changed in place: every operation binds a new tensor, so
clones and squeezed views stay valid.

Framing is bit-exact with :mod:`quisquis_tpu_torch.ops.strobe` (merlin v2).
"""

from __future__ import annotations

import functools
import struct
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.metrics import span
from .device_keccak import f1600
from .strobe import STROBE_R, Strobe128, _FLAG_A, _FLAG_C, _FLAG_I, _FLAG_M

Data = Union[bytes, torch.Tensor]  # constant bytes, or per-lane uint8 [..., k]

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(n: int) -> bytes:
    return struct.pack("<I", n)


def snapshot_host_strobe(strobe) -> tuple:
    """(state bytes, pos, pos_begin, cur_flags) of a host STROBE: the
    pure-Python Strobe128 or the C++ NativeStrobe128 (its 208-byte context,
    csrc/host_strobe.cpp StrobeCtx)."""
    ctx = getattr(strobe, "ctx", None)
    if ctx is not None:
        b = bytes(ctx)
        return b[:200], b[200], b[201], b[202]
    return bytes(strobe.state), strobe.pos, strobe.pos_begin, strobe.cur_flags


@functools.lru_cache(maxsize=4096)
def _bytes_const(data: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(data, np.uint8).copy(), device=device)


def _keep_mask(pos: int, count: int, device: torch.device) -> torch.Tensor:
    """uint8 [200]: 0 on bytes pos .. pos + count - 1, 1 elsewhere."""
    mask = bytearray(b"\x01" * 200)
    mask[pos:pos + count] = bytes(count)
    return _bytes_const(bytes(mask), device)


class DeviceStrobe:
    """Batched STROBE-128 state; schedule static, byte values per lane."""

    def __init__(self, protocol_label: bytes, batch_shape=(), device="cuda"):
        state, self.pos, self.pos_begin, self.cur_flags = snapshot_host_strobe(
            Strobe128(protocol_label))
        init = _bytes_const(state, resolve_device(device))
        self.state = init.expand(tuple(batch_shape) + (200,)).contiguous()

    @classmethod
    def from_host_states(cls, states: torch.Tensor, pos: int, pos_begin: int,
                         cur_flags: int) -> "DeviceStrobe":
        """Resume a batched replay from per-lane Strobe128 snapshots (uint8
        [..., 200]); all lanes share pos, pos_begin and flags, which holds
        whenever the host-side prefix had the same shape in every lane."""
        if states.dtype != torch.uint8 or states.shape[-1] != 200:
            raise ValueError("states: expected uint8 [..., 200]")
        s = object.__new__(cls)
        s.state = states
        s.pos = pos
        s.pos_begin = pos_begin
        s.cur_flags = cur_flags
        return s

    @property
    def batch_shape(self):
        return tuple(self.state.shape[:-1])

    # -- internals -----------------------------------------------------------

    def _run_f(self) -> None:
        # the three pad bytes' positions and values depend on the schedule
        # only: one constant XOR
        padv = bytearray(200)
        padv[self.pos] ^= self.pos_begin
        padv[self.pos + 1] ^= 0x04
        padv[STROBE_R + 1] ^= 0x80
        self.state = f1600(self.state ^ _bytes_const(bytes(padv), self.state.device))
        self.pos = 0
        self.pos_begin = 0

    def _chunks(self, total: int):
        """Split ``total`` bytes at rate boundaries."""
        off = 0
        while off < total:
            c = min(STROBE_R - self.pos, total - off)
            yield off, c
            off += c

    def _lane_tensor(self, data: Data, nbytes: int) -> torch.Tensor:
        if isinstance(data, (bytes, bytearray)):
            data = _bytes_const(bytes(data), self.state.device)  # 1-D: broadcasts over lanes
        if data.dtype != torch.uint8 or data.shape[-1] != nbytes:
            raise ValueError(f"expected uint8 [..., {nbytes}], got {data.dtype} "
                             f"{list(data.shape)}")
        return data

    def _placed(self, arr: torch.Tensor, off: int, count: int) -> torch.Tensor:
        """arr[..., off:off+count] at bytes pos .. of an otherwise zero state."""
        return F.pad(arr[..., off:off + count], (self.pos, 200 - self.pos - count))

    def _advance(self, count: int) -> None:
        self.pos += count
        if self.pos == STROBE_R:
            self._run_f()

    def _absorb(self, data: Data, nbytes: int) -> None:
        arr = self._lane_tensor(data, nbytes)
        for off, c in self._chunks(nbytes):
            self.state = self.state ^ self._placed(arr, off, c)
            self._advance(c)

    def _overwrite(self, data: Data, nbytes: int) -> None:
        arr = self._lane_tensor(data, nbytes)
        for off, c in self._chunks(nbytes):
            keep = _keep_mask(self.pos, c, self.state.device)
            self.state = (self.state * keep) ^ self._placed(arr, off, c)
            self._advance(c)

    def _squeeze(self, n: int) -> torch.Tensor:
        outs = []
        for _, c in self._chunks(n):
            outs.append(self.state[..., self.pos:self.pos + c])
            self.state = self.state * _keep_mask(self.pos, c, self.state.device)
            self._advance(c)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("cannot continue op with different flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]), 2)
        if flags & _FLAG_C and self.pos != 0:
            self._run_f()

    # -- merlin subset -------------------------------------------------------

    def meta_ad(self, data: Data, more: bool, nbytes: int = -1) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data, len(data) if nbytes < 0 else nbytes)

    def ad(self, data: Data, more: bool, nbytes: int = -1) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data, len(data) if nbytes < 0 else nbytes)

    def prf(self, n: int, more: bool = False) -> torch.Tensor:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: Data, more: bool, nbytes: int = -1) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data, len(data) if nbytes < 0 else nbytes)

    def clone(self) -> "DeviceStrobe":
        # sharing the tensor is safe: no operation writes into it
        return DeviceStrobe.from_host_states(self.state, self.pos, self.pos_begin,
                                             self.cur_flags)


class DeviceTranscript:
    """Batched twin of accounts.transcript.Transcript (merlin::Transcript)."""

    def __init__(self, label: bytes, batch_shape=(), device="cuda"):
        self.strobe = DeviceStrobe(MERLIN_PROTOCOL_LABEL, batch_shape, device)
        self.append_message(b"dom-sep", label)

    @classmethod
    def from_strobe(cls, strobe: DeviceStrobe) -> "DeviceTranscript":
        t = object.__new__(cls)
        t.strobe = strobe
        return t

    @classmethod
    def from_host_transcripts(cls, transcripts, device="cuda") -> "DeviceTranscript":
        """Batch host Transcripts with histories of one shape into a device
        transcript, so that a prefix replayed on the host (a transaction's
        transcript before its range proofs) continues on the device."""
        snaps = [snapshot_host_strobe(t.strobe) for t in transcripts]
        frame = snaps[0][1:]
        if any(s[1:] != frame for s in snaps):
            raise ValueError("lane transcripts diverged in framing")
        states = np.stack([np.frombuffer(s[0], np.uint8) for s in snaps])
        return cls.from_strobe(DeviceStrobe.from_host_states(
            torch.as_tensor(states, device=resolve_device(device)), *frame))

    @span("ops.strobe")
    def append_message(self, label: bytes, message: Data, nbytes: int = -1) -> None:
        n = len(message) if nbytes < 0 else nbytes
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        self.strobe.ad(message, False, n)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    @span("ops.strobe")
    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    def domain_sep(self, label: bytes) -> None:
        self.append_message(b"dom-sep", label)

    def append_scalar_var(self, label: bytes, scalar_bytes: Data) -> None:
        self.append_message(label, scalar_bytes, 32)

    def append_point_var(self, label: bytes, point_bytes: Data) -> None:
        self.append_message(b"ptvar", label)
        self.append_message(b"val", point_bytes, 32)

    def get_challenge_bytes(self, label: bytes) -> torch.Tensor:
        """64 challenge bytes [..., 64]; reduce with scalar_field.from_bytes_wide."""
        return self.challenge_bytes(label, 64)


class DeviceTranscriptRng:
    """Batched twin of merlin's TranscriptRng (witness-rekeyed PRF stream):
    clone the transcript's STROBE state, rekey with per-lane witness bytes,
    finalize with per-lane entropy, then draw PRF bytes. Bit-exact with
    the host stream of accounts.transcript (Transcript.build_rng())."""

    def __init__(self, strobe: DeviceStrobe):
        self.strobe = strobe.clone()

    @span("ops.strobe")
    def rekey_with_witness_bytes(self, label: bytes, witness: Data,
                                 nbytes: int = -1) -> "DeviceTranscriptRng":
        n = len(witness) if nbytes < 0 else nbytes
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        self.strobe.key(witness, False, n)
        return self

    @span("ops.strobe")
    def finalize(self, entropy: Data) -> "DeviceTranscriptRng":
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy, False, 32)
        return self

    @span("ops.strobe")
    def fill_bytes(self, n: int) -> torch.Tensor:
        self.strobe.meta_ad(_u32le(n), False)
        return self.strobe.prf(n, False)

    def random_scalar_bytes(self) -> torch.Tensor:
        """64 PRF bytes [..., 64]; reduce with scalar_field.from_bytes_wide."""
        return self.fill_bytes(64)
