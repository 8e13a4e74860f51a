"""Batched zkSchnorr verification, entirely on the device.

A validator checks one signature for every account that authorises a spend
(BASELINE.json config 3; reference src/transaction/signature.rs:83-137 and
src/ristretto/keys.rs:208-236). QuisQuis keys are updated on every use, so
in a block nearly every key is distinct and the three terms of a signature
do not coalesce: B signatures are one MSM of 3B terms. For B signatures the
whole verification runs between one upload and one boolean:

  upload:  g, h, R, s (uint8 [B, 32] each), the messages (uint8 [B, m])
           or the lanes' host transcript states, and 16 bytes of weight a
           lane, from one bulk draw (one copy, from a pinned buffer on CUDA)
  device:  batched STROBE transcripts (domain_sep, the three points, a
           64-byte challenge c per lane; ``ops.device_strobe``) -> one
           ``ristretto_decode`` launch over [B, 3] points -> the scalars
           w s, -w c and -w of the points g, h, R -> ONE MSM of 3B terms
           (``ops.msm``), its identity test, and every lane's decode
  fetch:   one boolean

It accepts exactly what ``Signature.verify`` accepts lane by lane, up to the
2^-128 chance of the random linear combination (``accounts.deferred``): a
point that fails to decode (a non-canonical encoding) fails the batch as
"Decompression Failed" fails one signature, and ``s`` is read modulo l as
``Signature.from_bytes`` reads it (``sc_from_bytes_mod_order``; the host
makes no canonical check). The weights are 128-bit with the top bit set, as
``DeferredPointChecks._weight`` draws them: ``os.urandom`` once a call, or
SHAKE-256 of a pinned seed for tests.

Spans (``utils.metrics``): ``dev.schnorr_verify`` around a call,
``dev.schnorr_verify.pack`` around the upload, ``dev.schnorr_verify.wait``
where the host blocks for the verdict; ``ops.strobe``, ``ops.point.decode``
and ``ops.msm`` inside. The counter ``dev.schnorr_verify.lanes`` counts the
signatures given to the program.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..accounts.transcript import Transcript
from ..device import resolve_device
from ..ops import cuda_point as kp
from ..ops import exact as ex
from ..ops import msm as qmsm
from ..ops import point as pt
from ..ops import scalar_field as sf
from ..ops.device_strobe import DeviceStrobe, DeviceTranscript, snapshot_host_strobe
from ..utils.metrics import metrics, span
from ..utils.staging import Staging

#: the transcript label of a signed message (``Signature.sign_message``)
MESSAGE_TRANSCRIPT = b"ZkSchnorr.sign_message"
#: bytes of one lane's weight: 128 bits, the top one set
WEIGHT_BYTES = 16
#: held by a call from its upload to its verdict: the staging buffers of a
#: shape serve one call at a time
_CALL = threading.Lock()


def draw_weights(lanes: int, seed: Optional[bytes] = None) -> np.ndarray:
    """uint8 [lanes, 16]: each lane's 128-bit weight, little-endian, top bit
    set; one draw for the whole call (``os.urandom``, or SHAKE-256 of
    `seed`, which pins the weights for tests)."""
    n = WEIGHT_BYTES * lanes
    raw = (os.urandom(n) if seed is None
           else hashlib.shake_256(b"zkschnorr-weights" + bytes(seed)).digest(n))
    w = np.frombuffer(raw, np.uint8).reshape(lanes, WEIGHT_BYTES).copy()
    w[:, -1] |= 0x80
    return w


@functools.lru_cache(maxsize=None)
def _message_prefix(device: torch.device):
    """(uint8 [200] on `device`, frame): the STROBE state of
    ``Transcript(MESSAGE_TRANSCRIPT)``, built once on the host."""
    state, *frame = snapshot_host_strobe(Transcript(MESSAGE_TRANSCRIPT).strobe)
    return torch.as_tensor(np.frombuffer(state, np.uint8).copy(), device=device), tuple(frame)


@functools.lru_cache(maxsize=4)
def _staging(nbytes: int, device: torch.device) -> Staging:
    """The staging buffers of a call's size, kept for it: on CUDA the host
    buffer is pinned, so the upload is one copy of fixed device time. A
    call holds ``_CALL`` from its upload to its verdict, so the buffers are
    rewritten only once the call that read them is done."""
    return Staging(nbytes, device)


@span("dev.schnorr_verify.pack")
def _upload(parts: Sequence[np.ndarray], device: torch.device) -> list:
    """The uint8 arrays of `parts` on the device, in their shapes, as one
    upload."""
    return _staging(sum(p.size for p in parts), device).put(parts)


def _challenges(dt: DeviceTranscript, points: torch.Tensor) -> torch.Tensor:
    """Each lane's challenge c as loose scalar limbs [B, 10]: the
    transcript steps of ``Signature.verify`` after its prefix, over the
    wire points uint8 [B, 3, 32] (g, h, R)."""
    dt.domain_sep(b"zkschnorr")
    for i, label in enumerate((b"G", b"H", b"R")):
        dt.append_point_var(label, points[:, i])
    return sf.from_bytes_wide(dt.get_challenge_bytes(b"c"))


def _message_transcript(label: bytes, messages: torch.Tensor) -> DeviceTranscript:
    """``Signature._transcript_for_message`` on every lane: the shared
    prefix broadcast from the host, then the lane's message."""
    state, frame = _message_prefix(messages.device)
    dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(
        state.expand(messages.shape[0], -1), *frame))
    dt.append_message(label, messages, messages.shape[-1])
    return dt


def _terms(dt: DeviceTranscript, points: torch.Tensor, s: torch.Tensor, w: torch.Tensor):
    """(0-d bool: every point decodes, scalars [3B, 10], points [3B]): the
    terms w s g - w c h - w R of each lane. points uint8 [B, 3, 32] (g, h,
    R), s uint8 [B, 32], w uint8 [B, 16]."""
    c = _challenges(dt, points)
    decoded, pts = kp.decode_bytes(points)
    wl = sf.from_bytes(F.pad(w, (0, 32 - WEIGHT_BYTES)))
    scalars = torch.stack([sf.mul(wl, sf.from_bytes(s)), sf.neg(sf.mul(wl, c)), sf.neg(wl)],
                          dim=1)
    return (decoded.all(), scalars.reshape(-1, sf.NLIMBS),
            pt.ExtPoint(*(k.reshape(-1, k.shape[-1]) for k in pts)))


def _verdict(parts) -> bool:
    """One MSM over every part's terms; the host waits for one boolean."""
    ok = functools.reduce(torch.logical_and, [p[0] for p in parts])
    total = qmsm.msm(sf.to_nibbles(torch.cat([p[1] for p in parts])),
                     pt.ExtPoint(*(torch.cat(k) for k in zip(*(p[2] for p in parts)))))
    ok = ok & pt.is_identity(total)
    with span("dev.schnorr_verify.wait"):
        return bool(ok)


def message_challenges(label: bytes, g, h, R, messages, device="cuda") -> list:
    """Each lane's challenge c (ints mod l), as ``Signature.verify_message``
    derives it: for tests against the host transcript."""
    dev = resolve_device(device)
    msgs = torch.as_tensor(np.array(messages, np.uint8), device=dev)
    points = torch.as_tensor(np.stack([g, h, R], axis=1), device=dev)
    return sf.to_int_batch(_challenges(_message_transcript(bytes(label), msgs), points))


@span("dev.schnorr_verify")
def verify_messages(label: bytes, g: np.ndarray, h: np.ndarray, R: np.ndarray, s: np.ndarray,
                    messages: np.ndarray, seed: Optional[bytes] = None, device="cuda") -> bool:
    """True where every lane's signature (R, s) verifies under its key
    (g, h) over ``(label, message)`` (``Signature.verify_message``).

    g, h, R, s: uint8 [B, 32]; messages: uint8 [B, m], one length for the
    batch. `seed` pins the weights (tests only)."""
    dev = resolve_device(device)
    lanes = g.shape[0]
    if lanes == 0:
        return True
    metrics.count("dev.schnorr_verify.lanes", lanes)
    w = draw_weights(lanes, seed)
    with _CALL:
        points, s, messages, w = _upload([np.stack([g, h, R], axis=1), s, messages, w], dev)
        return _verdict([_terms(_message_transcript(bytes(label), messages), points, s, w)])


@span("dev.schnorr_verify")
def verify_transcripts(items, seed: Optional[bytes] = None, device="cuda") -> bool:
    """True where every (signature, transcript, vk) verifies
    (``Signature.verify``): the host transcripts' STROBE states continue on
    the device. Lanes are grouped by transcript framing (the sponge
    position that the lengths of a history fix); every group's terms join
    one MSM."""
    dev = resolve_device(device)
    lanes = len(items)
    if lanes == 0:
        return True
    metrics.count("dev.schnorr_verify.lanes", lanes)
    snaps = [snapshot_host_strobe(t.strobe) for _, t, _ in items]
    wire = b"".join(vk.g + vk.h + sig.R + ex.sc_to_bytes(sig.s) for sig, _, vk in items)
    if len(wire) != 128 * lanes:
        raise ValueError("Error::Decompression Failed")   # a point of another length
    states = np.frombuffer(b"".join(snap[0] for snap in snaps), np.uint8).reshape(lanes, 200)
    groups: dict = {}
    for i, snap in enumerate(snaps):
        groups.setdefault(snap[1:], []).append(i)
    w = draw_weights(lanes, seed)
    with _CALL:
        wire, st, w = _upload([np.frombuffer(wire, np.uint8).reshape(lanes, 128), states, w],
                              dev)
        points, s = wire[:, :96].reshape(lanes, 3, 32), wire[:, 96:128]
        parts = []
        for frame, idx in groups.items():
            rows = slice(None) if len(groups) == 1 else torch.as_tensor(idx, device=dev)
            dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(st[rows], *frame))
            parts.append(_terms(dt, points[rows], s[rows], w[rows]))
        return _verdict(parts)
