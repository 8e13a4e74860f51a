"""Batched range-proof verification, entirely on the device.

The whole verifier of a batch of B aggregated range proofs of one shape
runs between one upload and one boolean:

  upload:  proof bytes (uint8), value commitments, random weights
  device:  batched STROBE transcripts (ops/device_strobe.py)
           -> challenges y, z, x, w, u_j     (ops/scalar_field.py)
           -> verification scalars (powers, Fermat and batch inversion, the
              inner-product s-vector), both check equations of every proof
           -> one MSM over [static generators | per-proof points]
              (ops/msm.py: three CUDA kernels)
  fetch:   one boolean

The static generators (BulletproofGens G and H, the Pedersen pair) are
decoded once at construction and stay on the device, so a call uploads
proof material only. Every check of every proof carries its own
unpredictable 128-bit-secure weight, sampled on the host and uploaded with
the batch: the random-linear-combination argument of batch verification.

Accepts exactly the proofs that the host ``RangeProof.verify_multiple``
accepts (tests/test_torch_range_verify.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..accounts.transcript import Transcript
from ..device import resolve_device
from ..ops import exact as ex
from ..ops import field as fe
from ..ops import msm as qmsm
from ..ops import point as pt
from ..ops import scalar_field as sf
from ..ops.device_strobe import DeviceStrobe, DeviceTranscript, snapshot_host_strobe
from ..primitives.pedersen import default_pedersen_gens
from .generators import bulletproof_gens


def _sf_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum mod l along axis -2 (log depth, fixed order)."""
    n = x.shape[-2]
    while n > 1:
        if n % 2:
            x = torch.cat([x, sf.zeros(x.shape[:-2] + (1,), x.device)], dim=-2)
            n += 1
        h = n // 2
        x = sf.add(x[..., :h, :], x[..., h:, :])
        n = h
    return x[..., 0, :]


def _sf_tree_prod(x: torch.Tensor) -> torch.Tensor:
    """Product mod l along axis -2 (log depth, fixed order)."""
    n = x.shape[-2]
    while n > 1:
        if n % 2:
            x = torch.cat([x, sf.one(x.shape[:-2] + (1,), x.device)], dim=-2)
            n += 1
        h = n // 2
        x = sf.mul(x[..., :h, :], x[..., h:, :])
        n = h
    return x[..., 0, :]


def _ext_concat(points, dim: int = 0) -> pt.ExtPoint:
    """Concatenate point batches along ``dim``."""
    return pt.ExtPoint(*(torch.cat(cs, dim=dim) for cs in zip(*points)))


class DeviceRangeVerifier:
    """Batched verifier for aggregated range proofs of a fixed shape (n
    bits, m values per proof, B proofs per batch).

    Usage::

        drv = DeviceRangeVerifier(n=64, m=16, batch=64)
        drv.verify(proofs, value_commitment_lists)   # raises ValueError

    Each call uploads proof bytes and fresh host-sampled weights and fetches
    one boolean. Transcripts are a fresh ``Transcript(label)`` per proof
    (``transcript_label``); for proofs inside a larger protocol, pass the
    per-proof host transcripts to ``verify(..., transcripts=...)``: their
    STROBE states ship with the batch and the replay continues from them.
    """

    def __init__(self, n: int, m: int, batch: int,
                 transcript_label: bytes = b"RangeProof", device="cuda"):
        if m < 1 or m & (m - 1) or n * m < 2:
            raise ValueError("m must be a power of two and n * m at least 2")
        self.device = resolve_device(device)
        self.n, self.m, self.batch = n, m, batch
        self.label = bytes(transcript_label)
        self.nm = n * m
        self.k = self.nm.bit_length() - 1  # inner-product rounds
        pc = default_pedersen_gens()
        bp = bulletproof_gens(n, m)
        # resident static generators: 2 + 2nm points
        self._static = pt.from_exact_batch(
            [pc.B, pc.B_blinding] + bp.G(n, m) + bp.H(n, m), self.device)
        self._two_pows = sf.scalars_to_dev([1 << i for i in range(n)], self.device)
        bits = (np.arange(self.nm)[None, :] >> (self.k - 1 - np.arange(self.k))[:, None]) & 1
        self._s_bits = torch.as_tensor(bits == 1, device=self.device)  # [k, nm]

    # -- device program ------------------------------------------------------

    def _program(self, comp, scal, weights, states, frame) -> torch.Tensor:
        """comp: uint8 [B, P, 32] compressed points (V m | A S T1 T2 | L k |
        R k); scal: uint8 [B, 5, 32] (t_x, t_x_blinding, e_blinding, ipp a,
        ipp b); weights: uint8 [B, 2, 64] uniform bytes; states: uint8
        [B, 200] STROBE states; frame: (pos, pos_begin, cur_flags) of those
        states. Returns a 0-d bool tensor."""
        n, m, nm, k = self.n, self.m, self.nm, self.k
        B = comp.shape[0]
        ok_pts, pts = pt.decompress_bytes_tensor(comp)  # [B, P]
        all_ok = ok_pts.all()

        t_x, t_x_b, e_b, ipp_a, ipp_b = sf.from_bytes(scal).unbind(1)
        w1, w2 = sf.from_bytes_wide(weights).unbind(1)

        # the host appends sc_to_bytes of the reduced scalar, so the
        # transcript gets canonical bytes even where the proof's are not
        t_x_bytes, t_x_b_bytes, e_b_bytes = sf.to_bytes_array(
            torch.stack([t_x, t_x_b, e_b], dim=1)).unbind(1)

        dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(states, *frame))
        dt.append_message(b"dom-sep", b"rangeproof v1")
        dt.append_u64(b"n", n)
        dt.append_u64(b"m", m)
        for j in range(m):
            dt.append_message(b"V", comp[:, j], 32)
        dt.append_message(b"A", comp[:, m], 32)
        dt.append_message(b"S", comp[:, m + 1], 32)
        y = sf.from_bytes_wide(dt.get_challenge_bytes(b"y"))
        z = sf.from_bytes_wide(dt.get_challenge_bytes(b"z"))
        dt.append_message(b"T_1", comp[:, m + 2], 32)
        dt.append_message(b"T_2", comp[:, m + 3], 32)
        x = sf.from_bytes_wide(dt.get_challenge_bytes(b"x"))
        dt.append_scalar_var(b"t_x", t_x_bytes)
        dt.append_scalar_var(b"t_x_blinding", t_x_b_bytes)
        dt.append_scalar_var(b"e_blinding", e_b_bytes)
        w = sf.from_bytes_wide(dt.get_challenge_bytes(b"w"))
        dt.append_message(b"dom-sep", b"ipp v1")
        dt.append_u64(b"n", nm)
        u = []
        for j in range(k):
            dt.append_message(b"L", comp[:, m + 4 + j], 32)
            dt.append_message(b"R", comp[:, m + 4 + k + j], 32)
            u.append(sf.from_bytes_wide(dt.get_challenge_bytes(b"u")))
        u = torch.stack(u, dim=-2)                    # [B, k, 10]

        # ----- scalar work (loose limbs mod l) -----
        y_pows = sf.powers(y, nm)                     # [B, nm, 10]
        h_fact = sf.powers(sf.invert(y), nm)          # y^-i
        z_pows = sf.powers(z, m + 3)                  # z^0 .. z^(m+2)
        z2 = z_pows[:, 2]
        z_2m = z_pows[:, 2:2 + m]                     # z^(2+j)
        # zeta[j, i] = z^(2+j) * 2^i, flattened to [B, nm]
        zeta = sf.mul(z_2m[:, :, None, :], self._two_pows).reshape(B, nm, sf.NLIMBS)

        # delta(y, z) = (z - z^2) sum_i y^i - (2^n - 1) sum_j z^(3+j)
        sum_y = sf.sum_over(y_pows, 1)
        sum_z3 = sf.sum_over(z_pows[:, 3:3 + m], 1)
        delta = sf.sub(sf.mul(sf.sub(z, z2), sum_y),
                       sf.mul(sum_z3, sf.const((1 << n) - 1, (B,), self.device)))

        # inner-product verification scalars
        u_inv = sf.batch_invert_rows(u)               # [B, k, 10]
        s_vec = _sf_tree_prod(u_inv)[:, None, :].expand(B, nm, sf.NLIMBS)
        u_sq = sf.mul(u, u)
        u_inv_sq = sf.mul(u_inv, u_inv)
        # s_i = prod_j u_inv_j * prod_{j: bit (k-1-j) of i} u_j^2
        one = sf.one((), self.device)
        for j in range(k):
            s_vec = sf.mul(s_vec, torch.where(self._s_bits[j][None, :, None],
                                              u_sq[:, j, None, :], one))
        s_inv_vec = s_vec.flip(1)                     # 1/s_i = s_(nm-1-i)

        # ----- check 1 (t polynomial), weight w1:
        #   (t_x - delta) B + t_x_b B~ - sum_j z^(2+j) V_j - x T1 - x^2 T2
        c1_B = sf.mul(w1, sf.sub(t_x, delta))
        c1_Bb = sf.mul(w1, t_x_b)
        c1_V = sf.neg(sf.mul(w1[:, None, :], z_2m))   # [B, m]
        c1_T1 = sf.neg(sf.mul(w1, x))
        c1_T2 = sf.neg(sf.mul(w1, sf.mul(x, x)))

        # ----- check 2 (inner-product commitment), weight w2:
        #   A + x S - e_b B~ + w (t_x - a b) B + sum_i (-z - a s_i) G_i
        #   + sum_i ((z y^i + zeta_i) - b / s_i) y^-i H_i
        #   + sum_j (u_j^2 L_j + u_j^-2 R_j)
        w2r = w2[:, None, :]
        c2_S = sf.mul(w2, x)
        c2_Bb = sf.neg(sf.mul(w2, e_b))
        c2_B = sf.mul(w2, sf.mul(w, sf.sub(t_x, sf.mul(ipp_a, ipp_b))))
        zb = z[:, None, :]
        c2_G = sf.mul(w2r, sf.neg(sf.add(zb, sf.mul(ipp_a[:, None, :], s_vec))))
        h_scal = sf.mul(sf.add(sf.mul(zb, y_pows), zeta), h_fact)
        c2_H = sf.mul(w2r, sf.sub(h_scal, sf.mul(sf.mul(ipp_b[:, None, :], s_inv_vec),
                                                 h_fact)))
        c2_L = sf.mul(w2r, u_sq)
        c2_R = sf.mul(w2r, u_inv_sq)

        # ----- one MSM: static points carry the sum over the batch, the
        # per-proof points (in comp's order) their own scalar
        static_scal = torch.cat([sf.add(c1_B, c2_B)[:, None], sf.add(c1_Bb, c2_Bb)[:, None],
                                 c2_G, c2_H], dim=1)
        dyn_scal = torch.cat([c1_V, w2r, c2_S[:, None], c1_T1[:, None], c1_T2[:, None],
                              c2_L, c2_R], dim=1)     # [B, P, 10]
        all_scal = torch.cat([sf.sum_over(static_scal, 0),
                              dyn_scal.reshape(-1, sf.NLIMBS)], dim=0)
        all_pts = pt.ExtPoint(*(torch.cat([s, d.reshape(-1, fe.NLIMBS)], dim=0)
                                for s, d in zip(self._static, pts)))
        total = qmsm.msm(sf.to_nibbles(all_scal), all_pts)
        return all_ok & pt.is_identity(total)

    # -- host API ------------------------------------------------------------

    def _pack(self, proofs, value_commitments, transcripts):
        B, m, k = self.batch, self.m, self.k
        if len(proofs) != B or len(value_commitments) != B:
            raise ValueError(f"batch size mismatch: {len(proofs)} != {B}")
        comp = np.zeros((B, m + 4 + 2 * k, 32), dtype=np.uint8)
        scal = np.zeros((B, 5, 32), dtype=np.uint8)
        for i, (proof, V) in enumerate(zip(proofs, value_commitments)):
            ipp = proof.ipp_proof
            if len(V) != m or len(ipp.L_vec) != k or len(ipp.R_vec) != k:
                raise ValueError("proof shape mismatch")
            rows = list(V) + [proof.A, proof.S, proof.T_1, proof.T_2] + ipp.L_vec + ipp.R_vec
            comp[i] = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 32)
            svals = [proof.t_x, proof.t_x_blinding, proof.e_blinding, ipp.a, ipp.b]
            scal[i] = np.frombuffer(b"".join(map(ex.sc_to_bytes, svals)),
                                    np.uint8).reshape(5, 32)
        if transcripts is None:
            transcripts = [Transcript(self.label)] * B
        snaps = [snapshot_host_strobe(t.strobe) for t in transcripts]
        frame = snaps[0][1:]
        if len(snaps) != B or any(s[1:] != frame for s in snaps):
            raise ValueError("lane transcripts diverged in framing")
        states = np.stack([np.frombuffer(s[0], np.uint8) for s in snaps])
        return comp, scal, states, frame

    def _run(self, comp, scal, weights, states, frame) -> bool:
        dev = self.device
        return bool(self._program(*(torch.as_tensor(a, device=dev)
                                    for a in (comp, scal, weights, states)), frame))

    def warmup(self) -> None:
        """Build the kernels (on CUDA) and run the program once on zero
        inputs, verdict discarded, so that the first batch pays no set-up."""
        B, m, k = self.batch, self.m, self.k
        state, *frame = snapshot_host_strobe(Transcript(self.label).strobe)
        states = np.tile(np.frombuffer(state, np.uint8), (B, 1))
        self._run(np.zeros((B, m + 4 + 2 * k, 32), np.uint8), np.zeros((B, 5, 32), np.uint8),
                  np.zeros((B, 2, 64), np.uint8), states, tuple(frame))

    def verify(self, proofs: Sequence, value_commitments: Sequence[Sequence[bytes]],
               transcripts=None, rng: Optional[object] = None) -> None:
        """Verify a full batch; raises ValueError unless every proof passes."""
        comp, scal, states, frame = self._pack(proofs, value_commitments, transcripts)
        nbytes = self.batch * 2 * 64
        wbytes = os.urandom(nbytes) if rng is None else rng.fill_bytes(nbytes)
        weights = np.frombuffer(wbytes, np.uint8).reshape(self.batch, 2, 64).copy()
        if not self._run(comp, scal, weights, states, frame):
            raise ValueError("Device batched range-proof verification failed")

    def verify_sharded(self, proofs: Sequence, value_commitments: Sequence[Sequence[bytes]],
                       mesh, transcripts=None, rng: Optional[object] = None) -> None:
        """verify() with the lane axis split over the ranks of ``mesh`` (a
        ``parallel.Mesh``): every rank calls it with the whole batch, packs
        only its own lanes and runs them on a cached verifier of B / size
        lanes on its device; the one collective shares the first failure.
        Every rank draws the whole batch's weights from ``rng`` and takes
        its lanes' rows, so with a seeded rng each lane's weights are those
        of verify(). Raises ValueError on every rank unless every lane on
        every rank passes."""
        B = self.batch
        if B % mesh.size:
            raise ValueError(f"batch {B} not divisible by {mesh.size} devices")
        if len(proofs) != B or len(value_commitments) != B:
            raise ValueError(f"batch size mismatch: {len(proofs)} != {B}")
        nbytes = B * 2 * 64
        wbytes = os.urandom(nbytes) if rng is None else rng.fill_bytes(nbytes)
        lanes = mesh.local_slice(B)
        local = get_device_range_verifier(self.n, self.m, B // mesh.size, self.label,
                                          device=mesh.device)
        error = ""
        try:    # a bad input is shared, not raised: the other ranks wait for this one
            comp, scal, states, frame = local._pack(
                proofs[lanes], value_commitments[lanes],
                None if transcripts is None else transcripts[lanes])
            weights = np.frombuffer(wbytes, np.uint8).reshape(B, 2, 64)[lanes].copy()
            if not local._run(comp, scal, weights, states, frame):
                error = "Device batched range-proof verification failed (sharded)"
        except ValueError as e:
            error = str(e)
        error = mesh.first_error(error)
        if error:
            raise ValueError(error)


# ---------------------------------------------------------------------------
# dispatch: verifier instances by shape
# ---------------------------------------------------------------------------

_VERIFIER_CACHE: dict = {}


def get_device_range_verifier(n: int, m: int, batch: int,
                              transcript_label: bytes = b"RangeProof",
                              device="cuda") -> DeviceRangeVerifier:
    """Process-wide cache of verifier instances by shape and device: their
    static generators stay resident between batches."""
    key = (n, m, batch, bytes(transcript_label), str(resolve_device(device)))
    if key not in _VERIFIER_CACHE:
        _VERIFIER_CACHE[key] = DeviceRangeVerifier(n, m, batch, transcript_label, device)
    return _VERIFIER_CACHE[key]


def device_batch_verify(instances, n: int, rng=None, min_bucket: int = 4,
                        device="cuda") -> None:
    """Verify [(proof, value_commitments, transcript), ...] on the device:
    group by aggregation width m and transcript framing (the lanes of one
    program share the STROBE frame), pad each group to a power-of-two bucket
    by repeating its first entry (a repeated lane verifies again, which is
    harmless), and run each group as one batch. Raises ValueError if any
    proof fails."""
    groups: dict = {}
    for inst in instances:
        frame = snapshot_host_strobe(inst[2].strobe)[1:]
        groups.setdefault((len(inst[1]), frame), []).append(inst)
    for (m, _), group in sorted(groups.items()):
        B = max(min_bucket, 1 << (len(group) - 1).bit_length())
        padded = group + [group[0]] * (B - len(group))
        drv = get_device_range_verifier(n, m, B, device=device)
        drv.verify([p for p, _, _ in padded], [V for _, V, _ in padded],
                   transcripts=[t for _, _, t in padded], rng=rng)
