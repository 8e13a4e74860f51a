"""Batched aggregated range-proof proving, on the device.

For B proofs of one shape (n bits, m values) the whole prover runs between
one upload and one fetch:

  upload:  value and blinding bytes, the bits, the random scalars that the
           host prover would draw (a and s blindings, s_L, s_R, t1 and t2
           blindings; drawn per lane from the caller's rng in the host
           prover's exact order, so the proofs are byte-identical under the
           same streams), the lanes' STROBE states
  device:  V, A and S in one shared-basis rows MSM -> challenges y, z -> the
           t polynomial's inner products -> T1, T2 (one MSM) -> x, w -> the
           l and r vectors -> the inner-product rounds, each round's L and R
           one shared-basis rows MSM over the ORIGINAL generators, with
           coefficient vectors cG, cH folded by u^{+-1} each round (no point
           vector is folded); the challenges come from the batched device
           transcript (ops/device_strobe.py)
  fetch:   every proof component: compressed points and canonical scalars

The basis [B, B_blinding, G, H] of the commitments and the inner-product
rounds (B_blinding with a zero coefficient there) and the pair
[B, B_blinding] of T1 and T2 are :class:`~quisquis_tpu_torch.ops.cuda_point.SharedBasis`
objects, one pair per shape and device: their MSM tables are built once
and tiled to the rows of each call (``ops/cuda_point.msm_shared_rows``).

Byte-identical to ``RangeProof.prove_multiple`` under the same rng streams
(tests/test_torch_range_prove.py).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..accounts.transcript import Transcript
from ..device import resolve_device
from ..ops import cuda_point as kp
from ..ops import exact as ex
from ..ops import msm as qmsm
from ..ops import point as pt
from ..ops import scalar_field as sf
from ..ops.device_strobe import DeviceStrobe, DeviceTranscript, snapshot_host_strobe
from ..primitives.pedersen import default_pedersen_gens
from ..utils.metrics import span
from .device_verify import _sf_tree_sum
from .generators import bulletproof_gens
from .inner_product import InnerProductProof
from .range_proof import RangeProof


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sf_tree_sum(sf.mul(a, b))


def _scalar_bytes(x: int) -> np.ndarray:
    return np.frombuffer(ex.sc_to_bytes(x), np.uint8)


@functools.lru_cache(maxsize=None)
def _bases(n: int, m: int, device: torch.device):
    """The shared bases of one shape: [B, B_blinding, G, H] and
    [B, B_blinding]. One pair for the provers of every batch size, so their
    MSM tables are built once."""
    pc = default_pedersen_gens()
    bp = bulletproof_gens(n, m)
    return (qmsm.SharedBasis(pt.from_exact_batch([pc.B, pc.B_blinding] + bp.G(n, m) + bp.H(n, m),
                                                 device)),
            qmsm.SharedBasis(pt.from_exact_batch([pc.B, pc.B_blinding], device)))


class DeviceRangeProver:
    """Batched prover for aggregated range proofs of a fixed shape (n bits,
    m values per proof, B proofs per batch).

    Usage::

        drp = DeviceRangeProver(n=64, m=16, batch=32)
        proofs, vlists = drp.prove(values, blindings, rngs=rngs)

    ``transcripts`` (optional) are per-lane host Transcripts in the
    pre-proof state; they are NOT advanced (callers embedding these proofs
    advance them with ``proof.advance_transcript``).
    """

    def __init__(self, n: int, m: int, batch: int,
                 transcript_label: bytes = b"RangeProof", device="cuda"):
        if m < 1 or m & (m - 1):
            raise ValueError("m must be a power of two")
        if n not in (8, 16, 32, 64):
            raise ValueError("n must be 8, 16, 32 or 64")
        self.device = resolve_device(device)
        self.n, self.m, self.batch = n, m, batch
        self.label = bytes(transcript_label)
        self.nm = n * m
        self.k = self.nm.bit_length() - 1  # inner-product rounds
        dev = self.device
        self._basis, self._pc_basis = _bases(n, m, dev)
        self._two_pows = sf.scalars_to_dev([1 << i for i in range(n)], dev)
        # round r of the inner-product argument: original index t lies in
        # the high half by bit (k - 1 - r) of t, at position t mod ncur
        tidx = np.arange(self.nm)
        self._hi = [torch.as_tensor((tidx >> (self.k - 1 - r)) & 1 == 1, device=dev)[None, :, None]
                    for r in range(self.k)]
        self._pos = [torch.as_tensor(tidx % (self.nm >> (r + 1)), device=dev)
                     for r in range(self.k)]

    # -- device program ------------------------------------------------------

    def _program(self, vb, blb, bits, svecs, rand4, states, frame):
        """vb, blb: uint8 [B, m, 32] value and blinding bytes; bits: bool
        [B, nm]; svecs: uint8 [B, 2, nm, 32] (s_L, s_R); rand4: uint8
        [B, 4, 32] (a, s, t1, t2 blindings); states: uint8 [B, 200] STROBE
        states with frame (pos, pos_begin, cur_flags). Returns (comp uint8
        [B, m + 4 + 2k, 32]: V m | A S T1 T2 | L k | R k, the layout of
        DeviceRangeVerifier; scal uint8 [B, 5, 32]: t_x, t_x_blinding,
        e_blinding, ipp a, ipp b)."""
        n, m, nm, k = self.n, self.m, self.nm, self.k
        B, dev = vb.shape[0], vb.device
        NL = sf.NLIMBS
        v = sf.from_bytes(vb)                          # [B, m, 10]
        bl = sf.from_bytes(blb)
        s_L = sf.from_bytes(svecs[:, 0])               # [B, nm, 10]
        s_R = sf.from_bytes(svecs[:, 1])
        a_blind, s_blind, t1_blind, t2_blind = sf.from_bytes(rand4).unbind(1)

        # ----- V, A, S in one shared-basis rows MSM: per lane m rows V_j
        # (v_j B + bl_j B~), then A and S over [B, B~, G, H]
        zero_nm = sf.zeros((B, nm), dev)
        bit1 = bits[..., None]
        bit_sc = torch.where(bit1, sf.one((B, nm), dev), zero_nm)
        aR_sc = torch.where(bit1, zero_nm, sf.neg(sf.one((B, nm), dev)))
        zero_col = sf.zeros((B, 1), dev)
        a_row = torch.cat([zero_col, a_blind[:, None], bit_sc, aR_sc], dim=1)
        s_row = torch.cat([zero_col, s_blind[:, None], s_L, s_R], dim=1)
        v_nib = sf.to_nibbles(torch.stack([v, bl], dim=2))          # [B, m, 2, 64]
        v_nib = torch.cat([v_nib, v_nib.new_zeros((B, m, 2 * nm, pt.NWINDOWS))], dim=2)
        nib = torch.cat([v_nib, sf.to_nibbles(torch.stack([a_row, s_row], dim=1))], dim=1)
        vas = qmsm.msm_shared_rows(nib.reshape(B * (m + 2), 2 + 2 * nm, pt.NWINDOWS),
                                   self._basis)
        enc = kp.encode_bytes(vas).reshape(B, m + 2, 32)
        V_b, A_b, S_b = enc[:, :m], enc[:, m], enc[:, m + 1]

        # ----- transcript to y, z
        dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(states, *frame))
        dt.append_message(b"dom-sep", b"rangeproof v1")
        dt.append_u64(b"n", n)
        dt.append_u64(b"m", m)
        for j in range(m):
            dt.append_message(b"V", V_b[:, j], 32)
        dt.append_message(b"A", A_b, 32)
        dt.append_message(b"S", S_b, 32)
        y = sf.from_bytes_wide(dt.get_challenge_bytes(b"y"))
        z = sf.from_bytes_wide(dt.get_challenge_bytes(b"z"))

        # ----- t polynomial
        y_nm = sf.powers(y, nm)                        # [B, nm, 10]
        z_pows = sf.powers(z, m + 2)
        zj = z_pows[:, 2:2 + m]                        # z^(2+j)
        zeta = sf.mul(zj[:, :, None, :], self._two_pows).reshape(B, nm, NL)
        zb = z[:, None, :].expand(B, nm, NL)
        l0 = sf.sub(bit_sc, zb)
        l1 = s_L
        r0 = sf.add(sf.mul(y_nm, sf.add(aR_sc, zb)), zeta)
        r1 = sf.mul(y_nm, s_R)
        t0 = _inner(l0, r0)
        t2 = _inner(l1, r1)
        t1 = sf.sub(sf.sub(_inner(sf.add(l0, l1), sf.add(r0, r1)), t0), t2)

        # T1 = t1 B + t1b B~ ; T2 = t2 B + t2b B~
        t_rows = torch.stack([torch.stack([t1, t1_blind], dim=1),
                              torch.stack([t2, t2_blind], dim=1)], dim=1)   # [B, 2, 2, 10]
        T = qmsm.msm_shared_rows(sf.to_nibbles(t_rows).reshape(B * 2, 2, pt.NWINDOWS),
                                 self._pc_basis)
        T_enc = kp.encode_bytes(T).reshape(B, 2, 32)
        dt.append_message(b"T_1", T_enc[:, 0], 32)
        dt.append_message(b"T_2", T_enc[:, 1], 32)
        x = sf.from_bytes_wide(dt.get_challenge_bytes(b"x"))

        xsq = sf.mul(x, x)
        t_x = sf.add(t0, sf.add(sf.mul(t1, x), sf.mul(t2, xsq)))
        txb = sf.add(sf.mul(t1_blind, x), sf.mul(t2_blind, xsq))
        txb = sf.add(txb, _sf_tree_sum(sf.mul(zj, bl)))   # + sum_j z^(2+j) blinding_j
        e_blind = sf.add(a_blind, sf.mul(x, s_blind))
        t_x_bytes, txb_bytes, eb_bytes = sf.to_bytes_array(
            torch.stack([t_x, txb, e_blind], dim=1)).unbind(1)
        dt.append_scalar_var(b"t_x", t_x_bytes)
        dt.append_scalar_var(b"t_x_blinding", txb_bytes)
        dt.append_scalar_var(b"e_blinding", eb_bytes)
        w = sf.from_bytes_wide(dt.get_challenge_bytes(b"w"))

        # ----- inner-product rounds: L and R as shared-basis MSMs over the
        # original [B, B~ (coefficient 0), G, H] through coefficient vectors
        dt.append_message(b"dom-sep", b"ipp v1")
        dt.append_u64(b"n", nm)
        a_vec = sf.add(l0, sf.mul(l1, x[:, None, :]))   # [B, nm]
        b_vec = sf.add(r0, sf.mul(r1, x[:, None, :]))
        cG = sf.one((B, nm), dev)                        # G factors
        cH = sf.powers(sf.invert(y), nm)                 # H factors y^-i
        L_out, R_out = [], []
        ncur = nm
        for rnd in range(k):
            ncur //= 2
            a_lo, a_hi = a_vec[:, :ncur], a_vec[:, ncur:]
            b_lo, b_hi = b_vec[:, :ncur], b_vec[:, ncur:]
            c_Lw = sf.mul(_inner(a_lo, b_hi), w)
            c_Rw = sf.mul(_inner(a_hi, b_lo), w)
            hi, pos = self._hi[rnd], self._pos[rnd]
            # L: a_lo on the G of the high half, b_hi on the H of the low
            # half; R the other way round
            gL = torch.where(hi, sf.mul(a_lo[:, pos], cG), zero_nm)
            hL = torch.where(hi, zero_nm, sf.mul(b_hi[:, pos], cH))
            gR = torch.where(hi, zero_nm, sf.mul(a_hi[:, pos], cG))
            hR = torch.where(hi, sf.mul(b_lo[:, pos], cH), zero_nm)
            rows = torch.stack([torch.cat([c_Lw[:, None], zero_col, gL, hL], dim=1),
                                torch.cat([c_Rw[:, None], zero_col, gR, hR], dim=1)], dim=1)
            LR = qmsm.msm_shared_rows(sf.to_nibbles(rows).reshape(B * 2, 2 + 2 * nm,
                                                                  pt.NWINDOWS), self._basis)
            LR_enc = kp.encode_bytes(LR).reshape(B, 2, 32)
            L_out.append(LR_enc[:, 0])
            R_out.append(LR_enc[:, 1])
            dt.append_message(b"L", LR_enc[:, 0], 32)
            dt.append_message(b"R", LR_enc[:, 1], 32)
            u = sf.from_bytes_wide(dt.get_challenge_bytes(b"u"))
            u_inv = sf.invert(u)
            ub, uib = u[:, None, :], u_inv[:, None, :]
            a_vec = sf.add(sf.mul(a_lo, ub), sf.mul(a_hi, uib))
            b_vec = sf.add(sf.mul(b_lo, uib), sf.mul(b_hi, ub))
            cG = sf.mul(cG, torch.where(hi, ub, uib))
            cH = sf.mul(cH, torch.where(hi, uib, ub))

        ab = sf.to_bytes_array(torch.stack([a_vec[:, 0], b_vec[:, 0]], dim=1))
        comp = torch.cat([V_b, enc[:, m:], T_enc, torch.stack(L_out, dim=1),
                          torch.stack(R_out, dim=1)], dim=1)
        scal = torch.cat([torch.stack([t_x_bytes, txb_bytes, eb_bytes], dim=1), ab], dim=1)
        return comp, scal

    # -- host API ------------------------------------------------------------

    def _pack_lane(self, values_i, blindings_i, rng):
        """One lane's witnesses: (vb, blb, bits, svecs, rand4), consuming
        ``rng`` in the host prover's exact draw order (range_proof.py
        prove_multiple): a_blinding, s_L, s_R, s_blinding, t1_blinding,
        t2_blinding."""
        n, m, nm = self.n, self.m, self.nm
        if len(values_i) != m or len(blindings_i) != m:
            raise ValueError("value count mismatch")
        for v in values_i:
            if not 0 <= v < (1 << n):
                raise ValueError(f"value out of range for {n}-bit proof")
        vb = np.stack([_scalar_bytes(v) for v in values_i])
        blb = np.stack([_scalar_bytes(b) for b in blindings_i])
        vals = np.array(values_i, dtype=np.uint64)
        bits = ((vals[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)).reshape(nm) == 1
        a_blinding = _scalar_bytes(rng.random_scalar())
        svecs = np.stack([_scalar_bytes(rng.random_scalar()) for _ in range(2 * nm)])
        rand4 = np.stack([a_blinding] + [_scalar_bytes(rng.random_scalar()) for _ in range(3)])
        return vb, blb, bits, svecs.reshape(2, nm, 32), rand4

    @span("dev.range_prove.pack")
    def _pack(self, values, blindings, rngs, transcripts):
        B = self.batch
        if len(values) != B or len(blindings) != B or len(rngs) != B:
            raise ValueError("lane count mismatch")
        lanes = [self._pack_lane(values[i], blindings[i], rngs[i]) for i in range(B)]
        arrays = tuple(np.stack(a) for a in zip(*lanes))
        if transcripts is None:
            transcripts = [Transcript(self.label) for _ in range(B)]
        snaps = [snapshot_host_strobe(t.strobe) for t in transcripts]
        frame = snaps[0][1:]
        if len(snaps) != B or any(s[1:] != frame for s in snaps):
            raise ValueError("lane transcripts diverged in framing")
        states = np.stack([np.frombuffer(s[0], np.uint8) for s in snaps])
        return arrays + (states,), frame

    def _run(self, arrays, frame):
        comp, scal = self._program(*(torch.as_tensor(a, device=self.device) for a in arrays),
                                   frame)
        with span("dev.range_prove.wait"):
            return comp.cpu().numpy(), scal.cpu().numpy()

    @span("dev.range_prove")
    def prove(self, values: Sequence[Sequence[int]], blindings: Sequence[Sequence[int]],
              rngs: Sequence, transcripts=None) -> Tuple[List[RangeProof], List[List[bytes]]]:
        """values, blindings: B lanes of m entries; rngs: one SeededRng per
        lane (drawn in the host prover's exact order). Returns (proofs, V
        byte lists), byte-identical to the host prover under the same
        streams."""
        arrays, frame = self._pack(values, blindings, rngs, transcripts)
        return self._decode(*self._run(arrays, frame))

    def prove_sharded(self, values: Sequence[Sequence[int]], blindings: Sequence[Sequence[int]],
                      rngs: Sequence, mesh, transcripts=None
                      ) -> Tuple[List[RangeProof], List[List[bytes]]]:
        """prove() with the lane axis split over the ranks of ``mesh`` (a
        ``parallel.Mesh``): every rank calls it with the whole batch, packs
        and proves only its own lanes on a cached prover of B / size lanes
        on its device, and gathers every lane's bytes, so every rank returns
        the whole (proofs, V lists), byte-identical to prove(). Lane i's rng
        is drawn from only on the rank that proves lane i. A rejected input
        raises its ValueError on every rank."""
        B = self.batch
        if B % mesh.size:
            raise ValueError(f"batch {B} not divisible by {mesh.size} devices")
        if len(values) != B or len(blindings) != B or len(rngs) != B:
            raise ValueError("lane count mismatch")
        lanes = mesh.local_slice(B)
        local = get_device_range_prover(self.n, self.m, B // mesh.size, self.label,
                                        device=mesh.device)
        error = ""
        try:    # a bad input is shared, not raised: the other ranks wait for this one
            comp, scal = local._run(*local._pack(
                values[lanes], blindings[lanes], rngs[lanes],
                None if transcripts is None else transcripts[lanes]))
        except ValueError as e:
            error = str(e)
        error = mesh.first_error(error)
        if error:
            raise ValueError(error)
        return self._decode(mesh.gather_rows(comp), mesh.gather_rows(scal))

    def _decode(self, comp: np.ndarray, scal: np.ndarray):
        m, k = self.m, self.k
        proofs, vlists = [], []
        for c, s in zip(comp, scal):
            pts = [bytes(r) for r in c]
            a, b = (int.from_bytes(bytes(r), "little") for r in s[3:])
            ipp = InnerProductProof(pts[m + 4:m + 4 + k], pts[m + 4 + k:], a, b)
            t_x, txb, eb = (int.from_bytes(bytes(r), "little") for r in s[:3])
            proofs.append(RangeProof(*pts[m:m + 4], t_x, txb, eb, ipp))
            vlists.append(pts[:m])
        return proofs, vlists

    def warmup(self) -> None:
        """Build the kernels (on CUDA) and the basis tables, and run the
        program once on zero inputs, result discarded."""
        B, m, nm = self.batch, self.m, self.nm
        state, *frame = snapshot_host_strobe(Transcript(self.label).strobe)
        self._run((np.zeros((B, m, 32), np.uint8), np.zeros((B, m, 32), np.uint8),
                   np.zeros((B, nm), bool), np.zeros((B, 2, nm, 32), np.uint8),
                   np.zeros((B, 4, 32), np.uint8),
                   np.tile(np.frombuffer(state, np.uint8), (B, 1))), tuple(frame))


# ---------------------------------------------------------------------------
# dispatch: prover instances by shape
# ---------------------------------------------------------------------------

_PROVER_CACHE: dict = {}


def get_device_range_prover(n: int, m: int, batch: int,
                            transcript_label: bytes = b"RangeProof",
                            device="cuda") -> DeviceRangeProver:
    """Process-wide cache of prover instances by shape and device: their
    generator tables stay resident between batches."""
    key = (n, m, batch, bytes(transcript_label), str(resolve_device(device)))
    if key not in _PROVER_CACHE:
        _PROVER_CACHE[key] = DeviceRangeProver(n, m, batch, transcript_label, device)
    return _PROVER_CACHE[key]
