"""Batched shuffle-proof verification, entirely on the device.

The shuffle argument is the reference's headline workload (reference
src/shuffle/shuffle.rs:547-712), and its verifier replay (transcript
framing, challenge derivation, Lagrange and product scalar work) is what a
host loop spends its time on. For B proofs of one shape (m x m anonymity
matrix, N = m^2 accounts) the whole verifier runs on the device between
one upload and one boolean:

  upload:  proof + statement + account bytes (uint8), fresh weights
  device:  batched STROBE transcripts -> challenges (x, Hadamard, y, z,
           MultiHadamard x/y, Zero x, SVP x, DDH, 2x Multiexpo x)
           -> Lagrange evaluations, power vectors, bilinear map scalars
           -> every sub-argument's point-identity checks, weighted into
              ONE MSM; the Schnorr-style recomputations (DDH first
              messages, the c_E recombination) run as batched point ops
              whose ristretto encodings feed the transcript
  fetch:   one boolean

The point work is three kernel calls (:mod:`quisquis_tpu_torch.ops.cuda_point`):
one ``scalar_mul`` over the B (3m + 3) per-lane products, one ``msm_rows``
over the 6B statement aggregates of N + 1 points, and one ``msm`` over the
19 weighted checks of every lane.

The program is three segments around its two MSMs (:meth:`_segments`): A
from the upload to the rows MSM's inputs, B from the rows to the final
MSM's inputs, C from the final MSM's point to the verdict. On CUDA each
transcript frame (the STROBE positions that a batch's transcript
histories fix) runs eagerly the first time it is seen; the second time
the segments are captured as three CUDA graphs over the instance's static
input buffers (:class:`GraphCache`), and from then on each call replays
them: one pinned upload, three graph launches and the two MSMs, issued
eagerly between them, so that every MSM call still passes through
``ops.msm``. On the CPU the segments always run eagerly.

It accepts exactly what the host verifier (ShuffleProof.verify) accepts
(tests/test_torch_shuffle_verify.py). The wire-static structural checks
(lengths, pinned identity commitments, omega uniqueness) run at pack time
on the host: the checks the host verifier makes before any challenge is
derived.
"""

from __future__ import annotations

import math
import os
import threading
from typing import List, NamedTuple

import numpy as np
import torch

from ..accounts.transcript import Transcript
from ..accounts.verifier import Verifier
from ..bulletproofs.device_verify import _ext_concat, _sf_tree_prod, _sf_tree_sum
from ..device import resolve_device
from ..ops import cuda_point as kp
from ..ops import exact as ex
from ..ops import field as fe
from ..ops import msm as qmsm
from ..ops import point as pt
from ..ops import scalar_field as sf
from ..ops.device_strobe import DeviceStrobe, DeviceTranscript, snapshot_host_strobe
from ..primitives.keys import RistrettoPublicKey
from ..primitives.pedersen import default_pedersen_gens, vector_pedersen_gens
from ..utils.metrics import metrics, span
from ..utils.staging import GraphCache, Staging, holding

L = ex.L

#: the transcript frames of one verifier instance that keep captured graphs
#: (each holds its graphs' memory); the least recently run is let go first.
#: A standalone shuffle is one frame; a transaction's input and output
#: shuffles are two (a block of 3x3 transactions runs its m = 3 instance
#: once on each), so four keep two transaction shapes of one set size
GRAPH_FRAMES = 4


def _cols(p: pt.ExtPoint, a: int, b: int) -> pt.ExtPoint:
    """Points a .. b - 1 along axis 1."""
    return pt.ExtPoint(*(c[:, a:b] for c in p))


class _LaneChecks:
    """Device accumulator of per-lane point-identity checks.

    Each check(scalars [B, k, 10], points [B, k]) asserts
    sum_j s_j P_j == identity per lane; it is scaled by the lane's next
    random weight and joins one global MSM (the device twin of
    accounts.deferred.DeferredPointChecks).
    """

    def __init__(self, weights: torch.Tensor):
        self._w = weights           # [B, NCHECKS, 10]
        self._ctr = 0
        self._scal: List[torch.Tensor] = []
        self._pts: List[pt.ExtPoint] = []
        self._terms = None

    def check(self, scalars: torch.Tensor, points: pt.ExtPoint) -> None:
        w = self._w[:, self._ctr]
        self._ctr += 1
        self._scal.append(sf.mul(scalars, w[:, None, :]))
        self._pts.append(points)

    def terms(self):
        """(nibbles, points): every check of every lane as the terms of one
        MSM, at its own term count; made at the first call."""
        if self._terms is None:
            scal = torch.cat([s.reshape(-1, sf.NLIMBS) for s in self._scal])
            pts = _ext_concat([pt.ExtPoint(*(c.reshape(-1, fe.NLIMBS) for c in p))
                               for p in self._pts])
            self._terms = sf.to_nibbles(scal), pts
        return self._terms

    def verify_msm(self) -> torch.Tensor:
        """One MSM over every check of every lane: is it the identity? (The
        replayed program runs the same MSM, then the identity test inside
        its last graph.)"""
        return pt.is_identity(qmsm.msm(*self.terms()))


class _Graphs(NamedTuple):
    """A frame's program captured: segment A's graph and the rows MSM's
    inputs it writes; the rows buffer [4, 6B, 10] that segment B's graph
    reads and the final MSM's inputs it writes; the final MSM's point
    buffer [4, 10] that segment C's graph reads and the verdict it
    writes; and every constant of a bounded cache that they read."""

    a: torch.cuda.CUDAGraph
    rows_in: tuple
    rows: torch.Tensor
    b: torch.cuda.CUDAGraph
    final_in: tuple
    total: torch.Tensor
    c: torch.cuda.CUDAGraph
    ok: torch.Tensor
    held: tuple     # the cached constants the graphs read (``staging.holding``)


class DeviceShuffleVerifier:
    """Batched verifier for shuffle proofs of one shape.

    Usage::

        dsv = DeviceShuffleVerifier(m=8, batch=16)   # 64-account shuffles
        dsv.verify(entries)   # entries: (proof, statement, inputs, outputs)

    Transcripts are fresh Verifier(proof_label, Transcript(label)) per
    lane by default; pass `transcripts=` (host Transcript objects with
    histories of one shape) for shuffles embedded in a larger protocol
    (the transaction flow): their STROBE states ship with the batch.
    """

    NCHECKS = 19

    def __init__(self, m: int, batch: int, proof_label: bytes = b"Shuffle",
                 transcript_label: bytes = b"ShuffleProof", device="cuda"):
        if m < 2:
            raise ValueError("the shuffle argument needs m >= 2")
        self.device = resolve_device(device)
        self.m = m
        self.N = m * m
        self.batch = batch
        self.proof_label = bytes(proof_label)
        self.transcript_label = bytes(transcript_label)
        xpc = vector_pedersen_gens(m + 1)
        pc = default_pedersen_gens()
        base_pk = RistrettoPublicKey.generate_base_pk()
        #: static point table (host order):
        #: [H, G_0..G_{m-1}, B, B_blinding, base_g, base_h, c_minus_one,
        #:  sumG (for com of constant vectors)]
        c_minus_one = xpc.commit([(-1) % L] * m, 0)
        sum_g = ex.pt_msm([1] * m, xpc.G_vec[:m])
        self._static_pts = ([xpc.H] + xpc.G_vec[:m]
                            + [pc.B, pc.B_blinding, base_pk.gr_point,
                               base_pk.grsk_point, c_minus_one, sum_g])
        self._statics = pt.from_exact_batch(self._static_pts, self.device)
        self._row_index = sf.scalars_to_dev([i + 1 for i in range(self.N)], self.device)
        self._graphs = GraphCache(GRAPH_FRAMES)
        self._staging = None    # a Staging: every call's inputs
        self._lock = threading.Lock()   # a call holds the staging buffers to its verdict

    # ---------------------------------------------------------------- layout

    @property
    def _npoints(self) -> int:
        m, N = self.m, self.N
        return 21 * m + 14 + 8 * N

    @property
    def _nscalars(self) -> int:
        return 10 * self.m + 19

    def _point_layout(self):
        m, N = self.m, self.N
        idx = {}
        off = 0

        def take(name, k):
            nonlocal off
            idx[name] = (off, off + k)
            off += k

        take("c_A", m)
        take("c_tau", m)
        take("c_B", m)
        take("c_B_dash", m)
        take("had_0", 3)            # c_a_0, c_b_0, c_c_0
        take("had_delta", m + 1)
        take("mh_cB", m)
        take("zero_head", 2)        # c_A_0, c_B_m
        take("zero_cD", 2 * m + 1)
        take("zero_stmt_cA", m - 1)  # last is replaced by c_minus_one
        take("svp", 4)              # d, delta_small, delta_capital, stmt c_a
        take("ddh", 2)              # G_dash, H_dash
        take("mepk_A0", 1)
        take("mepk_cBk", 2 * m)
        take("mepk_Ek0", 2 * m)
        take("mepk_Ek1", 2 * m)
        take("mec_A0", 1)
        take("mec_cBk", 2 * m)
        take("mec_Ek0", 2 * m)
        take("mec_Ek1", 2 * m)
        take("in_g", N)
        take("in_h", N)
        take("in_c", N)
        take("in_d", N)
        take("out_g", N)
        take("out_h", N)
        take("out_c", N)
        take("out_d", N)
        assert off == self._npoints, (off, self._npoints)
        return idx

    def _scalar_layout(self):
        m = self.m
        idx = {}
        off = 0

        def take(name, k):
            nonlocal off
            idx[name] = (off, off + k)
            off += k

        take("omega", m)
        take("had_a_bar", m)
        take("had_b_bar", m)
        take("had_c_bar", m)
        take("had_blind", 4)        # r_bar, s_bar, t_bar, rho_bar
        take("zero_a", m)
        take("zero_b", m)
        take("zero_blind", 3)       # r, s, t
        take("svp_a", m)
        take("svp_b", m)
        take("svp_blind", 3)        # r_tw, s_tw, statement b
        take("mepk", m + 3)         # a_vec, r, b, s
        take("mec", m + 4)          # a_vec, r, b, s, t
        take("ddh", 2)              # challenge, z
        assert off == self._nscalars, (off, self._nscalars)
        return idx

    # ---------------------------------------------------------------- device

    def _program(self, comp, scal, weights, states, frame) -> torch.Tensor:
        """The whole program, eagerly: segment A, the rows MSM, segment B,
        the final MSM and its identity test, segment C (arguments as
        :meth:`_segments`). Returns a 0-d bool tensor."""
        steps = self._segments(comp, scal, weights, states, frame)
        rows = qmsm.msm_rows(*next(steps))
        checks = steps.send(rows)
        return steps.send(checks.verify_msm())

    def _segments(self, comp, scal, weights, states, frame):
        """The program's three segments, as a generator: segment A yields
        the rows MSM's inputs (nibbles [6B, N+1, 64], points [6B, N+1]);
        sent that MSM's result (points [6B]), segment B yields the lanes'
        point checks (a ``_LaneChecks`` whose ``terms()``, the final MSM's
        inputs, it has made); sent whether their MSM is the identity (a 0-d
        bool tensor), segment C yields the verdict, a 0-d bool tensor. No
        segment fetches from the device or uploads to it.

        comp: uint8 [B, npoints, 32] wire points; scal: uint8
        [B, nscalars, 32]; weights: uint8 [B, NCHECKS, 64] uniform bytes;
        states: uint8 [B, 200] STROBE states; frame: (pos, pos_begin,
        cur_flags) of those states."""
        m, N = self.m, self.N
        B = comp.shape[0]
        dev = comp.device
        P = self._point_layout()
        S = self._scalar_layout()

        ok_pts, pts_all = kp.decode_bytes(comp)
        lane_ok = ok_pts.all(dim=-1)                # [B]

        def pts(name) -> pt.ExtPoint:
            return _cols(pts_all, *P[name])

        def wire(name) -> torch.Tensor:
            a, b_ = P[name]
            return comp[:, a:b_]

        def sc(name) -> torch.Tensor:
            a, b_ = S[name]
            return sf.from_bytes(scal[:, a:b_])     # loose limbs [B, k, 10]

        checks = _LaneChecks(sf.from_bytes_wide(weights))   # [B, NCHECKS, 10]
        statics = pt.ExtPoint(*(c[None].expand(B, -1, -1) for c in self._statics))
        H_pt = _cols(statics, 0, 1)                 # xpc H
        G_pts = _cols(statics, 1, 1 + m)            # G_0..G_{m-1}
        pc_B = _cols(statics, m + 1, m + 2)         # the basepoint
        pc_Bb = _cols(statics, m + 2, m + 3)
        base_g = _cols(statics, m + 3, m + 4)
        base_h = _cols(statics, m + 4, m + 5)
        c_minus_one = _cols(statics, m + 5, m + 6)
        sum_G = _cols(statics, m + 6, m + 7)

        def cat(plist: List[pt.ExtPoint]) -> pt.ExtPoint:
            return _ext_concat(plist, dim=1)

        def expand(s: torch.Tensor, k: int) -> torch.Tensor:
            return s[:, None, :].expand(B, k, sf.NLIMBS)

        one = sf.one((B,), dev)
        neg1 = sf.neg(one)

        def challenge(label: bytes) -> torch.Tensor:
            return sf.from_bytes_wide(dt.get_challenge_bytes(label))

        # ---------------- transcript ----------------
        dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(states, *frame))
        for i in range(m):
            dt.append_point_var(b"ACommitment", wire("c_A")[:, i])
            dt.append_point_var(b"tauCommitment", wire("c_tau")[:, i])
        x = challenge(b"xChallenge")
        exp_x = sf.powers(x, N + 1)[:, 1:]          # x^1..x^N  [B, N, 10]
        for i in range(m):
            dt.append_point_var(b"BCommitment", wire("c_B")[:, i])
            dt.append_point_var(b"BDashCommitment", wire("c_B_dash")[:, i])

        # ---------------- Hadamard ----------------
        dt.domain_sep(b"HadamardProductProof")
        for i in range(m):
            dt.append_point_var(b"c_a", wire("c_B_dash")[:, i])
            dt.append_point_var(b"c_b", wire("c_tau")[:, i])
            dt.append_point_var(b"c_c", wire("c_B")[:, i])
        dt.append_point_var(b"c_a_0", wire("had_0")[:, 0])
        dt.append_point_var(b"c_b_0", wire("had_0")[:, 1])
        dt.append_point_var(b"c_c_0", wire("had_0")[:, 2])
        for i in range(m + 1):
            dt.append_point_var(b"c_delta", wire("had_delta")[:, i])
        hx = challenge(b"challenge")

        # Lagrange evaluations at hx over nodes omega (the pack checked
        # their uniqueness): l_0(hx) = prod(hx - w_j); l_i(hx) = l_0(hx) /
        # ((hx - w_i) * prod_{j != i}(w_i - w_j)). Reject hx == w_i.
        omega = sc("omega")                         # [B, m, 10]
        diffs = sf.sub(expand(hx, m), omega)
        lane_ok = lane_ok & (~sf.is_zero(diffs)).all(dim=-1)
        ev0 = _sf_tree_prod(diffs)                  # l_0(hx) [B, 10]
        pair = sf.sub(omega[:, :, None, :].expand(B, m, m, sf.NLIMBS),
                      omega[:, None, :, :].expand(B, m, m, sf.NLIMBS))
        eye = torch.eye(m, dtype=torch.bool, device=dev)
        pair = torch.where(eye[None, :, :, None], sf.one((B, m, m), dev), pair)
        denom = _sf_tree_prod(pair)                 # prod over j != i [B, m, 10]
        inv = sf.batch_invert_rows(torch.cat([diffs, denom], dim=1))
        l_ev = sf.mul(sf.mul(inv[:, :m], inv[:, m:]), ev0[:, None, :])  # l_1..l_m

        a_bar, b_bar, c_bar = sc("had_a_bar"), sc("had_b_bar"), sc("had_c_bar")
        r_bar, s_bar, t_bar, rho_bar = sc("had_blind").unbind(1)

        def recombine(c0: pt.ExtPoint, commits: pt.ExtPoint,
                      blind: torch.Tensor, vals: torch.Tensor) -> None:
            # l_0(hx) c_0 + sum l_i(hx) C_i - blind*H - sum v_j G_j == 0
            s_comb = torch.cat([ev0[:, None, :], l_ev, sf.neg(blind)[:, None, :],
                                sf.neg(vals)], dim=1)
            checks.check(s_comb, cat([c0, commits, H_pt, G_pts]))

        had0 = pts("had_0")
        recombine(_cols(had0, 0, 1), pts("c_B_dash"), r_bar, a_bar)
        recombine(_cols(had0, 1, 2), pts("c_tau"), s_bar, b_bar)
        recombine(_cols(had0, 2, 3), pts("c_B"), t_bar, c_bar)

        exp_hx = sf.powers(hx, m + 1)               # [B, m+1, 10]
        abc = sf.sub(sf.mul(a_bar, b_bar), c_bar)
        s_delta = torch.cat([sf.mul(ev0[:, None, :], exp_hx),
                             sf.neg(rho_bar)[:, None, :], sf.neg(abc)], dim=1)
        checks.check(s_delta, cat([pts("had_delta"), H_pt, G_pts]))

        # ---------------- y, z + product statement ----------------
        y = challenge(b"yChallenge")
        z = challenge(b"zChallenge")
        terms = sf.sub(sf.add(sf.mul(y[:, None, :], self._row_index[None]), exp_x),
                       expand(z, N))
        r_tw, s_tw, svp_stmt_b = sc("svp_blind").unbind(1)
        lane_ok = lane_ok & sf.eq(_sf_tree_prod(terms), svp_stmt_b)

        # ---------------- MultiHadamard ----------------
        # (the c_E recombination and its encode-comparisons run in the
        # point phase below: the transcript framing does not depend on them)
        mh_wire = wire("mh_cB")
        dt.domain_sep(b"MultiHadamardProductProof")
        for i in range(m):
            dt.append_point_var(b"BVectorCommitment", mh_wire[:, i])
        mhx = challenge(b"XChallenge")
        mhy = challenge(b"YChallenge")
        mh_x_exp = sf.powers(mhx, m + 1)[:, 1:]     # x^1..x^m [B, m]
        mh_pts = pts("mh_cB")

        # ---------------- Zero argument ----------------
        dt.domain_sep(b"ZeroArgumentProof")
        dt.append_point_var(b"A0Commitment", wire("zero_head")[:, 0])
        dt.append_point_var(b"BmCommitment", wire("zero_head")[:, 1])
        for i in range(2 * m + 1):
            dt.append_point_var(b"DCommitment", wire("zero_cD")[:, i])
        zx = challenge(b"challenge")
        zx_exp = sf.powers(zx, 2 * m + 1)           # x^0..x^2m
        zx_m1 = zx_exp[:, 1:m + 1]                  # x^1..x^m
        zero_a, zero_b = sc("zero_a"), sc("zero_b")
        z_r, z_s, z_t = sc("zero_blind").unbind(1)
        zero_head = pts("zero_head")
        c_A0_pt, c_Bm_pt = _cols(zero_head, 0, 1), _cols(zero_head, 1, 2)
        # c_zero_A points: statement wires 0..m-2 then c_minus_one
        c_zero_A = cat([pts("zero_stmt_cA"), c_minus_one])

        # com(a_bar, r) - C_A_0 - sum x^i C_A_i == 0
        s1 = torch.cat([z_r[:, None, :], zero_a, neg1[:, None, :], sf.neg(zx_m1)], dim=1)
        checks.check(s1, cat([H_pt, G_pts, c_A0_pt, c_zero_A]))
        # (the com(b_bar, s) check needs the commit_D points: it follows in
        # the point phase)
        # com(a_bar . b_bar, t) - sum x^k C_D_k == 0 (plain Pedersen)
        y_i = sf.powers(mhy, m + 1)[:, 1:]          # y^1..y^m
        abb = _sf_tree_sum(sf.mul(sf.mul(zero_a, zero_b), y_i))
        s3 = torch.cat([abb[:, None, :], z_t[:, None, :], sf.neg(zx_exp)], dim=1)
        checks.check(s3, cat([pc_B, pc_Bb, pts("zero_cD")]))

        # ---------------- SVP ----------------
        dt.domain_sep(b"SingleValueProductProof")
        dt.append_point_var(b"DeltaSmall", wire("svp")[:, 1])
        dt.append_point_var(b"DeltaCapital", wire("svp")[:, 2])
        dt.append_point_var(b"d", wire("svp")[:, 0])
        sx = challenge(b"challenge")
        svp_a, svp_b = sc("svp_a"), sc("svp_b")
        lane_ok = lane_ok & sf.eq(sf.mul(svp_stmt_b, sx), svp_b[:, -1])
        svp_pts = pts("svp")
        # x C_a + C_d - com(a_bar, r_bar) == 0
        s4 = torch.cat([sx[:, None, :], one[:, None, :], sf.neg(r_tw)[:, None, :],
                        sf.neg(svp_a)], dim=1)
        checks.check(s4, cat([_cols(svp_pts, 3, 4), _cols(svp_pts, 0, 1), H_pt, G_pts]))
        # comvec_i = b[i+1] x - b[i] a[i+1]
        comvec = sf.sub(sf.mul(svp_b[:, 1:], sx[:, None, :]),
                        sf.mul(svp_b[:, :-1], svp_a[:, 1:]))   # [B, m-1]
        s5 = torch.cat([sx[:, None, :], one[:, None, :], sf.neg(s_tw)[:, None, :],
                        sf.neg(comvec)], dim=1)
        checks.check(s5, cat([_cols(svp_pts, 2, 3), _cols(svp_pts, 1, 2), H_pt,
                              _cols(G_pts, 0, m - 1)]))

        # ---------------- point phase ----------------
        # every per-lane scalar multiplication in one scalar_mul launch over
        # B (3m + 3) lanes
        ddh_chal, ddh_z = sc("ddh").unbind(1)
        mepk = sc("mepk")
        mec = sc("mec")
        mul_scal = torch.cat([
            expand(y, m),                       # yA: y * c_A_i           [m]
            sf.neg(z)[:, None, :],              # zG: -z * sum_G          [1]
            mh_x_exp,                           # c_D_mh: x^i * mh_cB     [m]
            mh_x_exp[:, :m - 1],                # c_D tail terms        [m-1]
            expand(mepk[:, m + 1], 2),          # pk reenc: b*base_{g,h}  [2]
            mec[:, m + 1][:, None, :],          # mec reenc: b*B          [1]
        ], dim=1)
        mul_pts = cat([pts("c_A"), sum_G, mh_pts, _cols(mh_pts, 1, m), base_g, base_h,
                       pc_B])
        K = mul_scal.shape[1]
        prods = kp.scalar_mul(sf.to_nibbles(mul_scal).reshape(B * K, pt.NWINDOWS),
                              pt.ExtPoint(*(c.reshape(B * K, fe.NLIMBS) for c in mul_pts)))
        prods = pt.ExtPoint(*(c.reshape(B, K, fe.NLIMBS) for c in prods))
        # every per-lane statement aggregation as six rows of one rows MSM
        # over [input pks | DDH point] (N + 1 points each):
        #   r0: G = sum x^i g_i              r1: H = sum x^i h_i
        #   r2: g_r = z_ddh*G + c*G_dash = sum (z_ddh x^i) g_i + c*G_dash
        #   r3: h_r = z_ddh*H + c*H_dash
        #   r4: t*G (commitment-multiexpo reencryption, key pk_GH)
        #   r5: t*H
        zx_ddh = sf.mul(exp_x, ddh_z[:, None, :])           # z_ddh * x^i
        tx = sf.mul(exp_x, mec[:, m + 3][:, None, :])       # t * x^i
        zero1 = sf.zeros((B, 1), dev)
        chal1 = ddh_chal[:, None, :]
        row_scal = torch.stack([
            torch.cat([exp_x, zero1], dim=1),
            torch.cat([exp_x, zero1], dim=1),
            torch.cat([zx_ddh, chal1], dim=1),
            torch.cat([zx_ddh, chal1], dim=1),
            torch.cat([tx, zero1], dim=1),
            torch.cat([tx, zero1], dim=1),
        ], dim=1)                                           # [B, 6, N+1]
        ddh_pts = pts("ddh")
        g_row = cat([pts("in_g"), _cols(ddh_pts, 0, 1)])    # [B, N+1]
        h_row = cat([pts("in_h"), _cols(ddh_pts, 1, 2)])
        # ---------------- end of segment A: the rows MSM ----------------
        rows = yield (
            sf.to_nibbles(row_scal).reshape(B * 6, N + 1, pt.NWINDOWS),
            pt.ExtPoint(*(torch.stack([g, h, g, h, g, h], dim=1).reshape(B * 6, N + 1, -1)
                          for g, h in zip(g_row, h_row))))
        rows = pt.ExtPoint(*(c.reshape(B, 6, fe.NLIMBS) for c in rows))

        off = 0

        def nxt(k):
            nonlocal off
            off += k
            return _cols(prods, off - k, off)

        yA, zG, c_D_mh, c_D_tail, re_pk, re_bB = (nxt(k) for k in (m, 1, m, m - 1, 2, 1))
        assert off == K

        # c_E_i = y*c_A_i + c_B_i + (-z)*sum_G
        c_E = pt.add(pt.add(yA, pts("c_B")),
                     pt.ExtPoint(*(c.expand(B, m, fe.NLIMBS) for c in zG)))
        c_D_last = pt.sum_points(c_D_tail, axis=1)
        commit_D = cat([_cols(c_D_mh, 0, m - 1), pt.ExtPoint(*(c[:, None] for c in c_D_last))])
        # zero argument: com(b_bar, s) - sum x^{m-i} C_B_i - C_B_m == 0
        s2 = torch.cat([z_s[:, None, :], zero_b, sf.neg(zx_m1.flip(1)), neg1[:, None, :]],
                       dim=1)
        checks.check(s2, cat([H_pt, G_pts, commit_D, c_Bm_pt]))

        # The six statement aggregates come out of the rows MSM above. DDH
        # responses use pk_GH = (G_agg, H_agg), NOT the base pk
        # (shuffle.rs:502-513 passes pk_GH into the commitment variant). Every
        # point that needs a ristretto encoding is ready before the DDH
        # appends, so one batched compress serves the comparisons and the
        # transcript: [c_E (m) | G_agg | H_agg | g_r | h_r].
        enc = kp.encode_bytes(cat([c_E, _cols(rows, 0, 4)]))  # [B, m+4, 32]

        def enc_eq(i: int, wire_bytes: torch.Tensor) -> torch.Tensor:
            # Byte equality with a canonical encoding: the wire is then
            # canonical too, so this accepts exactly what the host's
            # comparison of encodings accepts.
            return (enc[:, i] == wire_bytes).all(dim=-1)

        lane_ok = lane_ok & enc_eq(0, mh_wire[:, 0])
        stmt = wire("zero_stmt_cA")
        for i in range(1, m):
            lane_ok = lane_ok & enc_eq(i, stmt[:, i - 1])

        # ---------------- DDH ----------------
        dt.domain_sep(b"DDHTupleProof")
        dt.append_point_var(b"g", enc[:, m])
        dt.append_point_var(b"g_dash", wire("ddh")[:, 0])
        dt.append_point_var(b"h", enc[:, m + 1])
        dt.append_point_var(b"h_dash", wire("ddh")[:, 1])
        dt.append_point_var(b"gr", enc[:, m + 2])
        dt.append_point_var(b"hr", enc[:, m + 3])
        lane_ok = lane_ok & sf.eq(challenge(b"Challenge"), ddh_chal)

        # ---------------- Multiexpo (pubkey) ----------------
        # pk_GH == (E_k_0[m], E_k_1[m]) as bytes
        lane_ok = lane_ok & enc_eq(m, wire("mepk_Ek0")[:, m]) & enc_eq(m + 1, wire("mepk_Ek1")[:, m])
        self._multiexpo(
            dt, checks, b"MultiExponentialPubKeyProof", "mepk", wire, pts,
            pts("c_B_dash"), mepk,
            re0=_cols(re_pk, 0, 1), re1=_cols(re_pk, 1, 2),
            rows0=pts("out_g"), rows1=pts("out_h"),
            H_pt=H_pt, G_pts=G_pts, pc_B=pc_B, pc_Bb=pc_Bb, one=one)

        # ---------------- Multiexpo (commitment) ----------------
        # sum exp_x * C_in_i - E_m == 0 (both components)
        s_em = torch.cat([exp_x, neg1[:, None, :]], dim=1)
        checks.check(s_em, cat([pts("in_c"), _cols(pts("mec_Ek0"), m, m + 1)]))
        checks.check(s_em, cat([pts("in_d"), _cols(pts("mec_Ek1"), m, m + 1)]))
        self._multiexpo(
            dt, checks, b"MultiExponentialElgamalCommmitmentProof", "mec", wire, pts,
            pts("c_B"), mec,
            re0=_cols(rows, 4, 5),
            re1=pt.add(re_bB, _cols(rows, 5, 6)),
            rows0=pts("out_c"), rows1=pts("out_d"),
            H_pt=H_pt, G_pts=G_pts, pc_B=pc_B, pc_Bb=pc_Bb, one=one)

        assert checks._ctr == self.NCHECKS, checks._ctr
        checks.terms()
        # ---------------- end of segment B: the final MSM ----------------
        points_ok = yield checks
        # ---------------- segment C: the verdict ----------------
        yield lane_ok.all() & points_ok

    def _multiexpo(self, dt, checks, label, key, wire, pts, p_cA, vals, re0, re1,
                   rows0, rows1, H_pt, G_pts, pc_B, pc_Bb, one):
        """Shared multiexpo verification: transcript + 4 checks.

        ``vals`` holds a_vec, r, b, s (and t) of the proof; `re0`/`re1` [B, 1]
        are the reencryption points from the point phase: b*base for the
        pubkey variant, ElGamal Enc_pk_GH(b; t) = (t*G_agg, b*B + t*H_agg)
        for the commitment variant."""
        m = self.m
        w_A0, w_cBk, w_Ek0, w_Ek1 = (wire(f"{key}_{k}") for k in ("A0", "cBk", "Ek0", "Ek1"))
        dt.domain_sep(label)
        dt.append_point_var(b"A0Commitment", w_A0[:, 0])
        for k in range(2 * m):
            dt.append_point_var(b"BKCommitment", w_cBk[:, k])
            dt.append_point_var(b"EK0Commitment", w_Ek0[:, k])
            dt.append_point_var(b"EK1Commitment", w_Ek1[:, k])
        mx = sf.from_bytes_wide(dt.get_challenge_bytes(b"xchallenege"))
        x_exp = sf.powers(mx, 2 * m)                # x^0..x^{2m-1} [B, 2m]
        a_vec, r_s, b_s, s_s = vals[:, :m], vals[:, m], vals[:, m + 1], vals[:, m + 2]

        def cat(plist):
            return _ext_concat(plist, dim=1)

        # C_A_0 + sum x^i C_A_i - com(a_vec, r) == 0
        s1 = torch.cat([one[:, None, :], x_exp[:, 1:m + 1], sf.neg(r_s)[:, None, :],
                        sf.neg(a_vec)], dim=1)
        checks.check(s1, cat([pts(f"{key}_A0"), p_cA, H_pt, G_pts]))
        # com(b, s) - sum x^k C_B_k == 0
        s2 = torch.cat([b_s[:, None, :], s_s[:, None, :], sf.neg(x_exp)], dim=1)
        checks.check(s2, cat([pc_B, pc_Bb, pts(f"{key}_cBk")]))

        # sum x^k E_k - sum_i x^{m-1-i} <a_vec, row_i> - reenc == 0, where
        # rows: [B, N] points as m rows of m
        row_scal = [sf.neg(sf.mul(a_vec, x_exp[:, m - 1 - i][:, None, :])) for i in range(m)]
        s_ = torch.cat([x_exp] + row_scal + [sf.neg(one)[:, None, :]], dim=1)
        checks.check(s_, cat([pts(f"{key}_Ek0"), rows0, re0]))
        checks.check(s_, cat([pts(f"{key}_Ek1"), rows1, re1]))

    # ---------------------------------------------------------------- host

    def _default_transcripts(self):
        out = []
        for _ in range(self.batch):
            t = Transcript(self.transcript_label)
            Verifier(self.proof_label, t)  # appends the proof dom-sep
            out.append(t)
        return out

    @staticmethod
    def _states(transcripts):
        snaps = [snapshot_host_strobe(t.strobe) for t in transcripts]
        frame = snaps[0][1:]
        if any(s[1:] != frame for s in snaps):
            raise ValueError("lane transcripts diverged in framing")
        return np.stack([np.frombuffer(s[0], np.uint8) for s in snaps]), frame

    @span("dev.shuffle_verify.pack")
    def _pack(self, entries, transcripts):
        m, N, B = self.m, self.N, self.batch
        if len(entries) != B:
            raise ValueError(f"batch size mismatch: {len(entries)} != {B}")
        P = self._point_layout()
        S = self._scalar_layout()
        comp = np.zeros((B, self._npoints, 32), dtype=np.uint8)
        scal = np.zeros((B, self._nscalars, 32), dtype=np.uint8)
        enc_identity = ex.ristretto_encode(ex.IDENTITY)

        def put_pts(lane, name, blobs):
            a, b_ = P[name]
            if len(blobs) != b_ - a:
                raise ValueError(f"{name}: wrong length {len(blobs)}")
            for j, blob in enumerate(blobs):
                if len(blob) != 32:
                    raise ValueError(f"{name}: bad point size")
                comp[lane, a + j] = np.frombuffer(blob, np.uint8)

        def put_sc(lane, name, vals):
            a, b_ = S[name]
            if len(vals) != b_ - a:
                raise ValueError(f"{name}: wrong length")
            for j, v in enumerate(vals):
                scal[lane, a + j] = np.frombuffer(ex.sc_to_bytes(v % L), np.uint8)

        for lane, (proof, statement, inputs, outputs) in enumerate(entries):
            if not (len(proof.c_A) == m and len(proof.c_tau) == m
                    and len(proof.c_B) == m and len(proof.c_B_dash) == m):
                raise ValueError(
                    "Shuffle Proof Verify: Invalid length of commitment vectors")
            if len(inputs) != N or len(outputs) != N:
                raise ValueError("account vector length mismatch")
            had = proof.hadamard_proof
            hs = statement.hadamard_statement
            if len(set(hs.omega)) != m:
                raise ValueError(
                    "Hadamard Proof Verify: Omega values are not unique")
            mh = proof.product_proof.multi_hadamard_proof
            mhs = statement.product_statement.multi_hadamard_statement
            zp = mh.zero_proof
            zs = mhs.zero_statement
            svp = proof.product_proof.svp_proof
            svps = statement.product_statement.svp_statement
            mepk = proof.multi_exponen_pk
            mec = proof.multi_exponen_commit
            ddh = proof.ddh_proof
            dds = statement.ddh_statement
            # wire-static structural checks (host verifier raises the same)
            if len(zp.c_D) != 2 * m + 1 or len(zp.b_vec) != m:
                raise ValueError("Zero Argument Proof Verify: Size check failed")
            if zp.c_D[m + 1] != enc_identity:
                raise ValueError(
                    "Zero Argument Proof Verify: c_d_(m+1) == com(0,0) Failed")
            if mhs.c_b != mh.c_B[m - 1]:
                raise ValueError(
                    "Multihadamard Product Proof Verify: c_B_m == c_b Failed")
            if len(svp.b_twildle) != m or len(svp.a_twildle) != m:
                raise ValueError(
                    "SingleValue Product Proof Verify: Size check failed")
            if svp.a_twildle[0] != svp.b_twildle[0]:
                raise ValueError("SingleValue Product Proof Verify: Failed")
            for me, kind in ((mepk, "Pubkey"), (mec, "Commitment")):
                if not (len(me.a_vec) == m
                        and me.c_B_k[m] == enc_identity):
                    raise ValueError(
                        f"Multi-exponentiation {kind} Argument: "
                        "Verify com(0,0) == c_B_m Failed")
            zero_stmt_cA = list(zs.c_A[:m - 1])
            # the m-th statement commitment is pinned to com(-1vec, 0) by
            # the verifier (host replaces it silently; reject is wrong)

            put_pts(lane, "c_A", proof.c_A)
            put_pts(lane, "c_tau", proof.c_tau)
            put_pts(lane, "c_B", proof.c_B)
            put_pts(lane, "c_B_dash", proof.c_B_dash)
            put_pts(lane, "had_0", [had.commitment_a_0, had.commitment_b_0,
                                    had.commitment_c_0])
            put_pts(lane, "had_delta", had.commitment_delta)
            put_pts(lane, "mh_cB", mh.c_B)
            put_pts(lane, "zero_head", [zp.c_A_0, zp.c_B_m])
            put_pts(lane, "zero_cD", zp.c_D)
            put_pts(lane, "zero_stmt_cA", zero_stmt_cA)
            put_pts(lane, "svp", [svp.commitment_d,
                                  svp.commitment_delta_small,
                                  svp.commitment_delta_capital,
                                  svps.commitment_a])
            put_pts(lane, "ddh", [dds.G_dash, dds.H_dash])
            put_pts(lane, "mepk_A0", [mepk.c_A_0])
            put_pts(lane, "mepk_cBk", mepk.c_B_k)
            put_pts(lane, "mepk_Ek0", mepk.E_k_0)
            put_pts(lane, "mepk_Ek1", mepk.E_k_1)
            put_pts(lane, "mec_A0", [mec.c_A_0])
            put_pts(lane, "mec_cBk", mec.c_B_k)
            put_pts(lane, "mec_Ek0", mec.E_k_0)
            put_pts(lane, "mec_Ek1", mec.E_k_1)
            put_pts(lane, "in_g", [a.pk.gr for a in inputs])
            put_pts(lane, "in_h", [a.pk.grsk for a in inputs])
            put_pts(lane, "in_c", [a.comm.c for a in inputs])
            put_pts(lane, "in_d", [a.comm.d for a in inputs])
            put_pts(lane, "out_g", [a.pk.gr for a in outputs])
            put_pts(lane, "out_h", [a.pk.grsk for a in outputs])
            put_pts(lane, "out_c", [a.comm.c for a in outputs])
            put_pts(lane, "out_d", [a.comm.d for a in outputs])

            put_sc(lane, "omega", hs.omega)
            put_sc(lane, "had_a_bar", had.a_bar)
            put_sc(lane, "had_b_bar", had.b_bar)
            put_sc(lane, "had_c_bar", had.c_bar)
            put_sc(lane, "had_blind", [had.r_bar, had.s_bar, had.t_bar,
                                       had.rho_bar])
            put_sc(lane, "zero_a", zp.a_vec)
            put_sc(lane, "zero_b", zp.b_vec)
            put_sc(lane, "zero_blind", [zp.r, zp.s, zp.t])
            put_sc(lane, "svp_a", svp.a_twildle)
            put_sc(lane, "svp_b", svp.b_twildle)
            put_sc(lane, "svp_blind", [svp.r_twildle, svp.s_twildle, svps.b])
            put_sc(lane, "mepk", list(mepk.a_vec) + [mepk.r, mepk.b, mepk.s])
            put_sc(lane, "mec", list(mec.a_vec) + [mec.r, mec.b, mec.s,
                                                   mec.t])
            put_sc(lane, "ddh", [ddh.challenge, ddh.z])

        if transcripts is None:
            transcripts = self._default_transcripts()
        if len(transcripts) != B:
            raise ValueError(f"batch size mismatch: {len(transcripts)} transcripts")
        states, frame = self._states(transcripts)
        return comp, scal, states, frame

    def _upload(self, *arrays) -> list:
        """The uint8 arrays as views of the instance's one input buffer on
        the device (the graphs' static inputs): one copy a call."""
        if self._staging is None:   # the instance's shapes fix the size
            self._staging = Staging(sum(a.size for a in arrays), self.device)
        return self._staging.put(arrays)

    def _capture(self, inputs, frame) -> _Graphs:
        """Capture segments A, B and C over the static `inputs`, in one
        memory pool (nothing runs: the caller replays them)."""
        a, b, c = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        steps = self._segments(*inputs, frame)
        rows, total = (torch.empty((4, *shape, fe.NLIMBS), dtype=torch.int32, device=self.device)
                       for shape in ((6 * self.batch,), ()))
        with span("dev.shuffle_verify.capture"), holding() as held:
            with torch.cuda.graph(a, capture_error_mode="thread_local"):
                rows_in = next(steps)
            with torch.cuda.graph(b, pool=a.pool(), capture_error_mode="thread_local"):
                final_in = steps.send(pt.ExtPoint(*rows.unbind(0))).terms()
            with torch.cuda.graph(c, pool=a.pool(), capture_error_mode="thread_local"):
                ok = steps.send(pt.is_identity(pt.ExtPoint(*total.unbind(0))))
        metrics.count("dev.shuffle_verify.graph_captures")
        return _Graphs(a, rows_in, rows, b, final_in, total, c, ok,
                       tuple({id(t): t for t in held}.values()))

    def _replay(self, g: _Graphs) -> torch.Tensor:
        """The program by its graphs, the two MSMs eagerly between them;
        each MSM's result enters the next graph by one device copy."""
        with span("dev.shuffle_verify.replay"):
            g.a.replay()
        torch.stack(tuple(qmsm.msm_rows(*g.rows_in)), out=g.rows)
        with span("dev.shuffle_verify.replay"):
            g.b.replay()
        torch.stack(tuple(qmsm.msm(*g.final_in)), out=g.total)
        with span("dev.shuffle_verify.replay"):
            g.c.replay()
        return g.ok

    def _run(self, comp, scal, weights, states, frame) -> bool:
        metrics.count("dev.shuffle_verify.runs")
        with self._lock:
            inputs = self._upload(comp, scal, weights, states)
            graphs, capture = (self._graphs.get(frame) if self.device.type == "cuda"
                               else (None, False))
            if capture:
                graphs = self._capture(inputs, frame)
                self._graphs.put(frame, graphs)
            elif graphs is not None:
                metrics.count("dev.shuffle_verify.graph_replays")
            ok = self._program(*inputs, frame) if graphs is None else self._replay(graphs)
            with span("dev.shuffle_verify.wait"):
                return bool(ok)

    def warmup(self, transcripts=None) -> None:
        """Build the kernels (on CUDA) and run the program on zero inputs,
        verdict discarded, so that the first batch pays no set-up: once on
        the CPU, twice on CUDA (the second run captures the graphs of the
        transcripts' frame). Zero bytes decode as the identity point and the
        zero scalar."""
        B = self.batch
        states, frame = self._states(transcripts or self._default_transcripts())
        for _ in range(2 if self.device.type == "cuda" else 1):
            self._run(np.zeros((B, self._npoints, 32), np.uint8),
                      np.zeros((B, self._nscalars, 32), np.uint8),
                      np.zeros((B, self.NCHECKS, 64), np.uint8), states, frame)

    def verify(self, entries, transcripts=None, rng=None) -> None:
        """entries: (proof, statement, input accounts, output accounts) x B.
        Raises ValueError unless every lane verifies."""
        comp, scal, states, frame = self._pack(entries, transcripts)
        nbytes = self.batch * self.NCHECKS * 64
        wbytes = os.urandom(nbytes) if rng is None else rng.fill_bytes(nbytes)
        weights = np.frombuffer(wbytes, np.uint8).reshape(self.batch, self.NCHECKS, 64)
        if not self._run(comp, scal, weights.copy(), states, frame):
            raise ValueError("Device batched shuffle verification failed")

    def verify_sharded(self, entries, mesh, transcripts=None, rng=None) -> None:
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
        if len(entries) != B:
            raise ValueError(f"batch size mismatch: {len(entries)} != {B}")
        nbytes = B * self.NCHECKS * 64
        wbytes = os.urandom(nbytes) if rng is None else rng.fill_bytes(nbytes)
        lanes = mesh.local_slice(B)
        local = get_device_shuffle_verifier(self.m, B // mesh.size, self.proof_label,
                                            self.transcript_label, device=mesh.device)
        error = ""
        try:    # a bad input is shared, not raised: the other ranks wait for this one
            comp, scal, states, frame = local._pack(
                entries[lanes], None if transcripts is None else transcripts[lanes])
            weights = np.frombuffer(wbytes, np.uint8).reshape(B, self.NCHECKS, 64)[lanes]
            if not local._run(comp, scal, weights.copy(), states, frame):
                error = "Device batched shuffle verification failed (sharded)"
        except ValueError as e:
            error = str(e)
        error = mesh.first_error(error)
        if error:
            raise ValueError(error)


# ---------------------------------------------------------------------------
# dispatch: verifier instances by shape
# ---------------------------------------------------------------------------

_VERIFIER_CACHE: dict = {}
_MIN_BUCKET = 2  # device_batch_verify's smallest lane count


def get_device_shuffle_verifier(m: int, batch: int,
                                proof_label: bytes = b"Shuffle",
                                transcript_label: bytes = b"ShuffleProof",
                                device="cuda") -> DeviceShuffleVerifier:
    """Process-wide cache of verifier instances by shape and device: their
    static points stay resident between batches."""
    key = (m, batch, bytes(proof_label), bytes(transcript_label),
           str(resolve_device(device)))
    if key not in _VERIFIER_CACHE:
        _VERIFIER_CACHE[key] = DeviceShuffleVerifier(m, batch, proof_label,
                                                     transcript_label, device)
    return _VERIFIER_CACHE[key]


@span("dev.shuffle_verify")
def device_batch_verify(entries, transcripts=None, rng=None, device="cuda") -> None:
    """Verify [(proof, statement, inputs, outputs), ...] on the device.

    Groups by anonymity-set size and transcript framing (the lanes of one
    program share the STROBE frame: standalone and embedded prefixes
    bucket separately), pads each group to a power-of-two bucket of at
    least two lanes by repeating its first entry (a repeated lane verifies
    again, which is harmless), and runs each group as one batch: transcript replay,
    challenge arithmetic, per-lane products and the combined 19-check MSM.
    The batched successor of looping the host verifier (reference
    src/shuffle/shuffle.rs:547-712).

    `transcripts`, when given, are per-entry host Transcript objects in the
    pre-proof state (for shuffles embedded in a larger protocol).
    Raises ValueError if any proof fails.
    """
    groups: dict = {}
    for i, e in enumerate(entries):
        frame = (None if transcripts is None
                 else snapshot_host_strobe(transcripts[i].strobe)[1:])
        groups.setdefault((len(e[2]), frame), []).append(i)
    for (n_acc, _), idxs in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        m = math.isqrt(n_acc)
        if m * m != n_acc:
            raise ValueError(f"anonymity set size {n_acc} is not square")
        B = max(_MIN_BUCKET, 1 << (len(idxs) - 1).bit_length())
        pad_idx = idxs + [idxs[0]] * (B - len(idxs))
        dsv = get_device_shuffle_verifier(m, B, device=device)
        ts = None if transcripts is None else [transcripts[i] for i in pad_idx]
        dsv.verify([entries[i] for i in pad_idx], transcripts=ts, rng=rng)
