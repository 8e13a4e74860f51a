"""Batched shuffle-proof proving, on the device.

The prove side of the shuffle argument (reference
src/shuffle/shuffle.rs:361-532): for B shuffles of one shape (m x m
anonymity matrix, N = m^2 accounts) the whole prover runs between one
upload and one fetch:

  upload:  permutation, tau and rho witnesses, account bytes, the bytes the
           host rng would give (the c_A blindings and the 9 entropies that
           finalize the transcript rngs, drawn at pack time in the host
           prover's exact order), the lanes' STROBE states
  device:  batched STROBE transcripts and witness-rekeyed transcript rngs
           (ops/device_strobe.py DeviceTranscriptRng, bit-exact with merlin's
           TranscriptRng); every commitment a row of a shared-basis MSM over
           the cached [H, G_0..G_{m-1}] or [B, B_blinding] tables
           (ops/cuda_point.msm_shared_rows), the DDH and
           multi-exponentiation rows through ops/msm.msm_rows; Lagrange and
           quotient polynomials, bilinear maps and every response as
           batched scalar-field tensor operations
  fetch:   every proof field: compressed points and canonical scalars

Each MSM call takes all the rows of one phase of every lane. Byte-identical
to ``ShuffleProof.create_shuffle_proof`` under the same SeededRng streams
(tests/test_torch_shuffle_prove.py): the host rng gives only the c_A
blindings and the 9 entropies; every other draw is replayed on the device
from the transcript state, as merlin's witness-rekeyed TranscriptRng does.

Sub-argument provers mirrored here (host modules in parentheses):
permutation, tau, b and b' commitments (shuffle.py), Hadamard
(hadamard.py), Product = MultiHadamard + Zero + SVP (product.py,
singlevalueproduct.py), DDH (ddh.py) and both multi-exponentiation
variants (multiexponential.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..accounts.prover import Prover as HostProver
from ..accounts.transcript import Transcript
from ..bulletproofs.device_verify import _sf_tree_prod, _sf_tree_sum
from ..device import resolve_device
from ..ops import exact as ex
from ..ops import field as fe
from ..ops import msm as qmsm
from ..ops import point as pt
from ..ops import scalar_field as sf
from ..ops.device_strobe import (DeviceStrobe, DeviceTranscript, DeviceTranscriptRng,
                                 snapshot_host_strobe)
from ..primitives.keys import RistrettoPublicKey
from ..primitives.pedersen import default_pedersen_gens, vector_pedersen_gens
from .ddh import DDHProof, DDHStatement
from .hadamard import HadamardProof, HadamardStatement
from .multiexponential import MultiexpoProof
from .product import (MultiHadamardProof, MultiHadamardStatement, ProductProof,
                      ProductStatement, ZeroProof, ZeroStatement)
from .shuffle import ShuffleProof, ShuffleStatement
from .singlevalueproduct import SVPProof, SVPStatement

L = ex.L
NL = sf.NLIMBS


def _tree_sum2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum mod l over one axis of [..., 10] limbs."""
    return _sf_tree_sum(x.movedim(axis, -2))


def _cols(p: pt.ExtPoint, a: int, b: int) -> pt.ExtPoint:
    """Points a .. b - 1 along axis 1."""
    return pt.ExtPoint(*(c[:, a:b] for c in p))


def _cat(points, dim: int) -> pt.ExtPoint:
    return pt.ExtPoint(*(torch.cat(cs, dim=dim) for cs in zip(*points)))


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return sf.to_bytes_array(x)


@functools.lru_cache(maxsize=None)
def _bases(m: int, device: torch.device):
    """The shared bases of one shape: [H, G_0..G_{m-1}] and [B, B_blinding].
    One pair for the provers of every batch size, so their MSM tables are
    built once."""
    xpc = vector_pedersen_gens(m + 1)
    pc = default_pedersen_gens()
    return (qmsm.SharedBasis(pt.from_exact_batch([xpc.H] + xpc.G_vec[:m], device)),
            qmsm.SharedBasis(pt.from_exact_batch([pc.B, pc.B_blinding], device)))


def _set(x: torch.Tensor, j: int, value: torch.Tensor) -> torch.Tensor:
    """x with column j (axis 1) replaced by value."""
    x = x.clone()
    x[:, j] = value
    return x


class DeviceShuffleProver:
    """Batched prover for shuffle proofs of one shape.

    Usage::

        dsp = DeviceShuffleProver(m=8, batch=16)
        proofs_and_statements = dsp.prove(shuffles, rngs)

    ``shuffles``: B Shuffle objects (inputs, outputs, tau, rho, pi);
    ``rngs``: one SeededRng per lane, consumed in the host prover's exact
    order; ``transcripts`` (optional): per-lane host Transcripts in the
    pre-proof state (NOT advanced).
    """

    #: the prover's rng finalizations, in call order: shuffle trng,
    #: Hadamard, product, MultiHadamard, zero, SVP, DDH, multiexpo-pk,
    #: multiexpo-commit
    N_ENTROPY = 9

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
        base_pk = RistrettoPublicKey.generate_base_pk()
        dev = self.device
        #: the commitment basis [H, G_0..G_{m-1}] (pedersen.py); the SVP's
        #: truncated generators [H, G_0..G_{m-2}] are its prefix, reached
        #: with a zero coefficient on G_{m-1}
        self._xpc, self._pc = _bases(m, dev)
        self._base_g = pt.from_exact_batch([base_pk.gr_point], dev)
        self._base_h = pt.from_exact_batch([base_pk.grsk_point], dev)
        self._basepoint = pt.from_exact_batch([ex.BASEPOINT], dev)
        self._c_minus_one = ex.ristretto_encode(
            vector_pedersen_gens(m + 1).commit([(-1) % L] * m, 0))
        # E_k's coefficient of output row i is a_full[i + k - m + 1], or
        # zero (the padding row m + 1) outside 0..m
        j = np.arange(m)[None, :] + np.arange(2 * m)[:, None] - m + 1
        self._e_index = torch.as_tensor(np.where((j >= 0) & (j <= m), j, m + 1), device=dev)

    # -- helpers -------------------------------------------------------------

    def _commit(self, vals: torch.Tensor, blind: torch.Tensor) -> pt.ExtPoint:
        """blind H + sum_i vals_i G_i per row: vals [B, R, k <= m], blind
        [B, R] -> points [B, R]."""
        B, R = vals.shape[0], vals.shape[1]
        nib = sf.to_nibbles(torch.cat([blind[:, :, None], vals], dim=2))
        out = qmsm.msm_shared_rows(nib.reshape(B * R, -1, pt.NWINDOWS), self._xpc)
        return pt.ExtPoint(*(c.reshape(B, R, fe.NLIMBS) for c in out))

    def _commit_pc(self, vals: torch.Tensor, blind: torch.Tensor) -> pt.ExtPoint:
        """vals B + blind B_blinding per row: [B, R] each -> points [B, R]."""
        B, R = vals.shape[0], vals.shape[1]
        nib = sf.to_nibbles(torch.stack([vals, blind], dim=2))
        out = qmsm.msm_shared_rows(nib.reshape(B * R, 2, pt.NWINDOWS), self._pc)
        return pt.ExtPoint(*(c.reshape(B, R, fe.NLIMBS) for c in out))

    @staticmethod
    def _rows_msm(coeffs: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
        """One MSM per row: coeffs [B, R, k] over points [B, R, k] -> [B, R]."""
        B, R, k = coeffs.shape[:3]
        out = qmsm.msm_rows(sf.to_nibbles(coeffs).reshape(B * R, k, pt.NWINDOWS),
                            pt.ExtPoint(*(c.reshape(B * R, k, fe.NLIMBS) for c in points)))
        return pt.ExtPoint(*(c.reshape(B, R, fe.NLIMBS) for c in out))

    @staticmethod
    def _enc(points: pt.ExtPoint) -> torch.Tensor:
        """Wire encodings, uint8 [..., 32] on the device."""
        return fe.to_bytes_tensor(pt.compress(points))

    @staticmethod
    def _rekey(drng: DeviceTranscriptRng, arr_bytes: torch.Tensor) -> None:
        """rekey_with_witness_batch(b'', ..., 32): arr_bytes uint8 [B, k, 32]."""
        for i in range(arr_bytes.shape[1]):
            drng.rekey_with_witness_bytes(b"", arr_bytes[:, i], 32)

    @staticmethod
    def _draw(drng: DeviceTranscriptRng) -> torch.Tensor:
        """One Scalar::random draw: 64 PRF bytes reduced mod l."""
        return sf.from_bytes_wide(drng.random_scalar_bytes())

    def _draws(self, drng: DeviceTranscriptRng, k: int) -> torch.Tensor:
        """k sequential draws: [B, k, 10]."""
        return torch.stack([self._draw(drng) for _ in range(k)], dim=1)

    # -- device program ------------------------------------------------------

    def _program(self, perm, wit_b, tau_b, rho_b, r_b, ent, acc_in, acc_out, states, frame):
        """perm: int64 [B, N] (1-based, row-major); wit_b, tau_b: uint8
        [B, N, 32] (the permutation's values and tau as scalars); rho_b
        [B, 32]; r_b [B, m, 32]; ent [B, 9, 32]; acc_in, acc_out [B, 4N, 32]
        account bytes (gr | grsk | c | d); states [B, 200]. Returns (points
        uint8 [B, P, 32], scalars uint8 [B, S, 32]) in the order of
        :meth:`_out_layout`. Raises ValueError, before any other work, if an
        account point does not decode."""
        m, N = self.m, self.N
        n = m                                   # square matrices: n == m
        B, dev = perm.shape[0], perm.device
        out_pts, out_scal = [], []

        dt = DeviceTranscript.from_strobe(DeviceStrobe.from_host_states(states, *frame))

        def challenge(label: bytes) -> torch.Tensor:
            return sf.from_bytes_wide(dt.get_challenge_bytes(label))

        ok_in, in_pts = pt.decompress_bytes_tensor(acc_in)      # [B, 4N]
        ok_out, o_pts = pt.decompress_bytes_tensor(acc_out)
        if not bool(ok_in.all() & ok_out.all()):  # the one fetch before the end
            raise ValueError("invalid account point in shuffle prover input")
        in_g, in_h = _cols(in_pts, 0, N), _cols(in_pts, N, 2 * N)
        o_g, o_h = _cols(o_pts, 0, N), _cols(o_pts, N, 2 * N)
        o_c, o_d = _cols(o_pts, 2 * N, 3 * N), _cols(o_pts, 3 * N, 4 * N)

        tau = sf.from_bytes(tau_b)              # [B, N, 10]
        rho = sf.from_bytes(rho_b)              # [B, 10]
        r_blind = sf.from_bytes(r_b)            # [B, m, 10]
        wit = sf.from_bytes(wit_b)              # the permutation matrix's values
        wit_rows = wit.reshape(B, m, n, NL)
        tau_rows = tau.reshape(B, m, n, NL)

        # ---- c_A and c_tau (shuffle.py): the shuffle trng rekeyed with
        # tau and entropy 0 gives r_dash; one MSM call for both
        trng = DeviceTranscriptRng(dt.strobe)
        self._rekey(trng, tau_b)
        trng.finalize(ent[:, 0])
        r_dash = self._draws(trng, m)           # [B, m]
        c_At = self._enc(self._commit(torch.cat([wit_rows, tau_rows], dim=1),
                                      torch.cat([r_blind, r_dash], dim=1)))
        cA_b, ctau_b = c_At[:, :m], c_At[:, m:]
        for i in range(m):
            dt.append_point_var(b"ACommitment", cA_b[:, i])
            dt.append_point_var(b"tauCommitment", ctau_b[:, i])
        x = challenge(b"xChallenge")
        exp_x = sf.powers(x, N + 1)[:, 1:]      # x^1..x^N [B, N]

        # ---- b, b' witnesses (create_b_b_dash)
        idx = (perm - 1)[..., None].expand(B, N, NL)
        b_flat = torch.gather(exp_x, 1, idx)
        b_dash_flat = sf.mul(b_flat, sf.batch_invert_rows(tau))
        s_vec = self._draws(trng, m)
        s_dash = self._draws(trng, m)
        b_rows = b_flat.reshape(B, m, n, NL)
        bd_rows = b_dash_flat.reshape(B, m, n, NL)
        c_BB = self._enc(self._commit(torch.cat([b_rows, bd_rows], dim=1),
                                      torch.cat([s_vec, s_dash], dim=1)))
        cB_b, cBd_b = c_BB[:, :m], c_BB[:, m:]
        for i in range(m):
            dt.append_point_var(b"BCommitment", cB_b[:, i])
            dt.append_point_var(b"BDashCommitment", cBd_b[:, i])
        out_pts += [cA_b, ctau_b, cB_b, cBd_b]

        # ---- Hadamard argument (hadamard.py): a_rows = b', b_rows = tau,
        # c_rows = b; witnesses r = s_dash, s = r_dash, t = s_vec
        dt.domain_sep(b"HadamardProductProof")
        hrng = DeviceTranscriptRng(dt.strobe)
        self._rekey(hrng, torch.cat([_bytes(s_dash), _bytes(r_dash), _bytes(s_vec),
                                     _bytes(b_dash_flat), tau_b, _bytes(b_flat)], dim=1))
        hrng.finalize(ent[:, 1])
        h_a0 = self._draws(hrng, n)             # [B, n]
        h_b0 = self._draws(hrng, n)
        h_c0 = sf.mul(h_a0, h_b0)
        h_rst = self._draws(hrng, 3)            # r_0, s_0, t_0
        had0_b = self._enc(self._commit(torch.stack([h_a0, h_b0, h_c0], dim=1), h_rst))

        omega = self._draws(hrng, m)            # [B, m]
        # l(X) = prod (X - w_i), coefficients low to high: [B, m + 1]
        lc = sf.one((B, 1), dev)
        zero1 = sf.zeros((B, 1), dev)
        for i in range(m):
            lc = sf.add(torch.cat([zero1, lc], dim=1),
                        torch.cat([sf.mul(lc, sf.neg(omega[:, i])[:, None, :]), zero1], dim=1))
        # Lagrange basis l_i(X) = l(X) / ((X - w_i) prod_{j != i} (w_i - w_j)):
        # synthetic division of l by (X - w_i) for every i at once
        diff = sf.sub(omega[:, :, None, :], omega[:, None, :, :])            # [B, m, m]
        eye = torch.eye(m, dtype=torch.bool, device=dev)[None, :, :, None]
        denom = _sf_tree_prod(torch.where(eye, sf.one((), dev), diff))     # [B, m]
        denom_inv = sf.batch_invert_rows(denom)
        q = [lc[:, m, None, :].expand(B, m, NL)]                             # degree m - 1
        for k_ in range(m - 1, 0, -1):
            q.append(sf.add(lc[:, k_, None, :], sf.mul(omega, q[-1])))
        li = sf.mul(torch.stack(q[::-1], dim=2), denom_inv[:, :, None, :])  # [B, m(i), m]

        def col_expr(rows_, v0):
            """Per column j: v0_j l(X) + sum_i rows_[i][j] l_i(X); rows_
            [B, m, n], v0 [B, n] -> [B, n, m + 1] coefficients."""
            t1 = sf.mul(lc[:, None], v0[:, :, None, :])
            t2 = _tree_sum2(sf.mul(rows_[:, :, :, None, :], li[:, :, None, :, :]), 1)
            return sf.add(t1, F.pad(t2, (0, 0, 0, 1)))

        a_expr = col_expr(bd_rows, h_a0)        # [B, n, m + 1]
        b_expr = col_expr(tau_rows, h_b0)
        c_expr = col_expr(b_rows, h_c0)

        # (a_expr b_expr - c_expr) / l(X): the degree-2m product, then long
        # division by the monic l
        deg = 2 * m
        prod_c = F.pad(sf.neg(c_expr), (0, 0, 0, m))
        for i_ in range(m + 1):
            prod_c = sf.add(prod_c, F.pad(sf.mul(a_expr[:, :, i_, None, :], b_expr),
                                          (0, 0, i_, m - i_)))
        rem, qcoef = prod_c, [None] * (m + 1)
        for k_ in range(deg, m - 1, -1):
            qk = rem[:, :, k_]
            qcoef[k_ - m] = qk
            rem = sf.sub(rem, F.pad(sf.mul(qk[:, :, None, :], lc[:, None]),
                                    (0, 0, k_ - m, deg - k_)))
        delta_vec = torch.stack(qcoef, dim=1)   # [B, m + 1, n]: coefficient i across columns
        rho_h = self._draws(hrng, m + 1)
        cdelta_b = self._enc(self._commit(delta_vec, rho_h))

        for i in range(m):
            dt.append_point_var(b"c_a", cBd_b[:, i])
            dt.append_point_var(b"c_b", ctau_b[:, i])
            dt.append_point_var(b"c_c", cB_b[:, i])
        dt.append_point_var(b"c_a_0", had0_b[:, 0])
        dt.append_point_var(b"c_b_0", had0_b[:, 1])
        dt.append_point_var(b"c_c_0", had0_b[:, 2])
        for i in range(m + 1):
            dt.append_point_var(b"c_delta", cdelta_b[:, i])
        hx = challenge(b"challenge")
        hx_pow = sf.powers(hx, m + 2)           # x^0..x^{m+1}

        def poly_eval(coefs):
            """[B, n, m + 1] coefficients at hx -> [B, n]."""
            return _tree_sum2(sf.mul(coefs, hx_pow[:, None, :m + 1]), 2)

        ev0 = _tree_sum2(sf.mul(lc, hx_pow[:, :m + 1]), 1)              # l(hx)
        li_ev = _tree_sum2(sf.mul(li, hx_pow[:, None, :m]), 2)           # [B, m]
        blinds = torch.stack([s_dash, r_dash, s_vec], dim=1)              # [B, 3, m]
        rst_bar = sf.add(sf.mul(h_rst, ev0[:, None]),
                         _tree_sum2(sf.mul(blinds, li_ev[:, None]), 2))  # r, s, t bars
        rho_bar = sf.mul(ev0, _tree_sum2(sf.mul(hx_pow[:, :m + 1], rho_h), 1))
        out_pts += [had0_b, cdelta_b]
        out_scal += [_bytes(omega), _bytes(poly_eval(a_expr)), _bytes(poly_eval(b_expr)),
                     _bytes(poly_eval(c_expr)),
                     _bytes(torch.cat([rst_bar, rho_bar[:, None]], dim=1))]

        # ---- y, z and the e matrix (shuffle.py)
        y = challenge(b"yChallenge")
        z = challenge(b"zChallenge")
        f = sf.add(sf.mul(wit, y[:, None, :]), b_flat)
        t_blind = sf.add(sf.mul(r_blind, y[:, None, :]), s_vec)     # [B, m]
        e = sf.sub(f, z[:, None, :].expand(B, N, NL))
        # column-major m x n: e_rows[i][j] = e[j m + i]
        e_rows = e.reshape(B, n, m, NL).movedim(2, 1)

        # ---- Product argument (product.py): c_prod_A over the witness
        # columns, the product rng's s3 for cb, then MultiHadamard's s_mid
        # for the running products: the three commitments in one MSM call
        wit_cols = e_rows.movedim(2, 1)         # cols[i][j] = e_rows[j][i]
        bvec = _sf_tree_prod(e_rows)            # row products [B, m]
        bvec_bytes = _bytes(bvec)
        prng = DeviceTranscriptRng(dt.strobe)
        self._rekey(prng, bvec_bytes)
        prng.finalize(ent[:, 2])
        s3 = self._draw(prng)
        svp_b_stmt = _sf_tree_prod(bvec)

        dt.domain_sep(b"MultiHadamardProductProof")
        b_list = [wit_cols[:, 0]]               # running products of the columns
        for i in range(1, m - 1):
            b_list.append(sf.mul(b_list[-1], wit_cols[:, i]))
        b_list.append(bvec)
        blist_t = torch.stack(b_list, dim=1)    # [B, m, n]
        mhrng = DeviceTranscriptRng(dt.strobe)
        self._rekey(mhrng, bvec_bytes)
        mhrng.finalize(ent[:, 3])
        s_mid = self._draws(mhrng, m - 2) if m > 2 else sf.zeros((B, 0), dev)
        s_prod = torch.cat([t_blind[:, 0:1], s_mid, s3[:, None]], dim=1)     # [B, m]
        prod_b = self._enc(self._commit(
            torch.cat([wit_cols, bvec[:, None], blist_t[:, 1:m - 1]], dim=1),
            torch.cat([t_blind, s3[:, None], s_mid], dim=1)))
        cprodA_b, cb_b, cmid_b = prod_b[:, :m], prod_b[:, m:m + 1], prod_b[:, m + 1:]
        mh_cB_b = torch.cat([cprodA_b[:, 0:1], cmid_b, cb_b], dim=1)          # [B, m, 32]
        for i in range(m):
            dt.append_point_var(b"BVectorCommitment", mh_cB_b[:, i])
        mhx = challenge(b"XChallenge")
        mhy = challenge(b"YChallenge")
        mhx_exp = sf.powers(mhx, m + 1)[:, 1:]   # x^1..x^m [B, m]
        out_pts += [cb_b, mh_cB_b]

        # d columns of the zero argument (product.py)
        xm = mhx_exp[:, :m - 1]
        d_list = sf.mul(blist_t[:, :m - 1], xm[:, :, None, :])
        t_list = sf.mul(s_prod[:, :m - 1], xm)
        d_sum = _tree_sum2(sf.mul(blist_t[:, 1:m], xm[:, :, None, :]), 1)
        t_sum = _tree_sum2(sf.mul(xm, s_prod[:, 1:m]), 1)
        neg_one = sf.neg(sf.one((B, 1, n), dev))
        z_a_cols = torch.cat([wit_cols[:, 1:m], neg_one], dim=1)          # [B, m, n]
        z_b_cols = torch.cat([d_list, d_sum[:, None]], dim=1)
        z_s_vec = torch.cat([t_list, t_sum[:, None]], dim=1)

        # ---- Zero argument (product.py): rekeyed with the a matrix's rows
        dt.domain_sep(b"ZeroArgumentProof")
        zrng = DeviceTranscriptRng(dt.strobe)
        self._rekey(zrng, _bytes(z_a_cols.movedim(2, 1).reshape(B, n * m, NL)))
        zrng.finalize(ent[:, 4])
        z_a0 = self._draws(zrng, n)
        z_bm = self._draws(zrng, n)
        z_r0 = self._draw(zrng)
        z_sm = self._draw(zrng)
        zhead_b = self._enc(self._commit(torch.stack([z_a0, z_bm], dim=1),
                                         torch.stack([z_r0, z_sm], dim=1)))
        full_a = torch.cat([z_a0[:, None], z_a_cols], dim=1)               # [B, m + 1, n]
        full_b = torch.cat([z_b_cols, z_bm[:, None]], dim=1)
        y_i = sf.powers(mhy, n + 1)[:, 1:]      # y^1..y^n
        # bilinear map: dv_k = sum over i, j = m - k + i of <a_i, b_j>_y
        pair = _tree_sum2(sf.mul(sf.mul(full_a[:, :, None], full_b[:, None]),
                                 y_i[:, None, None]), 3)                   # [B, i, j]
        dv = torch.stack([_sf_tree_sum(torch.diagonal(pair, m - k_, 1, 2).movedim(-1, 1))
                          for k_ in range(2 * m + 1)], dim=1)              # [B, 2m + 1]
        t_z = _set(self._draws(zrng, 2 * m + 1), m + 1, sf.zeros((B,), dev))
        cD_b = self._enc(self._commit_pc(dv, t_z))
        dt.append_point_var(b"A0Commitment", zhead_b[:, 0])
        dt.append_point_var(b"BmCommitment", zhead_b[:, 1])
        for i in range(2 * m + 1):
            dt.append_point_var(b"DCommitment", cD_b[:, i])
        zx = challenge(b"challenge")
        zx_exp = sf.powers(zx, 2 * m + 1)       # x^0..x^2m
        zx_m = zx_exp[:, :m + 1]
        zx_mr = zx_m.flip(1)                    # x^m..x^0
        r_ext = torch.cat([z_r0[:, None], t_blind[:, 1:m], sf.zeros((B, 1), dev)], dim=1)
        s_ext = torch.cat([z_s_vec, z_sm[:, None]], dim=1)
        out_pts += [zhead_b, cD_b]
        out_scal += [_bytes(_tree_sum2(sf.mul(full_a, zx_m[:, :, None, :]), 1)),
                     _bytes(_tree_sum2(sf.mul(full_b, zx_mr[:, :, None, :]), 1)),
                     _bytes(torch.stack([_tree_sum2(sf.mul(r_ext, zx_m), 1),
                                         _tree_sum2(sf.mul(s_ext, zx_mr), 1),
                                         _tree_sum2(sf.mul(t_z, zx_exp), 1)], dim=1))]

        # ---- SVP (singlevalueproduct.py): a_vec = bvec, r = s3
        dt.domain_sep(b"SingleValueProductProof")
        srng = DeviceTranscriptRng(dt.strobe)
        run = [bvec[:, 0]]                      # running products of bvec
        for i in range(1, m):
            run.append(sf.mul(run[-1], bvec[:, i]))
        run = torch.stack(run, dim=1)           # [B, m]
        self._rekey(srng, _bytes(run))
        srng.finalize(ent[:, 5])
        sv_d = self._draws(srng, n)
        sv_rd = self._draw(srng)
        sv_delta = self._draws(srng, n)
        sv_delta = _set(_set(sv_delta, 0, sv_d[:, 0]), n - 1, sf.zeros((B,), dev))
        sv_s1 = self._draw(srng)
        sv_sx = self._draw(srng)
        d_lower = sf.neg(sf.mul(sv_delta[:, :n - 1], sv_d[:, 1:]))
        d_upper = sf.sub(sf.sub(sv_delta[:, 1:], sf.mul(bvec[:, 1:], sv_delta[:, :n - 1])),
                         sf.mul(run[:, :n - 1], sv_d[:, 1:]))
        # d over [H, G_0..G_{m-1}]; the two deltas over its prefix of m - 1
        svp_b = self._enc(self._commit(
            torch.stack([sv_d, F.pad(d_lower, (0, 0, 0, 1)), F.pad(d_upper, (0, 0, 0, 1))], dim=1),
            torch.stack([sv_rd, sv_s1, sv_sx], dim=1)))
        svd_b, svdl_b = svp_b[:, :1], svp_b[:, 1:]
        dt.append_point_var(b"DeltaSmall", svdl_b[:, 0])
        dt.append_point_var(b"DeltaCapital", svdl_b[:, 1])
        dt.append_point_var(b"d", svd_b[:, 0])
        sx = challenge(b"challenge")
        out_pts += [svd_b, svdl_b]
        out_scal += [_bytes(sf.add(sf.mul(bvec, sx[:, None, :]), sv_d)),
                     _bytes(sf.add(sf.mul(run, sx[:, None, :]), sv_delta)),
                     _bytes(torch.stack([sf.add(sf.mul(s3, sx), sv_rd),
                                         sf.add(sf.mul(sv_sx, sx), sv_s1), svp_b_stmt], dim=1))]

        # ---- DDH (ddh.py): 6 MSM rows over the input public keys
        dt.domain_sep(b"DDHTupleProof")
        drng = DeviceTranscriptRng(dt.strobe)
        self._rekey(drng, _bytes(exp_x))
        drng.finalize(ent[:, 6])
        ddh_r = self._draw(drng)
        xr = sf.mul(exp_x, rho[:, None, :])
        xs = sf.mul(exp_x, ddh_r[:, None, :])
        ddh_out = self._rows_msm(
            torch.stack([exp_x, exp_x, xr, xr, xs, xs], dim=1),
            pt.ExtPoint(*(torch.stack([g, h, g, h, g, h], dim=1) for g, h in zip(in_g, in_h))))
        ddh_b = self._enc(ddh_out)              # G, H, G', H', g_r, h_r
        dt.append_point_var(b"g", ddh_b[:, 0])
        dt.append_point_var(b"g_dash", ddh_b[:, 2])
        dt.append_point_var(b"h", ddh_b[:, 1])
        dt.append_point_var(b"h_dash", ddh_b[:, 3])
        dt.append_point_var(b"gr", ddh_b[:, 4])
        dt.append_point_var(b"hr", ddh_b[:, 5])
        ddh_chal = challenge(b"Challenge")
        out_pts += [ddh_b[:, 2:4]]
        out_scal += [_bytes(torch.stack([ddh_chal, sf.sub(ddh_r, sf.mul(ddh_chal, rho))], dim=1))]

        # ---- multi-exponentiations (multiexponential.py): the pk variant
        # re-encrypts under the base pk; the commitment variant under
        # pk_GH = (G, H) with randomness -rho (shuffle.rs:502-513)
        G_agg = pt.ExtPoint(*(c[:, 0] for c in ddh_out))
        H_agg = pt.ExtPoint(*(c[:, 1] for c in ddh_out))
        mepk = self._multiexpo(dt, b"MultiExponentialPubKeyProof", ent[:, 7],
                               bd_rows, s_dash, o_g, o_h, None)
        mec = self._multiexpo(dt, b"MultiExponentialElgamalCommmitmentProof", ent[:, 8],
                              b_rows, s_vec, o_c, o_d, (sf.neg(rho), G_agg, H_agg))
        out_pts += mepk[0] + mec[0]
        out_scal += mepk[1] + mec[1]
        # the ZeroStatement carries c_prod_A[1:m]
        out_pts += [cprodA_b[:, 1:]]
        return torch.cat(out_pts, dim=1), torch.cat(out_scal, dim=1)

    def _multiexpo(self, dt, label, entropy, a_rows, s_blind, pts0, pts1, commit):
        """One multi-exponentiation prover: ([point byte slices], [scalar
        byte slices]). a_rows [B, m, n] witness; s_blind [B, m]; pts0, pts1
        [B, N] the shuffled outputs' components (g, h or c, d). ``commit``
        None re-encrypts with b_k base_pk on both components; (neg_rho,
        G_agg, H_agg) adds Enc_pk_GH(b_k; tau_k) with tau_m pinned to -rho
        (shuffle.py, multiexponential.rs:163-242)."""
        m, N = self.m, self.N
        n = m
        B, dev = a_rows.shape[0], a_rows.device
        dt.domain_sep(label)
        rng = DeviceTranscriptRng(dt.strobe)
        self._rekey(rng, _bytes(a_rows.reshape(B, N, NL)))
        rng.finalize(entropy)
        a_0 = self._draws(rng, n)
        r_0 = self._draw(rng)
        zero = sf.zeros((B,), dev)
        b_vec = _set(self._draws(rng, 2 * m), m, zero)
        s_vec = _set(self._draws(rng, 2 * m), m, zero)
        cA0_b = self._enc(self._commit(a_0[:, None], r_0[:, None]))
        cbk_b = self._enc(self._commit_pc(b_vec, s_vec))

        # E_k rows: coefficients over [row-major outputs | base points],
        # E_k = sum_i <a_{i+k-m+1}, row_i> + reenc_k
        a_full = torch.cat([a_0[:, None], a_rows, sf.zeros((B, 1, n), dev)], dim=1)
        coeff = a_full[:, self._e_index].reshape(B, 2 * m, N, NL)
        zero2 = sf.zeros((B, 2 * m, 1), dev)

        def rows_of(p):                         # [B, N] -> [B, 2m, N]
            return pt.ExtPoint(*(c[:, None].expand(B, 2 * m, N, fe.NLIMBS) for c in p))

        def const(p):                           # [1] -> [B, 2m, 1]
            return pt.ExtPoint(*(c.expand(B, 2 * m, 1, fe.NLIMBS) for c in p))

        def per_lane(p):                        # [B] -> [B, 2m, 1]
            return pt.ExtPoint(*(c[:, None, None].expand(B, 2 * m, 1, fe.NLIMBS) for c in p))

        if commit is None:
            c0 = torch.cat([coeff, b_vec[:, :, None], zero2], dim=2)
            c1 = c0
            p0 = _cat([rows_of(pts0), const(self._base_g), const(self._base_g)], 2)
            p1 = _cat([rows_of(pts1), const(self._base_h), const(self._base_h)], 2)
        else:
            neg_rho, gh0, gh1 = commit
            tau_vec = _set(self._draws(rng, 2 * m), m, neg_rho)
            c0 = torch.cat([coeff, tau_vec[:, :, None], zero2], dim=2)
            c1 = torch.cat([coeff, b_vec[:, :, None], tau_vec[:, :, None]], dim=2)
            p0 = _cat([rows_of(pts0), per_lane(gh0), per_lane(gh0)], 2)
            p1 = _cat([rows_of(pts1), const(self._basepoint), per_lane(gh1)], 2)
        ek_b = self._enc(self._rows_msm(torch.cat([c0, c1], dim=1), _cat([p0, p1], 1)))
        E0_b, E1_b = ek_b[:, :2 * m], ek_b[:, 2 * m:]

        dt.append_point_var(b"A0Commitment", cA0_b[:, 0])
        for k_ in range(2 * m):
            dt.append_point_var(b"BKCommitment", cbk_b[:, k_])
            dt.append_point_var(b"EK0Commitment", E0_b[:, k_])
            dt.append_point_var(b"EK1Commitment", E1_b[:, k_])
        mx = sf.from_bytes_wide(dt.get_challenge_bytes(b"xchallenege"))
        x_exp = sf.powers(mx, 2 * m)            # x^0..x^{2m-1}
        # the challenge response (multiexponential.py): the reference
        # indexes as_columns()[i] over rows (square matrices)
        ax = _tree_sum2(sf.mul(a_rows.movedim(2, 1), x_exp[:, None, 1:m + 1]), 2)
        rbst = [sf.add(r_0, _tree_sum2(sf.mul(s_blind, x_exp[:, 1:m + 1]), 1)),
                _tree_sum2(sf.mul(b_vec, x_exp), 1), _tree_sum2(sf.mul(s_vec, x_exp), 1),
                _tree_sum2(sf.mul(tau_vec, x_exp), 1) if commit is not None else zero]
        return ([cA0_b, cbk_b, E0_b, E1_b],
                [_bytes(sf.add(ax, a_0)), _bytes(torch.stack(rbst, dim=1))])

    # -- host API ------------------------------------------------------------

    def _out_layout(self):
        """Named slices of the packed (points, scalars) outputs, in the
        order of :meth:`_program`."""
        m, n = self.m, self.m
        P, S = {}, {}
        po = so = 0

        def tp(name, k):
            nonlocal po
            P[name] = (po, po + k)
            po += k

        def ts(name, k):
            nonlocal so
            S[name] = (so, so + k)
            so += k

        tp("c_A", m); tp("c_tau", m); tp("c_B", m); tp("c_B_dash", m)  # noqa: E702
        tp("had0", 3); tp("had_delta", m + 1)  # noqa: E702
        ts("omega", m); ts("had_a_bar", n); ts("had_b_bar", n)  # noqa: E702
        ts("had_c_bar", n); ts("had_blind", 4)  # noqa: E702
        tp("cb", 1); tp("mh_cB", m)  # noqa: E702
        tp("zero_head", 2); tp("zero_cD", 2 * m + 1)  # noqa: E702
        ts("zero_a", n); ts("zero_b", n); ts("zero_blind", 3)  # noqa: E702
        tp("svp_d", 1); tp("svp_deltas", 2)  # noqa: E702
        ts("svp_a", n); ts("svp_b", n); ts("svp_blind", 3)  # noqa: E702
        tp("ddh_dash", 2)
        ts("ddh", 2)
        tp("mepk_A0", 1); tp("mepk_cBk", 2 * m)  # noqa: E702
        tp("mepk_Ek0", 2 * m); tp("mepk_Ek1", 2 * m)  # noqa: E702
        ts("mepk_a", m); ts("mepk_rbst", 4)  # noqa: E702
        tp("mec_A0", 1); tp("mec_cBk", 2 * m)  # noqa: E702
        tp("mec_Ek0", 2 * m); tp("mec_Ek1", 2 * m)  # noqa: E702
        ts("mec_a", m); ts("mec_rbst", 4)  # noqa: E702
        tp("_zs_tail", m - 1)
        return P, S, po, so

    def _default_transcripts(self):
        out = []
        for _ in range(self.batch):
            t = Transcript(self.transcript_label)
            HostProver(self.proof_label, t)     # appends the proof dom-sep
            out.append(t)
        return out

    def _states(self, transcripts):
        """(uint8 [B, 200] STROBE states, their shared frame)."""
        snaps = [snapshot_host_strobe(t.strobe) for t in transcripts]
        frame = snaps[0][1:]
        if len(snaps) != self.batch or any(s[1:] != frame for s in snaps):
            raise ValueError("lane transcripts diverged in framing")
        return np.stack([np.frombuffer(s[0], np.uint8) for s in snaps]), frame

    def _pack(self, shuffles: Sequence, rngs: Sequence, transcripts=None):
        """The program's inputs (numpy) and the transcript frame; consumes
        each lane's rng in the host prover's exact draw order
        (create_shuffle_proof, then each prove_rekey's entropy): r x m,
        then 9 entropies of 32 bytes."""
        m, N, B = self.m, self.N, self.batch
        if len(shuffles) != B or len(rngs) != B:
            raise ValueError("lane count mismatch")
        perm = np.zeros((B, N), np.int64)
        wit_b = np.zeros((B, N, 32), np.uint8)
        tau_b = np.zeros((B, N, 32), np.uint8)
        rho_b = np.zeros((B, 32), np.uint8)
        r_b = np.zeros((B, m, 32), np.uint8)
        ent = np.zeros((B, self.N_ENTROPY, 32), np.uint8)
        acc_in = np.zeros((B, 4 * N, 32), np.uint8)
        acc_out = np.zeros((B, 4 * N, 32), np.uint8)

        def sbytes(xs):
            return np.frombuffer(b"".join(ex.sc_to_bytes(x % L) for x in xs),
                                 np.uint8).reshape(-1, 32)

        def abytes(accounts):
            parts = [[a.pk.gr for a in accounts], [a.pk.grsk for a in accounts],
                     [a.comm.c for a in accounts], [a.comm.d for a in accounts]]
            return np.frombuffer(b"".join(b for part in parts for b in part),
                                 np.uint8).reshape(-1, 32)

        for i, sh in enumerate(shuffles):
            if len(sh.inputs) != N or len(sh.outputs) != N:
                raise ValueError("anonymity set size mismatch")
            perm[i] = sh.pi.get_row_major()
            wit_b[i] = sbytes(perm[i].tolist())
            tau_b[i] = sbytes(sh.shuffled_tau)
            rho_b[i] = sbytes([sh.rho])[0]
            r_b[i] = sbytes([rngs[i].random_scalar() for _ in range(m)])
            ent[i] = np.frombuffer(b"".join(rngs[i].fill_bytes(32)
                                            for _ in range(self.N_ENTROPY)),
                                   np.uint8).reshape(-1, 32)
            acc_in[i] = abytes(sh.inputs)
            acc_out[i] = abytes(sh.outputs)
        states, frame = self._states(transcripts or self._default_transcripts())
        return (perm, wit_b, tau_b, rho_b, r_b, ent, acc_in, acc_out, states), frame

    def _run(self, arrays, frame):
        pts_b, scal_b = self._program(*(torch.as_tensor(a, device=self.device) for a in arrays),
                                      frame)
        return pts_b.cpu().numpy(), scal_b.cpu().numpy()

    def prove(self, shuffles: Sequence, rngs: Sequence,
              transcripts: Optional[Sequence] = None):
        """[(ShuffleProof, ShuffleStatement)] x B, byte-identical to the
        host prover under the same per-lane rng streams. Raises ValueError
        if an account point does not decode."""
        return self._decode(*self._run(*self._pack(shuffles, rngs, transcripts)))

    def prove_sharded(self, shuffles: Sequence, rngs: Sequence, mesh,
                      transcripts: Optional[Sequence] = None):
        """prove() with the lane axis split over the ranks of ``mesh`` (a
        ``parallel.Mesh``): every rank calls it with the whole batch, packs
        and proves only its own lanes on a cached prover of B / size lanes
        on its device, and gathers every lane's bytes, so every rank returns
        all B (ShuffleProof, ShuffleStatement) pairs, equal to prove()'s.
        Lane i's rng is drawn from only on the rank that proves lane i. An
        account point that does not decode, or another rejected input,
        raises its ValueError on every rank."""
        B = self.batch
        if B % mesh.size:
            raise ValueError(f"batch {B} not divisible by {mesh.size} devices")
        if len(shuffles) != B or len(rngs) != B:
            raise ValueError("lane count mismatch")
        lanes = mesh.local_slice(B)
        local = get_device_shuffle_prover(self.m, B // mesh.size, self.proof_label,
                                          self.transcript_label, device=mesh.device)
        error = ""
        try:    # a bad input is shared, not raised: the other ranks wait for this one
            pts_b, scal_b = local._run(*local._pack(
                shuffles[lanes], rngs[lanes], None if transcripts is None else transcripts[lanes]))
        except ValueError as e:
            error = str(e)
        error = mesh.first_error(error)
        if error:
            raise ValueError(error)
        return self._decode(mesh.gather_rows(pts_b), mesh.gather_rows(scal_b))

    def warmup(self) -> None:
        """Build the kernels (on CUDA) and the basis tables, and run the
        program once on zero inputs (zero bytes decode as the identity and
        the zero scalar), result discarded."""
        m, N, B = self.m, self.N, self.batch
        states, frame = self._states(self._default_transcripts())
        z = np.zeros
        self._run((np.ones((B, N), np.int64), z((B, N, 32), np.uint8), z((B, N, 32), np.uint8),
                   z((B, 32), np.uint8), z((B, m, 32), np.uint8),
                   z((B, self.N_ENTROPY, 32), np.uint8), z((B, 4 * N, 32), np.uint8),
                   z((B, 4 * N, 32), np.uint8), states), frame)

    def _decode(self, pts_np: np.ndarray, scal_np: np.ndarray):
        """The fetched bytes -> [(ShuffleProof, ShuffleStatement)]."""
        m = self.m
        P, S, npts, nsc = self._out_layout()
        if pts_np.shape[1] != npts or scal_np.shape[1] != nsc:
            raise ValueError("prover output layout mismatch")
        out = []
        for lane_p, lane_s in zip(pts_np, scal_np):
            def pb(name):
                a, b_ = P[name]
                return [bytes(r) for r in lane_p[a:b_]]

            def sc(name):
                a, b_ = S[name]
                return [int.from_bytes(bytes(r), "little") for r in lane_s[a:b_]]

            hp = HadamardProof(*pb("had0"), pb("had_delta"), sc("had_a_bar"), sc("had_b_bar"),
                               sc("had_c_bar"), *sc("had_blind"))
            zp = ZeroProof(*pb("zero_head"), pb("zero_cD"), sc("zero_a"), sc("zero_b"),
                           *sc("zero_blind"))
            cb_enc = pb("cb")[0]
            # the ZeroStatement's cA: c_prod_A[1:m] and com(-1, 0)
            zs = ZeroStatement(pb("_zs_tail") + [self._c_minus_one])
            svb = sc("svp_blind")
            svp = SVPProof(pb("svp_d")[0], *pb("svp_deltas"), sc("svp_a"), sc("svp_b"),
                           svb[0], svb[1])
            ddh_sc = sc("ddh")
            mepk_r = sc("mepk_rbst")
            mepk = MultiexpoProof(pb("mepk_A0")[0], pb("mepk_cBk"), pb("mepk_Ek0"),
                                  pb("mepk_Ek1"), sc("mepk_a"), *mepk_r[:3], 0)
            mec = MultiexpoProof(pb("mec_A0")[0], pb("mec_cBk"), pb("mec_Ek0"), pb("mec_Ek1"),
                                 sc("mec_a"), *sc("mec_rbst"))
            proof = ShuffleProof(pb("c_A"), pb("c_tau"), pb("c_B"), pb("c_B_dash"), hp,
                                 ProductProof(MultiHadamardProof(pb("mh_cB"), zp), svp),
                                 mepk, mec, DDHProof(ddh_sc[0], ddh_sc[1]))
            stmt = ShuffleStatement(
                HadamardStatement(sc("omega")),
                ProductStatement(MultiHadamardStatement(cb_enc, zs), SVPStatement(cb_enc, svb[2])),
                DDHStatement(*pb("ddh_dash")))
            out.append((proof, stmt))
        return out


# ---------------------------------------------------------------------------
# dispatch: prover instances by shape
# ---------------------------------------------------------------------------

_PROVER_CACHE: dict = {}


def get_device_shuffle_prover(m: int, batch: int, proof_label: bytes = b"Shuffle",
                              transcript_label: bytes = b"ShuffleProof",
                              device="cuda") -> DeviceShuffleProver:
    """Process-wide cache of prover instances by shape and device: their
    basis tables stay resident between batches."""
    key = (m, batch, bytes(proof_label), bytes(transcript_label), str(resolve_device(device)))
    if key not in _PROVER_CACHE:
        _PROVER_CACHE[key] = DeviceShuffleProver(m, batch, proof_label, transcript_label, device)
    return _PROVER_CACHE[key]
