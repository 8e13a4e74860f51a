"""Inner-product argument (log-folding recursion).

Functional equivalent of dalek-bulletproofs' `InnerProductProof`: proves
<a, b> = c against generators G, H (with per-element factors folded in on
the first round) and commitment point Q, in log2(n) halving rounds.

Transcript framing mirrors the crate: domain sep b"ipp v1" + n, per-round
points b"L"/b"R", challenge b"u". Serialization: L_1 R_1 ... L_k R_k a b
(32 bytes each).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ops import exact as ex
from ..accounts.transcript import Transcript

L = ex.L


def _inner(a: Sequence[int], b: Sequence[int]) -> int:
    return sum(x * y for x, y in zip(a, b)) % L


@dataclass
class InnerProductProof:
    L_vec: List[bytes]
    R_vec: List[bytes]
    a: int
    b: int

    @staticmethod
    def create(transcript: Transcript, Q: ex.Point,
               G_factors: Sequence[int], H_factors: Sequence[int],
               G: List[ex.Point], H: List[ex.Point],
               a: List[int], b: List[int]) -> "InnerProductProof":
        n = len(G)
        assert n == len(H) == len(a) == len(b)
        assert n & (n - 1) == 0  # power of two
        transcript.append_message(b"dom-sep", b"ipp v1")
        transcript.append_u64(b"n", n)

        a = [x % L for x in a]
        b = [x % L for x in b]
        G = list(G)
        H = list(H)
        L_vec: List[bytes] = []
        R_vec: List[bytes] = []
        first = True
        while n > 1:
            n //= 2
            a_lo, a_hi = a[:n], a[n:]
            b_lo, b_hi = b[:n], b[n:]
            G_lo, G_hi = G[:n], G[n:]
            H_lo, H_hi = H[:n], H[n:]
            c_L = _inner(a_lo, b_hi)
            c_R = _inner(a_hi, b_lo)
            if first:
                gf_lo, gf_hi = G_factors[:n], G_factors[n:2 * n]
                hf_lo, hf_hi = H_factors[:n], H_factors[n:2 * n]
                L_pt = ex.pt_msm(
                    [ai * gf % L for ai, gf in zip(a_lo, gf_hi)] +
                    [bi * hf % L for bi, hf in zip(b_hi, hf_lo)] + [c_L],
                    G_hi + H_lo + [Q])
                R_pt = ex.pt_msm(
                    [ai * gf % L for ai, gf in zip(a_hi, gf_lo)] +
                    [bi * hf % L for bi, hf in zip(b_lo, hf_hi)] + [c_R],
                    G_lo + H_hi + [Q])
            else:
                L_pt = ex.pt_msm(a_lo + b_hi + [c_L], G_hi + H_lo + [Q])
                R_pt = ex.pt_msm(a_hi + b_lo + [c_R], G_lo + H_hi + [Q])
            L_b = ex.ristretto_encode(L_pt)
            R_b = ex.ristretto_encode(R_pt)
            L_vec.append(L_b)
            R_vec.append(R_b)
            transcript.append_message(b"L", L_b)
            transcript.append_message(b"R", R_b)
            u = transcript.get_challenge(b"u")
            u_inv = ex.sc_invert(u)
            a = [(al * u + u_inv * ah) % L for al, ah in zip(a_lo, a_hi)]
            b = [(bl * u_inv + u * bh) % L for bl, bh in zip(b_lo, b_hi)]
            if first:
                G = ex.pt_fold_batch([u_inv * gf_lo[i] % L for i in range(n)],
                                     [u * gf_hi[i] % L for i in range(n)],
                                     G_lo, G_hi)
                H = ex.pt_fold_batch([u * hf_lo[i] % L for i in range(n)],
                                     [u_inv * hf_hi[i] % L for i in range(n)],
                                     H_lo, H_hi)
                first = False
            else:
                G = ex.pt_fold_batch([u_inv] * n, [u] * n, G_lo, G_hi)
                H = ex.pt_fold_batch([u] * n, [u_inv] * n, H_lo, H_hi)
        return InnerProductProof(L_vec, R_vec, a[0], b[0])

    def verification_scalars(self, n: int, transcript: Transcript
                             ) -> Tuple[List[int], List[int], List[int]]:
        """Returns (u_sq, u_inv_sq, s) after replaying the transcript."""
        lg_n = len(self.L_vec)
        assert n == (1 << lg_n)
        transcript.append_message(b"dom-sep", b"ipp v1")
        transcript.append_u64(b"n", n)
        challenges = []
        for L_b, R_b in zip(self.L_vec, self.R_vec):
            transcript.append_message(b"L", L_b)
            transcript.append_message(b"R", R_b)
            challenges.append(transcript.get_challenge(b"u"))
        inv = ex.sc_batch_invert(challenges)
        u_sq = [u * u % L for u in challenges]
        u_inv_sq = [v * v % L for v in inv]
        # s_i = prod over j of u_j^{b(i,j)} where bit j of i (from MSB) selects
        s = [1] * n
        all_inv = 1
        for v in inv:
            all_inv = all_inv * v % L
        s[0] = all_inv
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            # challenges are stored in "round" order: round 0 splits at n/2
            u_lg_i_sq = u_sq[lg_n - 1 - lg_i]
            s[i] = s[i - k] * u_lg_i_sq % L
        return u_sq, u_inv_sq, s

    def verify(self, n: int, transcript: Transcript,
               G_factors: Sequence[int], H_factors: Sequence[int],
               P: ex.Point, Q: ex.Point,
               G: List[ex.Point], H: List[ex.Point]) -> None:
        """Check P == a <s∘Gf, G> + b <s_inv∘Hf, H> + ab Q - sum(L u² + R u⁻²)."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)
        s_inv = s[::-1]  # 1/s_i = s_{n-1-i}
        g_scalars = [self.a * si % L * gf % L for si, gf in zip(s, G_factors)]
        h_scalars = [self.b * si % L * hf % L for si, hf in zip(s_inv, H_factors)]
        neg_u_sq = [(-u) % L for u in u_sq]
        neg_u_inv_sq = [(-u) % L for u in u_inv_sq]
        L_pts = [ex.ristretto_decode(x) for x in self.L_vec]
        R_pts = [ex.ristretto_decode(x) for x in self.R_vec]
        if any(p is None for p in L_pts + R_pts):
            raise ValueError("IPP verification failed: bad point")
        expect = ex.pt_msm(
            [self.a * self.b % L] + g_scalars + h_scalars + neg_u_sq + neg_u_inv_sq,
            [Q] + G + H + L_pts + R_pts)
        if not ex.pt_eq(expect, P):
            raise ValueError("IPP verification failed")

    def to_bytes(self) -> bytes:
        out = b"".join(lb + rb for lb, rb in zip(self.L_vec, self.R_vec))
        return out + ex.sc_to_bytes(self.a) + ex.sc_to_bytes(self.b)

    @classmethod
    def from_bytes(cls, data: bytes) -> "InnerProductProof":
        assert len(data) % 32 == 0 and len(data) >= 64
        k = (len(data) - 64) // 64
        L_vec, R_vec = [], []
        for i in range(k):
            L_vec.append(data[64 * i:64 * i + 32])
            R_vec.append(data[64 * i + 32:64 * i + 64])
        a = ex.sc_from_bytes_mod_order(data[-64:-32])
        b = ex.sc_from_bytes_mod_order(data[-32:])
        return cls(L_vec, R_vec, a, b)
