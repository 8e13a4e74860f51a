"""Rank-1 Constraint System proofs (Bulletproofs r1cs protocol).

Functional equivalent of dalek-bulletproofs' `r1cs` module (the `yoloproofs`
feature the reference depends on, Cargo.toml:52-55; used by
reference src/accounts/rangeproof.rs:17-83): committed high-level
variables, multiplier triples a_L * a_R = a_O, arbitrary linear constraints,
proven with the 3-degree vector polynomial protocol (t(X) of degree 6,
T_1,T_3..T_6 commitments — T_2 carries the statement) and the log-size
inner-product argument.

Only deterministic (non-randomized) constraints are implemented — the
reference's range gadget (rangeproof.rs:95-127) uses nothing else.

The PyTorch port's host copy of the JAX package's module: the same
transcript schedule and random draws, so the same proofs byte for byte
(``tests/test_torch_r1cs.py``). It has no device twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops import exact as ex
from ..accounts.transcript import Transcript, SeededRng
from ..primitives.pedersen import default_pedersen_gens
from .generators import bulletproof_gens
from .inner_product import InnerProductProof

L = ex.L


# ---------------------------------------------------------------------------
# linear combinations over (V_j, aL_i, aR_i, aO_i, 1)
# ---------------------------------------------------------------------------

class LinearCombination:
    """Sparse linear combination of variables; terms: {(kind, idx): coeff}."""

    __slots__ = ("terms", "constant")

    def __init__(self, terms: Optional[Dict] = None, constant: int = 0):
        self.terms = dict(terms or {})
        self.constant = constant % L

    @staticmethod
    def from_var(kind: str, idx: int) -> "LinearCombination":
        return LinearCombination({(kind, idx): 1})

    @staticmethod
    def constant_lc(c: int) -> "LinearCombination":
        return LinearCombination({}, c)

    def __add__(self, other):
        other = _as_lc(other)
        t = dict(self.terms)
        for k, v in other.terms.items():
            t[k] = (t.get(k, 0) + v) % L
        return LinearCombination(t, self.constant + other.constant)

    def __sub__(self, other):
        return self + (_as_lc(other) * (-1))

    def __mul__(self, scalar: int):
        return LinearCombination(
            {k: v * scalar % L for k, v in self.terms.items()},
            self.constant * scalar)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1)


def _as_lc(x) -> LinearCombination:
    if isinstance(x, LinearCombination):
        return x
    return LinearCombination.constant_lc(int(x))


Variable = LinearCombination  # variables are single-term LCs


@dataclass
class R1CSProof:
    A_I1: bytes
    A_O1: bytes
    S1: bytes
    T_1: bytes
    T_3: bytes
    T_4: bytes
    T_5: bytes
    T_6: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: InnerProductProof

    def to_bytes(self) -> bytes:
        head = (self.A_I1 + self.A_O1 + self.S1 + self.T_1 + self.T_3 +
                self.T_4 + self.T_5 + self.T_6 +
                ex.sc_to_bytes(self.t_x) + ex.sc_to_bytes(self.t_x_blinding) +
                ex.sc_to_bytes(self.e_blinding))
        return head + self.ipp_proof.to_bytes()

    def serialized_size(self) -> int:
        return len(self.to_bytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> "R1CSProof":
        pts = [data[32 * i:32 * (i + 1)] for i in range(8)]
        off = 8 * 32
        t_x = ex.sc_from_bytes_mod_order(data[off:off + 32])
        t_x_b = ex.sc_from_bytes_mod_order(data[off + 32:off + 64])
        e_b = ex.sc_from_bytes_mod_order(data[off + 64:off + 96])
        ipp = InnerProductProof.from_bytes(data[off + 96:])
        return cls(*pts, t_x, t_x_b, e_b, ipp)


def _enc(p):
    return ex.ristretto_encode(p)


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _ConstraintSystemBase:
    """Shared constraint bookkeeping for prover and verifier."""

    def __init__(self):
        self.constraints: List[LinearCombination] = []
        self.num_multipliers = 0
        self.num_committed = 0

    def constrain(self, lc: LinearCombination) -> None:
        self.constraints.append(_as_lc(lc))

    def multipliers_len(self) -> int:
        return self.num_multipliers

    def _flattened_constraints(self, z: int, n_padded: int):
        """(wL, wR, wO, wV, wc) with row i weighted by z^(i+1)."""
        wL = [0] * n_padded
        wR = [0] * n_padded
        wO = [0] * n_padded
        wV = [0] * self.num_committed
        wc = 0
        zi = z
        for lc in self.constraints:
            for (kind, idx), coeff in lc.terms.items():
                if kind == "aL":
                    wL[idx] = (wL[idx] + zi * coeff) % L
                elif kind == "aR":
                    wR[idx] = (wR[idx] + zi * coeff) % L
                elif kind == "aO":
                    wO[idx] = (wO[idx] + zi * coeff) % L
                elif kind == "V":
                    # constraint has +coeff*V on the LHS; move to RHS weights
                    wV[idx] = (wV[idx] - zi * coeff) % L
                else:
                    raise ValueError(f"unknown var kind {kind}")
            wc = (wc - zi * lc.constant) % L
            zi = zi * z % L
        return wL, wR, wO, wV, wc


class R1CSProver(_ConstraintSystemBase):
    """bulletproofs::r1cs::Prover equivalent."""

    def __init__(self, transcript: Transcript, rng: Optional[SeededRng] = None):
        super().__init__()
        self.transcript = transcript
        self.transcript.append_message(b"dom-sep", b"r1cs v1")
        self.rng = rng or SeededRng()
        self.v: List[int] = []
        self.v_blinding: List[int] = []
        self.a_L: List[int] = []
        self.a_R: List[int] = []
        self.a_O: List[int] = []

    # -- witness allocation -------------------------------------------------

    def commit(self, value: int, blinding: int) -> Tuple[bytes, LinearCombination]:
        pc = default_pedersen_gens()
        V = _enc(pc.commit(value, blinding))
        j = len(self.v)
        self.v.append(value % L)
        self.v_blinding.append(blinding % L)
        self.num_committed += 1
        self.transcript.append_message(b"V", V)
        return V, LinearCombination.from_var("V", j)

    def allocate_multiplier(self, assignment: Tuple[int, int]
                            ) -> Tuple[LinearCombination, LinearCombination,
                                       LinearCombination]:
        l, r = assignment
        i = self.num_multipliers
        self.num_multipliers += 1
        self.a_L.append(l % L)
        self.a_R.append(r % L)
        self.a_O.append(l * r % L)
        return (LinearCombination.from_var("aL", i),
                LinearCombination.from_var("aR", i),
                LinearCombination.from_var("aO", i))

    def eval_lc(self, lc: LinearCombination) -> int:
        total = lc.constant
        for (kind, idx), coeff in lc.terms.items():
            val = {"aL": self.a_L, "aR": self.a_R, "aO": self.a_O,
                   "V": self.v}[kind][idx]
            total = (total + coeff * val) % L
        return total

    # -- proving ------------------------------------------------------------

    def prove(self) -> R1CSProof:
        pc = default_pedersen_gens()
        t = self.transcript
        rng = self.rng
        n = self.num_multipliers
        n_pad = _pad_pow2(max(n, 1))
        bp = bulletproof_gens(n_pad, 1)
        G = bp.G(n_pad, 1)
        H = bp.H(n_pad, 1)
        t.append_u64(b"m", len(self.v))

        a_L = self.a_L + [0] * (n_pad - n)
        a_R = self.a_R + [0] * (n_pad - n)
        a_O = self.a_O + [0] * (n_pad - n)

        i_blinding = rng.random_scalar()
        o_blinding = rng.random_scalar()
        s_blinding = rng.random_scalar()
        s_L = [rng.random_scalar() for _ in range(n_pad)]
        s_R = [rng.random_scalar() for _ in range(n_pad)]

        A_I = _enc(ex.pt_msm([i_blinding] + a_L + a_R,
                             [pc.B_blinding] + G + H))
        A_O = _enc(ex.pt_msm([o_blinding] + a_O, [pc.B_blinding] + G))
        S = _enc(ex.pt_msm([s_blinding] + s_L + s_R,
                           [pc.B_blinding] + G + H))
        t.append_message(b"A_I1", A_I)
        t.append_message(b"A_O1", A_O)
        t.append_message(b"S1", S)

        y = t.get_challenge(b"y")
        z = t.get_challenge(b"z")
        wL, wR, wO, wV, wc = self._flattened_constraints(z, n_pad)

        y_inv = ex.sc_invert(y)
        y_pow = [pow(y, i, L) for i in range(n_pad)]
        y_inv_pow = [pow(y_inv, i, L) for i in range(n_pad)]

        # l(X) = aL X + aO X^2 + y^-n o wR X + sL X^3
        # r(X) = y^n o aR X + wL X + (wO - y^n) + y^n o sR X^3
        l1 = [(a_L[i] + y_inv_pow[i] * wR[i]) % L for i in range(n_pad)]
        l2 = list(a_O)
        l3 = list(s_L)
        r0 = [(wO[i] - y_pow[i]) % L for i in range(n_pad)]
        r1 = [(y_pow[i] * a_R[i] + wL[i]) % L for i in range(n_pad)]
        r3 = [y_pow[i] * s_R[i] % L for i in range(n_pad)]

        def inner(a, b):
            return sum(x * y_ for x, y_ in zip(a, b)) % L

        t_poly = [0] * 7
        for (dl, lv) in ((1, l1), (2, l2), (3, l3)):
            for (dr, rv) in ((0, r0), (1, r1), (3, r3)):
                t_poly[dl + dr] = (t_poly[dl + dr] + inner(lv, rv)) % L

        tb = {i: rng.random_scalar() for i in (1, 3, 4, 5, 6)}
        T = {i: _enc(pc.commit(t_poly[i], tb[i])) for i in (1, 3, 4, 5, 6)}
        for i in (1, 3, 4, 5, 6):
            t.append_message(b"T_%d" % i, T[i])
        x = t.get_challenge(b"u")

        xp = [pow(x, i, L) for i in range(7)]
        t_x = sum(t_poly[i] * xp[i] for i in range(1, 7)) % L
        wv_gamma = sum(w * g for w, g in zip(wV, self.v_blinding)) % L
        t_x_blinding = (sum(tb[i] * xp[i] for i in (1, 3, 4, 5, 6))
                        + xp[2] * wv_gamma) % L
        e_blinding = (x * i_blinding + xp[2] * o_blinding
                      + xp[3] * s_blinding) % L
        t.append_scalar_var(b"t_x", t_x)
        t.append_scalar_var(b"t_x_blinding", t_x_blinding)
        t.append_scalar_var(b"e_blinding", e_blinding)
        w = t.get_challenge(b"w")
        Q = ex.pt_mul(w, pc.B)

        l_vec = [(l1[i] * x + l2[i] * xp[2] + l3[i] * xp[3]) % L
                 for i in range(n_pad)]
        r_vec = [(r0[i] + r1[i] * x + r3[i] * xp[3]) % L for i in range(n_pad)]
        H_factors = y_inv_pow
        ipp = InnerProductProof.create(t, Q, [1] * n_pad, H_factors, G, H,
                                       l_vec, r_vec)
        return R1CSProof(A_I, A_O, S, T[1], T[3], T[4], T[5], T[6],
                         t_x, t_x_blinding, e_blinding, ipp)


class R1CSVerifier(_ConstraintSystemBase):
    """bulletproofs::r1cs::Verifier equivalent."""

    def __init__(self, transcript: Transcript):
        super().__init__()
        self.transcript = transcript
        self.transcript.append_message(b"dom-sep", b"r1cs v1")
        self.V: List[bytes] = []

    def commit(self, commitment: bytes) -> LinearCombination:
        j = len(self.V)
        self.V.append(commitment)
        self.num_committed += 1
        self.transcript.append_message(b"V", commitment)
        return LinearCombination.from_var("V", j)

    def allocate_multiplier(self, _assignment=None):
        i = self.num_multipliers
        self.num_multipliers += 1
        return (LinearCombination.from_var("aL", i),
                LinearCombination.from_var("aR", i),
                LinearCombination.from_var("aO", i))

    def verify(self, proof: R1CSProof) -> None:
        pc = default_pedersen_gens()
        t = self.transcript
        n = self.num_multipliers
        n_pad = _pad_pow2(max(n, 1))
        bp = bulletproof_gens(n_pad, 1)
        G = bp.G(n_pad, 1)
        H = bp.H(n_pad, 1)
        t.append_u64(b"m", len(self.V))
        t.append_message(b"A_I1", proof.A_I1)
        t.append_message(b"A_O1", proof.A_O1)
        t.append_message(b"S1", proof.S1)
        y = t.get_challenge(b"y")
        z = t.get_challenge(b"z")
        wL, wR, wO, wV, wc = self._flattened_constraints(z, n_pad)
        T = {1: proof.T_1, 3: proof.T_3, 4: proof.T_4, 5: proof.T_5,
             6: proof.T_6}
        for i in (1, 3, 4, 5, 6):
            t.append_message(b"T_%d" % i, T[i])
        x = t.get_challenge(b"u")
        t.append_scalar_var(b"t_x", proof.t_x)
        t.append_scalar_var(b"t_x_blinding", proof.t_x_blinding)
        t.append_scalar_var(b"e_blinding", proof.e_blinding)
        w = t.get_challenge(b"w")

        y_inv = ex.sc_invert(y)
        y_pow = [pow(y, i, L) for i in range(n_pad)]
        y_inv_pow = [pow(y_inv, i, L) for i in range(n_pad)]
        xp = [pow(x, i, L) for i in range(7)]

        # check 1: t commitment identity
        # t_x B + t_x_blinding B~ == x^2 (delta + wc) B + x^2 <wV, V>
        #                            + sum_{i in {1,3,4,5,6}} x^i T_i
        delta = sum(y_inv_pow[i] * wR[i] % L * wL[i] for i in range(n_pad)) % L
        V_pts, T_pts = [], {}
        for vb in self.V:
            p = ex.ristretto_decode(vb)
            if p is None:
                raise ValueError("R1CS verify: bad V point")
            V_pts.append(p)
        for i in (1, 3, 4, 5, 6):
            p = ex.ristretto_decode(T[i])
            if p is None:
                raise ValueError("R1CS verify: bad T point")
            T_pts[i] = p
        lhs = ex.pt_msm([proof.t_x, proof.t_x_blinding], [pc.B, pc.B_blinding])
        rhs_scalars = ([xp[2] * (delta + wc) % L]
                       + [xp[2] * wv % L for wv in wV]
                       + [xp[i] for i in (1, 3, 4, 5, 6)])
        rhs_points = [pc.B] + V_pts + [T_pts[i] for i in (1, 3, 4, 5, 6)]
        if not ex.pt_eq(lhs, ex.pt_msm(rhs_scalars, rhs_points)):
            raise ValueError("R1CS verification failed (t check)")

        # check 2: IPP over P
        A_I = ex.ristretto_decode(proof.A_I1)
        A_O = ex.ristretto_decode(proof.A_O1)
        S = ex.ristretto_decode(proof.S1)
        if A_I is None or A_O is None or S is None:
            raise ValueError("R1CS verify: bad proof point")
        g_scalars = [x * y_inv_pow[i] % L * wR[i] % L for i in range(n_pad)]
        h_scalars = [y_inv_pow[i] * ((wL[i] * x + wO[i] - y_pow[i]) % L) % L
                     for i in range(n_pad)]
        Q = ex.pt_mul(w, pc.B)
        P = ex.pt_msm(
            [x, xp[2], xp[3], (-proof.e_blinding) % L, w * proof.t_x % L]
            + g_scalars + h_scalars,
            [A_I, A_O, S, pc.B_blinding, pc.B] + G + H)
        proof.ipp_proof.verify(n_pad, t, [1] * n_pad, y_inv_pow, P, Q, G, H)
