"""Aggregated 64-bit Bulletproofs range proofs.

Functional equivalent of dalek-bulletproofs' `RangeProof`
(prove_single/prove_multiple/verify_single/verify_multiple as used at
reference src/accounts/prover.rs:544-591 and
reference src/accounts/verifier.rs:494-555), implemented from the
Bulletproofs paper with the crate's transcript framing:

  dom-sep "rangeproof v1", n, m; points V*, A, S -> y, z; T_1, T_2 -> x;
  scalars t_x, t_x_blinding, e_blinding -> w; then the inner-product
  argument over (l, r) with H factors y^-i and Q = w*B.

Verification checks the two standard equations (t-poly check and the IPP
commitment check) directly; the random batching weight the crate samples
from an external RNG is verifier-internal and does not affect interop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ops import exact as ex
from ..accounts.transcript import Transcript, SeededRng
from ..device import resolve_device
from ..primitives.pedersen import default_pedersen_gens
from ..utils.metrics import span
from .generators import bulletproof_gens
from .inner_product import InnerProductProof

L = ex.L


def _powers(x: int, n: int) -> List[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % L
    return out


def _inner(a, b):
    return sum(x * y for x, y in zip(a, b)) % L


def _delta(n: int, m: int, y: int, z: int) -> int:
    """delta(y,z) = (z - z^2) <1, y^nm> - sum_j z^(3+j) <1, 2^n>."""
    sum_y = sum(_powers(y, n * m)) % L
    sum_2 = (1 << n) - 1
    z2 = z * z % L
    out = (z - z2) * sum_y % L
    zexp = z2 * z % L
    for _ in range(m):
        out = (out - zexp * sum_2) % L
        zexp = zexp * z % L
    return out


def _auto_min_device(m: int) -> float:
    """The fewest lanes of m values that prove_batch's "auto" proves on the
    device: 32 at m >= 16, 64 at m >= 4, never at m = 2 (see prove_batch)."""
    return 32 if m >= 16 else 64 if m >= 4 else float("inf")


@dataclass
class RangeProof:
    A: bytes
    S: bytes
    T_1: bytes
    T_2: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: InnerProductProof

    # ------------------------------------------------------------------ prove

    @staticmethod
    def prove_multiple(transcript: Transcript, values: Sequence[int],
                       blindings: Sequence[int], n: int,
                       rng: Optional[SeededRng] = None,
                       ) -> Tuple["RangeProof", List[bytes]]:
        """Aggregated proof that each value is in [0, 2^n)."""
        m = len(values)
        assert m & (m - 1) == 0, "m must be a power of two"
        assert n in (8, 16, 32, 64)
        for v in values:
            if not 0 <= v < (1 << n):
                # refuse to emit an unverifiable proof: the bit
                # decomposition below would silently truncate to n bits
                # while V commits the full value
                raise ValueError(f"value out of range for {n}-bit proof")
        if rng is None:
            rng = SeededRng()
        pc = default_pedersen_gens()
        bp = bulletproof_gens(n, m)
        nm = n * m
        G = bp.G(n, m)
        H = bp.H(n, m)

        transcript.append_message(b"dom-sep", b"rangeproof v1")
        transcript.append_u64(b"n", n)
        transcript.append_u64(b"m", m)

        # value commitments V_j = v B + b~ B_blinding
        V = [ex.ristretto_encode(pc.commit(v, b))
             for v, b in zip(values, blindings)]
        for vb in V:
            transcript.append_message(b"V", vb)

        # bit vectors
        a_L = [(values[j] >> k) & 1 for j in range(m) for k in range(n)]
        a_R = [(x - 1) % L for x in a_L]
        a_blinding = rng.random_scalar()
        A_pt = ex.pt_msm([a_blinding] + a_L + a_R, [pc.B_blinding] + G + H)
        s_L = [rng.random_scalar() for _ in range(nm)]
        s_R = [rng.random_scalar() for _ in range(nm)]
        s_blinding = rng.random_scalar()
        S_pt = ex.pt_msm([s_blinding] + s_L + s_R, [pc.B_blinding] + G + H)

        A_b = ex.ristretto_encode(A_pt)
        S_b = ex.ristretto_encode(S_pt)
        transcript.append_message(b"A", A_b)
        transcript.append_message(b"S", S_b)
        y = transcript.get_challenge(b"y")
        z = transcript.get_challenge(b"z")

        z2 = z * z % L
        y_nm = _powers(y, nm)
        # r coefficient vectors: r0_i = y^i (aR_i + z) + zeta_i ; r1_i = y^i sR_i
        zeta = [z2 * pow(z, j, L) % L * pow(2, k, L) % L
                for j in range(m) for k in range(n)]
        l0 = [(a - z) % L for a in a_L]
        l1 = s_L
        r0 = [(y_nm[i] * ((a_R[i] + z) % L) + zeta[i]) % L for i in range(nm)]
        r1 = [y_nm[i] * s_R[i] % L for i in range(nm)]

        t0 = _inner(l0, r0)
        t2 = _inner(l1, r1)
        t1 = (_inner([(a + b) % L for a, b in zip(l0, l1)],
                     [(a + b) % L for a, b in zip(r0, r1)]) - t0 - t2) % L

        t1_blinding = rng.random_scalar()
        t2_blinding = rng.random_scalar()
        T1_pt = pc.commit(t1, t1_blinding)
        T2_pt = pc.commit(t2, t2_blinding)
        T1_b = ex.ristretto_encode(T1_pt)
        T2_b = ex.ristretto_encode(T2_pt)
        transcript.append_message(b"T_1", T1_b)
        transcript.append_message(b"T_2", T2_b)
        x = transcript.get_challenge(b"x")

        t_x = (t0 + t1 * x + t2 * x * x) % L
        t_x_blinding = (t1_blinding * x + t2_blinding * x * x) % L
        for j in range(m):
            t_x_blinding = (t_x_blinding + z2 * pow(z, j, L) * blindings[j]) % L
        e_blinding = (a_blinding + x * s_blinding) % L

        transcript.append_scalar_var(b"t_x", t_x)
        transcript.append_scalar_var(b"t_x_blinding", t_x_blinding)
        transcript.append_scalar_var(b"e_blinding", e_blinding)
        w = transcript.get_challenge(b"w")
        Q = ex.pt_mul(w, pc.B)

        l_vec = [(l0[i] + l1[i] * x) % L for i in range(nm)]
        r_vec = [(r0[i] + r1[i] * x) % L for i in range(nm)]

        y_inv = ex.sc_invert(y)
        H_factors = _powers(y_inv, nm)
        G_factors = [1] * nm
        ipp = InnerProductProof.create(transcript, Q, G_factors, H_factors,
                                       G, H, l_vec, r_vec)
        return RangeProof(A_b, S_b, T1_b, T2_b, t_x, t_x_blinding,
                          e_blinding, ipp), V

    @staticmethod
    def prove_single(transcript: Transcript, value: int, blinding: int, n: int,
                     rng: Optional[SeededRng] = None,
                     ) -> Tuple["RangeProof", bytes]:
        proof, V = RangeProof.prove_multiple(transcript, [value], [blinding], n,
                                             rng=rng)
        return proof, V[0]

    @staticmethod
    def prove_batch(lanes, n: int, backend: str = "auto", min_bucket: int = 2,
                    device="cuda"):
        """Prove many independent aggregated range proofs.

        ``lanes``: (transcript, values, blindings, rng) per proof. Returns
        [(proof, V_bytes_list)] in lane order; every host transcript is
        advanced past its proof (so embedded flows can continue).

        backend:
          - "host": ``prove_multiple`` per lane.
          - "device-batched": group the lanes by (m, transcript frame), pad
            each group to a power-of-two bucket (at least ``min_bucket``;
            pad lanes draw from a fresh SeededRng, never from a real
            lane's stream) and prove each group in one call of
            ``bulletproofs.device_prove.DeviceRangeProver`` on ``device``:
            byte-identical to the host prover under the same rng streams.
            The host transcripts are advanced by replaying the finished
            proofs (``advance_transcript``).
          - "auto": per group, "device-batched" from
            ``_auto_min_device(m)`` lanes, "host" below. On the H100 with
            the C++ curve under the host prover (64 bits, two runs), a host
            proof took 51.1-57.4 ms at m = 2, 72.4-102.4 at m = 4,
            134.8-146.7 at m = 8 and 268.7-283.4 at m = 16; one device call
            of 32 lanes 3.5-6.0 s and of 64 lanes 3.7-6.7 s. The device led
            at m = 16 from 32 lanes (6,000-6,028 ms against 8,598-9,069 for
            32 host proofs), at m = 4 and m = 8 from 64 (3,723-4,194 ms
            against 4,634-6,554; 5,536-6,450 against 8,627-9,389; at 32
            lanes of m = 8 it was even in one run and behind in the other),
            never at m = 2 up to 64 (3,695-4,073 against 3,270-3,674)
            (``python3 -m quisquis_tpu_torch.auto_rules``; PERF.md §5).
            ``device`` is resolved first, so the default raises without a
            GPU whichever backend a group takes.

        The reference proves range proofs one at a time (reference
        src/accounts/prover.rs:544-591); cross-proof batching has no analog
        there.
        """
        lanes = list(lanes)
        if backend not in ("auto", "host", "device-batched"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            resolve_device(device)
        if backend == "host":
            return [RangeProof.prove_multiple(t, vals, blinds, n, rng=rng)
                    for t, vals, blinds, rng in lanes]
        from ..ops.device_strobe import snapshot_host_strobe
        from .device_prove import get_device_range_prover

        with span("dev.range_prove"):
            groups: dict = {}
            for i, (t, vals, _, _) in enumerate(lanes):
                frame = snapshot_host_strobe(t.strobe)[1:]
                groups.setdefault((len(vals), frame), []).append(i)
        results: list = [None] * len(lanes)
        for (m, _), idxs in sorted(groups.items()):
            if backend == "auto" and len(idxs) < _auto_min_device(m):
                for i in idxs:
                    t, vals, blinds, rng = lanes[i]
                    results[i] = RangeProof.prove_multiple(t, vals, blinds, n, rng=rng)
                continue
            with span("dev.range_prove"):
                B = max(min_bucket, 1 << (len(idxs) - 1).bit_length())
                pad = idxs + [idxs[0]] * (B - len(idxs))
                drp = get_device_range_prover(n, m, B, device=device)
                proofs, vlists = drp.prove(
                    [list(lanes[i][1]) for i in pad], [list(lanes[i][2]) for i in pad],
                    [lanes[i][3] if k < len(idxs) else SeededRng() for k, i in enumerate(pad)],
                    transcripts=[lanes[i][0] for i in pad])   # snapshots; not advanced
            with span("tx.build.advance"):
                for k, i in enumerate(idxs):
                    proofs[k].advance_transcript(lanes[i][0], vlists[k], n)
                    results[i] = (proofs[k], vlists[k])
        return results

    # ----------------------------------------------------------------- verify

    def verify_multiple(self, transcript: Transcript,
                        value_commitments: Sequence[bytes], n: int) -> None:
        m = len(value_commitments)
        assert m & (m - 1) == 0
        nm = n * m
        pc = default_pedersen_gens()
        bp = bulletproof_gens(n, m)
        G = bp.G(n, m)
        H = bp.H(n, m)

        transcript.append_message(b"dom-sep", b"rangeproof v1")
        transcript.append_u64(b"n", n)
        transcript.append_u64(b"m", m)
        for vb in value_commitments:
            transcript.append_message(b"V", vb)
        transcript.append_message(b"A", self.A)
        transcript.append_message(b"S", self.S)
        y = transcript.get_challenge(b"y")
        z = transcript.get_challenge(b"z")
        transcript.append_message(b"T_1", self.T_1)
        transcript.append_message(b"T_2", self.T_2)
        x = transcript.get_challenge(b"x")
        transcript.append_scalar_var(b"t_x", self.t_x)
        transcript.append_scalar_var(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar_var(b"e_blinding", self.e_blinding)
        w = transcript.get_challenge(b"w")

        V_pts = [ex.ristretto_decode(vb) for vb in value_commitments]
        A_pt = ex.ristretto_decode(self.A)
        S_pt = ex.ristretto_decode(self.S)
        T1_pt = ex.ristretto_decode(self.T_1)
        T2_pt = ex.ristretto_decode(self.T_2)
        if any(p is None for p in V_pts + [A_pt, S_pt, T1_pt, T2_pt]):
            raise ValueError("Bulletproof verification failed: bad point")

        z2 = z * z % L
        # check 1: t_x B + t_x_blinding B~ == z^2 sum z^j V_j + delta B + x T1 + x^2 T2
        lhs = ex.pt_msm([self.t_x, self.t_x_blinding], [pc.B, pc.B_blinding])
        rhs_scalars = [z2 * pow(z, j, L) % L for j in range(m)] + \
                      [_delta(n, m, y, z), x, x * x % L]
        rhs = ex.pt_msm(rhs_scalars, V_pts + [pc.B, T1_pt, T2_pt])
        if not ex.pt_eq(lhs, rhs):
            raise ValueError("Bulletproof verification failed")

        # check 2: P == <l,G> + <r,H'> + t_x Q  via the IPP
        y_nm = _powers(y, nm)
        y_inv = ex.sc_invert(y)
        H_factors = _powers(y_inv, nm)
        zeta = [z2 * pow(z, j, L) % L * pow(2, k, L) % L
                for j in range(m) for k in range(n)]
        Q = ex.pt_mul(w, pc.B)
        h_scalars = [(z * y_nm[i] + zeta[i]) % L * H_factors[i] % L
                     for i in range(nm)]
        P = ex.pt_msm(
            [1, x, (-self.e_blinding) % L, w * self.t_x % L] +
            [(-z) % L] * nm + h_scalars,
            [A_pt, S_pt, pc.B_blinding, pc.B] + G + H)
        self.ipp_proof.verify(nm, transcript, [1] * nm, H_factors, P, Q, G, H)

    def verify_single(self, transcript: Transcript, value_commitment: bytes,
                      n: int) -> None:
        self.verify_multiple(transcript, [value_commitment], n)

    @staticmethod
    def batch_verify(instances: Sequence[Tuple["RangeProof", Sequence[bytes],
                                               Transcript]],
                     n: int, rng: Optional[SeededRng] = None, defer=None,
                     backend: str = "device-batched", device="cuda") -> None:
        """Batch verification across many independent proofs (the crate's
        `yoloproofs` behavior): every proof's two checks are folded, with
        per-equation random weights, into ONE multiscalar multiplication
        whose shared generator scalars accumulate across proofs.

        instances: [(proof, value_commitments, transcript), ...]; each
        transcript must be in the state the corresponding single
        verification would start from. Raises ValueError if the combined
        check fails (at least one proof in the batch is invalid).

        backend:
          - "device-batched": hand the whole batch to the device verifier
            (bulletproofs.device_verify): transcripts, challenge arithmetic
            and the MSM all run on ``device``.
          - "host": replay the transcripts here and evaluate one MSM through
            the deferred accumulator (accounts.deferred), on the host.
          - "auto": "device-batched" without `defer`, "host" with it.

        With `defer` (accounts.deferred.DeferredPointChecks), the combined
        terms join an even larger cross-protocol batch instead of being
        evaluated here; per-equation weights then come from the accumulator,
        and the accumulator's owner chooses where its MSM runs.
        """
        from ..accounts.deferred import DeferredPointChecks

        if backend not in ("auto", "host", "device-batched"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "host" if defer is not None else "device-batched"
        if backend == "device-batched":
            if defer is not None:
                raise ValueError(
                    "device-batched backend evaluates its own MSM; "
                    "it cannot feed a deferred accumulator")
            from .device_verify import device_batch_verify

            device_batch_verify(instances, n, rng=rng, device=device)
            return

        own = defer is None
        if own:
            seed = None if rng is None else ex.sc_to_bytes(rng.random_scalar())
            defer = DeferredPointChecks(seed)
        pc = default_pedersen_gens()
        max_m = max((len(V) for _, V, _ in instances), default=1)
        bp = bulletproof_gens(n, max_m)
        G = bp.G(n, max_m)
        H = bp.H(n, max_m)

        for proof, value_commitments, transcript in instances:
            m = len(value_commitments)
            if m & (m - 1):
                raise ValueError("Bulletproof batch verification failed: "
                                 "the number of values is not a power of two")
            nm = n * m
            transcript.append_message(b"dom-sep", b"rangeproof v1")
            transcript.append_u64(b"n", n)
            transcript.append_u64(b"m", m)
            for vb in value_commitments:
                transcript.append_message(b"V", vb)
            transcript.append_message(b"A", proof.A)
            transcript.append_message(b"S", proof.S)
            y = transcript.get_challenge(b"y")
            z = transcript.get_challenge(b"z")
            transcript.append_message(b"T_1", proof.T_1)
            transcript.append_message(b"T_2", proof.T_2)
            x = transcript.get_challenge(b"x")
            transcript.append_scalar_var(b"t_x", proof.t_x)
            transcript.append_scalar_var(b"t_x_blinding", proof.t_x_blinding)
            transcript.append_scalar_var(b"e_blinding", proof.e_blinding)
            w = transcript.get_challenge(b"w")
            u_sq, u_inv_sq, s = proof.ipp_proof.verification_scalars(
                nm, transcript)

            V_pts = [ex.ristretto_decode(vb) for vb in value_commitments]
            A_pt = ex.ristretto_decode(proof.A)
            S_pt = ex.ristretto_decode(proof.S)
            T1_pt = ex.ristretto_decode(proof.T_1)
            T2_pt = ex.ristretto_decode(proof.T_2)
            L_pts = [ex.ristretto_decode(b_) for b_ in proof.ipp_proof.L_vec]
            R_pts = [ex.ristretto_decode(b_) for b_ in proof.ipp_proof.R_vec]
            if any(p is None for p in
                   V_pts + [A_pt, S_pt, T1_pt, T2_pt] + L_pts + R_pts):
                raise ValueError("Bulletproof batch verification failed: "
                                 "bad point")

            z2 = z * z % L
            # check 1:
            #   t_x B + t_x_blinding B~ - sum z^2 z^j V_j - delta B
            #   - x T1 - x^2 T2 == 0
            defer.check(
                [(proof.t_x - _delta(n, m, y, z)) % L, proof.t_x_blinding]
                + [(-z2) * pow(z, j, L) % L for j in range(m)]
                + [(-x) % L, (-x) * x % L],
                [pc.B, pc.B_blinding] + V_pts + [T1_pt, T2_pt],
                "Bulletproof batch verification failed")

            # check 2 + IPP:
            #   A + x S - e_b B~ + w(t_x - a b) B + sum(-z - a s_i) G_i
            #   + sum(h_i - b s_inv_i Hf_i) H_i + sum(u^2 L + u^-2 R) == 0
            a, b = proof.ipp_proof.a, proof.ipp_proof.b
            y_nm = _powers(y, nm)
            y_inv = ex.sc_invert(y)
            H_factors = _powers(y_inv, nm)
            zeta = [z2 * pow(z, j, L) % L * pow(2, k, L) % L
                    for j in range(m) for k in range(n)]
            h_scalars = [(z * y_nm[i] + zeta[i]) % L * H_factors[i] % L
                         for i in range(nm)]
            s_inv = s[::-1]
            scalars = [w * (proof.t_x - a * b) % L,
                       (-proof.e_blinding) % L, 1, x]
            points = [pc.B, pc.B_blinding, A_pt, S_pt]
            scalars.extend((-z - a * s[i]) % L for i in range(nm))
            points.extend(G[:nm])
            scalars.extend((h_scalars[i] - b * s_inv[i] % L * H_factors[i]) % L
                           for i in range(nm))
            points.extend(H[:nm])
            for k in range(len(L_pts)):
                scalars.extend([u_sq[k], u_inv_sq[k]])
                points.extend([L_pts[k], R_pts[k]])
            defer.check(scalars, points,
                        "Bulletproof batch verification failed")

        if own:
            defer.verify(backend="host")

    def advance_transcript(self, transcript: Transcript,
                           value_commitments: Sequence[bytes],
                           n: int) -> None:
        """Replay ONLY the transcript interactions of a verification (all
        appends and challenge pulls, results discarded), advancing
        `transcript` to the post-proof state without any scalar or point
        work.

        Used by the device-batched transaction path: the host transcript
        must continue past an embedded range proof (later sigma checks
        depend on its state) while the actual verification maths runs on
        device from a snapshot taken before this call.
        """
        m = len(value_commitments)
        nm = n * m
        transcript.append_message(b"dom-sep", b"rangeproof v1")
        transcript.append_u64(b"n", n)
        transcript.append_u64(b"m", m)
        for vb in value_commitments:
            transcript.append_message(b"V", vb)
        transcript.append_message(b"A", self.A)
        transcript.append_message(b"S", self.S)
        transcript.get_challenge(b"y")
        transcript.get_challenge(b"z")
        transcript.append_message(b"T_1", self.T_1)
        transcript.append_message(b"T_2", self.T_2)
        transcript.get_challenge(b"x")
        transcript.append_scalar_var(b"t_x", self.t_x)
        transcript.append_scalar_var(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar_var(b"e_blinding", self.e_blinding)
        transcript.get_challenge(b"w")
        transcript.append_message(b"dom-sep", b"ipp v1")
        transcript.append_u64(b"n", nm)
        for L_b, R_b in zip(self.ipp_proof.L_vec, self.ipp_proof.R_vec):
            transcript.append_message(b"L", L_b)
            transcript.append_message(b"R", R_b)
            transcript.get_challenge(b"u")

    # ------------------------------------------------------------------ serde

    def to_bytes(self) -> bytes:
        head = (self.A + self.S + self.T_1 + self.T_2 +
                ex.sc_to_bytes(self.t_x) + ex.sc_to_bytes(self.t_x_blinding) +
                ex.sc_to_bytes(self.e_blinding))
        return head + self.ipp_proof.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "RangeProof":
        assert len(data) >= 7 * 32
        A, S, T1, T2 = data[:32], data[32:64], data[64:96], data[96:128]
        t_x = ex.sc_from_bytes_mod_order(data[128:160])
        t_x_b = ex.sc_from_bytes_mod_order(data[160:192])
        e_b = ex.sc_from_bytes_mod_order(data[192:224])
        ipp = InnerProductProof.from_bytes(data[224:])
        return cls(A, S, T1, T2, t_x, t_x_b, e_b, ipp)

