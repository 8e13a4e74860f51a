"""Byte serialization for proofs and statements.

The reference derives serde/bincode on every proof struct
(SURVEY §5 persistence row); here each proof family gets an explicit,
versionless little-endian layout: scalars are 32-byte canonical LE, points
are 32-byte compressed ristretto, vectors are u32-length-prefixed. Account,
key, and commitment wire formats (64-byte concatenations) already match the
reference byte-for-byte (primitives/, accounts/).

The bytes equal the JAX package's (quisquis_tpu.utils.serde) in both
directions. The proof classes are imported where a blob is read, so that
:class:`Writer` and :class:`Reader` load without the CUDA wrappers: the
resident daemon's client frames its requests with them (daemon.py).
"""

from __future__ import annotations

import struct
from typing import TYPE_CHECKING, List

from ..ops import exact as ex

if TYPE_CHECKING:
    from ..accounts.prover import SigmaProof
    from ..shuffle.ddh import DDHProof, DDHStatement
    from ..shuffle.hadamard import HadamardProof, HadamardStatement
    from ..shuffle.singlevalueproduct import SVPProof, SVPStatement
    from ..shuffle.product import ProductProof, ProductStatement, ZeroProof, ZeroStatement
    from ..shuffle.multiexponential import MultiexpoProof
    from ..shuffle.shuffle import ShuffleProof, ShuffleStatement


class Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def scalar(self, s: int):
        self.parts.append(ex.sc_to_bytes(s))

    def point(self, p: bytes):
        assert len(p) == 32
        self.parts.append(p)

    def scalars(self, xs):
        self.u32(len(xs))
        for x in xs:
            self.scalar(x)

    def points(self, ps):
        self.u32(len(ps))
        for p in ps:
            self.point(p)

    def blob(self, b: bytes):
        self.u32(len(b))
        self.parts.append(bytes(b))

    def bytes_(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _need(self, n: int) -> None:
        if len(self.data) - self.off < n:
            raise ValueError("truncated proof bytes")

    def u8(self) -> int:
        self._need(1)
        v = self.data[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        self._need(4)
        v = struct.unpack_from("<I", self.data, self.off)[0]
        self.off += 4
        return v

    def u64(self) -> int:
        self._need(8)
        v = struct.unpack_from("<Q", self.data, self.off)[0]
        self.off += 8
        return v

    def scalar(self) -> int:
        self._need(32)
        v = ex.sc_from_bytes_mod_order(self.data[self.off:self.off + 32])
        self.off += 32
        return v

    def point(self) -> bytes:
        self._need(32)
        v = self.data[self.off:self.off + 32]
        self.off += 32
        return v

    def _count(self) -> int:
        # bound the declared count by the remaining bytes BEFORE looping:
        # a hostile u32 (e.g. 0xffffffff) must raise, not spin
        n = self.u32()
        if n > (len(self.data) - self.off) // 32:
            raise ValueError("declared count exceeds remaining proof bytes")
        return n

    def scalars(self) -> List[int]:
        return [self.scalar() for _ in range(self._count())]

    def points(self) -> List[bytes]:
        return [self.point() for _ in range(self._count())]

    def blob(self) -> bytes:
        n = self.u32()
        self._need(n)
        v = self.data[self.off:self.off + n]
        self.off += n
        return v

    def done(self) -> bool:
        return self.off == len(self.data)


# -- sigma proofs -----------------------------------------------------------

def sigma_to_bytes(p: SigmaProof) -> bytes:
    w = Writer()
    if p.kind == "dlog":
        z, x = p.fields
        w.u8(0)
        w.scalars(z)
        w.scalar(x)
    else:
        zv, zr1, zr2, x = p.fields
        w.u8(1)
        w.scalars(zv)
        w.scalars(zr1)
        w.scalars(zr2)
        w.scalar(x)
    return w.bytes_()


def sigma_from_bytes(data: bytes) -> "SigmaProof":
    from ..accounts.prover import SigmaProof

    r = Reader(data)
    kind = r.u8()
    if kind == 0:
        return SigmaProof.dlog(r.scalars(), r.scalar())
    return SigmaProof.dleq(r.scalars(), r.scalars(), r.scalars(), r.scalar())


# -- shuffle sub-proofs ------------------------------------------------------

def _w_ddh(w, p: DDHProof, s: DDHStatement):
    w.scalar(p.challenge)
    w.scalar(p.z)
    w.point(s.G_dash)
    w.point(s.H_dash)


def _r_ddh(r):
    from ..shuffle.ddh import DDHProof, DDHStatement

    return DDHProof(r.scalar(), r.scalar()), DDHStatement(r.point(), r.point())


def _w_hadamard(w, p: HadamardProof, s: HadamardStatement):
    w.point(p.commitment_a_0)
    w.point(p.commitment_b_0)
    w.point(p.commitment_c_0)
    w.points(p.commitment_delta)
    w.scalars(p.a_bar)
    w.scalars(p.b_bar)
    w.scalars(p.c_bar)
    for sc in (p.r_bar, p.s_bar, p.t_bar, p.rho_bar):
        w.scalar(sc)
    w.scalars(s.omega)


def _r_hadamard(r):
    from ..shuffle.hadamard import HadamardProof, HadamardStatement

    return (HadamardProof(r.point(), r.point(), r.point(), r.points(),
                          r.scalars(), r.scalars(), r.scalars(),
                          r.scalar(), r.scalar(), r.scalar(), r.scalar()),
            HadamardStatement(r.scalars()))


def _w_svp(w, p: SVPProof, s: SVPStatement):
    w.point(p.commitment_d)
    w.point(p.commitment_delta_small)
    w.point(p.commitment_delta_capital)
    w.scalars(p.a_twildle)
    w.scalars(p.b_twildle)
    w.scalar(p.r_twildle)
    w.scalar(p.s_twildle)
    w.point(s.commitment_a)
    w.scalar(s.b)


def _r_svp(r):
    from ..shuffle.singlevalueproduct import SVPProof, SVPStatement

    return (SVPProof(r.point(), r.point(), r.point(), r.scalars(),
                     r.scalars(), r.scalar(), r.scalar()),
            SVPStatement(r.point(), r.scalar()))


def _w_zero(w, p: ZeroProof, s: ZeroStatement):
    w.point(p.c_A_0)
    w.point(p.c_B_m)
    w.points(p.c_D)
    w.scalars(p.a_vec)
    w.scalars(p.b_vec)
    w.scalar(p.r)
    w.scalar(p.s)
    w.scalar(p.t)
    w.points(s.c_A)


def _r_zero(r):
    from ..shuffle.product import ZeroProof, ZeroStatement

    return (ZeroProof(r.point(), r.point(), r.points(), r.scalars(),
                      r.scalars(), r.scalar(), r.scalar(), r.scalar()),
            ZeroStatement(r.points()))


def _w_product(w, p: ProductProof, s: ProductStatement):
    w.points(p.multi_hadamard_proof.c_B)
    _w_zero(w, p.multi_hadamard_proof.zero_proof, s.multi_hadamard_statement.zero_statement)
    w.point(s.multi_hadamard_statement.c_b)
    _w_svp(w, p.svp_proof, s.svp_statement)


def _r_product(r):
    from ..shuffle.product import (MultiHadamardProof, MultiHadamardStatement,
                                   ProductProof, ProductStatement)

    c_B = r.points()
    zero_p, zero_s = _r_zero(r)
    c_b = r.point()
    svp_p, svp_s = _r_svp(r)
    return (ProductProof(MultiHadamardProof(c_B, zero_p), svp_p),
            ProductStatement(MultiHadamardStatement(c_b, zero_s), svp_s))


def _w_multiexpo(w, p: MultiexpoProof):
    w.point(p.c_A_0)
    w.points(p.c_B_k)
    w.points(p.E_k_0)
    w.points(p.E_k_1)
    w.scalars(p.a_vec)
    w.scalar(p.r)
    w.scalar(p.b)
    w.scalar(p.s)
    w.scalar(p.t)


def _r_multiexpo(r):
    from ..shuffle.multiexponential import MultiexpoProof

    return MultiexpoProof(r.point(), r.points(), r.points(), r.points(),
                          r.scalars(), r.scalar(), r.scalar(), r.scalar(),
                          r.scalar())


def shuffle_proof_to_bytes(p: ShuffleProof, s: ShuffleStatement) -> bytes:
    w = Writer()
    w.points(p.c_A)
    w.points(p.c_tau)
    w.points(p.c_B)
    w.points(p.c_B_dash)
    _w_hadamard(w, p.hadamard_proof, s.hadamard_statement)
    _w_product(w, p.product_proof, s.product_statement)
    _w_multiexpo(w, p.multi_exponen_pk)
    _w_multiexpo(w, p.multi_exponen_commit)
    _w_ddh(w, p.ddh_proof, s.ddh_statement)
    return w.bytes_()


def _shuffle_proof_read(r: "Reader"):
    from ..shuffle.shuffle import ShuffleProof, ShuffleStatement

    c_A = r.points()
    c_tau = r.points()
    c_B = r.points()
    c_B_dash = r.points()
    had_p, had_s = _r_hadamard(r)
    prod_p, prod_s = _r_product(r)
    me_pk = _r_multiexpo(r)
    me_commit = _r_multiexpo(r)
    ddh_p, ddh_s = _r_ddh(r)
    return (ShuffleProof(c_A, c_tau, c_B, c_B_dash, had_p, prod_p, me_pk,
                         me_commit, ddh_p),
            ShuffleStatement(had_s, prod_s, ddh_s))


def shuffle_proof_from_bytes(data: bytes):
    r = Reader(data)
    out = _shuffle_proof_read(r)
    if not r.done():
        raise ValueError("trailing bytes in shuffle proof")
    return out


def shuffle_entry_to_bytes(proof: ShuffleProof, statement: ShuffleStatement,
                           inputs, outputs) -> bytes:
    """One self-contained shuffle-verification work item: proof + statement
    + the input/output account vectors (the wire form a verification
    service ingests; see serving.ShuffleVerificationService)."""
    w = Writer()
    w.blob(shuffle_proof_to_bytes(proof, statement))
    _w_accounts(w, inputs)
    _w_accounts(w, outputs)
    return w.bytes_()


def shuffle_entry_from_bytes(data: bytes):
    """-> (proof, statement, input accounts, output accounts)."""
    r = Reader(data)
    proof, statement = shuffle_proof_from_bytes(r.blob())
    inputs = _r_accounts(r)
    outputs = _r_accounts(r)
    if not r.done():
        raise ValueError("trailing bytes in shuffle entry")
    return proof, statement, inputs, outputs


# -- transactions -------------------------------------------------------------

def _w_account(w: Writer, acc) -> None:
    w.blob(acc.as_bytes())


def _r_account(r: Reader):
    from ..accounts.accounts import Account

    return Account.from_bytes(r.blob())


def _w_accounts(w: Writer, accs) -> None:
    w.u32(len(accs))
    for a in accs:
        _w_account(w, a)


def _r_accounts(r: Reader):
    n = r.u32()
    if n > len(r.data) // 128:
        raise ValueError("declared count exceeds remaining proof bytes")
    return [_r_account(r) for _ in range(n)]


def transaction_to_bytes(tx) -> bytes:
    w = Writer()
    for vec in (tx.input_account_vector, tx.updated_account_vector,
                tx.account_delta_vector, tx.account_epsilon_vector,
                tx.account_updated_delta_vector, tx.output_account_vector):
        _w_accounts(w, vec)
    return w.bytes_()


def transaction_from_bytes(data: bytes):
    from ..transaction.transaction import Transaction

    r = Reader(data)
    vecs = [_r_accounts(r) for _ in range(6)]
    if not r.done():
        raise ValueError("trailing bytes in transaction")
    return Transaction(*vecs)


def transaction_proof_to_bytes(p) -> bytes:
    w = Writer()
    zv, zr1, zr2, x = p.delta_dleq
    w.scalars(zv), w.scalars(zr1), w.scalars(zr2), w.scalar(x)
    z_u, x_u = p.update_dlog
    w.scalars(z_u), w.scalar(x_u)
    z_z, x_z = p.zero_dlog
    w.scalars(z_z), w.scalar(x_z)
    zv_a, zsk_a, zr_a, x_a = p.sender_dleq
    w.scalars(zv_a), w.scalars(zsk_a), w.scalars(zr_a), w.scalar(x_a)
    _w_accounts(w, p.epsilon_sender_accounts)
    _w_accounts(w, p.anonymity_accounts)
    w.u32(len(p.range_proofs))
    for rp in p.range_proofs:
        # kind tag: 0 = aggregated bulletproof, 1 = shared-R1CS proof
        # (the R1CS transaction path, transaction.rs:184-475)
        from ..bulletproofs.r1cs import R1CSProof

        w.u8(1 if isinstance(rp, R1CSProof) else 0)
        w.blob(rp.to_bytes())
    w.blob(shuffle_proof_to_bytes(p.input_shuffle_proof,
                                  p.input_shuffle_statement))
    w.blob(shuffle_proof_to_bytes(p.output_shuffle_proof,
                                  p.output_shuffle_statement))
    w.u32(p.senders_count)
    w.u32(p.receivers_count)
    w.u32(p.anonymity_account_diff)
    return w.bytes_()


def transaction_proof_from_bytes(data: bytes):
    from ..bulletproofs.range_proof import RangeProof
    from ..transaction.transaction import TransactionProof

    r = Reader(data)
    delta_dleq = (r.scalars(), r.scalars(), r.scalars(), r.scalar())
    update_dlog = (r.scalars(), r.scalar())
    zero_dlog = (r.scalars(), r.scalar())
    sender_dleq = (r.scalars(), r.scalars(), r.scalars(), r.scalar())
    eps_sender = _r_accounts(r)
    anonymity = _r_accounts(r)
    n_rp = r.u32()
    if n_rp > len(r.data) // 32:
        raise ValueError("declared count exceeds remaining proof bytes")
    from ..bulletproofs.r1cs import R1CSProof

    range_proofs = []
    for _ in range(n_rp):
        kind = r.u8()
        if kind == 0:
            range_proofs.append(RangeProof.from_bytes(r.blob()))
        elif kind == 1:
            range_proofs.append(R1CSProof.from_bytes(r.blob()))
        else:
            raise ValueError(f"unknown range-proof kind {kind}")
    in_p, in_s = _shuffle_proof_read(Reader(r.blob()))
    out_p, out_s = _shuffle_proof_read(Reader(r.blob()))
    sc, rc, diff = r.u32(), r.u32(), r.u32()
    if not r.done():
        raise ValueError("trailing bytes in transaction proof")
    return TransactionProof(delta_dleq, update_dlog, zero_dlog, sender_dleq,
                            eps_sender, anonymity, range_proofs,
                            in_p, in_s, out_p, out_s, sc, rc, diff)
