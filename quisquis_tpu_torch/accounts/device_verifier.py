"""Device-batched sigma verification.

The host verifiers (:mod:`quisquis_tpu_torch.accounts.verifier`) recompute
the prover's first messages with per-account multiscalar multiplications,
the verifier's hot path. Here those recombinations run over all accounts at
once on the device: the account bytes go up, every scalar product of the
batch is one ``scalar_mul`` launch (and the fixed-base products one
``base_mul`` launch), and only the compressed 32-byte encodings return to
the host transcript:

    e_delta_i = zr1_i*gr_i + x*c_i
    f_delta_i = zv_i*G + zr1_i*grsk_i + x*d_i          (G fixed-base)
    e_eps_i   = zr2_i*gr'_i + x*c'_i
    f_eps_i   = zv_i*G + zr2_i*grsk'_i + x*d'_i

    e_i = z_i*gr_i + x*c_i,   f_i = z_i*grsk_i + x*d_i  (zero balance)

Byte for byte the encodings of Verifier.verify_delta_compact_verifier and
Verifier.zero_balance_account_vector_verifier (tests/test_torch_sigma_verify.py).
Every call runs eagerly on the given device; an account whose bytes do not
decode makes the call raise ValueError, as the host verifier does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import batch as qb
from ..ops import cuda_point as kp
from ..ops import exact as ex
from ..ops import point as pt
from .accounts import Account
from .verifier import Verifier

L = ex.L


def _products(blobs: Sequence[bytes], scalars: Sequence[int], dev: torch.device):
    """s_i * P_i for wire points P_i decoded on the device, in one
    ``scalar_mul`` launch: (all decoded?, products [k])."""
    wire = np.frombuffer(b"".join(blobs), np.uint8).reshape(len(blobs), 32).copy()
    ok, points = pt.decompress_bytes_tensor(torch.as_tensor(wire, device=dev))
    return ok.all(), kp.scalar_mul(qb.scalars_to_device(scalars, dev), points)


def _rows(p: pt.ExtPoint, k: int) -> pt.ExtPoint:
    return pt.ExtPoint(*(c.reshape(k, -1, c.shape[-1]) for c in p))


def _encodings(ok: torch.Tensor, points: pt.ExtPoint) -> np.ndarray:
    """Wire encodings [..., 32] of the points; raises if a point failed to
    decode. Only these bytes and one boolean leave the device."""
    enc = pt.compress_to_bytes(points)
    if not bool(ok):
        raise ValueError("Account Verify: Failed (a point does not decode)")
    return enc


def delta_compact_encodings(delta_accounts: Sequence[Account],
                            epsilon_accounts: Sequence[Account],
                            zv_vector: Sequence[int], zr1_vector: Sequence[int],
                            zr2_vector: Sequence[int], x: int,
                            device="cuda") -> np.ndarray:
    """uint8 [n, 4, 32]: (e_delta, f_delta, e_epsilon, f_epsilon) per account."""
    dev = resolve_device(device)
    n = len(delta_accounts)
    if not (len(epsilon_accounts) == len(zv_vector) == len(zr1_vector)
            == len(zr2_vector) == n):
        raise ValueError("Dleq Proof Verify: length mismatch")
    blobs, scalars = [], []
    for accs, zr in ((delta_accounts, zr1_vector), (epsilon_accounts, zr2_vector)):
        blobs += ([a.pk.gr for a in accs] + [a.comm.c for a in accs]
                  + [a.pk.grsk for a in accs] + [a.comm.d for a in accs])
        scalars += list(zr) + [x] * n + list(zr) + [x] * n
    ok, prod = _products(blobs, scalars, dev)
    gr_d, c_d, grsk_d, d_d, gr_e, c_e, grsk_e, d_e = (
        pt.ExtPoint(*(c[i] for c in _rows(prod, 8))) for i in range(8))
    g_v = kp.base_mul(qb.scalars_to_device(zv_vector, dev))
    out = [pt.add(gr_d, c_d), pt.add(g_v, pt.add(grsk_d, d_d)),
           pt.add(gr_e, c_e), pt.add(g_v, pt.add(grsk_e, d_e))]
    return _encodings(ok, pt.ExtPoint(*(torch.stack(cs, dim=1) for cs in zip(*out))))


def zero_balance_encodings(anonymity_accounts: Sequence[Account], z: Sequence[int],
                           x: int, device="cuda") -> np.ndarray:
    """uint8 [n, 2, 32]: (e, f) per account."""
    dev = resolve_device(device)
    n = len(anonymity_accounts)
    if len(z) != n:
        raise ValueError("Zero balance account verification: length mismatch")
    accs = anonymity_accounts
    ok, prod = _products([a.pk.gr for a in accs] + [a.comm.c for a in accs]
                         + [a.pk.grsk for a in accs] + [a.comm.d for a in accs],
                         list(z) + [x] * n + list(z) + [x] * n, dev)
    gr, c, grsk, d = (pt.ExtPoint(*(q[i] for q in _rows(prod, 4))) for i in range(4))
    out = [pt.add(gr, c), pt.add(grsk, d)]
    return _encodings(ok, pt.ExtPoint(*(torch.stack(cs, dim=1) for cs in zip(*out))))


def verify_delta_compact_verifier_device(
    delta_accounts: Sequence[Account], epsilon_accounts: Sequence[Account],
    zv_vector: Sequence[int], zr1_vector: Sequence[int],
    zr2_vector: Sequence[int], x: int, verifier: Verifier, device="cuda",
) -> None:
    """Device-batched Verifier.verify_delta_compact_verifier."""
    verifier.new_domain_sep(b"VerifyDeltaCompact")
    for d, e in zip(delta_accounts, epsilon_accounts):
        verifier.allocate_account(b"delta_account", d)
        verifier.allocate_account(b"epsilon_account", e)
    enc = delta_compact_encodings(delta_accounts, epsilon_accounts, zv_vector,
                                  zr1_vector, zr2_vector, x, device)
    for row in enc:
        verifier.allocate_point(b"e_delta", bytes(row[0]))
        verifier.allocate_point(b"f_delta", bytes(row[1]))
        verifier.allocate_point(b"e_epsilon", bytes(row[2]))
        verifier.allocate_point(b"f_epsilon", bytes(row[3]))
    if verifier.get_challenge(b"challenge") != x % L:
        raise ValueError("Dleq Proof Verify: Failed")


def zero_balance_account_vector_verifier_device(
    anonymity_accounts: Sequence[Account], z: Sequence[int], x: int,
    verifier: Verifier, device="cuda",
) -> None:
    """Device-batched Verifier.zero_balance_account_vector_verifier."""
    verifier.new_domain_sep(b"ZeroBalanceAccountVectorProof")
    for acc in anonymity_accounts:
        verifier.allocate_account(b"anonymity_account", acc)
    for row in zero_balance_encodings(anonymity_accounts, z, x, device):
        verifier.allocate_point(b"e", bytes(row[0]))
        verifier.allocate_point(b"f", bytes(row[1]))
    if verifier.get_challenge(b"challenge") != x % L:
        raise ValueError("Zero balance account verification failed")
