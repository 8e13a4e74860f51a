"""Batched ElGamal commitments and account updates in PyTorch.

The counterparts of the JAX package's ``ops/batch.py`` (BASELINE configs
1-3):

* commitment generation (c, d) = (r*gr, v*G + r*grsk), elgamal.rs:41-53;
* homomorphic add/sub/scale, account updates (accounts.rs:143-154) and
  commitment verification d == v*G + sk*c (elgamal.rs:81-95).

Batch = leading axis. Every scalar multiplication goes through
:mod:`quisquis_tpu_torch.ops.cuda_point`: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors. The JAX package keeps an XLA and a
Pallas version of each function; the port has one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import cuda_point as kp
from . import point as pt


class BatchCommitment(NamedTuple):
    """Batched ElGamal commitments in extended form."""

    c: pt.ExtPoint
    d: pt.ExtPoint


class BatchPk(NamedTuple):
    gr: pt.ExtPoint
    grsk: pt.ExtPoint


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def pks_to_device(pks, device="cuda") -> BatchPk:
    """List of host RistrettoPublicKey -> batched points on device."""
    dev = resolve_device(device)
    return BatchPk(pt.from_exact_batch([pk.gr_point for pk in pks], dev),
                   pt.from_exact_batch([pk.grsk_point for pk in pks], dev))


def comms_to_device(comms, device="cuda") -> BatchCommitment:
    dev = resolve_device(device)
    return BatchCommitment(pt.from_exact_batch([cm.c_point for cm in comms], dev),
                           pt.from_exact_batch([cm.d_point for cm in comms], dev))


def scalars_to_device(scalars, device="cuda") -> torch.Tensor:
    """Python ints mod l -> nibbles int32 [n, 64] on device."""
    return torch.as_tensor(pt.scalars_to_nibbles(scalars), device=resolve_device(device))


# ---------------------------------------------------------------------------
# batched operations (device follows the inputs)
# ---------------------------------------------------------------------------

def generate_commitments(pk: BatchPk, r_nibbles: torch.Tensor,
                         v_nibbles: torch.Tensor) -> BatchCommitment:
    """(c, d) = (r*gr, v*G + r*grsk), batched."""
    c = kp.scalar_mul(r_nibbles, pk.gr)
    gv = kp.base_mul(v_nibbles)
    kh = kp.scalar_mul(r_nibbles, pk.grsk)
    return BatchCommitment(c, pt.add(gv, kh))


def add_commitments(a: BatchCommitment, b: BatchCommitment) -> BatchCommitment:
    return BatchCommitment(pt.add(a.c, b.c), pt.add(a.d, b.d))


def sub_commitments(a: BatchCommitment, b: BatchCommitment) -> BatchCommitment:
    return BatchCommitment(pt.sub(a.c, b.c), pt.sub(a.d, b.d))


def scale_commitments(a: BatchCommitment, nibbles: torch.Tensor) -> BatchCommitment:
    return BatchCommitment(kp.scalar_mul(nibbles, a.c), kp.scalar_mul(nibbles, a.d))


def verify_commitments(comm: BatchCommitment, sk_nibbles: torch.Tensor,
                       v_nibbles: torch.Tensor) -> torch.Tensor:
    """d == v*G + sk*c, batched -> bool[batch]."""
    rhs = pt.add(kp.base_mul(v_nibbles), kp.scalar_mul(sk_nibbles, comm.c))
    return pt.eq(comm.d, rhs)


def update_pks(pk: BatchPk, c_nibbles: torch.Tensor) -> BatchPk:
    """pk' = c * pk (ristretto/keys.rs:146-148), batched."""
    return BatchPk(kp.scalar_mul(c_nibbles, pk.gr), kp.scalar_mul(c_nibbles, pk.grsk))


def update_accounts(pk: BatchPk, comm: BatchCommitment, bl_nibbles: torch.Tensor,
                    update_key_nibbles: torch.Tensor, comm_nibbles: torch.Tensor):
    """Account::update_account (accounts.rs:143-154), batched:
    pk' = c*pk; comm' = Enc_pk(bl; r) + comm."""
    new_pk = update_pks(pk, update_key_nibbles)
    new_comm = generate_commitments(pk, comm_nibbles, bl_nibbles)
    return new_pk, add_commitments(new_comm, comm)


def verify_keypairs(pk: BatchPk, sk_nibbles: torch.Tensor) -> torch.Tensor:
    """grsk == sk * gr (ristretto/keys.rs:187-195), batched."""
    return pt.eq(pk.grsk, kp.scalar_mul(sk_nibbles, pk.gr))
