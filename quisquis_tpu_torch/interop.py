"""Carry state between the JAX package and the port through numpy.

The JAX package stores field elements and scalars as radix 2^11 x 24 int32
limbs; the port stores field elements as radix 2^25.5 x 10 int32
(:mod:`quisquis_tpu_torch.ops.field`) and scalars as radix 2^28 x 10 int64
(:mod:`quisquis_tpu_torch.ops.scalar_field`). These helpers convert through
canonical integers mod p or mod l, on numpy arrays only: this module
imports no JAX.

The range verifier has no learned state; what it keeps between calls is its
static generator points (``DeviceRangeVerifier._static``), which
:func:`ext_point_from_jax` carries across like any other point batch. The
verifiers' inputs are host objects (accounts, sigma, range and shuffle
proofs and statements): :func:`host_object_from_jax` rebuilds them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .device import resolve_device
from .ops import exact as ex
from .ops import field as fe
from .ops import point as pt
from .ops import scalar_field as sf

JAX_BITS = 11
JAX_NLIMBS = 24
_JAX_SHIFTS = np.array([JAX_BITS * i for i in range(JAX_NLIMBS)], dtype=object)


def _ints_from_jax(limbs: np.ndarray) -> np.ndarray:
    """[..., 24] int32 (loose radix 2^11) -> object array [...] of ints mod p."""
    limbs = np.asarray(limbs)
    if limbs.shape[-1] != JAX_NLIMBS:
        raise ValueError(f"expected [..., {JAX_NLIMBS}] limbs, got {limbs.shape}")
    return (limbs.astype(object) << _JAX_SHIFTS).sum(axis=-1) % ex.P


def limbs_from_jax(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX field limbs [..., 24] -> the port's limbs [..., 10] on device."""
    vals = _ints_from_jax(limbs)
    out = fe.from_int_batch(vals.reshape(-1).tolist())
    return fe.to_tensor(out.reshape(vals.shape + (fe.NLIMBS,)), resolve_device(device))


def limbs_to_jax(limbs: torch.Tensor) -> np.ndarray:
    """The port's limbs [..., 10] -> canonical JAX limbs [..., 24] int32."""
    shape = tuple(limbs.shape[:-1])
    vals = np.array(fe.to_int_batch(limbs), dtype=object).reshape(shape)
    digits = (vals[..., None] >> _JAX_SHIFTS) & ((1 << JAX_BITS) - 1)
    return digits.astype(np.int32)


def ext_point_from_jax(coords, device="cuda") -> pt.ExtPoint:
    """(x, y, z, t) numpy arrays [..., 24] -> the port's ExtPoint."""
    return pt.ExtPoint(*(limbs_from_jax(np.asarray(c), device) for c in coords))


def ext_point_to_jax(p: pt.ExtPoint):
    """The port's ExtPoint -> (x, y, z, t) numpy arrays [..., 24]."""
    return tuple(limbs_to_jax(c) for c in p)


def nibbles_from_jax(nibbles: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX nibble digits [..., 64] (same format in both) -> int32 tensor."""
    nib = np.asarray(nibbles, dtype=np.int32)
    if nib.shape[-1] != pt.NWINDOWS or nib.min(initial=0) < 0 or nib.max(initial=0) > 15:
        raise ValueError("expected [..., 64] digits in [0, 16)")
    return torch.as_tensor(np.ascontiguousarray(nib), device=resolve_device(device))


def niels_table_from_jax(table: np.ndarray, device="cuda") -> torch.Tensor:
    """The JAX fixed-base table [3*16*24, 64] (rows (coord, entry, limb),
    columns window) -> the port's layout [64, 16, 3, 10]."""
    t = np.asarray(table).reshape(3, 16, JAX_NLIMBS, pt.NWINDOWS)
    return limbs_from_jax(t.transpose(3, 1, 0, 2), device)


def scalar_limbs_from_jax(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX scalar limbs [..., 24] (loose radix 2^11) -> the port's canonical
    scalar limbs [..., 10] on device."""
    limbs = np.asarray(limbs)
    if limbs.shape[-1] != JAX_NLIMBS:
        raise ValueError(f"expected [..., {JAX_NLIMBS}] limbs, got {limbs.shape}")
    vals = (limbs.astype(object) << _JAX_SHIFTS).sum(axis=-1)
    out = sf.from_int_batch(np.asarray(vals, dtype=object).reshape(-1).tolist())
    return torch.as_tensor(out.reshape(limbs.shape[:-1] + (sf.NLIMBS,)),
                           device=resolve_device(device))


def scalar_limbs_to_jax(limbs: torch.Tensor) -> np.ndarray:
    """The port's scalar limbs [..., 10] (loose allowed) -> canonical JAX
    scalar limbs [..., 24] int32."""
    shape = tuple(limbs.shape[:-1])
    vals = np.array(sf.to_int_batch(limbs), dtype=object).reshape(shape)
    return ((vals[..., None] >> _JAX_SHIFTS) & ((1 << JAX_BITS) - 1)).astype(np.int32)


def keccak_states_from_jax(states: np.ndarray, device="cuda") -> torch.Tensor:
    """JAX Keccak/STROBE states [..., 200] int32 byte values -> uint8 tensor."""
    st = np.asarray(states)
    if st.shape[-1] != 200 or st.min(initial=0) < 0 or st.max(initial=0) > 255:
        raise ValueError("expected [..., 200] byte values")
    return torch.as_tensor(st.astype(np.uint8), device=resolve_device(device))


def keccak_states_to_jax(states: torch.Tensor) -> np.ndarray:
    """The port's uint8 states [..., 200] -> int32 byte values for JAX."""
    return states.cpu().numpy().astype(np.int32)


@functools.lru_cache(maxsize=None)
def _host_classes() -> dict:
    """The port's host dataclasses by class name."""
    from .accounts import prover
    from .bulletproofs import inner_product, r1cs, range_proof
    from .shuffle import ddh, hadamard, multiexponential, product, shuffle, singlevalueproduct
    from .transaction import transaction

    mods = (prover, inner_product, r1cs, range_proof, ddh, hadamard, multiexponential, product,
            shuffle, singlevalueproduct, transaction)
    return {name: cls for mod in mods for name, cls in vars(mod).items()
            if isinstance(cls, type) and dataclasses.is_dataclass(cls)}


def host_object_from_jax(obj):
    """A host object of the JAX package (a proof, a statement, an account,
    lists and tuples of them) -> the same object built from the port's
    classes: dataclasses field by field, by class name; accounts, keys and
    commitments by their bytes; ints and bytes as they are. Reads only the
    object's attributes, so nothing of the JAX package is imported."""
    from .accounts.accounts import Account
    from .primitives.elgamal import ElGamalCommitment
    from .primitives.keys import RistrettoPublicKey

    if isinstance(obj, (int, bytes, str)) or obj is None:
        return obj
    if isinstance(obj, list):
        return [host_object_from_jax(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(host_object_from_jax(o) for o in obj)
    name = type(obj).__name__
    by_bytes = {"Account": Account, "RistrettoPublicKey": RistrettoPublicKey}
    if name in by_bytes:
        return by_bytes[name].from_bytes(obj.as_bytes())
    if name == "ElGamalCommitment":
        return ElGamalCommitment.from_bytes(obj.to_bytes())
    cls = _host_classes().get(name)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no port counterpart for {name}")
    return cls(**{f.name: host_object_from_jax(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})
