"""Bulletproofs: generators, inner-product argument, range proofs, R1CS
proofs, and the batched range verifier and prover on the device."""

# the accounts package first: its R1CS gadgets (accounts/rangeproof.py) import
# r1cs, which needs inner_product whole, and inner_product imports the
# accounts' transcripts
from .. import accounts as _accounts  # noqa: F401
from .generators import BulletproofGens, bulletproof_gens  # noqa: F401
from .inner_product import InnerProductProof  # noqa: F401
from .r1cs import R1CSProof, R1CSProver, R1CSVerifier  # noqa: F401
from .range_proof import RangeProof  # noqa: F401
from .device_prove import DeviceRangeProver, get_device_range_prover  # noqa: F401
