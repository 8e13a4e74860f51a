"""Key and commitment primitives (host objects)."""

from .elgamal import ElGamalCommitment  # noqa: F401
from .keys import BASE_PK_BTC, RistrettoPublicKey, RistrettoSecretKey  # noqa: F401
