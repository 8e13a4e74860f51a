"""Account model, Merlin transcripts, device-batched account updates and
the R1CS range-proof gadgets."""

from .accounts import Account  # noqa: F401
from .transcript import SeededRng, Transcript, TranscriptRng  # noqa: F401
from .rangeproof import RangeProofProver, RangeProofVerifier  # noqa: F401
