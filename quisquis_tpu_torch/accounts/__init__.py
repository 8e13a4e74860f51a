"""Account model, Merlin transcripts and device-batched account updates."""

from .accounts import Account  # noqa: F401
from .transcript import SeededRng, Transcript, TranscriptRng  # noqa: F401
