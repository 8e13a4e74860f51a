"""Field and point arithmetic, the CUDA kernel wrappers, batched
commitments, and the exact host backend (with Keccak/STROBE)."""
