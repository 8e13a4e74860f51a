"""quisquis_tpu_torch: the PyTorch/CUDA port of quisquis_tpu.

Laid out like the JAX package it is ported from:
  ops/          GF(2^255-19) and ristretto255 in torch (the plain versions),
                the scalar field mod l, batched Keccak/STROBE/merlin
                transcripts, the multiscalar multiplication, the CUDA kernel
                wrappers (cuda_point, cuda_keccak) and their loader
                (cuda_build), batched commitments, and its own copy of the
                exact host backend, Keccak and STROBE (pure Python, and the
                C++ curve and STROBE of host_curve and host_strobe, built by
                host_build)
  primitives/   keys, ElGamal commitments, Pedersen generators, zkSchnorr
                signatures (schnorr) and the key protocols (traits)
  accounts/     Account, Merlin transcripts, device-batched account updates,
                host sigma prover and verifier, the device sigma verifiers
                (device_verifier), deferred point checks (deferred), the
                R1CS range-proof gadgets (rangeproof)
  bulletproofs/ host range prover and verifier, R1CS proofs (r1cs); the
                device-batched range verifier (device_verify) and prover
                (device_prove)
  shuffle/      host shuffle prover and verifier; the device-batched shuffle
                verifier (device_verify) and prover (device_prove)
  transaction/  whole transactions: built on the host with their range proofs
                batched on the device (batch_create_transactions), verified
                with their embedded proofs batched on the device
                (batch_verify_transactions)
  utils/        metrics and timers, the wire format (serde), addresses,
                warmup of device shapes
  serving.py    process pools verifying and building transactions, and the
                batched range-proving service
  daemon.py     the resident process that owns the GPU, and its client
  cli.py        the demo CLI (python -m quisquis_tpu_torch.cli)
  config.py     protocol settings (anonymity-set size, range bits)
  csrc/         the CUDA C++ sources, built with nvcc at first use, and the
                host curve and STROBE (host_curve.cpp, host_strobe.cpp, built
                with g++ at first use; ops/host_curve.py, ops/host_strobe.py)

It imports torch and numpy, never jax, and nothing of quisquis_tpu. Public
entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asks for ``"cpu"``.
"""

import importlib as _importlib

#: public name -> the module that defines it, imported at first access, so
#: that a process needing only a light module (a daemon client) loads no
#: CUDA wrapper
_EXPORTS = {
    "Account": ".accounts.accounts",
    "ElGamalCommitment": ".primitives.elgamal",
    "RistrettoPublicKey": ".primitives.keys",
    "RistrettoSecretKey": ".primitives.keys",
    "Receiver": ".transaction.transaction",
    "Sender": ".transaction.transaction",
    "Transaction": ".transaction.transaction",
    "TransactionProof": ".transaction.transaction",
    "batch_create_transactions": ".transaction.transaction",
    "batch_verify_transactions": ".transaction.transaction",
    "create_transaction": ".transaction.transaction",
    "verify_transaction": ".transaction.transaction",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(_importlib.import_module(_EXPORTS[name], __name__), name)


# the host points on the C++ curve library (ops/host_curve.py), where g++
# builds it, now that the package has loaded
from .ops.exact import _try_enable_native as _enable_native_curve  # noqa: E402

_enable_native_curve()
del _enable_native_curve
