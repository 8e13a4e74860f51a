"""Multi-process transaction-verification and proving services (the
serving path).

The reference library has no serving story at all: its (dead) transaction
module only self-verifies during creation (reference
src/transaction/transaction.rs:487-749). This module is the
production-deployment counterpart: persistent pools of worker *processes*
that verify wire-format transactions and shuffle proofs, or build
transactions, in parallel, and a batched range-proving service on the card.

Why processes and not threads: a transaction verification replays sigma and
shuffle transcripts on the host, and its wall-clock is dominated by
Python-side orchestration (scalar arithmetic mod l, transcript framing,
ctypes marshalling) that holds the GIL; threads cannot scale it, processes
can. Each worker chunk collects all of its point-identity checks into one
random-weighted MSM (accounts.deferred), so a pool of W workers evaluates W
MSMs instead of per-check small ones, or exports its terms so that the
parent evaluates one merged MSM.

Transactions cross the process boundary in the framework's wire format
(utils/serde.py, byte for byte the JAX package's), which doubles as an
end-to-end exercise of the deserialization validation path: exactly what a
network-facing verifier service would execute.

Workers are host-only by design: they never touch torch.cuda. Every call
they make names its host backend (``backend="host"``, ``defer=``,
``device="cpu"`` where an argument defaults to the card), because the C++
host curve (csrc/host_curve.cpp) is the right tool for the many small MSMs
of transcript replay; the card owns the large batched kernels, driven from
the parent (the merged MSM of "device", the "device-batched" verifiers, the
range prover).
"""

from __future__ import annotations

import concurrent.futures as _cf
import hashlib
import itertools
import multiprocessing as _mp
import os
from typing import List, Optional, Sequence, Tuple

from .utils.metrics import metrics, span

#: what the forkserver imports once, before it forks any worker: the C++
#: curve and STROBE and the host verifiers and provers
_PRELOAD = ["quisquis_tpu_torch", "quisquis_tpu_torch.transaction.transaction",
            "quisquis_tpu_torch.utils.serde"]

_BACKENDS = ("host", "device", "merged-host", "device-batched")


def _pool_context():
    """Start-method selection for worker pools: ``forkserver``, or ``spawn``
    where the platform has no forkserver; never ``fork``.

    The JAX package forks when JAX is not loaded. Here the parent may hold
    a CUDA context, which a forked child cannot use and whose runtime
    threads may hold locks at fork time, and any process that has imported
    JAX holds XLA's threads; forking either can hang a child. A forkserver
    is a clean process started once: it imports the package (the C++ curve
    and STROBE, built under ``host_build.build_lock``) before it forks any
    worker, so workers start warm without inheriting the parent's state.
    """
    if "forkserver" in _mp.get_all_start_methods():
        ctx = _mp.get_context("forkserver")
        ctx.set_forkserver_preload(_PRELOAD)
        return ctx
    return _mp.get_context("spawn")


WirePair = Tuple[bytes, bytes]  # (transaction bytes, proof bytes)


def _prepare_device(backend_uses_device: bool, device):
    """The service's resolved device where its backend runs on it (the
    default raises without a GPU), with the kernels built there; else the
    device as given, unresolved (host backends never touch it)."""
    if not backend_uses_device:
        return device
    from .device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from .ops import cuda_build

        cuda_build.load_library()
    return dev


def serialize_transaction(tx, proof) -> WirePair:
    """Encode a (Transaction, TransactionProof) pair to wire bytes."""
    from .utils import serde

    return (serde.transaction_to_bytes(tx),
            serde.transaction_proof_to_bytes(proof))


def _verify_chunk(pairs: List[WirePair], seed: bytes) -> int:
    """Worker entry: deserialize and verify a chunk of wire transactions.

    Raises ValueError (propagated to the caller's future) on the first
    invalid transaction or malformed wire blob; returns the count verified.
    """
    from .utils import serde
    from .transaction.transaction import batch_verify_transactions

    items = [(serde.transaction_from_bytes(txb),
              serde.transaction_proof_from_bytes(pfb))
             for txb, pfb in pairs]
    batch_verify_transactions(items, backend="host", seed=seed, device="cpu")
    return len(items)


def _collect_tx_chunk(pairs: List[WirePair], seed: bytes):
    """Worker entry (collect mode): replay transcripts for a chunk of wire
    transactions, but DON'T evaluate the final MSM: export the weighted
    point-identity terms so the parent can fold every chunk into ONE MSM.

    Eager sigma checks (first-message recomputations that feed the
    transcript) still run here; only the deferred heavy checks export.
    """
    from .utils import serde
    from .transaction.transaction import verify_transaction_auto
    from .accounts.deferred import DeferredPointChecks

    defer = DeferredPointChecks(seed)
    for txb, pfb in pairs:
        verify_transaction_auto(serde.transaction_from_bytes(txb),
                                serde.transaction_proof_from_bytes(pfb),
                                defer=defer, backend="host", device="cpu")
    return defer.export_wire()


def _collect_shuffle_chunk(blobs: List[bytes], seed: bytes,
                           proof_label: bytes, transcript_label: bytes):
    """Worker entry (collect mode) for standalone shuffle proofs."""
    from .utils import serde
    from .accounts.transcript import Transcript
    from .accounts.verifier import Verifier
    from .accounts.deferred import DeferredPointChecks

    defer = DeferredPointChecks(seed)
    for blob in blobs:
        proof, statement, inputs, outputs = serde.shuffle_entry_from_bytes(blob)
        verifier = Verifier(proof_label, Transcript(transcript_label))
        proof.verify(verifier, statement, inputs, outputs, defer=defer)
    return defer.export_wire()


class _PoolService:
    """Shared machinery: worker pool, per-request weight seeds, and the
    collect-and-merge verification drive."""

    def __init__(self, workers: Optional[int] = None,
                 seed: Optional[bytes] = None, backend: str = "host",
                 device="cuda"):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown serving backend {backend!r}")
        self.workers = workers or (os.cpu_count() or 1)
        self.backend = backend
        # the device backends resolve the device (the default raises
        # without a GPU) and build the kernels before the pool starts
        self.device = _prepare_device(backend in ("device", "device-batched"), device)
        # `seed` pins the weight streams for tests only; a production
        # verifier must leave it None so weights stay unpredictable
        self._seed = bytes(seed) if seed is not None else None
        self._request_ctr = itertools.count()
        self._pool = _cf.ProcessPoolExecutor(max_workers=self.workers,
                                             mp_context=_pool_context())

    def _chunk_seed(self, index: int) -> bytes:
        """Weight-stream seed for one chunk of one request.

        The random-linear-combination soundness argument (accounts.deferred)
        assumes verification weights are drawn fresh per verification; a
        long-lived service must therefore never replay a weight stream
        across requests. Every call mixes a monotone request counter and,
        unless a test pinned the seed, fresh OS entropy.
        """
        request = next(self._request_ctr)
        base = self._seed if self._seed is not None else os.urandom(32)
        return hashlib.sha512(base + b"chunk"
                              + request.to_bytes(8, "little")
                              + index.to_bytes(8, "little")).digest()[:32]

    def _drive(self, worker_fn, chunks, extra_args=()) -> int:
        """Submit chunks; either count successes (host mode, workers verify
        their own MSM) or absorb exported terms and evaluate ONE MSM here
        (device / merged-host modes). The merged MSM's term count and time
        go to utils.metrics ("serving.merged_terms",
        "serving.merged_msm.<host|device>")."""
        collect = self.backend != "host"
        futures = [self._pool.submit(worker_fn, c, self._chunk_seed(i),
                                     *extra_args)
                   for i, c in enumerate(chunks)]
        total = 0
        defer = None
        if collect:
            from .accounts.deferred import DeferredPointChecks

            # absorb-only accumulator: every imported term already carries
            # its own unpredictable weight from the worker's stream
            defer = DeferredPointChecks(b"\x00" * 32)
        first_invalid = None   # ValueError: a proof failed to verify
        first_broken = None    # anything else: crashed worker, hostile blob
        for i, (f, chunk) in enumerate(zip(futures, chunks)):
            try:
                if collect:
                    sbuf, pbuf, labels = f.result()
                    defer.absorb_wire(sbuf, pbuf, labels)
                    total += len(chunk)
                else:
                    total += f.result()
            except ValueError as e:
                first_invalid = first_invalid or ValueError(f"chunk {i}: {e}")
            except Exception as e:  # noqa: BLE001 - attribute, drain, re-raise
                first_broken = first_broken or RuntimeError(
                    f"chunk {i}: {type(e).__name__}: {e}")
        if first_invalid is not None:
            raise first_invalid
        if first_broken is not None:
            raise first_broken
        if collect:
            where = "device" if self.backend == "device" else "host"
            metrics.count("serving.merged_terms", defer.num_terms)
            with span(f"serving.merged_msm.{where}"):
                defer.verify(backend=where, device=self.device)
        return total

    def warmup(self, shapes) -> None:
        """Warm device shape buckets at service start so the first request
        runs at steady-state latency (utils.warmup, on this service's
        device). `shapes`: its shape descriptors, e.g. [("shuffle", 3, 16),
        ("range", 64, 1, 16)]."""
        from .utils.warmup import warmup as _warmup

        _warmup(shapes, device=self.device)

    def close(self) -> None:
        # waits for the workers to exit, so a closed service leaves no process
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class VerificationService(_PoolService):
    """Persistent process pool verifying wire-format transactions.

    Usage::

        svc = VerificationService(workers=4, backend="host")
        svc.verify_wire(pairs)          # [(tx_bytes, proof_bytes), ...]
        svc.verify(items)               # [(Transaction, TransactionProof)]
        svc.close()                     # or use as a context manager

    `backend` selects where the heavy point checks evaluate:
      - "host": each worker verifies its chunk end-to-end (one C++ host
        MSM per chunk).
      - "device": workers replay transcripts and export their weighted
        point-identity terms; the parent folds every chunk into ONE MSM
        on `device` (the three MSM kernels).
      - "merged-host": like "device" but the single merged MSM runs on
        the host's C++ curve (for apples-to-apples comparison).
      - "device-batched": the embedded shuffle and range proofs of every
        transaction run as batched device verifications on `device`
        (batched transcript replay, challenge arithmetic and MSM on the
        card, shape-bucketed verifier instances); the host only advances
        transcripts and runs the small sigma checks. The worker pool is
        not used: the card replaces it as the parallel resource.
    There is no "auto", as in the JAX package. `device` is resolved (the
    default raises without a GPU) and the kernels built in ``__init__``
    for "device" and "device-batched"; the host backends ignore it.

    Accepts everything or raises ValueError naming the failing chunk; the
    soundness argument is the same random-linear-combination MSM batching
    as batch_verify_transactions, with an independent weight seed per chunk
    and per request.
    """

    @span("serving.verify_wire")
    def verify_wire(self, pairs: Sequence[WirePair]) -> int:
        """Verify wire-format transactions across the pool; returns count."""
        pairs = list(pairs)
        if not pairs:
            return 0
        if self.backend == "device-batched":
            from .utils import serde
            from .transaction.transaction import batch_verify_transactions

            with span("serving.decode"):
                items = [(serde.transaction_from_bytes(txb),
                          serde.transaction_proof_from_bytes(pfb))
                         for txb, pfb in pairs]
            batch_verify_transactions(items, backend="device-batched",
                                      seed=self._chunk_seed(0), device=self.device)
            return len(items)
        nchunks = min(self.workers, len(pairs))
        chunks = [pairs[i::nchunks] for i in range(nchunks)]
        worker = _verify_chunk if self.backend == "host" else _collect_tx_chunk
        return self._drive(worker, chunks)

    def verify(self, items) -> int:
        """Verify in-memory (Transaction, TransactionProof) pairs."""
        return self.verify_wire([serialize_transaction(tx, pf)
                                 for tx, pf in items])


class ShuffleVerificationService(_PoolService):
    """Process-pool verification of standalone shuffle proofs (config 5c
    serving twin): workers replay the GIL-bound transcript schedule in
    parallel and the merged point checks ride one MSM (on the card by
    default). "device-batched" runs the batched device verifier instead
    of the pool.

    Wire items come from `utils.serde.shuffle_entry_to_bytes`, or pass
    in-memory (proof, statement, inputs, outputs) tuples to `verify`.
    """

    def __init__(self, workers: Optional[int] = None,
                 seed: Optional[bytes] = None, backend: str = "device",
                 proof_label: bytes = b"Shuffle",
                 transcript_label: bytes = b"ShuffleProof", device="cuda"):
        if backend == "host":
            raise ValueError(
                "ShuffleVerificationService is collect-mode only; "
                "use backend='merged-host' for a host-side final MSM")
        super().__init__(workers, seed, backend, device)
        self.proof_label = bytes(proof_label)
        self.transcript_label = bytes(transcript_label)

    def verify_wire(self, blobs: Sequence[bytes]) -> int:
        blobs = list(blobs)
        if not blobs:
            return 0
        if self.backend == "device-batched":
            from .utils import serde
            from .accounts.transcript import Transcript
            from .accounts.verifier import Verifier
            from .shuffle.device_verify import device_batch_verify

            entries = [serde.shuffle_entry_from_bytes(b) for b in blobs]
            transcripts = []
            for _ in entries:
                t = Transcript(self.transcript_label)
                Verifier(self.proof_label, t)   # appends the proof dom-sep
                transcripts.append(t)
            device_batch_verify(entries, transcripts=transcripts, device=self.device)
            return len(entries)
        nchunks = min(self.workers, len(blobs))
        chunks = [blobs[i::nchunks] for i in range(nchunks)]
        return self._drive(_collect_shuffle_chunk, chunks,
                           (self.proof_label, self.transcript_label))

    def verify(self, entries) -> int:
        """entries: (proof, statement, input accounts, output accounts)."""
        from .utils import serde

        return self.verify_wire([serde.shuffle_entry_to_bytes(*e)
                                 for e in entries])


class BuildRequest:
    """Wire-friendly transaction-build request (picklable across workers).

    Fields mirror the inputs of transaction.create_transaction for the
    common single-sender/single-receiver transfer; the anonymity set is
    padded to `n` with fresh zero-balance accounts inside the worker
    (transaction.rs:103-164 semantics).

    SECURITY NOTE: `sender_sk` carries the raw secret scalar. This request
    format is an *intra-host* IPC payload between a wallet process and its
    co-located proving pool; it is NOT a network protocol. Never send a
    BuildRequest across a machine boundary; a remote proving service needs
    a different design in which secrets stay client-side (e.g. the client
    computes the sigma responses and delegates only the public MSM work).
    """

    __slots__ = ("sender_account", "sender_sk", "amount", "receiver_pk",
                 "sender_updated_balance", "n", "seed")

    def __init__(self, sender_account: bytes, sender_sk: bytes, amount: int,
                 receiver_pk: bytes, sender_updated_balance: int, n: int = 9,
                 seed: Optional[bytes] = None):
        self.sender_account = bytes(sender_account)  # 128-byte account wire
        self.sender_sk = bytes(sender_sk)            # 32-byte scalar
        self.amount = int(amount)
        self.receiver_pk = bytes(receiver_pk)        # 64-byte dual-point pk
        self.sender_updated_balance = int(sender_updated_balance)
        self.n = int(n)
        self.seed = seed

    def __getstate__(self):
        return tuple(getattr(self, s) for s in self.__slots__)

    def __setstate__(self, state):
        for s, v in zip(self.__slots__, state):
            setattr(self, s, v)


def _build_chunk(reqs: List[BuildRequest], seed: bytes) -> List[WirePair]:
    """Worker entry: build (prove + self-verify, on the host) a chunk of
    transactions and return them in wire format."""
    from .accounts.accounts import Account
    from .accounts.transcript import SeededRng
    from .ops import exact as ex
    from .primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from .transaction.transaction import (
        Sender, Receiver, create_transaction,
        generate_value_and_account_vector)

    out: List[WirePair] = []
    for i, req in enumerate(reqs):
        rng = SeededRng(seed=(req.seed if req.seed is not None else
                              seed + i.to_bytes(8, "little")))
        account = Account.from_bytes(req.sender_account)
        # NOT RistrettoSecretKey.from_bytes: that is the reference's
        # hash-to-scalar derivation (keys.rs:45), not a deserializer;
        # here the wire carries the canonical scalar bytes themselves
        sk = RistrettoSecretKey(ex.sc_from_bytes_mod_order(req.sender_sk))
        rec_pk = RistrettoPublicKey.from_bytes(req.receiver_pk)
        sender = Sender(total_amount=-req.amount, account=account,
                        receivers=[Receiver(req.amount, rec_pk)])
        values, accounts, anon, diff, sc, rc = \
            generate_value_and_account_vector([sender], rng=rng, n=req.n)
        tx, proof = create_transaction(
            values, accounts,
            sender_updated_balance=[req.sender_updated_balance],
            sender_sk=[sk], anonymity_comm_scalar=anon,
            anonymity_account_diff=diff,
            receiver_updated_balance=[req.amount],
            senders_count=sc, receivers_count=rc, rng=rng)
        out.append(serialize_transaction(tx, proof))
    return out


class SignatureVerificationService:
    """Verification of zkSchnorr signed messages (BASELINE.json config 3: a
    validator checks the signature of every account that authorises a
    spend; reference src/transaction/signature.rs:83-137).

    Wire items are ``utils.serde.signed_message_to_bytes`` records, each
    a signature by its key over ``(label, message)`` with messages of
    ``message_len`` bytes. `backend`: "device-batched" runs the whole call
    as one device program (``primitives.device_schnorr``: transcripts,
    decodes, scalar arithmetic and one MSM of three terms a signature on
    `device`), its input cut from the joined records by numpy; "host"
    replays each transcript here and checks the batch with one MSM on the
    C++ curve (``Signature.batch_verify(backend="host")``). No processes
    are spawned. `device` is resolved (the default raises without a GPU)
    and the kernels built in ``__init__`` for "device-batched".

    ``verify_wire`` accepts a call whole or raises ValueError.
    """

    def __init__(self, backend: str = "device-batched", *, label: bytes, message_len: int = 32,
                 seed: Optional[bytes] = None, device="cuda"):
        if backend not in ("device-batched", "host"):
            raise ValueError(f"unknown signature backend {backend!r}")
        self.backend = backend
        self.label = bytes(label)
        self.message_len = int(message_len)
        # `seed` pins the weights for tests only, as in _PoolService
        self._seed = bytes(seed) if seed is not None else None
        self._ctr = itertools.count()
        self.device = _prepare_device(backend == "device-batched", device)

    def _call_seed(self) -> Optional[bytes]:
        if self._seed is None:
            return None
        return hashlib.sha512(self._seed + b"sig" + next(self._ctr).to_bytes(8, "little")
                              ).digest()[:32]

    @span("serving.schnorr.verify_wire")
    def verify_wire(self, blobs: Sequence[bytes]) -> int:
        """Verify signed-message records; returns their count. The span
        ``serving.schnorr.decode`` holds the host's cut of the records, and
        ``serving.schnorr.verify_wire``'s own time the rest of the host's
        part (the release of the call's buffers)."""
        import numpy as np

        from .utils import serde

        width = serde.SIGNED_MESSAGE_HEAD + self.message_len
        with span("serving.schnorr.decode"):
            if not len(blobs):
                return 0
            if set(map(len, blobs)) != {width}:
                raise ValueError(f"a signed message is not {width} bytes")
            if self.backend == "device-batched":
                rec = np.frombuffer(b"".join(blobs), np.uint8).reshape(len(blobs), width)
            else:
                items = [serde.signed_message_from_bytes(b, self.message_len) for b in blobs]
        if self.backend == "device-batched":
            from .primitives.device_schnorr import verify_messages

            if not verify_messages(self.label, rec[:, 0:32], rec[:, 32:64], rec[:, 64:96],
                                   rec[:, 96:128], rec[:, 128:], seed=self._call_seed(),
                                   device=self.device):
                raise ValueError("Batched signature verification failed")
            return len(blobs)
        from .primitives.schnorr import Signature

        Signature.batch_verify([(sig, Signature._transcript_for_message(self.label, msg), vk)
                                for vk, sig, msg in items], backend="host",
                               seed=self._call_seed(), device="cpu")
        return len(items)

    def close(self) -> None:
        """Nothing to release (no pool): for the services' common use."""

    def __enter__(self) -> "SignatureVerificationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RangeProvingService:
    """Batched range-proof proving service (the prove-side device path).

    Collects independent (values, blindings) requests and proves them as
    lane batches through ``RangeProof.prove_batch`` with this service's
    `backend` and `device`: "device-batched" proves each shape bucket in
    one call of the device prover (bit commitments, challenge transcripts,
    the inner-product folds on the card), byte-identical to the host
    prover under the same rng streams; "auto" takes prove_batch's rule
    (read on the H100); "host" proves one lane at a time. The card
    replaces a worker pool as the parallel resource; no processes are
    spawned. `device` is resolved (the default raises without a GPU) and
    the kernels built in ``__init__`` for "auto" and "device-batched".

    Reference prove path: reference src/accounts/prover.rs:544-591 (one
    proof at a time, host only).
    """

    def __init__(self, n_bits: int = 64, backend: str = "auto",
                 seed: Optional[bytes] = None, device="cuda"):
        if backend not in ("auto", "host", "device-batched"):
            raise ValueError(f"unknown proving backend {backend!r}")
        self.n_bits = n_bits
        self.backend = backend
        self._seed = bytes(seed) if seed is not None else None
        self._ctr = itertools.count()
        self.device = _prepare_device(backend in ("auto", "device-batched"), device)

    def warmup(self, m: int, batch: int) -> None:
        """Warm the (n_bits, m, batch) prover bucket on this service's
        device."""
        from .utils.warmup import warmup as _warmup

        _warmup([("range-prove", self.n_bits, m, batch)], device=self.device)

    def prove(self, requests):
        """requests: iterable of (values, blindings) with len(values) a
        power of two. Returns [(RangeProof, V_bytes_list)] in order."""
        from .accounts.transcript import SeededRng, Transcript
        from .bulletproofs.range_proof import RangeProof

        requests = list(requests)
        if not requests:
            return []
        req_id = next(self._ctr)
        lanes = []
        for i, (vals, blinds) in enumerate(requests):
            if self._seed is None:
                rng = SeededRng()
            else:
                rng = SeededRng(seed=hashlib.sha512(
                    self._seed + b"prove" + req_id.to_bytes(8, "little")
                    + i.to_bytes(8, "little")).digest()[:32])
            lanes.append((Transcript(b"RangeProof"), list(vals),
                          list(blinds), rng))
        return RangeProof.prove_batch(lanes, self.n_bits,
                                      backend=self.backend, device=self.device)


class ProvingService:
    """Persistent process pool *building* transactions (prove-side twin of
    VerificationService; same GIL rationale), on the host. Returns
    wire-format pairs in request order, each already self-verified by
    create_transaction."""

    def __init__(self, workers: Optional[int] = None,
                 seed: Optional[bytes] = None):
        self.workers = workers or (os.cpu_count() or 1)
        self._seed = os.urandom(32) if seed is None else bytes(seed)
        self._pool = _cf.ProcessPoolExecutor(max_workers=self.workers,
                                             mp_context=_pool_context())

    def build(self, requests: Sequence[BuildRequest]) -> List[WirePair]:
        requests = list(requests)
        if not requests:
            return []
        nchunks = min(self.workers, len(requests))
        chunks = [requests[i::nchunks] for i in range(nchunks)]
        seeds = [hashlib.sha512(self._seed + b"build"
                                + i.to_bytes(8, "little")).digest()[:32]
                 for i in range(nchunks)]
        futures = [self._pool.submit(_build_chunk, c, s)
                   for c, s in zip(chunks, seeds)]
        results = [f.result() for f in futures]
        # un-interleave back to request order
        out: List[Optional[WirePair]] = [None] * len(requests)
        for i, chunk_out in enumerate(results):
            out[i::nchunks] = chunk_out
        return out  # type: ignore[return-value]

    def close(self) -> None:
        # waits for the workers to exit, so a closed service leaves no process
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "ProvingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
