"""Read the port's "auto" rules on one GPU: each host backend (the C++
curve underneath) against its device backend, at the shapes where a rule
chooses between them.

    python3 -m quisquis_tpu_torch.auto_rules [--quick]

It prints the card's name and power limit (nvidia-smi), then one line a
reading, host clock, each call synchronised:

1. ``RangeProof.prove_batch``: the host prover's ms a proof (``prove_multiple``,
   median of :data:`HOST_REPS`) and a "device-batched" call's ms
   (``DeviceRangeProver``, median of :data:`DEVICE_REPS` after a first
   call that builds the tables) at 64 bits, m in :data:`RANGE_MS` and
   batch in :data:`RANGE_BATCHES`;
2. ``batch_create_shuffle_proofs``: the host prover's ms a proof and a
   device call's ms at m in :data:`SHUFFLE_MS` and batch in
   :data:`SHUFFLE_BATCHES`;
3. ``batch_verify_shuffle_proofs``: "host" (the replay here and one MSM
   on the C++ curve) against "device-batched", on the same proofs;
4. ``DeferredPointChecks.verify``: "host" against "device" on the
   coalesced terms that ``verify_transaction`` collects from one
   transaction of each shape of :data:`TX_SHAPES` (the accumulator its
   "auto" decides on), on those of 1, 2, 4, ... shuffle proofs of side 8
   and on checks of :data:`FEW_TERMS` terms;
5. ``Signature.batch_verify``: "host", "device" (the host replay and one
   MSM on the card) and "device-batched" (``primitives.device_schnorr``)
   on the same signatures, one distinct key each, at the batches of
   :data:`SCHNORR_BATCHES` (the "auto" rule's count).

Each line ends with the batch from which the device is ahead, if any.
``--quick`` takes the smallest shapes only (a first check of the script).
It needs a CUDA GPU and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import copy
import statistics
import subprocess
import sys
import time

import torch

from .accounts.accounts import Account
from .accounts.deferred import DeferredPointChecks
from .accounts.prover import Prover
from .accounts.transcript import SeededRng, Transcript
from .accounts.verifier import Verifier
from .bulletproofs import device_prove as rdp
from .bulletproofs.range_proof import RangeProof
from .kernel_ab import median_ms
from .ops import exact as ex
from .primitives.schnorr import Signature, VerificationKey
from .primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from .shuffle import device_prove as sdp
from .shuffle.shuffle import Shuffle, ShuffleProof, batch_verify_shuffle_proofs
from .transaction.transaction import create_transaction, verify_transaction
from .transaction.workloads import benchmark_requests

RANGE_BITS = 64
RANGE_MS = (2, 4, 8, 16)
RANGE_BATCHES = (2, 8, 32, 64)
SHUFFLE_MS = (3, 8)
SHUFFLE_BATCHES = (2, 16, 32, 64)
VERIFY_BATCHES = (2, 16, 32, 64)
DEFER_PROOFS = (1, 2, 4, 8, 16, 32, 64)
FEW_TERMS = (8, 64, 128, 192, 256, 512)
#: (senders, accounts) of one transaction: configs 6/6b (1 + 1 over 9),
#: 2 + 2 over 9, 6e (4 + 4 over 16), and 1 + 1 over 64
TX_SHAPES = ((1, 9), (2, 9), (4, 16), (1, 64))
#: signatures a Signature.batch_verify call; 21,845 is BASELINE.json config 3
SCHNORR_BATCHES = (64, 256, 1024, 4096, 21845)
HOST_REPS = 5
DEVICE_REPS = 2


def _ms(fn, reps: int) -> float:
    return median_ms(fn, reps)[0]


def _ahead(host_ms_a_proof: float, device_ms: dict) -> str:
    """The first batch at which one device call beats the host proving or
    verifying the batch one proof at a time."""
    wins = [b for b, d in sorted(device_ms.items()) if d < b * host_ms_a_proof]
    return f"device ahead from batch {wins[0]}" if wins else "host ahead at every batch"


def _per_batch(device_ms: dict) -> str:
    return ", ".join(f"batch {b} {d:.1f} ms ({d / b:.1f} a proof)" for b, d in device_ms.items())


def _range_lane(n_bits: int, m: int, i: int):
    r = SeededRng(seed=b"auto-rules-range-%d-%d" % (m, i))
    values = [int.from_bytes(r.fill_bytes(n_bits // 8), "little") for _ in range(m)]
    return values, [r.random_scalar() for _ in range(m)], r


def read_range(card: str, ms, batches, n_bits=RANGE_BITS, device="cuda") -> None:
    for m in ms:
        def host_call():
            values, blindings, r = _range_lane(n_bits, m, 0)
            RangeProof.prove_multiple(Transcript(b"RangeProof"), values, blindings, n_bits,
                                      rng=r)
        host = _ms(host_call, HOST_REPS)
        device_ms = {}
        for b in batches:
            drp = rdp.DeviceRangeProver(n_bits, m, b, device=device)
            lanes = [_range_lane(n_bits, m, i) for i in range(b)]

            def call():
                drp.prove([v for v, _, _ in lanes], [bl for _, bl, _ in lanes],
                          [copy.deepcopy(r) for _, _, r in lanes])
            call()   # builds the tables
            device_ms[b] = _ms(call, DEVICE_REPS)
        print(f"range prove n={n_bits} m={m}: host {host:.1f} ms a proof; device-batched "
              + _per_batch(device_ms) + f"; {_ahead(host, device_ms)} [{card}]", flush=True)


def _accounts(m: int, r: SeededRng):
    return [Account.generate_account(RistrettoPublicKey.from_secret_key(
        RistrettoSecretKey.random(r), r), r)[0] for _ in range(m * m)]


def _shuffles(m: int, count: int):
    r = SeededRng(seed=b"auto-rules-shuffle-%d" % m)
    accounts = _accounts(m, r)
    return [Shuffle.input_shuffle(accounts, rng=r) for _ in range(count)]


def _host_proof(shuffle, i: int):
    rng = SeededRng(seed=b"auto-rules-proof-%d" % i)
    return ShuffleProof.create_shuffle_proof(
        Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), shuffle, rng=rng)


def _few_term_check(k: int) -> DeferredPointChecks:
    """One check of k terms, the size a sigma or transaction check defers:
    k - 1 random multiples of B and the term that cancels them."""
    checks = DeferredPointChecks(b"auto-rules-few")
    r = SeededRng(seed=b"auto-rules-few-%d" % k)
    ks = [r.random_scalar() for _ in range(k - 1)]
    ws = [r.random_scalar() for _ in range(k - 1)]
    checks.check(ws + [(-sum(w * x for w, x in zip(ws, ks))) % ex.L],
                 [ex.pt_base_mul(x) for x in ks] + [ex.BASEPOINT], "few-term check")
    return checks


def read_shuffle(card: str, ms, batches, verify_batches, defer_proofs, device="cuda") -> list:
    """Prints the shuffle readings; returns the last m's proof entries
    (proof, statement, inputs, outputs) for :func:`read_defer`."""
    entries = []
    for m in ms:
        shuffles = _shuffles(m, max(max(batches), max(verify_batches), max(defer_proofs)))
        host = _ms(lambda: _host_proof(shuffles[0], 0), HOST_REPS)
        device_ms = {}
        for b in batches:
            dsp = sdp.DeviceShuffleProver(m, b, device=device)

            def call():
                dsp.prove(shuffles[:b], [SeededRng(seed=b"auto-rules-proof-%d" % i)
                                         for i in range(b)])
            call()
            device_ms[b] = _ms(call, DEVICE_REPS)
        print(f"shuffle prove m={m}: host {host:.1f} ms a proof; device-batched "
              + _per_batch(device_ms) + f"; {_ahead(host, device_ms)} [{card}]", flush=True)

        n_proofs = max(max(verify_batches), max(defer_proofs))
        entries = []
        for i, sh in enumerate(shuffles[:n_proofs]):
            proof, statement = _host_proof(sh, i)
            entries.append((proof, statement, sh.get_inputs_vector(), sh.get_outputs_vector()))

        def wrapped(b):
            return [(p, Verifier(b"Shuffle", Transcript(b"ShuffleProof")), st, ins, outs)
                    for p, st, ins, outs in entries[:b]]

        times = {}
        for b in verify_batches:
            for backend in ("device-batched", "host"):
                batch_verify_shuffle_proofs(wrapped(b), backend=backend, seed=b"w",
                                            device=device)   # warm
                times[backend, b] = _ms(lambda: batch_verify_shuffle_proofs(
                    wrapped(b), backend=backend, seed=b"w", device=device), DEVICE_REPS)
        host_a_proof = statistics.median(times["host", b] / b for b in verify_batches)
        print(f"shuffle batch verify m={m}: "
              + "; ".join(f"batch {b}: host {times['host', b]:.1f} ms, device-batched "
                          f"{times['device-batched', b]:.1f} ms" for b in verify_batches)
              + f"; {_ahead(host_a_proof, {b: times['device-batched', b] for b in verify_batches})}"
              f" [{card}]", flush=True)
    return entries


def _tx_checks(n_senders: int, n_accounts: int) -> DeferredPointChecks:
    """The accumulator that verify_transaction's "auto" decides on: every
    deferred check of one transaction of n_senders + n_senders values over
    n_accounts accounts."""
    req = benchmark_requests(b"auto-rules-tx-%d-%d" % (n_senders, n_accounts), 1,
                             n_senders, n_accounts)[0]
    tx, proof = create_transaction(**req)
    checks = DeferredPointChecks(b"auto-rules-tx")
    verify_transaction(tx, proof, defer=checks)
    return checks


def read_defer(card: str, entries, defer_proofs, few_terms=FEW_TERMS, tx_shapes=TX_SHAPES,
               device="cuda") -> str:
    """One line of DeferredPointChecks.verify readings, "host" against
    "device", each accumulator's verdict checked by both; returns it."""
    parts = []

    def read(checks, what):
        host_ms = _ms(lambda: checks.verify(backend="host"), HOST_REPS)
        dev_ms = _ms(lambda: checks.verify(backend="device", device=device), HOST_REPS)
        parts.append(f"{checks.num_terms} terms ({what}): host {host_ms:.2f} ms, "
                     f"device {dev_ms:.2f} ms")

    for n_senders, n_accounts in tx_shapes:
        read(_tx_checks(n_senders, n_accounts),
             f"a transaction of {n_senders} + {n_senders} over {n_accounts}")
    for k in defer_proofs:
        checks = DeferredPointChecks(b"auto-rules-defer")
        for p, st, ins, outs in entries[:k]:
            p.verify(Verifier(b"Shuffle", Transcript(b"ShuffleProof")), st, ins, outs,
                     defer=checks)
        read(checks, f"{k} shuffle proofs")
    for k in few_terms:
        read(_few_term_check(k), "multiples of B")
    line = "DeferredPointChecks.verify: " + "; ".join(parts) + f" [{card}]"
    print(line, flush=True)
    return line


def _signatures(count: int) -> list:
    """(signature, transcript, key) x count, each by its own key over a
    transcript of one label."""
    r = SeededRng(seed=b"auto-rules-schnorr")
    out = []
    for _ in range(count):
        sk = r.random_scalar()
        vk = VerificationKey.from_secret(sk, r.random_scalar())
        t = Transcript(b"auto-rules-schnorr")
        out.append((Signature.sign(t.clone(), vk, sk, rng=r), t, vk))
    return out


def read_schnorr(card: str, batches=SCHNORR_BATCHES, device="cuda") -> str:
    """One line of Signature.batch_verify readings on each backend, each
    call on fresh clones of the transcripts (made before the clock starts);
    returns it."""
    items = _signatures(max(batches))
    parts, ahead = [], []
    for b in batches:
        ms = {}
        for backend in ("host", "device", "device-batched"):
            walls = []
            for _ in range(1 + DEVICE_REPS):   # the first call warms the shape
                batch = [(s, t.clone(), v) for s, t, v in items[:b]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Signature.batch_verify(batch, backend=backend, seed=b"auto-rules", device=device)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms[backend] = statistics.median(walls[1:])
        if ms["device-batched"] < min(ms["host"], ms["device"]):
            ahead.append(b)
        parts.append(f"batch {b}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()))
    line = ("Signature.batch_verify: " + "; ".join(parts) + "; "
            + (f"device-batched ahead from batch {ahead[0]}" if ahead
               else "device-batched ahead at no batch") + f" [{card}]")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the smallest shapes only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("auto_rules: no CUDA GPU is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if not ex.NATIVE_CURVE:
        print("auto_rules: the C++ host curve is not in use", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.quick:
        read_range(card, (2,), (2,))
        read_defer(card, read_shuffle(card, (3,), (2,), (2,), (1, 2)), (1, 2), (8,),
                   TX_SHAPES[:1])
        read_schnorr(card, SCHNORR_BATCHES[:1])
    else:
        read_range(card, RANGE_MS, RANGE_BATCHES)
        read_defer(card, read_shuffle(card, SHUFFLE_MS, SHUFFLE_BATCHES, VERIFY_BATCHES,
                                      DEFER_PROOFS), DEFER_PROOFS)
        read_schnorr(card)
    print(f"auto_rules: done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
