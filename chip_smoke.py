#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (quisquis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. require a CUDA GPU; print its name and power limit (nvidia-smi);
  2. build the eight CUDA kernels (seven sources) from csrc/ (nvcc, at
     first use) and check that the host transcripts use the C++ STROBE
     (csrc/host_strobe.cpp, built with g++ at the transcripts' first
     import) and that ops/exact.py does the host points on the C++ curve
     (csrc/host_curve.cpp, built with g++ at the package's import);
     meanwhile four worker processes make four aggregated range proofs
     (n = 64, m = 16) with the port's host prover, timed (the generators
     made first), and check each with the host verifier; they are done
     before phase 6;
  3. hold each kernel against its plain PyTorch version on the card at
     B = 256, limb for limb (edge scalars included: integers up to
     2^256 - 1, for scalar_mul also the identity and points with
     8-torsion), and 14 and 11 rows against the exact backend;
  4. the main path at N = 16,384 accounts: keys made on the card, the
     flagship step (generate + verify commitments), update_accounts, then
     verify_commitments and verify_keypairs on the updated state; one
     tampered lane must fail alone; 32 sampled lanes against exact.py;
  5. the Account-object path on 1,024 Accounts built from phase 4's wire
     bytes: update_accounts_device and delta/epsilon creation, 16 rows
     byte-identical to the host Account methods; the launches of both,
     the codec's included (8 encodes, no decode);
  6. each kernel's phase-4 output at N = 16,384, and a launch on its first
     1,024 lanes (phase 5's width), limb for limb against the plain version
     on the same inputs; times on this card: each kernel and its plain
     version at N = 16,384, end-to-end account updates per second;
  7. the MSM kernels (table, window sums, tail) and the Keccak kernel
     against their plain versions on the card, limb for limb and byte for
     byte: table at 256 points, window sums and tail at N = 300 and in rows
     mode at R = 8, k = 200, both MSMs also against the exact backend, the
     permutation at B = 1, 64, 1,000 also against the host permutation;
 7b. the ristretto codec kernels (decode, encode) against their plain
     versions on the card at the benchmark cells' shapes: ok for ok, limb
     for limb and byte for byte on valid and invalid encodings, one launch
     a call, rows against exact.py; CUDA-event times beside the plain
     versions', the wrapper's host time a call and the bound;
  8. the range verifier at full width: DeviceRangeVerifier(n=64, m=16,
     batch=64), one MSM of 4,610 points. The 64 lanes repeat the four
     proofs, each lane with its own random weights. The honest batch
     verifies; a batch with one byte flipped in one lane (a point, a scalar,
     an inner-product element, a value commitment in turn) is rejected; the
     launch counters of that one verify call show the four kernels ran;
  9. the four kernels at the verifier's own MSM and transcript shapes
     against their plain versions, and times on this card: each kernel and
     its plain version (msm_table and keccak_f1600, launches of tens of
     microseconds or less, by replaying a CUDA graph of back-to-back
     launches; their time through the wrapper, host enqueue included, on a
     line of its own), msm_tail's and Keccak's chain floors, verify wall
     time and proofs per second, the device's busy share over one profiled
     call;
 10. the sigma and shuffle proofs for phases 10, 11 and 13 from the port's
     host prover in six worker processes, started only now and waited for
     here, so that no prover shares the host with a timed call; then the sigma verifiers
     (accounts/device_verifier.py) at n = 64 and n = 1,024 of phase 5's
     Accounts: delta-compact and zero-balance proofs, honest proofs
     accepted, zv + 1 and z + 1 rejected, the device's e/f encodings equal
     to the host Verifier's recomputation byte for byte (every row at 64,
     64 sampled rows at 1,024), the kernels launched on the card; wall time
     of each call;
 11. the shuffle verifier at full width: DeviceShuffleVerifier(m=8,
     batch=16) on 16 distinct proofs over one 64-account anonymity set
     (phase 10's workers made them): the honest batch verifies, replayed
     from the CUDA graphs that warmup() captured (only the two MSMs'
     stages are launched), and on a fresh verifier's eager first call
     (every kernel launched); one lane
     tampered (a point, a Hadamard scalar, the DDH response, a
     multi-exponentiation commitment, the product statement, swapped
     accounts) is rejected by the device and by the host verifier;
     device_batch_verify on 5 proofs runs as a bucket of 8 and verifies;
     DeviceShuffleVerifier(m=3, batch=16) verifies too. The kernels at the
     verifier's own shapes against their plain versions (scalar_mul over
     the B (3m + 3) product lanes, the MSM stages on the [6B, N + 1] rows and
     on the final check's points, Keccak on the transcript states); times:
     the median of 7 verifies, one profiled call's busy share and kernel
     count, each kernel's launches per verify and device time by graph
     replay, batch_verify_shuffle_proofs by "host", "device" and
     "device-batched", and DeferredPointChecks "host" against "device" on
     the same terms, on one proof's terms and on a few-term check;
 12. range proving at full width: DeviceRangeProver(n=64, m=16, batch=32),
     benchmarks.py row 4e. Lanes 0-3 replay phase 2's rng streams and equal
     the host prover's proofs byte for byte; all 32 proofs are accepted by
     phase 8's verifier (the 32 twice) and one flipped byte is rejected;
     RangeProof.prove_batch("device-batched") on 5 lanes runs as a bucket
     of 8, equals the prover's proofs and advances the host transcripts.
     The kernels at the prover's shapes against their plain versions
     (msm_table on the cached basis, msm_acc and msm_tail on the V/A/S
     rows, the T rows and an inner-product round, Keccak on its states);
     times: each kernel's launches a prove and device time by graph
     replay, the median of 5 proves, host packing apart, the prover at
     batch 2, the host prover's time a proof, one profiled call;
 13. shuffle proving at full width: DeviceShuffleProver(m=8, batch=16) on
     phase 10's 16 shuffles, each lane's rng copied just before its host
     proof: all 16 proofs and statements equal the host prover's field for
     field and phase 11's verifier accepts them; m = 3 likewise;
     batch_create_shuffle_proofs("device-batched") on 5 shuffles runs as a
     bucket of 8. The kernels on the prover's largest rows call and Keccak
     on its states against their plain versions; times as in phase 12;
 14. transaction building at benchmarks.py config 6e's width: 16
     transactions of 4 senders and 4 receivers over 16 accounts by
     batch_create_transactions, their range proofs as one
     DeviceRangeProver(64, 8, 16) call ("device-batched") and on the host;
     the two equal byte for byte and every transaction verifies; the four
     MSM and Keccak kernels against their plain versions at that prover's
     shapes; one ristretto_encode launch for V/A/S, one for T and one for
     each inner-product round's L/R (the kernels line's count); times: the
     median of 3 builds by each range backend, the range proving apart,
     launches, each kernel's bound summed over one build's launches, one
     profiled build;
 15. batch verification: 32 transactions of config 6/6b (1 + 1 over 9
     accounts) and 4 over 64 accounts by batch_verify_transactions,
     accepted by "device-batched" (the collector's shuffle groups by shape
     and frame, the range groups, the deferred sigma MSM on the card) and
     by "host"; each of six tamperings of one transaction rejected by both
     (two of them only the device verifiers read: the host part accepts);
     one ristretto_decode launch a shuffle and a range verifier call and
     one ristretto_encode a shuffle verifier call (the kernels line's
     decode count); the five kernels against their plain versions at the
     verifiers' shapes; times: the median of 3 calls of each backend on
     this batch and on phase 14's, launches, each kernel's bound summed
     over one call's launches, one profiled call;
 16. the serving layer at the deployments users run, with os.cpu_count()
     worker processes: ShuffleVerificationService on phase 11's 16 proofs as
     wire entries (row 5d) and VerificationService on phase 15's 32
     transactions of config 6/6b as wire pairs (row 6c), each backend
     accepting and rejecting a tampered and a truncated request (naming the
     chunk where a pool verifies), medians of 3, the merged MSM's term count
     and time; no worker initialized CUDA; ProvingService on 16 build
     requests (row 6d) equal to an in-process _build_chunk replay and
     verified; RangeProvingService at row 4e on device-batched, lanes 0-3
     equal to the host service's, all 32 verified; Signature.batch_verify of
     21,845 signatures (65,535 terms, BASELINE.json config 3) on "device",
     "device-batched" (the whole verification one device program) and
     "host", a forged s rejected by all three, each call's ms and its
     MSM's share printed; the merged and Schnorr MSMs
     held to the plain MSM stages; then the resident daemon (python -m
     quisquis_tpu_torch.daemon, two warm shapes) and a fresh client process
     that pings, verifies the shuffle entries (first and second request
     timed), proves 4 ranges equal to the host prover's and verifies the 32
     transactions, with a tampered entry, a wrong key and a pickle frame
     refused, the key file 0600 in a 0700 directory, no torch in the
     client, and shutdown ending the daemon with 0;
 17. the sharded paths (quisquis_tpu_torch/parallel) at these phases'
     widths, on 2 ranks of parallel.launch sharing this card (gloo; NCCL
     refuses two ranks on one GPU) and on 1 rank over NCCL: sharded_msm of
     phase 16's Schnorr MSM (65,535 points) equal to the single-device MSM
     at the canonical value, Signature.batch_verify("sharded") of config 3
     (a forged signature rejected), range and shuffle verify_sharded on
     phases 8 and 11's batches (a tampered lane on rank 1 rejected),
     prove_sharded of both provers equal to phases 12-13's proofs byte for
     byte and field for field, batch_verify_transactions("sharded") on
     phase 15's 32 transactions (a tampered one rejected), every rejection
     alike on every rank and every kernel of each path launched on every
     rank; medians of 3 by the host clock beside the single-device times;
 18. one JSON line per contract with every kernel's numbers, then the
     final status line.

Any failed check raises, and the script exits non-zero. It also exits
non-zero without a GPU or outside a checkout of the repository. Whether it
passes or fails, it stops every process it started before it returns: the
worker pools, phase 17's ranks, the serving layer's forkserver and
multiprocessing's resource tracker, and (as the children's subreaper) any
orphan of theirs.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import shutil
import stat
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_MAIN = 16_384
B_CHECK = 256
N_ACCOUNTS = 1_024
RANGE_N, RANGE_M, RANGE_BATCH = 64, 16, 64   # the verifier's full width
RANGE_PROVE_BATCH = 32                        # the prover's full width (benchmarks.py row 4e)
RANGE_PROVE_SMALL = 2                         # the smallest bucket of prove_batch
PROVE_REPS = 5                                # timed prove calls
PLAIN_ROWS = 64                               # rows a chunk of the plain window sums
N_PROOFS = 4                                  # distinct proofs; the lanes repeat them
N_WORKERS = 6                                 # host provers in worker processes
SIGMA_NS = (64, 1_024)                        # config 5's anonymity set; phase 5's Accounts
SIGMA_SAMPLE = 64                             # rows held against the host at n = 1,024
SHUFFLE_M, SHUFFLE_B = 8, 16                  # 64-account shuffles, the throughput batch
SHUFFLE_M_SMALL = 3                           # the reference's 3x3 anonymity set
TX_BUILD, TX_SENDERS, TX_ACCOUNTS = 16, 4, 16  # benchmarks.py config 6e
TX_VERIFY, TX_VERIFY_ACCOUNTS = 32, 9          # config 6/6b: the reference's 9-account set
TX_VERIFY_WIDE, TX_WIDE_ACCOUNTS = 4, 64       # and a few at 64 accounts
TX_REPS = 3                                    # timed calls of each transaction path
FEW_TERMS = 8                                 # a sigma-sized deferred check
SCHNORR_SIGS = 21_845                          # BASELINE.json config 3: 3 terms each, 2^16 - 1
PROVE_SERVICE_TX = 16                          # ProvingService's build requests (row 6d)
SERVICE_REPS = 3                               # timed calls of each service
DAEMON_SHAPES = ("shuffle:8:16", "range-prove:64:16:32")   # the daemon's warm shapes
DAEMON_RANGES = 4                              # range proofs the daemon's client asks for
SHUFFLE_KERNELS = ("scalar_mul", "msm_table", "msm_acc", "msm_tail", "keccak_f1600")
SHARDED_WORLD = 2                              # ranks on the one card (phase 17)
SHARDED_REPS = 3                               # timed calls of each sharded step
SHARDED_PROGRAM = "quisquis_tpu_torch.parallel.programs:run_calls"
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
INT32_LANES_PER_SM = 64     # Hopper SM: 4 partitions x 16 INT32 lanes
# 32x32->64 limb products of one field multiply and one square
# (csrc/field25519.cuh fe_mul, fe_sq), and their counts per lane (csrc notes)
PRODUCTS = {"fe_mul": 100, "fe_sq": 55}
# base_mul: the work the function needs, 64 mixed additions of 7 multiplies
# a lane (the kernel's 65th window and the fold of its four parts, 34
# multiplies more, are its schedule's overhead: csrc/base_mul.cu)
FIELD_OPS = {"scalar_mul": {"fe_mul": 1400, "fe_sq": 1040},
             "base_mul": {"fe_mul": 64 * 7, "fe_sq": 0}}
# per point: the 16-entry table; per point and window: one addition (the
# fold of msm_acc's slices is its schedule's overhead: csrc/msm_acc.cu); per
# row: the tail's 64 lane trees, cached totals and Horner chain
# (csrc/msm_tail.cu)
MSM_PRODUCTS = {"table_point": 91 * 100 + 28 * 55, "add": 9 * 100,
                "tail_row": 2538 * 100 + 1008 * 55}
# the tail's chain: 252 doublings and 64 additions, two dependent rounds each
TAIL_CHAIN_ROUNDS = 2 * (252 + 64)
# 64-bit logic operations of one Keccak round (csrc/keccak_f1600.cu): theta 50
# xors and 5 rotates, rho+pi 24 rotates, chi 75, iota 1. Each is two 32-bit
# operations: a rotate by a constant is two funnel shifts
KECCAK_OPS_PER_STATE = 24 * 155 * 2
# the kernel's chain: 24 rounds of three dependent exchange steps (column
# parity, theta, pi and chi) on the warp that holds a state
KECCAK_CHAIN_STEPS = 24 * 3
KERNELS = {
    "scalar_mul": ("quisquis_tpu_torch/csrc/scalar_mul.cu", "quisquis_tpu/ops/pallas_point.py:79"),
    "base_mul": ("quisquis_tpu_torch/csrc/base_mul.cu", "quisquis_tpu/ops/pallas_point.py:212"),
    "msm_table": ("quisquis_tpu_torch/csrc/msm_table.cu", "quisquis_tpu/ops/pallas_point.py:286"),
    "msm_acc": ("quisquis_tpu_torch/csrc/msm_acc.cu", "quisquis_tpu/ops/pallas_point.py:307"),
    "msm_tail": ("quisquis_tpu_torch/csrc/msm_tail.cu", "quisquis_tpu/ops/pallas_point.py:392"),
    "keccak_f1600": ("quisquis_tpu_torch/csrc/keccak_f1600.cu",
                     "quisquis_tpu/ops/pallas_keccak.py:44"),
    "ristretto_decode": ("quisquis_tpu_torch/csrc/ristretto_codec.cu",
                         "no pallas_call: quisquis_tpu/ops/point.py decompress, a jax.jit program"),
    "ristretto_encode": ("quisquis_tpu_torch/csrc/ristretto_codec.cu",
                         "no pallas_call: quisquis_tpu/ops/point.py compress, a jax.jit program"),
}
SLICE1 = ("scalar_mul", "base_mul")
SLICE2 = ("msm_table", "msm_acc", "msm_tail", "keccak_f1600")
CODEC = ("ristretto_decode", "ristretto_encode")
# squares and multiplies of one point (csrc/ristretto_codec.cu), nearly all
# of them one dependent chain: the inverse square root's z^(2^252-3)
CODEC_OPS = {"ristretto_decode": {"fe_mul": 27, "fe_sq": 257},
             "ristretto_encode": {"fe_mul": 32, "fe_sq": 255}}
# bytes a point: in and out (decode: 32 + ok + 4 coordinates; encode back)
CODEC_BYTES = {"ristretto_decode": 32 + 1 + 4 * 40, "ristretto_encode": 4 * 40 + 32}
# the codec calls of the benchmark's cells: a block of 32 transactions of
# 1 + 1 over 9 accounts (the shuffle verifier's points, once for the input
# and once for the output shuffles, the range verifier's, the shuffle
# verifier's encodings, twice) and a build of 16 of 4 + 4
# (DeviceRangeProver(64, 8, 16): V/A/S once, then T and each round's L/R)
CODEC_SHAPES = {"ristretto_decode": ((32, 149), (32, 20)),
                "ristretto_encode": ((32, 7), (160,), (32,))}


def _flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 1]) + b[1:]


#: one-lane tamperings of a shuffle batch (those of the JAX package's
#: tests/test_device_shuffle_verify.py, and swapped input/output vectors)
SHUFFLE_TAMPERS = ("c_A point", "hadamard a_bar", "ddh z", "multiexpo E_k_0",
                   "svp statement b", "swapped accounts")


def shuffle_tampered(entries, what: str, lane: int):
    """entries with one tampering in lane `lane`."""
    rep = dataclasses.replace
    out = list(entries)
    p, s, ins, outs = out[lane]
    if what == "c_A point":
        p = rep(p, c_A=[_flip(p.c_A[0])] + p.c_A[1:])
    elif what == "hadamard a_bar":
        h = p.hadamard_proof
        p = rep(p, hadamard_proof=rep(h, a_bar=[h.a_bar[0] + 1] + h.a_bar[1:]))
    elif what == "ddh z":
        p = rep(p, ddh_proof=rep(p.ddh_proof, z=p.ddh_proof.z + 1))
    elif what == "multiexpo E_k_0":
        me = p.multi_exponen_commit
        p = rep(p, multi_exponen_commit=rep(me, E_k_0=[_flip(me.E_k_0[0])] + me.E_k_0[1:]))
    elif what == "svp statement b":
        ps = s.product_statement
        s = rep(s, product_statement=rep(ps, svp_statement=rep(ps.svp_statement,
                                                               b=ps.svp_statement.b + 1)))
    else:
        ins, outs = outs, ins
    out[lane] = (p, s, ins, outs)
    return out


def _patch_timer(cls, name: str, spent: list, sync):
    """Wrap the static method cls.name so that each call appends its host
    seconds to `spent`; returns the function that restores it."""
    raw = cls.__dict__[name]
    real = raw.__func__

    def timed(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)
        sync()
        spent.append(time.perf_counter() - t)
        return out
    setattr(cls, name, staticmethod(timed))
    return lambda: setattr(cls, name, raw)


def launch_bounds(seen, bound, launches) -> str:
    """Each kernel's bound summed over one call's launches, from the
    arguments its wrapper was given (seen: "table", "acc", "tail", "sm",
    "keccak" -> argument tuples, one a launch, checked against `launches`,
    the call's launch counts), counting what the data needs: msm_table the
    points that are not the identity, msm_acc the points with a nonzero
    digit (row padding is neither). `bound(ops, bytes)` -> (ms, by)."""
    from quisquis_tpu_torch.ops import field as fe
    from quisquis_tpu_torch.ops import msm as qmsm
    point_bytes = 4 * fe.NLIMBS * 4
    sums_row = 64 * 4 * fe.NLIMBS * qmsm.MSM_LANES * 4
    sm_ops = sum(FIELD_OPS["scalar_mul"][k] * PRODUCTS[k] for k in PRODUCTS)
    names = {"table": "msm_table", "acc": "msm_acc", "tail": "msm_tail", "sm": "scalar_mul",
             "keccak": "keccak_f1600"}
    parts = {}
    for key, calls in seen.items():
        if key not in names:
            continue
        name = names[key]
        check(len(calls) == launches.get(name, 0),
              f"{len(calls)} {name} calls recorded, {launches.get(name, 0)} launched")
        for args in calls:
            if key == "table":
                p = args[0]
                k = int((~((p.x == 0).all(-1) & (p.t == 0).all(-1))).sum())
                b = bound(k * MSM_PRODUCTS["table_point"], k * 17 * point_bytes)
            elif key == "acc":
                digits, _, rows = args
                k = int((digits != 0).any(0).sum())
                b = bound(k * 64 * MSM_PRODUCTS["add"],
                          k * (64 * 4 + 16 * point_bytes) + rows * sums_row)
            elif key == "tail":
                rows = args[0].x.shape[0]
                b = bound(rows * MSM_PRODUCTS["tail_row"], rows * (sums_row + point_bytes))
            elif key == "sm":
                n = args[0].shape[0]
                b = bound(n * sm_ops, n * (64 + 8 * fe.NLIMBS) * 4)
            else:
                n = args[0].shape[0]
                b = bound(n * KECCAK_OPS_PER_STATE, n * 400)
            parts.setdefault(name, []).append(b)
    return "; ".join(f"{k} {sum(ms for ms, _ in v):.5f} ms over {len(v)} launches "
                     f"({'/'.join(sorted({by for _, by in v}))})" for k, v in parts.items())


def encodings(p) -> np.ndarray:
    """The plain encoder's wire bytes of points, uint8 [..., 32] on the host."""
    from quisquis_tpu_torch.ops import point as pt
    return pt.compress_to_bytes_tensor(p).cpu().numpy()


def codec_inputs(dev, shape, seed: int):
    """(encodings uint8 [*shape, 32] on dev, the points [*shape] they
    encode where valid): the plain encodings of random points, then every
    other row made invalid in turn: a random string, the high bit set, a
    non-canonical value p + k, s + 1 (odd: negative, where still below p)."""
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import point as pt
    n = math.prod(shape)
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    b[:, 31] &= 0x0F
    points = kp.base_mul(torch.as_tensor(pt.scalar_to_nibbles(b), device=dev))
    enc = encodings(points)
    for i in range(1, n, 2):
        kind = (i // 2) % 4
        if kind == 0:
            enc[i] = rng.integers(0, 256, size=32, dtype=np.uint8)
        elif kind == 1:
            enc[i, 31] |= 0x80
        elif kind == 2:
            enc[i] = np.frombuffer((ex.P + i % 19).to_bytes(32, "little"), np.uint8)
        else:
            enc[i, 0] ^= 1
    return (torch.as_tensor(enc.reshape(*shape, 32), device=dev),
            pt.ExtPoint(*(c.reshape(*shape, 10) for c in points)))


def _max_abs_err(got, want) -> int:
    """The largest difference between paired tensors' elements."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))


def phase_codec(h, shapes=None):
    """The ristretto codec kernels against their plain versions on the card
    at the benchmark cells' shapes: decode limb for limb and ok for ok on
    valid and invalid encodings, encode byte for byte on random points and
    on what decode returned (rejected rows too), one launch a call, a few
    rows against exact.py; the kernel's device time by graph replay, a
    wrapper call's by CUDA events and on the host clock, the plain
    version's by CUDA events, each shape's bound. Returns the contract's
    JSON entries of both kernels (times at each kernel's largest shape;
    max_abs_err over every shape; launches None: the main paths' counts,
    phases 14-15, fill it in)."""
    from quisquis_tpu_torch.kernel_ab import graph_ms
    from quisquis_tpu_torch.ops import cuda_build as cb
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import point as pt
    shapes = CODEC_SHAPES if shapes is None else shapes
    phase, dev = h.phase, h.dev
    results = {}
    for name in CODEC:
        products = sum(CODEC_OPS[name][k] * PRODUCTS[k] for k in PRODUCTS)
        rows, err = [], 0
        for j, shape in enumerate(shapes[name]):
            enc, points = codec_inputs(dev, shape, SEED + 97 * j)
            n = math.prod(shape)
            if name == "ristretto_decode":
                run = lambda: kp.decode_bytes(enc)  # noqa: E731
                plain = lambda: pt.decompress_bytes_tensor(enc)  # noqa: E731
            else:
                run = lambda: kp.encode_bytes(points)  # noqa: E731
                plain = lambda: pt.compress_to_bytes_tensor(points)  # noqa: E731
            before = cb.LAUNCHES[name]
            got = run()
            check(cb.LAUNCHES[name] == before + 1, f"{name} {shape}: one launch a call")
            if name == "ristretto_decode":
                ok, got = got
                p_ok, want = plain()
                e = _max_abs_err((ok, *got), (p_ok, *want))
                check(e == 0 and ok.shape == p_ok.shape,
                      f"{name} {shape} == plain, ok for ok and limb for limb")
                flat_ok = ok.reshape(-1).cpu()
                check(bool(flat_ok[0::2].all()), f"{name} {shape}: every valid encoding decodes")
                check(not bool(flat_ok[3::8].any() | flat_ok[5::8].any()),
                      f"{name} {shape}: high-bit and non-canonical encodings rejected")
                flat_enc = enc.reshape(-1, 32).cpu().numpy()
                for i in range(min(n, 16)):
                    check(bool(flat_ok[i]) == (ex.ristretto_decode(bytes(flat_enc[i])) is not None),
                          f"{name} {shape} row {i}: ok == exact.py's")
            else:
                _, dec = kp.decode_bytes(enc)
                e = _max_abs_err((got, kp.encode_bytes(dec)),
                                 (plain(), pt.compress_to_bytes_tensor(dec)))
                check(e == 0 and got.shape == (*shape, 32),
                      f"{name} {shape} == plain, byte for byte, on random points and on decoded "
                      f"limbs (rejected rows too)")
                host = pt.to_exact_batch(pt.ExtPoint(*(c.reshape(-1, 10)[:16] for c in points)))
                flat = got.reshape(-1, 32).cpu().numpy()
                for i, p_ in enumerate(host):
                    check(bytes(flat[i]) == ex.ristretto_encode(p_),
                          f"{name} {shape} row {i} == exact.py's encoding")
            err = max(err, e)
            h.sync()
            ms = graph_ms(run)
            events_ms = time_ms(run, reps=50, warmup=3)
            t0 = time.perf_counter()
            for _ in range(50):
                run()
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            h.sync()
            plain_ms = time_once(plain)[1]
            b_ms, b_by = h.bound(n * products, n * CODEC_BYTES[name])
            rows.append((n, ms, plain_ms, b_ms, b_by))
            h.say(phase, f"{name} {shape} ({n} points): kernel {ms:.4f} ms by graph replay, "
                         f"{events_ms:.4f} ms a call by CUDA events over 50 wrapper calls, the "
                         f"wrapper's host time {host_ms:.4f} ms a call, plain {plain_ms:.2f} ms; "
                         f"bound {b_ms:.6f} ms ({b_by}: {n * products:.4e} limb products), "
                         f"chain floor ~285 dependent field operations a thread; == plain and "
                         f"exact.py; 1 launch a call [{h.card}]")
        n, ms, plain_ms, b_ms, b_by = max(rows)
        results[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
    return results


def phase_tx_build(h, n_tx=TX_BUILD, n_senders=TX_SENDERS, n_accounts=TX_ACCOUNTS,
                   reps=TX_REPS):
    """Transaction building at config 6e's width: batch_create_transactions
    with its range proofs proved on the device ("device-batched": one
    DeviceRangeProver call of (range bits, 2 x n_senders, n_tx)) and on the
    host, byte for byte equal, every transaction verified; the range
    prover's kernels against their plain versions at its shapes; times.
    `h`: the run's helpers (see phases). Returns the device-built pairs."""
    from quisquis_tpu_torch.bulletproofs import device_prove as rdp
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.config import DEFAULT
    from quisquis_tpu_torch.ops import cuda_build as cb
    from quisquis_tpu_torch.ops import cuda_keccak as kk
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import device_keccak as dk
    from quisquis_tpu_torch.ops import msm as qmsm
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.transaction import (batch_create_transactions,
                                                batch_verify_transactions, verify_transaction)
    from quisquis_tpu_torch.transaction.workloads import benchmark_requests, comparable

    m, n_bits = 2 * n_senders, DEFAULT.range_bits
    phase = h.phase

    def build(reqs, backend):
        return batch_create_transactions(reqs, range_backend=backend, device=h.dev)

    rdp._PROVER_CACHE.clear()
    reqs = benchmark_requests(b"chip-smoke-6e", n_tx, n_senders, n_accounts)
    h.sync()
    cb.reset_launches()
    t0 = time.perf_counter()
    out_dev = build(reqs, "device-batched")
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(set(launches) == {*SLICE2, "ristretto_encode"},
          f"batch_create_transactions launches {launches}")
    check([k[:3] for k in rdp._PROVER_CACHE] == [(n_bits, m, n_tx)],
          f"one DeviceRangeProver call of ({n_bits}, {m}, {n_tx}): {list(rdp._PROVER_CACHE)}")
    out_host = build(benchmark_requests(b"chip-smoke-6e", n_tx, n_senders, n_accounts), "host")
    check(comparable(out_dev) == comparable(out_host),
          "device-batched transactions == host-built ones, byte for byte")
    for tx, proof in out_dev:
        check(len(proof.range_proofs) == 1, f"one aggregated range proof (m={m}) a transaction")
        verify_transaction(tx, proof, backend="host")   # raises unless it verifies
    batch_verify_transactions(out_dev, backend="host", seed=b"chip-smoke-6e-check")
    h.say(phase, f"batch_create_transactions of {n_tx} transactions ({n_senders} senders and "
                 f"{n_senders} receivers over {n_accounts} accounts, benchmarks.py config 6e): "
                 f"device-batched (one DeviceRangeProver({n_bits}, {m}, {n_tx}) call; first "
                 f"call, tables built, {first_s:.2f} s, launches {launches}) == host-built, byte "
                 f"for byte; every transaction verifies [{h.card}]")

    # the kernels at this prover's shapes: one more build records their inputs
    drp = rdp._PROVER_CACHE[next(iter(rdp._PROVER_CACHE))]
    seen, restore = h.keep_calls([(kp, "msm_window_sums", "acc"), (kk, "f1600", "keccak"),
                                  (kp, "msm_table", "table"), (kp, "msm_tail", "tail")])
    cb.reset_launches()
    try:
        build(benchmark_requests(b"chip-smoke-6e", n_tx, n_senders, n_accounts),
              "device-batched")
    finally:
        restore()
    h.say(phase, f"bounds summed over one build's launches (the points the data needs): "
                 f"{launch_bounds(seen, h.bound, _launched(cb))} [{h.card}]")
    acc_calls = seen["acc"]
    check(len(acc_calls) == 2 + drp.k, f"{len(acc_calls)} msm_acc calls a build")
    # one encode launch for V/A/S, one for T and one for each round's L/R
    h.codec_launches["ristretto_encode"] = n_enc = cb.LAUNCHES["ristretto_encode"]
    check(n_enc == 2 + drp.k and cb.LAUNCHES["ristretto_decode"] == 0,
          f"ristretto_encode launches a build: {n_enc}, want 2 + {drp.k} rounds")
    basis = drp._basis
    kpad = basis.table().x.shape[-1]
    flat_b = pt.ExtPoint(*(torch.cat([c, e]) for c, e in
                           zip(basis.points, pt.identity((kpad - basis.k,), h.dev))))
    h.same(basis.table(), qmsm.msm_table(flat_b), "msm_table",
           f"the transaction range prover's cached basis ({kpad} points)")
    vas, t_call, ipp0 = acc_calls[0], acc_calls[1], acc_calls[2]
    for call, what in ((vas, "V/A/S"), (t_call, "T"), (ipp0, "inner-product round")):
        h.rows_against_plain(*call, f"the transaction range prover's {what} rows "
                                    f"({call[2]} x {call[0].shape[1] // call[2]})")
    states = torch.cat([st for (st,) in seen["keccak"]])
    check({st.shape[0] for (st,) in seen["keccak"]} == {n_tx}, f"prover states [{n_tx}, 200]")
    check(torch.equal(kk.f1600(states), dk.f1600_plain(states)),
          "keccak_f1600 == plain on every transaction range prover state of a build")
    h.say(phase, f"kernels == plain versions at the transaction range prover's shapes: "
                 f"msm_table on its basis ({basis.k} points padded to {kpad}), msm_acc / "
                 f"msm_tail on its V/A/S ({vas[2]} rows), T ({t_call[2]}) and inner-product "
                 f"({ipp0[2]}) rows, keccak_f1600 on {len(seen['keccak'])} states; max_abs_err "
                 f"{ {k: h.err[k] for k in SLICE2} }")

    # times: the median of `reps` builds by each range backend, the range
    # proving part apart (each build's requests made before its timing)
    times = {}
    for backend in ("device-batched", "host"):
        spent: list = []
        args = [benchmark_requests(b"chip-smoke-6e", n_tx, n_senders, n_accounts)
                for _ in range(reps)]
        restore = _patch_timer(RangeProof, "prove_batch", spent, h.sync)
        try:
            if backend == "device-batched":
                cb.reset_launches()
            times[backend] = h.median_ms(lambda: build(args.pop(), backend), reps=reps)
            if backend == "device-batched":
                launches = {k: v // reps for k, v in cb.LAUNCHES.items() if v}
        finally:
            restore()
        times[backend + " range"] = statistics.median(spent) * 1e3
    med, lo, hi = times["device-batched"]
    hmed, hlo, hhi = times["host"]
    h.say(phase, f"batch_create_transactions of {n_tx} transactions, host clock, {reps} calls: "
                 f"device-batched median {med:.1f} ms (min {lo:.1f}, max {hi:.1f}) = "
                 f"{n_tx / med * 1e3:.2f} tx/s, of it the range proving (prove_batch) "
                 f"{times['device-batched range']:.1f} ms; launches a build {launches}; host "
                 f"range backend median {hmed:.1f} ms (min {hlo:.1f}, max {hhi:.1f}) = "
                 f"{n_tx / hmed * 1e3:.2f} tx/s, of it the range proving "
                 f"{times['host range']:.1f} ms ({times['host range'] / n_tx:.1f} ms a proof) "
                 f"[{h.card}]")
    args = benchmark_requests(b"chip-smoke-6e", n_tx, n_senders, n_accounts)
    h.say(phase, h.profile(lambda: build(args, "device-batched"),
                           "batch_create_transactions (device-batched)", SLICE2))
    return out_dev


#: one-transaction tamperings of a verification batch; the last two only the
#: device verifiers see (the host's advance-only replay appends nothing of
#: them before its last challenge check)
TX_TAMPERS = ("range proof t_x byte", "output shuffle c_B byte", "sigma response",
              "delta update", "range proof inner-product a", "output shuffle E_k_0")
TX_DEVICE_ONLY = TX_TAMPERS[4:]


def tx_tampered(items, what: str, i: int):
    """items with one tampering in transaction i."""
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.transaction import Transaction
    rep = dataclasses.replace
    out = list(items)
    tx, proof = out[i]
    if what.startswith("range proof"):
        blob = bytearray(proof.range_proofs[0].to_bytes())
        blob[130 if what == "range proof t_x byte" else -64] ^= 1
        proof = rep(proof, range_proofs=[RangeProof.from_bytes(bytes(blob))])
    elif what == "output shuffle c_B byte":
        sp = proof.output_shuffle_proof
        proof = rep(proof, output_shuffle_proof=rep(sp, c_B=[_flip(sp.c_B[0])] + sp.c_B[1:]))
    elif what == "output shuffle E_k_0":
        sp = proof.output_shuffle_proof
        me = sp.multi_exponen_commit
        me = rep(me, E_k_0=[_flip(me.E_k_0[0])] + me.E_k_0[1:])
        proof = rep(proof, output_shuffle_proof=rep(sp, multi_exponen_commit=me))
    elif what == "sigma response":
        zv, zr1, zr2, x = proof.delta_dleq
        proof = rep(proof, delta_dleq=([zv[0] + 1] + zv[1:], zr1, zr2, x))
    else:   # the last account's delta is not applied
        upd = list(tx.account_updated_delta_vector)
        upd[-1] = tx.updated_account_vector[-1]
        tx = Transaction(tx.input_account_vector, tx.updated_account_vector,
                         tx.account_delta_vector, tx.account_epsilon_vector, upd,
                         tx.output_account_vector)
    out[i] = (tx, proof)
    return out


def phase_tx_verify(h, built, n_tx=TX_VERIFY, n_accounts=TX_VERIFY_ACCOUNTS,
                    n_wide=TX_VERIFY_WIDE, wide_accounts=TX_WIDE_ACCOUNTS, reps=TX_REPS):
    """Batch verification: n_tx transactions of config 6/6b (1 sender and 1
    receiver over n_accounts) and n_wide over wide_accounts, accepted by
    batch_verify_transactions on "device-batched" and on "host"; each
    tampering of TX_TAMPERS in one transaction rejected by both; the
    kernels against their plain versions at the device verifiers' shapes;
    times of both backends on this batch and on `built` (config 6e's)."""
    from quisquis_tpu_torch.ops import cuda_build as cb
    from quisquis_tpu_torch.ops import cuda_keccak as kk
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import device_keccak as dk
    from quisquis_tpu_torch.ops import msm as qmsm
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks, DeviceBatchCollector
    from quisquis_tpu_torch.bulletproofs.device_verify import DeviceRangeVerifier
    from quisquis_tpu_torch.shuffle import device_verify as sdv
    from quisquis_tpu_torch.shuffle.device_verify import DeviceShuffleVerifier
    from quisquis_tpu_torch.transaction import (batch_create_transactions,
                                                batch_verify_transactions, verify_transaction)
    from quisquis_tpu_torch.transaction.workloads import benchmark_requests

    phase = h.phase
    t0 = time.perf_counter()
    items = batch_create_transactions(
        benchmark_requests(b"chip-smoke-6b", n_tx, 1, n_accounts)
        + benchmark_requests(b"chip-smoke-wide", n_wide, 1, wide_accounts), range_backend="host")
    build_s = time.perf_counter() - t0

    def verify(batch, backend):
        batch_verify_transactions(batch, backend=backend, seed=b"chip-smoke-tx-verify",
                                  device=h.dev)

    h.sync()
    sdv._VERIFIER_CACHE.clear()   # fresh shuffle verifiers: a frame's first call runs eagerly
    cb.reset_launches()
    verify(items, "device-batched")   # raises unless every transaction verifies
    launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(set(launches) == {*SHUFFLE_KERNELS, *CODEC},
          f"device-batched verify launches {launches}")
    verify(items, "host")
    rejected = []
    at = min(5, len(items) - 1)
    for what in TX_TAMPERS:
        bad = tx_tampered(items, what, at)
        for backend in ("device-batched", "host"):
            try:
                verify(bad, backend)
            except ValueError:
                continue
            raise RuntimeError(f"check failed: {backend} accepted a batch with a tampered {what}")
        if what in TX_DEVICE_ONLY:   # the host part accepts; the device rejects
            collector, defer = DeviceBatchCollector(), DeferredPointChecks(b"chip-smoke-tx")
            verify_transaction(*bad[at], defer=defer, collector=collector)
            defer.verify(backend="host")
            try:
                collector.verify(device=h.dev)
            except ValueError:
                pass
            else:
                raise RuntimeError(f"check failed: the device verifiers accepted {what}")
        rejected.append(what)
    h.say(phase, f"batch_verify_transactions of {n_tx} transactions over {n_accounts} accounts "
                 f"and {n_wide} over {wide_accounts} (built by the host in {build_s:.1f} s): "
                 f"accepted by device-batched (launches {launches}) and host; one transaction "
                 f"with a tampered {', '.join(rejected)} rejected by both each time (the last "
                 f"{len(TX_DEVICE_ONLY)} by the device verifiers, the host part accepting) "
                 f"[{h.card}]")

    # the kernels at the device verifiers' shapes: one more verify records
    # their inputs (the largest call of each kind is held to the plain one)
    # and counts the verifiers' calls
    seen, restore = h.keep_calls([(kp, "scalar_mul", "sm"), (qmsm, "msm_rows", "rows"),
                                  (qmsm, "msm", "msm"), (kk, "f1600", "keccak"),
                                  (kp, "msm_table", "table"), (kp, "msm_window_sums", "acc"),
                                  (kp, "msm_tail", "tail"),
                                  (DeviceShuffleVerifier, "verify", "shuffle verifier"),
                                  (DeviceRangeVerifier, "verify", "range verifier")])
    sdv._VERIFIER_CACHE.clear()   # eager again: replayed graphs call no kernel wrapper
    cb.reset_launches()
    try:
        verify(items, "device-batched")
    finally:
        restore()
    h.say(phase, f"bounds summed over one call's launches (the points the data needs): "
                 f"{launch_bounds(seen, h.bound, _launched(cb))} [{h.card}]")
    # a shuffle verifier call decodes its points and encodes its DDH and
    # comparison points once; a range verifier call decodes once
    n_sh, n_rv = len(seen["shuffle verifier"]), len(seen["range verifier"])
    codec = {k: cb.LAUNCHES[k] for k in CODEC}
    check((n_sh, n_rv) == (4, 1), f"verifier calls: {n_sh} shuffle (want the input and output "
                                  f"shuffles of two widths, 4), {n_rv} range (want 1)")
    check(codec == {"ristretto_decode": n_sh + n_rv, "ristretto_encode": n_sh},
          f"codec launches a verify {codec}, want {n_sh} + {n_rv} decodes, {n_sh} encodes")
    h.codec_launches["ristretto_decode"] = codec["ristretto_decode"]
    nib_p, pts_p = max(seen["sm"], key=lambda a: a[0].shape[0])
    h.same(kp.scalar_mul(nib_p, pts_p), pt.scalar_mul(nib_p, pts_p), "scalar_mul",
           f"the transaction shuffle verifier's {nib_p.shape[0]} product lanes")
    nib_r, pts_r = max(seen["rows"], key=lambda a: a[0].shape[0] * a[0].shape[1])
    h.stages_against_plain(nib_r, pts_r, f"the transaction shuffle verifier's rows "
                                         f"{tuple(nib_r.shape[:2])}")
    nib_f, pts_f = max(seen["msm"], key=lambda a: a[0].shape[0])
    h.stages_against_plain(nib_f[None], pt.ExtPoint(*(c[None] for c in pts_f)),
                           f"the transaction verifiers' largest MSM ({nib_f.shape[0]} points)")
    for (st,) in seen["keccak"]:
        check(torch.equal(kk.f1600(st), dk.f1600_plain(st)),
              "keccak_f1600 == plain on a transaction verifier state")
    h.say(phase, f"kernels == plain versions at the transaction verifiers' shapes: scalar_mul "
                 f"({len(seen['sm'])} calls, the largest {nib_p.shape[0]} lanes), msm_table / "
                 f"msm_acc / msm_tail on the largest rows call {tuple(nib_r.shape[:2])} and the "
                 f"largest MSM ({nib_f.shape[0]} points; {len(seen['msm'])} calls), keccak_f1600 "
                 f"on {len(seen['keccak'])} states; max_abs_err "
                 f"{ {k: h.err[k] for k in SHUFFLE_KERNELS} }")

    for label, batch in ((f"{len(items)} transactions (6/6b and {wide_accounts}-account)", items),
                         (f"config 6e's {len(built)} transactions", built)):
        parts = []
        for backend in ("device-batched", "host"):
            cb.reset_launches()
            med, lo, hi = h.median_ms(lambda: verify(batch, backend), reps=reps)
            n_l = {k: v // reps for k, v in cb.LAUNCHES.items() if v}
            parts.append(f"{backend} median {med:.1f} ms (min {lo:.1f}, max {hi:.1f}) = "
                         f"{len(batch) / med * 1e3:.1f} tx/s"
                         + (f", launches a call {n_l}" if n_l else ""))
        h.say(phase, f"batch_verify_transactions of {label}, host clock, {reps} calls: "
                     + "; ".join(parts) + f" [{h.card}]")
    h.say(phase, h.profile(lambda: verify(items, "device-batched"),
                           "batch_verify_transactions (device-batched)", SHUFFLE_KERNELS))
    return items


def schnorr_transcript(i: int):
    from quisquis_tpu_torch.accounts.transcript import Transcript
    return Transcript(b"chip-smoke-schnorr-%d" % i)


def schnorr_slice(first: int, count: int):
    """Worker process: `count` zkSchnorr signatures from index `first`, each
    by its own key over its own transcript, from the port's host signer.
    Returns [(signature bytes, verification-key bytes)]."""
    sys.path.insert(0, REPO)
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    from quisquis_tpu_torch.primitives.schnorr import Signature, VerificationKey
    rng = SeededRng(seed=b"chip-smoke-schnorr-%d" % first)
    out = []
    for i in range(first, first + count):
        sk = rng.random_scalar()
        vk = VerificationKey.from_secret(sk, rng.random_scalar())
        out.append((Signature.sign(schnorr_transcript(i), vk, sk, rng=rng).to_bytes(),
                    vk.to_bytes()))
    return out


#: the daemon's client: a fresh interpreter that imports only
#: quisquis_tpu_torch.daemon; argv: socket, input file (JSON); prints one
#: JSON line of results
DAEMON_CLIENT = r'''
import json, pickle, sys, time
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client
from quisquis_tpu_torch.daemon import KEY_BYTES, DeviceClient


class Evil:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


sock, inputs = sys.argv[1], json.load(open(sys.argv[2]))
blobs = [bytes.fromhex(b) for b in inputs["shuffles"]]
pairs = [(bytes.fromhex(a), bytes.fromhex(b)) for a, b in inputs["pairs"]]
out = {}
with DeviceClient(sock, retries=900) as c:
    out["ping"] = c.ping()
    out["shuffle_s"] = []
    for _ in range(2):
        t = time.perf_counter()
        out["shuffles"] = c.verify_shuffles(blobs, backend="device-batched")
        out["shuffle_s"].append(time.perf_counter() - t)
    bad = bytearray(blobs[0])
    bad[inputs["flip"]] ^= 1
    try:
        c.verify_shuffles([bytes(bad)] + blobs[1:], backend="device-batched")
        out["tamper"] = "accepted"
    except ValueError as e:
        out["tamper"] = "ValueError: " + str(e)[:60]
    r = inputs["ranges"]
    t = time.perf_counter()
    proved = c.prove_ranges(r["n"], r["values"], r["blindings"],
                            [bytes.fromhex(x) for x in r["seeds"]], backend="device-batched")
    out["range_s"] = time.perf_counter() - t
    out["ranges"] = [[p.hex(), [v.hex() for v in V]] for p, V in proved]
    t = time.perf_counter()
    out["tx"] = c.verify_transactions(pairs)
    out["tx_s"] = time.perf_counter() - t
    try:
        c.roundtrip(pickle.dumps(Evil(inputs["pwned"])))
        out["pickle"] = "ok"
    except RuntimeError as e:
        out["pickle"] = "error: " + str(e)[:60]
try:
    Client(sock, "AF_UNIX", authkey=b"\0" * KEY_BYTES)
    out["wrong_key"] = "accepted"
except AuthenticationError:
    out["wrong_key"] = "refused"
out["torch_loaded"] = "torch" in sys.modules
out["cuda_modules"] = sorted(m for m in sys.modules if m.startswith("quisquis_tpu_torch.ops.cuda_"))
print(json.dumps(out))
'''


def _ddh_z_offset(entry: bytes) -> int:
    """The offset of the DDH response z's first byte in a shuffle entry
    (serde: the proof blob, u32-counted, ends with challenge, z, G', H')."""
    return 4 + int.from_bytes(entry[:4], "little") - 96


def _launched(cb) -> dict:
    return {k: v for k, v in cb.LAUNCHES.items() if v}


def phase_services(h, entries, items, drv, workers=None, n_sigs=SCHNORR_SIGS,
                   n_build=PROVE_SERVICE_TX, n_prove=RANGE_PROVE_BATCH, reps=SERVICE_REPS,
                   daemon_shapes=DAEMON_SHAPES, range_bits=RANGE_N, range_m=RANGE_M):
    """The serving layer at the deployments users run: ShuffleVerificationService
    on phase 11's 16 shuffle proofs (row 5d), VerificationService on phase
    15's 32 transactions of config 6/6b (row 6c), ProvingService on 16
    build requests (row 6d), RangeProvingService at row 4e, a batched
    Schnorr verify of BASELINE.json config 3, and the resident daemon with
    a fresh client process; the merged MSMs and the Schnorr MSM held to the
    plain MSM stages. `h`: the run's helpers, with `pool` (the worker
    processes). Every service runs `workers` processes (default: this
    machine's CPUs). Returns the Schnorr batch (`items_of(forge)`), its
    device MSM's inputs and the device call's ms."""
    from quisquis_tpu_torch import daemon as qdaemon
    from quisquis_tpu_torch import serving
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.ops import cuda_build as cb
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import msm as qmsm
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from quisquis_tpu_torch.primitives.schnorr import Signature, VerificationKey
    from quisquis_tpu_torch.shuffle import device_verify as sdv
    from quisquis_tpu_torch.utils import serde
    from quisquis_tpu_torch.utils.metrics import metrics

    phase, dev = h.phase, h.dev
    if workers is None:
        workers = min(os.cpu_count() or 1, len(os.sched_getaffinity(0)))
    msm_kernels = ("msm_table", "msm_acc", "msm_tail")

    def held(call, what):
        nib, pts = call
        h.stages_against_plain(nib[None], pt.ExtPoint(*(c[None] for c in pts)), what)

    def rejected(fn, chunk=None):
        """fn() raises ValueError, naming `chunk` where one is given."""
        try:
            fn()
        except ValueError as e:
            check(chunk is None or f"chunk {chunk}:" in str(e), f"'chunk {chunk}' in {e}")
            return
        raise RuntimeError("check failed: a tampered request was accepted")

    def timed_services(svcs, batch, bad, chunk, unit):
        """Accept, two rejections, the median of `reps` calls, launches and
        the merged MSMs of each service; the device MSM's inputs kept."""
        parts, kept = [], None
        for svc in svcs:
            h.sync()
            sdv._VERIFIER_CACHE.clear()   # the shuffle verifiers' first calls run eagerly
            cb.reset_launches()
            if svc.backend == "device":
                seen, restore = h.keep_calls([(qmsm, "msm", "msm")])
            try:
                check(svc.verify_wire(batch) == len(batch), f"{svc.backend} accepts")
            finally:
                if svc.backend == "device":
                    restore()
                    kept = max(seen["msm"], key=lambda a: a[0].shape[0])
            launches = _launched(cb)
            want = {"device": set(msm_kernels), "device-batched": {*SHUFFLE_KERNELS, *CODEC}}
            check(set(launches) == want.get(svc.backend, set()),
                  f"{svc.backend} service launches {launches}")
            for b, c in zip(bad, chunk):
                rejected(lambda: svc.verify_wire(b),
                         c if svc.backend != "device-batched" else None)
            # the merged MSM's terms and time, from the service's metrics
            key = "serving.merged_msm." + ("device" if svc.backend == "device" else "host")
            terms0 = metrics.counters.get("serving.merged_terms", 0)
            n0 = len(metrics.timers.get(key, []))
            med, lo, hi = h.median_ms(lambda: svc.verify_wire(batch), reps=reps)
            part = (f"{svc.backend}: median {med:.1f} ms (min {lo:.1f}, max {hi:.1f}) = "
                    f"{len(batch) / med * 1e3:.2f} {unit}/s")
            if svc.backend in ("device", "merged-host"):
                msm_s = list(metrics.timers[key])[n0:]
                terms = (metrics.counters["serving.merged_terms"] - terms0) / len(msm_s)
                part += (f", merged MSM of {terms:.0f} coalesced terms: median "
                         f"{statistics.median(msm_s) * 1e3:.2f} ms")
            parts.append(part + (f", launches {launches}" if launches else ""))
        return parts, kept

    # -- 5d: ShuffleVerificationService on phase 11's proofs -----------------
    blobs = [serde.shuffle_entry_to_bytes(*e) for e in entries]
    at = 3 % min(workers, len(blobs))
    flip = bytearray(blobs[at])
    flip[_ddh_z_offset(blobs[at])] ^= 1
    bad5 = [blobs[:at] + [bytes(flip)] + blobs[at + 1:],
            blobs[:at] + [blobs[at][:-1]] + blobs[at + 1:]]
    shuffle_svcs = [serving.ShuffleVerificationService(workers, backend=b, device=dev)
                    for b in ("device", "merged-host", "device-batched")]
    try:
        parts5, msm5 = timed_services(shuffle_svcs, blobs, bad5, (at, at), "proofs")
        states = [f.result() for f in [shuffle_svcs[0]._pool.submit(torch.cuda.is_initialized)
                                       for _ in range(workers)]]
        check(not any(states), f"workers left CUDA uninitialized after their chunks: {states}")
    finally:
        for svc in shuffle_svcs:
            svc.close()
    h.say(phase, f"ShuffleVerificationService, {workers} workers, {len(blobs)} proofs of m="
                 f"{math.isqrt(len(entries[0][2]))} over {len(entries[0][2])} accounts "
                 f"(benchmarks.py row 5d) as wire entries: accepted by each backend; one "
                 f"flipped byte (the DDH response) and one truncated blob rejected by each, "
                 f"naming chunk {at} where the pool verifies; host clock, {reps} calls: "
                 + "; ".join(parts5) + f"; no worker initialized CUDA [{h.card}]")

    # -- 6c: VerificationService on phase 15's 32 transactions ---------------
    pairs = [serving.serialize_transaction(tx, proof) for tx, proof in items]
    at = 5 % min(workers, len(pairs))
    tx, proof = items[at]
    zv, zr1, zr2, x = proof.delta_dleq
    tampered = serving.serialize_transaction(
        tx, dataclasses.replace(proof, delta_dleq=([zv[0] + 1] + zv[1:], zr1, zr2, x)))
    bad6 = [pairs[:at] + [tampered] + pairs[at + 1:],
            pairs[:at] + [(pairs[at][0], pairs[at][1][:-7])] + pairs[at + 1:]]
    tx_svcs = {b: serving.VerificationService(workers, backend=b, device=dev)
               for b in ("host", "merged-host", "device", "device-batched")}
    try:
        parts6, msm6 = timed_services(list(tx_svcs.values()), pairs, bad6, (at, at), "tx")
        h.say(phase, f"VerificationService, {workers} workers, {len(pairs)} wire transactions of "
                     f"config 6/6b (benchmarks.py row 6c): accepted by each backend; one "
                     f"tampered pair (a sigma response) and one truncated blob rejected by each, "
                     f"naming chunk {at} where the pool verifies; host clock, {reps} calls: "
                     + "; ".join(parts6) + f" [{h.card}]")

        # -- 6d: ProvingService --------------------------------------------------
        r = SeededRng(seed=b"chip-smoke-6d")
        reqs = []
        for i in range(n_build):
            sk = RistrettoSecretKey.random(r)
            acc, _ = Account.generate_account(RistrettoPublicKey.from_secret_key(sk, r), r)
            acc = Account.update_account(acc, 10 + i, r.random_scalar(), r.random_scalar())
            rec = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r)
            reqs.append(serving.BuildRequest(acc.as_bytes(), sk.as_bytes(), 5, rec.as_bytes(),
                                             10 + i - 5))
        with serving.ProvingService(workers, seed=b"chip-smoke-6d") as pp:
            built = pp.build(reqs)
            med, lo, hi = h.median_ms(lambda: pp.build(reqs), reps=reps)
        nchunks = min(workers, n_build)
        replay = [None] * n_build
        for i in range(nchunks):
            seed = hashlib.sha512(b"chip-smoke-6d" + b"build"
                                  + i.to_bytes(8, "little")).digest()[:32]
            replay[i::nchunks] = serving._build_chunk(reqs[i::nchunks], seed)
        check(built == replay, "ProvingService pairs == the in-process _build_chunk replay")
        check(tx_svcs["host"].verify_wire(built) == n_build, "every built pair verifies")
        h.say(phase, f"ProvingService, {workers} workers, {n_build} BuildRequests (benchmarks.py "
                     f"row 6d): the pairs equal an in-process _build_chunk replay byte for byte "
                     f"and verify; host clock, {reps} builds: median {med:.1f} ms (min {lo:.1f}, "
                     f"max {hi:.1f}) = {n_build / med * 1e3:.2f} tx/s [{h.card}]")
    finally:
        for svc in tx_svcs.values():
            svc.close()

    # -- 4e: RangeProvingService ---------------------------------------------
    lanes = [range_lane(i) for i in range(n_prove)]
    requests = [(v, b) for v, b, _ in lanes]
    rps = serving.RangeProvingService(range_bits, backend="device-batched",
                                      seed=b"chip-smoke-4e", device=dev)
    t0 = time.perf_counter()
    rps.warmup(range_m, n_prove)
    h.sync()
    warm_s = time.perf_counter() - t0
    cb.reset_launches()
    t0 = time.perf_counter()
    proved = rps.prove(requests)
    h.sync()
    prove_s = time.perf_counter() - t0
    launches = _launched(cb)
    check({"msm_acc", "msm_tail", "keccak_f1600"} <= set(launches),
          f"RangeProvingService launches {launches}")
    t0 = time.perf_counter()
    host = serving.RangeProvingService(range_bits, backend="host", seed=b"chip-smoke-4e",
                                       device=dev).prove(requests[:4])
    host_s = time.perf_counter() - t0
    check([(p.to_bytes(), V) for p, V in proved[:4]] == [(p.to_bytes(), V) for p, V in host],
          "RangeProvingService device-batched lanes 0-3 == host, byte for byte")
    ps, vs = [p for p, _ in proved], [V for _, V in proved]
    reps_v = drv.batch // len(ps)
    drv.verify(ps * reps_v, vs * reps_v)   # raises unless every proof verifies
    h.say(phase, f"RangeProvingService({range_bits}, device-batched), {n_prove} requests of "
                 f"{range_m} values (benchmarks.py row 4e): lanes 0-3 == the host service's "
                 f"byte for byte, all {n_prove} verify (phase 8's verifier); warmup {warm_s:.2f} "
                 f"s, then one call {prove_s * 1e3:.1f} ms = {n_prove / prove_s:.2f} proofs/s, "
                 f"launches {launches}; the host service {host_s * 1e3 / 4:.1f} ms a proof "
                 f"[{h.card}]")

    # -- BASELINE.json config 3: batched Schnorr -----------------------------
    t0 = time.perf_counter()
    per = -(-n_sigs // N_WORKERS)
    futs = [h.pool.submit(schnorr_slice, f, min(per, n_sigs - f)) for f in range(0, n_sigs, per)]
    made = [x for f in futs for x in f.result()]
    sign_s = time.perf_counter() - t0
    sigs = [(Signature.from_bytes(sb), VerificationKey(vb[:32], vb[32:])) for sb, vb in made]

    def items_of(forge=False):
        out = [(sig, schnorr_transcript(i), vk) for i, (sig, vk) in enumerate(sigs)]
        if forge:
            sig, t, vk = out[7]
            out[7] = (Signature((sig.s + 1) % ex.L, sig.R), t, vk)
        return out

    spent = {}
    real_verify = DeferredPointChecks.verify

    def timed_verify(self, backend="auto", device="cuda", mesh=None):
        spent["terms"] = self.num_terms
        h.sync()
        t = time.perf_counter()
        try:
            return real_verify(self, backend, device, mesh)
        finally:
            h.sync()
            spent[backend] = (time.perf_counter() - t) * 1e3

    real_msm = qmsm.msm

    def timed_msm(*a, **k):
        spent["terms"] = a[0].shape[0]
        h.sync()
        t = time.perf_counter()
        try:
            return real_msm(*a, **k)
        finally:
            h.sync()
            spent["device-batched"] = (time.perf_counter() - t) * 1e3

    walls, msm_ms, launches = {}, {}, {}
    DeferredPointChecks.verify = timed_verify
    try:
        for backend in ("device", "device-batched", "host"):
            cb.reset_launches()
            if backend == "device":
                seen, restore = h.keep_calls([(qmsm, "msm", "msm")])
            elif backend == "device-batched":
                qmsm.msm = timed_msm
            t = time.perf_counter()
            try:
                Signature.batch_verify(items_of(), backend=backend, seed=b"chip-smoke-3",
                                       device=dev)
            finally:
                if backend == "device":
                    restore()
                qmsm.msm = real_msm
            walls[backend] = (time.perf_counter() - t) * 1e3
            msm_ms[backend] = spent[backend]   # before the forged call's
            if backend != "host":
                launches[backend] = _launched(cb)
                want = set(msm_kernels) | ({"keccak_f1600", "ristretto_decode"}
                                           if backend == "device-batched" else set())
                check(set(launches[backend]) == want,
                      f"Schnorr {backend} launches {launches[backend]}")
            if backend == "device-batched":
                check(spent["terms"] == 3 * n_sigs,
                      f"the device-batched MSM holds {spent['terms']} terms")
            rejected(lambda: Signature.batch_verify(items_of(forge=True), backend=backend,
                                                    seed=b"chip-smoke-3", device=dev))
    finally:
        DeferredPointChecks.verify = real_verify
        qmsm.msm = real_msm
    msm3 = seen["msm"][0]
    check(msm3[0].shape[0] == spent["terms"], f"the Schnorr MSM holds {spent['terms']} terms")
    schnorr = types.SimpleNamespace(items_of=items_of, msm=msm3, call_ms=walls["device"])
    h.say(phase, f"Signature.batch_verify of {n_sigs} signatures ({spent['terms']} terms, "
                 f"BASELINE.json config 3; signed in {sign_s:.1f} s by {N_WORKERS} worker "
                 f"processes): accepted by device, device-batched and host, one forged s "
                 f"rejected by all three; "
                 + "; ".join(f"{b} call {walls[b]:.1f} ms, of it the MSM {msm_ms[b]:.2f} ms "
                             f"({100 * msm_ms[b] / walls[b]:.1f}%)"
                             + (f", launches {launches[b]}" if b in launches else "")
                             for b in ("device", "device-batched", "host"))
                 + f" [{h.card}]")

    # -- the kernels at this phase's shapes ------------------------------------
    held(msm5, f"5d's merged MSM ({msm5[0].shape[0]} points)")
    held(msm6, f"6c's merged MSM ({msm6[0].shape[0]} points)")
    held(msm3, f"the Schnorr MSM ({msm3[0].shape[0]} points)")
    h.say(phase, f"kernels == plain versions at this phase's shapes: msm_table / msm_acc / "
                 f"msm_tail on 5d's merged MSM ({msm5[0].shape[0]} points), 6c's "
                 f"({msm6[0].shape[0]}) and the Schnorr MSM ({msm3[0].shape[0]}); max_abs_err "
                 f"{ {k: h.err[k] for k in msm_kernels} }")

    # -- the resident daemon and a fresh client process ------------------------
    d = tempfile.mkdtemp(prefix="qq")
    sock = os.path.join(d, "d.sock")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = open(os.path.join(d, "daemon.log"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "quisquis_tpu_torch.daemon", "--socket", sock,
                             "--device", dev.type, *daemon_shapes],
                            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        rl = [range_lane(i) for i in range(DAEMON_RANGES)]
        rseeds = [b"chip-smoke-daemon-%d" % i for i in range(DAEMON_RANGES)]
        inputs = {"shuffles": [b.hex() for b in blobs], "flip": _ddh_z_offset(blobs[0]),
                  "pairs": [[a.hex(), b.hex()] for a, b in pairs],
                  "ranges": {"n": range_bits, "values": [v for v, _, _ in rl],
                             "blindings": [b for _, b, _ in rl],
                             "seeds": [s.hex() for s in rseeds]},
                  "pwned": os.path.join(d, "pwned")}
        with open(os.path.join(d, "in.json"), "w") as f:
            json.dump(inputs, f)
        client = subprocess.run([sys.executable, "-c", DAEMON_CLIENT, sock,
                                 os.path.join(d, "in.json")],
                                cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        check(client.returncode == 0, f"daemon client exited {client.returncode}: "
                                      f"{client.stderr[-2000:]}")
        out = json.loads(client.stdout.strip().splitlines()[-1])
        check(stat.S_IMODE(os.stat(sock + ".key").st_mode) == 0o600, "the key file is 0600")
        check(stat.S_IMODE(os.stat(d).st_mode) == 0o700, "the daemon's directory is 0700")
        qdaemon.DeviceClient(sock).shutdown()
        rc = proc.wait(timeout=120)
        total_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.seek(0)
        daemon_log = log.read()
        log.close()
    check(rc == 0, f"the daemon exited {rc} after shutdown: {daemon_log[-2000:]}")
    check(out["ping"] == dev.type, f"ping {out['ping']}")
    check(out["shuffles"] == len(blobs), "the daemon verified the shuffle entries")
    check(out["tamper"].startswith("ValueError"), f"tampered entry: {out['tamper']}")
    for (pb, V), (v, b, _), s in zip(out["ranges"], rl, rseeds):
        want, want_V = RangeProof.prove_multiple(Transcript(b"RangeProof"), v, b, range_bits,
                                                 rng=SeededRng(seed=s))
        check(bytes.fromhex(pb) == want.to_bytes() and [bytes.fromhex(x) for x in V] == want_V,
              "the daemon's range proofs == the host prover's")
    check(out["tx"] == len(pairs), "the daemon verified the transactions")
    check(out["pickle"].startswith("error"), f"pickle frame: {out['pickle']}")
    check(not os.path.exists(inputs["pwned"]), "the pickle frame had no effect")
    check(out["wrong_key"] == "refused", "a client with a wrong key is refused")
    check(not out["torch_loaded"] and not out["cuda_modules"],
          f"the client loaded torch {out['torch_loaded']}, {out['cuda_modules']}")
    warm = [ln for ln in daemon_log.splitlines() if ln.startswith("warmup")]
    h.say(phase, f"daemon ({' '.join(daemon_shapes)}; {'; '.join(warm)}): a fresh client "
                 f"process pinged ({out['ping']}), verified the {len(blobs)} entries on "
                 f"device-batched in {out['shuffle_s'][0] * 1e3:.1f} ms (first request) and "
                 f"{out['shuffle_s'][1] * 1e3:.1f} ms (second), proved {DAEMON_RANGES} ranges "
                 f"on device-batched in {out['range_s'] * 1e3:.1f} ms (== the host prover's), "
                 f"verified {out['tx']} wire transactions in {out['tx_s'] * 1e3:.1f} ms; a "
                 f"tampered entry raised ValueError, a wrong key was refused, a pickle frame was "
                 f"answered error without effect, the key file is 0600 in a 0700 directory, the "
                 f"client imported no torch; shutdown, exit 0; {total_s:.1f} s in all "
                 f"[{h.card}]")
    shutil.rmtree(d, ignore_errors=True)
    return schnorr


def phase_sharded(h, d, world=SHARDED_WORLD, reps=SHARDED_REPS):
    """The sharded paths (quisquis_tpu_torch/parallel) at the earlier
    phases' full widths: `world` ranks of parallel.launch on this one card
    (gloo: NCCL refuses two ranks on one GPU), then one rank over NCCL.
    Every rank's result must equal the single-device one (the MSM at the
    canonical value, proofs byte for byte and field for field), every
    tampered batch is rejected on every rank, and every kernel of each path
    launched on every rank; medians of `reps` calls by the host clock beside
    the single-device time of the same call. `d`: the earlier phases'
    batches and single-device times."""
    from quisquis_tpu_torch import parallel
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import msm as qmsm
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.transaction import batch_verify_transactions

    phase, dev, t_phase = h.phase, h.dev, time.perf_counter()
    msm_kernels = ("msm_table", "msm_acc", "msm_tail")
    nib, pts = d.schnorr.msm
    nib, pts = nib.cpu(), pt.ExtPoint(*(c.cpu() for c in pts))

    def encode(p):
        return ex.ristretto_encode(pt.to_exact_batch(pt.ExtPoint(*(c[None].cpu() for c in p)))[0])

    want_msm = encode(qmsm.msm(nib.to(dev), pt.ExtPoint(*(c.to(dev) for c in pts))))
    single = dict(d.single_ms)
    single["msm"] = h.median_ms(lambda: qmsm.msm(nib.to(dev), pt.ExtPoint(*(c.to(dev)
                                                                            for c in pts))),
                                reps=reps)[0]
    single["transactions"] = h.median_ms(lambda: batch_verify_transactions(
        d.txs, backend="device", seed=b"chip-smoke-sharded", device=dev), reps=reps)[0]
    proofs, commitments = d.range_verify
    lane = len(proofs) * 3 // 4                       # a lane of the last rank
    bad_range = list(proofs)
    blob = bytearray(proofs[lane].to_bytes())
    blob[130] ^= 1                                    # t_x
    bad_range[lane] = type(proofs[0]).from_bytes(bytes(blob))
    bad_shuffles = shuffle_tampered(d.shuffles, "ddh z", len(d.shuffles) * 3 // 4)
    range_args, range_proofs, range_v = d.range_prove
    shuffle_args, shuffle_proofs = d.shuffle_prove
    seed = b"chip-smoke-sharded"
    calls = [
        ("collectives", "collectives", (160 * nib.shape[0],), 1),  # the accumulator's bytes
        ("msm", "msm", (nib, pts)),
        ("schnorr", "schnorr", (d.schnorr.items_of(), b"chip-smoke-3")),
        ("schnorr forged", "schnorr", (d.schnorr.items_of(forge=True), b"chip-smoke-3"), 1),
        ("range verify", "range_verify", (RANGE_N, RANGE_M, proofs, commitments, seed)),
        ("range verify tampered", "range_verify", (RANGE_N, RANGE_M, bad_range, commitments,
                                                   seed), 1),
        ("shuffle verify", "shuffle_verify", (SHUFFLE_M, d.shuffles, seed)),
        ("shuffle verify tampered", "shuffle_verify", (SHUFFLE_M, bad_shuffles, seed), 1),
        ("range prove", "range_prove", (RANGE_N, RANGE_M, *range_args)),
        ("shuffle prove", "shuffle_prove", (SHUFFLE_M, *shuffle_args)),
        ("transactions", "transactions", (d.txs, seed, RANGE_N)),
        ("transactions tampered", "transactions",
         (tx_tampered(d.txs, "sigma response", 3), seed, RANGE_N), 1),
    ]
    kernels = {"msm": msm_kernels, "schnorr": msm_kernels,
               "range verify": (*SLICE2, "ristretto_decode"),
               "shuffle verify": (*SHUFFLE_KERNELS, *CODEC),
               "range prove": (*SLICE2, "ristretto_encode"), "shuffle prove": (*SLICE2, *CODEC),
               "transactions": msm_kernels}
    t0 = time.perf_counter()
    reports = parallel.launch(SHARDED_PROGRAM, world, dev.type, timeout_s=600, args=(calls, reps))
    world_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = parallel.launch(SHARDED_PROGRAM, 1, dev.type, timeout_s=300,
                           args=([c for c in calls if c[0] in ("collectives", "msm",
                                                               "range verify")], reps))
    nccl_s = time.perf_counter() - t0
    check([r["backend"] for r in reports] == ["gloo"] * world and nccl[0]["backend"] == "nccl",
          f"backends: {[r['backend'] for r in reports]} and {nccl[0]['backend']}")

    def outcomes(reps_, label):
        return [r[label]["outcome"] for r in reps_]

    for reps_ in (reports, nccl):
        check(outcomes(reps_, "msm") == [("ok", want_msm)] * len(reps_),
              f"sharded_msm of {nib.shape[0]} points == the single-device msm (canonical)")
        check(outcomes(reps_, "range verify") == [("ok", None)] * len(reps_),
              "range verify_sharded accepts the honest batch")
    want = {"schnorr": None, "range verify": None, "shuffle verify": None, "transactions": None,
            "range prove": ([p.to_bytes() for p in range_proofs], list(range_v)),
            "shuffle prove": [tuple(x) for x in shuffle_proofs]}
    for label, value in want.items():
        got = outcomes(reports, label)
        if label == "shuffle prove":
            got = [(o[0], [tuple(x) for x in o[1]]) if o[0] == "ok" else o for o in got]
        check(got == [("ok", value)] * world, f"sharded {label} == the single-device result")
    for label in ("schnorr forged", "range verify tampered", "shuffle verify tampered",
                  "transactions tampered"):
        got = outcomes(reports, label)
        check(got[0][0] == "ValueError" and got == [got[0]] * world,
              f"{label}: rejected alike on every rank ({got})")
    for reps_ in (reports, nccl):
        for r in reps_:
            for label, names in kernels.items():
                if label in r:
                    check(set(r[label]["launches"]) == set(names),
                          f"rank launches of {label}: {r[label]['launches']}")
    lines = []
    for label in ("msm", "schnorr", "range verify", "shuffle verify", "range prove",
                  "shuffle prove", "transactions"):
        ms = [r[label]["median_s"] * 1e3 for r in reports]
        line = (f"{label}: world {world} median of {reps} {max(ms):.1f} ms (ranks "
                f"{' / '.join(f'{m:.1f}' for m in ms)}), single device {single[label]:.1f} ms")
        if label in nccl[0]:
            line += f", world 1 NCCL {nccl[0][label]['median_s'] * 1e3:.1f} ms"
        lines.append(line + f"; launches a rank {reports[0][label]['launches']}")
    h.say(phase, f"sharded paths on {world} ranks sharing this card (backend gloo, the host "
                 f"staging the collectives) and on 1 rank (backend nccl): every result == the "
                 f"single-device one (sharded_msm of {nib.shape[0]} points at the canonical "
                 f"value, {len(range_proofs)} range proofs byte for byte, {len(shuffle_proofs)} "
                 f"shuffle proofs field for field, Schnorr config 3, range and shuffle "
                 f"verify_sharded, {len(d.txs)} transactions accepted); a forged signature, a "
                 f"tampered lane on rank 1 of each verifier and a tampered transaction rejected "
                 f"alike on every rank; launches {world_s:.1f} s (world {world}) and "
                 f"{nccl_s:.1f} s (world 1) with start-up [{h.card}]")
    for name, reps_ in ((f"world {world}, gloo", reports), ("world 1, nccl", nccl)):
        ops = reps_[0]["collectives"]["outcome"][1]
        h.say(phase, f"collectives, {name}, median of 20 on rank 0: "
                     + ", ".join(f"{k} {v:.3f} ms" for k, v in ops.items()) + f" [{h.card}]")
    for line in lines:
        h.say(phase, line + f" [{h.card}]")
    h.say(phase, f"phase {phase} took {time.perf_counter() - t_phase:.1f} s")


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.perf_counter()


def say(phase, msg: str) -> None:
    print(f"phase {phase}: [{time.perf_counter() - _T0:.1f} s] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn):
    """fn's output and its device time in ms, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profile_line(fn, card: str, what: str, names) -> str:
    """Device time by kernel and the device's busy share over one call of
    fn, from torch.profiler's kernel events (wall time on the host clock,
    with the profiler's own overhead). names: the CUDA kernels to list.
    Only device activity is recorded: the busy share reads kernel events
    alone, and the host events of a prove (a few hundred thousand) took
    the profiler about two minutes to collect."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "torch.profiler recorded no device kernels: busy share not measured"
    by_name = {f"{k}_kernel": 0.0 for k in names}
    by_name["torch ops"] = 0.0
    spans = []
    for e in kernels:
        key = next((k for k in by_name if k in e.name), None)
        if key is None:  # the codec kernels, listed where they ran
            key = next((f"{k}_kernel" for k in CODEC if f"{k}_kernel" in e.name), "torch ops")
            by_name.setdefault(key, 0.0)
        by_name[key] += e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in by_name.items())
    return (f"profiled {what}: {len(kernels)} kernels; {parts}; device busy "
            f"{busy / 1e3:.3f} of {wall_us / 1e3:.3f} ms wall = {busy / wall_us:.3f} "
            f"(idle {1 - busy / wall_us:.3f}) [{card}]")


def range_lane(i: int):
    """Range lane i's values, blindings and rng (from its own seed), as the
    host prover gets them."""
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    prng = SeededRng(seed=b"chip-smoke-range-%d" % i)
    values = [int.from_bytes(prng.fill_bytes(RANGE_N // 8), "little") for _ in range(RANGE_M)]
    blindings = [prng.random_scalar() for _ in range(RANGE_M)]
    return values, blindings, prng


def prove_and_check(i: int):
    """Worker process: one aggregated range proof (n = 64, m = 16) from the
    port's host prover, checked by the port's host verifier. Returns the
    proof's bytes, its value commitments, the prover transcript's snapshot
    after the proof and the host prove time in seconds."""
    sys.path.insert(0, REPO)
    from quisquis_tpu_torch.accounts.transcript import Transcript
    from quisquis_tpu_torch.bulletproofs.generators import bulletproof_gens
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.ops.device_strobe import snapshot_host_strobe
    values, blindings, prng = range_lane(i)
    t = Transcript(b"RangeProof")
    bulletproof_gens(RANGE_N, RANGE_M)   # the generators (pure Python) are not the proof's time
    t0 = time.perf_counter()
    proof, commitments = RangeProof.prove_multiple(t, values, blindings, RANGE_N, rng=prng)
    prove_s = time.perf_counter() - t0
    proof.verify_multiple(Transcript(b"RangeProof"), commitments, RANGE_N)  # raises if wrong
    return proof.to_bytes(), commitments, snapshot_host_strobe(t.strobe), prove_s


def shuffle_proof(accounts, tag: bytes):
    """Worker process: one shuffle of `accounts` and its proof from the
    port's host prover, checked by the port's host verifier. Returns
    ((proof, statement, inputs, outputs), the Shuffle, a copy of its rng
    taken just before the proof, the host prove time in seconds)."""
    sys.path.insert(0, REPO)
    from quisquis_tpu_torch.accounts.prover import Prover
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.accounts.verifier import Verifier
    from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
    rng = SeededRng(seed=tag)
    shuffle = Shuffle.input_shuffle(accounts, rng=rng)
    before = copy.deepcopy(rng)
    t0 = time.perf_counter()
    proof, statement = ShuffleProof.create_shuffle_proof(
        Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), shuffle, rng=rng)
    prove_s = time.perf_counter() - t0
    entry = (proof, statement, shuffle.get_inputs_vector(), shuffle.get_outputs_vector())
    proof.verify(Verifier(b"Shuffle", Transcript(b"ShuffleProof")), *entry[1:])  # raises if wrong
    return entry, shuffle, before, prove_s


def sigma_rows(kind: str, accounts, eps, proof, sample):
    """The host Verifier's first-message recomputations (the multiscalar
    rows of verifier.py) of the sampled accounts: (e_delta, f_delta,
    e_epsilon, f_epsilon) per account for "dleq", (e, f) for "dlog"."""
    from quisquis_tpu_torch.ops import exact as ex
    rows = []
    if kind == "dleq":
        zv, zr1, zr2, x = proof
        for i in sample:
            d, e = accounts[i], eps[i]
            rows += [([zr1[i], x], [d.pk.gr_point, d.comm.c_point]),
                     ([zr1[i], x, zv[i]], [d.pk.grsk_point, d.comm.d_point, ex.BASEPOINT]),
                     ([zr2[i], x], [e.pk.gr_point, e.comm.c_point]),
                     ([zr2[i], x, zv[i]], [e.pk.grsk_point, e.comm.d_point, ex.BASEPOINT])]
    else:
        z, x = proof
        for i in sample:
            a = accounts[i]
            rows += [([z[i], x], [a.pk.gr_point, a.comm.c_point]),
                     ([z[i], x], [a.pk.grsk_point, a.comm.d_point])]
    return ex.ristretto_encode_batch(ex.pt_msm_many(rows))


def sigma_proof(kind: str, blobs, eps_blobs, rscalars, values, sample):
    """Worker process: a delta-compact ("dleq") or zero-balance ("dlog")
    sigma proof over the accounts (wire bytes) from the port's host prover,
    and the host Verifier's first messages of the sampled accounts.
    Returns (proof fields, encodings)."""
    sys.path.insert(0, REPO)
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.prover import Prover
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    accounts = [Account.from_bytes(b) for b in blobs]
    eps = [Account.from_bytes(b) for b in eps_blobs]
    rng = SeededRng(seed=b"chip-smoke-sigma-%s-%d" % (kind.encode(), len(blobs)))
    if kind == "dleq":
        proof = Prover.verify_delta_compact_prover(
            accounts, eps, rscalars, values,
            Prover(b"DLEQProof", Transcript(b"DeltaCompact"), rng=rng)).get_dleq()
    else:
        proof = Prover.zero_balance_account_vector_prover(
            accounts, rscalars, Prover(b"DLOGProof", Transcript(b"ZeroBalance"), rng=rng)
        ).get_dlog()
    return proof, sigma_rows(kind, accounts, eps, proof, sample)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import quisquis_tpu_torch  # noqa: F401  (fails here, before any process starts, outside a checkout)
    become_subreaper()
    try:
        # the host provers (the C++ curve and STROBE under Python) run in
        # worker processes, the range proofs beside phases 2-5 (waited for
        # before phase 6), the sigma and shuffle proofs after phase 9's
        # timed calls
        with ProcessPoolExecutor(N_WORKERS, mp_context=get_context("spawn")) as pool:
            return phases(pool)
    finally:
        stop_children()


def become_subreaper() -> None:
    """Make this process the subreaper of its descendants (Linux
    prctl PR_SET_CHILD_SUBREAPER), so that an orphan, such as a worker of a
    forkserver that has exited, becomes its child and stop_children finds
    it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:   # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _descendants() -> list:
    """This process's live descendants, children first, from /proc."""
    parent = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    # pid (comm) state ppid ...: comm may hold spaces and ")"
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except OSError:
                continue
            if state != "Z":
                parent[int(name)] = int(ppid)
    out, frontier = [], [os.getpid()]
    while frontier:
        frontier = [pid for pid, pp in parent.items() if pp in frontier]
        out += frontier
    return out


def stop_children(timeout_s: float = 30.0) -> None:
    """Stop every process this run started and wait for it to end.

    The serving layer's forkserver lives until no process holds its "alive"
    pipe, and multiprocessing's resource tracker until no process holds its
    pipe: this process holds both until it exits, and every worker the
    forkserver forked holds both too. So the workers and any other
    descendant go first: each gets `timeout_s` to exit (a closed service's
    have exited already) and is then killed, named on stderr. Then the
    forkserver and the tracker are stopped through multiprocessing's own
    stop methods, which close this process's end of the pipe and wait."""
    from multiprocessing import forkserver, resource_tracker

    server, tracker = forkserver._forkserver, resource_tracker._resource_tracker
    _reap({server._forkserver_pid, tracker._pid}, timeout_s)
    for stop in (server._stop, tracker._stop):
        try:
            stop()
        except ChildProcessError:   # it had died, and _reap collected it
            pass
    _reap(set(), timeout_s)


def _reap(keep: set, timeout_s: float) -> None:
    """Wait up to `timeout_s` for every descendant not in `keep` to exit,
    then kill what is left; an orphan of a dead parent is this subreaper's
    child, and the exited children are collected."""
    import signal

    deadline, killed = time.monotonic() + timeout_s, False
    while True:
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        left = [pid for pid in _descendants() if pid not in keep]
        if not left:
            return
        if time.monotonic() > deadline:
            if killed:
                print(f"chip_smoke: processes {left} outlived SIGKILL", file=sys.stderr)
                return
            for pid in left:
                print(f"chip_smoke: killed leftover process {pid}: {_cmdline(pid)}",
                      file=sys.stderr)
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            killed, deadline = True, time.monotonic() + timeout_s
        time.sleep(0.1)


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")[:200]
    except OSError:
        return "?"


def phases(pool) -> int:
    from quisquis_tpu_torch.accounts import device_verifier as dvf
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
    from quisquis_tpu_torch.accounts.device_accounts import (
        create_delta_and_epsilon_accounts_device, update_accounts_device)
    from quisquis_tpu_torch.accounts import transcript as transcript_mod
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.accounts.verifier import Verifier
    from quisquis_tpu_torch.bulletproofs import device_prove as rdp
    from quisquis_tpu_torch.bulletproofs.device_verify import DeviceRangeVerifier
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.kernel_ab import graph_ms, median_ms
    from quisquis_tpu_torch.ops import batch as qb
    from quisquis_tpu_torch.ops import cuda_build as cb
    from quisquis_tpu_torch.ops import cuda_keccak as kk
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import device_keccak as dk
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import field as fe
    from quisquis_tpu_torch.ops import host_curve as hc
    from quisquis_tpu_torch.ops import host_strobe as hs
    from quisquis_tpu_torch.ops import keccak as host_keccak
    from quisquis_tpu_torch.ops import msm as qmsm
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.ops.device_strobe import snapshot_host_strobe
    from quisquis_tpu_torch.primitives.elgamal import ElGamalCommitment
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from quisquis_tpu_torch.shuffle import device_prove as sdp
    from quisquis_tpu_torch.shuffle import device_verify as sdv
    from quisquis_tpu_torch.shuffle.device_verify import DeviceShuffleVerifier, device_batch_verify
    from quisquis_tpu_torch.shuffle.shuffle import (batch_create_shuffle_proofs,
                                                    batch_verify_shuffle_proofs)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # -- phase 1 --------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_peak = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    say(1, f"device {kind} x{torch.cuda.device_count()}; {sms} SMs, max SM clock "
           f"{max_sm_mhz} MHz; torch {torch.__version__} CUDA {torch.version.cuda}")

    # -- phase 2 --------------------------------------------------------
    proving = [pool.submit(prove_and_check, i) for i in range(N_PROOFS)]
    srng = SeededRng(seed=b"chip-smoke-shuffle-accounts")
    shuffle_sets = {}
    for m_ in (SHUFFLE_M, SHUFFLE_M_SMALL):
        shuffle_sets[m_] = [Account.generate_account(RistrettoPublicKey.from_secret_key(
            RistrettoSecretKey.random(srng), srng), srng)[0] for _ in range(m_ * m_)]
    cb.load_library()
    say(2, f"{len(cb.KERNELS)} kernels in {len(cb.KERNEL_SOURCES)} sources built or loaded in "
           f"{cb.build_seconds():.1f} s")
    check(hs.available(), f"the C++ host STROBE builds and loads: {hs.build_error()}")
    check(transcript_mod.Strobe128 is hs.NativeStrobe128,
          "the host transcripts use the C++ STROBE")
    check(hc.available(), f"the C++ host curve builds and loads: {hc.build_error()}")
    check(ex.NATIVE_CURVE and ex.pt_msm is not ex.pt_msm_py,
          "ops/exact.py dispatches the host points to the C++ curve")
    say(2, f"C++ host STROBE (csrc/host_strobe.cpp): "
           f"{'compiled by g++' if hs.compiled() else 'an earlier build loaded'} in "
           f"{hs.build_seconds():.3f} s at the first import of the transcripts; the host "
           f"transcripts use it")
    say(2, f"C++ host curve (csrc/host_curve.cpp): "
           f"{'compiled by g++' if hc.compiled() else 'an earlier build loaded'} in "
           f"{hc.build_seconds():.3f} s at the package's import; ops/exact.py dispatches the "
           f"host point arithmetic to it")
    for line in cb.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    def scalar_bytes(n):  # uniform below 2^252 < l
        b = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        b[:, 31] &= 0x0F
        return b

    def small_bytes(n, nbytes=4):  # values < 2^32
        b = np.zeros((n, 32), dtype=np.uint8)
        b[:, :nbytes] = rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)
        return b

    def nib_of(b):
        return torch.as_tensor(pt.scalar_to_nibbles(b), device=dev)

    def ints_of(b, rows):
        return [int.from_bytes(bytes(b[i]), "little") for i in rows]

    def canon_err(a: pt.ExtPoint, b: pt.ExtPoint) -> int:
        return max(int((fe.canonicalize(x).long() - fe.canonicalize(y).long()).abs().max())
                   for x, y in zip(a, b))

    def limb_err(a: pt.ExtPoint, b: pt.ExtPoint) -> int:
        return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))

    def scalars_of(nibbles):  # [n, 64] digits -> python ints, not reduced mod l
        weights = 16 ** np.arange(64, dtype=object)
        return [int(v) for v in (nibbles.cpu().numpy().astype(object) * weights).sum(axis=1)]

    # -- phase 3: each kernel against its plain version -------------------
    many15 = int("f" * 63, 16) % ex.L
    edge = [0, 1, ex.L - 1, 2**252, many15, 15, 16, 2**252 - 1]
    check_b = scalar_bytes(B_CHECK)
    for i, s in enumerate(edge):
        check_b[i] = np.frombuffer(ex.sc_to_bytes(s), dtype=np.uint8)
    nib3 = nib_of(check_b)
    # scalar_mul takes any 256-bit integer: rows 8-13 carry into the 65th
    # signed digit, and rows 11-13 act on the identity, a point of order 8
    # and a point with an 8-torsion component
    raw = [2**256 - 1, 8 * 16**63 + 12345, 15 * 16**63 + 67890, 2**256 - 1,
           15 * 16**63 + 1, ex.L - 1]
    nib_sm = nib3.clone()
    nib_sm[8:14] = torch.as_tensor([[(v >> (4 * w)) & 15 for w in range(64)] for v in raw],
                                   dtype=torch.int32, device=dev)
    base3 = pt.base_mul(nib_of(scalar_bytes(B_CHECK)))  # plain torch on the card
    host_pts = pt.to_exact_batch(pt.ExtPoint(*(c[:14] for c in base3)))
    t8 = ex.eight_torsion()
    host_pts[11:14] = [ex.IDENTITY, t8, ex.pt_add(host_pts[13], t8)]
    for c, e in zip(base3, pt.from_exact_batch(host_pts[11:14], dev)):
        c[11:14] = e
    err = {}
    k_out = kp.scalar_mul(nib_sm, base3)
    err["scalar_mul"] = limb_err(k_out, pt.scalar_mul(nib_sm, base3))
    check(err["scalar_mul"] == 0, "scalar_mul kernel == plain, limb for limb")
    got3 = pt.to_exact_batch(pt.ExtPoint(*(c[:14] for c in k_out)))
    for i, v in enumerate(scalars_of(nib_sm[:14])):
        check(ex.pt_same(got3[i], ex.pt_mul_int(v, host_pts[i])), f"scalar_mul row {i} == exact")
    # base_mul: the 8 edge scalars, and rows 8-10 at 2^256 - 1 and top
    # nibbles 8 and 15 (B has order l: the exact value is v mod l)
    nib_bm = nib3.clone()
    nib_bm[8:11] = nib_sm[8:11]
    k_out = kp.base_mul(nib_bm)
    err["base_mul"] = limb_err(k_out, pt.base_mul(nib_bm))
    check(err["base_mul"] == 0, "base_mul kernel == plain, limb for limb")
    k_enc = encodings(pt.ExtPoint(*(c[:11] for c in k_out)))
    for i, v in enumerate(scalars_of(nib_bm[:11])):
        check(bytes(k_enc[i]) == ex.ristretto_encode(ex.pt_base_mul(v % ex.L)),
              f"base_mul row {i} == exact")
    check(max(err.values()) == 0, f"max_abs_err {err}")
    torch.cuda.synchronize()
    say(3, f"kernels == plain versions limb for limb on the card at B={B_CHECK} (edge "
           f"scalars included), scalar_mul 14 rows (up to 2^256-1, identity, 8-torsion) "
           f"and base_mul 11 rows (up to 2^256-1) == exact at canonical encodings; "
           f"max_abs_err {err}")

    # -- phase 4: the main path at full width -----------------------------
    n = N_MAIN
    key_b, sk_b, r_b, uk_b, cs_b = (scalar_bytes(n) for _ in range(5))
    v_b, bl_b = small_bytes(n), small_bytes(n)
    vsum = v_b[:, :8].copy().view(np.uint64)[:, 0] + bl_b[:, :8].copy().view(np.uint64)[:, 0]
    vsum_b = np.zeros((n, 32), dtype=np.uint8)
    vsum_b[:, :8] = vsum.astype("<u8").reshape(n, 1).view(np.uint8)
    key_n, sk_n, r_n, uk_n, cs_n, v_n, bl_n, vsum_n = map(
        nib_of, (key_b, sk_b, r_b, uk_b, cs_b, v_b, bl_b, vsum_b))
    torch.cuda.synchronize()

    def slice1_launches(since=None):
        return {k: cb.LAUNCHES[k] - (since[k] if since else 0) for k in SLICE1}

    cb.reset_launches()
    t0 = time.perf_counter()
    gr = kp.base_mul(key_n)
    pk = qb.BatchPk(gr, kp.scalar_mul(sk_n, gr))
    before = slice1_launches()
    comm = qb.generate_commitments(pk, r_n, v_n)
    ok0 = qb.verify_commitments(comm, sk_n, v_n)
    flagship = slice1_launches(before)
    before = slice1_launches()
    new_pk, new_comm = qb.update_accounts(pk, comm, bl_n, uk_n, cs_n)
    per_update = slice1_launches(before)
    ok1 = qb.verify_commitments(new_comm, sk_n, vsum_n)
    ok2 = qb.verify_keypairs(new_pk, sk_n)
    j = int(rng.integers(0, n))
    bad_d = pt.ExtPoint(*(c.clone() for c in new_comm.d))
    for c, src in zip(bad_d, new_comm.d):
        c[j] = src[(j + 1) % n]
    ok3 = qb.verify_commitments(qb.BatchCommitment(new_comm.c, bad_d), sk_n, vsum_n)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = dict(cb.LAUNCHES)
    check(all(main_launches[k] == 0 for k in SLICE2), "slice 1's path launches no MSM or Keccak")
    check(flagship == {"scalar_mul": 3, "base_mul": 2}, f"flagship launches {flagship}")
    check(per_update == {"scalar_mul": 4, "base_mul": 1}, f"update launches {per_update}")
    check(slice1_launches() == {"scalar_mul": 11, "base_mul": 6},
          f"main launches {main_launches}")
    check(bool(ok0.all()), "flagship verify: every lane true")
    check(bool(ok1.all()), "verify_commitments after update: every lane true")
    check(bool(ok2.all()), "verify_keypairs after update: every lane true")
    check(torch.nonzero(~ok3).flatten().tolist() == [j], f"tampered lane {j} fails alone")
    lanes = sorted(rng.choice(n, size=32, replace=False).tolist())
    idx = torch.as_tensor(lanes, device=dev)

    def enc_rows(p):
        return [bytes(r) for r in encodings(pt.ExtPoint(*(c[idx] for c in p)))]

    got = [enc_rows(p) for p in (new_pk.gr, new_pk.grsk, new_comm.c, new_comm.d)]
    ks, sks, rs, uks, css = (ints_of(b, lanes) for b in (key_b, sk_b, r_b, uk_b, cs_b))
    vs, bls = ints_of(v_b, lanes), ints_of(bl_b, lanes)
    for i in range(len(lanes)):
        g = ex.pt_base_mul(ks[i])
        h = ex.pt_mul(sks[i], g)
        c = ex.pt_add(ex.pt_mul(css[i], g), ex.pt_mul(rs[i], g))
        d = ex.pt_add(ex.pt_add(ex.pt_base_mul(bls[i]), ex.pt_mul(css[i], h)),
                      ex.pt_add(ex.pt_base_mul(vs[i]), ex.pt_mul(rs[i], h)))
        want = [ex.pt_mul(uks[i], g), ex.pt_mul(uks[i], h), c, d]
        for k in range(4):
            check(got[k][i] == ex.ristretto_encode(want[k]), f"lane {lanes[i]} coord {k} == exact")
    say(4, f"N={n}: keys, flagship step (launches {flagship}), update_accounts "
           f"(launches {per_update}), verify_commitments + verify_keypairs all {n} lanes "
           f"true, tampered lane {j} alone false, 32 lanes == exact; main path launches "
           f"{slice1_launches()} in {main_s:.3f} s (host clock)")

    # -- phase 5: the Account-object path ---------------------------------
    m = N_ACCOUNTS
    head = torch.arange(m, device=dev)
    wire = [encodings(pt.ExtPoint(*(c[head] for c in p)))
            for p in (new_pk.gr, new_pk.grsk, new_comm.c, new_comm.d)]
    accounts = [Account(RistrettoPublicKey(bytes(wire[0][i]), bytes(wire[1][i])),
                        ElGamalCommitment(bytes(wire[2][i]), bytes(wire[3][i])))
                for i in range(m)]
    prng = SeededRng(seed=b"chip-smoke-accounts")
    bl5 = [int(x) for x in rng.integers(0, 2**32, size=m)]
    uk5 = [prng.random_scalar() for _ in range(m)]
    cs5 = [prng.random_scalar() for _ in range(m)]
    cb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upd = update_accounts_device(accounts, bl5, uk5, cs5, device="cuda")
    upd_s = time.perf_counter() - t0
    base_pk = RistrettoPublicKey.generate_base_pk()
    values = [int(x) for x in rng.integers(0, 2**32, size=m)]
    delta, eps, rs5 = create_delta_and_epsilon_accounts_device(
        accounts, values, base_pk, SeededRng(seed=b"chip-smoke-delta"), device="cuda")
    acct_launches = slice1_launches()
    check(acct_launches == {"scalar_mul": 8, "base_mul": 3}, f"account launches {acct_launches}")
    # encodes: the updated keys' and commitments' four coordinates, the
    # delta and the epsilon commitments' two each; nothing is decoded
    acct_codec = {k: cb.LAUNCHES[k] for k in CODEC}
    check(acct_codec == {"ristretto_decode": 0, "ristretto_encode": 8},
          f"account codec launches {acct_codec}")
    for i in range(16):
        host = Account.update_account(accounts[i], bl5[i], uk5[i], cs5[i])
        check(upd[i].as_bytes() == host.as_bytes(), f"update row {i} == host")
        hd = Account(accounts[i].pk, ElGamalCommitment.generate_commitment(
            accounts[i].pk, rs5[i], values[i]))
        he = Account(base_pk, ElGamalCommitment.generate_commitment(base_pk, rs5[i], values[i]))
        check(delta[i].as_bytes() == hd.as_bytes(), f"delta row {i} == host")
        check(eps[i].as_bytes() == he.as_bytes(), f"epsilon row {i} == host")
    check(sum(rs5) % ex.L == 0, "delta rscalars sum to 0")
    say(5, f"{m} Accounts from phase 4 wire bytes: update_accounts_device + delta/epsilon "
           f"(launches {acct_launches}, {acct_codec}), 16 rows byte-identical to host; "
           f"update_accounts_device "
           f"{upd_s:.3f} s = {m / upd_s:.1f} accounts/s (host clock, host conversions included)")
    # the sigma phase's inputs from these Accounts: delta/epsilon pairs (phase
    # 5's own at n = 1,024) and zero-balance accounts (commitments to 0);
    # the host prover makes the proofs in the worker processes once phase
    # 9's timed calls are over
    sigma = {}
    for n_s in SIGMA_NS:
        d_s, e_s, r_s, v_s = (delta, eps, rs5, values) if n_s == m else (
            *create_delta_and_epsilon_accounts_device(
                accounts[:n_s], values[:n_s], base_pk, SeededRng(seed=b"chip-smoke-sigma-d"),
                device="cuda"), values[:n_s])
        z_s, _, rz_s = create_delta_and_epsilon_accounts_device(
            accounts[:n_s], [0] * n_s, base_pk, SeededRng(seed=b"chip-smoke-sigma-z"),
            device="cuda")
        sample = (list(range(n_s)) if n_s <= SIGMA_SAMPLE else
                  sorted(rng.choice(n_s, size=SIGMA_SAMPLE, replace=False).tolist()))
        sigma[n_s] = {
            "dleq": (d_s, e_s, ("dleq", [a.as_bytes() for a in d_s],
                                [a.as_bytes() for a in e_s], r_s, v_s, sample)),
            "dlog": (z_s, None, ("dlog", [a.as_bytes() for a in z_s], [], rz_s, None, sample)),
            "sample": sample}

    # the range proofs are done before any timed call
    t0 = time.perf_counter()
    proved = [f.result(timeout=900) for f in proving]
    proofs_wait_s = time.perf_counter() - t0

    # -- phase 6: kernels against plain versions at the main path's widths,
    # then times on this card ---------------------------------------------
    plain, plain_ms = {}, {}
    plain["scalar_mul"], plain_ms["scalar_mul"] = time_once(lambda: pt.scalar_mul(sk_n, gr))
    plain["base_mul"], plain_ms["base_mul"] = time_once(lambda: pt.base_mul(key_n))
    main_out = {"scalar_mul": pk.grsk, "base_mul": gr}  # phase 4's own launches
    head_out = {"scalar_mul": kp.scalar_mul(sk_n[:m], pt.ExtPoint(*(c[:m] for c in gr))),
                "base_mul": kp.base_mul(key_n[:m])}
    for name in SLICE1:
        e_main = limb_err(main_out[name], plain[name])
        e_head = limb_err(head_out[name], pt.ExtPoint(*(c[:m] for c in plain[name])))
        check(e_main == 0, f"{name} phase-4 output == plain, limb for limb, N={n}")
        check(e_head == 0, f"{name} kernel == plain, limb for limb, first {m} lanes")
        err[name] = max(err[name], e_main, e_head)
    say(6, f"kernels == plain versions limb for limb on phase 4's inputs at N={n} "
           f"(phase 4's own outputs) and on their first {m} lanes; max_abs_err {err}")
    results = {}
    ms = {"scalar_mul": time_ms(lambda: kp.scalar_mul(sk_n, gr), reps=10, warmup=3),
          "base_mul": time_ms(lambda: kp.base_mul(key_n), reps=10, warmup=3)}
    upd_ms = time_ms(lambda: qb.update_accounts(pk, comm, bl_n, uk_n, cs_n), reps=3)
    lane_bytes = {"scalar_mul": (64 + 8 * fe.NLIMBS) * 4,
                  "base_mul": (64 + 4 * fe.NLIMBS) * 4}
    table_bytes = pt.niels_base_table(dev).numel() * 4

    def bound(ops, nbytes):
        """(ms, "operations" or "bytes"): ops at the int32 rate or nbytes at
        the memory rate, whichever takes longer."""
        t_ops, t_bytes = ops / int32_peak * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def record(phase, name, shape, launches, ops, nbytes, what):
        """One kernel's line of the contract's JSON, and its printed line;
        ops at the int32 rate and nbytes at the memory rate give the bound."""
        b_ms, b_by = bound(ops, nbytes)
        results[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches,
            "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        say(phase, f"{name} {shape}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.2f} ms, "
                   f"bound {results[name]['bound_ms']:.5f} ms ({results[name]['bound_by']}: "
                   f"{ops:.4e} {what} at {int32_peak:.4e}/s, {nbytes:.4e} bytes at "
                   f"{MEM_BYTES_PER_S:.3e}/s), no library call [{card}]")

    for name in SLICE1:
        ops = n * sum(FIELD_OPS[name][k] * PRODUCTS[k] for k in PRODUCTS)
        nbytes = n * lane_bytes[name] + (table_bytes if name == "base_mul" else 0)
        record(6, name, f"N={n}", main_launches[name], ops, nbytes, "32x32->64 limb products")
    say(6, f"update_accounts N={n} on device tensors: {upd_ms:.3f} ms = "
           f"{n / upd_ms * 1e3:.1f} account updates/s [{card}]")
    say(6, profile_line(lambda: qb.update_accounts(pk, comm, bl_n, uk_n, cs_n), card,
                        "update_accounts", SLICE1))

    # -- phase 7: the MSM and Keccak kernels against their plain versions ---
    def same(a: pt.ExtPoint, b: pt.ExtPoint, name: str, what: str) -> None:
        e = limb_err(a, b)
        err[name] = max(err.get(name, 0), e)
        check(e == 0 and a.x.shape == b.x.shape, f"{name} kernel == plain, limb for limb, {what}")

    def stages_against_plain(nibbles, points, what):
        """Each MSM stage on the card against its plain version on the same
        inputs; returns the kernels' result, one point per row."""
        digits, flat = kp.pad_rows(nibbles, points)
        rows = nibbles.shape[0]
        table = kp.msm_table(flat)
        same(table, qmsm.msm_table(flat), "msm_table", what)
        sums = kp.msm_window_sums(digits, table, rows)
        same(sums, qmsm.msm_window_sums(digits, table, rows), "msm_acc", what)
        out = kp.msm_tail(sums)
        same(out, qmsm.msm_tail(sums), "msm_tail", what)
        return out

    p7 = kp.base_mul(nib_of(scalar_bytes(B_CHECK)))
    same(kp.msm_table(p7), qmsm.msm_table(p7), "msm_table", f"{B_CHECK} points")
    for rows, k in ((1, 300), (8, 200)):
        nib7 = nib_of(scalar_bytes(rows * k))
        pts7 = kp.base_mul(nib_of(scalar_bytes(rows * k)))
        nib_rk = nib7.reshape(rows, k, 64)
        pts_rk = pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS) for c in pts7))
        what = f"R={rows} k={k}"
        out7 = stages_against_plain(nib_rk, pts_rk, what)
        whole = kp.msm_rows(nib_rk, pts_rk) if rows > 1 else \
            pt.ExtPoint(*(c[None] for c in kp.msm(nib7, pts7)))
        same(whole, out7, "msm_tail", f"{what}, msm_rows / msm == the three stages")
        enc7 = encodings(whole)
        host_s, host_p = scalars_of(nib7), pt.to_exact_batch(pts7)
        for r in range(rows):
            want = ex.pt_msm(host_s[r * k:(r + 1) * k], host_p[r * k:(r + 1) * k])
            check(bytes(enc7[r]) == ex.ristretto_encode(want), f"msm {what} row {r} == exact")
    err["keccak_f1600"] = 0
    for b7 in (1, 64, 1000):
        st7 = torch.as_tensor(rng.integers(0, 256, size=(b7, 200), dtype=np.uint8), device=dev)
        got7, plain7 = kk.f1600(st7), dk.f1600_plain(st7)
        err["keccak_f1600"] = max(err["keccak_f1600"],
                                  int((got7.int() - plain7.int()).abs().max()))
        check(torch.equal(got7, plain7), f"keccak_f1600 kernel == plain, byte for byte, B={b7}")
        for row in (0, b7 - 1):
            host = bytearray(st7[row].cpu().numpy().tobytes())
            host_keccak.keccak_f1600(host)
            check(bytes(host) == got7[row].cpu().numpy().tobytes(),
                  f"keccak_f1600 B={b7} row {row} == host permutation")
    torch.cuda.synchronize()
    say(7, f"msm_table at {B_CHECK} points, msm_table / msm_acc / msm_tail at N=300 and at "
           f"R=8 k=200 == plain versions limb for limb, msm and msm_rows == exact.pt_msm; "
           f"keccak_f1600 at B=1, 64, 1000 == plain and host permutation byte for byte; "
           f"max_abs_err { {k: err[k] for k in SLICE2} }")

    # -- phase 7b: the ristretto codec kernels at the benchmark's shapes -----
    results.update(phase_codec(types.SimpleNamespace(
        phase="7b", dev=dev, card=card, say=say, bound=bound, sync=torch.cuda.synchronize)))

    # -- phase 8: the range verifier at full width --------------------------
    host_range_s = [p[3] for p in proved]
    say(8, f"{N_PROOFS} range proofs (n={RANGE_N}, m={RANGE_M}) from the port's host prover, "
           f"each accepted by the host verify_multiple (worker processes, done before phase "
           f"6; waited {proofs_wait_s:.1f} s for them after phase 5); host prove "
           + ", ".join(f"{t * 1e3:.1f}" for t in host_range_s) + " ms a proof")
    lanes = [proved[i % N_PROOFS] for i in range(RANGE_BATCH)]
    proofs = [RangeProof.from_bytes(p[0]) for p in lanes]
    commitments = [list(p[1]) for p in lanes]
    drv = DeviceRangeVerifier(RANGE_N, RANGE_M, RANGE_BATCH)
    n_msm = 2 + 2 * drv.nm + RANGE_BATCH * (RANGE_M + 4 + 2 * drv.k)
    drv.warmup()
    wrng = SeededRng(seed=b"chip-smoke-weights")
    cb.reset_launches()
    drv.verify(proofs, commitments, rng=wrng)  # raises unless the batch verifies
    verify_launches = dict(cb.LAUNCHES)
    check(all(verify_launches[k] > 0 for k in SLICE2), f"verify launches {verify_launches}")
    check(all(verify_launches[k] == 0 for k in SLICE1), f"verify launches {verify_launches}")
    check([verify_launches[k] for k in ("msm_table", "msm_acc", "msm_tail")] == [1, 1, 1],
          f"one MSM per verify: {verify_launches}")

    def flipped(proof, at):
        blob = bytearray(proof.to_bytes())
        blob[at] ^= 1
        return RangeProof.from_bytes(bytes(blob))

    tampers = {"a point (A)": 3, "a scalar (t_x)": 130, "an inner-product element (L_0)": 226}
    for lane, (what, at) in enumerate(tampers.items(), start=5):
        bad = list(proofs)
        bad[lane] = flipped(proofs[lane], at)
        try:
            drv.verify(bad, commitments, rng=wrng)
        except ValueError:
            continue
        raise RuntimeError(f"check failed: batch with {what} flipped in lane {lane} was accepted")
    bad_v = [list(v) for v in commitments]
    bad_v[9][1] = bytes([bad_v[9][1][0] ^ 1]) + bad_v[9][1][1:]
    try:
        drv.verify(proofs, bad_v, rng=wrng)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: batch with a value commitment flipped was accepted")
    say(8, f"DeviceRangeVerifier(n={RANGE_N}, m={RANGE_M}, batch={RANGE_BATCH}): one MSM of "
           f"{n_msm} points; honest batch accepted (launches {verify_launches}); one byte "
           f"flipped in one lane ({', '.join(tampers)}, a value commitment) rejected each time")

    # -- phase 9: the four kernels at the verifier's own shapes, and times ---
    seen = {}
    real_msm, real_f1600 = qmsm.msm, kk.f1600

    def keep_msm(nibbles, points):
        seen["msm"] = (nibbles, points)
        return real_msm(nibbles, points)

    def keep_f1600(state):
        seen["keccak"] = state
        return real_f1600(state)

    qmsm.msm, kk.f1600 = keep_msm, keep_f1600  # one more verify, to see its kernels' inputs
    try:
        drv.verify(proofs, commitments, rng=wrng)
    finally:
        qmsm.msm, kk.f1600 = real_msm, real_f1600
    nib9, pts9 = seen["msm"]
    check(nib9.shape == (n_msm, 64), f"the verifier's MSM has {nib9.shape[0]} points")
    digits9, flat9 = kp.pad_rows(nib9[None], pt.ExtPoint(*(c[None] for c in pts9)))
    n9 = digits9.shape[1]
    plain9 = {}
    plain9["msm_table"], plain_ms["msm_table"] = time_once(lambda: qmsm.msm_table(flat9))
    table9 = kp.msm_table(flat9)
    same(table9, plain9["msm_table"], "msm_table", f"the verifier's {n9} padded points")
    plain9["msm_acc"], plain_ms["msm_acc"] = time_once(
        lambda: qmsm.msm_window_sums(digits9, table9, 1))
    sums9 = kp.msm_window_sums(digits9, table9, 1)
    same(sums9, plain9["msm_acc"], "msm_acc", f"the verifier's {n9} padded points")
    plain9["msm_tail"], plain_ms["msm_tail"] = time_once(lambda: qmsm.msm_tail(sums9))
    total9 = kp.msm_tail(sums9)
    same(total9, plain9["msm_tail"], "msm_tail", "the verifier's window sums")
    check(bool(pt.is_identity(pt.ExtPoint(*(c[0] for c in total9)))),
          "the honest batch's MSM is the identity")
    state9 = seen["keccak"]
    check(tuple(state9.shape) == (RANGE_BATCH, 200), f"transcript states {tuple(state9.shape)}")
    plain_keccak, plain_ms["keccak_f1600"] = time_once(lambda: dk.f1600_plain(state9))
    check(torch.equal(kk.f1600(state9), plain_keccak), "keccak_f1600 == plain on a transcript state")
    ms["msm_acc"] = time_ms(lambda: kp.msm_window_sums(digits9, table9, 1), reps=20, warmup=3)
    ms["msm_tail"] = time_ms(lambda: kp.msm_tail(sums9), reps=20, warmup=3)
    # msm_table and keccak_f1600: device time from a graph of back-to-back
    # launches of their C entry points (no count, no host work between)
    lib = cb.load_library()
    out_table = pt.ExtPoint(*(torch.empty_like(c) for c in table9))
    out_state = torch.empty_like(state9)

    def direct(fn, *args):
        def run():
            check(fn(*args, torch.cuda.current_stream().cuda_stream) == 0, "direct launch")
        return run

    ms["msm_table"] = graph_ms(direct(lib.qq_msm_table, *(c.data_ptr() for c in flat9),
                                      *(c.data_ptr() for c in out_table), n9))
    ms["keccak_f1600"] = graph_ms(direct(lib.qq_keccak_f1600, state9.data_ptr(),
                                         out_state.data_ptr(), RANGE_BATCH))
    check(torch.equal(out_state, plain_keccak), "keccak_f1600 graph launches == plain")
    check(limb_err(out_table, table9) == 0, "msm_table graph launches == kernel")
    wrapped = {"msm_table": time_ms(lambda: kp.msm_table(flat9), reps=20, warmup=3),
               "keccak_f1600": time_ms(lambda: kk.f1600(state9), reps=50, warmup=3)}
    say(9, f"through the wrappers (what a caller pays, host enqueue included; CUDA events "
           f"over 20 and 50 calls): msm_table {wrapped['msm_table']:.4f} ms, keccak_f1600 "
           f"{wrapped['keccak_f1600']:.4f} ms; device time by graph replay: "
           f"{ms['msm_table']:.4f} and {ms['keccak_f1600']:.4f} ms [{card}]")
    lanes9 = qmsm.MSM_LANES
    point_bytes, sums_bytes = 4 * fe.NLIMBS * 4, 64 * 4 * fe.NLIMBS * lanes9 * 4
    shape9 = f"{n_msm} points padded to {n9}"
    record(9, "msm_table", shape9, verify_launches["msm_table"],
           n9 * MSM_PRODUCTS["table_point"], n9 * 17 * point_bytes, "32x32->64 limb products")
    record(9, "msm_acc", shape9, verify_launches["msm_acc"], n9 * 64 * MSM_PRODUCTS["add"],
           n9 * (64 * 4 + 16 * point_bytes) + sums_bytes, "32x32->64 limb products")
    record(9, "msm_tail", f"1 row of {lanes9} lanes", verify_launches["msm_tail"],
           MSM_PRODUCTS["tail_row"], sums_bytes + point_bytes, "32x32->64 limb products")
    say(9, f"msm_tail chain floor: 252 doublings + 64 additions = {TAIL_CHAIN_ROUNDS} "
           f"dependent rounds of one field product each; {ms['msm_tail'] * 1e3:.1f} us = "
           f"{ms['msm_tail'] * 1e6 / TAIL_CHAIN_ROUNDS:.0f} ns a round if the chain took it "
           f"all [{card}]")
    record(9, "keccak_f1600", f"{RANGE_BATCH} states", verify_launches["keccak_f1600"],
           RANGE_BATCH * KECCAK_OPS_PER_STATE, RANGE_BATCH * 400, "32-bit logic operations")
    say(9, f"keccak_f1600 chain floor: 24 rounds x 3 dependent exchange steps = "
           f"{KECCAK_CHAIN_STEPS} steps on one warp a state; {ms['keccak_f1600'] * 1e3:.2f} us = "
           f"{ms['keccak_f1600'] * 1e6 / KECCAK_CHAIN_STEPS:.0f} ns a step if the chain took it "
           f"all [{card}]")

    def timed_verify():
        torch.cuda.synchronize()
        t = time.perf_counter()
        drv.verify(proofs, commitments, rng=wrng)  # ends by fetching the verdict
        return time.perf_counter() - t

    walls = sorted(timed_verify() for _ in range(7))
    wall = statistics.median(walls)
    single_ms = {"range verify": wall * 1e3}   # single-device medians, for phase 17
    say(9, f"verify of {RANGE_BATCH} proofs (n={RANGE_N}, m={RANGE_M}), host clock, 7 calls: "
           f"median {wall * 1e3:.1f} ms (min {walls[0] * 1e3:.1f}, max {walls[-1] * 1e3:.1f}) = "
           f"{RANGE_BATCH / wall:.1f} range-proof verifications/s; launches per verify "
           f"{ {k: verify_launches[k] for k in SLICE2} } [{card}]")
    say(9, profile_line(lambda: drv.verify(proofs, commitments, rng=wrng), card,
                        "DeviceRangeVerifier.verify", SLICE2))

    # -- phase 10: the sigma verifiers ---------------------------------------
    # the sigma and shuffle proofs are made only now, so that no prover
    # shares the host with phases 6 and 9's timed calls, nor with the
    # timed calls of phases 10 and 11: this waits for all of them
    t0 = time.perf_counter()
    jobs = {(n_s, k): pool.submit(sigma_proof, *sigma[n_s][k][2])
            for n_s in SIGMA_NS for k in ("dleq", "dlog")}
    shuffling = {m_: [pool.submit(shuffle_proof, shuffle_sets[m_], b"chip-smoke-shuffle-%d-%d"
                                  % (m_, i)) for i in range(SHUFFLE_B)]
                 for m_ in (SHUFFLE_M, SHUFFLE_M_SMALL)}
    proved_sigma = {key: f.result(timeout=900) for key, f in jobs.items()}
    shuffled = {m_: [f.result(timeout=900) for f in fs] for m_, fs in shuffling.items()}
    entries = [r[0] for r in shuffled[SHUFFLE_M]]
    entries3 = [r[0] for r in shuffled[SHUFFLE_M_SMALL]]
    say(10, f"sigma proofs at n={SIGMA_NS} and {SHUFFLE_B} shuffle proofs at m={SHUFFLE_M} and "
            f"{SHUFFLE_B} at m={SHUFFLE_M_SMALL} from the port's host prover, each shuffle "
            f"proof accepted by the host verifier ({N_WORKERS} worker processes, started after "
            f"phase 9's timed calls; {time.perf_counter() - t0:.1f} s)")
    for n_s in SIGMA_NS:
        case = sigma[n_s]
        d_s, e_s, _ = case["dleq"]
        (zv, zr1, zr2, x), host_enc = proved_sigma[n_s, "dleq"]
        z_acc, _, _ = case["dlog"]
        (z, xz), host_zenc = proved_sigma[n_s, "dlog"]
        walls = {}

        def run_sigma(what, fn, *args):
            """One call on the card: (accepted?, launches, wall s by host clock)."""
            cb.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                fn(*args, device="cuda")
                ok = True
            except ValueError:
                ok = False
            walls[what] = time.perf_counter() - t
            return ok, {k: v for k, v in cb.LAUNCHES.items() if v}

        ok_d, l_d = run_sigma("delta-compact", dvf.verify_delta_compact_verifier_device, d_s, e_s,
                              zv, zr1, zr2, x, Verifier(b"DLEQProof", Transcript(b"DeltaCompact")))
        bad_zv = [(zv[0] + 1) % ex.L] + list(zv[1:])
        bad_d, _ = run_sigma("delta-compact, zv + 1", dvf.verify_delta_compact_verifier_device,
                             d_s, e_s, bad_zv, zr1, zr2, x,
                             Verifier(b"DLEQProof", Transcript(b"DeltaCompact")))
        ok_z, l_z = run_sigma("zero-balance", dvf.zero_balance_account_vector_verifier_device,
                              z_acc, z, xz, Verifier(b"DLOGProof", Transcript(b"ZeroBalance")))
        bad_z, _ = run_sigma("zero-balance, z + 1", dvf.zero_balance_account_vector_verifier_device,
                             z_acc, [(z[0] + 1) % ex.L] + list(z[1:]), xz,
                             Verifier(b"DLOGProof", Transcript(b"ZeroBalance")))
        check(ok_d and ok_z, f"n={n_s}: honest sigma proofs accepted")
        check(not bad_d and not bad_z, f"n={n_s}: zv + 1 and z + 1 rejected")
        codec = dict.fromkeys(CODEC, 1)
        check(l_d == {"scalar_mul": 1, "base_mul": 1, **codec}, f"delta-compact launches {l_d}")
        check(l_z == {"scalar_mul": 1, **codec}, f"zero-balance launches {l_z}")
        rows = case["sample"]
        seen = {}
        real_sm, real_bm = kp.scalar_mul, kp.base_mul

        def keep_sm(nib, p_):
            seen["scalar_mul"] = (nib, p_)
            return real_sm(nib, p_)

        def keep_bm(nib):
            seen["base_mul"] = nib
            return real_bm(nib)

        kp.scalar_mul, kp.base_mul = keep_sm, keep_bm  # to see the kernels' inputs
        try:
            enc = dvf.delta_compact_encodings(d_s, e_s, zv, zr1, zr2, x, device="cuda")
        finally:
            kp.scalar_mul, kp.base_mul = real_sm, real_bm
        torch.cuda.synchronize()
        t = time.perf_counter()
        zenc = dvf.zero_balance_encodings(z_acc, z, xz, device="cuda")
        zenc_s = time.perf_counter() - t
        t = time.perf_counter()
        dvf.delta_compact_encodings(d_s, e_s, zv, zr1, zr2, x, device="cuda")
        enc_s = time.perf_counter() - t
        check([bytes(r) for r in enc[rows].reshape(-1, 32)] == host_enc,
              f"n={n_s}: delta-compact e/f == host Verifier, byte for byte")
        check([bytes(r) for r in zenc[rows].reshape(-1, 32)] == host_zenc,
              f"n={n_s}: zero-balance e/f == host Verifier, byte for byte")
        nib_s, pts_s = seen["scalar_mul"]
        same(kp.scalar_mul(nib_s, pts_s), pt.scalar_mul(nib_s, pts_s), "scalar_mul",
             f"the sigma verifier's {nib_s.shape[0]} lanes")
        same(kp.base_mul(seen["base_mul"]), pt.base_mul(seen["base_mul"]), "base_mul",
             f"the sigma verifier's {n_s} lanes")
        say(10, f"sigma verifiers at n={n_s} on the card: honest delta-compact and zero-balance "
                f"proofs accepted (launches {l_d}, {l_z}), zv + 1 and z + 1 rejected; e/f "
                f"encodings of {len(rows)} accounts == host Verifier byte for byte; scalar_mul "
                f"({nib_s.shape[0]} lanes) and base_mul ({n_s}) == plain limb for limb; wall "
                f"time by host clock: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                                     for k, v in walls.items())
                + f"; of a call, the device encodings alone (upload, decode, products, "
                f"compress, fetch): delta-compact {enc_s * 1e3:.1f} ms, zero-balance "
                f"{zenc_s * 1e3:.1f} ms, the rest is the host transcript [{card}]")

    # -- phase 11: the shuffle verifier at full width ------------------------
    m8, b8 = SHUFFLE_M, SHUFFLE_B
    check(len({bytes(e[0].c_A[0]) for e in entries}) == b8, "16 distinct proofs")
    dsv = DeviceShuffleVerifier(m8, b8)
    t0 = time.perf_counter()
    dsv.warmup()
    warm_s = time.perf_counter() - t0
    srng_w = SeededRng(seed=b"chip-smoke-shuffle-weights")
    cb.reset_launches()
    dsv.verify(entries, rng=srng_w)  # raises unless the batch verifies
    replayed = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(replayed == {"msm_table": 2, "msm_acc": 2, "msm_tail": 2},
          f"a replayed verify launches its two MSMs alone: {replayed}")
    cb.reset_launches()
    DeviceShuffleVerifier(m8, b8).verify(entries, rng=srng_w)  # a first call runs eagerly
    sh_launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(set(sh_launches) == {*SHUFFLE_KERNELS, *CODEC},
          f"shuffle verify launches {sh_launches}")
    check(sh_launches["scalar_mul"] == 1 and all(sh_launches[k] == 2 for k in
                                                 ("msm_table", "msm_acc", "msm_tail"))
          and all(sh_launches[k] == 1 for k in CODEC),
          f"one scalar_mul, one rows MSM, one final MSM, one decode and one encode per verify: "
          f"{sh_launches}")
    rejected = []
    for lane, what in enumerate(SHUFFLE_TAMPERS, start=3):
        bad = shuffle_tampered(entries, what, lane)
        try:
            bad[lane][0].verify(Verifier(b"Shuffle", Transcript(b"ShuffleProof")), *bad[lane][1:])
            host_ok = True
        except ValueError:
            host_ok = False
        check(not host_ok, f"host verifier rejects {what}")
        try:
            dsv.verify(bad, rng=srng_w)
        except ValueError:
            rejected.append(what)
            continue
        raise RuntimeError(f"check failed: batch with {what} in lane {lane} was accepted")
    sdv._VERIFIER_CACHE.clear()
    device_batch_verify(entries[:5], rng=srng_w)
    check([k[:2] for k in sdv._VERIFIER_CACHE] == [(m8, 8)], "5 proofs ran as a bucket of 8")
    dsv3 = DeviceShuffleVerifier(SHUFFLE_M_SMALL, b8)
    dsv3.warmup()
    t0 = time.perf_counter()
    dsv3.verify(entries3, rng=srng_w)
    m3_s = time.perf_counter() - t0
    say(11, f"DeviceShuffleVerifier(m={m8}, batch={b8}): honest batch accepted (launches "
            f"{sh_launches}); one lane with {', '.join(rejected)} rejected each time, and by the "
            f"host verifier; device_batch_verify on 5 proofs ran as a bucket of 8 and accepted; "
            f"DeviceShuffleVerifier(m={SHUFFLE_M_SMALL}, batch={b8}) accepted in "
            f"{m3_s * 1e3:.1f} ms; warmup (first call, zero inputs) {warm_s:.2f} s [{card}]")

    # the kernels at the verifier's own shapes: one more verify records their inputs
    seen = {"keccak": []}
    real_sm, real_rows, real_msm, real_f1600 = kp.scalar_mul, qmsm.msm_rows, qmsm.msm, kk.f1600

    def keep_sm(nib, p_):
        seen["scalar_mul"] = (nib, p_)
        return real_sm(nib, p_)

    def keep_rows(nib, p_):
        seen["rows"] = (nib, p_)
        return real_rows(nib, p_)

    def keep_msm(nib, p_):
        seen["msm"] = (nib, p_)
        return real_msm(nib, p_)

    def keep_f1600(state):
        seen["keccak"].append(state)
        return real_f1600(state)

    kp.scalar_mul, qmsm.msm_rows, qmsm.msm, kk.f1600 = keep_sm, keep_rows, keep_msm, keep_f1600
    try:
        DeviceShuffleVerifier(m8, b8).verify(entries, rng=srng_w)   # eager: every wrapper called
    finally:
        kp.scalar_mul, qmsm.msm_rows, qmsm.msm, kk.f1600 = real_sm, real_rows, real_msm, real_f1600
    nib_p, pts_p = seen["scalar_mul"]
    lanes_p = nib_p.shape[0]
    check(lanes_p == b8 * (3 * m8 + 3), f"{lanes_p} product lanes")
    same(kp.scalar_mul(nib_p, pts_p), pt.scalar_mul(nib_p, pts_p), "scalar_mul",
         f"the shuffle verifier's {lanes_p} product lanes")
    nib_r, pts_r = seen["rows"]
    check(tuple(nib_r.shape) == (6 * b8, m8 * m8 + 1, 64), f"rows MSM {tuple(nib_r.shape)}")
    stages_against_plain(nib_r, pts_r, f"the shuffle verifier's {6 * b8} rows of {m8 * m8 + 1}")
    nib_f, pts_f = seen["msm"]
    n_final = nib_f.shape[0]
    final = stages_against_plain(nib_f[None], pt.ExtPoint(*(c[None] for c in pts_f)),
                                 f"the shuffle verifier's final MSM of {n_final} points")
    check(bool(pt.is_identity(pt.ExtPoint(*(c[0] for c in final)))),
          "the honest batch's final MSM is the identity")
    states_k = seen["keccak"]
    for st in states_k:
        check(torch.equal(kk.f1600(st), dk.f1600_plain(st)),
              "keccak_f1600 == plain on a shuffle transcript state")
    check({tuple(st.shape) for st in states_k} == {(b8, 200)}, "transcript states [16, 200]")
    say(11, f"kernels == plain versions at the shuffle verifier's shapes: scalar_mul over "
            f"{lanes_p} lanes, msm_table / msm_acc / msm_tail on {6 * b8} rows of "
            f"{m8 * m8 + 1} points and on the final MSM's {n_final} points, keccak_f1600 on "
            f"{len(states_k)} transcript states of [{b8}, 200]; max_abs_err "
            f"{ {k: err[k] for k in SHUFFLE_KERNELS} }")

    # each kernel's device time at these shapes, by replaying a CUDA graph of
    # back-to-back launches of its C entry point (msm_tail with its scratch
    # zeroed in the graph, as its wrapper does), its plain version's time
    # (CUDA events over one call) and its bound for the points these shapes
    # hold (row padding excluded)
    def ptrs(p_):
        return [c.data_ptr() for c in p_]

    def empty_pt(shape):
        return pt.ExtPoint(*(torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(4)))

    def graph_stage_ms(name, *args):
        return graph_ms(direct(getattr(lib, cb.KERNELS[name][1]), *args))

    sh_rows = []  # (kernel, shape, launches a verify, ms, plain ms, bound ms, bound by)

    def shape_line(name, shape, launches, k_ms, p_ms, ops, nbytes):
        sh_rows.append((name, shape, launches, k_ms, p_ms) + bound(ops, nbytes))

    out_p = empty_pt((lanes_p, fe.NLIMBS))
    shape_line("scalar_mul", f"{lanes_p} lanes", 1,
               graph_stage_ms("scalar_mul", nib_p.data_ptr(), *ptrs(pts_p), *ptrs(out_p),
                              lanes_p),
               time_once(lambda: pt.scalar_mul(nib_p, pts_p))[1],
               lanes_p * sum(FIELD_OPS["scalar_mul"][k] * PRODUCTS[k] for k in PRODUCTS),
               lanes_p * lane_bytes["scalar_mul"])
    for key, nib_k, pts_k in (("rows", nib_r, pts_r),
                              ("final", nib_f[None], pt.ExtPoint(*(c[None] for c in pts_f)))):
        rows_k, real_k = nib_k.shape[0], nib_k.shape[0] * nib_k.shape[1]
        digits_k, flat_k = kp.pad_rows(nib_k, pts_k)
        n_k = flat_k.x.shape[0]
        shape_k = f"{key}: {rows_k} x {nib_k.shape[1]} points ({n_k} padded)"
        table_k = empty_pt((16, fe.NLIMBS, n_k))
        sums_k = empty_pt((rows_k, 64, fe.NLIMBS, qmsm.MSM_LANES))
        sums_b = rows_k * 64 * 4 * fe.NLIMBS * qmsm.MSM_LANES * 4
        shape_line("msm_table", shape_k, 1,
                   graph_stage_ms("msm_table", *ptrs(flat_k), *ptrs(table_k), n_k),
                   time_once(lambda: qmsm.msm_table(flat_k))[1],
                   real_k * MSM_PRODUCTS["table_point"], real_k * 17 * point_bytes)
        shape_line("msm_acc", shape_k, 1,
                   graph_stage_ms("msm_acc", digits_k.data_ptr(), *ptrs(table_k), *ptrs(sums_k),
                                  rows_k, n_k // (rows_k * qmsm.MSM_LANES), qmsm.MSM_LANES),
                   time_once(lambda: qmsm.msm_window_sums(digits_k, table_k, rows_k))[1],
                   real_k * 64 * MSM_PRODUCTS["add"],
                   real_k * (64 * 4 + 16 * point_bytes) + sums_b)
        out_k = empty_pt((rows_k, fe.NLIMBS))
        totals_k = torch.empty((rows_k, 64, 4, fe.NLIMBS), dtype=torch.int32, device=dev)

        def tail(sums_=sums_k, totals_=totals_k, out_=out_k, rows_=rows_k):
            done = torch.zeros((rows_,), dtype=torch.int32, device=dev)
            check(lib.qq_msm_tail(*ptrs(sums_), totals_.data_ptr(), done.data_ptr(),
                                  *ptrs(out_), rows_, qmsm.MSM_LANES,
                                  torch.cuda.current_stream().cuda_stream) == 0, "direct launch")

        shape_line("msm_tail", shape_k, 1, graph_ms(tail),
                   time_once(lambda: qmsm.msm_tail(sums_k))[1],
                   rows_k * MSM_PRODUCTS["tail_row"], sums_b + rows_k * point_bytes)
    state_k = states_k[0]
    out_k = torch.empty_like(state_k)
    shape_line("keccak_f1600", f"{b8} states", sh_launches["keccak_f1600"],
               graph_stage_ms("keccak_f1600", state_k.data_ptr(), out_k.data_ptr(), b8),
               time_once(lambda: dk.f1600_plain(state_k))[1],
               b8 * KECCAK_OPS_PER_STATE, b8 * 400)
    for name, shape, n_l, k_ms, p_ms, b_ms, b_by in sh_rows:
        say(11, f"{name} at the shuffle verifier's {shape}: {n_l} launch(es) a verify; device "
                f"time by graph replay {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b_ms:.5f} ms "
                f"({b_by}) [{card}]")
    per_verify = sum(n_l * k_ms for _, _, n_l, k_ms, _, _, _ in sh_rows)
    say(11, f"the kernels' device time a shuffle verify: {per_verify:.3f} ms (launches "
            f"{sh_launches}) [{card}]")

    def timed_shuffle():
        torch.cuda.synchronize()
        t = time.perf_counter()
        dsv.verify(entries, rng=srng_w)  # ends by fetching the verdict
        return time.perf_counter() - t

    walls = sorted(timed_shuffle() for _ in range(7))
    wall = statistics.median(walls)
    single_ms["shuffle verify"] = wall * 1e3
    t = time.perf_counter()
    packed = dsv._pack(entries, None)
    pack_s = time.perf_counter() - t
    weights_sh = np.frombuffer(srng_w.fill_bytes(b8 * dsv.NCHECKS * 64), np.uint8).reshape(
        b8, dsv.NCHECKS, 64).copy()
    t = time.perf_counter()
    check(dsv._run(packed[0], packed[1], weights_sh, *packed[2:]), "packed batch verifies")
    run_s = time.perf_counter() - t
    say(11, f"DeviceShuffleVerifier.verify of {b8} proofs (m={m8}, N={m8 * m8}), host clock, 7 "
            f"calls: median {wall * 1e3:.1f} ms (min {walls[0] * 1e3:.1f}, max "
            f"{walls[-1] * 1e3:.1f}) = {b8 / wall:.1f} shuffle-proof verifications/s; one call "
            f"split: host packing {pack_s * 1e3:.1f} ms, program from upload to verdict "
            f"{run_s * 1e3:.1f} ms [{card}]")
    say(11, profile_line(lambda: dsv.verify(entries, rng=srng_w), card,
                         "DeviceShuffleVerifier.verify", SHUFFLE_KERNELS))

    def wrapped():
        return [(p_, Verifier(b"Shuffle", Transcript(b"ShuffleProof")), st, ins, outs)
                for p_, st, ins, outs in entries]

    backend_s = {}
    for backend in ("device-batched", "host", "device"):
        w = wrapped()
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch_verify_shuffle_proofs(w, backend=backend, seed=b"chip-smoke-batch")
        backend_s[backend] = time.perf_counter() - t
    deferred = DeferredPointChecks(b"chip-smoke-deferred")
    t = time.perf_counter()
    for p_, v, st, ins, outs in wrapped():
        p_.verify(v, st, ins, outs, defer=deferred)
    replay_s = time.perf_counter() - t
    defer_s = {}
    for backend in ("host", "device", "device", "host"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        deferred.verify(backend=backend)  # raises unless the combined check holds
        defer_s.setdefault(backend, []).append(time.perf_counter() - t)
    one = DeferredPointChecks(b"chip-smoke-deferred-1")
    p_, v, st, ins, outs = wrapped()[0]
    p_.verify(v, st, ins, outs, defer=one)
    for backend in ("host", "device", "device", "host"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one.verify(backend=backend)
        defer_s.setdefault(f"{backend} 1", []).append(time.perf_counter() - t)
    # a few-term accumulator, the size a sigma or transaction check defers:
    # FEW_TERMS - 1 random multiples of B and the term that cancels them
    few = DeferredPointChecks(b"chip-smoke-deferred-few")
    ks = [int.from_bytes(srng_w.fill_bytes(32), "little") % ex.L for _ in range(FEW_TERMS - 1)]
    ws = [int.from_bytes(srng_w.fill_bytes(32), "little") % ex.L for _ in range(FEW_TERMS - 1)]
    few.check(ws + [(-sum(w_ * k_ for w_, k_ in zip(ws, ks))) % ex.L],
              [ex.pt_base_mul(k_) for k_ in ks] + [ex.BASEPOINT], "few-term check")
    for backend in ("host", "device", "device", "host"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        few.verify(backend=backend)
        defer_s.setdefault(f"{backend} few", []).append(time.perf_counter() - t)
    say(11, f"batch_verify_shuffle_proofs on the same {b8} proofs, host clock: "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in backend_s.items())
            + f"; DeferredPointChecks on their {deferred.num_terms} coalesced terms (host "
            f"replay {replay_s * 1e3:.1f} ms): verify host "
            + " / ".join(f"{v * 1e3:.1f}" for v in defer_s["host"]) + " ms, device "
            + " / ".join(f"{v * 1e3:.1f}" for v in defer_s["device"]) + f" ms; on one "
            f"proof's {one.num_terms} terms: host "
            + " / ".join(f"{v * 1e3:.1f}" for v in defer_s["host 1"]) + " ms, device "
            + " / ".join(f"{v * 1e3:.1f}" for v in defer_s["device 1"]) + f" ms; on "
            f"{few.num_terms} terms: host "
            + " / ".join(f"{v * 1e3:.2f}" for v in defer_s["host few"]) + " ms, device "
            + " / ".join(f"{v * 1e3:.2f}" for v in defer_s["device few"]) + f" ms [{card}]")

    # the MSM stages on rows of any size against their plain versions (the
    # plain window sums in chunks of PLAIN_ROWS rows: 576 rows of 2,176
    # points at once would need tens of GB; the plain tail on all rows at
    # once, its Horner chain costs the same at any row count); and each
    # stage's device time by graph replay of direct launches
    def rows_against_plain(digits, table, rows, what, flat=None):
        """msm_acc (and msm_table on `flat`, if given) and msm_tail on these
        inputs against their plain versions, limb for limb. Returns the
        plain versions' ms (CUDA events, summed over the chunks)."""
        n_all = digits.shape[1]
        kp_ = n_all // rows
        plain_t = {"msm_table": 0.0, "msm_acc": 0.0, "msm_tail": 0.0}
        if flat is not None:
            want, plain_t["msm_table"] = time_once(lambda: qmsm.msm_table(flat))
            same(table, want, "msm_table", what)
        sums = kp.msm_window_sums(digits, table, rows)
        for r0 in range(0, rows, PLAIN_ROWS):
            r1 = min(rows, r0 + PLAIN_ROWS)
            cols = slice(r0 * kp_, r1 * kp_)
            want, t_ms = time_once(lambda: qmsm.msm_window_sums(
                digits[:, cols].contiguous(),
                pt.ExtPoint(*(c[..., cols].contiguous() for c in table)), r1 - r0))
            plain_t["msm_acc"] += t_ms
            same(pt.ExtPoint(*(c[r0:r1] for c in sums)), want, "msm_acc", what)
        want, plain_t["msm_tail"] = time_once(lambda: qmsm.msm_tail(sums))
        same(kp.msm_tail(sums), want, "msm_tail", what)
        return plain_t

    def table_graph_ms(flat):
        """Device time of msm_table on the points `flat`, by graph replay."""
        table_ = empty_pt((16, fe.NLIMBS, flat.x.shape[0]))
        return graph_ms(direct(lib.qq_msm_table, *ptrs(flat), *ptrs(table_), flat.x.shape[0]),
                        launches=4, replays=3)

    def rows_graph_ms(digits, table, rows):
        """Device time of msm_acc and msm_tail on these inputs, by graph
        replay of direct launches."""
        n_all = digits.shape[1]
        sums_ = empty_pt((rows, 64, fe.NLIMBS, qmsm.MSM_LANES))
        out_ = empty_pt((rows, fe.NLIMBS))
        totals_ = torch.empty((rows, 64, 4, fe.NLIMBS), dtype=torch.int32, device=dev)
        reps = dict(launches=4, replays=3)
        got = {"msm_acc": graph_ms(direct(lib.qq_msm_acc, digits.data_ptr(), *ptrs(table),
                                          *ptrs(sums_), rows, n_all // (rows * qmsm.MSM_LANES),
                                          qmsm.MSM_LANES), **reps)}

        def tail():
            done = torch.zeros((rows,), dtype=torch.int32, device=dev)
            check(lib.qq_msm_tail(*ptrs(sums_), totals_.data_ptr(), done.data_ptr(),
                                  *ptrs(out_), rows, qmsm.MSM_LANES,
                                  torch.cuda.current_stream().cuda_stream) == 0, "direct launch")

        got["msm_tail"] = graph_ms(tail, **reps)
        return got

    def rows_bounds(rows, real):
        """Bounds of msm_acc and msm_tail on `rows` rows of `real` points
        each (row padding excluded)."""
        sums_b = rows * 64 * 4 * fe.NLIMBS * qmsm.MSM_LANES * 4
        pts_ = rows * real
        return {"msm_acc": bound(pts_ * 64 * MSM_PRODUCTS["add"],
                                 pts_ * (64 * 4 + 16 * point_bytes) + sums_b),
                "msm_tail": bound(rows * MSM_PRODUCTS["tail_row"], sums_b + rows * point_bytes)}

    def keep_calls(patches):
        """Patch (module, name, key) wrappers to record their argument
        tuples in seen[key]; returns (seen, restore)."""
        seen_ = {key: [] for _, _, key in patches}
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        for (mod, name, key), (_, _, real) in zip(patches, saved):
            def keep(*a, _real=real, _key=key, **kw):
                seen_[_key].append(a)
                return _real(*a, **kw)
            setattr(mod, name, keep)

        def restore():
            for mod, name, real in saved:
                setattr(mod, name, real)
        return seen_, restore

    # -- phase 12: range proving at full width -------------------------------
    RB = RANGE_PROVE_BATCH

    def range_args(first=0, count=RB):
        ls = [range_lane(first + i) for i in range(count)]
        return [v for v, _, _ in ls], [b for _, b, _ in ls], [r for _, _, r in ls]

    cb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drp = rdp.DeviceRangeProver(RANGE_N, RANGE_M, RB)
    proofs_d, vlists_d = drp.prove(*range_args())
    first_s = time.perf_counter() - t0
    first_launches = dict(cb.LAUNCHES)
    check(all(first_launches[k] > 0 for k in SLICE2), f"first prove launches {first_launches}")
    check(all(first_launches[k] == 0 for k in SLICE1), f"first prove launches {first_launches}")
    check(first_launches["msm_table"] == 2, "the first prove builds the two basis tables")
    for i in range(N_PROOFS):
        check(proofs_d[i].to_bytes() == proved[i][0] and vlists_d[i] == list(proved[i][1]),
              f"range lane {i} == the host prover's proof, byte for byte")
    drv.verify(proofs_d + proofs_d, vlists_d + vlists_d, rng=wrng)  # raises unless accepted
    bad = list(proofs_d + proofs_d)
    bad[7] = flipped(bad[7], 3)
    try:
        drv.verify(bad, vlists_d + vlists_d, rng=wrng)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: a device proof with a flipped byte was accepted")
    cb.reset_launches()
    drp.prove(*range_args())
    rp_launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(rp_launches.get("msm_table", 0) == 0 and rp_launches.get("msm_acc") == 2 + drp.k
          and rp_launches.get("msm_tail") == 2 + drp.k,
          f"a prove after the first: V/A/S, T and {drp.k} rounds on the cached tables "
          f"({rp_launches})")
    rdp._PROVER_CACHE.clear()
    pb_lanes = [(Transcript(b"RangeProof"), v, b, r) for v, b, r in zip(*range_args(0, 5))]
    pb = RangeProof.prove_batch(pb_lanes, RANGE_N, backend="device-batched")
    check([k[:3] for k in rdp._PROVER_CACHE] == [(RANGE_N, RANGE_M, 8)],
          "prove_batch on 5 lanes ran as a bucket of 8")
    check([p_.to_bytes() for p_, _ in pb] == [p_.to_bytes() for p_ in proofs_d[:5]],
          "prove_batch's proofs == DeviceRangeProver's")
    for i, (t_, *_) in enumerate(pb_lanes):
        if i < N_PROOFS:
            want = proved[i][2]
        else:
            t5 = Transcript(b"RangeProof")
            proofs_d[i].advance_transcript(t5, vlists_d[i], RANGE_N)
            want = snapshot_host_strobe(t5.strobe)
        check(snapshot_host_strobe(t_.strobe) == want,
              f"prove_batch advanced lane {i}'s host transcript")
    say(12, f"DeviceRangeProver(n={RANGE_N}, m={RANGE_M}, batch={RB}): lanes 0-{N_PROOFS - 1} "
            f"== the host prover's proofs byte for byte; all {RB} proofs accepted by "
            f"DeviceRangeVerifier({RANGE_N}, {RANGE_M}, {RANGE_BATCH}) (the {RB} twice), one "
            f"flipped byte rejected; first call (tables built) {first_s:.2f} s, launches "
            f"{ {k: v for k, v in first_launches.items() if v} }, launches a prove after it "
            f"{rp_launches}; prove_batch on 5 lanes ran as a bucket of 8, equal proofs, host "
            f"transcripts advanced (lanes 0-3 == the host prover's) [{card}]")

    # the kernels at the prover's shapes: one more prove records their inputs
    seen, restore = keep_calls([(kp, "msm_window_sums", "acc"), (kk, "f1600", "keccak")])
    try:
        drp.prove(*range_args())
    finally:
        restore()
    acc_calls = seen["acc"]
    check(len(acc_calls) == 2 + drp.k, f"{len(acc_calls)} msm_acc calls a prove")
    basis = drp._basis
    kpad = basis.table().x.shape[-1]
    flat_b = pt.ExtPoint(*(torch.cat([c, e]) for c, e in
                           zip(basis.points, pt.identity((kpad - basis.k,), dev))))
    vas, t_call, ipp0 = acc_calls[0], acc_calls[1], acc_calls[2]
    check(vas[2] == RB * (RANGE_M + 2) and vas[0].shape[1] == vas[2] * kpad,
          f"V/A/S rows {vas[2]} x {kpad}")
    # the cached basis table (what every V/A/S and IPP row is tiled from)
    want, t_table = time_once(lambda: qmsm.msm_table(flat_b))
    same(basis.table(), want, "msm_table", f"the range prover's cached basis ({kpad} points)")
    p_tab = rows_against_plain(*vas, f"the range prover's V/A/S rows ({vas[2]} x {kpad})")
    p_tab["msm_table"] = t_table
    p_ipp = rows_against_plain(*ipp0, f"the range prover's IPP round ({ipp0[2]} x {kpad})")
    p_t = rows_against_plain(*t_call, f"the range prover's T rows ({t_call[2]} x 128)")
    check({tuple(st.shape) for (st,) in seen["keccak"]} == {(RB, 200)},
          "prover states [32, 200]")
    states_all = torch.cat([st for (st,) in seen["keccak"]])
    check(torch.equal(kk.f1600(states_all), dk.f1600_plain(states_all)),
          "keccak_f1600 == plain on every range prover transcript state of a prove")
    say(12, f"kernels == plain versions at the range prover's shapes: msm_table on the cached "
            f"basis ({basis.k} points padded to {kpad}), msm_acc / msm_tail on the V/A/S rows "
            f"({vas[2]} x {kpad}), the T rows ({t_call[2]}) and one inner-product round "
            f"({ipp0[2]} x {kpad}), keccak_f1600 on {len(seen['keccak'])} transcript states; "
            f"max_abs_err { {k: err[k] for k in SLICE2} }")
    g_vas = rows_graph_ms(*vas)
    g_vas["msm_table"] = table_graph_ms(flat_b)
    g_ipp = rows_graph_ms(*ipp0)
    g_t = rows_graph_ms(*t_call)
    (st_k,) = seen["keccak"][0]
    out_st = torch.empty_like(st_k)
    g_keccak = graph_ms(direct(lib.qq_keccak_f1600, st_k.data_ptr(), out_st.data_ptr(), RB))
    p_keccak = time_once(lambda: dk.f1600_plain(st_k))[1]
    n_basis = 2 + 2 * drp.nm
    rows_lines = [("msm_table", f"the cached basis, {n_basis} points ({kpad} padded)", 0,
                   g_vas["msm_table"], p_tab["msm_table"],
                   bound(n_basis * MSM_PRODUCTS["table_point"], n_basis * 17 * point_bytes))]
    for name in ("msm_acc", "msm_tail"):
        for label, g, p_, rows_, real, n_l in (
                (f"V/A/S {vas[2]} x {n_basis}", g_vas, p_tab, vas[2], n_basis, 1),
                (f"T {t_call[2]} x 2", g_t, p_t, t_call[2], 2, 1),
                (f"IPP round {ipp0[2]} x {n_basis}", g_ipp, p_ipp, ipp0[2], n_basis, drp.k)):
            rows_lines.append((name, label, n_l, g[name], p_[name],
                               rows_bounds(rows_, real)[name]))
    rows_lines.append(("keccak_f1600", f"{RB} states", rp_launches.get("keccak_f1600", 0), g_keccak,
                       p_keccak, bound(RB * KECCAK_OPS_PER_STATE, RB * 400)))
    for name, shape, n_l, k_ms, p_ms, (b_ms, b_by) in rows_lines:
        say(12, f"{name} at the range prover's {shape}: {n_l} launch(es) a prove; device time "
                f"by graph replay {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b_ms:.5f} ms "
                f"({b_by}) [{card}]")
    per_prove = sum(n_l * k_ms for _, _, n_l, k_ms, _, _ in rows_lines)
    say(12, f"the kernels' device time a range prove: {per_prove:.3f} ms (launches "
            f"{rp_launches}) [{card}]")
    args = [range_args() for _ in range(PROVE_REPS)]
    med, lo, hi = median_ms(lambda: drp.prove(*args.pop()), PROVE_REPS)
    single_ms["range prove"] = med
    t = time.perf_counter()
    packed = drp._pack(*range_args(), None)
    pack_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    drp._run(*packed)
    run_ms = (time.perf_counter() - t) * 1e3
    drp2 = rdp.DeviceRangeProver(RANGE_N, RANGE_M, RANGE_PROVE_SMALL)  # the same tables
    args2 = [range_args(0, RANGE_PROVE_SMALL) for _ in range(3)]
    med2, _, _ = median_ms(lambda: drp2.prove(*args2.pop()), reps=3)
    host_ms = statistics.mean(host_range_s) * 1e3
    say(12, f"DeviceRangeProver.prove of {RB} proofs (n={RANGE_N}, m={RANGE_M}), host clock, "
            f"{PROVE_REPS} calls: median {med:.1f} ms (min {lo:.1f}, max {hi:.1f}) = "
            f"{RB / med * 1e3:.2f} proofs/s, {med / RB:.1f} ms a proof; one call split: host "
            f"packing (the host prover's {2 * drp.nm + 4} draws a lane) {pack_ms:.1f} ms, "
            f"program from upload to fetch {run_ms:.1f} ms; at batch {RANGE_PROVE_SMALL}: "
            f"median of 3 {med2:.1f} ms = {med2 / RANGE_PROVE_SMALL:.1f} ms a proof; the host "
            f"prover (phase 2's workers, C++ curve and transcript): {host_ms:.1f} ms "
            f"a proof [{card}]")
    args = range_args()
    say(12, profile_line(lambda: drp.prove(*args), card, "DeviceRangeProver.prove", SLICE2))

    # -- phase 13: shuffle proving at full width -----------------------------
    def shuffle_args(results):
        return [r[1] for r in results], [copy.deepcopy(r[2]) for r in results]

    def same_proofs(got_, results, what):
        for i, ((proof, stmt), r) in enumerate(zip(got_, results)):
            want_p, want_s = r[0][0], r[0][1]
            for obj, want_o in ((proof, want_p), (stmt, want_s)):
                for f in dataclasses.fields(want_o):
                    check(getattr(obj, f.name) == getattr(want_o, f.name),
                          f"{what} lane {i}: {type(want_o).__name__}.{f.name} == host")

    sh8 = shuffled[m8]
    cb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsp = sdp.DeviceShuffleProver(m8, b8)
    got8 = dsp.prove(*shuffle_args(sh8))
    first_s = time.perf_counter() - t0
    first_launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    check(set(first_launches) == {*SLICE2, *CODEC}, f"shuffle prove launches {first_launches}")
    same_proofs(got8, sh8, f"m={m8}")
    dsv.verify([(p_, s_, e[2], e[3]) for (p_, s_), e in zip(got8, entries)], rng=srng_w)
    cb.reset_launches()
    dsp.prove(*shuffle_args(sh8))
    sp_launches = {k: v for k, v in cb.LAUNCHES.items() if v}
    dsp3 = sdp.DeviceShuffleProver(SHUFFLE_M_SMALL, b8)
    t0 = time.perf_counter()
    got3 = dsp3.prove(*shuffle_args(shuffled[SHUFFLE_M_SMALL]))
    m3_s = time.perf_counter() - t0
    same_proofs(got3, shuffled[SHUFFLE_M_SMALL], f"m={SHUFFLE_M_SMALL}")
    dsv3.verify([(p_, s_, e[2], e[3]) for (p_, s_), e in zip(got3, entries3)], rng=srng_w)
    sdp._PROVER_CACHE.clear()
    out5 = batch_create_shuffle_proofs(*shuffle_args(sh8[:5]), backend="device-batched")
    check([k[:2] for k in sdp._PROVER_CACHE] == [(m8, 8)], "5 shuffles ran as a bucket of 8")
    same_proofs(out5, sh8[:5], "batch_create_shuffle_proofs")
    say(13, f"DeviceShuffleProver(m={m8}, batch={b8}): all {b8} proofs and statements == the "
            f"host prover's field for field, accepted by DeviceShuffleVerifier({m8}, {b8}); "
            f"first call (tables built) {first_s:.2f} s, launches {first_launches}, a prove "
            f"after it {sp_launches}; DeviceShuffleProver(m={SHUFFLE_M_SMALL}, batch={b8}) == "
            f"host and accepted (first call {m3_s * 1e3:.1f} ms); batch_create_shuffle_proofs on 5 "
            f"shuffles ran as a bucket of 8, == host [{card}]")

    seen, restore = keep_calls([(qmsm, "msm_rows", "rows"), (kk, "f1600", "keccak")])
    try:
        dsp.prove(*shuffle_args(sh8))
    finally:
        restore()
    big = max(seen["rows"], key=lambda a: a[0].shape[0] * a[0].shape[1])
    nib_e, pts_e = big
    rows_e, k_e = nib_e.shape[0], nib_e.shape[1]
    digits_e, flat_e = kp.pad_rows(nib_e, pts_e)
    table_e = kp.msm_table(flat_e)
    p_e = rows_against_plain(digits_e, table_e, rows_e,
                             f"the shuffle prover's largest rows call ({rows_e} x {k_e})",
                             flat=flat_e)
    check({tuple(st.shape) for (st,) in seen["keccak"]} == {(b8, 200)},
          "prover states [16, 200]")
    states_all = torch.cat([st for (st,) in seen["keccak"]])
    check(torch.equal(kk.f1600(states_all), dk.f1600_plain(states_all)),
          "keccak_f1600 == plain on every shuffle prover transcript state of a prove")
    say(13, f"kernels == plain versions at the shuffle prover's shapes: msm_table / msm_acc / "
            f"msm_tail on its largest rows call (the multi-exponentiation's {rows_e} rows of "
            f"{k_e} points), keccak_f1600 on {len(seen['keccak'])} transcript states; "
            f"max_abs_err { {k: err[k] for k in SLICE2} }")
    g_e = rows_graph_ms(digits_e, table_e, rows_e)
    g_e["msm_table"] = table_graph_ms(flat_e)
    b_e = rows_bounds(rows_e, k_e)
    b_e["msm_table"] = bound(rows_e * k_e * MSM_PRODUCTS["table_point"],
                             rows_e * k_e * 17 * point_bytes)
    (st_k,) = seen["keccak"][0]
    out_st = torch.empty_like(st_k)
    g_keccak = graph_ms(direct(lib.qq_keccak_f1600, st_k.data_ptr(), out_st.data_ptr(), b8))
    for name in ("msm_table", "msm_acc", "msm_tail"):
        say(13, f"{name} at the shuffle prover's {rows_e} x {k_e} rows: {sp_launches.get(name, 0)} "
                f"launch(es) a prove (all shapes); device time of this call by graph replay "
                f"{g_e[name]:.4f} ms, plain {p_e[name]:.2f} ms, bound {b_e[name][0]:.5f} ms "
                f"({b_e[name][1]}) [{card}]")
    say(13, f"keccak_f1600 at {b8} states: {sp_launches.get('keccak_f1600', 0)} launches a prove; "
            f"device time by graph replay {g_keccak:.4f} ms, plain "
            f"{time_once(lambda: dk.f1600_plain(st_k))[1]:.2f} ms, bound "
            f"{bound(b8 * KECCAK_OPS_PER_STATE, b8 * 400)[0]:.5f} ms [{card}]")
    args = [shuffle_args(sh8) for _ in range(PROVE_REPS)]
    med, lo, hi = median_ms(lambda: dsp.prove(*args.pop()), PROVE_REPS)
    single_ms["shuffle prove"] = med
    t = time.perf_counter()
    packed = dsp._pack(*shuffle_args(sh8))
    pack_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    dsp._run(*packed)
    run_ms = (time.perf_counter() - t) * 1e3
    host_ms = statistics.mean(r[3] for r in sh8) * 1e3
    host3_ms = statistics.mean(r[3] for r in shuffled[SHUFFLE_M_SMALL]) * 1e3
    sh3 = shuffled[SHUFFLE_M_SMALL]
    args3 = [shuffle_args(sh3) for _ in range(3)]
    med3, _, _ = median_ms(lambda: dsp3.prove(*args3.pop()), reps=3)
    small = {}
    for m_, res in ((m8, sh8), (SHUFFLE_M_SMALL, sh3)):
        dsp_s = sdp.DeviceShuffleProver(m_, 2)
        args_s = [shuffle_args(res[:2]) for _ in range(3)]
        small[m_] = median_ms(lambda: dsp_s.prove(*args_s.pop()), reps=3)[0]
    say(13, f"DeviceShuffleProver.prove of {b8} proofs (m={m8}, N={m8 * m8}), host clock, "
            f"{PROVE_REPS} calls: median {med:.1f} ms (min {lo:.1f}, max {hi:.1f}) = "
            f"{b8 / med * 1e3:.2f} proofs/s, {med / b8:.1f} ms a proof; one call split: host "
            f"packing {pack_ms:.1f} ms, program from upload to fetch {run_ms:.1f} ms; m="
            f"{SHUFFLE_M_SMALL}, batch {b8}: median of 3 {med3:.1f} ms = {med3 / b8:.1f} ms a "
            f"proof; batch 2: median of 3 {small[m8]:.1f} ms at m={m8} ("
            f"{small[m8] / 2:.1f} ms a proof), {small[SHUFFLE_M_SMALL]:.1f} ms at "
            f"m={SHUFFLE_M_SMALL} ({small[SHUFFLE_M_SMALL] / 2:.1f} ms a proof); the host prover "
            f"(phase 10's workers): {host_ms:.1f} ms a proof at m={m8}, {host3_ms:.1f} at "
            f"m={SHUFFLE_M_SMALL} [{card}]")
    args = shuffle_args(sh8)
    say(13, profile_line(lambda: dsp.prove(*args), card, "DeviceShuffleProver.prove", SLICE2))

    # -- phases 14-15: transactions, built and batch-verified ----------------
    helpers = types.SimpleNamespace(
        dev=dev, card=card, err=err, same=same, stages_against_plain=stages_against_plain,
        rows_against_plain=rows_against_plain, keep_calls=keep_calls, median_ms=median_ms,
        sync=torch.cuda.synchronize, say=say, bound=bound, codec_launches={},
        profile=lambda fn, what, names: profile_line(fn, card, what, names))
    helpers.phase = 14
    built = phase_tx_build(helpers)
    helpers.phase = 15
    verified = phase_tx_verify(helpers, built)
    for name in CODEC:   # their launches on the main paths: a build, a verify
        results[name]["launches"] = helpers.codec_launches[name]

    # -- phase 16: the serving layer and the daemon ----------------------------
    helpers.phase, helpers.pool = 16, pool
    schnorr = phase_services(helpers, entries, verified[:TX_VERIFY], drv)

    # -- phase 17: the sharded paths, two ranks on this card and one over NCCL
    helpers.phase = 17
    single_ms["schnorr"] = schnorr.call_ms
    phase_sharded(helpers, types.SimpleNamespace(
        schnorr=schnorr, range_verify=(proofs, commitments), shuffles=entries,
        range_prove=(range_args(), proofs_d, vlists_d), shuffle_prove=(shuffle_args(sh8), got8),
        txs=verified[:TX_VERIFY], single_ms=single_ms))

    # -- phase 18 -----------------------------------------------------------
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
