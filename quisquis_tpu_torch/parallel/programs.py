"""Rank programs for :func:`quisquis_tpu_torch.parallel.launch`.

:func:`run_calls` runs a list of the sharded calls below on every rank and
reports each call's outcome, host-clock seconds and kernel launches. Each
call takes the mesh first and the whole batch, the same on every rank (the
SPMD model of :mod:`.mesh`), and returns a plain picklable value. The CPU
tests and ``chip_smoke.py`` pass their inputs in; the launch pickles them
to every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import statistics
import time

import torch
import torch.distributed as dist

from ..accounts.transcript import SeededRng
from ..ops import cuda_build
from ..ops import exact as ex
from ..ops import point as pt
from .sharded_msm import sharded_commitment_verify, sharded_msm


def _rng(seed):
    return None if seed is None else SeededRng(seed=seed)  # the verifiers' weights


def msm(mesh, nibbles, points) -> bytes:
    """The Ristretto encoding of sum_i s_i * P_i by ``sharded_msm``
    (nibbles int32 [n, 64] and points [n] on the host)."""
    out = sharded_msm(mesh, nibbles, points)
    return ex.ristretto_encode(pt.to_exact_batch(pt.ExtPoint(*(c[None].cpu() for c in out)))[0])


def commitments(mesh, sks, rs, vs, gr_points, wrong_lane=None) -> bool:
    """``sharded_commitment_verify`` on commitments Enc_pk(v; r) made on the
    host; lane ``wrong_lane`` is checked against v + 1."""
    from ..ops import batch as qb

    grsk_points = [ex.pt_mul(sk, p) for sk, p in zip(sks, gr_points)]
    c = [ex.pt_mul(r, p) for r, p in zip(rs, gr_points)]
    d = [ex.pt_add(ex.pt_base_mul(v), ex.pt_mul(r, h)) for v, r, h in zip(vs, rs, grsk_points)]
    checked = [v + (i == wrong_lane) for i, v in enumerate(vs)]
    comm = qb.BatchCommitment(pt.from_exact_batch(c, "cpu"), pt.from_exact_batch(d, "cpu"))
    return sharded_commitment_verify(mesh, comm, qb.scalars_to_device(sks, "cpu"),
                                     qb.scalars_to_device(checked, "cpu"))


def deferred(mesh, checks, seed) -> None:
    """``DeferredPointChecks.verify("sharded")`` over [(scalars, points,
    label)]; ``seed`` None draws each rank's own weights."""
    from ..accounts.deferred import DeferredPointChecks

    defer = DeferredPointChecks(seed)
    for scalars, points, label in checks:
        defer.check(scalars, points, label)
    defer.verify(backend="sharded", mesh=mesh)


def schnorr(mesh, items, seed) -> None:
    from ..primitives.schnorr import Signature

    Signature.batch_verify(items, backend="sharded", mesh=mesh, seed=seed)


def shuffles(mesh, entries, seed) -> None:
    from ..shuffle.shuffle import batch_verify_shuffle_proofs

    batch_verify_shuffle_proofs(entries, backend="sharded", mesh=mesh, seed=seed)


def transactions(mesh, items, seed, range_bits: int = 64) -> None:
    """``batch_verify_transactions("sharded")`` of transactions whose range
    proofs have ``range_bits`` bits (this rank's protocol setting for the
    call)."""
    from .. import config
    from ..transaction.transaction import batch_verify_transactions

    prev = config.DEFAULT
    config.DEFAULT = dataclasses.replace(prev, range_bits=range_bits)
    try:
        batch_verify_transactions(items, backend="sharded", mesh=mesh, seed=seed)
    finally:
        config.DEFAULT = prev


def range_verify(mesh, n, m, proofs, vlists, seed) -> None:
    from ..bulletproofs.device_verify import get_device_range_verifier

    get_device_range_verifier(n, m, len(proofs), device=mesh.device).verify_sharded(
        proofs, vlists, mesh, rng=_rng(seed))


def shuffle_verify(mesh, m, entries, seed) -> None:
    from ..shuffle.device_verify import get_device_shuffle_verifier

    get_device_shuffle_verifier(m, len(entries), device=mesh.device).verify_sharded(
        entries, mesh, rng=_rng(seed))


def range_prove(mesh, n, m, values, blindings, rngs):
    """(proof bytes, V lists) of every lane; ``rngs``: one SeededRng a lane."""
    from ..bulletproofs.device_prove import get_device_range_prover

    proofs, vlists = get_device_range_prover(n, m, len(values), device=mesh.device).prove_sharded(
        values, blindings, rngs, mesh)
    return [p.to_bytes() for p in proofs], vlists


def shuffle_prove(mesh, m, shuffle_list, rngs):
    """[(ShuffleProof, ShuffleStatement)] of every lane."""
    from ..shuffle.device_prove import get_device_shuffle_prover

    return get_device_shuffle_prover(m, len(shuffle_list), device=mesh.device).prove_sharded(
        shuffle_list, rngs, mesh)


def collectives(mesh, nbytes: int, reps: int = 20) -> dict:
    """Median ms on this rank of each collective that the sharded paths
    make: the all-gather of an MSM's partial point (4 x 10 int32), the
    all-reduce of a count, the gather of error rows (``first_error``) and a
    broadcast of ``nbytes`` (a deferred accumulator's terms)."""
    point = torch.zeros((4, 10), dtype=torch.int32, device=mesh.device)
    data = bytes(nbytes)
    ops = {"all_gather point": lambda: mesh.all_gather(point),
           "all_reduce count": lambda: mesh.all_reduce_sum(0),
           "first_error": lambda: mesh.first_error(""),
           f"broadcast {nbytes} bytes": lambda: mesh.broadcast_bytes(data)}
    out = {}
    for name, fn in ops.items():
        seconds = []
        for _ in range(reps):
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            fn()
            _sync(mesh)
            seconds.append(time.perf_counter() - t0)
        out[name] = statistics.median(seconds) * 1e3
    return out


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def run_calls(mesh, calls, repeat: int = 1) -> dict:
    """calls: [(label, program name in this module, args[, times])]. Runs
    each call ``times`` (default ``repeat``) times, each on a fresh copy of
    its args (a call may advance the transcripts it is given), all ranks
    starting together, and returns {label: {"outcome": ("ok", value) or
    ("ValueError", message), "seconds": [...] (host clock, to the device's
    end), "median_s", "launches": this rank's kernel launches in the first
    run}} plus "backend" and "device"."""
    report = {"backend": mesh.backend, "device": str(mesh.device)}
    for label, name, args, *times in calls:
        fn = globals()[name]
        seconds, launches, outcome = [], None, None
        for _ in range(times[0] if times else repeat):
            fresh = copy.deepcopy(args)
            cuda_build.reset_launches()
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            try:
                outcome = ("ok", fn(mesh, *fresh))
            except ValueError as e:
                outcome = ("ValueError", str(e))
            _sync(mesh)
            seconds.append(time.perf_counter() - t0)
            if launches is None:
                launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        report[label] = {"outcome": outcome, "seconds": seconds,
                         "median_s": statistics.median(seconds), "launches": launches}
    return report
