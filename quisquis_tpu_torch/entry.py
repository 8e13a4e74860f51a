"""The port's flagship step: batched ElGamal commitment generation followed
by verification (BASELINE configs 1-2), the counterpart of
``__graft_entry__.py``'s ``_flagship_fn``, ``_example_inputs`` and
``entry``; and its multi-GPU dry run, ``dryrun_multichip``.

    python -m quisquis_tpu_torch.entry --dryrun N [--device cpu]

runs the dry run on N ranks of this host (one process each) and ends with
``dryrun_multichip(N): OK``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .device import resolve_device
from .ops import batch as qb
from .ops import exact as ex
from .ops import point as pt


def flagship_step(gr_x, gr_y, gr_z, gr_t, grsk_x, grsk_y, grsk_z, grsk_t,
                  r_nib, v_nib, sk_nib):
    """comm = Enc_pk(v; r), then d == v*G + sk*c per lane."""
    pk = qb.BatchPk(pt.ExtPoint(gr_x, gr_y, gr_z, gr_t),
                    pt.ExtPoint(grsk_x, grsk_y, grsk_z, grsk_t))
    comm = qb.generate_commitments(pk, r_nib, v_nib)
    ok = qb.verify_commitments(comm, sk_nib, v_nib)
    return ok, comm.c.x, comm.d.x


def _example_values(batch: int):
    """(sks, rs, vs, gr points): the JAX package's entry's seeded values."""
    rng = np.random.default_rng(7)
    sks = [int(rng.integers(1, 2**62)) for _ in range(batch)]
    rs = [int(rng.integers(1, 2**62)) for _ in range(batch)]
    vs = [int(rng.integers(0, 2**32)) for _ in range(batch)]
    return sks, rs, vs, [ex.pt_base_mul(int(rng.integers(1, 2**62))) for _ in range(batch)]


def example_inputs(batch: int, device="cuda"):
    """The same seeded keys and scalars as the JAX package's entry."""
    dev = resolve_device(device)
    sks, rs, vs, gr_pts = _example_values(batch)
    grsk_pts = [ex.pt_mul(sk, p) for sk, p in zip(sks, gr_pts)]
    gr = pt.from_exact_batch(gr_pts, dev)
    grsk = pt.from_exact_batch(grsk_pts, dev)
    return (*gr, *grsk, qb.scalars_to_device(rs, dev), qb.scalars_to_device(vs, dev),
            qb.scalars_to_device(sks, dev))


def entry(device="cuda"):
    """(step, example_args) at batch 8."""
    return flagship_step, example_inputs(8, device)


def _dryrun_rank(mesh) -> list:
    """One rank of the dry run (one lane a rank): the sharded pipeline of
    ``__graft_entry__.dryrun_multichip`` on tiny shapes, every result
    checked against the host. Rank 0 prints each stage with its seconds;
    returns [(stage, seconds)]."""
    from .accounts.accounts import Account
    from .accounts.prover import Prover
    from .accounts.transcript import SeededRng, Transcript
    from .bulletproofs.device_prove import DeviceRangeProver
    from .bulletproofs.device_verify import DeviceRangeVerifier
    from .parallel import sharded_commitment_verify, sharded_msm
    from .primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from .shuffle.device_prove import DeviceShuffleProver
    from .shuffle.device_verify import DeviceShuffleVerifier
    from .shuffle.shuffle import Shuffle, ShuffleProof

    stages, batch, dev = [], mesh.size, mesh.device
    t0 = time.perf_counter()

    def stage(name: str) -> None:
        nonlocal t0
        stages.append((name, time.perf_counter() - t0))
        if mesh.rank == 0:
            print(f"  {name}: {stages[-1][1]:.2f} s", flush=True)
        t0 = time.perf_counter()

    # the sharded step: each rank generates and updates its lanes' commitments
    gx, gy, gz, gt, hx, hy, hz, ht, r_nib, v_nib, sk_nib = example_inputs(batch, "cpu")
    gr, grsk = pt.ExtPoint(gx, gy, gz, gt), pt.ExtPoint(hx, hy, hz, ht)
    pk = qb.BatchPk(mesh.shard(gr), mesh.shard(grsk))
    comm = qb.generate_commitments(pk, mesh.shard(r_nib), mesh.shard(v_nib))
    qb.update_accounts(pk, comm, mesh.shard(v_nib), mesh.shard(r_nib), mesh.shard(sk_nib))
    whole = qb.BatchCommitment(*(pt.ExtPoint(*(mesh.all_gather(c).flatten(0, 1) for c in p))
                                 for p in comm))
    if not sharded_commitment_verify(mesh, whole, sk_nib, v_nib):
        raise RuntimeError("sharded commitment verification failed")
    stage("commitments generated, updated, verified (sharded)")

    total = sharded_msm(mesh, r_nib, gr)
    _, rs, _, gr_pts = _example_values(batch)
    want = ex.pt_msm(rs, gr_pts)
    if not ex.pt_eq(pt.to_exact_batch(pt.ExtPoint(*(c[None].cpu() for c in total)))[0], want):
        raise RuntimeError("sharded MSM differs from the host MSM")
    stage("sharded MSM")

    # BASELINE configs 4-5: the device verifiers with the lane axis over the
    # ranks (8-bit range proofs, 4-account shuffles, one lane a rank)
    from .bulletproofs.range_proof import RangeProof

    rng = SeededRng(seed=b"dryrun-sharded")
    proofs, vlists = [], []
    for i in range(batch):
        p, V = RangeProof.prove_multiple(Transcript(b"RangeProof"), [i + 1],
                                         [rng.random_scalar()], 8, rng=rng)
        proofs.append(p)
        vlists.append(V)
    DeviceRangeVerifier(8, 1, batch, device=dev).verify_sharded(proofs, vlists, mesh,
                                                                rng=SeededRng(seed=b"w"))
    stage("range verify_sharded")

    accounts = []
    for _ in range(4):
        sk = RistrettoSecretKey.random(rng)
        accounts.append(Account.generate_account(RistrettoPublicKey.from_secret_key(sk, rng),
                                                 rng)[0])
    entries = []
    for _ in range(batch):
        sh = Shuffle.input_shuffle(accounts, rng=rng)
        proof, stmt = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), sh, rng=rng)
        entries.append((proof, stmt, sh.get_inputs_vector(), sh.get_outputs_vector()))
    DeviceShuffleVerifier(2, batch, device=dev).verify_sharded(entries, mesh,
                                                              rng=SeededRng(seed=b"w2"))
    stage("shuffle verify_sharded")

    # the sharded provers, every lane byte-checked against the host provers
    p_seeds = [b"dr-lane-%d" % i for i in range(batch)]
    p_values = [[i + 1] for i in range(batch)]
    p_blinds = [[rng.random_scalar()] for _ in range(batch)]
    sh_proofs, sh_V = DeviceRangeProver(8, 1, batch, device=dev).prove_sharded(
        p_values, p_blinds, [SeededRng(seed=s) for s in p_seeds], mesh)
    for i in range(batch):
        host_p, host_V = RangeProof.prove_multiple(Transcript(b"RangeProof"), p_values[i],
                                                   p_blinds[i], 8, rng=SeededRng(seed=p_seeds[i]))
        if sh_proofs[i].to_bytes() != host_p.to_bytes() or sh_V[i] != host_V:
            raise RuntimeError(f"sharded range prover diverged from the host on lane {i}")
    stage("range prove_sharded")

    s_seeds = [b"ds-lane-%d" % i for i in range(batch)]
    shuffles = [Shuffle.input_shuffle(accounts, rng=SeededRng(seed=b"s%d" % i))
                for i in range(batch)]
    proved = DeviceShuffleProver(2, batch, device=dev).prove_sharded(
        shuffles, [SeededRng(seed=s) for s in s_seeds], mesh)
    for i in range(batch):
        lane = SeededRng(seed=s_seeds[i])
        want = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=lane), shuffles[i], rng=lane)
        if tuple(proved[i]) != tuple(want):
            raise RuntimeError(f"sharded shuffle prover diverged from the host on lane {i}")
    stage("shuffle prove_sharded")
    return stages


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 600) -> None:
    """One step of every sharded path on ``n_devices`` ranks of this host
    (tiny shapes, one lane a rank), each result checked against the host:
    the counterpart of ``__graft_entry__.dryrun_multichip``. ``device="cuda"``,
    the default, raises without a GPU. Prints each stage and ends with
    ``dryrun_multichip(N): OK``; raises if a rank failed or the ranks
    outran ``timeout_s``."""
    from .parallel import launch

    t0 = time.perf_counter()
    launch("quisquis_tpu_torch.entry:_dryrun_rank", n_devices, device, timeout_s=timeout_s)
    print(f"dryrun_multichip({n_devices}): OK ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, required=True, metavar="N",
                    help="run the multi-GPU dry run on N ranks of this host")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.dryrun, args.device)


if __name__ == "__main__":
    main()
