"""The benchmark's input generator: everything a cell sends, made from the
seed with the frozen reference (``qqbench.ref``), never by the program.

Each entry (``qqbench/entries/<name>.py``) owns its inputs; this module holds
what they share (the pool of reference processes, the cache and
``seed_tag``) and the transaction traffic of the two transaction entries:

- ``verify_wire`` (:func:`verify_inputs`): ``transactions`` wire
  transactions of the configuration (``benchmark_requests``' streams,
  built by the reference's host ``create_transaction``), and for one
  transaction, picked by the seed, one tampered copy for each kind in the
  mix's ``tampered`` list. The reference's verdict on every transaction
  and every tampered copy is part of the inputs.
- ``build`` (:func:`build_inputs`): ``request_sets`` sets of
  ``requests_per_call`` build requests in a wire form (accounts by their
  bytes, secret keys by their scalar, the rng by its seed), which both the
  program and the reference turn into their own objects.

Inputs are cached in ``.qqbench_cache/inputs/``, keyed by configuration,
mix parameters, seed and the hash of the generator's sources (this file,
``qqbench/ref/`` and the file of the entry whose generator made them), so a
cell's first run with a seed pays for them and the runs after it read them
back.

:func:`checked_inputs` is the one generator of verify entries: items made
and judged by the reference in the pool, one seeded item's tampered copies,
and the reference's verdicts, refused where it rejects an honest item or
accepts a tampered one.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import multiprocessing as mp
import os
import pickle
import random
import time
from pathlib import Path

from .paths import PKG, cache_dir

#: the processes that build inputs and run the reference (one a core, at most 8)
POOL_WORKERS = max(1, min(8, os.cpu_count() or 1))
TAMPER_KINDS = ("range_proof_ipp_a", "output_shuffle_E_k_0", "sigma_delta_dleq_zv_0")


def generator_hash(owner: Path = None) -> str:
    """sha256 over the generator's and the reference's sources, and the
    file `owner` (an entry that makes its own inputs) where given."""
    h = hashlib.sha256()
    files = ([PKG / "gen.py"] + ([Path(owner)] if owner is not None else [])
             + sorted(p for p in (PKG / "ref").rglob("*") if p.suffix in (".py", ".cpp")))
    for p in files:
        h.update(str(p.relative_to(PKG)).encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def seed_tag(config: dict, seed: int, what: str) -> bytes:
    """The byte tag from which a configuration's streams derive."""
    return f"qqbench|{config['name']}|{what}|{int(seed)}".encode()


def pool(workers: int = POOL_WORKERS) -> cf.ProcessPoolExecutor:
    """A pool of fresh interpreters (spawn) that import only the reference."""
    return cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"))


# ---------------------------------------------------------------- requests

def request_to_wire(req: dict, rng_seed: bytes) -> dict:
    """A reference build request (``benchmark_requests``' dict) as plain
    bytes and ints."""
    return {
        "value_vector": list(req["value_vector"]),
        "account_vector": [a.as_bytes() for a in req["account_vector"]],
        "sender_updated_balance": list(req["sender_updated_balance"]),
        "sender_sk": [sk.scalar for sk in req["sender_sk"]],
        "anonymity_comm_scalar": list(req["anonymity_comm_scalar"]),
        "anonymity_account_diff": int(req["anonymity_account_diff"]),
        "receiver_updated_balance": list(req["receiver_updated_balance"]),
        "senders_count": int(req["senders_count"]),
        "receivers_count": int(req["receivers_count"]),
        "rng_seed": bytes(rng_seed),
    }


def request_from_wire(w: dict, account, secret_key, seeded_rng) -> dict:
    """``create_transaction`` keyword arguments from a wire request, with
    the given classes (the program's or the reference's)."""
    return dict(value_vector=list(w["value_vector"]),
                account_vector=[account.from_bytes(b) for b in w["account_vector"]],
                sender_updated_balance=list(w["sender_updated_balance"]),
                sender_sk=[secret_key(s) for s in w["sender_sk"]],
                anonymity_comm_scalar=list(w["anonymity_comm_scalar"]),
                anonymity_account_diff=w["anonymity_account_diff"],
                receiver_updated_balance=list(w["receiver_updated_balance"]),
                senders_count=w["senders_count"], receivers_count=w["receivers_count"],
                rng=seeded_rng(seed=w["rng_seed"]))


def wire_requests(tag: bytes, n: int, config: dict) -> list:
    """n wire requests of the configuration from one tag: the reference's
    ``benchmark_requests`` (each request's rng seeded with tag-tx<i>)."""
    from .ref.transaction.workloads import benchmark_requests

    reqs = benchmark_requests(tag, n, config["senders"], config["anonymity_set_size"])
    return [request_to_wire(r, tag + b"-tx%d" % i) for i, r in enumerate(reqs)]


def ref_build(wire: dict) -> tuple:
    """The reference's transaction for one wire request, as wire bytes
    (transaction, proof)."""
    from .ref.accounts.accounts import Account
    from .ref.accounts.transcript import SeededRng
    from .ref.primitives.keys import RistrettoSecretKey
    from .ref.transaction.transaction import create_transaction
    from .ref.utils import serde

    tx, proof = create_transaction(**request_from_wire(wire, Account, RistrettoSecretKey,
                                                       SeededRng))
    return serde.transaction_to_bytes(tx), serde.transaction_proof_to_bytes(proof)


def ref_verify(pair: tuple, weight_seed: bytes, point_checks: bool = True) -> bool:
    """The reference's verdict on one wire transaction: True where it
    verifies, False where it is malformed or a check fails. With
    `point_checks` False the batched point checks (every shuffle and
    range-proof identity) are never evaluated: the controls' verdict."""
    from .ref.accounts.deferred import DeferredPointChecks
    from .ref.transaction.transaction import verify_transaction
    from .ref.utils import serde

    try:
        tx = serde.transaction_from_bytes(pair[0])
        proof = serde.transaction_proof_from_bytes(pair[1])
        defer = DeferredPointChecks(weight_seed)
        verify_transaction(tx, proof, defer=defer)
        if point_checks:
            defer.verify()
    except ValueError:
        return False
    return True


def _build_and_verify(tag: bytes, config: dict, n_tx: int, indices: list) -> list:
    """Worker: the transactions `indices` of the tag's n_tx requests, built
    and verified by the reference."""
    reqs = wire_requests(tag, n_tx, config)
    out = []
    for i in indices:
        pair = ref_build(reqs[i])
        out.append((i, pair, ref_verify(pair, hashlib.sha256(tag + b"w%d" % i).digest())))
    return out


def tamper(pair: tuple, kind: str) -> tuple:
    """A copy of a wire transaction with one value of its proof changed to
    another valid encoding: the low bit of the range proof's inner-product
    ``a`` scalar, the output shuffle's first E_k_0 point moved by the base
    point, or the delta proof's first response ``zv`` plus one. Only the
    checks of that proof can reject it: the range and shuffle verifiers
    (on the card in the device-batched backend), or the delta sigma check
    (on the host in every backend)."""
    import dataclasses

    from .ref.bulletproofs.range_proof import RangeProof
    from .ref.ops import exact as ex
    from .ref.utils import serde

    proof = serde.transaction_proof_from_bytes(pair[1])
    if kind == "range_proof_ipp_a":
        blob = bytearray(proof.range_proofs[0].to_bytes())
        blob[-64] ^= 1
        proof = dataclasses.replace(proof, range_proofs=[RangeProof.from_bytes(bytes(blob))])
    elif kind == "output_shuffle_E_k_0":
        sp = proof.output_shuffle_proof
        me = sp.multi_exponen_commit
        moved = ex.ristretto_encode(ex.pt_add(ex.ristretto_decode(me.E_k_0[0]), ex.BASEPOINT))
        me = dataclasses.replace(me, E_k_0=[moved] + list(me.E_k_0[1:]))
        proof = dataclasses.replace(
            proof, output_shuffle_proof=dataclasses.replace(sp, multi_exponen_commit=me))
    elif kind == "sigma_delta_dleq_zv_0":
        zv, zr1, zr2, x = proof.delta_dleq
        proof = dataclasses.replace(proof, delta_dleq=([(zv[0] + 1) % ex.L] + list(zv[1:]),
                                                       zr1, zr2, x))
    else:
        raise ValueError(f"unknown tampering {kind!r}")
    return pair[0], serde.transaction_proof_to_bytes(proof)


# ------------------------------------------------------------------ inputs

def cache_path(kind: str, config: dict, key: dict, seed: int, owner: Path = None) -> Path:
    """Where the inputs of one kind, configuration, mix key and seed are
    cached, under the hash of the generator and of `owner`."""
    h = hashlib.sha256(json.dumps([config, key], sort_keys=True).encode()).hexdigest()[:12]
    return (cache_dir() / "inputs" / config["name"]
            / f"{kind}-{h}-{generator_hash(owner)}-{int(seed)}.pkl")


def cached(path: Path, make):
    """(data, seconds spent making it): read from `path`, or made by
    `make()` and written there."""
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f), 0.0
    t = time.perf_counter()
    data = make()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return data, time.perf_counter() - t


def checked_inputs(what: str, config: dict, seed: int, n: int, kinds: list, members: str,
                   worker, tamper, verify, owner: Path = None, workers: int = POOL_WORKERS):
    """({members: [item] * n, "verdicts": [bool] * n, "tampered_index": t,
    "tampered": {kind: item}, "tampered_verdicts": {kind: bool}}, seconds
    spent making them), from the cache or made now.

    The items come from ``worker(tag, config, n, indices) -> [(i, item,
    the reference's verdict)]`` in the pool, on the tag ``seed_tag(config,
    seed, what)``; item t, picked by the tag, is changed by ``tamper(item,
    kind)`` for each kind, and ``verify(item, weight_seed)`` judges each
    copy. Inputs in which the reference rejects an honest item or accepts a
    tampered one are refused."""
    key = {"n": n, "tampered": list(kinds)}

    def make():
        tag = seed_tag(config, seed, what)
        chunks = [list(range(i, n, workers)) for i in range(min(workers, n))]
        with pool(workers) as p:
            parts = list(p.map(worker, [tag] * len(chunks), [config] * len(chunks),
                               [n] * len(chunks), chunks))
        items, verdicts = [None] * n, [None] * n
        for part in parts:
            for i, item, ok in part:
                items[i], verdicts[i] = item, ok
        t = random.Random(tag).randrange(n)
        tampered = {k: tamper(items[t], k) for k in kinds}
        tv = {k: verify(item, hashlib.sha256(tag + k.encode()).digest())
              for k, item in tampered.items()}
        return {members: items, "verdicts": verdicts, "tampered_index": t,
                "tampered": tampered, "tampered_verdicts": tv}

    data, made_s = cached(cache_path(what, config, key, seed, owner), make)
    if not all(data["verdicts"]) or any(data["tampered_verdicts"].values()):
        raise RuntimeError(f"the reference rejected an honest {what} input or accepted a "
                           "tampered one: the generator or the reference is at fault")
    return data, made_s


def verify_inputs(config: dict, mix: dict, seed: int, workers: int = POOL_WORKERS):
    """:func:`checked_inputs` of a verify mix: ``transactions`` wire
    transactions as "pairs" (tx, proof)."""
    return checked_inputs("verify", config, seed, int(mix["transactions"]), mix["tampered"],
                          "pairs", _build_and_verify, tamper, ref_verify, workers=workers)


def build_inputs(config: dict, mix: dict, seed: int, workers: int = POOL_WORKERS):
    """(``request_sets`` lists of ``requests_per_call`` wire requests,
    seconds spent making them) for a build mix, from the cache or made now;
    set k's tag is the seed's tag with "-<k>" appended."""
    n_sets, per_call = int(mix["request_sets"]), int(mix["requests_per_call"])
    key = {"sets": n_sets, "per_call": per_call}
    tag = seed_tag(config, seed, "build")

    def make():
        tags = [tag + b"-%d" % k for k in range(n_sets)]
        with pool(min(workers, n_sets)) as p:
            return list(p.map(wire_requests, tags, [per_call] * n_sets, [config] * n_sets))

    return cached(cache_path("build", config, key, seed), make)


def _ref_build_set(wires: list) -> list:
    return [ref_build(w) for w in wires]


def reference_builds(config: dict, mix: dict, seed: int, sets: list,
                     inputs: list, workers: int = POOL_WORKERS) -> dict:
    """{k: [(tx, proof) wire bytes]} for each request set k in `sets`: what
    the reference builds from them, from the cache or made now in a pool
    (one task a request)."""
    out, todo = {}, []
    for k in sorted(set(sets)):
        path = cache_path(f"refbuild{k}", config, {"per_call": len(inputs[k])}, seed)
        if path.exists():
            with open(path, "rb") as f:
                out[k] = pickle.load(f)
        else:
            todo.append((k, path))
    if todo:
        with pool(workers) as p:
            futs = {k: [p.submit(_ref_build_set, [w]) for w in inputs[k]] for k, _ in todo}
            for k, path in todo:
                out[k] = cached(path, lambda k=k: [f.result()[0] for f in futs[k]])[0]
    return out
