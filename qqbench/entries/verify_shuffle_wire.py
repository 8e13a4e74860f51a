"""``verify_shuffle_wire``: groups of standalone wire shuffle proofs verified
by the port's shuffle verification service
(``ShuffleVerificationService.verify_wire``).

The inputs are made by the reference alone: ``proofs`` shuffles, each of
its own ``anonymity_set_size`` seeded accounts, each proved by the
reference's host prover with the configuration's proof and transcript
labels, as wire entries (``ref.utils.serde.shuffle_entry_to_bytes``); and,
for one proof picked by the seed, one tampered copy for each kind in the
mix's ``tampered`` list. The reference's verdict on every entry is part of
the inputs, and inputs in which it accepts a tampered copy or rejects an
honest entry are refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

from .. import gen
from .verify_wire import VerifyWire

#: one element changed in each of three sub-arguments of the shuffle proof
TAMPER_KINDS = ("ddh_z", "multiexpo_commit_E_k_0", "product_svp_r_twildle")


def labels(config: dict) -> tuple:
    """(proof label, transcript label) of the configuration, as bytes."""
    return config["proof_label"].encode(), config["transcript_label"].encode()


def ref_prove(tag: bytes, config: dict, i: int) -> bytes:
    """Entry i of a tag: a shuffle of the configuration's anonymity set of
    seeded accounts (each with a balance), proved by the reference, as
    wire bytes."""
    from ..ref.accounts.accounts import Account
    from ..ref.accounts.prover import Prover
    from ..ref.accounts.transcript import SeededRng, Transcript
    from ..ref.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from ..ref.shuffle.shuffle import Shuffle, ShuffleProof
    from ..ref.utils import serde

    rng = SeededRng(seed=tag + b"-p%d" % i)
    accounts = []
    for j in range(int(config["anonymity_set_size"])):
        pk = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(rng), rng)
        acc, _ = Account.generate_account(pk, rng)
        accounts.append(Account.update_account(acc, 20 + j, rng.random_scalar(),
                                               rng.random_scalar()))
    shuffle = Shuffle.input_shuffle(accounts, rng=rng)
    proof_label, transcript_label = labels(config)
    proof, statement = ShuffleProof.create_shuffle_proof(
        Prover(proof_label, Transcript(transcript_label), rng=rng), shuffle, rng=rng)
    return serde.shuffle_entry_to_bytes(proof, statement, shuffle.get_inputs_vector(),
                                        shuffle.get_outputs_vector())


def ref_verify(blob: bytes, config: dict, weight_seed: bytes, point_checks: bool = True) -> bool:
    """The reference's verdict on one wire shuffle entry: True where it
    verifies, False where it is malformed or a check fails. With
    `point_checks` False the batched point checks (every
    multi-exponentiation, product and Hadamard identity) are never
    evaluated: the control's verdict."""
    from ..ref.accounts.deferred import DeferredPointChecks
    from ..ref.accounts.transcript import Transcript
    from ..ref.accounts.verifier import Verifier
    from ..ref.utils import serde

    proof_label, transcript_label = labels(config)
    try:
        proof, statement, ins, outs = serde.shuffle_entry_from_bytes(blob)
        defer = DeferredPointChecks(weight_seed)
        proof.verify(Verifier(proof_label, Transcript(transcript_label)), statement, ins, outs,
                     defer=defer)
        if point_checks:
            defer.verify()
    except ValueError:
        return False
    return True


def _prove_and_verify(tag: bytes, config: dict, n: int, indices: list) -> list:
    """Worker: the entries `indices` of a tag, with the reference's verdicts."""
    out = []
    for i in indices:
        blob = ref_prove(tag, config, i)
        out.append((i, blob, ref_verify(blob, config, hashlib.sha256(tag + b"w%d" % i).digest())))
    return out


def tamper(blob: bytes, kind: str) -> bytes:
    """A copy of a wire shuffle entry with one value of its proof changed
    to another valid encoding: the DDH proof's response ``z`` plus one, the
    commitment multi-exponentiation argument's first ``E_k_0`` point moved
    by the base point, or the product argument's single-value-product
    response ``r_twildle`` plus one."""
    from ..ref.ops import exact as ex
    from ..ref.utils import serde

    proof, statement, ins, outs = serde.shuffle_entry_from_bytes(blob)
    if kind == "ddh_z":
        ddh = proof.ddh_proof
        proof = dataclasses.replace(proof, ddh_proof=dataclasses.replace(ddh, z=(ddh.z + 1) % ex.L))
    elif kind == "multiexpo_commit_E_k_0":
        me = proof.multi_exponen_commit
        moved = ex.ristretto_encode(ex.pt_add(ex.ristretto_decode(me.E_k_0[0]), ex.BASEPOINT))
        proof = dataclasses.replace(
            proof, multi_exponen_commit=dataclasses.replace(me, E_k_0=[moved] + list(me.E_k_0[1:])))
    elif kind == "product_svp_r_twildle":
        pp = proof.product_proof
        svp = dataclasses.replace(pp.svp_proof, r_twildle=(pp.svp_proof.r_twildle + 1) % ex.L)
        proof = dataclasses.replace(proof, product_proof=dataclasses.replace(pp, svp_proof=svp))
    else:
        raise ValueError(f"unknown tampering {kind!r}")
    return serde.shuffle_entry_to_bytes(proof, statement, ins, outs)


def shuffle_inputs(config: dict, mix: dict, seed: int, workers: int = gen.POOL_WORKERS):
    """``gen.checked_inputs`` of a shuffle mix: ``proofs`` wire shuffle
    entries as "entries"."""
    return gen.checked_inputs("shuffle", config, seed, int(mix["proofs"]), mix["tampered"],
                              "entries", _prove_and_verify, tamper,
                              lambda blob, weight_seed: ref_verify(blob, config, weight_seed),
                              owner=Path(__file__), workers=workers)


class VerifyShuffleWire(VerifyWire):
    """``ShuffleVerificationService(backend=<mix backend>, workers=<mix
    workers>, proof_label, transcript_label).verify_wire`` on groups of
    ``group_size`` wire shuffle entries, sent and judged as
    :class:`VerifyWire` sends and judges its groups: each group's verdict
    must equal the reference's, and an accepted call must return the
    group's size."""

    kind = "shuffle"
    members, member = "entries", "proofs"

    @staticmethod
    def inputs(config: dict, mix: dict, seed: int):
        return shuffle_inputs(config, mix, seed)

    @staticmethod
    def install_spans(spans) -> None:
        """Spans around the service's host steps before the device verifier
        (``host_ms.shuffle`` reads them): the wire decoding, and the
        transcripts it sets up, each ``Transcript`` with its ``Verifier``
        domain separator. Only where no span of the port is open, so that
        none of them lies inside the port's own spans."""
        from quisquis_tpu_torch.accounts.transcript import Transcript
        from quisquis_tpu_torch.accounts.verifier import Verifier
        from quisquis_tpu_torch.utils import serde
        from quisquis_tpu_torch.utils.metrics import metrics

        def outside(*a, **k):
            return not metrics._stack()
        spans.wrap(serde, "shuffle_entry_from_bytes", "wire_decode", when=outside)
        spans.wrap(Transcript, "__init__", "transcript_setup", when=outside)
        spans.wrap(Verifier, "__init__", "transcript_setup", when=outside)

    def service(self, device: str):
        from quisquis_tpu_torch.serving import ShuffleVerificationService

        proof_label, transcript_label = labels(self.config)
        return ShuffleVerificationService(workers=self.mix.get("workers") or 1,
                                          backend=self.mix["backend"], proof_label=proof_label,
                                          transcript_label=transcript_label, device=device)


Entry = VerifyShuffleWire
