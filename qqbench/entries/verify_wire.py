"""``verify_wire``: blocks of wire transactions verified by the port's
verification service (``VerificationService.verify_wire``)."""

from __future__ import annotations

import itertools
import random

from .. import gen
from ..stats import Call


class VerifyWire:
    """``VerificationService(backend=<mix backend>, workers=<mix
    workers>).verify_wire`` on groups of ``group_size`` wire transactions.

    The inputs' transactions are cut into consecutive groups, all honest.
    They go out in a seeded order, one seeded permutation of all groups
    after another, except that every ``tamper_every``-th call (the second,
    then every ``tamper_every`` calls) sends the group that holds the
    tampered transaction with one tampered copy in it, the mix's kinds in
    turn. So every run holds the same share of rejected groups at the same
    places, whatever the seed. A group's verdict is right when it equals
    the reference's (accepted where every member verifies), and an
    accepted call must return the group's size."""

    kind = "verify"
    #: the inputs' key of the honest members, and what a member is
    members, member = "pairs", "transactions"

    @staticmethod
    def inputs(config: dict, mix: dict, seed: int):
        """``gen.verify_inputs``: the mix's wire transactions, one seeded
        transaction's tampered copies, and the reference's verdicts."""
        return gen.verify_inputs(config, mix, seed)

    @staticmethod
    def install_spans(spans) -> None:
        """Spans around the device layer of the device-batched backend and
        its deferred device MSM; labels of the wire decoding and the host
        replay."""
        from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks, DeviceBatchCollector
        from quisquis_tpu_torch.transaction import transaction as tx
        from quisquis_tpu_torch.utils import serde

        spans.wrap(DeviceBatchCollector, "verify", "device_verify")
        spans.wrap(DeferredPointChecks, "verify", "device_msm",
                   when=lambda self, backend="auto", **k: backend == "device")
        spans.label(serde, "transaction_from_bytes", "wire_decode")
        spans.label(serde, "transaction_proof_from_bytes", "wire_decode")
        spans.label(tx, "verify_transaction_auto", "host_replay")

    def __init__(self, config: dict, mix: dict, inputs: dict, seed: int, device: str):
        self.config, self.mix, self.inputs, self.seed = config, mix, inputs, seed
        size, n = int(mix["group_size"]), len(inputs[self.members])
        if n % size:
            raise ValueError(f"{n} {self.member} are not whole groups of {size}")
        self.groups = [list(range(i, i + size)) for i in range(0, n, size)]
        self.bad_group = inputs["tampered_index"] // size
        self.kinds = sorted(inputs["tampered"])
        self.every = int(mix["tamper_every"])
        if self.every < 2:
            raise ValueError("tamper_every must be at least 2")
        self.svc = self.service(device)

    def service(self, device: str):
        """What verifies a group: ``verify_wire(pairs) -> count``, raising
        ValueError on a rejected group."""
        from quisquis_tpu_torch.serving import VerificationService

        return VerificationService(workers=self.mix.get("workers") or 1,
                                   backend=self.mix["backend"], device=device)

    def items(self):
        """(group index, tampered kind or None), endlessly."""
        rng = random.Random(f"qqbench-order|{self.seed}")
        honest, n_bad = [], 0
        for k in itertools.count():
            if k % self.every == 1:
                yield self.bad_group, self.kinds[n_bad % len(self.kinds)]
                n_bad += 1
                continue
            if not honest:
                honest = list(range(len(self.groups)))
                rng.shuffle(honest)
            yield honest.pop(), None

    def payload(self, item):
        g, kind = item
        pairs = [self.inputs[self.members][i] for i in self.groups[g]]
        if kind is not None:
            pairs[self.inputs["tampered_index"] - self.groups[g][0]] = self.inputs["tampered"][kind]
        return pairs

    def call(self, item, out: Call) -> None:
        pairs = self.payload(item)
        out.size = len(pairs)
        try:
            out.done = self.svc.verify_wire(pairs)
            out.verdict = True
        except ValueError as e:
            out.verdict, out.error = False, str(e)[:200]

    def settle(self, call: Call) -> None:
        """Nothing of a verify call is kept but its verdict and count."""

    def expected(self, item) -> bool:
        g, kind = item
        ok = all(self.inputs["verdicts"][i] for i in self.groups[g])
        return ok and (kind is None or self.inputs["tampered_verdicts"][kind])

    def judge(self, calls, config: dict, mix: dict, seed: int) -> dict:
        wrong = sum(1 for c in calls if c.verdict is not None
                    and c.verdict != self.expected(c.item))
        short = sum(1 for c in calls if c.verdict and c.done != c.size)
        return {"wrong_verdicts": (wrong, 0), "wrong_counts": (short, 0)}

    def close(self) -> None:
        self.svc.close()


Entry = VerifyWire
