"""The entries that a cell's window drives: the system under test.

A mix file's ``entry`` names one of :data:`ENTRIES`. An entry is made from
the configuration, the mix, the generated inputs and the seed; it hands out
the loop's items in order (:meth:`items`), makes one call of the port per
item (:meth:`call`), and judges the answers against the reference once the
window has closed (:meth:`judge`). Only here does the benchmark import the
port (``quisquis_tpu_torch``).
"""

from __future__ import annotations

import itertools
import random

from .stats import Call


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

    def __init__(self, config: dict, mix: dict, inputs: dict, seed: int, device: str):
        self.mix, self.inputs, self.seed = mix, inputs, seed
        size, n = int(mix["group_size"]), len(inputs["pairs"])
        if n % size:
            raise ValueError(f"{n} transactions are not whole groups of {size}")
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
        pairs = [self.inputs["pairs"][i] for i in self.groups[g]]
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


class Build:
    """``batch_create_transactions(range_backend=<mix range_backend>)`` on
    one request set a call (the sets in turn from set 0), so one
    ``DeviceRangeProver`` call a build. The wire requests become the
    port's objects inside the call's time (a proving pool receives them as
    bytes). A build is right when every transaction's wire bytes equal
    the reference's build of the same request."""

    kind = "build"

    def __init__(self, config: dict, mix: dict, inputs: list, seed: int, device: str):
        self.mix, self.inputs, self.device = mix, inputs, device
        self.bind()

    def bind(self) -> None:
        """The classes that read a wire request, the batched builder, and
        the wire encoder of its transactions: the port's."""
        import quisquis_tpu_torch  # noqa: F401  (the C++ curve under the port's host steps)
        from quisquis_tpu_torch.accounts.accounts import Account
        from quisquis_tpu_torch.accounts.transcript import SeededRng
        from quisquis_tpu_torch.primitives.keys import RistrettoSecretKey
        from quisquis_tpu_torch.transaction.transaction import batch_create_transactions
        from quisquis_tpu_torch.utils import serde

        self.classes = (Account, RistrettoSecretKey, SeededRng)
        self.create = batch_create_transactions
        self.serde = serde

    def items(self):
        k = 0
        while True:
            yield k % len(self.inputs)
            k += 1

    def call(self, item, out: Call) -> None:
        from .gen import request_from_wire

        reqs = [request_from_wire(w, *self.classes) for w in self.inputs[item]]
        out.size = len(reqs)
        built = self.create(reqs, range_backend=self.mix["range_backend"], device=self.device)
        out.done, out.verdict, out.output = len(built), True, built

    def settle(self, call: Call) -> None:
        """A build's transactions kept as their wire bytes from the moment
        the call returns, so that what a run keeps alive for the judge
        stays small (no growing heap of points for the collector to walk)."""
        if call.output is not None:
            serde = self.serde
            call.output = [(serde.transaction_to_bytes(tx), serde.transaction_proof_to_bytes(p))
                           for tx, p in call.output]

    def judge(self, calls, config: dict, mix: dict, seed: int) -> dict:
        from .gen import reference_builds

        ref = reference_builds(config, mix, seed, [c.item for c in calls], self.inputs)
        wrong = 0
        for c in calls:
            if c.output is None:
                continue
            got, want = c.output, ref[c.item]
            wrong += sum(1 for a, b in zip(got, want) if a != b) + abs(len(got) - len(want))
            c.output = None
        return {"wrong_transactions": (wrong, 0)}

    def close(self) -> None:
        pass


ENTRIES = {"verify_wire": VerifyWire, "build": Build}
