"""``build``: batches of transactions built by the port's batched builder
(``batch_create_transactions``)."""

from __future__ import annotations

from .. import gen
from ..stats import Call


class Build:
    """``batch_create_transactions(range_backend=<mix range_backend>)`` on
    one request set a call (the sets in turn from set 0), so one
    ``DeviceRangeProver`` call a build. The wire requests become the
    port's objects inside the call's time (a proving pool receives them as
    bytes). A build is right when every transaction's wire bytes equal
    the reference's build of the same request."""

    kind = "build"

    @staticmethod
    def inputs(config: dict, mix: dict, seed: int):
        """``gen.build_inputs``: the mix's request sets in wire form."""
        return gen.build_inputs(config, mix, seed)

    @staticmethod
    def install_spans(spans) -> None:
        """A span around the range step's batched proof; labels of the host
        steps before and after it."""
        from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
        from quisquis_tpu_torch.transaction import transaction as tx

        spans.wrap(RangeProof, "prove_batch", "prove_batch")
        spans.label(tx, "_tx_pre_range", "host_pre_range")
        spans.label(tx, "_tx_post_range", "host_post_range")

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
        reqs = [gen.request_from_wire(w, *self.classes) for w in self.inputs[item]]
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
        ref = gen.reference_builds(config, mix, seed, [c.item for c in calls], self.inputs)
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


Entry = Build
