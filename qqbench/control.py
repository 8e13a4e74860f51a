"""The controls: the reference put in the program's place with one guarantee
of the configuration broken, to show that the comparison that decides
``correct`` fails them.

- verify cells, ``no-point-checks``: the reference verifier without its
  batched point checks (the one MSM that holds every shuffle and
  range-proof identity); the sigma checks still run. It breaks the shuffle
  and range soundness that the configuration states.
- verify cells, ``no-sigma-checks``: the reference verifier with its
  sigma verifiers skipped (neither their checks nor their transcript
  steps run); the batched point checks still run. It breaks the sigma
  soundness, the host-side layer of every verify backend. (Skipping only
  their final challenge comparisons breaks nothing: a sigma response
  enters the transcript through the commitments recomputed from it, so a
  tampered one moves every later challenge and the range and shuffle
  checks reject it; ``tests/test_qqbench_harness.py`` shows it.)
- shuffle cells, ``no-point-checks``: the reference shuffle verifier
  without its batched point checks (every multi-exponentiation, product and
  Hadamard identity rides them); the transcript and the scalar checks
  (the product's and the DDH challenge) still run. It breaks the shuffle
  soundness that the configuration states.
- build cells, ``range-32``: the reference builder with 32-bit range
  proofs in place of the configuration's 64 bits, the step that would
  tempt a faster prover.

    python3 qqbench/control.py --workload <name> --control <name> --seeds <a,b,c> --seconds <s>

prints, for each seed, the compared numbers and ``correct`` (which must be
false), and exits 0 only where every seed's control came out not correct.
The benchmark's own runs never run it. It needs no card: the reference
runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qqbench.entries import Build, VerifyShuffleWire, VerifyWire  # noqa: E402


class _RefVerifier:
    """``verify_wire`` on a reference verdict: every item judged by
    ``verdict(item)``; a group with a rejected item raises ValueError."""

    def __init__(self, verdict):
        self.verdict = verdict

    def verify_wire(self, items) -> int:
        if not all(self.verdict(item) for item in items):
            raise ValueError("rejected")
        return len(items)

    def close(self) -> None:
        pass


#: the reference's sigma verifiers (static methods of its Verifier)
SIGMA_CHECKS = ("verify_delta_compact_verifier", "verify_update_account_verifier",
                "zero_balance_account_vector_verifier", "verify_account_verifier_bulletproof")


def _no_sigma_verdict(pair) -> bool:
    """The reference's verdict with its sigma verifiers skipped: they do
    nothing, so neither their checks nor their transcript steps run."""
    from qqbench.gen import ref_verify
    from qqbench.ref.accounts.verifier import Verifier

    saved = {name: getattr(Verifier, name) for name in SIGMA_CHECKS}
    try:
        for name in SIGMA_CHECKS:
            setattr(Verifier, name, staticmethod(lambda *a, **k: None))
        return ref_verify(pair, bytes(32))
    finally:
        for name, fn in saved.items():
            setattr(Verifier, name, staticmethod(fn))


class ControlVerify(VerifyWire):
    def service(self, device: str):
        from qqbench.gen import ref_verify

        return _RefVerifier(lambda pair: ref_verify(pair, bytes(32), point_checks=False))


class ControlNoSigma(VerifyWire):
    def service(self, device: str):
        return _RefVerifier(_no_sigma_verdict)


class ControlShuffle(VerifyShuffleWire):
    def service(self, device: str):
        from qqbench.entries.verify_shuffle_wire import ref_verify

        return _RefVerifier(lambda blob: ref_verify(blob, self.config, bytes(32),
                                                    point_checks=False))


class ControlBuild(Build):
    """The reference's builder at 32-bit ranges, one request at a time."""

    RANGE_BITS = 32

    def bind(self) -> None:
        from qqbench.ref.accounts.accounts import Account
        from qqbench.ref.accounts.transcript import SeededRng
        from qqbench.ref.config import DEFAULT
        from qqbench.ref.primitives.keys import RistrettoSecretKey
        from qqbench.ref.transaction.transaction import create_transaction
        from qqbench.ref.utils import serde

        self.classes = (Account, RistrettoSecretKey, SeededRng)
        self.serde = serde
        self._bits = DEFAULT.range_bits

        def create(reqs, **_):
            DEFAULT.range_bits = self.RANGE_BITS
            try:
                return [create_transaction(**r) for r in reqs]
            finally:
                DEFAULT.range_bits = self._bits
        self.create = create


#: control name -> {the kind of cell it stands in for: its entry}
CONTROLS = {"no-point-checks": {"verify": ControlVerify, "shuffle": ControlShuffle},
            "no-sigma-checks": {"verify": ControlNoSigma},
            "range-32": {"build": ControlBuild}}


def control_factory(name: str):
    """The entry factory of run_cell that puts control `name` in the
    program's place."""
    def factory(entry_cls, config, mix, inputs, seed):
        if entry_cls.kind not in CONTROLS[name]:
            raise ValueError(f"control {name!r} is for {sorted(CONTROLS[name])} cells, "
                             f"not {entry_cls.kind}")
        return CONTROLS[name][entry_cls.kind](config, mix, inputs, seed, "cpu")
    return factory


def main(argv=None) -> int:
    from qqbench import procs
    from qqbench.run import run_cell
    from qqbench.spec import Spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True, choices=sorted(CONTROLS))
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    spec = Spec.load()
    cell = spec.workload(args.workload)
    procs.become_subreaper()
    all_failed = True
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            run_args = argparse.Namespace(workload=cell["name"], seed=seed,
                                          seconds=args.seconds, trace=0)
            result, compared = run_cell(run_args, spec, cell, require_card=False,
                                        entry_factory=control_factory(args.control))
            all_failed &= not result["correct"]
            print(json.dumps({"workload": cell["name"], "seed": seed, "control": args.control,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "compared": {k: {"value": v, "limit": lim}
                                           for k, (v, lim) in compared.items()}}), flush=True)
    finally:
        procs.stop_children()
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
