"""Run one cell of BENCHMARK.json once and print its result line.

    python3 qqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, qqbench/ and the
port (quisquis_tpu_torch). The run:

1. checks for the cards the cell asks for (exits 2, printing no result,
   without them);
2. makes or reads back the cell's inputs from the seed (``gen.py``, the
   frozen reference; not counted in ``setup_s``);
3. sets up the port: imports, its kernels (nvcc builds them once per
   checkout into ``build/``), its C++ host curve and STROBE, the entry's
   service or pool, and the mix's warm calls (``warm_calls``, one by
   default) at the cell's own shape; that is ``setup_s``;
4. times a fixed piece of host work (``hostprobe.py``), runs the closed
   loop for ``--seconds``, closing the window at the end of the first call
   that completes after it, and times the host work again (on standard
   error, beside the garbage collector's seconds in the window);
5. with ``--trace 1``, the window runs with the benchmark's spans on, and
   then whole calls more run under torch.profiler (``trace.py``);
6. reads the device's memory peak, closes the port's service, judges every
   answer against the reference, stops every process it started, and
   prints the compared numbers beside their limits (the last lines of
   standard error) and one JSON line (the last line of standard output).

It exits nonzero and prints no result where a card is missing, where the
port cannot be imported, or where jax, jaxlib, flax or quisquis_tpu is
loaded once the window has closed. A call that raises something other
than a verdict ends the window and counts under ``failed`` and the
compared ``errors``, so the run is not correct.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):   # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qqbench import stats  # noqa: E402
from qqbench.spec import Spec, reader  # noqa: E402

#: top-level modules that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "quisquis_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``quisquis_tpu_torch`` is not ``quisquis_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    kind: str
    window: stats.Window
    setup_s: float
    spans: object = None            # probes.Spans (trace runs)
    program: dict = field(default_factory=dict)   # utils.metrics over the window
    trace: object = None            # trace.TraceSummary (trace runs)
    traced: object = None           # stats.Window of the profiled calls
    msm_rows: list = field(default_factory=list)  # per profiled MSM call: terms a row
    peaks: object = None            # roofline.peaks of the card


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(f"qqbench: {msg}", file=sys.stderr, flush=True)


def loop(entry, items, seconds: float, spans=None, keep: bool = True, min_calls: int = 1):
    """Calls of the closed loop until at least `min_calls` have run and the
    last completes at or after `seconds` from the first's start; stops at
    the first call that raised something other than a verdict."""
    window = stats.Window()
    while True:
        item = next(items)
        call = stats.Call(start=time.perf_counter(), end=0.0, item=item, size=0)
        try:
            if spans is not None:
                with spans.span("call"):
                    entry.call(item, call)
            else:
                entry.call(item, call)
        except Exception as e:  # noqa: BLE001 - recorded, ends the window, fails the run
            call.verdict, call.error = None, f"{type(e).__name__}: {e}"[:400]
        call.end = time.perf_counter()
        if spans is not None:
            spans.end_call(keep and call.verdict is not None)
        entry.settle(call)
        window.calls.append(call)
        if call.verdict is None or (len(window.calls) >= min_calls and window.closed(seconds)):
            return window


class GcClock:
    """Seconds the interpreter's garbage collector ran while installed, and
    its collections by generation (a cost that grows with what a run keeps
    alive would show here)."""

    def __init__(self):
        self.seconds, self.collections, self._t = 0.0, [0, 0, 0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1
            self._t = None


def install_spans(spans, kind: str) -> None:
    """The benchmark's spans around the port's device layers, and labels
    of its host steps for the profiled segment's idle gaps."""
    from quisquis_tpu_torch.transaction import transaction as tx
    from quisquis_tpu_torch.utils import serde

    if kind == "verify":
        from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks, DeviceBatchCollector

        spans.wrap(DeviceBatchCollector, "verify", "device_verify")
        spans.wrap(DeferredPointChecks, "verify", "device_msm",
                   when=lambda self, backend="auto", **k: backend == "device")
        spans.label(serde, "transaction_from_bytes", "wire_decode")
        spans.label(serde, "transaction_proof_from_bytes", "wire_decode")
        spans.label(tx, "verify_transaction_auto", "host_replay")
    else:
        from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof

        spans.wrap(RangeProof, "prove_batch", "prove_batch")
        spans.label(tx, "_tx_pre_range", "host_pre_range")
        spans.label(tx, "_tx_post_range", "host_post_range")


def run_cell(args, spec: Spec, cell: dict, require_card: bool = True, entry_factory=None,
             t0: float = None):
    """The run without the process handling: (result dict, compared
    {name: (value, limit)}). `entry_factory` replaces the port's entry
    (tests and the control); `require_card` False runs without a card."""
    from qqbench import gen, hostprobe, roofline
    from qqbench.entries import ENTRIES

    t0 = time.perf_counter() if t0 is None else t0
    import torch

    config, mix = spec.config(cell), spec.traffic(cell)
    entry_cls = ENTRIES[mix["entry"]]
    if entry_factory is None:
        import quisquis_tpu_torch  # noqa: F401  (fails here, before any input is made, outside a checkout)
    if mix["entry"] == "verify_wire":
        inputs, made_s = gen.verify_inputs(config, mix, args.seed)
    else:
        inputs, made_s = gen.build_inputs(config, mix, args.seed)
    say(f"inputs of {cell['name']} seed {args.seed}: "
        + (f"made in {made_s:.1f} s" if made_s else "read from the cache"))

    if entry_factory is None:
        check_port_config(config)
        from quisquis_tpu_torch.ops import cuda_build

        cuda_build.load_library()
        entry = entry_cls(config, mix, inputs, args.seed, "cuda")
    else:
        entry = entry_factory(entry_cls, config, mix, inputs, args.seed)
    card = torch.cuda.get_device_name(0) if require_card else "cpu"
    items = entry.items()
    spans = recorder = None
    try:
        if args.trace:
            from quisquis_tpu_torch.ops import msm as qmsm

            from qqbench.probes import MsmRecorder, Spans

            spans = Spans(torch)
            install_spans(spans, entry.kind)
            recorder = MsmRecorder(torch, qmsm)
        warm = loop(entry, items, 0.0, spans, keep=False, min_calls=int(mix.get("warm_calls", 1)))
        if require_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0 - made_s
        say(f"set-up {setup_s:.2f} s (warm calls "
            + " ".join(f"{c.seconds:.2f}" for c in warm.calls) + " s)")

        say(hostprobe.line("before", hostprobe.probe()))
        program = program_metrics()
        if program is not None:
            program.reset()
        window, gc_clock = stats.Window(), GcClock()
        if warm.calls[-1].verdict is not None:
            gc.callbacks.append(gc_clock)
            try:
                window = loop(entry, items, args.seconds, spans)
            finally:
                gc.callbacks.remove(gc_clock)
        say(f"window {window.seconds:.2f} s, {len(window.calls)} calls; seconds a call: "
            + " ".join(f"{c.seconds:.3f}" for c in window.calls[:60]))
        say(f"garbage collection in the window {gc_clock.seconds:.3f} s over "
            f"{'/'.join(map(str, gc_clock.collections))} collections (generations 0/1/2)")
        say(hostprobe.line("after", hostprobe.probe()))
        run = Run(kind=entry.kind, window=window, setup_s=setup_s, spans=spans,
                  peaks=roofline.peaks(card))
        if program is not None:
            run.program = {"timers": {k: list(v) for k, v in program.timers.items()},
                           "counters": dict(program.counters)}
        traced = stats.Window()
        if args.trace and window.calls and window.calls[-1].verdict is not None:
            run.trace, traced, run.msm_rows = profile_calls(torch, entry, items, spans, recorder)
            run.traced = traced
        memory_peak = torch.cuda.max_memory_allocated(0) if require_card else 0
    finally:
        if spans is not None:
            spans.restore()
        if recorder is not None:
            recorder.restore()
        entry.close()
    if require_card:
        torch.cuda.empty_cache()

    calls = warm.calls + window.calls + traced.calls
    failed = [c for c in calls if c.verdict is None]
    compared = entry.judge([c for c in calls if c.verdict is not None], config, mix, args.seed)
    compared["errors"] = (len(failed), 0)
    for c in failed:
        say(f"call on item {c.item} failed: {c.error}")

    metrics = {}
    for m in spec.metrics_of(cell, bool(args.trace)):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card, "count": cell["chips"],
              "memory_peak_bytes": memory_peak}
    result = {"correct": all(v <= lim for v, lim in compared.values()),
              "attempted": len(window.calls), "failed": sum(1 for c in window.calls
                                                            if c.verdict is None),
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"], device["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        say(f"traced {len(traced.calls)} calls: launches {run.trace.launches} "
            f"({run.trace.launches_from_counter} from the port's counter; custom kernels "
            f"{run.trace.custom_seen} seen of {run.trace.custom_counted} counted)")
    return result, compared


def check_port_config(config: dict) -> None:
    """The port runs the configuration as its file states it."""
    from quisquis_tpu_torch.config import DEFAULT

    want = {"range_bits": config["range_bits"], "bp_gens_capacity": config["bp_gens_capacity"],
            "bp_party_capacity": config["bp_party_capacity"]}
    have = {k: getattr(DEFAULT, k) for k in want}
    if have != want:
        raise RuntimeError(f"the port's protocol settings {have} are not the configuration's {want}")


def program_metrics():
    """The port's own counters and timers (utils.metrics), where loaded."""
    mod = sys.modules.get("quisquis_tpu_torch.utils.metrics")
    return None if mod is None else mod.metrics


def profile_calls(torch, entry, items, spans, recorder):
    """Whole calls under the profiler (at least one, and until
    trace.TRACE_MIN_S have passed): (summary, their window, MSM rows)."""
    from quisquis_tpu_torch.ops import cuda_build

    from qqbench.trace import TRACE_MIN_S, Profiled

    spans.profiling, recorder.on = True, True
    cuda_build.reset_launches()
    try:
        with Profiled(torch) as prof:
            traced = loop(entry, items, TRACE_MIN_S, spans, keep=False)
    finally:
        spans.profiling, recorder.on = False, False
    custom = sum(cuda_build.LAUNCHES.values())
    return prof.summary("qqbench.call", custom), traced, recorder.counts()


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse(argv)
    spec = Spec.load()
    cell = spec.workload(args.workload)
    import torch

    # one torch thread in this process: the host's cores go to the port's
    # host work and its workers, not to idle intra-op threads
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    from qqbench import procs

    procs.become_subreaper()
    try:
        result, compared = run_cell(args, spec, cell, t0=t0)
    finally:
        procs.stop_children()
    bad = forbidden_modules()
    if bad:
        say(f"modules that no process of the benchmark may load are loaded: {bad}")
        return 3
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value} limit {limit}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
