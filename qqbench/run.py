"""Run one cell of BENCHMARK.json once and print its result line.

    python3 qqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, qqbench/ and the
port (quisquis_tpu_torch). The run:

1. checks for the cards the cell asks for (exits 2, printing no result,
   without them);
2. makes or reads back the cell's inputs from the seed (the entry's
   generator on ``gen.py``, the frozen reference; not counted in
   ``setup_s``);
3. sets up the port: imports, its kernels (nvcc builds them once per
   checkout into ``build/``), its C++ host curve and STROBE, the entry's
   service or pool, and the mix's warm calls (``warm_calls``, one by
   default) at the cell's own shape; that is ``setup_s``;
4. times a fixed piece of host work (``hostprobe.py``), runs the closed
   loop for ``--seconds``, closing the window at the end of the first call
   that completes after it, and times the host work again (on standard
   error, beside the garbage collector's seconds in the window);
5. with ``--trace 1``, the window runs with the benchmark's spans on, and
   then whole calls more run under torch.profiler (``trace.py``); with
   ``--trace 0`` in a cell that has an end-to-end metric from the
   device's trace, calls more run after the window, each alone under the
   profiler with the device's activity only, until ``DEVICE_CALLS`` were
   accepted (their device busy time);
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
    device: object = None           # stats.Window of the calls profiled one by one (--trace 0)
    device_busy: list = field(default_factory=list)  # the device's busy seconds of each
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


def loop(entry, items, seconds: float, spans=None, keep: bool = True, min_calls: int = 1,
         accepted: bool = False):
    """Calls of the closed loop until at least `min_calls` have run and the
    last completes at or after `seconds` from the first's start (with
    `accepted`, also until one call was accepted, or 4 x `seconds` have
    passed); stops at the first call that raised something other than a
    verdict."""
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
        if call.verdict is None or (
                len(window.calls) >= min_calls and window.closed(seconds)
                and (not accepted or any(c.verdict for c in window.calls)
                     or window.closed(4 * seconds))):
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


def run_cell(args, spec: Spec, cell: dict, require_card: bool = True, entry_factory=None,
             t0: float = None):
    """The run without the process handling: (result dict, compared
    {name: (value, limit)}). `entry_factory` replaces the port's entry
    (tests and the control); `require_card` False runs without a card."""
    from qqbench import entries, hostprobe, roofline

    t0 = time.perf_counter() if t0 is None else t0
    import torch

    config, mix = spec.config(cell), spec.traffic(cell)
    entry_cls = entries.load(mix["entry"])
    if entry_factory is None:
        import quisquis_tpu_torch  # noqa: F401  (fails here, before any input is made, outside a checkout)
    inputs, made_s = entry_cls.inputs(config, mix, args.seed)
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
            entry_cls.install_spans(spans)
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
        say(f"window {window.seconds:.2f} s, {len(window.calls)} calls, "
            f"{stats.rate(window) if window.calls else 0.0:.4f} accepted items a second; seconds a call: "
            + " ".join(f"{c.seconds:.3f}" for c in window.calls[:60]))
        by_verdict = {v: [c.seconds for c in window.calls if c.verdict is v] for v in (True, False)}
        if by_verdict[False]:
            say("mean seconds a call: " + ", ".join(
                f"{w} {sum(t) / len(t):.4f} ({len(t)} calls)" for w, t in
                (("accepted", by_verdict[True]), ("rejected", by_verdict[False])) if t))
        say(f"garbage collection in the window {gc_clock.seconds:.3f} s over "
            f"{'/'.join(map(str, gc_clock.collections))} collections (generations 0/1/2)")
        say(hostprobe.line("after", hostprobe.probe()))
        if spans is not None:
            names = sorted({n for c in spans.per_call for n in c})
            say("the benchmark's spans, ms a call of the window: "
                + ", ".join(f"{n} {spans.mean_ms(n):.3f}" for n in names))
        run = Run(kind=entry.kind, window=window, setup_s=setup_s, spans=spans,
                  peaks=roofline.peaks(card))
        if program is not None:
            run.program = {"timers": {k: list(v) for k, v in program.timers.items()},
                           "counters": dict(program.counters)}
        traced = devcalls = stats.Window()
        if args.trace and window.calls and window.calls[-1].verdict is not None:
            run.trace, traced, run.msm_rows = profile_calls(torch, entry, items, spans, recorder)
            run.traced = traced
        if (not args.trace and require_card and window.calls
                and window.calls[-1].verdict is not None
                and any(m["source"] == "device_trace" for m in spec.metrics_of(cell, False))):
            devcalls, run.device_busy, kernels = device_calls(torch, entry, items)
            run.device = devcalls
            say("calls profiled one by one (item, verdict, transactions, device busy ms, "
                "of it kernels ms): " + ", ".join(
                    f"({c.item}, {c.verdict}, {c.size}, {1e3 * b:.3f}, {1e3 * k:.3f})"
                    for c, b, k in zip(devcalls.calls, run.device_busy, kernels)))
        memory_peak = torch.cuda.max_memory_allocated(0) if require_card else 0
    finally:
        if spans is not None:
            spans.restore()
        if recorder is not None:
            recorder.restore()
        entry.close()
    if require_card:
        torch.cuda.empty_cache()

    calls = warm.calls + window.calls + traced.calls + devcalls.calls
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
            f"{run.trace.custom_seen} seen of {run.trace.custom_counted} counted); a call's "
            "launches (item, verdict): " + ", ".join(
                f"{n} ({c.item}, {c.verdict})" for n, c in zip(run.trace.call_launches[:24],
                                                                traced.calls)))
    return result, compared


#: the port's process-wide protocol settings (``config.DEFAULT``) that a
#: configuration's file may state; the anonymity set's size is not among them,
#: as the port takes it from each proof's accounts
PORT_SETTINGS = ("range_bits", "bp_gens_capacity", "bp_party_capacity")


def check_port_config(config: dict) -> None:
    """The port runs the configuration as its file states it: each of
    :data:`PORT_SETTINGS` that the file states."""
    from quisquis_tpu_torch.config import DEFAULT

    want = {k: config[k] for k in PORT_SETTINGS if k in config}
    have = {k: getattr(DEFAULT, k) for k in want}
    if have != want:
        raise RuntimeError(f"the port's protocol settings {have} are not the configuration's {want}")


def program_metrics():
    """The port's own counters and timers (utils.metrics), where loaded."""
    mod = sys.modules.get("quisquis_tpu_torch.utils.metrics")
    return None if mod is None else mod.metrics


def profile_calls(torch, entry, items, spans, recorder):
    """Whole calls under the profiler (until trace.TRACE_MIN_S have passed
    and one call was accepted): (summary, their window, MSM rows). The
    port's counter of custom-kernel launches is read around each call, so
    that the summary gives each call its own launches."""
    from quisquis_tpu_torch.ops import cuda_build

    from qqbench.trace import TRACE_MIN_S, Profiled

    custom, call = [], entry.call

    def counted(item, out):
        n0 = sum(cuda_build.LAUNCHES.values())
        try:
            call(item, out)
        finally:
            custom.append(sum(cuda_build.LAUNCHES.values()) - n0)

    spans.profiling, recorder.on, entry.call = True, True, counted
    try:
        with Profiled(torch) as prof:
            traced = loop(entry, items, TRACE_MIN_S, spans, keep=False, accepted=True)
    finally:
        spans.profiling, recorder.on = False, False
        del entry.call
    return prof.summary("qqbench.call", custom), traced, recorder.counts()


#: accepted calls that a --trace 0 run profiles after its window for the
#: device's busy time, and the most calls it tries for them
DEVICE_CALLS, DEVICE_TRIES = 8, 16


def device_calls(torch, entry, items):
    """Whole calls of the loop after the window, each alone under the
    profiler with the device's activity only, until DEVICE_CALLS were
    accepted (or DEVICE_TRIES were made, or one raised something other than
    a verdict): (their window, the device's busy seconds in each call, and
    of these the seconds in which a kernel ran)."""
    from qqbench.trace import Profiled

    window, busy, kernels = stats.Window(), [], []
    while len(window.calls) < DEVICE_TRIES and sum(
            1 for c in window.calls if c.verdict) < DEVICE_CALLS:
        with Profiled(torch, device_only=True) as prof:
            one = loop(entry, items, 0.0)
        window.calls += one.calls
        busy.append(prof.busy_s())
        kernels.append(prof.busy_s(kinds={"kernel"}))
        if one.calls[-1].verdict is None:
            break
    return window, busy, kernels


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
