"""The profiled segment of a ``--trace 1`` run, read from torch.profiler's
events in memory (no chrome trace is written). (A ``--trace 0`` run of a
cell with an end-to-end metric from the device's trace profiles whole
calls too, each alone and with the device's activity only, for the busy
time of each: ``Profiled(torch, device_only=True).busy_s()``.)

After the measured window closes, the run profiles whole calls of the same
loop (at least one, and until ``TRACE_MIN_S`` have passed) with the CPU and
CUDA activities on. From the events it takes:

- ``window_s``: the segment's length, from a device sync before its first
  call to one after its last (host clock, epoch nanoseconds, the clock the
  profiler's events carry);
- ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device, inside that segment;
- ``launches``: the host's kernel and graph launch calls (CUDA runtime and
  driver events), those of the benchmark's own counting range
  (``probes.COUNT_RANGE``) left out; the port's custom kernels, launched
  from a library of its own, are checked against their runtime events and
  added from ``cuda_build.LAUNCHES`` where their events are missing;
- ``call_launches``: the same count for each call of the loop (each
  launch given to the call range it was issued in, the missing custom
  launches from that call's own reading of the counter), so that a reader
  can count the calls it chooses: a call whose answer was a rejection may
  stop early and launch a fraction of an accepted call's kernels;
- the device time of each kernel name, and the idle gaps by what the host
  was doing: the innermost profiler range or torch operator on the loop's
  thread at the middle of each gap.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

from .probes import COUNT_RANGE

TRACE_MIN_S = 2.0
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch", "cuGraphLaunch"})
DEVICE_ACTIVITIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
RUNTIME_ACTIVITIES = frozenset({"cuda_runtime", "cuda_driver"})
HOST_ACTIVITIES = frozenset({"cpu_op", "user_annotation"})
#: the port's custom kernels (``csrc/*.cu``), by the name of their function
#: (the profiler shows them inside their C++ namespace)
CUSTOM_KERNELS = ("scalar_mul_kernel", "base_mul_kernel", "msm_table_kernel",
                  "msm_acc_kernel", "msm_tail_kernel", "keccak_f1600_kernel",
                  "ristretto_decode_kernel", "ristretto_encode_kernel")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    launches_from_counter: int
    kernel_s: dict = field(default_factory=dict)      # kernel name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # host label -> seconds
    custom_seen: int = 0
    custom_counted: int = 0
    call_launches: list = field(default_factory=list)  # launches of each call, in order

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


class Profiled:
    """A profiled segment: ``with Profiled(torch) as p: ...`` then
    :meth:`summary`, or with `device_only` (no host activity recorded, so
    less overhead and fewer events) :meth:`busy_s`."""

    def __init__(self, torch, device_only: bool = False):
        self.torch, self.device_only = torch, device_only
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def __enter__(self):
        P = self.torch.profiler
        self.torch.cuda.synchronize()
        acts = [P.ProfilerActivity.CUDA] if self.device_only else [P.ProfilerActivity.CPU,
                                                                   P.ProfilerActivity.CUDA]
        self.prof = P.profile(activities=acts)
        self.prof.__enter__()
        self.torch.cuda.synchronize()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def busy_s(self, kinds=DEVICE_ACTIVITIES) -> float:
        """Seconds of the segment in which a kernel, copy or memset (of
        `kinds`) ran on the device."""
        t0, t1 = self.t0_ns, self.t1_ns
        intervals = []
        for e in self.prof.profiler.kineto_results.events():
            if activity(e) in kinds:
                a, b = max(e.start_ns(), t0), min(e.start_ns() + e.duration_ns(), t1)
                if b > a:
                    intervals.append((a, b))
        return _union(intervals, t0, t1)[0] * 1e-9

    def summary(self, thread_label: str, custom_launches: list) -> TraceSummary:
        """Reduce the events. `thread_label`: the range the loop's thread
        opens around each call (names the thread whose host work labels
        the gaps, and the calls); `custom_launches`: the port's counter of
        custom-kernel launches over each call."""
        events = self.prof.profiler.kineto_results.events()
        t0, t1 = self.t0_ns, self.t1_ns
        device, runtime, host = [], [], []
        for e in events:
            kind = activity(e)
            if kind in DEVICE_ACTIVITIES:
                device.append(e)
            elif kind in RUNTIME_ACTIVITIES:
                runtime.append(e)
            elif kind in HOST_ACTIVITIES:
                host.append(e)
        loop_threads = {e.start_thread_id() for e in host if e.name() == thread_label}
        host = [e for e in host if e.start_thread_id() in loop_threads]

        # the benchmark's own counting kernels: launched inside COUNT_RANGE
        own = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
               if e.name() == COUNT_RANGE]
        own.sort()
        starts = [a for a, _ in own]
        own_corr = set()
        for r in runtime:
            k = bisect.bisect_right(starts, r.start_ns()) - 1
            if k >= 0 and r.start_ns() < own[k][1]:
                own_corr.add(r.correlation_id())
        launch_corr = {r.correlation_id() for r in runtime
                       if r.name() in LAUNCH_CALLS and r.correlation_id() not in own_corr}
        calls = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
                       if e.name() == thread_label)
        call_starts = [a for a, _ in calls]
        call_of = {}    # launch correlation id -> the call it was issued in
        for r in runtime:
            if r.correlation_id() in launch_corr:
                k = bisect.bisect_right(call_starts, r.start_ns()) - 1
                if k >= 0 and r.start_ns() < calls[k][1]:
                    call_of[r.correlation_id()] = k

        kernel_s = defaultdict(float)
        intervals = []
        seen = [0] * len(calls)
        custom_seen = 0
        for e in device:
            if e.correlation_id() in own_corr:
                continue
            a, b = max(e.start_ns(), t0), min(e.start_ns() + e.duration_ns(), t1)
            if b > a:
                intervals.append((a, b))
            if activity(e) == "kernel":
                kernel_s[e.name()] += e.duration_ns() * 1e-9
                if any(k in e.name() for k in CUSTOM_KERNELS) and e.correlation_id() in launch_corr:
                    custom_seen += 1
                    if e.correlation_id() in call_of:
                        seen[call_of[e.correlation_id()]] += 1
        busy_ns, gaps = _union(intervals, t0, t1)
        per_call = [0] * len(calls)
        for k in call_of.values():
            per_call[k] += 1
        if len(custom_launches) == len(calls):
            missing = [max(0, n - s) for n, s in zip(custom_launches, seen)]
            per_call = [n + m for n, m in zip(per_call, missing)]
            missing = sum(missing)
        else:   # the calls' ranges and readings do not pair: no call has its own count
            missing, per_call = max(0, sum(custom_launches) - custom_seen), []
        return TraceSummary(
            window_s=(t1 - t0) * 1e-9, busy_s=busy_ns * 1e-9,
            launches=len(launch_corr) + missing, launches_from_counter=missing,
            kernel_s=dict(kernel_s), idle_by_host=_label_gaps(gaps, host),
            custom_seen=custom_seen, custom_counted=sum(custom_launches),
            call_launches=per_call)


def activity(e) -> str:
    """The kind of a profiler event: its ``activity_type`` where the
    installed torch gives one, else told by its device and name (device
    events: a copy, a memset or a kernel; host events: a CUDA runtime or
    driver call, or an operator or range)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at())
    name, on_device = e.name(), str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals, t0: int, t1: int):
    """(covered nanoseconds, idle gaps [(start, end)]) of intervals in
    [t0, t1]."""
    intervals.sort()
    busy, gaps, cur = 0, [], t0
    for a, b in intervals:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host range or operator that covers
    the middle of each gap (``host`` events of one thread nest)."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in host),
                   key=lambda s: (s[0], -s[1]))
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    out = defaultdict(float)
    stack, i = [], 0
    for t, length in mids:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        label = stack[-1][2] if stack else "outside any range (host between calls)"
        where = next((s[2] for s in reversed(stack) if s[2].startswith("qqbench.")), None)
        if where and where != label:
            label = f"{where} > {label}"
        out[label] += length * 1e-9
    return dict(out)
