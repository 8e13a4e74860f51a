"""Spans and records that the benchmark takes from its own side, around
calls into the port's layers (the port marks no ranges of its own).

Only a ``--trace 1`` run installs them. Each span ends in a device sync,
so it holds the device work that the call issued; inside a profiled
segment each span is also a ``record_function`` range, which names the
host's work in the device's idle gaps. :class:`MsmRecorder` notes, for every
MSM the port runs while it is on, how many terms with a nonzero scalar each
row holds; it counts them on a stream of its own, inside a range named
:data:`COUNT_RANGE`, so that the trace can tell its launches and kernels
from the program's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

#: the profiler range around the recorder's own counting kernels
COUNT_RANGE = "qqbench.msm_count"


class Spans:
    """Host-clock spans by name, summed per call of the loop."""

    def __init__(self, torch):
        self.torch = torch
        self.current = defaultdict(float)
        self.per_call = []          # one {name: seconds} a measured call
        self.profiling = False
        self._restore = []

    def _range(self, name: str):
        if self.profiling:
            return self.torch.profiler.record_function("qqbench." + name)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def span(self, name: str):
        sync = self.torch.cuda.synchronize
        with self._range(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                sync()
                self.current[name] += time.perf_counter() - t

    def wrap(self, owner, attr: str, name: str, when=None) -> None:
        """Time every call of ``owner.attr`` (a function, method or static
        method) under `name`; `when(*args, **kwargs)` picks the calls."""
        raw = owner.__dict__[attr]
        static = isinstance(raw, staticmethod)
        real = raw.__func__ if static else raw

        def timed(*a, **k):
            if when is not None and not when(*a, **k):
                return real(*a, **k)
            with self.span(name):
                return real(*a, **k)
        setattr(owner, attr, staticmethod(timed) if static else timed)
        self._restore.append(lambda: setattr(owner, attr, raw))

    def label(self, owner, attr: str, name: str) -> None:
        """Name the host's work in ``owner.attr`` in a profiled segment (a
        ``record_function`` range, no timing and no sync)."""
        real = getattr(owner, attr)

        def labelled(*a, **k):
            with self._range(name):
                return real(*a, **k)
        setattr(owner, attr, labelled)
        self._restore.append(lambda: setattr(owner, attr, real))

    def end_call(self, keep: bool) -> None:
        """Close one call of the loop: keep its sums (a measured call) or
        drop them (a warm-up or profiled call)."""
        if keep:
            self.per_call.append(dict(self.current))
        self.current.clear()

    def mean_ms(self, name: str):
        """The mean per measured call, in ms, or None where no call has
        the span."""
        if not self.per_call or not any(name in c for c in self.per_call):
            return None
        return 1e3 * sum(c.get(name, 0.0) for c in self.per_call) / len(self.per_call)

    def restore(self) -> None:
        while self._restore:
            self._restore.pop()()


class MsmRecorder:
    """Per-row nonzero-term counts of every MSM the port runs while on.

    Wraps ``ops.msm.msm``, ``msm_rows`` and ``msm_shared_rows`` (every
    caller in the port reaches its MSM through that module's attributes).
    A row's count is the number of its terms whose scalar digits are not
    all zero: what the data needs, without the padding that callers or the
    MSM add. The counts stay on the device until :meth:`counts`."""

    def __init__(self, torch, qmsm):
        self.torch, self.qmsm = torch, qmsm
        self.on = False
        self.stream = None
        self._pending = []
        self._restore = []
        for attr in ("msm", "msm_rows", "msm_shared_rows"):
            self._wrap(attr)

    def _wrap(self, attr: str) -> None:
        real = getattr(self.qmsm, attr)
        rows_axis = attr != "msm"    # msm: nibbles [n, 64]; rows: [R, k, 64]

        def recorded(nibbles, *a, **k):
            out = real(nibbles, *a, **k)
            if self.on and nibbles.is_cuda:
                self._count(nibbles if rows_axis else nibbles[None])
            return out
        setattr(self.qmsm, attr, recorded)
        self._restore.append(lambda: setattr(self.qmsm, attr, real))

    def _count(self, nibbles) -> None:
        torch = self.torch
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=nibbles.device)
        with torch.profiler.record_function(COUNT_RANGE):
            self.stream.wait_stream(torch.cuda.current_stream(nibbles.device))
            with torch.cuda.stream(self.stream):
                nz = (nibbles != 0).any(-1).sum(-1)
            nibbles.record_stream(self.stream)
        self._pending.append(nz)

    def counts(self) -> list:
        """One list of per-row term counts a recorded MSM call."""
        self.torch.cuda.synchronize()
        return [t.tolist() for t in self._pending]

    def restore(self) -> None:
        while self._restore:
            self._restore.pop()()
