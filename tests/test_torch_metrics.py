"""The port's spans (``quisquis_tpu_torch.utils.metrics``), with no
transaction built: nesting and self time, one stack a thread, the bound on
the kept durations, ``reset()``, and a ``record_function`` range a span
only while a torch profiler runs."""

import os
import sys
import threading
import time

import pytest
import torch

from quisquis_tpu_torch.utils import metrics as qm


@pytest.fixture
def reg():
    return qm.Metrics()


def self_s(reg, name):
    return reg.counters[name + qm.SELF]


def test_nesting_and_self_time(reg):
    with reg.span("outer"):
        time.sleep(0.01)
        with reg.span("inner"):
            time.sleep(0.02)
            with reg.span("leaf"):
                time.sleep(0.01)
        with reg.span("inner"):
            pass
    (outer,), inner, (leaf,) = reg.timers["outer"], reg.timers["inner"], reg.timers["leaf"]
    assert len(inner) == 2 and outer >= sum(inner) >= leaf >= 0.01
    # self time: the duration less the spans directly inside
    assert self_s(reg, "outer") == pytest.approx(outer - sum(inner), abs=1e-9)
    assert self_s(reg, "inner") == pytest.approx(sum(inner) - leaf, abs=1e-9)
    assert self_s(reg, "leaf") == pytest.approx(leaf, abs=1e-9)
    # the self times under one outer span add up to its duration
    total = sum(v for k, v in reg.counters.items() if k.endswith(qm.SELF))
    assert total == pytest.approx(outer, abs=1e-9)
    assert self_s(reg, "outer") >= 0.009 and self_s(reg, "inner") >= 0.019


def test_decorator_and_exceptions(reg):
    @reg.span("f")
    def f(x):
        """doc"""
        if x:
            raise ValueError("x")
        return 7

    assert f(0) == 7 and f.__name__ == "f" and f.__doc__ == "doc"
    with pytest.raises(ValueError):
        with reg.span("outer"):
            f(1)
    assert len(reg.timers["f"]) == 2 and len(reg.timers["outer"]) == 1
    assert reg._stack() == []   # a raising span still closes
    assert self_s(reg, "outer") == pytest.approx(reg.timers["outer"][0] - reg.timers["f"][1],
                                                 abs=1e-9)


def test_each_thread_has_its_own_stack(reg):
    """A span open on one thread is not the parent of another thread's."""
    opened, release = threading.Event(), threading.Event()

    def other():
        with reg.span("other"):
            opened.set()
            release.wait(5)
            time.sleep(0.01)

    t = threading.Thread(target=other)
    with reg.span("main"):
        t.start()
        opened.wait(5)
        with reg.span("child"):
            release.set()
            t.join()
    assert self_s(reg, "other") == pytest.approx(reg.timers["other"][0], abs=1e-9)
    assert self_s(reg, "main") == pytest.approx(
        reg.timers["main"][0] - reg.timers["child"][0], abs=1e-9)


def test_no_update_is_lost_across_threads(reg):
    """More threads than cores, switching every microsecond, each closing
    spans and counting: every update lands."""
    n_threads, n = 4 * (os.cpu_count() or 1), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with reg.span("t"):
                    reg.count("c")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert reg.counters["c"] == n_threads * n
    assert len(reg.timers["t"]) == n_threads * n
    assert self_s(reg, "t") == pytest.approx(sum(reg.timers["t"]), rel=1e-9)


def test_kept_durations_are_bounded(reg):
    n = 100_000
    for _ in range(n):
        with reg.span("hot"):
            pass
    kept = reg.timers["hot"]
    assert len(kept) == qm.MAX_OBSERVATIONS < n
    # the self-time sum stays exact over every span, kept or not
    assert self_s(reg, "hot") >= sum(kept) > 0


def test_reset(reg):
    with reg.span("a"):
        reg.count("c", 3)
    reg.reset()
    assert not reg.timers and not reg.counters
    with reg.span("a"):
        pass
    assert len(reg.timers["a"]) == 1 and set(reg.counters) == {"a" + qm.SELF}
    assert '"a"' in reg.report()


def test_a_profiler_range_a_span_only_while_profiling(reg, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    for _ in range(10):
        with reg.span("quiet"):
            pass
    assert opened == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with reg.span("outer.step"):
            with reg.span("inner.step"):
                torch.ones(4).add_(1)
    assert opened == ["outer.step", "inner.step"]
    names = [e.name for e in prof.events()]
    assert names.count("outer.step") == 1 and names.count("inner.step") == 1
    with reg.span("quiet"):
        pass
    assert len(opened) == 2
