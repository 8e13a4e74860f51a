"""The reduction of profiler events to busy time, launches, kernel time and
idle gaps, on made-up events of the kind torch.profiler gives."""

import pytest

from qqbench import trace
from qqbench.probes import COUNT_RANGE


class Ev:
    """A profiler event as the installed torch without ``activity_type``
    gives it (device type, user-annotation flag, times in ns)."""

    def __init__(self, name, dev, start, dur, corr=0, ann=False, thread=1):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._c, self._a, self._t = corr, ann, thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


class FakeProfile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


MSM = "(anonymous namespace)::msm_acc_kernel(int const*, int*)"
EVENTS = [
    Ev("qqbench.call", False, 0, 1000, ann=True),
    Ev("qqbench.call", True, 0, 1000, ann=True),            # its device-side twin
    Ev("aten::add", False, 100, 50, corr=1),
    Ev("cudaLaunchKernel", False, 110, 10, corr=2),
    Ev("void at::native::add_kernel", True, 200, 100, corr=2),
    Ev("cudaLaunchKernel", False, 400, 10, corr=3),
    Ev(MSM, True, 420, 80, corr=3),
    Ev(COUNT_RANGE, False, 510, 40, ann=True),
    Ev("cudaLaunchKernel", False, 520, 5, corr=4),
    Ev("void at::native::reduce_kernel", True, 530, 300, corr=4),   # the benchmark's own
    Ev("cudaMemcpyAsync", False, 600, 10, corr=5),
    Ev("Memcpy DtoH (Device -> Pageable)", True, 800, 50, corr=5),
    Ev("cudaStreamSynchronize", False, 610, 250, corr=6),
]


@pytest.fixture
def summary():
    p = trace.Profiled(None)
    p.prof, p.t0_ns, p.t1_ns = FakeProfile(EVENTS), 0, 1000
    return p.summary("qqbench.call", custom_launches=[1])


def test_activity_without_activity_type():
    kinds = [trace.activity(e) for e in EVENTS]
    assert kinds[:7] == ["user_annotation", "gpu_user_annotation", "cpu_op", "cuda_runtime",
                         "kernel", "cuda_runtime", "kernel"]
    assert kinds[11] == "gpu_memcpy"


def test_busy_launches_and_kernel_time(summary):
    # device work: [200, 300), [420, 500), [800, 850); the benchmark's own
    # reduce kernel and the annotation's device twin are left out
    assert summary.window_s == pytest.approx(1e-6)
    assert summary.busy_s == pytest.approx(230e-9)
    assert summary.launches == 2 and summary.launches_from_counter == 0
    assert summary.custom_seen == 1 and summary.call_launches == [2]
    assert set(summary.kernel_s) == {"void at::native::add_kernel", MSM}


def test_missing_custom_launches_come_from_the_counter():
    p = trace.Profiled(None)
    p.prof, p.t0_ns, p.t1_ns = FakeProfile(EVENTS), 0, 1000
    s = p.summary("qqbench.call", custom_launches=[3])
    assert s.launches == 4 and s.launches_from_counter == 2
    assert s.call_launches == [4]


def test_idle_gaps_are_named_by_the_host_range(summary):
    gaps = summary.idle_by_host
    assert sum(gaps.values()) == pytest.approx(1e-6 - 230e-9)
    assert gaps["qqbench.call > aten::add"] == pytest.approx(200e-9)
    assert gaps["qqbench.call"] == pytest.approx(570e-9)   # [300, 420), [500, 800), [850, 1000)
    assert [k for k, _ in summary.breakdown()["device_ops"]] == ["void at::native::add_kernel", MSM]


def test_every_kernel_of_the_port_is_a_custom_kernel():
    """Each ``__global__`` function of the port's CUDA sources is named in
    CUSTOM_KERNELS, so that its runtime launch is seen and not added again
    from the port's counter."""
    import re

    from qqbench.paths import ROOT

    names = set()
    for src in (ROOT / "quisquis_tpu_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                src.read_text()))
    assert "ristretto_decode_kernel" in names and "ristretto_encode_kernel" in names
    assert names <= set(trace.CUSTOM_KERNELS)


def two_calls():
    """Two calls of the loop: the first launches 3 kernels (one of them a
    custom kernel whose runtime event is missing, so counted by the port's
    counter), the second, a rejected call, 1; a launch between them
    belongs to neither."""
    return [
        Ev("qqbench.call", False, 0, 400, ann=True),
        Ev("cudaLaunchKernel", False, 10, 5, corr=1),
        Ev("void at::native::add_kernel", True, 20, 10, corr=1),
        Ev("cudaLaunchKernel", False, 50, 5, corr=2),
        Ev(MSM, True, 60, 10, corr=2),
        Ev("cudaLaunchKernel", False, 450, 5, corr=3),
        Ev("void at::native::add_kernel", True, 460, 10, corr=3),
        Ev("qqbench.call", False, 500, 400, ann=True),
        Ev("cudaLaunchKernel", False, 510, 5, corr=4),
        Ev("void at::native::add_kernel", True, 520, 10, corr=4),
    ]


def test_each_call_gets_its_own_launches():
    p = trace.Profiled(None)
    p.prof, p.t0_ns, p.t1_ns = FakeProfile(two_calls()), 0, 1000
    s = p.summary("qqbench.call", custom_launches=[2, 0])
    assert s.call_launches == [3, 1]
    assert s.launches == 5 and s.launches_from_counter == 1
    assert s.custom_seen == 1 and s.custom_counted == 2


def test_launches_per_item_count_the_accepted_calls_only():
    """A rejected call may stop at its first failed check: its launches and
    its transactions are left out, whichever call the traced segment
    holds."""
    from qqbench.readers import launches_per_tx
    from qqbench.run import Run
    from qqbench.stats import Call, Window

    p = trace.Profiled(None)
    p.prof, p.t0_ns, p.t1_ns = FakeProfile(two_calls()), 0, 1000
    s = p.summary("qqbench.call", custom_launches=[2, 0])
    calls = [Call(0.0, 1.0, 0, 4, verdict=True), Call(1.0, 2.0, 1, 4, verdict=False)]
    run = Run(kind="verify", window=Window(), setup_s=1.0, trace=s, traced=Window(calls))
    assert launches_per_tx(run, "verify") == pytest.approx(3 / 4)
    assert launches_per_tx(run, "build") is None
    calls[0].verdict = False
    assert launches_per_tx(run, "verify") is None
    run.traced = Window(calls[:1])   # the calls and the ranges do not pair
    assert launches_per_tx(run, "verify") is None


def test_busy_of_a_device_only_segment():
    # every kernel, copy and memset: [200, 300), [420, 500), [530, 850); the
    # annotation's device twin is no device work
    p = trace.Profiled(None, device_only=True)
    p.prof, p.t0_ns, p.t1_ns = FakeProfile(EVENTS), 0, 1000
    assert p.busy_s() == pytest.approx(500e-9)
    p.t0_ns, p.t1_ns = 250, 700        # only what lies inside the segment
    assert p.busy_s() == pytest.approx(50e-9 + 80e-9 + 170e-9)
