"""A fixed piece of host work, timed just before and just after the window,
to tell a change in the host's speed from a change in the program.

The program's host steps run in the interpreter and in the C++ curve,
which splits each batch of point work over one thread a core. So the probe
times the same three kinds of work with the reference's copy of that
library: interpreter arithmetic, one MSM row on one thread, and one row a
core at once (the way the program's batches run). Where the all-core time
grows and the one-core time does not, something else holds the host's
cores. The readings go to standard error only; they are no metric.
"""

from __future__ import annotations

import os
import random
import statistics
import time

#: terms of one probe row, and repetitions of each timing
ROW_TERMS = 256
REPS = 5


def _median_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def probe() -> dict:
    """{"python_ms", "one_core_ms", "all_cores_ms", "cores"}: medians of
    REPS timings of fixed work (the same on every run and seed)."""
    from .ref.ops import exact as ex

    rng = random.Random(20240601)
    base = [ex.pt_base_mul(rng.randrange(1, ex.L)) for _ in range(16)]
    row = ([rng.randrange(ex.L) for _ in range(ROW_TERMS)],
           [base[i % len(base)] for i in range(ROW_TERMS)])
    cores = os.cpu_count() or 1
    nums = [rng.getrandbits(255) | 1 for _ in range(64)]

    def python_work():
        acc = 1
        for _ in range(200):
            for n in nums:
                acc = acc * n % ex.L

    return {"python_ms": _median_ms(python_work),
            "one_core_ms": _median_ms(lambda: ex.pt_msm_many([row])),
            "all_cores_ms": _median_ms(lambda: ex.pt_msm_many([row] * cores)),
            "cores": cores}


def line(when: str, p: dict) -> str:
    return (f"host probe {when} the window: interpreter {p['python_ms']:.2f} ms, one core "
            f"{p['one_core_ms']:.2f} ms, {p['cores']} cores at once {p['all_cores_ms']:.2f} ms")
