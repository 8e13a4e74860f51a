"""Each cell on the card, briefly, through the one command (marked
``cuda``; skipped without a card). On the GPU machine, from the root:

    python -m pytest -m cuda qqbench/tests -q
"""

import json
import re
import subprocess
import sys

import pytest

from qqbench.paths import ROOT
from qqbench.spec import Spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["n9-block32-batched", "n9-4x4-build16-batched",
                                  "n64-shuffle64-batched"])
def test_a_short_run_is_correct(card, name, trace):
    out = subprocess.run([sys.executable, "qqbench/run.py", "--workload", name,
                          "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-3000:]
    assert result["device"]["kind"] == card and result["device"]["count"] == 1
    assert list(result)[-1] == "compared"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert "breakdown" in result
        # every custom kernel's runtime launch is seen: none is added from the counter
        seen, counted = re.search(r"custom kernels (\d+) seen of (\d+) counted",
                                  out.stderr).groups()
        assert seen == counted, out.stderr[-3000:]
        if name.startswith("n64-shuffle"):
            # the six steps split the benchmark's span around the call, within 1%
            call = float(re.search(r"spans, ms a call of the window: .*\bcall ([0-9.]+)",
                                   out.stderr).group(1))
            steps = sum(v["value"] for k, v in result["metrics"].items()
                        if k.endswith("_ms.shuffle"))
            assert abs(steps - call) <= 0.01 * call, (steps, call)
    else:
        # every end-to-end metric of the cell, those from the device's trace included
        spec = Spec.load()
        want = {m["name"] for m in spec.metrics_of(spec.workload(name), False)}
        assert set(result["metrics"]) == want, out.stderr[-3000:]
