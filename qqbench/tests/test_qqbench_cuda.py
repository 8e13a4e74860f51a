"""Each cell on the card, briefly, through the one command (marked
``cuda``; skipped without a card). On the GPU machine, from the root:

    python -m pytest -m cuda qqbench/tests -q
"""

import json
import subprocess
import sys

import pytest

from qqbench.paths import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["n9-block32-batched", "n9-4x4-build16-batched"])
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
    else:
        assert "setup_s" in result["metrics"]
