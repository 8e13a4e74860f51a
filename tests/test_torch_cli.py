"""The port's demo CLI (``python -m quisquis_tpu_torch.cli``), each mode in a
fresh interpreter (mirrors the JAX package's CLI): it exits with 0 and
prints every OK line of the mode."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = {
    "demo": ([], ["verify_account(0)          : OK", "update_account(+16) verify : OK",
                  "pk update + verify         : OK", "commitment add (16+26=42)  : OK",
                  "decommit(42) == 42         : True"]),
    "tx": (["--tx"], ["transaction built+verified : OK", "standalone verification    : OK",
                      "sender delta balance (5)   : OK", "epsilon conservation check : OK"]),
    "batch": (["--batch", "2"], ["batch verification         : OK"]),
    "serve": (["--serve", "2"], ["proving service            : built 2 wire tx",
                                 "verification service       : OK, 2 tx"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_mode_prints_every_ok_line(mode):
    args, lines = MODES[mode]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "quisquis_tpu_torch.cli", *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for line in lines:
        assert line in out.stdout, (line, out.stdout)
