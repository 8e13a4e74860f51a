"""``quisquis_tpu_torch/auto_rules.py``'s deferred-check readings on the
CPU, at small shapes (the readings themselves need a GPU to mean
anything): each reading verifies the accumulator it times on both
backends, so an accumulator that fails raises here; and the accumulator
of one transaction of config 6/6b holds as many terms as
``DeferredPointChecks.verify``'s "auto" sends to the device. Exact: the
verdicts and the term counts are ints and booleans."""

import pytest
import torch

from quisquis_tpu_torch import auto_rules
from quisquis_tpu_torch.accounts import deferred


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def test_read_defer_times_both_backends_on_cpu():
    line = auto_rules.read_defer("cpu", [], (), few_terms=(8,), tx_shapes=(), device="cpu")
    assert line.startswith("DeferredPointChecks.verify: 8 terms (multiples of B): host ")
    assert ", device " in line and line.endswith(" [cpu]")


def test_transaction_accumulator_takes_the_device_under_auto():
    checks = auto_rules._tx_checks(1, 9)   # config 6/6b: 1 + 1 over 9 accounts
    assert checks.num_terms >= deferred.AUTO_DEVICE_MIN_TERMS
    checks.verify(backend="host")
    few = auto_rules._few_term_check(8)
    assert few.num_terms == 8 < deferred.AUTO_DEVICE_MIN_TERMS
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        checks.verify()   # "auto" resolves the default device first
