"""Shuffle argument suite (mirrors reference src/shuffle/mod.rs:27-56)."""

from .shuffle import (Shuffle, Permutation, ShuffleProof, ShuffleStatement,  # noqa: F401
                      create_b_b_dash, N, ROWS, COLUMNS)
from .hadamard import HadamardProof, HadamardStatement  # noqa: F401
from .product import (ProductProof, ProductStatement, MultiHadamardProof,  # noqa: F401
                      MultiHadamardStatement, ZeroProof, ZeroStatement,
                      bilinearmap, single_bilinearmap)
from .singlevalueproduct import SVPProof, SVPStatement  # noqa: F401
from .multiexponential import MultiexpoProof  # noqa: F401
from .ddh import DDHProof, DDHStatement  # noqa: F401
from . import vectorutil, polynomial  # noqa: F401
from .device_prove import DeviceShuffleProver, get_device_shuffle_prover  # noqa: F401
