"""The plain reference: a frozen copy of the port's host code.

Copied from ``quisquis_tpu_torch`` (config, ops/exact with its C++ curve
and STROBE, primitives, accounts, bulletproofs, shuffle, transaction,
utils/serde) with every device path, the R1CS range proofs, Schnorr
signatures and the metrics hooks taken out. Relative imports keep the
port's layout. It imports neither jax, quisquis_tpu nor quisquis_tpu_torch,
and builds its C++ libraries into the benchmark's cache
(``.qqbench_cache/build/``), never loading one that the program built.

The benchmark's generator builds the inputs with it, and the comparison
that decides ``correct`` verifies and rebuilds with it. Later changes to
the port do not reach this copy: it is the yardstick.
"""

from .ops.exact import _try_enable_native as _enable_native_curve

_enable_native_curve()
del _enable_native_curve
