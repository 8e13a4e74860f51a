"""Multiscalar multiplication: sum_i s_i * P_i over batched points.

    sum_i s_i P_i = sum_w 16^w T_w,   T_w = sum_i digit[i, w] * P_i.

Three stages, each a CUDA kernel (``csrc/msm_table.cu``, ``csrc/msm_acc.cu``,
``csrc/msm_tail.cu``) with its plain PyTorch version in
:mod:`quisquis_tpu_torch.ops.msm_plain`, re-exported here:
:func:`msm_table`, :func:`msm_window_sums`, :func:`msm_tail`.

:func:`msm`, :func:`msm_rows`, :func:`pad_rows`, :class:`SharedBasis` and
:func:`msm_shared_rows` (rows over one shared basis, whose table is built
once) are those of :mod:`quisquis_tpu_torch.ops.cuda_point`, which pads
the rows and runs the three stages' wrappers: the kernels for CUDA
tensors, the plain versions for CPU tensors, at every size (the JAX
package's size thresholds were measured on a TPU and are not carried
over). Imports go one way:
this module -> ``cuda_point`` -> ``msm_plain``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import exact as ex
from . import point as pt
from .cuda_point import (SharedBasis, msm, msm_rows, msm_shared_rows,  # noqa: F401
                         pad_rows)  # (callers take them from here)
from .msm_plain import (MSM_LANES, msm_shared_base, msm_slices,  # noqa: F401  (plain versions)
                        msm_table, msm_tail, msm_window_sums, select)


def msm_host(scalars, host_points, device="cuda") -> ex.Point:
    """Host scalars and points -> device MSM -> host point."""
    dev = resolve_device(device)
    nibbles = torch.as_tensor(pt.scalars_to_nibbles(scalars), device=dev)
    out = msm(nibbles, pt.from_exact_batch(host_points, dev))
    return pt.to_exact_batch(pt.ExtPoint(*(c[None] for c in out)))[0]
