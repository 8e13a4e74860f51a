"""The sharded MSM and batched commitment verification: the counterparts
of the JAX package's ``parallel/sharded_msm.py``.

The point axis is split over the ranks. Each rank computes its partial MSM
with :func:`quisquis_tpu_torch.ops.msm.msm` (the three MSM kernels on a
CUDA rank, their plain versions on a CPU rank); the partial points (4 x 10
int32 each) are all-gathered and tree-added in rank order, so every rank
returns the same limbs. Batched commitment verification checks each rank's
lanes and sums the failures over the ranks.
"""

from __future__ import annotations

import torch

from ..ops import batch as qbatch
from ..ops import msm as qmsm
from ..ops import point as pt
from .mesh import Mesh


def sharded_msm(mesh: Mesh, nibbles: torch.Tensor, points: pt.ExtPoint) -> pt.ExtPoint:
    """sum_i s_i * P_i with the point axis split over ``mesh``: nibbles int32
    [n, 64] and points [n], the whole batch on every rank (any device), ->
    one point (coords [10]) on the mesh's device, the same on every rank.
    The axis is padded to a multiple of the world size with zero scalars on
    the identity."""
    n = nibbles.shape[0]
    pad = (-n) % mesh.size
    if pad:
        nibbles = torch.cat([nibbles, nibbles.new_zeros((pad, pt.NWINDOWS))])
        ident = pt.identity((pad,), nibbles.device)
        points = pt.ExtPoint(*(torch.cat([c, e]) for c, e in zip(points, ident)))
    local = qmsm.msm(mesh.shard(nibbles).contiguous(),
                     pt.ExtPoint(*(c.contiguous() for c in mesh.shard(points))))
    parts = mesh.all_gather(torch.stack(list(local)))          # [size, 4, 10]
    return pt.sum_points(pt.ExtPoint(*parts.unbind(1)))


def sharded_commitment_verify(mesh: Mesh, comm: qbatch.BatchCommitment,
                              sk_nibbles: torch.Tensor, v_nibbles: torch.Tensor) -> bool:
    """d == v*G + sk*c for every lane of the batch (the whole batch on every
    rank; each rank checks its lanes) -> the same bool on every rank.
    Raises ValueError unless the ranks divide the batch."""
    ok = qbatch.verify_commitments(mesh.shard(comm), mesh.shard(sk_nibbles),
                                   mesh.shard(v_nibbles))
    return mesh.all_reduce_sum(int((~ok).sum())) == 0
