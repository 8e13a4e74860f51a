"""Multi-GPU sharding on torch.distributed: meshes of ranks, the sharded
MSM and batched commitment verification (the JAX package's
``parallel/``), and :func:`launch`, which runs one program's ranks."""

from .mesh import Mesh, launch, make_mesh  # noqa: F401
from .sharded_msm import sharded_commitment_verify, sharded_msm  # noqa: F401
