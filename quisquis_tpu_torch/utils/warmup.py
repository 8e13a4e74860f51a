"""Warm the device paths of given shapes before the first request.

The twin of the JAX package's ``utils.jaxcache.warmup``, with the same shape
descriptors:

    ("shuffle", m, batch)            DeviceShuffleVerifier
    ("range", n, m, batch)           DeviceRangeVerifier
    ("range-prove", n, m, batch)     DeviceRangeProver
    ("shuffle-prove", m, batch)      DeviceShuffleProver

On CUDA, warming a shape does three things: nvcc builds the six kernels
(``ops/cuda_build.py``, once per hash of the sources, under its file lock),
the per-shape instance is built and cached with its resident generator
tables (``get_device_*``), and one batch of zero inputs runs through it,
its result discarded. Warmup lasts for this process only; run it inside the
resident daemon (``python -m quisquis_tpu_torch.daemon``) so that other
processes meet warm shapes.

The JAX package's ``enable_persistent_cache`` has no counterpart here: the
kernels' build directory (``build/quisquis_tpu_torch/``) is the port's
cache, kept between processes, and nothing else is compiled.
"""

from __future__ import annotations

import time
from typing import Iterable, Tuple

from ..device import resolve_device

#: a shape descriptor, as in the module docstring
ShapeDesc = Tuple

#: shape kind -> its number of dimensions
KINDS = {"shuffle": 2, "range": 3, "range-prove": 3, "shuffle-prove": 2}


def warmup(shapes: Iterable[ShapeDesc], verbose: bool = False, device="cuda") -> None:
    """Build, cache and run once the device instance of every shape
    (``verbose``: print each shape's seconds). ``device`` is resolved
    first, so the default raises without a GPU."""
    dev = resolve_device(device)
    shapes = [tuple(d) for d in shapes]
    for desc in shapes:
        if not desc or desc[0] not in KINDS or len(desc) != 1 + KINDS[desc[0]]:
            raise ValueError(f"unknown warmup shape {desc!r}")
    if dev.type == "cuda":
        from ..ops import cuda_build

        cuda_build.load_library()
    for desc in shapes:
        kind, dims = desc[0], desc[1:]
        t0 = time.perf_counter()
        if kind == "shuffle":
            from ..shuffle.device_verify import get_device_shuffle_verifier

            get_device_shuffle_verifier(*dims, device=dev).warmup()
        elif kind == "range":
            from ..bulletproofs.device_verify import get_device_range_verifier

            get_device_range_verifier(*dims, device=dev).warmup()
        elif kind == "range-prove":
            from ..bulletproofs.device_prove import get_device_range_prover

            get_device_range_prover(*dims, device=dev).warmup()
        else:
            from ..shuffle.device_prove import get_device_shuffle_prover

            get_device_shuffle_prover(*dims, device=dev).warmup()
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        if verbose:
            print(f"warmup {desc}: {time.perf_counter() - t0:.3f} s", flush=True)
