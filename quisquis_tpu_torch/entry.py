"""The port's flagship step: batched ElGamal commitment generation followed
by verification (BASELINE configs 1-2), the counterpart of
``__graft_entry__.py``'s ``_flagship_fn``, ``_example_inputs`` and
``entry``. The multi-chip dry run waits for the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np

from .device import resolve_device
from .ops import batch as qb
from .ops import exact as ex
from .ops import point as pt


def flagship_step(gr_x, gr_y, gr_z, gr_t, grsk_x, grsk_y, grsk_z, grsk_t,
                  r_nib, v_nib, sk_nib):
    """comm = Enc_pk(v; r), then d == v*G + sk*c per lane."""
    pk = qb.BatchPk(pt.ExtPoint(gr_x, gr_y, gr_z, gr_t),
                    pt.ExtPoint(grsk_x, grsk_y, grsk_z, grsk_t))
    comm = qb.generate_commitments(pk, r_nib, v_nib)
    ok = qb.verify_commitments(comm, sk_nib, v_nib)
    return ok, comm.c.x, comm.d.x


def example_inputs(batch: int, device="cuda"):
    """The same seeded keys and scalars as the JAX package's entry."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    sks = [int(rng.integers(1, 2**62)) for _ in range(batch)]
    rs = [int(rng.integers(1, 2**62)) for _ in range(batch)]
    vs = [int(rng.integers(0, 2**32)) for _ in range(batch)]
    gr_pts = [ex.pt_base_mul(int(rng.integers(1, 2**62))) for _ in range(batch)]
    grsk_pts = [ex.pt_mul(sk, p) for sk, p in zip(sks, gr_pts)]
    gr = pt.from_exact_batch(gr_pts, dev)
    grsk = pt.from_exact_batch(grsk_pts, dev)
    return (*gr, *grsk, qb.scalars_to_device(rs, dev), qb.scalars_to_device(vs, dev),
            qb.scalars_to_device(sks, dev))


def entry(device="cuda"):
    """(step, example_args) at batch 8."""
    return flagship_step, example_inputs(8, device)
