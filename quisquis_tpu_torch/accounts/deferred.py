"""Deferred point-identity checks: cross-proof batch verification.

The reference verifies every proof eagerly, one multiscalar multiplication
at a time (reference src/accounts/verifier.rs:91-99 and every
`pt_eq`-style check in reference src/shuffle/*.rs). Batched, the right
shape is the opposite: collect every point-identity check from a *batch* of
proofs, scale each by an independent random 128-bit weight, and evaluate
the whole thing as ONE large MSM, on the host or on the device's three MSM
kernels (:mod:`quisquis_tpu_torch.ops.msm`) (the same
random-linear-combination trick the vendored bulletproofs crate uses for
`RangeProof::verify_multiple` batching, generalized to arbitrary
sigma/shuffle checks).

Soundness: if any single check Σ s_i·P_i ≠ identity, the weighted sum is
non-identity except with probability 2^-128 over the verifier's weights
(which the prover cannot predict — they are drawn fresh per verification
from OS entropy unless a seed is pinned for tests).

Fiat–Shamir challenges still derive on the host transcript (sequential
Keccak, cheap); only the heavy point arithmetic is deferred. Checks whose
*result bytes feed back into the transcript* (Schnorr-style first-message
recomputation, e.g. ddh.rs:109-142) cannot be deferred and stay eager.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import exact as ex
from ..ops import field as fe
from ..ops import msm as qmsm
from ..ops import point as pt

L = ex.L

#: the fewest coalesced terms that DeferredPointChecks.verify's "auto"
#: sends to the device (see its docstring)
AUTO_DEVICE_MIN_TERMS = 256


def _pt_wire(p: ex.Point) -> bytes:
    """128-byte extended-point wire form (4 x 32-byte LE coordinates).

    Points made by the C++ curve library carry a cached `.wire`; pure
    tuples serialize their (already reduced mod p) coordinates.
    """
    w = getattr(p, "wire", None)
    if w is not None:
        return w
    x, y, z, t = p
    return (x.to_bytes(32, "little") + y.to_bytes(32, "little")
            + z.to_bytes(32, "little") + t.to_bytes(32, "little"))


def assert_identity(defer: Optional["DeferredPointChecks"],
                    scalars: Sequence[int], points: Sequence[ex.Point],
                    msg: str) -> None:
    """Assert Σ s_i·P_i == identity — immediately, or deferred into `defer`."""
    if defer is not None:
        defer.check(scalars, points, msg)
    elif not ex.pt_eq(ex.pt_msm(scalars, points), ex.IDENTITY):
        raise ValueError(msg)


class DeferredPointChecks:
    """Accumulates point-identity assertions Σ s_i·P_i == identity.

    Duplicate points (Pedersen generators appear in nearly every check)
    are coalesced by accumulating their weighted scalars, so a batch of B
    shuffle proofs costs one MSM over roughly B·(unique commitments) terms
    instead of B·(all terms).
    """

    def __init__(self, seed: Optional[bytes] = None):
        self._seed = os.urandom(32) if seed is None else bytes(seed)
        self._ctr = 0
        # keyed by id(point): the repeated points (Pedersen generators) are
        # the same cached objects across every check, and id() avoids
        # hashing 4-bigint tuples on every term. Distinct objects holding
        # equal points simply stay as separate MSM terms (correct, just
        # unmerged).
        self._acc: dict = {}   # id(point) -> accumulated scalar mod L
        self._pts: dict = {}   # id(point) -> point
        # pre-weighted terms absorbed from other processes in wire form
        # (32-byte scalars ++ 128-byte extended points); they join the final
        # MSM as-is — their weights were already applied by the exporter
        self._wire: List[Tuple[bytes, bytes]] = []
        self.labels: List[str] = []

    def _weight(self) -> int:
        h = hashlib.sha512(
            self._seed + self._ctr.to_bytes(8, "little")).digest()
        self._ctr += 1
        return int.from_bytes(h[:16], "little") | (1 << 127)

    def check(self, scalars: Sequence[int], points: Sequence[ex.Point],
              msg: str) -> None:
        """Assert Σ scalars_i · points_i == identity (deferred)."""
        if len(scalars) != len(points):
            raise ValueError(f"{msg}: scalar/point length mismatch")
        w = self._weight()
        acc = self._acc
        pts = self._pts
        for s, p in zip(scalars, points):
            k = id(p)
            if k in acc:
                acc[k] = (acc[k] + w * s) % L
            else:
                acc[k] = w * s % L
                pts[k] = p
        self.labels.append(msg)

    def check_eq(self, scalars: Sequence[int], points: Sequence[ex.Point],
                 rhs: ex.Point, msg: str) -> None:
        """Assert Σ scalars_i · points_i == rhs (deferred)."""
        self.check(list(scalars) + [L - 1], list(points) + [rhs], msg)

    def derive(self, index: int) -> "DeferredPointChecks":
        """A sub-accumulator with an independent weight stream.

        For a batch split across workers: each collects into its own
        accumulator (no shared mutable state), and the parts are `merge`d
        into one MSM at the end. The sub-seed is derived from
        this accumulator's seed, so the prover can predict it exactly when
        they can predict the parent's (i.e. never, unless a test pins it).
        """
        return DeferredPointChecks(hashlib.sha512(
            self._seed + b"derive" + index.to_bytes(8, "little")).digest()[:32])

    def merge(self, other: "DeferredPointChecks") -> None:
        """Fold another accumulator's terms into this one."""
        acc, pts = self._acc, self._pts
        for k, s in other._acc.items():
            if k in acc:
                acc[k] = (acc[k] + s) % L
            else:
                acc[k] = s
                pts[k] = other._pts[k]
        self._wire.extend(other._wire)
        self.labels.extend(other.labels)

    def export_wire(self) -> Tuple[bytes, bytes, List[str]]:
        """Serialize the accumulated (already weighted) terms for transport
        across a process boundary: (32-byte scalars, 128-byte points, labels).

        The random weights are already folded into the scalars, so the
        importer only needs Σ(all terms of all exporters) == identity —
        each check carried an independent unpredictable weight, which is
        the same soundness statement as a single shared accumulator.
        """
        scalars, points = self._terms()
        sbuf = b"".join(s.to_bytes(32, "little") for s in scalars)
        pbuf = b"".join(_pt_wire(p) for p in points)
        for sb, pb in self._wire:
            sbuf += sb
            pbuf += pb
        return sbuf, pbuf, list(self.labels)

    def absorb_wire(self, sbuf: bytes, pbuf: bytes,
                    labels: Sequence[str]) -> None:
        """Fold terms exported by `export_wire` (e.g. from a worker process)
        into this accumulator's final MSM."""
        if len(sbuf) % 32 or len(pbuf) % 128 or len(sbuf) // 32 != len(pbuf) // 128:
            raise ValueError("absorb_wire: malformed term buffers")
        self._wire.append((bytes(sbuf), bytes(pbuf)))
        self.labels.extend(labels)

    @property
    def num_terms(self) -> int:
        return len(self._acc) + sum(len(s) // 32 for s, _ in self._wire)

    def _terms(self):
        items = [(s, self._pts[k]) for k, s in self._acc.items() if s != 0]
        return [s for s, _ in items], [p for _, p in items]

    def _all_terms(self):
        """(scalars, points) including wire-absorbed terms (host backends)."""
        scalars, points = self._terms()
        for sbuf, pbuf in self._wire:
            for i in range(len(sbuf) // 32):
                scalars.append(int.from_bytes(sbuf[32 * i:32 * i + 32],
                                              "little"))
                points.append(self._decode_wire_point(
                    pbuf[128 * i:128 * i + 128]))
        return scalars, points

    @staticmethod
    def _decode_wire_point(b: bytes) -> ex.Point:
        return (int.from_bytes(b[0:32], "little"),
                int.from_bytes(b[32:64], "little"),
                int.from_bytes(b[64:96], "little"),
                int.from_bytes(b[96:128], "little"))

    def _terms_wire(self) -> Tuple[bytes, bytes]:
        """All terms as concatenated wire buffers (device fast path: no
        bigint -> limb conversion, just byte reshapes into SoA tensors)."""
        sbuf, pbuf, _ = self.export_wire()
        return sbuf, pbuf

    def verify(self, backend: str = "auto", device="cuda", mesh=None) -> None:
        """Evaluate the combined MSM; raise ValueError if non-identity.

        backend: "device" (the MSM kernels on ``device``), "host" (the exact
        backend's Pippenger, on the C++ curve where g++ built it), "sharded"
        (the point axis split over the ranks of ``mesh``, a
        :class:`~quisquis_tpu_torch.parallel.Mesh`; every rank of the mesh
        calls it and every rank returns or raises alike) or "auto": "device"
        from AUTO_DEVICE_MIN_TERMS coalesced terms, else "host" (``device`` is
        resolved first either way, so the default raises without a GPU). On the
        H100 (host / device ms, two runs) the C++ host led at 8 terms
        (0.27-0.34 / 2.50-2.59), 64 (1.74-1.96 / 2.73-4.56) and 128 (2.18-2.75
        / 2.55-3.43), the device narrowly at 192 (3.16-3.58 / 2.90-3.00) and
        from 256 (3.86-4.34 / 2.88-3.41) on, and on the accumulators that
        verify_transaction collects from one transaction: 559 terms (1 + 1
        values over 9 accounts; 7.57-9.69 / 4.70-6.30), 819 (2 + 2 over 9;
        10.00-14.65 / 4.34-6.96), 1,449 (1 + 1 over 64; 12.60-14.73 /
        5.81-5.89) and 1,467 (4 + 4 over 16; 11.97-12.30 / 6.01-6.04). The
        host's threaded Pippenger leads again from about 14,500 terms
        (41.8-51.6 / 49.0-61.6 at 14,575), a size that no caller of "auto"
        reaches (``python3 -m quisquis_tpu_torch.auto_rules``; PERF.md §5). The
        JAX package's crossover was measured on a TPU and is not carried over.
        """
        if backend == "auto":
            resolve_device(device)
            backend = "device" if self.num_terms >= AUTO_DEVICE_MIN_TERMS else "host"
        if backend not in ("host", "device", "sharded"):
            raise ValueError(f"unknown backend {backend!r}")
        if self.num_terms == 0:
            return
        if backend == "device":
            ok = self._verify_device_wire(device)
        elif backend == "sharded":
            ok = self._verify_sharded(mesh)
        else:
            scalars, points = self._all_terms()
            # every term coalesced away: vacuously identity
            ok = not scalars or ex.pt_eq(ex.pt_msm(scalars, points), ex.IDENTITY)
        if not ok:
            raise ValueError(
                "Batched point-check verification failed; one of: "
                + "; ".join(sorted(set(self.labels))))

    @staticmethod
    def _wire_tensors(sbuf: bytes, pbuf: bytes, device):
        """Wire buffers -> (nibbles int32 [n, 64], points [n]) on ``device``,
        by numpy byte reshaping (no Python bigints)."""
        n = len(sbuf) // 32
        nib = pt.scalar_to_nibbles(np.frombuffer(sbuf, np.uint8).reshape(n, 32))
        wire = np.frombuffer(pbuf, np.uint8).reshape(n, 4, 32)
        points = pt.ExtPoint(*(fe.from_bytes(wire[:, i], device) for i in range(4)))
        return torch.as_tensor(nib, device=device), points

    def _verify_device_wire(self, device="cuda") -> bool:
        """Device MSM straight from wire buffers; the identity check runs on
        the device and only one boolean comes back. No padding: the MSM
        pads its rows to whole tiles itself, at any term count."""
        dev = resolve_device(device)
        sbuf, pbuf = self._terms_wire()
        if not sbuf:
            return True
        out = qmsm.msm(*self._wire_tensors(sbuf, pbuf, dev))
        return bool(pt.is_identity(out))

    def _verify_sharded(self, mesh) -> bool:
        """The sharded MSM (``parallel.sharded_msm``) over rank 0's terms.

        Every rank replays its own transcripts into its own accumulator, but
        an accumulator without a pinned seed draws its own weights, and a
        check whose terms fall on two ranks must carry one weight. So rank
        0's terms are broadcast and every rank evaluates that one weighted
        sum; rank 0's weights are as unpredictable as a single process's."""
        if mesh is None:
            raise ValueError("sharded backend requires a mesh")
        from ..parallel.sharded_msm import sharded_msm

        sbuf, pbuf = self._terms_wire()
        sbuf, pbuf = mesh.broadcast_bytes(sbuf), mesh.broadcast_bytes(pbuf)
        if not sbuf:
            return True  # every term coalesced away: vacuously identity
        return bool(pt.is_identity(sharded_msm(mesh, *self._wire_tensors(sbuf, pbuf, "cpu"))))


class DeviceBatchCollector:
    """Collects embedded shuffle and range proofs from a batch of
    transaction verifications for batched device verification.

    The host replays each transaction's transcript in advance-only mode
    (appends + challenge pulls, no scalar vectors, no MSM terms), cloning
    the transcript at each embedded proof boundary; the clones ship to the
    device verifiers as batched STROBE prefix states, and the entire
    embedded-proof verification (transcript replay, challenge arithmetic,
    the combined MSM) runs on the device (bulletproofs/shuffle
    device_verify). Sigma checks stay on the host (eager first-message
    recomputations + a small deferred MSM).
    """

    def __init__(self):
        self.shuffle_entries: list = []
        self.shuffle_transcripts: list = []
        self.range_instances: dict = {}   # n_bits -> [(proof, V, transcript)]

    def add_shuffle(self, entry, transcript) -> None:
        """entry: (proof, statement, inputs, outputs); transcript: a host
        Transcript clone taken BEFORE the proof's first append."""
        self.shuffle_entries.append(entry)
        self.shuffle_transcripts.append(transcript)

    def add_range(self, proof, commitments, transcript, n_bits: int) -> None:
        """transcript: a clone taken before the rangeproof dom-sep."""
        self.range_instances.setdefault(int(n_bits), []).append(
            (proof, list(commitments), transcript))

    @property
    def num_proofs(self) -> int:
        return (len(self.shuffle_entries)
                + sum(len(v) for v in self.range_instances.values()))

    def verify(self, rng=None, device="cuda") -> None:
        """Run the collected proofs on ``device``; raises ValueError on any
        failure (grouped and padded per shape by the dispatchers)."""
        if self.shuffle_entries:
            from ..shuffle.device_verify import device_batch_verify

            device_batch_verify(self.shuffle_entries,
                                transcripts=self.shuffle_transcripts,
                                rng=rng, device=device)
        if self.range_instances:
            from ..bulletproofs.device_verify import device_batch_verify

            for n_bits, insts in sorted(self.range_instances.items()):
                device_batch_verify(insts, n_bits, rng=rng, device=device)
