"""What a device program needs to take its inputs in one upload a call and
to replay as CUDA graphs.

* :class:`Staging`: a host buffer (pinned on CUDA) and a device buffer of
  one size. ``put`` writes a call's uint8 arrays into the host buffer back
  to back and copies it to the device in one non-blocking copy; the arrays
  come back as views of the device buffer, which is the same memory every
  call, so a captured graph can read them. The caller holds a lock from
  ``put`` to the verdict: the next call rewrites the buffers.
* :class:`GraphCache`: when a program's key is captured, and how many keys
  keep their graphs.
* :func:`holding` and :func:`hold`: a captured graph reads tensors by
  address and holds no reference to them. A cache of device constants with
  a bound (``ops.device_strobe``) passes each constant it hands out through
  ``hold``, so that a capture open on the thread (``with holding() as
  held``) keeps it for as long as the graph keeps ``held``; an eviction
  from the cache then cannot free memory that a graph reads.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Sequence

import numpy as np
import torch


class Staging:
    """A uint8 host buffer and device buffer of `nbytes` (one buffer on the
    CPU, which the device views then share)."""

    def __init__(self, nbytes: int, device: torch.device):
        host = torch.empty(nbytes, dtype=torch.uint8)
        if device.type == "cuda":
            self.host, self.dev = host.pin_memory(), torch.empty_like(host, device=device)
        else:
            self.host = self.dev = host

    def put(self, arrays: Sequence[np.ndarray]) -> list:
        """The uint8 `arrays` as views of the device buffer, in order and in
        their shapes: written back to back, then one copy of the buffer."""
        view, at, out = self.host.numpy(), 0, []
        for a in arrays:
            view[at:at + a.size] = a.reshape(-1)
            out.append(self.dev[at:at + a.size].view(a.shape))
            at += a.size
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
        return out


class GraphCache:
    """When a key's program is captured: a key runs eagerly the first time
    it is seen, is captured the second time, and replays from then on. At
    most `size` keys hold graphs; the least recently run is let go first,
    and is then seen afresh."""

    def __init__(self, size: int):
        self.size = size
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: set = set()

    def get(self, key):
        """(the key's graphs or None, whether to capture them now)."""
        graphs = self._graphs.get(key)
        if graphs is not None:
            self._graphs.move_to_end(key)
            return graphs, False
        if key in self._seen:
            return None, True
        self._seen.add(key)
        return None, False

    def put(self, key, graphs) -> None:
        self._graphs[key] = graphs
        while len(self._graphs) > self.size:
            old, _ = self._graphs.popitem(last=False)
            self._seen.discard(old)

    def __len__(self) -> int:
        return len(self._graphs)


_HELD = threading.local()


@contextlib.contextmanager
def holding():
    """Collect, into the list it yields, every tensor passed to :func:`hold`
    on this thread inside the block (around a capture)."""
    outer = getattr(_HELD, "into", None)
    _HELD.into = held = []
    try:
        yield held
    finally:
        _HELD.into = outer
        if outer is not None:
            outer.extend(held)


def hold(t: torch.Tensor) -> torch.Tensor:
    """`t`, kept by the :func:`holding` block open on this thread, if any."""
    into = getattr(_HELD, "into", None)
    if into is not None:
        into.append(t)
    return t
