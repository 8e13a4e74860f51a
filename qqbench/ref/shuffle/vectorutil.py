"""Scalar vector utilities (mirrors reference src/shuffle/vectorutil.rs)."""

from __future__ import annotations

from typing import List, Sequence

from ..ops import exact as ex

L = ex.L


def exp_iter(x: int, count: int, skip: int = 0) -> List[int]:
    """Powers of x: [x^skip, ..., x^(skip+count-1)] (exp_iter starts at 1)."""
    out = []
    cur = pow(x, skip, L)
    for _ in range(count):
        out.append(cur)
        cur = cur * x % L
    return out


def vector_multiply_scalar(a: Sequence[int], b: Sequence[int]) -> int:
    """Dot product of scalar vectors."""
    return sum(x * y for x, y in zip(a, b)) % L


def hadamard_product(a: Sequence[int], b: Sequence[int]) -> List[int]:
    assert len(a) == len(b)
    return [x * y % L for x, y in zip(a, b)]
