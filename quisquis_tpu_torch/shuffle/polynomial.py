"""Dense scalar polynomial engine over Z_l.

Mirrors reference src/shuffle/polynomial.rs:71-504 (add/sub/multiply/
monic long division/Horner evaluation/Lagrange basis construction), with the
3-point Lagrange construction generalized to any number of interpolation
points (the reference asserts len==3 at polynomial.rs:369).
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import exact as ex

L = ex.L


class Polynomial:
    """Dense coefficient polynomial, little-endian coefficients."""

    __slots__ = ("coefficients",)

    def __init__(self, coefficients: Sequence[int]):
        self.coefficients = [c % L for c in coefficients] or [0]

    @property
    def degree(self) -> int:
        return len(self.coefficients) - 1

    def trimmed(self) -> "Polynomial":
        c = list(self.coefficients)
        while len(c) > 1 and c[-1] == 0:
            c.pop()
        return Polynomial(c)

    def __add__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coefficients), len(other.coefficients))
        out = [0] * n
        for i, c in enumerate(self.coefficients):
            out[i] = c
        for i, c in enumerate(other.coefficients):
            out[i] = (out[i] + c) % L
        return Polynomial(out)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coefficients), len(other.coefficients))
        out = [0] * n
        for i, c in enumerate(self.coefficients):
            out[i] = c
        for i, c in enumerate(other.coefficients):
            out[i] = (out[i] - c) % L
        return Polynomial(out)

    def multiply(self, other: "Polynomial") -> "Polynomial":
        out = [0] * (self.degree + other.degree + 1)
        for i, a in enumerate(self.coefficients):
            if a == 0:
                continue
            for j, b in enumerate(other.coefficients):
                out[i + j] = (out[i + j] + a * b) % L
        return Polynomial(out)

    def scalar_mul(self, s: int) -> "Polynomial":
        return Polynomial([c * s % L for c in self.coefficients])

    def divide_scalar(self, s: int) -> "Polynomial":
        return self.scalar_mul(ex.sc_invert(s % L))

    def divide(self, denom: "Polynomial") -> "Polynomial":
        """Exact long division by a monic denominator (remainder must be 0)."""
        num = self.trimmed().coefficients[:]
        den = denom.trimmed().coefficients
        assert den[-1] == 1, "denominator must be monic"
        if len(num) < len(den):
            return Polynomial([0])
        q = [0] * (len(num) - len(den) + 1)
        for k in range(len(num) - len(den), -1, -1):
            q[k] = num[k + len(den) - 1] % L
            for j, d in enumerate(den):
                num[k + j] = (num[k + j] - q[k] * d) % L
        assert all(c == 0 for c in num[:len(den) - 1]), "non-zero remainder"
        return Polynomial(q)

    def evaluate(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coefficients):
            acc = (acc * x + c) % L
        return acc

    # reference naming parity
    evaluate_polynomial = evaluate

    def __eq__(self, other) -> bool:
        return self.trimmed().coefficients == other.trimmed().coefficients

    def __repr__(self):
        return f"Polynomial({self.coefficients})"


def create_l_x_polynomial(w: Sequence[int]) -> Polynomial:
    """l(X) = prod (X - w_i)."""
    p = Polynomial([1])
    for wi in w:
        p = p.multiply(Polynomial([(-wi) % L, 1]))
    return p


def create_l_i_x_polynomial(w: Sequence[int]) -> List[Polynomial]:
    """[l(X), l_1(X), ..., l_m(X)] — full product + Lagrange basis at w."""
    m = len(w)
    out = [create_l_x_polynomial(w)]
    for i in range(m):
        others = [w[j] for j in range(m) if j != i]
        num = create_l_x_polynomial(others)
        denom = 1
        for j in range(m):
            if j != i:
                denom = denom * (w[i] - w[j]) % L
        out.append(num.divide_scalar(denom))
    return out


def compute_polynomial_expression(l_x_vec: Sequence[Polynomial],
                                  a_rows: Sequence[Sequence[int]],
                                  a_0: Sequence[int]) -> List[Polynomial]:
    """Per-column polynomials: a_0_j*l(X) + sum_i a_rows[i][j]*l_{i+1}(X)."""
    n = len(a_0)
    out = []
    for j in range(n):
        p = l_x_vec[0].scalar_mul(a_0[j])
        for i, row in enumerate(a_rows):
            p = p + l_x_vec[i + 1].scalar_mul(row[j])
        out.append(p)
    return out
