"""Safe integer arithmetic + fractions (reference libs/math).

Consensus arithmetic must fail loudly on overflow (Go int64 semantics)
rather than silently promote to bignum: voting-power sums and proposer
priorities are specified as int64.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_INT64 = (1 << 63) - 1
MIN_INT64 = -(1 << 63)


class ErrOverflow(ArithmeticError):
    pass


def safe_add_int64(a: int, b: int) -> int:
    c = a + b
    if not (MIN_INT64 <= c <= MAX_INT64):
        raise ErrOverflow(f"int64 overflow: {a} + {b}")
    return c


def safe_sub_int64(a: int, b: int) -> int:
    c = a - b
    if not (MIN_INT64 <= c <= MAX_INT64):
        raise ErrOverflow(f"int64 overflow: {a} - {b}")
    return c


def safe_mul_int64(a: int, b: int) -> int:
    c = a * b
    if not (MIN_INT64 <= c <= MAX_INT64):
        raise ErrOverflow(f"int64 overflow: {a} * {b}")
    return c


def safe_add_clip_int64(a: int, b: int) -> int:
    c = a + b
    return max(MIN_INT64, min(MAX_INT64, c))


def safe_sub_clip_int64(a: int, b: int) -> int:
    c = a - b
    return max(MIN_INT64, min(MAX_INT64, c))


@dataclass(frozen=True)
class Fraction:
    """Positive rational (reference libs/math/fraction.go); trust levels
    like 1/3 parse from "n/d" strings."""

    numerator: int
    denominator: int

    def __post_init__(self):
        if self.denominator == 0:
            raise ZeroDivisionError("fraction with zero denominator")

    @classmethod
    def parse(cls, s: str) -> "Fraction":
        n, _, d = s.partition("/")
        if not d:
            raise ValueError(f"not a fraction: {s!r}")
        return cls(int(n), int(d))

    def __float__(self) -> float:
        return self.numerator / self.denominator

    def __str__(self) -> str:
        return f"{self.numerator}/{self.denominator}"
