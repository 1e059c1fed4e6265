"""Slow-but-obvious ground-truth implementations (Python ints / numpy objects).

Used by unit tests as oracles for the device kernels, mirroring the
reference's strategy of testing against algebraic definitions
(/root/reference/src/bgg/mod.rs:25-111, SURVEY.md §4).
"""

from __future__ import annotations


def negacyclic_mul(a: list[int], b: list[int], q: int) -> list[int]:
    """Schoolbook negacyclic convolution c = a*b mod (x^n + 1, q)."""
    n = len(a)
    c = [0] * n
    for i in range(n):
        if a[i] == 0:
            continue
        for j in range(n):
            k = i + j
            t = a[i] * b[j]
            if k >= n:
                c[k - n] = (c[k - n] - t) % q
            else:
                c[k] = (c[k] + t) % q
    return [x % q for x in c]


def poly_matmul(a, b, q, n):
    """Matrix product of coefficient-list polynomials: a [r][k], b [k][c]."""
    r, kk = len(a), len(a[0])
    c = len(b[0])
    out = [[[0] * n for _ in range(c)] for _ in range(r)]
    for i in range(r):
        for j in range(c):
            acc = [0] * n
            for t in range(kk):
                prod = negacyclic_mul(a[i][t], b[t][j], q)
                acc = [(x + y) % q for x, y in zip(acc, prod)]
            out[i][j] = acc
    return out


def poly_eval(coeffs: list[int], x: int, q: int) -> int:
    """sum_k coeffs[k] * x^k mod q (Horner)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + int(c)) % q
    return acc
