"""ELLPACK sparse matvec and graph-polynomial bases (plain PyTorch).

The port's independent oracle for the stencil path and its kernels: K
applications of the rescaled graph Laplacian in padded ELLPACK form
``(idx, val)`` of shape (M, W) against a dense (M, C) activation,
interleaved per the Chebyshev / monomial recurrences, followed by one
(B*M, Fin*K) x (Fin*K, Fout) matmul.  Counterpart of the JAX package's
``deepsphere_tpu.ops.spmv``.
"""

from __future__ import annotations

import torch

__all__ = [
    "ellpack_spmv",
    "chebyshev_basis",
    "chebyshev_terms",
    "monomial_basis",
    "monomial_terms",
    "graph_conv",
]


def ellpack_spmv(idx, val, x):
    """y = L @ x with L in padded ELLPACK form.

    Unrolled over the small row width W, so peak memory stays O(M*C).

    :param idx: (M, W) int64 column indices (padded entries self-point)
    :param val: (M, W) values (padded entries are 0)
    :param x: (M, C) dense activations
    :return: (M, C)
    """
    W = idx.shape[1]
    y = val[:, 0:1] * x[idx[:, 0]]
    for w in range(1, W):
        y = y + val[:, w : w + 1] * x[idx[:, w]]
    return y


def chebyshev_terms(matvec, x0, K):
    """Yield [T_0(L)x, ..., T_{K-1}(L)x] over an abstract ``matvec``:
    x_k = 2 L x_{k-1} - x_{k-2}."""
    yield x0
    if K > 1:
        x1 = matvec(x0)
        yield x1
        for _ in range(2, K):
            x0, x1 = x1, 2.0 * matvec(x1) - x0
            yield x1


def monomial_terms(matvec, x0, K):
    """Yield [x, Lx, L^2 x, ...] over an abstract ``matvec``."""
    yield x0
    for _ in range(1, K):
        x0 = matvec(x0)
        yield x0


def chebyshev_basis(idx, val, x, K):
    """Chebyshev basis stack, shape (K, M, C)."""
    return torch.stack(
        list(chebyshev_terms(lambda y: ellpack_spmv(idx, val, y), x, K)))


def monomial_basis(idx, val, x, K):
    """Monomial basis stack, shape (K, M, C)."""
    return torch.stack(
        list(monomial_terms(lambda y: ellpack_spmv(idx, val, y), x, K)))


def graph_conv(basis, x, kernel, n_terms):
    """Apply a graph polynomial conv given a basis function.

    :param basis: callable (x2d (M, C), n_terms) -> (n_terms, M, C)
    :param x: input activations (B, M, Fin)
    :param kernel: (Fin * n_terms, Fout) — Fin-major, term-minor rows, the
        reference kernel layout
    :return: (B, M, Fout)
    """
    B, M, Fin = x.shape
    Fout = kernel.shape[-1]
    x2d = x.permute(1, 0, 2).reshape(M, B * Fin)
    tx = basis(x2d, n_terms)  # (K, M, B*Fin)
    tx = tx.reshape(n_terms, M, B, Fin)
    tx = tx.permute(2, 1, 3, 0).reshape(B * M, Fin * n_terms)
    y = torch.matmul(tx, kernel.to(tx.dtype))
    return y.reshape(B, M, Fout).to(x.dtype)
