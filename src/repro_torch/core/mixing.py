"""Gossip (confusion) matrices W for decentralized SGD (Section 5).

A numpy copy of ``repro.core.mixing`` (the port imports nothing of the
JAX package): the same matrices and the same Birkhoff-von Neumann
decomposition, so the port's gossip exchanges lower the same W onto the
same permutation terms.

Assumption 7 requires W symmetric, doubly stochastic, with spectral gap
1 - rho > 0 where rho = max_{n>=2} |lambda_n(W)|. The paper's examples:
  W1 = 11^T / N            (fully connected,  rho = 0)
  W2 = ring, self+2 nbrs   (rho ~= 1 - 16 pi^2 / (3 N^2) for large N)
  W3 = disconnected        (rho = 1, DSGD does NOT converge)
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def fully_connected(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n)


def ring(n: int) -> np.ndarray:
    """Paper's W2: average of self + immediate left/right neighbors."""
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = 1.0 / 3.0
        w[i, (i + 1) % n] = 1.0 / 3.0
        w[i, (i - 1) % n] = 1.0 / 3.0
    if n == 1:
        w[0, 0] = 1.0
    if n == 2:
        # self + one neighbor twice -> 1/3 + 2/3
        w = np.array([[1 / 3, 2 / 3], [2 / 3, 1 / 3]])
    return w


def torus_2d(rows: int, cols: int) -> np.ndarray:
    """4-neighbor 2-D torus gossip (beyond-paper topology; deg(G) = 4)."""
    n = rows * cols
    w = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = {
                ((r + 1) % rows) * cols + c,
                ((r - 1) % rows) * cols + c,
                r * cols + (c + 1) % cols,
                r * cols + (c - 1) % cols,
            } - {i}
            for j in nbrs:
                w[i, j] = 1.0 / (len(nbrs) + 1)
            w[i, i] = 1.0 - w[i].sum()
    return w


def near_square_factors(n: int) -> tuple[int, int]:
    """(rows, cols) with rows*cols = n, rows the largest divisor <= sqrt(n)
    (how GossipMix folds a 1-D worker axis onto a 2-D torus)."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def disconnected(n: int) -> np.ndarray:
    """Paper's W3: block-diagonal, rho = 1, provably non-mixing."""
    w = np.eye(n)
    if n >= 3:
        w[: n - 1, : n - 1] = fully_connected(n - 1)
        w[n - 1, n - 1] = 1.0
    return w


def spectral_rho(w: np.ndarray) -> float:
    """rho = second largest |eigenvalue| (Assumption 7)."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(eig[1]) if eig.shape[0] > 1 else 0.0


def check_assumption7(w: np.ndarray, *, atol: float = 1e-8) -> None:
    """Raise if W violates symmetry / double-stochasticity / spectral gap."""
    if not np.allclose(w, w.T, atol=atol):
        raise ValueError("W is not symmetric")
    if not np.allclose(w.sum(axis=0), 1.0, atol=atol):
        raise ValueError("W is not doubly stochastic (columns)")
    if not np.allclose(w.sum(axis=1), 1.0, atol=atol):
        raise ValueError("W is not doubly stochastic (rows)")
    if (w < -atol).any():
        raise ValueError("W has negative entries")
    if spectral_rho(w) >= 1.0 - 1e-12:
        raise ValueError("W has no spectral gap (rho = 1): network disconnected")


def ring_rho_paper_estimate(n: int) -> float:
    """Paper's closed-form estimate rho ~= 1 - 16 pi^2 / (3 N^2)."""
    return 1.0 - 16.0 * np.pi**2 / (3.0 * n**2)


def degree(w: np.ndarray) -> int:
    """deg(G): max off-diagonal nonzeros per row (Table 1.1 comm cost)."""
    off = (np.abs(w) > 1e-12).sum(axis=1) - 1
    return int(off.max())


def _perfect_matching(support: np.ndarray) -> Optional[list]:
    """Kuhn's augmenting-path matching on a boolean (dst, src) support
    matrix. Returns match[dst] = src covering every row, or None."""
    n = support.shape[0]
    match_of_src = [-1] * n   # src -> dst

    def try_row(dst: int, seen: list) -> bool:
        for src in range(n):
            if support[dst, src] and not seen[src]:
                seen[src] = True
                if match_of_src[src] < 0 or try_row(match_of_src[src], seen):
                    match_of_src[src] = dst
                    return True
        return False

    for dst in range(n):
        if not try_row(dst, [False] * n):
            return None
    match = [-1] * n
    for src, dst in enumerate(match_of_src):
        match[dst] = src
    return match


def birkhoff_decomposition(w: np.ndarray, *, atol: float = 1e-9
                           ) -> list[tuple[float, tuple]]:
    """Birkhoff-von Neumann: W = sum_k c_k P_k with c_k > 0, sum c_k = 1.

    Each term is ``(c_k, perm_k)`` where ``perm_k`` is a tuple of
    ``(src, dst)`` pairs (the ``ppermute`` convention: value moves
    src -> dst, so P_k[dst, src] = 1 and (P_k x)_dst = x_src). Every
    perm is FULL (fixed points appear as (i, i) — a permutation is
    complete); the identity term carries
    ``perm_k = ()`` so callers skip the collective entirely.

    This is how an arbitrary doubly stochastic gossip matrix is lowered
    onto collective hardware: one gather per non-identity permutation,
    scaled by the scalar c_k (GossipMix consumes this). Greedy peeling via
    perfect matchings on the remaining support; terminates because W
    doubly stochastic keeps every remainder/total doubly stochastic
    (Birkhoff's theorem) and each peel zeroes >= 1 entry.
    """
    w = np.array(w, dtype=float)
    if (w < -atol).any():
        raise ValueError("W has negative entries")
    if not (np.allclose(w.sum(0), 1.0, atol=1e-6)
            and np.allclose(w.sum(1), 1.0, atol=1e-6)):
        raise ValueError("W is not doubly stochastic")
    n = w.shape[0]
    terms: list[tuple[float, tuple]] = []
    remaining = w.copy()
    for _ in range(n * n + 1):
        if remaining.max() <= atol:
            break
        match = _perfect_matching(remaining > atol)
        if match is None:   # numerically exhausted support
            break
        c = float(min(remaining[dst, match[dst]] for dst in range(n)))
        if all(match[dst] == dst for dst in range(n)):
            perm: tuple = ()
        else:
            perm = tuple((match[dst], dst) for dst in range(n))
        terms.append((c, perm))
        for dst in range(n):
            remaining[dst, match[dst]] -= c
    total = sum(c for c, _ in terms)
    if abs(total - 1.0) > 1e-6:
        raise ValueError(f"decomposition lost mass: sum c_k = {total}")
    return terms
