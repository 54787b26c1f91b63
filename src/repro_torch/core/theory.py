"""Analytic complexity + learning-rate rules from the paper's theorems.

These are the closed forms behind Tables 1.1 and 1.2. The benchmark
`benchmarks/table1_1.py` prints them next to the event-simulator measurements
and the empirical iterations-to-epsilon from the quadratic testbed.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Workload:
    L: float = 1.0            # Lipschitz gradient constant
    sigma: float = 1.0        # stochastic-gradient std (Assumption 2)
    sigma_c: float = 0.5      # compression-induced std sigma' (Assumption 4)
    varsigma: float = 0.5     # outer/data variance among workers (Assumption 6)
    f_gap: float = 1.0        # f(x1) - f*
    M: int = 10_000           # dataset size
    d: int = 1_000_000        # model dimension


# --- Table 1.2: iteration / query complexity (to average grad-norm <= eps) ---

def gd_iterations(w: Workload, eps: float) -> float:
    return w.f_gap * w.L / eps


def gd_queries(w: Workload, eps: float) -> float:
    return w.M * gd_iterations(w, eps)


def sgd_iterations(w: Workload, eps: float) -> float:
    return w.f_gap * (w.L / eps + w.L * w.sigma**2 / eps**2)


def mbsgd_iterations(w: Workload, eps: float, batch: int) -> float:
    return w.f_gap * (w.L / eps + w.L * w.sigma**2 / (batch * eps**2))


def mbsgd_queries(w: Workload, eps: float, batch: int) -> float:
    return batch * mbsgd_iterations(w, eps, batch)


# --- Table 1.1: iterations for each system relaxation (N workers) ---

def dist_sgd_iterations(w: Workload, eps: float, n: int) -> float:
    """mb-SGD baseline, Eq. (2.2): O(1/eps + sigma^2/(N eps^2))."""
    return w.f_gap * (1.0 / eps + w.sigma**2 / (n * eps**2))


def csgd_iterations(w: Workload, eps: float, n: int) -> float:
    """Eq. (3.6): adds the compression-variance term sigma'^2/eps^2."""
    return w.f_gap * (1.0 / eps + w.sigma**2 / (n * eps**2)
                      + w.sigma_c**2 / eps**2)


def ecsgd_iterations(w: Workload, eps: float, n: int) -> float:
    """Thm 3.4.2: 1/T + sigma/sqrt(TN) + sigma'^{2/3}/T^{2/3}  =>  solve for T."""
    return w.f_gap * (1.0 / eps + w.sigma**2 / (n * eps**2)
                      + w.sigma_c / eps ** 1.5)


def asgd_iterations(w: Workload, eps: float, n: int, tau: float | None = None) -> float:
    """Thm 4.2.2 with tau ~ N (paper: staleness proportional to #workers)."""
    tau = float(n) if tau is None else tau
    return w.f_gap * ((tau + 1.0) / eps + w.sigma**2 / (n * eps**2))


def dsgd_iterations(w: Workload, eps: float, n: int, rho: float) -> float:
    """Thm 5.2.6: 1/T + sigma/sqrt(NT) + (varsigma rho/((1-rho)T))^{2/3}."""
    return w.f_gap * (1.0 / eps + w.sigma**2 / (n * eps**2)
                      + (w.varsigma * rho / max(1e-12, 1.0 - rho)) / eps ** 1.5)


# --- Table 1.1: communication cost per iteration (alpha latency, beta bw) ---

def comm_cost_ps(n: int, alpha: float, beta: float) -> float:
    return 2 * n * (alpha + beta)


def comm_cost_allreduce(n: int, alpha: float, beta: float) -> float:
    return 2 * n * alpha + 2 * beta


def comm_cost_compressed(n: int, alpha: float, beta: float, eta: float) -> float:
    """Compression ratio eta < 1 scales only the bandwidth term."""
    return 2 * n * alpha + 2 * beta * eta


def comm_cost_decentralized(deg: int, alpha: float, beta: float) -> float:
    return deg * (alpha + beta)


# --- learning-rate rules (used by the optimizers' `paper_lr` helpers) ---

def lr_gd(w: Workload) -> float:
    return 1.0 / w.L                                        # Thm 1.1.1


def lr_sgd(w: Workload, T: int) -> float:
    return 1.0 / (w.L + w.sigma * math.sqrt(T * w.L))       # Thm 1.2.1


def lr_csgd(w: Workload, T: int) -> float:
    return 1.0 / (w.L + w.sigma_c * math.sqrt(T * w.L))     # Eq. (3.5)


def lr_ecsgd(w: Workload, T: int, n: int) -> float:
    return 1.0 / (2 * w.L + math.sqrt(T / n) * w.sigma
                  + T ** (1 / 3) * w.sigma_c ** (2 / 3))    # Thm 3.4.2


def lr_asgd(w: Workload, T: int, tau: float) -> float:
    return 1.0 / (w.L * (tau + 1) + math.sqrt(T * w.L) * w.sigma)  # Eq. (4.10)


def lr_dsgd(w: Workload, T: int, n: int, rho: float) -> float:
    return 1.0 / (1.0 + math.sqrt(T * n) * w.sigma
                  + T ** (1 / 3) * w.varsigma ** (2 / 3)
                  * rho ** (2 / 3) * (1 - rho) ** (-2 / 3))  # Thm 5.2.6
