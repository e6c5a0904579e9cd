"""Analytic reproductions of the paper's Theorem 1 bound and Table 1 rows.

A copy of ``repro.core.theory`` (pure Python): the port keeps its own.

These are the formulas the experiments are validated against:
``theorem1_bound`` is eq. (12) term by term; ``table1_row`` reproduces the
convergence-order / communication / computation columns for every method.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Problem:
    d: int            # model dimension
    m: int            # workers
    B: int            # batch size per worker
    N: int            # total iterations
    L: float = 1.0    # smoothness
    sigma: float = 1.0  # gradient-noise std bound
    f0_gap: float = 1.0  # f(x0) - f*


def min_iterations(p: Problem) -> int:
    """Theorem 1's validity condition N > 16 (d + Bm - 1)^2 / (Bm)."""
    return int(16 * (p.d + p.B * p.m - 1) ** 2 / (p.B * p.m)) + 1


def theorem_mu(p: Problem) -> float:
    """Smoothing parameter choice mu <= 1/sqrt(d N)."""
    return 1.0 / math.sqrt(p.d * p.N)


def theorem1_bound(p: Problem, tau: int) -> Dict[str, float]:
    """Eq. (12): every term of the average-squared-gradient-norm bound."""
    BmN = math.sqrt(p.B * p.m * p.N)
    terms = {
        "fo_descent": 4 * p.L * p.f0_gap / BmN,
        "fo_variance": 2 * p.sigma**2 / (BmN * tau),
    }
    if tau > 1:
        r = (tau - 1) / tau
        terms.update({
            "smooth_gap_1": 4 * p.L**2 / (p.d**2 * BmN * tau),
            "smooth_gap_2": 4 * p.L**2 / (p.d**2 * p.N * BmN),
            "zo_bias_1": p.L**2 / BmN * r,
            "zo_bias_2": p.L**2 / (p.N * BmN * tau),
            "zo_variance_1": 4 * p.d * p.sigma**2 / BmN * r,
            "zo_variance_2": 4 * p.d * p.sigma**2 / (p.N * BmN * tau),
            "zo_bias_3": p.L**2 / BmN * r,
            "zo_bias_4": p.L**2 / (p.N * BmN * tau),
        })
    terms["total"] = sum(v for k, v in terms.items() if k != "total")
    return terms


def convergence_order(p: Problem, tau: int) -> float:
    """Remark 1: O(d/sqrt(mN)) for tau>1, O(1/sqrt(mN)) for tau=1."""
    if tau > 1:
        return p.d / math.sqrt(p.m * p.N)
    return 1.0 / math.sqrt(p.m * p.N)


# --------------------------------------------------------------------------- #
# Table 1
# --------------------------------------------------------------------------- #
def table1_row(method: str, p: Problem, tau: int = 8, s: int = 4,
               mu_redundancy: float = 0.25, K_dataset: int = 50000) -> Dict[str, float]:
    """(convergence order, comm load/iter in scalars, normalized compute load).

    Compute load is normalized to the cost of one first-order stochastic
    gradient (the paper's convention; one ZO estimate = 2 function evals
    ~= (1/d) gradient-equivalents per Nesterov & Spokoiny 2017).
    """
    d, m, N = p.d, p.m, p.N
    rows = {
        "ho_sgd": dict(
            conv=d / math.sqrt(m * N) if tau > 1 else 1 / math.sqrt(m * N),
            comm=(tau - 1 + d) / tau,
            comp=1 / tau + 1 / d,
        ),
        "ri_sgd": dict(
            conv=tau / math.sqrt(m * N),
            comm=d / tau,
            comp=mu_redundancy * m + 1,
        ),
        "sync_sgd": dict(conv=1 / math.sqrt(m * N), comm=float(d), comp=1.0),
        "zo_sgd": dict(
            conv=(d / m) ** (1 / 3) / N ** (1 / 4), comm=1.0, comp=1 / d
        ),
        "zo_svrg_ave": dict(
            conv=d / N + 1 / min(d, m), comm=1.0, comp=K_dataset / d
        ),
        "qsgd": dict(
            conv=1 / N + math.sqrt(d),
            comm=(s**2 + s * math.sqrt(d)) / 32.0,
            comp=1.5,
        ),
    }
    if method not in rows:
        raise KeyError(method)
    return rows[method]
