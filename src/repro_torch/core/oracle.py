"""IMM's θ maths (Tang et al. 2015), the same floats as
``repro.core.oracle.log_cnk`` / ``imm_theta_params``."""
from __future__ import annotations

import math


def log_cnk(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def imm_theta_params(n: int, k: int, eps: float, ell: float = 1.0):
    """IMM's λ', λ* (Eqs. 9 & 6) with the ℓ adjustment; returns
    (λ', λ*, ε', ℓ)."""
    ell = ell * (1.0 + math.log(2) / math.log(n))
    eps_p = math.sqrt(2.0) * eps
    lcnk = log_cnk(n, k)
    lam_p = ((2.0 + 2.0 / 3.0 * eps_p)
             * (lcnk + ell * math.log(n) + math.log(math.log2(n)))
             * n / (eps_p ** 2))
    alpha = math.sqrt(ell * math.log(n) + math.log(2))
    beta = math.sqrt((1.0 - 1.0 / math.e) * (lcnk + ell * math.log(n) + math.log(2)))
    lam_star = 2.0 * n * (((1.0 - 1.0 / math.e) * alpha + beta) ** 2) / (eps ** 2)
    return lam_p, lam_star, eps_p, ell
