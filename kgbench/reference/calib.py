"""The KGWAS_P tail in NumPy, from the reference's description
(``utils.py`` storey_tibshirani_integrate, find_closest_x; ``kgwas.py``):

  * bins: quantiles of |pred| at 0, 1/500, ..., 1 (linear interpolation),
    the first edge lowered by 1 and the last raised by 1, repeated edges
    dropped; a SNP falls in the bin (e_i, e_i+1];
  * per bin Storey and Tibshirani's pi0 at lambda = 0.05 ... 0.90: the
    cubic spline through (lambda, #(p > lambda) / (n (1 - lambda))) read
    at its last knot, which is that knot's value; at most 1, then clipped
    to [1e-5, 1 - 1e-5];
  * weights (1 - pi0) / pi0 over their mean; P_weighted = P / weight, or P
    where that is above 1;
  * the scale factor x: bisection on [0, 200] in steps of 0.01 until
    #(1e-3 < x P_weighted < 1e-2) is within 1% of #(1e-3 < P < 1e-2);
    KGWAS_P = clip(x P_weighted, 0, 1).
"""
from __future__ import annotations

import numpy as np

LAMBDAS = np.arange(0.05, 0.95, 0.05)


def pi0(p: np.ndarray) -> float:
    lam = p.dtype.type(LAMBDAS[-1])
    est = np.count_nonzero(p > lam) / (len(p) * (1 - lam))
    return min(max(min(est, 1.0), 1e-5), 1 - 1e-5)


def weighted_p(pred: np.ndarray, p: np.ndarray, num_bins: int = 500):
    """P_weighted in p's dtype."""
    dt = p.dtype.type
    score = np.abs(np.asarray(pred, dtype=dt))
    q = np.arange(0, 1 + 1 / (num_bins + 1), 1 / num_bins)
    edges = np.quantile(score, q).astype(dt)
    edges[0] -= 1.0
    edges[-1] += 1.0
    _, first = np.unique(edges, return_index=True)
    edges = edges[np.sort(first)]
    bins = np.searchsorted(edges, score, side="left") - 1
    pi = np.empty(len(p), dtype=p.dtype)
    for b in np.unique(bins):
        sel = bins == b
        pi[sel] = pi0(p[sel])
    w = (1 - pi) / pi
    w = w / w.mean(dtype=p.dtype)
    pw = p / w
    return np.where(pw > 1, p, pw)


def scale_factor(pw: np.ndarray, p: np.ndarray) -> float:
    band = int(np.count_nonzero((p > 1e-3) & (p < 1e-2)))
    if band == 0:
        return 1.0
    lo, hi, tol = 0.0, 200.0, 0.01
    mid = (lo + hi) / 2
    while lo <= hi:
        mid = (lo + hi) / 2
        r = np.count_nonzero((pw * mid > 1e-3) & (pw * mid < 1e-2)) / band
        if abs(r - 1) < tol:
            return mid
        if r > 1:
            lo = mid + tol
        else:
            hi = mid - tol
    return mid


def kgwas_p(pred: np.ndarray, p: np.ndarray, dtype=np.float64) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=dtype), 0, 1)
    pw = weighted_p(pred, p)
    return np.clip(dtype(scale_factor(pw, p)) * pw, 0, 1)
