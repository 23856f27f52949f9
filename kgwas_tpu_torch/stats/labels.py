"""Label construction variants for GWAS chi-square regression targets, and
the Bonferroni correction.

Counterpart of ``kgwas_tpu/stats/labels.py`` on column tables (numpy
only). The residual-* labels regress chi2 on LD scores and train on the
residual; the closed-form weighted least squares gives statsmodels' WLS
estimates. ``KGWAS_Data.process_gwas_file`` builds them from the loaded
LD scores (its ``label`` argument).
"""
from __future__ import annotations

import numpy as np


def _wls_params(x: np.ndarray, y: np.ndarray, weights=None):
    """Weighted least squares y ~ 1 + x. Returns (intercept, slope) equal to
    statsmodels WLS(y, add_constant(x), weights).fit().params."""
    X = np.column_stack([np.ones_like(x, dtype=float), x.astype(float)])
    if weights is None:
        w = np.ones_like(y, dtype=float)
    else:
        w = np.asarray(weights, dtype=float)
    Xw = X * w[:, None]
    beta = np.linalg.solve(X.T @ Xw, Xw.T @ y.astype(float))
    return beta[0], beta[1]


def residual_label(lr_uni: dict, mode: str) -> np.ndarray:
    """The residual label of a sumstats column table with BETA, SE,
    ld_score, w_ld_score and ld_weight columns."""
    col = lambda k: np.asarray(lr_uni[k], dtype=float)  # noqa: E731
    y = (col("BETA") / col("SE")) ** 2
    y = np.nan_to_num(y, nan=0.0)

    if mode in ("residual-w-ld", "residual-w-ld-ols"):
        X = col("w_ld_score")
    else:
        X = col("ld_score")

    if mode in ("residual-w-ld", "residual-ld"):
        b0, b1 = _wls_params(X, y, col("ld_weight"))
    else:
        b0, b1 = _wls_params(X, y)

    # the reference predicts from w_ld_score in every mode, even the
    # ld_score-fit ones; kept for parity
    y_pred = b0 + b1 * col("w_ld_score")
    resid = y - y_pred
    if mode == "residual-ld-ols-abs":
        return np.abs(resid)
    return resid


def bonferroni(p_values, alpha: float = 0.05):
    """Bonferroni-corrected p-values (statsmodels multipletests
    method='bonferroni'); alpha does not change them."""
    p = np.asarray(p_values, dtype=float)
    return np.minimum(p * len(p), 1.0)
