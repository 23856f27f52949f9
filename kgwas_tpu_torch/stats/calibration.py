"""Storey-Tibshirani binned FDR reweighting + scale-factor calibration.

Counterpart of ``kgwas_tpu/stats/calibration.py`` on numpy and scipy alone
(``finalize_predictions`` runs in the port's span kgwas.tail.calibration).
A table is a column table, ``dict[str, np.ndarray]``. The pandas semantics
the JAX version relies on are written out here:

  * ``Series.quantile`` is numpy's linear-interpolation quantile over the
    non-NaN values;
  * the edge expansion indexes the quantile Series by LABEL: the edge of
    quantile 0.0 drops by 1 and the edge of quantile 1.0 rises by 1;
  * ``drop_duplicates`` keeps the first of equal edges;
  * ``pd.cut`` bins are right-closed, (e_i, e_{i+1}]; a value outside every
    bin has no bin, so no pi0, so ``P_weighted`` 1;
  * object-dtype arithmetic skips missing values, and the mean of the
    weights is a sequential sum over the present ones.
"""
from __future__ import annotations

import numpy as np
from scipy import interpolate

from ..engine.profiling import span


def find_closest_x(df_pred, lower_bound=0, upper_bound=200, tolerance=0.01):
    """Calibration scale factor via bisection: find x such that
    #(lower < x*P_weighted < upper) matches #(lower < P < upper). Returns
    1.0 when no GWAS p-value falls in the calibration band."""
    upper = 1e-2
    lower = 1e-3
    mid = (lower_bound + upper_bound) / 2
    pw = np.asarray(df_pred["P_weighted"], dtype=np.float64)
    p = np.asarray(df_pred["P"], dtype=np.float64)
    res2 = int(np.count_nonzero((p < upper) & (p > lower)))
    if res2 == 0:
        return 1.0
    while lower_bound <= upper_bound:
        mid = (lower_bound + upper_bound) / 2
        res1 = int(np.count_nonzero((pw * mid < upper) & (pw * mid > lower)))
        result = res1 / res2
        if abs(result - 1) < tolerance:
            return mid
        elif result > 1:
            lower_bound = mid + tolerance
        else:
            upper_bound = mid - tolerance
    return mid


def storey_pi_estimator(pvalue):
    """Storey & Tibshirani (PNAS 2003) pi0 estimator over one bin's
    p-values: lambda grid 0.05..0.90, cubic-spline extrapolated at the
    largest lambda, clipped at 1."""
    pvalue = np.asarray(pvalue, dtype=np.float64)
    total_tests = float(len(pvalue))
    lam = np.arange(0.05, 0.95, 0.05)
    counts = np.array([(pvalue > i).sum() for i in np.arange(0.05, 0.95, 0.05)])
    pi0 = np.array([counts[l] / (total_tests * (1 - lam[l]))
                    for l in range(len(lam))])
    if not np.all(np.isfinite(pi0)):
        finite = np.isfinite(pi0)
        lam = lam[finite]
        pi0 = pi0[finite]
    pi0_est = interpolate.CubicSpline(lam, pi0)(lam[-1])
    if pi0_est > 1:
        pi0_est = 1
    return pi0_est


def _quantile_bins(values, num_bins):
    """Bin index per value (-1: no bin), as pd.cut over the expanded,
    deduplicated Series.quantile edges."""
    quantiles = np.arange(0, 1 + 1 / (num_bins + 1), 1 / num_bins)
    v64 = np.asarray(values, dtype=np.float64)
    present = v64[~np.isnan(v64)]
    if len(present):
        edges = np.quantile(present, quantiles, method="linear")
    else:
        edges = np.full(len(quantiles), np.nan)
    # label lookups of the quantile Series: a missing label is a KeyError
    for label, delta in ((0.0, -1.0), (1.0, 1.0)):
        pos = np.flatnonzero(quantiles == label)
        if len(pos) == 0:
            raise KeyError(label)
        edges[pos[0]] = edges[pos[0]] + delta
    _, first = np.unique(edges, return_index=True)
    edges = edges[np.sort(first)]
    if np.any(np.diff(edges) <= 0):
        raise ValueError("bins must increase monotonically.")
    ids = np.searchsorted(edges, v64, side="left")
    missing = np.isnan(v64) | (ids == len(edges)) | (ids == 0)
    return np.where(missing, -1, ids - 1), len(edges) - 1


def storey_tibshirani_integrate(gwas_data, column="pred", num_bins=100):
    """Binned p-value reweighting. Bins SNPs by quantiles of ``column``,
    estimates pi0 per bin, reweights P by (1-pi0)/pi0 normalised to mean 1.
    Adds the bin_number, pi0, weights and P_weighted columns to gwas_data
    (and clips P into [0, 1]), and returns P_weighted."""
    bins, n_bins = _quantile_bins(gwas_data[column], float(num_bins))
    gwas_data["bin_number"] = bins

    p = np.asarray(gwas_data["P"], dtype=np.float64)
    if p.min() < 0 or p.max() > 1:
        p = np.clip(p, 0, 1)
        gwas_data["P"] = p

    pi0 = np.full(len(p), np.nan)
    for i in range(n_bins):
        in_bin = bins == i
        if in_bin.any():
            est = storey_pi_estimator(p[in_bin])
            # prevent exploding weights
            if est < 1e-5:
                est = 1e-5
            if est > 1 - 1e-5:
                est = 1 - 1e-5
            pi0[in_bin] = est
    if np.any(pi0 == 1):  # all-null bin -> smallest non-null weight
        one = pi0 == 1
        pi0[one] = np.nanmax(pi0[~one])
    if np.any(pi0 == 0):  # all-alternative bin -> largest non-null weight
        zero = pi0 == 0
        pi0[zero] = np.nanmin(pi0[~zero])
    gwas_data["pi0"] = pi0

    weights = (1 - pi0) / pi0
    present = ~np.isnan(weights)
    # pandas' object-dtype mean: a sequential sum over the present values
    mean_weight = (np.cumsum(np.where(present, weights, 0.0))[-1]
                   / np.count_nonzero(present)) if present.any() else np.nan
    weights = weights / mean_weight
    gwas_data["weights"] = weights

    p_weighted = p / weights
    over = p_weighted > 1
    # use the original p-value when the reweighted one exceeds 1
    p_weighted[over] = p[over]
    p_weighted[np.isnan(p_weighted)] = 1
    gwas_data["P_weighted"] = p_weighted
    return p_weighted


@span("kgwas.tail.calibration")
def finalize_predictions(lr_uni, pred):
    """The KGWAS tail: attach per-SNP predictions, run the 500-bin
    Storey-Tibshirani reweighting on |pred|, calibrate with the
    find_closest_x scale factor and clip to [0, 1]. Adds the pred, abs_pred,
    SR_P_val and SR columns to lr_uni and returns (lr_uni_to_save,
    scale_factor): a copy of lr_uni with pred, plus P_weighted and KGWAS_P."""
    pred = np.asarray(pred)
    if pred.ndim == 2 and pred.shape[1] == 1:  # [n, out_channels=1]
        pred = pred[:, 0]
    lr_uni["pred"] = pred
    lr_uni_to_save = {k: np.array(v, copy=True) for k, v in lr_uni.items()}

    lr_uni["abs_pred"] = np.abs(lr_uni["pred"])
    lr_uni["SR_P_val"] = storey_tibshirani_integrate(
        lr_uni, column="abs_pred", num_bins=500
    )
    lr_uni["SR"] = -np.log10(lr_uni["SR_P_val"].astype(float))
    lr_uni_to_save["P_weighted"] = lr_uni["SR_P_val"]

    scale_factor = find_closest_x(lr_uni_to_save)
    lr_uni_to_save["KGWAS_P"] = np.clip(
        scale_factor * lr_uni_to_save["P_weighted"], 0, 1)
    return lr_uni_to_save, scale_factor
