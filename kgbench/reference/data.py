"""The reference data layer in NumPy: the LDSC regression weights, the chi^2
labels and the train / val / test split, from the raw sumstats and LD-score
tables of kgbench.inputs.gwas (one row per SNP, in SNP order).

  * weights (reference utils.py ldsc weights, kgwas_data.py
    process_gwas_file): l = max(ld, 1), w = max(1 + w_ld, 1), c = h2 N / M
    with h2 = 0.5, M = 1.5e7 and N the mean sample size; weight =
    1 / (2 (1 + c l)^2) / w, divided by its mean;
  * label: chi^2 = (BETA / SE)^2;
  * split: scikit-learn's train_test_split(ids, test_size=0.05,
    random_state=seed) twice (test off all SNPs, then val off the rest):
    the test part is the first ceil(0.05 n) of RandomState(seed)'s
    permutation, the train part the rest in permutation order.
"""
from __future__ import annotations

import math

import numpy as np


def ldsc_weights(sumstats: dict, ld: dict, w_ld: dict,
                 dtype=np.float64) -> np.ndarray:
    one = dtype(1)
    n = dtype(np.mean(sumstats["N"]))
    l = np.maximum(np.asarray(ld["ldscore"], dtype=dtype), one)
    w = np.maximum(one + np.asarray(w_ld["ldscore"], dtype=dtype), one)
    c = dtype(0.5) * n / dtype(15_000_000.0)
    weight = one / (dtype(2) * (one + c * l) ** 2) / w
    return weight / weight.mean(dtype=dtype)


def chi2_labels(sumstats: dict, dtype=np.float64) -> np.ndarray:
    return (np.asarray(sumstats["BETA"], dtype=dtype)
            / np.asarray(sumstats["SE"], dtype=dtype)) ** 2


def _split(ids: np.ndarray, frac: float, seed: int):
    n_test = math.ceil(frac * len(ids))
    perm = np.random.RandomState(seed).permutation(len(ids))
    return ids[perm[n_test:]], ids[perm[:n_test]]


def split(n_snp: int, seed: int):
    """(train, val, test) SNP indices."""
    train_val, test = _split(np.arange(n_snp), 0.05, seed)
    train, val = _split(train_val, 0.05, seed)
    return train, val, test


def batches(train: np.ndarray, batch_size: int) -> list:
    """Consecutive batches of the training SNPs, the tail dropped."""
    n = len(train) // batch_size
    return [train[i * batch_size:(i + 1) * batch_size] for i in range(n)]
