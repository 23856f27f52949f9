from .ldsc import ldsc_regression_weights
from .calibration import (
    finalize_predictions,
    find_closest_x,
    storey_pi_estimator,
    storey_tibshirani_integrate,
)
from .gwas_eval import plot_cluster_range
