"""Cutoff math: order statistics, censored imputation and the normal CDF,
each as a float64 numpy reference and a torch twin."""
