"""Ensemble aggregation (the serving part of `gnnep_tpu.train.calibrate`).

The affine debias and conformal calibration wait for the training slice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ensemble_mixture(member_means: np.ndarray, member_vars: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """[M,N,T] member stats → mixture mean and variance (law of total variance):
    var = E[var] + E[mean²] − (E[mean])²."""
    mean = member_means.mean(axis=0)
    var = (member_vars.mean(axis=0) + (member_means ** 2).mean(axis=0)
           - mean ** 2)
    return mean, np.clip(var, 1e-12, None)
