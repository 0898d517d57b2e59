"""Engine defaults (counterpart of :mod:`repro.search.defaults`).

The reference's time-tuned table binds only on the platform it was
measured on (jax CPU), so the port resolves every knob left at its
sentinel to :data:`FALLBACK_DEFAULTS`.  :func:`detect_regime` is the
reference's classifier, kept for the backends whose tuned knobs it keys.
"""
from __future__ import annotations

import torch

__all__ = ["FALLBACK_DEFAULTS", "REGIME_WIDTH_THRESHOLD", "detect_regime"]

#: mean per-block Eq. 13 interval width separating the regimes (measured
#: by the reference's tools/tune_defaults.py)
REGIME_WIDTH_THRESHOLD = 0.4508

#: what a knob left at its sentinel resolves to
FALLBACK_DEFAULTS = {
    "best_first": True,
    "warm_start_blocks": None,
    "leaf_eval": None,          # None -> the tree backend's device rule ("auto")
    "n_pivots": 0,              # joint-bound depth; 0 = eq13 intervals only
}


def detect_regime(index) -> str:
    """``"clustered"`` (tight per-block pivot-similarity intervals) or
    ``"uniform"`` (intervals near the full spread), from the mean interval
    width of a flat index."""
    width = index.dp_max.float() - index.dp_min.float()
    mean_width = float(torch.mean(width))
    return "clustered" if mean_width < REGIME_WIDTH_THRESHOLD else "uniform"
