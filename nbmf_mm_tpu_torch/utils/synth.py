"""Synthetic binary data generation (reference ``src/nbmf_mm/_utils.py:11-47``).

Note (preserved quirk, documented in SURVEY.md §2.4): the generator samples
through a *sigmoid* link ``P = sigmoid(W_true @ H_true)`` even though the
NBMF-MM model is mean-parameterized (``V ~ Bernoulli(W H)`` directly).  Tests
and examples use it only as a stable source of structured binary matrices, so
the mismatch is harmless; ``link="mean"`` opts into model-consistent data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_synthetic_binary_data"]


def generate_synthetic_binary_data(
    n_samples=100,
    n_features=50,
    n_components=5,
    sparsity=0.3,
    random_state=None,
    link="sigmoid",
):
    """Generate a binary matrix with a known low-rank structure.

    Returns ``(X, W_true, H_true)`` with ``X`` of shape
    ``(n_samples, n_features)``, ``W_true`` of shape
    ``(n_samples, n_components)`` and ``H_true`` of shape
    ``(n_components, n_features)``.
    """
    rng = np.random.RandomState(random_state)
    W_true = rng.uniform(0.1, 0.9, size=(n_samples, n_components))
    H_true = (rng.random((n_components, n_features)) < sparsity).astype(float)
    if link == "sigmoid":
        P = 1.0 / (1.0 + np.exp(-(W_true @ H_true)))
    elif link == "mean":
        # Model-consistent: rows of W on the simplex so P = W @ H is in [0,1].
        W_true = W_true / W_true.sum(axis=1, keepdims=True)
        H_true = np.clip(rng.uniform(0.05, 0.95, size=H_true.shape), 0.0, 1.0)
        P = W_true @ H_true
    else:
        raise ValueError(f"unknown link: {link!r}")
    X = (rng.random((n_samples, n_features)) < P).astype(float)
    return X, W_true, H_true
