"""Linear models with optional L1 regularization (proximal gradient).

L1 matters to the reproduction: the paper's Fig. 9 sweeps the regularization
strength to create zero weights, which the model-projection-pushdown rule then
exploits (zero-weight inputs never need to be read).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _soft_threshold(w: np.ndarray, t: float) -> np.ndarray:
    return np.sign(w) * np.maximum(np.abs(w) - t, 0.0)


@dataclass
class LogisticRegression:
    """Binary logistic regression trained with proximal gradient descent
    (ISTA) so that L1 produces exact zeros."""

    alpha: float = 0.0  # L1 strength
    lr: float = 0.5
    n_iter: int = 400
    weights: Optional[np.ndarray] = field(default=None, repr=False)
    bias: float = 0.0

    def fit(self, X, y) -> "LogisticRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, d = X.shape
        w = np.zeros(d)
        b = 0.0
        # Lipschitz-ish step scaling
        scale = max(1.0, float(np.mean(np.sum(X * X, axis=1))) / 4.0)
        step = self.lr / scale
        for _ in range(self.n_iter):
            z = X @ w + b
            p = 1.0 / (1.0 + np.exp(-z))
            err = p - y
            gw = X.T @ err / n
            gb = err.mean()
            w = _soft_threshold(w - step * gw, step * self.alpha)
            b -= step * gb
        self.weights = w
        self.bias = float(b)
        return self

    def decision_function(self, X) -> np.ndarray:
        z = np.asarray(X, dtype=np.float64) @ self.weights + self.bias
        return 1.0 / (1.0 + np.exp(-z))

    def predict_proba(self, X) -> np.ndarray:
        return self.decision_function(X)

    def predict(self, X) -> np.ndarray:
        return (self.decision_function(X) >= 0.5).astype(np.int64)

    @property
    def n_zero_weights(self) -> int:
        return int(np.sum(self.weights == 0.0))


@dataclass
class LinearRegression:
    """Ridge-regularized least squares (closed form)."""

    l2: float = 1e-6
    weights: Optional[np.ndarray] = field(default=None, repr=False)
    bias: float = 0.0

    def fit(self, X, y) -> "LinearRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        Xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        A = Xb.T @ Xb + self.l2 * np.eye(Xb.shape[1])
        wb = np.linalg.solve(A, Xb.T @ y)
        self.weights = wb[:-1]
        self.bias = float(wb[-1])
        return self

    def predict(self, X) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.weights + self.bias
