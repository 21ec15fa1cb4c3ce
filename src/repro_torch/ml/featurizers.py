"""Featurization operators (scikit-learn-style fit/transform).

Each featurizer has a direct pipeline-node encoding (see
:mod:`repro_torch.ml.pipeline`) so the optimizer can propagate predicate constants
and projections *through* it, exactly as the paper's §4.1 requires
(e.g. a constant pushed through a Scaler becomes ``(c - offset) * scale``;
through a OneHotEncoder it becomes the constant indicator vector).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StandardScaler:
    """y = (x - offset) * scale, per column."""

    offset: Optional[np.ndarray] = field(default=None, repr=False)
    scale: Optional[np.ndarray] = field(default=None, repr=False)

    def fit(self, X) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.offset = X.mean(axis=0)
        std = X.std(axis=0)
        std = np.where(std == 0.0, 1.0, std)
        self.scale = 1.0 / std
        return self

    def transform(self, X) -> np.ndarray:
        return (np.asarray(X, dtype=np.float64) - self.offset) * self.scale


@dataclass
class Normalizer:
    """Row-wise normalization: l1 | l2 | max."""

    norm: str = "l2"

    def fit(self, X) -> "Normalizer":
        return self

    def transform(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if self.norm == "l1":
            d = np.abs(X).sum(axis=1, keepdims=True)
        elif self.norm == "l2":
            d = np.sqrt((X * X).sum(axis=1, keepdims=True))
        elif self.norm == "max":
            d = np.abs(X).max(axis=1, keepdims=True)
        else:
            raise ValueError(self.norm)
        return X / np.where(d == 0.0, 1.0, d)


@dataclass
class LabelEncoder:
    """Maps arbitrary integer category values to dense codes [0, V)."""

    classes: Optional[np.ndarray] = field(default=None, repr=False)

    def fit(self, x) -> "LabelEncoder":
        self.classes = np.unique(np.asarray(x))
        return self

    def transform(self, x) -> np.ndarray:
        return np.searchsorted(self.classes, np.asarray(x))


@dataclass
class OneHotEncoder:
    """Single-column one-hot over known category values.

    Unknown values encode to all-zeros (handle_unknown='ignore' semantics).
    """

    categories: Optional[np.ndarray] = field(default=None, repr=False)

    def fit(self, x) -> "OneHotEncoder":
        self.categories = np.unique(np.asarray(x))
        return self

    def transform(self, x) -> np.ndarray:
        x = np.asarray(x).reshape(-1)
        out = (x[:, None] == self.categories[None, :]).astype(np.float64)
        return out

    @property
    def n_categories(self) -> int:
        return len(self.categories)
