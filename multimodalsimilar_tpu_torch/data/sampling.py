"""Class-balanced sampling for the text ArcFace recipes.

Copied from ``multimodalsimilar_tpu/data/sampling.py`` (numpy only; the
port imports nothing of the JAX package):

* ``class_balance_weights`` <- get_class_weights
  (nlp_classifier_train_daodian_v2.py:58-72): per-row weight = 1 / freq(label)
  — the inverse-frequency weights fed to WeightedRandomSampler (:96-97).
* ``WeightedSampler`` — replacement sampling by those weights (epoch-sized).

``PairSampler`` comes with the pair-training slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def class_balance_weights(labels: np.ndarray) -> np.ndarray:
    """weight[i] = 1 / count(labels == labels[i]) (inverse frequency)."""
    labels = np.asarray(labels)
    _, inverse, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    return (1.0 / counts)[inverse]


class WeightedSampler:
    """Sample indices with replacement, P(i) proportional to weights[i] (the
    torch WeightedRandomSampler contract)."""

    def __init__(self, weights: np.ndarray, num_samples: Optional[int] = None,
                 seed: int = 0):
        self.p = np.asarray(weights, np.float64)
        self.p = self.p / self.p.sum()
        self.num_samples = num_samples or len(self.p)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        yield from self.rng.choice(len(self.p), size=self.num_samples,
                                   replace=True, p=self.p)

    def __len__(self) -> int:
        return self.num_samples
