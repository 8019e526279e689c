"""Sampling strategies: class-balanced weights, weighted sampling, pair
sampling for the Siamese model.

Copied from ``multimodalsimilar_tpu/data/sampling.py`` (the port imports
nothing of the JAX package), with ``PairSampler`` reading a
``{column: list}`` table where the JAX one reads a DataFrame:

* ``class_balance_weights`` <- get_class_weights
  (nlp_classifier_train_daodian_v2.py:58-72): per-row weight = 1 / freq(label)
  — the inverse-frequency weights fed to WeightedRandomSampler (:96-97).
* ``WeightedSampler`` — replacement sampling by those weights (epoch-sized).
* ``PairSampler`` <- NlpSTDataset (nlp_st_datasets.py:13-100): coin-flip
  positive/negative pair construction over the tag/lv2/lv1 hierarchy,
  with a real RNG (the reference's ``sample(random_state=42)`` returns the
  same row every epoch) and bucket indices built once.
"""

from __future__ import annotations

from numbers import Number
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from multimodalsimilar_tpu_torch.retrieval.filters import _missing


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


def _key_array(values: Sequence) -> np.ndarray:
    """A key column as pandas holds it, so comparisons and lookups behave
    as on the JAX package's DataFrame: numbers as int64, or float64 with
    NaN where any value is missing (``_missing``) or a float; anything
    else as objects with NaN for the missing values."""
    missing = [_missing(v) for v in values]
    present = [v for v, m in zip(values, missing) if not m]
    if all(isinstance(v, Number) and not isinstance(v, bool)
           for v in present):
        if any(missing) or any(isinstance(v, (float, np.floating))
                               for v in present):
            return np.asarray([np.nan if m else float(v)
                               for v, m in zip(values, missing)],
                              np.float64)
        return np.asarray(values, np.int64)
    out = np.empty(len(values), object)
    out[:] = [np.nan if m else v for v, m in zip(values, missing)]
    return out


def _group_indices(keys: np.ndarray) -> Dict:
    """``DataFrame.groupby(col).indices``: each key's row indices in
    ascending order; rows whose key is missing belong to no group."""
    groups: Dict = {}
    for i, k in enumerate(keys):
        if not _missing(k):
            groups.setdefault(k, []).append(i)
    return {k: np.asarray(v) for k, v in groups.items()}


class PairSampler:
    """Online positive/negative pair construction for Siamese training.

    Thresholds follow nlp_st_datasets.py:17-19 — tag 0.7 / lv2 0.2 / lv1 0.1.
    For an anchor row:
      P(positive) = 0.5; positive drawn from same-lv1 (r<0.1), same-lv2
      (r<0.2, or tag missing), else same-tag bucket; negative drawn from
      same-lv2-diff-tag (r<0.1), same-lv1-diff-lv2 (r<0.2), else diff-lv1.
      Any failed lookup falls back to a (self, self, positive) pair
      (nlp_st_datasets.py:89-91).

    ``table`` is a ``{column: sequence}`` mapping (or a DataFrame) with
    ``title``, ``tag_id``, ``lv2_category_id``, ``lv1_category_id`` and
    optionally ``sku_sn_name``; ``self.table`` holds its key columns as
    ``_key_array``s. The same seed draws the same pairs as the JAX
    sampler on the same rows.
    """

    KEYS = ("tag_id", "lv2_category_id", "lv1_category_id")

    def __init__(self, table, seed: int = 0, tag_th: float = 0.7,
                 lv2_th: float = 0.2, lv1_th: float = 0.1):
        from multimodalsimilar_tpu_torch.data.datasets import column
        self.rng = np.random.default_rng(seed)
        self.tag_th, self.lv2_th, self.lv1_th = tag_th, lv2_th, lv1_th
        self._raw_titles = column(table, "title")
        self.table = {"title": self._raw_titles}
        for col in self.KEYS:
            self.table[col] = _key_array(column(table, col))
        self._tag_vals, self._lv2_vals, self._lv1_vals = (
            self.table[c] for c in self.KEYS)
        self._by_tag, self._by_lv2, self._by_lv1 = (
            _group_indices(self.table[c]) for c in self.KEYS)
        self._titles = np.asarray([str(t) for t in self._raw_titles],
                                  object)
        # the reference excludes rows sharing the anchor's sku_sn_name from
        # every POSITIVE bucket (nlp_st_datasets.py:40,46,52); without the
        # column, excluding the anchor row itself is the closest reading
        self._sku = None
        if "sku_sn_name" in table:
            self._sku = self.table["sku_sn_name"] = _key_array(
                column(table, "sku_sn_name"))

    def __len__(self) -> int:
        return len(self._raw_titles)

    def _not_anchor_sku(self, cands: Optional[np.ndarray], idx: int
                        ) -> Optional[np.ndarray]:
        """Positive-branch exclusion: drop rows sharing the anchor's
        sku_sn_name (or the anchor row itself when the column is absent)."""
        if cands is None or len(cands) == 0:
            return None
        if self._sku is not None:
            out = cands[self._sku[cands] != self._sku[idx]]
        else:
            out = cands[cands != idx]
        return out if len(out) else None

    def _not_query_title(self, cands: Optional[np.ndarray], query
                         ) -> Optional[np.ndarray]:
        """Negative-branch exclusion: the reference filters
        title != query (nlp_st_datasets.py:66,75,83) — a duplicate of the
        anchor's own title must never be labeled dissimilar."""
        if cands is None or len(cands) == 0:
            return None
        out = cands[self._titles[cands] != str(query)]
        return out if len(out) else None

    @staticmethod
    def _pick(cands: Optional[np.ndarray], rng: np.random.Generator
              ) -> Optional[int]:
        if cands is None or len(cands) == 0:
            return None
        return int(rng.choice(cands))

    def sample_pair(self, idx: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[str, str, int]:
        """Return (query_title, pair_title, label) for anchor row idx.

        ``rng`` overrides the sampler's own stream: ``PairTextSource``
        passes a per-(seed, epoch) generator, so an eval pass draws the
        same pair set every time while train epochs resample."""
        rng = rng if rng is not None else self.rng
        query = self._raw_titles[idx]
        tag, lv2, lv1 = (self._tag_vals[idx], self._lv2_vals[idx],
                         self._lv1_vals[idx])
        title = None
        if rng.uniform() > 0.5:                # positive
            r = rng.uniform()
            if r < self.lv1_th:
                j = self._pick(self._not_anchor_sku(self._by_lv1.get(lv1),
                                                    idx), rng)
            elif r < self.lv2_th or tag == -1:
                j = self._pick(self._not_anchor_sku(self._by_lv2.get(lv2),
                                                    idx), rng)
            elif r < self.tag_th:
                # same-tag branch requires a bucket of >2 non-anchor rows
                # (nlp_st_datasets.py:53)
                cands = self._not_anchor_sku(self._by_tag.get(tag), idx)
                j = self._pick(cands, rng) if cands is not None \
                    and len(cands) > 2 else None
            else:
                j = None
            label = 1
            if j is not None:
                title = self._raw_titles[j]
        else:                                   # negative
            r = rng.uniform()
            j = None
            if r < self.lv1_th and tag != -1:
                cands = self._by_lv2.get(lv2)
                if cands is not None:
                    cands = cands[self._tag_vals[cands] != tag]
                    j = self._pick(self._not_query_title(cands, query), rng)
            elif r < self.lv2_th:
                cands = self._by_lv1.get(lv1)
                if cands is not None:
                    cands = cands[self._lv2_vals[cands] != lv2]
                    j = self._pick(self._not_query_title(cands, query), rng)
            elif r < self.tag_th:
                # diff-lv1, uniform over the complement of one lv1 bucket,
                # by rejection sampling (~1 expected draw), with an exact
                # complement scan when one bucket is nearly every row
                n = len(self)
                qs = str(query)
                for _ in range(32):
                    cand = int(rng.integers(n))
                    if (self._lv1_vals[cand] != lv1
                            and self._titles[cand] != qs):
                        j = cand
                        break
                else:
                    cands = np.flatnonzero(self._lv1_vals != lv1)
                    j = self._pick(self._not_query_title(cands, query), rng)
            label = 0
            if j is not None:
                title = self._raw_titles[j]
        if title is None:
            title, label = query, 1            # fallback self-pair positive
        return query, title, label
