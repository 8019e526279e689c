"""Job input tables and batch sources (counterpart of
multimodalsimilar_tpu/data/datasets.py).

* ``read_table`` reads CSV and parquet files; pandas is imported inside
  it, so the port's device path does not need pandas.
* ``TextClassificationSource`` turns (title, label) rows into tokenized
  numpy batches, from a pandas DataFrame or a plain ``{column: sequence}``
  mapping.
* ``_bounded_map`` is the decode pool's backpressure (``ImageEmbedder``'s
  ``embed_keys``).

The image, multimodal and pair training sources come with later slices.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence, Union

import numpy as np

from multimodalsimilar_tpu_torch.data.sampling import WeightedSampler
from multimodalsimilar_tpu_torch.data.text import preprocess_for_infer
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.utils.buckets import bucket_ladder

Batch = Dict[str, np.ndarray]


class InputError(ValueError):
    """Bad job input (missing table / missing columns)."""


def read_table(path: str, require: Sequence[str] = ()):
    """CSV or parquet by extension (the reference's two input formats).
    Other URL-style paths (s3://, https://) pass straight to pandas.
    ``require`` lists columns the caller needs; missing ones produce one
    clear error naming the file and its actual columns."""
    import pandas as pd
    if path.startswith(("hive://", "hivesql://")):
        raise InputError(f"{path}: warehouse pulls are not ported yet; "
                         f"extract the table to CSV or parquet")
    if "://" not in path and not os.path.exists(path):
        raise InputError(f"input table not found: {path}")
    df = (pd.read_parquet(path) if path.endswith(".parquet")
          else pd.read_csv(path))
    missing = [c for c in require if c not in df.columns]
    if missing:
        raise InputError(
            f"{path}: missing column(s) {missing}; found "
            f"{list(df.columns)} — point the matching --*_col flags at "
            f"your table's column names")
    return df


def column(table, name: str) -> list:
    """A column as a list, from a pandas DataFrame or a plain
    ``{column: sequence}`` mapping."""
    col = table[name]
    return col.tolist() if hasattr(col, "tolist") else list(col)


def _bounded_map(pool, fn, iterable, window: int):
    """``pool.map`` with backpressure: at most ``window`` tasks in flight,
    results in submission order.

    ``Executor.map`` submits the WHOLE iterable up front — with a decode
    producer faster than the consumer, completed futures buffer decoded
    images unboundedly, and abandoning the generator mid-stream blocks in
    shutdown(wait=True) until every remaining decode finishes. The bounded
    window caps buffered results at ``window`` items and cancels
    not-yet-started work on early exit."""
    from collections import deque
    pending = deque()
    it = iter(iterable)
    try:
        for x in it:
            pending.append(pool.submit(fn, x))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()


def _epoch_order(n: int, shuffle: bool, seed: int, epoch: int,
                 sampler: Optional[WeightedSampler]) -> np.ndarray:
    if sampler is not None:
        return np.fromiter(iter(sampler), np.int64, len(sampler))
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


class TextClassificationSource:
    """(title, label...) rows -> tokenized batches.

    label_cols may be one column (single-head ArcFace, batch key
    ``labels``) or several (each under its own name). ``seq_buckets``
    (e.g. ``(48, 64, 96)``) trims each batch's token arrays to the smallest
    bucket covering the batch's longest row — the reference pads to the
    batch max (DataCollatorWithPadding), so its real batches are far
    shorter than max_length. Sampling order is untouched (no sorting).
    """

    def __init__(self, table, tokenizer: TextTokenizer,
                 text_col: str = "spu_name",
                 label_cols: Union[str, Sequence[str]] = "labels",
                 max_length: int = 128, clean: bool = True,
                 seq_buckets: Optional[Sequence[int]] = None):
        self.tokenizer = tokenizer
        self.text_col = text_col
        self.label_cols = ([label_cols] if isinstance(label_cols, str)
                           else list(label_cols))
        self.max_length = max_length
        self.seq_buckets = bucket_ladder(seq_buckets, max_length)
        texts = [str(t) for t in column(table, text_col)]
        self.texts = preprocess_for_infer(texts) if clean else texts
        self.labels = {c: np.asarray(column(table, c))
                       for c in self.label_cols}

    def __len__(self):
        return len(self.texts)

    def materialize(self, idx: np.ndarray) -> Batch:
        batch = dict(self.tokenizer([self.texts[i] for i in idx],
                                    self.max_length))
        if self.seq_buckets:
            need = int(batch["attention_mask"].sum(axis=1).max())
            bucket = next(b for b in self.seq_buckets if b >= need)
            batch = {k: (v[:, :bucket] if v.ndim == 2
                         and v.shape[1] == self.max_length else v)
                     for k, v in batch.items()}
        for col in self.label_cols:
            key = "labels" if len(self.label_cols) == 1 else col
            batch[key] = self.labels[col][idx].astype(np.int32)
        return batch

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, sampler: Optional[WeightedSampler] = None,
                drop_remainder: bool = True) -> Iterator[Batch]:
        order = _epoch_order(len(self), shuffle, seed, epoch, sampler)
        stop = (len(order) - batch_size + 1) if drop_remainder \
            else len(order)
        for s in range(0, max(stop, 0), batch_size):
            yield self.materialize(order[s: s + batch_size])
