"""Job input tables and batch sources (counterpart of
multimodalsimilar_tpu/data/datasets.py).

``read_table`` returns a table as a ``{column: list}`` mapping. It reads
CSV with the stdlib ``csv`` module (the card machine has no pandas),
with ``pd.read_csv``'s values; parquet files, other URLs and ``hive://``
pulls go through pandas (and pyspark), imported at call time. Every
source reads a pandas DataFrame or a ``{column: sequence}`` mapping:

* ``TextClassificationSource`` <- the load_dataset + tokenize pipelines
  (nlp_classifier_train.py:70-87, .._v2.py:85-105);
* ``ImageClassificationSource`` <- CvDataset + None-filtering collate
  (cv_dataset.py:13-43, cv_classifier_train_daodian.py:178-180): failed
  decodes are skipped and the batch topped up from the sampler, so
  batches stay full; uint8 images, normalized on the device
  (``models.vision.device_normalize``);
* ``MultimodalSource`` <- MultimodalDataset (multimodal_dataset.py:34-65);
* ``PairTextSource`` <- NlpSTDataset pair batches (nlp_st_datasets.py).

``_bounded_map`` is the decode pools' backpressure (also
``ImageEmbedder.embed_keys``).
"""

from __future__ import annotations

import csv
import math
import os
import re
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from multimodalsimilar_tpu_torch.data import images as I
from multimodalsimilar_tpu_torch.data.sampling import (PairSampler,
                                                       WeightedSampler)
from multimodalsimilar_tpu_torch.data.text import preprocess_for_infer
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.utils.buckets import bucket_ladder

Batch = Dict[str, np.ndarray]


class InputError(ValueError):
    """Bad job input (missing table / missing columns)."""


# pd.read_csv's default na_values
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT_FIELD = re.compile(r"^\s*[+-]?[0-9]+\s*$")
_FLOAT_FIELD = re.compile(
    r"^\s*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|inf|infinity)\s*$", re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_POW10 = [float(f"1e{i}") for i in range(309)]


def _pandas_float(text: str) -> float:
    """A decimal field as pandas' default float parser reads it (its C
    ``precise_xstrtod``): at most 17 significant digits accumulated in a
    double (later integer digits only scale, later decimals are dropped),
    then one multiply or divide by a power of ten. It differs from the
    correctly rounded ``float()`` in the last bit for some 17-digit
    values."""
    text = text.strip()
    if text.lstrip("+-").lower() in ("inf", "infinity"):
        return float(text)
    m = re.match(r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?$",
                 text)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp[:17]) if exp else 0
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return number * 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _csv_column(fields: List[Optional[str]]) -> list:
    """One CSV column's values as ``pd.read_csv`` types them (``None`` is
    a missing field): all integers -> int (floats when a field is
    missing), all numbers -> float, all True/False forms -> bool, else
    the strings as they are; missing fields become nan."""
    nan = math.nan
    present = [f for f in fields if f is not None]
    if not present:
        return [nan] * len(fields)
    complete = len(present) == len(fields)
    if all(_INT_FIELD.match(f) for f in present):
        ints = [int(f) for f in present]
        # pandas reads int64 and uint64 columns, and wider integers as
        # Python ints, but a column mixing negatives with the uint64-only
        # range as strings
        if not (any(i < 0 for i in ints)
                and any(2**63 <= i < 2**64 for i in ints)):
            if complete:
                return ints
            return [nan if f is None else float(int(f)) for f in fields]
    elif all(_FLOAT_FIELD.match(f) for f in present):
        return [nan if f is None else _pandas_float(f) for f in fields]
    elif all(f in _BOOLS for f in present):
        return [nan if f is None else _BOOLS[f] for f in fields]
    return [nan if f is None else f for f in fields]


def _header(names: List[str]) -> List[str]:
    """pandas' column names: an empty one is ``Unnamed: {i}``, a repeated
    one gets ``.1``, ``.2``, ... ."""
    out: List[str] = []
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        base, n = name, 0
        while name in out:
            n += 1
            name = f"{base}.{n}"
        out.append(name)
    return out


def _read_csv(path: str) -> Dict[str, list]:
    """A CSV file as ``{column: list}``, with the values ``pd.read_csv``
    gives at its defaults: blank lines skipped, short rows padded with
    missing fields, pandas' NA strings missing, each column typed by
    ``_csv_column``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f)
                if len(r) > 1 or (r and r[0].strip())]
    if not rows:
        raise InputError(f"{path}: no columns to parse (empty file)")
    names = _header(rows[0])
    width = len(names)
    fields: List[List[Optional[str]]] = [[] for _ in names]
    for line, row in enumerate(rows[1:], 2):
        if len(row) > width:
            raise InputError(f"{path}: row {line} has {len(row)} fields, "
                             f"the header {width}")
        for j in range(width):
            v = row[j] if j < len(row) else None
            fields[j].append(None if v is None or v in _NA_STRINGS else v)
    return {name: _csv_column(col) for name, col in zip(names, fields)}


def _frame_columns(df) -> Dict[str, list]:
    return {c: df[c].tolist() for c in df.columns}


def read_table(path: str, require: Sequence[str] = ()) -> Dict[str, list]:
    """A job's input table as ``{column: list}``, by address: a CSV file
    (the stdlib reader, ``_read_csv``), a parquet file or another URL
    (pandas), or a warehouse pull, ``hive://db.table`` for a whole table
    and ``hivesql://<SQL>`` for a query, through the Spark adapter
    (``pipelines/spark.py``). ``require`` lists columns the caller needs;
    missing ones produce one clear error naming the file and its actual
    columns."""
    if path.startswith(("hive://", "hivesql://")):
        from multimodalsimilar_tpu_torch.pipelines.spark import (
            SparkTableSource, spark_session)
        query = (path[len("hivesql://"):] if path.startswith("hivesql://")
                 else f"select * from {path[len('hive://'):]}")
        table = _frame_columns(SparkTableSource(spark_session(
            "multimodalsimilar_tpu_torch")).sql(query))
    elif "://" in path or path.endswith(".parquet"):
        if "://" not in path and not os.path.exists(path):
            raise InputError(f"input table not found: {path}")
        import pandas as pd
        table = _frame_columns(pd.read_parquet(path)
                               if path.endswith(".parquet")
                               else pd.read_csv(path))
    else:
        if not os.path.exists(path):
            raise InputError(f"input table not found: {path}")
        table = _read_csv(path)
    missing = [c for c in require if c not in table]
    if missing:
        raise InputError(
            f"{path}: missing column(s) {missing}; found "
            f"{list(table)} — point the matching --*_col flags at "
            f"your table's column names")
    return table


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


def _diagnose_skips(skipped: int, total: int, first_path: str) -> None:
    """Per-item decode failures are skipped (cv_dataset.py:33-41), but
    when NOTHING decoded the --img_root or --key_col is wrong: fail loud
    rather than finish every epoch with no batch. Warn with a count
    otherwise."""
    if skipped and skipped == total:
        raise RuntimeError(
            f"all {skipped} sampled images failed to decode (first "
            f"expected path: {first_path!r}) — check --img_root / --key_col")
    if skipped:
        print(f"warning: skipped {skipped}/{total} rows with "
              f"missing/corrupt images this epoch", file=sys.stderr,
              flush=True)


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


def _item_rng(seed: int, epoch: int, pos: int) -> np.random.Generator:
    """An independent generator per sampled position: augmentations are
    reproducible whatever order the decode threads finish in."""
    return np.random.default_rng((seed * 1000 + epoch) * 100003 + pos)


class ImageClassificationSource:
    """{img_root}/{key}.jpg images + integer labels -> NHWC uint8 batches
    ``{"images", "labels"}``.

    Decode failures are *skipped and replaced* by the next sampler index
    so every batch has the same shape. ``from_image_folder`` ingests the
    timm ImageFolder layout of cv_classifier_train.py:41-49
    ({root}/{class_name}/{img}). ``path_fn(row)`` takes a row as a
    ``{column: value}`` dict. ``decode_cache``: a ``DecodedCache``
    directory (decode each image once across epochs)."""

    @classmethod
    def from_image_folder(cls, root: str, image_size: int = 224,
                          train_aug: bool = False
                          ) -> "ImageClassificationSource":
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        table: Dict[str, list] = {"path": [], "label": [], "class_name": []}
        for li, cname in enumerate(classes):
            cdir = os.path.join(root, cname)
            for fname in sorted(os.listdir(cdir)):
                table["path"].append(os.path.join(cdir, fname))
                table["label"].append(li)
                table["class_name"].append(cname)
        return cls(table, root, key_col="path", label_col="label",
                   image_size=image_size, train_aug=train_aug,
                   path_fn=lambda row: row["path"])

    def __init__(self, table, img_root: str,
                 key_col: str = "goods_sku", label_col: str = "tag_new_id",
                 image_size: int = 512, train_aug: bool = False,
                 path_fn: Optional[Callable[[dict], str]] = None,
                 num_workers: int = 8, decode_cache: Optional[str] = None):
        self.columns = {c: column(table, c) for c in table}
        self.img_root = img_root
        self.key_col, self.label_col = key_col, label_col
        self.labels = np.asarray(self.columns[label_col])
        self.image_size = image_size
        self.train_aug = train_aug
        self.num_workers = num_workers
        self.cache = (I.DecodedCache.open(decode_cache, image_size)
                      if decode_cache else None)
        self.path_fn = path_fn or (
            lambda row: os.path.join(img_root, f"{row[key_col]}.jpg"))

    def __len__(self):
        return len(self.labels)

    def path(self, i: int) -> str:
        return self.path_fn({c: v[i] for c, v in self.columns.items()})

    def _load(self, i: int, rng: np.random.Generator
              ) -> Optional[np.ndarray]:
        if self.train_aug:
            return I.load_train(self.path(i), self.image_size, rng,
                                cache=self.cache, normalize_host=False)
        return I.load_eval(self.path(i), self.image_size, cache=self.cache,
                           normalize_host=False)

    def decoded(self, order: Sequence[int], seed: int, epoch: int
                ) -> Iterator[tuple]:
        """(row, uint8 image) for each row of ``order`` that decodes, in
        order, from a thread pool (cv2 releases the GIL); the skip count
        is reported at the end."""
        from concurrent.futures import ThreadPoolExecutor
        skipped = 0

        def load(args):
            pos, i = args
            return int(i), self._load(int(i), _item_rng(seed, epoch, pos))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = max(self.num_workers * 4, 64)
            for i, img in _bounded_map(pool, load, enumerate(order), window):
                if img is None:
                    skipped += 1
                else:
                    yield i, img
        _diagnose_skips(skipped, len(order),
                        self.path(0) if len(self) else "?")

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, sampler: Optional[WeightedSampler] = None,
                drop_remainder: bool = True) -> Iterator[Batch]:
        order = _epoch_order(len(self), shuffle, seed, epoch, sampler)
        rows: List[int] = []
        imgs: List[np.ndarray] = []
        for i, img in self.decoded(order, seed, epoch):
            rows.append(i)
            imgs.append(img)
            if len(rows) == batch_size:
                yield self._batch(rows, imgs)
                rows, imgs = [], []
        if rows and not drop_remainder:
            yield self._batch(rows, imgs)

    def _batch(self, rows, imgs) -> Batch:
        return {"images": np.stack(imgs),
                "labels": self.labels[rows].astype(np.int32)}


class MultimodalSource:
    """Tokenized titles + uint8 images + labels (multimodal_dataset.py
    semantics: title tokenized at max_length, image at
    {img_root}/{key}.jpg)."""

    def __init__(self, table, tokenizer: TextTokenizer, img_root: str,
                 text_col: str = "spu_name", key_col: str = "spu_sn",
                 label_col: str = "cateid", max_length: int = 128,
                 image_size: int = 380, train_aug: bool = False,
                 decode_cache: Optional[str] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 clean: bool = True):
        self.text = TextClassificationSource(table, tokenizer, text_col,
                                             label_col, max_length,
                                             clean=clean,
                                             seq_buckets=seq_buckets)
        self.image = ImageClassificationSource(
            table, img_root, key_col, label_col, image_size, train_aug,
            decode_cache=decode_cache)

    def __len__(self):
        return len(self.text)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, sampler: Optional[WeightedSampler] = None,
                drop_remainder: bool = True) -> Iterator[Batch]:
        order = _epoch_order(len(self), shuffle, seed, epoch, sampler)
        rows: List[int] = []
        imgs: List[np.ndarray] = []

        def batch():
            out = self.text.materialize(np.asarray(rows))
            out["images"] = np.stack(imgs)
            return out

        for i, img in self.image.decoded(order, seed, epoch):
            rows.append(i)
            imgs.append(img)
            if len(rows) == batch_size:
                yield batch()
                rows, imgs = [], []
        if rows and not drop_remainder:
            yield batch()


class PairTextSource:
    """Siamese pair batches via ``PairSampler`` (NlpSTDataset capability).

    ``seq_buckets`` trims BOTH sides to one shared bucket covering the
    batch's longest row on either side (see TextClassificationSource).
    ``self.table`` is the sampler's table (its key columns as pandas would
    hold them)."""

    def __init__(self, table, tokenizer: TextTokenizer,
                 max_length: int = 128, seed: int = 0,
                 seq_buckets: Optional[Sequence[int]] = None):
        self.sampler = PairSampler(table, seed=seed)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.seq_buckets = bucket_ladder(seq_buckets, max_length)
        self.table = self.sampler.table

    def __len__(self):
        return len(self.sampler)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, sampler: Optional[WeightedSampler] = None,
                drop_remainder: bool = True) -> Iterator[Batch]:
        order = _epoch_order(len(self), shuffle, seed, epoch, sampler)
        # per-(seed, epoch) pair stream: an eval pass (default seed and
        # epoch) draws the SAME pair set every time, while train epochs
        # (distinct epochs) resample like the reference's DataLoader
        rng = _item_rng(seed, epoch, 29)
        stop = (len(order) - batch_size + 1) if drop_remainder \
            else len(order)
        for s in range(0, max(stop, 0), batch_size):
            pairs = [self.sampler.sample_pair(int(i), rng=rng)
                     for i in order[s: s + batch_size]]
            q = self.tokenizer([str(p[0]) for p in pairs], self.max_length)
            t = self.tokenizer([str(p[1]) for p in pairs], self.max_length)
            if self.seq_buckets:
                need = int(max(q["attention_mask"].sum(axis=1).max(),
                               t["attention_mask"].sum(axis=1).max()))
                b = next(x for x in self.seq_buckets if x >= need)
                q = {k: v[:, :b] for k, v in q.items()}
                t = {k: v[:, :b] for k, v in t.items()}
            out = {f"query_{k}": v for k, v in q.items()}
            out.update({f"title_{k}": v for k, v in t.items()})
            out["labels"] = np.asarray([p[2] for p in pairs], np.int32)
            yield out
