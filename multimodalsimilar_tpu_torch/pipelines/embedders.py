"""Batched embedders (counterpart of ``TextEmbedder``, ``ImageEmbedder``
and ``MultimodalEmbedder`` in multimodalsimilar_tpu/pipelines/embedders.py).

The reference embeds one row at a time; here the workload streams through
the tower in full batches (the last one padded by repeating its last row),
with three batches in flight: later batches are launched before earlier
results are read back, and uploads and read-backs go through pinned host
memory, so the card computes while the host tokenizes or decodes.
``fused_similar_fn`` chains a tower into the engine's search for the
serving daemon.

* ``TextEmbedder`` — tokenizer + any model with ``predict_emb``.
* ``ImageEmbedder`` — decoded uint8 [S, S, 3] images + a
  ``CvImageClassifier``; uint8 goes up to the device, where
  ``device_normalize`` and the NCHW permute run. ``embed_keys`` keeps the
  reference's per-SKU ``emb.txt`` cache (daodian_infer.py:259-285) or the
  packed ``EmbeddingCache``, and averages a key's images ({j}.jpg up to
  the first gap) — *correctly* (the reference re-reads image 0 for every
  extra image, daodian_infer.py:270-272; not reproduced).
* ``MultimodalEmbedder`` — (title, image) pairs + a
  ``MultimodalClassifier``: the fused [B, fc_dim + hidden] embedding.

Three padding rules for rows, each as in the JAX package: a serving
micro-batch (``embed_device``, the fused path) pads with zeros (images)
or repeated last rows (tokens) to its bucket;
``ImageEmbedder.embed_batch`` pads a partial chunk to its pow2 bucket by
repeating the last image;
``embed_keys`` pads its tail to the full batch by repeating the last
image. The int8 text tower (``models/quant.py``) takes one activation
scale over its whole padded batch, so for it these rules are part of
the output, as in the JAX package. ``TextEmbedder.__call__`` cuts the
token length of a padding-invariant tower's batches to their longest
row (its docstring).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalsimilar_tpu_torch.data import images as I
from multimodalsimilar_tpu_torch.data.datasets import _bounded_map
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.vision import (device_normalize,
                                                       to_nchw)
from multimodalsimilar_tpu_torch.utils.buckets import bucket_ladder
from multimodalsimilar_tpu_torch.utils.devices import resolve_device
from multimodalsimilar_tpu_torch.utils.profiling import count, enabled, span

_TOKEN_KEYS = ("input_ids", "attention_mask", "token_type_ids")
_IN_FLIGHT = 3   # batches launched ahead of the oldest read-back
_WINDOW = 64     # batches a text window holds (tokenized and sorted at once)
_FIRST_WINDOW = 4   # ... the first window of a padding-invariant tower


def _pad_rows(arrs: Dict[str, np.ndarray], batch: int) -> Dict[str, np.ndarray]:
    n = next(iter(arrs.values())).shape[0]
    if n == batch:
        return arrs
    return {k: np.concatenate(
        [v, np.repeat(v[-1:], batch - n, axis=0)]) for k, v in arrs.items()}


def _upload(arrays: Sequence[np.ndarray], device: torch.device):
    """Host arrays as tensors on ``device``; to a card from pinned host
    memory without blocking the host."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


def _token_arrays(toks: Dict[str, np.ndarray]) -> List[np.ndarray]:
    return [toks[key] for key in _TOKEN_KEYS]


def _count_tokens(real: np.ndarray, rows: int, length: int) -> None:
    """The recorder's counters of one text micro-batch: the real tokens
    (``real``: the attention mask of its rows before padding) and the
    token positions the tower computes (padded rows x cut length)."""
    if enabled():
        count("embed.tokens_real", int(real.sum()))
        count("embed.tokens_computed", rows * length)


def _stream(batches, run, device: torch.device,
            rows: Optional[int] = None) -> np.ndarray:
    """Pipelined embed loop: keep ``_IN_FLIGHT`` batches in flight.

    ``batches`` yields ``(host arrays, n_valid)``; ``run`` takes the
    uploaded tensors, and the results' first ``n_valid`` rows are
    concatenated. With ``rows``, ``batches`` yields ``(host arrays,
    index)`` instead, and each result's first ``len(index)`` rows land
    at those rows of a ``[rows, D]`` output as they are read back. On a
    card each result is
    copied into pinned host memory on the compute stream and an event marks
    its arrival; the host waits on the oldest event only when more than
    ``_IN_FLIGHT`` batches are pending."""
    parts: List[np.ndarray] = []
    out = None
    pending = deque()
    cuda = device.type == "cuda"

    def launch(arrays, n):
        with span("embed.launch"):
            emb = run(*_upload(arrays, device)).float()
            if not cuda:
                return emb, None, n
            host = torch.empty(emb.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(emb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done, n

    def drain(host, done, n):
        nonlocal out
        with span("embed.drain"):
            if done is not None:
                done.synchronize()
            got = host.numpy()
            if rows is None:
                parts.append(got[:n].copy())
                return
            if out is None:
                out = np.empty((rows, got.shape[1]), np.float32)
            out[n] = got[:len(n)]

    for arrays, n in batches:
        pending.append(launch(arrays, n))
        if len(pending) > _IN_FLIGHT:
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    if out is not None:
        return out
    return np.concatenate(parts) if parts else np.zeros((0, 0), np.float32)


class TextEmbedder:
    """Tokenizer + any model with ``predict_emb`` on ``device``.

    A call embeds its rows in windows of up to ``_WINDOW`` batches
    (``_windows``). Each window is tokenized at ``max_length`` in row
    order (one tokenizer call a window; a worker thread tokenizes the next
    window while this one's batches run), and its batches go to the tower
    with the original row order restored in the output. How a batch is
    cut:

    * a tower whose ``padding_invariant`` is true (the float BERT towers:
      masked attention, CLS or masked-mean pooling): each distinct text
      once, rows sorted by token length within the window, each batch
      cut to its longest row, so it computes little pad; a repeated text
      takes its first row's vector;
    * ``length_buckets`` (e.g. ``(24, 48)``) on a call of more than one
      batch: the same sort, each batch cut to the smallest bucket that
      fits its longest row (``max_length`` is always the final bucket).
      A ladder bounds how many shapes the tower sees, and it is the only
      way a tower that is not padding-invariant gets short batches (then
      with every row, each window ``_WINDOW`` batches);
    * otherwise (the int8 tower, whose activation scale spans the padded
      batch): rows in order, every batch at ``max_length``.

    Every batch has ``batch_size`` rows, a partial one padded by
    repeating its last row.
    """

    def __init__(self, model: torch.nn.Module, tokenizer: TextTokenizer,
                 max_length: int = 128, batch_size: int = 256,
                 length_buckets: Optional[Sequence[int]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.length_buckets = bucket_ladder(length_buckets, max_length)
        self.padding_invariant = bool(getattr(model, "padding_invariant",
                                              False))
        self.model = model.to(self.device).eval()

    def tower_fn(self, input_ids, attention_mask, token_type_ids):
        """The tower on token tensors, without a mode of its own: the
        engine's fused chain runs it inside inference mode."""
        return self.model.predict_emb(input_ids, attention_mask,
                                      token_type_ids)

    def _run(self, *token_tensors):
        with torch.inference_mode():
            return self.tower_fn(*token_tensors)

    def _inputs(self, texts: Sequence[str], pad_to: int):
        """Tokenize one micro-batch on the host, pad it to ``pad_to`` rows
        by repeating the last, and upload the token tensors: the
        arguments of ``tower_fn``."""
        if not len(texts) <= pad_to <= self.batch_size:
            raise ValueError(f"need len(texts) <= pad_to <= batch_size, "
                             f"got {len(texts)} / {pad_to} / "
                             f"{self.batch_size}")
        toks = _pad_rows(self.tokenizer(list(texts), self.max_length),
                         pad_to)
        return _upload(_token_arrays(toks), self.device)

    def embed_device(self, texts: Sequence[str], pad_to: int = None
                     ) -> torch.Tensor:
        """One micro-batch -> a padded [pad_to, D] tensor still on the
        device (rows past len(texts) are pad outputs the caller discards).
        ``pad_to`` defaults to batch_size; len(texts) <= pad_to <=
        batch_size."""
        pad = self.batch_size if pad_to is None else pad_to
        return self._run(*self._inputs(texts, pad))

    def fused_similar_fn(self, engine, k: int):
        """``(texts, pad_to) -> (scores, indices)`` on the device: the
        serving hot path as one stream-ordered chain (tokenize on the
        host, upload, then tower, normalize and exact top-k through
        ``engine.fused_search_fn``), on the calling thread's current
        stream. None for an empty corpus."""
        run = engine.fused_search_fn(self.tower_fn, k)
        if run is None:
            return None

        def fused(texts, pad_to):
            return run(*self._inputs(texts, pad_to))

        return fused

    def _cut(self, n: int):
        """``need -> width`` for the batches of a call of ``n`` rows,
        where ``need`` is a batch's longest row in tokens; None when
        batches keep the rows in order at ``max_length``."""
        if self.length_buckets and n > self.batch_size:
            return lambda need: next(b for b in self.length_buckets
                                     if b >= need)
        if self.padding_invariant:
            return lambda need: need
        return None

    def _windows(self, n: int) -> List[tuple]:
        """``(start, end)`` rows of each window of a call of ``n`` rows.
        A padding-invariant tower's windows start at ``_FIRST_WINDOW``
        batches and double up to ``_WINDOW``: the device waits only for
        the first, and each later one is tokenized while the one before
        it runs. Another tower's hold ``_WINDOW`` batches each, so a
        ladder groups its rows as the JAX package does."""
        B = self.batch_size
        size = _FIRST_WINDOW if self.padding_invariant else _WINDOW
        out, w0 = [], 0
        while w0 < n:
            out.append((w0, min(w0 + size * B, n)))
            w0, size = out[-1][1], min(2 * size, _WINDOW)
        return out

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        B, n = self.batch_size, len(texts)
        cut = self._cut(n)
        # a padding-invariant tower embeds each distinct text once, and
        # its repeats take that vector: bit for bit the same, whatever
        # width its batch was cut to, so repeats tie in a search
        first: Dict[str, int] = {}
        src = (np.fromiter((first.setdefault(t, i)
                            for i, t in enumerate(texts)), np.int64, n)
               if self.padding_invariant else None)

        def prepare(window):
            """The batches of rows ``window`` = (w0, w1) of ``texts``:
            ``(token arrays, rows)``."""
            w0, w1 = window
            with span("embed.prepare"):
                toks = self.tokenizer(list(texts[w0: w1]), self.max_length)
                mask = toks["attention_mask"]
                L = mask.shape[1]
                # each row's extent: its last real token + 1
                extent = L - np.argmax(mask[:, ::-1] > 0, axis=1)
                order = np.arange(w1 - w0)
                if src is not None:
                    order = order[src[w0: w1] == order + w0]
                if cut is not None:
                    order = order[np.argsort(extent[order], kind="stable")]
                ready = []
                for s in range(0, len(order), B):
                    sel = order[s: s + B]
                    width = L if cut is None else min(
                        cut(int(extent[sel].max())), L)
                    _count_tokens(mask[sel], B, width)
                    ready.append((_token_arrays(_pad_rows(
                        {k: v[sel, :width] for k, v in toks.items()}, B)),
                        w0 + sel))
                return ready

        bounds = self._windows(n)

        def batches(windows):
            for _ in bounds:
                with span("embed.tokenize"):   # the wait for a window
                    ready = next(windows)
                yield from ready

        with ThreadPoolExecutor(max_workers=1) as pool:
            windows = (_bounded_map(pool, prepare, bounds, window=2)
                       if len(bounds) > 1 else map(prepare, bounds))
            out = _stream(batches(windows), self._run, self.device, rows=n)
        if src is not None and len(out):
            repeat = np.flatnonzero(src != np.arange(n))
            out[repeat] = out[src[repeat]]
        return out


class ImageEmbedder:
    """Batched image embedding with optional per-key disk cache and
    multi-image mean, on ``device``.

    ``model`` is a ``CvImageClassifier`` (or anything with an NCHW
    ``predict_emb``); it moves to the device once, in ``channels_last``.
    ``paths_for_key(key) -> [path, ...]`` lists candidate images (the
    reference reads {sku}/0.jpg..7.jpg, daodian_infer.py:266-281); their
    embeddings are averaged. The default cache layout matches the
    reference: one ``emb.txt`` (np.savetxt) next to the images. Passing
    ``cache`` (an ``embcache.EmbeddingCache``) uses the packed store
    instead, and when BOTH are given a cache miss falls back to the
    legacy emb.txt and backfills the packed store.
    """

    def __init__(self, model: torch.nn.Module, image_size: int = 512,
                 batch_size: int = 64,
                 cache_path_for_key: Optional[Callable[[str], str]] = None,
                 cache=None, emb_dim: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        # expected embedding dim for validating legacy emb.txt reads; when
        # absent it is taken from the packed cache (if any) or learned
        # from the first computed embedding
        self.emb_dim = emb_dim or (cache.dim if cache is not None else None)
        self.image_size = image_size
        self.batch_size = batch_size
        self.cache_path_for_key = cache_path_for_key
        self.cache = cache
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()

    def tower_fn(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] on the device -> [B, D]: normalize and
        permute on the device, then the tower. No mode of its own: the
        engine's fused chain runs it inside inference mode."""
        return self.model.predict_emb(to_nchw(device_normalize(images)))

    def _run(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.tower_fn(images)

    def _pad_image_batch(self, images, pad: int) -> np.ndarray:
        """[pad, S, S, 3] host batch: the images, zero-padded to ``pad``
        rows (shared by embed_device and the fused path)."""
        if not 1 <= len(images) <= pad <= self.batch_size:
            raise ValueError(f"need 1 <= len(images) <= pad_to <= "
                             f"batch_size, got {len(images)} / {pad} / "
                             f"{self.batch_size}")
        first = np.asarray(images[0])
        batch = np.zeros((pad,) + first.shape, first.dtype)
        for i, im in enumerate(images):
            batch[i] = im
        return batch

    def _inputs(self, images: Sequence[np.ndarray], pad_to: int):
        """One micro-batch as ``tower_fn``'s argument: the zero-padded
        uint8 batch, uploaded."""
        return _upload([self._pad_image_batch(images, pad_to)], self.device)

    def embed_device(self, images: Sequence[np.ndarray],
                     pad_to: int = None) -> torch.Tensor:
        """One micro-batch of decoded uint8 [S, S, 3] images -> a padded
        [pad_to, D] tensor still on the device (rows past len(images)
        embed zero images and are discarded by the caller)."""
        pad = self.batch_size if pad_to is None else pad_to
        return self._run(*self._inputs(images, pad))

    def fused_similar_fn(self, engine, k: int):
        """``(images, pad_to) -> (scores, indices)`` on the device: upload
        the uint8 batch, then tower, normalize and exact top-k through
        ``engine.fused_search_fn`` on the calling thread's stream (decode
        and resize ran on the HTTP handler, ImageQueryParser). None for
        an empty corpus."""
        run = engine.fused_search_fn(self.tower_fn, k)
        if run is None:
            return None

        def fused(images, pad_to):
            return run(*self._inputs(images, pad_to))

        return fused

    def embed_batch(self, images: np.ndarray) -> np.ndarray:
        B = self.batch_size

        def batches():
            for s in range(0, len(images), B):
                chunk = images[s: s + B]
                n = len(chunk)
                # pad a partial chunk to its pow2 BUCKET, not the full
                # batch_size: padding uploads real bytes, so a 1-image
                # query must not ship a full batch; the bucket ladder
                # keeps the shapes the tower sees to log2(B)
                pad = 1
                while pad < n:
                    pad *= 2
                pad = min(pad, B)
                if n < pad:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], pad - n, axis=0)])
                yield [chunk], n

        return _stream(batches(), self._run, self.device)

    def embed_paths(self, paths: Sequence[str]) -> Dict[str, np.ndarray]:
        """Embed single images; failed decodes are skipped (absent keys)."""
        loaded, keys = [], []
        for p in paths:
            img = I.load_eval(p, self.image_size, normalize_host=False)
            if img is not None:
                loaded.append(img)
                keys.append(p)
        if not loaded:
            return {}
        embs = self.embed_batch(np.stack(loaded))
        return dict(zip(keys, embs))

    def embed_keys(self, keys: Sequence[str],
                   paths_for_key: Callable[[str], Sequence[str]]
                   ) -> Dict[str, np.ndarray]:
        """Multi-image mean embedding per key, with emb.txt caching."""
        result: Dict[str, np.ndarray] = {}
        to_decode: List[str] = []      # keys needing compute
        migrate: Dict[str, np.ndarray] = {}   # legacy emb.txt -> cache
        for key in keys:
            if self.cache is not None:
                hit = self.cache.get(key)
                if hit is not None:
                    result[key] = hit
                    continue
            txt = (self.cache_path_for_key(key)
                   if self.cache_path_for_key else None)
            if txt and os.path.exists(txt):
                # a malformed or wrong-dim emb.txt (older run, different
                # --fc_dim, truncated write) must not kill the job:
                # recompute the key instead
                emb = None
                try:
                    emb = np.loadtxt(txt).astype(np.float32).reshape(-1)
                except (ValueError, OSError):
                    pass
                if emb is not None and (self.emb_dim is None
                                        or emb.shape == (self.emb_dim,)):
                    result[key] = emb
                    if self.cache is not None:   # migrate legacy emb.txt
                        migrate[key] = emb
                else:
                    to_decode.append(key)
            else:
                to_decode.append(key)
        if migrate:
            # ONE flock/append cycle for the whole batch
            self.cache.put_many(migrate)

        def load_key(key):
            loaded = []
            for p in paths_for_key(key):
                if not os.path.exists(p):
                    break  # sequentially-numbered images END at the first
                    # gap (daodian_infer.py:269-280 stops at the first
                    # unreadable {j}.jpg; a folder without 0.jpg yields
                    # nothing and the key is skipped)
                img = I.load_eval(p, self.image_size, normalize_host=False)
                if img is not None:
                    loaded.append(img)
            return key, loaded

        # decode streams INTO the pipelined embed loop: the pool decodes
        # the next keys while the device embeds the current batch
        pending: List[str] = []
        owners: List[str] = []
        B = self.batch_size

        def batches(decoded):
            buf: List[np.ndarray] = []
            for key, loaded in decoded:
                if not loaded:
                    continue
                pending.append(key)
                for img in loaded:
                    buf.append(img)
                    owners.append(key)
                    if len(buf) == B:
                        yield [np.stack(buf)], B
                        buf = []
            if buf:
                n = len(buf)
                pad = np.repeat(buf[-1][None], B - n, axis=0)
                yield [np.concatenate([np.stack(buf), pad])], n

        with ThreadPoolExecutor(max_workers=8) as pool:
            # bounded window: Executor.map would submit every key up front
            # and buffer up to 8 decoded images per key for the whole
            # catalog when decode outpaces the device
            embs = _stream(batches(_bounded_map(pool, load_key, to_decode,
                                                window=32)),
                           self._run, self.device)
        if len(embs):
            sums: Dict[str, np.ndarray] = {}
            counts: Dict[str, int] = {}
            for key, e in zip(owners, embs):
                sums[key] = sums.get(key, 0.0) + e
                counts[key] = counts.get(key, 0) + 1
            fresh: Dict[str, np.ndarray] = {}
            for key in pending:
                emb = (sums[key] / counts[key]).astype(np.float32)
                if self.emb_dim is None:
                    self.emb_dim = int(emb.shape[-1])
                result[key] = emb
                if self.cache is not None:
                    fresh[key] = emb.reshape(-1)
                elif self.cache_path_for_key:
                    txt = self.cache_path_for_key(key)
                    os.makedirs(os.path.dirname(txt), exist_ok=True)
                    np.savetxt(txt, emb)
            if fresh:
                self.cache.put_many(fresh)   # one flock cycle per batch
        return result


class MultimodalEmbedder:
    """(title, uint8 image) pairs + a ``MultimodalClassifier`` on
    ``device``: the fused [B, fc_dim + hidden] embedding, un-normalized
    as a whole (each half is unit-norm)."""

    def __init__(self, model: torch.nn.Module, tokenizer: TextTokenizer,
                 max_length: int = 128, image_size: int = 380,
                 batch_size: int = 48, device="cuda"):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.batch_size = batch_size
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()

    def tower_fn(self, images, input_ids, attention_mask, token_type_ids):
        """Both towers and the norm-concat fusion on device tensors; no
        mode of its own (the fused chain runs it in inference mode)."""
        return self.model.predict_emb(to_nchw(device_normalize(images)),
                                      input_ids, attention_mask,
                                      token_type_ids)

    def _run(self, *tensors):
        with torch.inference_mode():
            return self.tower_fn(*tensors)

    def _pad_pair_batch(self, pairs, pad: int) -> List[np.ndarray]:
        """[images, input_ids, attention_mask, token_type_ids] host arrays
        for a [pad]-row batch from (text, uint8 image) pairs: tokens pad
        by repeating the last row, images with zeros."""
        if not 1 <= len(pairs) <= pad <= self.batch_size:
            raise ValueError(f"need 1 <= len(pairs) <= pad_to <= "
                             f"batch_size, got {len(pairs)} / {pad} / "
                             f"{self.batch_size}")
        texts = [t for t, _ in pairs]
        toks = _pad_rows(self.tokenizer(texts, self.max_length), pad)
        first = np.asarray(pairs[0][1])
        images = np.zeros((pad,) + first.shape, first.dtype)
        for i, (_, im) in enumerate(pairs):
            images[i] = im
        return [images] + _token_arrays(toks)

    def _inputs(self, pairs: Sequence, pad_to: int):
        """One micro-batch as ``tower_fn``'s arguments, uploaded."""
        return _upload(self._pad_pair_batch(list(pairs), pad_to),
                       self.device)

    def embed_device(self, pairs: Sequence, pad_to: int = None
                     ) -> torch.Tensor:
        """One micro-batch of (text, uint8 image) pairs -> a padded
        [pad_to, fc_dim + hidden] tensor still on the device (rows past
        len(pairs) are padding the caller discards)."""
        pad = self.batch_size if pad_to is None else pad_to
        return self._run(*self._inputs(pairs, pad))

    def fused_similar_fn(self, engine, k: int):
        """``(pairs, pad_to) -> (scores, indices)`` on the device: both
        towers, the norm-concat fusion and the exact top-k (un-normalized
        squared L2 in the multimodal engine, multimodal_infer.py:140-145)
        chained on one stream. None for an empty corpus."""
        run = engine.fused_search_fn(self.tower_fn, k)
        if run is None:
            return None

        def fused(pairs, pad_to):
            return run(*self._inputs(pairs, pad_to))

        return fused

    def __call__(self, images: np.ndarray, texts: Sequence[str]
                 ) -> np.ndarray:
        B = self.batch_size

        def batches():
            for s in range(0, len(texts), B):
                chunk_t = list(texts[s: s + B])
                toks = self.tokenizer(chunk_t, self.max_length)
                arrs = _pad_rows({**toks, "images": images[s: s + B]}, B)
                yield [arrs["images"]] + _token_arrays(arrs), len(chunk_t)

        return _stream(batches(), self._run, self.device)
