"""Batched text embedder (counterpart of TextEmbedder in
multimodalsimilar_tpu/pipelines/embedders.py).

The reference embeds one row at a time; here the workload streams through
the tower in full batches (the last one padded by repeating its last row),
with three batches in flight: later batches are launched before earlier
results are read back, and read-backs go through pinned host memory, so the
card computes while the host tokenizes. ``fused_similar_fn`` chains the
tower into the engine's search for the serving daemon. The image and
multimodal embedders come with later slices.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.utils.buckets import bucket_ladder
from multimodalsimilar_tpu_torch.utils.devices import resolve_device

_TOKEN_KEYS = ("input_ids", "attention_mask", "token_type_ids")
_IN_FLIGHT = 3   # batches launched ahead of the oldest read-back


def _pad_rows(arrs: Dict[str, np.ndarray], batch: int) -> Dict[str, np.ndarray]:
    n = next(iter(arrs.values())).shape[0]
    if n == batch:
        return arrs
    return {k: np.concatenate(
        [v, np.repeat(v[-1:], batch - n, axis=0)]) for k, v in arrs.items()}


def _upload(toks: Dict[str, np.ndarray], device: torch.device):
    """The token arrays as tensors on ``device``; to a card from pinned
    host memory without blocking the host."""
    out = []
    for key in _TOKEN_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(toks[key]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


def _stream(batches, run, device: torch.device) -> np.ndarray:
    """Pipelined embed loop: keep ``_IN_FLIGHT`` batches in flight.

    ``batches`` yields ``(token dict, n_valid)``. On a card each result is
    copied into pinned host memory on the compute stream and an event marks
    its arrival; the host waits on the oldest event only when more than
    ``_IN_FLIGHT`` batches are pending."""
    out: List[np.ndarray] = []
    pending = deque()
    cuda = device.type == "cuda"

    def launch(toks, n):
        emb = run(*_upload(toks, device)).float()
        if not cuda:
            return emb, None, n
        host = torch.empty(emb.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(emb, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, n

    def drain(host, done, n):
        if done is not None:
            done.synchronize()
        out.append(host.numpy()[:n].copy())

    for toks, n in batches:
        pending.append(launch(toks, n))
        if len(pending) > _IN_FLIGHT:
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


class TextEmbedder:
    """Tokenizer + any model with ``predict_emb`` on ``device``.

    ``length_buckets`` (e.g. ``(24, 48)``) turns on length-bucketed
    batches: rows are sorted by true token length within a window, batched,
    and each batch is trimmed to the smallest bucket that fits its longest
    row (``max_length`` is always the final bucket). Embeddings are
    padding-invariant (masked attention and pooling), so outputs match the
    unbucketed path; the original row order is restored exactly.
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
        self.model = model.to(self.device).eval()

    def tower_fn(self, input_ids, attention_mask, token_type_ids):
        """The tower on token tensors, without a mode of its own: the
        engine's fused chain runs it inside inference mode."""
        return self.model.predict_emb(input_ids, attention_mask,
                                      token_type_ids)

    def _run(self, *token_tensors):
        with torch.inference_mode():
            return self.tower_fn(*token_tensors)

    def _tokens(self, texts: Sequence[str], pad_to: int):
        """Tokenize one micro-batch on the host, pad it to ``pad_to`` rows
        by repeating the last, and upload the token tensors."""
        if not len(texts) <= pad_to <= self.batch_size:
            raise ValueError(f"need len(texts) <= pad_to <= batch_size, "
                             f"got {len(texts)} / {pad_to} / "
                             f"{self.batch_size}")
        toks = _pad_rows(self.tokenizer(list(texts), self.max_length),
                         pad_to)
        return _upload(toks, self.device)

    def embed_device(self, texts: Sequence[str], pad_to: int = None
                     ) -> torch.Tensor:
        """One micro-batch -> a padded [pad_to, D] tensor still on the
        device (rows past len(texts) are pad outputs the caller discards).
        ``pad_to`` defaults to batch_size; len(texts) <= pad_to <=
        batch_size."""
        pad = self.batch_size if pad_to is None else pad_to
        return self._run(*self._tokens(texts, pad))

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
            return run(*self._tokens(texts, pad_to))

        return fused

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if self.length_buckets and len(texts) > self.batch_size:
            return self._call_bucketed(texts)
        B = self.batch_size

        def batches():
            for s in range(0, len(texts), B):
                chunk = list(texts[s: s + B])
                yield (_pad_rows(self.tokenizer(chunk, self.max_length), B),
                       len(chunk))

        return _stream(batches(), self._run, self.device)

    def _call_bucketed(self, texts: Sequence[str]) -> np.ndarray:
        B = self.batch_size
        W = 64 * B                     # sort window: 64 batches at a time
        order_ix: List[np.ndarray] = []

        def batches():
            for w0 in range(0, len(texts), W):
                chunk = list(texts[w0: w0 + W])
                toks = self.tokenizer(chunk, self.max_length)
                lens = toks["attention_mask"].sum(axis=1)
                order = np.argsort(lens, kind="stable")
                for s in range(0, len(order), B):
                    sel = order[s: s + B]
                    need = int(lens[sel].max())
                    bucket = next(b for b in self.length_buckets
                                  if b >= need)
                    order_ix.append(np.asarray(w0 + sel))
                    yield (_pad_rows({k: v[sel][:, :bucket]
                                      for k, v in toks.items()}, B),
                           len(sel))

        embs = _stream(batches(), self._run, self.device)
        if not len(embs):
            return embs
        out = np.empty_like(embs)
        out[np.concatenate(order_ix)] = embs
        return out
