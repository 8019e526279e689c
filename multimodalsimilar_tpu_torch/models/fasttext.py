"""fastText-style supervised n-gram bag model, in PyTorch.

Counterpart of ``multimodalsimilar_tpu/models/fasttext.py``. The reference
trains ``fasttext.train_supervised(lr=0.1, dim=100, epoch=5,
word_ngrams=2, loss='softmax')`` (fasttext_train.py:4-6) and serves its
``get_sentence_vector`` as the cheap text tower of the daodian job
(daodian_infer.py:214,352):

* vocabulary = corpus words + hashed word-bigram buckets (fastText's FNV-1a
  over sign-extended UTF-8 bytes and the ``h1 * 116049371 + h2`` uint64
  bigram combination); the JAX module imports JAX, so the vocabulary code
  is the port's own copy of it, id for id;
* model = embedding-bag mean over token ids -> linear softmax head;
* ``FastTextClassifier.get_sentence_vector`` = the supervised model's plain
  mean of input rows (``hidden_mean``); ``sentence_vector`` = the
  unsupervised branch, the mean of unit token vectors;
* ``train_supervised`` = minibatch SGD with fastText's linear LR decay and
  a SPARSE update: the gradient of the gathered rows is scatter-added into
  the table with ``index_add_``, so a step moves only the batch's rows.

The JAX package pads inference batches to a pow2 bucket so that its jitted
programs compile once per bucket; the port runs eagerly and compiles
nothing per shape, so it does without the bucket. ``chain_steps`` (the TPU
relay's several-steps-per-dispatch scan) is accepted and has no effect.

Models are saved in the port's own format (``save`` / ``load``, a
``torch.save`` of plain tensors and lists): a JAX pickle unpickles JAX
classes. ``models/convert.py:fasttext_from_jax`` carries JAX weights over.

Capability parity, not bit parity, with the reference (fastText's hogwild
SGD is nondeterministic); parity with the JAX package: the same vocab ids,
the same sentence vectors on the same weights, the same training
trajectory from the same initial weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalsimilar_tpu_torch.utils.devices import resolve_device

EOS = "</s>"
SAVE_FORMAT = "multimodalsimilar_tpu_torch.fasttext/1"
_EMBED_ROWS = 8192     # rows per gather in the inference helpers


def _fnv1a(s: str) -> int:
    """fastText's FNV-1a: XORs each UTF-8 byte SIGN-EXTENDED to uint32
    (dictionary.cc hash() does ``uint32_t(int8_t(c))``) — bytes >= 0x80,
    i.e. every byte of a Chinese character, get the 0xFFFFFF00 high bits.
    Plain zero-extension diverges from fastText on all non-ASCII words."""
    h = 2166136261
    for b in s.encode("utf-8"):
        if b >= 0x80:
            b |= 0xFFFFFF00
        h = (h ^ b) * 16777619 & 0xFFFFFFFF
    return h


def _bigram_bucket(h1: int, h2: int, bucket: int) -> int:
    """fastText addWordNgrams: the uint32 hashes are stored as int32 and
    sign-extended to uint64 before ``h*116049371 + h2`` (dictionary.cc)."""

    def as_u64(h):                     # uint64(int32(h))
        return h | 0xFFFFFFFF00000000 if h >= 0x80000000 else h

    h = (as_u64(h1) * 116049371 + as_u64(h2)) & 0xFFFFFFFFFFFFFFFF
    return h % bucket


@dataclasses.dataclass
class FastTextVocab:
    words: Dict[str, int]
    bucket: int
    min_count: int = 1

    @classmethod
    def build(cls, corpus: Iterable[str], bucket: int = 200_000,
              min_count: int = 1) -> "FastTextVocab":
        counts: Dict[str, int] = {}
        for line in corpus:
            for w in line.split():
                counts[w] = counts.get(w, 0) + 1
        counts[EOS] = 10**9
        words = {w: i for i, (w, c) in enumerate(
            sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))
            if c >= min_count}
        return cls(words, bucket, min_count)

    @property
    def nwords(self) -> int:
        return len(self.words)

    @property
    def size(self) -> int:
        return self.nwords + self.bucket

    def line_ids(self, line: str, word_ngrams: int = 2) -> List[int]:
        """Token ids for a line: known words (+EOS) and hashed bigrams."""
        toks = line.split() + [EOS]
        ids = [self.words[t] for t in toks if t in self.words]
        if word_ngrams >= 2:
            hashes = [_fnv1a(t) for t in toks]
            for i in range(len(toks) - 1):
                h = _bigram_bucket(hashes[i], hashes[i + 1], self.bucket)
                ids.append(self.nwords + h)
        return ids

    def _native_encoder(self):
        """The native packer (native/fastpack.cpp), built once per vocab;
        None where the host cannot build it."""
        if "_native" not in self.__dict__:
            from multimodalsimilar_tpu_torch.native import NativeFtEncoder
            try:
                enc = NativeFtEncoder(self.words, self.bucket, self.nwords)
            except RuntimeError:
                enc = None
            self.__dict__["_native"] = enc
        return self.__dict__["_native"]

    def encode_batch(self, lines: Sequence[str], max_tokens: int = 64,
                     word_ngrams: int = 2) -> Tuple[np.ndarray, np.ndarray]:
        """Static [B, max_tokens] id matrix + mask (pad id 0, masked out),
        through the native packer when it builds, else the Python path
        below; both give the same output."""
        native = self._native_encoder()
        if native is not None:
            # the C splitter knows ASCII space classes only, str.split()
            # (used at vocab build) all of str.isspace(): normalize first
            lines = [" ".join(str(l).split()) for l in lines]
            return native.encode_batch(lines, max_tokens, word_ngrams)
        ids = np.zeros((len(lines), max_tokens), np.int32)
        mask = np.zeros((len(lines), max_tokens), np.float32)
        for b, line in enumerate(lines):
            li = self.line_ids(line, word_ngrams)[:max_tokens]
            ids[b, : len(li)] = li
            mask[b, : len(li)] = 1.0
        return ids, mask


def init_params(generator: torch.Generator, vocab_size: int, dim: int,
                num_labels: int, device="cpu") -> Dict[str, torch.Tensor]:
    """fastText init: input uniform(-1/dim, 1/dim), output zeros; drawn
    on the host from ``generator``, then moved to ``device``."""
    inp = torch.empty((vocab_size, dim), dtype=torch.float32)
    inp.uniform_(-1.0 / dim, 1.0 / dim, generator=generator)
    return {"input": inp.to(device),
            "output": torch.zeros((num_labels, dim), dtype=torch.float32,
                                  device=device)}


def hidden_mean(params: Dict[str, torch.Tensor], ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Embedding-bag mean over valid tokens: [B, dim]."""
    vecs = params["input"][ids]                     # [B, L, D] gather
    total = torch.sum(vecs * mask[:, :, None], dim=1)
    return total / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


def logits_fn(params: Dict[str, torch.Tensor], ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    return hidden_mean(params, ids, mask) @ params["output"].T


def sentence_vector(params: Dict[str, torch.Tensor], ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """fastText getSentenceVector's UNSUPERVISED branch: average of
    per-token vectors, each divided by its L2 norm. The serving path uses
    a SUPERVISED model, whose getSentenceVector is ``hidden_mean``
    (FastTextClassifier.get_sentence_vector)."""
    vecs = params["input"][ids]
    norm = torch.sqrt(torch.sum(torch.square(vecs), -1, keepdim=True))
    unit = torch.where(norm > 0, vecs / torch.clamp(norm, min=1e-12),
                       torch.zeros((), dtype=vecs.dtype, device=vecs.device))
    total = torch.sum(unit * mask[:, :, None], dim=1)
    return total / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


def _plain_labels(labels: Sequence) -> list:
    """Labels as plain Python values (numpy scalars become ints/floats),
    so a saved model loads with ``torch.load(weights_only=True)``."""
    return [l.item() if isinstance(l, np.generic) else l for l in labels]


@dataclasses.dataclass
class FastTextClassifier:
    """Trained supervised model bundle (vocab + params + label list);
    ``params`` live on ``device``."""

    vocab: FastTextVocab
    params: Dict[str, torch.Tensor]
    labels: List
    dim: int
    word_ngrams: int = 2
    max_tokens: int = 64
    device: torch.device = torch.device("cuda")
    train_losses: Optional[np.ndarray] = None   # per step, when trained

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in self.params.items()}

    def _encode(self, texts: Sequence[str]):
        ids, mask = self.vocab.encode_batch(list(texts), self.max_tokens,
                                            self.word_ngrams)
        return (torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device))

    def _rows(self, fn, texts: Sequence[str], width: int) -> np.ndarray:
        out = np.empty((len(texts), width), np.float32)
        with torch.inference_mode():
            for s in range(0, len(texts), _EMBED_ROWS):
                ids, mask = self._encode(texts[s: s + _EMBED_ROWS])
                out[s: s + len(ids)] = fn(self.params, ids,
                                          mask).cpu().numpy()
        return out

    def predict(self, texts: Sequence[str]) -> np.ndarray:
        if not len(texts):
            return np.zeros((0,), np.int64)
        return self._rows(logits_fn, texts, len(self.labels)).argmax(-1)

    def predict_labels(self, texts: Sequence[str]) -> List:
        return [self.labels[i] for i in self.predict(texts)]

    def get_sentence_vector(self, texts: Sequence[str]) -> np.ndarray:
        """Supervised-model getSentenceVector = plain mean of input rows
        (words + bigram buckets), NO per-token normalization — fastText's
        fasttext.cc takes this branch for model==sup, the model the
        serving path loads (daodian_infer.py:214,352)."""
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        return self._rows(hidden_mean, texts, self.dim)

    def test(self, texts: Sequence[str], labels: Sequence
             ) -> Tuple[int, float, float]:
        """(N, precision@1, recall@1) like fastText's classifier.test
        (fasttext_train.py:8-17)."""
        pred = self.predict_labels(texts)
        correct = sum(p == l for p, l in zip(pred, labels))
        acc = correct / max(len(labels), 1)
        return len(labels), acc, acc

    def save(self, path: str) -> None:
        torch.save({"format": SAVE_FORMAT,
                    "words": dict(self.vocab.words),
                    "bucket": int(self.vocab.bucket),
                    "min_count": int(self.vocab.min_count),
                    "input": self.params["input"].cpu(),
                    "output": self.params["output"].cpu(),
                    "labels": _plain_labels(self.labels),
                    "dim": int(self.dim),
                    "word_ngrams": int(self.word_ngrams),
                    "max_tokens": int(self.max_tokens)}, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "FastTextClassifier":
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict) or state.get("format") != SAVE_FORMAT:
            raise ValueError(f"{path} is not a fastText model saved by "
                             f"the port (format {SAVE_FORMAT!r})")
        vocab = FastTextVocab(state["words"], state["bucket"],
                              state["min_count"])
        return cls(vocab, {"input": state["input"],
                           "output": state["output"]}, state["labels"],
                   state["dim"], state["word_ngrams"], state["max_tokens"],
                   device=device)


def train_supervised(texts: Sequence[str], labels: Sequence,
                     dim: int = 100, lr: float = 0.1, epochs: int = 5,
                     word_ngrams: int = 2, bucket: int = 200_000,
                     batch_size: int = 256, max_tokens: int = 64,
                     min_count: int = 1, seed: int = 0,
                     chain_steps: int = 1, device="cuda"
                     ) -> FastTextClassifier:
    """Supervised training with fastText's linearly-decaying LR, on
    ``device``: the JAX package's steps in its order (``lr`` to 0 over
    ``epochs * steps_per_epoch``, ``np.random.default_rng(seed)``
    permutations, the last partial batch of an epoch skipped), each a
    softmax cross-entropy over the bag means whose gathered rows'
    gradients are scatter-added into the table (``index_add_``, in place).
    Initial weights come from ``init_params(torch.Generator().manual_seed(
    seed), ...)``. The per-step losses land in ``train_losses``, read
    back once at the end. ``chain_steps`` has no effect (see the module
    docstring)."""
    del chain_steps
    dev = resolve_device(device)
    vocab = FastTextVocab.build(texts, bucket, min_count)
    label_list = sorted(set(labels))
    label_idx = {l: i for i, l in enumerate(label_list)}
    y = torch.as_tensor(np.asarray([label_idx[l] for l in labels],
                                   np.int64), device=dev)
    ids_np, mask_np = vocab.encode_batch(list(texts), max_tokens,
                                         word_ngrams)
    ids = torch.from_numpy(ids_np).to(dev, torch.long)
    mask = torch.from_numpy(mask_np).to(dev)
    params = init_params(torch.Generator().manual_seed(seed), vocab.size,
                         dim, len(label_list), device=dev)
    inp, out = params["input"], params["output"]
    n = len(texts)
    steps_per_epoch = max(n // batch_size, 1)
    total = epochs * steps_per_epoch
    rng = np.random.default_rng(seed)
    losses = []
    i = 0
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(steps_per_epoch):
            sel = order[s * batch_size:(s + 1) * batch_size]
            if len(sel) == 0:
                continue
            # optax.linear_schedule(lr, 0, total) at step i
            lr_t = lr * (1.0 - min(i, total) / total)
            bi, bm, by = ids[sel], mask[sel], y[sel]
            rows = inp[bi].requires_grad_(True)           # [B, L, D]
            out_p = out.detach().requires_grad_(True)
            h = torch.sum(rows * bm[:, :, None], dim=1) / torch.clamp(
                bm.sum(dim=1, keepdim=True), min=1.0)
            loss = torch.nn.functional.cross_entropy(h @ out_p.T, by)
            g_rows, g_out = torch.autograd.grad(loss, (rows, out_p))
            with torch.no_grad():
                inp.index_add_(0, bi.reshape(-1),
                               (-lr_t * g_rows).reshape(-1, dim))
                out.sub_(lr_t * g_out)
            losses.append(loss.detach())
            i += 1
    train_losses = (torch.stack(losses).cpu().numpy() if losses
                    else np.zeros((0,), np.float32))
    return FastTextClassifier(vocab, {"input": inp, "output": out},
                              label_list, dim, word_ngrams, max_tokens,
                              device=dev, train_losses=train_losses)
