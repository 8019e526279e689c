#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``multimodalsimilar_tpu_torch/csrc`` with nvcc
   for sm_90a.
2. Phase 1 holds the streaming top-k kernel (``csrc/topk.cu``) against its
   plain PyTorch version on the card, at the text job's shapes: a
   262,144 x 768 f32 corpus, 4,096 queries, k in {13, 26, 101}, ip and l2;
   a ragged corpus, a padded corpus with ``true_n < N`` (including the l2
   pad fill of 1e18, whose square overflows f32), a split-free launch, and
   small-integer data with duplicate rows where every score is exact and
   ties must go to the lowest index. Scores must agree within
   atol=1e-4, rtol=1e-5 (summation order differs); indices must be equal
   wherever the plain version's neighbouring scores differ by more than
   1e-5, and everywhere in the exact-arithmetic tie cases. It times the
   kernel, the plain version and ``torch.topk(q @ x.T)`` (a yardstick the
   port never calls) with CUDA events.
3. Phase 2 runs the text similarity job (``nlp_similar_job``) on 50,000
   synthetic product titles through the full-width ``roberta_wwm_ext``
   tower (12 layers, 768 hidden, vocab 21128; random weights from a seed,
   bf16 inference policy), ``TextEmbedder`` (max_length 128, batch 256),
   the engine's exact top-k (k=13) and the 0.9 threshold into an in-memory
   KV sink. The top-k launch count is set to 0 just before the job and read
   just after; it must have risen. Embeddings must be finite, keys must be
   written, and 512 sampled queries' scores must match the plain version
   on the same device corpus.

Prints the card's name and power limit, one JSON line per phase, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device or when any
check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.ops import _build
from multimodalsimilar_tpu_torch.ops import topk as T
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.pipelines.similar import nlp_similar_job
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

SEED = 0
ATOL, RTOL, GAP = 1e-4, 1e-5, 1e-5
N_CORPUS, N_QUERY, DIM = 262_144, 4_096, 768
N_TITLES = 50_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def unit_rows(rng, n, d, dev):
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    x = x.to(dev)
    return x / x.norm(dim=1, keepdim=True)


def check_case(name, got, want, k, exact=False) -> float:
    """Kernel (got) vs plain (want, computed with k + 1 columns where the
    corpus allows, so the k-th score's gap to the next one is known)."""
    gv, gi = got
    pv, pi = want
    if gv.shape[1] != k or pv.shape[1] < k:
        raise AssertionError(f"{name}: shapes {tuple(gv.shape)} vs "
                             f"{tuple(pv.shape)} at k={k}")
    wv, wi = pv[:, :k], pi[:, :k]
    err = float((gv - wv).abs().max())
    if not torch.isfinite(gv).all():
        raise AssertionError(f"{name}: non-finite kernel scores")
    if not torch.allclose(gv, wv, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{name}: scores differ, max abs err {err}")
    if exact:
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            bad = int((gi != wi).sum())
            raise AssertionError(f"{name}: {bad} indices differ on exact "
                                 f"(tie) data")
        return err
    inf = torch.full((pv.shape[0], 1), float("inf"), device=pv.device)
    d = (pv[:, 1:] - pv[:, :-1]).abs()
    prev = torch.cat([inf, d], 1)[:, :k]
    nxt = torch.cat([d, inf], 1)[:, :k]
    sep = (prev > GAP) & (nxt > GAP)
    bad = int(((gi != wi) & sep).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} indices differ where the "
                             f"neighbouring scores are > {GAP} apart")
    return err


def phase1(dev) -> dict:
    rng = np.random.default_rng(SEED)
    x = unit_rows(rng, N_CORPUS, DIM, dev)
    q = unit_rows(rng, N_QUERY, DIM, dev)
    cases, max_err = [], 0.0

    def run(name, corpus, queries, k, metric, true_n=None, exact=False,
            timed=False):
        nonlocal max_err
        got = T.topk_cuda(corpus, queries, k, metric, true_n)
        want = T.topk_plain(corpus, queries, k + 1, metric, true_n)
        torch.cuda.synchronize()
        if true_n is not None and int(got[1].max()) >= true_n:
            raise AssertionError(f"{name}: a pad row came back")
        max_err = max(max_err, check_case(name, got, want, k, exact))
        row = {"case": name, "q": queries.shape[0], "n": corpus.shape[0],
               "true_n": true_n or corpus.shape[0], "d": queries.shape[1],
               "k": k, "metric": metric}
        if timed:
            row["ms"] = cuda_ms(lambda: T.topk_cuda(corpus, queries, k,
                                                    metric, true_n))
            row["plain_ms"] = cuda_ms(lambda: T.topk_plain(
                corpus, queries, k, metric, true_n), reps=1)
            row["bound_ms"], row["bound_by"] = T.bound_ms(
                queries.shape[0], true_n or corpus.shape[0],
                queries.shape[1], k, metric)
        cases.append(row)
        return row

    main = None
    for metric in ("ip", "l2"):
        for k in (13, 26, 101):
            row = run(f"{metric}_k{k}", x, q, k, metric, timed=True)
            if metric == "ip" and k == 13:
                main = row

    def library():
        for s in range(0, N_QUERY, 1024):
            torch.topk(q[s: s + 1024] @ x.T, 13, dim=1)
    main["library_ms"] = cuda_ms(library)

    ragged = x[: N_CORPUS - 1234]
    run("ragged_ip_k13", ragged, q[:1024], 13, "ip")
    for metric, fill in (("ip", 0.0), ("l2", 1e18)):
        pad = torch.full((1234, DIM), fill, device=dev)
        padded = torch.cat([ragged, pad])
        run(f"padded_{metric}_k101", padded, q[:1024], 101, metric,
            true_n=ragged.shape[0])
    # enough query tiles that the corpus is not split (no merge pass)
    run("unsplit_l2_k26", x[: 32_768 - 100], unit_rows(rng, 20_000, DIM, dev),
        26, "l2")

    ints = torch.from_numpy(rng.integers(-3, 4, size=(N_CORPUS, DIM))
                            .astype(np.float32)).to(dev)
    ints[1000:2000] = ints[0:1000]          # duplicate rows: exact ties
    ints[N_CORPUS - 1] = ints[5]
    qi = torch.cat([ints[:16], torch.from_numpy(
        rng.integers(-3, 4, size=(1008, DIM)).astype(np.float32)).to(dev)])
    for metric in ("ip", "l2"):
        run(f"ties_{metric}_k101", ints, qi, 101, metric, exact=True)
    return {"cases": cases, "main": main, "max_abs_err": max_err}


def make_titles(n: int, rng) -> list:
    """Synthetic product titles: CJK characters and digits, 8-40 chars; one
    in ten is a near-duplicate of an earlier title (a digit changed)."""
    pool = np.array([chr(0x4E00 + i) for i in range(3000)]
                    + list("0123456789"))
    lens = rng.integers(8, 41, size=n)
    titles = ["".join(pool[rng.integers(0, len(pool), size=m)])
              for m in lens]
    for i in range(n // 10, n, 10):
        src = titles[int(rng.integers(0, i))]
        titles[i] = src[:-1] + str(int(rng.integers(0, 10)))
    return titles


def phase2(dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    titles = make_titles(N_TITLES, rng)
    keys = [f"spu{i:06d}" for i in range(N_TITLES)]
    tok = TextTokenizer.from_corpus(titles)
    config = BertConfig.roberta_wwm_ext()
    model = NlpTextClassifier(config, policy=DTypePolicy.inference(),
                              generator=torch.Generator().manual_seed(SEED))
    embedder = TextEmbedder(model, tok, max_length=128, batch_size=256,
                            device=dev)
    embedder(titles[:512])                       # warm-up, not timed
    torch.cuda.synchronize()
    seen = {}

    def embed(texts):
        t0 = time.perf_counter()
        seen["emb"] = embedder(texts)
        seen["embed_s"] = time.perf_counter() - t0
        return seen["emb"]

    sink = InMemoryKVSink()
    T.LAUNCHES["topk"] = 0
    t0 = time.perf_counter()
    written = nlp_similar_job({"spu_name": titles, "spu_sn": keys}, embed,
                              sink, k=13, score_th=0.9, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = T.LAUNCHES["topk"]
    if launches < 1:
        raise AssertionError("the job never launched the top-k kernel")

    emb = seen["emb"]
    if emb.shape != (N_TITLES, config.hidden_size):
        raise AssertionError(f"embeddings shape {emb.shape}")
    if not np.isfinite(emb).all():
        raise AssertionError("non-finite embeddings")
    if written <= 0:
        raise AssertionError("the job wrote no keys")
    known = set(keys)
    for key in sink.keys()[:2000]:
        spu = key.removeprefix("dj_similar:")
        nbrs = sink.get(key).split(",")
        if spu not in known or spu in nbrs or not set(nbrs) <= known \
                or len(nbrs) > 12:
            raise AssertionError(f"bad KV item {key} -> {nbrs[:5]}")

    engine = SimilarityEngine(emb, keys, device=dev)
    t0 = time.perf_counter()
    scores, _ = engine.search(13)
    search_s = time.perf_counter() - t0
    corpus_dev, true_n, _ = engine._corpus_dev
    rows = np.sort(rng.choice(N_TITLES, size=512, replace=False))
    qd = torch.from_numpy(engine._emb[rows]).to(dev)
    pv, _ = T.topk_plain(corpus_dev, qd, 13, "ip", true_n)
    got = torch.from_numpy(scores[rows]).to(dev)
    if not torch.allclose(got, pv, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"engine scores differ from the plain version: "
                             f"{float((got - pv).abs().max())}")
    return {"titles": N_TITLES, "written": written, "topk_launches": launches,
            "embeddings_per_s": N_TITLES / seen["embed_s"],
            "embed_s": seen["embed_s"], "search_s": search_s,
            "job_wall_s": wall, "tokenizer_backend": tok.backend,
            "sample_max_abs_err": float((got - pv).abs().max()),
            "config": "roberta_wwm_ext", "policy": "inference (bf16)"}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    names = _build.build_all()
    print(json.dumps({"built": names,
                      "build_s": time.perf_counter() - t0}), flush=True)
    for name, log in _build.build_logs.items():
        print(f"[nvcc {name}]\n{log.strip()}", flush=True)

    p1 = phase1(dev)
    print(json.dumps({"phase1": p1["cases"]}), flush=True)
    p2 = phase2(dev)
    print(json.dumps({"phase2": p2}), flush=True)
    m = p1["main"]
    kernel = {"name": "topk", "route": "cuda",
              "source": "multimodalsimilar_tpu_torch/csrc/topk.cu",
              "replaces": "multimodalsimilar_tpu/ops/topk.py:56",
              "launches": p2["topk_launches"],
              "max_abs_err": p1["max_abs_err"],
              "ms": m["ms"], "kernel_ms": m["ms"], "plain_ms": m["plain_ms"],
              "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
              "library_ms": m["library_ms"],
              "shape": {k: m[k] for k in ("q", "n", "d", "k", "metric")}}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
