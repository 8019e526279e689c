"""The nightly ``similar nlp`` job, back to back over fresh catalogs.

Set-up draws the text tower's weights on the device from the seed
(``benchlib/weights.py``), builds ``NlpTextClassifier`` on the ``meta``
device and loads them, wraps it in ``TextEmbedder`` at the recipe's
``max_length`` and batch, and runs one whole job on a catalog of its own
(a catalog of ``warmup_rows`` titles: the one [batch, max_length] tower
call the window uses, the search kernel, the filters and the sink). The window runs
``pipelines/similar.py:nlp_similar_job`` on catalog after catalog, each
drawn from (seed, job index), through the benchmark's embed callable and
its own in-memory KV sink; the job in progress when ``--seconds`` is up
finishes and counts. ``job_rows_per_s`` is every row of those jobs over
the wall time from the window's start to the last job's end.

Afterwards, with the program's state freed, the plain reference
(``reference/bert.py``, ``reference/search.py``, float32 with TF32 off)
embeds the whole catalog of one job drawn from the seed itself and
judges every neighbour list the sink received in that job against the
exact float64 search of those embeddings, with the job's filters. It
also judges a sample of each job's rows drawn from the seed, the longest
titles in it: the token ids the embedder was handed, the embeddings the
job searched, and, stage by stage, the lists against the exact float64
search of the job's own embeddings (which alone sees a search that
rounds more than the program's).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchlib import flops, gen, peaks
from benchlib.trace import DeviceTrace, Spans
from benchlib.weights import draw
from reference import bert as ref_bert
from reference import search as ref_search

CATALOG, WARMUP, SAMPLE, WHOLE = 1, 2, 3, 4       # rng_for purposes


class Recorder:
    """The program's tokenizer, keeping each call's token ids (a
    reference to the array it returns; nothing is copied)."""

    def __init__(self, inner):
        self.inner = inner
        self.ids = []

    def __call__(self, texts, max_length=128):
        out = self.inner(texts, max_length)
        self.ids.append(out["input_ids"])
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Sink:
    """An in-memory KV sink (the ``KVSink`` interface: ``set_many``,
    ``get``), its writes timed as the ``sink`` span."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.items = {}
        self.ttl = None

    def set_many(self, items, ttl_seconds=None):
        with self.spans.span("sink"):
            self.items.update(items)
            self.ttl = ttl_seconds

    def get(self, key):
        return self.items.get(key)


def bert_config(model: dict):
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    return BertConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        num_layers=model["num_hidden_layers"],
        num_heads=model["num_attention_heads"],
        intermediate_size=model["intermediate_size"],
        max_position_embeddings=model["max_position_embeddings"],
        type_vocab_size=model["type_vocab_size"],
        layer_norm_eps=model["layer_norm_eps"],
        hidden_dropout=model["hidden_dropout_prob"],
        attention_dropout=model["attention_probs_dropout_prob"])


def catalog(traffic: dict, *seed_parts, rows: int = None) -> tuple:
    """(titles, keys) of one catalog (of the traffic's rows unless
    ``rows`` is given)."""
    rng = gen.rng_for(*seed_parts)
    lo, hi = traffic["title_len"]
    titles = gen.make_titles(rows or traffic["rows"], rng, lo, hi,
                             traffic["dup_every"])
    return titles, [f"spu{i:06d}" for i in range(len(titles))]


class ControlEmbedder:
    """The reference with fp8 products (``reference/bert.py:fp8``) in the
    embedder's place: the comparison's control."""

    def __init__(self, params, cfg, tokens, recipe, tok, device):
        self.params, self.cfg, self.tokens = params, cfg, tokens
        self.recipe, self.tok, self.device = recipe, tok, device

    def __call__(self, texts):
        ids, _ = ref_bert.tokenize(texts, self.tokens,
                                   self.recipe["max_length"])
        self.tok.ids.append(ids)
        return ref_bert.embed(self.params, self.cfg, texts, self.tokens,
                              self.recipe["max_length"], self.device,
                              self.recipe["batch_size"], quant="fp8")


def build(cell, opts, tokens):
    """The program's embedder over seed weights; as the comparison's
    control, the reference with fp8 products (``fp8``) in its place
    (``tf32_search`` replaces the search instead, in ``run``)."""
    import torch
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    model_cfg, recipe = cell.config, cell.config["recipe"]
    policy = DTypePolicy.inference()
    if opts.full_precision:
        policy = DTypePolicy.full_precision()
    weights = ref_bert.finish(draw(ref_bert.param_specs(model_cfg),
                                   opts.seed, opts.device))
    with torch.device("meta"):
        model = NlpTextClassifier(bert_config(model_cfg), policy=policy,
                                  num_labels=2)
    state = {"tower.encoder." + k: v for k, v in weights.items()}
    state["head.weight"] = torch.zeros(2, model_cfg["hidden_size"],
                                       device=opts.device)
    model.load_state_dict(state, assign=True, strict=True)
    tok = Recorder(TextTokenizer.from_vocab(tokens))
    if opts.control == "fp8":
        return ControlEmbedder(weights, model_cfg, tokens, recipe, tok,
                               opts.device), tok
    if opts.control not in (None, "tf32_search"):
        raise ValueError(f"unknown control {opts.control!r}")
    return TextEmbedder(model, tok, recipe["max_length"],
                        recipe["batch_size"], device=opts.device), tok


def run(cell, opts) -> dict:
    import torch
    from multimodalsimilar_tpu_torch.pipelines import similar as S

    recipe, traffic = cell.config["recipe"], cell.traffic
    cuda = opts.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans(opts.trace)
    tokens = ref_bert.vocab(gen.TITLE_POOL)
    opts.log("set-up: program imported")
    embedder, tok = build(cell, opts, tokens)
    opts.log("set-up: embedder built")
    current = {}

    def embed(texts):
        with spans.span("embed"):
            out = np.asarray(embedder(list(texts)))
        current["emb"] = out
        return out

    def job(titles, keys):
        sink = Sink(spans)
        tok.ids.clear()
        with spans.span("job"):
            S.nlp_similar_job({recipe["text_col"]: titles,
                               recipe["key_col"]: keys}, embed, sink,
                              text_col=recipe["text_col"],
                              key_col=recipe["key_col"], k=recipe["k"],
                              score_th=recipe["score_th"],
                              ttl_seconds=recipe["exp_seconds"],
                              device=opts.device)
            sync()
        return sink

    job(*catalog(traffic, opts.seed, WARMUP, rows=traffic["warmup_rows"]))
    opts.log("set-up: warm-up job run")
    ahead = int(traffic["catalogs_ahead"])
    catalogs = [catalog(traffic, opts.seed, CATALOG, j)
                for j in range(ahead)]
    opts.log(f"set-up: {ahead} catalogs drawn; window opens")
    undo = _plant(opts.fault, embedder, S) if opts.fault else None
    if opts.control == "tf32_search":
        undo = _control_search(S, current, opts.device)
    sync()
    trace = DeviceTrace() if opts.trace else None
    if trace:
        trace.start()
    jobs = []
    t0 = time.perf_counter()
    with spans.span("window"):
        while True:
            j = len(jobs)
            titles, keys = (catalogs[j] if j < len(catalogs)
                            else catalog(traffic, opts.seed, CATALOG, j))
            sink = job(titles, keys)
            jobs.append({"titles": titles, "keys": keys,
                         "emb": current["emb"], "items": sink.items,
                         "ids": np.concatenate(tok.ids),
                         "end": time.perf_counter()})
            jobs[-1]["start"] = jobs[-2]["end"] if j else t0
            if jobs[-1]["end"] - t0 >= opts.seconds:
                break
    window_s = jobs[-1]["end"] - t0
    if trace:
        trace.stop()
    if undo:
        undo()
    memory_peak = torch.cuda.max_memory_allocated(opts.device) if cuda \
        else 0
    rows = sum(len(jb["titles"]) for jb in jobs)

    del embedder, tok, current
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    opts.log(f"window closed after {len(jobs)} jobs of " + ", ".join(
        f"{jb['end'] - jb['start']:.3f}" for jb in jobs) + " s")
    checks = judge(cell, opts, jobs, tokens)
    opts.log("reference compared")

    model = cell.config
    token_counts = [flops.title_tokens(t, recipe["max_length"])
                    for jb in jobs for t in jb["titles"]]
    n, dim, k = traffic["rows"], model["hidden_size"], recipe["k"]
    obs = {
        "window_s": window_s,
        "embed_s": spans.total("embed", t0),
        "job_s": spans.total("job", t0),
        "jobs": len(jobs),
        "model_flops": flops.bert_job_flops(
            token_counts, dim, model["num_hidden_layers"],
            model["intermediate_size"])
        + len(jobs) * flops.topk_flops(n, n, dim),
        "topk_bound_s": len(jobs) * peaks.roofline_s(
            flops.topk_flops(n, n, dim), flops.topk_bytes(n, n, dim, k)),
    }
    if trace:
        obs["device"] = trace.summary(spans)
    return {"e2e": {"job_rows_per_s": rows / window_s,
                    "setup_s": t0 - opts.t_start},
            "attempted": rows, "failed": 0, "checks": checks,
            "memory_peak_bytes": memory_peak, "obs": obs}


def _control_search(S, current, device):
    """The reference's search with TF32 products in the engine's place
    (the comparison's control for the neighbour lists), over the rows the
    embed callable returned. Returns what undoes it."""
    engine = S.SimilarityEngine
    search = engine.search

    def control(self, k, queries=None):
        if queries is not None:
            return search(self, k, queries)
        return ref_search.search_tf32(current["emb"], k, device)

    engine.search = control
    return lambda: setattr(engine, "search", search)


def _plant(fault: str, embedder, S):
    """A fault for calibration: ``answer`` writes the catalog's first key
    in place of each list's first neighbour. Returns what undoes it."""
    if fault != "answer":
        raise ValueError(f"unknown fault {fault!r}")
    write = S.write_neighbor_map

    def altered(sink, neighbor_map, ttl_seconds, key_fn):
        first = next(iter(neighbor_map))
        out = {k: ([first] + list(v[1:]) if v and k != first else v)
               for k, v in neighbor_map.items()}
        return write(sink, out, ttl_seconds, key_fn)

    S.write_neighbor_map = altered
    return lambda: setattr(S, "write_neighbor_map", write)


def judge(cell, opts, jobs, tokens) -> list:
    """The reference's numbers: every list of one job drawn from the seed
    against the reference's own embeddings of its catalog, and a sample
    of every job's rows stage by stage."""
    import torch
    model, recipe, traffic = cell.config, cell.config["recipe"], \
        cell.traffic
    limits = model["limits"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = ref_bert.finish(draw(ref_bert.param_specs(model),
                                      opts.seed, opts.device))
        ids_bad, emb_gap, list_gap = 0, 0.0, 0.0
        for j, jb in enumerate(jobs):
            rows = sample_rows(jb["titles"], traffic, opts.seed, j)
            titles = [jb["titles"][i] for i in rows]
            want_ids, _ = ref_bert.tokenize(titles, tokens,
                                            recipe["max_length"])
            ids_bad += int((jb["ids"][rows] != want_ids).any(1).sum())
            ref = ref_bert.embed(params, model, titles, tokens,
                                 recipe["max_length"], opts.device)
            got = jb["emb"][rows]
            emb_gap = max(emb_gap, float(np.max(np.linalg.norm(
                _unit(got) - _unit(ref), axis=1))))
            corpus = ref_search.normalized64(jb["emb"], opts.device)
            scores, order = ref_search.ranked(corpus, rows, recipe["k"])
            key_row = {k: i for i, k in enumerate(jb["keys"])}
            for q, row in enumerate(rows):
                value = jb["items"].get(f"dj_similar:{jb['keys'][row]}")
                written = ref_search.parse_written(value, key_row)
                list_gap = max(list_gap, ref_search.list_gap(
                    scores[q], order[q], row, written, jb["keys"],
                    recipe["score_th"]))
            del corpus
        whole = jobs[int(gen.rng_for(opts.seed, WHOLE).integers(len(jobs)))]
        corpus = ref_search.normalized64(ref_bert.embed(
            params, model, whole["titles"], tokens, recipe["max_length"],
            opts.device, recipe["batch_size"]), opts.device)
        key_row = {k: i for i, k in enumerate(whole["keys"])}
        written = [ref_search.parse_written(
            whole["items"].get(f"dj_similar:{key}"), key_row)
            for key in whole["keys"]]
        whole_gap = ref_search.widest_list_gap(
            corpus, written, whole["keys"], recipe["k"], recipe["score_th"])
        del corpus
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return [{"name": "token_ids_rows_differing", "value": float(ids_bad),
             "limit": 0.0},
            {"name": "embedding_gap", "value": emb_gap,
             "limit": limits["embedding_gap"]},
            {"name": "neighbour_list_gap", "value": list_gap,
             "limit": limits["neighbour_list_gap"]},
            {"name": "reference_list_gap", "value": whole_gap,
             "limit": limits["reference_list_gap"]}]


def _unit(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def sample_rows(titles, traffic: dict, seed: int, job: int) -> list:
    """Rows of one job to judge: a draw from (seed, job) and the longest
    titles."""
    judge_cfg = traffic["judge"]
    rng = gen.rng_for(seed, SAMPLE, job)
    drawn = rng.choice(len(titles), size=min(judge_cfg["rows_per_job"],
                                             len(titles)), replace=False)
    lens = np.fromiter((len(t) for t in titles), np.int64, len(titles))
    longest = np.argsort(-lens, kind="stable")[:judge_cfg["longest_per_job"]]
    return sorted(set(drawn.tolist()) | set(longest.tolist()))
