"""The nightly ``similar nlp`` job with DeepSeek-V2-Lite as its text tower,
back to back over fresh catalogs.

Set-up draws the tower's weights on the device from the seed, one part
at a time as bfloat16 (``reference/deepseek_v2.py:draw``: the whole model
drawn at once in float32 would ask for 62 GB), carries each part over to
the port's layout with the port's importer of the published names
(``models/hf_import.py``), loads them into a ``DeepseekV2Tower`` built on
the ``meta`` device, and wraps it in ``TextEmbedder`` at the recipe's
``max_length`` and batch, with the job's char vocabulary under the
config's BOS token (``TextTokenizer.with_bos``), as ``cli/embedders.py``
builds it for ``--text_tower deepseek_v2_lite``. It then runs one whole
job on a catalog of its own (every batch width the window meets). The
window runs ``pipelines/similar.py:nlp_similar_job`` on catalog after
catalog, as ``drivers/similar_job.py`` does (its embed callable, sink,
catalogs and samples); the job in progress when ``--seconds`` is up
finishes and counts.

Afterwards, with the program's state freed, the plain reference
(``reference/deepseek_v2.py``, float32 with TF32 off) embeds, in one pass
over the layers, a sample of each job's rows drawn from the seed (the
longest titles in it) and the whole catalog of one job drawn from the
seed, and judges them as ``drivers/similar_job.py:judge`` does: the
token ids, the embeddings, the lists against the exact float64 search of
the job's own embeddings, and every list of the whole job against the
exact float64 search of the reference's.

Calibration only: ``--control fp8`` puts the reference with fp8 products
in the embedder's place, ``--control tf32_search`` a TF32 search in the
engine's; ``--fault`` plants ``topk_renormalised`` (the top-6 weights
renormalised), ``no_yarn_mscale`` (YaRN's m^2 left out of the softmax
scale), ``shared_expert_dropped`` (the second shared expert's rows of the
down projection zeroed) or ``answer`` (``drivers/similar_job.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchlib import flops, gen, moe_flops, peaks
from benchlib import program as prog
from benchlib.trace import DeviceTrace, Spans
from drivers import similar_job as base
from reference import bert as ref_bert
from reference import deepseek_v2 as ref
from reference import search as ref_search

FAULTS = ("topk_renormalised", "no_yarn_mscale", "shared_expert_dropped")


def model_config(cell) -> dict:
    """The published keys with the assumed BOS id."""
    return dict(cell.config, bos_token_id=cell.config["assumed"][
        "bos_token_id"])


def weights_fn(cfg: dict, seed: int, device):
    return lambda part: ref.draw(cfg, seed, part, device)


def tower(cfg: dict, seed: int, device):
    """The port's tower on ``device`` holding the seed's weights."""
    import torch
    from multimodalsimilar_tpu_torch.models import hf_import
    from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config, DeepseekV2Tower)
    config = DeepseekV2Config.from_hf(cfg)
    with torch.device("meta"):
        model = DeepseekV2Tower(config)
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    state = {}
    for part in ref.parts(cfg):
        drawn = {"model." + k: v
                 for k, v in ref.draw(cfg, seed, part, device).items()}
        for k, v in hf_import.deepseek_v2_state_from_hf(drawn,
                                                        config).items():
            state[k] = v.to(dtypes[k])
        del drawn
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


def plant(model, fault: str) -> None:
    """A fault in the tower (calibration only)."""
    import torch
    cfg = model.config
    if fault == "topk_renormalised":
        for layer in model.layers[cfg.first_k_dense_replace:]:
            layer.mlp.norm_topk_prob = True
    elif fault == "no_yarn_mscale":
        for layer in model.layers:
            layer.self_attn.softmax_scale = cfg.q_head_dim ** -0.5
    elif fault == "shared_expert_dropped":
        inter = cfg.moe_intermediate_size
        with torch.no_grad():
            for layer in model.layers[cfg.first_k_dense_replace:]:
                layer.mlp.shared_experts.down_proj.weight[:, -inter:] = 0.0
    else:
        raise ValueError(f"unknown fault {fault!r}")


class ControlEmbedder:
    """The reference with fp8 products in the embedder's place."""

    def __init__(self, cfg, tokens, recipe, tok, seed, device, batch):
        self.cfg, self.tokens, self.recipe, self.tok = cfg, tokens, recipe, \
            tok
        self.weights = weights_fn(cfg, seed, device)
        self.device, self.batch = device, batch

    def __call__(self, texts):
        ids, _ = ref.tokenize(texts, self.tokens, self.cfg["bos_token_id"],
                              self.recipe["max_length"])
        self.tok.ids.append(ids)
        return ref.embed_groups(self.weights, self.cfg, [texts],
                                self.tokens, self.cfg["bos_token_id"],
                                self.recipe["max_length"], self.device,
                                self.batch, quant="fp8")[0]


def build(cell, opts, tokens):
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    cfg, recipe = model_config(cell), cell.config["recipe"]
    if opts.full_precision:
        raise ValueError("the DeepSeek-V2 tower holds bfloat16 weights and "
                         "its grouped products take bfloat16 only: no "
                         "full-precision witness")
    tok = base.Recorder(TextTokenizer.from_vocab(tokens).with_bos(
        cfg["bos_token_id"]))
    if opts.control == "fp8":
        return ControlEmbedder(cfg, tokens, recipe, tok, opts.seed,
                               opts.device,
                               cell.traffic["judge"]["reference_batch"]), \
            tok
    if opts.control not in (None, "tf32_search"):
        raise ValueError(f"unknown control {opts.control!r}")
    model = tower(cfg, opts.seed, opts.device)
    if opts.fault in FAULTS:
        plant(model, opts.fault)
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
        sink = base.Sink(spans)
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

    job(*base.catalog(traffic, opts.seed, base.WARMUP,
                      rows=traffic["warmup_rows"]))
    opts.log("set-up: warm-up job run")
    ahead = int(traffic["catalogs_ahead"])
    catalogs = [base.catalog(traffic, opts.seed, base.CATALOG, j)
                for j in range(ahead)]
    opts.log(f"set-up: {ahead} catalogs drawn; window opens")
    undo = None
    if opts.fault == "answer":
        undo = base._plant(opts.fault, embedder, S)
    elif opts.fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {opts.fault!r}")
    if opts.control == "tf32_search":
        undo = base._control_search(S, current, opts.device)
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
                            else base.catalog(traffic, opts.seed,
                                              base.CATALOG, j))
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
    counters = (prog.summary() or {}).get("counters", {}) if trace else {}
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

    cfg = model_config(cell)
    token_counts = [min(len("".join(t.split())) + 1, recipe["max_length"])
                    for jb in jobs for t in jb["titles"]]
    n, dim, k = traffic["rows"], cfg["hidden_size"], recipe["k"]
    obs = {
        "window_s": window_s,
        "embed_s": spans.total("embed", t0),
        "job_s": spans.total("job", t0),
        "jobs": len(jobs),
        "model_flops": moe_flops.job_flops(token_counts, cfg)
        + len(jobs) * flops.topk_flops(n, n, dim),
        "topk_bound_s": len(jobs) * peaks.roofline_s(
            flops.topk_flops(n, n, dim), flops.topk_bytes(n, n, dim, k)),
    }
    if counters.get("moe.launches"):
        routed = counters["moe.rows_routed"]
        obs["expert_bound_s"] = peaks.roofline_s(
            moe_flops.expert_flops(routed, cfg),
            moe_flops.expert_bytes(counters["moe.launches"], routed, cfg))
    if trace:
        obs["device"] = trace.summary(spans)
    return {"e2e": {"job_rows_per_s": rows / window_s,
                    "setup_s": t0 - opts.t_start},
            "attempted": rows, "failed": 0, "checks": checks,
            "memory_peak_bytes": memory_peak, "obs": obs}


def judge(cell, opts, jobs, tokens) -> list:
    """``drivers/similar_job.py:judge``'s numbers, the reference computed
    in one pass over the layers for every job's sample and the whole
    job."""
    import torch
    cfg, recipe, traffic = model_config(cell), cell.config["recipe"], \
        cell.traffic
    limits = cell.config["limits"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        samples = [base.sample_rows(jb["titles"], traffic, opts.seed, j)
                   for j, jb in enumerate(jobs)]
        whole = jobs[int(gen.rng_for(opts.seed, base.WHOLE)
                         .integers(len(jobs)))]
        groups = [[jb["titles"][i] for i in rows]
                  for jb, rows in zip(jobs, samples)] + [whole["titles"]]
        refs = ref.embed_groups(weights_fn(cfg, opts.seed, opts.device),
                                cfg, groups, tokens, cfg["bos_token_id"],
                                recipe["max_length"], opts.device,
                                traffic["judge"]["reference_batch"])
        ids_bad, emb_gap, list_gap = 0, 0.0, 0.0
        for jb, rows, want in zip(jobs, samples, refs):
            want_ids, _ = ref.tokenize([jb["titles"][i] for i in rows],
                                       tokens, cfg["bos_token_id"],
                                       recipe["max_length"])
            ids_bad += int((jb["ids"][rows] != want_ids).any(1).sum())
            emb_gap = max(emb_gap, float(np.max(np.linalg.norm(
                base._unit(jb["emb"][rows]) - base._unit(want), axis=1))))
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
        corpus = ref_search.normalized64(refs[-1], opts.device)
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
