"""Corpus-sharded serving on the CPU: the port's daemons and the daodian
job over two gloo ranks against the JAX package's sharded runs (over
tests/conftest.py's 8 virtual devices, where the JAX engine row-shards
its corpus) and against the port on one process.

The port's ranks are processes (``parallel/spawn.py``, one torch thread
each, a time limit); what they run is in ``tests/torch_parallel_workers.py``,
which imports no JAX. One spawn serves every case, started in the
background while the references compute:

* ``serve --tower bert`` through ``cli.main`` on both ranks: rank 0 warms,
  serves HTTP and answers a script (``/similar`` with a category,
  ``exclude_key``, ``score_th`` and ``k``, ``/embed``, requests refused with
  400, an ``/update`` that appends a key and re-embeds another, the
  ``/similar`` calls that see both, ``/healthz``), then shuts down; rank 1
  follows and returns when rank 0's service closes. The tower is the JAX
  command's seed-0 tiny tower, carried over as a port checkpoint, in
  f32 in all three runs;
* ``serve --tower fasttext`` the same way (the host path: every rank
  embeds every row, the search is sharded);
* l2 over shards at the engine (un-normalized rows, the multimodal
  daemon's metric; pad rows of 1e18 that never win);
* ``similar daodian --text_only`` in v1 and v2 over 2 areas (each rank's
  block of every area searched, rank 0 writes);
* the refusals under 2 ranks: ``serve --tower daodian`` and
  ``--pallas_topk``.

Tolerances: scores within 1e-5 (f32 on both sides); neighbour keys equal
to the port's one process, and to the JAX package's wherever its scores
around them lie more than 1e-5 apart; KV contents exact.
"""

import concurrent.futures
import json
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import multimodalsimilar_tpu.cli as jcli
import torch_parallel_workers as W
from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.cli import serve as jserve
from multimodalsimilar_tpu.cli import similar as jsimilar
from multimodalsimilar_tpu.models import fasttext as JF
from multimodalsimilar_tpu.parallel.mesh import create_mesh as j_mesh
from multimodalsimilar_tpu.pipelines.serving import make_server as j_server
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryKVSink as JInMemoryKVSink)
from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JSimilarityEngine)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    fasttext_from_jax, text_classifier_from_jax)
from multimodalsimilar_tpu_torch.parallel.spawn import spawn
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
TIMEOUT = 150
TOL = 1e-5
N_ROWS = 300        # padded to 512 over 2 ranks: both blocks hold real rows
WORDS = ["苹果", "香蕉", "牛奶", "酸奶", "可乐", "汽水", "面包", "饼干",
         "大米", "面条", "鸡蛋", "橙汁"]
NEW, RE = "苹果香蕉橙汁新品", "可乐可乐饼干"


def _titles(n, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(WORDS, int(rng.integers(2, 5))))
            for _ in range(n)]


def _bert_script(titles):
    q = _titles(3, seed=5)
    return [("/healthz", None),
            ("/similar", {"text": q[0], "score_th": None}),
            ("/similar", {"text": q[1], "category": "1", "score_th": None}),
            ("/similar", {"text": titles[5], "exclude_key": "sku5",
                          "score_th": None}),
            ("/similar", {"text": q[2], "score_th": 0.5, "k": 3}),
            ("/similar", {"text": titles[250]}),
            ("/embed", {"texts": q[:2]}),
            ("/similar", {"text": q[0], "k": "x"}),
            ("/similar", {"category": "1"}),
            ("/update", {"items": []}),
            ("/update", {"items": [{"key": "new0", "text": NEW}]}),
            ("/update", {"items": [
                {"key": "new0", "text": NEW, "category": "2"},
                {"key": "sku3", "text": RE, "category": "0"}]}),
            ("/similar", {"text": NEW, "score_th": None}),
            ("/similar", {"text": RE, "category": "0", "score_th": None}),
            ("/healthz", None)]


REFUSED = (7, 8, 9, 10)        # the script's 400s


def _ft_script():
    return [("/similar", {"text": "苹果 水果 新鲜"}),
            ("/similar", {"text": "牛奶 乳品", "category": 20}),
            ("/similar", {"text": "没有 这个", "score_th": None}),
            ("/update", {"items": [
                {"key": "s_new", "text": "苹果 水果 新鲜 新品",
                 "category": 10},
                {"key": "s1_101_0", "text": "酸奶 乳品 发酵",
                 "category": 20}]}),
            ("/similar", {"text": "苹果 水果 新鲜 新品", "score_th": None}),
            ("/similar", {"text": "酸奶 乳品 发酵", "category": 20}),
            ("/healthz", None)]


CATS = {10: {101: "苹果 水果 新鲜", 102: "香蕉 水果 甜"},
        20: {201: "牛奶 乳品 醇香", 202: "酸奶 乳品 发酵"}}


def _catalog():
    """2 areas of 300 rows on two days: titles of their lv2's words and a
    number, so each lv1 group holds near and exact ties."""
    rng = np.random.default_rng(7)
    rows = []
    for area in (1, 2):
        for k in range(N_ROWS):
            lv1 = (10, 20)[k % 2]
            lv2 = list(CATS[lv1])[(k // 2) % 2]
            rows.append({"area_id": area, "spu_sn": f"s{area}_{lv2}_{k}",
                         "sku": str(1000 + len(rows)),
                         "title": f"{CATS[lv1][lv2]} 商品"
                                  f"{int(rng.integers(0, 40))}号",
                         "first_level_category_id": lv1,
                         "second_level_category_id": lv2,
                         "dt": ["2026-08-16", "2026-08-15"][k % 3 % 2]})
    return pd.DataFrame(rows)


def _l2_case():
    rng = np.random.default_rng(11)
    emb = (3.0 * rng.standard_normal((N_ROWS, 8))).astype(np.float32)
    emb[17] = emb[290]                       # a tie across the blocks
    queries = (3.0 * rng.standard_normal((5, 8))).astype(np.float32)
    queries[0] = emb[290]
    new = (3.0 * rng.standard_normal((3, 8))).astype(np.float32)
    return emb, queries, 9, (new, ["n0", "r5", "n1"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The files every run reads: the text corpus and its vocab, the JAX
    ``serve`` command's seed-0 tiny tower as a port checkpoint, the
    daodian catalog and a JAX fastText model on it (pickled for the JAX
    commands, carried over for the port's)."""
    d = tmp_path_factory.mktemp("sharded_serving")
    titles = _titles(N_ROWS, seed=3)
    pd.DataFrame({"spu_sn": [f"sku{i}" for i in range(N_ROWS)],
                  "spu_name": titles,
                  "lv1": [str(i % 3) for i in range(N_ROWS)]}).to_csv(
        d / "corpus.csv", index=False)
    build_char_vocab(titles + [NEW, RE] + _titles(3, seed=5),
                     out_path=str(d / "vocab.txt"))
    df = _catalog()
    df.to_csv(d / "skus.csv", index=False)
    jft = JF.train_supervised(df["title"].tolist(),
                              df["second_level_category_id"].tolist(),
                              dim=16, epochs=4, bucket=2000, batch_size=64)
    with open(d / "ft.pkl", "wb") as f:
        pickle.dump(jft, f)
    fasttext_from_jax({k: np.asarray(v) for k, v in jft.params.items()},
                      jft.vocab.words, jft.vocab.bucket, jft.labels, jft.dim,
                      jft.word_ngrams, jft.max_tokens,
                      device="cpu").save(str(d / "ft.pt"))
    bert = ["serve", "--data", str(d / "corpus.csv"), "--tokenizer",
            str(d / "vocab.txt"), "--category_col", "lv1", "--k", "6",
            "--max_length", "16", "--batch_size", "8", "--max_batch", "8",
            "--max_wait_ms", "2", "--port", "0"]
    ft = ["serve", "--tower", "fasttext", "--data", str(d / "skus.csv"),
          "--text_col", "title", "--category_col", "first_level_category_id",
          "--k", "100", "--max_batch", "8", "--max_wait_ms", "2", "--port",
          "0"]
    daodian = {
        "v1": ["similar", "daodian", "--config",
               os.path.join(CONFIGS, "similar_daodian_v1.yaml")],
        "v2": ["similar", "daodian", "--config",
               os.path.join(CONFIGS, "similar_daodian_v2_recent_days.yaml"),
               "--dt", "2026-08-16", "--recent_days", "2"]}
    daodian = {v: a + ["--data", str(d / "skus.csv"), "--text_only"]
               for v, a in daodian.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPolicy, "inference",
                   classmethod(lambda cls: cls.full_precision()))
        jsvc, _ = jserve._build_serve_service(build_parser().parse_args(
            bert))
    embedder = jsvc._embed_queries_device.__self__
    CheckpointManager(str(d / "ckpt")).save(0, {"model": text_classifier_from_jax(
        embedder._variables["params"], BertConfig.tiny())})
    return {"dir": d, "titles": titles, "jax_bert": jsvc,
            "bert": bert + ["--checkpoint", str(d / "ckpt")], "ft": ft,
            "daodian": daodian}


def _jax_serve(service, script):
    httpd = j_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        return W.drive(f"http://127.0.0.1:{httpd.server_address[1]}",
                       script)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(10)


def _jax_runs(setup):
    """The JAX package's runs, its engines sharded over 8 devices."""
    d = setup["dir"]
    out = {"bert": _jax_serve(setup["jax_bert"],
                              _bert_script(setup["titles"]))}
    jsvc, _ = jserve._build_serve_service(build_parser().parse_args(
        setup["ft"] + ["--fasttext_model", str(d / "ft.pkl")]))
    assert jsvc.engine.mesh.shape["data"] == 8
    out["ft"] = _jax_serve(jsvc, _ft_script())
    emb, queries, k, update = _l2_case()
    eng = JSimilarityEngine(emb, [f"r{i}" for i in range(len(emb))],
                            metric="l2", normalize=False,
                            mesh=j_mesh(jax.devices(), 8, 1))
    out["l2"] = W.l2_ops(eng, queries, k, update, jnp.asarray)
    for variant, argv in setup["daodian"].items():
        sink = JInMemoryKVSink()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jsimilar, "_kv_sink", lambda args: sink)
            jcli.main(argv + ["--fasttext_model", str(d / "ft.pkl")])
        out[variant] = {k: v for k, (v, _) in sink.data.items()}
    return out


@pytest.fixture(scope="module")
def runs(setup):
    """{"two": each job's [rank 0, rank 1] results, "one": the port on
    one process, "jax": the JAX package's}."""
    d = setup["dir"]
    ft = setup["ft"] + ["--fasttext_model", str(d / "ft.pt")]
    daodian = {v: a + ["--fasttext_model", str(d / "ft.pt")]
               for v, a in setup["daodian"].items()}
    jobs = {"bert": ("serve_cli", (setup["bert"],
                                   _bert_script(setup["titles"]))),
            "ft": ("serve_cli", (ft, _ft_script())),
            "l2": ("lockstep_l2", _l2_case()),
            "v1": ("similar_daodian", (daodian["v1"],)),
            "v2": ("similar_daodian", (daodian["v2"],))}
    jobs.update({f"blocks_{n}": ("embed_blocks", (n, 3)) for n in (1, 7)})
    jobs["bert_mp"] = ("serve_cli", (setup["bert"],
                                     _bert_script(setup["titles"])[:7], 2))
    refusals = {"daodian": ["serve", "--tower", "daodian", "--data",
                            str(d / "skus.csv"), "--text_only"] + ft[-2:],
                "pallas": setup["bert"] + ["--pallas_topk"]}
    spawned = list(jobs.values()) + [("refused", (a,))
                                     for a in refusals.values()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(spawn, W.run, 2, (spawned,), timeout=TIMEOUT)
        jax_out = _jax_runs(setup)
        alone = {name: job for name, job in jobs.items()
                 if name != "bert_mp"}     # model 2 needs two ranks
        one = dict(zip(alone, W.run(list(alone.values()))))
        ranks = two.result()
    names = list(jobs) + [f"refused_{r}" for r in refusals]
    return {"two": {name: [r[i] for r in ranks]
                    for i, name in enumerate(names)},
            "one": one, "jax": jax_out}


def _same_neighbors(got, want, exact_keys):
    """Scores within TOL; keys equal, or with ``exact_keys=False`` equal
    wherever ``want``'s scores around them lie more than TOL apart."""
    assert len(got) == len(want), (got, want)
    ws = np.array([w["score"] for w in want])
    np.testing.assert_allclose([g["score"] for g in got], ws, atol=TOL,
                               rtol=0)
    if exact_keys:
        assert [g["key"] for g in got] == [w["key"] for w in want]
        return
    gaps = np.abs(np.diff(ws))
    for i in range(len(want) - 1):
        if (i == 0 or gaps[i - 1] > TOL) and gaps[i] > TOL:
            assert got[i]["key"] == want[i]["key"], (i, got, want)


def _same_replies(got, want, exact_keys):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g, *_), (_, w, *_) in zip(got, want):
        assert set(g) == set(w)
        if "neighbors" in w:
            _same_neighbors(g["neighbors"], w["neighbors"], exact_keys)
        elif "embeddings" in w:
            np.testing.assert_allclose(g["embeddings"], w["embeddings"],
                                       atol=TOL)
        elif "corpus" in w:
            assert (g["corpus"], g["k"]) == (w["corpus"], w["k"])
            assert g.get("updated") == w.get("updated")


@pytest.mark.parametrize("tower", ["bert", "ft"])
def test_sharded_daemon_answers_as_jax_and_one_process(runs, tower):
    """Two ranks' daemon (rank 0's HTTP, rank 1 replaying its engine)
    answers every request of the script as the JAX package's sharded
    daemon and as the port's on one process, ``/update`` included."""
    rank0, rank1 = runs["two"][tower]
    got = rank0["replies"]
    _same_replies(got, runs["one"][tower]["replies"], exact_keys=True)
    _same_replies(got, runs["jax"][tower], exact_keys=False)
    assert rank1 == {"followed": rank1["followed"]}
    assert sum(len(r[1].get("neighbors", ())) for r in got) >= 20
    if tower == "bert":
        assert got[-1][1]["corpus"] == N_ROWS + 1
        assert got[12][1]["neighbors"][0]["key"] == "new0"
        assert got[13][1]["neighbors"][0]["key"] == "sku3"
        assert all(n["key"] != "sku5" for n in got[3][1]["neighbors"])
        assert all(int(n["key"][3:]) % 3 == 1
                   for n in got[2][1]["neighbors"])


def test_follower_replays_every_engine_call_and_no_refused_request(runs):
    """The follower returned (``cmd_serve`` gave it ``stop`` when rank 0's
    service closed) after replaying exactly rank 0's engine calls: the
    warm-up's, the host and device searches and the updates; a request
    that rank 0 refused with 400 made no call."""
    for tower in ("bert", "ft"):
        rank0, rank1 = runs["two"][tower]
        calls = [r[2] for r in rank0["replies"]]
        followed = rank1["followed"]
        assert sum(followed.values()) == calls[-1]
        assert followed["update"] == 1
        if tower == "bert":
            # the warm-up ladder and the requests: the device chain
            assert followed["search_device"] > followed["search"] > 0
            for i in REFUSED:
                assert rank0["replies"][i][0] == 400
                assert calls[i] == calls[i - 1]
        else:
            # no device tower: the host path's searches only
            assert "search_device" not in followed


def test_l2_over_shards_matches_jax_and_one_process(runs):
    """``LockstepEngine`` and ``follow`` at the engine, l2 on
    un-normalized rows: every answer equals the one-process engine's and
    the JAX package's sharded engine's; pad rows never come back; a
    refused update raises on rank 0 and leaves both ranks in step; the
    sharded corpus has no fused chain."""
    rank0, rank1 = runs["two"]["l2"]
    one, want = runs["one"]["l2"], runs["jax"]["l2"]
    assert rank0["sharded"] and rank0["fused_is_none"]
    assert rank0["block_rows"] == 256 and not one["sharded"]
    assert rank1 == {"followed": rank0["calls"]}
    for key in ("host", "tensor", "device", "after_update", "self"):
        for ref in (one, want):
            np.testing.assert_array_equal(rank0[key][1], ref[key][1])
            np.testing.assert_allclose(rank0[key][0], ref[key][0],
                                       rtol=1e-6, atol=TOL)
        assert rank0[key][1].max() < N_ROWS + 2
    assert rank0["host"][1][0, :2].tolist() == [17, 290]
    assert rank0["empty"] == one["empty"] == [(0, 9), (0, 9)]
    assert rank0["update"] == one["update"] == want["update"] == (1, 2)
    assert "duplicate keys" in rank0["refused"] == one["refused"]


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_sharded_daodian_job_writes_jax_and_one_process_items(runs,
                                                              variant):
    """``similar daodian --text_only`` over two ranks writes exactly the
    JAX package's sharded job's KV items and the one-process port's, and
    every rank returns rank 0's merged map."""
    rank0, rank1 = runs["two"][variant]
    assert rank0["items"] and rank0["items"] == runs["jax"][variant]
    assert rank0["items"] == runs["one"][variant]["items"]
    assert rank1["items"] == {}
    assert rank0["merged"] == rank1["merged"] == \
        runs["one"][variant]["merged"]


def test_model_parallel_daemon_serves_on_rank_0_alone(runs):
    """A mesh of model 2 over two ranks leaves a data axis of 1: the
    corpus is not sharded, rank 0 serves alone (its fused chain) and
    answers as one process does; rank 1 returns at once."""
    rank0, rank1 = runs["two"]["bert_mp"]
    _same_replies(rank0["replies"], runs["one"]["bert"]["replies"][:7],
                  exact_keys=True)
    assert rank1 == {"followed": {}}


@pytest.mark.parametrize("n", [1, 7])
def test_corpus_blocks_gather_in_row_order(runs, n):
    """Each rank embeds its own block of the corpus (``embed_sharded``,
    ``embed_kept``, ``embed_keys_sharded``, which the cv and multimodal
    daemons use): the gathered rows, kept rows and keyed vectors equal
    the one-process pass, a block with no row or no kept row included."""
    for rank in runs["two"][f"blocks_{n}"]:
        one = runs["one"][f"blocks_{n}"]
        np.testing.assert_array_equal(rank["all"], one["all"])
        assert rank["kept"] == one["kept"] == [i for i in range(n) if i % 3]
        np.testing.assert_array_equal(rank["kept_emb"].reshape(-1, 2),
                                      one["kept_emb"].reshape(-1, 2))
        assert rank["by_key"] == one["by_key"]


def test_refusals_under_two_ranks(runs):
    """``serve --tower daodian`` keeps its per-area engines on one card
    and refuses a launch of two ranks, naming the reason; ``--pallas_topk``
    is still refused."""
    for rank in runs["two"]["refused_daodian"]:
        kind, msg = rank
        assert kind == "SystemExit"
        assert "over 2 ranks" in msg and "one process" in msg
        assert "A17" not in msg
    for rank in runs["two"]["refused_pallas"]:
        assert rank[0] == "NotImplementedError" and "--pallas_topk" in rank[1]

