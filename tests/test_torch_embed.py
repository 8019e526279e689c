"""The embedding export jobs in the port, on the CPU: the serialization,
``incremental_export`` / ``rebuild_export`` / ``bulk_export`` held against
the JAX package's functions on the same embed function and table, and the
production chain ``embed incremental`` -> ``serve --emb_table``.
"""

import json
import zlib

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.pipelines import embed as J
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryTableSink as JInMemoryTableSink)
from multimodalsimilar_tpu.pipelines.sinks import (
    ParquetTableSink as JParquetTableSink)
from multimodalsimilar_tpu_torch.cli import embed as cli_embed
from multimodalsimilar_tpu_torch.cli import serve as cli_serve
from multimodalsimilar_tpu_torch.pipelines import embed as P
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.pipelines.sinks import (InMemoryTableSink,
                                                         ParquetTableSink)

torch.set_num_threads(1)


def _vec(key, dim=5):
    rng = np.random.default_rng(zlib.crc32(str(key).encode()))
    return (3.0 * rng.normal(size=dim)).astype(np.float32)


def embed_fn(sub):
    """The same deterministic embed function for both packages."""
    return {str(k): _vec(k) for k in sub["goods_sku"]}


def _same_table(got, want):
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


@pytest.mark.parametrize("normalize,brackets",
                         [(True, True), (False, True), (False, False)])
def test_format_parse_round_trip(normalize, brackets):
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(40, 7)).astype(np.float32)
    strings = [P.format_embedding(v, normalize, brackets) for v in vecs]
    assert strings == [J.format_embedding(v, normalize, brackets)
                       for v in vecs]
    assert strings[0].startswith("[") == brackets
    want = vecs / np.linalg.norm(vecs, axis=1, keepdims=True) \
        if normalize else vecs
    out = P.parse_embeddings(strings)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out, J.parse_embeddings(strings))
    for s, row in zip(strings, out):
        np.testing.assert_array_equal(P.parse_embedding(s), row)
    assert P.parse_embeddings([]).shape == (0, 0)
    zero = P.format_embedding(np.zeros(3), normalize=True)
    assert zero == "[0.0,0.0,0.0]"


def test_parse_embeddings_chunked_path_and_ragged():
    """More than 50k rows crosses the chunked join; a ragged table
    raises."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(50_003, 2)).astype(np.float32)
    strings = [P.format_embedding(v, normalize=False) for v in vecs]
    np.testing.assert_allclose(P.parse_embeddings(strings), vecs, rtol=1e-6)
    with pytest.raises(ValueError, match="ragged"):
        P.parse_embeddings(strings[:50_000] + ["[1.0,2.0,3.0]"] * 3)


def test_incremental_export_matches_jax():
    """Skip-existing increments, in-df duplicate keys collapsed, the dt
    column, normalized '[...]' strings: the same table in both
    packages."""
    df = pd.DataFrame({"goods_sku": ["1", "2", "3", "2"],
                       "spu_name": ["a", "b", "c", "b2"]})
    df2 = pd.concat([df, pd.DataFrame({"goods_sku": ["4"],
                                       "spu_name": ["d"]})])
    sink, jsink = InMemoryTableSink(), JInMemoryTableSink()
    for frame, dt, written in ((df, "2026-08-16", 3), (df, None, 0),
                               (df2, "2026-08-17", 1)):
        got = P.incremental_export(frame, embed_fn, sink, dt=dt)
        assert got == J.incremental_export(frame, embed_fn, jsink,
                                           dt=dt) == written
    _same_table(sink.read(), jsink.read())
    table = sink.read()
    assert sorted(table["goods_sku"]) == ["1", "2", "3", "4"]
    np.testing.assert_allclose(np.linalg.norm(
        P.parse_embeddings(table["embedding"]), axis=1), 1.0, rtol=1e-5)


def test_incremental_export_periodic_flush_is_crash_resumable():
    sink = InMemoryTableSink()
    df = pd.DataFrame({"goods_sku": [str(i) for i in range(6)]})
    calls = {"n": 0}

    def flaky(sub):
        calls["n"] += 1
        if calls["n"] == 3:               # crash on the 3rd chunk
            raise RuntimeError("boom")
        return embed_fn(sub)

    with pytest.raises(RuntimeError):
        P.incremental_export(df, flaky, sink, buffer_rows=2, flush_rows=2)
    assert set(sink.read()["goods_sku"]) == {"0", "1", "2", "3"}
    calls["n"] = 10
    assert P.incremental_export(df, flaky, sink, buffer_rows=2,
                                flush_rows=2) == 2
    assert sorted(sink.read()["goods_sku"]) == [str(i) for i in range(6)]


def test_incremental_export_compacts_parquet_like_jax(tmp_path):
    df = pd.DataFrame({"goods_sku": [f"k{i}" for i in range(10)]})
    sink = ParquetTableSink(str(tmp_path / "t.parquet"))
    jsink = JParquetTableSink(str(tmp_path / "j.parquet"))
    for s, run in ((sink, P.incremental_export),
                   (jsink, J.incremental_export)):
        assert run(df, embed_fn, s, buffer_rows=3, flush_rows=3,
                   dt="2026-08-18") == 10
        assert not s._part_files()              # compacted
        assert run(df, embed_fn, s, buffer_rows=3, flush_rows=3) == 0
    _same_table(pd.read_parquet(tmp_path / "t.parquet"),
                pd.read_parquet(tmp_path / "j.parquet"))


def test_rebuild_export_matches_jax():
    """Full overwrite: re-embedded keys refresh, departed keys drop."""
    sink, jsink = InMemoryTableSink(), JInMemoryTableSink()
    day1 = pd.DataFrame({"goods_sku": ["1", "2", "3"]})
    day2 = pd.DataFrame({"goods_sku": ["3", "5"]})
    for frame, dt in ((day1, "2026-08-16"), (day2, "2026-08-17")):
        assert P.rebuild_export(frame, embed_fn, sink, dt=dt) == \
            J.rebuild_export(frame, embed_fn, jsink, dt=dt)
        _same_table(sink.read(), jsink.read())
    assert sink.existing_keys("goods_sku") == {"3", "5"}
    P.rebuild_export(day2.iloc[:0], embed_fn, sink)
    assert list(sink.read().columns) == ["goods_sku", "embedding"]


@pytest.mark.parametrize("normalize,brackets", [(False, False),
                                                (True, True)])
def test_bulk_export_outer_merge_matches_jax(normalize, brackets):
    """Columns per tower, outer-merged over the key; the reference bulk
    job's raw format by default (goodssku_emb.py:92-93)."""
    df = pd.DataFrame({"goods_sku": ["1", "2", "3"]})

    def partial_fn(sub):                  # an embedder covering sku 1 only
        return embed_fn(sub[sub["goods_sku"] == "1"])

    towers = {"bert": embed_fn, "cv": partial_fn}
    sink, jsink = InMemoryTableSink(), JInMemoryTableSink()
    got = P.bulk_export(df, towers, sink, normalize=normalize,
                        brackets=brackets)
    want = J.bulk_export(df, towers, jsink, normalize=normalize,
                         brackets=brackets)
    _same_table(got, want)
    _same_table(sink.read(), got)
    assert got["cv_emb"].isna().sum() == 2
    s = got["bert_emb"].iloc[0]
    assert s.startswith("[") == brackets
    assert list(P.bulk_export(df, {}, sink).columns) == ["goods_sku"]


def _corpus_csv(tmp_path, n=20):
    df = pd.DataFrame({"goods_sku": [f"g{i}" for i in range(n)],
                       "spu_name": [f"{'甲乙丙丁戊'[i % 5] * 2}商品{i}"
                                    for i in range(n)]})
    path = str(tmp_path / "catalog.csv")
    df.to_csv(path, index=False)
    return path, df


def test_embed_incremental_then_serve_emb_table(tmp_path, monkeypatch,
                                                capsys):
    """The production chain: ``embed incremental --kind text`` writes the
    table (a rerun writes nothing), and ``serve --emb_table`` starts from
    it without re-embedding the rows it holds, serving the same vectors
    the tower gives."""
    data, df = _corpus_csv(tmp_path)
    table = str(tmp_path / "emb.parquet")
    flags = ["--max_length", "16", "--batch_size", "8"]
    args = build_parser().parse_args(
        ["embed", "incremental", "--data", data, "--table", table,
         "--dt", "2026-08-16", *flags])
    cli_embed.cmd_embed_incremental(args, device="cpu")
    cli_embed.cmd_embed_incremental(args, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["written"] for ln in lines] == [20, 0]
    written = pd.read_parquet(table)
    assert len(written) == 20 and set(written["dt"]) == {"2026-08-16"}

    embedded = []
    real_call = TextEmbedder.__call__
    monkeypatch.setattr(TextEmbedder, "__call__", lambda self, texts: (
        embedded.append(len(texts)) or real_call(self, texts)))
    sargs = build_parser().parse_args(
        ["serve", "--data", data, "--key_col", "goods_sku", "--emb_table",
         table, "--max_batch", "8", "--k", "3", *flags])
    svc, n = cli_serve._build_serve_service(sargs, device="cpu")
    try:
        assert n == 20 and embedded == [1]     # the dim probe only
        vecs = P.parse_embeddings(written["embedding"])
        order = [list(written["goods_sku"]).index(k)
                 for k in df["goods_sku"]]
        np.testing.assert_allclose(svc.engine._emb, vecs[order],
                                   atol=1e-6)
        fresh = svc.embed(list(df["spu_name"][:4]))
        fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
        np.testing.assert_allclose(svc.engine._emb[:4], fresh, atol=1e-5)
        got = svc.similar(df["spu_name"][7], score_th=None)
        assert got[0]["key"] == "g7"
    finally:
        svc.close()


def test_embed_bulk_bert_column_and_unported_kinds(tmp_path, capsys):
    data, df = _corpus_csv(tmp_path, n=6)
    table = str(tmp_path / "bulk.parquet")
    args = build_parser().parse_args(
        ["embed", "bulk", "--data", data, "--table", table, "--kinds",
         "bert", "--max_length", "16", "--batch_size", "4"])
    cli_embed.cmd_embed_bulk(args, device="cpu")
    out = pd.read_parquet(table)
    assert list(out.columns) == ["goods_sku", "bert_emb"] and len(out) == 6
    assert not out["bert_emb"].iloc[0].startswith("[")   # raw, like bulk
    assert '"towers": ["bert"]' in capsys.readouterr().out
    # fasttext is ported (tests/test_torch_daodian.py); without a model
    # it stops with the JAX command's one-line error
    for argv in (["bulk", "--kinds", "bert,fasttext"],
                 ["bulk", "--kinds", "fasttext"],
                 ["incremental", "--kind", "fasttext"]):
        a = build_parser().parse_args(
            ["embed", argv[0], "--data", data, "--table", table, *argv[1:]])
        fn = (cli_embed.cmd_embed_bulk if argv[0] == "bulk"
              else cli_embed.cmd_embed_incremental)
        with pytest.raises(SystemExit, match="--fasttext_model"):
            fn(a, device="cpu")
    # hive:// tables go through the Spark adapter, which needs pyspark
    # (tests/test_torch_cli.py drives it against a stub)
    a = build_parser().parse_args(
        ["embed", "incremental", "--data", data, "--table", "hive://db.t"])
    with pytest.raises(ImportError, match="pyspark"):
        cli_embed.cmd_embed_incremental(a, device="cpu")
