"""The text similarity job end to end: JAX package vs port, on the CPU.

A tiny tower (2 layers, width 64) with the JAX model's weights carried
over by ``text_classifier_from_jax``, the same char tokenizer, the same
titles: ``TextEmbedder`` and ``nlp_similar_job`` must produce the same
embeddings and the same KV items in both packages, from a pandas DataFrame
and from a plain dict of lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JNlpTextClassifier)
from multimodalsimilar_tpu.pipelines.embedders import (
    TextEmbedder as JTextEmbedder)
from multimodalsimilar_tpu.pipelines.similar import (
    nlp_similar_job as jnlp_similar_job)
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryKVSink as JInMemoryKVSink)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import text_classifier_from_jax
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.pipelines.similar import nlp_similar_job
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

BASE = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
        "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]


def _titles(n=37, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = BASE[int(rng.integers(0, len(BASE)))]
        out.append(t if i % 4 else t + str(int(rng.integers(0, 9))))
    return out


@pytest.fixture(scope="module")
def towers():
    titles = _titles()
    jtok = JTokenizer.from_corpus(titles)
    tok = TextTokenizer.from_corpus(titles)
    cfg = JBertConfig.tiny(vocab_size=jtok.vocab_size)
    jmodel = JNlpTextClassifier(cfg, num_labels=3,
                                policy=JPolicy.full_precision())
    ids = jnp.zeros((1, 16), jnp.int32)
    variables = jmodel.init({"params": jax.random.key(2)}, ids,
                            label=jnp.zeros(1, jnp.int32))
    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size)
    model = NlpTextClassifier(tcfg, policy=DTypePolicy.full_precision(),
                              num_labels=3)
    model.load_state_dict(text_classifier_from_jax(variables["params"], tcfg))
    return titles, (jmodel, variables, jtok), (model, tok)


@pytest.mark.parametrize("buckets", [None, (8,)], ids=["flat", "buckets"])
def test_text_embedder_matches_jax(towers, buckets):
    titles, (jmodel, variables, jtok), (model, tok) = towers
    want = JTextEmbedder(jmodel, variables, jtok, max_length=16,
                         batch_size=8, length_buckets=buckets)(titles)
    emb = TextEmbedder(model, tok, max_length=16, batch_size=8,
                       length_buckets=buckets, device="cpu")
    got = emb(titles)
    assert got.shape == want.shape == (len(titles), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dev = emb.embed_device(titles[:5], pad_to=6)
    assert isinstance(dev, torch.Tensor) and dev.shape == (6, 64)
    np.testing.assert_allclose(dev[:5].numpy(), want[:5], atol=1e-5)
    with pytest.raises(ValueError, match="pad_to"):
        emb.embed_device(titles[:9])


@pytest.mark.parametrize("as_dict", [False, True], ids=["dataframe", "dict"])
def test_nlp_similar_job_same_kv_items(towers, as_dict):
    titles, (jmodel, variables, jtok), (model, tok) = towers
    keys = [f"s{i}" for i in range(len(titles))]
    keys[5] = keys[2]                   # duplicate key: never its own neighbor
    df = pd.DataFrame({"spu_sn": keys, "spu_name": titles})
    jsink, sink = JInMemoryKVSink(), InMemoryKVSink()
    jembed = JTextEmbedder(jmodel, variables, jtok, max_length=16,
                           batch_size=8)
    embed = TextEmbedder(model, tok, max_length=16, batch_size=8,
                         device="cpu")
    want = jnlp_similar_job(df, jembed, jsink, k=6, score_th=0.95)
    table = {"spu_sn": keys, "spu_name": titles} if as_dict else df
    got = nlp_similar_job(table, embed, sink, k=6, score_th=0.95,
                          device="cpu")
    assert got == want > 0
    assert {k: v for k, (v, _) in sink.data.items()} == \
        {k: v for k, (v, _) in jsink.data.items()}
    assert 0 < sink.ttl(next(iter(sink.keys()))) <= 7 * 24 * 3600


def _expected_counts(titles, tok, windows, width):
    """(real tokens, computed positions, batches) of a padding-invariant
    tower's call at max_length 16 and batch 8: each distinct title once
    (its first row), sorted by length within its window, each batch
    ``width(longest row)`` long."""
    lens = tok(titles, 16)["attention_mask"].sum(axis=1)
    firsts = np.array([i for i, t in enumerate(titles)
                       if titles.index(t) == i])
    computed = batches = 0
    for w0, w1 in windows:
        part = np.sort(lens[firsts[(firsts >= w0) & (firsts < w1)]])
        for s in range(0, len(part), 8):
            computed += 8 * width(int(part[s: s + 8].max()))
            batches += 1
    return int(lens[firsts].sum()), computed, batches


def test_recorded_job_has_its_stages_and_the_same_lists(towers):
    """Under ``recording()`` the job holds ``similar.job`` over embed,
    index, search, filter and write, in that order; under
    ``similar.embed`` the embedder's main-thread spans: one
    ``embed.tokenize`` (the wait for a window) a window, one
    ``embed.launch`` and ``embed.drain`` a batch; one ``embed.prepare`` a
    window on the worker thread that tokenizes ahead.
    ``embed.tokens_real`` is the attention masks' sum over the rows the
    tower computes (each distinct title once), ``embed.tokens_computed``
    each batch's rows x its trimmed length (rows sorted by length within
    a window); the lists are an unrecorded run's."""
    import threading
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    titles, _, (model, tok) = towers
    keys = [f"s{i}" for i in range(len(titles))]
    table = {"spu_sn": keys, "spu_name": titles}
    embed = TextEmbedder(model, tok, max_length=16, batch_size=8,
                         device="cpu")
    plain, traced = InMemoryKVSink(), InMemoryKVSink()
    nlp_similar_job(table, embed, plain, k=6, score_th=0.95, device="cpu")
    with recording() as rec:
        nlp_similar_job(table, embed, traced, k=6, score_th=0.95,
                        device="cpu")
    assert {k: v for k, (v, _) in traced.data.items()} == \
        {k: v for k, (v, _) in plain.data.items()} and plain.data
    job = [s for s in rec.spans if s[0] == "similar.job"]
    assert len(job) == 1 and job[0][1] is None
    kids = sorted((s for s in rec.spans if s[1] == "similar.job"),
                  key=lambda s: s[3])
    assert [s[0] for s in kids] == ["similar.embed", "similar.index",
                                    "similar.search", "similar.filter",
                                    "similar.write"]
    assert all(job[0][3] <= s[3] <= s[4] <= job[0][4] for s in kids)
    windows = [(0, 32), (32, 37)]          # 4 batches of 8, then the rest
    assert embed._windows(len(titles)) == windows
    real, computed, n = _expected_counts(
        titles, tok, windows, lambda need: need)
    assert len(set(titles)) < len(titles) and computed < n * 8 * 16
    main = threading.main_thread().ident
    for name, count in (("embed.tokenize", len(windows)),
                        ("embed.launch", n), ("embed.drain", n)):
        got = [s for s in rec.spans if s[0] == name]
        assert len(got) == count and {s[1] for s in got} == {
            "similar.embed"} and {s[2] for s in got} == {main}, name
    prep = [s for s in rec.spans if s[0] == "embed.prepare"]
    assert len(prep) == len(windows) and main not in {s[2] for s in prep}
    assert rec.counters == {"embed.tokens_real": real,
                            "embed.tokens_computed": computed}


class _NotPaddingInvariant(torch.nn.Module):
    """The same tower, declared to depend on its padding: the embedder
    keeps every batch in row order at ``max_length``."""

    padding_invariant = False

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def predict_emb(self, *tokens):
        return self.inner.predict_emb(*tokens)


class _Shapes(torch.nn.Module):
    """A tower that keeps the token shape of every call and is
    padding-invariant as its inner one is."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.padding_invariant = inner.padding_invariant
        self.shapes = []

    def predict_emb(self, input_ids, *rest):
        self.shapes.append(tuple(input_ids.shape))
        return self.inner.predict_emb(input_ids, *rest)


def _mixed_titles(tok_titles):
    """Titles of 1-20 characters (some past ``max_length`` 16), one
    repeated, 77 rows: 10 batches of 8, the last partial, over two
    windows."""
    rng = np.random.default_rng(5)
    chars = "".join(tok_titles)
    out = ["".join(rng.choice(list(chars), int(n)))
           for n in rng.integers(1, 21, 77)]
    out[40] = out[3]
    return out


def test_default_embedder_trims_and_matches_the_flat_path(towers):
    """With no ladder, a padding-invariant tower gets batches sorted by
    length and cut to their longest row, each distinct title once; the
    embeddings equal the flat path's (the same tower declared not
    padding-invariant) in row order, a repeated title's bit for bit its
    first row's, and the flat path hands the tower every batch at
    ``max_length``."""
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    titles, _, (model, tok) = towers
    texts = _mixed_titles(titles)
    trimmed = _Shapes(model)
    flat = _Shapes(_NotPaddingInvariant(model))
    with recording() as rec:
        got = TextEmbedder(trimmed, tok, max_length=16, batch_size=8,
                           device="cpu")(texts)
    want = TextEmbedder(flat, tok, max_length=16, batch_size=8,
                        device="cpu")(texts)
    assert got.shape == want.shape == (77, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[40], got[3])
    assert flat.shapes == [(8, 16)] * 10
    one = TextEmbedder(trimmed, tok, max_length=16, batch_size=8,
                       device="cpu")
    windows = [(0, 32), (32, 77)]
    assert one._windows(77) == windows
    real, computed, n = _expected_counts(texts, tok, windows,
                                         lambda need: need)
    assert len(trimmed.shapes) == n
    assert all(b == 8 for b, _ in trimmed.shapes)
    assert len({w for _, w in trimmed.shapes}) > 2
    # the counters count the rows and positions the tower was handed
    assert rec.counters == {"embed.tokens_real": real,
                            "embed.tokens_computed": computed}
    assert computed == sum(b * w for b, w in trimmed.shapes) < n * 8 * 16
    # one batch is cut too, and needs no sort
    mask = tok(texts, 16)["attention_mask"]
    trimmed.shapes.clear()
    np.testing.assert_allclose(one(texts[:5]), want[:5], rtol=0, atol=1e-5)
    assert trimmed.shapes == [(8, int(mask[:5].sum(axis=1).max()))]


def test_tokenizer_sees_each_row_once_in_order_at_max_length(towers):
    """The tokenizer is called on the rows in row order, each row once,
    at ``max_length``: the concatenated ids of its calls are the rows'
    own at full width (the benchmark's recorder compares rows by
    position)."""
    titles, _, (model, tok) = towers
    texts = _mixed_titles(titles) * 3              # 231 rows, 4 windows
    calls = []

    def recording_tok(batch, max_length=128):
        out = tok(batch, max_length)
        calls.append((list(batch), max_length, out["input_ids"]))
        return out

    emb = TextEmbedder(model, recording_tok, max_length=16, batch_size=8,
                       device="cpu")
    emb(texts)
    assert len(calls) == len(emb._windows(len(texts))) == 4
    assert [t for batch, _, _ in calls for t in batch] == texts
    assert {m for _, m, _ in calls} == {16}
    np.testing.assert_array_equal(
        np.concatenate([ids for _, _, ids in calls]),
        tok(texts, 16)["input_ids"])


def test_bucketed_embedder_counts_the_tokens_it_computes(towers):
    """Length buckets: ``embed.tokens_computed`` is each batch's rows x
    its bucket, ``embed.tokens_real`` the masks' sum, over the rows the
    tower computes (each distinct title once)."""
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    titles, _, (model, tok) = towers
    emb = TextEmbedder(model, tok, max_length=16, batch_size=8,
                       length_buckets=(8,), device="cpu")
    with recording() as rec:
        emb(titles)
    real, computed, _ = _expected_counts(
        titles, tok, emb._windows(len(titles)),
        lambda need: 8 if need <= 8 else 16)
    assert rec.counters == {"embed.tokens_real": real,
                            "embed.tokens_computed": computed}
