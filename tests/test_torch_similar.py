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


def test_recorded_job_has_its_stages_and_the_same_lists(towers):
    """Under ``recording()`` the job holds ``similar.job`` over embed,
    index, search, filter and write, in that order; the embedder's spans
    under ``similar.embed``; ``embed.tokens_real`` is the attention
    masks' sum, ``embed.tokens_computed`` the padded batches' positions;
    the lists are an unrecorded run's."""
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
    batches = -(-len(titles) // 8)
    for name in ("embed.tokenize", "embed.launch", "embed.drain"):
        got = [s for s in rec.spans if s[0] == name]
        assert len(got) == batches and {s[1] for s in got} == {
            "similar.embed"}, name
    mask = tok(titles, 16)["attention_mask"]
    assert rec.counters == {"embed.tokens_real": int(mask.sum()),
                            "embed.tokens_computed": batches * 8 * 16}


def test_bucketed_embedder_counts_the_tokens_it_computes(towers):
    """Length buckets: ``embed.tokens_computed`` is each batch's rows x
    its bucket, ``embed.tokens_real`` the masks' sum, as unbucketed."""
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    titles, _, (model, tok) = towers
    emb = TextEmbedder(model, tok, max_length=16, batch_size=8,
                       length_buckets=(8,), device="cpu")
    with recording() as rec:
        emb(titles)
    lens = np.sort(tok(titles, 16)["attention_mask"].sum(axis=1))
    computed = sum(8 * (8 if lens[s: s + 8].max() <= 8 else 16)
                   for s in range(0, len(lens), 8))
    assert rec.counters == {"embed.tokens_real": int(lens.sum()),
                            "embed.tokens_computed": computed}
