"""The port's int8 text tower (``models/quant.py``) against the JAX
package's, on the CPU.

The tiny BERT's seeded port weights go to the JAX model through
``hf_import.bert_params_from_torch`` (the port keeps HF names); both are
then quantized by their own package:

* ``quantize_bert_state`` equals JAX ``quantize_bert_params`` bit for
  bit: every int8 weight and f32 scale (the JAX kernel transposed), and
  the passed-through embeddings, LayerNorms and pooler;
* ``QuantTextEmbModel.predict_emb`` (``cls`` and ``mean`` pools) against
  JAX's on one padded batch, within 1e-6 in full precision and 1e-5
  of the largest output under the inference policy (the probabilities
  in bf16); through ``TextEmbedder`` on whole padded batches (a tail
  padded by repeating its last row, length buckets) against the JAX
  embedder, the same tolerances — the activation scale is per tensor,
  so a row's embedding depends on its batch, which the test shows;
* the int8 tower's embeddings against the float tower's: cosine >= 1 -
  1e-3, the JAX package's own budget (``tests/test_quant.py``);
* ``int8_matmul`` exact at K = 3,072 with every product at 127^2
  (past f32's exact range), and ``_int_mm_padded``'s zero padding to
  ``torch._int_mm``'s shapes, on the CPU;
* the commands against the JAX CLI (its checkpoint restore replaced by
  the JAX tree): ``similar nlp --int8`` (the KV writes) and ``embed
  incremental --int8`` (the table), in full precision; ``--int8`` with a
  pipeline-parallel checkpoint exits with the JAX command's message.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import multimodalsimilar_tpu.cli as jcli
from multimodalsimilar_tpu.cli import build_parser as jbuild_parser
from multimodalsimilar_tpu.cli import embedders as jembedders
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models import quant as JQ
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.hf_import import bert_params_from_torch
from multimodalsimilar_tpu.pipelines.embedders import (
    TextEmbedder as JTextEmbedder)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch import cli
from multimodalsimilar_tpu_torch.cli.embedders import _build_text_embedder
from multimodalsimilar_tpu_torch.data.datasets import InputError
from multimodalsimilar_tpu_torch.data.tokenizer import (TextTokenizer,
                                                        build_char_vocab)
from multimodalsimilar_tpu_torch.models import quant as Q
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import (
    text_classifier_from_jax)
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
from tests.test_torch_cli import (BASE, CONFIGS, _full_precision, _items,
                                  _last_json, _sinks)

torch.set_num_threads(1)

CFG, JCFG = BertConfig.tiny(), JBertConfig.tiny()
POLICIES = {"full": (JPolicy.full_precision(),
                     DTypePolicy.full_precision(), 1e-6),
            "inference": (JPolicy.inference(), DTypePolicy.inference(),
                          1e-5)}


def _port_classifier(pool="cls", seed=3, policy=DTypePolicy()):
    return NlpTextClassifier(CFG, pool=pool, policy=policy,
                             generator=torch.Generator().manual_seed(seed))


def _jax_quant_params(model):
    """The port tower's weights -> the JAX encoder -> JAX quantized."""
    sd = {k[len("tower.encoder."):]: v.numpy()
          for k, v in model.state_dict().items()
          if k.startswith("tower.encoder.")}
    return JQ.quantize_bert_params(bert_params_from_torch(sd, JCFG))


def _batch(seed=0, B=6, S=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, CFG.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for r, n in enumerate(rng.integers(2, S, B)):
        mask[r, n:] = 0
        ids[r, n:] = 0
    return ids, mask, np.zeros((B, S), np.int32)


def test_quantized_weights_equal_jax_bit_for_bit():
    model = _port_classifier()
    qp = _jax_quant_params(model)
    state = Q.quantize_text_tower(model).encoder.state_dict()
    H, I = CFG.hidden_size, CFG.intermediate_size
    names = {"attention.self.query": ("attention", "query", H),
             "attention.self.key": ("attention", "key", H),
             "attention.self.value": ("attention", "value", H),
             "attention.output.dense": ("attention", "out", H),
             "intermediate.dense": ("intermediate", None, I),
             "output.dense": ("output", None, H)}
    for i in range(CFG.num_layers):
        jl = qp[f"layer_{i}"]
        for port, (a, b, out) in names.items():
            j = jl[a][b] if b else jl[a]
            pre = f"encoder.layer.{i}.{port}"
            wq = state[f"{pre}.weight_q"]
            assert wq.dtype == torch.int8
            np.testing.assert_array_equal(
                wq.numpy(), np.asarray(j["kernel_q"]).reshape(-1, out).T)
            np.testing.assert_array_equal(
                state[f"{pre}.scale"].numpy(),
                np.asarray(j["scale"]).reshape(-1))
            np.testing.assert_array_equal(
                state[f"{pre}.bias"].numpy(),
                np.asarray(j["bias"]).reshape(-1))
        np.testing.assert_array_equal(
            state[f"encoder.layer.{i}.output.LayerNorm.weight"].numpy(),
            np.asarray(jl["output_norm"]["scale"]))
    np.testing.assert_array_equal(
        state["embeddings.word_embeddings.weight"].numpy(),
        np.asarray(qp["word_embeddings"]["embedding"]))
    np.testing.assert_array_equal(state["pooler.dense.weight"].numpy(),
                                  np.asarray(qp["pooler"]["kernel"]).T)
    # a zero output channel keeps the 1e-8 floor, as in JAX
    w = np.zeros((3, 4), np.float32)
    w[1] = [0.5, -1.0, 0.25, 0.0]
    q, s = Q.quantize_weight(torch.from_numpy(w))
    jq, js = JQ._quantize_weight(w.T)
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_predict_emb_matches_jax(pool, policy):
    jpol, pol, tol = POLICIES[policy]
    model = _port_classifier(pool, policy=pol)
    qp = _jax_quant_params(model)
    jmodel = JQ.QuantTextEmbModel(JCFG, pool=pool, policy=jpol)
    ids, mask, types = _batch()
    want = np.asarray(jmodel.apply(
        {"params": {"encoder": qp}}, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(types), method=jmodel.predict_emb), np.float32)
    qmodel = Q.quantize_text_tower(model)
    assert qmodel.policy == pol
    with torch.no_grad():
        got = qmodel.predict_emb(torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(types)).float().numpy()
    assert got.shape == (6, CFG.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


TEXTS = [BASE[i % len(BASE)] + "新品" * (i % 4) + str(i) for i in range(21)]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("buckets", [None, (8,)], ids=["full", "buckets"])
def test_text_embedder_matches_jax_on_padded_batches(buckets, policy):
    """21 titles at batch 8: the last batch padded by repeating its last
    row, as both embedders pad; with buckets, the rows sorted by length
    and each batch cut to its bucket. Whole batches agree."""
    jpol, pol, tol = POLICIES[policy]
    vocab = build_char_vocab(TEXTS)
    model = _port_classifier("cls", policy=pol)
    qp = _jax_quant_params(model)
    jemb = JTextEmbedder(JQ.QuantTextEmbModel(JCFG, policy=jpol),
                         {"params": {"encoder": qp}},
                         JTokenizer.from_vocab(vocab, use_native=False), 16,
                         8, length_buckets=buckets)
    emb = TextEmbedder(Q.quantize_text_tower(model),
                       TextTokenizer.from_vocab(vocab), 16, 8,
                       length_buckets=buckets, device="cpu")
    want, got = np.asarray(jemb(TEXTS)), emb(TEXTS)
    assert got.shape == want.shape == (21, CFG.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))
    # the activation scale spans the batch: a row alone embeds otherwise
    alone = emb(TEXTS[:1])
    assert np.abs(alone[0] - got[0]).max() > 1e-6


def test_int8_tower_without_a_ladder_computes_whole_batches():
    """The int8 tower is not padding-invariant: with no ladder the
    embedder keeps every batch at ``max_length``, in row order, so it
    counts batches x batch_size x max_length token positions."""
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    qmodel = Q.quantize_text_tower(_port_classifier("cls"))
    assert not qmodel.padding_invariant
    vocab = build_char_vocab(TEXTS)
    tok = TextTokenizer.from_vocab(vocab)
    emb = TextEmbedder(qmodel, tok, 16, 8, device="cpu")
    with recording() as rec:
        emb(TEXTS)
    assert rec.counters == {
        "embed.tokens_real": int(tok(TEXTS, 16)["attention_mask"].sum()),
        "embed.tokens_computed": 3 * 8 * 16}


def test_int8_tower_stays_within_the_cosine_budget():
    model = _port_classifier("cls", policy=DTypePolicy.full_precision())
    qmodel = Q.quantize_text_tower(model)
    ids, mask, types = _batch(seed=1, B=8)
    args = [torch.from_numpy(a) for a in (ids, mask, types)]
    with torch.no_grad():
        a = qmodel.predict_emb(*args).numpy()
        b = model.predict_emb(*args).float().numpy()
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() > 1 - 1e-3, cos


def test_int8_products_are_exact():
    k = 3072
    x = torch.full((3, k), 127, dtype=torch.int8)
    x[1] = -127
    w = torch.full((5, k), -127, dtype=torch.int8)
    got = Q.int8_matmul(x, w)
    assert got.dtype == torch.int32
    want = x.long() @ w.long().t()
    assert int(want.abs().max()) == 127 * 127 * k > 2 ** 24
    assert torch.equal(got.long(), want)
    # the card's route: zero rows and columns up to torch._int_mm's shapes
    rng = np.random.default_rng(0)
    for m, kk, n in ((1, 64, 64), (5, 100, 37), (40, 3072, 768)):
        xq = torch.from_numpy(rng.integers(-127, 128, (m, kk)).astype(
            np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (n, kk)).astype(
            np.int8))
        got = Q._int_mm_padded(xq, wq)
        assert got.shape == (m, n)
        assert torch.equal(got.long(), xq.long() @ wq.long().t())


@pytest.fixture(scope="module")
def int8_setup(tmp_path_factory):
    """40 titles on disk, their vocab, a JAX tiny tower and the port
    checkpoint of its weights."""
    d = tmp_path_factory.mktemp("int8")
    titles = [BASE[i % len(BASE)] + "款" * (i % 3) + str(i % 7)
              for i in range(40)]
    keys = [f"s{i}" for i in range(40)]
    pd.DataFrame({"spu_sn": keys, "goods_sku": keys,
                  "spu_name": titles}).to_csv(d / "t.csv", index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    from multimodalsimilar_tpu.models.classifiers import (
        NlpTextClassifier as JNlpTextClassifier)
    jmodel = JNlpTextClassifier(JCFG, num_labels=3,
                                policy=JPolicy.full_precision())
    params = jax.device_get(jmodel.init(
        {"params": jax.random.key(5)}, jnp.zeros((1, 16), jnp.int32),
        label=jnp.zeros(1, jnp.int32)))["params"]
    CheckpointManager(str(d / "ckpt")).save(0, {
        "model": text_classifier_from_jax(params, CFG)})
    return d, vocab, params


def _record_embeddings(monkeypatch, module):
    """Wrap ``module.nlp_similar_job`` to keep the embeddings it gets."""
    seen = {}
    job = module.nlp_similar_job

    def wrapped(table, embed_texts, *a, **kw):
        def embed(texts):
            seen["emb"] = np.asarray(embed_texts(texts), np.float32)
            return seen["emb"]
        return job(table, embed, *a, **kw)

    monkeypatch.setattr(module, "nlp_similar_job", wrapped)
    return seen


def test_similar_nlp_int8_matches_jax_cli(int8_setup, monkeypatch, capsys):
    """The int8 activation scale rounds to a step of 1/127: a last-bit
    difference can move one quantized value by a step, so neighbours
    whose scores are that close may swap. Embeddings agree within 1e-5;
    each key's written list has, neighbour by neighbour, JAX's scores
    (computed on the JAX embeddings) within 1e-5."""
    import multimodalsimilar_tpu.pipelines.similar as jsim
    import multimodalsimilar_tpu_torch.pipelines.similar as psim
    d, vocab, params = int8_setup
    _full_precision(monkeypatch)
    js, ps = _sinks(monkeypatch)
    jseen, pseen = (_record_embeddings(monkeypatch, jsim),
                    _record_embeddings(monkeypatch, psim))
    monkeypatch.setattr(jembedders, "_restore_required",
                        lambda c, template=None: {"params": params})
    argv = ["similar", "nlp", "--config",
            os.path.join(CONFIGS, "similar_nlp.yaml"), "--data",
            str(d / "t.csv"), "--tokenizer", vocab, "--checkpoint",
            str(d / "ckpt"), "--bert_preset", "tiny", "--max_length", "16",
            "--batch_size", "8", "--k", "5", "--score_th", "0.5", "--int8"]
    jcli.main(argv)
    want = _last_json(capsys)
    cli.main(argv, device="cpu")
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == want
    assert want["written"] > 0 and "int8 PTQ text tower" in out.err
    je, pe = jseen["emb"], pseen["emb"]
    np.testing.assert_allclose(pe, je, rtol=0, atol=1e-5 * np.abs(je).max())
    unit = je / np.linalg.norm(je, axis=1, keepdims=True)
    row = {f"s{i}": i for i in range(len(unit))}
    got, exp = _items(ps), _items(js)
    assert got.keys() == exp.keys()
    for key, neighbours in exp.items():
        q = unit[row[key.split(":")[1]]]
        score = [[float(unit[row[n]] @ q) for n in lst.split(",")]
                 for lst in (got[key], neighbours)]
        np.testing.assert_allclose(score[0], score[1], rtol=0, atol=1e-5)


def test_embed_incremental_int8_matches_jax_cli(int8_setup, monkeypatch,
                                                capsys, tmp_path):
    d, vocab, params = int8_setup
    _full_precision(monkeypatch)
    monkeypatch.setattr(jembedders, "_restore_required",
                        lambda c, template=None: {"params": params})
    from multimodalsimilar_tpu.cli import embed as jembed
    from multimodalsimilar_tpu_torch.cli import embed as pembed
    from multimodalsimilar_tpu_torch.pipelines.embed import parse_embeddings
    tables = {}
    for side, cmd in (("jax", jembed.cmd_embed_incremental),
                      ("port", lambda a: pembed.cmd_embed_incremental(
                          a, device="cpu"))):
        table = str(tmp_path / f"{side}.parquet")
        args = jbuild_parser().parse_args(
            ["embed", "incremental", "--data", str(d / "t.csv"), "--table",
             table, "--tokenizer", vocab, "--checkpoint", str(d / "ckpt"),
             "--num_labels", "3", "--max_length", "16", "--batch_size", "8",
             "--dt", "2026-08-16", "--int8"])
        cmd(args)
        tables[side] = pd.read_parquet(table)
    outs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert outs[1] == {**outs[0], "table": outs[1]["table"]}
    assert outs[1]["written"] == 40
    got, want = tables["port"], tables["jax"]
    assert list(got["goods_sku"]) == list(want["goods_sku"])
    np.testing.assert_allclose(parse_embeddings(got["embedding"]),
                               parse_embeddings(want["embedding"]),
                               rtol=0, atol=1e-6)


def test_int8_with_a_pipeline_parallel_checkpoint_exits_as_jax(
        int8_setup, tmp_path, monkeypatch):
    """The JAX embedder rebuilds the stacked layout, then refuses --int8;
    the port refuses with the same message. Without --int8 the JAX orbax
    directory is no port checkpoint (the port's own pipeline-parallel
    checkpoints are in the one-card layout): the port's "no checkpoint"
    error."""
    d, vocab, params = int8_setup
    meta = tmp_path / "pp" / "100" / "default"
    meta.mkdir(parents=True)
    (meta / "_METADATA").write_bytes(b'{"tree": {"pp_layers": {}}}')
    argv = ["similar", "nlp", "--data", str(d / "t.csv"), "--tokenizer",
            vocab, "--checkpoint", str(tmp_path / "pp"), "--bert_preset",
            "tiny", "--max_length", "16", "--int8"]
    args = jbuild_parser().parse_args(argv)
    monkeypatch.setattr(jembedders, "_restore_required",
                        lambda c, template=None: {"params": {}})
    with pytest.raises(SystemExit) as jerr:
        jembedders._build_text_embedder(args)
    with pytest.raises(SystemExit) as err:
        _build_text_embedder(args, device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "pipeline-parallel" in str(err.value)
    args.int8 = False
    with pytest.raises(InputError, match="no checkpoint found"):
        _build_text_embedder(args, device="cpu")
