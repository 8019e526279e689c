"""The plain reference agrees with the port on the CPU at tiny sizes,
with the port under its full-precision policy: the BERT encoder and the
tokenizer, EfficientNet in training mode with the neck and the ArcFace
loss (the same dropout and drop-path masks), and the exact search."""

import numpy as np
import pytest
import torch

from benchlib import gen
from benchlib.registry import driver
from benchlib.weights import draw
from reference import bert as ref_bert
from reference import efficientnet as ref_eff
from reference import search as ref_search
from tiny import job_cell, train_cell


def test_tokenizer_matches_the_port():
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    tokens = ref_bert.vocab(gen.TITLE_POOL)
    titles = gen.make_titles(64, gen.rng_for(1)) + ["a b", "x" * 300]
    want, mask = ref_bert.tokenize(titles, tokens, 24)
    got = TextTokenizer.from_vocab(tokens)(titles, 24)
    assert (got["input_ids"] == want).all()
    assert (got["attention_mask"] == mask).all()


def test_bert_matches_the_port():
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    cfg = job_cell().config
    params = ref_bert.finish(draw(ref_bert.param_specs(cfg), 5, "cpu"))
    with torch.device("meta"):
        model = NlpTextClassifier(driver("similar_job").bert_config(cfg),
                                  policy=DTypePolicy.full_precision())
    state = {"tower.encoder." + k: v for k, v in params.items()}
    state["head.weight"] = torch.zeros(2, cfg["hidden_size"])
    model.load_state_dict(state, assign=True, strict=True)
    tokens = ref_bert.vocab(gen.TITLE_POOL)
    titles = gen.make_titles(16, gen.rng_for(2), 8, 20)
    ids, mask = ref_bert.tokenize(titles, tokens, 24)
    with torch.no_grad():
        got = model.predict_emb(torch.from_numpy(ids),
                                torch.from_numpy(mask),
                                torch.zeros_like(torch.from_numpy(ids)))
    want = ref_bert.embed(params, cfg, titles, tokens, 24, "cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_efficientnet_step_matches_the_port():
    from multimodalsimilar_tpu_torch.models.bert import set_dropout_generator
    from multimodalsimilar_tpu_torch.models.vision import (CvImageClassifier,
                                                           backbone_config)
    from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
    from multimodalsimilar_tpu_torch.train.tasks import cv_arcface_task
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    cell = train_cell()
    cfg, recipe = cell.config, cell.config["recipe"]
    n_cls = recipe["num_classes"]
    specs = ref_eff.param_specs(cfg, n_cls)
    model = CvImageClassifier(backbone_config("tiny"), num_labels=n_cls,
                              fc_dim=cfg["fc_dim"],
                              arcface=ArcFaceParams(m=0.2),
                              policy=DTypePolicy.full_precision())
    model.load_state_dict(ref_eff.finish(draw(specs, 3, "cpu")),
                          strict=True)
    model.train()
    gen_p = torch.Generator().manual_seed(99)
    set_dropout_generator(model, gen_p)
    images = torch.from_numpy(gen.make_images(gen.rng_for(4), 4, 64))
    labels = torch.tensor([1, 7, 7, 49])
    loss, _ = cv_arcface_task(model).train_loss(
        {"images": images, "labels": labels}, 0.2)
    loss.backward()

    P = ref_eff.finish(draw(specs, 3, "cpu"))
    names = ref_eff.trainable(P)
    for n in names:
        P[n].requires_grad_(True)
    gen_r = torch.Generator().manual_seed(99)
    emb = ref_eff.forward(P, cfg, images, ref_eff.Masks(gen_r))
    want = ref_eff.arcface_loss(emb, P["head.weight"], labels, 0.2,
                                recipe["arcface_s"])
    grads = torch.autograd.grad(want, [P[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    params = dict(model.named_parameters())
    # leaves before a BatchNorm have a gradient of nought to rounding:
    # their gap is taken against the median leaf's largest entry
    median = float(torch.stack([g.abs().max() for g in grads]).median())
    for n, g in zip(names, grads):
        scale = max(float(g.abs().max()), median)
        assert float((params[n].grad - g).abs().max()) <= 1e-4 * scale, n


def test_exact_search_matches_the_port():
    from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
    from multimodalsimilar_tpu_torch.retrieval.filters import FilterRules
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    emb[10] = emb[3]                      # a tie, to the lower index
    keys = [f"k{i}" for i in range(300)]
    engine = SimilarityEngine(emb, keys, metric="ip", normalize=True,
                              device="cpu")
    got = engine.similar_map(13, FilterRules(score_threshold=0.2,
                                             same_category=False))
    corpus = ref_search.normalized64(emb, "cpu")
    rows = list(range(300))
    scores, order = ref_search.ranked(corpus, rows, 13)
    key_row = {k: i for i, k in enumerate(keys)}
    for q in rows:
        written = [key_row[k] for k in got.get(keys[q], [])]
        assert ref_search.list_gap(scores[q], order[q], q, written, keys,
                                   0.2) < 1e-6
        assert written == ref_search.expected_list(scores[q], order[q], q,
                                                   keys, 0.2)
