"""The DeepSeek-V2 text tower (``models/deepseek_v2.py``, ``ops/moe.py``)
against the benchmark's plain reference (``bench_port/reference/
deepseek_v2.py``, imported by path, so the tests and the benchmark's
judge are one file), at a tiny config on the CPU in float32; its faults,
padding, grouped products, import of the published names and the CLI.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu_torch import cli
from multimodalsimilar_tpu_torch.cli import similar as psimilar
from multimodalsimilar_tpu_torch.data.tokenizer import (TextTokenizer,
                                                       build_char_vocab)
from multimodalsimilar_tpu_torch.models import hf_import
from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Config, DeepseekV2Tower, softmax_scale, yarn_inv_freq)
from multimodalsimilar_tpu_torch.ops import moe
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "bench_reference_deepseek_v2",
        os.path.join(ROOT, "bench_port", "reference", "deepseek_v2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()

# the published config.json's keys at the tests' size: one dense and two
# MoE layers, 8 experts of which 2 a token and 1 shared, YaRN over 16
# original positions so that its ramp bends at these lengths
TINY = dict(
    vocab_size=512, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_shared_experts=1, n_routed_experts=8,
    num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=None,
    first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, rms_norm_eps=1e-6, rope_theta=10000,
    topk_method="greedy", scoring_func="softmax", n_group=1, topk_group=1,
    rope_scaling=dict(type="yarn", factor=40,
                      original_max_position_embeddings=16, beta_fast=32,
                      beta_slow=1, mscale=0.707, mscale_all_dim=0.707),
    max_position_embeddings=64, bos_token_id=500, eos_token_id=501,
    attention_bias=False, hidden_act="silu")
# float32 on both sides in another order of sums through three layers:
# the widest gap read over seeds 1-3 is 4e-7 on vectors of norm ~8
TOL = 1e-5


def _weights(seed):
    return lambda part: REF.draw(TINY, seed, part, "cpu")


def _hf_state(seed):
    state = {}
    for part in REF.parts(TINY):
        state.update(REF.draw(TINY, seed, part, "cpu"))
    return state


def _tower(seed, dtype=torch.float32):
    """The port's tower holding the reference's weights of ``seed``,
    through the published names' importer."""
    config = DeepseekV2Config.from_hf(TINY)
    with torch.device("meta"):
        tower = DeepseekV2Tower(config, dtype=dtype)
    dtypes = {k: v.dtype for k, v in tower.state_dict().items()}
    state = hf_import.deepseek_v2_state_from_hf(
        {"model." + k: v for k, v in _hf_state(seed).items()}, config)
    tower.load_state_dict({k: v.to(dtypes[k]) for k, v in state.items()},
                          strict=True, assign=True)
    return tower.eval()


def _batch(seed, lengths=(20, 3, 17, 9, 1, 12)):
    rng = np.random.default_rng(seed)
    L = max(lengths)
    ids = torch.from_numpy(rng.integers(5, 400, (len(lengths), L)))
    mask = torch.zeros(len(lengths), L, dtype=torch.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    ids[:, 0] = TINY["bos_token_id"]
    return (ids * mask).long(), mask


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _gap(tower, seed):
    ids, mask = _batch(seed)
    with torch.no_grad():
        got = tower.predict_emb(ids, mask)
        want = REF.embed_batches(_weights(seed), TINY, [(ids, mask)])[0]
    return float((_unit(got) - _unit(want)).norm(dim=-1).max())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tower_matches_reference(seed):
    assert _gap(_tower(seed), seed) < TOL


def _renormalised(tower):
    for layer in tower.layers[1:]:
        layer.mlp.norm_topk_prob = True


def _no_mscale(tower):
    for layer in tower.layers:
        layer.self_attn.softmax_scale = tower.config.q_head_dim ** -0.5


def _shared_dropped(tower):
    inter = tower.config.moe_intermediate_size
    with torch.no_grad():
        for layer in tower.layers[1:]:
            layer.mlp.shared_experts.down_proj.weight[:, -inter:] = 0.0


@pytest.mark.parametrize("plant", [_renormalised, _no_mscale,
                                   _shared_dropped],
                         ids=["topk_renormalised", "no_yarn_mscale",
                              "shared_expert_dropped"])
def test_planted_faults_fail_the_comparison(plant):
    tower = _tower(1)
    plant(tower)
    assert _gap(tower, 1) > 100 * TOL


def test_yarn_at_the_published_config():
    """The issue's figures for V2-Lite: ramp ends 10 and 23, softmax
    scale 192^-0.5 * 1.2608^2 = 0.11472."""
    cfg = DeepseekV2Config()
    assert softmax_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    f = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    inv = yarn_inv_freq(cfg).double()
    assert torch.allclose(inv[:10], f[:10], rtol=1e-6)
    assert torch.allclose(inv[23:], f[23:] / 40, rtol=1e-6)
    assert (inv[10:23] < f[10:23]).all() and (inv[10:23] > f[10:23] / 40).all()


def test_right_padding_leaves_every_row_unchanged():
    tower = _tower(2)
    lengths = (20, 3, 17, 9, 1, 12)
    ids, mask = _batch(5, lengths)
    with torch.no_grad():
        padded = tower.predict_emb(ids, mask)
        for b, n in enumerate(lengths):
            alone = tower.predict_emb(ids[b:b + 1, :n], mask[b:b + 1, :n])
            wider = tower.predict_emb(
                torch.cat([ids[b:b + 1], torch.zeros(1, 7).long()], 1),
                torch.cat([mask[b:b + 1], torch.zeros(1, 7).int()], 1))
            assert torch.allclose(alone[0], padded[b], atol=1e-6, rtol=1e-5)
            assert torch.allclose(wider[0], padded[b], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_grouped_plain_path_matches_a_per_token_loop(top_k):
    """Route, plan, grouped MLP and combine (float32, as the router and
    the combine compute) against each token through its experts one at a
    time in float64; experts 5-7 get no token."""
    g = torch.Generator().manual_seed(top_k)
    T, H, inter, E = 13, 16, 8, 8
    x = torch.randn(T, H, generator=g)
    gate = torch.randn(E, H, generator=g)
    gate_up = torch.randn(E, 2 * inter, H, generator=g)
    down = torch.randn(E, H, inter, generator=g)
    x[:, 0] = 1.0
    gate[5:, 0] = -1e3
    weights, experts = moe.route(x, gate, top_k)
    assert int(experts.max()) < 5
    p = moe.plan(experts, E)
    assert p.ends.dtype == torch.int32 and p.ends.tolist()[-1] == T * top_k
    assert p.ends[4:].unique().numel() == 1
    got = moe.combine(moe.grouped_mlp(x, p, gate_up, down), p, weights)
    want = torch.zeros(T, H, dtype=torch.float64)
    for t in range(T):
        for j in range(top_k):
            e = int(experts[t, j])
            h = gate_up[e].double() @ x[t].double()
            a = torch.nn.functional.silu(h[:inter]) * h[inter:]
            want[t] += weights[t, j].double() * (down[e].double() @ a)
    # float32 products of 16 and 8 terms against float64
    assert torch.allclose(got.double(), want, rtol=1e-5,
                          atol=1e-5 * float(want.abs().max()))


def test_moe_spans_and_counters():
    tower = _tower(3)
    ids, mask = _batch(3)
    with profiling.recording() as rec, torch.no_grad():
        tower.predict_emb(ids, mask)
    names = {s[0] for s in rec.spans}
    assert {"moe.route", "moe.experts", "moe.combine"} <= names
    moe_layers = TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    assert rec.counters["moe.launches"] == moe_layers
    assert rec.counters["moe.rows_routed"] == \
        moe_layers * ids.numel() * TINY["num_experts_per_tok"]


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_names_round_trip(tmp_path, fmt):
    config = DeepseekV2Config.from_hf(TINY)
    tower = _tower(4)
    hf = hf_import.deepseek_v2_state_to_hf(tower.state_dict(), config)
    want = {"model." + k for k in _hf_state(4)}
    assert set(hf) == want
    assert torch.equal(hf["model.layers.2.mlp.experts.7.up_proj.weight"],
                       _hf_state(4)["layers.2.mlp.experts.7.up_proj.weight"]
                       .float())
    back = hf_import.deepseek_v2_state_from_hf(
        dict(hf, **{"lm_head.weight": torch.zeros(1)}), config)
    assert back.keys() == tower.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in tower.state_dict().items())
    if fmt == "bin":
        torch.save(hf, tmp_path / "pytorch_model.bin")
    else:
        safetensors = pytest.importorskip("safetensors.torch")
        half = len(hf) // 2
        for i, keys in enumerate((list(hf)[:half], list(hf)[half:])):
            safetensors.save_file({k: hf[k].contiguous() for k in keys},
                                  str(tmp_path / f"model-{i}.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    cfg2, state = hf_import.load_deepseek_v2_checkpoint(str(tmp_path))
    assert cfg2 == config
    assert all(torch.equal(state[k], v) for k, v in back.items())


def test_with_bos_tokenizer_matches_the_reference():
    titles = ["红富士 苹果", "a", "", "橙汁100%" * 5]
    tokens = build_char_vocab(titles)
    tok = TextTokenizer.from_vocab(tokens).with_bos(500)
    out = tok(titles, 12)
    ids, mask = REF.tokenize(titles, tokens, 500, 12)
    assert np.array_equal(out["input_ids"], ids)
    assert np.array_equal(out["attention_mask"], mask)
    assert tok.vocab_size == 501


def test_transformers_deepseek_v2_model_agrees_save_its_scale():
    """transformers' own ``DeepseekV2Model`` (4.57.6) on the same weights.
    Its departures from the published ``modeling_deepseek.py``: the
    attention scale is ``q_head_dim^-0.5`` without YaRN's mscale^2 (so
    the port is compared at that scale here), and the rotary product
    keeps the pairs interleaved (complex numbers) where the published
    code de-interleaves them, a common permutation of the rotary dims of
    queries and keys that leaves the scores as they are."""
    transformers = pytest.importorskip("transformers")
    try:
        from transformers import DeepseekV2Config as HFConfig
        from transformers import DeepseekV2Model
    except ImportError:
        pytest.skip(f"transformers {transformers.__version__} has no "
                    f"DeepseekV2Model")
    hf_cfg = HFConfig(**TINY)
    hf_cfg._attn_implementation = "eager"
    model = DeepseekV2Model(hf_cfg).eval()
    model.load_state_dict({k: v.float() for k, v in _hf_state(6).items()},
                          strict=True)
    tower = _tower(6)
    for layer in tower.layers:
        layer.self_attn.softmax_scale = tower.config.q_head_dim ** -0.5
    ids, mask = _batch(6)
    with torch.no_grad():
        h = model(input_ids=ids, attention_mask=mask).last_hidden_state
        m = mask.float()[:, :, None]
        want = (h * m).sum(1) / m.sum(1)
        got = tower.predict_emb(ids, mask)
    assert float((_unit(got) - _unit(want)).norm(dim=-1).max()) < TOL


TITLES = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
          "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]


def _similar(monkeypatch, csv, extra):
    sink = InMemoryKVSink()
    monkeypatch.setattr(psimilar, "_kv_sink", lambda a: sink)
    cli.main(["similar", "nlp", "--data", str(csv), "--text_tower",
              "deepseek_v2_lite", "--max_length", "16", "--batch_size", "8",
              "--k", "4", "--score_th", "0.0"] + extra, device="cpu")
    return {k: v for k, (v, _) in sink.data.items()}


def test_similar_nlp_cli_runs_the_tower(tmp_path, monkeypatch, capsys):
    """``similar nlp --text_tower deepseek_v2_lite`` on a tiny catalog:
    each title and its near-duplicate (one character added at the end,
    so every earlier position is the same under causal attention) list
    each other first; the seed-0 tower saved under the published names
    and loaded with ``--checkpoint`` writes the same lists."""
    titles = TITLES + [t + "X" for t in TITLES]
    keys = [f"s{i}" for i in range(len(titles))]
    csv = tmp_path / "t.csv"
    pd.DataFrame({"spu_sn": keys, "spu_name": titles}).to_csv(csv,
                                                               index=False)
    items = _similar(monkeypatch, csv, ["--deepseek_preset", "tiny"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"written": len(titles)}
    n = len(TITLES)
    for i in range(n):
        assert items[f"dj_similar:s{i}"].split(",")[0] == f"s{i + n}"
        assert items[f"dj_similar:s{i + n}"].split(",")[0] == f"s{i}"
    # the same seed-0 tower through the published names
    with torch.device("cpu"):
        tower = DeepseekV2Tower(
            DeepseekV2Config.tiny(),
            generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(hf_import.deepseek_v2_state_to_hf(tower.state_dict(),
                                                 tower.config),
               ckpt / "pytorch_model.bin")
    hf = dict(TINY, bos_token_id=DeepseekV2Config.tiny().bos_token_id,
              initializer_range=0.1)
    (ckpt / "config.json").write_text(json.dumps(hf))
    vocab = tmp_path / "vocab.txt"
    build_char_vocab(titles, out_path=str(vocab))
    assert _similar(monkeypatch, csv, ["--checkpoint", str(ckpt),
                                       "--tokenizer", str(vocab)]) == items


def test_text_embedder_cuts_batches_for_the_tower():
    """``TextEmbedder`` embeds with the tower as with BERT: sorted,
    trimmed batches give each row what it gets alone."""
    tower = _tower(7)
    titles = ["一二三四五六七八九十" * 2, "苹果", "香蕉 进口", "x", "橙汁 100%"]
    tokens = build_char_vocab(titles)
    tok = TextTokenizer.from_vocab(tokens).with_bos(500)
    emb = TextEmbedder(tower, tok, max_length=16, batch_size=2,
                       device="cpu")(titles)
    ids, mask = REF.tokenize(titles, tokens, 500, 16)
    want = REF.embed_batches(_weights(7), TINY, [
        (torch.from_numpy(ids).long(), torch.from_numpy(mask))])[0]
    got = torch.from_numpy(emb)
    assert float((_unit(got) - _unit(want)).norm(dim=-1).max()) < TOL
