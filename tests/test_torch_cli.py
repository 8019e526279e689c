"""The port's command line against the JAX package's, on the CPU.

* The parser: every subcommand, flag, default and ``set_defaults`` of the
  JAX ``build_parser``; each of the 22 ``configs/*.yaml`` (with the argv
  of ``tests/test_configs.py:CASES``) and each subcommand's bare defaults
  give the JAX Namespace, minus ``fn`` and ``config``.
* The readers: ``cli/config.py`` equals ``yaml.safe_load`` on every config
  and on a file of each scalar form, and refuses what it does not read;
  ``read_table`` equals ``pd.read_csv`` (values and types per column).
* The commands, ``main(argv, device="cpu")`` against the JAX CLI's
  ``main`` on the same weights (carried over with
  ``text_classifier_from_jax`` / ``multimodal_classifier_from_jax`` /
  ``fasttext_from_jax``; the JAX side's checkpoint restore is replaced by
  the JAX tree, since its checkpoints are orbax directories), every
  tower in full precision: the KV writes of ``similar nlp`` (with
  ``--dt``), ``similar multimodal`` (both routes) and ``similar daodian``
  (v1, v2 date-keyed, v2 recent days; ``--text_only``), and ``train
  fasttext``'s losses and saved vectors.
* ``copy-kv`` and ``download`` with fakes, ``hive://`` through the stub
  pyspark of ``tests/test_spark_adapter.py``, ``--tokenizer <dir>``
  through ``TextTokenizer.from_hf`` on a directory written locally.
"""

import argparse
import json
import math
import os
import pickle
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

import multimodalsimilar_tpu.cli as jcli
from multimodalsimilar_tpu.cli import embedders as jembedders
from multimodalsimilar_tpu.cli import similar as jsimilar
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models import fasttext as JF
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JNlpTextClassifier)
from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.pipelines.embedders import (
    MultimodalEmbedder as JMultimodalEmbedder)
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryKVSink as JInMemoryKVSink)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch import cli
from multimodalsimilar_tpu_torch.cli import config as C
from multimodalsimilar_tpu_torch.cli import parser as P
from multimodalsimilar_tpu_torch.cli import similar as psimilar
from multimodalsimilar_tpu_torch.data.datasets import read_table
from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
from multimodalsimilar_tpu_torch.models import fasttext as PF
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    fasttext_from_jax, multimodal_classifier_from_jax,
    text_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
from tests.test_configs import CASES
from tests.test_spark_adapter import pyspark_stub  # noqa: F401
from tests.test_torch_image_serving import _jiggle, images

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")


# -- the parser ---------------------------------------------------------------

def _actions(parser, path=()):
    """{subcommand path: ({dest: the action's parse contract},
    set_defaults without fn)} of a parser tree."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_actions(sub, path + (name,)))
    if path:
        acts = {a.dest: (tuple(a.option_strings), type(a).__name__,
                         a.default, a.type,
                         tuple(a.choices) if a.choices else None,
                         a.required, a.nargs, a.const, a.metavar)
                for a in parser._actions
                if not isinstance(a, (argparse._HelpAction,
                                      argparse._SubParsersAction))}
        out[path] = (acts, {k: v for k, v in parser._defaults.items()
                            if k != "fn"})
    return out


# the subcommands that take the text embedder's flags, and with them the
# port's own flags (``cli/parser.py:PORT_ONLY``)
TEXT_EMBEDDER = {("similar", "nlp"), ("embed", "incremental"),
                 ("embed", "bulk")}


def test_parser_has_every_jax_subcommand_and_flag():
    """Every JAX subcommand, flag and default, and beside them only the
    port's own ``PORT_ONLY`` flags, on the text embedder's subcommands,
    at defaults that run the JAX command."""
    want, got = _actions(jcli.build_parser()), _actions(cli.build_parser())
    assert set(got) == set(want) and len(want) == 20
    for path in want:
        acts = dict(got[path][0])
        own = {d: acts.pop(d)[2] for d in P.PORT_ONLY if d in acts}
        assert own == (P.PORT_ONLY if path in TEXT_EMBEDDER else {}), path
        assert (acts, got[path][1]) == want[path], path


def _namespace(build, inject, apply, argv):
    parser = build()
    argv = inject(list(argv), parser)
    args = parser.parse_args(argv)
    apply(args, argv)
    return {k: v for k, v in vars(args).items() if k not in ("fn", "config")}


def _jax_namespace(argv):
    return _namespace(jcli.build_parser, jcli._inject_yaml_argv,
                      jcli._apply_yaml_config, argv)


def _port_namespace(argv):
    """The port's namespace without its own flags, each at its default
    (``cli/parser.py:PORT_ONLY``)."""
    from multimodalsimilar_tpu_torch.cli.common import _apply_yaml_config
    ns = _namespace(cli.build_parser, P._inject_yaml_argv,
                    _apply_yaml_config, argv)
    own = {d: ns.pop(d) for d in P.PORT_ONLY if d in ns}
    assert own in ({}, P.PORT_ONLY), own
    return ns


@pytest.mark.parametrize("fname", sorted(CASES))
def test_config_gives_the_jax_namespace(fname):
    argv = CASES[fname] + ["--config", os.path.join(CONFIGS, fname)]
    got, want = _port_namespace(argv), _jax_namespace(argv)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


BARE = {
    "train_cv": ["train", "cv", "--data", "x", "--img_root", "r"],
    "train_multimodal": ["train", "multimodal", "--data", "x",
                         "--img_root", "r"],
    "embed_incremental": ["embed", "incremental", "--data", "x",
                          "--table", "t"],
    "embed_bulk": ["embed", "bulk", "--data", "x", "--table", "t"],
    "similar_daodian": ["similar", "daodian", "--data", "x",
                        "--fasttext_model", "m"],
    "copy_kv": ["copy-kv", "--src_host", "a", "--dst_host", "b"],
    "import": ["import-checkpoint", "--kind", "nlp", "--state_dict", "s",
               "--out", "o"],
    "export": ["export-checkpoint", "--kind", "cv", "--checkpoint", "c",
               "--out", "o"],
    "download": ["download", "--manifest", "m", "--out_root", "o"],
    **{f"train_{m}": ["train", m, "--data", "x"]
       for m in ("nlp", "multilabel", "pair", "fasttext")},
    **{f"similar_{m}": ["similar", m, "--data", "x"]
       for m in ("nlp", "multimodal")},
    "serve": ["serve", "--data", "x"], "eval": ["eval", "--data", "x"],
}


@pytest.mark.parametrize("name", sorted(BARE))
def test_bare_defaults_give_the_jax_namespace(name):
    assert _port_namespace(BARE[name]) == _jax_namespace(BARE[name])
    args = cli.build_parser().parse_args(BARE[name])
    assert args.fn.__module__.startswith("multimodalsimilar_tpu_torch.cli")


def test_explicit_flags_beat_the_config_and_unknown_keys_die(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("epochs: 30\nbatch_size: 256\nno_clean: false\n"
                   "seq_buckets: [48, 64]\n")
    argv = ["train", "nlp", "--data", "x", "--config", str(cfg),
            "--epochs=5", "--no_clean"]
    got = _port_namespace(argv)
    assert got == _jax_namespace(argv)
    assert (got["epochs"], got["batch_size"], got["no_clean"],
            got["seq_buckets"]) == (5, 256, True, "48,64")
    cfg.write_text("batch_sise: 32\n")
    with pytest.raises(SystemExit, match="unknown flags.*batch_sise"):
        cli.main(["train", "nlp", "--config", str(cfg), "--data", "x"],
                 device="cpu")


# -- the config reader --------------------------------------------------------

def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("fname", sorted(CASES))
def test_config_reader_equals_safe_load(fname):
    path = os.path.join(CONFIGS, fname)
    got, want = C.load_config(path), yaml.safe_load(open(path)) or {}
    assert list(got) == list(want)
    assert all(_same(got[k], want[k]) for k in want), fname


SCALARS = r"""# every scalar form the reader resolves
f1: 5.0e-5
f2: 1.0e-3
f3: 1.0e+3
f4: 1.
f5: .5
f6: -.inf
f7: .NaN
f8: 3.14_15
f9: 1:30.5
s1: "48,64,96"
s2: 48,64,96
s3: 127.0.0.1
s4: 1e5
s5: 08
s6: a#b
s7: 'it''s'
s8: "tab\there \u00e9 \"q\""
s9: -2026-08-16
s10: 商品 标题
s11: "  spaced  "
s12: ~user
b1: true
b2: False
b3: yes
b4: Off
n1: null
n2: ~
n3:
i1: 007
i2: 0x1F
i3: 0b101
i4: 1_000
i5: 1:30
i6: +12
i7: -0
d1: 2026-08-16
l1: [48, 64, "x", yes, 1.5e-3]
l2: []
l3:
  - 48
  - "64"
l4:
- a
- 2.5
dup: 1
dup: 2   # a duplicate key keeps its last value
"""


def test_config_reader_resolves_every_scalar_form_as_safe_load():
    got, want = C.parse_config(SCALARS), yaml.safe_load(SCALARS)
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), (k, got[k], want[k])


REFUSED = {
    "nested": "a:\n  b: 1\n",
    "flow_map": "a: {x: 1}\n",
    "anchor": "a: &x 1\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  x\n",
    "mapping_value": "a: b: c\n",
    "unterminated": "a: 'x\n",
    "top_list": "- 1\n",
    "nested_list": "a: [[1]]\n",
    "timestamp": "a: 2026-08-16 10:00:00\n",
    "continuation": "a: x\n  y\n",
    "document": "---\na: 1\n",
    "bool_key": "on: 1\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_config_reader_refuses_what_it_does_not_read(name, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(REFUSED[name])
    with pytest.raises(C.ConfigError, match=r"bad\.yaml:\d+: "):
        C.load_config(str(path))


# -- read_table ---------------------------------------------------------------

TABLES = {
    "catalog": 'spu_sn,goods_sku,spu_name,price,dt\n'
               's1,007,"苹果, 红富士 5斤",1.5,2026-08-16\n'
               's2,010,纯牛奶 250ml,,20260816\n'
               's3,123,"可乐 ""罐装""",2,2026-08-15\n',
    "empty_fields": "a,b,c,d\n1,x,,True\n,y,,\n3,,,FALSE\n",
    "na_strings": "a,b\nNA,1\nnull,2\nNone,3\nn/a,4\nabc,5\n",
    "numbers": "a,b,c,d\n1e5,+4,-0,inf\n.5, 5 ,7,-Infinity\n1.,6,8,1\n",
    "big_ints": "a,b,c\n9223372036854775808,99999999999999999999,1\n"
                "1,1,-1\n",
    "strings": "a,b,c\n0x10,1_000,' x '\n1,2,.\n",
    "header": ",a,a,\n1,2,3,4\n",
    "ragged": "a,b\n1\n\n2,3\n   \n",
    "one_column": "a\n1\n\n3\n",
    "header_only": "a,b\n",
    "bom_crlf": "\ufeffa,b\r\n1,2\r\n",
    "quoted_newline": 'a,b\n"x\ny",1\n"",2\n',
}


def _pandas_columns(path):
    df = pd.read_csv(path)
    return {c: df[c].tolist() for c in df.columns}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_read_table_equals_pandas(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_bytes(TABLES[name].encode("utf-8"))
    got, want = read_table(str(path)), _pandas_columns(str(path))
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c])
        for g, w in zip(got[c], want[c]):
            assert _same(g, w) or (isinstance(w, float) and type(g) is float
                                   and g == w), (c, got[c], want[c])


def test_read_table_random_table_equals_pandas(tmp_path):
    """Random floats (repr and fixed-point forms), ints with missing
    fields, titles: every value and type as pandas reads it."""
    rng = np.random.default_rng(0)
    n = 500
    df = pd.DataFrame({
        "f": rng.normal(0, 1e3, n), "g": rng.random(n),
        "i": rng.integers(-10**12, 10**12, n).astype(float),
        "t": [f"商品{i} {'甲乙丙'[i % 3]}" for i in range(n)]})
    df.loc[::7, "i"] = np.nan
    path = str(tmp_path / "r.csv")
    df.to_csv(path, index=False, float_format=None)
    with open(path, "a") as f:
        f.write("1.23456789012345678e-300,0.1,,x\n")
    got, want = read_table(path), _pandas_columns(path)
    for c in want:
        assert all(_same(g, w) for g, w in zip(got[c], want[c])), c


def test_read_table_errors_name_the_file(tmp_path):
    from multimodalsimilar_tpu_torch.data.datasets import InputError
    with pytest.raises(InputError, match="not found"):
        read_table(str(tmp_path / "none.csv"))
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,2,3\n")
    with pytest.raises(InputError, match="row 2 has 3 fields"):
        read_table(str(path))
    path.write_text("a,b\n1,2\n")
    with pytest.raises(InputError, match=r"missing column\(s\) \['c'\]"):
        read_table(str(path), require=["c"])


def test_config_and_csv_need_neither_pyyaml_nor_pandas(tmp_path):
    """A process where ``import yaml`` and ``import pandas`` fail (the
    card machine) parses every config and reads a CSV."""
    path = tmp_path / "t.csv"
    path.write_text("spu_sn,spu_name,dt\ns1,苹果,2026-08-16\n",
                    encoding="utf-8")
    code = f"""
import sys
for m in ("yaml", "pandas"):
    sys.modules[m] = None
from multimodalsimilar_tpu_torch.cli import build_parser
from multimodalsimilar_tpu_torch.cli.parser import _inject_yaml_argv
from multimodalsimilar_tpu_torch.data.datasets import read_table
import os
argv = ["similar", "nlp", "--data", "x", "--config",
        os.path.join({CONFIGS!r}, "similar_nlp.yaml")]
args = build_parser().parse_args(_inject_yaml_argv(argv, build_parser()))
assert args.bert_preset == "base" and args.exp_seconds == 604800
assert read_table({str(path)!r}) == {{"spu_sn": ["s1"], "spu_name": ["苹果"],
                                     "dt": ["2026-08-16"]}}
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- the commands against the JAX CLI -----------------------------------------

BASE = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
        "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]


def _full_precision(monkeypatch):
    """Both packages' inference policy in f32, so the towers agree to
    ~1e-6 and the KV writes exactly."""
    monkeypatch.setattr(JPolicy, "inference",
                        classmethod(lambda cls: cls.full_precision()))
    monkeypatch.setattr(DTypePolicy, "inference",
                        classmethod(lambda cls: cls.full_precision()))


def _sinks(monkeypatch):
    js, ps = JInMemoryKVSink(), InMemoryKVSink()
    monkeypatch.setattr(jsimilar, "_kv_sink", lambda a: js)
    monkeypatch.setattr(psimilar, "_kv_sink", lambda a: ps)
    monkeypatch.setattr(jsimilar, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))
    return js, ps


def _items(sink):
    return {k: v for k, (v, _) in sink.data.items()}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def text_setup(tmp_path_factory):
    """40 titles on two days on disk, their vocab, a JAX tiny tower and
    the port checkpoint of its weights."""
    d = tmp_path_factory.mktemp("text")
    rng = np.random.default_rng(0)
    titles = [BASE[int(rng.integers(0, len(BASE)))] + str(i % 5)
              for i in range(40)]
    pd.DataFrame({"spu_sn": [f"s{i}" for i in range(40)],
                  "spu_name": titles,
                  "dt": ["2026-08-16" if i % 3 else "20260815"
                         for i in range(40)]}).to_csv(d / "t.csv",
                                                      index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    jmodel = JNlpTextClassifier(JBertConfig.tiny(), num_labels=3,
                                policy=JPolicy.full_precision())
    params = jax.device_get(jmodel.init(
        {"params": jax.random.key(3)}, jnp.zeros((1, 16), jnp.int32),
        label=jnp.zeros(1, jnp.int32)))["params"]
    CheckpointManager(str(d / "ckpt")).save(0, {
        "model": text_classifier_from_jax(params, BertConfig.tiny())})
    return d, vocab, params


@pytest.mark.parametrize("dt", [None, "2026-08-16"], ids=["all", "dt"])
def test_similar_nlp_matches_jax_cli(text_setup, monkeypatch, capsys, dt):
    d, vocab, params = text_setup
    _full_precision(monkeypatch)
    js, ps = _sinks(monkeypatch)
    monkeypatch.setattr(jembedders, "_restore_required",
                        lambda c, template=None: {"params": params})
    argv = ["similar", "nlp", "--config",
            os.path.join(CONFIGS, "similar_nlp.yaml"), "--data",
            str(d / "t.csv"), "--tokenizer", vocab, "--checkpoint",
            str(d / "ckpt"), "--bert_preset", "tiny", "--max_length", "16",
            "--batch_size", "8", "--k", "5", "--score_th", "0.5"]
    if dt:
        argv += ["--dt", dt]
    jcli.main(argv)
    want = _last_json(capsys)
    cli.main(argv, device="cpu")
    assert _last_json(capsys) == want and want["written"] > 0
    assert _items(ps) == _items(js)
    if dt:
        assert not any(k in _items(ps) for k in ("dj_similar:s0",
                                                 "dj_similar:s3"))


def test_similar_nlp_dt_refusals_match_jax(text_setup, tmp_path):
    d, vocab, _ = text_setup
    base = ["similar", "nlp", "--data", str(d / "t.csv"), "--tokenizer",
            vocab, "--bert_preset", "tiny", "--max_length", "16"]
    nodt = tmp_path / "nodt.csv"
    nodt.write_text("spu_sn,spu_name\ns1,苹果\n", encoding="utf-8")
    for argv in (base + ["--dt", "2025-01-01"],
                 ["similar", "nlp", "--data", str(nodt), "--dt", "2026"]):
        with pytest.raises(SystemExit) as want:
            jcli.main(argv)
        with pytest.raises(SystemExit) as got:
            cli.main(argv, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="pallas_topk"):
        cli.main(base + ["--pallas_topk"], device="cpu")


IMG, FC, N_MM = 32, 16, 12


@pytest.fixture(scope="module")
def mm_setup(tmp_path_factory):
    """Pairs on disk ({img_root}/{key}.jpg, the last key without one),
    their fused vectors as '[x,y,...]' strings with two empty ones, the
    vocab, a port checkpoint and the JAX embedder of the same weights."""
    d = tmp_path_factory.mktemp("mm")
    keys = [f"spu{i}" for i in range(N_MM)]
    titles = [BASE[i % len(BASE)] + str(i) for i in range(N_MM)]
    os.makedirs(d / "img")
    for k, im in zip(keys[:-1], images(N_MM, seed=41, size=IMG)):
        cv2.imwrite(str(d / "img" / f"{k}.jpg"), im)
    vecs = np.random.default_rng(5).normal(size=(N_MM, 6))
    strs = ["[" + ",".join(f"{x:.6f}" for x in v) + "]" for v in vecs]
    strs[3], strs[7] = "", "[]"
    pd.DataFrame({"spu_sn": keys, "spu_name": titles,
                  "multimodal_emb": strs}).to_csv(d / "pairs.csv",
                                                  index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    jmodel = JMultimodalClassifier(JBertConfig.tiny(),
                                   JEfficientNetConfig.tiny(), num_labels=5,
                                   fc_dim=FC, policy=JPolicy.full_precision())
    v = _jiggle(jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(9)}, x, i, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 12), jnp.int32)), 10)
    CheckpointManager(str(d / "ckpt")).save(0, {
        "model": multimodal_classifier_from_jax(
            v, BertConfig.tiny(), EfficientNetConfig.tiny())})
    jemb = JMultimodalEmbedder(jmodel, v, JTokenizer.from_vocab_file(vocab),
                               max_length=12, image_size=IMG, batch_size=8)
    return d, vocab, jemb


@pytest.mark.parametrize("route", ["embedding_col", "checkpoint"])
def test_similar_multimodal_matches_jax_cli(mm_setup, monkeypatch, capsys,
                                            route):
    d, vocab, jemb = mm_setup
    _full_precision(monkeypatch)
    js, ps = _sinks(monkeypatch)
    monkeypatch.setattr(jembedders, "_multimodal_embedder",
                        lambda a, df: jemb)
    argv = ["similar", "multimodal", "--data", str(d / "pairs.csv"),
            "--k", "4"]
    if route == "checkpoint":
        argv += ["--checkpoint", str(d / "ckpt"), "--tokenizer", vocab,
                 "--img_root", str(d / "img"), "--backbone", "tiny",
                 "--image_size", str(IMG), "--fc_dim", str(FC),
                 "--num_labels", "5", "--max_length", "12",
                 "--batch_size", "8"]
    jcli.main(argv)
    want = capsys.readouterr()
    cli.main(argv, device="cpu")
    got = capsys.readouterr()
    assert got.out == want.out
    assert json.loads(got.out)["written"] == N_MM - (
        2 if route == "embedding_col" else 1)
    assert ("skipping 2 rows" in got.err) == (route == "embedding_col")
    assert _items(ps) == _items(js)


def test_similar_multimodal_refusals_match_jax(mm_setup, tmp_path):
    d, _, _ = mm_setup
    empty = tmp_path / "e.csv"
    empty.write_text("spu_sn,multimodal_emb\na,\nb,[]\n")
    for argv in (["similar", "multimodal", "--data", str(d / "pairs.csv"),
                  "--embedding_col", "nope"],
                 ["similar", "multimodal", "--data", str(empty)]):
        with pytest.raises(SystemExit) as want:
            jcli.main(argv)
        with pytest.raises(SystemExit) as got:
            cli.main(argv, device="cpu")
        assert str(got.value) == str(want.value)


CATS = {10: {101: "苹果 水果 新鲜", 102: "香蕉 水果 甜"},
        20: {201: "牛奶 乳品 醇香", 202: "酸奶 乳品 发酵"}}


@pytest.fixture(scope="module")
def daodian_setup(tmp_path_factory):
    """Two areas of 36 rows on two days, a JAX fastText model trained on
    them (pickled for the JAX command) and its port carry-over (saved for
    the port's)."""
    d = tmp_path_factory.mktemp("dd")
    rows, i = [], 0
    for area in (1, 2):
        for lv1, lv2s in CATS.items():
            for lv2, words in lv2s.items():
                for k in range(9):
                    rows.append({"area_id": area,
                                 "spu_sn": f"s{area}_{lv2}_{k}",
                                 "sku": str(1000 + i),
                                 "title": f"{words} 商品{i % 5}号",
                                 "first_level_category_id": lv1,
                                 "second_level_category_id": lv2,
                                 "dt": ["2026-08-16", "2026-08-15"][k % 2]})
                    i += 1
    df = pd.DataFrame(rows)
    df.to_csv(d / "skus.csv", index=False)
    jft = JF.train_supervised(df["title"].tolist(),
                              df["second_level_category_id"].tolist(),
                              dim=16, epochs=8, bucket=2000, batch_size=32)
    with open(d / "ft.pkl", "wb") as f:
        pickle.dump(jft, f)
    fasttext_from_jax({k: np.asarray(v) for k, v in jft.params.items()},
                      jft.vocab.words, jft.vocab.bucket, jft.labels, jft.dim,
                      jft.word_ngrams, jft.max_tokens,
                      device="cpu").save(str(d / "ft.pt"))
    return d


@pytest.mark.parametrize("variant", ["v1", "v2_date_keyed",
                                     "v2_recent_days"])
def test_similar_daodian_matches_jax_cli(daodian_setup, monkeypatch, capsys,
                                         variant):
    d = daodian_setup
    js, ps = _sinks(monkeypatch)
    config = {"v1": "similar_daodian_v1.yaml",
              "v2_date_keyed": "similar_daodian_v1.yaml",
              "v2_recent_days": "similar_daodian_v2_recent_days.yaml"}
    argv = ["similar", "daodian", "--config",
            os.path.join(CONFIGS, config[variant]), "--data",
            str(d / "skus.csv"), "--text_only"]
    if variant != "v1":
        argv += ["--dt", "2026-08-16", "--date_keyed", "--recent_days", "2"]
    jcli.main(argv + ["--fasttext_model", str(d / "ft.pkl")])
    want = _last_json(capsys)
    cli.main(argv + ["--fasttext_model", str(d / "ft.pt")], device="cpu")
    assert _last_json(capsys) == want == {"skus": 72}
    assert _items(ps) == _items(js) and _items(ps)
    ttl = {k: t for k, (_, t) in ps.data.items()}
    assert len({round(t, -2) for t in ttl.values() if t}) == 1
    prefix = "20260816:" if variant != "v1" else "s"
    assert all(k.startswith(prefix) for k in _items(ps))


def test_similar_daodian_refusals_match_jax(daodian_setup):
    d = daodian_setup
    base = ["similar", "daodian", "--data", str(d / "skus.csv")]
    for extra in ([], ["--text_only", "--date_keyed"],
                  ["--text_only", "--dt_col", "dt"]):
        with pytest.raises(SystemExit) as want:
            jcli.main(base + extra + ["--fasttext_model",
                                      str(d / "ft.pkl")])
        with pytest.raises(SystemExit) as got:
            cli.main(base + extra + ["--fasttext_model", str(d / "ft.pt")],
                     device="cpu")
        assert str(got.value) == str(want.value)


def test_train_fasttext_matches_jax_cli(daodian_setup, monkeypatch, capsys,
                                        tmp_path):
    """Both commands from the port's initial weights (JAX's init_params
    replaced), JAX's per-step losses read through a debug callback on its
    cross-entropy; the saved models hold the same vectors."""
    d = daodian_setup
    monkeypatch.setattr(JF, "init_params", lambda rng, v, dim, n: {
        k: jnp.asarray(t.numpy()) for k, t in PF.init_params(
            torch.Generator().manual_seed(0), v, dim, n).items()})
    jax_losses = []

    def ce(logits, y):
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        jax.debug.callback(lambda v: jax_losses.append(float(v)),
                           loss.mean())
        return loss

    class _Optax:
        linear_schedule = staticmethod(optax.linear_schedule)
        softmax_cross_entropy_with_integer_labels = staticmethod(ce)

    monkeypatch.setattr(JF, "optax", _Optax)
    argv = ["train", "fasttext", "--config",
            os.path.join(CONFIGS, "train_fasttext.yaml"), "--data",
            str(d / "skus.csv"), "--eval_data", str(d / "skus.csv"),
            "--text_col", "title", "--label_col", "second_level_category_id",
            "--dim", "8", "--lr", "0.5", "--epochs", "40"]
    jcli.main(argv + ["--output", str(tmp_path / "jax")])
    want = _last_json(capsys)
    model = cli.main(argv + ["--output", str(tmp_path / "port")],
                     device="cpu")
    assert _last_json(capsys) == want and want["n"] == 72
    assert len(jax_losses) == len(model.train_losses) == 40
    np.testing.assert_allclose(model.train_losses, jax_losses, rtol=1e-5)
    assert model.train_losses[-1] < model.train_losses[0]
    with open(tmp_path / "jax" / "fasttext.pkl", "rb") as f:
        jft = pickle.load(f)
    pft = PF.FastTextClassifier.load(str(tmp_path / "port" / "fasttext.pkl"),
                                     device="cpu")
    for name in ("input", "output"):
        np.testing.assert_allclose(pft.params[name].numpy(),
                                   np.asarray(jft.params[name]), rtol=1e-4,
                                   atol=1e-6)
    titles = pd.read_csv(d / "skus.csv")["title"].tolist()
    np.testing.assert_allclose(pft.get_sentence_vector(titles),
                               jft.get_sentence_vector(titles), atol=1e-5)
    assert pft.labels == jft.labels


# -- ops, warehouse, HF tokenizer ---------------------------------------------

class _FakeRedis:
    """``RedisKVSink`` stand-in over one dict per (host, db)."""
    stores = {}

    def __init__(self, host, port=6379, db=0, password=None):
        self.store = self.stores.setdefault((host, db), {})
        self.client = self

    def keys(self, pattern):
        import fnmatch
        return [k.encode() for k in self.store if fnmatch.fnmatch(k,
                                                                  pattern)]

    def get(self, key):
        return self.store.get(key, (None,))[0]

    def set_many(self, items, ttl_seconds=None):
        for k, v in items.items():
            self.store[k] = (v, ttl_seconds)


def test_copy_kv_matches_jax_cli(monkeypatch, capsys):
    from multimodalsimilar_tpu.pipelines import sinks as jsinks
    from multimodalsimilar_tpu_torch.pipelines import sinks as psinks
    monkeypatch.setattr(jsinks, "RedisKVSink", _FakeRedis)
    monkeypatch.setattr(psinks, "RedisKVSink", _FakeRedis)
    outs = []
    for side, main in (("jax", jcli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        _FakeRedis.stores = {("src", 0): {f"dj_similar:{i}": (f"v{i}", None)
                                          for i in range(2500)}}
        _FakeRedis.stores[("src", 0)]["other"] = ("x", None)
        main(["copy-kv", "--src_host", "src", "--dst_host", "dst",
              "--pattern", "dj_similar:*", "--exp_seconds", "60"])
        outs.append((_last_json(capsys), dict(_FakeRedis.stores[("dst",
                                                                 0)])))
    assert outs[0] == outs[1] and outs[1][0] == {"copied": 2500}
    assert set(t for _, t in outs[1][1].values()) == {60}


def test_download_matches_jax_cli(monkeypatch, capsys, tmp_path):
    from multimodalsimilar_tpu.pipelines import download as jdl
    from multimodalsimilar_tpu_torch.pipelines import download as pdl

    def fetch(url):
        if "bad" in url:
            raise OSError("unreachable")
        return url.encode()

    monkeypatch.setattr(jdl, "_default_fetch", fetch)
    monkeypatch.setattr(pdl, "_default_fetch", fetch)
    manifest = tmp_path / "m.csv"
    manifest.write_text("goods_sku,img_id,url\n007,0,http://a/0\n"
                        "007,1,http://bad/1\n12,0,http://a/2\n")
    os.makedirs(tmp_path / "jax" / "7")
    (tmp_path / "jax" / "7" / "0.jpg").write_bytes(b"old")
    os.makedirs(tmp_path / "port" / "7")
    (tmp_path / "port" / "7" / "0.jpg").write_bytes(b"old")
    res = []
    for side, main in (("jax", jcli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        main(["download", "--manifest", str(manifest), "--out_root",
              str(tmp_path / side), "--threads", "2"])
        res.append((_last_json(capsys), sorted(
            (os.path.relpath(os.path.join(r, f), tmp_path / side),
             open(os.path.join(r, f), "rb").read())
            for r, _, fs in os.walk(tmp_path / side) for f in fs)))
    assert res[0] == res[1]
    assert res[1][0] == {"downloaded": 1, "skipped_or_failed": 2}


def test_hive_tables_go_through_the_spark_adapter(pyspark_stub, monkeypatch,
                                                  text_setup, capsys):
    """``--data hive://`` and ``hivesql://`` pull through
    ``SparkTableSource``; an ``embed`` export to ``hive://`` stages a tmp
    table and INSERT OVERWRITEs, as the JAX command does."""
    from multimodalsimilar_tpu_torch.pipelines.spark import spark_session
    d, vocab, params = text_setup
    spark = spark_session("t")
    df = pd.read_csv(d / "t.csv")
    spark.tables["db.titles"] = df
    spark.canned["select * from db.titles where dt = '20260815'"] = \
        df[df["dt"] == "20260815"]
    assert read_table("hive://db.titles") == {c: df[c].tolist()
                                              for c in df.columns}
    got = read_table("hivesql://select * from db.titles where dt = "
                     "'20260815'")
    assert got["dt"] == ["20260815"] * 14
    tables = {}
    for side, main in (("jax", jcli.main),
                       ("port", lambda a: cli.main(a, device="cpu"))):
        spark.tables.pop("db.emb", None)
        main(["embed", "incremental", "--data", "hive://db.titles",
              "--table", "hive://db.emb", "--key_col", "spu_sn",
              "--tokenizer", vocab, "--max_length", "16", "--batch_size",
              "8", "--dt", "2026-08-16"])
        assert _last_json(capsys)["written"] == 40
        tables[side] = spark.tables["db.emb"]
    assert list(tables["port"].columns) == list(tables["jax"].columns) == [
        "spu_sn", "embedding", "dt"]
    assert tables["port"]["spu_sn"].tolist() == tables["jax"][
        "spu_sn"].tolist()


def test_hf_tokenizer_directory_matches_jax(tmp_path):
    from transformers import BertTokenizerFast
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    vocab = str(tmp_path / "vocab.txt")
    build_char_vocab(BASE, out_path=vocab)
    BertTokenizerFast(vocab_file=vocab, tokenize_chinese_chars=True
                      ).save_pretrained(str(tmp_path / "hf"))
    tok = _tokenizer(argparse.Namespace(tokenizer=str(tmp_path / "hf")))
    jtok = JTokenizer.from_hf(str(tmp_path / "hf"))
    assert tok.backend == "hf" and tok.vocab_size == jtok.vocab_size
    got, want = tok(BASE + ["未知 字"], 12), jtok(BASE + ["未知 字"], 12)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_module_runs_as_a_script(text_setup):
    """``python -m multimodalsimilar_tpu_torch.cli`` parses and refuses
    without a card (its commands default to the card)."""
    out = subprocess.run(
        [sys.executable, "-m", "multimodalsimilar_tpu_torch.cli", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "similar" in out.stdout
    d, vocab, _ = text_setup
    out = subprocess.run(
        [sys.executable, "-m", "multimodalsimilar_tpu_torch.cli", "similar",
         "nlp", "--data", str(d / "t.csv"), "--tokenizer", vocab,
         "--max_length", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "device='cpu'" in out.stderr
