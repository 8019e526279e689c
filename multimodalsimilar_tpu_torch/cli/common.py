"""Shared command helpers (counterpart of
multimodalsimilar_tpu/cli/common.py): ``--config`` preloading, the
tokenizer, the BERT presets, checkpoint restore (a text model that a
checkpoint fills is built on the ``meta`` device, ``_on_meta``, and
loaded with ``assign=True``: no random init on the host), the fastText model
(``--fasttext_model``, in the port's own format), the packed embedding
cache (``--emb_cache``), the KV and table sinks and the search-flag
check.

``_enable_compile_cache`` has no counterpart: it turns on XLA's
persistent compilation cache, and the port compiles nothing per job
(its kernels are built once into ``multimodalsimilar_tpu_torch/build``,
``ops/_build.py``). ``_mesh`` builds the ``(data, model)`` mesh over the
ranks ``torchrun`` started (``parallel/mesh.py``). ``_ckpt_has_pp`` has
no counterpart: it finds the JAX package's stacked ``pp_layers`` tree in
an orbax directory, and the port reads its own checkpoints, always in
the one-card layout (a pipeline-parallel run gathers its stages).
"""

from __future__ import annotations

import os
import sys

from multimodalsimilar_tpu_torch.data.datasets import column


def _apply_yaml_config(args, argv):
    """--config file.yaml preloads flag values; explicit flags still win.

    Applied to the parsed namespace after ``_inject_yaml_argv`` put every
    value it can express into argv, so what is left to apply is a
    ``key: false`` for a store_true flag. Unknown keys are an error, not
    a silent no-op; ``key: null`` never applies (it would bypass
    argparse's type conversion and clobber the default with None)."""
    if getattr(args, "config", None):
        from multimodalsimilar_tpu_torch.cli.config import load_config
        cfg = load_config(args.config)
        unknown = [k for k in cfg if not hasattr(args, k)]
        if unknown:
            raise SystemExit(f"--config {args.config}: unknown flags "
                             f"{unknown}")
        for k, v in cfg.items():
            explicit = any(t == f"--{k}" or t.startswith(f"--{k}=")
                           for t in argv)
            if not explicit and v is not None:
                setattr(args, k, v)


def _require_tokenizer_with_checkpoint(args):
    """--checkpoint without --tokenizer would derive a FRESH char vocab
    from the serving data: token ids shuffle relative to training and the
    restored tower silently embeds garbage. Training saves
    {output}/vocab.txt exactly so serving jobs can reuse the training
    ids — require it."""
    if getattr(args, "checkpoint", None) \
            and not getattr(args, "tokenizer", None):
        raise SystemExit(
            "--checkpoint given without --tokenizer: a vocab derived from "
            "the serving data would not match the training vocab and the "
            "restored tower would embed garbage. Pass --tokenizer "
            "{train_output}/vocab.txt (saved by train).")


def _tokenizer(args, df=None, save_dir=None, text_col=None):
    """--tokenizer: a vocab.txt from a previous train run, or an HF
    tokenizer directory or name (``TextTokenizer.from_hf``, which needs
    transformers). Without it, a char vocab is derived from ``text_col``
    (default ``args.text_col``) of the data (``df``, a DataFrame or a
    ``{column: list}`` mapping, else ``args.data``) and, with
    ``save_dir``, written to ``{save_dir}/vocab.txt``, so the serve and
    embed jobs reuse the training token ids."""
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    if args.tokenizer:
        if args.tokenizer.endswith("vocab.txt"):
            return TextTokenizer.from_vocab_file(args.tokenizer)
        return TextTokenizer.from_hf(args.tokenizer)
    if df is None:
        from multimodalsimilar_tpu_torch.data.datasets import read_table
        df = read_table(args.data)
    save_path = None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        save_path = os.path.join(save_dir, "vocab.txt")
    return TextTokenizer.from_corpus(
        [str(t) for t in column(df, text_col or args.text_col)],
        save_vocab_path=save_path)


def _load_fasttext(args, device="cuda"):
    """The ``FastTextClassifier`` at ``--fasttext_model``, saved by the
    port (``FastTextClassifier.save``; a JAX pickle holds JAX classes:
    carry its weights over with ``models/convert.py:fasttext_from_jax``),
    on ``device``; one-line errors when the flag is missing."""
    from multimodalsimilar_tpu_torch.models.fasttext import (
        FastTextClassifier)
    path = getattr(args, "fasttext_model", None)
    if not path:
        raise SystemExit(
            "--fasttext_model is required for the fasttext embedder (a "
            "model saved by the port's FastTextClassifier.save)")
    return FastTextClassifier.load(path, device=device)


def _restore_required(checkpoint_dir):
    """The latest training state under ``checkpoint_dir`` (the port's own
    ``train/checkpoint.py`` files: ``{step, model, ...}``), or a one-line
    error when there is none."""
    from multimodalsimilar_tpu_torch.data.datasets import InputError
    from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
    state = CheckpointManager(checkpoint_dir).restore()
    if state is None:
        raise InputError(f"no checkpoint found under {checkpoint_dir} "
                         f"(expected step_*.pt files written by the "
                         f"port's trainer)")
    return state


def _on_meta(make):
    """``make()`` built on the ``meta`` device: no weight is drawn, since
    every tensor is about to come from a checkpoint (fill it with
    ``load_state_dict(..., assign=True)``, then move it)."""
    import torch
    with torch.device("meta"):
        return make()


def _fill_heads(model) -> None:
    """The ArcFace heads a tower-only load left on the ``meta`` device,
    drawn on the host from seed 0 (an embedder never runs them)."""
    import torch

    from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
    for m in model.modules():
        if isinstance(m, ArcFaceHead) and m.weight.is_meta:
            m.to_empty(device="cpu")
            m.reset_parameters(torch.Generator().manual_seed(0))


def _bert_config(preset: str, remat: bool = False,
                 sequence_parallel: bool = False,
                 pipeline_parallel: int = 0,
                 remat_policy: str = "full", remat_skip: int = 0):
    """BertConfig of a preset: ``tiny``, ``base`` (roberta_wwm_ext) or
    ``large`` (roberta_wwm_ext_large), with ``--remat*``,
    ``--sequence_parallel`` and ``--pipeline_parallel``: the GPipe
    microbatch count M (0 = off); the stage count comes from the mesh's
    model axis when the model is built (``parallel/pp.py:building``)."""
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    make = {"tiny": BertConfig.tiny, "base": BertConfig.roberta_wwm_ext,
            "large": BertConfig.roberta_wwm_ext_large}[preset]
    if (remat_policy != "full" or remat_skip) and not remat:
        raise SystemExit("--remat_policy/--remat_skip modify --remat; "
                         "pass --remat too (refusing to silently ignore)")
    return make(remat=remat, sequence_parallel=sequence_parallel,
                pipeline_parallel=pipeline_parallel > 0,
                pp_microbatches=max(int(pipeline_parallel), 1),
                remat_policy=remat_policy, remat_skip=int(remat_skip or 0))


def _emb_cache(args):
    """--emb_cache DIR -> packed EmbeddingCache (emb.txt stays the default
    reference-compatible layout; the packed store backfills itself from
    any existing emb.txt)."""
    d = getattr(args, "emb_cache", None)
    if not d:
        return None
    from multimodalsimilar_tpu_torch.pipelines.embcache import EmbeddingCache
    return EmbeddingCache.open(d, args.fc_dim)


def _seq_buckets(args):
    from multimodalsimilar_tpu_torch.utils.buckets import parse_buckets
    return parse_buckets(getattr(args, "seq_buckets", None))


def _make_table_sink(table: str, key_col=None):
    """Embedding-table sink by address: ``hive://db.table`` writes through
    the Spark adapter with the reference's tmp-table + INSERT OVERWRITE
    discipline (goodssku_emb_bert_di.py:148-154); anything else is a local
    parquet stand-in with the same contract."""
    if table.startswith("hive://"):
        from multimodalsimilar_tpu_torch.pipelines.spark import (
            SparkTableSink, spark_session)
        return SparkTableSink(spark_session("multimodalsimilar_tpu_torch"),
                              table[len("hive://"):], key_col=key_col)
    from multimodalsimilar_tpu_torch.pipelines.sinks import ParquetTableSink
    return ParquetTableSink(table)


def _mesh(args=None):
    """The ``(data, model)`` mesh over every rank (``--model_parallel``
    ranks on the model axis; one rank without a process group)."""
    from multimodalsimilar_tpu_torch.parallel.mesh import create_mesh
    mp = int(getattr(args, "model_parallel", 1) or 1) if args else 1
    return create_mesh(model=mp)


def _knn_backend_mesh(args):
    """The mesh the similar jobs search over, or None. The JAX package
    also picks a search backend here; the port has one search, exact on
    the device (``csrc/topk.cu``, ``csrc/topk_select.cu`` above k = 128),
    so ``--pallas_topk`` raises instead of being ignored.
    ``--approx_recall r`` (0 < r <= 1) is the JAX package's approximate
    search, a TPU op that it runs exactly on any other backend, without
    a mesh: so does the port, after a notice."""
    if getattr(args, "pallas_topk", False):
        raise NotImplementedError(
            "--pallas_topk: the port has no search-backend option; the "
            "device runs the exact search (csrc/topk.cu on a card)")
    approx = getattr(args, "approx_recall", None)
    if approx is not None:
        if not 0.0 < approx <= 1.0:
            raise ValueError(f"approx_recall must be in (0, 1], "
                             f"got {approx!r}")
        print(f"--approx_recall {approx}: the approximate k-NN is a TPU op "
              "(approx_max_k); on this device the search is exact, on one "
              "device, as the JAX package runs it off a TPU",
              file=sys.stderr)
        return None
    return _mesh(args)


def _kv_sink(args):
    """Redis when ``--redis_host`` is given, else an in-memory sink (a dry
    run, announced on stderr)."""
    from multimodalsimilar_tpu_torch.pipelines.sinks import (
        InMemoryKVSink, RedisKVSink)
    if args.redis_host:
        return RedisKVSink(args.redis_host, args.redis_port, args.redis_db,
                           args.redis_password)
    print("no --redis_host: using in-memory sink (dry run)", file=sys.stderr)
    return InMemoryKVSink()
