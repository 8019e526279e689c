"""Shared command helpers (counterpart of the subset of
multimodalsimilar_tpu/cli/common.py that the serving and embedding export
commands use): the tokenizer, the BERT presets, checkpoint restore, the
fastText model (``--fasttext_model``, in the port's own format), the
packed embedding cache (``--emb_cache``) and the embedding-table sink.

Options whose code is not ported raise ``NotImplementedError`` instead of
being ignored: HF tokenizers and ``hive://`` sinks.
"""

from __future__ import annotations

import os

from multimodalsimilar_tpu_torch.data.datasets import column


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
    """--tokenizer: a vocab.txt from a previous train run. Without it, a
    char vocab is derived from ``text_col`` (default ``args.text_col``) of
    the data (``df``, a DataFrame or a ``{column: list}`` mapping, else
    ``args.data``) and, with ``save_dir``, written to
    ``{save_dir}/vocab.txt``, so the serve and embed jobs reuse the
    training token ids."""
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    if args.tokenizer:
        if args.tokenizer.endswith("vocab.txt"):
            return TextTokenizer.from_vocab_file(args.tokenizer)
        raise NotImplementedError(
            f"--tokenizer {args.tokenizer}: HF tokenizers are not ported "
            "(the port does not depend on transformers); pass a vocab.txt")
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


def _bert_config(preset: str):
    """BertConfig of a preset: ``tiny``, ``base`` (roberta_wwm_ext) or
    ``large`` (roberta_wwm_ext_large). Remat and the sequence- and
    pipeline-parallel layouts are not ported (ROADMAP A17): the train
    commands refuse their flags."""
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    make = {"tiny": BertConfig.tiny, "base": BertConfig.roberta_wwm_ext,
            "large": BertConfig.roberta_wwm_ext_large}[preset]
    return make()


def _emb_cache(args):
    """--emb_cache DIR -> packed EmbeddingCache (emb.txt stays the default
    reference-compatible layout; the packed store backfills itself from
    any existing emb.txt)."""
    d = getattr(args, "emb_cache", None)
    if not d:
        return None
    from multimodalsimilar_tpu_torch.pipelines.embcache import EmbeddingCache
    return EmbeddingCache.open(d, args.fc_dim)


def _make_table_sink(table: str):
    """Embedding-table sink by address: a local parquet file standing in
    for the warehouse table. ``hive://`` addresses raise."""
    if table.startswith("hive://"):
        raise NotImplementedError(
            f"{table}: the Spark table sink is not ported (ROADMAP A16); "
            "write to a local parquet path")
    from multimodalsimilar_tpu_torch.pipelines.sinks import ParquetTableSink
    return ParquetTableSink(table)
