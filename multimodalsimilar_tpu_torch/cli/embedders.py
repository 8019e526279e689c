"""Text embedder construction shared by the embed and serve commands
(counterpart of the text part of multimodalsimilar_tpu/cli/embedders.py):
an ``NlpTextClassifier`` tower under ``DTypePolicy.inference()`` with
weights from a port checkpoint, or from seed 0 without ``--checkpoint``.

``--int8`` (``models/quant.py``, ROADMAP A16) and pipeline-parallel
checkpoints raise ``NotImplementedError``. The cv and multimodal towers
come with the image slice.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from multimodalsimilar_tpu_torch.cli.common import (
    _bert_config, _require_tokenizer_with_checkpoint, _restore_required,
    _tokenizer)
from multimodalsimilar_tpu_torch.data.datasets import column


def _is_pp_checkpoint(checkpoint_dir) -> bool:
    """A JAX checkpoint trained with --pipeline_parallel: its orbax step
    metadata names the stacked ``pp_layers`` tree."""
    for meta in glob.glob(os.path.join(str(checkpoint_dir), "*", "default",
                                       "_METADATA")):
        try:
            with open(meta, "rb") as f:
                if b'"pp_layers"' in f.read():
                    return True
        except OSError:
            continue
    return False


def _build_text_embedder(args, df=None, device="cuda"):
    """TextEmbedder from a checkpoint (or seed-0 weights for smoke runs)
    on ``device``. ``df`` (a DataFrame or ``{column: list}``) saves
    re-reading ``args.data`` when the vocab comes from the corpus."""
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    from multimodalsimilar_tpu_torch.utils.buckets import parse_buckets
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

    if getattr(args, "int8", False):
        raise NotImplementedError("--int8: the int8 PTQ tower "
                                  "(models/quant.py) is not ported "
                                  "(ROADMAP A16)")
    _require_tokenizer_with_checkpoint(args)
    tok = _tokenizer(args, df=df)
    model = NlpTextClassifier(_bert_config(args.bert_preset),
                              pool=getattr(args, "pool", "cls"),
                              policy=DTypePolicy.inference(),
                              num_labels=args.num_labels)
    if args.checkpoint:
        if _is_pp_checkpoint(args.checkpoint):
            raise NotImplementedError(
                f"{args.checkpoint}: pipeline-parallel checkpoints are not "
                "ported (ROADMAP A17)")
        state = _restore_required(args.checkpoint)
        # the tower only, as the JAX embedder reads only the tower: the
        # head's class count need not match --num_labels
        model.tower.load_state_dict(
            {k[len("tower."):]: v for k, v in state["model"].items()
             if k.startswith("tower.")})
    buckets = parse_buckets(getattr(args, "length_buckets", None))
    return TextEmbedder(model, tok, args.max_length, args.batch_size,
                        length_buckets=buckets, device=device)


def _build_embed_fn(args, df=None, device="cuda"):
    """key -> embedding dict interface over the text embedder (the batch
    jobs' merge-by-key contract, goodssku_emb.py:183-195)."""
    embedder = _build_text_embedder(args, df=df, device=device)

    def embed_fn(sub):
        em = embedder([str(t) for t in column(sub, args.text_col)])
        return dict(zip((str(k) for k in column(sub, args.key_col)), em))

    return embed_fn


def _embed_fn_from_embedder(embedder):
    """texts -> [N, D] float32 by calling the TextEmbedder directly (the
    serving path needs no DataFrame round-trip per micro-batch)."""
    def embed_texts(texts):
        return np.asarray(embedder(list(texts)))

    return embed_texts
