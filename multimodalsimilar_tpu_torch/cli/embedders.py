"""Embedder construction shared by the embed and serve commands
(counterpart of multimodalsimilar_tpu/cli/embedders.py), every tower under
``DTypePolicy.inference()``:

* text: an ``NlpTextClassifier`` tower, weights from a port checkpoint
  or from seed 0 without ``--checkpoint``; with ``--int8`` that tower
  quantized (``models/quant.py:quantize_text_tower``); with
  ``--text_tower deepseek_v2_lite`` the DeepSeek-V2 tower in bfloat16
  weights (``models/deepseek_v2.py``), from a published checkpoint
  directory or from seed 0;
* cv: a ``CvImageClassifier`` (checkpoint or seed 0) of any backbone, an
  EfficientNet's BatchNorm folded into its convs (``models/fold_bn.py``;
  ViT and ConvNeXt have no backbone BatchNorm), a ViT's position table
  sized by ``--image_size``;
* multimodal: a ``MultimodalClassifier`` from a port checkpoint, which
  this path requires, as the JAX package's does.

A checkpoint is the port's own (``train/checkpoint.py``: ``{step, model,
...}``); the heads' class counts need not match ``--num_labels``, as the
embedders never run a head. A text tower that a checkpoint fills is
built on the ``meta`` device and loaded with ``assign=True`` (no random
init on the host); without ``--checkpoint`` the seed-0 draw is the
weights. The image towers are drawn, then loaded: their inits run
``normal_``, whose meta kernel imports the compiler stack (seconds, once
a process), more than an image tower's draw costs.
The port's checkpoints are in the one-card layout whatever layout
trained them. The JAX package's pipeline-parallel orbax directory (its
stacked ``pp_layers`` tree) is no port checkpoint: with ``--int8`` it
exits with the JAX command's message, without it with the port's "no
checkpoint" error.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from multimodalsimilar_tpu_torch.cli.common import (
    _bert_config, _emb_cache, _fill_heads, _on_meta,
    _require_tokenizer_with_checkpoint, _restore_required, _tokenizer)
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


def _deepseek_v2_tower(args, device):
    """The DeepSeek-V2 tower in bfloat16 on ``device``: the published
    checkpoint at ``--checkpoint`` (``config.json`` and its weights,
    ``models/hf_import.py``), else ``--deepseek_preset``'s config drawn
    on the device from seed 0."""
    import torch

    from multimodalsimilar_tpu_torch.models import hf_import
    from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config, DeepseekV2Tower)
    from multimodalsimilar_tpu_torch.utils.devices import resolve_device
    dev = resolve_device(device)
    if args.checkpoint:
        config, state = hf_import.load_deepseek_v2_checkpoint(
            args.checkpoint)
        with torch.device("meta"):
            tower = DeepseekV2Tower(config)
        dtypes = {k: v.dtype for k, v in tower.state_dict().items()}
        tower.load_state_dict({k: v.to(dev, dtypes[k])
                               for k, v in state.items()},
                              strict=True, assign=True)
        return tower
    config = {"lite": DeepseekV2Config,
              "tiny": DeepseekV2Config.tiny}[args.deepseek_preset]()
    with torch.device(dev):
        return DeepseekV2Tower(
            config, generator=torch.Generator(device=dev).manual_seed(0))


def _build_text_embedder(args, df=None, device="cuda"):
    """TextEmbedder from a checkpoint (or seed-0 weights for smoke runs)
    on ``device``. ``df`` (a DataFrame or ``{column: list}``) saves
    re-reading ``args.data`` when the vocab comes from the corpus.
    ``--text_tower deepseek_v2_lite`` puts the DeepSeek-V2 tower in the
    BERT tower's place, a char vocabulary then giving each row the
    config's BOS token and no [SEP] (``TextTokenizer.with_bos``)."""
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    from multimodalsimilar_tpu_torch.utils.buckets import parse_buckets
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

    int8 = getattr(args, "int8", False)
    _require_tokenizer_with_checkpoint(args)
    tok = _tokenizer(args, df=df)
    buckets = parse_buckets(getattr(args, "length_buckets", None))
    if getattr(args, "text_tower", "bert") == "deepseek_v2_lite":
        if int8:
            raise SystemExit("--int8 quantizes the BERT tower only; drop it "
                             "with --text_tower deepseek_v2_lite")
        tower = _deepseek_v2_tower(args, device)
        if tok.backend != "hf":
            tok = tok.with_bos(tower.config.bos_token_id)
        return TextEmbedder(tower, tok, args.max_length, args.batch_size,
                            length_buckets=buckets, device=device)

    def make():
        return NlpTextClassifier(_bert_config(args.bert_preset),
                                 pool=getattr(args, "pool", "cls"),
                                 policy=DTypePolicy.inference(),
                                 num_labels=args.num_labels)

    if not args.checkpoint:
        model = make()
    else:
        if int8 and _is_pp_checkpoint(args.checkpoint):
            raise SystemExit(
                "--int8: the int8 PTQ tower does not support the "
                "pipeline-parallel stacked layout; export the "
                "checkpoint to the sequential layout first "
                "(models.bert.unstack_layer_params) or drop --int8")
        state = _restore_required(args.checkpoint)
        # the tower only, as the JAX embedder reads only the tower: the
        # head's class count need not match --num_labels
        model = _on_meta(make)
        model.tower.load_state_dict(
            {k[len("tower."):]: v for k, v in state["model"].items()
             if k.startswith("tower.")}, assign=True)
        _fill_heads(model)
    if int8:
        from multimodalsimilar_tpu_torch.models.quant import (
            quantize_text_tower)
        print("--int8: int8 PTQ text tower (models/quant.py): int8 weights "
              "per output channel, int8 activations per tensor; its "
              "embeddings and speed against the bf16 default are in "
              "PERF.md", file=sys.stderr)
        model = quantize_text_tower(model)
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


def _is_head(key: str) -> bool:
    return key == "head.weight" or key.endswith(".head.weight")


def _load_without_heads(model, state_dict, checkpoint) -> None:
    """Every tower weight of ``state_dict`` into ``model``, strictly; the
    ArcFace heads are skipped (an embedder never runs them, and their
    class counts need not match ``--num_labels``)."""
    from multimodalsimilar_tpu_torch.data.datasets import InputError
    hint = "check --backbone, --bert_preset and --fc_dim"
    try:
        missing, unexpected = model.load_state_dict(
            {k: v for k, v in state_dict.items() if not _is_head(k)},
            strict=False)
    except RuntimeError as e:                # a tensor of another shape
        raise InputError(f"{checkpoint}: the checkpoint does not fit the "
                         f"model built from the flags — {hint} "
                         f"({str(e).strip().splitlines()[-1].strip()})"
                         ) from e
    bad = [k for k in missing if not _is_head(k)] + list(unexpected)
    if bad:
        raise InputError(f"{checkpoint}: the checkpoint does not fit the "
                         f"model built from the flags — {hint} (first "
                         f"mismatched keys: {bad[:4]})")


def _load_cv_tower(args, checkpoint, num_labels):
    """The image classifier in the serving config, one construction site:
    ``DTypePolicy.inference()``, weights from ``checkpoint`` or seed 0, an
    EfficientNet's BN folded into its convs (exact math; ViT and ConvNeXt
    keep only the neck's BN, unfolded, as in the JAX package)."""
    from multimodalsimilar_tpu_torch.models.efficientnet import (
        EfficientNetConfig)
    from multimodalsimilar_tpu_torch.models.fold_bn import fold_cv_classifier
    from multimodalsimilar_tpu_torch.models.vision import (
        CvImageClassifier, backbone_config)
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

    cfg = backbone_config(args.backbone, image_size=args.image_size)
    policy = DTypePolicy.inference()
    model = CvImageClassifier(cfg, num_labels, fc_dim=args.fc_dim,
                              policy=policy)
    if checkpoint:
        state = _restore_required(checkpoint)
        _load_without_heads(model, state["model"], checkpoint)
    if not isinstance(cfg, EfficientNetConfig):
        return model
    folded_cfg, sd = fold_cv_classifier(model.state_dict(), cfg)
    folded = CvImageClassifier(folded_cfg, num_labels, fc_dim=args.fc_dim,
                               policy=policy)
    folded.load_state_dict(sd)
    return folded


def _image_paths(args):
    """key -> the reference layout's candidate images,
    {img_root}/{key}/0..7.jpg."""
    return lambda k: [os.path.join(args.img_root, str(k), f"{j}.jpg")
                      for j in range(8)]


def _cv_embedder(args, device="cuda"):
    """ImageEmbedder over the folded cv tower, with the reference's
    {img_root}/{key}/emb.txt cache and ``--emb_cache``."""
    from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
    return ImageEmbedder(
        _load_cv_tower(args, args.checkpoint, args.num_labels),
        image_size=args.image_size, batch_size=args.batch_size,
        cache_path_for_key=lambda k: os.path.join(args.img_root, str(k),
                                                  "emb.txt"),
        cache=_emb_cache(args), emb_dim=args.fc_dim, device=device)


def _build_cv_embed_fn(args, device="cuda"):
    """key -> embedding dict interface over the cv tower: each key's
    images averaged, emb.txt and --emb_cache respected."""
    embedder = _cv_embedder(args, device=device)
    paths = _image_paths(args)

    def embed_fn(sub):
        return embedder.embed_keys([str(k) for k in column(sub,
                                                           args.key_col)],
                                   paths)

    return embed_fn


def _multimodal_embedder(args, df, device="cuda"):
    """MultimodalEmbedder over the checkpointed fused tower — shared by
    the offline similar job (``_fused_embeddings``) and the serving
    daemon (``serve --tower multimodal``)."""
    from multimodalsimilar_tpu_torch.models.multimodal import (
        MultimodalClassifier)
    from multimodalsimilar_tpu_torch.models.vision import backbone_config
    from multimodalsimilar_tpu_torch.pipelines.embedders import (
        MultimodalEmbedder)
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

    _require_tokenizer_with_checkpoint(args)   # same garbage-vocab trap
    tok = _tokenizer(args, df=df)
    model = MultimodalClassifier(
        _bert_config(args.bert_preset),
        backbone_config(args.backbone, image_size=args.image_size),
        num_labels=args.num_labels, fc_dim=args.fc_dim,
        policy=DTypePolicy.inference())
    state = _restore_required(args.checkpoint)
    _load_without_heads(model, state["model"], args.checkpoint)
    return MultimodalEmbedder(model, tok, args.max_length, args.image_size,
                              args.batch_size, device=device)


def _fused_embeddings(args, df, embedder=None, device="cuda",
                      require_rows=True):
    """Fused [N, fc_dim + hidden] embeddings of the (text_col,
    {img_root}/{key}.jpg) rows of ``df`` (a DataFrame or ``{column:
    list}``) — what the reference job does (multimodal_infer.py:119-134).
    Returns (embeddings, surviving row positions): rows whose image fails
    to load are skipped like the reference's per-row try/except. With
    ``require_rows=False`` no readable image at all gives ``(0, 0)``
    embeddings instead of an error (a rank's block of a sharded corpus
    may have none; the caller checks what the ranks gathered)."""
    from multimodalsimilar_tpu_torch.data import images as I

    if embedder is None:
        embedder = _multimodal_embedder(args, df, device=device)
    # decode + embed in bounded chunks: a warehouse-scale table must not
    # hold every decoded image in host RAM at once
    chunk_rows = max(args.batch_size, 1) * 8
    keys = [str(k) for k in column(df, args.key_col)]
    texts_all = [str(t) for t in column(df, args.text_col)]
    out_parts, keep = [], []
    for s in range(0, len(keys), chunk_rows):
        imgs, texts = [], []
        for pos in range(s, min(s + chunk_rows, len(keys))):
            img = I.load_eval(
                os.path.join(args.img_root, f"{keys[pos]}.jpg"),
                args.image_size, normalize_host=False)
            if img is None:
                continue
            imgs.append(img)
            keep.append(pos)
            texts.append(texts_all[pos])
        if imgs:
            out_parts.append(embedder(np.stack(imgs), texts))
    if not keep:
        if not require_rows:
            return np.zeros((0, 0), np.float32), keep
        raise _no_readable_images(args)
    return np.concatenate(out_parts), keep


def _no_readable_images(args) -> SystemExit:
    return SystemExit(f"no readable images under {args.img_root} for any "
                      f"row — check --img_root/--key_col")


def fused_embeddings_by_block(args, table, mesh, embedder, device="cuda"):
    """``_fused_embeddings`` of every row of ``table``, each rank of a
    sharded ``mesh`` embedding its own ``row_block``
    (``pipelines/similar.py:embed_kept``; a block may hold no readable
    image): (embeddings, kept row positions) in row order, the same on
    every rank. Exits when no row of the table has a readable image."""
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        embed_kept, n_rows, table_columns, take_rows)
    cols = table_columns(table)
    emb, keep = embed_kept(mesh, n_rows(cols), lambda rows: (
        _fused_embeddings(args, take_rows(cols, rows), embedder=embedder,
                          device=device, require_rows=False)), device)
    if not keep:
        raise _no_readable_images(args)
    return emb, keep
