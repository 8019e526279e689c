"""``embed {incremental,bulk}`` — the goodssku_emb* export jobs
(counterpart of multimodalsimilar_tpu/cli/embed.py) for the text tower:
``--kind text`` and ``--kinds bert``. The cv kinds come with the image
slice (ROADMAP A8-A9), fasttext with the daodian slice (A14).
"""

from __future__ import annotations

import json

from multimodalsimilar_tpu_torch.cli.common import _make_table_sink
from multimodalsimilar_tpu_torch.cli.embedders import _build_embed_fn

_KINDS_NOT_PORTED = {"cv": "A8-A9", "fasttext": "A14"}


def _refuse(kinds) -> None:
    for kind in kinds:
        if kind in _KINDS_NOT_PORTED:
            raise NotImplementedError(
                f"embed kind {kind!r} is not ported yet (ROADMAP "
                f"{_KINDS_NOT_PORTED[kind]})")


def cmd_embed_incremental(args, device="cuda"):
    """goodssku_emb_bert_di capability: skip-existing daily export of the
    text tower's embeddings into ``args.table``."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embed import incremental_export
    _refuse([getattr(args, "kind", "text")])
    df = read_table(args.data)
    sink = _make_table_sink(args.table)
    n = incremental_export(df, _build_embed_fn(args, df=df, device=device),
                           sink, key_col=args.key_col, dt=args.dt)
    print(json.dumps({"written": n, "table": args.table}))


def cmd_embed_bulk(args, device="cuda"):
    """goodssku_emb.py capability: one table with a column per tower,
    outer-merged over the key (the BERT column here)."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embed import bulk_export
    kinds = [k.strip() for k in args.kinds.split(",")]
    _refuse(kinds)
    df = read_table(args.data)
    sink = _make_table_sink(args.table)
    embedders = {}
    if "bert" in kinds:
        embedders["bert"] = _build_embed_fn(args, df=df, device=device)
    merged = bulk_export(df, embedders, sink, key_col=args.key_col)
    print(json.dumps({"rows": len(merged), "towers": list(embedders),
                      "table": args.table}))
