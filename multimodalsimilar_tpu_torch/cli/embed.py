"""``embed {incremental,bulk}`` — the goodssku_emb* export jobs
(counterpart of multimodalsimilar_tpu/cli/embed.py): ``--kind text|cv``
and ``--kinds bert,cv``. fasttext comes with the daodian slice (ROADMAP
A14).
"""

from __future__ import annotations

import json

from multimodalsimilar_tpu_torch.cli.common import _make_table_sink
from multimodalsimilar_tpu_torch.cli.embedders import (_build_cv_embed_fn,
                                                       _build_embed_fn)

_KINDS_NOT_PORTED = {"fasttext": "A14"}


def _refuse(kinds) -> None:
    for kind in kinds:
        if kind in _KINDS_NOT_PORTED:
            raise NotImplementedError(
                f"embed kind {kind!r} is not ported yet (ROADMAP "
                f"{_KINDS_NOT_PORTED[kind]})")


def cmd_embed_incremental(args, device="cuda"):
    """goodssku_emb_*_di capability: skip-existing daily export of the
    text tower's embeddings into ``args.table``; ``--kind cv`` is the
    image job's full rebuild (multi-image mean, emb.txt caching)."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embed import (
        incremental_export, rebuild_export)
    kind = getattr(args, "kind", "text")
    _refuse([kind])
    df = read_table(args.data)
    sink = _make_table_sink(args.table)
    if kind == "cv":
        # goodssku_emb_cv_di.py is a FULL REBUILD despite the _di name: it
        # re-reads every cached emb.txt for today's catalog and overwrites
        # the table, so refreshed embeddings replace stale rows and
        # departed SKUs drop out (:83-119)
        n = rebuild_export(df, _build_cv_embed_fn(args, device=device),
                           sink, key_col=args.key_col, dt=args.dt)
        print(json.dumps({"written": n, "table": args.table,
                          "mode": "rebuild"}))
        return
    n = incremental_export(df, _build_embed_fn(args, df=df, device=device),
                           sink, key_col=args.key_col, dt=args.dt)
    print(json.dumps({"written": n, "table": args.table}))


def cmd_embed_bulk(args, device="cuda"):
    """goodssku_emb.py capability: one table with a column per tower
    (BERT, CV), outer-merged over the key."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embed import bulk_export
    kinds = [k.strip() for k in args.kinds.split(",")]
    _refuse(kinds)
    df = read_table(args.data)
    sink = _make_table_sink(args.table)
    embedders = {}
    if "bert" in kinds:
        embedders["bert"] = _build_embed_fn(args, df=df, device=device)
    if "cv" in kinds:
        embedders["cv"] = _build_cv_embed_fn(args, device=device)
    merged = bulk_export(df, embedders, sink, key_col=args.key_col)
    print(json.dumps({"rows": len(merged), "towers": list(embedders),
                      "table": args.table}))
