"""``embed {incremental,bulk}`` — the goodssku_emb* export jobs
(counterpart of multimodalsimilar_tpu/cli/embed.py): ``--kind
text|cv|fasttext`` and ``--kinds bert,fasttext,cv``. The export jobs
(``pipelines/embed.py``) work on a pandas DataFrame and write parquet or
Hive tables, so these commands need pandas.
"""

from __future__ import annotations

import json

from multimodalsimilar_tpu_torch.cli.common import (_load_fasttext,
                                                    _make_table_sink)
from multimodalsimilar_tpu_torch.cli.embedders import (_build_cv_embed_fn,
                                                       _build_embed_fn)
from multimodalsimilar_tpu_torch.data.datasets import column


def _fasttext_embed_fn(args, device="cuda"):
    """``{key: sentence vector}`` of a table's ``text_col`` rows through
    the ``--fasttext_model`` classifier (its supervised
    get_sentence_vector)."""
    ft = _load_fasttext(args, device=device)

    def embed_fn(sub):
        em = ft.get_sentence_vector([str(t) for t in
                                     column(sub, args.text_col)])
        return dict(zip([str(k) for k in column(sub, args.key_col)], em))

    return embed_fn


def _data_frame(args):
    """``--data`` as the pandas DataFrame the export jobs take."""
    import pandas as pd
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    return pd.DataFrame(read_table(args.data))


def cmd_embed_incremental(args, device="cuda"):
    """goodssku_emb_*_di capability: skip-existing daily export of the
    text tower's embeddings into ``args.table``; ``--kind cv`` is the
    image job's full rebuild (multi-image mean, emb.txt caching)."""
    from multimodalsimilar_tpu_torch.pipelines.embed import (
        incremental_export, rebuild_export)
    kind = getattr(args, "kind", "text")
    df = _data_frame(args)
    sink = _make_table_sink(args.table, key_col=args.key_col)
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
    embed_fn = (_fasttext_embed_fn(args, device=device)
                if kind == "fasttext"
                else _build_embed_fn(args, df=df, device=device))
    n = incremental_export(df, embed_fn, sink, key_col=args.key_col,
                           dt=args.dt)
    print(json.dumps({"written": n, "table": args.table}))


def cmd_embed_bulk(args, device="cuda"):
    """goodssku_emb.py capability: one table with a column per tower
    (fastText + BERT + CV), outer-merged over the key."""
    from multimodalsimilar_tpu_torch.pipelines.embed import bulk_export
    kinds = [k.strip() for k in args.kinds.split(",")]
    df = _data_frame(args)
    sink = _make_table_sink(args.table, key_col=args.key_col)
    embedders = {}
    if "bert" in kinds:
        embedders["bert"] = _build_embed_fn(args, df=df, device=device)
    if "fasttext" in kinds:
        embedders["fasttext"] = _fasttext_embed_fn(args, device=device)
    if "cv" in kinds:
        embedders["cv"] = _build_cv_embed_fn(args, device=device)
    merged = bulk_export(df, embedders, sink, key_col=args.key_col)
    print(json.dumps({"rows": len(merged), "towers": list(embedders),
                      "table": args.table}))
