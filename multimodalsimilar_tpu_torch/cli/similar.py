"""``similar {nlp,multimodal,daodian}`` — the batch retrieval jobs
(nlp_infer / multimodal_infer / daodian_infer*; counterpart of
multimodalsimilar_tpu/cli/similar.py), on ``device``.

Each reads ``--data`` with ``read_table`` (a ``{column: list}`` table),
builds its embedder and calls the port's job (``pipelines/similar.py``),
whose search is the top-k kernel (``csrc/topk.cu``, k <= 128) or the
selection kernel (``csrc/topk_select.cu``, k > 128) on a card. The KV
sink is Redis with ``--redis_host``, else an in-memory dry run.
``--pallas_topk`` raises and ``--approx_recall`` runs the exact search on
one device (``_knn_backend_mesh``).

Under ``torchrun`` (``python -m multimodalsimilar_tpu_torch.cli`` joins
the process group when ``WORLD_SIZE`` > 1) every job shards its search
over the ranks as the JAX jobs do over the mesh's data axis (``similar
daodian``: both arms of every area). ``similar nlp`` and ``similar
multimodal --checkpoint`` also embed each rank's own rows, and ``similar
daodian`` each rank's own block of an area's SKU images. Rank 0 writes
the sink and prints the result.
"""

from __future__ import annotations

import json
import math
import os
import sys

from multimodalsimilar_tpu_torch.cli.common import (_emb_cache,
                                                    _knn_backend_mesh,
                                                    _kv_sink, _load_fasttext)
from multimodalsimilar_tpu_torch.cli.embedders import (
    _build_text_embedder, _embed_fn_from_embedder, _load_cv_tower,
    _multimodal_embedder, fused_embeddings_by_block)
from multimodalsimilar_tpu_torch.data.datasets import column


def _present(v) -> bool:
    """Not a missing value (None or nan), as ``Series.notna``."""
    return v is not None and not (isinstance(v, float) and math.isnan(v))


def cmd_similar_nlp(args, device="cuda"):
    """nlp_infer capability: text tower embeddings, normalize + inner
    product top-k, ``dj_similar:{spu_sn}`` writes. ``--dt`` keeps the
    rows whose ``dt`` column equals it, compared digit-normalized
    ('2026-08-16' == '20260816' == 20260816): the reference applies dt in
    its SQL pull (nlp_infer.py:112)."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        nlp_similar_job, norm_dt, take_rows)
    table = read_table(args.data)
    if args.dt:
        if "dt" not in table:
            raise SystemExit("--dt given but the input table has no 'dt' "
                             "column to select on (the reference applies "
                             "dt in its SQL pull) — drop the flag or add "
                             "the column")
        want = norm_dt(args.dt)
        table = take_rows(table, [i for i, v in enumerate(table["dt"])
                                  if norm_dt(v) == want])
        if not table["dt"]:
            raise SystemExit(f"--dt {args.dt}: no rows match in the input "
                             f"table")
    mesh = _knn_backend_mesh(args)
    sink = _kv_sink(args)
    embed_fn = _embed_fn_from_embedder(
        _build_text_embedder(args, df=table, device=device))
    n = nlp_similar_job(table, embed_fn, sink, text_col=args.text_col,
                        key_col=args.key_col, k=args.k,
                        score_th=args.score_th,
                        ttl_seconds=args.exp_seconds, device=device,
                        mesh=mesh)
    _print_rank0(mesh, {"written": n})


def _print_rank0(mesh, result: dict) -> None:
    if mesh is None or mesh.rank == 0:
        print(json.dumps(result))


def cmd_similar_multimodal(args, device="cuda"):
    """multimodal_infer capability: fused embeddings, un-normalized L2
    top-k, ``dj_similar:{spu_sn}`` writes. With ``--checkpoint`` the fused
    embeddings are computed in process (the reference's pattern); without
    it, the ``[x,y,...]`` strings of ``--embedding_col`` are read, and
    rows where it is empty (a key the fused tower missed) are skipped with
    a count."""
    import numpy as np
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embed import parse_embedding
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        multimodal_similar_job, take_rows)
    table = read_table(args.data)
    mesh = _knn_backend_mesh(args)
    if args.checkpoint:
        emb, keep = fused_embeddings_by_block(
            args, table, mesh, _multimodal_embedder(args, table, device),
            device)
        table = take_rows(table, keep)
    elif args.embedding_col in table:
        ok = [i for i, v in enumerate(table[args.embedding_col])
              if _present(v) and str(v).strip("[] ")]
        skipped = len(table[args.embedding_col]) - len(ok)
        if skipped:
            print(f"similar multimodal: skipping {skipped} rows "
                  f"with empty {args.embedding_col!r}", file=sys.stderr)
            table = take_rows(table, ok)
            if not ok:
                raise SystemExit(
                    f"no rows with a non-empty {args.embedding_col!r}")
        emb = np.stack([parse_embedding(str(s))
                        for s in table[args.embedding_col]])
    else:
        raise SystemExit(
            f"--embedding_col {args.embedding_col!r} not in table — pass "
            "--checkpoint (+ --img_root) to compute fused embeddings "
            "in-process like the reference job, or point at a table with "
            "precomputed fused embeddings")
    sink = _kv_sink(args)
    n = multimodal_similar_job(table, emb, sink, key_col=args.key_col,
                               k=args.k, ttl_seconds=args.exp_seconds,
                               device=device, mesh=mesh)
    _print_rank0(mesh, {"written": n})


def _gen_titles(table) -> list:
    """``gen_title`` of every row of a DataFrame or ``{column: list}``
    table (``DataFrame.apply(gen_title, axis=1)``)."""
    from multimodalsimilar_tpu_torch.data.text import gen_title
    from multimodalsimilar_tpu_torch.pipelines.similar import (n_rows,
                                                               table_columns)
    cols = table_columns(table)
    return [gen_title({c: v[i] for c, v in cols.items()})
            for i in range(n_rows(cols))]


def cmd_similar_daodian(args, device="cuda"):
    """daodian_infer capability: per-area fastText + CV merge, KV write.
    v1 keys ``{spu_sn}``; ``--date_keyed`` (v2) writes
    ``{yyyymmdd}:{spu_sn}``, and ``--dt_col`` (v2 recent days) keeps only
    neighbors whose dt is ``--dt``. Without ``--cv_checkpoint`` it
    refuses unless ``--text_only`` says to run the fastText arm alone."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        daodian_similar_job, table_columns)

    table = table_columns(read_table(args.data))
    if "title" not in table:
        table["title"] = _gen_titles(table)
    ft = _load_fasttext(args, device=device)

    def embed_titles(titles):
        return ft.get_sentence_vector(list(titles))

    if args.cv_checkpoint:
        emb = ImageEmbedder(
            _load_cv_tower(args, args.cv_checkpoint, args.cv_num_labels),
            image_size=args.image_size,
            cache_path_for_key=lambda k: os.path.join(
                args.img_root, str(k), "emb.txt"),
            cache=_emb_cache(args), emb_dim=args.fc_dim, device=device)

        def embed_skus(area):
            return _sku_to_spusn(area, emb, args, mesh, device)
    else:
        # The reference job always has a CV side (daodian_infer.py:367);
        # degrading to text-only must be an explicit operator choice.
        if not args.text_only:
            raise SystemExit(
                "similar daodian: no --cv_checkpoint given. The reference "
                "job merges CV and text neighbors; pass --text_only to "
                "deliberately run the fastText side alone.")
        print("similar daodian: --text_only — CV side disabled",
              file=sys.stderr)

        def embed_skus(area):
            return {}

    sink = _kv_sink(args)
    if (args.date_keyed or args.dt_col) and not args.dt:
        raise SystemExit(
            "similar daodian: --date_keyed/--dt_col are v2 semantics and "
            "need the target date; pass --dt YYYY-MM-DD.")
    date_key = args.dt.replace("-", "") if (args.dt and args.date_keyed) \
        else None
    mesh = _knn_backend_mesh(args)
    merged = daodian_similar_job(
        table, embed_titles, embed_skus, sink, ttl_seconds=args.exp_seconds,
        date_key=date_key, dt_col=args.dt_col, target_dt=args.dt,
        recent_days=args.recent_days, device=device, mesh=mesh)
    _print_rank0(mesh, {"skus": len(merged)})


def _sku_to_spusn(area, emb, args, mesh=None, device="cuda"):
    """Embed by goods_sku (image folders) but key the result by spu_sn.

    ``area`` is a DataFrame or a ``{column: list}`` table, ``emb`` an
    ``ImageEmbedder``. Several spu_sns may share one goods_sku (same
    product listed twice) — every spu_sn gets its sku's embedding, like
    the reference's per-row loop (daodian_infer.py:256-288), not just the
    last one. Under a sharded ``mesh`` each rank embeds its own block of
    the skus."""
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        embed_keys_sharded)
    skus = [str(s) for s in column(area, args.sku_col)]
    spusns = column(area, args.key_col)
    by_sku = embed_keys_sharded(mesh, sorted(set(skus)), lambda kk: (
        emb.embed_keys(kk, lambda k: [os.path.join(args.img_root, k,
                                                   f"{j}.jpg")
                                      for j in range(8)])), device)
    return {sp: by_sku[sk] for sk, sp in zip(skus, spusns) if sk in by_sku}
