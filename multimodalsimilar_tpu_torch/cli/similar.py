"""The ``similar`` commands' shared helper (counterpart of the part of
multimodalsimilar_tpu/cli/similar.py that the daodian job and daemon
need). The ``cmd_similar_*`` entry points come with the port's command
line (ROADMAP A15)."""

from __future__ import annotations

import os

from multimodalsimilar_tpu_torch.data.datasets import column


def _sku_to_spusn(area, emb, args):
    """Embed by goods_sku (image folders) but key the result by spu_sn.

    ``area`` is a DataFrame or a ``{column: list}`` table, ``emb`` an
    ``ImageEmbedder``. Several spu_sns may share one goods_sku (same
    product listed twice) — every spu_sn gets its sku's embedding, like
    the reference's per-row loop (daodian_infer.py:256-288), not just the
    last one."""
    skus = [str(s) for s in column(area, args.sku_col)]
    spusns = column(area, args.key_col)
    by_sku = emb.embed_keys(
        sorted(set(skus)),
        lambda kk: [os.path.join(args.img_root, kk, f"{j}.jpg")
                    for j in range(8)])
    return {sp: by_sku[sk] for sk, sp in zip(skus, spusns) if sk in by_sku}
