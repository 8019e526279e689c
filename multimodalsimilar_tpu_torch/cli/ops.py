"""``copy-kv`` / ``download`` — the reference's ops utilities
(copy_redis.py, the image downloaders; counterpart of
multimodalsimilar_tpu/cli/ops.py). Neither touches the device: ``device``
is accepted for ``main``'s uniform call and unused."""

from __future__ import annotations

import json

from multimodalsimilar_tpu_torch.data.datasets import column


def cmd_copy_kv(args, device="cuda"):
    """Copy the keys matching ``--pattern`` between two Redis databases,
    TTL re-applied (copy_redis.py:18-35)."""
    from multimodalsimilar_tpu_torch.pipelines.download import copy_kv
    from multimodalsimilar_tpu_torch.pipelines.sinks import RedisKVSink
    src = RedisKVSink(args.src_host, args.src_port, args.src_db,
                      args.redis_password)
    dst = RedisKVSink(args.dst_host, args.dst_port, args.dst_db,
                      args.redis_password)
    keys = [k.decode() if isinstance(k, bytes) else k
            for k in src.client.keys(args.pattern)]
    n = copy_kv(src, dst, keys, args.exp_seconds)
    print(json.dumps({"copied": n}))


def cmd_download(args, device="cuda"):
    """Download ``{out_root}/{key}/{img_id}.jpg`` for every manifest row
    (daodian_image_download.py:48-118): skip-if-exists, per-item failures
    logged and counted."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    from multimodalsimilar_tpu_torch.pipelines.download import download_images
    table = read_table(args.manifest)
    items = list(zip([str(k) for k in column(table, args.key_col)],
                     [str(i) for i in column(table, args.img_id_col)],
                     column(table, args.url_col)))
    ok, failed = download_images(items, args.out_root, threads=args.threads)
    print(json.dumps({"downloaded": ok, "skipped_or_failed": failed}))
