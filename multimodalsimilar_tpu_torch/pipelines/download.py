"""Image acquisition + KV copy ops utilities.

Copied from ``multimodalsimilar_tpu/pipelines/download.py`` (it imports
no JAX), against the port's ``pipelines/sinks.py``.

* ``download_images`` <- daodian_image_download.py:48-118 — threadpool(20)
  download of {out_root}/{sku}/{img_id}.jpg, skip-if-exists; per-item errors
  logged and skipped (never fatal).
* ``copy_kv``         <- copy_redis.py:18-35 — bulk key copy between KV
  stores in chunks, TTL re-applied.

``fetch_fn(url) -> bytes`` is injectable so tests (and the zero-egress build
environment) run without network; the default uses urllib.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Sequence, Tuple

from multimodalsimilar_tpu_torch.pipelines.sinks import KVSink


def _default_fetch(url: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def download_images(
    items: Sequence[Tuple[str, str, str]],   # (sku, img_id, url)
    out_root: str,
    fetch_fn: Optional[Callable[[str], bytes]] = None,
    threads: int = 20,
    skip_existing: bool = True,
) -> Tuple[int, int]:
    """Returns (downloaded, skipped_or_failed)."""
    if fetch_fn is None:
        fetch_fn = _default_fetch
    ok = failed = 0

    def one(item):
        sku, img_id, url = item
        path = os.path.join(out_root, str(sku), f"{img_id}.jpg")
        if skip_existing and os.path.exists(path):
            return False
        try:
            data = fetch_fn(url)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
            return True
        except Exception as e:
            print(f"download failed {url}: {e}", flush=True)
            return False

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for res in pool.map(one, items):
            ok += int(res)
            failed += int(not res)
    return ok, failed


def copy_kv(src: KVSink, dst: KVSink, keys: Iterable[str],
            ttl_seconds: int = 7 * 24 * 3600, chunk: int = 1000) -> int:
    """Copy keys src->dst re-applying the TTL (copy_redis.py semantics)."""
    copied = 0
    buf = {}
    for k in keys:
        v = src.get(k)
        if v is None:
            continue
        buf[k] = v
        if len(buf) >= chunk:
            dst.set_many(buf, ttl_seconds)
            copied += len(buf)
            buf = {}
    if buf:
        dst.set_many(buf, ttl_seconds)
        copied += len(buf)
    return copied
