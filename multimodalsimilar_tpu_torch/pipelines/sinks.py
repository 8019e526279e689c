"""Serving/warehouse sinks behind thin interfaces with in-memory fakes.

The reference writes straight to production infra — Redis SET+EXPIRE
pipelines (nlp_infer.py:154-172) and Hive tmp-table + INSERT OVERWRITE via
Spark (goodssku_emb_bert_di.py:148-154). Here the same contracts are
interfaces so every pipeline is testable hermetically:

* KVSink — pipelined set-with-TTL key/value writes (online serving store).
  RedisKVSink adapts a real redis client when the ``redis`` package and a
  server exist; InMemoryKVSink is the fake.
* TableSink — append/overwrite of key->row tables (embedding warehouse).
  ParquetTableSink stands in for Hive (a dt-partitioned parquet dir);
  InMemoryTableSink is the fake.

Copied from ``multimodalsimilar_tpu/pipelines/sinks.py``, with pandas
imported inside the table sinks only: the KV path does not need it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional, Tuple


class KVSink:
    def set_many(self, items: Mapping[str, str],
                 ttl_seconds: Optional[int] = None) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError


class InMemoryKVSink(KVSink):
    """Fake Redis: stores (value, expiry-timestamp)."""

    def __init__(self):
        self.data: Dict[str, Tuple[str, Optional[float]]] = {}

    def set_many(self, items, ttl_seconds=None):
        exp = time.time() + ttl_seconds if ttl_seconds else None
        for k, v in items.items():
            self.data[k] = (str(v), exp)

    def get(self, key):
        item = self.data.get(key)
        if item is None:
            return None
        value, exp = item
        if exp is not None and time.time() > exp:
            del self.data[key]
            return None
        return value

    def ttl(self, key) -> Optional[float]:
        item = self.data.get(key)
        return None if item is None or item[1] is None else \
            item[1] - time.time()

    def keys(self) -> List[str]:
        return list(self.data)


class RedisKVSink(KVSink):
    """Real Redis adapter, written like copy_redis.py/nlp_infer.py use it:
    chunked pipelines of SET + EXPIRE (chunk 1000, copy_redis.py:22-35)."""

    def __init__(self, host: str, port: int = 6379, db: int = 0,
                 password: Optional[str] = None, chunk: int = 1000):
        import redis  # optional dependency; import deferred
        self.client = redis.StrictRedis(host=host, port=port, db=db,
                                        password=password)
        self.chunk = chunk

    def set_many(self, items, ttl_seconds=None):
        pipe = self.client.pipeline(transaction=False)
        for i, (k, v) in enumerate(items.items(), 1):
            if ttl_seconds:
                pipe.setex(k, int(ttl_seconds), v)
            else:
                pipe.set(k, v)
            if i % self.chunk == 0:
                pipe.execute()
        pipe.execute()

    def get(self, key):
        v = self.client.get(key)
        return v.decode() if isinstance(v, bytes) else v


class TableSink:
    def existing_keys(self, key_col: str) -> set:
        raise NotImplementedError

    def append(self, df) -> None:
        raise NotImplementedError

    def overwrite(self, df) -> None:
        raise NotImplementedError

    def read(self):
        raise NotImplementedError


class InMemoryTableSink(TableSink):
    def __init__(self):
        import pandas as pd
        self._df = pd.DataFrame()

    def existing_keys(self, key_col):
        return set() if self._df.empty else set(self._df[key_col])

    def append(self, df):
        import pandas as pd
        self._df = pd.concat([self._df, df], ignore_index=True)

    def overwrite(self, df):
        self._df = df.reset_index(drop=True)

    def read(self):
        return self._df.copy()


class ParquetTableSink(TableSink):
    """Hive-table stand-in: a parquet file per table. ``overwrite`` mimics
    the reference's tmp-table + INSERT OVERWRITE (atomic replace via
    rename).

    ``append`` writes a sidecar part file ({path}.parts/part-*.parquet)
    instead of read-whole + rewrite — a warehouse backfill flushing every
    50k rows paid quadratic parquet I/O otherwise, the exact cost
    embed.py's flush design exists to avoid (the Spark sink appends via
    INSERT INTO for the same reason). read()/existing_keys() see main +
    parts; ``compact()`` (called by incremental_export on success) merges
    parts back into the single file external consumers read."""

    def __init__(self, path: str):
        self.path = path
        self.parts_dir = path + ".parts"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _part_files(self):
        if not os.path.isdir(self.parts_dir):
            return []
        return sorted(os.path.join(self.parts_dir, f)
                      for f in os.listdir(self.parts_dir)
                      if f.endswith(".parquet"))

    def existing_keys(self, key_col):
        import pandas as pd
        keys = set()
        if os.path.exists(self.path):
            keys.update(pd.read_parquet(self.path,
                                        columns=[key_col])[key_col])
        for p in self._part_files():
            keys.update(pd.read_parquet(p, columns=[key_col])[key_col])
        return keys

    def read(self):
        import pandas as pd
        frames = ([pd.read_parquet(self.path)]
                  if os.path.exists(self.path) else [])
        frames += [pd.read_parquet(p) for p in self._part_files()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def _write(self, df, dest):
        tmp = f"{dest}.tmp.{os.getpid()}"
        df.reset_index(drop=True).to_parquet(tmp)
        os.replace(tmp, dest)

    def append(self, df):
        if not os.path.exists(self.path) and not self._part_files():
            self._write(df, self.path)        # first write creates the table
            return
        os.makedirs(self.parts_dir, exist_ok=True)
        n = len(self._part_files())
        self._write(df, os.path.join(self.parts_dir,
                                     f"part-{os.getpid()}-{n:06d}.parquet"))

    def overwrite(self, df):
        self._write(df, self.path)
        for p in self._part_files():
            os.remove(p)
        if os.path.isdir(self.parts_dir):
            try:
                os.rmdir(self.parts_dir)
            except OSError:
                pass

    def compact(self):
        """Merge append parts into the single file (one O(N) rewrite at
        job end; a crash before compact leaves parts that read()/
        existing_keys() still see, so a retry resumes correctly)."""
        if self._part_files():
            self.overwrite(self.read())
