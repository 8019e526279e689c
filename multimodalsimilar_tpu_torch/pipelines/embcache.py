"""Packed on-disk embedding cache (the emb.txt replacement).

The reference caches one embedding per SKU as a TEXT file next to the
images — np.savetxt on write, np.loadtxt on read (daodian_infer.py:259-285;
goodssku_emb_cv_di.py re-reads every emb.txt for the day's catalog). At
warehouse key counts that is minutes of host time spent parsing decimal
floats out of 100k+ tiny files. ``EmbeddingCache`` stores fixed-dim
float32 records packed in one data.bin with a keys.txt index — the same
crash discipline as data.images.DecodedCache (atomic meta.json, flock'd
record-aligned appends, torn-tail tolerance, cross-process index refresh)
applied to embeddings (the JAX package's benchmarks/embcache_bench.py
compares the two read paths on the host).

Copied from ``multimodalsimilar_tpu/pipelines/embcache.py`` (numpy and
the standard library only). Reference compatibility: ``import_emb_txt`` ingests an existing emb.txt
tree, ``export_emb_txt`` writes one back in the exact layout the
reference's jobs read (np.savetxt float-per-line next to the images) —
and ``pipelines.embedders.ImageEmbedder`` migrates organically when given
both a cache and a legacy ``cache_path_for_key`` (cache miss -> read
emb.txt -> backfill the cache).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np


class EmbeddingCache:
    """One fixed-dim f32 record per key; see module docstring."""

    _instances: dict = {}
    _instances_lock = threading.Lock()

    @classmethod
    def open(cls, directory: str, dim: int) -> "EmbeddingCache":
        key = (os.path.realpath(directory), dim)
        with cls._instances_lock:
            inst = cls._instances.get(key)
            if inst is None:
                inst = cls._instances[key] = cls(directory, dim)
            return inst

    def __init__(self, directory: str, dim: int):
        os.makedirs(directory, exist_ok=True)
        self.dim = int(dim)
        self.record = self.dim * 4            # float32
        meta_path = os.path.join(directory, "meta.json")
        meta = None
        if os.path.exists(meta_path):
            try:
                meta = json.load(open(meta_path))
            except (json.JSONDecodeError, OSError):
                meta = None                   # torn meta: rewrite below
        if meta is not None:
            if meta["dim"] != self.dim:
                raise ValueError(
                    f"EmbeddingCache at {directory} holds {meta['dim']}-d "
                    f"embeddings, requested {self.dim}-d — use a separate "
                    f"directory")
        else:
            data_bin = os.path.join(directory, "data.bin")
            if os.path.exists(data_bin) and os.path.getsize(data_bin) > 0:
                raise ValueError(
                    f"EmbeddingCache at {directory}: meta.json is "
                    f"unreadable but data.bin is non-empty — delete the "
                    f"directory to rebuild")
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"dim": self.dim, "format": "f32-v1"}, f)
            os.replace(tmp, meta_path)
        self._keys_path = os.path.join(directory, "keys.txt")
        self._data_path = os.path.join(directory, "data.bin")
        self._index: Dict[str, int] = {}
        self._keys_offset = 0
        self._lock = threading.Lock()
        if os.path.exists(self._keys_path):
            with open(self._keys_path, "rb") as f:
                raw = f.read()
            if raw and not raw.endswith(b"\n"):
                # torn final line: poison it so it never mis-maps
                with open(self._keys_path, "ab") as f:
                    f.write(b"\t#\n")
                raw += b"\t#\n"
            self._ingest_keys(raw)
        self._read_fd = os.open(self._data_path,
                                os.O_RDONLY | os.O_CREAT, 0o644)

    # -- index ------------------------------------------------------------

    def _ingest_keys(self, raw: bytes) -> None:
        for line in raw.decode("utf-8", "replace").splitlines():
            key, _, slot = line.rpartition("\t")
            if key and slot.isdigit():
                self._index[key] = int(slot)
        self._keys_offset += len(raw)

    def _refresh_index(self) -> None:
        try:
            end = os.path.getsize(self._keys_path)
        except OSError:
            return
        if end <= self._keys_offset:
            return
        with open(self._keys_path, "rb") as f:
            f.seek(self._keys_offset)
            raw = f.read()
        if raw and not raw.endswith(b"\n"):
            raw = raw[: raw.rfind(b"\n") + 1]
        self._ingest_keys(raw)

    def __len__(self):
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self) -> Iterable[str]:
        with self._lock:
            self._refresh_index()
        return list(self._index)

    # -- records ----------------------------------------------------------

    def get(self, key: str) -> Optional[np.ndarray]:
        slot = self._index.get(key)
        if slot is None:
            with self._lock:
                self._refresh_index()
            slot = self._index.get(key)
            if slot is None:
                return None
        buf = os.pread(self._read_fd, self.record, slot * self.record)
        if len(buf) != self.record:
            return None                       # torn write from a crash
        return np.frombuffer(buf, np.float32).copy()

    def get_many(self, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        out = {}
        for k in keys:
            v = self.get(k)
            if v is not None:
                out[k] = v
        return out

    def _validate(self, key: str, vec: np.ndarray) -> bytes:
        v = np.ascontiguousarray(vec, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"expected a ({self.dim},) vector, "
                             f"got {v.shape}")
        if "\t" in key or "\n" in key:
            raise ValueError(f"cache key may not contain tab/newline: "
                             f"{key!r}")
        return v.tobytes()

    def _append_locked(self, items) -> int:
        """Append (key, payload) records under ONE open/flock/fstat cycle.

        One syscall cycle per BATCH, not per record: put_many over a
        warehouse migration was paying 100k open+LOCK_EX+fstat+close
        rounds plus 100k keys.txt appends on this host's one slow CPU.
        Caller holds self._lock. Already-present keys are skipped (the
        index is re-checked under the file lock, so two processes
        migrating the same tree don't double-append)."""
        import fcntl
        fd = os.open(self._data_path, os.O_WRONLY | os.O_CREAT, 0o644)
        lines = []
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            self._refresh_index()
            end = os.fstat(fd).st_size
            slot = end // self.record         # re-align past a torn tail
            off = slot * self.record
            for key, payload in items:
                if key in self._index:
                    continue
                done = 0
                while done < len(payload):
                    done += os.pwrite(fd, payload[done:], off + done)
                lines.append(f"{key}\t{slot}\n")
                self._index[key] = slot
                slot += 1
                off += self.record
            if lines:
                # keys.txt written before the data flock releases: a
                # concurrent appender computes its slots from data.bin's
                # size, so its keys can't collide with these
                kfd = os.open(self._keys_path,
                              os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
                try:
                    # another process may have crashed mid-append leaving
                    # a torn final line; poison it under this flock (the
                    # same discipline __init__ applies) so our first key
                    # can't merge into it as 'tornkey\tslot'
                    size = os.fstat(kfd).st_size
                    if size:
                        with open(self._keys_path, "rb") as rf:
                            rf.seek(size - 1)
                            if rf.read(1) != b"\n":
                                os.write(kfd, b"\t#\n")
                    buf = "".join(lines).encode()
                    done = 0
                    while done < len(buf):
                        done += os.write(kfd, buf[done:])
                finally:
                    os.close(kfd)
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
        return len(lines)

    def put(self, key: str, vec: np.ndarray) -> None:
        payload = self._validate(key, vec)
        with self._lock:
            if key in self._index:
                return
            self._append_locked([(key, payload)])

    def put_many(self, items: Dict[str, np.ndarray]) -> None:
        batch = [(k, self._validate(k, v)) for k, v in items.items()
                 if k not in self._index]
        if not batch:
            return
        with self._lock:
            self._append_locked(batch)

    def close(self):
        with self._instances_lock:
            for k, v in list(self._instances.items()):
                if v is self:
                    del self._instances[k]
        os.close(self._read_fd)

    # -- emb.txt compatibility --------------------------------------------

    def import_emb_txt(self, cache_path_for_key: Callable[[str], str],
                       keys: Sequence[str]) -> int:
        """Ingest an existing reference-layout emb.txt tree
        (daodian_infer.py:259-285: np.loadtxt per key). Returns #imported;
        keys without a readable emb.txt (or already cached) are skipped."""
        n = 0
        batch: Dict[str, np.ndarray] = {}
        for key in keys:
            if self._index.get(key) is not None:
                continue
            path = cache_path_for_key(key)
            if not os.path.exists(path):
                continue
            try:
                # whole-file split parse; measured ~1.2x np.loadtxt on
                # this numpy — kept for the simpler failure mode (any
                # malformed token raises ValueError -> key skipped)
                with open(path) as f:
                    vec = np.array(f.read().split(), dtype=np.float32)
                if vec.size == 0:
                    continue
            except (ValueError, OSError):
                continue
            if vec.shape == (self.dim,):
                batch[key] = vec
                n += 1
                if len(batch) >= 4096:   # bound memory on warehouse trees
                    self.put_many(batch)
                    batch.clear()
        if batch:
            self.put_many(batch)
        return n

    def export_emb_txt(self, cache_path_for_key: Callable[[str], str],
                       keys: Optional[Sequence[str]] = None) -> int:
        """Write the reference's exact emb.txt layout back out (np.savetxt
        float-per-line) so its own jobs can read this cache's contents."""
        n = 0
        for key in (self.keys() if keys is None else keys):
            vec = self.get(key)
            if vec is None:
                continue
            path = cache_path_for_key(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savetxt(path, vec)
            n += 1
        return n
