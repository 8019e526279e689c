"""Corpus-sharded serving over ``torch.distributed`` ranks: every engine
call of the serving rank replayed, in lockstep, by every other rank.

This module has no counterpart in the JAX package. There one process
drives every device of the mesh, so the daemon's sharded search
(``sharded_knn_search`` over the engine's row-sharded corpus) needs no
replay. The port runs one process per rank, and a sharded search is a
collective on every rank of the data axis: the query chunk's all-reduce
(``SimilarityEngine._chunk_rows``) and the candidates' all-gather
(``retrieval/knn.py:sharded_knn_search``). So each search that global
rank 0 makes must be made by every other rank too, in the same order and
with the same queries. A rank that misses one hangs the daemon.

The replay sits at the engine, which every call of the service passes
through: the warm-up ladder, the host path's ``search``, the device
path's ``search_device`` and ``/update``'s ``update``.

* ``LockstepEngine`` wraps rank 0's engine. Before each of those calls it
  broadcasts a small int64 header (op, query rows, k, width, query kind)
  and the payload, then makes the call itself. The payload of a search is
  its f32 query rows; that of an update is the embeddings, then the keys,
  categories and dts as one object. Every other attribute reads through
  to the engine (the fused chain is None for a sharded corpus, so the
  service takes the two-step chain).
* ``follow(engine, mesh)`` runs on every other rank (``Follower.run``,
  what ``cli/serve.py`` gives those ranks in place of a service). It
  receives headers and replays the same calls on its own engine until the
  ``stop`` op, which ``LockstepEngine.stop`` sends
  (``SimilarityService.close``).

Rank 0 decides what each call is before it broadcasts, so an empty query
set, which returns before any collective, does so on every rank. The
filters, ``exclude_key``, ``score_th`` and the read-back stay on rank 0:
they work on the merged answer, which every rank holds. A call that
raises, raises on every rank alike (the same inputs on the same corpus):
the follower reports it and waits for the next, as the service goes on
serving. The headers and payloads travel over ``Mesh.control_group``, a
gloo group on the host in which a follower may wait for the next request
as long as the daemon stays idle; the engine's own collectives use the
mesh's data groups (NCCL on cards). A lock makes the calls of rank 0's
threads (the warm-up, then the MicroBatcher's worker) one sequence.
"""

from __future__ import annotations

import collections
import sys
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

STOP, SEARCH, SEARCH_DEVICE, UPDATE = range(4)
OPS = {SEARCH: "search", SEARCH_DEVICE: "search_device", UPDATE: "update"}
# what a search's queries were on rank 0, so a follower passes the same
NUMPY, TENSOR, SELF = range(3)
_HEADER = 5                      # op, rows, k, width, query kind


def _broadcast(group, t: torch.Tensor) -> torch.Tensor:
    dist.broadcast(t, src=0, group=group)
    return t


def _send_rows(group, rows) -> None:
    """The f32 rows of rank 0 to every rank (host tensors)."""
    if isinstance(rows, torch.Tensor):
        t = rows.detach().to("cpu", torch.float32)
    else:
        t = torch.from_numpy(np.asarray(rows, np.float32))
    _broadcast(group, t.contiguous())


def _recv_rows(group, rows: int, width: int) -> torch.Tensor:
    return _broadcast(group, torch.empty((rows, width), dtype=torch.float32))


class LockstepEngine:
    """Global rank 0's ``SimilarityEngine``, each of whose collective
    calls every other rank replays (``follow``). Build it on rank 0 at the
    point where the others call ``follow``."""

    def __init__(self, engine, mesh):
        if not engine.sharded or mesh.rank != 0:
            raise ValueError("LockstepEngine wraps global rank 0's engine "
                             "over a sharded corpus")
        self._engine = engine
        self._group = mesh.control_group()
        self._lock = threading.Lock()
        self._stopped = False
        self.calls: Dict[str, int] = collections.Counter()

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _header(self, op: int, rows: int = 0, k: int = 0, width: int = 0,
                kind: int = NUMPY) -> None:
        if self._stopped:
            raise RuntimeError("the sharded engine was stopped")
        _broadcast(self._group, torch.tensor([op, rows, k, width, kind],
                                             dtype=torch.int64))
        if op != STOP:
            self.calls[OPS[op]] += 1

    def search(self, k: int, queries=None):
        with self._lock:
            if queries is None:
                self._header(SEARCH, k=k, kind=SELF)
            else:
                kind = TENSOR if isinstance(queries, torch.Tensor) else NUMPY
                q = queries if kind == TENSOR else np.asarray(queries)
                self._header(SEARCH, q.shape[0], k, q.shape[1], kind)
                _send_rows(self._group, q)
            return self._engine.search(k, queries=queries)

    def search_device(self, k: int, queries):
        with self._lock:
            q = (queries if isinstance(queries, torch.Tensor)
                 else np.asarray(queries))
            self._header(SEARCH_DEVICE, q.shape[0], k, q.shape[1])
            _send_rows(self._group, q)
            return self._engine.search_device(k, queries)

    def update(self, embeddings, keys: Sequence,
               categories: Optional[Sequence] = None,
               dts: Optional[Sequence] = None):
        with self._lock:
            emb = np.asarray(embeddings, np.float32)
            if emb.ndim != 2:
                raise ValueError(f"embeddings {emb.shape} vs {len(keys)} "
                                 "keys")
            self._header(UPDATE, emb.shape[0], 0, emb.shape[1])
            _send_rows(self._group, emb)
            box = [(list(keys), categories, dts)]
            dist.broadcast_object_list(box, src=0, group=self._group)
            return self._engine.update(emb, keys, categories=categories,
                                       dts=dts)

    def stop(self) -> None:
        """Send every follower ``stop`` (once); later calls raise."""
        with self._lock:
            if not self._stopped:
                self._header(STOP)
                self._stopped = True


class Follower:
    """A rank other than global rank 0 of a daemon over several ranks,
    in place of the service: ``run`` replays rank 0's engine calls until
    ``stop`` and returns how many of each it replayed. When the corpus is
    not sharded (a data axis of 1: a mesh whose model axis spans every
    rank; or no mesh, as with ``--approx_recall``), rank 0 serves alone
    and ``run`` returns at once."""

    def __init__(self, engine, mesh):
        self.engine, self.mesh = engine, mesh

    def run(self) -> Dict[str, int]:
        if not self.engine.sharded:
            return {}
        return follow(self.engine, self.mesh)


def follow(engine, mesh) -> Dict[str, int]:
    """Replay global rank 0's engine calls on this rank's ``engine`` until
    rank 0 sends ``stop``; returns how many of each op were replayed."""
    group = mesh.control_group()
    counts: Dict[str, int] = collections.Counter()
    while True:
        header = _broadcast(group, torch.empty(_HEADER, dtype=torch.int64))
        op, rows, k, width, kind = header.tolist()
        if op == STOP:
            return dict(counts)
        counts[OPS[op]] += 1
        q = None if kind == SELF else _recv_rows(group, rows, width)
        if op == UPDATE:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=group)
            keys, categories, dts = box[0]
        try:
            if op == SEARCH:
                engine.search(k, queries=(q.numpy() if kind == NUMPY
                                          else q))
            elif op == SEARCH_DEVICE:
                engine.search_device(k, q)
            else:
                engine.update(q.numpy(), keys, categories=categories,
                              dts=dts)
        except Exception as e:    # rank 0 meets the same error
            print(f"rank {mesh.rank}: {OPS[op]} raised {e!r}; rank 0 "
                  "raised it too", file=sys.stderr, flush=True)
