"""Micro-batching and query-payload parsing for the serving daemon.

Copied from ``multimodalsimilar_tpu/pipelines/microbatch.py`` (which
imports no JAX): ``DeferredBatch`` lets a device-path batch return launched
but unread results so the worker overlaps the read-back with the next
micro-batch; ``MicroBatcher`` is the single device-owner queue;
``TextQueryParser``, ``ImageQueryParser`` and ``MultimodalQueryParser``
extract text, image and (text, image) queries from request bodies. The
image parsers decode with OpenCV (``data/images.py``, which imports it
when an image is decoded).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List

import numpy as np

from multimodalsimilar_tpu_torch.data import images as I

_CLOSE = object()


class DeferredBatch:
    """``run_batch`` may return this instead of a results list: the
    batch's device work is LAUNCHED but not read back. ``finish()`` blocks
    on the read-back and returns the results. The MicroBatcher overlaps
    ``finish()`` with collecting and launching the NEXT micro-batch
    (depth-1 pipeline), so the read-back's wait rides on device work the
    next batch is already doing."""

    def __init__(self, finish: Callable[[], List[object]]):
        self.finish = finish


class TextQueryParser:
    """Extract text-tower query payloads from request dicts.

    ``one`` (the /similar shape) and ``many`` (the /embed shape) raise
    ValueError with a client-facing message on malformed input — the
    handler maps that to a 400.
    """

    def one(self, req: dict) -> str:
        text = req.get("text")
        if not isinstance(text, str):
            raise ValueError("need 'text': str")
        return text

    def many(self, req: dict) -> List[str]:
        texts = req.get("texts")
        if texts is None and "text" in req:
            texts = [req["text"]]
        if not isinstance(texts, list) or \
                not all(isinstance(t, str) for t in texts):
            raise ValueError("need 'texts': [str, ...]")
        return texts


class ImageQueryParser:
    """Extract image-tower query payloads: ``image_b64`` (base64-encoded
    JPEG/PNG bytes) or ``image_path`` (server-local file) -> resized RGB
    uint8 [S, S, 3]. Decode and resize run on the HANDLER thread, so the
    device worker's micro-batch only uploads uint8 and runs the tower
    (normalization runs on the device)."""

    def __init__(self, image_size: int):
        self.image_size = image_size

    def one(self, req: dict) -> np.ndarray:
        if req.get("image_b64") is not None:
            import base64
            import binascii
            if not isinstance(req["image_b64"], str):
                raise ValueError("'image_b64' must be a base64 string")
            try:
                raw = base64.b64decode(req["image_b64"], validate=True)
            except (binascii.Error, TypeError, ValueError) as e:
                raise ValueError(f"bad image_b64: {e}")
            img = I.decode_image_bytes(raw)
            if img is None:
                raise ValueError("image_b64 bytes did not decode to an "
                                 "image (JPEG/PNG expected)")
        elif req.get("image_path") is not None:
            img = I.decode_image(str(req["image_path"]))
            if img is None:
                raise ValueError(
                    f"could not read image_path {req['image_path']!r}")
        else:
            raise ValueError("need 'image_b64' (base64 JPEG/PNG) or "
                             "'image_path'")
        return I.resize(img, self.image_size)

    def many(self, req: dict) -> List[np.ndarray]:
        for field, key in (("images_b64", "image_b64"),
                           ("image_paths", "image_path")):
            if field in req:
                vals = req[field]
                if not isinstance(vals, list) or not vals:
                    raise ValueError(f"'{field}' must be a non-empty list")
                return [self.one({key: v}) for v in vals]
        return [self.one(req)]


class MultimodalQueryParser:
    """Extract fused-tower queries: ``text`` (str) plus an image
    (``image_b64`` / ``image_path`` — ImageQueryParser's fields) -> a
    ``(text, resized uint8 image)`` pair for MultimodalEmbedder. The batch
    form zips ``texts`` with ``images_b64``/``image_paths`` positionally
    (equal lengths required), like the offline fused job's per-row
    (title, {key}.jpg) input (multimodal_infer.py:127-134)."""

    def __init__(self, image_size: int):
        self._text = TextQueryParser()
        self._image = ImageQueryParser(image_size)

    def one(self, req: dict) -> tuple:
        if not isinstance(req.get("text"), str):
            raise ValueError("need 'text': str (plus 'image_b64' or "
                             "'image_path') — the fused tower embeds a "
                             "text+image pair")
        return (req["text"], self._image.one(req))

    def many(self, req: dict) -> List[tuple]:
        if "texts" not in req and "images_b64" not in req \
                and "image_paths" not in req:
            return [self.one(req)]
        texts = self._text.many(req)
        images = self._image.many(req)
        if len(texts) != len(images):
            raise ValueError(
                f"'texts' ({len(texts)}) and images ({len(images)}) must "
                "have the same length — pairs are zipped positionally")
        return list(zip(texts, images))


class MicroBatcher:
    """Coalesce concurrent blocking submissions into batched calls.

    ``run_batch(items) -> results`` runs on ONE worker thread (the only
    thread that may touch the device); ``submit`` blocks the calling
    thread until its item's result (or exception) is available.

    The worker blocks for the first item, then keeps draining the queue
    until either ``max_batch`` items are in hand or ``max_wait_ms`` has
    elapsed since the first item — a trickle of lone requests pays at
    most ``max_wait_ms`` extra latency, a concurrent burst becomes one
    device call.
    """

    def __init__(self, run_batch: Callable[[List], List],
                 max_batch: int = 64, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.stats = {"batches": 0, "items": 0, "max_batch_seen": 0}
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # serializes the closed-check+enqueue against close(): without it a
        # submitter could pass the check, lose the CPU while close() puts
        # _CLOSE and the worker exits, then enqueue onto a dead queue — its
        # Future would never resolve and submit() would block forever
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatch-worker")
        self._worker.start()

    def submit_nowait(self, item) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((item, fut))
        return fut

    def submit(self, item):
        return self.submit_nowait(item).result()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_CLOSE)
        self._worker.join(timeout=30)

    def _run(self):
        pending = None   # (batch, DeferredBatch): launched, not read back
        while True:
            if pending is None:
                first = self._q.get()
            else:
                # bounded wait: the pending batch's clients are blocked on
                # its futures, so with no new traffic we must finish it
                # now rather than hold the read-back hostage
                try:
                    first = self._q.get(timeout=self.max_wait)
                except queue.Empty:
                    self._finish(*pending)
                    pending = None
                    continue
            if first is _CLOSE:
                if pending is not None:
                    self._finish(*pending)
                return
            batch = [first]
            closing = self._collect_into(batch)
            if pending is not None and not closing \
                    and len(batch) < self.max_batch:
                # partial batch while one is in flight: finish the pending
                # read-back FIRST and top the batch up with the clients
                # that releases; only FULL batches ride the pipeline, so a
                # burst is not split into many small device calls
                self._finish(*pending)
                pending = None
                closing = self._collect_into(batch)
            items = [it for it, _ in batch]
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(items))
            deferred = None
            try:
                results = self.run_batch(items)
                if isinstance(results, DeferredBatch):
                    deferred = results   # read-back overlaps the next batch
                else:
                    self._resolve(batch, results)
            except Exception as e:  # propagate to every waiter, keep serving
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            # finish the PREVIOUS batch after this one is launched: its
            # read-back wait rode on top of this batch's device work
            if pending is not None:
                self._finish(*pending)
            if deferred is not None and self._q.empty():
                # no follow-up traffic queued: holding the read-back
                # pending can't overlap anything (its own clients are
                # blocked on the futures) — it would only add a full
                # max_wait queue-poll stall before resolving. The depth-1
                # pipeline engages exactly when there IS queued traffic to
                # overlap with (c > max_batch, or open-loop arrivals).
                self._finish(batch, deferred)
                deferred = None
            pending = (batch, deferred) if deferred is not None else None
            if closing:
                if pending is not None:
                    self._finish(*pending)
                return

    def _collect_into(self, batch) -> bool:
        """Drain the queue into ``batch`` until max_batch or max_wait
        since this call; True if _CLOSE was seen."""
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is _CLOSE:
                return True
            batch.append(nxt)
        return False

    @staticmethod
    def _resolve(batch, results):
        if len(results) != len(batch):
            raise RuntimeError(
                f"run_batch returned {len(results)} results for "
                f"{len(batch)} items")
        for (_, fut), res in zip(batch, results):
            fut.set_result(res)

    def _finish(self, batch, deferred):
        try:
            self._resolve(batch, deferred.finish())
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
