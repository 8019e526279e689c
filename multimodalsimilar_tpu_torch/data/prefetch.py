"""Host -> device prefetching (counterpart of
multimodalsimilar_tpu/data/prefetch.py).

A producer thread builds the next batches (tokenization, bucket trims)
and starts their copies while the device runs the current step. On a
CUDA device each numpy array goes into pinned host memory and is copied
with ``non_blocking=True``; PyTorch's pinned allocator keeps the host
buffer alive until its copy has run. The copies go on the producer
thread's current stream, which is the device's default stream, the one
the training step runs on, so a step never reads a batch before its copy
has landed. There is no mesh: the port runs on one device. The recorder's
spans (``utils/profiling.py``): ``prefetch.build`` (the source's next
batch) and ``prefetch.upload`` on the producer thread, ``prefetch.wait``
(the consumer's wait on the queue) on the consumer's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from multimodalsimilar_tpu_torch.utils.profiling import span


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (pinned, non-blocking copies
    for CUDA)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(batch_iter: Iterator, device, buffer_size: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator: produce in the background and copy
    ahead. If the consumer abandons the generator early (an exception in
    the training loop, a break), the producer is told to stop and the
    queue is drained, so it never blocks on a full queue holding device
    batches."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    end = object()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(batch_iter)
            while True:
                with span("prefetch.build"):
                    batch = next(it, end)
                if batch is end or stop.is_set():
                    return
                with span("prefetch.upload"):
                    item = to_device(batch, device)
                if not put(item):
                    return
        except Exception as e:  # surfaced in the consumer
            err.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            with span("prefetch.wait"):
                item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
