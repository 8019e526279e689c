"""Run a function on N ranks, each its own process, and collect what each
returns (what ``torchrun`` does for the command line, for the tests and
``chip_smoke.py``).

The ranks start under ``multiprocessing``'s ``spawn`` method, so ``fn``
must be importable by module path, and its module should import only
what the ranks need (a child imports it afresh). Each rank sets the
environment ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), joins the process group (even a
world of one) and calls ``fn(*args)``. A rank that raises
fails the run, and so does one that has not answered by ``timeout``
seconds: a hung collective becomes an error, and every rank is stopped.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that the OS just handed out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank, world, port, device, local_rank, threads,
               out):
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(local_rank or 0),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        import torch
        import torch.distributed as dist

        from multimodalsimilar_tpu_torch.parallel.mesh import TIMEOUT
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(local_rank or 0)
        # a process group even for one rank: its collectives then run
        # through the backend (NCCL with a card a rank; else gloo, every
        # rank on one device)
        dist.init_process_group(
            "nccl" if local_rank is not None else "gloo",
            init_method="env://", rank=rank, world_size=world,
            timeout=TIMEOUT)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))   # for the parent
        raise


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          device: str = "cpu", backend: Optional[str] = None,
          timeout: float = 120.0, threads: Optional[int] = 1) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world)]``.

    ``backend="nccl"`` (``device="cuda"``) gives rank r the card
    ``cuda:r``; ``backend="gloo"`` puts every rank on ``device`` (all on
    ``cuda:0`` when it is ``"cuda"``). ``threads``: torch threads per
    rank."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl needs device='cuda'")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, tuple(args), r, world, port, device,
              r if backend == "nccl" else None, threads, out))
        for r in range(world)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * world
    failed = []
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            left = deadline - time.monotonic()
            try:
                rank, ok, value = out.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)}: no "
                    f"answer within {timeout:.0f} s (a hung collective?)")
            if not ok:
                failed.append(f"rank {rank}:\n{value}")
                break
            results[rank] = value
        if failed:
            raise RuntimeError("a rank failed: " + "\n".join(failed))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return results
