"""Streaming exact top-k similarity: the CUDA kernel, its plain version and
the wrapper that picks between them by device.

Counterpart of ``multimodalsimilar_tpu/ops/topk.py`` (``pallas_topk``,
kernel ``_topk_kernel``). Same contract: for each query the top ``k``
corpus rows by inner product (``ip``, scores descending) or squared L2
distance (``l2``, ascending), all math in f32, rows at index ``true_n``
or beyond excluded, ties to the lowest index (FAISS order), and
``k = min(k, true_n)``.

* ``topk_cuda`` launches ``csrc/topk.cu`` (see the note at its top for the
  bound and the design); k is at most ``MAX_K`` there and larger k raises.
* ``topk_select_cuda`` is the large-k route: the [Q, true_n] products,
  f32-accurate whatever the TF32 flag (``f32_products``; the JAX package
  leaves this product to XLA too, ``retrieval/knn.py:_scores``), then
  ``csrc/topk_select.cu`` selects the top k of each row by (value desc,
  index asc) at any k: a radix select of the k-th key where k is at most
  half the row, a block radix sort of the kept keys, rows longer than
  ``SELECT_CHUNK`` in chunks merged into a running top-k.
* ``topk_plain`` is plain PyTorch, blockwise, with a stable sort over
  (value desc, index asc); the CPU tests and ``chip_smoke.py`` hold both
  kernels against it. It is the plain version of both routes.
* ``streaming_topk`` takes the plain version only for tensors on the CPU;
  a CUDA tensor reaches ``csrc/topk.cu`` for k <= ``MAX_K`` and
  ``csrc/topk_select.cu`` above, or raises.

``LAUNCHES["topk"]`` and ``LAUNCHES["topk_select"]`` count kernel
launches, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

MAX_K = 128          # csrc/topk.cu kMaxK
SELECT_CHUNK = 16384  # csrc/topk_select.cu kChunk: columns held at once
QUERY_TILE = 128     # csrc/topk.cu: queries per block (64 when k > 113)
CHUNK_ROWS = 128     # csrc/topk.cu kTN: corpus rows per inner step
MIN_SPLIT_ROWS = 1024   # keeps the merge pass negligible next to a split
H100_F32_FLOPS = 67e12  # H100 SXM f32 peak outside the tensor cores
# The card's fastest f32-accurate route: the TF32 tensor cores (495 TFLOP/s
# dense) at three products per f32-accurate multiply-add (3xTF32).
H100_F32_ACCURATE_TC_FLOPS = 165e12
H100_HBM_BYTES = 3.35e12
LAUNCHES: collections.Counter = collections.Counter()

_FILL_IDX = 2**31 - 1


def _check(corpus: torch.Tensor, queries: torch.Tensor, metric: str,
           true_n: Optional[int]) -> int:
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if corpus.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"corpus {tuple(corpus.shape)} and queries "
                         f"{tuple(queries.shape)} must be 2-D")
    if corpus.shape[1] != queries.shape[1]:
        raise ValueError(f"dim mismatch: corpus d={corpus.shape[1]}, "
                         f"queries d={queries.shape[1]}")
    n = corpus.shape[0]
    if true_n is None:
        return n
    if not 0 < true_n <= n:
        raise ValueError(f"true_n={true_n} out of range for corpus of {n}")
    return true_n


def topk_plain(corpus: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str = "ip", true_n: Optional[int] = None,
               block_rows: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on the inputs' device.

    The corpus is scanned in blocks; each block's scores are concatenated
    after the running top-k and one stable descending sort keeps the best
    ``k``. Running entries all have lower indices than the block's, so
    stability puts equal values in ascending index order."""
    true_n = _check(corpus, queries, metric, true_n)
    k = min(k, true_n)
    q = queries.shape[0]
    dev = queries.device
    qf = queries.float()
    vals = torch.full((q, k), float("-inf"), dtype=torch.float32, device=dev)
    idx = torch.full((q, k), _FILL_IDX, dtype=torch.int64, device=dev)
    qn = (qf * qf).sum(1, keepdim=True) if metric == "l2" else None
    for b0 in range(0, true_n, block_rows):
        blk = corpus[b0: min(b0 + block_rows, true_n)].float()
        s = qf @ blk.T
        if metric == "l2":
            s = -(qn - 2.0 * s + (blk * blk).sum(1)[None, :])
        cols = torch.arange(b0, b0 + blk.shape[0], device=dev)
        cat_v = torch.cat([vals, s], dim=1)
        cat_i = torch.cat([idx, cols[None, :].expand(q, -1)], dim=1)
        sv, order = torch.sort(cat_v, dim=1, descending=True, stable=True)
        vals = sv[:, :k]
        idx = torch.gather(cat_i, 1, order[:, :k])
    if metric == "l2":
        vals = -vals
    return vals, idx.to(torch.int32)


def plan_splits(n_queries: int, true_n: int, n_sm: int,
                tile: int = QUERY_TILE) -> Tuple[int, int]:
    """(splits, rows_per_split) for ``csrc/topk.cu``: one block fills an
    SM (its shared memory), so split the corpus until the blocks fill the
    card in one wave, keeping at least ``MIN_SPLIT_ROWS`` rows per
    split."""
    tiles = -(-n_queries // tile)
    want = max(1, n_sm // tiles)
    splits = max(1, min(want, true_n // MIN_SPLIT_ROWS))
    rows = -(-true_n // splits)
    rows = -(-rows // CHUNK_ROWS) * CHUNK_ROWS
    return -(-true_n // rows), rows


@functools.cache
def _lib() -> ctypes.CDLL:
    from multimodalsimilar_tpu_torch.ops import _build
    lib = _build.load("topk")
    lib.mms_topk.restype = ctypes.c_int
    lib.mms_topk.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
    for fn, args in (("mms_topk_max_k", []), ("mms_topk_chunk_rows", []),
                     ("mms_topk_query_tile", [ctypes.c_int])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    got = (lib.mms_topk_max_k(), lib.mms_topk_query_tile(1),
           lib.mms_topk_chunk_rows())
    if got != (MAX_K, QUERY_TILE, CHUNK_ROWS):
        raise RuntimeError(f"csrc/topk.cu constants {got} disagree with "
                           f"ops/topk.py {(MAX_K, QUERY_TILE, CHUNK_ROWS)}")
    return lib


def _check_cuda(corpus: torch.Tensor, queries: torch.Tensor) -> None:
    for name, t in (("corpus", corpus), ("queries", queries)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if corpus.device != queries.device:
        raise ValueError(f"corpus on {corpus.device}, queries on "
                         f"{queries.device}")


def topk_cuda(corpus: torch.Tensor, queries: torch.Tensor, k: int,
              metric: str = "ip", true_n: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk.cu`` on the current stream. Inputs are f32,
    contiguous, on one CUDA device; k (after ``min(k, true_n)``) is at
    most ``MAX_K``."""
    true_n = _check(corpus, queries, metric, true_n)
    _check_cuda(corpus, queries)
    k = min(k, true_n)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the top-k kernel takes 1 <= k <= {MAX_K}, got "
                         f"k={k}")
    q, d = queries.shape
    dev = queries.device
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = plan_splits(q, true_n, n_sm, lib.mms_topk_query_tile(k))
    if splits > 1:
        part_v = torch.empty((splits, q, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, q, k), dtype=torch.int32, device=dev)
    else:
        part_v, part_i = out_v, out_i
    # l2: squared norms of the queries, then of the corpus rows
    norms = torch.empty(q + true_n if metric == "l2" else 0,
                        dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mms_topk(queries.data_ptr(), corpus.data_ptr(),
                           norms.data_ptr() if norms.numel() else None,
                           part_v.data_ptr(), part_i.data_ptr(),
                           out_v.data_ptr(), out_i.data_ptr(), q, d, true_n,
                           k, int(metric == "l2"), splits, rows, stream)
    if err:
        raise RuntimeError(f"csrc/topk.cu launch failed: cudaError {err}")
    LAUNCHES["topk"] += 1
    return out_v, out_i


@functools.cache
def _select_lib() -> ctypes.CDLL:
    from multimodalsimilar_tpu_torch.ops import _build
    lib = _build.load("topk_select")
    lib.mms_topk_select.restype = ctypes.c_int
    lib.mms_topk_select.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.mms_select_chunk.restype = ctypes.c_int
    lib.mms_select_chunk.argtypes = []
    if lib.mms_select_chunk() != SELECT_CHUNK:
        raise RuntimeError(f"csrc/topk_select.cu kChunk "
                           f"{lib.mms_select_chunk()} disagrees with "
                           f"ops/topk.py SELECT_CHUNK {SELECT_CHUNK}")
    return lib


def select_scratch_bytes(n: int, k: int) -> int:
    """Scratch bytes per query of ``csrc/topk_select.cu``: two running
    lists of k uint64 keys, only for rows longer than ``SELECT_CHUNK``."""
    return 16 * k if n > SELECT_CHUNK else 0


def select_cuda(scores: torch.Tensor, k: int,
                qnorm: Optional[torch.Tensor] = None,
                xnorm: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk_select.cu`` on the current stream: the top k
    (1 <= k <= n) of each row of ``scores`` [Q, n] (f32, contiguous, on a
    card) by (value desc, column asc). With ``qnorm`` [Q] and ``xnorm``
    [n] the scores are products and the result is the k smallest squared
    L2 distances ``qnorm - 2 s + xnorm``, ascending."""
    if scores.device.type != "cuda" or scores.dtype != torch.float32 \
            or scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous 2-D float32 tensor "
                         f"on a CUDA device, got {scores.dtype} "
                         f"{tuple(scores.shape)} on {scores.device}")
    q, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"the selection kernel takes 1 <= k <= n = {n}, "
                         f"got k={k}")
    l2 = qnorm is not None
    if l2 != (xnorm is not None):
        raise ValueError("l2 needs both qnorm and xnorm")
    if l2 and (qnorm.shape != (q,) or xnorm.shape != (n,)):
        raise ValueError(f"qnorm {tuple(qnorm.shape)} / xnorm "
                         f"{tuple(xnorm.shape)} do not fit scores {(q, n)}")
    dev = scores.device
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    lib = _select_lib()
    scratch = None
    if select_scratch_bytes(n, k):
        scratch = torch.empty((2, q, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mms_topk_select(
            scores.data_ptr(),
            qnorm.contiguous().data_ptr() if l2 else None,
            xnorm.contiguous().data_ptr() if l2 else None,
            scratch.data_ptr() if scratch is not None else None,
            out_v.data_ptr(), out_i.data_ptr(), q, n, k, int(l2), stream)
    if err:
        raise RuntimeError(f"csrc/topk_select.cu launch failed: cudaError "
                           f"{err}")
    LAUNCHES["topk_select"] += 1
    return out_v, out_i


def _tf32_big(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the 13 low mantissa bits cleared: exact in TF32."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def f32_products(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``queries @ rows.T`` accurate to f32 whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says. With TF32 off that is
    one f32 product. With it on, each operand is split into a TF32-exact
    big part and the rest (exact in f32), and the product is
    big.small + small.big + big.big, the 3xTF32 scheme of
    ``csrc/tf32x3.cuh``: relative error about 2^-21 per term against
    TF32's 2^-11."""
    if not torch.backends.cuda.matmul.allow_tf32:
        return torch.matmul(queries, rows.T)
    qb, rb = _tf32_big(queries), _tf32_big(rows)
    out = torch.matmul(qb, (rows - rb).T)    # one [Q, N] tile, in place
    out.addmm_(queries - qb, rb.T)
    return out.addmm_(qb, rb.T)


def topk_select_cuda(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                     metric: str = "ip", true_n: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large-k route on the current stream: the [Q, true_n]
    f32-accurate products of the first ``true_n`` rows
    (``f32_products``), then ``select_cuda``. Any k >= 1; inputs as for
    ``topk_cuda``. Memory: the product tile (4 * Q * true_n bytes), the
    outputs and, for rows longer than ``SELECT_CHUNK``,
    ``select_scratch_bytes`` per query."""
    true_n = _check(corpus, queries, metric, true_n)
    _check_cuda(corpus, queries)
    k = min(k, true_n)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if queries.shape[0] == 0:
        dev = queries.device
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    real = corpus[:true_n]
    scores = f32_products(queries, real)             # [Q, true_n]
    if metric == "l2":
        return select_cuda(scores, k, (queries * queries).sum(1),
                           (real * real).sum(1))
    return select_cuda(scores, k)


def streaming_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                   metric: str = "ip", true_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with FAISS order: the plain version for CPU tensors;
    for CUDA tensors ``csrc/topk.cu`` up to ``MAX_K`` and the large-k
    route above it (both raise rather than fall back)."""
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return topk_plain(corpus, queries, k, metric, true_n)
    n = _check(corpus, queries, metric, true_n)
    if min(k, n) > MAX_K:
        return topk_select_cuda(corpus, queries, k, metric, true_n)
    return topk_cuda(corpus, queries, k, metric, true_n)


def bound_ms(n_queries: int, n_rows: int, d: int, k: int,
             metric: str = "ip",
             flops_rate: float = H100_F32_ACCURATE_TC_FLOPS
             ) -> Tuple[float, str]:
    """Least time an H100 SXM could take for one call, and what bounds
    it: the 2*Q*N*d multiply-adds (plus the norms for l2) at the card's
    fastest f32-accurate rate, against each input byte read once and each
    output written once. ``flops_rate=H100_F32_FLOPS`` gives the older
    CUDA-core bound."""
    flops = 2.0 * n_queries * n_rows * d
    if metric == "l2":
        flops += 2.0 * (n_rows + n_queries) * d
    nbytes = 4.0 * (n_queries + n_rows) * d + 8.0 * n_queries * k
    t_ops, t_bytes = flops / flops_rate, nbytes / H100_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")

