"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every roofline and
``mfu`` share of the benchmark is taken against these: the bf16 tensor
core rate is the card's highest dense rate short of fp8, so no
implementation that passes a cell's comparison can read above 100%."""

H100_BF16_FLOPS = 989e12      # FLOP/s, dense bf16 / fp16 tensor cores
H100_HBM_BYTES = 3.35e12      # bytes/s, HBM3


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES)
