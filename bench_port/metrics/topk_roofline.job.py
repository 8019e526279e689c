"""The jobs' searches against their roofline: the least time each
search could take (2 Q N D operations at the bf16 peak, or the f32
queries, corpus and results once at the HBM bandwidth, whichever is
larger) over the device time of the top-k kernels (``topk_kernel`` and
``topk_merge_kernel`` of ``csrc/topk.cu``) in the trace."""

KERNELS = ("topk_kernel", "topk_merge_kernel")


def read(obs):
    dev = obs.get("device")
    if not dev or not obs.get("topk_bound_s"):
        return None
    spent = sum(s for name, s in dev["kernels"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * obs["topk_bound_s"] / spent
