"""The routed experts' grouped products against their roofline: the
least time they could take over the window (``benchlib/moe_flops.py``:
2 x 3 H I operations a routed row, at the bf16 peak, or every launch
pair's 64 experts' bfloat16 weights and its rows in and out, at the HBM
bandwidth, whichever is larger; the rows and launch pairs are the
program's ``moe.rows_routed`` and ``moe.launches`` counters) over the
device time of their kernels in the trace: ``torch._grouped_mm``'s
CUTLASS grouped GEMM (a ``cutlass::device_kernel`` whose name holds
``GroupProblemShape``) and the ``prepare_grouped_gemm_data`` kernel that
sets each launch's problems up, as named on an H100 under torch
2.11.0+cu128."""

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(obs):
    dev = obs.get("device")
    if not dev or not obs.get("expert_bound_s"):
        return None
    spent = sum(s for name, s in dev["kernels"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * obs["expert_bound_s"] / spent
