"""The model operations the jobs' inputs need (each title's real tokens
through the encoder and pooler, and each job's search product, counted
from the published shapes by ``benchlib/flops.py``) over the window's
wall time, as a share of the card's bf16 peak."""

from benchlib.peaks import H100_BF16_FLOPS


def read(obs):
    if not obs.get("model_flops"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / H100_BF16_FLOPS
