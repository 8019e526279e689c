"""Forward operations of the image model at the recipe's size (the
EfficientNet's convolutions from its block table, the fc and the ArcFace
product, ``benchlib/flops.py``) times 3 for the backward, for every
example the Trainer consumed in the window, over the window's wall time,
as a share of the card's bf16 peak."""

from benchlib.peaks import H100_BF16_FLOPS


def read(obs):
    if not obs.get("model_flops"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / H100_BF16_FLOPS
