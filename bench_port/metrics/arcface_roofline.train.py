"""The ArcFace head's kernel against its roofline: the least time one
launch could take (2 B C D operations at the bf16 peak, or x, W, the
labels and the logits once at the HBM bandwidth, whichever is larger),
times the launches, over the device time of ``arcface_kernel``
(``csrc/arcface.cu``) in the trace."""


def read(obs):
    dev = obs.get("device")
    if not dev or not obs.get("arcface_launches"):
        return None
    spent = sum(s for name, s in dev["kernels"].items()
                if "arcface_kernel" in name)
    if spent <= 0:
        return None
    return 100.0 * obs["arcface_bound_s"] * obs["arcface_launches"] / spent
