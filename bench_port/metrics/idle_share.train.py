"""Share of the window in which no operation ran on the device
(``torch.profiler``, CUDA activity: kernels, copies and sets)."""


def read(obs):
    dev = obs.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
