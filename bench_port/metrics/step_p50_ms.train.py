"""The median step of the window on the host clock: the time between
the starts of consecutive Trainer steps (the Trainer reads each step's
loss one step later, so the host runs at most one step ahead), the last
one ending in the window's closing synchronise."""


def read(obs):
    if not obs.get("step_p50_s"):
        return None
    return 1e3 * obs["step_p50_s"]
