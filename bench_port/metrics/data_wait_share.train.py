"""Share of the window the Trainer's loop waited for its next batch (the
program's ``prefetch.wait`` spans on the main thread,
``data/prefetch.py``)."""

from benchlib import program


def read(obs):
    s = program.summary()
    if not s or "train.step" not in s["durations"] \
            or not obs.get("window_s"):
        return None
    return 100.0 * s["main_s"].get("prefetch.wait", 0.0) / obs["window_s"]
