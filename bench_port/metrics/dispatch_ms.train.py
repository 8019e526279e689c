"""The median time the host spent in one ``Trainer.train_step`` (the
program's ``train.step`` spans: enqueuing the forward, the backward and
the optimizer step, and any wait the device imposes on the way)."""

import statistics

from benchlib import program


def read(obs):
    s = program.summary()
    if not s or not s["durations"].get("train.step"):
        return None
    return 1e3 * statistics.median(s["durations"]["train.step"])
