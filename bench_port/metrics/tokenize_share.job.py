"""Share of the jobs' time (the program's ``similar.job`` spans) spent
tokenising and padding the text micro-batches on the host (its
``embed.tokenize`` spans, ``pipelines/embedders.py``)."""

from benchlib import program


def read(obs):
    s = program.summary()
    if not s or not s["main_s"].get("similar.job"):
        return None
    return 100.0 * s["main_s"].get("embed.tokenize", 0.0) \
        / s["main_s"]["similar.job"]
