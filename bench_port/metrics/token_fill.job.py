"""The titles' real tokens (the program's ``embed.tokens_real``
counter: the attention mask of each micro-batch's rows) over the token
positions the tower computed (``embed.tokens_computed``: padded rows x
padded length), counted in ``pipelines/embedders.py`` before upload."""

from benchlib import program


def read(obs):
    s = program.summary()
    if not s or not s["counters"].get("embed.tokens_computed"):
        return None
    c = s["counters"]
    return 100.0 * c.get("embed.tokens_real", 0) / c["embed.tokens_computed"]
