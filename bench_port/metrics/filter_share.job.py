"""Share of the jobs' time (the program's ``similar.job`` spans) spent
filtering the neighbour lists and writing them to the sink (its
``similar.filter`` and ``similar.write`` spans:
``retrieval/engine.py:similar_map``, ``pipelines/similar.py``)."""

from benchlib import program


def read(obs):
    s = program.summary()
    if not s or not s["main_s"].get("similar.job"):
        return None
    main = s["main_s"]
    return 100.0 * (main.get("similar.filter", 0.0)
                    + main.get("similar.write", 0.0)) / main["similar.job"]
