"""Share of the tower's enqueue (the program's ``embed.launch`` spans,
``pipelines/embedders.py``) that the host spends in the mixture of
experts' own spans (``moe.route``, ``moe.experts``, ``moe.combine``,
``models/deepseek_v2.py``): whether the MoE's enqueue paces the tower."""

from benchlib import program

MOE = ("moe.route", "moe.experts", "moe.combine")


def read(obs):
    s = program.summary()
    if not s or not s["main_s"].get("embed.launch") \
            or not any(m in s["main_s"] for m in MOE):
        return None
    main = s["main_s"]
    return 100.0 * sum(main.get(m, 0.0) for m in MOE) / main["embed.launch"]
