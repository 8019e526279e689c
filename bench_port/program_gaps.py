#!/usr/bin/env python3
"""A traced run of one cell whose idle gaps are named by the program's
own spans.

    python3 bench_port/program_gaps.py --workload <name> --seed <n> \
        --seconds <s>

Runs ``run.py`` with ``--trace 1`` and one difference: before the device
trace is reduced, the program's main-thread spans
(``benchlib/program.py``) are appended to the harness's ``Spans.wall``,
so each of the ten longest idle gaps in ``breakdown`` is named by the
innermost program or harness span the host had open when it began. The
metrics read as in ``run.py`` (they read ``Spans.times`` and the
program's record, which the appended spans leave alone). After
``run.py``'s result line it prints one line more: ``{"program": ...}``,
each span name's count, seconds and median, the counters
(``program.brief``), and under ``gaps`` each of the ten gaps' seconds,
name and split among the spans the host had open across it
(``program.gap_stages``). A gap's start is the time at which
``DeviceTrace.summary`` looked up its name; the run stops with an error
if those lookups do not match the reported gaps one for one. The file
stands in for two lines of the drivers (``program.append_main_spans``
before ``DeviceTrace.summary``), and goes once they have them.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    import run
    from benchlib import program
    from benchlib import trace as T
    reduce, open_span = T.DeviceTrace.summary, T._open_span
    seen = {}

    def named(spans, t):
        seen["wall"] = spans
        seen["starts"].append(t)
        return open_span(spans, t)

    def summary(self, spans):
        program.append_main_spans(spans)
        # DeviceTrace.summary names each gap it reports by one lookup, in
        # the order it reports them: keep each lookup's time as its start
        seen["starts"] = []
        T._open_span = named
        try:
            out = reduce(self, spans)
        finally:
            T._open_span = open_span
        gaps, starts = out["idle_gaps"], seen["starts"]
        if len(starts) != len(gaps) or any(
                open_span(seen["wall"], t) != name
                for (name, _), t in zip(gaps, starts)):
            raise RuntimeError(
                f"DeviceTrace.summary's {len(starts)} span lookups do not "
                f"match its {len(gaps)} idle gaps one for one, in order: "
                f"the gaps' start times are unknown")
        seen["gaps"] = [
            [s, name, program.gap_stages(t, t + int(s * 1e9), seen["wall"])]
            for (name, s), t in zip(gaps, starts)]
        return out

    T.DeviceTrace.summary = summary
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        T.DeviceTrace.summary = reduce
    s = program.summary()
    if s is not None:
        print(json.dumps({"program": dict(program.brief(s),
                                          gaps=seen.get("gaps", []))}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
