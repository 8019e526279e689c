"""The program's own spans and counters in a traced run.

The port's recorder (``multimodalsimilar_tpu_torch/utils/profiling.py``)
opens a fresh ``PROFILED`` record each time a ``torch.profiler`` session
starts and closes it when the session stops: in a ``--trace 1`` run it
holds ``DeviceTrace``'s session, which opens just before the window's
first step or job and closes after its last. The per-layer readers that rest on it call ``summary``; a program
without the recorder gives None, and their metrics are left out of its
line. ``append_main_spans`` adds the main thread's spans to a harness's
``Spans.wall`` (never to ``Spans.times``, which the harness's metrics
read), so that ``DeviceTrace.summary`` names each idle gap by the
innermost program or harness span the host had open when it began, and
``gap_stages`` splits a gap among the spans the host had open across it
(``program_gaps.py``).
"""

from __future__ import annotations

import statistics
import threading
from collections import defaultdict
from typing import Optional


def record():
    """The program's ``PROFILED`` record, or None when it keeps none."""
    try:
        from multimodalsimilar_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "PROFILED", None)


def summary(rec=None) -> Optional[dict]:
    """Seconds by span name on the main thread (``main_s``) and on every
    thread (``all_s``), the main thread's durations by name in seconds
    (``durations``) and the counters; None without a record."""
    rec = record() if rec is None else rec
    if rec is None:
        return None
    main = threading.main_thread().ident
    main_s, all_s = defaultdict(float), defaultdict(float)
    durations = defaultdict(list)
    for name, _, thread, start, end in list(rec.spans):
        d = (end - start) * 1e-9
        all_s[name] += d
        if thread == main:
            main_s[name] += d
            durations[name].append(d)
    return {"main_s": dict(main_s), "all_s": dict(all_s),
            "durations": dict(durations), "counters": dict(rec.counters)}


def brief(s: dict) -> dict:
    """``summary`` without the durations: each span name's count, seconds
    and median milliseconds on the main thread, seconds on every thread,
    and the counters."""
    spans = {name: {"count": len(d), "main_s": s["main_s"].get(name, 0.0),
                    "median_ms": 1e3 * statistics.median(d)}
             for name, d in s["durations"].items()}
    for name, total in s["all_s"].items():
        spans.setdefault(name, {"count": 0})["all_s"] = total
    return {"spans": spans, "counters": s["counters"]}


def append_main_spans(spans, rec=None) -> int:
    """Append the program's main-thread spans to ``spans.wall`` as
    ``(start ns, end ns, name, thread)``; returns how many."""
    rec = record() if rec is None else rec
    if rec is None:
        return 0
    main = threading.main_thread().ident
    added = [(start, end, name, thread)
             for name, _, thread, start, end in list(rec.spans)
             if thread == main]
    spans.wall.extend(added)
    return len(added)


def gap_stages(start: int, end: int, wall, samples: int = 200) -> dict:
    """Seconds of the gap [start, end) ns that each span of ``wall``
    (``(start ns, end ns, name, thread)``, one thread's) was the
    innermost open one, at ``samples`` evenly spaced points; time with no
    span open counts under ``NO_SPAN``."""
    from benchlib.trace import _open_span
    inside = sorted((s for s in wall if s[0] <= end and s[1] >= start),
                    key=lambda s: s[0])
    step = (end - start) / samples
    out: dict = defaultdict(float)
    for i in range(samples):
        t = int(start + (i + 0.5) * step)
        out[_open_span(inside, t)] += step * 1e-9
    return dict(out)
