"""The port's span recorder (``utils/profiling.py``): off it records
nothing, on it keeps nesting, threads and counters, its clock is
``torch.profiler``'s, and ``trace`` writes the spans as annotations."""

import glob
import gzip
import json
import os
import threading

import torch

from multimodalsimilar_tpu_torch.utils import profiling as P


def test_off_records_nothing_and_shares_one_no_op():
    assert not P.enabled()
    profiled = P.PROFILED
    before = None if profiled is None else len(profiled.spans)
    a, b = P.span("a"), P.span("b")
    assert a is b
    with a:
        P.count("c", 3)
    with P.recording() as rec:
        pass
    assert rec.spans == [] and not rec.counters
    assert P.PROFILED is profiled
    assert before is None or len(profiled.spans) == before
    assert not P.enabled()


def test_on_records_nesting_parent_thread_and_counters():
    seen = {}

    def worker():
        with P.span("worker"):
            P.count("rows", 2)
        seen["tid"] = threading.get_ident()

    with P.recording() as rec:
        assert P.enabled()
        with P.span("outer"):
            with P.span("inner"):
                P.count("rows", 5)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with P.recording() as nested:
            with P.span("late"):
                P.count("late")
    assert not P.enabled()
    main = threading.get_ident()
    got = {s[0]: s for s in rec.spans}
    assert [s[0] for s in rec.spans] == ["inner", "worker", "outer", "late"]
    assert got["inner"][1:3] == ("outer", main)
    assert got["outer"][1:3] == (None, main)
    assert got["worker"][1:3] == (None, seen["tid"]) and seen["tid"] != main
    assert got["late"][1] is None
    outer, inner = got["outer"], got["inner"]
    assert outer[3] <= inner[3] <= inner[4] <= outer[4]
    assert rec.counters == {"rows": 7, "late": 1}
    assert [s[0] for s in nested.spans] == ["late"]
    assert nested.counters == {"late": 1}
    with P.span("after"):
        pass
    assert [s[0] for s in rec.spans][-1] == "late"


def test_a_span_and_the_profiler_share_a_clock():
    """A CPU op run inside a span under ``torch.profiler`` starts and
    ends within the span's ``time.time_ns()`` bounds, to 1 ms; the span
    lands in ``PROFILED`` with no ``recording()`` open, and each session
    starts a fresh ``PROFILED`` that holds its spans and counts alone."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("clock.earlier"):
            P.count("clock.ops")
    earlier = P.PROFILED
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert P.enabled()
        with P.span("clock.check"):
            torch.mm(a, b)
        P.count("clock.ops")
    assert not P.enabled()
    assert P.PROFILED is not earlier
    assert [s[0] for s in P.PROFILED.spans] == ["clock.check"]
    assert P.PROFILED.counters == {"clock.ops": 1}
    with P.span("clock.after"):
        P.count("clock.ops")
    assert [s[0] for s in P.PROFILED.spans] == ["clock.check"]
    span = P.PROFILED.spans[-1]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert ops
    start = ops[-1].start_ns()
    end = start + ops[-1].duration_ns()
    ms = 1_000_000
    assert span[3] - ms <= start <= end <= span[4] + ms, (span, start, end)


def test_trace_writes_the_spans_as_user_annotations(tmp_path):
    with P.trace(str(tmp_path)):
        with P.span("stage.outer"):
            with P.span("stage.inner"):
                torch.ones(8).sum()
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json*"))
    assert files
    path = files[0]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"stage.outer", "stage.inner"} <= names
    assert {"stage.outer", "stage.inner"} <= {
        s[0] for s in P.PROFILED.spans}
