"""The readers of the program's own spans and counters
(``benchlib/program.py``), on a made-up record: each of the five reads
what it should, all leave their metric out for a program without the
recorder, and appending the program's spans to ``Spans.wall`` names an
idle gap by them and leaves ``embed_share.job`` as it was."""

import os
import threading

import pytest

from benchlib import program, registry
from benchlib.trace import Spans, _open_span

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000


class FakeRecord:
    def __init__(self, spans, counters):
        self.spans, self.counters = spans, counters


def _reader(name):
    return registry._module(os.path.join(BENCH, "metrics", f"{name}.py"),
                            "test_metric_" + name.replace(".", "_")).read


def _record():
    main = threading.main_thread().ident
    other = main + 1
    s = [("similar.job", None, main, 0, 1000 * MS),
         ("similar.embed", "similar.job", main, 0, 800 * MS),
         ("embed.tokenize", "similar.embed", main, 0, 30 * MS),
         ("embed.tokenize", "similar.embed", main, 100 * MS, 120 * MS),
         ("similar.filter", "similar.job", main, 850 * MS, 900 * MS),
         ("similar.write", "similar.job", main, 900 * MS, 950 * MS),
         ("train.step", None, main, 0, 300 * MS),
         ("train.step", None, main, 400 * MS, 500 * MS),
         ("train.step", None, main, 600 * MS, 800 * MS),
         ("prefetch.wait", None, main, 300 * MS, 350 * MS),
         ("prefetch.wait", None, other, 0, 900 * MS)]
    return FakeRecord(s, {"embed.tokens_real": 26,
                          "embed.tokens_computed": 128})


def test_readers_read_the_program_record(monkeypatch):
    monkeypatch.setattr(program, "record", _record)
    obs = {"window_s": 2.0}
    assert _reader("tokenize_share.job")(obs) == pytest.approx(5.0)
    assert _reader("token_fill.job")(obs) == pytest.approx(100 * 26 / 128)
    assert _reader("filter_share.job")(obs) == pytest.approx(10.0)
    # the main thread's 50 ms of waiting, not the other thread's
    assert _reader("data_wait_share.train")(obs) == pytest.approx(2.5)
    assert _reader("dispatch_ms.train")(obs) == pytest.approx(200.0)


@pytest.mark.parametrize("rec", [None, FakeRecord([], {})],
                         ids=["no recorder", "empty"])
def test_readers_leave_the_metric_out_without_a_record(monkeypatch, rec):
    monkeypatch.setattr(program, "record", lambda: rec)
    for name in ("tokenize_share.job", "token_fill.job", "filter_share.job",
                 "data_wait_share.train", "dispatch_ms.train"):
        assert _reader(name)({"window_s": 2.0}) is None, name


def test_program_spans_name_gaps_and_leave_embed_share(monkeypatch):
    monkeypatch.setattr(program, "record", _record)
    spans = Spans(True)
    main = threading.main_thread().ident
    spans.times["job"].append((0.0, 1.0))
    spans.times["embed"].append((0.0, 0.8))
    spans.wall += [(0, 1000 * MS, "job", main), (0, 800 * MS, "embed", main)]
    embed_share = _reader("embed_share.job")

    def obs():
        return {"embed_s": spans.total("embed"), "job_s": spans.total("job")}

    before = embed_share(obs())
    assert program.append_main_spans(spans) == 10
    assert embed_share(obs()) == before == pytest.approx(80.0)
    assert dict(spans.times) == {"job": [(0.0, 1.0)], "embed": [(0.0, 0.8)]}
    wall = sorted(spans.wall, key=lambda s: s[0])
    assert _open_span(wall, 860 * MS) == "similar.filter"
    assert _open_span(wall, 820 * MS) == "similar.job"
    assert _open_span(wall, 110 * MS) == "embed.tokenize"
    assert _open_span(wall, 325 * MS) == "prefetch.wait"


def test_a_gap_splits_among_the_spans_open_across_it():
    main = threading.main_thread().ident
    wall = [(0, 1000 * MS, "similar.job", main),
            (100 * MS, 400 * MS, "similar.search", main),
            (400 * MS, 700 * MS, "similar.filter", main),
            (700 * MS, 800 * MS, "similar.write", main)]
    got = program.gap_stages(300 * MS, 900 * MS, wall)
    want = {"similar.search": 0.1, "similar.filter": 0.3,
            "similar.write": 0.1, "similar.job": 0.1}
    assert set(got) == set(want)
    for name, seconds in want.items():
        assert got[name] == pytest.approx(seconds, abs=0.004), name
    assert program.gap_stages(1100 * MS, 1200 * MS, wall) == {
        "no_benchmark_span_open": pytest.approx(0.1)}
