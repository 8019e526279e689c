"""Everything a cell needs, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file (``traffic/<name>.json``), the
driver the traffic names (``drivers/<driver>.py``) and a reader for each
of its per-layer metrics (``metrics/<metric>.py``). A later cell, mix or
metric is a new file and a new entry; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict                 # the configuration file's contents
    traffic_name: str
    traffic: dict                # the traffic file's contents
    end_to_end: List[dict]       # the metrics this cell reports
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``{root}/BENCHMARK.json``; its files are read
    from ``bench_dir`` (and the configuration from the path the entry
    gives, relative to ``root``)."""
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _covers(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _covers(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"],
                traffic=load_traffic(w["traffic"], bench_dir),
                end_to_end=e2e, per_layer=per_layer)


def load_traffic(name: str, bench_dir: str = HERE) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = HERE):
    """The module ``drivers/<name>.py``, which defines ``run(cell, opts)``."""
    return _module(os.path.join(bench_dir, "drivers", f"{name}.py"),
                   f"bench_driver_{name}")


def read_metrics(cell: Cell, obs: dict, bench_dir: str = HERE
                 ) -> Dict[str, dict]:
    """``{metric: {"value", "unit"}}`` of every per-layer metric whose
    reader (``metrics/<name>.py``, a ``read(obs)`` function) finds
    something to read; a reader that returns None is left out."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(bench_dir, "metrics", f"{m['name']}.py")
        value: Optional[float] = _module(
            path, "bench_metric_" + m["name"].replace(".", "_")).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
