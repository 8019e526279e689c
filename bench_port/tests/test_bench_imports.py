"""Nothing the benchmark runs loads JAX, Flax, optax or the JAX package,
compared by whole top-level module names; the reference loads nothing
of the program."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodalsimilar_tpu"}

CHILD = r"""
import glob, importlib.util, json, os, sys
bench, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [bench, os.path.join(bench, "tests"), root]
import run
from benchlib import registry
for path in sorted(glob.glob(os.path.join(bench, "metrics", "*.py"))
                   + glob.glob(os.path.join(bench, "drivers", "*.py"))):
    spec = importlib.util.spec_from_file_location(
        "m_" + os.path.basename(path).replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for path in glob.glob(os.path.join(bench, "configs", "*.json")) + \
        glob.glob(os.path.join(bench, "traffic", "*.json")):
    json.load(open(path))
import tiny
registry.driver("similar_job").run(tiny.job_cell(), tiny.Opts())
registry.driver("train_cv").run(tiny.train_cell(), tiny.Opts(seconds=0.2))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_runs_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHILD, BENCH, ROOT],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "multimodalsimilar_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN | {
                    "multimodalsimilar_tpu_torch"}, (name, mod)
    child = ("import sys; sys.path[:0] = [sys.argv[1]]; "
             "import reference.bert, reference.efficientnet, "
             "reference.search; print(sorted({m.split('.')[0] for m in "
             "sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", child, BENCH],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "multimodalsimilar_tpu_torch" not in proc.stdout
