"""What a run loads: never JAX, flax or the JAX package (by whole
top-level names); the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

RUN = """
import json, sys
sys.path.insert(0, "rrbench/tests")
from conftest import tiny_cell
cell = tiny_cell("rrnet-eval6", seconds=0.3)
rec = cell.driver().run(cell)
from rrbench import harness
print(json.dumps({"bad": harness.forbidden_modules(),
                  "tops": sorted({m.partition(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert {"rrnet_torch", "rrbench", "torch"} <= set(got["tops"])
    assert not {"jax", "jaxlib", "flax", "rrnet_tpu"} & set(got["tops"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            top = mod.partition(".")[0]
            assert top not in ("rrnet_torch", "rrnet_tpu", "jax", "flax"), \
                (path.name, mod)
            if top == "rrbench":
                assert mod.startswith("rrbench.reference"), (path.name, mod)


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.partition(".")[0] not in ("jax", "jaxlib", "flax",
                                                 "rrnet_tpu"), path
