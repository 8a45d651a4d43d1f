"""Nothing a run loads is JAX, Flax or the JAX package; the reference loads
nothing of the program; nothing here reads the JAX-era benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PROBE = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench import harness, control, manifest, trace
from perfbench.tests.tiny import tiny
for cell in ("vt5-concat-mpdocvqa", "hivt5-mpdocvqa"):
    sp = tiny(cell, max_new_tokens=3)
    for kind in ("end_to_end", "per_layer"):
        for m in sp.metrics[kind]:
            harness.reader(m["name"])
    harness.run(sp, 1, 0.05, False, device="cpu", log=lambda *a: None)
from perfbench.tests import qwen_probe
from perfbench.tests.test_perfbench_family import probe
qwen_probe.register()
harness.run(probe(), 1, 0.05, False, device="cpu", log=lambda *a: None)
print(" ".join(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1:] in ([], [""]), out.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"rag_docvqa_tpu_torch", "rag_docvqa_tpu", "jax", "jaxlib", "flax"}, path


def test_no_file_reads_the_jax_benchmark():
    names = ["bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_"]
    for path in BENCH.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        src = path.read_text()
        assert not any(n in src for n in names), path
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "bench" not in tops and not tops & {"jax", "jaxlib", "flax", "rag_docvqa_tpu"}, path
