import json

import pytest

from perfbench.harness import BENCH, ROOT, spec
from perfbench.manifest import faults


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_no_fault():
    assert faults(manifest(), ROOT) == []


@pytest.mark.parametrize("break_it, found", [
    (lambda m: m["workloads"][0].update(chips=4), "takes 4 chips"),
    (lambda m: m["per_layer"][0].update(unit="ms a batch"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="ttft_ms"), "no end-to-end metric"),
    (lambda m: m["workloads"].__setitem__(1, dict(m["workloads"][1], config="rag-vt5-base", traffic="x")),
     "keeps no cell"),
    (lambda m: m["workloads"][0].update(name="a b"), "name"),
])
def test_faults_are_found(break_it, found):
    m = manifest()
    break_it(m)
    assert any(found in f for f in faults(m, ROOT))


def test_every_cell_finds_its_files():
    for w in manifest()["workloads"]:
        sp = spec(w["name"])
        assert sp.cfg["family"] and sp.traffic["batch_size"] >= 1
        assert (BENCH / "families" / f"{sp.cfg['family']}.py").exists()
        assert set(sp.cfg["limits"]) >= {"logit_gap"}
