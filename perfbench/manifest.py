"""The manifest check: what `BENCHMARK.json` must hold for this harness to
run every cell it names.

    python3 perfbench/manifest.py    # prints each fault, exits 1 on any
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def faults(manifest: Dict, root: Path) -> List[str]:
    out: List[str] = []
    bench = root / "perfbench"
    configs = {c["name"]: c for c in manifest["configs"]}
    cells = manifest["workloads"]
    e2e = manifest["end_to_end"]
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in cells] \
        + [m["name"] for m in e2e + manifest["per_layer"]]
    for n in names + [w["traffic"] for w in cells] + [w["config"] for w in cells]:
        if not NAME.match(n):
            out.append(f"name {n!r} has a character outside [A-Za-z0-9_.-] or is too long")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in manifest[kind]]
        if len(seen) != len(set(seen)):
            out.append(f"{kind}: a name appears twice")
    for m in e2e + manifest["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r}")
        if m["source"] not in SOURCES or m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: source or better")
        if not (bench / "metrics" / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    if "setup_s" not in [m["name"] for m in e2e]:
        out.append("no setup_s")
    for c in manifest["configs"]:
        if not any(w["config"] == c["name"] for w in cells):
            out.append(f"configuration {c['name']} keeps no cell")
        if not (root / c["file"]).exists():
            out.append(f"configuration {c['name']}: no file {c['file']}")
    for w in cells:
        if w["chips"] != 1:
            out.append(f"cell {w['name']} takes {w['chips']} chips")
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: no configuration {w['config']}")
        if not (bench / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"cell {w['name']}: no traffic file traffic/{w['traffic']}.json")
    reports = lambda m, w: "workloads" not in m or w in m["workloads"]
    for m in manifest["per_layer"]:
        moved = next((e for e in e2e if e["name"] == m["moves"]), None)
        if moved is None:
            out.append(f"{m['name']} moves {m['moves']}, which is no end-to-end metric")
            continue
        for w in cells:
            if reports(m, w["name"]) and not reports(moved, w["name"]):
                out.append(f"{m['name']} is read in {w['name']}, which does not report {m['moves']}")
    for w in cells:
        if not any(reports(m, w["name"]) for m in e2e if m["name"] != "setup_s"):
            out.append(f"cell {w['name']} reports no end-to-end metric besides setup_s")
        if not any(reports(m, w["name"]) for m in manifest["per_layer"]):
            out.append(f"cell {w['name']} reports no per-layer metric")
    return out


if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    found = faults(json.loads((root / "BENCHMARK.json").read_text()), root)
    print("\n".join(found) or "BENCHMARK.json: no fault found")
    sys.exit(1 if found else 0)
