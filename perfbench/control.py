"""The readings the check's limits are set from, on the card: for each seed,
one run of the cell's set-up and window (`--seconds`, at the cell's own
load and sizes), then its check's numbers for the program and for the
control, the plain reference computed with float8 e4m3 linear layers put in
the program's place, on the same sample. One JSON line a seed, then one line
with each number's largest program reading and smallest control reading.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 8

The benchmark's own runs never run it.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--pool", type=int, default=0, help="documents made in set-up (0: the traffic file's)")
    args = ap.parse_args(argv)
    sp = harness.spec(args.workload)
    if args.pool:
        sp.traffic["pool_docs"] = args.pool
    program, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run(sp, seed, args.seconds, False, control=True)
        line = {"seed": seed, "correct": r["correct"], "checks": {k: v["value"] for k, v in r["checks"].items()},
                "control": r.get("control"), "docs_per_s": r["metrics"].get("docs_per_s", {}).get("value"),
                "seconds": time.perf_counter() - t}
        print(json.dumps(harness.finite(line)), flush=True)
        for k, v in line["checks"].items():
            program[k] = max(program.get(k, 0.0), v)
        for k, v in (r.get("control") or {}).items():
            low[k] = min(low.get(k, float("inf")), v)
    print(json.dumps(harness.finite({"program_max": program, "control_min": low})), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
