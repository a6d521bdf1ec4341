"""The check's control, which the benchmark's own runs never run: a
cell's traffic for a short window at the cell's own size, then the
check with the reference computed in bfloat16 (the precision below the
configuration's float32) in the program's place.  Each seed prints the
numbers the check compares; every one should come out not correct.

    python portbench/control.py --workload CELL --seconds S --seeds A,B,C
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    for seed in args.seeds.split(","):
        res = harness.run(args.workload, int(seed), args.seconds, False,
                          control=True)
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
