"""Run one cell once a seed, each run a process of its own, and print the
spread of every metric and the largest reading of every compared number:

    python3 -m benchmark.sets --workload <cell> --seconds 10 --seeds 11 12 13 [--trace 1] [--out runs.jsonl]

A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median; it is
given over all runs and with the run farthest from the median left out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def without_farthest(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result, "stderr_tail": proc.stderr[-3000:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    runs = []
    for seed in args.seeds:
        r = run_one(args.workload, seed, args.seconds, args.trace)
        runs.append(r)
        res = r["result"] or {}
        metrics = {k: v["value"] for k, v in res.get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in res.get("checks", {}).items()}
        print(json.dumps({"seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 2), "correct": res.get("correct"),
                          "attempted": res.get("attempted"), "metrics": metrics, "checks": checks}), flush=True)
        if r["rc"] or not r["result"]:
            print(r["stderr_tail"], file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seconds": args.seconds, "trace": args.trace, **r}) + "\n")
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for res in ok for k in res["metrics"]})
    for name in names:
        vals = [res["metrics"][name]["value"] for res in ok if name in res["metrics"]]
        s_all = spread(vals)
        s_cut = spread(without_farthest(vals)) if len(vals) > 2 else None
        print(f"{name}: median {statistics.median(vals)!r} spread {s_all!r} spread_without_farthest {s_cut!r} "
              f"values {vals}", flush=True)
    for name in sorted({k for res in ok for k in res.get("checks", {})}):
        vals = [res["checks"][name]["value"] for res in ok if name in res.get("checks", {})]
        print(f"check {name}: max {max(vals)!r} values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
