"""Measure a cell's spread: sets of runs, each run its own process.

    python3 -m wam_bench.sets --workload <cell> --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 10 [--trace 0] [--out chiprun_out/sets.jsonl]

Runs the seeds once per set (the same seeds in every set), after one
untimed run that builds the kernels, and prints for each metric each
set's median and spread (the distance between the first and third
quartile, ``statistics.quantiles(values, n=4)``, as a share of the
median), the widest spread, and whether every run was correct.  With
``--out`` every result line is appended there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from wam_bench.stats import spread


def one_run(workload: str, seed: int, seconds: float, trace: int):
    cmd = [sys.executable, "-m", "wam_bench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        print(f"seed {seed}: exit {out.returncode}\n{out.stderr[-2000:]}",
              file=sys.stderr)
        return None
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    one_run(args.workload, seeds[0] + 7919, args.seconds, args.trace)
    sets, ok = [], True
    for n in range(args.sets):
        results = []
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            ok = ok and r is not None and r["correct"]
            if r is not None:
                results.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps({"set": n, "seed": seed,
                                            "result": r}) + "\n")
                print(f"set {n} seed {seed}: correct {r['correct']} "
                      + " ".join(f"{k}={v['value']}" for k, v in
                                 r["metrics"].items())
                      + " checks " + json.dumps(r["checks"]), flush=True)
        sets.append(results)
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    for name in names:
        cols = []
        for s in sets:
            v = [r["metrics"][name]["value"] for r in s
                 if name in r["metrics"]]
            if len(v) >= 2:
                cols.append((statistics.median(v), spread(v)))
        if cols:
            print(f"{name}: " + "; ".join(
                f"set {i} median {m} spread {sp:.5f}"
                for i, (m, sp) in enumerate(cols))
                + f"; widest spread {max(sp for _, sp in cols):.5f}")
    print(f"all correct: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
