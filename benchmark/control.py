"""The control of a cell's `correct`, on the card: each run is the cell as
the benchmark runs it, with the configuration's "control" put into its
deployment (one of the guarantees it states broken), so every run must
come out not correct. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

prints one JSON line a seed (correct, attempted, failed and the checks)
and exits with 1 if any run came out correct.
"""

import argparse
import json
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness.spec import Cell, benchmark  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    plant = Cell(benchmark(), args.workload).config["control"]
    sound = 0
    for seed in args.seeds:
        code = (f"import sys; sys.path.insert(0, {BENCH_DIR!r}); import run; "
                f"sys.exit(run.main(['--workload', {args.workload!r}, "
                f"'--seed', '{seed}', '--seconds', '{args.seconds}', "
                f"'--trace', '0'], plant={plant!r}))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(json.dumps({"seed": seed, "exit": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            continue  # a control that gives no number has failed
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        sound += bool(line["correct"])
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "checks": line["checks"]}), flush=True)
    return 1 if sound else 0


if __name__ == "__main__":
    sys.exit(main())
