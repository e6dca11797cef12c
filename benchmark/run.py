"""The benchmark of tbus_torch, the PyTorch and CUDA port of tbus's device
plane, on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json from the checkout's root and prints, as
its last line of output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the numbers `correct`
was decided by, each beside its limit (also the last lines of standard
error). It exits with another code than 0, and prints no result, without
as many CUDA cards as the cell asks for, or when it finds JAX or the JAX
package loaded once the window has closed.
"""

import os
import time


def _process_start() -> float:
    """This process's start on the monotonic clock (10 ms resolution)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
            "SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]


def _say(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", plant=None) -> int:
    """A run on `device`: "cuda" looks for the cards first; "cpu" skips
    that look and runs the device runtime's CPU backend (the tests'
    rehearsal). `plant` is put into the configuration's deployment (the
    faults and the control)."""
    args = parse(argv)
    from harness.spec import Cell, benchmark

    cell = Cell(benchmark(), args.workload)
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            _say("no CUDA device: this benchmark runs only on NVIDIA cards")
            return 2
        if torch.cuda.device_count() < cell.chips:
            _say(f"{args.workload} needs {cell.chips} cards, found "
                 f"{torch.cuda.device_count()}")
            return 2
    from harness.cell import run_cell, say_checks

    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                    device=device, plant=plant)
    forbidden = line["detail"]["forbidden"]
    if forbidden:
        _say(f"JAX or the JAX package was loaded: {', '.join(forbidden)}")
        return 3
    if line["detail"]["leaked"]:
        _say(f"shared-memory segments left by an ended process: "
             f"{line['detail']['leaked']}")
    say_checks(line, _say)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
