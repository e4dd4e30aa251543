"""The readings that set a cell's correctness limit, on the chip.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control 1]

Runs the cell once a seed in one process, as ``run.py`` does (the timed
path at the cell's sizes), and prints for each seed the number compared
(``served_gap``: the widest gap of a served token under the fp32
reference).  With ``--control 1`` the control stands in the program's
place: ``served_gap`` is then the control's (the same gap of the token
that the reference computed with fp8 products puts first at each of
those positions), ``correct`` is decided on it and has to come out
false, and ``control.program_gap`` keeps the program's own reading.
``limits/<cell>.json`` records the readings a limit was set from.
Benchmark runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()

    import torch

    from benchkit.cell_run import run_cell
    from repro_torch.train.serve_step import _jitted_steps_cached

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False,
                     torch.device("cuda", 0), t, control=bool(args.control),
                     log=lambda m: print(m, file=sys.stderr, flush=True))
        # each seed builds its own steps; keep one seed's graphs at a time
        _jitted_steps_cached.cache_clear()
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "control": r.get("control"),
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
