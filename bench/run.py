"""Run one cell of the port's benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``).  The last line of standard output is the
result, one JSON object; the numbers that decided ``correct`` are also
the last lines of standard error.  Needs as many CUDA devices as the cell
asks for: without them it prints no result and exits with 2.  The
port's CUDA library builds on first use into ``build/cuda/`` of the
checkout; later runs there reuse it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchkit import spec
    from benchkit.cell_run import forbidden_modules, run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        log(f"unknown workload {args.workload!r}; known: {sorted(chips)}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        log(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START,
                      spec.ROOT, spec.BENCH_DIR, log=log)
    loaded = forbidden_modules()
    if loaded:
        log(f"forbidden modules loaded in this process: {loaded}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
