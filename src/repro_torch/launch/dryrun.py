"""Dry run of the production cells — the port of :mod:`repro.launch.dryrun`:
trace every (arch x shape) cell's step on the production mesh, allocating
nothing (``meta`` tensors), and record what one chip holds and does.

The reference lowers and compiles each cell under a 512-device XLA flag.
The port needs no flag and no subprocess: the production mesh is a
:class:`~repro_torch.launch.mesh.MeshSpec` description, and
:func:`repro_torch.launch.build.lower_step` traces rank 0's sharded
program on a traced mesh (its collectives recorded, no data moved).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all               # 33-cell sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod   # 2x16x16

Per cell this records to ``artifacts/dryrun_torch/``:
    memory_analysis (bytes per chip: the arguments' blocks, the traced
    peak of temporaries, the outputs, the donated arguments),
    op_cost_analysis (the traced program's FLOPs and bytes, where the
    reference keeps XLA's cost analysis),
    hlo_analysis (per-chip FLOPs / bytes / collective bytes, the key the
    reference's roofline reads),
    matmul_flops, kernel_scopes, the collective schedule head.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs.registry import arch_shapes, list_archs, make_run
from repro_torch.launch.build import lower_step
from repro_torch.launch.hlo_analysis import collective_schedule
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils.config import MeshConfig, ParallelConfig, RunConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def parallel_overrides(par: ParallelConfig, kv: Optional[str]
                       ) -> ParallelConfig:
    """``par`` with the ``key=value,...`` overrides of ``kv``."""
    if not kv:
        return par
    out = {}
    for item in kv.split(","):
        k, v = item.split("=", 1)
        cur = getattr(par, k)
        if isinstance(cur, bool):
            out[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            out[k] = int(v)
        else:
            out[k] = v
    return par.replace(**out)


def cell_run(arch: str, shape: str, *, multi_pod: bool = False,
             par_kv: Optional[str] = None, mesh_kv: Optional[str] = None
             ) -> RunConfig:
    """The validated run of one cell: the arch's default plan with the
    ``par_kv`` overrides, on the production mesh or the ``mesh_kv``
    re-mesh of the same chips (``"64x4"``: data x model)."""
    run = make_run(arch, shape, multi_pod=multi_pod)
    run = run.replace(parallel=parallel_overrides(run.parallel, par_kv))
    if mesh_kv:
        dims = tuple(int(x) for x in mesh_kv.split("x"))
        axes = (("pod", "data", "model") if len(dims) == 3
                else ("data", "model"))
        run = run.replace(mesh=MeshConfig(shape=dims, axes=axes))
    run.validate()
    return run


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False,
                par_kv: Optional[str] = None, save: bool = True,
                tag: str = "", mesh_kv: Optional[str] = None,
                peak_tensors: int = 0) -> Dict:
    """Trace one cell (:func:`cell_run`) and return its record, written as
    JSON under :data:`ARTIFACT_DIR` when ``save``; with ``peak_tensors``
    the record's ``peak_tensors`` lists that many of the largest groups of
    storages live at the peak, by the op, dtype, shape and pass that made
    them (bytes, count, what), printed too."""
    t0 = time.perf_counter()  # repro: ignore[wall-clock] -- the record's trace time
    run = cell_run(arch, shape, multi_pod=multi_pod, par_kv=par_kv,
                   mesh_kv=mesh_kv)
    mesh = MeshSpec.of(run.mesh.shape, run.mesh.axes)
    chips = run.mesh.num_devices

    bundle, traced = lower_step(run, mesh, peak_tensors=peak_tensors)
    t_lower = time.perf_counter() - t0  # repro: ignore[wall-clock] -- the record's trace time

    mem = traced.memory_analysis()
    costs = traced.cost_analysis()
    sched = collective_schedule(traced.counter, limit=24)

    rec = {
        "arch": arch,
        "shape": shape,
        "kind": bundle.kind,
        "mesh": {"shape": list(run.mesh.shape), "axes": list(run.mesh.axes)},
        "chips": chips,
        "parallel": run.parallel.to_dict(),
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,  # nothing is compiled
        "memory_analysis": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "peak_bytes": mem.peak_memory_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
        },
        "op_cost_analysis": {
            "flops": costs.flops,
            "bytes_accessed": costs.bytes_accessed,
        },
        "hlo_analysis": {
            "flops_per_chip": costs.flops,
            "bytes_per_chip": costs.bytes_accessed,
            "collective_bytes_per_chip": costs.collective_bytes,
            "collective_count": costs.collective_count,
            "total_collective_bytes_per_chip": costs.total_collective_bytes,
        },
        "matmul_flops": costs.matmul_flops,
        "kernel_scopes": costs.kernel_scopes,
        "collective_schedule_head": sched,
    }
    print(f"[dryrun] {arch} x {shape} ({'x'.join(map(str, run.mesh.shape))}"
          f"{' ' + tag if tag else ''}): OK  "
          f"flops/chip={costs.flops:.3e}  bytes/chip="
          f"{costs.bytes_accessed:.3e}  "
          f"coll/chip={costs.total_collective_bytes:.3e}  "
          f"args+temp={mem.peak_memory_in_bytes / 2**30:.2f}GiB "
          f"(trace {t_lower:.1f}s)")
    if peak_tensors:
        rec["peak_tensors"] = traced.counter.peak_live
        for n, count, what in traced.counter.peak_live:
            print(f"[dryrun]   live at the peak: {n / 2**30:.2f} GiB in "
                  f"{count}  {what}")
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        name = f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"
        if tag:
            name += f"__{tag}"
        with open(os.path.join(ARTIFACT_DIR, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep all cells")
    ap.add_argument("--parallel", help="comma list of ParallelConfig "
                                       "overrides, e.g. tp=8,microbatch=2")
    ap.add_argument("--mesh", help="logical re-mesh of the same chips, "
                                   "e.g. 64x4 (data x model)")
    ap.add_argument("--tag", default="", help="artifact suffix for perf iters")
    ap.add_argument("--peak-tensors", type=int, default=0, metavar="N",
                    help="list the N largest storages live at the peak")
    args = ap.parse_args(argv)

    failures = []
    if args.all:
        for arch in list_archs():
            for shape in arch_shapes(arch):
                try:
                    dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                                par_kv=args.parallel, tag=args.tag,
                                mesh_kv=args.mesh,
                                peak_tensors=args.peak_tensors)
                except (ValueError, KeyError, TypeError, RuntimeError,
                        NotImplementedError) as e:
                    # a cell the rules or the trace refuse: recorded and
                    # surfaced through the exit code; anything else
                    # (KeyboardInterrupt, MemoryError) stops the sweep
                    failures.append((arch, shape, repr(e)))
                    print(f"[dryrun] {arch} x {shape}: FAIL {e}")
                    traceback.print_exc()
        print(f"[dryrun] sweep done, {len(failures)} failures")
        for f in failures:
            print("  FAIL:", f)
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    dryrun_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                par_kv=args.parallel, tag=args.tag, mesh_kv=args.mesh,
                peak_tensors=args.peak_tensors)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
