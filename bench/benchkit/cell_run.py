"""One run of one cell: set-up, the measured window, the reading of the
metrics, the check, and the result's line."""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict

import torch

from benchkit import check, driver, spec, stats, trace, traffic, weights
from benchkit.measure import Run

#: top-level module names that no run may load: JAX, its libraries and
#: the JAX package the port was made from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def limits(cell: spec.Cell) -> Dict[str, Dict]:
    """``limits/<cell>.json``: each number compared, with its limit and
    the readings it was set from."""
    return json.loads((cell.bench_dir / "limits" / f"{cell.name}.json")
                      .read_text())


def _e2e(cell: spec.Cell, w: driver.Window) -> Dict[str, float]:
    times = [w.times[u] for u in sorted(w.times)]
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "output_tokens_per_s":
            out[name] = stats.output_tokens_per_s(times, w.t0, w.t1)
        elif name == "ttft_p90_ms":
            out[name] = stats.ttft_p90_ms(w.ttft_s)
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             root: Path = spec.ROOT, bench_dir: Path = spec.BENCH_DIR,
             control: bool = False, log=print) -> Dict:
    """Set up ``workload`` from ``seed``, measure it for ``seconds`` (with
    the profiler over the window's end when ``traced``), check what it
    served, and return the result's line as a dict."""
    cell = spec.load_cell(workload, root, bench_dir)
    cfg = spec.port_model_config(cell.config)
    sizes = cell.config["port"]
    mix = cell.mix
    seed = int(seed) % (2 ** 63)
    clock = time.perf_counter

    # -- set-up: weights, the batcher, every shape the window uses; the
    # loop's start before the window (``Driver``) is set-up too
    marks = [("start", clock())]
    params = weights.make_params(cfg, seed, device)
    marks.append(("weights", clock()))
    batcher = driver.deploy(cfg, cell.config, mix, params, device, seed)
    marks.append(("deploy", clock()))
    driver.warm_up(batcher, mix, cfg.vocab_size)
    marks.append(("warm-up", clock()))
    spans = trace.instrument(batcher, clock) if traced else None
    if mix["loop"] == "closed":
        plan = traffic.closed_loop(mix, seed, cfg.vocab_size)
    else:
        plan = traffic.open_loop(mix, seed, cfg.vocab_size, seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("plan", clock()))

    # -- the window
    drv = driver.Driver(batcher, clock)
    prof = None
    if traced:
        prof = trace.Profiled(batcher, drv.w, clock,
                              min(trace.TRACE_SECONDS, seconds))
        drv.on_tick = prof
    if mix["loop"] == "closed":
        w = drv.closed(plan, seconds)
    else:
        w = drv.open(plan, seconds, float(mix.get("warm_s", 0.0)))
    sub = prof.finish() if prof is not None else None
    marks.append(("loop start", w.t0))
    setup_s = w.t0 - t_start
    log("set-up: imports " + f"{marks[0][1] - t_start:.2f} s, " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0

    # -- metrics
    if traced:
        run = Run(cell, sizes, w, sub, spans)
        metrics = {}
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = _e2e(cell, w)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}

    # -- the check, once the program's state is freed
    done = driver.finished(w)
    picked = check.sample(done, seed, int(mix["check_requests"]))
    prompts = [w.planned[u].prompt for u in picked]
    served = [list(w.states[u].generated) for u in picked]
    del batcher, drv, prof, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got: Dict[str, float] = {"served_gap": float("inf")}
    if picked:
        t = clock()
        got = check.compare(cell, params, prompts, served, device, control)
        log(f"check: {len(picked)} requests, {got['served_tokens']} served "
            f"tokens, {clock() - t:.1f} s")
    if control:
        # the control stands in the program's place: its gap is judged
        got = dict(got, served_gap=got.get("control_gap", float("inf")),
                   program_gap=got["served_gap"])
    lim = limits(cell)
    checks = {name: {"value": got[name], "limit": lim[name]["limit"]}
              for name in lim}
    correct = (bool(picked) and w.failed == 0 and w.attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced and sub is not None and sub.trace is not None:
        result["device"]["busy_s"] = sub.trace.busy_s
        result["device"]["window_s"] = sub.trace.window_s
        result["breakdown"] = trace.breakdown(sub.trace)
    if control:
        result["control"] = {"control_gap": got.get("control_gap"),
                             "program_gap": got["program_gap"]}
    if w.lateness_s:
        log(f"generator lateness: {stats.summary(w.lateness_s)}")
    result["checks"] = checks
    return result
