"""The reference's side of the dry-run parity tests: a smoke cell's step
lowered and compiled by the JAX package, its FLOPs read off the compiled
HLO text.

The cell is compiled without ``compat.set_mesh``: under the installed jax
the mesh context makes ``with_sharding_constraint`` fail
(``tests/test_integration_lower.py``'s known failures), and on the
one-device smoke mesh the constraint changes nothing.  Run as a script
(``python torch_dryrun_reference.py [--collectives] CELL ...``, in a
process whose ``XLA_FLAGS`` force at least 2 host devices) it compiles
each cell — ``ARCH:SHAPE`` at tp=2 on a ``(1, 2)`` ``("data", "model")``
mesh, the SPMD partitioner's program of one device, or
``ARCH:SHAPE:TP:REMAT`` at that tp (1: the one-device mesh) under that
``remat`` policy — and prints its dot FLOPs by cell as JSON (with
``--collectives``, ``analyze_hlo``'s collective operand bytes by kind).  The
dot term is ``repro.launch.hlo_analysis``'s own rule (2 x result
elements x contracted elements, ``:330-342``), summed over the
computations its call-graph walk reaches, each scaled by its loop's trip
count, through the module's own parsing functions.
"""

import jax

from repro.configs.registry import make_run
from repro.launch import hlo_analysis as H
from repro.launch.build import build_step
from repro.launch.mesh import make_mesh


def compiled_text(arch: str, shape: str, tp: int = 1,
                  remat: str = None) -> str:
    """The compiled smoke cell, on its one-device mesh, or with ``tp`` > 1
    on a ``(1, tp)`` ``("data", "model")`` mesh at that tp (fsdp 1); with
    ``remat`` under that policy (the smoke plan's, ``"none"``, else)."""
    from repro.utils.config import MeshConfig

    run = make_run(arch, shape, smoke=True)
    if tp > 1:
        run = run.replace(mesh=MeshConfig(shape=(1, tp),
                                          axes=("data", "model")),
                          parallel=run.parallel.replace(tp=tp, fsdp=1))
    if remat is not None:
        run = run.replace(parallel=run.parallel.replace(remat=remat))
    b = build_step(run, make_mesh(run.mesh))
    jitted = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings,
                     donate_argnums=b.donate_argnums)
    return jitted.lower(*b.abstract_args).compile().as_text()


def _computation_dots(lines) -> float:
    types, flops = {}, 0.0
    for line in lines:
        m = H._OP_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        om = H._OPCODE_RE.search(rest)
        opcode = om.group(1) if om else ""
        types[name] = rest[:om.start() + 1] if om else rest
        if opcode != "dot":
            continue
        operands = H._NAME_REF_RE.findall(H._arg_list(rest, om.end() - 1))
        otypes = [types.get(n, "") for n in operands]
        rm = H._SHAPE_RE.search(types[name])
        result = H._shape_elems(rm.group(0)) if rm else 0
        contract = 1
        cm = H._DOT_CONTRACT_RE.search(rest)
        if cm and otypes:
            rhs = H._SHAPE_RE.search(otypes[1] if len(otypes) > 1
                                     else otypes[0])
            if rhs and rhs.group(2):
                dims = [int(x) for x in rhs.group(2).split(",")]
                for d in (int(x) for x in cm.group(1).split(",") if x):
                    if d < len(dims):
                        contract *= dims[d]
        flops += 2.0 * result * contract
    return flops


def dot_flops(hlo: str) -> float:
    """``analyze_hlo``'s dot FLOPs alone, trip-scaled."""
    comps = H._split_computations(hlo)
    stats = {n: H._analyze_computation(n, lines)
             for n, lines in comps.items()}
    dots = {n: _computation_dots(lines) for n, lines in comps.items()}

    def total(name, seen=()):
        if name not in stats or name in seen:
            return 0.0
        out = dots[name]
        for callee, mult, cond in stats[name].calls:
            trips = mult
            if mult < 0:
                trips = (H._trip_count(stats.get(cond, H.CompStats()))
                         if cond else 1.0)
            out += trips * total(callee, seen + (name,))
        return out

    return total(H._ENTRY_RE.search(hlo).group(1))


def reference_costs(arch: str, shape: str):
    """(dot FLOPs, ``analyze_hlo(...).flops``) of one compiled smoke cell."""
    text = compiled_text(arch, shape)
    return dot_flops(text), H.analyze_hlo(text).flops


def _cell_text(cell: str) -> str:
    arch, shape, *rest = cell.split(":")
    tp, remat = (int(rest[0]), rest[1]) if rest else (2, None)
    return compiled_text(arch, shape, tp=tp, remat=remat)


if __name__ == "__main__":
    import json
    import sys

    cells = [c for c in sys.argv[1:] if c != "--collectives"]
    if "--collectives" in sys.argv:
        print(json.dumps({c: H.analyze_hlo(_cell_text(c)).collective_bytes
                          for c in cells}))
    else:
        print(json.dumps({c: dot_flops(_cell_text(c)) for c in cells}))
