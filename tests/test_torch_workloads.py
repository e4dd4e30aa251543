"""The port's workload subsystem against the JAX reference's, bit for bit:
every trace kind at two seeds (arrivals, prompt and output lengths), the
serving space's option names, and the serving and fleet simulators' every
counter and modeled latency on seeded traces and sampled configurations.

The simulators are priced under the reference's hardware and cell
constants, passed explicitly: the port's defaults are the H100's.  The
sampled spaces are those whose launch domains both packages share — the
paged-attention family's knobs and the scheduler-only space.
"""

import dataclasses

import numpy as np
import pytest

from repro.envs.measure import HardwareSpec as JHardwareSpec
from repro.envs.measure import KernelWorkload as JKernelWorkload
from repro.workloads import FleetPlan as JFleetPlan
from repro.workloads import FleetSimulator as JFleetSimulator
from repro.workloads import FleetSpec as JFleetSpec
from repro.workloads import ServingPlan as JServingPlan
from repro.workloads import ServingSimulator as JServingSimulator
from repro.workloads import make_workload as jmake_workload
from repro.workloads import serving_space as jserving_space
from repro_torch.envs.measure import HardwareSpec, KernelWorkload
from repro_torch.workloads import (FLEET_COUNTER_NAMES, SIM_COUNTER_NAMES,
                                   FleetPlan, FleetSimulator, FleetSpec,
                                   ServingPlan, ServingSimulator,
                                   make_workload, serving_space,
                                   workload_kinds)

GENERATED_KINDS = ("poisson", "bursty", "diurnal", "heavy_tail")
SPECS = ("poisson:rate=3000,horizon=0.02",
         "bursty:rate=2500,horizon=0.02,mean_prompt=40,max_len=256",
         "heavy_tail:rate=2000,horizon=0.02")
SHARED_FAMILIES = (("paged_attention",), ())


def _cells():
    """The reference's cell and hardware, and the port's with equal
    values."""
    jc = JKernelWorkload(name="tiny", batch=1, seq_len=128, heads=4,
                         kv_heads=2, head_dim=16, d_model=64)
    jh = JHardwareSpec()
    return (jc, jh), (KernelWorkload(**dataclasses.asdict(jc)),
                      HardwareSpec(**dataclasses.asdict(jh)))


def _requests(trace):
    return [(r.uid, r.arrival_s, r.prompt_len, r.output_len)
            for r in trace.requests]


def test_registered_kinds_match_the_reference():
    from repro.workloads import workload_kinds as jkinds

    assert workload_kinds() == jkinds()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", GENERATED_KINDS)
def test_traces_are_the_reference_bit_for_bit(kind, seed):
    spec = f"{kind}:horizon=0.03"
    ref = jmake_workload(spec).generate(seed)
    out = make_workload(spec).generate(seed)
    assert make_workload(spec).spec == jmake_workload(spec).spec
    assert (out.kind, out.spec, out.seed) == (ref.kind, ref.spec, ref.seed)
    assert len(out) > 3 and _requests(out) == _requests(ref)


@pytest.mark.parametrize("seed", [0, 7])
def test_replay_kind_reads_the_reference_trace_file(tmp_path, seed):
    path = str(tmp_path / "trace.jsonl")
    jmake_workload("bursty:horizon=0.02").generate(3).save(path)
    ref = jmake_workload(f"replay:path={path}").generate(seed)
    out = make_workload(f"replay:path={path}").generate(seed)
    assert _requests(out) == _requests(ref)


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("families", SHARED_FAMILIES + (
    ("flash_attention", "rmsnorm"),))
def test_serving_space_names_match_the_reference(families, fleet):
    assert (serving_space(families, fleet=fleet).names
            == jserving_space(families, fleet=fleet).names)


@pytest.mark.parametrize("families", SHARED_FAMILIES)
def test_serving_space_domains_match_for_shared_families(families):
    mine, ref = serving_space(families), jserving_space(families)
    assert [(o.name, tuple(o.values), o.default) for o in mine.options] == \
        [(o.name, tuple(o.values), o.default) for o in ref.options]


def test_discovery_counter_names_match_the_reference():
    from repro.workloads import FLEET_COUNTER_NAMES as JFLEET
    from repro.workloads import SIM_COUNTER_NAMES as JSIM

    assert SIM_COUNTER_NAMES == JSIM and FLEET_COUNTER_NAMES == JFLEET


def _sampled_configs(families, n, seed):
    """Configurations from the reference's space (the port's has the same
    names and domains), plus the default."""
    space = jserving_space(families)
    return [space.default_config()] + space.sample(
        np.random.default_rng(seed), n)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("families", SHARED_FAMILIES)
def test_simulator_counters_are_the_reference_bit_for_bit(spec, families):
    (jc, jh), (pc, ph) = _cells()
    jsim = JServingSimulator(jc, families, hardware=jh)
    psim = ServingSimulator(pc, families, hardware=ph)
    trace = make_workload(spec).generate(1)
    jtrace = jmake_workload(spec).generate(1)
    feasible = 0
    for cfg in _sampled_configs(families, 12, seed=5):
        ref = jsim.run(jtrace, JServingPlan.from_config(cfg), cfg)
        out = psim.run(trace, ServingPlan.from_config(cfg), cfg)
        assert dataclasses.asdict(out) == dataclasses.asdict(ref), cfg
        assert out.counters() == ref.counters()
        feasible += out.feasible
    assert feasible >= 3


@pytest.mark.parametrize("families", SHARED_FAMILIES)
def test_fleet_simulator_is_the_reference_bit_for_bit(families):
    (jc, jh), (pc, ph) = _cells()
    spec = "bursty:rate=4000,horizon=0.02"
    jfleet = JFleetSpec(num_devices=8, slow_devices=(2, 5), slowdown=3.0)
    pfleet = FleetSpec(**dataclasses.asdict(jfleet))
    jsim = JFleetSimulator(jc, families, hardware=jh, fleet=jfleet)
    psim = FleetSimulator(pc, families, hardware=ph, fleet=pfleet)
    trace, jtrace = (m(spec).generate(2) for m in (make_workload,
                                                    jmake_workload))
    space = jserving_space(families, fleet=True)
    for cfg in [space.default_config()] + space.sample(
            np.random.default_rng(9), 8):
        ref = jsim.run(jtrace, JServingPlan.from_config(cfg),
                       JFleetPlan.from_config(cfg), cfg)
        out = psim.run(trace, ServingPlan.from_config(cfg),
                       FleetPlan.from_config(cfg), cfg)
        assert dataclasses.asdict(out) == dataclasses.asdict(ref), cfg


def test_port_defaults_are_the_h100s_not_the_references():
    hw, cell = HardwareSpec(), KernelWorkload()
    assert (hw.mxu_flops_per_us, hw.vpu_flops_per_us,
            hw.hbm_bytes_per_us) == (989e6, 67e6, 3.35e6)
    assert cell.vmem_limit == 232448
    assert hw != HardwareSpec(**dataclasses.asdict(JHardwareSpec()))
