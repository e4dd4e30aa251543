"""Serving-workload scenarios: seeded request-trace generators + the
deterministic continuous-batching simulator they drive.

``make_workload("bursty:rate=2000")`` mirrors ``measure.make_backend`` —
trace kinds register in ``WORKLOAD_KINDS`` and are selectable by spec
string anywhere a workload is accepted (``ServingEnv``,
``repro_torch.launch.serve --workload``).
"""

from repro_torch.workloads.sim import (  # noqa: F401
    FLEET_COUNTER_NAMES, FLEET_OPTIONS, FLEET_PREFIX, ROUTING_POLICIES,
    SCHEDULER_OPTIONS, SERVING_PREFIX, SIM_COUNTER_NAMES, DrainStall,
    FleetPlan, FleetReport, FleetSimulator, FleetSpec, ServingPlan,
    ServingSimulator, SimReport, serving_space, tp_speedup)
from repro_torch.workloads.traces import (  # noqa: F401
    WORKLOAD_KINDS, RequestSpec, Trace, TraceWorkload, Workload,
    make_workload, register_workload, workload_kinds)
