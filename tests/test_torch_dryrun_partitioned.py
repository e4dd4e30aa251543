"""The dry run's traced rank against the reference's partitioned compile:
smoke cells at tp=2 on a ``(1, 2)`` ``("data", "model")`` mesh (fsdp 1).

The reference's side runs in a subprocess whose ``XLA_FLAGS`` force 4 host
devices (set for that process only, never in this one): each cell jitted
with its ``in_shardings`` and compiled, outside ``compat.set_mesh`` as
``torch_dryrun_reference.py`` compiles the one-device cells, its dot FLOPs
read by that file's ``dot_flops``: one device's program as the SPMD
partitioner builds it.  The port's side is ``lower_step``'s trace of rank
0's sharded step (``matmul_flops``).

They agree number for number on llama3.2-1b's prefill, decode and train
cells.  Two cells differ, each held at both counts (``ROADMAP.md`` queue
3 says why): the reference lays the decode state out by
``cache_specs``, which splits a cache's last divisible dim, and computes
the products that feed it at that device's columns, where the port's rank
computes them whole for the state it holds — deepseek-v3-671b's prefill
(the latent product ``x @ w_dkv``, 12 of its 24 columns a device in the
reference; MLA's latent cache is whole on every port rank) and
zamba2-2.7b's decode (Mamba-2's ``B`` / ``C`` / ``dt`` products and the
``B`` / ``C`` convolution, half their columns in the reference; every
head a port rank holds reads the whole ``B`` and ``C`` of its one group).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import make_run
from repro_torch.launch.build import lower_step
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils.config import MeshConfig

torch.set_num_threads(1)

EXACT = (("llama3.2-1b", "prefill_smoke"), ("llama3.2-1b", "decode_smoke"),
         ("llama3.2-1b", "train_smoke"))
#: (arch, shape) -> (port traced matmul FLOPs, reference partitioned dots)
HELD = {("deepseek-v3-671b", "prefill_smoke"): (27852800, 27459584),
        ("zamba2-2.7b", "decode_smoke"): (836608, 825856)}
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cells = [f"{a}:{s}" for a, s in EXACT + tuple(HELD)]
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dryrun_reference.py"),
         *cells], env=env, capture_output=True, text=True, timeout=600,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def traced_matmul_flops(arch, shape):
    run = make_run(arch, shape, smoke=True)
    run = run.replace(mesh=MeshConfig(shape=(1, 2), axes=("data", "model")),
                      parallel=run.parallel.replace(tp=2, fsdp=1))
    _, traced = lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))
    return traced.cost_analysis().matmul_flops


def test_the_flag_stays_in_its_subprocess():
    assert "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("arch,shape", EXACT,
                         ids=[f"{a}-{s}" for a, s in EXACT])
def test_traced_rank_equals_the_partitioned_compile(reference, arch, shape):
    assert traced_matmul_flops(arch, shape) == \
        reference[f"{arch}:{shape}"] > 0


@pytest.mark.parametrize("arch,shape", sorted(HELD),
                         ids=[f"{a}-{s}" for a, s in sorted(HELD)])
def test_cell_held_at_its_counts(reference, arch, shape):
    port, ref = HELD[(arch, shape)]
    assert (traced_matmul_flops(arch, shape),
            reference[f"{arch}:{shape}"]) == (port, ref)
