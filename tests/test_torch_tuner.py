"""The port's CAMEO core and tuner against the JAX reference on the CPU.

- The GP (rewritten in torch, float32 as the reference computes with
  ``jax_enable_x64`` off): the same (lengthscale, noise) from the grid on
  seeded data, the posterior mean and std within 1e-4 + 1e-4|x|.
- The carried numpy modules, bit for bit: ``fci_lite``'s graph,
  ``rank_by_ace``'s ranking, ``top_k_blanket``'s blanket, the query parser.
- A seeded k=1 CAMEO run on a serving-environment pair of the dense llama
  families plus paging, priced under the reference's constants, makes the
  same proposals, round for round, with the same measurements; so does a
  random-search baseline.  The two packages size the launch domains for
  their own kernels, so both environments are handed one space: the
  port's serving space, whose every value both simulators price.
- ``transfer_tune`` runs at k=1 and with batched rounds (k=2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.ace import rank_by_ace as jrank_by_ace
from repro.core.cameo import Cameo as JCameo
from repro.core.discovery import fci_lite as jfci_lite
from repro.core.gp import fit_gp as jfit_gp
from repro.core.gp import gp_predict as jgp_predict
from repro.core.markov_blanket import top_k_blanket as jtop_k_blanket
from repro.core.query import parse_query as jparse_query
from repro.core.spaces import ConfigSpace as JConfigSpace
from repro.core.spaces import Option as JOption
from repro.envs.measure import HardwareSpec as JHardwareSpec
from repro.envs.measure import KernelWorkload as JKernelWorkload
from repro.envs.serving_env import make_serving_pair as jmake_serving_pair
from repro.tuner.runner import transfer_tune as jtransfer_tune
from repro_torch.core.ace import choose_k, rank_by_ace
from repro_torch.core.cameo import Cameo
from repro_torch.core.discovery import fci_lite
from repro_torch.core.gp import fit_gp, gp_predict
from repro_torch.core.markov_blanket import top_k_blanket
from repro_torch.core.query import parse_query
from repro_torch.envs.measure import HardwareSpec, KernelWorkload
from repro_torch.envs.serving_env import make_serving_pair
from repro_torch.tuner.runner import tune_kernel_launch, transfer_tune
from repro_torch.workloads import serving_space
from torch_reference_geometry import reference_geometry  # noqa: F401

torch.set_num_threads(1)

GP_TOL = (1e-4, 1e-4)  # float32 on both sides; sums in other orders
SOURCE = "poisson:rate=2500,horizon=0.02"
TARGET = "bursty:rate=3000,horizon=0.02"
FAMILIES = ("flash_attention", "paged_attention", "rmsnorm")


def _gp_data(n=40, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 - 0.5 * x[:, 2] * x[:, 3] \
        + 0.05 * rng.standard_normal(n)
    xq = rng.uniform(0, 1, (25, d))
    return x, y, xq


def _close(out, ref, tol=GP_TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    atol, rtol = tol
    assert np.all(np.abs(out - ref) <= atol + rtol * np.abs(ref)), \
        float(np.abs(out - ref).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hetero", [False, True])
def test_gp_fit_and_posterior_match_the_reference(seed, hetero):
    x, y, xq = _gp_data(seed=seed)
    ev = (np.random.default_rng(seed + 9).uniform(0, 0.05, len(y))
          if hetero else None)
    ref, out = jfit_gp(x, y, extra_var=ev), fit_gp(x, y, extra_var=ev)
    assert (float(out.lengthscale), float(out.noise)) == \
        (float(ref.lengthscale), float(ref.noise))
    assert out.chol.dtype == torch.float32
    _close(out.alpha, np.array(ref.alpha))
    mu, sd = gp_predict(out, xq)
    jmu, jsd = jgp_predict(ref, xq)
    _close(mu, np.array(jmu))
    _close(sd, np.array(jsd))
    # at the training points too (the posterior's narrowest std)
    _close(gp_predict(out, x)[1], np.array(jgp_predict(ref, x)[1]))


def test_gp_degenerate_data_takes_the_widest_kernel_like_the_reference():
    x = np.zeros((6, 2))
    y = np.ones(6)
    ref, out = jfit_gp(x, y), fit_gp(x, y)
    assert (float(out.lengthscale), float(out.noise)) == \
        (float(ref.lengthscale), float(ref.noise))
    _close(gp_predict(out, x)[0], np.array(jgp_predict(ref, x)[0]))


def _causal_data(seed=0, n=500):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(float)
    b = rng.standard_normal(n)
    c = 0.8 * a + 0.3 * rng.standard_normal(n)
    inert = rng.standard_normal(n)
    y = 1.5 * c + 0.6 * b + 0.2 * rng.standard_normal(n)
    return np.column_stack([a, b, c, inert, y]), ["a", "b", "c", "inert",
                                                  "__objective__"]


@pytest.mark.parametrize("seed", [0, 3])
def test_discovery_ace_and_blanket_are_the_reference_bit_for_bit(seed):
    data, names = _causal_data(seed)
    g, jg = fci_lite(data, names), jfci_lite(data, names)
    assert g.edges == jg.edges and g.sepsets == jg.sepsets
    ranked = rank_by_ace(data, names, "__objective__", g)
    assert ranked == jrank_by_ace(data, names, "__objective__", jg)
    k = choose_k(ranked)
    assert top_k_blanket(g, ranked, k, "__objective__", data=data,
                         names=names) == \
        jtop_k_blanket(jg, ranked, k, "__objective__", data=data,
                       names=names)


@pytest.mark.parametrize("text", [
    "minimize latency within 12 samples",
    "maximize throughput for which latency is less than 800 within 9 "
    "samples"])
def test_query_parser_matches_the_reference(text):
    assert dataclasses.asdict(parse_query(text)) == \
        dataclasses.asdict(jparse_query(text))


def _pairs(seed=0):
    """The serving-environment pair in both packages, priced under the
    reference's constants (the port's defaults are the H100's)."""
    jcell = JKernelWorkload(name="tiny", batch=1, seq_len=128, heads=4,
                            kv_heads=2, head_dim=16, d_model=64)
    jhw = JHardwareSpec()
    ref = jmake_serving_pair(SOURCE, TARGET, jcell, families=FAMILIES,
                             seed=seed, hardware=jhw)
    out = make_serving_pair(SOURCE, TARGET,
                            KernelWorkload(**dataclasses.asdict(jcell)),
                            families=FAMILIES, seed=seed,
                            hardware=HardwareSpec(**dataclasses.asdict(jhw)))
    space = serving_space(FAMILIES)
    jspace = JConfigSpace([JOption(o.name, tuple(o.values), o.default, o.kind)
                           for o in space.options])
    for env in ref:
        env.space = jspace
    for env in out:
        env.space = space
    return ref, out


def _cameo_run(pkg_cameo, pkg_query, src, tgt, budget=8, seed=0):
    d_s = src.dataset(48, seed=seed + 1)
    d_init = tgt.dataset(3, seed=seed + 2)
    cam = pkg_cameo(tgt.space, pkg_query(
        f"minimize latency within {budget} samples"), d_s,
        counter_names=src.counter_names, seed=seed)
    cam.seed_target(d_init)
    cam.run(tgt, budget, query_batch=1)
    return cam


@pytest.mark.usefixtures("reference_geometry")
def test_seeded_cameo_makes_the_reference_proposals_round_for_round():
    (jsrc, jtgt), (src, tgt) = _pairs(seed=0)
    assert src.space.names == jsrc.space.names
    jcam = _cameo_run(JCameo, jparse_query, jsrc, jtgt)
    cam = _cameo_run(Cameo, parse_query, src, tgt)
    assert cam.reduced_names == jcam.reduced_names and cam.k == jcam.k
    assert cam.trace.action == jcam.trace.action
    for i, (c, jc) in enumerate(zip(cam.d_t.configs, jcam.d_t.configs)):
        assert c == jc, f"round {i}: {c} != {jc}"
    assert len(cam.d_t.configs) == len(jcam.d_t.configs) == 3 + 8
    assert cam.d_t.ys == jcam.d_t.ys
    assert cam.trace.best_y == jcam.trace.best_y
    # a real search: distinct proposals with distinct latencies
    assert len({tuple(sorted(c.items())) for c in cam.d_t.configs}) > 8
    assert len({y for y in cam.d_t.ys if np.isfinite(y)}) > 5


@pytest.mark.usefixtures("reference_geometry")
def test_random_search_baseline_matches_the_reference():
    (jsrc, jtgt), (src, tgt) = _pairs(seed=1)
    kw = dict(budget=6, n_source=16, n_target_init=2, seed=1)
    ref = jtransfer_tune("random", jsrc, jtgt, **kw)
    out = transfer_tune("random", src, tgt, **kw)
    assert out.best_config == ref.best_config
    assert out.trace_best_y == ref.trace_best_y


@pytest.mark.parametrize("query_batch", [1, 2])
def test_transfer_tune_runs_sequential_and_batched(query_batch):
    # the port's own constants (the H100's) and the dense llama families
    src, tgt = make_serving_pair(SOURCE, TARGET, KernelWorkload(),
                                 families=("flash_attention", "rmsnorm"),
                                 seed=2)
    res = transfer_tune("cameo", src, tgt, budget=4, n_source=24,
                        n_target_init=2, query_batch=query_batch,
                        query_text=tgt.query_text, seed=2)
    assert np.isfinite(res.best_y) and res.best_y > 0
    assert len(res.trace_best_y) == 4
    assert sum(r["size"] for r in res.rounds) == 4
    assert len(res.rounds) == (4 if query_batch == 1 else 2)
    assert all(not k.startswith(("serving.", "pages."))
               for k in res.launch_config)


def test_kernel_launch_tuning_names_the_slice_it_waits_for():
    # the kernel-launch slice is ported: the tuning runs (analytic target)
    res = tune_kernel_launch(KernelWorkload(), budget=2, n_source=16,
                             n_target_init=2)
    assert np.isfinite(res.best_y) and res.best_y > 0
    assert len(res.trace_best_y) == 2
    assert res.launch_config and all("." in k for k in res.launch_config)

