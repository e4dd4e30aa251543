"""CAMEO — Causal Multi-Environment Optimization (the paper's contribution).

Pipeline (Fig. 6 of the paper):

  knowledge extraction   discovery.fci_lite -> ace.rank_by_ace ->
                         markov_blanket.top_k_blanket (reduced space)
  knowledge update       cgp.CausalGP (warm on reduced space, cold on full)
                         acquisition.combined_acquisition (λ-gated EI)
                         epsilon.observation_epsilon (obs/intervene trade-off)
  Algorithm 1            cameo.Cameo

Baselines (SMAC / CELLO / Unicorn / ResTune / ResTune-w/o-ML) share the
tuner interface in ``baselines.py``; environments live in ``repro_torch.envs``.
"""

from repro_torch.core.spaces import ConfigSpace, Option  # noqa: F401
from repro_torch.core.discovery import CausalGraph, fci_lite  # noqa: F401
from repro_torch.core.ace import rank_by_ace, choose_k  # noqa: F401
from repro_torch.core.markov_blanket import top_k_blanket  # noqa: F401
from repro_torch.core.cameo import Cameo, Dataset  # noqa: F401
from repro_torch.core.query import parse_query, Query  # noqa: F401
from repro_torch.core.baselines import make_baseline  # noqa: F401
