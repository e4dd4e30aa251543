"""The paged-KV scheduler surface shared by the simulator, the batcher and
the serving environments.

Two kinds of knobs govern paging and they live in different registries:

- ``paged_attention.*`` — the kernel family's launch options (``page_size``,
  ``pages_per_slot_max``, ``prefill_chunk``), registered in
  :mod:`repro_torch.kernels.dispatch` like every other launch knob and joining
  ``serving_space()`` through ``dispatch.launch_space()``.
- ``pages.*`` — scheduler options that are not kernel-launch parameters:
  whether paging is on at all and how large the shared pool is.  They deploy
  through :meth:`PagedPlan.from_config` exactly like ``serving.*`` deploys
  through ``ServingPlan.from_config`` (and are likewise excluded from
  ``launch_config_of``).

:class:`PagedPlan` is the resolved deployment: one immutable record both the
discrete-event simulator (:mod:`repro.workloads.sim`, not yet ported) and the real batcher
(:mod:`repro_torch.serving.scheduler`) price/allocate with, so the sim-to-real
pair stays pinned to one paging geometry.

This module must stay import-light (no jax, no model stack): the simulator
and the scheduler both import it, and the scheduler cannot import the
simulator (the simulator already imports the scheduler's ``DrainStall``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from repro_torch.core.spaces import Option

PAGES_PREFIX = "pages."

# scheduler-level paging options (the kernel-level ones ride in the
# dispatch registry under the paged_attention family)
PAGES_OPTIONS: Tuple[Option, ...] = (
    Option("pages.paging", ("off", "on"), default="off", kind="categorical"),
    Option("pages.pool_pages", (64, 128, 256, 512), default=128),
)


@dataclass(frozen=True)
class PagedPlan:
    """One resolved paged-KV deployment.

    ``paging=False`` is the dense reference: the serving stack behaves
    exactly as before this plan existed.  With paging on, each admitted slot
    owns up to ``pages_per_slot_max`` pages of ``page_size`` tokens out of a
    shared ``pool_pages``-page pool; ``prefill_chunk`` > 0 splits prompt
    prefill into chunks admitted between decode ticks.
    """

    paging: bool = False
    pool_pages: int = 128
    page_size: int = 64
    pages_per_slot_max: int = 8
    prefill_chunk: int = 0

    @property
    def slot_capacity(self) -> int:
        """Max tokens one slot can ever hold (its page table filled)."""
        return self.page_size * self.pages_per_slot_max

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache entries (at least one)."""
        return max(-(-int(tokens) // self.page_size), 1)

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "PagedPlan":
        """Resolve a flat tuner config; missing keys fall back to the
        ``pages.*`` option defaults and the paged_attention registry
        defaults, so a config that never heard of paging resolves to the
        dense reference plan."""
        from repro_torch.kernels import dispatch

        fam = dispatch.get_family("paged_attention")
        launch = {o.name: o.default for o in fam.launch_options}
        for o in fam.launch_options:
            key = f"paged_attention.{o.name}"
            if key in config:
                launch[o.name] = config[key]
        defaults = {o.name[len(PAGES_PREFIX):]: o.default
                    for o in PAGES_OPTIONS}
        paging = config.get("pages.paging", defaults["paging"])
        return PagedPlan(
            paging=(paging in (True, 1, "on")),
            pool_pages=int(config.get("pages.pool_pages",
                                      defaults["pool_pages"])),
            page_size=int(launch["page_size"]),
            pages_per_slot_max=int(launch["pages_per_slot_max"]),
            prefill_chunk=int(launch["prefill_chunk"]),
        )
