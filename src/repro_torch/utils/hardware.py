"""Hardware constants used by the roofline model and the analytic perf env —
carried over from :mod:`repro.utils.hardware`, with one H100 SXM added.

TPU v5e is the reference's primary target; the "v4-like" variant exists so
the tuner has a *hardware change* environment axis (the paper's TX2 ->
Xavier move).  ``AnalyticTPUEnv`` prices with these TPU specs, as the
reference does.  :data:`H100_SXM` holds the constants the port's launch
geometry prices with (``repro_torch.envs.measure``); its ``vmem_bytes`` is
the shared memory one block may opt into.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bandwidth: float        # bytes/s per chip
    hbm_capacity: float         # bytes per chip
    ici_bandwidth: float        # bytes/s per link (intra-pod)
    dci_bandwidth: float        # bytes/s per link (cross-pod / data-center)
    vmem_bytes: float = 128 * 2**20  # ~128 MiB VMEM per core (v5e-ish)
    ici_latency_us: float = 1.0
    dci_latency_us: float = 25.0

    def roofline_time(self, flops: float, hbm_bytes: float, coll_bytes: float,
                      chips: int, cross_pod: bool = False) -> dict:
        """Three-term roofline residence times in seconds (per the task spec)."""
        link = self.dci_bandwidth if cross_pod else self.ici_bandwidth
        return {
            "compute_s": flops / (chips * self.peak_flops_bf16),
            "memory_s": hbm_bytes / (chips * self.hbm_bandwidth),
            "collective_s": coll_bytes / (chips * link),
        }


# Task-spec constants: 197 TFLOP/s bf16; 819 GB/s HBM; ~50 GB/s/link ICI.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    hbm_capacity=16 * 2**30,
    ici_bandwidth=50e9,
    dci_bandwidth=12.5e9,  # cross-pod links are ~4x thinner
)

# A "different hardware" environment for transfer experiments: more HBM bw,
# more capacity, different compute/comm balance (v4-like).
TPU_V4_LIKE = HardwareSpec(
    name="tpu_v4_like",
    peak_flops_bf16=275e12,
    hbm_bandwidth=1200e9,
    hbm_capacity=32 * 2**30,
    ici_bandwidth=100e9,
    dci_bandwidth=25e9,
)

#: the shared memory one H100 block may opt into (227 KB of the SM's 256
#: KB): the one copy of this limit — ``cuda_lib.SMEM_LIMIT``,
#: ``envs.measure.SMEM_LIMIT_BYTES`` and the static analysis read it here
H100_SMEM_PER_BLOCK = 232448
#: the H100 SXM's streaming multiprocessors
H100_SM_COUNT = 132
#: threads one block may hold, and 32-bit registers one SM holds (sm_90)
MAX_BLOCK_THREADS = 1024
REGISTERS_PER_SM = 65536
#: what one SM holds at once (CUDA C Programming Guide, compute capability
#: 9.0): resident blocks and threads, shared bytes (228 KB), and the shared
#: bytes the runtime reserves for each resident block
MAX_SM_BLOCKS = 32
MAX_SM_THREADS = 2048
H100_SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
#: results a clock one SM issues (CUDA C Programming Guide, compute
#: capability 9.0): fp32 multiply-adds, and exponentials (``ex2``) on the
#: special-function units
FP32_LANES_PER_SM = 128
SFU_PER_SM = 16

# NVIDIA's data sheet, SXM part, dense bf16: 989 TFLOP/s; 3.35 TB/s of HBM3;
# NVLink 900 GB/s a card, 450 GB/s each way; one 400 Gb/s NDR InfiniBand
# link a card across hosts
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80 * 2**30,
    ici_bandwidth=450e9,
    dci_bandwidth=50e9,
    vmem_bytes=H100_SMEM_PER_BLOCK,
)

HARDWARE = {h.name: h for h in (TPU_V5E, TPU_V4_LIKE, H100_SXM)}
