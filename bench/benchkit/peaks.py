"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), the
yardstick of every roofline share and every ``mfu``.  They assume the
card's full 700 W power limit; results carry the card's name beside
them."""

#: operations a second by the precision of the arithmetic
FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12,
         "fp8": 1979e12}
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the work needs on the chip: the larger of its
    operations at the peak rate of ``precision`` and its bytes at the
    memory's bandwidth."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
