"""Operations and bytes of the Mamba-1 selective scan over one sequence
(the prefill's ``selective_scan`` kernel), from its shapes.

Per step t, channel c and state n: the decay ``exp(dt A)`` (one product,
the exponential not counted), the input ``(dt x) B`` (one product; ``dt
x`` once per (t, c)), the state update (a product and a sum) and the
output ``C . h`` (a product and a sum): 6 operations a (t, c, n) and 3 a
(t, c) (``dt x``, ``D x`` and its sum).  Bytes: each input read once and
each output written once: x, dt, y (L, C) and B, C (L, N) in the model's
dtype, A (C, N) and D (C) in fp32, the final state (C, N) in fp32.
"""

#: the arithmetic runs in fp32 outside the tensor cores
PRECISION = "fp32"


def work(length: int, channels: int, states: int, elt_bytes: int = 2):
    """(operations, bytes) of one sequence of ``length`` steps."""
    l, c, n = length, channels, states
    flops = 6 * l * c * n + 3 * l * c
    nbytes = (3 * l * c + 2 * l * n) * elt_bytes + (2 * c * n + c) * 4
    return flops, nbytes
