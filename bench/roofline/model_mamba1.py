"""Model FLOPs of a Mamba-1 language model, a token at a time.

A token's layer: the products ``w_x`` and ``w_z`` (d x d_inner each),
``w_bcdt`` (d_inner x (R + 2N)), ``w_dt`` (R x d_inner) and ``w_out``
(d_inner x d), two operations a weight; the depthwise convolution (2K a
channel); the scan (6N + 3 a channel, as ``selective_scan.py`` counts).
The head (2 d V) runs once for a decoded token and once for a prompt:
only its last position's logits are needed.  Norms and activations are
not counted.
"""


def _layer(s):
    d = int(s["d_model"])
    di = int(s["ssm_expand"]) * d
    n, k = int(s["ssm_state"]), int(s["ssm_conv"])
    r = -(-d // 16)
    matmul = 2 * (2 * d * di + di * (r + 2 * n) + r * di + di * d)
    return matmul + 2 * k * di + (6 * n + 3) * di


def _head(s):
    return 2 * int(s["d_model"]) * int(s["vocab_size"])


def prefill_flops(s, length):
    return length * int(s["num_layers"]) * _layer(s) + _head(s)


def decode_flops(s, context):
    return int(s["num_layers"]) * _layer(s) + _head(s)
