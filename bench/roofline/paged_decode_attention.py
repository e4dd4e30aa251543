"""Operations and bytes of one row of paged single-token decode attention
(the ``paged_decode_attention`` kernel), from its shapes.

A row of ``context`` cache rows, ``q_heads`` query heads over
``kv_heads`` key/value heads of width ``head_dim``: the scores ``q K^T``
and the output ``p V`` are two products of ``2 * context * head_dim`` a
query head (the softmax's few operations a score not counted).  Bytes:
each key and value row read once (``2 * context * kv_heads * head_dim``
elements), the query read and the output written once, and the row's
page-table entries (int32) and length read once.
"""

PRECISION = "bf16"


def work(context: int, q_heads: int, kv_heads: int, head_dim: int,
         page_size: int, elt_bytes: int = 2):
    """(operations, bytes) of one row."""
    flops = 4 * context * q_heads * head_dim
    pages = -(-context // page_size)
    nbytes = (2 * context * kv_heads * head_dim
              + 2 * q_heads * head_dim) * elt_bytes + 4 * pages + 4
    return flops, nbytes
