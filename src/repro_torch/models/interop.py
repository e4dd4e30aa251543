"""Carry the reference's parameters across: the JAX parameter pytree, as
nested dicts of numpy arrays, becomes the port's parameter tree.

The port keeps the reference's layout (``(in, out)`` weights, super-block
leaves stacked on a leading ``nsb`` axis, whatever the pattern's length —
one sub-layer for dense and ssm, five for the vlm, six for zamba2 — the
hybrid family's unstacked ``shared_attn`` block, and the
encoder-decoder's ``enc_blocks`` / ``dec_blocks`` stacked on their layer
axes), so the conversion is leaf-for-leaf; the
tree structure and every shape are checked against the port's own
parameters (built on the ``meta`` device).  Each leaf takes its template
leaf's dtype: the model dtype for weights, fp32 for the SSM parameters
``A_log``, ``dt_bias`` and ``D`` and for the MoE router, which the
reference keeps in fp32 in a bf16 model.  Callers hand over ``np.array(x)`` copies, not ``np.asarray``
views, which are read-only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import init_params_tree, torch_dtype
from repro_torch.utils.config import ModelConfig
from repro_torch.utils.device import DeviceLike, resolve_device


def _to_tensor(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly first
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's ``init_lm_params`` tree (``init_encdec_params`` for
    the audio family) -> the port's parameters.
    ``dtype`` (default: the config's) is the model dtype of the template;
    leaves the reference keeps in fp32 stay fp32."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    template = init_params_tree(cfg, None, dtype, torch.device("meta"))

    def convert(src, tmpl, path):
        if isinstance(tmpl, dict):
            if not isinstance(src, dict) or set(src) != set(tmpl):
                raise ValueError(
                    f"parameter tree mismatch at {path or '/'}: reference has "
                    f"{sorted(src) if isinstance(src, dict) else type(src)}, "
                    f"port expects {sorted(tmpl)}")
            return {k: convert(src[k], tmpl[k], f"{path}/{k}") for k in tmpl}
        if tuple(np.shape(src)) != tuple(tmpl.shape):
            raise ValueError(f"{path}: reference shape {np.shape(src)} != "
                             f"port shape {tuple(tmpl.shape)}")
        return _to_tensor(src, tmpl.dtype, dev)

    return convert(tree, template, "")
