"""JAX (flax) variables -> PyTorch state_dict in the reference's key names.

The port's own copy of ``eop_tpu/utils/torch_export.py`` (the port imports
nothing of ``eop_tpu``): the same rename table and layout transforms, so a
checkpoint trained by the JAX package, or its freshly initialised variables
in the parity tests, loads into the port's modules with ``strict=True``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# flax path -> torch dotted key.  Order matters: specific stage names before
# the generic patterns.
_INVERSE_RENAMES = [
    # ---- head ----
    (r"\bstem_(\d+)\.", r"stems.\1."),
    (r"\bcls_conv_(\d+)_(\d+)\.", r"cls_convs.\1.\2."),
    (r"\breg_conv_(\d+)_(\d+)\.", r"reg_convs.\1.\2."),
    (r"\b(cls|reg|obj)_pred_(\d+)\.", r"\1_preds.\2."),
    # ---- CSPDarknet stages ----
    (r"\bdark5_spp\.", r"dark5.1."),
    (r"\bdark5_csp\.", r"dark5.2."),
    (r"\bdark(\d)_csp\.", r"dark\1.1."),
    (r"\bdark(\d)_conv\.", r"dark\1.0."),
    # ---- CSPLayer bottleneck list ----
    (r"\bm_(\d+)\.", r"m.\1."),
]


def unmap_key(path: str) -> str:
    """Flax dotted path prefix -> torch dotted key prefix (the patterns
    anchor on a trailing dot, so a final component rewrites too)."""
    path = path + "."
    for pat, repl in _INVERSE_RENAMES:
        path = re.sub(pat, repl, path)
    return path[:-1]


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_jax(variables: Mapping[str, Mapping]
                        ) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of arrays -> state_dict.

    Conv kernels HWIO -> OIHW (the Focus kernel keeps the reference shape
    ``[32, 12, 3, 3]``: its fold happens at compute time), BN ``scale`` ->
    ``weight``, ``mean/var`` -> ``running_mean/var``, plus the
    ``num_batches_tracked`` counter strict loading expects.
    """
    out: Dict[str, torch.Tensor] = {}
    bn_prefixes = set()
    for path, v in _walk(variables.get("params", {})):
        prefix = unmap_key(".".join(path[:-1]))
        leaf = path[-1]
        if leaf == "kernel" and v.ndim == 4:
            out[f"{prefix}.weight"] = v.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            out[f"{prefix}.weight"] = v
        elif leaf == "bias":
            out[f"{prefix}.bias"] = v
        else:
            raise ValueError(f"unexpected param leaf {leaf!r} at {prefix}")
    for path, v in _walk(variables.get("batch_stats", {})):
        prefix = unmap_key(".".join(path[:-1]))
        leaf = path[-1]
        if leaf == "mean":
            out[f"{prefix}.running_mean"] = v
        elif leaf == "var":
            out[f"{prefix}.running_var"] = v
        else:
            raise ValueError(f"unexpected stat leaf {leaf!r} at {prefix}")
        bn_prefixes.add(prefix)
    sd = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}
    for prefix in bn_prefixes:
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
