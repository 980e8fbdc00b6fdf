"""JAX (flax) variables -> PyTorch state_dict in the reference's key names.

The port's own copy of ``eop_tpu/utils/torch_export.py`` (the port imports
nothing of ``eop_tpu``): the same rename table and layout transforms, so a
checkpoint trained by the JAX package, or its freshly initialised variables
in the parity tests, loads into the port's modules with ``strict=True``.
The table also carries the backbones of the feature-map study, the inverse
of ``eop_tpu/utils/torch_import.py``'s renames: DenseNet's dense layers
(``D{i}.layer{j}.conv{1,2}``), transitions and stem, VGG's
``conv_pool{i}_conv{j}`` and ResNet's ``layer{i}_block{j}`` with its
``down_conv`` / ``down_bn``; ``eop_tpu``'s exporter has none of them.

YOLOv3 (classic Darknet + YOLOFPN) has names of its own: ``eop_tpu`` maps
them one way only, reference -> flax (``torch_import.py::map_yolofpn_key``),
and ``torch_export.py`` has no inverse.  :func:`unmap_yolofpn_key` is that
inverse; a tree is YOLOv3's when it has Darknet's ``stem_group``.  A
``DWConv``'s ``dconv`` / ``pconv`` carry the same names in both packages and
its grouped kernel ``[k, k, 1, C]`` transposes to torch's ``[C, 1, k, k]``.
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
    # ---- DenseNet (before ResNet's: its dense layers are ``layer{j}``) ----
    (r"\bD(\d)\.layer(\d+)\.conv1\.", r"D\1.denseblock.\2.conv_block.0."),
    (r"\bD(\d)\.layer(\d+)\.conv2\.", r"D\1.denseblock.\2.conv_block.1."),
    (r"\bT(\d)\.conv\.", r"T\1.trans.0."),
    (r"\bstem_conv\.", r"stem.0."),
    # ---- VGG ----
    (r"\bconv_pool(\d)_conv(\d+)\.", r"conv_pool\1.\2."),
    # ---- ResNet ----
    (r"\blayer(\d)_block(\d+)\.down_conv\.", r"layer\1.\2.downsample.0."),
    (r"\blayer(\d)_block(\d+)\.down_bn\.", r"layer\1.\2.downsample.1."),
    (r"\blayer(\d)_block(\d+)\.", r"layer\1.\2."),
    # ---- CSPDarknet stages ----
    (r"\bdark5_spp\.", r"dark5.1."),
    (r"\bdark5_csp\.", r"dark5.2."),
    (r"\bdark(\d)_csp\.", r"dark\1.1."),
    (r"\bdark(\d)_conv\.", r"dark\1.0."),
    # ---- CSPLayer bottleneck list ----
    (r"\bm_(\d+)\.", r"m.\1."),
]


# classic Darknet (YOLOv3's backbone) and YOLOFPN: flax names -> the
# reference's positional Sequential indices; dark5 is handled apart
_INVERSE_RENAMES_YOLOFPN = [
    (r"\bstem_conv\.", r"stem.0."),
    (r"\bstem_group\.conv\.", r"stem.1."),
    (r"\bstem_group\.res_(\d+)\.", lambda m: f"stem.{int(m.group(1)) + 2}."),
    (r"\bdark(\d)\.conv\.", r"dark\1.0."),
    (r"\bdark(\d)\.res_(\d+)\.",
     lambda m: f"dark{m.group(1)}.{int(m.group(2)) + 1}."),
    (r"\bout(\d)\.cbl(\d)\.", r"out\1.\2."),
]
# the SPP block's five entries follow dark5's stride conv and ResLayers
_SPP_BLOCK = ("conv0", "conv1", "spp", "conv2", "conv3")


def unmap_key(path: str) -> str:
    """Flax dotted path prefix -> torch dotted key prefix (the patterns
    anchor on a trailing dot, so a final component rewrites too)."""
    path = path + "."
    for pat, repl in _INVERSE_RENAMES:
        path = re.sub(pat, repl, path)
    return path[:-1]


def unmap_yolofpn_key(path: str, dark5_res: int) -> str:
    """A YOLOv3 flax dotted path prefix -> torch dotted key prefix;
    ``dark5_res`` is the number of ResLayers in dark5 (4 at depth 53, 1 at
    21), which places the SPP block's entries after them."""
    path = path + "."

    def dark5(m):
        group, name = m.group(1), m.group(2)
        if group == "group":
            i = 0 if name == "conv" else int(name[len("res_"):]) + 1
        else:
            i = 1 + dark5_res + _SPP_BLOCK.index(name)
        return f"dark5.{i}."

    path = re.sub(r"\bdark5_(group|spp)\.(conv\d?|spp|res_\d+)\.", dark5,
                  path)
    for pat, repl in _INVERSE_RENAMES_YOLOFPN + _INVERSE_RENAMES:
        path = re.sub(pat, repl, path)
    return path[:-1]


def _unmapper(paths):
    """The prefix renamer for a tree's dotted paths: YOLOv3's where the
    tree has Darknet's ``stem_group``, else the YOLOX one."""
    if not any(".stem_group." in f".{p}." for p in paths):
        return unmap_key
    res = {int(m.group(1)) for p in paths
           for m in [re.search(r"\bdark5_group\.res_(\d+)\b", p)] if m}
    return lambda path: unmap_yolofpn_key(path, len(res))


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
    unmap = _unmapper([".".join(path) for tree in variables.values()
                       for path, _ in _walk(tree)])
    for path, v in _walk(variables.get("params", {})):
        prefix = unmap(".".join(path[:-1]))
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
        prefix = unmap(".".join(path[:-1]))
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


def train_state_from_jax(state: Mapping, model, optimizer):
    """A JAX ``TrainState`` given as numpy arrays -> the port's
    ``TrainState`` over ``model`` and ``optimizer`` (both updated in place),
    so the two packages can start from one state.

    ``state`` keys: ``params``, ``batch_stats`` (flax trees); optional
    ``momentum`` (the optax trace, a tree shaped like ``params``),
    ``ema_params``, ``ema_batch_stats``, ``dwa`` (``last_iou``, ``last_obj``,
    ``last_cls``) and ``step``.  Every tree goes through the rename table of
    :func:`state_dict_from_jax`, so momentum and EMA kernels take the
    HWIO -> OIHW transpose too.
    """
    from ..losses import DWAState
    from ..train.steps import TrainState

    model.load_state_dict(state_dict_from_jax(
        {"params": state["params"], "batch_stats": state["batch_stats"]}),
        strict=True)
    device = next(model.parameters()).device
    params = dict(model.named_parameters())

    def on_device(tree_kind: str, tree):
        sd = state_dict_from_jax({tree_kind: tree})
        return {k: v.to(device) for k, v in sd.items()
                if v.is_floating_point()}

    if state.get("momentum") is not None:
        bufs = on_device("params", state["momentum"])
        if set(bufs) != set(params):
            raise ValueError("momentum tree does not match the parameters")
        for name, p in params.items():
            optimizer.state[p]["momentum_buffer"] = bufs[name]
    ema_params = ema_stats = dwa = None
    if state.get("ema_params") is not None:
        ema_params = on_device("params", state["ema_params"])
    if state.get("ema_batch_stats") is not None:
        ema_stats = on_device("batch_stats", state["ema_batch_stats"])
    if state.get("dwa") is not None:
        dwa = DWAState(**{
            k: torch.tensor(np.asarray(state["dwa"][k], np.float32),
                            device=device)
            for k in ("last_iou", "last_obj", "last_cls")})
    return TrainState(model=model, optimizer=optimizer,
                      step=int(state.get("step", 0)), ema_params=ema_params,
                      ema_batch_stats=ema_stats, dwa=dwa)
