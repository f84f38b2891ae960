"""Flax parameter trees (as numpy) -> torch state_dicts, and the strict
load of a torch checkpoint into a port model (`convert_checkpoint`, the
counterpart of v2v_tpu/models/convert.py::validate_against).

The inverse of v2v_tpu/models/convert.py::torch_state_dict_to_flax for
the modules this package ports (the recurrent UNet zoo, EVFlowNet,
FireNet and its legacy form, ETNet, HyperE2VID, ERAFT, NerNet, the RAFT
teachers, the LPIPS trunks): carries weights from the JAX reference
into the port, so parity tests run both on the same numbers. Rules:

  * kernel (kH,kW,I,O) -> weight (O,I,kH,kW); kernel (I,O) -> weight (O,I)
  * a transposed conv's kernel (kH,kW,O,I) (flax ConvTranspose with
    transpose_kernel) -> weight (I,O,kH,kW): the same permutation
  * packed attention in_proj_kernel (d,3d) -> in_proj_weight (3d,d)
  * DynamicConv compositional_coefficients (1,1,I,O) -> (O,I,1,1)
  * scale -> weight; other leaves keep their name
  * batch_stats {mean, var} (BatchNorm, or InstanceNorm with running
    statistics) -> running_mean / running_var, with
    num_batches_tracked 0 (JAX does not count batches)
  * flax child `encoders_0` of a torch ModuleList -> `encoders.0`; also
    NerNet's Sequentials: the ValueLayer's `mlp_0`, the RepCNN's `cnn_0`,
    the NAM cell's `conv_x_0` / `conv_h_0` / `conv_m_0` / `conv_o_0` and
    the GCB's `channel_add_conv_0` -> `mlp.0`, `cnn.0`, `conv_x.0`, ...
  * a decoder stack's `decoders/decoders_0` -> `decoders.0` (also
    `image_decoders` and `flow_decoders`, WNet's two stacks, and NerNet's
    m-stream upsampler `m_t_UpsampleLayer`)
  * NerNet's flat flax names `representation.quantization_layer` and
    `representation.ConvLayer` -> the two torch levels `representation`
    / `quantization_layer` (`ConvLayer`)
  * the GCB's LayerNorm([C, 1, 1]) (`channel_add_conv_1`): scale and bias
    (C,) -> weight and bias (C, 1, 1)
  * ETNet's stacked streams `tri_encoder`/`tri_decoder` (leading axis 3)
    -> `trans_encoder{i}.encoder` / `trans_decoder{i}.decoder`
  * a residual block's `norm3` also as `downsample.1`, ERAFT's second
    registration of the same module (model/eraft/extractor.py)
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

# torch ModuleList / Sequential attributes whose flax children are named
# `{name}_{i}` (the subset of the reference converter's list that the
# ported modules use)
_MODULELISTS = ("encoders", "resblocks", "layer1", "layer2", "layer3",
                "downsample", "mask", "DownsampleConv", "UpsampleConv",
                "layers", "bases_net", "mlp", "cnn", "conv_x", "conv_h",
                "conv_m", "conv_o", "channel_add_conv")
_DECODER_STACKS = ("decoders", "image_decoders", "flow_decoders",
                   "m_t_UpsampleLayer")
# flax modules that are a torch LayerNorm over (C, 1, 1)
_LAYERNORM_CHW = ("channel_add_conv_1",)
_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _strip_wrappers(key: str) -> str:
    """Drop the `module.` (DDP) and `_orig_mod.` (torch.compile)
    prefixes of a torch state_dict key."""
    parts = key.split(".")
    while parts and parts[0] in ("_orig_mod", "module"):
        parts.pop(0)
    return ".".join(parts)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_module_path(path: Tuple[str, ...]) -> List[str]:
    out: List[str] = []
    i = 0
    while i < len(path):
        p = path[i]
        nxt = path[i + 1] if i + 1 < len(path) else None
        m = _INDEXED.match(nxt) if nxt is not None else None
        if p in _DECODER_STACKS and m and m.group(1) == "decoders":
            out += [p, m.group(2)]
            i += 2
            continue
        m = _INDEXED.match(p)
        if "." in p:          # one flax name for two torch levels
            out += p.split(".")
        elif m and m.group(1) in _MODULELISTS:
            out += [m.group(1), m.group(2)]
        else:
            out.append(p)
        i += 1
    return out


def _unstack_eitr_streams(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of v2v_tpu/models/convert.py::_stack_eitr_streams: the
    JAX EITR batches its three streams on a leading axis, the reference
    (and this port) keeps them as separate modules with one more level."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    out = dict(tree)
    for tri, base, level in (("tri_encoder", "trans_encoder", "encoder"),
                             ("tri_decoder", "trans_decoder", "decoder")):
        if tri in out:
            stacked = out.pop(tri)
            for i in range(3):
                out[f"{base}{i}"] = {level: take(stacked, i)}
    return out


def jax_params_to_state_dict(flax_params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """{'params': tree[, 'batch_stats': tree]} (or the bare params tree)
    of numpy arrays -> state_dict."""
    tree = _unstack_eitr_streams(flax_params.get("params", flax_params))
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(tree):
        arr = np.asarray(val, dtype=np.float32)
        leaf = path[-1]
        mod = _torch_module_path(path[:-1])
        if leaf == "in_proj_kernel":
            leaf = "in_proj_weight"
            arr = arr.T
        elif leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "compositional_coefficients":
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        if len(path) > 1 and path[-2] in _LAYERNORM_CHW:
            arr = arr.reshape(-1, 1, 1)
        sd[".".join(mod + [leaf])] = torch.from_numpy(np.array(arr))
    for path, val in _leaves(flax_params.get("batch_stats", {})):
        mod = _torch_module_path(path[:-1])
        sd[".".join(mod + [f"running_{path[-1]}"])] = torch.from_numpy(
            np.array(val, dtype=np.float32))
        sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    for key in [k for k in sd if ".norm3." in k]:
        block, leaf = key.rsplit(".norm3.", 1)
        if f"{block}.downsample.0.weight" in sd:
            sd[f"{block}.downsample.1.{leaf}"] = sd[key]
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state_dict: the file's `state_dict` entry, or
    the file itself (v2v_tpu/models/convert.py:208), with the `module.`
    and `_orig_mod.` prefixes stripped."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved.get("state_dict", saved)
    return {_strip_wrappers(k): v for k, v in sd.items()}


def validate_against(model: torch.nn.Module,
                     state_dict: Dict[str, torch.Tensor],
                     strict: bool = True) -> Dict[str, torch.Tensor]:
    """Check `state_dict` against `model`'s keys and shapes and return a
    full state_dict for it. `strict` raises on a missing key, an
    unexpected key or a shape mismatch; otherwise the unexpected keys are
    dropped and the missing or mismatched ones keep the model's values
    (load_state_dict(strict=False), test_e2vid.py:188)."""
    template = model.state_dict()
    missing = [k for k in template if k not in state_dict]
    unexpected = [k for k in state_dict if k not in template]
    mismatched = [k for k in template if k in state_dict and tuple(
        state_dict[k].shape) != tuple(template[k].shape)]
    if strict and (missing or unexpected or mismatched):
        raise ValueError(
            f"checkpoint does not match {type(model).__name__}: "
            f"missing={missing[:5]} ({len(missing)} total), "
            f"unexpected={unexpected[:5]} ({len(unexpected)} total), "
            f"shape-mismatch={mismatched[:5]} ({len(mismatched)} total)")
    return {k: v if k in missing or k in mismatched else state_dict[k]
            for k, v in template.items()}


def convert_checkpoint(path: str, model: torch.nn.Module,
                       strict: bool = True) -> torch.nn.Module:
    """Load the torch checkpoint at `path` into `model` through
    `validate_against`; returns the model."""
    model.load_state_dict(validate_against(
        model, load_torch_checkpoint(path), strict))
    return model
