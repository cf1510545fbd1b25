"""Carry the reference's problem data and model weights across to the port
and back.

The balancer's "weights" are its problem data.  ``from_reference`` turns the
reference ``Problem``'s fields, taken out as numpy arrays, into the port's
``Problem`` on a device; ``to_numpy`` goes the other way.  The dict holds
one entry per ``Problem`` field; ``weights`` is a dict of the five goal
weights, and the optional utility curves may be absent or None.

``lm_from_reference`` builds the port's model from the reference's params
pytree as numpy arrays, by ``cfg.family``: for the dense and MoE
``TransformerLM`` its ``init``'s layout (``embed``, ``final_norm``, optional
``lm_head``, with ``first_dense_layers`` a ``prefix`` list of P unstacked
blocks, the port's blocks 0..P-1, and ``layers`` a list of G groups whose
leaves are stacked [(num_layers - P) / G, ...]: one group, or gemma2's two,
local and global, whose leaf g of group j is the port's block P + G g + j;
an MoE block's ``moe`` holds ``router``, ``w_gate``, ``w_up``, ``w_down``
stacked [E, ...] and, with shared experts, ``shared`` = {w_gate, w_up,
w_down}; a block's ``attn`` holds its attention's ``PARAMS``, MLA's
``wq``, ``wkv_down``, ``kv_norm`` (f32), ``wk_rope``, ``wk_up``, ``wv_up``
and ``wo`` under ``mla``);
for the hybrid ``Zamba2`` its ``init``'s (``embed``, ``final_norm``,
``layers`` a dict of Mamba2 leaves stacked [num_layers, ...], and
``shared`` = {in_proj, ln1, attn, ln2, mlp, out_proj [apps, d, d]}); for
the xLSTM family's ``XLSTM`` its ``init``'s (``embed``, ``final_norm`` and
``layers`` an unstacked list of one dict a layer, whose keys are the
block's: an mLSTM's ``norm``, ``w_up``, ``w_gate_up``, ``conv_w``,
``conv_b``, ``wq``, ``wk``, ``wv``, ``w_if``, ``out_norm``, ``w_down``; an
sLSTM's ``norm``, ``w_in``, ``r_z``, ``r_i``, ``r_f``, ``r_o``,
``out_norm`` and ``ffn`` = {w_gate, w_up, w_down}).
``lm_to_numpy`` goes the other way.  The VLM family (phi-3-vision) is a
``TransformerLM`` and carries as the dense one does.
``encoder_from_reference`` and ``encoder_to_numpy`` do the same for the
audio family's ``Encoder`` and its ``init``'s layout (``pos_conv_w``,
``mask_embed``, ``layers`` one block's tree with every leaf stacked
[num_layers, ...], ``final_norm`` {"scale", "bias"} and ``head``).  Both
packages store linear weights [d_in, d_out], so nothing is transposed: the
stacked leaves are only cut per layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.problem import GOAL_NAMES, GoalWeights, Problem
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.model import empty_model
from repro_torch.models.transformer import group_windows, num_prefix
from repro_torch.models.xlstm import SLSTMBlock

_CURVES = ("util_knee", "util_slope", "util_weight")


def from_reference(problem_arrays: dict, device=DEFAULT_DEVICE) -> Problem:
    """The port's ``Problem`` from the reference's fields as numpy arrays
    (the same dtypes: f32 values, i32 ids, bool masks)."""
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(Problem):
        if f.name == "weights":
            w = problem_arrays["weights"]
            fields["weights"] = GoalWeights(*(
                torch.tensor(np.float32(w[name]), device=dev) for name in GOAL_NAMES))
            continue
        value = problem_arrays.get(f.name)
        if value is None:
            if f.name not in _CURVES:
                raise KeyError(f"missing Problem field {f.name!r}")
            fields[f.name] = None
            continue
        fields[f.name] = torch.as_tensor(np.array(value), device=dev)
    return Problem(**fields)


def to_numpy(problem: Problem) -> dict:
    """The inverse of ``from_reference``: every field as a host array."""
    out = {}
    for f in dataclasses.fields(Problem):
        value = getattr(problem, f.name)
        if f.name == "weights":
            out["weights"] = {name: np.float32(getattr(value, name).item())
                              for name in GOAL_NAMES}
        elif value is not None:
            out[f.name] = value.detach().cpu().numpy()
    return out


_MLP = ("w_gate", "w_up", "w_down")
_MOE = ("router", "w_gate", "w_up", "w_down")
_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")
_MAMBA = ("norm", "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm",
          "out_proj")
_MLSTM = ("norm", "w_up", "w_gate_up", "conv_w", "conv_b", "wq", "wk", "wv", "w_if",
          "out_norm", "w_down")
_SLSTM = ("norm", "w_in", "r_z", "r_i", "r_f", "r_o", "out_norm")


def _norm_params(norm) -> dict:
    """A port norm's parameters in the reference's form: the rmsnorm
    weight array, {"scale", "bias"} for layernorm, None without params."""
    if norm.kind == "rmsnorm":
        return {"": norm.weight}
    if norm.kind == "layernorm":
        return {"scale": norm.weight, "bias": norm.bias}
    return {}


def _layer_tensors(block) -> dict:
    """(reference path) -> port tensor for one block; a norm's weight array
    is (name, "")."""
    out = {}
    for name in _NORMS:
        if hasattr(block, name):
            for key, t in _norm_params(getattr(block, name)).items():
                out[(name, key)] = t
    for name in block.attn.PARAMS:
        t = getattr(block.attn, name)
        if t is not None:
            out[("attn", name)] = t
    if block.is_moe:
        for name in _MOE:
            out[("moe", name)] = getattr(block.moe, name)
        if block.moe.shared is not None:
            for name in _MLP:
                out[("moe", "shared", name)] = getattr(block.moe.shared, name)
    else:
        for name in _MLP:
            out[("mlp", name)] = getattr(block.mlp, name)
    return out


def _get(tree, path):
    for key in path:
        if key == "":
            break
        tree = tree[key]
    return tree


def _put(t, value) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"shape {value.shape} does not fit {tuple(t.shape)}")
    t.data.copy_(torch.as_tensor(value.astype(np.float32)).to(t.dtype))


def _arr(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _shared_tensors(shared) -> dict:
    """(reference path under ``shared``) -> port tensor of Zamba2's block."""
    out = {(name, ""): getattr(shared, name) for name in ("in_proj", "ln1", "ln2", "out_proj")}
    for name in shared.attn.PARAMS:
        t = getattr(shared.attn, name)
        if t is not None:
            out[("attn", name)] = t
    for name in _MLP:
        out[("mlp", name)] = getattr(shared.mlp, name)
    return out


def _xlstm_tensors(layer) -> dict:
    """(reference path in the layer's dict) -> port tensor of an xLSTM block."""
    if isinstance(layer, SLSTMBlock):
        out = {(name,): getattr(layer, name) for name in _SLSTM}
        out.update({("ffn", name): getattr(layer.ffn, name) for name in _MLP})
        return out
    return {(name,): getattr(layer, name) for name in _MLSTM}


def lm_from_reference(cfg, params_np: dict, device=DEFAULT_DEVICE):
    """The port's model of ``cfg`` with the reference's weights (its params
    pytree, leaves as numpy arrays) on ``device``."""
    if cfg.family == "audio":
        raise ValueError("an audio config builds an Encoder: use encoder_from_reference")
    model = empty_model(cfg, device)
    if cfg.family == "hybrid":
        _put(model.embed, params_np["embed"])
        _put(model.final_norm, params_np["final_norm"])
        for i, layer in enumerate(model.layers):
            for name in _MAMBA:
                _put(getattr(layer, name), params_np["layers"][name][i])
        for path, t in _shared_tensors(model.shared).items():
            _put(t, _get(params_np["shared"], path))
        return model
    if cfg.family == "ssm":
        if len(params_np["layers"]) != len(model.layers):
            raise ValueError(f"{len(params_np['layers'])} layers for a model of "
                             f"{len(model.layers)}")
        _put(model.embed, params_np["embed"])
        _put(model.final_norm, params_np["final_norm"])
        for layer, tree in zip(model.layers, params_np["layers"]):
            for path, t in _xlstm_tensors(layer).items():
                _put(t, _get(tree, path))
        return model
    P = num_prefix(cfg)
    prefix = params_np.get("prefix", [])
    if len(prefix) != P:
        raise ValueError(f"{len(prefix)} prefix layers for a plan of {P}")
    groups = params_np["layers"]
    G = len(group_windows(cfg))
    if len(groups) != G:
        raise ValueError(f"{len(groups)} layer groups for a plan of {G}")
    _put(model.embed, params_np["embed"])
    _put_final_norm(model.final_norm, params_np["final_norm"])
    if model.lm_head is not None:
        _put(model.lm_head, params_np["lm_head"])
    for i, block in enumerate(model.blocks):
        for path, t in _layer_tensors(block).items():
            if i < P:
                _put(t, _get(prefix[i], path))
            else:
                _put(t, _get(groups[(i - P) % G], path)[(i - P) // G])
    return model


def _norm_tree(norm, values: dict):
    """A norm's parameters as the reference holds them, from ``values``
    keyed as ``_norm_params`` keys them."""
    if norm.kind == "rmsnorm":
        return values[""]
    if norm.kind == "layernorm":
        return {"scale": values["scale"], "bias": values["bias"]}
    return None


def _block_tree(blocks, stack: bool) -> dict:
    """The reference's tree of ``blocks``: each leaf stacked over them, or
    the one block's own."""
    per_layer = [_layer_tensors(b) for b in blocks]

    def leaf(path):
        values = [_arr(layer[path]) for layer in per_layer]
        return np.stack(values) if stack else values[0]

    tree = {}
    for name in _NORMS:
        if hasattr(blocks[0], name):
            norm = getattr(blocks[0], name)
            tree[name] = _norm_tree(norm, {key: leaf((name, key)) for key in _norm_params(norm)})
    for path in per_layer[0]:
        if path[0] not in _NORMS:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf(path)
    return tree


def _final_norm_numpy(norm):
    return _norm_tree(norm, {k: _arr(t) for k, t in _norm_params(norm).items()})


def _put_final_norm(norm, value) -> None:
    for key, t in _norm_params(norm).items():
        _put(t, value if key == "" else value[key])


def lm_to_numpy(model) -> dict:
    """The inverse of ``lm_from_reference``: the reference's params pytree
    with numpy leaves (the prefix's blocks unstacked, the rest stacked
    [(num_layers - P) / G, ...] in G groups; f32 for bf16 weights)."""
    if model.cfg.family == "hybrid":
        shared = {}
        for (sub, name), t in _shared_tensors(model.shared).items():
            if name == "":
                shared[sub] = _arr(t)
            else:
                shared.setdefault(sub, {})[name] = _arr(t)
        return {"embed": _arr(model.embed),
                "layers": {name: np.stack([_arr(getattr(layer, name)) for layer in model.layers])
                           for name in _MAMBA},
                "shared": shared,
                "final_norm": _arr(model.final_norm)}
    if model.cfg.family == "ssm":
        layers = []
        for layer in model.layers:
            tree: dict = {}
            for path, t in _xlstm_tensors(layer).items():
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = _arr(t)
            layers.append(tree)
        return {"embed": _arr(model.embed), "layers": layers,
                "final_norm": _arr(model.final_norm)}

    out = {"embed": _arr(model.embed), "final_norm": _final_norm_numpy(model.final_norm)}
    if model.lm_head is not None:
        out["lm_head"] = _arr(model.lm_head)
    P = num_prefix(model.cfg)
    if P:
        out["prefix"] = [_block_tree([b], stack=False) for b in model.blocks[:P]]
    G = len(group_windows(model.cfg))
    scanned = model.blocks[P:]
    # group j stacks scanned blocks j, G + j, 2 G + j, ...
    out["layers"] = [_block_tree(scanned[j::G], stack=True) for j in range(G)]
    return out


def encoder_from_reference(cfg, params_np: dict, device=DEFAULT_DEVICE):
    """The port's ``Encoder`` of ``cfg`` (family "audio") with the
    reference's weights (its params pytree, leaves as numpy arrays) on
    ``device``."""
    if cfg.family != "audio":
        raise ValueError(f"an encoder takes an audio config, got family {cfg.family!r}")
    model = empty_model(cfg, device)
    for name in ("pos_conv_w", "mask_embed", "head"):
        _put(getattr(model, name), params_np[name])
    _put_final_norm(model.final_norm, params_np["final_norm"])
    for i, block in enumerate(model.blocks):
        for path, t in _layer_tensors(block).items():
            _put(t, _get(params_np["layers"], path)[i])
    return model


def encoder_to_numpy(model) -> dict:
    """The inverse of ``encoder_from_reference``: the reference's params
    pytree with numpy leaves (f32 for bf16 weights)."""
    return {"pos_conv_w": _arr(model.pos_conv_w), "mask_embed": _arr(model.mask_embed),
            "layers": _block_tree(list(model.blocks), stack=True),
            "final_norm": _final_norm_numpy(model.final_norm), "head": _arr(model.head)}
