"""PartitionSpec rules: params, optimizer state, batches, caches.

The PyTorch port of ``repro.distributed.sharding``.  The rules are the
reference's (``src/repro/distributed/sharding.py:25-323``), computed on the
port's own minimal ``Mesh``, ``PartitionSpec`` and ``NamedSharding``, which
hold axis names, sizes and specs only.  The port runs on one card, a
one-device mesh: placing anything there stays ``.to(device)``, and
``constrain`` is the identity, which is what the reference's constraint
amounts to on one device.

2D "megatron" layout on the ("data", "model") mesh, with an optional leading
"pod" axis that composes with "data" for batch/gradient parallelism:
  * column-parallel up-projections  (d_model -> hidden): shard out-dim
  * row-parallel   down-projections (hidden -> d_model): shard in-dim
  * embeddings / lm_head: vocab-sharded
  * MoE expert stacks: expert-parallel on axis 0 (the "model" axis)
  * everything else (norms, biases, scalars): replicated

Rules are *name-based* with a divisibility sanitizer: if a proposed sharded
dim is not divisible by the mesh axis size (e.g. kv-head counts smaller than
the model axis, odd vocab sizes), the axis is dropped for that dim.

Trees are ``distributed.tree`` trees; a leaf needs ``shape`` and ``ndim``
(a tensor, a numpy array).  Paths name a ``NamedTuple`` field ``".field"``,
as ``str`` of the reference's ``GetAttrKey`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import tree as T


def _canonical(entry):
    """A dim's entry as the reference's ``PartitionSpec`` stores it: a tuple
    of one axis is that axis, an empty tuple is None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """A tuple of mesh axis names (or tuples of them, or None) per dim."""

    def __new__(cls, *specs):
        return super().__new__(cls, (_canonical(s) for s in specs))


P = PartitionSpec


class Mesh:
    """Devices laid out on named axes (a numpy array of ``torch.device``s,
    or of anything, with one dim per axis name)."""

    def __init__(self, devices, axis_names: tuple):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} device dims for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def dp_axes(mesh: Mesh):
    """Batch-parallel axes: ("pod", "data") on multi-pod, else ("data",)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# Name-based rules: (names, core_rank, spec-for-the-core-dims).  A leaf may
# carry extra *leading* stack dims (scanned layer stacks, zamba's
# per-application out_proj stack); they are padded with None by rank, which
# makes the rules independent of whether a family stacks its layers.
_RULES: tuple[tuple[tuple[str, ...], int, tuple], ...] = (
    # MoE expert stacks [E, d, f] — expert-parallel on the model axis
    (("moe::w_gate", "moe::w_up", "moe::w_down"), 3, ("model", None, None)),
    # embeddings [V, d] — vocab-sharded
    (("embed",), 2, ("model", None)),
    # xlstm block-diagonal recurrent mats [H, Dh, Dh]
    (("r_z", "r_i", "r_f", "r_o"), 3, (None, "model", None)),
    # row-parallel (hidden -> d_model)
    (("wo", "w_down", "out_proj"), 2, ("model", None)),
    # column-parallel (d_model -> hidden)
    (("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "wk_up", "wv_up",
      "wkv_down", "w_gate_up", "w_in", "w_if", "wk_rope", "head", "lm_head",
      "conv_w", "pos_conv_w"), 2, (None, "model")),
    # replicated small projections
    (("router",), 2, (None, None)),
    # hidden-dim vectors (sharded with their producing projection)
    (("bq", "bk", "bv", "conv_b", "gate_norm"), 1, ("model",)),
    # per-head / d_model vectors and norms — replicated
    (("A_log", "D", "dt_bias", "kv_norm", "mask_embed", "norm", "ln1", "ln2",
      "ln1_post", "ln2_post", "final_norm", "out_norm", "scale", "bias",
      "ffn"), 1, (None,)),
)


def _match(path: str, last: str, names: tuple[str, ...]) -> bool:
    for name in names:
        if "::" in name:                 # context::leafname
            ctx, leafname = name.split("::")
            if ctx in path and last == leafname and "shared" not in path:
                return True
        elif last == name or (len(name) > 2 and name in last):
            return True
    return False


def param_spec(path_parts: tuple, leaf) -> PartitionSpec:
    path = "/".join(str(p) for p in path_parts)
    last = str(path_parts[-1]) if path_parts else ""
    ndim = leaf.ndim
    for names, core_rank, spec in _RULES:
        if _match(path, last, names):
            if ndim < core_rank:         # scalarized / degenerate leaf
                return P(*((None,) * ndim))
            lead = ndim - core_rank
            return P(*((None,) * lead + tuple(spec)))
    return P(*((None,) * ndim))


def sanitize(spec: PartitionSpec, shape: tuple, mesh: Mesh) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for i, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        total = int(np.prod([sizes[a] for a in axes]))
        if i < len(shape) and shape[i] % total == 0:
            out.append(axis)
        else:
            out.append(None)
    return P(*out)


def params_shardings(mesh: Mesh, params_shape) -> Any:
    """NamedShardings for a params tree (of tensors or arrays)."""
    def one(path, leaf):
        spec = sanitize(param_spec(path, leaf), tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)
    return T.map_with_path(one, params_shape)


def opt_state_shardings(mesh: Mesh, opt_shape, *, zero1: bool = False) -> Any:
    """Optimizer state mirrors the params tree (count is replicated).

    ``zero1``: additionally shard each moment tensor over the data axis
    (ZeRO-1): the largest still-unsharded dim that the data axis divides.
    """
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    data_size = sizes.get("data", 1)

    def one(path, leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, P())
        spec = sanitize(param_spec(path, leaf), tuple(leaf.shape), mesh)
        if zero1 and data_size > 1:
            entries = list(spec) + [None] * (leaf.ndim - len(spec))
            # shard the largest still-unsharded dim over "data"
            cands = [(leaf.shape[i], i) for i, a in enumerate(entries)
                     if a is None and leaf.shape[i] % data_size == 0]
            if cands:
                _, i = max(cands)
                entries[i] = "data"
                spec = P(*entries)
        return NamedSharding(mesh, spec)
    return T.map_with_path(one, opt_shape)


def batch_shardings(mesh: Mesh, batch_shape) -> Any:
    """Model inputs: batch dim over ("pod","data"), rest replicated."""
    dp = dp_axes(mesh)

    def one(leaf):
        spec = P(dp, *([None] * (leaf.ndim - 1)))
        return NamedSharding(mesh, sanitize(spec, tuple(leaf.shape), mesh))
    return T.tree_map(one, batch_shape)


def place_shard_batch(tree: Any, device=DEFAULT_DEVICE) -> Any:
    """The stacked shard batch ``tree`` (an object with a ``.to(device)``,
    such as a stacked ``Problem``, or a tensor) on ``device``, whole.  The
    reference shards its leading [S] axis over the ambient mesh's batch
    axes and leaves it untouched without one; on one card nothing is
    split."""
    return tree.to(resolve_device(device))


def cache_shardings(mesh: Mesh, cache_shape, *, kv_shard: str = "heads") -> Any:
    """KV/state caches: batch over dp axes, heads/feature over "model".

    Handles the layouts used by the models:
      [L, B, S, KV, D] stacked attention kv, [B, S, KV, D] unstacked,
      [B, S, lora] MLA, [L, B, H, P, N] mamba states, xlstm states, scalars.

    ``kv_shard``:
      "heads" — kv-head dim on "model" (baseline; silently replicates when
                the head count does not divide the axis),
      "seq"   — sequence dim on "model" (flash-decoding style),
      "auto"  — heads when the kv-head count divides the model axis, else seq.
    """
    dp = dp_axes(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model_size = sizes.get("model", 1)

    def one(path, leaf):
        path_s = T.leaf_name(path)
        nd = leaf.ndim
        if nd == 0:
            spec = P()
        elif "pos" in path_s:
            spec = P()
        else:
            # Identify the batch dim: stacked caches have it second.
            stacked = ("layers" in path_s or "mamba" in path_s
                       or "attn_k" in path_s or "attn_v" in path_s)
            spec_list: list = [None] * nd
            b_dim = 1 if (stacked and nd >= 2) else 0
            spec_list[b_dim] = dp
            # Shard the "model"-parallel dim where one exists.
            is_attn_kv = (("k" in path_s.split("/")[-1]
                           or "v" in path_s.split("/")[-1])
                          and nd >= 4 and "ssm" not in path_s
                          and "conv" not in path_s)
            if "c_kv" in path_s:
                spec_list[-1] = "model"              # MLA latent dim
            elif "k_pe" in path_s:
                pass                                 # tiny; replicate
            elif "ssm" in path_s and nd >= 3:
                spec_list[b_dim + 1] = "model"       # mamba heads
            elif is_attn_kv and (
                    kv_shard == "seq"
                    or (kv_shard == "auto"
                        and leaf.shape[nd - 2] % model_size != 0)):
                spec_list[b_dim + 1] = "model"       # sequence slice
            elif nd >= 4:
                spec_list[nd - 2] = "model"          # kv heads (baseline)
            spec = P(*spec_list)
        return NamedSharding(mesh, sanitize(spec, tuple(leaf.shape), mesh))
    return T.map_with_path(one, cache_shape)


def logits_sharding(mesh: Mesh, shape: Optional[tuple] = None,
                    ndim: int = 3) -> NamedSharding:
    dp = dp_axes(mesh)
    spec = P(dp, *([None] * (ndim - 2)), "model")
    if shape is not None:
        spec = sanitize(spec, shape, mesh)
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def constrain(x, dims: tuple):
    """The reference's in-model activation constraint (logical dims "dp",
    "dpm", "model" or None per dim) on the port, which runs on one card:
    ``x`` itself, as the reference's ``with_sharding_constraint`` amounts
    to without a mesh or on a one-device one."""
    return x
