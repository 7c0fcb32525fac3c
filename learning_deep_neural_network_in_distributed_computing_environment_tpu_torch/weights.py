"""Convert between flax variables of numpy arrays (the JAX package's GPT,
Llama, BERT, ViT and image-model layouts) and the port's ``state_dict``
naming and layout.

Image models (``enhanced_cnn``, ``resnet*``, ``lenet5``, ``mlp``;
``cnn_flax_to_torch`` / ``cnn_torch_to_flax``): the flax module path is
the torch key with ``.`` between modules.  Conv kernels are [kh, kw, cin,
cout] in flax and [cout, cin, kh, kw] here, Dense kernels [in, out] and
[out, in]; BatchNorm ``scale``/``bias`` are ``weight``/``bias``, and the
``batch_stats`` collection's ``mean``/``var`` are the ``running_mean`` /
``running_var`` buffers.

Transformers (``flax_to_torch`` / ``torch_to_flax``, ``params`` only): the
flax tree is either stacked (``--layer_scan auto``: one ``layers/layer``
subtree whose leaves carry a leading [num_layers] axis) or unrolled
(``layer0``, ``layer1``, ...).  Dense kernels are [in, out...] in flax and
``nn.Linear`` weights [out, in] here; ``DenseGeneral`` kernels flatten
their head axes (``qkv`` [hidden, 3, H, Dh] <-> [3*H*Dh, hidden], ``out``
[H, Dh, hidden] <-> [hidden, H*Dh]).  Both directions only transpose and
reshape, so a round trip is exact, for the image models too.

The whole train state (``state_to_jax_leaves`` / ``state_from_jax_leaves``)
goes by the key paths of the JAX package's checkpoints
(``jax.tree_util.keystr`` of its ``TrainState``, dict keys sorted as
``tree_flatten`` sorts them): ``.params[...]`` (transformers in the stacked
``layers/layer`` layout, ``--layer_scan auto``), ``.batch_stats[...]``,
optax Adam's ``.opt_state.count`` (int32) and ``.opt_state.mu[...]`` /
``.opt_state.nu[...]`` (each moment laid out like its parameter),
``.lr_epoch`` (int32) and ``.rng`` (uint32[2]).  These are one worker's
rows; the checkpoint adds the leading worker axis.

The transformer family follows from the leaves present: GPT has
LayerNorms (``ln1``, ``ln2``, ``ln_f``), a position table and FFN biases;
Llama has RMSNorms (``rms1``, ``rms2``, ``rms_f``), a SwiGLU ``ffn_up``
and an untied ``lm_head``, and no biases; BERT has post-LN blocks
(``ln_attn``, ``ln_ffn``), ``ln_emb`` and the MLM head (``mlm_dense``,
``mlm_ln``, ``mlm_decoder``); ViT has ``patch_embed`` (kernel [p*p*c, H]),
a ``pos_emb`` array [1, N, H] (a parameter of the model, not a table
module) and ``head``.  A Switch-MoE block has a ``moe`` subtree in place of
the FFN: ``gate`` (kernel [H, E] <-> weight [E, H]) and the expert stacks
``w1`` [E, H, F], ``b1`` [E, F], ``w2`` [E, F, H], ``b2`` [E, H], which keep
their layout.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np

# flax leaf name <-> port key suffix
_LN = {"scale": "weight", "bias": "bias"}
_DENSE = {"kernel": "weight", "bias": "bias"}
_NORMS = ("ln1", "ln2", "rms1", "rms2", "ln_attn", "ln_ffn")
_FFN = ("ffn_in", "ffn_up", "ffn_out")
_EXPERTS = ("w1", "b1", "w2", "b2")


def _block_to_torch(block: dict) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for norm in _NORMS:
        for leaf, key in _LN.items():
            if leaf in block.get(norm, {}):
                out[f"{norm}.{key}"] = block[norm][leaf]
    attn = block["attn"]
    for proj in ("qkv", "q", "kv"):
        if proj in attn:
            kern = attn[proj]["kernel"]
            out[f"attn.{proj}.weight"] = kern.reshape(kern.shape[0], -1).T
            if "bias" in attn[proj]:
                out[f"attn.{proj}.bias"] = attn[proj]["bias"].reshape(-1)
    kern = attn["out"]["kernel"]                     # [H, Dh, hidden]
    out["attn.out.weight"] = kern.reshape(-1, kern.shape[-1]).T
    if "out_bias" in attn:
        out["attn.out_bias"] = attn["out_bias"]
    for dense in _FFN:
        for leaf, key in _DENSE.items():
            if leaf in block.get(dense, {}):
                arr = block[dense][leaf]
                out[f"{dense}.{key}"] = arr.T if leaf == "kernel" else arr
    if "ffn_bias" in block:
        out["ffn_bias"] = block["ffn_bias"]
    if "moe" in block:
        moe = block["moe"]
        out["moe.gate.weight"] = moe["gate"]["kernel"].T
        for leaf in _EXPERTS:
            out[f"moe.{leaf}"] = moe[leaf]
    return out


def _block_to_flax(sd: dict, prefix: str, num_heads: int,
                   num_kv_heads: int, head_dim: int = 0) -> dict:
    get = lambda k: sd[prefix + k]
    has = lambda k: prefix + k in sd
    block: dict = {norm: {leaf: get(f"{norm}.{key}")
                          for leaf, key in _LN.items() if has(f"{norm}.{key}")}
                   for norm in _NORMS if has(f"{norm}.weight")}
    attn: dict = {}
    hidden = get("attn.out.weight").shape[0]
    # a tensor-parallel shard holds num_heads of the model's heads, each
    # of head_dim (hidden / all heads)
    dh = head_dim or hidden // num_heads
    heads = {"qkv": (3, num_heads, dh), "q": (num_heads, dh),
             "kv": (2, num_kv_heads or num_heads, dh)}
    for proj, shape in heads.items():
        if has(f"attn.{proj}.weight"):
            w = get(f"attn.{proj}.weight")
            attn[proj] = {"kernel": w.T.reshape(w.shape[1], *shape)}
            if has(f"attn.{proj}.bias"):
                attn[proj]["bias"] = get(f"attn.{proj}.bias").reshape(shape)
    attn["out"] = {"kernel": get("attn.out.weight").T.reshape(
        num_heads, dh, hidden)}
    if has("attn.out_bias"):
        attn["out_bias"] = get("attn.out_bias")
    block["attn"] = attn
    for dense in _FFN:
        if has(f"{dense}.weight"):
            block[dense] = {"kernel": get(f"{dense}.weight").T}
            if has(f"{dense}.bias"):
                block[dense]["bias"] = get(f"{dense}.bias")
    if has("ffn_bias"):
        block["ffn_bias"] = get("ffn_bias")
    if has("moe.gate.weight"):
        block["moe"] = {"gate": {"kernel": get("moe.gate.weight").T},
                        **{leaf: get(f"moe.{leaf}") for leaf in _EXPERTS}}
    return block


# top-level leaves: flax (module, leaf) <-> port key, where present
_TOP = {("tok_emb", "embedding"): "tok_emb.weight",
        ("pos_emb", "embedding"): "pos_emb.weight",
        ("ln_f", "scale"): "ln_f.weight", ("ln_f", "bias"): "ln_f.bias",
        ("rms_f", "scale"): "rms_f.weight",
        ("lm_head", "kernel"): "lm_head.weight",
        **{(m, leaf): f"{m}.{key}"
           for m in ("ln_emb", "mlm_ln") for leaf, key in _LN.items()},
        **{(m, leaf): f"{m}.{key}"
           for m in ("mlm_dense", "mlm_decoder", "patch_embed", "head")
           for leaf, key in _DENSE.items()}}
# ViT's position table: a bare [1, N, H] parameter (``models/vit.py:117``)
_VIT_POS = "pos_emb"


def flax_to_torch(params: dict) -> dict[str, np.ndarray]:
    """flax GPT, Llama, BERT or ViT ``params`` (stacked or unrolled) ->
    port ``state_dict`` entries as numpy arrays (hand to
    ``torch.as_tensor`` / ``load_state_dict``)."""
    params = _to_numpy(params)
    sd = {}
    for (module, leaf), key in _TOP.items():
        node = params.get(module, {})
        if isinstance(node, Mapping) and leaf in node:
            sd[key] = node[leaf].T if leaf == "kernel" else node[leaf]
    if not isinstance(params.get(_VIT_POS, {}), Mapping):
        sd[_VIT_POS] = params[_VIT_POS]
    if "layers" in params:
        stacked = params["layers"]["layer"]
        blocks = [_index(stacked, i) for i in range(_leading(stacked))]
    else:
        blocks = [params[f"layer{i}"] for i in range(_count_unrolled(params))]
    for i, block in enumerate(blocks):
        for key, arr in _block_to_torch(block).items():
            sd[f"blocks.{i}.{key}"] = arr
    return sd


def torch_to_flax(state_dict: dict, *, num_heads: int,
                  num_kv_heads: int = 0, stacked: bool = True,
                  head_dim: int = 0) -> dict:
    """Port ``state_dict`` (tensors or arrays) -> flax GPT, Llama, BERT or
    ViT ``params`` of numpy arrays, stacked (``layers/layer``) or unrolled
    (``layerN``).  ``head_dim`` (default hidden / ``num_heads``) is given
    for a tensor-parallel shard, whose ``num_heads`` are its own."""
    sd = {k: _as_numpy(v) for k, v in state_dict.items()}
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    blocks = [_block_to_flax(sd, f"blocks.{i}.", num_heads, num_kv_heads,
                             head_dim)
              for i in range(n)]
    params: dict = {}
    for (module, leaf), key in _TOP.items():
        if key in sd:
            arr = sd[key]
            params.setdefault(module, {})[leaf] = (
                arr.T if leaf == "kernel" else arr)
    if _VIT_POS in sd:
        params[_VIT_POS] = sd[_VIT_POS]
    if stacked:
        params["layers"] = {"layer": _stack(blocks)}
    else:
        params.update({f"layer{i}": b for i, b in enumerate(blocks)})
    return params


def cnn_flax_to_torch(variables: dict) -> dict[str, np.ndarray]:
    """flax image-model ``{"params": ..., "batch_stats": ...}`` (the
    second collection absent for models without BatchNorm) -> port
    ``state_dict`` entries as numpy arrays."""
    variables = _to_numpy(variables)
    sd = {}
    for path, arr in _leaves(variables["params"]):
        key, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            sd[f"{key}.weight"] = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                                   else arr.T)
        else:
            sd[f"{key}.{_LN[leaf]}"] = arr
    for path, arr in _leaves(variables.get("batch_stats", {})):
        sd[f"{'.'.join(path[:-1])}.running_{path[-1]}"] = arr
    return sd


def cnn_torch_to_flax(state_dict: dict) -> dict:
    """Port ``state_dict`` of an image model (tensors or arrays) -> flax
    ``{"params": ..., "batch_stats": ...}`` of numpy arrays (no
    ``batch_stats`` for a model without BatchNorm)."""
    variables: dict = {"params": {}}
    for key, value in state_dict.items():
        arr = _as_numpy(value)
        *modules, leaf = key.split(".")
        if leaf.startswith("running_"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            collection, name = "params", "bias"
        elif arr.ndim == 1:                     # BatchNorm weight
            collection, name = "params", "scale"
        else:
            collection, name = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = variables.setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = arr
    return variables


def _leaves(tree, path=()):
    """(path tuple, leaf) pairs of a nested mapping, depth first."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _as_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return _as_numpy(tree)


def _leading(tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _count_unrolled(params: dict) -> int:
    n = 0
    while f"layer{n}" in params:
        n += 1
    return n


# ----------------------------------------------------------------------
# The whole train state by JAX checkpoint key path
# ----------------------------------------------------------------------

_COLLECTION = re.compile(
    r"^\.(params|batch_stats|opt_state\.mu|opt_state\.nu|sync_residual)"
    r"((?:\['[^']*'\])+)$")
_SEGMENT = re.compile(r"\['([^']*)'\]")
SCALAR_KEYS = (".opt_state.count", ".lr_epoch", ".rng")


def state_layout(model) -> dict:
    """Which conversion a model's tensors take: the transformer families
    carry ``num_heads`` (and Llama ``num_kv_heads``), the image models
    neither."""
    if hasattr(model, "num_heads"):
        out = {"kind": "transformer", "num_heads": int(model.num_heads),
               "num_kv_heads": int(getattr(model, "num_kv_heads", 0) or 0)}
        if getattr(model, "tp", None) is not None:
            # a tensor-parallel shard: its own heads of the model's width
            out["head_dim"] = int(model.head_dim)
        return out
    return {"kind": "image"}


def _flax_collections(tensors: dict, layout: dict) -> dict:
    """Port tensors by ``state_dict`` name -> {"params": tree,
    "batch_stats": tree} of numpy arrays."""
    if layout["kind"] == "transformer":
        return {"params": torch_to_flax(
            tensors, num_heads=layout["num_heads"],
            num_kv_heads=layout["num_kv_heads"], stacked=True,
            head_dim=layout.get("head_dim", 0))}
    return cnn_torch_to_flax(tensors)


def _keyed(prefix: str, tree) -> list[tuple[str, np.ndarray]]:
    """(key path, leaf) in ``jax.tree_util`` flatten order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v, key = tree[k], f"{prefix}['{k}']"
        out.extend(_keyed(key, v) if isinstance(v, Mapping) else [(key, v)])
    return out


def state_to_jax_leaves(params: dict, buffers: dict, mu: dict, nu: dict,
                        count: int, lr_epoch: int, rng, layout: dict,
                        residual: dict | None = None,
                        round_opt: dict | None = None,
                        params_resident: dict | None = None,
                        residual_outer: dict | None = None
                        ) -> dict[str, np.ndarray]:
    """One worker's train state -> ``{JAX key path: numpy row}``, in the
    JAX package's flatten order.  ``params``/``buffers``/``mu``/``nu`` map
    ``state_dict`` names to tensors or arrays (host); ``rng`` is uint32[2];
    ``residual`` (like ``params``) becomes ``.sync_residual[...]``,
    ``round_opt`` ({bucket: {"mu", "nu"}}) ``.round_opt[...]``,
    ``params_resident`` ({bucket: row}; then ``params`` is empty)
    ``.params_resident[...]`` and ``residual_outer`` ({bucket: row}, the
    hierarchical sync's outer residual) ``.sync_residual_outer[...]``."""
    main = (_flax_collections({**params, **buffers}, layout)
            if params or buffers else {"params": {}})
    moments = [_flax_collections(m, layout)["params"] for m in (mu, nu)]
    leaves = dict(_keyed(".params", main["params"]))
    leaves.update(_keyed(".batch_stats", main.get("batch_stats", {})))
    leaves[".opt_state.count"] = np.asarray(count, np.int32)
    leaves.update(_keyed(".opt_state.mu", moments[0]))
    leaves.update(_keyed(".opt_state.nu", moments[1]))
    leaves[".lr_epoch"] = np.asarray(lr_epoch, np.int32)
    leaves[".rng"] = np.asarray(rng, np.uint32).reshape(2)
    if residual is not None:
        leaves.update(_keyed(".sync_residual",
                             _flax_collections(residual, layout)["params"]))
    if round_opt is not None:
        leaves.update(_keyed(".round_opt", round_opt))
    if params_resident is not None:
        leaves.update(_keyed(".params_resident", params_resident))
    if residual_outer is not None:
        leaves.update(_keyed(".sync_residual_outer", residual_outer))
    return leaves


def leaves_of_state_dict(state: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``TrainState`` as flax's ``to_state_dict`` nests it (what a
    legacy single-file checkpoint holds: ``{"params": tree, "opt_state":
    {"count", "mu", "nu"}, "lr_epoch", "rng", ...}``, absent fields None)
    -> ``{JAX key path: array}``, the keys ``state_to_jax_leaves``
    writes (``.params[...]``, ``.opt_state.count``, ``.opt_state.mu[...]``,
    ``.lr_epoch``, ...)."""
    out: dict[str, np.ndarray] = {}
    for field, value in state.items():
        if value is None:
            continue
        if field == "opt_state":
            for part, sub in value.items():
                if isinstance(sub, Mapping):
                    out.update(_keyed(f".opt_state.{part}", sub))
                else:
                    out[f".opt_state.{part}"] = np.asarray(sub)
        elif isinstance(value, Mapping):
            out.update(_keyed(f".{field}", value))
        else:
            out[f".{field}"] = np.asarray(value)
    return out


def _nest(pairs) -> dict:
    tree: dict = {}
    for segs, arr in pairs:
        node = tree
        for s in segs[:-1]:
            node = node.setdefault(s, {})
        node[segs[-1]] = arr
    return tree


def _trees(leaves: dict) -> dict[str, dict]:
    """``{JAX key path: array}`` -> nested trees by collection (``params``,
    ``batch_stats``, ``opt_state.mu``, ``opt_state.nu``)."""
    pairs: dict[str, list] = {}
    for key, arr in leaves.items():
        m = _COLLECTION.match(key)
        if m:
            pairs.setdefault(m.group(1), []).append(
                (_SEGMENT.findall(m.group(2)), arr))
    return {k: _nest(v) for k, v in pairs.items()}


def _to_port(params_tree: dict, stats: dict | None, layout: dict) -> dict:
    if layout["kind"] == "transformer":
        return flax_to_torch(params_tree)
    return cnn_flax_to_torch({"params": params_tree,
                              "batch_stats": stats or {}})


def params_from_jax_leaves(leaves: dict, layout: dict
                           ) -> dict[str, np.ndarray]:
    """The ``.params[...]`` rows of ``leaves`` -> port parameters by
    ``state_dict`` name (stacked or unrolled layer layout)."""
    return _to_port(_trees(leaves).get("params", {}), None, layout)


def state_from_jax_leaves(leaves: dict, layout: dict) -> dict:
    """``{JAX key path: numpy row}`` (stacked or unrolled layer layout) ->
    ``{"params", "buffers", "mu", "nu"}`` (``state_dict`` name -> numpy
    array) plus ``count``, ``lr_epoch`` and ``rng``.  Keys outside the
    TrainState's ``params``/``batch_stats``/``opt_state``/``lr_epoch``/
    ``rng`` are not read here."""
    trees = _trees(leaves)
    sd = _to_port(trees.get("params", {}), trees.get("batch_stats"), layout)
    return {"params": {k: v for k, v in sd.items() if ".running_" not in k},
            "buffers": {k: v for k, v in sd.items() if ".running_" in k},
            "mu": _to_port(trees.get("opt_state.mu", {}), None, layout),
            "nu": _to_port(trees.get("opt_state.nu", {}), None, layout),
            **({"sync_residual": _to_port(trees["sync_residual"], None,
                                          layout)}
               if "sync_residual" in trees else {}),
            "count": int(leaves[".opt_state.count"]),
            "lr_epoch": int(leaves[".lr_epoch"]),
            "rng": np.asarray(leaves[".rng"], np.uint32).reshape(2)}


def params_leaves(model) -> list:
    """[[path segments], shape, dtype] of every ``.params`` leaf of one
    worker (the manifest metadata's ``params_leaves``, JAX
    ``driver.py:176-186``)."""
    host = {n: p.detach().cpu() for n, p in model.named_parameters()}
    tree = _flax_collections(host, state_layout(model))["params"]
    return [[_SEGMENT.findall(key), [int(d) for d in arr.shape],
             str(arr.dtype)] for key, arr in _keyed("", tree)]


def _match_axes(local: np.ndarray, shape: tuple):
    """The dims permutation that lays a tensor of ``shape`` out as the
    flat index run ``local`` (None: as it is)."""
    n = len(shape)
    base = np.arange(local.size, dtype=local.dtype).reshape(shape)
    candidates = [None]
    if n >= 2:
        candidates += [tuple(reversed(range(n))), (2, 3, 1, 0)]
    for axes in candidates:
        if axes is not None and len(axes) != n:
            continue
        want = base if axes is None else base.transpose(axes)
        if np.array_equal(want.reshape(-1), local):
            return axes
    raise ValueError(f"no transpose of {shape} gives the flax layout")


def wire_layout(model) -> tuple[list, list]:
    """Where a model's parameters sit in the JAX package's flatten order
    (``comms.WireLayout``'s arguments): the ``(shape, dtype)`` of its flax
    ``params`` leaves in ``tree_flatten`` order, and ``(parameter index,
    axes)`` pieces in that order (each parameter, permuted by ``axes``,
    is one contiguous run of its leaf; a stacked leaf holds one per
    layer).  Found by converting each parameter's global element indices
    with the checkpoint conversion, so the packed vector is JAX's."""
    named = list(model.named_parameters())
    sizes = np.array([p.numel() for _n, p in named], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    if offsets[-1] >= 2 ** 31:
        raise ValueError("more than 2**31 parameter elements")
    index = {name: np.arange(offsets[i], offsets[i + 1], dtype=np.int32)
             .reshape(tuple(p.shape)) for i, (name, p) in enumerate(named)}
    tree = _flax_collections(index, state_layout(model))["params"]
    leaves, pieces = [], []
    for _key, arr in _keyed("", tree):
        dtype = named[int(np.searchsorted(offsets, arr.reshape(-1)[0],
                                          "right")) - 1][1].dtype
        leaves.append((tuple(arr.shape), dtype))
        flat, pos = arr.reshape(-1), 0
        while pos < flat.size:
            t = int(np.searchsorted(offsets, flat[pos], "right")) - 1
            run = flat[pos:pos + sizes[t]] - offsets[t]
            pieces.append((t, _match_axes(run, tuple(named[t][1].shape))))
            pos += int(sizes[t])
    if sorted(t for t, _a in pieces) != list(range(len(named))):
        raise ValueError("the flax layout does not cover every parameter "
                         "exactly once")
    return leaves, pieces


# ----------------------------------------------------------------------
# One rank's shard of the parameters on the rank grid (mesh.Grid)
# ----------------------------------------------------------------------

def jax_param_leaves(state_dict: dict, layout: dict) -> dict:
    """Port parameters (``state_dict`` names -> tensors or arrays) -> the
    JAX package's ``params`` leaves as numpy arrays, ``{key: array}`` in
    its flatten order (keys like ``['layers']['layer']['attn']['qkv']
    ['kernel']``: ``.params`` + key is the checkpoint's key path)."""
    tree = _flax_collections(
        {k: _as_numpy(v) for k, v in state_dict.items()}, layout)["params"]
    return dict(_keyed("", tree))


def param_leaf_shapes(model) -> dict:
    """{key: shape} of a model's ``params`` leaves in the JAX layout (what
    ``bert.tp_param_specs`` and ``fsdp.fsdp_param_specs`` read)."""
    leaves = jax_param_leaves(
        {n: np.empty(tuple(p.shape), np.float32)
         for n, p in model.named_parameters()}, state_layout(model))
    return {k: tuple(a.shape) for k, a in leaves.items()}


def shard_index(shape: tuple, spec: tuple, coords: dict) -> list:
    """The global index [[start, stop], ...] of the shard of a leaf of
    ``shape`` that the rank at ``coords`` ({axis: (index, size)}) holds
    under ``spec`` (one axis name or None per dimension)."""
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append([0, int(n)])
            continue
        i, k = coords.get(axis, (0, 1))
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} is not "
                             f"divisible by the {axis!r} axis size {k}")
        step = n // k
        out.append([i * step, (i + 1) * step])
    return out


def shard_params(params: dict, specs: dict, coords: dict) -> dict:
    """A full parameter tree ``{key: array}`` (JAX layout:
    ``jax_param_leaves``, or a JAX numpy tree flattened the same way) ->
    the shard of each leaf that the rank at ``coords`` ({axis: (index,
    size)}) holds under ``specs``."""
    out = {}
    for key, arr in params.items():
        index = shard_index(np.shape(arr), specs[key], coords)
        out[key] = arr[tuple(slice(a, b) for a, b in index)]
    return out


def join_shards(shards: list, specs: dict, axes: dict) -> dict:
    """The inverse of ``shard_params``: ``shards`` is a list of
    ``(coords, {key: array})``, one per rank of a worker's block (coords
    {axis: (index, size)}), ``axes`` {axis: size}; returns every leaf
    whole.  A replicated leaf is taken from the first shard holding it."""
    out = {}
    for key, spec in specs.items():
        arr0 = shards[0][1][key]
        shape = [n * (axes.get(spec[d], 1) if d < len(spec) and spec[d]
                      else 1) for d, n in enumerate(np.shape(arr0))]
        full = np.empty(shape, np.asarray(arr0).dtype)
        for coords, leaves in shards:
            index = shard_index(shape, spec, coords)
            full[tuple(slice(a, b) for a, b in index)] = leaves[key]
        out[key] = full
    return out
