"""Convert between a flax ``params`` tree of numpy arrays (the JAX
package's GPT or Llama layout) and the port's ``state_dict`` naming and
layout.

The flax tree is either stacked (``--layer_scan auto``: one ``layers/layer``
subtree whose leaves carry a leading [num_layers] axis) or unrolled
(``layer0``, ``layer1``, ...).  Dense kernels are [in, out...] in flax and
``nn.Linear`` weights [out, in] here; ``DenseGeneral`` kernels flatten
their head axes (``qkv`` [hidden, 3, H, Dh] <-> [3*H*Dh, hidden], ``out``
[H, Dh, hidden] <-> [hidden, H*Dh]).  Both directions only transpose and
reshape, so a round trip is exact.

The family follows from the leaves present: GPT has LayerNorms (``ln1``,
``ln2``, ``ln_f``), a position table and FFN biases; Llama has RMSNorms
(``rms1``, ``rms2``, ``rms_f``), a SwiGLU ``ffn_up`` and an untied
``lm_head``, and no biases.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

# flax leaf name <-> port key suffix
_LN = {"scale": "weight", "bias": "bias"}
_DENSE = {"kernel": "weight", "bias": "bias"}
_NORMS = ("ln1", "ln2", "rms1", "rms2")
_FFN = ("ffn_in", "ffn_up", "ffn_out")


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
    return out


def _block_to_flax(sd: dict, prefix: str, num_heads: int,
                   num_kv_heads: int) -> dict:
    get = lambda k: sd[prefix + k]
    has = lambda k: prefix + k in sd
    block: dict = {norm: {leaf: get(f"{norm}.{key}")
                          for leaf, key in _LN.items() if has(f"{norm}.{key}")}
                   for norm in _NORMS if has(f"{norm}.weight")}
    attn: dict = {}
    hidden = get("attn.out.weight").shape[0]
    dh = hidden // num_heads
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
    return block


# top-level leaves: flax (module, leaf) <-> port key, where present
_TOP = {("tok_emb", "embedding"): "tok_emb.weight",
        ("pos_emb", "embedding"): "pos_emb.weight",
        ("ln_f", "scale"): "ln_f.weight", ("ln_f", "bias"): "ln_f.bias",
        ("rms_f", "scale"): "rms_f.weight",
        ("lm_head", "kernel"): "lm_head.weight"}


def flax_to_torch(params: dict) -> dict[str, np.ndarray]:
    """flax GPT or Llama ``params`` (stacked or unrolled) -> port
    ``state_dict`` entries as numpy arrays (hand to ``torch.as_tensor`` /
    ``load_state_dict``)."""
    params = _to_numpy(params)
    sd = {}
    for (module, leaf), key in _TOP.items():
        if leaf in params.get(module, {}):
            arr = params[module][leaf]
            sd[key] = arr.T if leaf == "kernel" else arr
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
                  num_kv_heads: int = 0, stacked: bool = True) -> dict:
    """Port ``state_dict`` (tensors or arrays) -> flax GPT or Llama
    ``params`` of numpy arrays, stacked (``layers/layer``) or unrolled
    (``layerN``)."""
    sd = {k: _as_numpy(v) for k, v in state_dict.items()}
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    blocks = [_block_to_flax(sd, f"blocks.{i}.", num_heads, num_kv_heads)
              for i in range(n)]
    params: dict = {}
    for (module, leaf), key in _TOP.items():
        if key in sd:
            arr = sd[key]
            params.setdefault(module, {})[leaf] = (
                arr.T if leaf == "kernel" else arr)
    if stacked:
        params["layers"] = {"layer": _stack(blocks)}
    else:
        params.update({f"layer{i}": b for i, b in enumerate(blocks)})
    return params


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
