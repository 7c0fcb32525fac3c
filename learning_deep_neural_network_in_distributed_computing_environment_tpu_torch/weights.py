"""Convert between a flax ``params`` tree of numpy arrays (the JAX
package's GPT layout) and the port's ``state_dict`` naming and layout.

The flax tree is either stacked (``--layer_scan auto``: one ``layers/layer``
subtree whose leaves carry a leading [num_layers] axis) or unrolled
(``layer0``, ``layer1``, ...).  Dense kernels are [in, out...] in flax and
``nn.Linear`` weights [out, in] here; ``DenseGeneral`` kernels flatten
their head axes (``qkv`` [hidden, 3, H, Dh] <-> [3*H*Dh, hidden], ``out``
[H, Dh, hidden] <-> [hidden, H*Dh]).  Both directions only transpose and
reshape, so a round trip is exact.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

# flax leaf (module path, leaf name) <-> port key suffix, per block
_LN = {"scale": "weight", "bias": "bias"}
_DENSE = {"kernel": "weight", "bias": "bias"}


def _block_to_torch(block: dict) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for ln in ("ln1", "ln2"):
        for leaf, key in _LN.items():
            out[f"{ln}.{key}"] = block[ln][leaf]
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
    for dense in ("ffn_in", "ffn_out"):
        for leaf, key in _DENSE.items():
            if leaf in block[dense]:
                arr = block[dense][leaf]
                out[f"{dense}.{key}"] = arr.T if leaf == "kernel" else arr
    out["ffn_bias"] = block["ffn_bias"]
    return out


def _block_to_flax(sd: dict, prefix: str, num_heads: int,
                   num_kv_heads: int) -> dict:
    get = lambda k: sd[prefix + k]
    block: dict = {ln: {leaf: get(f"{ln}.{key}") for leaf, key in _LN.items()}
                   for ln in ("ln1", "ln2")}
    attn: dict = {}
    hidden = get("ln1.weight").shape[0]
    dh = hidden // num_heads
    heads = {"qkv": (3, num_heads, dh), "q": (num_heads, dh),
             "kv": (2, num_kv_heads or num_heads, dh)}
    for proj, shape in heads.items():
        if prefix + f"attn.{proj}.weight" in sd:
            w = get(f"attn.{proj}.weight")
            attn[proj] = {"kernel": w.T.reshape(w.shape[1], *shape)}
            if prefix + f"attn.{proj}.bias" in sd:
                attn[proj]["bias"] = get(f"attn.{proj}.bias").reshape(shape)
    attn["out"] = {"kernel": get("attn.out.weight").T.reshape(
        num_heads, dh, hidden)}
    if prefix + "attn.out_bias" in sd:
        attn["out_bias"] = get("attn.out_bias")
    block["attn"] = attn
    block["ffn_in"] = {"kernel": get("ffn_in.weight").T,
                       "bias": get("ffn_in.bias")}
    block["ffn_out"] = {"kernel": get("ffn_out.weight").T}
    block["ffn_bias"] = get("ffn_bias")
    return block


def flax_to_torch(params: dict) -> dict[str, np.ndarray]:
    """flax GPT ``params`` (stacked or unrolled) -> port ``state_dict``
    entries as numpy arrays (hand to ``torch.as_tensor`` /
    ``load_state_dict``)."""
    params = _to_numpy(params)
    sd = {"tok_emb.weight": params["tok_emb"]["embedding"],
          "pos_emb.weight": params["pos_emb"]["embedding"],
          "ln_f.weight": params["ln_f"]["scale"],
          "ln_f.bias": params["ln_f"]["bias"]}
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
    """Port ``state_dict`` (tensors or arrays) -> flax GPT ``params`` of
    numpy arrays, stacked (``layers/layer``) or unrolled (``layerN``)."""
    sd = {k: _as_numpy(v) for k, v in state_dict.items()}
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    blocks = [_block_to_flax(sd, f"blocks.{i}.", num_heads, num_kv_heads)
              for i in range(n)]
    params = {"tok_emb": {"embedding": sd["tok_emb.weight"]},
              "pos_emb": {"embedding": sd["pos_emb.weight"]},
              "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]}}
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
