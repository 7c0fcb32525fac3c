"""``--layer_scan auto|on|off`` in the port, held against the JAX package.

The port keeps one module per block whatever the flag says; the flag sets
the parameter layout every flat structure follows (``weights.state_layout``):
``off`` gives JAX's unrolled ``layer{i}`` subtrees, which flatten in sorted
order (``layer10`` before ``layer2``), where ``auto``/``on`` give one stacked
``layers/layer`` subtree.  Held here, on the CPU at small sizes:

(a) the ``.params`` leaves and their shapes under ``off`` against JAX's
    flatten of its ``scan_layers=False`` model;
(b) the sharded sync's bucket plan and wire bytes against JAX's;
(c) the grid's fsdp, model and expert specs against JAX's on the unrolled
    tree;
(d) a 2-rank gloo run of gpt_tiny under ``off`` with the int8 wire and
    error feedback against the JAX driver's ``off`` run from the same
    transplanted start; the same run under a dense fp32 sync is bitwise
    its ``auto`` twin, and under int8 it is not;
(e) checkpoints written under ``off`` crossing between the frameworks
    both ways, and a resume (or ``main serve``) across layouts refused
    with JAX's words;
(f) the JAX driver's refusals around the flag, with its words, exception
    types and order.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    checkpoint as J,
    comms as j_comms,
    train as j_train,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.driver import (
    train_global as j_train_global,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.bert import (
    tp_param_specs as j_tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.moe import (
    ep_param_specs as j_ep_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.fsdp import (
    fsdp_param_specs as j_fsdp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve.engine import (
    ServeEngine as JServeEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as C,
    comms,
    driver as t_driver,
    main as t_main,
    sync_harness,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel.shards import (
    grid_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
    LocalSGDEngine,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")

# name -> (registry model, Config fields, JAX model kwargs, input shape,
# classes, blocks); gpt12 has 12 blocks so that layer10 sorts before layer2
MODELS = {
    "gpt12": ("gpt_tiny", {}, dict(num_layers=12), (16,), 97, 12),
    "llama_gqa": ("llama_tiny", dict(num_kv_heads=2), dict(num_kv_heads=2),
                  (16,), 97, None),
    "vit": ("vit_tiny", {}, {}, (32, 32, 3), 10, None),
    "bert_moe": ("bert_tiny", dict(num_experts=2), dict(num_experts=2),
                 (16,), 97, None),
}


def _port_model(case: str, layer_scan: str = "off"):
    name, fields, _jkw, shape, ncls, blocks = MODELS[case]
    cfg = Config(model=name, device="cpu", layer_scan=layer_scan, **fields)
    return t_driver.build_model_for(cfg, ncls, CPU, shape, num_layers=blocks)


def _jax_params(case: str, scan_layers: bool = False):
    """JAX's ``params`` of the case's model, shapes only (no init run)."""
    name, _fields, jkw, shape, ncls, _blocks = MODELS[case]
    model = j_get_model(name, num_classes=ncls, scan_layers=scan_layers,
                        **jkw)
    x = (jnp.zeros((2, *shape), jnp.float32) if name.startswith("vit")
         else jnp.zeros((2, *shape), jnp.int32))
    return jax.eval_shape(lambda k: model.init(k, x, train=False),
                          jax.random.key(0))["params"]


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(spec_tree, params) -> dict:
    """A JAX PartitionSpec tree as {key: spec padded to the leaf's rank}."""
    shapes = {k: v.shape for k, v in _flat(params).items()}
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {jax.tree_util.keystr(k): tuple(
        list(s) + [None] * (len(shapes[jax.tree_util.keystr(k)]) - len(s)))
        for k, s in flat}


# ----------------------------------------------------------------------
# (a) the leaves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(MODELS))
def test_unrolled_leaves_are_jaxs_in_flatten_order(case):
    """``params_leaves`` and ``param_leaf_shapes`` under ``off``: JAX's
    unrolled flatten key for key and shape for shape, in order, with no
    ``layers`` subtree; under ``auto`` the stacked tree, as before."""
    model = _port_model(case)
    assert not weights.scan_layers(model)
    jflat = jax.tree_util.tree_flatten_with_path(_jax_params(case))[0]
    want = [[[str(k.key) for k in path], [int(d) for d in leaf.shape],
             str(np.dtype(leaf.dtype))] for path, leaf in jflat]
    assert weights.params_leaves(model) == want
    shapes = weights.param_leaf_shapes(model)
    assert list(shapes.items()) == [
        (jax.tree_util.keystr(p), tuple(leaf.shape)) for p, leaf in jflat]
    assert not any("['layers']" in k for k in shapes)
    if case == "gpt12":
        tops = [p[0] for p, _s, _d in weights.params_leaves(model)]
        order = list(dict.fromkeys(tops))
        assert order.index("layer10") < order.index("layer2")
    stacked = weights.param_leaf_shapes(_port_model(case, "auto"))
    assert list(stacked) == list(_flat(_jax_params(case, True)))


# ----------------------------------------------------------------------
# (b) the sync's buckets and wire bytes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes", [1 << 14, 1 << 16, 4 << 20])
@pytest.mark.parametrize("case", ["gpt12", "llama_gqa", "bert_moe"])
def test_unrolled_bucket_plan_and_wire_bytes_are_jaxs(case, bucket_bytes):
    """The port's wire layout under ``off`` buckets as JAX's
    ``bucket_plan`` buckets JAX's unrolled leaves, and hands the wire
    JAX's bytes; at small buckets the stacked plan differs."""
    model = _port_model(case)
    leaves, _pieces = weights.wire_layout(model)
    j_leaves = [jax.ShapeDtypeStruct(v.shape, v.dtype)
                for v in _flat(_jax_params(case)).values()]
    for n in (2, 3):
        got = comms.bucket_plan(leaves, n, bucket_bytes)
        want = j_comms.bucket_plan(j_leaves, n, bucket_bytes)
        assert [(b.padded, b.items) for b in got] == \
            [(b.padded, b.items) for b in want]
        for tdt, jdt in ((None, None), (torch.int8, jnp.int8)):
            assert comms.sync_wire_bytes(
                leaves, n, wire_dtype=tdt, bucket_bytes=bucket_bytes) == \
                j_comms.sync_wire_bytes(j_leaves, n, wire_dtype=jdt,
                                        bucket_bytes=bucket_bytes)
    stacked, _p = weights.wire_layout(_port_model(case, "auto"))
    if bucket_bytes == 1 << 14:
        assert len(comms.bucket_plan(stacked, 2, bucket_bytes)) != \
            len(comms.bucket_plan(leaves, 2, bucket_bytes))


@pytest.mark.parametrize("layer_scan", ["auto", "off"])
def test_lab_int8_wire_scales_each_jax_leaf(layer_scan):
    """The lab's simulated int8 wire (``comms.aggregate_sim``, ``--sim_workers``)
    encodes each worker's row of each JAX leaf with one scale, as JAX's
    does: a stacked leaf spans every layer's tensor (``weights.leaf_groups``).
    Two syncs with error feedback at N = 4 against JAX's ``aggregate_sim``
    on the JAX tree: within one step of the int8 grid of the leaf's row
    (test_torch_sim's bar), every leaf's decoded values on the grid of its
    own scale; a per-tensor scale under ``auto`` misses that grid."""
    model = t_driver.build_model_for(
        Config(model="gpt_tiny", device="cpu", layer_scan=layer_scan), 97, CPU)
    layout = weights.state_layout(model)
    names = [k for k, _p in model.named_parameters()]
    n, rng = 4, np.random.default_rng(5)
    rows = [{k: (p.detach().numpy() * (1 + 0.1 * rng.standard_normal(
        p.shape))).astype(np.float32) for k, p in model.named_parameters()}
        for _ in range(n)]
    groups = weights.leaf_groups(model)
    assert len(groups) == len(weights.params_leaves(model))
    assert any(len(g) == 2 for g in groups) == (layer_scan == "auto")
    kw = dict(how="equal", topology="ring", local_weight=0.5)

    def port(groups):
        xs = [torch.from_numpy(np.stack([r[k] for r in rows])) for k in names]
        res = [torch.zeros_like(x) for x in xs]
        for _ in range(2):
            xs, res = comms.aggregate_sim(xs, wire_dtype=torch.int8,
                                          residual=res, groups=groups, **kw)
        return [weights.jax_param_leaves(
            {k: x[w].numpy() for k, x in zip(names, xs)}, layout)
            for w in range(n)]

    tree = {k: np.stack([weights.jax_param_leaves(r, layout)[k]
                         for r in rows]) for k in
            weights.jax_param_leaves(rows[0], layout)}
    xj, rj = tree, {k: np.zeros_like(v) for k, v in tree.items()}
    for _ in range(2):
        xj, rj = jax.jit(lambda x, r: j_comms.aggregate_sim(
            x, wire_dtype=jnp.int8, residual=r, **kw))(xj, rj)
    got = port(groups)
    for k, want in xj.items():
        want = np.asarray(want)
        step = np.abs(tree[k]).reshape(n, -1).max(1) / 127.0
        for w in range(n):
            np.testing.assert_allclose(got[w][k], want[w], rtol=1e-5,
                                       atol=2 * step[w], err_msg=k)
    if layer_scan == "auto":
        alone = port(None)
        apart = sum(int((np.abs(alone[w][k] - np.asarray(v)[w]) > 1e-6)
                        .sum()) for k, v in xj.items() for w in range(n))
        close = sum(int((np.abs(got[w][k] - np.asarray(v)[w]) > 1e-6)
                        .sum()) for k, v in xj.items() for w in range(n))
        assert apart > 100 * max(close, 1), (apart, close)


# ----------------------------------------------------------------------
# (c) the grid's specs
# ----------------------------------------------------------------------

class _Axes:
    """The sizes of a grid's axes (what ``grid_specs`` reads)."""

    def __init__(self, **sizes):
        self.sizes = sizes

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)


@pytest.mark.parametrize("case,axes", [
    ("gpt12", dict(fsdp=2)), ("gpt12", dict(model=2)),
    ("llama_gqa", dict(model=2)), ("vit", dict(model=2)),
    ("bert_moe", dict(expert=2)), ("bert_moe", dict(fsdp=2)),
], ids=["gpt12-fsdp", "gpt12-model", "llama-model", "vit-model",
        "bert_moe-expert", "bert_moe-fsdp"])
def test_unrolled_grid_specs_are_jaxs(case, axes):
    """``grid_specs`` on the unrolled leaves gives JAX's
    ``fsdp_param_specs``, ``tp_param_specs`` and ``ep_param_specs`` on
    JAX's unrolled tree (the expert dimension leads, no layer dimension
    is claimed)."""
    model = _port_model(case)
    params = _jax_params(case)
    tok = MODELS[case][0].startswith("gpt")
    got = grid_specs(weights.param_leaf_shapes(model), _Axes(**axes),
                     shard_tok_emb=tok)
    if "fsdp" in axes:
        want = j_fsdp_param_specs(params, axis="fsdp", axis_size=2)
    elif "model" in axes:
        want = j_tp_param_specs(params, "model", shard_tok_emb=tok)
    else:
        want = j_ep_param_specs(params, "expert")
    assert got == _specs(want, params)
    axis = next(iter(axes))
    assert any(axis in s for s in got.values())
    if axis == "expert":
        assert all(s[0] == "expert" for k, s in got.items()
                   if "['moe']" in k and "gate" not in k)


# ----------------------------------------------------------------------
# (f) the refusals
# ----------------------------------------------------------------------

REFUSALS = {
    "pp_remat": dict(model="gpt_tiny", pp_remat=True, layer_scan="off"),
    "on_mlp": dict(model="mlp", dataset="mnist", layer_scan="on",
                   grad_accum=2),
    "off_pipe": dict(model="gpt_tiny", layer_scan="off",
                     mesh_shape="data=1,pipe=2",
                     remat_policy="everything"),
    "remat_off": dict(model="gpt_tiny", layer_scan="off",
                      remat_policy="dots_saveable"),
    "accum_mlp": dict(model="mlp", dataset="mnist", grad_accum=2),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_are_jaxs(devices, case):
    """Each refusal around ``--layer_scan`` (JAX ``driver.py:460-500``) is
    raised by both drivers with the same exception type and words; the
    cases that break two rules get the one JAX checks first."""
    kw = dict(dataset="synthetic_lm", epochs_global=1, epochs_local=1,
              batch_size=8, limit_train_samples=32, limit_eval_samples=8,
              compute_dtype="float32", probe_batches=1)
    kw.update(REFUSALS[case])
    axes = ({"data": 1, "pipe": 2} if "mesh_shape" in kw else {"data": 1})
    with pytest.raises(Exception) as jax_err:
        j_train_global(JConfig(**kw), progress=False,
                       mesh=build_mesh(axes, devices[:len(axes)]))
    with pytest.raises(Exception) as port_err:
        t_driver.train_global(Config(device="cpu", **kw), progress=False)
    assert type(port_err.value) is type(jax_err.value) is ValueError
    assert str(port_err.value) == str(jax_err.value)


# ----------------------------------------------------------------------
# (d) two ranks under the int8 wire with error feedback
# ----------------------------------------------------------------------

LR = 1e-4
RUN = dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=2,
           epochs_local=1, batch_size=4, limit_train_samples=48,
           limit_eval_samples=8, compute_dtype="float32", augment=False,
           aggregation_by="weights", seed=1, probe_batches=1, lr=LR,
           proportionality="uniform", sync_mode="sharded",
           sync_bucket_mb=1 / 64)
INT8 = dict(sync_dtype="int8", sync_compression="ef")
PROBE = [0.02, 0.02]
# port runs of one start: name -> extra flags
PORT_RUNS = {"int8_off": dict(INT8, layer_scan="off"),
             "int8_auto": dict(INT8, layer_scan="auto"),
             "dense_off": dict(sync_mode="dense", layer_scan="off"),
             "dense_auto": dict(sync_mode="dense", layer_scan="auto")}


def _jax_off_init() -> dict:
    """The JAX driver's seeded init of gpt_tiny under ``--layer_scan off``
    (unrolled, fp32), in the port's naming: the start every run takes."""
    ds = load_dataset(RUN["dataset"], limit_train=8, limit_test=8)[0]
    model = j_get_model(RUN["model"], num_classes=ds.num_classes,
                        dtype=jnp.float32, scan_layers=False)
    params = model.init(jax.random.key(RUN["seed"]),
                        jnp.zeros((RUN["batch_size"], ds.images.shape[1]),
                                  jnp.int32), train=False)["params"]
    return weights.flax_to_torch(params)


def _jax_int8_off(ckpt_dir: str) -> dict:
    """The JAX driver's ``--layer_scan off`` int8 EF run on 2 virtual
    devices (a process of its own), writing its checkpoints."""
    jax.config.update("jax_platforms", "cpu")
    res = j_train_global(
        JConfig(**{**RUN, **PORT_RUNS["int8_off"]}, checkpoint_dir=ckpt_dir,
                checkpoint_every=1),
        mesh=build_mesh({"data": 2}, jax.devices()[:2]),
        simulated_durations=PROBE, progress=False)
    return {"params": {k: np.asarray(v) for k, v in
                       _flat(res["variables"]["params"]).items()},
            "residual": {k: np.asarray(v)[0] for k, v in
                         _flat(res["state"].sync_residual).items()},
            "losses": res["global_train_losses"],
            "val": res["global_val_losses"]}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's four runs from one start of 2 ranks, the int8 off run
    writing a checkpoint; the JAX driver's int8 off run in a process
    beside them."""
    d = tmp_path_factory.mktemp("layer_scan")
    kw = dict(progress=False, simulated_durations=PROBE,
              initial_state_dict=_jax_off_init())
    ckpt = dict(checkpoint_dir=str(d / "port"), checkpoint_every=1)
    jobs = [(Config(device="cpu", log_level="WARNING", **{**RUN, **extra},
                    **(ckpt if name == "int8_off" else {})), kw)
            for name, extra in PORT_RUNS.items()]
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_run = pool.submit(_jax_int8_off, str(d / "jax"))
        with t_driver.SharedStart(2, jobs) as start:
            out = {name: start.run() for name in PORT_RUNS}
        out["jax"] = jax_run.result(timeout=600)
    out["dirs"] = {k: str(d / k) for k in ("port", "jax")}
    return out


def _leaves(res) -> dict:
    """A run's parameters as JAX ``params`` leaves of its own layout."""
    model = res["model"]
    return weights.jax_param_leaves(
        {k: v.detach() for k, v in model.named_parameters()},
        weights.state_layout(model))


def _residual(res) -> dict:
    """Rank 0's EF residual as JAX leaves of its run's layout."""
    model = res["model"]
    names = [n for n, _p in model.named_parameters()]
    return weights.jax_param_leaves(
        dict(zip(names, res["state"].sync_residual)),
        weights.state_layout(model))


def _within(got: dict, want: dict, bound: float, quantum: dict,
            step: dict | None = None) -> int:
    """test_torch_sync_engine's bar: every element within ``bound`` plus
    one wire quantum; returns how many lie beyond 1e-4, leaving out those
    exactly one ``step`` of their owned shard's int8 grid apart (a
    rounding tie x/s = k + 1/2 that the two frameworks break apart: XLA
    multiplies by the scale's reciprocal, the port divides)."""
    assert list(got) == list(want)
    beyond = 0
    for k, w in want.items():
        err = np.abs(np.asarray(got[k], np.float64) - w)
        assert (err <= bound + quantum[k]).all(), (k, float(err.max()))
        far = err > 1e-4
        if step is not None:
            far &= ~np.isclose(err, step[k], rtol=1e-5, atol=0.0)
        beyond += int(far.sum())
    return beyond


def test_int8_ef_off_matches_the_jax_driver(two_ranks):
    """Losses at rtol 1e-4, and rank 0's parameters and EF residual
    against the JAX driver's ``off`` run at test_torch_sync_engine's bar
    for the int8 wire: every element within 2 lr per Adam step plus one
    quantum of its bucket's encoding (the residual: its bucket's and n of
    its owned shard's), at most one in 1e4 beyond 1e-4 but for ties
    broken one grid step apart.  The ``auto`` run, whose int8 scales
    cover other groups of elements, lands off JAX's ``off`` numbers in
    many more elements."""
    j, mine = two_ranks["jax"], two_ranks["int8_off"]
    for key, jkey in (("global_train_losses", "losses"),
                      ("global_val_losses", "val")):
        np.testing.assert_allclose(mine[key], j[jkey], rtol=1e-4)
    keys = list(j["params"])
    bucket, owner = sync_harness.bucket_map(
        [j["params"][k].shape for k in keys], 2,
        int(RUN["sync_bucket_mb"] * (1 << 20)))
    values = [j["params"][k][None] for k in keys]
    q1 = {k: a[0] for k, a in zip(
        keys, sync_harness.wire_quanta(values, "int8", bucket))}
    q2 = {k: a[0] for k, a in zip(
        keys, sync_harness.wire_quanta(values, "int8", bucket, owner))}
    total = sum(v.size for v in j["params"].values())
    params = _within(_leaves(mine), j["params"],
                     2 * LR * int(mine["state"].opt.count), q1, q2)
    residual = _within(_residual(mine), j["residual"], 1e-6,
                       {k: q1[k] + 2 * q2[k] * (o == 0)
                        for k, o in zip(keys, owner)})
    assert params <= total * 1e-4 and residual <= total * 1e-4
    # the stacked run's parameters, in the unrolled layout
    auto = two_ranks["int8_auto"]["model"]
    off = weights.jax_param_leaves(
        {k: v.detach() for k, v in auto.named_parameters()},
        weights.state_layout(mine["model"]))
    apart = sum(int((np.abs(np.asarray(off[k]) - w) > 1e-6).sum())
                for k, w in j["params"].items())
    mine_apart = sum(int((np.abs(np.asarray(v) - j["params"][k]) > 1e-6)
                         .sum()) for k, v in _leaves(mine).items())
    assert apart > 10 * max(mine_apart, 10), (apart, mine_apart)


def test_dense_fp32_off_is_bitwise_auto_and_int8_is_not(two_ranks):
    """The dense fp32 sum is elementwise: ``off`` and ``auto`` give the
    same bits (metrics, checksums on both ranks, parameters).  The int8
    wire's scales follow the layout: they do not."""
    a, b = two_ranks["dense_off"], two_ranks["dense_auto"]
    assert a["global_train_losses"] == b["global_train_losses"]
    assert a["param_checksums"] == b["param_checksums"]
    assert len(set(a["param_checksums"])) == 1
    sa, sb = a["model"].state_dict(), b["model"].state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    i, k = two_ranks["int8_off"], two_ranks["int8_auto"]
    assert len(set(i["param_checksums"])) == 1
    assert i["param_checksums"] != k["param_checksums"]


# ----------------------------------------------------------------------
# (e) checkpoints under off, across frameworks and layouts
# ----------------------------------------------------------------------

def _row0(state) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(p): np.asarray(x)[0] for p, x in flat}


def _same(message: str, path: str) -> str:
    return message.replace(path, "<path>")


def test_off_checkpoints_cross_the_frameworks(two_ranks, devices):
    """The 2-worker ``off`` epochs (resident rows, int8 EF residual): JAX's
    ``off`` engine restores the port's, and the port JAX's (into a
    replicated template, through the resident re-layout), bit for bit;
    both manifests record ``scan_layers: false`` and the same unrolled
    ``params_leaves``."""
    dirs = two_ranks["dirs"]
    ppath = C.latest_checkpoint(dirs["port"])
    jpath = J.latest_checkpoint(dirs["jax"])
    pm, jm = (json.load(open(os.path.join(p, C.MANIFEST)))
              for p in (ppath, jpath))
    assert pm["leaves"] == jm["leaves"] and pm["metadata"] == jm["metadata"]
    assert pm["metadata"]["scan_layers"] is False
    assert pm["metadata"]["param_residency"] == "resident"
    names = [leaf[0][0] for leaf in pm["metadata"]["params_leaves"]]
    assert len(names) == 28 and "layers" not in names
    # JAX's off engine restores the port's epoch, every row bit for bit
    jcfg = JConfig(**{**RUN, **PORT_RUNS["int8_off"]})
    jengine = j_train.LocalSGDEngine(
        j_get_model("gpt_tiny", num_classes=1000, dtype=jnp.float32,
                    scan_layers=False),
        build_mesh({"data": 2}, devices[:2]), jcfg)
    jstate = jengine.init_state(jax.random.key(0),
                                np.zeros((4, 128), np.int32))
    restored, epoch = J.restore_checkpoint(
        ppath, jstate, params_template=jengine.params_template,
        bucket_bytes=jengine.sync_bucket_bytes)
    tree = J.host_tree(ppath)[0]
    got = _flat(restored)
    assert epoch == 2 and set(got) <= set(tree)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), tree[k], err_msg=k)
    # the port restores JAX's epoch into worker 1's replicated template
    cfg = Config(device="cpu", **{**RUN, **PORT_RUNS["int8_off"]})
    model = t_driver.build_model_for(cfg, 1000, CPU)
    engine = LocalSGDEngine(model, cfg, CPU)
    tmpl = dataclasses.replace(engine.checkpoint_state(engine.init_state()),
                               worker=1, n_workers=2)
    back, epoch = C.restore_checkpoint(
        jpath, tmpl, params_template=engine.params_template,
        bucket_bytes=engine.sync_bucket_bytes)
    assert epoch == 2
    row = {k: v[1] for k, v in J.host_tree(jpath)[0].items()}
    mine = C.jax_leaves(back)
    for k, v in mine.items():
        want = (two_ranks["jax"]["params"][k[len(".params"):]]
                if k.startswith(".params[") else row[k])
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert any(k.startswith(".sync_residual[") for k in mine)


def test_resident_epoch_refuses_the_other_layout_as_jax(two_ranks, devices):
    """JAX's ``off`` resident epoch (2 workers) restored into an ``auto``
    resident template: the buckets of the stacked plan do not tile the
    unrolled one's rows, and both frameworks refuse with JAX's words."""
    jpath = J.latest_checkpoint(two_ranks["dirs"]["jax"])
    jcfg = JConfig(**{**RUN, **INT8})
    jengine = j_train.LocalSGDEngine(
        j_get_model("gpt_tiny", num_classes=1000, dtype=jnp.float32,
                    scan_layers=True),
        build_mesh({"data": 2}, devices[:2]), jcfg)
    jstate = jengine.init_state(jax.random.key(0),
                                np.zeros((4, 128), np.int32))
    assert jstate.params_resident is not None
    with pytest.raises(ValueError) as j_err:
        J.restore_checkpoint(jpath, jstate,
                             params_template=jengine.params_template,
                             bucket_bytes=jengine.sync_bucket_bytes)
    cfg = Config(device="cpu", **{**RUN, **INT8})
    engine = LocalSGDEngine(t_driver.build_model_for(cfg, 1000, CPU), cfg,
                            CPU)
    state = engine.init_state()
    rows = comms.resident_from_tree(
        [p.detach().numpy() for p in engine.params], 2,
        template=engine.params_template,
        bucket_bytes=engine.sync_bucket_bytes)
    tmpl = dataclasses.replace(
        engine.checkpoint_state(state), n_workers=2, params={},
        params_resident={b: v[0] for b, v in rows.items()})
    with pytest.raises(ValueError) as p_err:
        C.restore_checkpoint(jpath, tmpl,
                             params_template=engine.params_template,
                             bucket_bytes=engine.sync_bucket_bytes)
    assert str(p_err.value) == str(j_err.value)
    assert "has shape" in str(p_err.value)


ONE = dict(dataset="synthetic_lm", epochs_global=1, epochs_local=1,
           batch_size=8, limit_train_samples=64, limit_eval_samples=16,
           compute_dtype="float32", augment=False, checkpoint_every=1,
           seed=3, model="gpt_tiny")


@pytest.fixture(scope="module")
def one_worker(tmp_path_factory):
    """One worker, replicated parameters: JAX and the port each write an
    ``off`` epoch; the port also writes an ``auto`` one."""
    d = tmp_path_factory.mktemp("one_worker")
    out = {"dirs": {k: str(d / k) for k in ("jax", "port", "auto")}}
    out["jax"] = j_train_global(
        JConfig(**ONE, layer_scan="off", num_workers=1,
                checkpoint_dir=out["dirs"]["jax"]), progress=False)
    for name, scan in (("port", "off"), ("auto", "auto")):
        out[name] = t_driver.train_global(
            Config(**ONE, layer_scan=scan, device="cpu",
                   checkpoint_dir=out["dirs"][name]), progress=False)
    return out


def test_replicated_off_checkpoints_cross_bitwise(one_worker):
    """JAX ``restore_checkpoint`` reads the port's ``off`` epoch into its
    own ``off`` state, and the port JAX's into an ``off`` engine, every
    leaf bit for bit; the manifests are alike."""
    jres, dirs = one_worker["jax"], one_worker["dirs"]
    ppath = J.latest_checkpoint(dirs["port"])
    port = one_worker["port"]
    engine = LocalSGDEngine(port["model"], Config(device="cpu"), CPU)
    want = C.jax_leaves(C.snapshot(engine.checkpoint_state(port["state"])))
    restored, epoch = J.restore_checkpoint(ppath, jres["state"])
    got = _row0(restored)
    assert epoch == 1 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = Config(device="cpu", **dict(ONE, checkpoint_every=0),
                 layer_scan="off")
    model = t_driver.build_model_for(cfg, 1000, CPU)
    engine = LocalSGDEngine(model, cfg, CPU)
    state = engine.init_state()
    back, _e = C.restore_checkpoint(J.latest_checkpoint(dirs["jax"]),
                                    engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, back)
    got = C.jax_leaves(C.snapshot(engine.checkpoint_state(state)))
    assert list(got) == list(_row0(jres["state"]))
    for k, v in _row0(jres["state"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    pm, jm = (json.load(open(os.path.join(J.latest_checkpoint(dirs[k]),
                                          C.MANIFEST)))
              for k in ("port", "jax"))
    assert pm["leaves"] == jm["leaves"] and pm["metadata"] == jm["metadata"]


@pytest.mark.parametrize("into", ["auto", "off"])
def test_a_resume_across_layouts_raises_jaxs_message(one_worker, into):
    """``--resume`` under the other layout: ``auto`` on an ``off``
    checkpoint (JAX's own), ``off`` on an ``auto`` one (the port's); both
    drivers raise JAX's restore-template refusal, word for word."""
    src = one_worker["dirs"]["jax" if into == "auto" else "auto"]
    kw = dict(ONE, layer_scan=into, resume=True, checkpoint_dir=src,
              epochs_global=2)
    with pytest.raises(ValueError, match="required by the restore "
                       r"template \(engine config mismatch\?\)") as j_err:
        j_train_global(JConfig(**kw, num_workers=1), progress=False)
    with pytest.raises(ValueError) as p_err:
        t_driver.train_global(Config(**kw, device="cpu"), progress=False)
    path = J.latest_checkpoint(src)
    assert _same(str(p_err.value), path) == _same(str(j_err.value), path)
    key = re.search(r"has no leaf (\S+)", str(p_err.value)).group(1)
    assert ("['layers']" in key) == (into == "auto")


def test_serve_refuses_an_unrolled_checkpoint_as_jax(one_worker):
    """``main serve`` on the port's own ``off`` checkpoint raises JAX's
    unrolled-layout refusal, as JAX's serve engine does on it."""
    d = one_worker["dirs"]["port"]
    with pytest.raises(ValueError) as j_err:
        JServeEngine.from_checkpoint(d, max_batch=2, page_size=4,
                                     max_pages=16, prompt_buckets=(8,),
                                     max_seq=12)
    with pytest.raises(ValueError) as p_err:
        t_main.run(["serve", "--checkpoint_dir", d, "--device", "cpu"])
    assert str(p_err.value) == str(j_err.value)
    assert "unrolled (non-layer-scan)" in str(p_err.value)
