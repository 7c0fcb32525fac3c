"""The port's checkpoint engine (``..._torch/checkpoint.py``) in the JAX
package's format 2, held against the JAX package itself.

- the engine contract, ported from ``tests/test_checkpoint.py``: round
  trip, async bitwise the blocking write, prune, crash fallback at both
  crash hooks, a corrupt same-size shard, a missing shard, dtype
  mismatch, the open-time sweep; and the refusals that name the ROADMAP
  queues of what is not ported;
- across frameworks: a checkpoint written by JAX ``train_global``
  (``gpt_tiny``, ``mlp``) and one with BatchNorm statistics written by JAX
  ``save_checkpoint`` restore into the port bit for bit; a checkpoint
  written by the port's ``train_global`` restores into JAX
  ``restore_checkpoint``, ``host_tree`` and ``ServeEngine.from_checkpoint``
  bit for bit, with the manifest JAX writes for the same config;
- two worker processes (gloo) write ``shard_0``/``shard_1`` and one
  manifest, which JAX ``host_tree`` merges.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    checkpoint as J,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    driver as j_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve.engine import (
    ServeEngine as JServeEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.train import (
    TrainState as JTrainState,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as C,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    main as t_main,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
    LocalSGDEngine,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# one config for both frameworks: JAX writes, the port writes, each reads
RUN = dict(dataset="synthetic_lm", epochs_global=1, epochs_local=1,
           batch_size=8, limit_train_samples=64, limit_eval_samples=16,
           compute_dtype="float32", augment=False, checkpoint_every=1,
           seed=3)
RUNS = {"gpt_tiny": dict(RUN, model="gpt_tiny"),
        "mlp": dict(RUN, model="mlp", dataset="mnist")}


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _engine_state(seed=0, name="gpt_tiny", **kw):
    """A tiny port model's engine and train state on the CPU, with the
    moments, count, clock and seed words off their init."""
    model = get_model(name, num_classes=97, **kw)
    model.init_parameters(torch.Generator().manual_seed(seed))
    engine = LocalSGDEngine(model, Config(model=name, device="cpu",
                                          seed=seed), torch.device("cpu"))
    state = engine.init_state()
    g = torch.Generator().manual_seed(seed + 100)
    for m in state.opt.mu + state.opt.nu:
        m.normal_(generator=g)
    state.opt.count, state.lr_epoch = 5 + seed, 2 + seed
    return engine, state


def _leaves(engine, state) -> dict:
    """The worker's JAX-layout leaves of ``state`` (host numpy)."""
    return C.jax_leaves(C.snapshot(engine.checkpoint_state(state)))


def _assert_leaves_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _restore(path, seed=9, **kw):
    engine, state = _engine_state(seed, **kw)
    restored, epoch = C.restore_checkpoint(path,
                                           engine.checkpoint_state(state))
    return engine, engine.load_checkpoint_state(state, restored), epoch


def _jax_row0(state) -> dict:
    """Row 0 of every leaf of a JAX TrainState, by key path."""
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(p): np.asarray(x)[0] for p, x in flat}


# ----------------------------------------------------------------------
# the engine contract (ported from tests/test_checkpoint.py)
# ----------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    engine, state = _engine_state(0)
    eng = C.CheckpointEngine(str(tmp_path), async_write=False)
    path = eng.save(engine.checkpoint_state(state), 3)
    assert os.path.isfile(os.path.join(path, C.MANIFEST))
    assert C.latest_checkpoint(str(tmp_path)) == path
    fresh, fstate, epoch = _restore(path)
    assert epoch == 3
    _assert_leaves_equal(_leaves(fresh, fstate), _leaves(engine, state))
    # the restored seed words drive the next round's generator
    assert list(fstate.rng) == list(state.rng)


def test_async_save_bitwise_equals_blocking(tmp_path):
    engine, state = _engine_state(2)
    da, db = str(tmp_path / "async"), str(tmp_path / "blocking")
    ea = C.CheckpointEngine(da, async_write=True)
    eb = C.CheckpointEngine(db, async_write=False)
    timing = {}
    ea.save(engine.checkpoint_state(state), 5, timing=timing)
    eb.save(engine.checkpoint_state(state), 5)
    ea.close()
    assert timing["ckpt_snapshot_ms"] > 0 and timing["ckpt_write_ms"] > 0
    raw = lambda d: open(os.path.join(d, "ckpt_5", "shard_0.msgpack"),
                         "rb").read()
    assert raw(da) == raw(db)
    assert ea.summary()["async"] and not eb.summary()["async"]
    assert ea.summary()["bytes_per_host"] == eb.summary()["bytes_per_host"]
    assert ea.summary()["bytes_per_host"] == sum(
        a.nbytes for a in _leaves(engine, state).values())
    f, fs, _ = _restore(C.latest_checkpoint(da))
    _assert_leaves_equal(_leaves(f, fs), _leaves(engine, state))


def test_prune_keeps_newest_committed(tmp_path):
    engine, state = _engine_state(0)
    eng = C.CheckpointEngine(str(tmp_path), keep=2, async_write=False)
    for e in range(1, 6):
        eng.save(engine.checkpoint_state(state), e)
    assert C.committed_epochs(str(tmp_path)) == [4, 5]
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("ckpt_")) == ["ckpt_4", "ckpt_5"]


class _Crash(Exception):
    pass


@pytest.mark.parametrize("point", ["mid_shard", "before_manifest"])
def test_crash_hooks_fall_back_to_previous_committed(tmp_path, monkeypatch,
                                                     point):
    """A crash at either hook leaves an unmanifested epoch: the listing
    falls back to the previous one, which restores, and the next engine
    open sweeps the debris."""
    engine, state = _engine_state(0)
    eng = C.CheckpointEngine(str(tmp_path), async_write=False)
    eng.save(engine.checkpoint_state(state), 1)

    def crash(code):
        raise _Crash(code)
    monkeypatch.setenv(C._CRASH_ENV, point)
    monkeypatch.setattr(C.os, "_exit", crash)
    with pytest.raises(_Crash):
        eng.save(engine.checkpoint_state(state), 2)
    monkeypatch.delenv(C._CRASH_ENV)
    d = tmp_path / "ckpt_2"
    assert not (d / C.MANIFEST).exists()
    assert (d / "shard_0.msgpack.tmp.0").exists() == (point == "mid_shard")
    assert (d / "shard_0.msgpack").exists() == (point == "before_manifest")
    assert C.committed_epochs(str(tmp_path)) == [1]
    latest = C.latest_checkpoint(str(tmp_path))
    assert latest.endswith("ckpt_1")
    f, fs, epoch = _restore(latest)
    assert epoch == 1
    _assert_leaves_equal(_leaves(f, fs), _leaves(engine, state))
    C.CheckpointEngine(str(tmp_path))            # open -> sweep
    assert not d.exists()


def test_corrupt_same_size_shard_falls_back(tmp_path):
    engine, state = _engine_state(0)
    eng = C.CheckpointEngine(str(tmp_path), async_write=False)
    eng.save(engine.checkpoint_state(state), 1)
    eng.save(engine.checkpoint_state(state), 2)
    sh = tmp_path / "ckpt_2" / "shard_0.msgpack"
    raw = bytearray(sh.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    sh.write_bytes(bytes(raw))
    assert C.committed_epochs(str(tmp_path)) == [1]
    assert C.latest_checkpoint(str(tmp_path)).endswith("ckpt_1")
    with pytest.raises(ValueError, match="corrupt"):
        C.host_tree(str(tmp_path / "ckpt_2"))


def test_missing_shard_falls_back(tmp_path):
    engine, state = _engine_state(0)
    eng = C.CheckpointEngine(str(tmp_path), async_write=False)
    eng.save(engine.checkpoint_state(state), 1)
    eng.save(engine.checkpoint_state(state), 2)
    os.remove(tmp_path / "ckpt_2" / "shard_0.msgpack")
    assert C.committed_epochs(str(tmp_path)) == [1]
    assert C.latest_checkpoint(str(tmp_path)).endswith("ckpt_1")


def test_dtype_mismatch_rejected(tmp_path):
    engine, state = _engine_state(0)
    path = C.CheckpointEngine(str(tmp_path), async_write=False).save(
        engine.checkpoint_state(state), 1)
    template = engine.checkpoint_state(state)
    bad = dataclasses.replace(template, mu={
        k: v.to(torch.bfloat16) for k, v in template.mu.items()})
    with pytest.raises(ValueError, match="dtype"):
        C.restore_checkpoint(path, bad)


def test_open_sweeps_stale_leftovers(tmp_path):
    engine, state = _engine_state(0)
    C.CheckpointEngine(str(tmp_path), async_write=False).save(
        engine.checkpoint_state(state), 1)
    os.makedirs(tmp_path / "ckpt_9")
    (tmp_path / "ckpt_9" / "shard_0.msgpack").write_bytes(b"junk")
    (tmp_path / "ckpt_4.msgpack.tmp.0").write_bytes(b"junk")
    (tmp_path / "ckpt_1" / "shard_0.msgpack.tmp.0").write_bytes(b"junk")
    C.CheckpointEngine(str(tmp_path), async_write=False)
    names = {n for root, _d, fs in os.walk(tmp_path)
             for n in fs + [os.path.basename(root)]}
    assert not any(".tmp." in n for n in names), names
    assert not (tmp_path / "ckpt_9").exists()
    assert C.committed_epochs(str(tmp_path)) == [1]


def _jax_bn_state(seed: int):
    """A worker-stacked JAX TrainState of enhanced_cnn (width 4) with
    BatchNorm statistics, its moments, count, clock and seed words off
    their init."""
    rng = np.random.default_rng(seed)
    src = get_model("enhanced_cnn", num_classes=10, width=4)
    src.init_parameters(torch.Generator().manual_seed(seed))
    for _name, buf in src.named_buffers():
        buf.copy_(torch.from_numpy(rng.random(buf.shape).astype(np.float32)))
    flax_vars = weights.cnn_torch_to_flax(src.state_dict())
    stack = lambda t: jax.tree.map(lambda a: np.asarray(a)[None], t)
    moment = lambda: jax.tree.map(
        lambda a: rng.normal(size=(1, *a.shape)).astype(np.float32),
        flax_vars["params"])
    return JTrainState(
        params=stack(flax_vars["params"]),
        batch_stats=stack(flax_vars["batch_stats"]),
        opt_state=optax.ScaleByAdamState(
            count=np.array([11], np.int32), mu=moment(), nu=moment()),
        lr_epoch=np.array([6], np.int32),
        rng=np.array([[123, 456]], np.uint32))


def _legacy_restores_and_resumes(tmp_path, jax_written):
    """JAX ``save_checkpoint_legacy`` files (format 1: one MessagePack of
    the whole TrainState) of gpt_tiny (a JAX run's state) and of a
    BatchNorm model restore into the port bit for bit; ``--resume`` from
    the gpt_tiny file, the newest epoch, trains exactly the remaining
    round; ``main serve`` refuses the file as JAX's serve does."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve import (
        engine as t_serve_engine,
    )
    res, _d = jax_written["gpt_tiny"]
    d = str(tmp_path / "gpt")
    path = J.save_checkpoint_legacy(d, res["state"], 1)
    assert C.latest_checkpoint(d) == path
    cfg = Config(device="cpu", checkpoint_dir=d, **RUNS["gpt_tiny"])
    model = t_driver.build_model_for(cfg, res["test"].num_classes,
                                     torch.device("cpu"))
    engine = LocalSGDEngine(model, cfg, torch.device("cpu"))
    state = engine.init_state()
    restored, epoch = C.restore_checkpoint(path,
                                           engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, restored)
    assert epoch == 1
    _assert_leaves_equal(_leaves(engine, state), _jax_row0(res["state"]))
    with pytest.raises(ValueError, match="legacy single-file checkpoint"):
        t_serve_engine.resolve_checkpoint(d)
    # BatchNorm statistics ride the legacy file too
    jstate = _jax_bn_state(1)
    bn_path = J.save_checkpoint_legacy(str(tmp_path / "bn"), jstate, 2)
    bn = LocalSGDEngine(get_model("enhanced_cnn", num_classes=10, width=4),
                        Config(device="cpu"), torch.device("cpu"))
    bn_state = bn.init_state()
    restored, epoch = C.restore_checkpoint(bn_path,
                                           bn.checkpoint_state(bn_state))
    bn_state = bn.load_checkpoint_state(bn_state, restored)
    assert epoch == 2
    _assert_leaves_equal(_leaves(bn, bn_state), _jax_row0(jstate))
    # a resume from the legacy epoch runs only the rounds after it
    resumed = t_driver.train_global(
        Config(device="cpu", checkpoint_dir=d,
               **dict(RUNS["gpt_tiny"], epochs_global=3, resume=True)),
        progress=False)
    assert [t["epoch"] for t in resumed["round_timings"]] == [1, 2]
    assert resumed["state"].lr_epoch == int(res["state"].lr_epoch[0]) + 2
    assert C.committed_epochs(d) == [1, 2, 3]


@pytest.mark.parametrize("case,where", [
    # the legacy single file restores now: the case checks that it does
    ("legacy", "A.9"),
    # round-optimizer leaves restore; this one is in the manifest but in
    # no shard
    ("round_opt", r"\.round_opt"),
    # slice checkpoints restore (tests/test_torch_hier_sync.py); a manifest
    # whose slice count does not divide its worker rows is refused
    ("slices", "records 2 slice"), ("workers", "worker")],
    ids=["legacy-A.9", "round_opt-missing-leaf", "slices-A.11",
         "workers-worker"])
def test_refusals_name_their_queue(tmp_path, jax_written, case, where):
    if case == "legacy":
        _legacy_restores_and_resumes(tmp_path, jax_written)
        return
    engine, state = _engine_state(0)
    meta = {"num_slices": 2} if case == "slices" else None
    path = C.CheckpointEngine(str(tmp_path), async_write=False,
                              metadata=meta).save(
        engine.checkpoint_state(state), 1)
    template = engine.checkpoint_state(state)
    if case == "round_opt":
        key = ".round_opt.mu['b0000']"
        mpath = os.path.join(path, C.MANIFEST)
        manifest = json.load(open(mpath))
        manifest["leaves"][key] = {"shape": [1, 4], "dtype": "float32",
                                   "bytes": 16}
        json.dump(manifest, open(mpath, "w"))
    if case == "round_opt":     # a run that tracks a round optimizer
        template = dataclasses.replace(template, round_opt={
            "b0000": {"mu": torch.zeros(4), "nu": torch.zeros(4)}})
    elif case == "workers":
        template = dataclasses.replace(template, n_workers=2)
    with pytest.raises(ValueError, match=where):
        C.restore_checkpoint(path, template)


def test_config_validation():
    with pytest.raises(ValueError, match="ckpt_keep"):
        Config(ckpt_keep=0)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Config(checkpoint_every=1)
    with pytest.raises(ValueError, match="resume"):
        Config(resume=True)


# ----------------------------------------------------------------------
# across frameworks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """{model: (JAX train_global results, checkpoint dir)} for RUNS."""
    out = {}
    for name, kw in RUNS.items():
        d = str(tmp_path_factory.mktemp(f"jax_{name}"))
        res = j_driver.train_global(JConfig(checkpoint_dir=d, num_workers=1,
                                            **kw),
                                    progress=False)
        out[name] = (res, d)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_jax_written_checkpoint_restores_into_the_port(jax_written, name):
    """Params, Adam count and moments (transposed like their kernels),
    lr_epoch and rng bit for bit as the JAX state holds them."""
    res, d = jax_written[name]
    kw = RUNS[name]
    cfg = Config(checkpoint_dir=d, device="cpu", **kw)
    model = t_driver.build_model_for(
        cfg, res["test"].num_classes, torch.device("cpu"),
        res["test"].images.shape[1:])
    engine = LocalSGDEngine(model, cfg, torch.device("cpu"))
    state = engine.init_state()
    restored, epoch = C.restore_checkpoint(C.latest_checkpoint(d),
                                           engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, restored)
    assert epoch == 1
    _assert_leaves_equal(_leaves(engine, state), _jax_row0(res["state"]))


def test_jax_written_batch_stats_restore_into_the_port(tmp_path):
    """A worker-stacked JAX TrainState with BatchNorm statistics, written
    by JAX ``save_checkpoint``: params, batch_stats, moments bit for bit."""
    jstate = _jax_bn_state(0)
    J.save_checkpoint(str(tmp_path), jstate, 2)
    model = get_model("enhanced_cnn", num_classes=10, width=4)
    engine = LocalSGDEngine(model, Config(device="cpu"), torch.device("cpu"))
    state = engine.init_state()
    restored, epoch = C.restore_checkpoint(
        C.latest_checkpoint(str(tmp_path)), engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, restored)
    assert epoch == 2
    _assert_leaves_equal(_leaves(engine, state), _jax_row0(jstate))
    assert any(k.startswith(".batch_stats") for k in _jax_row0(jstate))


@pytest.fixture(scope="module")
def port_written(tmp_path_factory):
    """{model: (port train_global results, checkpoint dir)} for RUNS."""
    out = {}
    for name, kw in RUNS.items():
        d = str(tmp_path_factory.mktemp(f"port_{name}"))
        res = t_driver.train_global(
            Config(checkpoint_dir=d, device="cpu", **kw), progress=False)
        out[name] = (res, d)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_port_written_checkpoint_restores_into_jax(port_written,
                                                   jax_written, name):
    """JAX ``restore_checkpoint`` and ``host_tree`` read the port's
    checkpoint bit for bit, and its manifest has the key, shape, dtype
    and metadata set JAX writes for the same config."""
    res, d = port_written[name]
    path = J.latest_checkpoint(d)
    engine = LocalSGDEngine(res["model"], Config(device="cpu"),
                            torch.device("cpu"))
    want = _leaves(engine, res["state"])
    tree, epoch = J.host_tree(path)
    assert epoch == 1
    _assert_leaves_equal({k: v[0] for k, v in tree.items()}, want)
    # restore into a JAX template of the same shapes (the JAX run's state)
    jres, jd = jax_written[name]
    restored, epoch = J.restore_checkpoint(path, jres["state"])
    _assert_leaves_equal(_jax_row0(restored), want)
    jm = json.load(open(os.path.join(J.latest_checkpoint(jd), C.MANIFEST)))
    pm = json.load(open(os.path.join(path, C.MANIFEST)))
    assert pm["leaves"] == jm["leaves"]
    assert pm["metadata"] == jm["metadata"]
    assert pm.keys() == jm.keys() and pm["format"] == 2
    assert res["checkpoint"]["saves"] == 1 and res["checkpoint"]["enabled"]
    assert res["round_timings"][0]["ckpt_write_ms"] > 0


def test_port_written_checkpoint_serves_in_jax(port_written):
    res, d = port_written["gpt_tiny"]
    eng = JServeEngine.from_checkpoint(d, max_batch=2, page_size=4,
                                       max_pages=16, prompt_buckets=(8,),
                                       max_seq=12)
    want = weights.torch_to_flax(res["model"].state_dict(), num_heads=4)
    got = jax.tree.map(np.asarray, eng.params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_port_resume_runs_only_the_remaining_rounds(tmp_path):
    kw = dict(RUNS["gpt_tiny"], checkpoint_dir=str(tmp_path), device="cpu")
    first = t_driver.train_global(Config(**dict(kw, epochs_global=2)),
                                  progress=False)
    for t in first["round_timings"]:
        assert t["ckpt_snapshot_ms"] > 0 and t["ckpt_write_ms"] > 0
    assert set(first["checkpoint"]) == {
        "enabled", "async", "layout", "keep", "saves", "bytes_per_host",
        "stall_ms_total", "write_ms_total"}
    second = t_driver.train_global(
        Config(**dict(kw, epochs_global=3, resume=True)), progress=False)
    assert [t["epoch"] for t in second["round_timings"]] == [2]
    assert C.committed_epochs(str(tmp_path)) == [1, 2, 3]
    assert second["state"].lr_epoch == 3
    none = t_driver.train_global(
        Config(**dict(RUNS["gpt_tiny"], device="cpu", checkpoint_every=0)),
        progress=False)
    assert none["checkpoint"] == {"enabled": False}
    assert none["round_timings"][0]["ckpt_snapshot_ms"] == 0.0


def test_two_workers_write_one_checkpoint_jax_merges(tmp_path):
    """Two worker processes of a gloo group: rank r writes shard_r with its
    row, one manifest commits both, and JAX ``host_tree`` merges them."""
    d = str(tmp_path / "ck")
    res = t_main.run([
        "--device", "cpu", "--num_workers", "2", "--model", "gpt_tiny",
        "--dataset", "synthetic_lm", "--epochs_global", "1",
        "--epochs_local", "1", "--batch_size", "8", "--limit_train_samples",
        "64", "--limit_eval_samples", "16", "--compute_dtype", "float32",
        "--checkpoint_dir", d, "--checkpoint_every", "1", "--seed", "3",
        "--out_dir", str(tmp_path / "plots")])
    path = J.latest_checkpoint(d)
    manifest = json.load(open(os.path.join(path, C.MANIFEST)))
    assert manifest["process_count"] == 2
    assert sorted(manifest["shards"]) == ["shard_0.msgpack",
                                          "shard_1.msgpack"]
    tree, _ = J.host_tree(path)
    assert all(v.shape[0] == 2 for v in tree.values())
    mine, _ = C.host_tree(path)
    _assert_leaves_equal(mine, tree)
    engine = LocalSGDEngine(res["model"], Config(device="cpu"),
                            torch.device("cpu"))
    _assert_leaves_equal({k: v[0] for k, v in tree.items()},
                         _leaves(engine, res["state"]))
    assert int(tree[".opt_state.count"][1]) > 0


# ----------------------------------------------------------------------
# the fast sync engines' state: .sync_residual and .round_opt
# ----------------------------------------------------------------------

def _mlp_sync_engine(placement="sharded", **over):
    """A one-worker mlp engine with an EF residual and a round optimizer
    (the two never arm together in a run; the template carries both)."""
    model = get_model("mlp", num_classes=10, hidden=16,
                      input_shape=(28, 28, 1))
    model.init_parameters(torch.Generator().manual_seed(0))
    cfg = Config(device="cpu", model="mlp", aggregation_by="gradients",
                 sync_mode="sharded", opt_placement=placement,
                 sync_bucket_mb=256 / 2**20, **over)
    engine = LocalSGDEngine(model, cfg, torch.device("cpu"))
    state = engine.init_state()
    g = torch.Generator().manual_seed(5)
    state.sync_residual = [torch.randn(p.shape, generator=g)
                           for p in engine.params]
    for b in state.round_opt.values():
        for m in b.values():
            m.copy_(torch.rand(m.shape, generator=g))
    return engine, state


def test_port_sync_state_restores_into_jax(tmp_path):
    """The port's ``.sync_residual`` (laid out like ``.params``) and
    ``.round_opt['b<i>']['mu'|'nu']`` rows, read by JAX ``host_tree`` and
    restored by JAX ``restore_checkpoint`` into a template of JAX's own
    structure, bit for bit; and back into the port."""
    engine, state = _mlp_sync_engine()
    path = C.CheckpointEngine(str(tmp_path), async_write=False).save(
        engine.checkpoint_state(state), 2)
    want = _leaves(engine, state)
    assert any(k.startswith(".sync_residual[") for k in want)
    assert ".round_opt['b0000']['mu']" in want and len(
        [k for k in want if k.startswith(".round_opt")]) > 2
    tree, _ = J.host_tree(path)
    _assert_leaves_equal({k: v[0] for k, v in tree.items()}, want)
    flax = weights.cnn_torch_to_flax(
        {n: p.detach().numpy() for n, p in engine.model.named_parameters()})
    stack = lambda t: jax.tree.map(lambda a: np.zeros((1, *np.shape(a)),
                                                      np.asarray(a).dtype), t)
    template = JTrainState(
        params=stack(flax["params"]), batch_stats={},
        opt_state=optax.ScaleByAdamState(count=np.zeros(1, np.int32),
                                         mu=stack(flax["params"]),
                                         nu=stack(flax["params"])),
        lr_epoch=np.zeros(1, np.int32), rng=np.zeros((1, 2), np.uint32),
        sync_residual=stack(flax["params"]),
        round_opt={b: {m: np.zeros((1, v.numel()), np.float32)
                       for m, v in ms.items()}
                   for b, ms in state.round_opt.items()})
    restored, epoch = J.restore_checkpoint(path, template)
    assert epoch == 2
    _assert_leaves_equal(_jax_row0(restored), want)
    fresh, fstate = _mlp_sync_engine()
    got, _ = C.restore_checkpoint(path, fresh.checkpoint_state(fstate))
    fstate = fresh.load_checkpoint_state(fstate, got)
    _assert_leaves_equal(_leaves(fresh, fstate), want)


@pytest.mark.parametrize("placement", ["sharded", "replicated"])
def test_jax_sync_state_restores_into_the_port(tmp_path, placement):
    """A 2-worker JAX TrainState with an EF residual and sharded round-
    optimizer rows, written by JAX ``save_checkpoint``: worker 1's
    residual and its rows (the sharded layout's row 1, or the whole
    vector for a replicated template) bit for bit."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
        comms as j_comms,
    )
    engine, state = _mlp_sync_engine(placement)
    rng = np.random.default_rng(1)
    flax = weights.cnn_torch_to_flax(
        {n: p.detach().numpy() for n, p in engine.model.named_parameters()})
    rows = lambda: jax.tree.map(
        lambda a: rng.normal(size=(2, *np.shape(a))).astype(np.float32),
        flax["params"])
    shapes = [jax.ShapeDtypeStruct(np.shape(a), np.float32)
              for a in jax.tree.leaves(flax["params"])]
    trk = j_comms.round_opt_init(shapes, 2, placement="sharded",
                                 bucket_bytes=256)
    trk = {b: {m: rng.random(np.shape(v)).astype(np.float32)
               for m, v in ms.items()} for b, ms in trk.items()}
    jstate = JTrainState(
        params=rows(), batch_stats={},
        opt_state=optax.ScaleByAdamState(count=np.array([4, 4], np.int32),
                                         mu=rows(), nu=rows()),
        lr_epoch=np.array([1, 1], np.int32),
        rng=np.array([[1, 2], [3, 4]], np.uint32), sync_residual=rows(),
        round_opt=trk)
    J.save_checkpoint(str(tmp_path), jstate, 3)
    # the port's worker 1 of 2, with its placement's round-optimizer rows
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        comms,
    )
    template = dataclasses.replace(
        engine.checkpoint_state(state), worker=1, n_workers=2,
        round_opt=comms.round_opt_init(
            engine.layout.leaves, 2, 1, placement=placement,
            bucket_bytes=256))
    restored, epoch = C.restore_checkpoint(C.latest_checkpoint(
        str(tmp_path)), template)
    assert epoch == 3
    want_res = weights.cnn_flax_to_torch({"params": jax.tree.map(
        lambda a: a[1], jstate.sync_residual)})
    for name, v in restored.residual.items():
        np.testing.assert_array_equal(v, want_res[name], err_msg=name)
    for b, ms in trk.items():
        for m, v in ms.items():
            want = v[1] if placement == "sharded" else v.reshape(-1)
            np.testing.assert_array_equal(restored.round_opt[b][m], want)


# ----------------------------------------------------------------------
# the scatter-resident parameters: .params_resident
# ----------------------------------------------------------------------

BUCKET = 256          # bytes: several buckets for the 16-wide mlp


def _mlp_flax(engine):
    return weights.cnn_torch_to_flax(
        {n: p.detach().numpy() for n, p in engine.model.named_parameters()})


@pytest.mark.parametrize("into", ["resident", "replicated"])
def test_jax_resident_checkpoint_restores_into_the_port(tmp_path, into):
    """A 2-worker JAX TrainState with ``params=None`` and
    ``.params_resident`` rows (``comms.resident_from_tree`` of a consensus
    tree), written by JAX ``save_checkpoint``: a resident port template
    of worker 1 gets row 1 of every bucket, a replicated one the whole
    consensus in its own layout, bit for bit."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
        comms as j_comms,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        comms,
    )
    engine, state = _mlp_sync_engine()
    rng = np.random.default_rng(4)
    consensus = jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32),
        _mlp_flax(engine)["params"])
    resident = j_comms.resident_from_tree(consensus, 2, bucket_bytes=BUCKET)
    rows = lambda: jax.tree.map(
        lambda a: rng.normal(size=(2, *np.shape(a))).astype(np.float32),
        consensus)
    jstate = JTrainState(
        params=None, batch_stats={},
        opt_state=optax.ScaleByAdamState(count=np.array([4, 4], np.int32),
                                         mu=rows(), nu=rows()),
        lr_epoch=np.array([1, 1], np.int32),
        rng=np.array([[1, 2], [3, 4]], np.uint32),
        params_resident=resident)
    J.save_checkpoint(str(tmp_path), jstate, 3)
    template = dataclasses.replace(
        engine.checkpoint_state(state), worker=1, n_workers=2,
        round_opt=None, residual=None)
    if into == "resident":
        template = dataclasses.replace(template, params={}, params_resident={
            b: torch.zeros(v.shape[1]) for b, v in resident.items()})
    restored, epoch = C.restore_checkpoint(
        C.latest_checkpoint(str(tmp_path)), template,
        params_template=engine.params_template, bucket_bytes=BUCKET)
    assert epoch == 3
    if into == "resident":
        assert restored.params == {}
        for b, v in resident.items():
            np.testing.assert_array_equal(restored.params_resident[b], v[1])
    else:
        assert restored.params_resident is None
        want = weights.cnn_flax_to_torch({"params": consensus})
        for name, v in restored.params.items():
            np.testing.assert_array_equal(v, want[name], err_msg=name)
        # the host gather is the JAX one, bit for bit
        got = comms.resident_to_tree(
            resident, template=engine.params_template, bucket_bytes=BUCKET)
        for name, v in zip(engine.params_template.names, got):
            np.testing.assert_array_equal(v, want[name], err_msg=name)


@pytest.mark.parametrize("into", ["resident", "replicated"])
def test_port_resident_checkpoint_restores_into_jax(tmp_path, into):
    """The port's resident save (``.params_resident`` rows, no
    ``.params``; the buddy rows never saved) restores into a JAX resident
    template bit for bit, and into a replicated JAX template as the
    consensus tree; and back into the port."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        comms,
    )
    engine, state = _mlp_sync_engine()
    rows = comms.resident_from_tree(
        [p.detach() for p in engine.params], 1,
        template=engine.params_template, bucket_bytes=BUCKET)
    ws = dataclasses.replace(
        engine.checkpoint_state(state), params={}, round_opt=None,
        residual=None, params_resident={
            b: torch.from_numpy(v[0]) for b, v in rows.items()})
    path = C.CheckpointEngine(
        str(tmp_path), async_write=False,
        metadata={"sync_bucket_mb": BUCKET / 2**20}).save(ws, 2)
    tree, _ = J.host_tree(path)
    assert not any(k.startswith(".params[") for k in tree)
    assert not any("buddy" in k for k in tree)
    for b, v in rows.items():
        np.testing.assert_array_equal(tree[f".params_resident['{b}']"], v)
    flax = _mlp_flax(engine)
    stack = lambda t: jax.tree.map(lambda a: np.zeros((1, *np.shape(a)),
                                                      np.asarray(a).dtype), t)
    opt = optax.ScaleByAdamState(count=np.zeros(1, np.int32),
                                 mu=stack(flax["params"]),
                                 nu=stack(flax["params"]))
    common = dict(batch_stats={}, opt_state=opt,
                  lr_epoch=np.zeros(1, np.int32),
                  rng=np.zeros((1, 2), np.uint32))
    if into == "resident":
        template = JTrainState(params=None, params_resident={
            b: np.zeros_like(v) for b, v in rows.items()}, **common)
    else:
        template = JTrainState(params=stack(flax["params"]), **common)
    restored, epoch = J.restore_checkpoint(path, template)
    assert epoch == 2
    if into == "resident":
        for b, v in rows.items():
            np.testing.assert_array_equal(restored.params_resident[b], v)
    else:
        want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                jax.tree_util.tree_flatten_with_path(flax["params"])[0]}
        got = {jax.tree_util.keystr(p): np.asarray(a)[0] for p, a in
               jax.tree_util.tree_flatten_with_path(restored.params)[0]}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back, _ = C.restore_checkpoint(path, ws,
                                   params_template=engine.params_template)
    for b, v in rows.items():
        np.testing.assert_array_equal(back.params_resident[b], v[0])


def test_resident_checkpoint_serves_its_consensus(tmp_path):
    """``main serve``'s loader takes a resident checkpoint's rows as the
    consensus parameters (JAX ``load_params_resident``): the same tensors
    as the replicated save of the same model."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        comms,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve.engine import (
        load_params_row0,
    )
    engine, state = _engine_state(3)
    template = comms.ParamsTemplate.of(
        engine.names, engine.params,
        comms.WireLayout(*weights.wire_layout(engine.model)))
    rows = comms.resident_from_tree([p.detach() for p in engine.params], 1,
                                    template=template, bucket_bytes=BUCKET)
    ws = dataclasses.replace(engine.checkpoint_state(state), params={},
                             params_resident={b: torch.from_numpy(v[0])
                                              for b, v in rows.items()})
    path = C.CheckpointEngine(
        str(tmp_path), async_write=False,
        metadata={"sync_bucket_mb": BUCKET / 2**20}).save(ws, 1)
    served, _ = _engine_state(8)
    load_params_row0(path, served.model)
    want = dict(engine.model.named_parameters())
    for name, p in served.model.named_parameters():
        assert torch.equal(p, want[name]), name
