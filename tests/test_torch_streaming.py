"""The streamed input pipeline of the port (``--stream_chunk_steps``;
``data.window_feed``, ``train.ChunkStager``, ``LocalSGDEngine.
round_streamed``, ``driver.chunk_feed``): the port's windows are JAX's
worker rows, a streamed round is bitwise the whole round (losses, epoch
metrics, parameters, BatchNorm statistics and Adam state; with
augmentation, with the flash path's plain versions, staged synchronously
and by the producer thread), streamed ``train_global`` matches JAX's
streamed run from the same initial parameters, the stager's error and
close paths, two gloo workers streamed against two whole-round workers,
and checkpoints with ``--resume`` under streaming."""

import functools
import operator
import threading

import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    train as j_train,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.data.partition import (
    window_feed as j_window_feed,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.driver import (
    train_global as j_train_global,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    train as t_train,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
    pack_window,
    window_feed,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


# ----------------------------------------------------------------------
# Windows
# ----------------------------------------------------------------------

def test_window_feed_rows_equal_jax():
    """Every worker's windows are that worker's row of JAX's stacked
    windows; an empty shard streams all-padding windows, a zero budget no
    window, and a ragged budget is refused by both."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(50, 4, 4, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    idxs = [rng.permutation(50)[:37], rng.permutation(50)[:11],
            np.array([], np.int64)]
    want = list(j_window_feed(images, labels, idxs, 5, 4, 8)(0))
    assert len(want) == 2
    for row, idx in enumerate(idxs):
        got = list(window_feed(images, labels, idx, 5, 4, 8)(1))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b[row])
    empty = list(window_feed(images, labels, idxs[2], 5, 4, 8)(0))
    assert all((m == 0).all() for _, _, m in empty)
    assert list(window_feed(images, labels, idxs[0], 5, 4, 0)(0)) == []
    assert list(j_window_feed(images, labels, idxs, 5, 4, 0)(0)) == []
    for feed in (window_feed, j_window_feed):
        with pytest.raises(ValueError, match="multiple of chunk_steps"):
            feed(images, labels, idxs if feed is j_window_feed else idxs[0],
                 5, 4, 10)


# ----------------------------------------------------------------------
# round_streamed against round
# ----------------------------------------------------------------------

CASES = {
    # the reference's CNN with on-device augmentation (draws per step)
    "cnn": dict(model="enhanced_cnn", model_width=8, dataset="cifar10",
                batch_size=4),
    # a transformer through the flash path's plain versions
    "gpt": dict(model="gpt_tiny", dataset="synthetic_lm",
                attention_impl="flash", compute_dtype="float32",
                batch_size=4),
}


def _engine(cfg, ds):
    model = t_driver.build_model_for(cfg, ds.num_classes, CPU,
                                     ds.images.shape[1:])
    engine = t_train.LocalSGDEngine(model, cfg, CPU)
    return engine, engine.init_state()


def _state_tensors(engine, state):
    ws = engine.checkpoint_state(state)
    return {k: v.detach().clone() for k, v in ws.tensors().items()}


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_round_streamed_is_bitwise_the_whole_round(case, prefetch):
    """37 train samples at batch 4 (10 steps, the last partly padding) in
    windows of 3 (12 steps: 2 padding steps), 2 local epochs, 10 val
    samples: the same batch losses and epoch metrics, and the same
    parameters, statistics and Adam state, bit for bit."""
    cfg = Config(device="cpu", epochs_local=2, stream_chunk_steps=3,
                 stream_prefetch=prefetch, seed=3, **CASES[case])
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, 0, 60, 4)
    rng = np.random.default_rng(1)
    tr, va = rng.permutation(60)[:37], rng.permutation(60)[:10]
    b = cfg.batch_size

    whole, w_state = _engine(cfg, ds)
    w_state, w_mx = whole.round(
        w_state, tuple(a[None] for a in pack_window(
            ds.images, ds.labels, tr, b, 0, 10)),
        tuple(a[None] for a in pack_window(ds.images, ds.labels, va, b, 0,
                                           3)))
    stream, s_state = _engine(cfg, ds)
    s_state, s_mx = stream.round_streamed(
        s_state, window_feed(ds.images, ds.labels, tr, b, 3, 12),
        window_feed(ds.images, ds.labels, va, b, 3, 3))

    assert s_mx["batch_losses"].shape == (1, 2, 12)
    np.testing.assert_array_equal(s_mx["batch_losses"][..., :10],
                                  w_mx["batch_losses"])
    assert not s_mx["batch_losses"][..., 10:].any()
    assert not s_mx["batch_mask"][..., 10:].any()
    for key in ("train_loss", "train_acc", "val_loss", "val_acc",
                "global_train_loss", "global_val_acc", "agg_grad_norm"):
        np.testing.assert_array_equal(s_mx[key], w_mx[key], err_msg=key)
    assert s_mx["train_steps"] == w_mx["train_steps"] == 20
    assert s_mx["val_steps"] == w_mx["val_steps"]
    got, want = _state_tensors(stream, s_state), _state_tensors(whole,
                                                                w_state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (s_state.opt.count, s_state.lr_epoch) == (w_state.opt.count, 2)
    assert not [t for t in threading.enumerate()
                if t.name == "chunk-stager"]


# ----------------------------------------------------------------------
# The stager's error and close paths
# ----------------------------------------------------------------------

def test_stager_reraises_a_generator_error_at_the_consumer():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("packing failed")

    stager = t_train.ChunkStager(gen(), lambda x: x * 10, depth=2)
    got = []
    with pytest.raises(RuntimeError, match="packing failed"):
        for item in stager:
            got.append(item)
    assert got == [10, 20]
    stager.close()
    assert not stager._t.is_alive()


def test_stager_close_mid_round_joins_and_drops_the_staged():
    staged = []

    def stage(i):
        staged.append(i)
        return torch.full((4,), float(i))

    stager = t_train.ChunkStager(iter(range(10**6)), stage, depth=2)
    it = iter(stager)
    assert float(next(it)[0]) == 0.0
    stager.close()
    assert not stager._t.is_alive()
    assert stager._q.empty()
    # bounded: the one taken, depth in the queue, one in the producer's
    # hand; nothing is staged once close() has begun
    assert len(staged) <= 4
    stager.close()                   # idempotent


def test_a_failing_step_closes_the_round_stager(monkeypatch):
    """The consumer bails mid-round: the error reaches the caller and no
    producer thread is left behind."""
    cfg = Config(device="cpu", epochs_local=1, stream_chunk_steps=1,
                 stream_prefetch=2, **CASES["gpt"])
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, 0, 24, 4)
    engine, state = _engine(cfg, ds)
    calls = []
    real = engine._train_step

    def flaky(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return real(*args)

    monkeypatch.setattr(engine, "_train_step", flaky)
    idx = np.arange(24)
    with pytest.raises(RuntimeError, match="step failed"):
        engine.round_streamed(
            state, window_feed(ds.images, ds.labels, idx, 4, 1, 6),
            window_feed(ds.images, ds.labels, idx, 4, 1, 6))
    assert not [t for t in threading.enumerate()
                if t.name == "chunk-stager" and t.is_alive()]


# ----------------------------------------------------------------------
# The driver: against JAX's streamed run, N=2, checkpoints
# ----------------------------------------------------------------------

def _mlp_kw(**over):
    return dict(model="mlp", dataset="mnist", epochs_global=2,
                epochs_local=2, batch_size=16, limit_train_samples=160,
                limit_eval_samples=32, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=1,
                probe_batches=1, **over)


@pytest.mark.parametrize("data_mode", ["balanced", "disbalanced"])
def test_streamed_train_global_matches_jax_streamed(devices, monkeypatch,
                                                    data_mode):
    """One worker, windows of 2 steps, from JAX's initial parameters with
    pinned walls: the reference metrics at rtol 1e-4 (fp32 both sides)."""
    kw = _mlp_kw(stream_chunk_steps=2, data_mode=data_mode)
    walls = dict(simulated_durations=[1.0],
                 simulated_round_durations=lambda e: np.ones(1))
    init = {}
    j_init_state = j_train.LocalSGDEngine.init_state

    def capture(self, key, sample):
        state = j_init_state(self, key, sample)
        init["params"] = self.rank0_variables(state)["params"]
        return state

    monkeypatch.setattr(j_train.LocalSGDEngine, "init_state", capture)
    j_res = j_train_global(JConfig(**kw),
                           mesh=build_mesh({"data": 1}, devices[:1]),
                           progress=False, **walls)
    t_build = t_driver.build_model_for

    def transplanted(cfg, num_classes, device, input_shape=None):
        model = t_build(cfg, num_classes, device, input_shape)
        model.load_state_dict({
            k: torch.from_numpy(np.array(v)) for k, v in
            weights.cnn_flax_to_torch({"params": init["params"]}).items()})
        return model

    monkeypatch.setattr(t_driver, "build_model_for", transplanted)
    res = t_driver.train_global(Config(device="cpu", **kw), progress=False,
                                **walls)
    assert res["shard_sizes"] == j_res["shard_sizes"]
    for key in ("global_train_losses", "global_val_losses",
                "global_train_accuracies", "global_val_accuracies",
                "worker_specific_train_losses", "all_epochs_losses"):
        got = np.asarray(res[key], np.float64)
        want = np.asarray(j_res[key], np.float64)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def _two_workers(cfg, kw):
    store = mesh.new_store_path()
    procs = mesh.spawn_workers(t_driver.train_rank, 2,
                               (store, 60.0, cfg, kw))
    try:
        res = t_driver.train_rank(0, 2, store, 60.0, cfg, kw)
        mesh.join_workers(procs, timeout_s=60.0)
    finally:
        mesh.stop_workers(procs)
        mesh.remove_store(store)
    return res


def test_two_gloo_workers_streamed_equal_whole_rounds():
    """Two worker processes, disbalanced, ring sync, pinned walls: the
    streamed run's losses and every rank's parameter checksum equal the
    whole-round run's."""
    walls = [[0.8, 0.4], [0.6, 0.6]]
    kw = dict(simulated_durations=[2.0, 0.5], progress=False,
              simulated_round_durations=functools.partial(operator.getitem,
                                                          walls))
    base = _mlp_kw(data_mode="disbalanced", topology="ring",
                   aggregation_type="weighted", local_weight=0.7)
    whole = _two_workers(Config(device="cpu", **base), kw)
    stream = _two_workers(Config(device="cpu", stream_chunk_steps=3,
                                 stream_prefetch=1, **base), kw)
    assert stream["all_workers_losses"] == whole["all_workers_losses"]
    assert stream["global_train_losses"] == whole["global_train_losses"]
    assert stream["param_checksums"] == whole["param_checksums"]
    assert len(set(whole["param_checksums"])) == 2   # weighted ring


def test_checkpoint_and_resume_under_streaming(tmp_path):
    """2 rounds saving every round, then --resume to 3, streamed and not:
    the same committed epochs and the same final state, bit for bit."""
    final = {}
    for mode, extra in (("whole", {}), ("stream", dict(
            stream_chunk_steps=2))):
        kw = dict(_mlp_kw(**extra), device="cpu", checkpoint_every=1,
                  checkpoint_dir=str(tmp_path / mode))
        t_driver.train_global(Config(**kw), progress=False,
                              simulated_durations=[1.0])
        res = t_driver.train_global(
            Config(**dict(kw, epochs_global=3, resume=True)),
            progress=False, simulated_durations=[1.0])
        assert [t["epoch"] for t in res["round_timings"]] == [2]
        engine = t_train.LocalSGDEngine(res["model"], Config(**kw), CPU)
        final[mode] = (_state_tensors(engine, res["state"]),
                       res["all_workers_losses"])
    (w, w_losses), (s, s_losses) = final["whole"], final["stream"]
    assert s_losses == w_losses
    for k in w:
        assert torch.equal(s[k], w[k]), k


@pytest.mark.parametrize("over,where", [
    (dict(sim_workers=4), "A.11"),
    (dict(sync_staleness=1), "stream_chunk_steps cannot combine")],
    ids=["sim_workers", "sync_staleness"])
def test_streaming_with_the_unported_tiers_stays_refused(over, where):
    """JAX refuses --stream_chunk_steps with --sim_workers and with
    --sync_staleness (config.py:764, :877); the port refuses the first as
    a tier it has not ported, the second with JAX's message."""
    with pytest.raises(ValueError, match="stream_chunk_steps"):
        JConfig(stream_chunk_steps=2, aggregation_by="weights", **over)
    with pytest.raises(ValueError, match=where):
        Config(stream_chunk_steps=2, aggregation_by="weights", **over)
    cfg = Config(stream_chunk_steps=2, stream_prefetch=0)
    assert (cfg.stream_chunk_steps, cfg.stream_prefetch) == (2, 0)
    for bad in (dict(stream_chunk_steps=-1), dict(stream_prefetch=-1)):
        with pytest.raises(ValueError, match="must be >= 0"):
            Config(**bad)
