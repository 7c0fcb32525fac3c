"""Sequence parallelism through the port's driver on the CPU (fp32, the
JAX ``tests/test_sp.py`` ``_composition_run`` config, uniform shares and
one probe batch so that every run trains on the same shards): bert_tiny
MLM with ``ring`` and ``all_to_all`` at data=2,seq=2 against the port's
data=2 run and against the JAX driver's run of the same config on 4
virtual devices from the same initial parameters; the causal models
(gpt_tiny with ``ring_zigzag``, llama_tiny with grouped K/V and ``ring``)
against their data=2 twins; SP x FSDP (data=1,fsdp=2,seq=2: ring on
bert_tiny, the zig-zag ring on gpt_tiny) and SP x TP (data=1,seq=2,
model=2: ring and Ulysses) against the data=1 runs; the parameters bitwise
equal along seq after every round; a seq grid's checkpoint restored on
data=1.  Losses at rtol 2e-3, JAX's gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as t_checkpoint,
    driver as t_driver,
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RTOL = 2e-3
LOSSES = ("global_train_losses", "global_val_losses")


def _kw(model="bert_tiny", dataset="synthetic_mlm", seed=7, **extra):
    """JAX test_sp.py's ``_composition_run`` config."""
    return dict(model=model, dataset=dataset, epochs_global=2,
                epochs_local=1, batch_size=8, limit_train_samples=128,
                limit_eval_samples=32, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=seed,
                proportionality="uniform", probe_batches=1, **extra)


def _run(kw, axes, init=None, **train_kwargs):
    """The port's driver on the rank grid ``axes`` (one process per rank;
    one rank runs in this process), the seq line checked bitwise after
    every round."""
    cfg = Config(device="cpu", log_level="WARNING",
                 mesh_shape=",".join(f"{a}={n}" for a, n in axes.items()),
                 **kw)
    train_kwargs = dict(progress=False, round_checksums=True,
                        initial_state_dict=init, **train_kwargs)
    n = mesh.world_size_of(mesh.grid_axes(cfg))
    if n == 1:
        return t_driver.train_global(cfg, **train_kwargs)
    return t_driver.run_group(cfg, n, train_kwargs=train_kwargs)


def _same_losses(a, b, what):
    for key in LOSSES:
        np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                   err_msg=f"{what}: {key}")


def _check_sp(res, axes):
    """The grid's SP bookkeeping: its axes, hops on every rank, the
    gradients summed over seq, no flash launch, the parameters checked
    bitwise equal along seq after both rounds, the loss falling."""
    g = res["grid"]
    assert g["axes"] == axes
    assert all(s["calls"] > 0 and s["bytes"] > 0 and s["grad_calls"] > 0
               for s in g["sp"])
    assert not any(any(c.values()) for c in g["launches"])
    assert g["seq_bitwise_rounds"] == 2
    losses = res["global_train_losses"]
    assert losses[-1] < losses[0]


def _jax_init(kw):
    """The JAX driver's seeded init of the dense model (stacked layers,
    fp32), in the port's layout."""
    vocab = load_dataset(kw["dataset"], limit_train=8,
                         limit_test=8)[0].num_classes
    model = j_get_model(kw["model"], num_classes=vocab, dtype=jnp.float32,
                        scan_layers=True)
    params = model.init(jax.random.key(kw["seed"]),
                        jnp.zeros((kw["batch_size"], 128), jnp.int32),
                        train=False)["params"]
    return weights.flax_to_torch(params)


@pytest.fixture(scope="module")
def bert_runs(devices):
    """bert_tiny from JAX's init: the port's data=2 twin and its two SP
    runs, and the JAX driver's two SP runs."""
    kw = _kw()
    init = _jax_init(kw)
    out = {"twin": _run(kw, {"data": 2}, init)}
    for mode in ("ring", "all_to_all"):
        out[mode] = _run(dict(kw, sequence_parallel=mode),
                         {"data": 2, "seq": 2}, init)
        out[f"jax_{mode}"] = j_train_global(
            JConfig(**kw, sequence_parallel=mode),
            mesh=build_mesh({"data": 2, "seq": 2}, devices[:4]),
            progress=False)
    return out


@pytest.mark.parametrize("mode", ["ring", "all_to_all"])
def test_bert_matches_data_only_twin_and_jax_driver(bert_runs, mode):
    """JAX test_sp.py TestDriverSequenceParallel: bert_tiny MLM at
    data=2,seq=2 equals the data=2 run and the JAX driver's SP run of the
    same config (global train and val losses, rtol 2e-3)."""
    res = bert_runs[mode]
    _same_losses(res, bert_runs["twin"], f"{mode} vs data=2")
    _same_losses(res, bert_runs[f"jax_{mode}"], f"{mode} vs JAX")
    _check_sp(res, {"data": 2, "seq": 2})


@pytest.mark.parametrize("which", [
    ("gpt_tiny", "ring_zigzag", {}),
    ("llama_tiny", "ring", {"num_kv_heads": 2})], ids=["gpt_zigzag",
                                                       "llama_gqa_ring"])
def test_causal_models_match_data_only_twin(which):
    """JAX test_sp.py TestZigzagRing::test_driver_matches_dense_run
    (gpt_tiny, ring_zigzag) and the causal llama (grouped K/V, ring: the
    rotating K/V half the heads) at data=2,seq=2 against data=2."""
    model, mode, extra = which
    kw = _kw(model=model, dataset="synthetic_lm", seed=13, **extra)
    twin = _run(kw, {"data": 2})
    res = _run(dict(kw, sequence_parallel=mode), {"data": 2, "seq": 2})
    _same_losses(res, twin, model)
    _check_sp(res, {"data": 2, "seq": 2})


@pytest.fixture(scope="module")
def data1_twin():
    return _run(_kw(seed=9), {"data": 1})


@pytest.fixture(scope="module")
def sp_fsdp_run(tmp_path_factory, data1_twin):
    d = tmp_path_factory.mktemp("ckpt_sp")
    res = _run(_kw(seed=9, sequence_parallel="ring", checkpoint_dir=str(d),
                   checkpoint_every=1), {"data": 1, "fsdp": 2, "seq": 2})
    return d, res


def test_sp_fsdp_matches_data_only_run(sp_fsdp_run, data1_twin):
    """JAX TestSeqFsdpComposition: B over fsdp and L over seq in the same
    step (the loss denominator and the metric sums over both partial
    axes; the gradients summed over seq, then reduced over fsdp)."""
    _, res = sp_fsdp_run
    _same_losses(res, data1_twin, "fsdp x seq")
    _check_sp(res, {"data": 1, "fsdp": 2, "seq": 2})
    assert all(s["gathers"] > 0 for s in res["grid"]["fsdp"])


@pytest.mark.parametrize("mode", ["ring", "all_to_all"])
def test_sp_tp_matches_data_only_run(data1_twin, mode):
    """JAX TestSeqTensorComposition: ring (and Ulysses: the head shards
    over model split again over seq) attention on the Megatron head
    shards over model."""
    res = _run(_kw(seed=9, sequence_parallel=mode),
               {"data": 1, "seq": 2, "model": 2})
    _same_losses(res, data1_twin, f"seq x model, {mode}")
    _check_sp(res, {"data": 1, "seq": 2, "model": 2})
    assert all(s["calls"] > 0 for s in res["grid"]["tp"])


def test_seq_axis_without_sp_is_replicas_of_the_step(data1_twin):
    """JAX train.py:455-459: a seq axis without --sequence_parallel is no
    part axis, so both seq ranks take the data=1 step on the whole batch
    (no hop, no gradient sum over seq) and stay bitwise equal."""
    res = _run(_kw(seed=9), {"data": 1, "seq": 2})
    _same_losses(res, data1_twin, "seq replicas")
    g = res["grid"]
    assert g["axes"] == {"data": 1, "seq": 2}
    assert all(s["calls"] == 0 and s["grad_calls"] == 0 for s in g["sp"])
    assert g["seq_bitwise_rounds"] == 2


def test_zigzag_fsdp_matches_data_only_run():
    """The zig-zag ring composed with FSDP: gpt_tiny at
    data=1,fsdp=2,seq=2 against data=1."""
    kw = _kw(model="gpt_tiny", dataset="synthetic_lm", seed=9)
    twin = _run(kw, {"data": 1})
    res = _run(dict(kw, sequence_parallel="ring_zigzag"),
               {"data": 1, "fsdp": 2, "seq": 2})
    _same_losses(res, twin, "fsdp x seq, ring_zigzag")
    _check_sp(res, {"data": 1, "fsdp": 2, "seq": 2})


def test_seq_grid_checkpoint_restores_on_data_only(sp_fsdp_run):
    """The data=1,fsdp=2,seq=2 checkpoint holds each piece once (written
    by seq index 0: an fsdp-sharded leaf in 2 pieces, the scalars in 1)
    and restores on data=1 with the worker's parameters bitwise."""
    d, saved = sp_fsdp_run
    path = str(d / "ckpt_2")
    manifest = t_checkpoint.read_manifest(path)
    assert manifest["process_count"] == 4
    payloads = list(t_checkpoint.verified_shards(path, manifest))
    key = ".params['layers']['layer']['ffn_in']['kernel']"
    assert sum(key in p["leaves"] for p in payloads) == 2
    assert sum(".lr_epoch" in p["leaves"] for p in payloads) == 1
    cfg = Config(device="cpu", log_level="WARNING", mesh_shape="data=1",
                 **_kw(seed=9, checkpoint_dir=str(d), resume=True))
    res = t_driver.train_global(cfg, progress=False)
    for name, t in saved["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)
