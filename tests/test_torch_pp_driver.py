"""Pipeline parallelism through the port's driver on the CPU (fp32, the
config of JAX ``tests/test_pp.py`` ``TestDriverPipelineParallel._run``,
uniform shares and one probe batch so that every run trains on the same
shards, one intra-op thread per rank): bert_tiny at data=1,pipe=2 (GPipe)
against the port's data=1 twin and the JAX driver's run of the same
config on 2 virtual devices from the same initial parameters; gpt_tiny
(tied head), llama_tiny and vit_tiny (classifier head) under 1F1B and
bert_tiny at 4 microbatches against their data=1 twins; the compositions
with model (1F1B and GPipe, whose final parameters agree), fsdp and seq
(ring attention in each stage), and with ``--grad_accum``; the replicated
leaves bitwise equal along pipe after every round (and a planted fault
that skips their sum caught); each rank's state bytes its stage's share;
checkpoints across the pipe grid and data=1 both ways, and ``main serve``
off a pipe-trained checkpoint.  Losses at rtol 2e-3, JAX's gate."""

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
    driver as t_driver,
    main as t_main,
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    pp,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RTOL = 2e-3
LOSSES = ("global_train_losses", "global_val_losses")
# JAX test_driver_1f1b_sp_matches_gpipe_and_dense's caps on the final
# parameters of two schedules of the same run: max, mean, and max on the
# embedding tables
PARAM_MAX, PARAM_MEAN, EMB_MAX = 5e-3, 2e-3, 3e-2


def _kw(model="bert_tiny", dataset="synthetic_mlm", seed=7, **extra):
    """JAX TestDriverPipelineParallel._run's config."""
    return dict(model=model, dataset=dataset, epochs_global=2,
                epochs_local=1, batch_size=8, limit_train_samples=128,
                limit_eval_samples=32, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=seed,
                proportionality="uniform", probe_batches=1, **extra)


def _run(kw, axes, init=None, **train_kwargs):
    """The port's driver on the rank grid ``axes`` (one process per rank;
    rank 0 runs in this process)."""
    cfg = Config(device="cpu", log_level="WARNING",
                 mesh_shape=",".join(f"{a}={n}" for a, n in axes.items()),
                 **kw)
    train_kwargs = dict(progress=False, initial_state_dict=init,
                        **train_kwargs)
    n = mesh.world_size_of(mesh.grid_axes(cfg))
    if n == 1:
        return t_driver.train_global(cfg, **train_kwargs)
    return t_driver.run_group(cfg, n, train_kwargs=train_kwargs)


def _same_losses(a, b, what):
    for key in LOSSES:
        np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                   err_msg=f"{what}: {key}")


def _check_pp(res, axes, schedule="gpipe", m=None):
    """The grid's PP bookkeeping: its axes, hops both ways, the replicated
    leaves' all-reduce on every rank, the microbatches in flight at the
    schedule's bound, the replicated leaves checked bitwise equal along
    pipe after both rounds, the loss falling."""
    g = res["grid"]
    assert g["axes"] == axes
    p = axes["pipe"]
    m = m or p
    for r, st in enumerate(g["pp"]):
        s = g["coords_of"][r]["pipe"]
        assert (st["schedule"], st["microbatches"]) == (schedule, m)
        assert st["grad_calls"] > 0 and st["grad_bytes"] > 0
        assert (st["fwd_calls"] > 0) and (st["bwd_calls"] > 0)
        assert st["in_flight"] == pp.in_flight_bound(schedule, p, s, m)
    assert g["pipe_bitwise_rounds"] == 2
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
def bert_runs(devices, tmp_path_factory):
    """bert_tiny from JAX's init: the port's data=1 twin (writing a
    checkpoint a round), its GPipe run at data=1,pipe=2 (writing one too)
    and the JAX driver's run of the same config on 2 virtual devices."""
    kw = _kw()
    init = _jax_init(kw)
    d_twin = tmp_path_factory.mktemp("ckpt_twin")
    d_pipe = tmp_path_factory.mktemp("ckpt_pipe")
    out = {"twin": _run(dict(kw, checkpoint_dir=str(d_twin),
                             checkpoint_every=1), {"data": 1}, init),
           "pipe": _run(dict(kw, checkpoint_dir=str(d_pipe),
                             checkpoint_every=1), {"data": 1, "pipe": 2},
                        init),
           "jax": j_train_global(JConfig(**kw),
                                 mesh=build_mesh({"data": 1, "pipe": 2},
                                                 devices[:2]),
                                 progress=False),
           "dirs": (d_twin, d_pipe), "init": init}
    return out


def test_bert_gpipe_matches_data_only_twin_and_jax_driver(bert_runs):
    """JAX TestDriverPipelineParallel.test_matches_dense_run: bert_tiny
    MLM at data=1,pipe=2 (one block a stage, GPipe over 2 microbatches)
    equals the data=1 run and the JAX driver's pipe run of the same
    config (global train and val losses, rtol 2e-3)."""
    res = bert_runs["pipe"]
    _same_losses(res, bert_runs["twin"], "pipe vs data=1")
    _same_losses(res, bert_runs["jax"], "pipe vs JAX")
    _check_pp(res, {"data": 1, "pipe": 2})


def test_stage_state_bytes_are_the_stage_share(bert_runs):
    """Each rank holds its stage's rows of the stacked leaves and every
    leaf outside the stack whole: parameters and Adam moments are that
    share of the worker's, and the two stages together hold the worker's
    once plus the replicated leaves twice."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
        get_model,
    )
    model = get_model("bert_tiny", num_classes=bert_runs["pipe"][
        "model"].num_classes)
    blocks = sum(p.numel() for p in model.blocks.parameters())
    total = sum(p.numel() for p in model.parameters())
    stage = total - blocks // 2
    for st in bert_runs["pipe"]["grid"]["state_bytes"]:
        assert st["params"] == 4 * stage
        assert st["opt_state"] == 8 * stage + 4


@pytest.mark.parametrize("which", [
    ("gpt_tiny", "synthetic_lm", {}, "1f1b", 0),
    ("llama_tiny", "synthetic_lm", {}, "1f1b", 0),
    ("vit_tiny", "cifar10", {}, "1f1b", 4),
    ("bert_tiny", "synthetic_mlm", {}, "gpipe", 4),
], ids=["gpt_1f1b_tied_head", "llama_1f1b", "vit_1f1b_classifier_head",
        "bert_microbatches_4"])
def test_families_match_data_only_twin(which, tmp_path):
    """JAX TestOneF1B's driver cases (the tied gpt head, llama's untied
    head, vit's mean-pool classifier) and TestDriverPipelineParallel.
    test_microbatch_override, each at data=1,pipe=2 against its data=1
    twin."""
    model, dataset, extra, schedule, m = which
    kw = _kw(model=model, dataset=dataset, seed=13, **extra)
    twin = _run(kw, {"data": 1})
    res = _run(dict(kw, pp_schedule=schedule, pp_microbatches=m),
               {"data": 1, "pipe": 2})
    _same_losses(res, twin, model)
    _check_pp(res, {"data": 1, "pipe": 2}, schedule, m or 2)


@pytest.fixture(scope="module")
def gpt_twin():
    return _run(_kw(model="gpt_tiny", dataset="synthetic_lm", seed=9),
                {"data": 1})


@pytest.fixture(scope="module")
def pp_tp_runs(gpt_twin, tmp_path_factory):
    """gpt_tiny at data=1,pipe=2,model=2 under both schedules (the 1F1B run
    writes a checkpoint a round)."""
    kw = _kw(model="gpt_tiny", dataset="synthetic_lm", seed=9)
    d = tmp_path_factory.mktemp("ckpt_pp_tp")
    axes = {"data": 1, "pipe": 2, "model": 2}
    return {"gpipe": _run(kw, axes),
            "1f1b": _run(dict(kw, pp_schedule="1f1b", checkpoint_dir=str(d),
                              checkpoint_every=1), axes),
            "dir": d}


def test_pipe_model_1f1b_and_gpipe_match_twin_and_each_other(gpt_twin,
                                                             pp_tp_runs):
    """JAX test_driver_1f1b_tp_matches_gpipe_and_dense: the tied
    vocab-parallel head under pipe x model; both schedules' trajectories
    equal the data=1 run's, and their final parameters agree within JAX's
    caps (5e-3 max, 2e-3 mean, 3e-2 on the embedding tables)."""
    axes = {"data": 1, "pipe": 2, "model": 2}
    for schedule in ("gpipe", "1f1b"):
        res = pp_tp_runs[schedule]
        _same_losses(res, gpt_twin, f"pipe x model, {schedule}")
        _check_pp(res, axes, schedule)
        assert all(s["calls"] > 0 for s in res["grid"]["tp"])
    a, b = (pp_tp_runs[s]["variables"] for s in ("gpipe", "1f1b"))
    for name in a:
        d = np.abs(a[name].double().numpy() - b[name].double().numpy())
        cap = EMB_MAX if "emb" in name else PARAM_MAX
        assert d.max() < cap and d.mean() < PARAM_MEAN, (name, d.max(),
                                                         d.mean())


def test_fsdp_pipe_matches_data_only_run(bert_runs):
    """JAX TestDriverPipelineTensorParallel.test_driver_fsdp_pp_matches_
    dense: bert_tiny at data=1,fsdp=2,pipe=2 (the batch over fsdp, then
    microbatches; the stacked leaves' layer dimension over pipe and a free
    one over fsdp) against data=1."""
    res = _run(_kw(), {"data": 1, "fsdp": 2, "pipe": 2}, bert_runs["init"])
    _same_losses(res, bert_runs["twin"], "fsdp x pipe")
    _check_pp(res, {"data": 1, "fsdp": 2, "pipe": 2})
    assert all(s["gathers"] > 0 for s in res["grid"]["fsdp"])


def test_seq_pipe_ring_matches_data_only_run(gpt_twin):
    """JAX test_driver_1f1b_sp_matches_gpipe_and_dense's SP x PP: ring
    attention over seq inside each stage (gpt_tiny at data=1,pipe=2,seq=2,
    1F1B over 4 microbatches) against data=1."""
    kw = _kw(model="gpt_tiny", dataset="synthetic_lm", seed=9,
             sequence_parallel="ring", pp_schedule="1f1b",
             pp_microbatches=4)
    res = _run(kw, {"data": 1, "pipe": 2, "seq": 2})
    _same_losses(res, gpt_twin, "seq x pipe")
    _check_pp(res, {"data": 1, "pipe": 2, "seq": 2}, "1f1b", 4)
    assert all(s["calls"] > 0 and s["grad_calls"] > 0
               for s in res["grid"]["sp"])


def test_grad_accum_pipe_matches_data_only_run(bert_runs):
    """--grad_accum 2 x pipe (each of the 2 slices run through the
    schedule, the gradients summed over both) against the data=1 run."""
    res = _run(_kw(grad_accum=2), {"data": 1, "pipe": 2}, bert_runs["init"])
    _same_losses(res, bert_runs["twin"], "grad_accum x pipe")
    _check_pp(res, {"data": 1, "pipe": 2})


def test_skipping_the_pipe_sum_fails_the_bitwise_gate(bert_runs,
                                                      monkeypatch):
    """A planted fault: rank 0 (this process) runs the pipe all-reduce of
    the replicated leaves' gradients but keeps its own; its leaves leave
    the other stage's and the check after the round raises."""
    real = pp.all_reduce_replicated

    def keep_own(grads, replicated, group):
        real(grads, replicated, group)
        return list(grads)

    monkeypatch.setattr(pp, "all_reduce_replicated", keep_own)
    with pytest.raises(RuntimeError) as info:
        _run(_kw(), {"data": 1, "pipe": 2}, bert_runs["init"])
    # the group reports a failed peer first, rank 0's own error beneath
    assert "along pipe" in f"{info.value} {info.value.__cause__}"


def test_pipe_checkpoint_restores_bitwise_on_data_only(bert_runs):
    """The data=1,pipe=2 checkpoint holds each stacked leaf in 2 pieces
    (one per stage) and the other leaves once (stage 0 writes them), and
    restores on data=1 with the worker's parameters bitwise."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        checkpoint as t_checkpoint,
    )
    _, d = bert_runs["dirs"]
    path = str(d / "ckpt_2")
    manifest = t_checkpoint.read_manifest(path)
    assert manifest["process_count"] == 2
    payloads = list(t_checkpoint.verified_shards(path, manifest))
    key = ".params['layers']['layer']['ffn_in']['kernel']"
    assert sum(key in p["leaves"] for p in payloads) == 2
    assert sum(".params['tok_emb']['embedding']" in p["leaves"]
               for p in payloads) == 1
    res = _run(_kw(checkpoint_dir=str(d), resume=True), {"data": 1})
    assert res["round_timings"] == []
    for name, t in bert_runs["pipe"]["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)


def test_data_only_checkpoint_restores_bitwise_on_pipe(bert_runs):
    """The data=1 checkpoint restores on data=1,pipe=2: each stage takes
    its rows, and the worker's parameters come back whole, bitwise."""
    d, _ = bert_runs["dirs"]
    res = _run(_kw(checkpoint_dir=str(d), resume=True),
               {"data": 1, "pipe": 2})
    assert res["round_timings"] == []
    for name, t in bert_runs["twin"]["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)


def test_main_serve_loads_a_pipe_trained_checkpoint(pp_tp_runs):
    """``main serve`` off the data=1,pipe=2,model=2 gpt_tiny checkpoint:
    the model is rebuilt whole from the pieces and serves greedy requests
    whose first token is the full forward's argmax of the trained
    parameters."""
    d = pp_tp_runs["dir"]
    res = t_main.run(["serve", "--device", "cpu", "--checkpoint_dir",
                      str(d), "--serve_max_batch", "2", "--serve_page_size",
                      "4", "--serve_max_pages", "40",
                      "--serve_prompt_buckets", "8,16", "--serve_requests",
                      "2", "--serve_max_new_tokens", "3", "--serve_prompt",
                      "1,2,3,4,5"])
    outs = [list(c.tokens) for c in res["completions"]]
    want = pp_tp_runs["1f1b"]
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
        get_model,
    )
    model = get_model("gpt_tiny", num_classes=want["model"].num_classes)
    model.load_state_dict({k: v.cpu() for k, v in want["variables"].items()})
    with torch.no_grad():
        first = int(model(torch.tensor([[1, 2, 3, 4, 5]]))[0, -1].argmax())
    assert len(outs) == 2 and all(o[0] == first for o in outs), (outs,
                                                                 first)
