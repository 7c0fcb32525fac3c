"""Expert parallelism through the port's driver on the CPU (fp32, the
config of JAX ``tests/test_moe.py:146-157``: bert_tiny with 4 experts, 2
rounds; uniform shares and one probe batch so that every run trains on
the same shards; the aux loss at weight 1, so that a fault in its
scaling or in its gradient moves the losses; one intra-op thread per
rank): data=1,expert=2 against the port's data=1 twin and the JAX
driver's run of the same config on 2 virtual devices from the same
initial parameters; the compositions with model, fsdp, seq (ring), pipe
(GPipe, and 1F1B against GPipe, JAX ``tests/test_moe.py:356-400``) and
``--grad_accum 2``, each against the port's twin that shares its routing
(fsdp slices, seq chunks and pipeline microbatches route on their own)
and, under fsdp, seq and pipe, against the JAX driver's run of that twin
(data=1 and fsdp=2, seq=2 or pipe=2 under each schedule on 2 devices),
which holds the aux's division over the batch's parts and over the
microbatches and its place in each stage's backward independently of
the port; the replicated leaves bitwise equal along expert after every
round; each rank's state bytes its share.  The 2- and 4-process runs
share one start each.  Losses at rtol 2e-3, JAX's gate."""

import concurrent.futures
import multiprocessing

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
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)

RTOL = 2e-3
LOSSES = ("global_train_losses", "global_val_losses")
# JAX _assert_params_close: the final parameters of two schedules
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4
GATE = ".moe.gate."
# the port's router kernels against JAX's after 2 rounds: Adam turns the
# two implementations' fp32 noise in a gate gradient near 0 into up to
# about half a step (5.3e-4 seen); a stage whose aux misses its backward
# moves them by 2e-2
GATE_RTOL, GATE_ATOL = 2e-3, 2e-3
EXPERTS = 4
# JAX's default is 0.01: at weight 1 the aux is a share of the loss and
# of the gate's gradient that a fault in its scaling cannot hide in
AUX_W = 1.0
# run name -> (mesh axes, extra flags): the 2-process start, then the
# 4-process one (each the twin, or the composition, of a test below)
TWO = {"ep": ({"data": 1, "expert": 2}, {}),
       "fsdp": ({"data": 1, "fsdp": 2}, {}),
       "seq": ({"data": 1, "seq": 2}, {"sequence_parallel": "ring"}),
       "pipe": ({"data": 1, "pipe": 2}, {}),
       "ep_accum": ({"data": 1, "expert": 2}, {"grad_accum": 2})}
FOUR = {"ep_model": ({"data": 1, "expert": 2, "model": 2}, {}),
        "ep_fsdp": ({"data": 1, "fsdp": 2, "expert": 2}, {}),
        "ep_seq": ({"data": 1, "seq": 2, "expert": 2},
                   {"sequence_parallel": "ring"}),
        "ep_pipe": ({"data": 1, "pipe": 2, "expert": 2}, {}),
        "ep_pipe_1f1b": ({"data": 1, "pipe": 2, "expert": 2},
                         {"pp_schedule": "1f1b"})}
# composition -> its twin (None: the data=1 run)
TWINS = {"ep": None, "ep_model": None, "ep_fsdp": "fsdp", "ep_seq": "seq",
         "ep_pipe": "pipe", "ep_pipe_1f1b": "ep_pipe"}
# the JAX driver's runs on 2 devices: name -> (mesh axes, extra flags)
JAX_RUNS = {"jax": ({"data": 1, "expert": 2}, {}),
            "jax_fsdp": TWO["fsdp"], "jax_seq": TWO["seq"],
            "jax_pipe": TWO["pipe"],
            "jax_pipe_1f1b": ({"data": 1, "pipe": 2},
                              {"pp_schedule": "1f1b"})}
# run of the port -> the JAX run it equals (the same routing)
JAX_TWINS = {"ep": "jax", "ep_model": "jax", "ep_fsdp": "jax_fsdp",
             "ep_seq": "jax_seq", "ep_pipe": "jax_pipe",
             "ep_pipe_1f1b": "jax_pipe_1f1b", "fsdp": "jax_fsdp",
             "seq": "jax_seq", "pipe": "jax_pipe"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(**extra):
    """JAX TestDriverExpertParallel._run's config."""
    return dict(model="bert_tiny", dataset="synthetic_mlm", epochs_global=2,
                epochs_local=1, batch_size=8, limit_train_samples=128,
                limit_eval_samples=32, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=7,
                num_experts=EXPERTS, proportionality="uniform",
                probe_batches=1, moe_aux_weight=AUX_W, **extra)


def _cfg(axes, **extra):
    return Config(device="cpu", log_level="WARNING",
                  mesh_shape=",".join(f"{a}={n}" for a, n in axes.items()),
                  **_kw(**extra))


def _jax_init():
    """The JAX driver's seeded init of the dense model (stacked layers,
    fp32), in the port's layout."""
    kw = _kw()
    vocab = load_dataset(kw["dataset"], limit_train=8,
                         limit_test=8)[0].num_classes
    model = j_get_model(kw["model"], num_classes=vocab, dtype=jnp.float32,
                        scan_layers=True, num_experts=EXPERTS)
    params = model.init(jax.random.key(kw["seed"]),
                        jnp.zeros((kw["batch_size"], 128), jnp.int32),
                        train=False)["params"]
    return weights.flax_to_torch(params)


def _shared(n, runs, init):
    """Every run of ``runs`` from one start of ``n`` processes."""
    train_kwargs = dict(progress=False, initial_state_dict=init)
    jobs = [(_cfg(axes, **extra), train_kwargs)
            for axes, extra in runs.values()]
    with t_driver.SharedStart(n, jobs) as start:
        return {name: start.run() for name in runs}


def _jax_run(name: str) -> dict:
    """The JAX driver's run ``JAX_RUNS[name]`` on the virtual CPU devices
    (the test environment's), from its seeded init: its losses."""
    jax.config.update("jax_platforms", "cpu")
    axes, extra = JAX_RUNS[name]
    n = int(np.prod(list(axes.values())))
    res = j_train_global(JConfig(**_kw(**extra)),
                         mesh=build_mesh(axes, jax.devices()[:n]),
                         progress=False)
    # the one worker's row of the state's leading worker axis
    final = weights.flax_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[0], res["state"].params))
    return {**{k: list(res[k]) for k in LOSSES},
            "gates": {k: np.asarray(v) for k, v in final.items()
                      if GATE in k}}


@pytest.fixture(scope="module")
def runs(devices):
    """The data=1 twins (plain and --grad_accum 2, in this process), every
    2- and 4-process run of TWO and FOUR, all from JAX's init, and the
    JAX driver's runs of JAX_RUNS, in two processes of their own beside
    them (the port's ranks take one thread each)."""
    init = _jax_init()
    kw = dict(progress=False, initial_state_dict=init)
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_runs = {name: pool.submit(_jax_run, name) for name in JAX_RUNS}
        out = {"twin": t_driver.train_global(_cfg({"data": 1}), **kw),
               "twin_accum": t_driver.train_global(
                   _cfg({"data": 1}, grad_accum=2), **kw)}
        out.update(_shared(2, TWO, init))
        out.update(_shared(4, FOUR, init))
        out.update({name: run.result(timeout=600)
                    for name, run in jax_runs.items()})
    return out


def _same_losses(a, b, what):
    for key in LOSSES:
        np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                   err_msg=f"{what}: {key}")


def _same_gates(res, jax_res, what):
    """The final router (gate) kernels of a port run against a JAX run's:
    the aux loss reaches the other parameters only through them."""
    gates = jax_res["gates"]
    assert len(gates) == 2, sorted(gates)
    for k, g in gates.items():
        np.testing.assert_allclose(res["variables"][k].numpy(), g,
                                   rtol=GATE_RTOL, atol=GATE_ATOL,
                                   err_msg=f"{what}: {k}")


def _check_ep(res, axes):
    """The grid's EP bookkeeping: its axes, the expert all-reduces on every
    rank, the replicated leaves checked bitwise equal along expert after
    both rounds, the loss falling."""
    g = res["grid"]
    assert g["axes"] == axes
    assert all(s["calls"] > 0 and s["bytes"] > 0 for s in g["ep"])
    assert g["expert_bitwise_rounds"] == 2
    losses = res["global_train_losses"]
    assert losses[-1] < losses[0]


def test_expert_matches_data_only_twin_and_jax_driver(runs):
    """JAX TestDriverExpertParallel.test_matches_unsharded_run: bert_tiny
    with 4 experts at data=1,expert=2 (2 experts a rank) equals the data=1
    run and the JAX driver's expert run of the same config (global train
    and val losses, rtol 2e-3)."""
    res = runs["ep"]
    _same_losses(res, runs["twin"], "expert vs data=1")
    _same_losses(res, runs["jax"], "expert vs JAX")
    _same_gates(res, runs["jax"], "expert vs JAX")
    _check_ep(res, {"data": 1, "expert": 2})


@pytest.mark.parametrize("name", sorted(FOUR))
def test_compositions_match_their_twins(runs, name):
    """MoE x TP x EP (JAX test_moe.py:164-177), FSDP x EP
    (test_fsdp.py:205-218), SP x EP (test_moe.py:336-344), PP x EP under
    GPipe and 1F1B (test_moe.py:287-306, 401-415): each equals its twin,
    which shares its routing (the data=1 run under model; fsdp=2, seq=2
    or pipe=2 without the expert axis; 1F1B's twin is GPipe's expert
    run), and the JAX driver's run of that routing (data=1,expert=2;
    fsdp=2, seq=2, pipe=2 under the same schedule) at rtol 2e-3; the
    expert stacks are cut over expert and the other axis is used."""
    res = runs[name]
    axes = FOUR[name][0]
    twin = TWINS[name]
    _same_losses(res, runs[twin] if twin else runs["twin"],
                 f"{name} vs {twin or 'data=1'}")
    _same_losses(res, runs[JAX_TWINS[name]], f"{name} vs {JAX_TWINS[name]}")
    _same_gates(res, runs[JAX_TWINS[name]], f"{name} vs {JAX_TWINS[name]}")
    _check_ep(res, axes)
    g = res["grid"]
    if "model" in axes:
        assert all(s["calls"] > 0 for s in g["tp"])
    if "fsdp" in axes:
        assert all(s["gathers"] > 0 for s in g["fsdp"])
    if "seq" in axes:
        assert all(s["calls"] > 0 for s in g["sp"])
    if "pipe" in axes:
        assert g["pipe_bitwise_rounds"] == 2
        assert all(s["fwd_calls"] > 0 for s in g["pp"])


@pytest.mark.parametrize("name", ["fsdp", "seq", "pipe"])
def test_moe_twins_match_jax_driver(runs, name):
    """MoE x FSDP, MoE x SP (ring) and MoE x PP (GPipe) without the
    expert axis (JAX test_fsdp.py:186-204, test_moe.py:262-285, 308-335):
    the port's run equals the JAX driver's from the same initial
    parameters (rtol 2e-3): each fsdp slice and seq chunk routes its own
    tokens, its aux over the part count; each pipeline microbatch's aux
    over M joins its stage's backward."""
    for check in (_same_losses, _same_gates):
        check(runs[name], runs[JAX_TWINS[name]],
              f"{name} vs {JAX_TWINS[name]}")


def test_1f1b_expert_params_match_gpipe(runs):
    """JAX test_1f1b_moe_ep_matches_gpipe_ep: under the expert axis the
    1F1B run's final parameters equal the GPipe run's (JAX's
    _assert_params_close: rtol 2e-3, atol 2e-4): the aux loss of each
    microbatch reaches its stage's backward under both schedules."""
    a, b = (runs[k]["variables"] for k in ("ep_pipe_1f1b", "ep_pipe"))
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def test_grad_accum_expert_matches_twin(runs):
    """--grad_accum 2 x expert (each slice routed on its own, its aux over
    K) against the data=1 run at --grad_accum 2."""
    _same_losses(runs["ep_accum"], runs["twin_accum"], "grad_accum x ep")
    _check_ep(runs["ep_accum"], {"data": 1, "expert": 2})


def test_expert_state_bytes_are_the_rank_share(runs):
    """Each expert rank holds its 2 of the 4 experts of every layer and
    every other leaf whole: its parameters and Adam moments are that
    share of the worker's."""
    model = get_model("bert_tiny", num_classes=runs["ep"][
        "model"].num_classes, num_experts=EXPERTS)
    named = list(model.named_parameters())
    total = sum(p.numel() for _n, p in named)
    experts = sum(p.numel() for n, p in named
                  if ".moe." in n and ".gate." not in n)
    share = total - experts // 2
    for st in runs["ep"]["grid"]["state_bytes"]:
        assert st["params"] == 4 * share
        assert st["opt_state"] == 8 * share + 4
