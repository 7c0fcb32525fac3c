"""Sequence parallelism over the ``seq`` axis of the port's rank grid
(``..._torch/parallel/sp.py``, ``ops/attention.attend``) against the
JAX package's ``parallel/sp.py`` and the port's own dense attention: ring
attention (bidirectional, causal, grouped K/V), the zig-zag causal ring at
S=2 and S=4 (grouped K/V too) and all-to-all (Ulysses) attention, each
forward and each gradient of q, k and v on gloo ranks of one spawn, held
against JAX's ``shard_map`` of the same function on as many of the 8
virtual CPU devices, on the same numpy inputs; then the refusals of JAX's
SP path (the functions' and the configuration's).  Tolerances are written
beside each case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    config as j_config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.sp import (
    ring_attention as jax_ring,
    ring_attention_zigzag as jax_zigzag,
    ulysses_attention as jax_ulysses,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    config as t_config,
    grid_harness,
    mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.decode import (
    spec_from_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.ops.attention import (
    attend,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    sp,
)

# forward: the blockwise online softmax sums the same terms in another
# order (fp32); gradients: JAX's own gate of the grouped cases
# (tests/test_sp.py uses 1e-4 on its dense comparisons)
OUT_ATOL, GRAD_ATOL = 1e-5, 2e-4
B, L, H, D = 2, 32, 4, 16
# id -> (impl, seq size S, causal, K/V heads); 4 ranks: a 4-rank seq line,
# or two 2-rank lines (data=2, seq=2) of which line 0 is read
CASES = {
    "ring": ("ring", 4, False, H),
    "ring_causal": ("ring", 4, True, H),
    "ring_causal_gqa": ("ring", 4, True, 2),
    "zigzag_s2": ("ring_zigzag", 2, True, H),
    "zigzag_s4": ("ring_zigzag", 4, True, H),
    "zigzag_gqa": ("ring_zigzag", 4, True, 2),
    "ulysses": ("all_to_all", 4, False, H),
    "ulysses_causal_gqa": ("all_to_all", 2, True, 2),
}
# id -> (registry name, extra model kwargs, --sequence_parallel, seq size):
# the slice as a whole on one module step, against the dense twin
MODEL_VOCAB, MODEL_SEQ = 96, 16
MODEL_CASES = {
    "gpt_zigzag": ("gpt_tiny", {}, "ring_zigzag", 2),
    "llama_gqa_ring": ("llama_tiny", {"num_kv_heads": 2}, "ring", 4),
    "bert_ulysses": ("bert_tiny", {}, "all_to_all", 4),
}
JAX_FN = {"ring": lambda q, k, v, causal: jax_ring(q, k, v, "seq",
                                                    causal=causal),
          "ring_zigzag": lambda q, k, v, causal: jax_zigzag(q, k, v, "seq"),
          "all_to_all": lambda q, k, v, causal: jax_ulysses(
              q, k, v, "seq", causal=causal)}


def _job(i, kv):
    """Case i's inputs: q, k, v and the cotangent, drawn in the ranks and
    here from one seed (``grid_harness.sp_inputs``)."""
    return dict(seed=100 + i, shape=(B, L, H, kv, D))


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """One spawn of 4 gloo ranks (one intra-op thread each) running every
    case; {case id: the seq ranks' results in seq order}."""
    d = tmp_path_factory.mktemp("sp_jobs")
    jobs = []
    for i, (impl, s, causal, kv) in enumerate(CASES.values()):
        axes = {"seq": 4} if s == 4 else {"data": 2, "seq": 2}
        jobs.append(dict(kind="sp", axes=axes, impl=impl, causal=causal,
                         **_job(i, kv)))
    for i, (name, kw, mode, s) in enumerate(MODEL_CASES.values()):
        axes = {"seq": 4} if s == 4 else {"data": 2, "seq": 2}
        model = get_model(name, num_classes=MODEL_VOCAB, **kw)
        model.init_parameters(torch.Generator().manual_seed(i))
        rng = np.random.default_rng(200 + i)
        jobs.append(dict(
            model=name, vocab=MODEL_VOCAB, axes=axes,
            kw=dict(kw, sequence_parallel=mode, mesh_shape=",".join(
                f"{a}={n}" for a, n in axes.items())),
            state_dict={k: v.numpy() for k, v in model.state_dict().items()},
            x=rng.integers(0, MODEL_VOCAB, (4, MODEL_SEQ)),
            y=rng.integers(-1, MODEL_VOCAB, (4, MODEL_SEQ)),
            m=np.array([1.0, 1.0, 0.0, 1.0], np.float32)))
    spec = d / "jobs.pt"
    torch.save({"axes": jobs[0]["axes"], "jobs": jobs}, spec)
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, 4, (store, str(spec), str(d)),
            ranks=range(4), threads=1), timeout_s=120.0)
    finally:
        mesh.remove_store(store)
    out = {}
    for i, (name, (_impl, s, _c, _kv)) in enumerate(CASES.items()):
        ranks = [torch.load(d / f"rank{r}-{i}.pt", weights_only=False)
                 for r in range(s)]          # data coordinate 0's line
        assert [r["seq"] for r in ranks] == list(range(s))
        out[name] = ranks
    for j, (name, (_m, _kw, _mode, s)) in enumerate(MODEL_CASES.items()):
        out[name] = [torch.load(d / f"rank{r}-{len(CASES) + j}.pt",
                                weights_only=False) for r in range(s)]
    return out


def _jax_run(impl, s, causal, q, k, v, do):
    """JAX's shard_map of the same function on ``s`` virtual devices: the
    output and the gradients of sum(out * do)."""
    mesh_ = Mesh(np.array(jax.devices()[:s]), ("seq",))
    fn = jax.shard_map(lambda q, k, v: JAX_FN[impl](q, k, v, causal),
                       mesh=mesh_, in_specs=(P(None, "seq"),) * 3,
                       out_specs=P(None, "seq"))
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) * do).sum(),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_attention_matches_jax_shard_map_and_dense(sp_runs, name):
    """Each case's output chunks (joined in seq order) equal JAX's
    shard_map of ``parallel/sp.py`` at atol 1e-5 and the port's dense
    attention on the whole sequence; the gradients of q, k and v at atol
    2e-4 against both; the hops were counted on every rank."""
    impl, s, causal, kv = CASES[name]
    i = list(CASES).index(name)
    q, k, v, do = grid_harness.sp_inputs(_job(i, kv))
    ranks = sp_runs[name]
    out = np.concatenate([r["out"] for r in ranks], axis=1)
    grads = [np.concatenate([r["grads"][j] for r in ranks], axis=1)
             for j in range(3)]
    want, want_grads = _jax_run(impl, s, causal, q, k, v, do)
    np.testing.assert_allclose(out, want, atol=OUT_ATOL)
    np.testing.assert_allclose(out, ranks[0]["dense_out"], atol=OUT_ATOL)
    for j, g in enumerate(grads):
        np.testing.assert_allclose(g, want_grads[j], atol=GRAD_ATOL,
                                   err_msg="qkv"[j])
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][j],
                                   atol=GRAD_ATOL, err_msg="qkv"[j])
    assert all(r["stats"]["calls"] > 0 and r["stats"]["bytes"] > 0
               for r in ranks)
    # each rank's own differences (the ones chip_smoke.py gates)
    lc = L // s
    for r, res in enumerate(ranks):
        mine = slice(r * lc, (r + 1) * lc)
        for j, (a, b) in enumerate(zip([res["out"], *res["grads"]],
                                       [res["dense_out"],
                                        *res["dense_grads"]])):
            want = np.abs(a - b[:, mine]).max() / np.abs(b).max()
            assert res["errors"][j] == pytest.approx(want, rel=1e-6,
                                                     abs=1e-12)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_step_matches_the_dense_twin(sp_runs, name):
    """One fp32 forward and backward of a model on its seq line (each rank
    its chunk of every sequence: learned positions and RoPE at the chunk's
    offset, the attention over the line): the logits joined in seq order
    equal the dense twin's on the whole sequences (atol 1e-5), the loss
    numerators summed over the line its loss (rtol 1e-6), the gradients
    summed over the line its gradients (atol 2e-4) and are bitwise equal on
    every seq rank; the module launched no flash kernel."""
    ranks = sp_runs[name]
    logits = np.concatenate([r["logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(logits, ranks[0]["dense_logits"],
                               atol=OUT_ATOL)
    np.testing.assert_allclose(sum(r["loss"] for r in ranks),
                               ranks[0]["dense_loss"], rtol=1e-6)
    for key, g in ranks[0]["grads"].items():
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][key],
                                   atol=GRAD_ATOL, err_msg=key)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["grads"][key], g, err_msg=key)
    assert all(not any(r["launches"].values()) for r in ranks)
    # each rank's own differences (the ones chip_smoke.py gates)
    for r, res in enumerate(ranks):
        mine = np.array_split(res["dense_logits"], len(ranks), axis=1)[r]
        assert res["logits_err"] == np.abs(res["logits"] - mine).max()
        assert res["grads_err"] <= GRAD_ATOL


def test_hop_counts_follow_the_design(sp_runs):
    """Per forward and backward: the ring runs S-1 hops each way (JAX's
    last rotation is skipped), the zig-zag ring two more (to and from the
    zig-zag layout), Ulysses two all-to-alls each way; a GQA ring moves
    K/V of half the heads."""
    calls = {n: sp_runs[n][0]["stats"]["calls"] for n in CASES}
    assert calls["ring"] == calls["ring_causal"] == 2 * 3
    assert calls["zigzag_s4"] == 2 * (3 + 2)
    assert calls["zigzag_s2"] == 2 * (1 + 2)
    assert calls["ulysses"] == calls["ulysses_causal_gqa"] == 2 * 2
    bytes_ = {n: sp_runs[n][0]["stats"]["bytes"] for n in CASES}
    assert bytes_["ring_causal_gqa"] * 2 == bytes_["ring_causal"]


def _line(n=2):
    """A ``seq`` line view with no process group: the refusals raise
    before any hop."""
    return mesh.Group(0, n, torch.device("cpu"))


def test_odd_zigzag_chunk_refused():
    x = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="even per-device chunk"):
        sp.ring_attention_zigzag(x, x, x, _line())


def test_ulysses_needs_divisible_heads():
    q, kv = torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match=r"divisible by the seq-axis size"):
        sp.ulysses_attention(q, kv, kv, _line())
    with pytest.raises(ValueError, match=r"kv heads \(1\)"):
        sp.ulysses_attention(torch.zeros(1, 4, 2, 8),
                             torch.zeros(1, 4, 1, 8),
                             torch.zeros(1, 4, 1, 8), _line())


@pytest.mark.parametrize("impl", ["ring", "ring_zigzag", "all_to_all"])
def test_attend_refuses_as_jax_does(impl):
    """JAX ``ops/attention.py:116-136``: a seq group is required, a mask
    is not sharded, and zig-zag only balances causal attention."""
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="requires a seq group"):
        attend(x, x, x, impl=impl, causal=True)
    with pytest.raises(NotImplementedError, match="arbitrary masks"):
        attend(x, x, x, mask=torch.ones(4, 4, dtype=torch.bool), impl=impl,
               group=_line(), causal=True)
    if impl == "ring_zigzag":
        with pytest.raises(ValueError, match="CAUSAL"):
            attend(x, x, x, impl=impl, group=_line(), causal=False)


@pytest.mark.parametrize("flags,match", [
    (["--model", "bert_tiny", "--mesh_shape", "data=1,seq=2",
      "--sequence_parallel", "ring", "--attention_impl", "flash"],
     "cannot combine with --sequence_parallel"),
    (["--model", "bert_tiny", "--sequence_parallel", "ring"],
     "needs a 'seq' mesh axis of size >= 2"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,seq=1",
      "--sequence_parallel", "all_to_all"], "size >= 2"),
    (["--model", "vit_tiny", "--dataset", "cifar10", "--mesh_shape",
      "data=1,seq=2", "--sequence_parallel", "ring"],
     "token-sequence models"),
    (["--model", "enhanced_cnn", "--mesh_shape", "data=1,seq=2",
      "--sequence_parallel", "ring"], "token-sequence models"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,seq=2",
      "--sequence_parallel", "ring_zigzag"], "CAUSAL"),
    (["--model", "gpt_tiny", "--sim_workers", "4", "--sequence_parallel",
      "ring", "--mesh_shape", "data=-1"], "--sim_workers"),
    # SP x PP runs, as in JAX (tests/test_torch_pp_driver.py): accepted
    (["--model", "gpt_tiny", "--mesh_shape", "data=1,seq=2,pipe=2",
      "--sequence_parallel", "ring"], None),
    # MoE x SP runs, as in JAX (tests/test_torch_ep_driver.py): accepted
    (["--model", "bert_tiny", "--num_experts", "4", "--mesh_shape",
      "data=1,seq=2", "--sequence_parallel", "ring"], None),
    # elastic membership and staleness run on a seq grid, as in JAX
    # (tests/test_torch_grid_elastic.py)
    (["--model", "bert_tiny", "--mesh_shape", "data=2,seq=2",
      "--sequence_parallel", "ring", "--chaos", "kill@1:w1"], None),
    (["--model", "bert_tiny", "--mesh_shape", "data=2,seq=2",
      "--sequence_parallel", "ring", "--aggregation_by", "weights",
      "--sync_staleness", "1"], None),
], ids=["flash", "no_seq_axis", "seq_axis_1", "vit", "cnn", "zigzag_bert",
        "sim_workers", "pipe", "moe", "chaos",
        "staleness"])
def test_config_refusals(flags, match):
    """JAX's checks of --sequence_parallel (driver.py:710-732,
    config.py:797-802) with its messages; SP with a pipe axis, with MoE,
    with elastic membership and with staleness is accepted (match None)
    by the port's Config and by JAX's, on the flag's grid."""
    if match is None:
        cfg = t_config.config_from_args(["--device", "cpu", *flags])
        j_config.config_from_args(["--device", "cpu", *flags])
        shape = flags[flags.index("--mesh_shape") + 1]
        assert mesh.grid_axes(cfg) == {
            a: int(n) for a, n in (kv.split("=") for kv in shape.split(","))}
        return
    with pytest.raises(ValueError, match=match):
        t_config.config_from_args(["--device", "cpu", *flags])


def test_config_accepts_the_three_modes():
    for mode, model in (("ring", "bert_tiny"), ("ring_zigzag", "gpt_tiny"),
                        ("all_to_all", "llama_tiny")):
        cfg = t_config.config_from_args(
            ["--device", "cpu", "--model", model, "--mesh_shape",
             "data=2,fsdp=2,seq=2,model=2", "--sequence_parallel", mode])
        assert mesh.grid_axes(cfg) == {"data": 2, "fsdp": 2, "seq": 2,
                                       "model": 2}


def test_config_accepts_a_seq_axis_without_sequence_parallel():
    """JAX train.py:455-459: without --sequence_parallel a seq axis is no
    part axis; its ranks are replicas of the step (flash allowed)."""
    cfg = t_config.config_from_args(
        ["--device", "cpu", "--model", "gpt_tiny", "--mesh_shape",
         "data=1,seq=2", "--attention_impl", "flash"])
    assert cfg.sequence_parallel == "none"
    assert mesh.grid_axes(cfg) == {"data": 1, "seq": 2}


def test_decode_refuses_a_sequence_parallel_model():
    """JAX decode.py:90: serving runs the dense twin."""
    model = get_model("gpt_tiny", num_classes=64, sp=_line(),
                      attention_impl="ring")
    with pytest.raises(ValueError, match="not servable"):
        spec_from_model(model)
