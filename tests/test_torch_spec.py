"""Speculative decoding in the port (``..._torch/serve/``, ``models/decode.
speculative_accept``) against the JAX package's: the accept step and
``paired_admit`` equal JAX's, the speculative streams equal the port's own
non-speculative twin token for token and the JAX engine's with a draft
(tokens and the accepted count of every tick) on the same weights, with
the prefix cache and chunked prefill, batched and alone, under EOS, with
the target as its own draft; the pairing and config refusals are JAX's,
the telemetry keys are JAX's, and no page leaks in either pool.  fp32
throughout (the JAX decode traces only there, ROADMAP §C)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    decode as j_decode,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    ContinuousBatchingScheduler as JScheduler,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    PageAllocator as JPageAllocator,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    Request as JRequest,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    ServeEngine as JServeEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve.cache import (
    paired_admit as j_paired_admit,
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
    decode as t_decode,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    PageAllocator,
    Request,
    ServeEngine,
    paired_admit,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

VOCAB = 97
PROMPT = [5, 9, 3, 7, 2, 11, 4, 1]
FAMILIES = {
    "gpt": ("gpt_tiny", {}),
    "llama_gqa": ("llama_tiny", {"num_kv_heads": 2}),
    "gpt_moe": ("gpt_tiny", {"num_experts": 2, "capacity_factor": 2.0}),
}
GEOMETRY = dict(max_batch=3, page_size=4, max_pages=32,
                prompt_buckets=(8, 16), max_seq=24, seed=0)


@pytest.fixture(scope="module")
def served():
    """(fam, init key) -> (JAX model, JAX params, the port model with the
    same parameters); key 0 is the target, key 99 an independently drawn
    draft of the same family (so the two really disagree)."""
    cache = {}

    def build(fam, key=0):
        if (fam, key) not in cache:
            name, kw = FAMILIES[fam]
            jm = j_get_model(name, num_classes=VOCAB, scan_layers=True, **kw)
            v = jm.init(jax.random.key(key),
                        np.asarray(PROMPT, np.int32)[None])
            tm = get_model(name, num_classes=VOCAB, dtype=torch.float32, **kw)
            tm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                                weights.flax_to_torch(v["params"]).items()})
            cache[fam, key] = (jm, v["params"], tm)
        return cache[fam, key]

    return build


def _engine(model, **kw):
    return ServeEngine(model, **{**GEOMETRY, **kw})


def _pair(target, draft, k, **kw):
    """A target engine paired with a draft engine of the same geometry."""
    return ServeEngine(target, draft=_engine(draft, **kw), spec_tokens=k,
                       **{**GEOMETRY, **kw})


def _reqs(n=3, new=6):
    return [Request(rid=i, prompt=PROMPT[:4 + 2 * i], max_new_tokens=new)
            for i in range(n)]


def _streams(out):
    return [c.tokens for c in out["completions"]]


def _leak_free(out):
    assert out["pages"]["leaked"] == 0 and out["pages"]["draft_leaked"] == 0


# ----------------------------------------------------------------------
# The accept step and the paired admission against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_speculative_accept_equals_jax(k):
    """Seeded random logits; row 0 forced to match everywhere (the k-1
    cap), row 1 to miss at once (total rejection): integer for integer."""
    rng = np.random.default_rng(5 + k)
    logits = rng.standard_normal((6, k + 1, 13)).astype(np.float32)
    draft = rng.integers(0, 13, (6, k)).astype(np.int32)
    draft[0] = logits[0].argmax(-1)[:k]
    draft[1, 0] = (logits[1, 0].argmax() + 1) % 13
    draft[2, :k - 1] = logits[2].argmax(-1)[:k - 1]   # a partial prefix
    j_em, j_acc = j_decode.speculative_accept(logits, draft)
    em, acc = t_decode.speculative_accept(torch.from_numpy(logits),
                                          torch.from_numpy(draft))
    assert em.dtype == acc.dtype == torch.int32
    np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    assert int(acc[0]) == k - 1 and int(acc[1]) == 0
    assert (em.numpy()[np.arange(6), acc.numpy()] == logits.argmax(-1)[
        np.arange(6), acc.numpy()]).all()       # the bonus is the target's


def test_paired_admit_equals_jax():
    """The same operations on both packages' allocator pairs: success,
    prefix hits claimed in both pools, rollback when either pool is short,
    and the refusal of unequal hit runs."""
    def run(alloc_cls, admit):
        log = []
        tgt, dra = alloc_cls(8), alloc_cls(8)
        got = admit(tgt, dra, [], [], 3)
        log.append((got, tgt.in_use, dra.in_use))
        tgt.register(b"k0", got[0][0])
        dra.register(b"k0", got[1][0])
        tgt.free(got[0])
        dra.free(got[1])
        hits = tgt.lookup([b"k0"]), dra.lookup([b"k0"])
        got = admit(tgt, dra, *hits, 4)       # hits claimed in both pools
        log.append((hits, got, tgt.in_use, dra.in_use,
                    tgt.refcount(hits[0][0]), dra.refcount(hits[1][0])))
        small = alloc_cls(4)                  # 3 usable pages
        pin = small.alloc(2)
        log.append((admit(tgt, small, [], [], 3), tgt.in_use, small.in_use))
        small.free(pin)
        short = alloc_cls(4)
        short.alloc(3)
        log.append((admit(short, dra, [], [], 3), short.in_use, dra.in_use))
        with pytest.raises(ValueError, match="equal length"):
            admit(tgt, dra, [1], [], 2)
        return log

    assert run(PageAllocator, paired_admit) == run(JPageAllocator,
                                                   j_paired_admit)


# ----------------------------------------------------------------------
# Streams: the non-speculative twin, the JAX engine, composition
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("fam", ["gpt", "llama_gqa"])
def test_streams_equal_nonspeculative_twin(served, fam, k):
    """THE gate: a draft that really disagrees changes when tokens appear,
    never which: every stream equals the plain run's."""
    target, draft = served(fam)[2], served(fam, 99)[2]
    twin = ContinuousBatchingScheduler(_engine(target)).run(_reqs())
    eng = _pair(target, draft, k)
    out = ContinuousBatchingScheduler(eng).run(_reqs())
    assert _streams(out) == _streams(twin)
    assert out["spec"]["verify_steps"] > 0
    assert out["spec"]["draft_steps"] == k * out["spec"]["verify_steps"]
    assert eng.programs == {("prefill", (1, 8)), ("verify", (3, k + 1))}
    assert eng.draft.programs == {("prefill", (1, 8)), ("decode", (3, 1))}
    _leak_free(out)


def _record_acc(engine_cls, monkeypatch):
    """Wrap ``engine_cls.verify`` to record each tick's accepted counts of
    the active rows."""
    ticks = []
    verify = engine_cls.verify

    def rec(self, tokens, lengths, table, active):
        emitted, acc = verify(self, tokens, lengths, table, active)
        ticks.append([int(a) for a, on in zip(np.asarray(acc), active)
                      if on])
        return emitted, acc

    monkeypatch.setattr(engine_cls, "verify", rec)
    return ticks


@pytest.mark.parametrize("fam", ["gpt", "llama_gqa"])
def test_streams_and_acceptance_equal_jax_engine(served, fam, monkeypatch):
    """The JAX ServeEngine paired with the same draft, on the same weights,
    requests and k: equal streams and equal accepted counts tick by tick,
    with more requests than slots and the prefix cache on."""
    jm, jp, tm = served(fam)
    jdm, jdp, tdm = served(fam, 99)
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, VOCAB, 4).tolist()
    reqs = [Request(rid=i, prompt=prefix + rng.integers(
        1, VOCAB, 1 + 2 * i).tolist(), max_new_tokens=7) for i in range(5)]
    kw = dict(prefix_cache=True)
    t_ticks = _record_acc(ServeEngine, monkeypatch)
    out = ContinuousBatchingScheduler(_pair(tm, tdm, 3, **kw)).run(
        [Request(**dataclasses.asdict(r)) for r in reqs])
    j_ticks = _record_acc(JServeEngine, monkeypatch)
    jeng = JServeEngine(jm, jp, draft=JServeEngine(jdm, jdp, **GEOMETRY,
                                                    **kw),
                        spec_tokens=3, **GEOMETRY, **kw)
    jout = JScheduler(jeng).run([JRequest(**dataclasses.asdict(r))
                                 for r in reqs])
    assert _streams(out) == _streams(jout)
    assert t_ticks == j_ticks and len(t_ticks) > 0
    assert out["spec"] == jout["spec"]
    assert out["page_reuse_ratio"] == jout["page_reuse_ratio"]
    _leak_free(out)


def test_composes_with_prefix_cache_and_chunked_prefill(served):
    """Speculation, warm prefix hits and chunked prefill at once: cold and
    warm runs equal the twin's streams, in both pools."""
    target, draft = served("gpt")[2], served("gpt", 99)[2]
    kw = dict(max_pages=48, prefix_cache=True, prefill_chunk=4)
    def reqs():
        return [Request(rid=i, prompt=PROMPT, max_new_tokens=6)
                for i in range(2)]
    base = _streams(ContinuousBatchingScheduler(_engine(target)).run(reqs()))
    eng = _pair(target, draft, 4, **kw)
    cold = ContinuousBatchingScheduler(eng).run(reqs())
    warm = ContinuousBatchingScheduler(eng).run(reqs())
    assert _streams(cold) == base and _streams(warm) == base
    assert warm["page_reuse_ratio"] > 0 and warm["prefill_chunks"] > 0
    assert eng.programs == {("prefill_chunk", (1, 4)), ("verify", (3, 5))}
    assert eng.draft.programs == {("prefill_chunk", (1, 4)),
                                  ("decode", (3, 1))}
    _leak_free(warm)
    assert eng.draft.allocator.cached_pages == eng.allocator.cached_pages > 0


def test_batched_equals_single(served):
    """A slot's accepted tokens do not depend on its batch neighbours."""
    target, draft = served("gpt")[2], served("gpt", 99)[2]
    reqs = [Request(rid=i, prompt=PROMPT[:3 + i], max_new_tokens=5)
            for i in range(3)]
    eng = _pair(target, draft, 2)
    batched = ContinuousBatchingScheduler(eng).run(reqs)
    by_rid = {c.rid: c.tokens for c in batched["completions"]}
    for r in reqs:
        single = ContinuousBatchingScheduler(eng, max_active=1).run(
            [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5)])
        assert single["completions"][0].tokens == by_rid[r.rid]
        _leak_free(single)


def test_self_draft_accepts_every_proposal(served, monkeypatch):
    """The target as its own draft (fp32): every tick's drafts all match,
    so each tick accepts the cap k-1 and emits k tokens; the telemetry
    reads JAX's deterministic bar, acceptance (k-1)/k and target steps per
    token 1/k, and the streams equal the twin's."""
    target = served("gpt")[2]
    k = 4
    ticks = _record_acc(ServeEngine, monkeypatch)
    eng = _pair(target, target, k, max_seq=32)
    def reqs():
        return [Request(rid=i, prompt=PROMPT, max_new_tokens=17)
                for i in range(2)]
    out = ContinuousBatchingScheduler(eng).run(reqs())
    assert ticks and all(a == k - 1 for tick in ticks for a in tick)
    assert out["spec"]["acceptance_rate"] == (k - 1) / k
    assert out["spec"]["target_steps_per_token"] == 1 / k
    twin = ContinuousBatchingScheduler(_engine(target, max_seq=32)).run(
        reqs())
    assert _streams(out) == _streams(twin)


def test_eos_truncates_a_burst_where_the_twin_stops(served):
    target = served("gpt")[2]
    stream = ContinuousBatchingScheduler(_engine(target)).run(
        [Request(rid=0, prompt=PROMPT, max_new_tokens=6)])["completions"][
            0].tokens
    eos = stream[2]                   # the third token: mid-burst at k=4
    out = ContinuousBatchingScheduler(_pair(target, target, 4),
                                      eos_id=eos).run(
        [Request(rid=0, prompt=PROMPT, max_new_tokens=6)])
    c = out["completions"][0]
    assert c.reason == "eos" and c.tokens == stream[:stream.index(eos) + 1]
    _leak_free(out)


def test_pools_stay_paired_under_backpressure(served):
    """Tight twin pools, more requests than fit: admission waits, both
    pools' occupancy moves together, and both end empty."""
    target, draft = served("gpt")[2], served("gpt", 99)[2]
    eng = _pair(target, draft, 2, max_pages=10)
    out = ContinuousBatchingScheduler(eng).run(
        [Request(rid=i, prompt=PROMPT[:4 + i % 3], max_new_tokens=8)
         for i in range(6)])
    assert out["admission_blocked"] > 0
    assert out["pages"]["draft_peak_in_use"] == out["pages"]["peak_in_use"]
    assert eng.allocator.in_use == eng.draft.allocator.in_use == 0
    assert len(out["completions"]) == 6


# ----------------------------------------------------------------------
# Refusals and telemetry
# ----------------------------------------------------------------------

def test_pairing_rejections(served):
    target, draft = served("gpt")[2], served("gpt", 99)[2]
    with pytest.raises(ValueError, match="BOTH"):
        _engine(target, draft=_engine(draft))
    with pytest.raises(ValueError, match="BOTH"):
        _engine(target, spec_tokens=4)
    other = get_model("gpt_tiny", num_classes=VOCAB + 1,
                      dtype=torch.float32)
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        _engine(target, draft=_engine(other), spec_tokens=2)
    with pytest.raises(ValueError, match="MoE draft"):
        _engine(target, draft=_engine(served("gpt_moe")[2]), spec_tokens=2)
    with pytest.raises(ValueError, match="nest"):
        _engine(target, draft=_pair(draft, draft, 2), spec_tokens=2)
    for geo in (dict(page_size=8), dict(max_batch=2), dict(max_seq=16),
                dict(max_pages=16)):
        with pytest.raises(ValueError, match="geometry"):
            _engine(target, draft=_engine(draft, **geo), spec_tokens=2)
    with pytest.raises(ValueError, match="temperature"):
        ContinuousBatchingScheduler(_pair(target, draft, 2)).run(
            [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=2,
                     temperature=0.7)])
    with pytest.raises(ValueError, match="spec_tokens"):
        ContinuousBatchingScheduler(_pair(target, draft, 4)).run(
            [Request(rid=0, prompt=PROMPT, max_new_tokens=14)])


@pytest.mark.parametrize("bad,match", [
    (dict(serve_draft_ckpt="/tmp/x", serve_spec_tokens=-1), ">= 1"),
    (dict(serve_draft_ckpt="/tmp/x", serve_spec_tokens=4,
          serve_temperature=0.8), "rejection-sampling"),
    (dict(serve_prefix_cache=True, serve_max_pages=7,
          serve_draft_ckpt="/tmp/x", serve_spec_tokens=16),
     "serve_spec_tokens"),
], ids=["negative_k", "temperature", "headroom"])
def test_config_refusals_equal_jax(bad, match):
    """JAX test_serve.py:995-1011: both configs refuse with the reason
    (the flags armed alone: test_torch_serve.py)."""
    with pytest.raises(ValueError, match=match):
        JConfig(**bad)
    with pytest.raises(ValueError, match=match):
        Config(**bad)
    Config(serve_prefix_cache=True, serve_max_pages=7)


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_telemetry_keys_equal_jax_and_zero_fill_without_draft(served):
    jm, jp, tm = served("gpt")
    reqs = [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=3)]
    plain = ContinuousBatchingScheduler(_engine(tm)).run(reqs)
    assert plain["spec"] == {"acceptance_rate": 0.0, "draft_steps": 0,
                             "verify_steps": 0,
                             "target_steps_per_token": 0.0}
    assert plain["pages"]["draft_peak_in_use"] == 0
    assert plain["pages"]["draft_leaked"] == 0
    spec = ContinuousBatchingScheduler(_pair(tm, tm, 2)).run(reqs)
    jspec = JScheduler(JServeEngine(
        jm, jp, draft=JServeEngine(jm, jp, **GEOMETRY), spec_tokens=2,
        **GEOMETRY)).run([JRequest(**dataclasses.asdict(r)) for r in reqs])
    assert _key_tree(spec) == _key_tree(jspec) == _key_tree(plain)
    assert spec["pages"]["draft_peak_in_use"] > 0


def test_main_serve_with_a_draft_checkpoint(tmp_path):
    """`main serve --serve_draft_ckpt D --serve_spec_tokens 4` off a port
    checkpoint served as its own draft: the streams equal `main serve`
    without the draft, acceptance is JAX's self-draft bar, the draft's
    programs are reported, and both pools end empty."""
    d = str(tmp_path / "ck")
    t_main.run(["--device", "cpu", "--model", "gpt_tiny", "--dataset",
                "synthetic_lm", "--epochs_global", "1", "--epochs_local",
                "1", "--batch_size", "8", "--limit_train_samples", "32",
                "--limit_eval_samples", "8", "--probe_batches", "1",
                "--compute_dtype", "float32", "--no_augment",
                "--checkpoint_dir", d, "--checkpoint_every", "1",
                "--out_dir", str(tmp_path / "plots")])
    argv = ["serve", "--device", "cpu", "--checkpoint_dir", d,
            "--serve_requests", "3", "--serve_max_new_tokens", "9",
            "--serve_max_batch", "2", "--serve_page_size", "4",
            "--serve_max_pages", "24", "--serve_prompt_buckets", "8"]
    plain = t_main.run(argv)
    spec = t_main.run([*argv, "--serve_draft_ckpt", d,
                       "--serve_spec_tokens", "4"])
    assert _streams(spec) == _streams(plain)
    tele = spec["serve"]
    assert tele["spec"]["acceptance_rate"] == 0.75
    assert tele["programs"] == [["prefill", [1, 8]], ["verify", [2, 5]]]
    assert tele["draft_programs"] == [["decode", [2, 1]], ["prefill", [1, 8]]]
    assert tele["memory"]["draft_params_bytes"] == tele["memory"][
        "params_bytes"]
    _leak_free(tele)
