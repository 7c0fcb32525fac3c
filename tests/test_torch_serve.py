"""The port's serving stack (``..._torch/serve/``) against the JAX
package's ``serve/``: allocator, prefix keys and scheduler cases ported
from ``tests/test_serve.py`` (pages, stops, batched vs single, prefix keys
and cache, chunked prefill against the monolithic prefill, telemetry key
set), greedy streams equal to JAX ``ServeEngine`` + scheduler per family,
the same invalid config values refused by both ``Config``s, a JAX-trained
checkpoint served by both ``run_serve``s, and the port's own train ->
checkpoint -> serve path against repeated full forwards.

The JAX reference's own chunked prefill fails its GQA cases on this tree
(ROADMAP §C), so the port's chunked prefill is held against the port's
and JAX's monolithic prefill, never JAX's chunked one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    driver as j_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    ContinuousBatchingScheduler as JScheduler,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    Request as JRequest,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    ServeEngine as JServeEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve import (
    page_prefix_keys as j_page_prefix_keys,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve.api import (
    build_requests as j_build_requests,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.serve.api import (
    run_serve as j_run_serve,
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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    PageAllocator,
    Request,
    ServeEngine,
    page_prefix_keys,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve.api import (
    run_serve,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.utils.batching import (
    pad_to_bucket,
    pick_bucket,
)

VOCAB = 97
PROMPT = [5, 9, 3, 7, 2, 11, 4, 1]
FAMILIES = {
    "gpt": ("gpt_tiny", {}),
    "llama": ("llama_tiny", {}),
    "llama_gqa": ("llama_tiny", {"num_kv_heads": 2}),
    "gpt_moe": ("gpt_tiny", {"num_experts": 2, "capacity_factor": 2.0}),
}
GEOMETRY = dict(max_batch=3, page_size=4, max_pages=32,
                prompt_buckets=(8, 16), max_seq=24, seed=0)


@pytest.fixture(scope="module")
def served():
    """fam -> (JAX model, JAX variables, the port model with the same
    parameters), built once per module."""
    cache = {}

    def build(fam):
        if fam not in cache:
            name, kw = FAMILIES[fam]
            jm = j_get_model(name, num_classes=VOCAB, scan_layers=True, **kw)
            v = jm.init(jax.random.key(0), np.asarray(PROMPT, np.int32)[None])
            tm = get_model(name, num_classes=VOCAB, dtype=torch.float32, **kw)
            tm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                                weights.flax_to_torch(v["params"]).items()})
            cache[fam] = (jm, v, tm)
        return cache[fam]

    return build


def _engine(model, **kw):
    return ServeEngine(model, **{**GEOMETRY, **kw})


def _reqs(reqs):
    return [Request(**dataclasses.asdict(r)) for r in reqs]


# ----------------------------------------------------------------------
# Pages, stops, batched vs single (ported from tests/test_serve.py)
# ----------------------------------------------------------------------

class TestPages:
    def test_allocator_recycles_freed_pages_first(self):
        a = PageAllocator(8)
        first = a.alloc(3)
        assert first == [1, 2, 3] and a.in_use == 3
        a.free(first)
        assert a.alloc(3) == [1, 2, 3]
        assert a.alloc(99) is None
        assert a.in_use == 3 and a.peak_in_use == 3

    def test_allocator_guards(self):
        with pytest.raises(ValueError, match="trash page"):
            PageAllocator(1)
        a = PageAllocator(4)
        got = a.alloc(2)
        a.free(got)
        with pytest.raises(ValueError, match="double free"):
            a.free(got)
        with pytest.raises(ValueError, match="invalid page"):
            a.free([0])

    def test_scheduler_recycles_and_never_leaks(self, served):
        eng = _engine(served("gpt")[2], max_batch=2, max_pages=8)
        reqs = [Request(rid=i, prompt=PROMPT[:4], max_new_tokens=4)
                for i in range(4)]
        out = ContinuousBatchingScheduler(eng, eos_id=-1).run(reqs)
        assert out["evicted"] == 4 and out["pages"]["leaked"] == 0
        assert out["pages"]["peak_in_use"] <= 4
        assert out["pages"]["page_bytes"] == eng.page_bytes()
        assert eng.allocator.free_pages == 7

    def test_admission_blocks_under_full_occupancy(self, served):
        eng = _engine(served("gpt")[2], max_batch=2, max_pages=4, max_seq=8,
                      prompt_buckets=(4,))
        out = ContinuousBatchingScheduler(eng, eos_id=-1).run(
            [Request(rid=i, prompt=PROMPT[:4], max_new_tokens=4)
             for i in range(3)])
        assert out["admission_blocked"] > 0
        assert out["evicted"] == 3 and out["pages"]["leaked"] == 0

    def test_oversized_request_fails_at_submit(self, served):
        sched = ContinuousBatchingScheduler(_engine(served("gpt")[2]))
        with pytest.raises(ValueError, match="exceeds the largest"):
            sched.run([Request(rid=0, prompt=[1] * 17, max_new_tokens=2)])
        with pytest.raises(ValueError, match="max_seq"):
            sched.run([Request(rid=0, prompt=PROMPT, max_new_tokens=100)])
        for bad in ([1, VOCAB], [-3, 1]):
            with pytest.raises(ValueError, match="prompt ids"):
                sched.run([Request(rid=0, prompt=bad, max_new_tokens=2)])
        with pytest.raises(ValueError, match="unique"):
            sched.run([Request(rid=0, prompt=PROMPT), Request(
                rid=0, prompt=PROMPT)])

    def test_programs_are_the_buckets_and_one_decode_shape(self, served):
        eng = _engine(served("gpt")[2])
        ContinuousBatchingScheduler(eng).run(
            [Request(rid=i, prompt=(PROMPT * 2)[:3 + 5 * i],
                     max_new_tokens=3) for i in range(3)])
        assert eng.programs == {("prefill", (1, 8)), ("prefill", (1, 16)),
                                ("decode", (3, 1))}
        with pytest.raises(ValueError, match="shape"):
            eng.decode([1, 2], [3, 3], np.zeros((2, eng.pages_per_seq)),
                       [0.0, 0.0], [0, 1], [True, True])


class TestStops:
    def test_max_token_budget_stop(self, served):
        out = ContinuousBatchingScheduler(_engine(served("gpt")[2])).run(
            [Request(rid=0, prompt=PROMPT, max_new_tokens=3)])
        c = out["completions"][0]
        assert c.reason == "length" and len(c.tokens) == 3

    def test_eos_stop(self, served):
        model = served("gpt")[2]
        probe = ContinuousBatchingScheduler(_engine(model)).run(
            [Request(rid=0, prompt=PROMPT, max_new_tokens=4)])
        stream = probe["completions"][0].tokens
        eos = stream[1]
        out = ContinuousBatchingScheduler(_engine(model), eos_id=eos).run(
            [Request(rid=0, prompt=PROMPT, max_new_tokens=4)])
        c = out["completions"][0]
        assert c.reason == "eos" and c.tokens == stream[:stream.index(eos)
                                                        + 1]

    def test_request_timeout_evicts_stuck_sequence(self, served):
        eng = _engine(served("gpt")[2], max_batch=1)
        out = ContinuousBatchingScheduler(
            eng, request_timeout=1e-6).run(
                [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=8),
                 Request(rid=1, prompt=PROMPT[:4], max_new_tokens=8)])
        assert out["timed_out"] == 2 and out["evicted"] == 2
        for c in out["completions"]:
            assert c.reason == "timeout" and len(c.tokens) < 8
        assert out["pages"]["leaked"] == 0 and eng.allocator.in_use == 0
        with pytest.raises(ValueError, match="request_timeout"):
            ContinuousBatchingScheduler(eng, request_timeout=-1.0)

    def test_request_timeout_off_by_default(self, served):
        out = ContinuousBatchingScheduler(_engine(served("gpt")[2])).run(
            [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=3)])
        assert out["timed_out"] == 0
        assert out["completions"][0].reason == "length"


class TestBatchedVsSingle:
    @pytest.mark.parametrize("fam", ["gpt", "llama"])
    def test_token_streams_identical(self, served, fam):
        """Greedy and temperature requests, more than the slots: each
        stream equals its single-sequence decode on one reused engine
        (recycled pages hold stale KV the cache-offset mask hides)."""
        model = served(fam)[2]
        rng = np.random.default_rng(7)
        reqs = [Request(rid=i, prompt=rng.integers(1, VOCAB, 4 + i).tolist(),
                        max_new_tokens=5,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(5)]
        batched = ContinuousBatchingScheduler(_engine(model)).run(reqs)
        assert batched["admitted"] == batched["evicted"] == 5
        by_rid = {c.rid: c.tokens for c in batched["completions"]}
        single_eng = _engine(model)
        for r in reqs:
            single = ContinuousBatchingScheduler(
                single_eng, max_active=1).run(_reqs([r]))
            assert single["completions"][0].tokens == by_rid[r.rid]


# ----------------------------------------------------------------------
# Prefix keys and the prefix cache
# ----------------------------------------------------------------------

class TestPrefixKeys:
    def test_rolling_hash_keys_whole_prefix(self):
        keys = page_prefix_keys(PROMPT, 4)
        assert len(keys) == 2
        assert page_prefix_keys(PROMPT[:7], 4) == keys[:1]
        other = [1, 1, 1, 1] + PROMPT[4:]
        assert page_prefix_keys(other, 4)[0] != keys[0]
        assert page_prefix_keys(other, 4)[1] != keys[1]
        fork = PROMPT[:4] + [2, 2, 2, 2]
        assert page_prefix_keys(fork, 4)[0] == keys[0]
        assert page_prefix_keys(fork, 4)[1] != keys[1]

    @pytest.mark.parametrize("page", [1, 4, 16])
    def test_key_bytes_equal_jax(self, page):
        tokens = np.random.default_rng(page).integers(0, 50000, 70).tolist()
        assert page_prefix_keys(tokens, page) == j_page_prefix_keys(
            tokens, page)

    def test_refcount_lifecycle(self):
        a = PageAllocator(8)
        p0, p1 = a.alloc(2)
        a.register(b"k0", p0)
        a.claim(p0)
        assert a.refcount(p0) == 2 and a.in_use == 2
        a.free([p0, p1])
        assert a.refcount(p0) == 1 and a.cached_pages == 0
        a.free([p0])
        assert a.in_use == 0 and a.cached_pages == 1
        assert a.lookup([b"k0"]) == [p0]
        with pytest.raises(ValueError, match="double free"):
            a.free([p0])
        a.claim(p0)
        assert a.cached_pages == 0 and a.refcount(p0) == 1
        with pytest.raises(ValueError, match="no live reference"):
            a.register(b"kX", p1)
        with pytest.raises(ValueError, match="neither"):
            a.claim(7)
        assert a.in_use + a.cached_pages + a.free_pages == 7

    def test_lru_eviction_oldest_first_and_first_writer_wins(self):
        a = PageAllocator(5)
        pages = a.alloc(3)
        for i, p in enumerate(pages):
            a.register(bytes([i]), p)
        a.free(pages)
        assert a.cached_pages == 3 and a.free_pages == 1
        got = a.alloc(3)
        assert got == [4, 1, 2] and a.cache_evictions == 2
        assert a.lookup([bytes([0])]) == []
        assert a.lookup([bytes([2])]) == [3]
        assert a.register(bytes([2]), got[0]) is False
        assert a.register(bytes([9]), got[0]) is True
        assert a.register(bytes([10]), got[0]) is False

    def test_lookup_stops_at_first_miss(self):
        a = PageAllocator(8)
        pages = a.alloc(3)
        a.register(b"a", pages[0])
        a.register(b"c", pages[2])
        assert a.lookup([b"a", b"b", b"c"]) == [pages[0]]


class TestPrefixCache:
    @pytest.mark.parametrize("fam", ["gpt", "llama_gqa"])
    def test_hit_decode_trajectory_bitwise_vs_cold_twin(self, served, fam):
        model = served(fam)[2]
        reqs = [Request(rid=i, prompt=PROMPT, max_new_tokens=6,
                        temperature=0.0 if i == 0 else 0.8)
                for i in range(2)]
        cold = ContinuousBatchingScheduler(_engine(model)).run(_reqs(reqs))
        warm = ContinuousBatchingScheduler(
            _engine(model, prefix_cache=True)).run(reqs)
        for cc, cw in zip(cold["completions"], warm["completions"]):
            assert cw.tokens == cc.tokens
        assert warm["page_reuse_ratio"] == pytest.approx(1 / 4)
        assert warm["prefill_tokens_saved"] == 4
        assert warm["pages"]["leaked"] == 0
        assert warm["pages"]["cached_pages"] > 0
        assert cold["page_reuse_ratio"] == 0.0

    def test_shared_system_prompt_reuse_ratio(self, served):
        model = served("gpt")[2]
        rng = np.random.default_rng(11)
        sys_prefix = rng.integers(1, VOCAB, 8).tolist()
        reqs = [Request(rid=i, prompt=sys_prefix + rng.integers(
                    1, VOCAB, 4).tolist(), max_new_tokens=4)
                for i in range(4)]
        out = ContinuousBatchingScheduler(
            _engine(model, prefix_cache=True)).run(_reqs(reqs))
        assert out["page_reuse_ratio"] == pytest.approx(6 / 12)
        assert out["prefill_tokens_saved"] == 3 * 8
        assert out["pages"]["leaked"] == 0
        plain = _engine(model)
        for r in reqs:
            solo = ContinuousBatchingScheduler(plain, max_active=1).run(
                [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=4)])
            got = next(c for c in out["completions"] if c.rid == r.rid)
            assert got.tokens == solo["completions"][0].tokens

    def test_engine_headroom_guard(self, served):
        model = served("gpt")[2]
        with pytest.raises(ValueError, match="headroom"):
            _engine(model, prefix_cache=True, max_pages=7)
        _engine(model, prefix_cache=True, max_pages=8)


# ----------------------------------------------------------------------
# Chunked prefill, held against the monolithic prefill
# ----------------------------------------------------------------------

class TestChunkedPrefill:
    @pytest.mark.parametrize("fam", ["gpt", "llama", "llama_gqa"])
    @pytest.mark.parametrize("chunk", [4, 8])
    def test_logits_and_cache_vs_monolithic(self, served, fam, chunk):
        """The port's chunked prefill against the port's monolithic one
        and against JAX's monolithic prefill: the same token, and logits
        and written pages within fp32 atol 1e-5 (torch's CPU products
        round differently at 4 rows than at 16, so not to the bit)."""
        jm, v, model = served(fam)
        prompt = np.asarray(PROMPT + [6, 2, 8, 3], np.int32)
        kw = dict(prompt_buckets=(16,), max_seq=16)
        em = _engine(model, **kw)
        ec = _engine(model, prefill_chunk=chunk, **kw)
        row_m = em.table_row(em.allocator.alloc(em.pages_for(16)))
        row_c = ec.table_row(ec.allocator.alloc(ec.pages_for(16)))
        tok_m, lg_m = em.prefill(prompt, row_m, 0.0, 7)
        for s in range(0, len(prompt), chunk):
            tok_c, lg_c = ec.prefill_chunk_step(prompt[s:s + chunk], s,
                                                row_c, 0.0, 7)
        assert tok_c == tok_m
        close = lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
        close(lg_c, lg_m)
        close(ec.kcache[:, 1:5], em.kcache[:, 1:5])
        close(ec.vcache[:, 1:5], em.vcache[:, 1:5])
        assert ec.compiled_buckets == []
        je = JServeEngine(jm, v["params"], **{**GEOMETRY, **kw})
        row_j = je.table_row(je.allocator.alloc(je.pages_for(16)))
        tok_j, lg_j = je.prefill(prompt, row_j, 0.0, 7)
        assert tok_j == tok_c
        close(lg_c, lg_j)

    def test_streams_identical_and_chunk_counts(self, served):
        model = served("gpt")[2]
        rng = np.random.default_rng(3)
        reqs = [Request(rid=i, prompt=rng.integers(1, VOCAB,
                                                   5 + 3 * i).tolist(),
                        max_new_tokens=5,
                        temperature=0.0 if i % 2 == 0 else 0.7)
                for i in range(4)]
        mono = ContinuousBatchingScheduler(_engine(model)).run(_reqs(reqs))
        chk = ContinuousBatchingScheduler(
            _engine(model, prefill_chunk=4)).run(reqs)
        assert ([c.tokens for c in chk["completions"]]
                == [c.tokens for c in mono["completions"]])
        assert chk["prefill_chunks"] == 11 and mono["prefill_chunks"] == 0
        assert chk["prefill_buckets"] == [] and chk["pages"]["leaked"] == 0

    def test_chunks_interleave_with_running_decode(self, served):
        model = served("gpt")[2]
        eng = _engine(model, prefill_chunk=4)
        calls = []
        orig_chunk, orig_decode = eng.prefill_chunk_step, eng.decode
        eng.prefill_chunk_step = lambda *a, **k: (
            calls.append("chunk"), orig_chunk(*a, **k))[1]
        eng.decode = lambda *a, **k: (
            calls.append("decode"), orig_decode(*a, **k))[1]
        out = ContinuousBatchingScheduler(eng).run(
            [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=12),
             Request(rid=1, prompt=PROMPT * 2, max_new_tokens=2)])
        first = calls.index("chunk")
        last = len(calls) - 1 - calls[::-1].index("chunk")
        assert "decode" in calls[first:last]
        assert out["pages"]["leaked"] == 0
        solo = ContinuousBatchingScheduler(
            _engine(model, prefill_chunk=4)).run(
                [Request(rid=0, prompt=PROMPT[:4], max_new_tokens=12)])
        assert (next(c for c in out["completions"] if c.rid == 0).tokens
                == solo["completions"][0].tokens)

    def test_prompt_beyond_largest_bucket_admits(self, served):
        model = served("gpt")[2]
        long_prompt = (PROMPT * 3)[:18]
        with pytest.raises(ValueError, match="exceeds the largest"):
            ContinuousBatchingScheduler(_engine(model)).run(
                [Request(rid=0, prompt=long_prompt, max_new_tokens=2)])
        eng = _engine(model, prefill_chunk=4)
        out = ContinuousBatchingScheduler(eng).run(
            [Request(rid=0, prompt=long_prompt, max_new_tokens=2)])
        c = out["completions"][0]
        assert c.reason == "length" and len(c.tokens) == 2
        assert out["prefill_chunks"] == 5
        assert eng.programs == {("prefill_chunk", (1, 4)),
                                ("decode", (3, 1))}

    def test_engine_rejects_non_page_multiple_chunk(self, served):
        model = served("gpt")[2]
        for bad in (3, -4):
            with pytest.raises(ValueError, match="multiple of page_size"):
                _engine(model, prefill_chunk=bad)


# ----------------------------------------------------------------------
# Telemetry
# ----------------------------------------------------------------------

def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


class TestLatencyTelemetry:
    def test_key_set_equals_jax(self, served):
        jm, v, model = served("gpt")
        reqs = [Request(rid=0, prompt=PROMPT, max_new_tokens=3)]
        out = ContinuousBatchingScheduler(_engine(model)).run(reqs)
        jout = JScheduler(JServeEngine(jm, v["params"], **GEOMETRY)).run(
            [JRequest(**dataclasses.asdict(r)) for r in reqs])
        assert _key_tree(out) == _key_tree(jout)
        assert out["spec"] == jout["spec"]
        assert out["pages"]["draft_leaked"] == 0

    def test_ttft_split_from_decode_gaps(self, served):
        out = ContinuousBatchingScheduler(_engine(served("gpt")[2])).run(
            [Request(rid=0, prompt=PROMPT, max_new_tokens=5)])
        c = out["completions"][0]
        assert c.ttft_s is not None and c.ttft_s > 0
        assert len(c.decode_latencies_s) == len(c.tokens) - 1
        for key in ("p50", "p99", "mean"):
            assert out["ttft_ms"][key] > 0 and out["latency_ms"][key] > 0

    def test_zero_filled_schema_on_empty_run(self, served):
        out = ContinuousBatchingScheduler(_engine(served("gpt")[2])).run([])
        zero = {"p50": 0.0, "p99": 0.0, "mean": 0.0}
        assert out["latency_ms"] == zero and out["ttft_ms"] == zero
        assert out["page_reuse_ratio"] == 0.0
        assert out["prefill_tokens_saved"] == out["prefill_chunks"] == 0
        assert out["tokens_per_s"] == 0.0


# ----------------------------------------------------------------------
# Against the JAX engine and JAX's run_serve
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(FAMILIES))
def test_greedy_streams_equal_jax_engine(served, fam):
    """fp32 greedy (cross-framework temperature streams use different
    generators and are not compared), ragged prompts, more requests than
    slots, with the prefix cache on for the dense families."""
    jm, v, model = served(fam)
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, VOCAB, 4).tolist()
    reqs = [Request(rid=i, prompt=prefix + rng.integers(
        1, VOCAB, 1 + 2 * i).tolist(), max_new_tokens=6) for i in range(5)]
    kw = {} if fam == "gpt_moe" else {"prefix_cache": True}
    out = ContinuousBatchingScheduler(_engine(model, **kw)).run(_reqs(reqs))
    jout = JScheduler(JServeEngine(jm, v["params"], **GEOMETRY, **kw)).run(
        [JRequest(**dataclasses.asdict(r)) for r in reqs])
    assert ([c.tokens for c in out["completions"]]
            == [c.tokens for c in jout["completions"]])
    assert out["page_reuse_ratio"] == jout["page_reuse_ratio"]


@pytest.mark.parametrize("bad", [
    dict(serve_max_batch=0), dict(serve_page_size=0), dict(serve_max_pages=1),
    dict(serve_max_new_tokens=0), dict(serve_requests=0),
    dict(serve_temperature=-0.5), dict(serve_request_timeout=-1.0),
    dict(serve_prefill_chunk=5), dict(serve_prefill_chunk=-16),
    dict(serve_prompt_buckets="8,x"), dict(serve_prompt_buckets="0"),
    dict(serve_prefix_cache=True, serve_max_pages=6),
    dict(ckpt_keep=0), dict(checkpoint_every=-1), dict(checkpoint_every=2),
    dict(resume=True)], ids=lambda d: "-".join(f"{k}={v}"
                                               for k, v in d.items()))
def test_invalid_values_refused_by_both_configs(bad):
    with pytest.raises(ValueError) as je:
        JConfig(**bad)
    with pytest.raises(ValueError) as te:
        Config(**bad)
    first = lambda e: str(e.value).split()[0].strip("-:")
    assert first(te) == first(je)


def test_speculative_flags_name_their_queue():
    """Speculative decoding is ported (ROADMAP A.10b): the two flags arm it
    together, and one alone is refused as the JAX config refuses it."""
    cfg = Config(serve_draft_ckpt="d", serve_spec_tokens=2)
    assert cfg.serve_spec_tokens == 2
    for bad in (dict(serve_spec_tokens=2), dict(serve_draft_ckpt="d")):
        with pytest.raises(ValueError, match="TOGETHER"):
            JConfig(**bad)
        with pytest.raises(ValueError, match="TOGETHER"):
            Config(**bad)


def test_fast_path_flags_refused_by_training_runs():
    for flags in (dict(serve_prefix_cache=True, serve_max_pages=200),
                  dict(serve_draft_ckpt="/tmp/x", serve_spec_tokens=2)):
        with pytest.raises(ValueError, match="serving fast path"):
            t_driver.train_global(Config(device="cpu", **flags))


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_llama"))
    cfg = dict(model="llama_tiny", num_kv_heads=2, dataset="synthetic_lm",
               epochs_global=1, epochs_local=1, batch_size=8,
               limit_train_samples=64, limit_eval_samples=16,
               compute_dtype="float32", augment=False, checkpoint_dir=d,
               checkpoint_every=1, seed=3)
    j_driver.train_global(JConfig(num_workers=1, **cfg), progress=False)
    return d


def test_jax_checkpoint_served_by_both_run_serves(jax_trained):
    """The same flags give the same requests (numpy draws) and the same
    greedy completions from JAX's run_serve and the port's."""
    kw = dict(checkpoint_dir=jax_trained, serve_max_batch=3,
              serve_page_size=4, serve_max_pages=40,
              serve_prompt_buckets="8,16", serve_requests=6,
              serve_max_new_tokens=6, serve_prefill_chunk=8,
              serve_prefix_cache=True)
    ours = run_serve(Config(device="cpu", **kw))
    theirs = j_run_serve(JConfig(**kw))
    assert ([c.tokens for c in ours["completions"]]
            == [c.tokens for c in theirs["completions"]])
    assert [r.prompt for r in ours["requests"]] == [
        r.prompt for r in j_build_requests(JConfig(**kw),
                                           ours["engine"].spec.vocab)]
    assert ours["serve"]["pages"]["leaked"] == 0
    assert ours["serve"]["programs"] == [["decode", [3, 1]],
                                         ["prefill_chunk", [1, 8]]]
    with pytest.raises(ValueError, match="does not match"):
        run_serve(Config(device="cpu", model="gpt_tiny", **kw),
                  model_flag_given=True)


def test_port_train_checkpoint_serve_greedy_matches_argmax(tmp_path):
    """main --checkpoint_dir, then main serve: greedy ids equal the argmax
    of repeated full forwards of the trained model (JAX
    test_serve.py:523-558)."""
    d = str(tmp_path / "ck")
    res = t_main.run([
        "--device", "cpu", "--model", "gpt_tiny", "--dataset",
        "synthetic_lm", "--epochs_global", "1", "--epochs_local", "1",
        "--batch_size", "8", "--limit_train_samples", "64",
        "--limit_eval_samples", "16", "--compute_dtype", "float32",
        "--no_augment", "--aggregation_by", "weights", "--checkpoint_dir", d,
        "--checkpoint_every", "1", "--seed", "3", "--out_dir",
        str(tmp_path / "plots")])
    out = t_main.run([
        "serve", "--device", "cpu", "--checkpoint_dir", d, "--serve_prompt",
        "5,9,3,7,2", "--serve_requests", "2", "--serve_max_new_tokens", "4",
        "--serve_max_batch", "2", "--serve_page_size", "8",
        "--serve_max_pages", "16", "--serve_prompt_buckets", "8"])
    ids = [5, 9, 3, 7, 2]
    with torch.no_grad():
        for _ in range(4):
            lg = res["model"](torch.tensor([ids]))
            ids.append(int(lg[0, -1].argmax()))
    for c in out["completions"]:
        assert c.tokens == ids[5:]
    assert out["serve"]["tokens_generated"] == 8
    assert out["serve"]["pages"]["leaked"] == 0
    assert out["serve"]["restore_ms"] > 0


def test_bucket_helpers():
    assert pick_bucket(5, (8, 16)) == 8 and pick_bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError, match="largest bucket"):
        pick_bucket(17, (8, 16))
    assert pad_to_bucket(np.array([3, 1, 4]), 8).tolist() == [3, 1, 4, 0, 0,
                                                              0, 0, 0]
    with pytest.raises(ValueError):
        pad_to_bucket(np.array([1] * 9), 8)
