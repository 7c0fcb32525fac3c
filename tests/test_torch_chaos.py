"""The port's chaos harness (``..._torch/chaos.py``) and the elastic
flags of its config, held against the JAX package's on the same inputs:
the spec grammar, the seeded random schedule, the wall perturbations,
the straggler policy's verdict sequences, the eager validation, and the
resolution of ``--param_residency`` / ``--shard_redundancy`` over the
grid of sync mode x placement x aggregation x staleness x worker count
(JAX's side: its engine's resolution, built on an N-device CPU mesh)."""

import dataclasses
import itertools

import jax
import numpy as np
import pytest

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    chaos as j_chaos,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.train import (
    LocalSGDEngine as JEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    chaos as t_chaos,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
    config_from_args,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SPECS = ["kill@1:w3,join@2,crash@3:w0,nan@4:w1",
         "slow@2:w1x2.5; stall@3:w0+40*2, join@5",
         "join@1,join@1,kill@4:w5", "nan@2:w1,nan@2:w3,nan@4:w0",
         "stall@1:w2+7.5"]
BAD_SPECS = ["kill@1", "join@2:w1", "crash@0:w1", "slow@2:w1", "slow@2:w1x0",
             "stall@2:w1", "kill@2:w1+30", "nan@2:w1*3", "boom@2:w1",
             "kill@x:w1", "crash@2:w1x2"]


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_as_jax_parses(spec):
    assert _fields(t_chaos.parse_chaos_spec(spec)) == _fields(
        j_chaos.parse_chaos_spec(spec))
    assert [e.describe() for e in t_chaos.parse_chaos_spec(spec)] == [
        e.describe() for e in j_chaos.parse_chaos_spec(spec)]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_malformed_spec_rejected_as_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        j_chaos.parse_chaos_spec(bad)
    with pytest.raises(ValueError) as terr:
        t_chaos.parse_chaos_spec(bad)
    assert str(terr.value) == str(jerr.value)
    # and eagerly, at config time, in both
    with pytest.raises(ValueError):
        JConfig(chaos=bad)
    with pytest.raises(ValueError):
        Config(chaos=bad)


@pytest.mark.parametrize("seed,kinds", [
    (0, j_chaos.DEFAULT_RANDOM_KINDS), (3, ("crash", "nan")),
    (11, j_chaos.KINDS), (5, ("kill", "join"))])
def test_random_schedule_and_queries_match_jax(seed, kinds):
    """The seeded draw, the round-0 pinning and every schedule query
    (membership events, nan targets, resolved targets, perturbed walls)
    over a roster that loses and gains workers."""
    jev = j_chaos.random_events(seed, 24, 8, kinds=kinds)
    tev = t_chaos.random_events(seed, 24, 8, kinds=tuple(kinds))
    assert _fields(tev) == _fields(jev)
    js, ts = j_chaos.ChaosSchedule(jev), t_chaos.ChaosSchedule(tev)
    js.pin_wall_targets(range(4))
    ts.pin_wall_targets(range(4))
    assert _fields(ts.events) == _fields(js.events)
    walls = np.random.default_rng(seed).uniform(0.5, 2.0, (8, 6))
    rosters = [[0, 1, 2, 3], [0, 1, 3], [1, 3, 4], [1, 3, 4, 5]]
    for rnd, ids in itertools.product(range(8), rosters):
        assert ([e.describe() for e in ts.membership_events(rnd)]
                == [e.describe() for e in js.membership_events(rnd)])
        assert ts.nan_targets(rnd, ids) == js.nan_targets(rnd, ids)
        w = walls[rnd][:len(ids)]
        np.testing.assert_array_equal(ts.perturb_walls(rnd, ids, w),
                                      js.perturb_walls(rnd, ids, w))
        for te, je in zip(ts.events, js.events):
            assert ts.resolve_target(te, ids) == js.resolve_target(je, ids)
    assert all(ts.has_kind(k) == js.has_kind(k) for k in j_chaos.KINDS)


def test_schedule_from_config_matches_jax():
    for kw in (dict(chaos="kill@1:w1,slow@2:w0x3"),
               dict(chaos="random", chaos_seed=7, chaos_events=6,
                    num_workers=3, epochs_global=6,
                    chaos_kinds="kill,join,crash,nan")):
        j = j_chaos.ChaosSchedule.from_config(JConfig(**kw))
        t = t_chaos.ChaosSchedule.from_config(Config(**kw))
        assert _fields(t.events) == _fields(j.events)
    assert t_chaos.ChaosSchedule.from_config(Config()) is None


@pytest.mark.parametrize("seed", range(4))
def test_straggler_verdicts_match_jax(seed):
    """Retry/backoff ladder, departures, recoveries and the distinct
    CRASHED verdict of a non-finite wall, round after round, with the
    resets of membership boundaries."""
    rng = np.random.default_rng(seed)
    jp = j_chaos.StragglerPolicy(1.0, 0.5, retries=2, backoff=0.5)
    tp = t_chaos.StragglerPolicy(1.0, 0.5, retries=2, backoff=0.5)
    ids = [0, 1, 2, 3]
    for rnd in range(24):
        walls = rng.choice([0.4, 1.2, 1.6, 2.1, 3.5, np.inf], size=len(ids),
                           p=[0.4, 0.15, 0.15, 0.15, 0.1, 0.05])
        assert tp.observe(ids, walls) == jp.observe(ids, walls)
        assert [tp.deadline(w) for w in ids] == [jp.deadline(w) for w in ids]
        if rnd % 7 == 6:
            tp.reset()
            jp.reset()
        if rnd % 5 == 4:
            tp.forget(ids[0])
            jp.forget(ids[0])


@pytest.mark.parametrize("kw,match", [
    (dict(chaos_kinds="kill,typo"), "unknown chaos kind"),
    (dict(chaos_kinds=" , "), "selects no event"),
    (dict(chaos_events=-1), "must be >= 0"),
    (dict(chaos_retries=-1), "must be >= 0"),
    (dict(chaos_grace=-1.0), "must be >= 0"),
    (dict(chaos_backoff=-0.5), "must be >= 0"),
    (dict(elastic_min_workers=0), "elastic_min_workers must be >= 1"),
    (dict(chaos="kill@1:w0", sim_workers=4), "cannot combine with --sim"),
    (dict(chaos="kill@1:w0", sync_staleness=1, aggregation_by="weights"),
     "cannot combine with --sync_staleness"),
    (dict(param_residency="resident", topology="ring"),
     "gossip blends are"),
    (dict(param_residency="resident", sync_mode="dense"),
     "no scatter whose output"),
    (dict(param_residency="resident", opt_placement="replicated"),
     "SHARD-side apply"),
    (dict(shard_redundancy="buddy", topology="double_ring"),
     "nothing for a buddy"),
    (dict(shard_redundancy="buddy", sync_mode="dense"),
     "nothing for a buddy"),
    (dict(shard_redundancy="buddy", sim_workers=2),
     "cannot combine with --sim_workers"),
])
def test_elastic_flags_rejected_as_jax_rejects(kw, match):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError, match=match):
            cfg_cls(**kw)


def test_chaos_kinds_parse_as_jax():
    for kinds in ("kill,crash,nan", "nan, kill ,nan", "stall"):
        assert (Config(chaos_kinds=kinds).parse_chaos_kinds()
                == JConfig(chaos_kinds=kinds).parse_chaos_kinds())


def test_elastic_flags_parse_and_run_in_the_port():
    cfg = config_from_args([
        "--chaos", "kill@1:w1,join@2,crash@3:w0,nan@4:w2", "--chaos_seed",
        "3", "--chaos_events", "5", "--chaos_kinds", "kill,nan",
        "--chaos_grace", "2.5", "--chaos_retries", "2", "--chaos_backoff",
        "0.25", "--elastic_min_workers", "2", "--param_residency",
        "resident", "--shard_redundancy", "buddy", "--aggregation_by",
        "weights", "--sync_mode", "sharded"])
    assert (cfg.chaos_retries, cfg.elastic_min_workers) == (2, 2)
    assert cfg.resolve_param_residency(4) == "resident"
    assert cfg.resolve_shard_redundancy(4) == "buddy"
    assert cfg.resolve_param_residency(1) == "replicated"
    assert cfg.resolve_shard_redundancy(1) == "off"


_MLP = j_get_model("mlp", num_classes=10)


@pytest.mark.parametrize("staleness", [0, 1])
@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("by", ["weights", "gradients"])
@pytest.mark.parametrize("placement", ["auto", "replicated", "sharded"])
@pytest.mark.parametrize("mode", ["auto", "dense", "sharded"])
def test_residency_and_redundancy_resolve_as_jax(mode, placement, by, how,
                                                 staleness):
    """For every residency x redundancy flag and N in 1, 2, 4: the port's
    resolution is the JAX engine's (``param_residency``, ``buddy_on``), and
    a combination JAX refuses, the port refuses."""
    devices = jax.devices()
    for residency, redundancy in itertools.product(
            ("auto", "replicated", "resident"), ("auto", "buddy", "off")):
        kw = dict(sync_mode=mode, opt_placement=placement, aggregation_by=by,
                  aggregation_type=how, sync_staleness=staleness,
                  param_residency=residency, shard_redundancy=redundancy)
        try:
            jcfg = JConfig(**kw)
        except ValueError:
            with pytest.raises(ValueError):
                Config(**kw)
            continue
        tcfg = Config(**kw)
        assert tcfg.resolve_sync_mode() == jcfg.resolve_sync_mode("cpu")
        for n in (1, 2, 4):
            eng = JEngine(_MLP, build_mesh({"data": n}, devices[:n]), jcfg)
            assert tcfg.resolve_param_residency(n) == eng.param_residency
            assert (tcfg.resolve_shard_redundancy(n) == "buddy") == \
                eng.buddy_on, (kw, n)
