"""The port's elastic membership (``..._torch/elastic.py``) and its
host-side layouts (``..._torch/comms.py``: the round optimizer's and the
scatter-resident parameters' re-layouts, the buddy rows, the crashed
rows' restore and the buddy hop's bytes), held against the JAX
package's functions on the same numpy inputs made from a seed.  They are
copies and permutations, so they are held bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    chaos as j_chaos,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    elastic as j_elastic,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.train import (
    TrainState as JTrainState,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    chaos as t_chaos,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    elastic as t_elastic,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    train as t_train,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# one worker's parameters: JAX flattens the dict in key order, which is
# the template's order (an identity wire layout)
SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4)}
BUCKET = 64           # bytes: three buckets, pads at every worker count


def _template():
    import torch
    tensors = [torch.zeros(s) for s in SHAPES.values()]
    return comms.ParamsTemplate.of(list(SHAPES), tensors)


def _jtmpl():
    return {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in SHAPES.items()}


def _rows(rng, n):
    return {k: rng.standard_normal((n, *s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaves(tree):
    return [np.asarray(tree[k]) for k in SHAPES]


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


# ----------------------------------------------------------------------
# the membership plan (JAX tests/test_elastic.py TestMembershipPlan)
# ----------------------------------------------------------------------

PLAN_CASES = [
    # (n, plan kwargs, [spec per boundary])
    (4, {}, ["kill@1:w1,join@1", "join@2"]),
    (4, {}, ["kill@1:w3", "join@2", "join@3,kill@3:w0"]),
    (2, {"min_workers": 2}, ["kill@1:w0", "kill@2:w1,join@2"]),
    (3, {"max_workers": 3}, ["join@1", "kill@2:w0,join@2", "join@3"]),
    (3, {}, ["kill@1:w9", "kill@2:w1,kill@2:w1"]),
    (4, {"min_workers": 3}, ["kill@1:w0,kill@1:w1,join@1"]),
]


def _change(ch):
    return (ch.kept_positions, ch.worker_ids, ch.joiner_ids, ch.applied,
            ch.rejected, ch.changed)


@pytest.mark.parametrize("n,kw,specs", PLAN_CASES)
def test_membership_plan_applies_as_jax(n, kw, specs):
    jp = j_elastic.MembershipPlan(n, **kw)
    tp = t_elastic.MembershipPlan(n, **kw)
    for spec in specs:
        je = j_chaos.parse_chaos_spec(spec)
        te = t_chaos.parse_chaos_spec(spec)
        assert _change(tp.apply(te)) == _change(jp.apply(je))
        assert (tp.worker_ids, tp.next_id) == (jp.worker_ids, jp.next_id)
    # a snapshot-restored plan resumes the allocator, never recycling
    twin_j = j_elastic.MembershipPlan(
        jp.n_workers, worker_ids=jp.worker_ids, next_id=jp.next_id, **kw)
    twin_t = t_elastic.MembershipPlan(
        tp.n_workers, worker_ids=tp.worker_ids, next_id=tp.next_id, **kw)
    ev = "join@9"
    assert _change(twin_t.apply(t_chaos.parse_chaos_spec(ev))) == _change(
        twin_j.apply(j_chaos.parse_chaos_spec(ev)))


def test_crash_and_depart_resolve_before_joins():
    for plan_mod, chaos_mod in ((j_elastic, j_chaos), (t_elastic, t_chaos)):
        plan = plan_mod.MembershipPlan(3, max_workers=3)
        ch = plan.apply([chaos_mod.ChaosEvent(kind="join", round=2),
                         chaos_mod.ChaosEvent(kind="crash", round=2,
                                              worker=1)])
        assert ch.worker_ids == [0, 2, 3] and not ch.rejected


# ----------------------------------------------------------------------
# the shared layouts (comms)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,n_new", [(4, 3), (3, 5), (2, 1), (4, 4)])
@pytest.mark.parametrize("placement", ["sharded", "replicated"])
def test_round_opt_relayout_bitwise(n, n_new, placement):
    rng = np.random.default_rng(n * 10 + n_new)
    trk = j_comms.round_opt_init(_jtmpl(), n, placement=placement,
                                 bucket_bytes=BUCKET)
    # real moments on the filled positions, exact zeros on the pads
    vec = {b: {m: rng.random(int(np.prod(np.shape(v)) if placement ==
                                 "sharded" else np.shape(v)[1]))
               .astype(np.float32) for m, v in ms.items()}
           for b, ms in trk.items()}
    plan = j_comms.bucket_plan(list(_jtmpl().values()), n, BUCKET)
    for i, b in enumerate(plan):
        filled = sum(size for (_j, _o, size) in b.items)
        for m in ("mu", "nu"):
            v = vec[j_comms._bucket_name(i)][m]
            v[filled:] = 0
            trk[j_comms._bucket_name(i)][m] = (
                v.reshape(n, -1) if placement == "sharded"
                else np.broadcast_to(v, (n, v.size)).copy())
    want = j_comms.round_opt_relayout(trk, _jtmpl(), n_new,
                                      placement=placement,
                                      bucket_bytes=BUCKET)
    got = comms.round_opt_relayout(trk, _template().leaves, n_new,
                                   placement=placement, bucket_bytes=BUCKET)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_resident_layouts_bitwise(n):
    """``resident_from_tree``, ``resident_to_tree`` and ``resident_relayout``
    to every other count, against JAX's."""
    rng = np.random.default_rng(n)
    tree = {k: v[0] for k, v in _rows(rng, 1).items()}
    tmpl = _template()
    want = j_comms.resident_from_tree(tree, n, bucket_bytes=BUCKET)
    got = comms.resident_from_tree(_leaves(tree), n, template=tmpl,
                                   bucket_bytes=BUCKET)
    _assert_tree_equal(got, want)
    back = comms.resident_to_tree(got, template=tmpl, bucket_bytes=BUCKET)
    jback = j_comms.resident_to_tree(want, _jtmpl(), bucket_bytes=BUCKET)
    for a, k in zip(back, SHAPES):
        np.testing.assert_array_equal(a, jback[k])
        np.testing.assert_array_equal(a, tree[k])
    for n_new in (1, 2, 3, 5):
        _assert_tree_equal(
            comms.resident_relayout(got, tmpl.leaves, n_new,
                                    bucket_bytes=BUCKET),
            j_comms.resident_relayout(want, _jtmpl(), n_new,
                                      bucket_bytes=BUCKET))


def _stacked_state(n, rng, *, resident=False, residual=False,
                   tracker=None):
    """The same worker-stacked state as a JAX ``TrainState`` (numpy
    leaves) and a port ``HostState``: params (or the resident layout of a
    consensus), BatchNorm-like buffers, Adam moments and count, clock,
    seed words, and optionally an EF residual and round-optimizer rows."""
    params = _rows(rng, n)
    mu, nu, stats = _rows(rng, n), _rows(rng, n), {"s": rng.random((n, 6))}
    lr_epoch = np.arange(n, dtype=np.int32) + 3
    count = np.arange(n, dtype=np.int32) + 7
    seeds = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32)
    res = (_rows(rng, n) if residual else None)
    pres = None
    if resident:
        consensus = {k: v[0] for k, v in params.items()}
        pres = j_comms.resident_from_tree(consensus, n, bucket_bytes=BUCKET)
    trk = None
    if tracker is not None:
        trk = j_comms.round_opt_init(_jtmpl(), n, placement=tracker,
                                     bucket_bytes=BUCKET)
        plan = j_comms.bucket_plan(list(_jtmpl().values()), n, BUCKET)
        for i, b in enumerate(plan):
            filled = sum(size for (_j, _o, size) in b.items)
            name = j_comms._bucket_name(i)
            for m in ("mu", "nu"):
                v = rng.random(b.padded).astype(np.float32)
                v[filled:] = 0
                trk[name][m] = (v.reshape(n, -1) if tracker == "sharded"
                                else np.broadcast_to(v, (n, v.size)).copy())
    import optax
    jstate = JTrainState(
        params=None if resident else params, batch_stats=stats,
        opt_state=optax.ScaleByAdamState(count=count, mu=mu, nu=nu),
        lr_epoch=lr_epoch, rng=seeds, sync_residual=res, round_opt=trk,
        params_resident=pres)
    hstate = t_elastic.HostState(
        params=None if resident else params, buffers=stats, mu=mu, nu=nu,
        count=count, lr_epoch=lr_epoch, rng=seeds, sync_residual=res,
        round_opt=trk, params_resident=pres)
    return jstate, hstate


def _assert_state_equal(t, j, joiners=(), seed=0):
    """Every field of the port's ``HostState`` equals the JAX state's; the
    joiners' seed words are the port's ``joiner_rng`` (JAX's are its
    ``fold_in`` keys: the two frameworks draw different streams)."""
    if j.params is None:
        assert t.params is None
    else:
        _assert_tree_equal(t.params, j.params)
    _assert_tree_equal(t.buffers, j.batch_stats)
    _assert_tree_equal(t.mu, j.opt_state.mu)
    _assert_tree_equal(t.nu, j.opt_state.nu)
    np.testing.assert_array_equal(t.count, j.opt_state.count)
    np.testing.assert_array_equal(t.lr_epoch, j.lr_epoch)
    k = len(joiners)
    keep = slice(None, len(t.rng) - k)
    np.testing.assert_array_equal(t.rng[keep], j.rng[keep])
    for row, wid in zip(t.rng[len(t.rng) - k:], joiners):
        np.testing.assert_array_equal(row, t_elastic.joiner_rng(seed, wid))
    for f_t, f_j in (("sync_residual", "sync_residual"),
                     ("round_opt", "round_opt"),
                     ("params_resident", "params_resident"),
                     ("buddy", "buddy")):
        a, b = getattr(t, f_t), getattr(j, f_j)
        assert (a is None) == (b is None), f_t
        if a is not None:
            _assert_tree_equal(a, b)


RESHARD_CASES = [
    # (n, kept, joiners, resident, residual, tracker, buddy)
    (4, [0, 2, 3], [4], False, True, None, False),
    (4, [1, 3], [], True, True, None, True),
    (3, [0, 1, 2], [3, 4], True, False, None, True),
    (3, [2], [], True, True, None, True),        # quorum of one demotes
    (2, [1], [5], True, False, None, True),
    (4, [0, 1, 3], [7], False, False, "sharded", True),
    (3, [1, 2], [3], False, False, "replicated", False),
]


@pytest.mark.parametrize("case", RESHARD_CASES)
def test_reshard_state_bitwise(case):
    n, kept, joiners, resident, residual, tracker, buddy = case
    rng = np.random.default_rng(n + len(kept) * 7 + len(joiners))
    jstate, hstate = _stacked_state(n, rng, resident=resident,
                                    residual=residual, tracker=tracker)
    placement = tracker or "sharded"
    if buddy:
        jb = j_comms.derive_buddy(
            _jtmpl(), n, bucket_bytes=BUCKET,
            params_resident=jstate.params_resident,
            round_opt=jstate.round_opt,
            residual=jstate.sync_residual if resident else None,
            opt_placement=placement)
        tb = comms.derive_buddy(
            _template(), n, bucket_bytes=BUCKET,
            params_resident=hstate.params_resident,
            round_opt=hstate.round_opt,
            residual=(_leaves(hstate.sync_residual)
                      if resident and residual else None),
            opt_placement=placement)
        _assert_tree_equal(tb, jb)
        jstate, hstate = jstate.replace(buddy=jb), hstate.replace(buddy=tb)
    kw = dict(round_opt_placement=tracker, sync_bucket_bytes=BUCKET)
    want = j_elastic.reshard_state(jstate, kept, joiners, seed=3,
                                   params_template=_jtmpl(), **kw)
    got = t_elastic.reshard_state(hstate, kept, joiners, seed=3,
                                  params_template=_template(), **kw)
    _assert_state_equal(got, want, joiners, seed=3)
    if residual and joiners:
        for v in got.sync_residual.values():
            assert not v[len(kept):].any()


def test_reshard_without_survivors_raises():
    _j, hstate = _stacked_state(2, np.random.default_rng(0))
    with pytest.raises(ValueError, match="no surviving"):
        t_elastic.reshard_state(hstate, [], [2], seed=0)


def test_joiner_seed_keys_by_logical_id():
    """A run without membership changes draws what it always drew: worker
    ``rank`` has logical id ``rank``; a joiner's stream is keyed by its
    id, never its position."""
    for wid in range(5):
        np.testing.assert_array_equal(
            t_elastic.joiner_rng(11, wid),
            t_train.seed_words(t_train.worker_seed(11, wid)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_buddy_wire_bytes_match_jax(n):
    import torch
    for kw in (dict(), dict(wire_dtype="bfloat16"), dict(params=False,
                                                         tracker=True),
               dict(wire_dtype="int8", ef=True)):
        twire = ({"bfloat16": torch.bfloat16, "int8": torch.int8}
                 [kw["wire_dtype"]] if "wire_dtype" in kw else None)
        tkw = {**kw, "wire_dtype": twire}
        assert comms.buddy_wire_bytes(
            _template().leaves, n, bucket_bytes=BUCKET, **tkw) == \
            j_comms.buddy_wire_bytes(_jtmpl(), n, bucket_bytes=BUCKET, **kw)
    assert comms.buddy_wire_bytes(_template().leaves, 1) == 0


@pytest.mark.parametrize("lost", [[0], [2], [1, 3]])
def test_buddy_restore_rows_bitwise(lost):
    """The crashed positions' resident rows, their sharded tracker rows and
    the residual's folded span, against JAX's; the dead rows are never
    read (NaN there)."""
    n = 4
    rng = np.random.default_rng(sum(lost) + 1)
    jstate, hstate = _stacked_state(n, rng, resident=True, residual=True,
                                    tracker="sharded")
    jb = j_comms.derive_buddy(
        _jtmpl(), n, bucket_bytes=BUCKET,
        params_resident=jstate.params_resident, round_opt=jstate.round_opt,
        residual=jstate.sync_residual)
    tb = comms.derive_buddy(
        _template(), n, bucket_bytes=BUCKET,
        params_resident=hstate.params_resident, round_opt=hstate.round_opt,
        residual=_leaves(hstate.sync_residual))
    _assert_tree_equal(tb, jb)
    dead = lambda a: np.where(np.isin(np.arange(n), lost)[
        (...,) + (None,) * (a.ndim - 1)], np.nan, a)
    jparts = {"params_resident": {k: dead(v) for k, v in
                                  jstate.params_resident.items()},
              "round_opt": {b: {m: dead(v) for m, v in ms.items()}
                            for b, ms in jstate.round_opt.items()},
              "residual": jstate.sync_residual}
    tparts = {"params_resident": jparts["params_resident"],
              "round_opt": jparts["round_opt"],
              "residual": _leaves(hstate.sync_residual)}
    want = j_comms.buddy_restore_rows(jparts, jb, lost, _jtmpl(),
                                      bucket_bytes=BUCKET)
    got = comms.buddy_restore_rows(tparts, tb, lost, _template(),
                                   bucket_bytes=BUCKET)
    _assert_tree_equal(got["params_resident"], want["params_resident"])
    _assert_tree_equal(got["round_opt"], want["round_opt"])
    for a, k in zip(got["residual"], SHAPES):
        np.testing.assert_array_equal(a, want["residual"][k])
    _assert_tree_equal(got["params_resident"], jstate.params_resident)


def test_double_fault_raises_as_jax():
    n = 4
    jstate, hstate = _stacked_state(n, np.random.default_rng(9),
                                    resident=True)
    tb = comms.derive_buddy(_template(), n, bucket_bytes=BUCKET,
                            params_resident=hstate.params_resident)
    with pytest.raises(ValueError, match="double fault"):
        comms.buddy_restore_rows(
            {"params_resident": hstate.params_resident}, tb, [2, 3],
            _template(), bucket_bytes=BUCKET)
    assert comms.derive_buddy(_template(), n) is None
    assert comms.derive_buddy(_template(), 1, params_resident={}) is None


@pytest.mark.parametrize("case", [
    # (resident, residual, tracker, buddy, lost)
    (True, True, None, True, [1]),
    (False, False, "sharded", True, [0]),
    (False, False, "replicated", False, [2]),
    (False, False, None, False, [3]),
])
def test_restore_crashed_rows_bitwise(case):
    resident, residual, tracker, buddy, lost = case
    n = 4
    rng = np.random.default_rng(len(lost) + 5 * resident)
    jstate, hstate = _stacked_state(n, rng, resident=resident,
                                    residual=residual, tracker=tracker)
    if buddy:
        kw = dict(bucket_bytes=BUCKET, params_resident=jstate.params_resident,
                  round_opt=jstate.round_opt,
                  opt_placement=tracker or "sharded")
        jstate = jstate.replace(buddy=j_comms.derive_buddy(
            _jtmpl(), n, residual=jstate.sync_residual if resident else None,
            **kw))
        hstate = hstate.replace(buddy=comms.derive_buddy(
            _template(), n, residual=(_leaves(hstate.sync_residual)
                                      if resident and residual else None),
            **kw))
    kw = dict(sync_bucket_bytes=BUCKET, round_opt_placement=tracker)
    want = j_elastic.restore_crashed_rows(jstate, lost,
                                          params_template=_jtmpl(), **kw)
    got = t_elastic.restore_crashed_rows(hstate, lost,
                                         params_template=_template(), **kw)
    _assert_state_equal(got, want)


def test_restore_crashed_rows_without_buddy_raises():
    jstate, hstate = _stacked_state(3, np.random.default_rng(2),
                                    resident=True)
    for mod, st, tmpl in ((j_elastic, jstate, _jtmpl()),
                          (t_elastic, hstate, _template())):
        with pytest.raises(ValueError, match="no buddy copy"):
            mod.restore_crashed_rows(st, [1], params_template=tmpl,
                                     sync_bucket_bytes=BUCKET)


@pytest.mark.parametrize("data_mode", ["balanced", "disbalanced"])
def test_build_snapshot_matches_jax(data_mode):
    """The survivor EMA edit, the joiner's sec/batch, the re-partition
    drawn from one seeded stream and the stream's captured state equal
    JAX's; the row edit is ``reshard_state``'s."""
    n, labels = 4, np.random.default_rng(0).integers(0, 10, 500)
    change_kw = dict(kept_positions=[0, 2, 3], worker_ids=[0, 2, 3, 4],
                     joiner_ids=[4], applied=[], rejected=[])
    jstate, hstate = _stacked_state(n, np.random.default_rng(1))
    common = dict(epoch=3, sec_per_batch=np.array([0.1, 0.3, 0.2, 0.4]),
                  seed=5, num_classes=10, trainset_len=500, valset_len=120,
                  proportionality="inverse", data_mode=data_mode,
                  fixed_ratio=0.5, trainset_labels=labels,
                  valset_labels=labels[:120], next_worker_id=5, n_round0=4)
    js = j_elastic.build_snapshot(
        change=j_elastic.MembershipChange(**change_kw), old_state=jstate,
        rng=np.random.default_rng(7), **common)
    ts = t_elastic.build_snapshot(
        change=t_elastic.MembershipChange(**change_kw), old_state=hstate,
        rng=np.random.default_rng(7), **common)
    assert (ts.epoch, ts.worker_ids, ts.next_worker_id, ts.n_round0) == (
        js.epoch, js.worker_ids, js.next_worker_id, js.n_round0)
    np.testing.assert_array_equal(ts.sec_per_batch, js.sec_per_batch)
    for a, b in zip(ts.train_parts + ts.val_parts,
                    js.train_parts + js.val_parts):
        np.testing.assert_array_equal(a, b)
    assert ts.fixed_classes == js.fixed_classes
    assert ts.rng_state == js.rng_state
    _assert_state_equal(ts.host_state, js.host_state, [4], seed=5)
    copy = t_elastic.snapshot_copy(ts)
    copy.train_parts[0][:] = -1
    copy.host_state.mu["a"][:] = 0
    assert (ts.train_parts[0] >= 0).all() and ts.host_state.mu["a"].any()


def test_snapshot_saves_one_row_per_position(tmp_path):
    """``save_snapshot`` writes the manifest and one file per position;
    each position loads its own row, the whole loads back equal."""
    _j, hstate = _stacked_state(3, np.random.default_rng(3), resident=True,
                                residual=True)
    snap = t_elastic.MembershipSnapshot(
        epoch=2, worker_ids=[0, 2, 5], host_state=hstate,
        sec_per_batch=np.ones(3), train_parts=[np.arange(4)] * 3,
        val_parts=[np.arange(2)] * 3, fixed_classes=None,
        rng_state=np.random.default_rng(0).bit_generator.state,
        next_worker_id=6, n_round0=3, params_template=_template())
    t_elastic.save_snapshot(snap, str(tmp_path))
    meta, row = t_elastic.load_snapshot(str(tmp_path), 1)
    assert meta.host_state is None and meta.worker_ids == [0, 2, 5]
    assert meta.params_template == _template()
    _assert_tree_equal(row["params_resident"],
                       {k: v[1] for k, v in hstate.params_resident.items()})
    full = t_elastic.load_full_snapshot(str(tmp_path))
    _assert_tree_equal(dataclasses.asdict(full.host_state),
                       dataclasses.asdict(hstate))
