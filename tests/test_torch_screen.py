"""The chaos screen, the scatter-resident sync and the buddy hop of the
port's sync engines (``comms.aggregate`` / ``gossip_sync`` /
``sharded_opt_sync``) on 4 gloo processes, against the JAX package's
``make_host_sync`` (its ``tests/test_failure_domain.py`` TestNanScreen
and TestBuddyHop surfaces):

- a clean round with the screen armed is bitwise the unscreened round,
  in every engine and blend;
- a round with a poisoned worker (and one with a non-finite value)
  renormalizes as JAX's does, within fp32 rtol = atol = 1e-6;
- the resident sync's rows are JAX's resident rows (fp32), the buddy
  rows are the ring predecessor's rows bit for bit on every wire, the
  hop's bytes are ``comms.buddy_wire_bytes``, and the sync's other
  outputs are bitwise those without the hop.

One spawn of 4 ranks (``sync_harness.engines_worker``) runs every
case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    comms,
    mesh,
    sync_harness,
)

N = 4
SHAPES = [(7, 5), (13,)]
BUCKET = 64
W = 0.25
MODES = [("sharded", "allreduce"), ("gossip", "ring"),
         ("gossip", "double_ring"), ("dense", "allreduce"),
         ("dense", "ring"), ("dense", "double_ring")]
CLEAN, POISON, NONFINITE = [False] * N, [False, True, False, False], \
    [False] * N
WIRES = ("float32", "bfloat16", "int8")


def _case(mode, topology, how, **kw):
    return dict(mode=mode, topology=topology, how=how, local_weight=W,
                bucket_bytes=BUCKET, **kw)


CASES = {}
for (_m, _t), _h in [(mt, h) for mt in MODES for h in ("equal", "weighted")]:
    CASES[f"plain-{_m}-{_t}-{_h}"] = _case(_m, _t, _h)
    CASES[f"clean-{_m}-{_t}-{_h}"] = _case(_m, _t, _h, poison=CLEAN)
    CASES[f"poison-{_m}-{_t}-{_h}"] = _case(_m, _t, _h, poison=POISON)
    CASES[f"nonfinite-{_m}-{_t}-{_h}"] = _case(_m, _t, _h, poison=NONFINITE,
                                               leaves=[2, 1])
for _w in WIRES:
    _ef = _w != "float32"
    CASES[f"resident-{_w}"] = _case("sharded", "allreduce", "equal",
                                    wire=_w, ef=_ef, residency="resident")
    CASES[f"buddy-{_w}"] = _case("sharded", "allreduce", "equal", wire=_w,
                                 ef=_ef, residency="resident", buddy=True)
CASES["tracker-buddy"] = _case("sharded", "allreduce", "equal", track=True,
                               buddy=True)
CASES["tracker"] = _case("sharded", "allreduce", "equal", track=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on 4 ranks: leaves 0, 1 finite; leaf 2 is leaf 0 with a
    non-finite element on worker 3."""
    rng = np.random.default_rng(12)
    leaves = [rng.standard_normal((N, *s)).astype(np.float32)
              for s in SHAPES]
    bad = leaves[0].copy()
    bad[3, 0, 0] = np.inf
    leaves.append(bad)
    d = tmp_path_factory.mktemp("screen")
    np.savez(d / "in.npz", **{f"leaf{j}": a for j, a in enumerate(leaves)})
    names = list(CASES)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            sync_harness.engines_worker, N,
            (store, "cpu", str(d / "in.npz"),
             [{**CASES[k], "leaves": CASES[k].get("leaves", [0, 1])}
              for k in names], str(d), 60.0),
            ranks=range(N)), timeout_s=180.0)
    finally:
        mesh.remove_store(store)
        torch.set_num_threads(threads)
    outs = []
    for r in range(N):
        with np.load(d / f"rank{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return leaves, names, outs


def _get(run, name, key):
    _leaves, names, outs = run
    c = names.index(name)
    return [o[f"{c}/{key}"] for o in outs]


def _stack(run, name, key):
    return np.stack(_get(run, name, key))


def _jax(leaves, mode, topology, how, poison=None, **kw):
    sync = j_comms.make_host_sync(
        build_mesh({"data": N}, jax.devices()[:N]), mode=mode,
        topology=topology, how=how, local_weight=W, bucket_bytes=BUCKET,
        screen=poison is not None, **kw)
    tree = [jnp.asarray(a) for a in leaves]
    if poison is None:
        out, _ = sync(tree, None)
        return jax.device_get(out), None
    d = sync(tree, None, None, np.asarray(poison, bool))
    return jax.device_get(d["out"]), np.asarray(
        jax.device_get(d["ok"])).reshape(-1)


@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("mode,topology", MODES)
def test_clean_screened_round_is_bitwise_the_unscreened(run, mode, topology,
                                                        how):
    tag = f"{mode}-{topology}-{how}"
    assert _get(run, f"clean-{tag}", "ok") == [1.0] * N
    for j in range(2):
        np.testing.assert_array_equal(_stack(run, f"clean-{tag}", f"out{j}"),
                                      _stack(run, f"plain-{tag}", f"out{j}"))
    assert (_get(run, f"clean-{tag}", "wire_payload")
            == _get(run, f"plain-{tag}", "wire_payload"))


@pytest.mark.parametrize("kind", ["poison", "nonfinite"])
@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("mode,topology", MODES)
def test_quarantine_renormalizes_as_jax(run, mode, topology, how, kind):
    """Worker 1 poisoned, or worker 3 carrying an inf: its flag is 0, the
    blends renormalize over the valid workers, every output finite where
    JAX's is, within fp32 1e-6."""
    leaves = run[0]
    pick = CASES[f"{kind}-{mode}-{topology}-{how}"].get("leaves", [0, 1])
    poison = POISON if kind == "poison" else NONFINITE
    want, want_ok = _jax([leaves[j] for j in pick], mode, topology, how,
                         poison=poison)
    tag = f"{kind}-{mode}-{topology}-{how}"
    np.testing.assert_array_equal(_get(run, tag, "ok"), want_ok)
    assert (np.asarray(_get(run, tag, "ok")) == 0).sum() == 1
    for j in range(2):
        np.testing.assert_allclose(_stack(run, tag, f"out{j}"),
                                   np.asarray(want[j]), rtol=1e-6,
                                   atol=1e-6)


def test_resident_rows_are_jaxs(run):
    """The fp32 resident sync's rows equal JAX's resident layout, and the
    host gather of them is the mean (the next round's entry)."""
    leaves = run[0]
    out = j_comms.make_host_sync(
        build_mesh({"data": N}, jax.devices()[:N]), mode="sharded",
        how="equal", bucket_bytes=BUCKET, param_residency="resident")(
        [jnp.asarray(a) for a in leaves[:2]], None)[0]
    want = jax.device_get(out)
    for name, rows in want.items():
        np.testing.assert_allclose(_stack(run, "resident-float32",
                                          f"resident/{name}"),
                                   np.asarray(rows), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wire", WIRES)
def test_buddy_hop_copies_the_predecessor_bitwise(run, wire):
    """On every wire the buddy rows are the predecessor's resident rows
    (and EF spans) bit for bit, the resident rows and residual are those
    of the sync without the hop, and the hop sends buddy_wire_bytes."""
    _leaves, names, outs = run
    resident = {k.split("/", 2)[2] for k in outs[0]
                if k.startswith(f"{names.index(f'buddy-{wire}')}/resident/")}
    assert resident
    for name in resident:
        rows = _stack(run, f"buddy-{wire}", f"resident/{name}")
        np.testing.assert_array_equal(
            rows, _stack(run, f"resident-{wire}", f"resident/{name}"))
        np.testing.assert_array_equal(
            np.roll(rows, 1, axis=0),
            _stack(run, f"buddy-{wire}", f"buddy/{name}/params"))
    ef = wire != "float32"
    for j in range(2 if ef else 0):
        np.testing.assert_array_equal(_stack(run, f"buddy-{wire}", f"res{j}"),
                                      _stack(run, f"resident-{wire}",
                                             f"res{j}"))
    wdt = comms.WIRE_DTYPES[wire]
    want = comms.buddy_wire_bytes(
        [(s, torch.float32) for s in SHAPES], N,
        wire_dtype=None if wdt == torch.float32 else wdt,
        bucket_bytes=BUCKET, ef=ef)
    assert want > 0
    assert _get(run, f"buddy-{wire}", "wire_buddy") == [want] * N
    assert (_get(run, f"buddy-{wire}", "wire_payload")
            == _get(run, f"resident-{wire}", "wire_payload"))


def test_tracker_buddy_rows_are_the_predecessors(run):
    _leaves, names, outs = run
    c = names.index("tracker-buddy")
    buckets = {k.split("/")[2] for k in outs[0]
               if k.startswith(f"{c}/buddy/")}
    assert buckets
    for name in buckets:
        for m in ("mu", "nu"):
            rows = _stack(run, "tracker-buddy", f"{m}/{name}")
            np.testing.assert_array_equal(
                rows, _stack(run, "tracker", f"{m}/{name}"))
            np.testing.assert_array_equal(
                np.roll(rows, 1, axis=0),
                _stack(run, "tracker-buddy", f"buddy/{name}/{m}"))
    assert _get(run, "tracker-buddy", "wire_buddy") == [
        comms.buddy_wire_bytes([(s, torch.float32) for s in SHAPES], N,
                               bucket_bytes=BUCKET, params=False,
                               tracker=True)] * N
