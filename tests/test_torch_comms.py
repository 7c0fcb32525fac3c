"""The port's sync point on N gloo processes against the JAX package's
``comms.make_host_aggregator`` on an N-device CPU mesh: all 12 modes (the
six how x topology blends, each the same for gradients and weights) at
N = 2, 3 and 4, from the same per-worker numpy leaves.

One spawn per N runs all six blends (``comms.modes_worker``, a function
of the port); the children write their results under ``tmp_path`` and
the parent holds them against JAX.  Tolerance rtol 1e-6 / atol 1e-6: the
gossip blends are elementwise and agree to the last bit or so, the
all-reduce differs only in the order gloo sums in."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    comms,
    mesh,
)

ROOT = Path(__file__).resolve().parents[1]
LOCAL_WEIGHT = 0.7
RTOL = ATOL = 1e-6
SIZES = ((7,), (3, 5), (1,), (129,))     # odd sizes; the last leaf is i


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    """One intra-op thread in this process and in the ranks it spawns
    (``mesh.rank_threads``): the suite runs beside other test processes,
    and OpenMP threads spinning on a full host slow all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(n: int) -> list[np.ndarray]:
    """Per-worker fp32 leaves [n, ...]: normal draws from a seed, and one
    leaf whose value on worker i is i (the self-hop's witness)."""
    rng = np.random.default_rng(n)
    leaves = [rng.normal(size=(n, *s)).astype(np.float32) for s in SIZES]
    return leaves + [np.arange(n, dtype=np.float32)[:, None]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """n -> (leaves, [rank results]) of one spawn of n ranks, on demand."""
    cache = {}

    def get(n):
        if n not in cache:
            d = tmp_path_factory.mktemp(f"modes{n}")
            leaves = _leaves(n)
            np.savez(d / "in.npz", **{f"leaf{j}": a
                                      for j, a in enumerate(leaves)})
            store = mesh.new_store_path()
            try:
                mesh.join_workers(mesh.spawn_workers(
                    comms.modes_worker, n,
                    (store, "cpu", str(d / "in.npz"), str(d), LOCAL_WEIGHT,
                     60.0), ranks=range(n)), timeout_s=120.0)
            finally:
                mesh.remove_store(store)
            outs = []
            for r in range(n):
                with np.load(d / f"rank{r}.npz") as f:
                    outs.append({k: f[k] for k in f.files})
            cache[n] = leaves, outs
        return cache[n]
    return get


@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_modes_match_jax_host_aggregator(runs, devices, n):
    leaves, outs = runs(n)
    j_mesh = build_mesh({"data": n}, devices[:n])
    for how, topology in comms.MODES:
        agg = j_comms.make_host_aggregator(
            j_mesh, how=how, topology=topology, local_weight=LOCAL_WEIGHT)
        want = jax.device_get(agg([jnp.asarray(a) for a in leaves]))
        for j, w in enumerate(want):
            for r in range(n):
                got = outs[r][f"{how}-{topology}-leaf{j}"]
                assert got.dtype == np.float32 and got.shape == w[r].shape
                np.testing.assert_allclose(
                    got, w[r], rtol=RTOL, atol=ATOL,
                    err_msg=f"n={n} {how}-{topology} leaf{j} rank {r}")


def test_double_ring_second_hop_at_two_workers_is_own_value(runs):
    """At n=2 the shift-2 hop wraps to the worker itself: worker 0 of
    values [0, 1] gets (0 + 1 + 0) / 3, as XLA's ppermute gives it."""
    leaves, outs = runs(2)
    w = LOCAL_WEIGHT
    np.testing.assert_allclose(outs[0]["equal-double_ring-leaf4"], [1 / 3],
                               rtol=RTOL)
    np.testing.assert_allclose(outs[1]["equal-double_ring-leaf4"], [2 / 3],
                               rtol=RTOL)
    np.testing.assert_allclose(outs[0]["weighted-double_ring-leaf4"],
                               [(1 - w) / 2], rtol=RTOL)
    x0, x1 = leaves[0]
    np.testing.assert_array_equal(outs[0]["equal-double_ring-leaf0"],
                                  (x0 + x1 + x0) / np.float32(3))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_equal_allreduce_leaves_every_rank_bitwise_identical(runs, n):
    _leaves_, outs = runs(n)
    assert len({str(o["checksum-equal-allreduce"]) for o in outs}) == 1
    for j in range(len(SIZES) + 1):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"equal-allreduce-leaf{j}"],
                                          outs[0][f"equal-allreduce-leaf{j}"])
    # the other blends leave the workers apart
    assert len({str(o["checksum-weighted-ring"]) for o in outs}) == n


def test_one_worker_is_the_identity_without_a_group():
    xs = [torch.randn(3, 5), torch.randn(7)]
    for how, topology in comms.MODES:
        out = comms.aggregate(xs, how=how, topology=topology)
        assert all(a is b for a, b in zip(out, xs))
    assert not dist.is_initialized()
    assert comms.wire_bytes(100, "allreduce", 1) == 0


@pytest.mark.parametrize("kw,match", [
    ({"how": "median"}, "how must be one of"),
    ({"topology": "torus"}, "topology must be one of"),
], ids=["how", "topology"])
def test_bad_how_or_topology_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        comms.aggregate([torch.zeros(2)], **kw)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("shift", [1, 2])
def test_ring_neighbors_match_jax(n, shift):
    assert comms.ring_neighbors(n, shift) == j_comms.ring_neighbors(n, shift)


def test_wire_bytes_per_topology():
    """A ring all-reduce sends 2(n-1)/n of the buffer; a gossip hop one
    buffer, none for the self-hop of double_ring at n=2."""
    assert comms.wire_bytes(1000, "allreduce", 4) == 6000
    assert comms.wire_bytes(1000, "ring", 4) == 4000
    assert comms.wire_bytes(1000, "double_ring", 4) == 8000
    assert comms.wire_bytes(1000, "double_ring", 2) == 4000


def test_flatten_round_trips_channels_last_tensors():
    w = torch.randn(4, 3, 2, 2).to(memory_format=torch.channels_last)
    xs = [w, torch.randn(5)]
    flat = comms.flatten(xs)
    assert flat.shape == (4 * 3 * 2 * 2 + 5,)
    for a, b in zip(comms.unflatten(flat, xs), xs):
        assert torch.equal(a, b)


def test_a_failing_child_makes_join_raise(tmp_path):
    """A rank that cannot read its input exits non-zero; its peers fail at
    the group timeout, and joining them raises naming the exit codes."""
    store = mesh.new_store_path()
    try:
        procs = mesh.spawn_workers(
            comms.modes_worker, 2,
            (store, "cpu", str(tmp_path / "missing.npz"), str(tmp_path),
             LOCAL_WEIGHT, 5.0), ranks=range(2))
        with pytest.raises(RuntimeError, match="exit codes"):
            mesh.join_workers(procs, timeout_s=60.0)
    finally:
        mesh.remove_store(store)
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_smoke_float64_formula_matches_jax(devices, n):
    """chip_smoke.py holds the card's sync against its own float64 formula
    of each mode; that formula agrees with JAX's aggregator."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    leaves = _leaves(n)
    j_mesh = build_mesh({"data": n}, devices[:n])
    for how, topology in comms.MODES:
        agg = j_comms.make_host_aggregator(
            j_mesh, how=how, topology=topology, local_weight=LOCAL_WEIGHT)
        want = jax.device_get(agg([jnp.asarray(a) for a in leaves]))
        for x, w in zip(leaves, want):
            np.testing.assert_allclose(
                smoke.modes_reference(x, n, how, topology, LOCAL_WEIGHT), w,
                rtol=RTOL, atol=ATOL, err_msg=f"{how}-{topology}")
