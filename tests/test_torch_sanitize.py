"""Run observability of the port on the CPU: ``--sanitize``'s schema and
its round guard (the counterparts of JAX ``tests/test_sanitize.py:32-90``)
and ``--profile_dir``'s trace.

On the card the guard is ``torch.cuda.set_sync_debug_mode("error")``
around each round (``tests/test_torch_cuda.py`` plants an implicit sync
there); the CPU has no device to sync with, so a sanitized CPU run
records zeros, and the guard's classification is held here with the
sync-debug switch stubbed."""

import json

import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RUN = dict(model="mlp", dataset="mnist", epochs_global=2, epochs_local=1,
           batch_size=16, limit_train_samples=128, limit_eval_samples=32,
           probe_batches=1, compute_dtype="float32", augment=False,
           aggregation_by="weights", seed=3, log_level="warning")
# JAX's results["sanitize"] on a clean run, and the port's key naming the
# checks that watch XLA
JAX_CLEAN = {"enabled": True, "transfer_guard_violations": 0,
             "retrace_count": 0, "recompile_count": 0, "donation_failures": 0}
NOT_APPLICABLE = ["retrace_count", "recompile_count", "donation_failures"]


def _run(**kw):
    return t_driver.train_global(Config(device="cpu", **RUN, **kw),
                                 progress=False)


def test_sanitized_cpu_run_records_zeros_and_changes_no_value():
    res = _run(sanitize=True)
    assert res["sanitize"] == {**JAX_CLEAN, "not_applicable": NOT_APPLICABLE}
    ref = _run()
    assert res["global_train_losses"] == ref["global_train_losses"]
    assert ref["sanitize"] == {**JAX_CLEAN, "enabled": False,
                               "not_applicable": NOT_APPLICABLE}


class _SyncDebug:
    """A stand-in for torch's sync-debug switch (the CPU build has no
    CUDA to switch): records each mode set."""

    def __init__(self, monkeypatch):
        self.modes, self.mode = [], 0
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                            lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.modes.append(mode)
        self.mode = mode


CUDA = torch.device("cuda", 0)


def test_guard_counts_and_reraises_a_sync_debug_error(monkeypatch):
    switch = _SyncDebug(monkeypatch)
    san = {"enabled": True, "transfer_guard_violations": 0}
    with pytest.raises(RuntimeError, match="synchronizing CUDA"):
        with t_driver._round_guard(san, CUDA):
            assert switch.mode == "error"
            raise RuntimeError("called a synchronizing CUDA operation")
    assert san["transfer_guard_violations"] == 1
    assert switch.modes == ["error", 0]     # restored on the way out


def test_guard_leaves_an_unrelated_error_uncounted(monkeypatch):
    _SyncDebug(monkeypatch)
    san = {"enabled": True, "transfer_guard_violations": 0}
    for err in (RuntimeError("a CUDA transfer failed"), ValueError("x")):
        with pytest.raises(type(err)):
            with t_driver._round_guard(san, CUDA):
                raise err
    assert san["transfer_guard_violations"] == 0


def test_guard_is_a_no_op_when_off_or_on_the_cpu(monkeypatch):
    switch = _SyncDebug(monkeypatch)
    for san, dev in (({"enabled": False}, CUDA),
                     ({"enabled": True}, torch.device("cpu"))):
        with t_driver._round_guard(dict(san, transfer_guard_violations=0),
                                   dev):
            pass
    assert switch.modes == []


def test_profile_dir_writes_a_trace_of_the_round_loop(tmp_path):
    res = _run(profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(res["round_timings"]) == RUN["epochs_global"]
    # the round loop's work is in it: the train step's matmuls
    assert any("addmm" in n or "mm" == n for n in names), sorted(names)[:50]
