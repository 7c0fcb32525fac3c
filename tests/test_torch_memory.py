"""``results["memory"]`` of the port on the CPU (the counterparts of JAX
``tests/test_remat_memory.py:284-400``): the row on every run, a
zero-round resume too, with JAX's keys; its analytic part (per-worker
state bytes, the resident total, the fleet or stacked total) equal to the
JAX run's on the same config (dense, scatter-resident at N=2, the lab at
N=4); ``probe.TrackedProgram`` keeping one entry per input shape; and
``memory_analysis_row``'s eager meaning of XLA's keys.  The CPU allocator
keeps no statistics, so no program has a row here (``available``:
false); the rows themselves are held on the card
(``tests/test_torch_cuda.py``)."""

import jax
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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
    probe,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RUN = dict(model="mlp", dataset="mnist", epochs_global=1, epochs_local=1,
           batch_size=16, limit_train_samples=128, limit_eval_samples=32,
           probe_batches=1, compute_dtype="float32", augment=False,
           aggregation_by="weights", seed=5, log_level="warning")
ANALYTIC = ("per_worker_state_bytes", "per_worker_resident_bytes",
            "per_worker_peak_bytes", "state_bytes_total", "workers",
            "simulated")
CASES = {"dense": (1, {}),
         "resident_n2": (2, {"sync_mode": "sharded",
                             "param_residency": "resident"}),
         "sim_n4": (4, {"sim_workers": 4})}


@pytest.mark.parametrize("case", list(CASES))
def test_memory_row_matches_jax(devices, case):
    n, extra = CASES[case]
    kw = dict(RUN, **extra)
    sim = "sim_workers" in extra
    j_res = j_train_global(
        JConfig(**kw), progress=False,
        **({} if sim else {"mesh": build_mesh({"data": n}, devices[:n])}))
    cfg = Config(device="cpu", **kw)
    res = (t_driver.run_group(cfg, n, train_kwargs={"progress": False})
           if n > 1 and not sim else t_driver.train_global(cfg,
                                                          progress=False))
    m, jm = res["memory"], j_res["memory"]
    assert set(m) == set(jm)
    for key in ANALYTIC:
        assert m[key] == jm[key], key
    assert m["state_bytes_total"] == n * m["per_worker_resident_bytes"]
    if case == "resident_n2":
        pw = m["per_worker_state_bytes"]
        assert pw["params"] * 2 == pw["params_gathered_peak"]
        assert m["per_worker_peak_bytes"] == (m["per_worker_resident_bytes"]
                                              + pw["params_gathered_peak"])
    # every program the round ran is registered; none has a row here
    want = ({"sim_step", "sim_eval", "sim_blend"} if sim
            else {"train_step", "eval_step", "sync"}
            | ({"resident_enter"} if case == "resident_n2" else set()))
    assert set(m["programs_unavailable"]) == want
    assert m["programs"] == {} and m["available"] is False
    assert m["temp_bytes_total"] == 0


def test_zero_round_resume_still_emits_the_row(tmp_path):
    """Resuming a finished run runs no round: the row is there, with no
    program and the analytic part filled (JAX
    ``test_zero_round_run_still_emits``)."""
    kw = dict(RUN, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    t_driver.train_global(Config(device="cpu", **kw), progress=False)
    res = t_driver.train_global(Config(device="cpu", resume=True, **kw),
                                progress=False)
    assert res["round_timings"] == []
    m = res["memory"]
    assert m["programs"] == {} and m["programs_unavailable"] == []
    assert m["available"] is False and m["per_worker_resident_bytes"] > 0


def test_tracked_program_keeps_one_entry_per_shape():
    calls = []

    def fn(a):
        calls.append(a.shape)
        return a.sum()

    multi = probe.TrackedProgram("prefill", fn, multi_shape=True)
    for n in (3, 5, 3):
        multi(torch.ones(n))
    assert multi.shape_keys() == [(((3,), "torch.float32"),),
                                  (((5,), "torch.float32"),)]
    single = probe.TrackedProgram("round", fn)
    for n in (3, 5):
        single(torch.ones(n))
    assert single.shape_keys() == [()]
    assert len(calls) == 5          # every call reaches the program
    # the CPU allocator keeps no statistics: no row
    assert multi.memory_rows() == [] and single.memory_rows() == []


def test_tracked_program_passes_results_and_errors_through():
    tp = probe.TrackedProgram("p", lambda a, b=1: a + b)
    assert tp(1, b=2) == 3 and tp(1) == 2
    bad = probe.TrackedProgram("bad", lambda a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        bad(torch.ones(2))
    assert bad.shape_keys() == []   # a failed first call is not recorded


def test_memory_analysis_row_eager_meaning():
    """Arguments and outputs in tensor bytes; an output sharing an
    input's storage (an in-place update) counts as alias; temp is the
    peak above the start less the newly allocated outputs."""
    w = torch.zeros(100)            # 400 B, updated in place
    x = torch.zeros(25)             # 100 B
    y = torch.zeros(10)             # 40 B, new output
    row = probe.memory_analysis_row(before=1000, peak=1800,
                                    inputs=[w, x, w], outputs=[w, y])
    assert row == {"temp_bytes": 800 - 40, "argument_bytes": 500,
                   "output_bytes": 440, "alias_bytes": 400,
                   "generated_code_bytes": 0}
    assert probe.memory_analysis_row(0, 10, [], [y])["temp_bytes"] == 0


class _Rows:
    def __init__(self, rows):
        self.rows = rows

    def memory_rows(self):
        return self.rows


def test_memory_report_schema():
    """JAX ``test_memory_report_schema``: a program without rows flips
    ``available``; the resident and peak bytes and the total."""
    row = {"temp_bytes": 7, "argument_bytes": 1, "output_bytes": 2,
           "alias_bytes": 0, "generated_code_bytes": 0}
    rep = probe.memory_report(
        {"round": _Rows([row, row]), "broken": _Rows([])},
        state_bytes={"params": 100, "opt_state": 200,
                     "params_gathered_peak": 800}, n_workers=8)
    assert rep["available"] is False
    assert rep["programs_unavailable"] == ["broken"]
    assert rep["temp_bytes_total"] == 14
    assert rep["per_worker_resident_bytes"] == 300
    assert rep["per_worker_peak_bytes"] == 1100
    assert rep["state_bytes_total"] == 2400
    full = probe.memory_report({"round": _Rows([row])}, sim=True)
    assert full["available"] is True and full["simulated"] is True
    assert "state_bytes_total" not in full


def test_process_peak_is_zero_off_the_card():
    assert probe.max_memory_allocated(torch.device("cpu")) == 0
    probe.reset_peak_memory_stats(torch.device("cpu"))   # a no-op
