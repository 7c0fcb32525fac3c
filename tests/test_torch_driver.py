"""The PyTorch port end to end on the CPU: ``main`` through the driver, the
device rule of its entry points, the config's rejections of features not
ported yet, and the guard that the port imports nothing of JAX."""

import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    config as t_config,
    driver as t_driver,
    main as t_main,
    viz as t_viz,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = "learning_deep_neural_network_in_distributed_computing_environment_tpu_torch"
JAX_PKG = "learning_deep_neural_network_in_distributed_computing_environment_tpu"

# the reference's metric structures (the JAX driver's results keys)
REFERENCE_KEYS = (
    "all_workers_losses", "all_epochs_losses", "global_epoch_losses",
    "global_epoch_accuracies", "global_train_losses",
    "global_train_accuracies", "global_val_losses", "global_val_accuracies",
    "worker_specific_train_losses", "worker_specific_train_accuracies",
    "worker_specific_val_losses", "worker_specific_val_accuracies",
    "step_caps", "shard_sizes", "round_timings")
PLOTS = ("training_metrics", "training_metrics_0",
         "loss_distribution_by_worker", "loss_distribution_per_epoch",
         "loss_distribution_per_epoch_global",
         "accuracy_distribution_per_epoch_global")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: beside the other test
    processes of a loaded host, every OpenMP thread beyond a free core
    spins at each parallel region's barrier, and the probe's measured
    seconds per batch (which cap the steps under ``--time_limit``) grew
    200-fold (0.018 s alone, 4.1 s beside five busy 8-thread processes on
    8 cores): enough to cut the cnn run's 7 steps.  One thread keeps the
    probe near its own cost under any load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(out_dir, *extra):
    return ["--model", "gpt_tiny", "--dataset", "synthetic_lm",
            "--epochs_global", "1", "--epochs_local", "2",
            "--batch_size", "8", "--limit_train_samples", "40",
            "--limit_eval_samples", "8", "--probe_batches", "1",
            "--compute_dtype", "float32", "--out_dir", str(out_dir), *extra]


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
def test_main_one_round_on_cpu(tmp_path, monkeypatch, attention_impl):
    """One round of gpt_tiny through ``main``: the reference metric keys,
    finite losses, the test evaluation, and the six plots as the JSON the
    card machine writes (it has no matplotlib)."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    results = t_main.run(_argv(tmp_path, "--device", "cpu",
                               "--attention_impl", attention_impl))
    for key in REFERENCE_KEYS:
        assert key in results, key
    assert len(results["global_train_losses"]) == 1
    assert len(results["worker_specific_train_losses"]) == 2
    # 40 samples -> 32 train / 8 val; one worker -> 4 steps per epoch
    assert results["shard_sizes"] == [[32]]
    assert results["round_timings"][0]["train_steps"] == 2 * 4
    assert len(results["all_workers_losses"][0]) == 2 * 4
    assert all(math.isfinite(x) for x in results["all_workers_losses"][0])
    ev = results["test_eval"]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 100.0
    assert set(results["variables"]) == set(results["model"].state_dict())
    for name in PLOTS:
        payload = json.loads((tmp_path / f"{name}.json").read_text())
        assert payload
    assert not any(tmp_path.glob("*.png"))


def test_main_llama_gqa_one_round_on_cpu(tmp_path, monkeypatch):
    """One round of llama_tiny with 2 KV heads and flash attention through
    ``main``: the model is the GQA Llama and the losses are finite."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    argv = _argv(tmp_path, "--device", "cpu", "--attention_impl", "flash",
                 "--num_kv_heads", "2")
    argv[argv.index("gpt_tiny")] = "llama_tiny"
    results = t_main.run(argv)
    attn = results["model"].blocks[0].attn
    assert (attn.num_kv_heads, attn.rope_theta) == (2, 10000.0)
    assert "rms_f.weight" in results["variables"]
    assert results["round_timings"][0]["train_steps"] == 2 * 4
    assert all(math.isfinite(x) for x in results["all_workers_losses"][0])
    assert math.isfinite(results["test_eval"]["loss"])


def test_num_kv_heads_applies_to_llama_only(tmp_path):
    """The JAX driver's rule (driver.py:571-577)."""
    with pytest.raises(ValueError, match="applies to llama_"):
        t_main.run(_argv(tmp_path, "--device", "cpu", "--num_kv_heads", "2"))


def test_main_cnn_defaults_two_rounds_on_cpu(tmp_path, monkeypatch):
    """The reference's own run (enhanced_cnn on cifar10, bf16 compute,
    augmentation on) through ``main`` at small size: two rounds, the
    metric structures, finite losses, BatchNorm statistics among the
    variables, a finite test evaluation and the six plots."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    results = t_main.run(["--device", "cpu", "--model_width", "8",
                          "--epochs_global", "2", "--epochs_local", "1",
                          "--limit_train_samples", "256",
                          "--limit_eval_samples", "64", "--batch_size", "32",
                          "--out_dir", str(tmp_path)])
    for key in REFERENCE_KEYS:
        assert key in results, key
    model = results["model"]
    assert type(model).__name__ == "EnhancedCNNModel"
    assert model.dtype == torch.bfloat16 and model.prep_conv.out_channels == 8
    # 256 samples -> 204 train / 52 val; one worker -> 7 steps per epoch
    assert results["shard_sizes"] == [[204], [204]]
    assert [r["train_steps"] for r in results["round_timings"]] == [7, 7]
    assert len(results["global_train_losses"]) == 2
    assert all(math.isfinite(x) for x in results["all_workers_losses"][0])
    assert np.isfinite(results["global_val_losses"]).all()
    stats = results["variables"]["prep_bn.running_var"]
    assert torch.isfinite(stats).all() and not torch.equal(
        stats, torch.ones_like(stats))
    ev = results["test_eval"]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 100.0
    for name in PLOTS:
        assert json.loads((tmp_path / f"{name}.json").read_text())


def test_model_width_applies_to_enhanced_cnn_only(tmp_path):
    """The JAX driver's rule (driver.py:119-124)."""
    with pytest.raises(ValueError, match="applies to --model enhanced_cnn"):
        t_main.run(_argv(tmp_path, "--device", "cpu", "--model_width", "8"))


def test_train_global_repartitions_across_rounds():
    """Two rounds with pinned probe durations: the shard is re-drawn
    between rounds and keeps its size at one worker."""
    cfg = t_config.Config(model="gpt_tiny", dataset="synthetic_lm",
                          epochs_global=2, epochs_local=1, batch_size=8,
                          limit_train_samples=40, limit_eval_samples=8,
                          compute_dtype="float32", device="cpu")
    results = t_driver.train_global(cfg, simulated_durations=[1.0],
                                    progress=False)
    assert results["shard_sizes"] == [[32], [32]]
    assert len(results["global_val_losses"]) == 2
    assert np.isfinite(results["global_val_losses"]).all()


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """Without --device cpu the port needs a card; it never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.run(_argv(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_driver.resolve_device(None)
    assert t_driver.resolve_device("cpu") == torch.device("cpu")
    assert not any(tmp_path.iterdir())


def test_serve_is_not_ported(tmp_path):
    """`main serve` is ported with its speculative decoding (ROADMAP A.10
    and A.10b): the speculative flags pass the config, and the run stops
    only at the checkpoint that is not there."""
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        t_main.run(["serve", "--checkpoint_dir", str(tmp_path / "x"),
                    "--serve_draft_ckpt", str(tmp_path / "y"),
                    "--serve_spec_tokens", "2"])


@pytest.mark.parametrize("flags,where", [
    # the flat and the per-slice resident layouts are ported; an allreduce
    # outer level is refused as JAX refuses it (the flat S*W engine)
    (["--sync_mode", "sharded", "--param_residency", "resident",
      "--num_slices", "2"], "flat sharded allreduce"),
    # the transformer knobs are ported; what stays refused is refused as
    # the JAX config refuses it
    (["--remat_policy", "save_names:attn_out"], "enhanced_cnn has none"),
    (["--grad_accum", "3"], "divisible by --grad_accum"),
    (["--mesh_shape", "data=1,expert=2"],
     "mesh has an 'expert' axis but --num_experts is 0"),
    # the data, fsdp, seq, pipe, expert and model axes run
    # (tests/test_torch_tp.py, tests/test_torch_sp.py, tests/test_torch_pp.py,
    # tests/test_torch_ep.py); an expert axis without experts, and a pipe
    # axis on the default enhanced_cnn, are refused as JAX refuses them
    (["--mesh_shape", "data=1,pipe=2"], "applies to attention models"),
    (["--num_workers", "2", "--backend", "nccl"], "A.12"),
    (["--model", "bert_tiny", "--layer_scan", "off"], "A.11"),
], ids=["param_residency", "remat_policy", "grad_accum", "num_experts",
        "mesh_shape", "num_workers", "layer_scan"])
def test_config_rejects_features_not_ported(flags, where):
    with pytest.raises(ValueError, match=where):
        t_config.config_from_args(["--device", "cpu", *flags])


def test_config_keeps_reference_names_and_defaults():
    cfg = t_config.config_from_args(["--mesh_shape", "data=1"])
    assert (cfg.model, cfg.dataset, cfg.compute_dtype, cfg.attention_impl,
            cfg.lr_step_size, cfg.lr_gamma, cfg.probe_batches,
            cfg.out_dir) == ("enhanced_cnn", "cifar10", "bfloat16", "dense",
                             25, 0.1, 10, "Graphs")
    assert cfg.device is None and cfg.augment
    # the reference's dead flags parse as no-ops; --backend jax|gloo|mpi
    # all run the gloo group, nccl is not ported (one rank per card)
    t_config.config_from_args(["--local-rank", "0", "--gpu_weight", "1.0",
                               "--dist-url", "tcp://x", "--backend", "gloo"])
    with pytest.raises(ValueError, match="A.12"):
        t_config.config_from_args(["--backend", "nccl"])


def _port_sources():
    return sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_imports_in_port_sources():
    """AST scan: no import of jax, flax, optax or the JAX package in the
    port or in chip_smoke.py (``import_module("...")`` included)."""
    banned = ("jax", "jaxlib", "flax", "optax", JAX_PKG)
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and getattr(node.func, "id", getattr(node.func, "attr", ""))
                  in ("import_module", "__import__")
                  and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            for name in names:
                if name.split(".")[0] in banned and name != PORT \
                        and not name.startswith(PORT + "."):
                    offenders.append(f"{path.name}: {name}")
    assert not offenders, offenders
    assert len(_port_sources()) > 15


def test_importing_the_port_loads_no_jax():
    code = (f"import sys\n"
            f"import {PORT}.main, {PORT}.driver, {PORT}.ops.flash\n"
            f"import {PORT}.models.llama, {PORT}.weights\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'jaxlib', 'flax', 'optax', '{JAX_PKG}'))\n"
            f"print(bad)\n"
            f"assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports only the
    standard library)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sass(*functions):
    """Canned ``cuobjdump -sass`` text: (mangled name, instructions)."""
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a",
             "", "\tcode for sm_90a"]
    for name, ops in functions:
        lines += [f"\t\tFunction : {name}",
                  '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"']
        lines += [f"        /*{16 * i:04x}*/                   {op} ;"
                  f"   /* 0x000fe200000018ff */" for i, op in enumerate(ops)]
        lines.append("\t\t..........")
    return "\n".join(lines) + "\n"


_BF16_FWD = "_ZN5flash2tc13fwd_kernel_tcILi64EEEvPK13__nv_bfloat16S4_S4_PS2_Pf"
_F32_FWD = "_ZN5flash10fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiiii"
_BF16_DQ = ("_ZN5flash2tc16bwd_dq_kernel_tcILi64EEEvPK13__nv_bfloat16S4_S4_S4_"
            "PKfS6_PS2_")
_BF16_DKV = ("_ZN5flash2tc17bwd_dkv_kernel_tcILi64EEEvPK13__nv_bfloat16S4_S4_S4_"
             "PKfS6_PS2_S7_")
_F32_DQ = "_ZN5flash13bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS6_PS1_"
_BF16_DQ_FMA = "_ZN5flash13bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_"
_BF16_FUSED = ("_ZN5flash2tc19bwd_fused_kernel_tcILi64EEEvPK13__nv_bfloat16"
               "S4_S4_S4_PKfS6_PfPS2_S8_")
_HMMA = "HMMA.16816.F32.BF16 R24, R4.reuse, R16, R24"
_FMA = ["LDS R8, [R2+0x100]", "FFMA R4, R8, R9, R4", "EXIT"]
_KERNEL_IDS = ("forward", "fused", "dq", "dkv")


def _libraries(forward=(_HMMA,), fused=(_HMMA,), dq=(_HMMA,), dkv=(_HMMA,),
               extra_bwd=()):
    """Canned cuobjdump text of the three libraries: each kernel's bf16
    instance with the given instructions beside its fp32 FMA instance."""
    return {"flash_fwd": _sass((_F32_FWD, _FMA), (_BF16_FWD, forward)),
            "flash_bwd": _sass((_F32_DQ, _FMA), (_BF16_DQ, dq),
                               (_BF16_DKV, dkv), *extra_bwd),
            "flash_bwd_fused": _sass((_BF16_FUSED, fused))}


def test_smoke_sass_check_finds_tensor_core_instructions():
    smoke = _chip_smoke()
    text = _sass((_BF16_FWD, ["LDSM.16.M88.4 R4, [R2]", _HMMA,
                              "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24",
                              _HMMA, "EXIT"]), (_F32_FWD, _FMA))
    assert smoke.tensor_core_ops(text) == {
        _BF16_FWD: ["HGMMA.64x64x16.F32.BF16", "HMMA.16816.F32.BF16"],
        _F32_FWD: []}
    found = smoke.check_tensor_cores(_libraries(fused=[_HMMA, _HMMA]))
    assert found == {"flash_fwd": True, "flash_bwd_dq": True,
                     "flash_bwd_dkv": True, "flash_bwd_fused": True}


@pytest.mark.parametrize("kernel", _KERNEL_IDS, ids=_KERNEL_IDS)
def test_smoke_sass_check_fails_without_tensor_core_instructions(
        capsys, kernel):
    """A kernel designed for the tensor cores whose bf16 instance runs only
    FMA instructions fails the build phase."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(_libraries(**{kernel: _FMA}))
    assert "hold no HMMA/HGMMA" in capsys.readouterr().err


def test_smoke_sass_check_fails_on_a_bf16_fma_instance_left_beside(capsys):
    """A bf16 FMA-only bwd_dq_kernel instance left instantiated beside the
    tensor-core one fails the check, though the _tc instance holds HMMA."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(
            _libraries(extra_bwd=[(_BF16_DQ_FMA, _FMA)]))
    err = capsys.readouterr().err
    assert "flash_bwd_dq" in err and "hold no HMMA/HGMMA" in err


def test_smoke_sass_check_fails_without_cuobjdump(capsys, monkeypatch):
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke.shutil, "which", lambda name: None)
    monkeypatch.setattr(smoke.os.path, "exists", lambda path: False)
    with pytest.raises(SystemExit):
        smoke.find_cuobjdump()
    assert "cuobjdump not found" in capsys.readouterr().err
