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
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

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
    # --backend nccl is a no-op, as in JAX (the gloo group), and
    # --layer_scan off lays the transformer out unrolled: both run
    (["--num_workers", "2", "--backend", "nccl"], None),
    (["--model", "bert_tiny", "--layer_scan", "off"], None),
], ids=["param_residency", "remat_policy", "grad_accum", "num_experts",
        "mesh_shape", "num_workers", "layer_scan"])
def test_config_rejects_features_not_ported(flags, where):
    """What stays refused is refused as JAX refuses it; what JAX takes
    (``where`` None) parses and resolves as in JAX."""
    argv = ["--device", "cpu", *flags]
    if where is not None:
        with pytest.raises(ValueError, match=where):
            t_config.config_from_args(argv)
        return
    cfg = t_config.config_from_args(argv)
    from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
        config_from_args as j_config_from_args,
    )
    j_cfg = j_config_from_args(argv)
    assert (cfg.backend, cfg.layer_scan) == (j_cfg.backend, j_cfg.layer_scan)
    # both unrolled: the CNN has no blocks, bert_tiny is laid out off
    assert not t_driver.resolve_layer_scan(cfg)


def test_config_keeps_reference_names_and_defaults():
    cfg = t_config.config_from_args(["--mesh_shape", "data=1"])
    assert (cfg.model, cfg.dataset, cfg.compute_dtype, cfg.attention_impl,
            cfg.lr_step_size, cfg.lr_gamma, cfg.probe_batches,
            cfg.out_dir) == ("enhanced_cnn", "cifar10", "bfloat16", "dense",
                             25, 0.1, 10, "Graphs")
    assert cfg.device is None and cfg.augment
    # the reference's dead flags parse as no-ops; --backend jax|gloo|nccl|
    # mpi all run the gloo group (JAX takes them as no-ops of XLA)
    t_config.config_from_args(["--local-rank", "0", "--gpu_weight", "1.0",
                               "--dist-url", "tcp://x", "--backend", "gloo"])
    assert t_config.config_from_args(["--backend", "nccl"]).backend == "nccl"


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


def _bf16_fwd(d=64):
    return (f"_ZN5flash4sm9015fwd_kernel_sm90I13__nv_bfloat16Li{d}EEEv"
            "14CUtensorMap_stS3_S3_S3_Pfiiiiiif")


def _bf16_dq(d=64):
    return (f"_ZN5flash4sm9018bwd_dq_kernel_sm90I13__nv_bfloat16Li{d}EEEv"
            "14CUtensorMap_stS3_S3_S3_S3_PKfS5_iiiiiif")


def _bf16_dkv(d=64):
    return (f"_ZN5flash4sm9019bwd_dkv_kernel_sm90I13__nv_bfloat16Li{d}EEEv"
            "14CUtensorMap_stS3_S3_S3_S3_S3_PKfS5_iiiiiif")


def _bf16_fused(d=64):
    return (f"_ZN5flash4sm9021bwd_fused_kernel_sm90I13__nv_bfloat16Li{d}EEEv"
            "14CUtensorMap_stS3_S3_S3_S3_S3_S3_PKfS5_Pfiiiiiiif")


_BF16_FWD = _bf16_fwd()
_F32_FWD = "_ZN5flash10fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiiii"
_BF16_DQ = _bf16_dq()
_BF16_DKV = _bf16_dkv()
_F32_DQ = "_ZN5flash13bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS6_PS1_"
_BF16_DQ_FMA = "_ZN5flash13bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_"
_BF16_FUSED = _bf16_fused()
_F32_FUSED = ("_ZN5flash16bwd_fused_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS6_PfPS1_"
              "S8_")
_HMMA = "HMMA.16816.F32.BF16 R24, R4.reuse, R16, R24"
_HGMMA = "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"
_UTMALDG = "UTMALDG.4D [UR8], [UR4]"
_WGMMA = (_UTMALDG, "SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR10], RZ", _HGMMA,
          "WARPGROUP.DEPBAR.LE gsb0, 0x0")
_FMA = ["LDS R8, [R2+0x100]", "FFMA R4, R8, R9, R4", "EXIT"]
_KERNEL_IDS = ("forward", "fused", "dq", "dkv")
# each kernel's bf16 name and the extra instances' argument of _libraries
_BF16_NAME = {"forward": _bf16_fwd, "dq": _bf16_dq, "dkv": _bf16_dkv,
              "fused": _bf16_fused}
_EXTRA_OF = {"forward": "extra_fwd", "dq": "extra_bwd", "dkv": "extra_bwd",
             "fused": "extra_fused"}


def _libraries(forward=_WGMMA, fused=_WGMMA, dq=_WGMMA, dkv=_WGMMA,
               extra_bwd=(), extra_fwd=(), extra_fused=()):
    """Canned cuobjdump text of the three libraries: each kernel's bf16
    instance with the given instructions beside its fp32 FMA instance (all
    four on HGMMA fed by TMA by default, the wgmma design)."""
    return {"flash_fwd": _sass((_F32_FWD, _FMA), (_BF16_FWD, forward),
                               *extra_fwd),
            "flash_bwd": _sass((_F32_DQ, _FMA), (_BF16_DQ, dq),
                               (_BF16_DKV, dkv), *extra_bwd),
            "flash_bwd_fused": _sass((_F32_FUSED, _FMA), (_BF16_FUSED, fused),
                                     *extra_fused)}


def _at_head_dims(kernel, ops_at):
    """_libraries with ``kernel``'s bf16 instances at D = 32, 64 and 128
    holding ``ops_at(d)``, the other kernels on the wgmma design."""
    return _libraries(**{kernel: ops_at(64), _EXTRA_OF[kernel]: [
        (_BF16_NAME[kernel](d), ops_at(d)) for d in (32, 128)]})


def test_smoke_sass_check_finds_tensor_core_instructions():
    smoke = _chip_smoke()
    text = _sass((_BF16_FWD, ["LDSM.16.M88.4 R4, [R2]", _HMMA,
                              "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24",
                              _HMMA, "EXIT"]), (_F32_FWD, _FMA))
    assert smoke.tensor_core_ops(text) == {
        _BF16_FWD: ["HGMMA.64x64x16.F32.BF16", "HMMA.16816.F32.BF16"],
        _F32_FWD: []}
    found = smoke.check_tensor_cores(_libraries(fused=[*_WGMMA, _HGMMA]))
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
    wgmma one fails the check, though the _sm90 instance holds HGMMA."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(
            _libraries(extra_bwd=[(_BF16_DQ_FMA, _FMA)]))
    err = capsys.readouterr().err
    assert "flash_bwd_dq" in err and "hold no HMMA/HGMMA" in err


def test_smoke_sass_check_passes_wgmma_kernels_at_every_head_dim(capsys):
    """All four kernels on HGMMA fed by TMA at D = 32, 64 and 128: the
    check passes and names each instance's design and its TMA copies."""
    smoke = _chip_smoke()
    found = smoke.check_tensor_cores(_libraries(
        extra_fwd=[(_bf16_fwd(d), _WGMMA) for d in (32, 128)],
        extra_bwd=[(name(d), _WGMMA) for name in (_bf16_dq, _bf16_dkv)
                   for d in (32, 128)],
        extra_fused=[(_bf16_fused(d), _WGMMA) for d in (32, 128)]))
    assert found == {"flash_fwd": True, "flash_bwd_dq": True,
                     "flash_bwd_dkv": True, "flash_bwd_fused": True}
    out = capsys.readouterr().out
    assert out.count("(wgmma)") == 12 and "(tensor-core)" not in out
    assert "UTMALDG" in out
    assert all(smoke.KERNELS[k][4] == "wgmma" for k in smoke.KERNELS)


@pytest.mark.parametrize("kernel", ("forward", "dkv", "dq", "fused"))
def test_smoke_sass_check_fails_on_an_hmma_only_wgmma_kernel(capsys, kernel):
    """A kernel designed for wgmma whose bf16 instance holds only HMMA (the
    mma.sync design it replaced) fails, though HMMA is a tensor-core
    instruction."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(_libraries(
            **{kernel: (_UTMALDG, _HMMA)}))
    err = capsys.readouterr().err
    assert "designed for wgmma" in err and "no HGMMA" in err


@pytest.mark.parametrize("head_dim", (32, 64, 128))
@pytest.mark.parametrize("kernel", ("forward", "dkv", "dq", "fused"))
def test_smoke_sass_check_fails_on_one_hmma_head_dim(capsys, kernel,
                                                     head_dim):
    """Every bf16 instance of a wgmma kernel must hold HGMMA: one head
    dim's instance on HMMA alone fails the check while the others pass."""
    libraries = _at_head_dims(kernel, lambda d: (
        (_UTMALDG, _HMMA) if d == head_dim else _WGMMA))
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(libraries)
    assert f"Li{head_dim}E" in capsys.readouterr().err


def test_smoke_sass_check_fails_on_a_wgmma_kernel_without_tma(capsys):
    """HGMMA from shared memory that no TMA copy fills (no UTMALDG) is not
    the design the wgmma kernels claim."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(_libraries(forward=(_HGMMA,)))
    assert "no UTMALDG" in capsys.readouterr().err


@pytest.mark.parametrize("kernel", ("dq", "fused"))
def test_smoke_sass_check_keeps_hmma_for_the_tensor_core_kernels(capsys,
                                                                 kernel):
    """dq and the fused kernel left their mma.sync design for wgmma: an
    instance on HMMA alone (that design, with no TMA) now fails for them,
    as it does for the forward and dkv."""
    with pytest.raises(SystemExit):
        _chip_smoke().check_tensor_cores(
            _libraries(**{kernel: (_HMMA, "EXIT")}))
    err = capsys.readouterr().err
    assert "designed for wgmma" in err and "no HGMMA" in err


def test_smoke_sass_check_fails_without_cuobjdump(capsys, monkeypatch):
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke.shutil, "which", lambda name: None)
    monkeypatch.setattr(smoke.os.path, "exists", lambda path: False)
    with pytest.raises(SystemExit):
        smoke.find_cuobjdump()
    assert "cuobjdump not found" in capsys.readouterr().err
