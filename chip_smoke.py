#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: the quickest proof that it builds
and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device  - the card's name, count, and nvidia-smi name/power limit;
2. build   - nvcc builds every kernel from csrc/ (sm_90a) and prints the
             ptxas report (registers, shared memory, spills); cuobjdump
             lists the tensor-core instructions (HMMA, HGMMA) in each
             kernel's bf16 instances, and the phase fails if a kernel
             designed for the tensor cores (all four) has a bf16 instance
             without them;
3. kernels - each flash kernel against its plain PyTorch version on the
             same bf16 inputs, at both paths' shapes, at L=2048 causal and
             non-causal, and at a long GQA shape; times for the kernel, the
             plain version and a PyTorch attention call (a yardstick the
             port never calls), beside the least time the card could take,
             and the two-pass pair (dq + dkv) against PyTorch's flash
             backward;
4. path    - the port's CLI flow (main.run) trains full-width gpt2_small
             with --attention_impl flash on synthetic_lm (two-pass
             backward), with launch counters reset just before and read
             just after; checks the counts, finite and falling losses, and
             the trained model's flash logits against its dense logits on a
             small input;
5. profile - device time by kernel over a few more train steps of the
             trained model (torch.profiler), and the device's busy share;
6. llama   - the same two phases for full-width llama_medium with 4 K/V
             heads under FLASH_BWD=fused (the fused backward kernel), in a
             child process, since the switch is read once at import.

The last lines are the nvidia-smi line, one JSON object with a row per
kernel, and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PKG = "learning_deep_neural_network_in_distributed_computing_environment_tpu_torch"
JAX_PKG = "learning_deep_neural_network_in_distributed_computing_environment_tpu"
# H100 SXM data-sheet peaks: HBM3
# bytes/s and dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# torch.cuda._sleep cycles per millisecond at the 1.98 GHz boost clock
SLEEP_CYCLES_PER_MS = 1.98e6
PATH_BATCH, PATH_LEN = 64, 128
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # the paths' plots
_COMMON_ARGV = ["--dataset", "synthetic_lm", "--attention_impl", "flash",
                "--epochs_global", "1", "--epochs_local", "1",
                "--batch_size", str(PATH_BATCH), "--limit_train_samples",
                "1280", "--limit_eval_samples", "256"]
# path name -> (argv of main.run, layers: one launch each per pass)
PATHS = {
    "gpt2": (["--model", "gpt2_small", *_COMMON_ARGV, "--out_dir",
              os.path.join(OUT_DIR, "gpt2")], 12),
    "llama": (["--model", "llama_medium", "--num_kv_heads", "4",
               *_COMMON_ARGV, "--out_dir", os.path.join(OUT_DIR, "llama")],
              16),
}
PROFILE_STEPS = 4              # 4 x 64 sequences of the 256-sequence test set
LLAMA_PHASE = "llama"          # the child's argument
RESULT_TAG = "chip_smoke-llama-result "

# (label, B, L, H, KV, D, causal); "main" is the gpt2 path's shape and
# "llama_path" the llama path's
SHAPES = [
    ("main", PATH_BATCH, PATH_LEN, 12, 12, 64, True),
    ("L2048_causal", 4, 2048, 12, 12, 64, True),
    ("L2048", 4, 2048, 12, 12, 64, False),
    ("gqa_llama_medium", 2, 1024, 16, 4, 64, True),
    ("llama_path", PATH_BATCH, PATH_LEN, 16, 4, 64, True),
]
# Tolerances, as max |kernel - plain| / max |plain| on bf16 inputs (the
# plain version computes in fp32 on the same bf16 values).  O and the
# gradients are rounded to bf16 (relative spacing 2^-8) after fp32
# accumulation in a different order: 1e-2 for O, 2e-2 for the gradients,
# whose terms are larger products.  The fused kernel's dq is summed by
# fp32 atomics whose order changes from run to run; it is rounded to bf16
# once, so the same 2e-2 holds.  lse stays fp32 end to end: 1e-3 absolute.
TOL_O, TOL_GRAD, TOL_LSE = 1e-2, 2e-2, 1e-3
# kernel -> (source, TPU kernel it replaces, the path and shape its JSON
# row reports, design of its bf16 instance)
KERNELS = {
    "flash_fwd": ("csrc/flash_fwd.cu", "ops/pallas_ops.py:66", "gpt2",
                  "main", "tensor-core"),
    "flash_bwd_dq": ("csrc/flash_bwd.cu", "ops/pallas_ops.py:192", "gpt2",
                     "main", "tensor-core"),
    "flash_bwd_dkv": ("csrc/flash_bwd.cu", "ops/pallas_ops.py:235", "gpt2",
                      "main", "tensor-core"),
    "flash_bwd_fused": ("csrc/flash_bwd_fused.cu", "ops/pallas_ops.py:290",
                        "llama", "llama_path", "tensor-core"),
}
# kernel -> (its library in ops/_build.py, a name its device functions
# carry); a bf16 instance has __nv_bfloat16 in its mangled name
SASS_SYMBOLS = {"flash_fwd": ("flash_fwd", "fwd_kernel"),
                "flash_bwd_dq": ("flash_bwd", "bwd_dq_kernel"),
                "flash_bwd_dkv": ("flash_bwd", "bwd_dkv_kernel"),
                "flash_bwd_fused": ("flash_bwd_fused", "bwd_fused_kernel")}
TENSOR_CORE_OP = re.compile(r"\bHG?MMA(?:\.\w+)+")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, paced: bool = False) -> float:
    """Mean milliseconds per call from CUDA events, after two warm-up calls.

    By default the device's time: a device-side sleep queued first keeps
    the card busy while the host enqueues all the calls, so the host's cost
    per call (Python, allocation, the launch) leaves no gap between them;
    the sleep is doubled until the host finished enqueueing before the
    first event was reached.  ``paced=True`` times the calls back to back
    with no sleep, so a call that the host enqueues more slowly than the
    card runs it is timed at the host's pace."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 1.0 + 0.5 * iters
    while True:
        if not paced:
            torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = paced or not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        sleep_ms *= 2


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of bytes over the
    memory rate and operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> tuple[str, str]:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build() -> None:
    from importlib import import_module
    build = import_module(f"{PKG}.ops._build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} "
          f"built in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line.lower() for w in ("ptxas", "spill", "error")):
                print(f"[build] {name}: {line.strip()}")


def tensor_core_ops(sass: str) -> dict[str, list[str]]:
    """Each device function in ``cuobjdump -sass`` text -> the distinct
    tensor-core instructions (HMMA, HGMMA) in it, sorted."""
    ops: dict[str, set] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            name = head.group(1)
            ops[name] = set()
        elif name is not None:
            ops[name].update(TENSOR_CORE_OP.findall(line))
    return {n: sorted(found) for n, found in ops.items()}


def check_tensor_cores(sass_by_library: dict[str, str]) -> dict[str, bool]:
    """kernel -> whether every bf16 instance of it runs tensor-core
    instructions; fails if a kernel designed for the tensor cores has no
    bf16 instance or one without them."""
    result = {}
    for kernel, (library, symbol) in SASS_SYMBOLS.items():
        found = {n: o for n, o in tensor_core_ops(
            sass_by_library[library]).items()
                 if symbol in n and "__nv_bfloat16" in n}
        for fn, ops in sorted(found.items()):
            print(f"[build] sass {kernel} {fn[:70]}: "
                  f"{' '.join(ops) or 'no tensor-core instruction'}")
        result[kernel] = bool(found) and all(found.values())
        if KERNELS[kernel][4] == "tensor-core" and not result[kernel]:
            fail(f"{kernel} is designed for the tensor cores but its bf16 "
                 f"instances {sorted(found) or '(none found)'} hold no "
                 f"HMMA/HGMMA instruction")
    return result


def find_cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        found = "/usr/local/cuda/bin/cuobjdump"
    if found is None:
        fail("cuobjdump not found (it ships with nvcc): the build phase "
             "needs it to check the kernels' tensor-core instructions")
    return found


def phase_sass() -> dict[str, bool]:
    """``cuobjdump -sass`` of each built library, then check_tensor_cores."""
    from importlib import import_module
    build = import_module(f"{PKG}.ops._build")
    tool = find_cuobjdump()
    sass = {lib: subprocess.run(
        [tool, "-sass", str(build._library_path(lib))], capture_output=True,
        text=True, check=True).stdout
        for lib in sorted({lib for lib, _ in SASS_SYMBOLS.values()})}
    return check_tensor_cores(sass)


def _err(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    e = (out.float() - ref.float()).abs().max().item()
    return e, e / max(ref.float().abs().max().item(), 1e-30)


def _sdpa_backward_ms(q, k, v, do, causal, iters):
    """Yardstick the port never calls: PyTorch's flash-attention backward
    (``aten._scaled_dot_product_flash_attention_backward``) alone, on its
    own forward's outputs, with grouped K/V as given (GQA).  Should that
    call refuse grouped K/V, it is timed on K/V expanded to full heads and
    the note says so.  Returns (ms or None, note)."""
    import torch
    aten = torch.ops.aten
    dot = do.transpose(1, 2)

    def timed(k_, v_):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k_, v_))
        fwd = aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
        bwd = lambda: aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
            offset)
        return cuda_ms(bwd, iters)

    note = "aten flash-attention backward"
    try:                                         # a yardstick, not the port
        return timed(k, v), note + ("" if k.shape[2] == q.shape[2]
                                    else " on grouped K/V")
    except (RuntimeError, TypeError, ValueError) as e:
        if k.shape[2] == q.shape[2]:
            return None, f"{note} unavailable: {e}"
        refused = str(e).splitlines()[0][:120]
    rep = q.shape[2] // k.shape[2]
    try:
        ms = timed(*(t.repeat_interleave(rep, 2) for t in (k, v)))
        return ms, (f"{note} on K/V expanded to full heads (grouped K/V "
                    f"refused: {refused})")
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"{note} unavailable: {refused}; expanded: {e}"


def check_shape(label, b, l, h, kv, d, causal) -> dict:
    """Each kernel against its plain version at one shape; returns the
    per-kernel numbers for that shape."""
    import torch
    import torch.nn.functional as F
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
    q, k, v, do = rnd(b, l, h, d), rnd(b, l, kv, d), rnd(b, l, kv, d), \
        rnd(b, l, h, d)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fl.plain_forward(*f32[:3], causal)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    dq_ref = fl.plain_bwd_dq(*f32, lse_ref, delta, causal)
    dk_ref, dv_ref = fl.plain_bwd_dkv(*f32, lse_ref, delta, causal)
    fused_ref = fl.plain_bwd_fused(*f32, lse_ref, delta, causal)

    o, lse = fl.kernel_forward(q, k, v, causal, with_lse=True)
    dq = fl.kernel_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fl.kernel_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    fused = fl.kernel_bwd_fused(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    checks = {"flash_fwd": [("o", o, o_ref, TOL_O)],
              "flash_bwd_dq": [("dq", dq, dq_ref, TOL_GRAD)],
              "flash_bwd_dkv": [("dk", dk, dk_ref, TOL_GRAD),
                                ("dv", dv, dv_ref, TOL_GRAD)],
              "flash_bwd_fused": [(n, got, ref, TOL_GRAD) for n, got, ref
                                  in zip(("dq", "dk", "dv"), fused,
                                         fused_ref)]}
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= TOL_LSE:
        fail(f"{label}: flash_fwd lse differs from plain by {lse_err}")

    # work each function must do at this shape (causal: the visible pairs),
    # each input read once and each output written once in its own dtype:
    # the fused kernel's fp32 dq accumulator is its design, not the work
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    qb, kvb, rowb = b * l * h * d * 2, b * l * kv * d * 2, b * h * l * 4
    work = {"flash_fwd": (2 * qb + 2 * kvb + rowb, 4 * pairs * d),
            "flash_bwd_dq": (3 * qb + 2 * kvb + 2 * rowb, 6 * pairs * d),
            "flash_bwd_dkv": (2 * qb + 4 * kvb + 2 * rowb, 8 * pairs * d),
            "flash_bwd_fused": (3 * qb + 4 * kvb + 2 * rowb,
                                10 * pairs * d)}
    iters = 20 if l <= 128 else 5
    times = {
        "flash_fwd": (lambda: fl.kernel_forward(q, k, v, causal, True),
                      lambda: fl.plain_forward(q, k, v, causal)),
        "flash_bwd_dq": (
            lambda: fl.kernel_bwd_dq(q, k, v, do, lse_ref, delta, causal),
            lambda: fl.plain_bwd_dq(q, k, v, do, lse_ref, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fl.kernel_bwd_dkv(q, k, v, do, lse_ref, delta, causal),
            lambda: fl.plain_bwd_dkv(q, k, v, do, lse_ref, delta, causal)),
        "flash_bwd_fused": (
            lambda: fl.kernel_bwd_fused(q, k, v, do, lse_ref, delta, causal),
            lambda: fl.plain_bwd_fused(q, k, v, do, lse_ref, delta, causal)),
    }
    # yardsticks the port never calls: SDPA forward, forward+backward, and
    # PyTorch's flash backward alone
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=causal, enable_gqa=kv != h)
    sdpa_fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt), iters)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    dot = do.transpose(1, 2)
    sdpa_fb_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg), (qg, kg, vg), dot), iters)
    bwd_ms, bwd_note = _sdpa_backward_ms(q, k, v, do, causal, iters)
    library = {"flash_fwd": (sdpa_fwd_ms, "sdpa fwd"),
               "flash_bwd_dq": (None, "no one call; sdpa fwd+bwd "
                                      f"{sdpa_fb_ms:.4f}"),
               "flash_bwd_dkv": (None, "no one call; sdpa fwd+bwd "
                                       f"{sdpa_fb_ms:.4f}"),
               "flash_bwd_fused": (bwd_ms, bwd_note)}

    rows = {}
    for name, pairs_ in checks.items():
        errs = []
        for what, out, ref, tol in pairs_:
            e, rel = _err(out, ref)
            if not (math.isfinite(e) and rel <= tol):
                fail(f"{label}: {name} {what} max abs err {e:.3g} "
                     f"({rel:.3g} of max |plain|) exceeds {tol}")
            errs.append(e)
        kernel_fn, plain_fn = times[name]
        b_ms, b_by = bound(*work[name])
        lib_ms, lib_note = library[name]
        rows[name] = dict(
            max_abs_err=max(errs), ms=cuda_ms(kernel_fn, iters),
            paced_ms=cuda_ms(kernel_fn, iters, paced=True),
            plain_ms=cuda_ms(plain_fn, max(iters // 4, 2)),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_note=lib_note, library_fwd_bwd_ms=sdpa_fb_ms,
            shape=[b, l, h, kv, d, causal])
        r = rows[name]
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"[kernels] {label} [B={b} L={l} H={h} KV={kv} D={d} "
              f"causal={causal}] {name}: kernel_ms {r['ms']:.4f} (host-paced "
              f"{r['paced_ms']:.4f}) plain_ms "
              f"{r['plain_ms']:.4f} library_ms {lib} ({lib_note}) "
              f"bound_ms {b_ms:.5f} ({b_by}) max_err {r['max_abs_err']:.3g}")
    # the two-pass pair computes what aten's flash backward computes
    pair_ms = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    ratio = "null" if bwd_ms is None else f"{pair_ms / bwd_ms:.3f}"
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name].update(pair_ms=pair_ms, pair_library_ms=bwd_ms)
    print(f"[kernels] {label} two-pass pair (flash_bwd_dq + flash_bwd_dkv): "
          f"kernel_ms {pair_ms:.4f} library_ms "
          f"{'null' if bwd_ms is None else f'{bwd_ms:.4f}'} ({bwd_note}) "
          f"x library {ratio}")
    return rows


def phase_kernels() -> dict:
    import torch
    # the plain versions' fp32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {shape[0]: check_shape(*shape) for shape in SHAPES}


def run_path(name: str) -> tuple[dict, dict]:
    """Drive one path through main.run with the launch counters reset just
    before and read just after; check the counts, the losses and the flash
    logits against the dense ones; print the step time and memory."""
    import numpy as np
    import torch
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    main = import_module(f"{PKG}.main")
    argv, layers = PATHS[name]
    torch.cuda.reset_peak_memory_stats()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    results = main.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fl.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rt = results["round_timings"]
    train_steps = sum(r["train_steps"] for r in rt)
    val_steps = sum(r["val_steps"] for r in rt)
    eval_batches = -(-len(results["test"].labels) // PATH_BATCH)
    probe_passes = 1 + 10          # warm-up + --probe_batches default
    fwd = layers * (probe_passes + train_steps + val_steps + eval_batches)
    bwd = layers * (probe_passes + train_steps)
    fused = fl._use_fused_bwd()
    expect = {"flash_fwd": fwd,
              "flash_bwd_dq": 0 if fused else bwd,
              "flash_bwd_dkv": 0 if fused else bwd,
              "flash_bwd_fused": bwd if fused else 0}
    print(f"[{name}] launches {counts}; expected {expect} "
          f"({train_steps} train steps, {val_steps} val steps, "
          f"{eval_batches} eval batches, {probe_passes} probe passes, "
          f"FLASH_BWD={'fused' if fused else 'two-pass'})")
    if train_steps < 12:
        fail(f"{name} path ran only {train_steps} train steps")
    if counts != expect or not all(counts[n] > 0 for n in expect
                                   if expect[n]):
        fail(f"{name}: launch counts {counts} do not match the path's "
             f"{expect}")
    losses = results["all_workers_losses"][0]
    curves = [losses] + [results[k] for k in (
        "global_train_losses", "global_val_losses",
        "worker_specific_train_losses")]
    if not all(math.isfinite(x) for c in curves for x in c):
        fail(f"non-finite loss in the {name} path's metrics")
    first, last = losses[0], results["worker_specific_train_losses"][-1]
    if not last < first:
        fail(f"{name}: train loss did not fall: first batch {first}, last "
             f"epoch {last}")
    if not math.isfinite(results["test_eval"]["loss"]):
        fail(f"{name}: non-finite test loss")

    # the trained model's flash logits against its dense logits (the
    # port's reference attention) on a small input
    model = results["model"]
    x = torch.from_numpy(np.asarray(results["test"].images[:4])).to(
        next(model.parameters()).device, torch.long)
    with torch.no_grad():
        flash_logits = model(x)
        attns = [m for m in model.modules() if hasattr(m, "attention_impl")]
        for m in attns:
            m.attention_impl = "dense"
        dense_logits = model(x)
        for m in attns:
            m.attention_impl = "flash"
    want = (4, PATH_LEN, results["test"].num_classes)
    if tuple(flash_logits.shape) != want:
        fail(f"{name}: logits shape {tuple(flash_logits.shape)}, expected "
             f"{want}")
    e, rel = _err(flash_logits, dense_logits)
    print(f"[{name}] flash vs dense logits on 4 test sequences: max abs err "
          f"{e:.4g} ({rel:.3g} of max |dense|)")
    if not (math.isfinite(e) and rel <= 5e-2):
        fail(f"{name}: flash and dense logits disagree beyond bf16 "
             f"tolerance 5e-2")

    train_ms = sum(r["train_ms"] for r in rt)
    step_ms = train_ms / train_steps
    tokens_s = train_steps * PATH_BATCH * PATH_LEN / (train_ms / 1e3)
    params = sum(p.numel() for p in model.parameters())
    print(f"[{name}] {params:,} params; wall {wall:.1f} s; train step "
          f"{step_ms:.3f} ms; {tokens_s:.0f} tokens/s; first-batch loss "
          f"{first:.4f} -> last-epoch mean {last:.4f}; val loss "
          f"{results['global_val_losses'][-1]:.4f}; test loss "
          f"{results['test_eval']['loss']:.4f}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    return counts, results


def phase_profile(name: str, results) -> None:
    """Where a train step's device time goes: one more round of
    PROFILE_STEPS train steps of the trained model under torch.profiler,
    after the path's counts were read.  Prints device time by kernel and
    the device's busy share of the round's wall time."""
    import numpy as np
    import torch
    from importlib import import_module
    from torch.profiler import ProfilerActivity, profile
    cfg = import_module(f"{PKG}.config").config_from_args(PATHS[name][0])
    train = import_module(f"{PKG}.train")
    device = next(results["model"].parameters()).device
    engine = train.LocalSGDEngine(results["model"], cfg, device)
    state = results["state"]
    test = results["test"]
    n = PROFILE_STEPS * PATH_BATCH
    shape = (1, PROFILE_STEPS, PATH_BATCH, -1)
    pack = (test.images[:n].reshape(shape), test.labels[:n].reshape(shape),
            np.ones((1, PROFILE_STEPS, PATH_BATCH), np.float32))
    val = tuple(a[:, :1] for a in pack)
    engine.round(state, pack, val)              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.round(state, pack, val)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kind = (torch.autograd.DeviceType.CUDA if device.type == "cuda"
            else torch.autograd.DeviceType.CPU)
    rows = [e for e in prof.key_averages() if e.device_type == kind]
    attr = ("self_device_time_total" if device.type == "cuda"
            else "self_cpu_time_total")
    dev_us = lambda e: getattr(e, attr)
    rows.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    if not busy > 0:
        fail("the profiler recorded no device time")
    tag = f"[profile {name}]"
    print(f"{tag} {PROFILE_STEPS} train steps + 1 val step: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for e in rows[:20]:
        print(f"{tag} {dev_us(e) / 1e3:9.3f} ms "
              f"{100 * dev_us(e) / busy:5.1f}% x{e.count:<5d} {e.key[:100]}")


def llama_child() -> int:
    """The llama path, run in a child process whose environment has
    FLASH_BWD=fused before the port is imported; prints its counts as one
    tagged JSON line for the parent."""
    from importlib import import_module
    if not import_module(f"{PKG}.ops.flash")._use_fused_bwd():
        fail("the llama child does not see FLASH_BWD=fused")
    counts, results = run_path("llama")
    phase_profile("llama", results)
    print(RESULT_TAG + json.dumps({"counts": counts}), flush=True)
    return 0


def phase_llama() -> dict:
    """Run llama_child in a child process with FLASH_BWD=fused; echo its
    output and return its launch counts."""
    env = {**os.environ, "FLASH_BWD": "fused"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           LLAMA_PHASE], env=env, capture_output=True,
                          text=True, timeout=900)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT_TAG):
            result = json.loads(line[len(RESULT_TAG):])
        else:
            print(line)
    if proc.returncode != 0 or result is None:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"the llama child exited with {proc.returncode}"
             + ("" if result else " and printed no result line"))
    return result["counts"]


def main() -> int:
    if sys.argv[1:] == [LLAMA_PHASE]:
        return llama_child()
    # the gpt2 path runs the two-pass backward: the switch is read once, at
    # the port's import, so it must be gone before anything imports it
    os.environ.pop("FLASH_BWD", None)
    name, smi = phase_device()
    import torch  # noqa: F401  (device phase checked the card)
    phase_build()
    tensor_cores = phase_sass()
    rows = phase_kernels()
    counts = {}
    counts["gpt2"], results = run_path("gpt2")
    phase_profile("gpt2", results)
    del results                    # give the card back for the child
    torch.cuda.empty_cache()
    counts["llama"] = phase_llama()
    kernels = []
    for kname, (src, replaces, path, shape, design) in KERNELS.items():
        kernels.append(dict(
            name=kname, route="cuda", source=f"{PKG}/{src}",
            replaces=f"{JAX_PKG}/{replaces}", launches=counts[path][kname],
            launches_by_path={p: c[kname] for p, c in counts.items()},
            path=path, tensor_cores=tensor_cores[kname], design=design,
            **rows[shape][kname]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
