"""Configuration: the flags the ported slice reads, with the JAX package's
names and defaults (reference: ``..._tpu/config.py:20-125, 1232-1610``).

Flags of features that are not ported yet still parse, so a launch line
written for the JAX package fails with a clear message instead of an
argparse error: any non-default value raises a ValueError naming the
ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import dataclasses

# flag -> (default, ROADMAP item that ports it).  A non-default value is
# rejected in Config.__post_init__; "mesh_shape" also accepts data=1.
NOT_PORTED = {
    "sync_mode": ("auto", "A.8 (bucketed sync engines on NCCL)"),
    "sync_dtype": ("float32", "A.8 (compressed sync wire)"),
    "sync_compression": ("none", "A.8 (error-feedback residuals)"),
    "sync_staleness": (0, "A.8 (semi-synchronous rounds)"),
    "remat_policy": ("none", "A.7 (transformer slice: torch.utils.checkpoint)"),
    "grad_accum": (1, "A.7 (transformer slice: gradient accumulation)"),
    "num_experts": (0, "A.7 (transformer slice: MoE FFN)"),
    "layer_scan": ("auto", "A.7 (the port keeps per-block params; weights.py "
                           "converts both JAX layouts)"),
    "mesh_shape": ("data=-1", "A.11 (tensor/pipeline/sequence parallelism)"),
    "sequence_parallel": ("none", "A.11 (ring / Ulysses attention)"),
    "stream_chunk_steps": (0, "A.3 (streamed input pipeline)"),
    "model_width": (0, "A.2 (CNN main path)"),
    "checkpoint_dir": ("", "A.9 (checkpoint engine)"),
    "chaos": ("", "A.11 (elastic membership + chaos)"),
    "sim_workers": (0, "A.11 (scenario lab)"),
    "num_slices": (1, "A.11 (hierarchical two-level sync)"),
}


def _choices(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass
class Config:
    """Run configuration of the ported slice (same field names and defaults
    as the JAX ``Config``)."""

    # --- reference-parity flags -------------------------------------------
    backend: str = "jax"          # gloo|nccl|mpi accepted as compat no-ops
    epochs_local: int = 5
    epochs_global: int = 20
    batch_size: int = 64
    lr: float = 1e-3
    time_limit: float = 60.0      # straggler grace budget, seconds
    prev_fraction: float = 0.5
    next_fraction: float = 0.5
    aggregation_type: str = "equal"      # equal | weighted
    aggregation_by: str = "gradients"    # gradients | weights
    local_weight: float = 0.5
    fixed_ratio: float = 0.5
    topology: str = "allreduce"   # allreduce | ring | double_ring
    data_mode: str = "balanced"   # balanced | disbalanced

    # --- framework knobs -----------------------------------------------------
    model: str = "enhanced_cnn"
    dataset: str = "cifar10"
    num_workers: int = 0          # 0 => one worker per device (one here)
    seed: int = 0
    dtype: str = "float32"        # param dtype
    compute_dtype: str = "bfloat16"
    lr_step_size: int = 25        # StepLR per LOCAL epoch
    lr_gamma: float = 0.1
    proportionality: str = "inverse"   # inverse | direct | uniform
    probe_batches: int = 10
    data_dir: str = "data"
    out_dir: str = "Graphs"
    log_level: str = "info"
    limit_train_samples: int = 0
    limit_eval_samples: int = 0
    augment: bool = True          # image augmentation (no-op for tokens)
    attention_impl: str = "dense"  # dense | flash (hand-written CUDA kernels)
    num_kv_heads: int = 0         # > 0 => grouped-query attention (llama_*)
    device: str | None = None     # None => cuda; "cpu" runs the plain paths

    # --- flags of features not ported yet (see NOT_PORTED) ------------------
    sync_mode: str = "auto"
    sync_dtype: str = "float32"
    sync_compression: str = "none"
    sync_staleness: int = 0
    remat_policy: str = "none"
    grad_accum: int = 1
    num_experts: int = 0
    layer_scan: str = "auto"
    mesh_shape: str = "data=-1"
    sequence_parallel: str = "none"
    stream_chunk_steps: int = 0
    model_width: int = 0
    checkpoint_dir: str = ""
    chaos: str = ""
    sim_workers: int = 0
    num_slices: int = 1

    def __post_init__(self) -> None:
        _choices("backend", self.backend, ("jax", "gloo", "nccl", "mpi"))
        _choices("aggregation_type", self.aggregation_type,
                 ("equal", "weighted"))
        _choices("aggregation_by", self.aggregation_by,
                 ("gradients", "weights"))
        _choices("topology", self.topology,
                 ("allreduce", "ring", "double_ring"))
        _choices("data_mode", self.data_mode, ("balanced", "disbalanced"))
        _choices("proportionality", self.proportionality,
                 ("inverse", "direct", "uniform"))
        _choices("attention_impl", self.attention_impl, ("dense", "flash"))
        _choices("compute_dtype", self.compute_dtype,
                 ("bfloat16", "float32"))
        _choices("device", self.device, (None, "cuda", "cpu"))
        if self.dtype != "float32":
            raise NotImplementedError(
                "param dtype other than float32 is not supported; use "
                "--compute_dtype for bfloat16 activations/matmuls")
        for name, (default, where) in NOT_PORTED.items():
            value = getattr(self, name)
            if value == default or (name == "mesh_shape"
                                    and value == "data=1"):
                continue
            if name == "sync_mode" and value == "dense":
                continue
            raise ValueError(
                f"--{name} {value} is not ported to the PyTorch package yet; "
                f"it arrives with ROADMAP queue {where}")
        if self.num_workers > 1:
            raise ValueError(
                f"--num_workers {self.num_workers}: the PyTorch port runs one "
                "worker so far; the multi-worker sync matrix on "
                "torch.distributed is ROADMAP queue A.5")
        if self.epochs_local < 1 or self.batch_size < 1:
            raise ValueError("epochs_local and batch_size must be >= 1")


def build_argparser() -> argparse.ArgumentParser:
    """CLI with the JAX package's flag names and defaults for the ported
    slice (plus the parse-then-reject flags of ``NOT_PORTED``)."""
    d = Config()
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA local-SGD distributed training framework")
    # the reference's dead flags, accepted as documented no-ops
    p.add_argument("--local-rank", type=int, dest="local_rank", default=None)
    p.add_argument("--gpu_weight", type=float, default=None)
    p.add_argument("--dist-url", type=str, dest="dist_url", default=None)
    p.add_argument("--backend", type=str, default=d.backend,
                   choices=["jax", "gloo", "nccl", "mpi"])
    for name in ("epochs_local", "epochs_global", "batch_size", "num_workers",
                 "seed", "probe_batches", "limit_train_samples",
                 "limit_eval_samples", "num_kv_heads"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("lr", "time_limit", "prev_fraction", "next_fraction",
                 "local_weight", "fixed_ratio"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    p.add_argument("--aggregation_type", default=d.aggregation_type,
                   choices=["equal", "weighted"])
    p.add_argument("--aggregation_by", default=d.aggregation_by,
                   choices=["gradients", "weights"])
    p.add_argument("--topology", default=d.topology,
                   choices=["allreduce", "ring", "double_ring"])
    p.add_argument("--data_mode", default=d.data_mode,
                   choices=["balanced", "disbalanced"])
    p.add_argument("--proportionality", default=d.proportionality,
                   choices=["inverse", "direct", "uniform"])
    p.add_argument("--attention_impl", default=d.attention_impl,
                   choices=["dense", "flash"],
                   help="attention for transformer models (flash = the "
                        "hand-written Hopper kernels)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (plain PyTorch paths)")
    for name in ("model", "dataset", "dtype", "compute_dtype", "data_dir",
                 "out_dir", "log_level"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    p.add_argument("--no_augment", action="store_true")
    for name, (default, _where) in NOT_PORTED.items():
        p.add_argument(f"--{name}", type=type(default), default=default,
                       help="not ported yet (rejected unless default)")
    return p


def config_from_args(argv: list[str] | None = None) -> Config:
    args = build_argparser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["augment"] = not args.no_augment
    return Config(**kw)
