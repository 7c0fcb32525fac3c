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

# flag -> (default, ROADMAP item that ports it).  A value other than the
# default is rejected in Config.__post_init__.
NOT_PORTED = {
    "layer_scan": ("auto", "A.11 (the port keeps one module per block, "
                           "which is what auto gives; weights.py converts "
                           "both JAX layouts)"),
}
# the --mesh_shape axes the port runs (JAX mesh.py's names)
MESH_AXES = ("data", "fsdp", "seq", "pipe", "expert", "model")
PP_SCHEDULES = ("gpipe", "1f1b")
SEQUENCE_PARALLEL = ("none", "ring", "ring_zigzag", "all_to_all")


def _choices(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass
class Config:
    """Run configuration of the ported slice (same field names and defaults
    as the JAX ``Config``)."""

    # --- reference-parity flags -------------------------------------------
    backend: str = "jax"          # jax|gloo|mpi: the gloo group; nccl: A.12
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
    num_workers: int = 0          # 0 => one per CUDA device; 1 on the CPU
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
    model_width: int = 0          # > 0 => enhanced_cnn channel base (64)
    # transformer families (JAX config.py:107-149)
    # none | dots_saveable | everything | save_names:<set> |
    # offload_names:<set> (models/remat.py; names: models.REMAT_NAMES)
    remat_policy: str = "none"
    grad_accum: int = 1           # microbatches per train step
    num_experts: int = 0          # > 0 => Switch-MoE FFN in every block
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01  # load-balance aux loss coefficient
    # checkpoints (JAX config.py:70-80; checkpoint.py)
    checkpoint_dir: str = ""      # empty => checkpointing off
    checkpoint_every: int = 0     # global epochs between checkpoints
    ckpt_async: bool = True       # the writer thread; False = inline
    ckpt_keep: int = 3            # committed checkpoints kept by the prune
    resume: bool = False
    # `main serve` (JAX config.py:330-369; serve/): the model comes from
    # the checkpoint's MANIFEST metadata
    serve_max_batch: int = 4      # decode slots (the fixed decode shape)
    serve_page_size: int = 16     # tokens per KV-cache page
    serve_max_pages: int = 64     # page-pool size (page 0 = trash page)
    serve_prompt_buckets: str = "16,64"  # prefill lengths, csv
    serve_eos_id: int = -1        # sampling this id evicts (-1 = off)
    serve_max_new_tokens: int = 16  # per-request generation budget
    serve_temperature: float = 0.0  # 0 = greedy
    serve_requests: int = 8       # synthetic requests when no prompt given
    serve_prompt: str = ""        # fixed prompt (csv token ids) for all
    serve_request_timeout: float = 0.0  # seconds an admitted request may
    #                                     run before eviction (0 = off)
    serve_prefix_cache: bool = False    # content-addressed prompt pages
    serve_prefill_chunk: int = 0  # > 0: one [1, C] prefill program
    serve_draft_ckpt: str = ""    # draft checkpoint dir ("" = off)
    serve_spec_tokens: int = 0    # draft tokens per verify (k); 0 = off
    # streamed input pipeline (JAX config.py:153-157; train.ChunkStager)
    stream_chunk_steps: int = 0   # > 0: windows of this many steps
    stream_prefetch: int = 2      # windows staged ahead (0 = synchronous)
    # scenario lab (JAX config.py:381-426; sim.py): > 0 runs that many
    # local-SGD workers in ONE process on one device, their state stacked
    # on a leading [N, ...] axis and each step one torch.func.vmap over
    # the workers; 0 = one process per worker (the real engine)
    sim_workers: int = 0
    sim_sample_frac: float = 1.0  # (0, 1]: ceil(frac * N) train per round
    sim_dropout: float = 0.0      # [0, 1): per-round worker dropout
    sim_byzantine: str = ""       # "kind:count[:scale]", last count ids
    sim_lr_jitter: float = 0.0    # [0, 1): lr * (1 + jitter * u_i)
    sim_staleness: int = 0        # deliver each consensus K rounds late

    # the bucketed sync engines (JAX config.py:182-267; comms.py):
    # auto | dense | sharded (sharded = the fast engine of the topology:
    # reduce-scatter for allreduce, bucketed gossip for ring/double_ring)
    sync_mode: str = "auto"
    sync_dtype: str = "float32"   # wire of the fast engines: bf16 | int8
    sync_compression: str = "none"   # ef: error-feedback residuals
    sync_bucket_mb: float = 4.0   # MiB of fp32 per bucket (collective)
    opt_placement: str = "auto"   # auto | replicated | sharded
    # semi-synchronous rounds (JAX config.py:164-176): K > 0 runs round
    # R's sync on a host thread under round R+1's compute and folds its
    # consensus delta in at the entry of round R+K+1 (weights mode)
    sync_staleness: int = 0

    # elastic membership and chaos (JAX config.py:299-440; chaos.py,
    # elastic.py): the fault plan, the straggler policy and the quorum
    chaos: str = ""
    chaos_seed: int = 0
    chaos_events: int = 4
    chaos_kinds: str = "kill,join,slow,stall"
    chaos_grace: float = 5.0
    chaos_retries: int = 1
    chaos_backoff: float = 0.5
    elastic_min_workers: int = 1
    # where the consensus lives between rounds, and its buddy copy
    param_residency: str = "auto"
    shard_redundancy: str = "auto"
    # the round pipeline and run observability (JAX config.py:81, 164,
    # 296): a torch.profiler trace of the round loop, the sync-debug guard
    # around each round, and the overlapped round loop
    profile_dir: str = ""         # empty => no trace
    sanitize: bool = False
    overlap_rounds: bool = True   # --no_overlap_rounds: the serial flow

    # the rank grid: data x fsdp x seq x pipe x model (mesh.Grid); data=-1 is
    # --num_workers' count
    mesh_shape: str = "data=-1"
    # the attention of the train module over the seq axis: none | ring |
    # ring_zigzag (causal models only) | all_to_all (parallel/sp.py)
    sequence_parallel: str = "none"
    # the hierarchical two-level sync (JAX config.py:203-225; comms
    # hierarchical_sync): S > 1 slices of --num_workers workers each, the
    # sharded engine over each slice's data line (inner level) and the
    # gossip hop of --topology over the slice line (outer level); the
    # outer wire ("" inherits --sync_dtype)
    num_slices: int = 1
    sync_dtype_outer: str = ""
    # pipeline parallelism over the pipe axis (JAX config.py:97-104;
    # parallel/pp.py): the schedule, the microbatches per step (0 => the
    # pipe size) and --remat_policy everything's alias under a pipe axis
    pp_schedule: str = "gpipe"
    pp_microbatches: int = 0
    pp_remat: bool = False
    # --- flags of features not ported yet (see NOT_PORTED) ------------------
    layer_scan: str = "auto"

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
        _choices("sequence_parallel", self.sequence_parallel,
                 SEQUENCE_PARALLEL)
        _choices("pp_schedule", self.pp_schedule, PP_SCHEDULES)
        _choices("compute_dtype", self.compute_dtype,
                 ("bfloat16", "float32"))
        _choices("device", self.device, (None, "cuda", "cpu"))
        _choices("sync_mode", self.sync_mode, ("auto", "dense", "sharded"))
        _choices("sync_dtype", self.sync_dtype,
                 ("float32", "bfloat16", "int8"))
        _choices("sync_compression", self.sync_compression, ("none", "ef"))
        _choices("opt_placement", self.opt_placement,
                 ("auto", "replicated", "sharded"))
        _choices("param_residency", self.param_residency,
                 ("auto", "replicated", "resident"))
        _choices("shard_redundancy", self.shard_redundancy,
                 ("auto", "buddy", "off"))
        self.parse_remat_policy()
        self._check_sim()
        self._check_sync()
        if self.dtype != "float32":
            raise NotImplementedError(
                "param dtype other than float32 is not supported; use "
                "--compute_dtype for bfloat16 activations/matmuls")
        for name, (default, where) in NOT_PORTED.items():
            value = getattr(self, name)
            if value == default:
                continue
            raise ValueError(
                f"--{name} {value} is not ported to the PyTorch package "
                f"yet; it arrives with ROADMAP queue {where}")
        if self.backend == "nccl":
            # N workers share one card here as N processes of a gloo group
            # (mesh.py); NCCL refuses two ranks on one device
            raise ValueError(
                "--backend nccl: the PyTorch port runs its workers as a gloo "
                "group with host-staged syncs (--backend jax|gloo|mpi); "
                "NCCL with one rank per card is ROADMAP queue A.12")
        if self.num_workers < 0:
            raise ValueError(
                f"--num_workers must be >= 0 (0 = one per device), got "
                f"{self.num_workers}")
        if self.epochs_local < 1 or self.batch_size < 1:
            raise ValueError("epochs_local and batch_size must be >= 1")
        if self.grad_accum < 1:
            raise ValueError(
                f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.grad_accum > 1 and self.batch_size % self.grad_accum:
            raise ValueError(
                f"--batch_size {self.batch_size} must be divisible by "
                f"--grad_accum {self.grad_accum} (microbatch split)")
        if self.stream_chunk_steps < 0 or self.stream_prefetch < 0:
            raise ValueError(
                f"stream_chunk_steps ({self.stream_chunk_steps}) and "
                f"stream_prefetch ({self.stream_prefetch}) must be >= 0 "
                "(0 = the whole-round pack / synchronous staging)")
        self._check_checkpoint_and_serve()
        self._check_mesh()

    def _check_sim(self) -> None:
        """The JAX config's checks of the scenario-lab flags
        (``config.py:683-835``), with its messages: the scenario knobs'
        ranges, knobs without ``--sim_workers``, every real-engine
        feature a simulated run refuses, and the simulated wire."""
        if self.sim_workers < 0:
            raise ValueError(
                f"sim_workers must be >= 0 (0 = real-mesh driver), got "
                f"{self.sim_workers}")
        if not 0.0 < self.sim_sample_frac <= 1.0:
            raise ValueError(
                f"--sim_sample_frac must be in (0, 1] (each round samples "
                f"ceil(frac * N) >= 1 participants), got "
                f"{self.sim_sample_frac}")
        if not 0.0 <= self.sim_dropout < 1.0:
            raise ValueError(
                f"--sim_dropout must be in [0, 1) (1.0 would drop every "
                f"worker every round — no round could ever commit), got "
                f"{self.sim_dropout}")
        if not 0.0 <= self.sim_lr_jitter < 1.0:
            raise ValueError(
                f"--sim_lr_jitter must be in [0, 1): worker i trains at "
                f"lr * (1 + jitter * u_i) with u_i in [-1, 1), and jitter "
                f">= 1 could drive a learning rate to zero or negative; "
                f"got {self.sim_lr_jitter}")
        self.parse_sim_byzantine()   # validates the spec eagerly
        if self.sim_workers == 0:
            for flag, dflt, name in (
                    (self.sim_sample_frac, 1.0, "--sim_sample_frac"),
                    (self.sim_dropout, 0.0, "--sim_dropout"),
                    (self.sim_byzantine, "", "--sim_byzantine"),
                    (self.sim_lr_jitter, 0.0, "--sim_lr_jitter")):
                if flag != dflt:
                    raise ValueError(
                        f"{name} is a simulated-scenario knob; it needs "
                        "--sim_workers N (the real-mesh driver has no "
                        "per-round participation/adversary machinery)")
        else:
            self._check_sim_combinations()
        if self.sim_staleness < 0:
            raise ValueError(
                f"sim_staleness must be >= 0 (0 = the synchronous lab), "
                f"got {self.sim_staleness}")
        if self.sim_staleness > 0:
            if self.sim_workers == 0:
                raise ValueError(
                    "--sim_staleness is a simulated-scenario knob; it "
                    "needs --sim_workers N (the real engine's knob is "
                    "--sync_staleness)")
            if self.aggregation_by != "weights":
                raise ValueError(
                    "--sim_staleness requires --aggregation_by weights: "
                    "in gradients mode every worker applies its own "
                    "optimizer to the aggregate inside the round — there "
                    "is no between-round consensus blend whose delivery "
                    "could be deferred")

    def _check_sim_combinations(self) -> None:
        """What a simulated run refuses (``--sim_workers`` > 0)."""
        if self.chaos:
            raise ValueError(
                "--chaos cannot combine with --sim_workers: the chaos "
                "harness injects faults into the REAL driver's process "
                "semantics (measured walls, membership boundaries, mesh "
                "rebuilds) which the vmap'd simulator replaces with "
                "stacked math — use --sim_dropout / --sim_byzantine for "
                "simulated failure scenarios")
        if self.num_slices > 1:
            raise ValueError(
                "--num_slices > 1 cannot combine with --sim_workers: the "
                "hierarchical sync models a real multi-slice DCN fabric "
                "(nested mesh axes, per-level wires) — the simulator's "
                "fabric is stacked math on one chip; simulate the flat "
                "topologies instead")
        if self.shard_redundancy == "buddy":
            raise ValueError(
                "--shard_redundancy buddy cannot combine with "
                "--sim_workers: buddy redundancy protects REAL "
                "shard-resident state against a real worker's crash — "
                "every simulated worker's rows already live on the one "
                "chip (nothing is uniquely held; auto resolves to off)")
        if self.opt_placement == "sharded":
            raise ValueError(
                "--opt_placement sharded cannot combine with "
                "--sim_workers: the shard-resident apply is a stage of "
                "the real bucketed sync engine (reduce-scatter/all-gather "
                "over a real worker axis) — the simulated sync is the "
                "dense-semantics stacked twin (comms.aggregate_sim), "
                "which has no scatter phase to place an apply between")
        if self.param_residency == "resident":
            raise ValueError(
                "--param_residency resident cannot combine with "
                "--sim_workers: scatter-resident params ARE the real "
                "engine's 1/N scatter output kept between rounds — the "
                "simulated worker axis lives on one chip, where every "
                "row is already resident (nothing to gather)")
        if self.sync_mode == "sharded":
            raise ValueError(
                "--sync_mode sharded cannot combine with --sim_workers: "
                "the bucketed sharded engine runs real collectives over "
                "a real worker axis — the simulated sync is "
                "comms.aggregate_sim, the stacked twin of the dense "
                "reference path")
        if self.stream_chunk_steps > 0:
            raise ValueError(
                "--stream_chunk_steps cannot combine with --sim_workers "
                "in v1: the streamed round feeds per-chunk windows to "
                "one worker's engine — the simulator runs the whole "
                "round over one [N, S, B] stack on one device (ROADMAP "
                "A.11)")
        if self.checkpoint_dir or self.resume:
            raise ValueError(
                "--checkpoint_dir/--resume cannot combine with "
                "--sim_workers in v1: the sharded checkpoint engine's "
                "layouts and manifest worker-axis bookkeeping describe "
                "the real worker group — simulated runs are cheap to "
                "replay from seed (ROADMAP A.11 names sim "
                "checkpointing as the follow-on)")
        if self.num_workers:
            raise ValueError(
                f"--num_workers {self.num_workers} sizes the REAL "
                "worker group (one process per worker); with "
                "--sim_workers the worker axis is simulated in one "
                "process — drop --num_workers (the simulated count is "
                "--sim_workers)")
        inner = [a for a, s in self._mesh_shape_axes().items()
                 if a != "data" and (s > 1 or s <= 0)]
        if inner:
            raise ValueError(
                f"--sim_workers cannot combine with inner mesh axes "
                f"{inner} (--mesh_shape {self.mesh_shape!r}): "
                "TP/PP/SP/EP/FSDP shard the parameter leaves over REAL "
                "devices inside each worker — the simulator stacks whole "
                "per-worker states on one device")
        if self.sequence_parallel != "none":
            raise ValueError(
                "--sequence_parallel cannot combine with --sim_workers: "
                "the ring/zigzag attention kernels run over a real 'seq' "
                "mesh axis (see the inner-mesh-axes rejection)")
        if self.sync_staleness > 0:
            raise ValueError(
                "--sync_staleness cannot combine with --sim_workers: the "
                "real engine's staleness overlaps a REAL standalone sync "
                "under the next round's compute — the lab's sync is "
                "stacked math at the round's end (use --sim_staleness "
                "for the simulated delivery-delay twin)")

    def _check_sync(self) -> None:
        """The JAX config's checks of the sync engine's flags
        (``config.py:436-575``), the hierarchical sync's among them, and of
        ``--sync_staleness`` (:804-891), with its messages."""
        compressed_wire = self.sync_dtype in ("bfloat16", "int8")
        if compressed_wire and self.sync_mode == "dense":
            raise ValueError(
                f"--sync_dtype {self.sync_dtype} is the bucketed engines' "
                "compressed wire format; it cannot combine with "
                "--sync_mode dense")
        if self.opt_placement == "sharded" and self.sync_mode == "dense":
            raise ValueError(
                "--opt_placement sharded runs the optimizer apply between "
                "psum_scatter and all_gather — a bucketed-sync-engine "
                "stage; it cannot combine with --sync_mode dense")
        if self.opt_placement == "replicated" and compressed_wire:
            raise ValueError(
                f"--opt_placement replicated cannot combine with "
                f"--sync_dtype {self.sync_dtype}: a compressed wire "
                "quantizes the gathered mean, which forces the "
                "scale-then-encode apply onto the 1/N shard (the sharded "
                "placement) — a post-gather replicated apply would gather "
                "the uncompressed fp32 sum instead")
        if (self.param_residency == "resident"
                and self.topology != "allreduce" and self.num_slices == 1):
            # under slices the topology names the OUTER level, and each
            # slice's consensus can stay resident (JAX config.py:474-480)
            raise ValueError(
                f"--param_residency resident cannot combine with "
                f"--topology {self.topology}: gossip blends are "
                "worker-local by construction — every worker's post-round "
                "params are a different function of its own value, so "
                "there is no cross-replica-redundant consensus tree to "
                "keep scatter-resident (the same argument that resolves "
                "--opt_placement to 'local' there)")
        if self.param_residency == "resident" and self.sync_mode == "dense":
            raise ValueError(
                "--param_residency resident keeps the psum_scatter "
                "output as the between-round parameter state — a bucketed-"
                "sync-engine stage; it cannot combine with "
                "--sync_mode dense (no scatter whose output could stay "
                "resident)")
        if (self.param_residency == "resident"
                and self.opt_placement == "replicated"):
            raise ValueError(
                "--param_residency resident stores the SHARD-side apply "
                "output (the scaled 1/N scatter shard) as the resident "
                "state; --opt_placement replicated applies post-gather "
                "full-size and leaves no per-shard apply output to keep "
                "resident")
        if self.shard_redundancy == "buddy" and self.num_slices == 1 and (
                self.topology != "allreduce" or self.sync_mode == "dense"):
            raise ValueError(
                "--shard_redundancy buddy protects SHARD-RESIDENT state "
                "(scatter-resident params / sharded round-optimizer "
                "rows), which only the bucketed sharded allreduce engine "
                f"produces; --topology {self.topology} / --sync_mode "
                f"{self.sync_mode} keeps every state worker-local or "
                "replicated — nothing is uniquely held, so there is "
                "nothing for a buddy to back up (auto resolves this to "
                "off)")
        self._check_chaos()
        _choices("sync_dtype_outer", self.sync_dtype_outer,
                 ("", "float32", "bfloat16", "int8"))
        if self.num_slices < 1:
            raise ValueError(
                f"num_slices must be >= 1, got {self.num_slices}")
        if self.sync_dtype_outer and self.num_slices == 1:
            raise ValueError(
                "--sync_dtype_outer sets the OUTER (DCN) gossip wire of "
                "the hierarchical sync; it requires --num_slices >= 2 "
                "(a flat run has no outer level)")
        outer_compressed = (self.sync_dtype_outer or self.sync_dtype) in (
            "bfloat16", "int8")
        if self.num_slices > 1:
            self._check_slices()
        if self.sync_compression == "ef" and not (compressed_wire
                                                  or outer_compressed):
            raise ValueError(
                "--sync_compression ef compensates compressed-wire "
                "rounding; it requires a compressed --sync_dtype (or, "
                "hierarchically, --sync_dtype_outer) of bfloat16 or int8")
        if self.sync_bucket_mb <= 0:
            raise ValueError(
                f"sync_bucket_mb must be positive, got {self.sync_bucket_mb}")
        if self.sync_staleness < 0:
            raise ValueError(
                f"sync_staleness must be >= 0 (0 = fully synchronous), "
                f"got {self.sync_staleness}")
        if self.sync_staleness == 0:
            return
        if self.aggregation_by != "weights":
            raise ValueError(
                "--sync_staleness requires --aggregation_by weights "
                "(FedAvg): the deferred delivery folds a consensus "
                "DELTA into later params, which needs a consensus "
                "blend to exist — in gradients mode the aggregate "
                "feeds each worker's optimizer step inside the round "
                "and there is nothing to deliver late")
        if self.chaos:
            raise ValueError(
                "--chaos cannot combine with --sync_staleness in v1: "
                "crash rollback and elastic membership both rebuild "
                "state at a round boundary assuming NO consensus is "
                "in flight — a pending stale delta would be computed "
                "against a pre-crash (or pre-reshard) worker axis and "
                "silently corrupt the restored params (per-fault "
                "drain is the ROADMAP follow-on)")
        if self.num_slices > 1:
            raise ValueError(
                "--num_slices > 1 cannot combine with "
                "--sync_staleness in v1: the hierarchical sync "
                "threads a DCN outer-EF residual through consecutive "
                "sync programs — under staleness sync R+1 dispatches "
                "before sync R's residual exists, so the two-level "
                "chain cannot pipeline without restructuring the "
                "outer hop (the ROADMAP follow-on)")
        if self.param_residency == "resident":
            raise ValueError(
                "--param_residency resident cannot combine with "
                "--sync_staleness: resident keeps the sync's scatter "
                "output as the between-round state, which makes round "
                "R+1's entry gather DEPEND on sync R finishing — the "
                "exact serialization staleness exists to remove "
                "(auto resolves to replicated)")
        if self.shard_redundancy == "buddy":
            raise ValueError(
                "--shard_redundancy buddy cannot combine with "
                "--sync_staleness: the buddy hop rides the sync "
                "program to snapshot shard-resident state, and "
                "staleness resolves param residency to replicated — "
                "nothing is uniquely held, so there is nothing to "
                "back up (its consumer, crash recovery, is rejected "
                "under staleness anyway)")
        if self.stream_chunk_steps > 0:
            raise ValueError(
                "--stream_chunk_steps cannot combine with "
                "--sync_staleness in v1: the streamed round already "
                "overlaps its standalone sync under the next round's "
                "first chunks via the producer thread — composing a "
                "second staleness window over the chunked dispatch "
                "is the ROADMAP follow-on")
        if self.checkpoint_dir or self.resume:
            raise ValueError(
                "--checkpoint_dir/--resume cannot combine with "
                "--sync_staleness in v1: a snapshot taken between "
                "fences would capture params WITHOUT the K in-flight "
                "consensus deltas, so the restored trajectory would "
                "silently diverge from the run that wrote it "
                "(drain-before-snapshot is the ROADMAP follow-on)")

    def _check_slices(self) -> None:
        """What ``--num_slices > 1`` refuses (JAX ``config.py:528-565``),
        with its messages: an allreduce outer level, a dense inner level,
        chaos, explicit buddy redundancy and the replicated apply."""
        if self.topology == "allreduce":
            raise ValueError(
                "--num_slices > 1 syncs the outer slice level with "
                "the ppermute GOSSIP engine (--topology ring | "
                "double_ring); an allreduce outer level is just the "
                "flat sharded allreduce over all S*W workers — run "
                "it as --num_slices 1")
        if self.sync_mode == "dense":
            raise ValueError(
                "--num_slices > 1 runs the bucketed sharded "
                "psum_scatter/all_gather engine on the inner (ICI) "
                "level — the outer gossip hop rides its 1/W scatter "
                "shard; a dense inner level has no shard for the "
                "hop to ride (--sync_mode dense rejected)")
        if self.chaos:
            raise ValueError(
                "--chaos cannot combine with --num_slices > 1 in "
                "v1: elastic membership and the crash/NaN fault "
                "machinery operate on the flat worker axis (mesh "
                "resize, ring buddy map, quorum floor are all "
                "single-level) — per-slice membership is the "
                "ROADMAP follow-on")
        if self.shard_redundancy == "buddy":
            raise ValueError(
                "--shard_redundancy buddy cannot combine with "
                "--num_slices > 1 in v1: the buddy map is the flat "
                "worker-axis ring, and crash recovery (its consumer) "
                "is rejected under slices anyway (auto resolves to "
                "off)")
        if self.opt_placement == "replicated":
            raise ValueError(
                "--opt_placement replicated cannot combine with "
                "--num_slices > 1: the outer gossip hop rides the "
                "1/W scatter shard, so the apply (inner mean scale, "
                "gossip blend, wire encode) necessarily runs "
                "shard-side — there is no post-gather full-size "
                "apply stage in the hierarchical program")

    def _check_chaos(self) -> None:
        """The JAX config's eager checks of the chaos flags
        (``config.py:660-677``): a malformed ``--chaos`` spec or
        ``--chaos_kinds`` selection fails here, not at round boundary 3."""
        if self.chaos and self.chaos.strip().lower() != "random":
            from .chaos import parse_chaos_spec
            parse_chaos_spec(self.chaos)
        self.parse_chaos_kinds()
        if self.chaos_events < 0 or self.chaos_retries < 0:
            raise ValueError(
                f"chaos_events ({self.chaos_events}) and chaos_retries "
                f"({self.chaos_retries}) must be >= 0")
        if self.chaos_grace < 0.0 or self.chaos_backoff < 0.0:
            raise ValueError(
                f"chaos_grace ({self.chaos_grace}) and chaos_backoff "
                f"({self.chaos_backoff}) must be >= 0")
        if self.elastic_min_workers < 1:
            raise ValueError(
                f"elastic_min_workers must be >= 1, got "
                f"{self.elastic_min_workers}")

    def parse_chaos_kinds(self) -> tuple[str, ...]:
        """``--chaos_kinds`` as a validated kind tuple (JAX
        ``parse_chaos_kinds``): the kinds a ``--chaos random`` schedule
        may draw, order kept, duplicates collapsed."""
        from .chaos import KINDS
        out: list[str] = []
        for part in self.chaos_kinds.split(","):
            part = part.strip()
            if not part:
                continue
            if part not in KINDS:
                raise ValueError(
                    f"unknown chaos kind {part!r} in --chaos_kinds "
                    f"{self.chaos_kinds!r}: expected a subset of {KINDS}")
            if part not in out:
                out.append(part)
        if not out:
            raise ValueError(
                f"--chaos_kinds {self.chaos_kinds!r} selects no event "
                "kinds — a random schedule needs at least one")
        return tuple(out)

    def resolve_sync_mode(self) -> str:
        """``--sync_mode`` resolved per topology into the engine run:
        ``dense`` | ``sharded`` | ``gossip`` | ``hier`` (JAX
        ``resolve_sync_mode`` off a TPU).  ``sharded`` is the fast engine
        of the topology (the reduce-scatter for allreduce, the bucketed
        gossip for ring and double_ring); ``auto`` picks it only when a
        compressed wire or ``--opt_placement sharded`` asks for it, and the
        dense path otherwise (bitwise the same in fp32 at two workers).
        ``--num_slices > 1`` is always ``hier``: the two fast engines
        composed, one per level."""
        if self.num_slices > 1:
            return "hier"
        fast = "sharded" if self.topology == "allreduce" else "gossip"
        if self.sync_mode == "sharded":
            return fast
        if self.sync_mode == "dense":
            return "dense"
        if self.sync_dtype in ("bfloat16", "int8"):
            return fast
        if self.opt_placement == "sharded":
            return fast
        if self.param_residency == "resident":
            # scatter-resident params are a layout of the bucketed engine
            return fast
        return "dense"

    def resolve_sync_levels(self) -> dict:
        """Per-level engines (JAX ``resolve_sync_levels``): the flat run's
        one engine as the inner level and no outer level; under slices the
        sharded engine inside each slice and the gossip across them."""
        if self.num_slices > 1:
            return {"inner": "sharded", "outer": "gossip"}
        return {"inner": self.resolve_sync_mode(), "outer": None}

    def resolve_sync_wire_dtypes(self) -> tuple[str, str]:
        """``(inner, outer)`` wire names (JAX ``resolve_sync_wire_dtypes``):
        ``--sync_dtype`` for the inner collectives, ``--sync_dtype_outer``
        for the outer hops, which inherits the inner one when unset."""
        return (self.sync_dtype, self.sync_dtype_outer or self.sync_dtype)

    def resolve_opt_placement(self) -> str:
        """``--opt_placement`` resolved: ``replicated`` | ``sharded`` |
        ``local`` (JAX ``resolve_opt_placement``): gossip topologies are
        ``local`` (worker-local blends, nothing to shard); for allreduce
        ``auto`` is ``sharded`` exactly when the sharded engine runs, and
        the dense path reports ``replicated``."""
        mode = self.resolve_sync_mode()
        if mode == "hier":
            # the outer hop rides the 1/W scatter shard: the apply runs
            # shard-side (the replicated placement is refused)
            return "sharded"
        if mode == "gossip" or self.topology != "allreduce":
            return "local"
        if self.opt_placement in ("replicated", "sharded"):
            return self.opt_placement
        return "sharded" if mode == "sharded" else "replicated"

    def resolve_param_residency(self, n_workers: int | None = None) -> str:
        """``--param_residency`` resolved: ``resident`` | ``replicated``
        (JAX ``resolve_param_residency``): resident needs the sharded
        engine, its sharded apply, weights aggregation with the equal
        blend (the between-round params are then one consensus, which the
        scatter leaves 1/N per worker) and no staleness; ``auto`` picks it
        exactly then, and an explicit ``resident`` resolves to replicated
        otherwise.  ``n_workers`` applies the JAX engine's demotion of a
        one-worker axis (nothing to shard, ``train.py:612-620``); under
        slices it is the workers of one slice, whose consensus each keeps
        1/W of (JAX ``config.py:1027-1032``)."""
        if self.sync_staleness > 0:
            return "replicated"
        if self.inner_axes():
            # the bucket plan must stay per-worker: inner axes shard the
            # parameter leaves themselves (JAX train.py:604-613)
            return "replicated"
        if self.resolve_sync_mode() not in ("sharded", "hier"):
            return "replicated"
        if self.resolve_opt_placement() != "sharded":
            return "replicated"
        if self.aggregation_by != "weights":
            return "replicated"
        if self.aggregation_type != "equal":
            return "replicated"
        if self.param_residency == "replicated":
            return "replicated"
        if n_workers is not None and n_workers < 2:
            return "replicated"
        return "resident"

    def round_opt_on(self) -> bool:
        """Whether the round optimizer's moments are armed (JAX
        ``train.py:576-580``): gradients mode under the sharded engine."""
        return (self.aggregation_by == "gradients"
                and self.resolve_sync_mode() == "sharded"
                and self.resolve_opt_placement() in ("replicated",
                                                     "sharded")
                and not self.inner_axes())

    def resolve_shard_redundancy(self, n_workers: int) -> str:
        """``--shard_redundancy`` resolved for ``n_workers``: ``buddy`` |
        ``off`` (the JAX engine's rule, ``train.py:631-652``): the hop
        protects state no other worker holds, the scatter-resident params
        rows or the sharded round optimizer's rows, so ``auto`` (and an
        explicit ``buddy``) is on exactly when either resolves, on two or
        more workers; ``off`` turns it off."""
        if (self.shard_redundancy == "off" or n_workers < 2
                or self.num_slices > 1):
            # the buddy map is the flat worker ring (refused under slices)
            return "off"
        resident = self.resolve_param_residency(n_workers) == "resident"
        sharded_opt = (self.round_opt_on()
                       and self.resolve_opt_placement() == "sharded")
        return "buddy" if resident or sharded_opt else "off"

    def sync_wire_dtype(self):
        """The compressed wire's torch dtype (None: the fp32 wire)."""
        from .comms import WIRE_DTYPES
        wire = WIRE_DTYPES[self.sync_dtype]
        return None if wire == WIRE_DTYPES["float32"] else wire

    def sync_wire_dtype_outer(self):
        """The outer hops' compressed wire's torch dtype (None: fp32)."""
        from .comms import WIRE_DTYPES
        wire = WIRE_DTYPES[self.resolve_sync_wire_dtypes()[1]]
        return None if wire == WIRE_DTYPES["float32"] else wire

    SIM_BYZANTINE_KINDS = ("signflip", "noise")

    def parse_sim_byzantine(self) -> tuple[str, int, float] | None:
        """``--sim_byzantine`` as ``(kind, count, scale)`` or None (JAX
        ``config.py:1112-1160``).

        Spec: ``kind:count[:scale]`` with kind in
        ``SIM_BYZANTINE_KINDS``, count >= 1 adversarial workers (the
        LAST count worker ids), scale the noise stddev (noise kind only;
        default 1.0)."""
        spec = self.sim_byzantine.strip()
        if not spec:
            return None
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"--sim_byzantine must be 'kind:count[:scale]', got "
                f"{self.sim_byzantine!r}")
        kind = parts[0].strip()
        if kind not in self.SIM_BYZANTINE_KINDS:
            raise ValueError(
                f"unknown --sim_byzantine kind {kind!r}: expected one of "
                f"{self.SIM_BYZANTINE_KINDS}")
        try:
            count = int(parts[1])
        except ValueError:
            raise ValueError(
                f"--sim_byzantine count must be an integer, got "
                f"{parts[1]!r} in {self.sim_byzantine!r}") from None
        if count < 1:
            raise ValueError(
                f"--sim_byzantine count must be >= 1, got {count}")
        if self.sim_workers and count >= self.sim_workers:
            raise ValueError(
                f"--sim_byzantine count {count} must leave at least one "
                f"honest worker (--sim_workers {self.sim_workers})")
        scale = 1.0
        if len(parts) == 3:
            if kind != "noise":
                raise ValueError(
                    f"--sim_byzantine scale applies to the 'noise' kind "
                    f"(the injected stddev); {kind!r} takes none — got "
                    f"{self.sim_byzantine!r}")
            try:
                scale = float(parts[2])
            except ValueError:
                raise ValueError(
                    f"--sim_byzantine scale must be a float, got "
                    f"{parts[2]!r} in {self.sim_byzantine!r}") from None
            if scale <= 0:
                raise ValueError(
                    f"--sim_byzantine noise scale must be > 0, got "
                    f"{scale}")
        return (kind, count, scale)

    def mesh_axes(self) -> dict[str, int]:
        """``--mesh_shape`` as an ordered {axis: size} dict (JAX
        ``config.mesh_axes``): ``data`` is prepended when absent; a size of
        -1 (data only) is resolved by ``mesh.grid_axes``.  ``--num_slices
        > 1`` puts the ``slice`` axis first; inner model axes are refused
        under it (the hierarchical bucket plan is per worker)."""
        axes = self._mesh_shape_axes()
        if "slice" in axes:
            raise ValueError(
                "the 'slice' mesh axis is driven by --num_slices, not "
                f"--mesh_shape (got --mesh_shape {self.mesh_shape!r})")
        if "data" not in axes:
            axes = {"data": -1, **axes}
        if self.num_slices > 1:
            inner = [a for a, s in axes.items()
                     if a != "data" and (s > 1 or s <= 0)]
            if inner:
                raise ValueError(
                    f"--num_slices {self.num_slices} cannot combine with "
                    f"inner mesh axes {inner} in v1: the hierarchical "
                    "sync's bucket plan is per-worker, and TP/PP/SP/EP/"
                    "FSDP shard the parameter leaves themselves "
                    "(docs/ARCHITECTURE.md documents the demotion)")
            axes = {"slice": self.num_slices, **axes}
        return axes

    def inner_axes(self) -> dict[str, int]:
        """The mesh axes inside each worker that shard it (size > 1)."""
        return {a: s for a, s in self.mesh_axes().items()
                if a not in ("slice", "data") and s > 1}

    def _check_mesh(self) -> None:
        """The ``--mesh_shape`` checks: the axes the port runs (data, fsdp,
        seq, pipe, expert, model), and the JAX driver's checks of the
        expert, model, fsdp and seq axes (``driver.py:578-732``,
        ``models/moe.py:71-79``)."""
        axes = {a: s for a, s in self.mesh_axes().items() if a != "slice"}
        for name, size in axes.items():
            if name not in MESH_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r} in --mesh_shape "
                    f"{self.mesh_shape!r}: expected among {MESH_AXES}")
            elif size == 0 or size < -1 or (size == -1 and name != "data"):
                raise ValueError(
                    f"mesh axis {name!r} needs a size >= 1 (data may be -1: "
                    f"one worker per --num_workers), got {size}")
        data = axes["data"]
        if data > 0 and self.num_workers not in (0, data):
            raise ValueError(
                f"--mesh_shape data={data} and --num_workers "
                f"{self.num_workers} disagree: give one worker count (data=-1 "
                "takes --num_workers')")
        self._check_pipe(axes)
        self._check_seq(axes)
        self._check_experts(axes)
        inner = self.inner_axes()
        if not inner:
            return
        tp, fsdp = inner.get("model", 1), inner.get("fsdp", 1)
        if tp > 1:
            from .models import is_attention_model
            if not is_attention_model(self.model):
                raise ValueError(
                    "a 'model' mesh axis (tensor parallelism) applies to "
                    "attention models (bert_*/gpt_*/vit_*/llama_*); got "
                    f"--model {self.model}")
        if fsdp > 1 and self.batch_size % fsdp:
            raise ValueError(
                f"--batch_size {self.batch_size} must be divisible by the "
                f"'fsdp' axis size {fsdp} (the batch splits over it)")
        pp = inner.get("pipe", 1)
        mb = self.pp_microbatches or pp
        if pp > 1 and fsdp > 1 and mb > 1 and (self.batch_size // fsdp) % mb:
            raise ValueError(
                f"per-fsdp-slice batch {self.batch_size // fsdp} must "
                f"be divisible by {mb} pipeline microbatches")
        per_dev = self.batch_size // fsdp
        if self.grad_accum > 1 and per_dev % self.grad_accum:
            raise ValueError(
                f"per-device batch {per_dev} (batch_size {self.batch_size}"
                f"{f' / fsdp {fsdp}' if fsdp > 1 else ''}) must be "
                f"divisible by --grad_accum {self.grad_accum}")
        if (self.grad_accum > 1 and pp > 1
                and (per_dev // self.grad_accum) % mb):
            raise ValueError(
                f"per-accumulation-slice batch {per_dev // self.grad_accum} "
                f"must be divisible by {mb} pipeline microbatches")

    def _check_experts(self, axes: dict) -> None:
        """The JAX driver's checks of ``--num_experts`` and the expert
        axis (``driver.py:578-615``), then the MoE layer's own
        (``models.moe.check_shards``, JAX ``models/moe.py:71-79``), with
        their messages and in their order."""
        ep = axes.get("expert", 1)
        if self.num_experts > 0:
            from .models import is_attention_model
            if not is_attention_model(self.model):
                raise ValueError(
                    "--num_experts applies to attention models (bert_*/"
                    "gpt_*/vit_*/llama_*); got --model "
                    f"{self.model}")
        elif ep > 1:
            raise ValueError(
                "mesh has an 'expert' axis but --num_experts is 0")
        if self.num_experts <= 0:
            return
        from .models import ffn_dim_of, moe
        moe.check_shards(self.num_experts, ffn_dim_of(self.model), ep,
                         axes.get("model", 1))

    def _check_pipe(self, axes: dict) -> None:
        """The JAX driver's checks of the pipe axis and the ``--pp_*``
        flags (``driver.py:504-548``, ``models/bert.py:231-233``), with its
        messages and in its order; the per-fsdp-slice and
        per-accumulation-slice checks follow in ``_check_mesh``, and
        ``--pp_remat`` without a pipe axis, which JAX's config takes, is
        refused where JAX refuses it, when a run starts
        (``driver.train_global``)."""
        pp = axes.get("pipe", 1)
        from .models import is_attention_model
        if self.pp_schedule == "1f1b":
            if pp <= 1:
                raise ValueError(
                    "--pp_schedule 1f1b applies under pipeline parallelism "
                    "(a 'pipe' mesh axis of size >= 2)")
            if not self.model.startswith(("bert", "gpt", "llama", "vit")):
                raise NotImplementedError(
                    "--pp_schedule 1f1b supports bert_*/gpt_*/llama_*/vit_* "
                    "(the per-microbatch head+loss runs inside the "
                    "schedule)")
        if pp <= 1:
            return
        if not is_attention_model(self.model):
            raise ValueError(
                "a 'pipe' mesh axis (pipeline parallelism) applies to "
                "attention models (bert_*/gpt_*/vit_*/llama_*); got "
                f"--model {self.model}")
        mb_count = self.pp_microbatches or pp
        if self.batch_size % mb_count:
            raise ValueError(
                f"--batch_size {self.batch_size} must be divisible by the "
                f"{mb_count} pipeline microbatches (--pp_microbatches, 0 => "
                f"the 'pipe' axis size {pp})")
        from .models import num_layers_of
        layers = num_layers_of(self.model)
        if layers % pp:
            raise ValueError(f"num_layers {layers} not divisible by pp_size "
                             f"{pp}")

    def resolve_remat_policy(self) -> str:
        """``--remat_policy``, with ``--pp_remat`` its ``everything`` alias
        (JAX ``driver.py:488-492``)."""
        if self.pp_remat and self.remat_policy == "none":
            return "everything"
        return self.remat_policy

    def _check_seq(self, axes: dict) -> None:
        """The JAX driver's checks of ``--sequence_parallel``
        (``driver.py:710-732``), with its messages.  A ``seq`` axis without
        it runs as JAX runs it (``train.py:455-459``): seq is then no part
        axis, and its ranks all take the same step on the whole batch."""
        seq = axes.get("seq", 1)
        if self.sequence_parallel == "none":
            return
        if self.attention_impl != "dense":
            raise ValueError(
                f"--attention_impl {self.attention_impl} cannot combine with "
                f"--sequence_parallel {self.sequence_parallel}: the round "
                "program's attention is the sequence-parallel kernel")
        if seq < 2:
            raise ValueError(
                f"--sequence_parallel {self.sequence_parallel} needs a "
                "'seq' mesh axis of size >= 2 (e.g. --mesh_shape "
                f"data=2,seq=4); got mesh {axes}")
        from .models import is_token_model
        if not is_token_model(self.model):
            raise ValueError(
                "--sequence_parallel applies to token-sequence models "
                f"(bert_*/gpt_*/llama_*); got --model {self.model}")
        if (self.sequence_parallel == "ring_zigzag"
                and not self.model.startswith(("gpt", "llama"))):
            raise ValueError(
                "--sequence_parallel ring_zigzag balances CAUSAL masking "
                "work and applies to causal models (gpt_*/llama_*); "
                f"got --model {self.model} — use 'ring' for bidirectional "
                "attention")

    def _mesh_shape_axes(self) -> dict[str, int]:
        """Raw ``--mesh_shape`` parse: axis name -> size (-1 when no size
        is given)."""
        axes: dict[str, int] = {}
        for part in self.mesh_shape.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size) if size else -1
        return axes

    def _check_checkpoint_and_serve(self) -> None:
        """The JAX config's checks of the checkpoint and serve flags
        (``config.py:572-585, 588-660``), speculative decoding's
        included."""
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError(
                "--checkpoint_every needs --checkpoint_dir (nowhere to "
                "write the shards)")
        if self.resume and not self.checkpoint_dir:
            raise ValueError(
                "--resume needs --checkpoint_dir (nowhere to restore from)")
        if self.ckpt_keep < 1:
            raise ValueError(
                f"ckpt_keep must be >= 1, got {self.ckpt_keep}")
        if self.serve_max_batch < 1 or self.serve_page_size < 1:
            raise ValueError(
                f"serve_max_batch ({self.serve_max_batch}) and "
                f"serve_page_size ({self.serve_page_size}) must be >= 1")
        if self.serve_max_pages < 2:
            raise ValueError(
                f"serve_max_pages must be >= 2 (page 0 is the reserved "
                f"trash page), got {self.serve_max_pages}")
        if self.serve_max_new_tokens < 1 or self.serve_requests < 1:
            raise ValueError(
                "serve_max_new_tokens and serve_requests must be >= 1, "
                f"got {self.serve_max_new_tokens}/{self.serve_requests}")
        if self.serve_temperature < 0.0:
            raise ValueError(
                f"serve_temperature must be >= 0 (0 = greedy), got "
                f"{self.serve_temperature}")
        if self.serve_request_timeout < 0.0:
            raise ValueError(
                f"serve_request_timeout must be >= 0 (0 = off), got "
                f"{self.serve_request_timeout}")
        if self.serve_prefill_chunk < 0 or (
                self.serve_prefill_chunk
                and self.serve_prefill_chunk % self.serve_page_size):
            raise ValueError(
                f"--serve_prefill_chunk must be a positive multiple of "
                f"--serve_page_size ({self.serve_page_size}) — chunk "
                f"boundaries must land on page boundaries so every chunk "
                f"writes whole pages (and the prefix cache can key them) "
                f"— got {self.serve_prefill_chunk}; 0 disables chunking")
        # speculative decoding: every limit refused here with its reason
        if bool(self.serve_draft_ckpt) != bool(self.serve_spec_tokens):
            raise ValueError(
                "--serve_draft_ckpt and --serve_spec_tokens arm "
                "speculative decoding TOGETHER (the draft proposes, k "
                "sizes the verify program) — one without the other is "
                f"inert; got draft_ckpt={self.serve_draft_ckpt!r}, "
                f"spec_tokens={self.serve_spec_tokens}")
        if self.serve_spec_tokens < 0:
            raise ValueError(
                f"--serve_spec_tokens must be >= 1 (0 disables), got "
                f"{self.serve_spec_tokens}")
        if self.serve_draft_ckpt and self.serve_temperature > 0.0:
            raise ValueError(
                f"--serve_temperature {self.serve_temperature} with "
                "--serve_draft_ckpt: speculative acceptance is greedy "
                "argmax equality against the verify logits — temperature "
                "sampling needs the stochastic rejection-sampling rule "
                "(accept with prob min(1, p_target/p_draft)) that is not "
                "implemented; serve greedy or drop the draft")
        buckets = self.parse_prompt_buckets()   # validates the csv eagerly
        if self.serve_prefix_cache:
            # one max-length sequence (largest bucket + max_new, + the k
            # positions the verify program writes past it) pinning the
            # whole pool leaves no page to keep cached
            longest = (buckets[-1] + self.serve_max_new_tokens
                       + self.serve_spec_tokens)
            seq_pages = -(-longest // self.serve_page_size)
            if seq_pages >= self.serve_max_pages - 1:
                raise ValueError(
                    f"--serve_prefix_cache needs page-pool headroom "
                    f"beyond one max-length sequence: a {longest}-token "
                    f"sequence (largest bucket {buckets[-1]} + "
                    f"serve_max_new_tokens {self.serve_max_new_tokens}"
                    + (f" + serve_spec_tokens {self.serve_spec_tokens}"
                       if self.serve_spec_tokens else "") + ") "
                    f"pins {seq_pages} of the {self.serve_max_pages - 1} "
                    f"usable pages (page 0 is the trash page), so no "
                    f"page could ever stay cached — raise "
                    f"--serve_max_pages past {seq_pages + 1}")

    def parse_prompt_buckets(self) -> tuple[int, ...]:
        """``--serve_prompt_buckets`` as ascending unique lengths."""
        out = []
        for part in self.serve_prompt_buckets.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                out.append(int(part))
            except ValueError:
                raise ValueError(
                    f"serve_prompt_buckets must be comma-separated "
                    f"integers, got {self.serve_prompt_buckets!r}") from None
        if not out or min(out) < 1:
            raise ValueError(
                f"serve_prompt_buckets needs at least one positive "
                f"length, got {self.serve_prompt_buckets!r}")
        return tuple(sorted(set(out)))

    def parse_remat_policy(self) -> tuple[str, tuple[str, ...]]:
        """``--remat_policy`` as ``(kind, names)``, validated as the JAX
        config does (``config.py:1050-1080``): the spelling, and each name
        of a named policy against the model family's vocabulary
        (``models.remat_name_vocab``), so a typo fails here instead of
        saving nothing."""
        from .models import remat_name_vocab
        from .models.remat import split_remat_policy
        kind, names = split_remat_policy(self.remat_policy)
        if not names:
            return kind, names
        vocab = remat_name_vocab(self.model, self.num_experts)
        if not vocab:
            raise ValueError(
                f"--remat_policy {kind}:... selects checkpoint_name-"
                f"annotated activations of the transformer blocks; --model "
                f"{self.model} has none (bert_*/gpt_*/llama_*/vit_* do)")
        unknown = [n for n in names if n not in vocab]
        if unknown:
            moe = (f" (num_experts={self.num_experts})"
                   if self.num_experts else "")
            raise ValueError(
                f"--remat_policy {kind}: unknown activation name(s) "
                f"{unknown} — the {self.model} family{moe} emits exactly "
                f"{sorted(vocab)} (a name outside the vocabulary would "
                "silently degrade the policy to save-nothing)")
        return kind, names


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
                 "limit_eval_samples", "num_kv_heads", "model_width",
                 "grad_accum", "num_experts"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("lr", "time_limit", "prev_fraction", "next_fraction",
                 "local_weight", "fixed_ratio", "expert_capacity_factor",
                 "moe_aux_weight"):
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
    p.add_argument("--remat_policy", default=d.remat_policy,
                   help="per-block rematerialization: none | dots_saveable "
                        "| everything | save_names:<a,b> | "
                        "offload_names:<a,b> (names: attn_out, mlp_out, "
                        "block_out, moe_dispatch)")
    for name in ("model", "dataset", "dtype", "compute_dtype", "data_dir",
                 "out_dir", "log_level"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    p.add_argument("--ckpt_async", choices=["on", "off"],
                   default="on" if d.ckpt_async else "off",
                   help="a writer thread serializes and commits the shards "
                        "while training goes on (off: the same path, "
                        "inline)")
    p.add_argument("--ckpt_keep", type=int, default=d.ckpt_keep)
    p.add_argument("--resume", action="store_true")
    for name in ("serve_max_batch", "serve_page_size", "serve_max_pages",
                 "serve_eos_id", "serve_max_new_tokens", "serve_requests",
                 "serve_prefill_chunk"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("serve_temperature", "serve_request_timeout"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    for name in ("serve_prompt_buckets", "serve_prompt"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    p.add_argument("--serve_prefix_cache", action="store_true")
    p.add_argument("--serve_draft_ckpt", type=str, default=d.serve_draft_ckpt,
                   help="speculative decoding: a smaller same-vocab dense "
                        "checkpoint proposes --serve_spec_tokens tokens a "
                        "tick; greedy output equals the plain run's")
    p.add_argument("--serve_spec_tokens", type=int,
                   default=d.serve_spec_tokens,
                   help="draft tokens per verify (k >= 1; 0 = off; needs "
                        "--serve_draft_ckpt)")
    p.add_argument("--stream_chunk_steps", type=int,
                   default=d.stream_chunk_steps,
                   help="stream each round in windows of this many steps "
                        "(0 = pack the whole round)")
    p.add_argument("--stream_prefetch", type=int, default=d.stream_prefetch,
                   help="windows staged on the device ahead of compute by "
                        "a producer thread (2 = double buffering, 0 = "
                        "synchronous)")
    p.add_argument("--sim_workers", type=int, default=d.sim_workers,
                   help="simulate this many local-SGD workers in ONE "
                        "process on one device (per-worker state, data "
                        "and augmentation streams stacked on a leading "
                        "axis; each step one torch.func.vmap over the "
                        "workers; the sync is stacked math); 0 = one "
                        "process per worker")
    p.add_argument("--sim_sample_frac", type=float,
                   default=d.sim_sample_frac,
                   help="scenario: per-round client sampling — each "
                        "round ceil(frac*N) seeded-drawn workers train "
                        "and contribute; the rest skip the round but "
                        "adopt the consensus (FedAvg sampling)")
    p.add_argument("--sim_dropout", type=float, default=d.sim_dropout,
                   help="scenario: per-round worker dropout probability "
                        "— a dropped worker neither trains, contributes, "
                        "nor adopts (the whole round is a no-op for it)")
    p.add_argument("--sim_byzantine", type=str, default=d.sim_byzantine,
                   help="scenario: adversarial workers, "
                        "'kind:count[:scale]' — the last count ids "
                        "corrupt their sync contribution every round "
                        "(signflip = the round's update sign-flipped; "
                        "noise = payload + scale*N(0,1), seeded)")
    p.add_argument("--sim_lr_jitter", type=float, default=d.sim_lr_jitter,
                   help="scenario: per-worker LR spread — worker i "
                        "trains at lr*(1 + jitter*u_i), u_i a seeded "
                        "uniform[-1,1) draw fixed for the run")
    p.add_argument("--sim_staleness", type=int, default=d.sim_staleness,
                   help="scenario: deliver each round's consensus delta "
                        "K rounds late (0 = synchronous)")
    p.add_argument("--sync_mode", default=d.sync_mode,
                   choices=["auto", "dense", "sharded"],
                   help="round-sync engine, resolved per topology: sharded "
                        "= the bucketed fast engine (reduce-scatter for "
                        "allreduce, bucketed gossip for ring/double_ring), "
                        "host-staged over the gloo group; auto = dense "
                        "unless a compressed wire or --opt_placement "
                        "sharded asks for the fast engine")
    p.add_argument("--sync_dtype", default=d.sync_dtype,
                   choices=["float32", "bfloat16", "int8"],
                   help="wire dtype of the fast engines (bfloat16 halves "
                        "the bytes, int8 with a per-bucket scale quarters "
                        "them); under --sim_workers the simulated wire")
    p.add_argument("--sync_compression", default=d.sync_compression,
                   choices=["none", "ef"],
                   help="ef = carry fp32 error-feedback residuals so the "
                        "compressed wire's rounding does not accumulate "
                        "in the parameters (weights aggregation)")
    p.add_argument("--sync_bucket_mb", type=float, default=d.sync_bucket_mb,
                   help="fast-engine bucket size in MiB of fp32 per "
                        "collective")
    p.add_argument("--opt_placement", default=d.opt_placement,
                   choices=["auto", "replicated", "sharded"],
                   help="where the allreduce blend's scale runs: sharded = "
                        "on each worker's 1/N shard between the reduce-"
                        "scatter and the all-gather (and the gradients-"
                        "mode round optimizer's moments at 1/N), "
                        "replicated = on the gathered buffer; auto = "
                        "sharded under the sharded engine")
    p.add_argument("--sync_staleness", type=int, default=d.sync_staleness,
                   help="semi-synchronous rounds: round R's sync runs on a "
                        "host thread while round R+1 trains on the "
                        "pre-sync parameters, and its consensus delta is "
                        "folded in at the entry of round R+K+1 (0 = "
                        "synchronous; weights aggregation only)")
    p.add_argument("--param_residency", default=d.param_residency,
                   choices=["auto", "replicated", "resident"],
                   help="where the consensus parameters live between "
                        "rounds: resident = each worker keeps its 1/N "
                        "scatter shard and the next round's entry gathers "
                        "it; auto = resident under the sharded engine with "
                        "weights x equal aggregation and no staleness")
    p.add_argument("--shard_redundancy", default=d.shard_redundancy,
                   choices=["auto", "buddy", "off"],
                   help="buddy = every worker also sends its shard-resident "
                        "rows to its ring successor, so a crashed worker's "
                        "span is rebuilt from memory; auto = buddy whenever "
                        "something is shard-resident")
    p.add_argument("--chaos", type=str, default=d.chaos,
                   help="fault-injection plan: comma-separated "
                        "kind@round[:wID][xF][+S][*K] events (kill/join/"
                        "slow/stall/crash/nan) or 'random' (seeded "
                        "schedule); membership changes apply at round "
                        "boundaries by regrouping the worker processes, "
                        "crashes mid-round by the rollback recovery")
    p.add_argument("--chaos_seed", type=int, default=d.chaos_seed,
                   help="seed for --chaos random's up-front event draw")
    p.add_argument("--chaos_events", type=int, default=d.chaos_events,
                   help="event count for --chaos random")
    p.add_argument("--chaos_kinds", type=str, default=d.chaos_kinds,
                   help="event kinds --chaos random may draw (csv; "
                        "crash/nan are opt-in — the default keeps the "
                        "cooperative kill/join/slow/stall faults)")
    p.add_argument("--chaos_grace", type=float, default=d.chaos_grace,
                   help="seconds past --time_limit before a round wall "
                        "counts as a straggler overrun")
    p.add_argument("--chaos_retries", type=int, default=d.chaos_retries,
                   help="consecutive straggler overruns (or quarantined "
                        "sync contributions) tolerated before the worker "
                        "is treated as departed")
    p.add_argument("--chaos_backoff", type=float, default=d.chaos_backoff,
                   help="per-retry grace extension factor: attempt k's "
                        "deadline is time_limit + grace*(1 + backoff*k)")
    p.add_argument("--elastic_min_workers", type=int,
                   default=d.elastic_min_workers,
                   help="quorum floor: membership events that would drop "
                        "below this many live workers are rejected")
    p.add_argument("--profile_dir", type=str, default=d.profile_dir,
                   help="write a torch.profiler trace of the round loop "
                        "(CPU and CUDA activity) into this directory, one "
                        "file per worker process")
    p.add_argument("--sanitize", action="store_true", default=d.sanitize,
                   help="run each round under torch.cuda."
                        "set_sync_debug_mode('error'): an implicit "
                        "host-device sync in the round loop is counted "
                        "(results['sanitize']) and raised")
    p.add_argument("--no_overlap_rounds", action="store_true",
                   help="the serial round loop: no prep of the next round "
                        "and no metric fetch beside the running round "
                        "(bit-identical results)")
    # JAX's persistent XLA compile cache: a documented no-op here
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="[compat no-op] the JAX package's XLA compile "
                        "cache; the port compiles nothing ahead of time")
    p.add_argument("--mesh_shape", type=str, default=d.mesh_shape,
                   help="the rank grid, e.g. data=2,fsdp=2,model=2: each "
                        "of the data workers is fsdp x seq x pipe x model "
                        "processes (ZeRO-3 over fsdp, sequence parallelism "
                        "over seq, pipeline stages over pipe, tensor "
                        "parallelism over model)")
    p.add_argument("--pp_microbatches", type=int, default=d.pp_microbatches,
                   help="pipeline microbatches per step when the mesh has a "
                        "pipe axis (0 = pipe size)")
    p.add_argument("--pp_schedule", default=d.pp_schedule,
                   choices=list(PP_SCHEDULES),
                   help="pipeline schedule: gpipe (all forwards, then all "
                        "backwards) | 1f1b (one forward, one backward: at "
                        "most pipe - s microbatches in flight on stage s)")
    p.add_argument("--pp_remat", action="store_true", default=d.pp_remat,
                   help="recompute each block in the backward under "
                        "pipeline parallelism: --remat_policy everything")
    p.add_argument("--sequence_parallel", default=d.sequence_parallel,
                   choices=list(SEQUENCE_PARALLEL),
                   help="the train module's attention over the 'seq' mesh "
                        "axis: ring | ring_zigzag (causal models) | "
                        "all_to_all (Ulysses)")
    p.add_argument("--num_slices", type=int, default=d.num_slices,
                   help="hierarchical two-level sync: S slices of "
                        "--num_workers workers each (S x W processes); each "
                        "slice's workers reduce-scatter over their data "
                        "line and the slices' means gossip over the slice "
                        "line (--topology ring | double_ring) on the 1/W "
                        "shard; 1 = the flat engine")
    p.add_argument("--sync_dtype_outer", type=str,
                   default=d.sync_dtype_outer,
                   choices=["", "float32", "bfloat16", "int8"],
                   help="wire dtype of the outer (slice) gossip hops; '' "
                        "inherits --sync_dtype")
    for name, (default, _where) in NOT_PORTED.items():
        help_ = "not ported yet (rejected unless default)"
        if isinstance(default, bool):
            p.add_argument(f"--{name}", action="store_true", help=help_)
        else:
            p.add_argument(f"--{name}", type=type(default), default=default,
                           help=help_)
    return p


def config_from_args(argv: list[str] | None = None) -> Config:
    args = build_argparser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["augment"] = not args.no_augment
    kw["ckpt_async"] = args.ckpt_async == "on"
    kw["overlap_rounds"] = not args.no_overlap_rounds
    return Config(**kw)
