#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: the quickest proof that it builds
and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device  - the card's name, count, and nvidia-smi name/power limit;
2. build   - nvcc builds every kernel from csrc/ (sm_90a) and prints the
             ptxas report (registers, shared memory, spills); cuobjdump
             lists the tensor-core instructions (HMMA, HGMMA) and the TMA
             copies (UTMALDG, UTMASTG) in each kernel's bf16 instances, and
             the phase fails if a kernel designed for the tensor cores
             has a bf16 instance without them, or a kernel designed for
             wgmma (all four) one without HGMMA and UTMALDG;
3. kernels - each flash kernel against its plain PyTorch version on the
             same bf16 inputs, at the gpt2 and llama paths' shapes, at the
             bert/moe [64,128,12,64] and vit [64,196,6,64] instances (full
             attention; vit's last tile holds 4 rows), at L=2048 causal and
             non-causal, and at a long GQA shape; times for the kernel, the
             plain version and a PyTorch attention call (a yardstick the
             port never calls), beside the least time the card could take,
             and the two-pass pair (dq + dkv) against PyTorch's flash
             backward; the fused kernel's time is its launch alone, with
             its wrapper's whole time (zero-fill and cast where dq is not
             written whole) beside it;
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
             child process, since the switch is read once at import; the
             child runs beside the sync phase (9), each mostly waiting on
             the host, so both are timed under the other's load;
7. bert, vit, moe - the encoder families through main.run, as the path
             phase does: bert_base MLM (87,578,344 params) and bert_base
             with 8 Switch experts (484,336,360) on synthetic_mlm at lr
             1e-4, vit_s16 (22,049,128) on the synthetic imagenet at 224²
             with augmentation, at least 16 train steps each; launches
             exactly layers x passes, falling losses, flash against dense
             (logits for bert and vit; for moe every layer's attention
             output in bf16 and the logits in fp32, since a near-tie gate
             flips an expert under bf16 rounding), each moe layer's aux
             loss and dropped share; a profile of bert and vit;
   stream vit - the vit path again with --stream_chunk_steps 2
             --stream_prefetch 2 (pinned windows, side-stream copies):
             batch losses and final parameters equal to the plain vit
             run's bit for bit, the same launches; step ms, train wall and
             peak memory of both; a profile of where the H2D copies run
             (pinned or pageable, which stream, overlapped or not);
   remat   - bert at 4 train steps under remat none, everything,
             dots_saveable, save_names:attn_out,block_out and
             offload_names:attn_out, and under --grad_accum 4: launches
             (a remat'd forward runs twice), the same batch losses under
             every policy, K=4 against K=1, and each train step's ms and
             peak memory;
8. cnn     - the reference's own run through main.run: enhanced_cnn at
             full width (44,595,786 params) on cifar10 (the seeded
             synthetic data), bf16 compute, augmentation on, 2 global x 2
             local epochs on 5,120 images; checks that no flash kernel
             launched, the param count, finite and falling losses, finite
             BatchNorm statistics that moved off their init, a finite test
             evaluation, and the trained model's eval-mode logits on 8 test
             images (bf16, channels_last) against the same weights run in
             fp32 on the CPU; then its profile.  It runs after the kernels
             phase turned TF32 off, which touches none of its bf16 convs
             and none of its CPU reference.
   ckpt    - checkpoints (after the gpt2 path): the gpt2 path at 2 rounds
             with --checkpoint_dir --checkpoint_every 1 --ckpt_keep 2, then
             epoch 2 restored into a fresh engine and held against the
             run's final state bit for bit (parameters, Adam moments and
             count, StepLR clock, generator seed), then the same run with
             --epochs_global 3 --resume, which must train exactly one
             round and leave committed epochs [2, 3]; snapshot and write
             ms per save, payload bytes, restore wall;
   serve gpt2 - `main serve` off that checkpoint: 16 greedy requests of 32
             new tokens at 8 decode slots (pages of 16, 160 pages, prompt
             buckets 32 and 128): 512 tokens, no page leaked, the
             dispatched (program, shape) pairs exactly the used buckets
             and one decode shape; 4 requests' paged logits at every
             generated position against a full-sequence forward of the
             served model (flash attention) within 5e-2 of max |full|,
             and the token the full forward's argmax wherever its top-2
             margin exceeds that limit; then a shared 96-token prompt
             with --serve_prefill_chunk 32, cold and with
             --serve_prefix_cache, whose streams must all be equal, with
             pages reused; tokens/s, decode and TTFT p50/p99, peak
             memory, restore ms;
   draft   - the speculative draft: gpt_small (4 layers, hidden 128, 4
             heads of 32) at vocab 1000 on synthetic_lm with flash, one
             round of 16 steps, saving a checkpoint; launches exactly layers
             x passes (the D=32 kernel instances, also held against their
             plain versions in the kernels phase as draft_path);
   serve gpt2 spec - serve gpt2's traffic again with --serve_draft_ckpt
             (the draft) --serve_spec_tokens 4: 512 tokens, no page
             leaked in either pool, the programs exactly the used buckets
             and one verify shape (the draft's: its buckets and one decode
             shape); every stream equal to serve gpt2's up to the first
             position whose plain top-2 margin is within SERVE_LOGIT_TOL of
             max |logit|, and how many are equal in full; tokens/s, decode
             and TTFT p50/p99, acceptance, target steps per token, peak
             memory with both pools, restore ms, beside the plain run's;
             the target as its own draft (acceptance printed); a profile;
   serve llama - in the llama child, the llama path's run writes one
             checkpoint, and the child serves from it as serve gpt2 does
             (GQA and RoPE at the cache offsets);
9. sync    - the N-worker slice: [gloo] which gloo collectives the
             card's torch has and what they give (all_to_all_single on
             fp32/bf16/int8/uint8, all_gather into views,
             all_gather_into_tensor, all_gather_single) on 2 processes;
             (a) all 12 sync modes (six blends, each serving gradients
             and weights) on CUDA tensors of odd sizes in 2 and in 4
             worker processes of a gloo group, staged through pinned host
             memory, against a float64 numpy formula of each mode (rtol
             1e-6, atol 1e-6), with post-sync checksums; then the fast
             engines on the same tensors (sharded equal/weighted, gossip
             ring/double_ring equal/weighted): fp32 against the formula,
             the sharded equal all-reduce bitwise equal on every rank,
             bf16 and int8 with error feedback (worker r's leaves scaled
             by 1 + r) within one quantum of each wire stage of fp32 per
             element, the bytes handed to gloo equal to sync_wire_bytes, the
             slowest rank's quickest-round ms beside the dense path's
             timed the same way; at n=4 the hierarchical engine at 2
             slices x 2 workers (ring and double ring, equal and weighted,
             on the fp32, fp32/bf16, fp32/int8 and int8/int8 inner/outer
             wires with both levels' error feedback): fp32 bitwise its
             dense twin comms.aggregate_hier on every rank and within 1e-6
             of the float64 gossip of slice means, the compressed pairs
             within one quantum of each wire stage, the bytes handed to
             gloo per level equal to hier_wire_bytes; (b) main.run on
             the cnn phase's run with --num_workers 2 and 4 and
             --aggregation_by weights (N=2 equal/allreduce balanced, N=4
             equal/allreduce balanced, N=4 weighted/double_ring
             disbalanced, N=4 sharded int8 with error feedback, N=4
             weighted double ring bf16 with error feedback one round
             stale over three rounds, and the hierarchical sync at
             --num_slices 2 --num_workers 2 over the ring, the int8
             outer wire with error feedback, 3 rounds under --sanitize
             with a checkpoint a round: round 2's DCN bytes equal to
             hier_wire_bytes, no implicit sync, each slice's workers
             bitwise equal after every round, the last checkpoint restored
             in this process bitwise the run's rows and outer residual),
             each worker its own process on the one card (each process
             count's gloo probe, modes, engines and runs from ONE start
             of its ranks, main.run_shared):
             per-worker step time, summed images/s beside the cnn phase's
             one worker, the sync wall per round and the bytes per
             worker (the modeled wire against the same engine's fp32
             wire), async_rounds, each process's peak memory, the host's
             core count; checks finite and falling losses, no flash
             launch, every stale delta delivered (one at a round's
             entry, with its sync wall on every rank, the in-loop and the
             drain's hidden fractions apart), and bitwise-identical
             parameters on every rank after an equal all-reduce;
10. sim    - the scenario lab (--sim_workers, one process): the cnn run at
             N=8 weighted double ring non-IID (2 x 2) and its profile, N=8
             equal all-reduce (all rows bitwise equal after the sync) and
             N=32 (the ceiling on one card): summed images/s beside the cnn
             and sync phases', stacked-blend sync ms, bytes, peak memory;
             sim parity n2 (fp32, 1,024 images) against 2 worker
             processes at limits set between the sound reading and three
             planted faults; sim scenario (the draws equal the seed's numpy
             draw, dropped rows bitwise frozen); sim gpt2 n4 (one flash
             launch per layer per pass for all 4 workers, worker 0's flash
             vs dense logits), whose kernels the kernels phase holds at
             sim_path [256,128,12,64].
10b. grid  - the rank grid (--mesh_shape; every rank a process on the
             one card, every collective staged through pinned host
             memory), from ONE start of 2 processes (main.run_shared: the
             module checks, [tp gpt2]'s data-only twin, [sp gpt2], [sp
             bert], [pp gpt2]) and then ONE start of 4 ([tp gpt2]'s grid
             runs, [tp fsdp bert]'s, [fsdp cnn]): [tp gpt2] the gpt2
             path's fp32 pair (2 steps a
             worker) at data=2,model=2 against --num_workers 2 (losses
             rtol 2e-3), both timed, then the bf16 run (about 3 steps a
             worker) timed; each grid run's launches (the fp32, then the
             tensor-core instances) exactly layers x its passes on every
             rank, the bf16 run's loss falling; [tp
             fsdp bert] bert_base at data=1,fsdp=2,model=2: the fp32 pair
             (2 steps) against data=1, both timed, the grid's launches
             (fp32 instances) checked on every rank; [fsdp cnn] the cnn
             at data=2,fsdp=2 timed (one round on 2,048 images), BatchNorm
             statistics equal along fsdp; the module checks: [fsdp cnn] one
             fp32 step of the full-width cnn at data=1,fsdp=2 against the
             dense twin that normalises each half (logits atol 1e-5,
             gradients 2e-4), [sp attn], [pp toy] and [pp gpt2]'s one
             steps; [sp attn] ring, ring_zigzag and
             all_to_all on a seq line of 2 processes at the gpt2
             [64,128,12,64] and llama [64,128,16/4,64] shapes, causal, bf16
             and fp32, the output and the q/k/v gradients against the
             dense attention on the whole sequence (5e-2 and 1e-5 of max
             |dense|); [sp gpt2] gpt2_small at data=1,seq=2 with
             ring_zigzag and [sp bert] bert_base at data=1,seq=2 with
             all_to_all (dense attention: JAX refuses flash under SP):
             each an fp32 pair (one round of 2 steps) against data=1, then
             a bf16 run (gpt2 4 steps, bert 8) under --sanitize: no flash
             launch on any rank, the parameters bitwise equal along seq,
             no implicit sync, the loss falling; each rank's step ms, TP
             all-reduce, FSDP gather/reduce-scatter and SP hop ms and
             bytes, the seq gradient all-reduce, parameter and moment
             bytes, peak memory; [pp toy] GPipe and 1F1B on a pipe line
             of 2 processes over JAX tests/test_pp.py's tanh stages (4
             microbatches) against the stages run in turn (atol 1e-5), the
             microbatches in flight at each stage's bound; [pp gpt2]
             gpt2_small at data=1,pipe=2 (6 blocks a stage, flash): one
             fp32 step under each schedule against the dense twin (the last
             stage's logits atol 1e-5, gradients 2e-4), the fp32 pair (one
             round of 2 steps, M=2) under each schedule against one data=1
             twin (losses rtol 2e-3), then a bf16 run under each schedule
             at --pp_microbatches 4: every rank's launches exactly its 6
             blocks x M x its train and val steps plus the dense twin's 12
             blocks x the probe's passes, the replicated leaves bitwise
             equal along pipe after every round, M microbatches in flight
             under GPipe and at most 2 - s on stage s under 1F1B, each
             rank's fp32 parameters and Adam moments 529.0 MB (its stage's
             44,083,200 parameters), the loss falling; per rank step ms,
             tokens/s, hop ms and bytes per pass, the replicated leaves'
             all-reduce, memory at the most microbatches in flight and
             peak; [tp llama] in the llama child:
             llama_medium at data=1,model=2, the fused backward's launches
             on every rank.  The kernels phase holds the four kernels at
             the shard shapes tp_gpt2 [64,128,6,64] causal, tp_llama
             [64,128,8/2,64] causal and tp_fsdp_bert [32,128,6,64] full,
             and the pipeline stage's microbatch pp_gpt2 [16,128,12,64]
             causal.  Alone: python3 chip_smoke.py grid; the 2-process
             phases alone: python3 chip_smoke.py pp (or sp).  (To make
             room for these phases the
             sync and overlap runs take 2,048 images (the sync runs one
             local epoch a round), the elastic phase 2,048 images and 1
             layout round, serving 16 requests of 32 new tokens, [tp
             gpt2] a shallow bf16 run, [fsdp cnn] no data-only twin.)
             [stale tp gpt2] the last job of the 4-process start: [tp
             gpt2]'s bf16 run with --sync_staleness 1 over 3 rounds (each
             coordinate's data line runs its stale sync on a second group
             of the line): 3 deltas delivered, the hidden fraction, every
             rank's launches, the loss falling.
             [unrolled gpt2] the last job of the 2-process start: the
             gpt2 path under --layer_scan off (JAX's unrolled layout) on
             2 worker processes, sharded int8 sync with error feedback
             (replicated parameters), 2 rounds, a checkpoint of the last:
             each worker's launches 12 x its passes, the loss falling,
             both workers' parameters bitwise equal, 148 leaves in 37
             buckets (the stacked layout's 5 printed beside them) and the
             wire bytes comms.sync_wire_bytes gives, the MANIFEST's
             scan_layers false and its 148 params_leaves in JAX's sorted
             order, the epoch restored into a fresh engine bit for bit,
             and JAX's refusals of it by an --layer_scan auto engine's
             restore and by main serve.

11. elastic cnn n4 - in a child process (CUBLAS_WORKSPACE_CONFIG set,
             deterministic algorithms in it and in its ranks): the cnn run
             on 4 worker processes, weights x equal on the sharded engine
             (scatter-resident parameters, the buddy hop), 2,048 images,
             5 rounds, under --chaos kill@1:w3,join@2,crash@3:w0,nan@4:w1
             with the walls pinned: the roster per round (4 -> 3 -> 4 ->
             3), events, reshard and recovery stalls, sync ms and bytes
             (the buddy hop's apart), memory held after the sync and peak;
             checks round 3 voided once and re-run from the buddy rows,
             one quarantine strike in round 4, finite values, equal
             parameters on every rank after every round and a falling
             loss; a fresh twin from the round-2 snapshot bitwise the
             continued run, and a twin whose joiner clones the wrong row
             seen to differ; then the replicated against the resident
             layout without chaos (memory, sync ms, bitwise parameters).
             The child's runs all come from one start of 6 ranks
             (driver.SharedStart; 4-rank jobs leave two
             idle): the overlap pair, the layouts, elastic tp gpt2, then
             this phase's three runs.
   elastic tp gpt2 - in the same child, before elastic cnn n4: the gpt2
             path (bf16, flash) on data=3,model=2 (6 processes, 480
             sequences: about 2 train steps of 64 a worker a round on 3
             workers, 3 on 2; 5 rounds) under --chaos
             kill@2:w1,join@3,crash@4:w0:
             the roster of worker blocks 3 -> 2 -> 3 -> 2 (the model axis
             fixed), round 4 voided and re-run from the boundary snapshot,
             every final rank's launches (the voided round's included),
             at least 2 train steps a worker a round, the boundary, join
             and recovery stalls, each round's step ms (round 1, the only
             one with no boundary or start before it, the steady figure)
             and each rank's peak, a falling loss, and the fresh twin from
             the round-2
             snapshot bitwise over its one round.  Alone, with [stale tp
             gpt2]: CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py
             elastic_tp
   overlap cnn - first in the same child: the cnn run (probe and walls
             pinned) with --no_overlap_rounds and with the overlapped
             round loop, then the same on 4 worker processes on the sync
             n4 traffic (one local epoch; one start of the ranks for both
             and the elastic layouts): every metric list, the
             parameters (every rank's at N=4) and the partitions equal to
             the bit; each round's stage, compute,
             fetch, assemble, prep and gap ms in both flows.  Alone:
             CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py overlap
   multihost cnn n4 - last in the same child, once the shared start's
             ranks are gone: the N=4 serial run again as a launched world
             (driver.run_launched): two processes started with Popen,
             each told JAX_COORDINATOR_ADDRESS (127.0.0.1 and a free
             port), JAX_NUM_PROCESSES=2 and its JAX_PROCESS_ID, each
             hosting 2 ranks on the card, met at a TCPStore, one shared
             --checkpoint_dir saved every round: both exit 0, their metric
             lists bitwise equal to each other's and to the serial
             overlap n4 run's, the partitions and every rank's parameter
             checksum equal to that run's, the last manifest listing 4
             shards, which this process merges bitwise to every rank's
             final row (SHA-256 of each leaf), the loss falling; the
             wall, each rank's seconds to its rendezvous and first round,
             round and sync ms per rank, images/s, checkpoint ms.  (The
             child's processes set the deterministic flag without
             torch.use_deterministic_algorithms, whose import of
             torch._inductor took 8-13 s of each process's start.)
12. sanitize - which host waits torch's sync-debug mode counts;
             --sanitize on short cnn and gpt2 runs (every counter 0); an
             .item() planted in the train step, counted once and raised;
             every path's implicit syncs listed by place (warn mode; they
             fail nothing);
   profile_dir - a short cnn run with --profile_dir: the trace file holds
             CUDA kernel rows;
13. memory - results["memory"] of the cnn, gpt2 and sim cnn n8 runs and
             the serve gpt2 telemetry's: available, every registered
             program with its row; the lab's total 8 x per worker; 1 GiB
             allocated and freed before a tracked program's first call
             still in the process peak; bert's train-step temp bytes none
             >= dots_saveable >= everything (the remat runs);
   mfu     - the FLOP count against 2*M*N*K of one layer, then each path's
             FLOPs per train step (its dense twin on the meta device) and
             MFU from this call's step times, beside the card's name and
             power limit.

The last lines are the smoke's total wall, the nvidia-smi line, one JSON
object with a row per kernel, and {"ok": true, "device": {...}}.  Imports
nothing of JAX.

Another tree's kernels beside this tree's, in one card call:
    python3 chip_smoke.py kernels_ab <that tree's csrc directory>
builds both (each build's wall) and, at every SHAPES entry, times each
kernel in turns (other, this, this, other) at the device's and the host's
pace beside SDPA's forward and aten's flash backward (the fused kernel
alone and its wrapper whole, each tree's wrapper by its own protocol: dq
written whole up to its flash_bwd_fused_whole_keys, else zero-fill and
cast), and checks both against the plain versions, this tree's kernels for
repeated bits (all but a dq the fused kernel sums by atomics), and the
kernels AB_SAME names, which this tree leaves as they were, for equal bits
in both.  For the parent commit: git archive HEAD <package>/csrc | tar -x
-C build/parent (build/ is ignored by git but copied to the card).
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
_COMMON_ARGV = ["--attention_impl", "flash", "--epochs_global", "1",
                "--batch_size", str(PATH_BATCH)]
# token paths: 1,280 sequences -> 1,024 train (16 steps) / 256 val, and 256
# test sequences, one local epoch
_TOKENS_ARGV = [*_COMMON_ARGV, "--epochs_local", "1",
                "--limit_train_samples", "1280", "--limit_eval_samples", "256"]
# the encoders train at BERT's own peak rate, 1e-4: at the repo's 1e-3 the
# post-LN stack with 8 experts climbs over its first 16 steps (7.198 ->
# 7.375 on the card), as post-LN BERT does without warm-up
_MLM_ARGV = ["--dataset", "synthetic_mlm", "--lr", "1e-4"]
# the vit path: the seeded synthetic imagenet is random pixels under random
# labels, so there is nothing to learn but the training images themselves:
# 320 images -> 256 train (4 steps) / 64 val, 4 local epochs over them (16
# steps), and 256 test images (0.35 GB of fp32 pixels in all)
_VIT_ARGV = [*_COMMON_ARGV, "--dataset", "imagenet", "--epochs_local", "4",
             "--limit_train_samples", "320", "--limit_eval_samples", "256"]
LLAMA_CKPT_DIR = os.path.join(OUT_DIR, "ckpt_llama")
# path name -> (argv of main.run, layers: one launch each per pass)
PATHS = {
    "gpt2": (["--model", "gpt2_small", "--dataset", "synthetic_lm",
              *_TOKENS_ARGV, "--out_dir", os.path.join(OUT_DIR, "gpt2")], 12),
    # the llama run also writes one checkpoint, which the child serves
    "llama": (["--model", "llama_medium", "--num_kv_heads", "4",
               "--dataset", "synthetic_lm", *_TOKENS_ARGV, "--out_dir",
               os.path.join(OUT_DIR, "llama"), "--checkpoint_dir",
               LLAMA_CKPT_DIR, "--checkpoint_every", "1"], 16),
    "bert": (["--model", "bert_base", *_MLM_ARGV, *_TOKENS_ARGV, "--out_dir",
              os.path.join(OUT_DIR, "bert")], 12),
    "vit": (["--model", "vit_s16", *_VIT_ARGV, "--out_dir",
             os.path.join(OUT_DIR, "vit")], 12),
    # Switch-Base-8: bert_base with 8 top-1 experts at the JAX defaults
    # (capacity factor 1.25, aux weight 0.01)
    "moe": (["--model", "bert_base", "--num_experts", "8", *_MLM_ARGV,
             *_TOKENS_ARGV, "--out_dir", os.path.join(OUT_DIR, "moe")], 12),
}
# phase ckpt: the gpt2 path at 2 rounds, saving every round, keeping 2
CKPT_DIR = os.path.join(OUT_DIR, "ckpt_gpt2")
CKPT_ARGV = [*PATHS["gpt2"][0], "--epochs_global", "2", "--checkpoint_dir",
             CKPT_DIR, "--checkpoint_every", "1", "--ckpt_keep", "2"]
# phase unrolled gpt2: the gpt2 path under --layer_scan off (JAX's unrolled
# parameter layout: a layer{i} subtree per block) on 2 worker processes,
# the sharded int8 sync with error feedback, 2 rounds (8 steps a worker a
# round), one checkpoint at the end; replicated parameters, so that the
# checkpoint holds the .params leaves a resume of the other layout misses
UNROLLED_DIR = os.path.join(OUT_DIR, "ckpt_unrolled")
UNROLLED_ARGV = [*PATHS["gpt2"][0], "--num_workers", "2", "--epochs_global",
                 "2", "--layer_scan", "off", "--sync_mode", "sharded",
                 "--sync_dtype", "int8", "--sync_compression", "ef",
                 "--aggregation_by", "weights", "--param_residency",
                 "replicated", "--checkpoint_dir", UNROLLED_DIR,
                 "--checkpoint_every", "2", "--out_dir",
                 os.path.join(OUT_DIR, "unrolled")]
# gpt2_small at vocab 1000 (weights.wire_layout, comms.bucket_plan): 148
# unrolled leaves in 37 buckets of 4 MiB at n = 2, where the stacked
# layout's 16 leaves make 5
UNROLLED_LEAVES, UNROLLED_BUCKETS, STACKED_BUCKETS = 148, 37, 5
# phase draft: gpt_small (head_dim 32) as the speculative draft, one round
# of 16 steps on the token paths' data, saving its checkpoint
DRAFT_CKPT_DIR = os.path.join(OUT_DIR, "ckpt_draft")
DRAFT_ARGV = ["--model", "gpt_small", "--dataset", "synthetic_lm",
              *_TOKENS_ARGV, "--out_dir", os.path.join(OUT_DIR, "draft"),
              "--checkpoint_dir", DRAFT_CKPT_DIR, "--checkpoint_every", "1"]
DRAFT_LAYERS = 4
SPEC_TOKENS = 4
# phase stream vit: the vit path's windows of 2 steps, 2 staged ahead
STREAM_ARGV = ["--stream_chunk_steps", "2", "--stream_prefetch", "2"]
# phase serve: 16 greedy requests of 32 new tokens at 8 decode slots (cut
# from 32 requests to make room for the rank grid's phases, and from 64
# new tokens for the seq axis's)
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 32
SERVE_ARGV = ["--serve_max_batch", "8", "--serve_page_size", "16",
              "--serve_max_pages", "160", "--serve_prompt_buckets", "32,128",
              "--serve_requests", str(SERVE_REQUESTS),
              "--serve_max_new_tokens", str(SERVE_NEW_TOKENS)]
SERVE_TOKENS = SERVE_REQUESTS * SERVE_NEW_TOKENS
SERVE_CHECKED = 4              # requests held against a full forward
# paged logits vs a full-sequence forward with the flash kernels, bf16:
# the flash-vs-dense limit of the paths, as a share of max |full|
SERVE_LOGIT_TOL = 5e-2
# a shared 96-token prompt (6 full pages; a hit reuses 5 and prefills
# the last 16 tokens)
SHARED_PROMPT = ",".join(str((7 * i * i + 3 * i + 11) % 1000)
                         for i in range(96))
SHARED_ARGV = ["--serve_prefill_chunk", "32", "--serve_prompt",
               SHARED_PROMPT]
# phase remat: the bert path cut to 4 train steps (320 sequences -> 256
# train / 64 val; 256 test), under each policy, and under --grad_accum 4
REMAT_ARGV = ["--model", "bert_base", *_MLM_ARGV, *_COMMON_ARGV,
              "--epochs_local", "1", "--limit_train_samples", "320",
              "--limit_eval_samples", "256", "--probe_batches", "1"]
REMAT_POLICIES = ["none", "everything", "dots_saveable",
                  "save_names:attn_out,block_out", "offload_names:attn_out"]
GRAD_ACCUM = 4
# Every policy computes the same values (the recompute repeats the same
# kernels on the same shapes, and the two-pass backward has no atomics):
# the batch losses of all policies agree to 1e-6 of their value.
REMAT_LOSS_RTOL = 1e-6
# K=4 against K=1, both bf16 (products at another row count round
# elsewhere): each batch loss to 1e-3 of its value, and the parameters'
# updates after 4 Adam steps to 0.05 in relative L2 norm.  Each limit lies
# between the sound reading on the H100 (2.04e-5; 0.0165) and the smallest
# reading of a planted accumulation fault (5.64e-3, keeping only the last
# slice's gradient; 0.1333, each slice over its own denominator).
ACCUM_LOSS_RTOL, ACCUM_UPDATE_RTOL = 1e-3, 0.05
MOE_EXPERTS = 8
# the reference's run, cut to 2 rounds of 2 local epochs on 5,120 images;
# batch 64, bf16, augmentation and width 64 are main's defaults
CNN_ARGV = ["--model", "enhanced_cnn", "--dataset", "cifar10",
            "--epochs_global", "2", "--epochs_local", "2",
            "--limit_train_samples", "5120", "--limit_eval_samples", "1024",
            "--out_dir", os.path.join(OUT_DIR, "cnn")]
CNN_PARAMS = 44_595_786
# phase 8: (label, workers, extra argv of main.run) of the N-worker runs
SYNC_RUNS = [
    ("n2_equal_allreduce", 2, ["--aggregation_type", "equal", "--topology",
                               "allreduce", "--data_mode", "balanced"]),
    ("n4_equal_allreduce", 4, ["--aggregation_type", "equal", "--topology",
                               "allreduce", "--data_mode", "balanced"]),
    ("n4_weighted_double_ring", 4, [
        "--aggregation_type", "weighted", "--topology", "double_ring",
        "--data_mode", "disbalanced", "--local_weight", "0.7"]),
    # the fast engines: the reduce-scatter on the int8 wire
    # with error feedback, and the bucketed gossip on the bf16 wire with
    # error feedback under one round of staleness (three rounds: round 0's
    # delta lands at round 2's entry, rounds 1 and 2 at the drain)
    ("n4_sharded_int8_ef", 4, [
        "--aggregation_type", "equal", "--topology", "allreduce",
        "--data_mode", "balanced", "--sync_mode", "sharded", "--sync_dtype",
        "int8", "--sync_compression", "ef"]),
    ("n4_double_ring_bf16_stale1", 4, [
        "--aggregation_type", "weighted", "--topology", "double_ring",
        "--data_mode", "disbalanced", "--local_weight", "0.7",
        "--sync_dtype", "bfloat16", "--sync_compression", "ef",
        "--sync_staleness", "1", "--epochs_global", "3"]),
    # the hierarchical sync: 2 slices of 2 workers, the sharded engine in
    # each slice (fp32) and the ring gossip across them on the int8 wire
    # with error feedback, 3 rounds under --sanitize, a checkpoint a round
    ("n4_hier_ring_int8_ef", 4, [
        "--num_slices", "2", "--aggregation_type", "equal", "--topology",
        "ring", "--data_mode", "balanced", "--sync_dtype_outer", "int8",
        "--sync_compression", "ef", "--epochs_global", "3", "--sanitize",
        "--checkpoint_dir", os.path.join(OUT_DIR, "ckpt_hier"),
        "--checkpoint_every", "1"]),
]
# phase sync engines: (engine, how, topology) of each fast-engine case, on
# each wire; rounds per case (the ms is the quickest round's)
SYNC_ENGINES = [("sharded", "equal", "allreduce"),
                ("sharded", "weighted", "allreduce"),
                ("gossip", "equal", "ring"), ("gossip", "weighted", "ring"),
                ("gossip", "equal", "double_ring"),
                ("gossip", "weighted", "double_ring")]
SYNC_WIRES = ("float32", "bfloat16", "int8")
SYNC_ENGINE_ROUNDS = 2
# the hierarchical engine's cases at n=4: 2 slices x 2 workers, each blend
# on each (inner, outer) wire pair; a compressed pair carries both levels'
# error feedback
SYNC_HIER_SLICES = 2
SYNC_HIER = [("equal", "ring"), ("weighted", "ring"),
             ("equal", "double_ring"), ("weighted", "double_ring")]
SYNC_HIER_WIRES = [("float32", "float32"), ("float32", "bfloat16"),
                   ("float32", "int8"), ("int8", "int8")]
# the scenario lab (--sim_workers): the cnn run's N workers in one process
SIM_WEIGHTED = ["--aggregation_by", "weights", "--aggregation_type",
                "weighted", "--topology", "double_ring", "--data_mode",
                "disbalanced", "--local_weight", "0.7"]
SIM_ALLREDUCE = ["--aggregation_by", "weights", "--aggregation_type",
                 "equal", "--topology", "allreduce", "--data_mode",
                 "balanced", "--epochs_global", "1"]
# phase sim scenario: N=8, 2 rounds x 1 local epoch on 1,024 images
SIM_SCENARIO = ["--sim_sample_frac", "0.5", "--sim_dropout", "0.125",
                "--sim_byzantine", "signflip:1", "--sim_lr_jitter", "0.2",
                "--sim_staleness", "1"]
# phase sim parity n2: --sim_workers 2 against 2 worker processes, fp32, 1
# round of 1 local epoch on 1,024 images (7 steps a worker) at lr 1e-4;
# uniform shares, so the two runs' probes (one tiled measurement, two
# measured ranks) split alike
SIM_PARITY_LR = 1e-4
SIM_PARITY_ARGV = ["--model", "enhanced_cnn", "--dataset", "cifar10",
                   "--epochs_global", "1", "--epochs_local", "1",
                   "--limit_train_samples", "1024", "--limit_eval_samples",
                   "256", "--compute_dtype", "float32", "--aggregation_by",
                   "weights", "--aggregation_type", "weighted",
                   "--local_weight", "0.7", "--probe_batches", "1",
                   "--proportionality", "uniform", "--lr",
                   str(SIM_PARITY_LR)]
# The two runs compute each worker's products with other cuDNN algorithms
# (a vmapped conv is one grouped conv), so they differ by fp32 rounding,
# which every step amplifies (train-mode BatchNorm; Adam moves an element
# whose gradient is near zero by ~lr whatever its size).  Limits, as
# relative differences between the runs: the first and second batch
# losses, every batch loss, worker 0's parameter update and BatchNorm
# statistics in L2, the validation losses.  Each lies between the sound
# reading on the H100 (twice: 2.7e-7, 1.1e-4, 5.9e-3 and 1.2e-2, 0.068,
# 1.9e-3, 1.3e-5 and 1.3e-4) and the least reading of the faults it
# catches, planted in a run of this phase: every worker drawing worker
# 0's augmentation (first 5.2e-2, stats 3.6e-2, val 3.8e-3), Adam's bias
# correction a step ahead (second 3.4e-2, losses 6.8e-2, update 0.136),
# BatchNorm statistics never written (stats 0.52, val 1.0e-2).
SIM_PARITY_TOL = dict(first=1e-5, second=1e-3, losses=3e-2, update=0.1,
                      stats=1e-2, val=1e-3)
SYNC_MODE_SIZES = [(7,), (3, 5), (1,), (129,), (1_000_003,)]
SYNC_LOCAL_WEIGHT = 0.7
SYNC_TOL = 1e-6                # rtol and atol against the float64 formula
SYNC_DEVICE = "cuda"           # phase 8a's tensors
CNN_LOGIT_TOL = 5e-2           # bf16 on the card vs fp32 on the CPU
# a profile window: 2 x 64 examples of the test set, and a serve
# profile's new tokens (short: the profiler's post-processing of a
# window's events takes seconds on the card's host)
PROFILE_STEPS = 2
PROFILE_NEW_TOKENS = 8
LLAMA_PHASE = "llama"          # the child's argument
ACCUM_PHASE = "grad_accum"     # runs phase remat's K=4 vs K=1 alone
RESULT_TAG = "chip_smoke-llama-result "
# phase elastic cnn n4: the reference's cnn on 4 worker processes, weights
# x equal on the sharded engine (resident parameters, the buddy hop),
# 2,048 training images, 5 rounds of 1 local epoch, under chaos
ELASTIC_PHASE = "elastic"      # the child's argument
ELASTIC_RESULT_TAG = "chip_smoke-elastic-result "
ELASTIC_ARGV = ["--model", "enhanced_cnn", "--dataset", "cifar10",
                "--num_workers", "4", "--aggregation_by", "weights",
                "--aggregation_type", "equal", "--topology", "allreduce",
                "--sync_mode", "sharded", "--epochs_global", "5",
                "--epochs_local", "1", "--limit_train_samples", "2560",
                "--limit_eval_samples", "256", "--log_level", "warning",
                "--out_dir", os.path.join(OUT_DIR, "elastic")]
ELASTIC_CHAOS = ["--chaos", "kill@1:w3,join@2,crash@3:w0,nan@4:w1",
                 "--chaos_retries", "1"]
ELASTIC_ROSTERS = [[0, 1, 2, 3], [0, 1, 2], [0, 1, 2, 4], [1, 2, 4],
                   [1, 2, 4]]
# the walls the straggler policy and the EMA read, pinned (seconds per
# local epoch, per logical id 0..4 and round) so that a fresh twin makes
# the continued run's host decisions
ELASTIC_WALLS = [[1.0 + 0.05 * w for w in range(5)] for _ in range(5)]
ELASTIC_TWIN_SNAPSHOT = 1      # the round-2 snapshot (after the join)
ELASTIC_TWIN_EPOCH = 2
ELASTIC_LAYOUT_ROUNDS = 1      # replicated vs resident, no chaos
# phase elastic tp gpt2: the gpt2 path (bf16, flash) on data=3,model=2 (6
# processes: 3 worker blocks of 2 tensor-parallel ranks), weights x equal,
# 5 rounds on 480 sequences (384 train: about 128 a worker a round on 3
# workers, 2 steps of 64, and 3 steps on 2), under kill, join and crash: the roster of blocks 3 -> 2 -> 3 -> 2, the model axis fixed;
# in the deterministic child's shared start (6 ranks), before elastic cnn
# n4
ELASTIC_TP_PHASE = "elastic_tp"     # this phase and stale tp gpt2 alone
ELASTIC_TP_ARGV = [*PATHS["gpt2"][0], "--mesh_shape", "data=3,model=2",
                   "--aggregation_by", "weights", "--epochs_global", "5",
                   "--limit_train_samples", "480", "--limit_eval_samples",
                   "64", "--probe_batches", "1", "--log_level", "warning",
                   "--out_dir", os.path.join(OUT_DIR, "elastic_tp")]
ELASTIC_TP_CHAOS = ["--chaos", "kill@2:w1,join@3,crash@4:w0"]
ELASTIC_TP_ROSTERS = [[0, 1, 2], [0, 1, 2], [0, 2], [0, 2, 3], [2, 3]]
ELASTIC_TP_TWIN_SNAPSHOT = 0   # the round-2 snapshot (after the kill)
ELASTIC_TP_TWIN_EPOCH = 2
ELASTIC_TP_MIN_STEPS = 2       # train steps of every worker, every round
ELASTIC_TP_STEADY_ROUND = 1    # no start or boundary just before it
# phase overlap cnn: the cnn run serial and overlapped, at
# one worker and at N=4 on the sync n4 traffic (one local epoch), in the
# deterministic child; the probe and the walls pinned, so the partitions
# of both flows come from the same numbers
DETERMINISTIC_PHASE = "deterministic"   # the child: overlap, then elastic
OVERLAP_PHASE = "overlap"
OVERLAP_ARGV = [*CNN_ARGV[:-1], os.path.join(OUT_DIR, "overlap"),
                "--limit_train_samples", "2560"]
OVERLAP_N4_ARGV = [*OVERLAP_ARGV, "--num_workers", "4", "--aggregation_by",
                   "weights", "--epochs_local", "1", *SYNC_RUNS[1][2]]
OVERLAP_PROBE = [1.0, 1.3, 0.9, 1.1]
OVERLAP_WALLS = [[0.5 + 0.1 * w for w in range(4)] for _ in range(2)]
OVERLAP_KEYS = ("stage_ms", "compute_ms", "fetch_ms", "assemble_ms",
                "prep_ms", "gap_ms")
# phase multihost cnn n4: [overlap cnn n4]'s serial run as a launched
# world of 2 independently started processes x 2 ranks on the one card,
# met at a TCPStore on localhost (JAX's three variables), one shared
# checkpoint directory, a save every round; in the deterministic child
MULTIHOST_PHASE = "multihost_rank"      # one launched process
MULTIHOST_TAG = "chip_smoke-multihost-result "
MULTIHOST_PROCESSES = 2
MULTIHOST_DIR = os.path.join(OUT_DIR, "multihost")
MULTIHOST_CKPT = ["--checkpoint_dir", os.path.join(MULTIHOST_DIR, "ckpt"),
                  "--checkpoint_every", "1"]
MULTIHOST_METRICS = ("all_workers_losses", "global_train_losses",
                     "global_val_losses", "global_train_accuracies",
                     "worker_specific_train_losses", "step_caps",
                     "shard_sizes", "param_checksums")
# phases tp gpt2, tp llama, fsdp cnn and tp fsdp bert: the
# rank grid's worker processes time-share the one card and stage every
# collective (the per-layer TP all-reduces, the FSDP gather and
# reduce-scatter) through pinned host memory; the numbers measure that,
# not the speed of tensor parallelism.  The fp32 parity runs share their
# partition (uniform shares, one probe batch) with their data-only twins.
GRID_FP32 = ["--compute_dtype", "float32", "--proportionality", "uniform",
             "--probe_batches", "1", "--epochs_global", "1",
             "--limit_train_samples", "640", "--limit_eval_samples", "128"]
# [sp bert]'s timed bf16 run: the path's argv cut to 512 training
# sequences (8 steps) and one probe batch; tp llama to 256 (4 steps);
# [tp gpt2]'s bf16 run to 448 (a probe batch, then about 3 steps a
# worker) and its fp32 pair to 320 (2 steps a worker)
GRID_CUT = ["--limit_train_samples", "640", "--limit_eval_samples", "128",
            "--probe_batches", "1"]
TP_LLAMA_CUT = ["--limit_train_samples", "320", "--limit_eval_samples",
                "64", "--probe_batches", "1"]
TP_GPT2_CUT = ["--limit_train_samples", "448", "--limit_eval_samples",
               "64", "--probe_batches", "1"]
TP_GPT2_FP32 = [*GRID_FP32, "--limit_train_samples", "320",
                "--limit_eval_samples", "64"]
# fsdp cnn: one round of one local epoch on 2,048 training images
FSDP_CNN_CUT = ["--epochs_global", "1", "--epochs_local", "1",
                "--limit_train_samples", "2560", "--limit_eval_samples",
                "256"]
TP_GPT2_MESH = ["--mesh_shape", "data=2,model=2"]
# phase stale tp gpt2: the tp gpt2 bf16 run's launch line with the stale
# sync (K = 1) over 3 rounds of 2 train steps a worker (256 sequences), in
# the grid's 4-process start
STALE_TP_ARGV = ["--aggregation_by", "weights", "--sync_staleness", "1",
                 "--epochs_global", "3", "--limit_train_samples", "256"]
TP_LLAMA_MESH = ["--mesh_shape", "data=1,model=2"]
FSDP_CNN_MESH = ["--mesh_shape", "data=2,fsdp=2"]
TP_FSDP_BERT_MESH = ["--mesh_shape", "data=1,fsdp=2,model=2"]
GRID_RTOL = 2e-3          # the CPU tests' gate (JAX test_tp/test_fsdp)
# the one-step module checks (grid_harness): logits atol 1e-5, gradients
# atol 2e-4 (the CPU tests' gates, fp32 on the card)
GRID_LOGITS_ATOL, GRID_GRAD_ATOL = 1e-5, 2e-4
TP_LLAMA_PHASE = "tp_llama"     # the FLASH_BWD=fused child, alone
GRID_COUNTS: dict = {}          # tp llama's rank-0 launches (llama child)
GRID_PHASE = "grid"             # the rank grid's phases alone
# phases sp gpt2, sp bert and sp attn: sequence parallelism over a seq line
# of 2 processes on the one card.  Every hop of the ring and the
# all-to-all stages through pinned host memory, so the numbers measure the
# staging, not the speed of sequence parallelism.  The runs attend densely
# (the JAX package refuses flash under SP): their ranks launch no kernel.
# The fp32 pairs: one round of 2 steps against the data=1 twin; the timed
# bf16 runs: one probe batch and 256 training sequences for gpt2 (4
# steps), 512 for bert (8: its loss falls slowly at lr 1e-4).
SP_FP32 = [*GRID_FP32, "--limit_train_samples", "160",
           "--limit_eval_samples", "32"]
SP_RUNS = {
    "gpt2": ("[sp gpt2]", ["--mesh_shape", "data=1,seq=2",
                           "--sequence_parallel", "ring_zigzag"],
             ["--limit_train_samples", "320", "--limit_eval_samples", "64",
              "--probe_batches", "1"]),
    "bert": ("[sp bert]", ["--mesh_shape", "data=1,seq=2",
                           "--sequence_parallel", "all_to_all"], GRID_CUT),
}
# [sp attn]: the three functions on 2 processes at the gpt2 path's causal
# shape and the llama path's grouped one, (label, B, L, H, KV, D), each
# against the dense attention on the whole sequence at these fractions of
# max |dense| (bf16: rounding of the outputs and gradients; fp32 with TF32
# off: the same terms summed in another order)
SP_ATTN_SHAPES = [("gpt2", PATH_BATCH, PATH_LEN, 12, 12, 64),
                  ("llama", PATH_BATCH, PATH_LEN, 16, 4, 64)]
SP_ATTN_TOL = {"bfloat16": 5e-2, "float32": 1e-5}
# the device and enhanced_cnn width of the module checks' ranks
GRID_CHECK_DEVICE, GRID_CHECK_WIDTH = "cuda", 64
SP_PHASE = "sp"                 # the 2-process phases alone (sp and pp)
PP_PHASE = "pp"                 # the same
EP_PHASE = "ep"                 # the same
# phase pp gpt2: the gpt2 path as two pipeline stages (data=1,pipe=2: 6 of
# the 12 blocks a stage, the embeddings on stage 0, the head and the loss
# on stage 1) on 2 processes of the card, flash attention.  Every stage
# hop stages through pinned host memory, so the numbers measure the
# staging, not the speed of pipeline parallelism.  The fp32 pairs: one
# round of 2 steps (M = 2, microbatch [32,128]) under each schedule
# against the data=1 twin; the bf16 runs: M = 4 (microbatch [16,128]), one
# probe batch and 256 training sequences (4 steps).  The one-step module
# checks run full-width fp32 on 8 sequences (M = 2); the toy schedule
# checks on JAX tests/test_pp.py's tanh stages.
PP_MESH = ["--mesh_shape", "data=1,pipe=2"]
PP_STAGES, PP_STAGE_LAYERS = 2, 6
PP_SCHEDULES = ("gpipe", "1f1b")
PP_FP32 = SP_FP32
PP_CUT = ["--limit_train_samples", "320", "--limit_eval_samples", "64",
          "--probe_batches", "1", "--pp_microbatches", "4"]
# a stage's parameters: 6 blocks of 7,087,872 and the 1,555,968 every stage
# holds (the token and position tables, ln_f), of the worker's 86,610,432
PP_RANK_PARAMS, GPT2_PARAMS = 44_083_200, 86_610_432
PP_MODULE_BATCH = 8
PP_TOY_ATOL = 1e-5              # fp32, TF32 off: the same sums in order
# phase ep moe: the moe path (bert_base, 8 experts) at data=1,expert=2 on
# 2 processes of the card, flash attention: each rank holds 4 of the 8
# experts of every layer and runs the whole attention of the whole batch
# (routing and attention are replicated along expert); every MoE layer's
# output, and the gradients of its tokens and gate, are summed over the
# expert line through pinned host memory, so the numbers measure the
# staging, not the speed of expert parallelism.  The fp32 pair: one round
# of 2 steps against the data=1 twin; the bf16 run: one probe batch and
# 512 training sequences (8 steps: the loss falls slowly at lr 1e-4).  The
# one-step module check runs full-width fp32 on 8 sequences.
EP_MESH = ["--mesh_shape", "data=1,expert=2"]
EP_RANKS = 2
EP_MODULE_BATCH = 8
# each rank's aux loss (summed over the 12 layers, ~12) against the dense
# twin's over the same tokens: fp32, the MoE outputs summed in another order
EP_AUX_ATOL = 1e-4
# phase sanitize: each path cut to 2 rounds of a few steps (argparse keeps
# a flag's last value)
_SMALL = ["--epochs_global", "2", "--epochs_local", "1", "--probe_batches",
          "1", "--checkpoint_dir", "", "--checkpoint_every", "0"]
SANITIZE_RUNS = {
    "cnn": [*CNN_ARGV, *_SMALL, "--limit_train_samples", "640",
            "--limit_eval_samples", "128"],
    **{name: [*PATHS[name][0], *_SMALL, "--limit_train_samples",
              "160" if name == "vit" else "320", "--limit_eval_samples",
              "64"] for name in ("gpt2", "llama", "bert", "vit", "moe")}}
SANITIZE_CLEAN = ("cnn", "gpt2")          # the gate: no implicit sync
PROFILE_DIR = os.path.join(OUT_DIR, "profile_dir")
# phase memory: the programs every run registers
MEMORY_PROGRAMS = {
    "cnn": {"train_step", "eval_step", "sync"},
    "gpt2": {"train_step", "eval_step", "sync"},
    "sim cnn n8": {"sim_step", "sim_eval", "sim_blend"},
    "serve gpt2": {"decode_step", "prefill"},
}
MFU_LINEAR = (512, 1024, 4096)   # M, K, N of the count's one-layer gate
MFU_RTOL = 1e-6
# filled by the phases: the memory rows and the train steps whose MFU the
# mfu phase reports
MEMORY_ROWS: dict = {}
REMAT_TEMP: dict = {}
MFU_RUNS: dict = {}

# (label, B, L, H, KV, D, causal); "main" is the gpt2 path's shape,
# "llama_path" the llama path's, "bert_path" the bert and moe paths'
# (bidirectional), "vit_path" the vit path's (bidirectional, 196 = 3 x 64
# + 4: a ragged last tile) and "draft_path" the draft's (head_dim 32)
SHAPES = [
    ("main", PATH_BATCH, PATH_LEN, 12, 12, 64, True),
    ("L2048_causal", 4, 2048, 12, 12, 64, True),
    ("L2048", 4, 2048, 12, 12, 64, False),
    ("gqa_llama_medium", 2, 1024, 16, 4, 64, True),
    ("llama_path", PATH_BATCH, PATH_LEN, 16, 4, 64, True),
    ("bert_path", PATH_BATCH, PATH_LEN, 12, 12, 64, False),
    ("vit_path", PATH_BATCH, 196, 6, 6, 64, False),
    ("draft_path", PATH_BATCH, PATH_LEN, 4, 4, 32, True),
    # the gpt2 path's shape with --sim_workers 4 folded into the batch
    ("sim_path", 4 * PATH_BATCH, PATH_LEN, 12, 12, 64, True),
    # the rank grid's head shards: gpt2 at tp 2, llama at tp
    # 2 (8 query heads over 2 K/V heads, groups of 4), bert at fsdp 2 x tp
    # 2 (half the batch, half the heads)
    ("tp_gpt2", PATH_BATCH, PATH_LEN, 6, 6, 64, True),
    ("tp_llama", PATH_BATCH, PATH_LEN, 8, 2, 64, True),
    ("tp_fsdp_bert", PATH_BATCH // 2, PATH_LEN, 6, 6, 64, False),
    # a pipeline stage's microbatch: gpt2 at pipe 2, --pp_microbatches 4
    ("pp_gpt2", PATH_BATCH // 4, PATH_LEN, 12, 12, 64, True),
]
# shapes whose numbers every kernel's JSON row carries beside its path's
ROW_SHAPES = ("bert_path", "vit_path", "draft_path", "sim_path", "tp_gpt2",
              "tp_llama", "tp_fsdp_bert", "pp_gpt2")
TP_SHAPES = ("tp_gpt2", "tp_llama", "tp_fsdp_bert")
# Tolerances, as max |kernel - plain| / max |plain| on bf16 inputs (the
# plain version computes in fp32 on the same bf16 values).  O and the
# gradients are rounded to bf16 (relative spacing 2^-8) after fp32
# accumulation in a different order: 1e-2 for O, 2e-2 for the gradients,
# whose terms are larger products.  The fused kernel's dq is summed by
# fp32 atomics whose order changes from run to run; it is rounded to bf16
# once, so the same 2e-2 holds.  lse stays fp32 end to end: 1e-3 absolute.
TOL_O, TOL_GRAD, TOL_LSE = 1e-2, 2e-2, 1e-3
# kernel -> (source, TPU kernel it replaces, the path and shape its JSON
# row reports, design of its bf16 instance: "wgmma" (wgmma on TMA-fed
# shared memory, csrc/flash_sm90.cuh; check_tensor_cores also takes
# "tensor-core": HMMA or HGMMA))
KERNELS = {
    "flash_fwd": ("csrc/flash_fwd.cu", "ops/pallas_ops.py:66", "gpt2",
                  "main", "wgmma"),
    "flash_bwd_dq": ("csrc/flash_bwd.cu", "ops/pallas_ops.py:192", "gpt2",
                     "main", "wgmma"),
    "flash_bwd_dkv": ("csrc/flash_bwd.cu", "ops/pallas_ops.py:235", "gpt2",
                      "main", "wgmma"),
    "flash_bwd_fused": ("csrc/flash_bwd_fused.cu", "ops/pallas_ops.py:290",
                        "llama", "llama_path", "wgmma"),
}
# kernel -> (its library in ops/_build.py, a name its device functions
# carry); a bf16 instance has __nv_bfloat16 in its mangled name
SASS_SYMBOLS = {"flash_fwd": ("flash_fwd", "fwd_kernel"),
                "flash_bwd_dq": ("flash_bwd", "bwd_dq_kernel"),
                "flash_bwd_dkv": ("flash_bwd", "bwd_dkv_kernel"),
                "flash_bwd_fused": ("flash_bwd_fused", "bwd_fused_kernel")}
TENSOR_CORE_OP = re.compile(r"\bHG?MMA(?:\.\w+)+")
TMA_OP = re.compile(r"\bUTMA(?:LDG|STG)\b")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


PR_SET_CHILD_SUBREAPER = 36     # prctl option (linux/prctl.h)


def _adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts (an
    attribute of this process alone): a process whose parent exits before
    it is handed to this one rather than to init, so ``_stop_leftovers``
    still finds it however it was started (a new session included)."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _processes() -> dict[int, tuple[str, int, int, str]]:
    """Every process /proc shows: pid -> (state, parent pid, process
    group, command line)."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # the command's name may hold spaces: the fields follow its last ")"
        state, ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        out[int(entry)] = (state, int(ppid), int(pgrp),
                           cmd.strip()[:200] or stat[:stat.rindex(")") + 1])
    return out


def _descendants() -> dict[int, tuple[str, int, int, str]]:
    """The processes below this one (``_processes``' rows)."""
    procs, me = _processes(), os.getpid()
    mine = {}
    for pid in procs:
        up, seen = procs[pid][1], {pid}
        while up in procs and up not in seen and up != me:
            seen.add(up)
            up = procs[up][1]
        if up == me:
            mine[pid] = procs[pid]
    return mine


def _reap(pids, until: float) -> None:
    """Collect the exit status of those of ``pids`` that are this
    process's children, waiting for them until the time ``until``."""
    pids = set(pids)
    while pids and time.time() < until:
        for pid in list(pids):
            try:
                done, _status = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:   # not a child, or reaped already
                done = pid
            if done:
                pids.discard(pid)
        if pids:
            time.sleep(0.02)


def _stop_leftovers() -> list[str]:
    """Stop every process below this one that still runs, so that the
    script leaves none behind: each is killed and reaped, then
    multiprocessing's resource tracker (which ignores SIGTERM and ends
    when the last process holding its pipe is gone) is stopped and
    reaped.  Returns what was found running, one line each."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    me = os.getpid()
    found = {pid: row for pid, row in _descendants().items()
             if pid != tracker._pid}
    left = [f"pid {pid} (parent {row[1]}, state {row[0]}): {row[3]}"
            for pid, row in sorted(found.items()) if row[0] != "Z"]
    for pid, row in found.items():
        if row[0] != "Z":
            try:
                os.kill(pid, 9)
            except (ProcessLookupError, PermissionError):
                pass
    deadline = time.time() + 10
    while time.time() < deadline:
        rest = {pid: row for pid, row in _descendants().items()
                if pid != tracker._pid}
        if not rest:
            break
        for pid, row in rest.items():   # killed in turn once orphaned
            if row[1] == me and row[0] != "Z":
                try:
                    os.kill(pid, 9)
                except ProcessLookupError:
                    pass
        _reap([pid for pid, row in rest.items() if row[1] == me],
              time.time() + 0.2)
    if tracker._pid is not None and tracker._fd is not None:
        os.close(tracker._fd)           # the tracker ends on its own
        tracker._fd = None
        _reap([tracker._pid], time.time() + 10)
        if tracker._pid in _descendants():
            os.kill(tracker._pid, 9)
            _reap([tracker._pid], time.time() + 5)
        tracker._pid = None
    return left


def _end_session(proc, what: str, grace_s: float = 5.0) -> None:
    """After ``proc`` (started with ``start_new_session``) has exited:
    give what is left of its process group ``grace_s`` to exit (a rank's
    or a resource tracker's last moments), then name and kill the rest."""
    proc.wait()
    deadline = time.time() + grace_s
    while True:
        rest = {pid: row for pid, row in _processes().items()
                if row[2] == proc.pid and row[0] != "Z"}
        if not rest or time.time() >= deadline:
            break
        time.sleep(0.05)
    for pid, row in sorted(rest.items()):
        print(f"{what}: pid {pid} (parent {row[1]}) outlived the process "
              f"that started it and is killed: {row[3]}", flush=True)
    if rest:
        try:
            os.killpg(proc.pid, 9)
        except (ProcessLookupError, PermissionError):
            pass


def _peak_reset() -> None:
    """Start a process-peak window (the port's probe: its programs' memory
    rows reset the card's peak statistic, and the probe keeps the running
    maximum across those resets)."""
    import torch
    from importlib import import_module
    import_module(f"{PKG}.probe").reset_peak_memory_stats(
        torch.device("cuda"))


def _peak() -> int:
    """The process's peak allocation since ``_peak_reset``."""
    import torch
    from importlib import import_module
    return import_module(f"{PKG}.probe").max_memory_allocated(
        torch.device("cuda"))


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
    tensor-core instructions (HMMA, HGMMA) and TMA copies (UTMALDG,
    UTMASTG) in it, sorted."""
    ops: dict[str, set] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            name = head.group(1)
            ops[name] = set()
        elif name is not None:
            ops[name].update(TENSOR_CORE_OP.findall(line))
            ops[name].update(TMA_OP.findall(line))
    return {n: sorted(found) for n, found in ops.items()}


def check_tensor_cores(sass_by_library: dict[str, str]) -> dict[str, bool]:
    """kernel -> whether every bf16 instance of it runs tensor-core
    instructions; fails if a kernel designed for the tensor cores has no
    bf16 instance or one without them, and if a kernel designed for wgmma
    has a bf16 instance (D = 32, 64 or 128) without HGMMA or without the
    TMA loads (UTMALDG) that feed it."""
    result = {}
    for kernel, (library, symbol) in SASS_SYMBOLS.items():
        design = KERNELS[kernel][4]
        found = {n: o for n, o in tensor_core_ops(
            sass_by_library[library]).items()
                 if symbol in n and "__nv_bfloat16" in n}
        for fn, ops in sorted(found.items()):
            print(f"[build] sass {kernel} ({design}) {fn[:70]}: "
                  f"{' '.join(ops) or 'no tensor-core instruction'}")
        mma = {fn: [o for o in ops if "MMA" in o] for fn, ops in found.items()}
        result[kernel] = bool(found) and all(mma.values())
        if not result[kernel]:
            fail(f"{kernel} is designed for the tensor cores but its bf16 "
                 f"instances {sorted(found) or '(none found)'} hold no "
                 f"HMMA/HGMMA instruction")
        if design == "wgmma":
            lacking = sorted(
                fn for fn, ops in found.items()
                if not any(o.startswith("HGMMA") for o in ops)
                or "UTMALDG" not in ops)
            if lacking:
                fail(f"{kernel} is designed for wgmma on TMA-fed shared "
                     f"memory but its bf16 instances {lacking} hold no "
                     f"HGMMA or no UTMALDG instruction")
        # the draft's head_dim (the template argument D=32 mangles as
        # Li32E); the rules above already fail on any bf16 instance
        # without tensor-core instructions, this one among them
        d32 = [ops for fn, ops in found.items() if "Li32E" in fn]
        print(f"[build] sass {kernel} D=32 bf16 instance(s): "
              + ("; ".join(' '.join(o) or 'no tensor-core instruction'
                           for o in d32) or "none found"))
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


def kernel_work(b, l, h, kv, d, causal) -> dict:
    """kernel -> (bytes, FLOPs) each function must move and do at this
    shape (causal: the visible pairs), each input read once and each output
    written once in its own dtype: the fused kernel's fp32 dq accumulator
    is its design, not the work."""
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    qb, kvb, rowb = b * l * h * d * 2, b * l * kv * d * 2, b * h * l * 4
    return {"flash_fwd": (2 * qb + 2 * kvb + rowb, 4 * pairs * d),
            "flash_bwd_dq": (3 * qb + 2 * kvb + 2 * rowb, 6 * pairs * d),
            "flash_bwd_dkv": (2 * qb + 4 * kvb + 2 * rowb, 8 * pairs * d),
            "flash_bwd_fused": (3 * qb + 4 * kvb + 2 * rowb,
                                10 * pairs * d)}


def _fused_outputs(q, k, v, whole: bool) -> tuple:
    """The fused kernel's dq, dk, dv: dq in q's dtype where the kernel
    writes it whole, else a zero-filled fp32 accumulator."""
    import torch
    dq = (torch.empty_like(q) if whole
          else torch.zeros(q.shape, dtype=torch.float32, device=q.device))
    return dq, torch.empty_like(k), torch.empty_like(v)


def _fused_kernel_alone(fl, q, k, v, do, lse, delta, causal, fn=None,
                        whole_keys=None):
    """A call that launches the fused kernel alone, into outputs allocated
    once: dq in q's dtype where the kernel writes it whole (Lk <=
    ``whole_keys``, the tree's ``flash_bwd_fused_whole_keys``; this tree's
    by default), else an fp32 accumulator zero-filled once (each launch
    adds into it again: the values grow, the work does not change).  ``fn``
    is another tree's C entry point (this tree's wrapper by default)."""
    whole = (fl.fused_dq_whole(q, k) if whole_keys is None
             else k.shape[1] <= whole_keys)
    dq, dk, dv = _fused_outputs(q, k, v, whole)
    if fn is None:
        return lambda: fl.launch_bwd_fused(q, k, v, do, lse, delta, dq, dk,
                                           dv, causal)
    return lambda: fl._check(fn(*fl._fused_args(
        q, k, v, do, lse, delta, dq, dk, dv, causal)), "flash_bwd_fused")


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

    work = kernel_work(b, l, h, kv, d, causal)
    iters = 20 if l <= 128 else 5
    fused_alone = _fused_kernel_alone(fl, q, k, v, do, lse_ref, delta, causal)
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
            fused_alone,
            lambda: fl.plain_bwd_fused(q, k, v, do, lse_ref, delta, causal)),
    }
    # the fused wrapper whole: where dq is not written whole, the fp32
    # accumulator's zero-fill and the cast beside the kernel
    fused_wrapper_ms = cuda_ms(
        lambda: fl.kernel_bwd_fused(q, k, v, do, lse_ref, delta, causal), iters)
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
            shape=[b, l, h, kv, d, causal], design=KERNELS[name][4])
        r = rows[name]
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        wrapper = ""
        if name == "flash_bwd_fused":
            r["wrapper_ms"] = fused_wrapper_ms
            wrapper = (f" wrapper_ms {fused_wrapper_ms:.4f} (dq "
                       f"{'whole' if fl.fused_dq_whole(q, k) else 'fp32 accumulator, zero-fill and cast'})")
        print(f"[kernels] {label} [B={b} L={l} H={h} KV={kv} D={d} "
              f"causal={causal}] {name} ({r['design']}): kernel_ms "
              f"{r['ms']:.4f} (host-paced "
              f"{r['paced_ms']:.4f}){wrapper} plain_ms "
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


def check_losses(name: str, results: dict) -> tuple[float, float]:
    """Fail unless a path's losses are finite, its last-epoch train loss is
    below its first batch's, and its test evaluation is finite; returns
    (first-batch loss, last-epoch loss)."""
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
    ev = results["test_eval"]
    if not (math.isfinite(ev["loss"]) and math.isfinite(ev["accuracy"])):
        fail(f"{name}: non-finite test evaluation {ev}")
    return first, last


def drive(tag: str, argv: list[str], layers: int):
    """main.run(argv) with the launch counters reset just before and read
    just after; fails unless every kernel launched exactly layers x its
    passes.  A pass is a forward (train step, probe pass, validation or
    evaluation batch) or a backward (train step, probe pass); a train step
    runs one of each per --grad_accum microbatch, and a remat policy other
    than none runs each forward of a pass with a backward twice (the
    backward recomputes it).  Returns (counts, results, wall s, peak
    bytes)."""
    import torch
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    main = import_module(f"{PKG}.main")
    cfg = import_module(f"{PKG}.config").config_from_args(argv)
    _peak_reset()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    results = main.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fl.LAUNCHES)
    peak = _peak()

    rt = results["round_timings"]
    train_steps = sum(r["train_steps"] for r in rt)
    val_steps = sum(r["val_steps"] for r in rt)
    eval_batches = -(-len(results["test"].labels) // cfg.batch_size)
    probe_passes = 1 + cfg.probe_batches        # warm-up + timed
    remat = cfg.remat_policy != "none"
    grad_passes = probe_passes + train_steps * cfg.grad_accum
    fwd = layers * (grad_passes * (2 if remat else 1) + val_steps
                    + eval_batches)
    bwd = layers * grad_passes
    fused = fl._use_fused_bwd()
    expect = {"flash_fwd": fwd,
              "flash_bwd_dq": 0 if fused else bwd,
              "flash_bwd_dkv": 0 if fused else bwd,
              "flash_bwd_fused": bwd if fused else 0}
    print(f"{tag} launches {counts}; expected {expect} ({layers} layers; "
          f"{train_steps} train steps x {cfg.grad_accum} microbatch(es), "
          f"{val_steps} val steps, {eval_batches} eval batches, "
          f"{probe_passes} probe passes; remat {cfg.remat_policy}: forward "
          f"x{2 if remat else 1} where a backward follows; "
          f"FLASH_BWD={'fused' if fused else 'two-pass'})")
    if counts != expect or not all(counts[n] > 0 for n in expect
                                   if expect[n]):
        fail(f"{tag}: launch counts {counts} do not match the path's "
             f"{expect}")
    results["smoke_wall_s"], results["smoke_peak_bytes"] = wall, peak
    return counts, results, wall, peak


def _set_attention(model, impl: str) -> None:
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl


def _set_compute_dtype(model, dtype) -> None:
    """Every module's compute dtype (the parameters stay fp32)."""
    import torch
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def flash_vs_dense(name: str, model, x):
    """The trained model's flash logits against its dense logits (the
    port's reference attention) on the 4 test inputs ``x``, at the path's
    bf16 compute.  With experts the top-1 routing is discrete: a token
    whose two best gate scores lie within bf16 rounding of each other may
    take another expert under dense attention, and then its logits differ
    by design.  So the moe path holds every layer's attention output of
    the trained model, flash against dense on the same captured bf16
    inputs, and the logits in fp32 compute (the kernels' fp32 instance),
    where such ties are far below the rounding.  Returns the flash
    logits."""
    import torch
    with torch.no_grad():
        if getattr(model, "num_experts", 0):
            inputs = []
            attns = [b.attn for b in model.blocks]
            hooks = [a.register_forward_hook(
                lambda m, inp, out: inputs.append(inp[0])) for a in attns]
            model(x)
            for h in hooks:
                h.remove()
            worst = 0.0
            for a, inp in zip(attns, inputs):
                a.attention_impl = "dense"
                dense = a(inp)
                a.attention_impl = "flash"
                _, rel = _err(a(inp), dense)
                worst = max(worst, rel)
            print(f"[{name}] flash vs dense attention outputs of all "
                  f"{len(attns)} layers on the trained model's bf16 inputs "
                  f"(4 test sequences): worst max abs err / max |dense| "
                  f"{worst:.3g}")
            if not (math.isfinite(worst) and worst <= 5e-2):
                fail(f"{name}: flash and dense attention outputs disagree "
                     f"beyond bf16 tolerance 5e-2")
            dtype = model.dtype
            _set_compute_dtype(model, torch.float32)
            label = "fp32 compute"
        else:
            label = "bf16 compute"
        flash_logits = model(x)
        _set_attention(model, "dense")
        dense_logits = model(x)
        _set_attention(model, "flash")
        if getattr(model, "num_experts", 0):
            _set_compute_dtype(model, dtype)
    e, rel = _err(flash_logits, dense_logits)
    print(f"[{name}] flash vs dense logits on 4 test inputs ({label}, "
          f"shape {tuple(flash_logits.shape)}): max abs err {e:.4g} "
          f"({rel:.3g} of max |dense|)")
    if not (math.isfinite(e) and rel <= 5e-2):
        fail(f"{name}: flash and dense logits disagree beyond tolerance "
             f"5e-2")
    return flash_logits


def moe_routing(model, x) -> None:
    """The moe path's routing on one train-size batch ``x`` of the trained
    model: each layer's Switch aux loss E * sum_e f_e P_e (1 at a uniform
    gate or perfect balance; at least 1/E in any case) and its share of
    dropped tokens."""
    import torch
    from importlib import import_module
    moe_cls = import_module(f"{PKG}.models.moe").MoEFFN
    stats = []

    def record(m, inp, out):
        toks = inp[0].reshape(-1, inp[0].shape[-1])
        probs, onehot, _, keep, cap = m.route(toks)
        aux = m.num_experts * (onehot.mean(0) * probs.mean(0)).sum()
        stats.append((aux.item(), 1.0 - keep.mean().item(), cap,
                      onehot.sum(0).tolist()))

    moes = [m for m in model.modules() if isinstance(m, moe_cls)]
    hooks = [m.register_forward_hook(record) for m in moes]
    with torch.no_grad():
        _, aux_total = model(x, with_aux=True)
    for h in hooks:
        h.remove()
    for i, (aux, drop, cap, load) in enumerate(stats):
        print(f"[moe] layer {i}: aux {aux:.4f}, dropped {100 * drop:.2f}% "
              f"of {x.shape[0] * x.shape[1]} tokens (capacity {cap}), "
              f"tokens per expert {[int(n) for n in load]}")
    auxes = [a for a, *_ in stats]
    print(f"[moe] aux summed over {len(stats)} layers {aux_total.item():.4f}"
          f" (the engine adds 0.01 x this); per layer {min(auxes):.4f} to "
          f"{max(auxes):.4f}; all >= 1: {all(a >= 1 for a in auxes)}")
    if len(stats) != len(model.blocks) or not all(
            math.isfinite(a) and a >= 1.0 / MOE_EXPERTS - 1e-6
            for a in auxes):
        fail(f"moe: aux losses {auxes} not finite or below 1/E")
    if not math.isclose(aux_total.item(), sum(auxes), rel_tol=1e-4):
        fail(f"moe: the model's summed aux {aux_total.item()} is not the "
             f"sum of its layers' {sum(auxes)}")


def run_path(name: str) -> tuple[dict, dict]:
    """Drive one path through main.run (``drive``); check the losses and
    the flash logits against the dense ones; print the step time, the rate
    and memory."""
    import numpy as np
    import torch
    from importlib import import_module
    train = import_module(f"{PKG}.train")
    argv, layers = PATHS[name]
    counts, results, wall, peak = drive(f"[{name}]", argv, layers)
    rt = results["round_timings"]
    train_steps = sum(r["train_steps"] for r in rt)
    if train_steps < 16:
        fail(f"{name} path ran only {train_steps} train steps")
    first, last = check_losses(name, results)

    model = results["model"]
    test = results["test"]
    device = next(model.parameters()).device
    x = train.to_device(np.asarray(test.images[:4]), device)
    logits = flash_vs_dense(name, model, x)
    tokens = x.ndim == 2
    want = ((4, x.shape[1], test.num_classes) if tokens
            else (4, test.num_classes))
    if tuple(logits.shape) != want:
        fail(f"{name}: logits shape {tuple(logits.shape)}, expected {want}")
    if getattr(model, "num_experts", 0):
        moe_routing(model, train.to_device(
            np.asarray(test.images[:PATH_BATCH]), device))

    train_ms = sum(r["train_ms"] for r in rt)
    step_ms = train_ms / train_steps
    per_step = PATH_BATCH * (x.shape[1] if tokens else 1)
    rate = train_steps * per_step / (train_ms / 1e3)
    params = sum(p.numel() for p in model.parameters())
    MFU_RUNS[name] = dict(argv=argv, num_classes=test.num_classes,
                          example=list(test.images.shape[1:]),
                          tokens=tokens, step_ms=step_ms, workers=1)
    if name == "gpt2":
        MEMORY_ROWS[name] = results["memory"]
    print(f"[{name}] {params:,} params; wall {wall:.1f} s; train step "
          f"{step_ms:.3f} ms; {rate:.0f} {'tokens' if tokens else 'images'}"
          f"/s; first-batch loss {first:.4f} -> last-epoch mean {last:.4f}; "
          f"val loss {results['global_val_losses'][-1]:.4f}; test loss "
          f"{results['test_eval']['loss']:.4f}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    return counts, results


def _recording_inits(t_driver, inits: list):
    """``t_driver.build_model_for``, recording a float host copy of each
    model's state_dict as it is built (the run's initial parameters; on
    the host, so the train steps' peak memory holds none of it)."""
    import torch
    build = t_driver.build_model_for

    def spy(*args, **kwargs):
        model = build(*args, **kwargs)
        inits.append({k: v.detach().to("cpu", torch.float32, copy=True)
                      for k, v in model.state_dict().items()})
        return model
    return spy


def phase_remat(policies: list[str]) -> None:
    """The bert path at 4 train steps under each remat policy of
    ``policies`` (the first is none) and under --grad_accum 4, in this
    process: launches (checked by ``drive``), and the step ms and peak
    memory of one more round of each trained model; every policy's batch
    losses against none's (REMAT_LOSS_RTOL); K=4 against K=1 (none): the
    initial parameters bitwise, then the batch losses and the parameters'
    updates from those initial parameters (ACCUM_*)."""
    import torch
    from importlib import import_module
    from unittest import mock
    t_driver = import_module(f"{PKG}.driver")
    t0 = time.perf_counter()
    runs, params, inits = {}, {}, {}
    variants = [(f"remat {p}", ["--remat_policy", p]) for p in policies]
    variants.append((f"grad_accum {GRAD_ACCUM}",
                     ["--grad_accum", str(GRAD_ACCUM)]))
    for label, extra in variants:
        argv = [*REMAT_ARGV, *extra, "--out_dir",
                os.path.join(OUT_DIR, "remat")]
        built = []
        with mock.patch.object(t_driver, "build_model_for",
                               _recording_inits(t_driver, built)):
            _, results, wall, peak = drive(f"[remat] {label}", argv,
                                           PATHS["bert"][1])
        if len(built) != 1:
            fail(f"remat {label}: the run built {len(built)} models")
        rt = results["round_timings"]
        steps = sum(r["train_steps"] for r in rt)
        step_ms = sum(r["train_ms"] for r in rt) / steps
        losses = results["all_workers_losses"][0]
        if steps != 4 or not all(math.isfinite(v) for v in losses):
            fail(f"remat {label}: {steps} train steps, losses {losses}")
        if label in ("remat none", f"grad_accum {GRAD_ACCUM}"):
            inits[label] = built[0]
            params[label] = {
                k: v.detach().to("cpu", torch.float32, copy=True)
                for k, v in results["model"].state_dict().items()}
        # the train step's own peak and pace: one more round of the
        # trained model (the run's peak also holds the probe's full-batch
        # pass, which --grad_accum does not split), after a warm-up round
        _, one_round = steady_round(results, argv)
        one_round()
        torch.cuda.synchronize()
        _peak_reset()
        mx = one_round()[1]
        step_peak = _peak()
        steady_ms = mx["train_ms"] / mx["train_steps"]
        print(f"[remat] {label}: run's train step {step_ms:.3f} ms, run's "
              f"max_memory_allocated {peak / 2**30:.3f} GiB; steady round: "
              f"train step {steady_ms:.3f} ms, max_memory_allocated "
              f"{step_peak / 2**30:.3f} GiB; batch losses "
              f"{[round(v, 6) for v in losses]}; wall {wall:.1f} s")
        runs[label] = dict(step_ms=steady_ms, peak=step_peak, losses=losses)
        REMAT_TEMP[label] = results["memory"]["programs"]["train_step"][0][
            "temp_bytes"]
        del results
        torch.cuda.empty_cache()
    base = runs["remat none"]["losses"]
    for p in policies[1:]:
        got = runs[f"remat {p}"]["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(got, base))
        print(f"[remat] {p} vs none: batch losses differ by {worst:.3g} of "
              f"their value at most (tolerance {REMAT_LOSS_RTOL})")
        if not worst <= REMAT_LOSS_RTOL:
            fail(f"remat {p}: losses {got} differ from none's {base}")
    k = f"grad_accum {GRAD_ACCUM}"
    init, init_k = inits["remat none"], inits[k]
    if init.keys() != init_k.keys() or not all(
            torch.equal(init[n], init_k[n]) for n in init):
        fail(f"grad_accum: K={GRAD_ACCUM} and K=1 start from different "
             "parameters")
    got = runs[k]["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, base))
    num = den = 0.0
    k1, kk = params["remat none"], params[k]
    max_err = 0.0
    for name, p0 in init.items():
        u1, uk = k1[name] - p0, kk[name] - p0
        num += float((uk - u1).square().sum())
        den += float(u1.square().sum())
        max_err = max(max_err, float((uk - u1).abs().max()))
    rel = math.sqrt(num / den)
    print(f"[grad_accum] K={GRAD_ACCUM} vs K=1 from bitwise-equal initial "
          f"parameters: batch losses differ by {worst:.3g} of their value "
          f"at most (tolerance {ACCUM_LOSS_RTOL}); parameter updates after "
          f"4 Adam steps differ by {rel:.4f} in relative L2 norm "
          f"(tolerance {ACCUM_UPDATE_RTOL}), max abs {max_err:.3g}; "
          f"train-step peak {runs['remat none']['peak'] / 2**30:.3f} GiB at "
          f"K=1, {runs[k]['peak'] / 2**30:.3f} GiB at K={GRAD_ACCUM}")
    if not (worst <= ACCUM_LOSS_RTOL and rel <= ACCUM_UPDATE_RTOL):
        fail(f"grad_accum: K={GRAD_ACCUM} departs from K=1 beyond the "
             f"stated tolerances")
    print(f"[remat] phase wall {time.perf_counter() - t0:.1f} s")


def steady_round(results, argv: list[str]):
    """An engine over the trained model of a path's run (``argv``: the
    path's, one local epoch) and a callable that runs one more round of
    PROFILE_STEPS train steps and 1 validation step on its test set."""
    import numpy as np
    from importlib import import_module
    cfg = import_module(f"{PKG}.config").config_from_args(
        [*argv, "--epochs_local", "1"])
    train = import_module(f"{PKG}.train")
    device = next(results["model"].parameters()).device
    engine = train.LocalSGDEngine(results["model"], cfg, device)
    state = results["state"]
    test = results["test"]
    n = PROFILE_STEPS * PATH_BATCH
    steps = (1, PROFILE_STEPS, PATH_BATCH)
    pack = (test.images[:n].reshape(steps + test.images.shape[1:]),
            test.labels[:n].reshape(steps + test.labels.shape[1:]),
            np.ones(steps, np.float32))
    val = tuple(a[:, :1] for a in pack)
    return engine, lambda: engine.round(state, pack, val)


def phase_profile(name: str, results, argv: list[str]) -> None:
    """Where a train step's device time goes: one more round of
    PROFILE_STEPS train steps of the trained model under torch.profiler,
    after the path's counts were read (``argv``: the path's).  Prints
    device time by kernel and the device's busy share of the round's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    engine, one_round = steady_round(results, argv)
    profile_window(f"[profile {name}]",
                   f"{PROFILE_STEPS} train steps + 1 val step", one_round,
                   engine.device)


def profile_window(tag: str, what: str, fn, device, trace: str = "",
                   top: int = 20) -> None:
    """``fn`` once to warm up, then once under torch.profiler: prints the
    window's wall, the device's busy and idle share, and device time by
    kernel (the ``top`` rows); with ``trace``, writes the Chrome trace
    there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # late in a long process the tracer has dropped a window's first
        # device events (a round's input copy comes first): open the
        # window after a kernel and a pause
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace:
        prof.export_chrome_trace(trace)
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
    print(f"{tag} {what}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%; "
          f"{sum(e.count for e in rows)} device kernels")
    for e in rows[:top]:
        print(f"{tag} {dev_us(e) / 1e3:9.3f} ms "
              f"{100 * dev_us(e) / busy:5.1f}% x{e.count:<5d} {e.key[:100]}")


def h2d_copies(tag: str, trace: str) -> dict:
    """The host-to-device copies in a profiler Chrome trace: count, bytes,
    device ms, kind (pageable or pinned), their streams, how much of their
    time overlaps compute kernels on other streams, and the host time each
    thread spent in ``cudaMemcpyAsync`` (a pageable copy blocks its
    caller for the whole transfer)."""
    with open(trace) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    host: dict = {}
    for e in events:
        if (e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaMemcpyAsync"):
            host[e.get("tid")] = host.get(e.get("tid"), 0.0) + e["dur"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    spans: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            spans.setdefault(e.get("args", {}).get("stream"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    overlap = 0.0
    for c in copies:
        lo, hi = c["ts"], c["ts"] + c["dur"]
        cover = sorted((max(a, lo), min(b, hi))
                       for st, iv in spans.items()
                       if st != c.get("args", {}).get("stream")
                       for a, b in iv if a < hi and b > lo)
        end = lo
        for a, b in cover:           # the union of the covering kernels
            if b > end:
                overlap += b - max(a, end)
                end = b
    out = dict(n=len(copies),
               mb=sum(c.get("args", {}).get("bytes", 0) for c in copies)
               / 1e6,
               ms=sum(c["dur"] for c in copies) / 1e3,
               kinds=sorted({c["name"] for c in copies}),
               streams=sorted({str(c.get("args", {}).get("stream"))
                               for c in copies}),
               compute_streams=sorted(str(st) for st in spans),
               overlap_ms=overlap / 1e3,
               host_ms=sorted((v / 1e3 for v in host.values()),
                              reverse=True))
    print(f"{tag} H2D copies: {out['n']}, {out['mb']:.1f} MB, "
          f"{out['ms']:.3f} device ms; {', '.join(out['kinds'])}; on "
          f"stream(s) {', '.join(out['streams'])} (compute kernels on "
          f"{', '.join(out['compute_streams'])}); {out['overlap_ms']:.3f} "
          f"ms of them overlapped compute kernels on other streams; host ms "
          f"in cudaMemcpyAsync per thread "
          f"{[round(v, 3) for v in out['host_ms']]}")
    return out


def phase_stream_vit(plain: dict) -> dict:
    """Phase stream vit: the vit path with STREAM_ARGV against the plain vit
    run of this call (``plain``: its batch losses, final parameters on the
    host, launches, step ms, train wall and peak), bit for bit; then where
    its copies run.  Returns the launches."""
    import torch
    argv = [*PATHS["vit"][0][:-1], os.path.join(OUT_DIR, "stream_vit"),
            *STREAM_ARGV]
    counts, results, wall, peak = drive("[stream vit]", argv,
                                        PATHS["vit"][1])
    losses = results["all_workers_losses"][0]
    params = {k: v.detach().cpu()
              for k, v in results["model"].state_dict().items()}
    loss_diff = max((abs(a - b) for a, b in zip(losses, plain["losses"])),
                    default=0.0)
    differ = [k for k in plain["params"]
              if not torch.equal(params[k], plain["params"][k])]
    worst = max((float((params[k].float() - plain["params"][k].float())
                       .abs().max()) for k in differ), default=0.0)
    rt = results["round_timings"]
    steps = sum(r["train_steps"] for r in rt)
    train_ms = sum(r["train_ms"] for r in rt)
    n_diff = sum(a != b for a, b in zip(losses, plain["losses"]))
    print(f"[stream vit] windows of 2 steps, 2 staged ahead: {len(losses)} "
          f"batch losses, {n_diff} differ from the plain vit run's (max abs "
          f"{loss_diff:.3g}); "
          f"{len(differ)} of {len(params)} parameter tensors differ (max abs "
          f"{worst:.3g}); launches {counts} vs plain {plain['counts']}")
    print(f"[stream vit] streamed: train step {train_ms / steps:.3f} ms, "
          f"train wall {train_ms:.1f} ms over {steps} steps, run wall "
          f"{wall:.1f} s, max_memory_allocated {peak / 2**30:.2f} GiB; plain "
          f"(same call): train step {plain['step_ms']:.3f} ms, train wall "
          f"{plain['train_ms']:.1f} ms, run wall {plain['wall']:.1f} s, "
          f"max_memory_allocated {plain['peak'] / 2**30:.2f} GiB")
    if (losses != plain["losses"] or differ or counts != plain["counts"]
            or steps != plain["steps"]):
        fail("stream vit: the streamed run departs from the plain vit run "
             "(losses, parameters, launches or steps; sizes above)")
    profile_stream(results, argv)
    return counts


def profile_stream(results, argv: list[str]) -> None:
    """Where the input copies run: one more round of PROFILE_STEPS train
    steps + 1 val step of the trained model, as one whole-round pack
    (pageable copies on the compute stream) and as windows of 2 (pinned,
    on the side stream), each under torch.profiler."""
    from importlib import import_module
    import numpy as np
    data = import_module(f"{PKG}.data")
    engine, whole = steady_round(results, argv)
    state, test = results["state"], results["test"]
    idx = np.arange(PROFILE_STEPS * PATH_BATCH)
    feed = data.window_feed(test.images, test.labels, idx, PATH_BATCH, 2,
                            PROFILE_STEPS)
    val = data.window_feed(test.images, test.labels, idx[:PATH_BATCH],
                           PATH_BATCH, 2, 2)
    for label, fn in (("whole-round pack", whole),
                      ("streamed windows", lambda: engine.round_streamed(
                          state, feed, val))):
        trace = os.path.join(OUT_DIR, f"trace_{label.split()[0]}.json")
        tag = f"[profile stream vit] {label}:"
        profile_window(tag, f"{PROFILE_STEPS} train steps + 1 val step", fn,
                       engine.device, trace=trace, top=6)
        h2d_copies(tag, trace)


def run_cnn() -> tuple[dict, dict]:
    """Drive the reference's run (CNN_ARGV) through main.run with the
    launch counters reset just before and read just after; check it and
    print its step time, throughput and memory."""
    import numpy as np
    import torch
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    main = import_module(f"{PKG}.main")
    models = import_module(f"{PKG}.models")
    _peak_reset()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    results = main.run(CNN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fl.LAUNCHES)
    peak = _peak()

    rt = results["round_timings"]
    train_steps = sum(r["train_steps"] for r in rt)
    print(f"[cnn] launches {counts} (the CNN path has no attention: all 0)")
    if any(counts.values()):
        fail(f"cnn: flash kernels launched on the CNN path: {counts}")
    if train_steps < 12:
        fail(f"cnn path ran only {train_steps} train steps")
    model = results["model"]
    params = sum(p.numel() for p in model.parameters())
    if params != CNN_PARAMS:
        fail(f"cnn: {params:,} params, expected {CNN_PARAMS:,}")
    first, last = check_losses("cnn", results)
    variables = results["variables"]
    stats = {k: v for k, v in variables.items() if ".running_" in k}
    unmoved = [k for k, v in stats.items() if torch.equal(
        v, torch.full_like(v, 1.0 if k.endswith("var") else 0.0))]
    if not stats or not all(torch.isfinite(v).all() for v in stats.values()):
        fail("cnn: BatchNorm statistics missing or not finite")
    if unmoved:
        fail(f"cnn: BatchNorm statistics still at their init: {unmoved}")
    ev = results["test_eval"]

    # the trained model's eval-mode logits on the card (bf16,
    # channels_last) against the same state_dict in fp32 on the CPU
    x = torch.from_numpy(np.asarray(results["test"].images[:8]))
    model.eval()
    with torch.no_grad():
        card = model(x.to(next(model.parameters()).device)).float().cpu()
        cpu_model = models.get_model(
            "enhanced_cnn", num_classes=results["test"].num_classes,
            width=model.prep_conv.out_channels, dtype=torch.float32,
            device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in variables.items()})
        cpu_model = cpu_model.to(memory_format=torch.channels_last).eval()
        ref = cpu_model(x)
    if tuple(card.shape) != (8, results["test"].num_classes):
        fail(f"cnn: logits shape {tuple(card.shape)}")
    e, rel = _err(card, ref)
    print(f"[cnn] card bf16 vs CPU fp32 eval-mode logits on 8 test images: "
          f"max abs err {e:.4g} ({rel:.3g} of max |cpu|)")
    if not (math.isfinite(e) and rel <= CNN_LOGIT_TOL):
        fail(f"cnn: card and CPU logits disagree beyond {CNN_LOGIT_TOL}")

    train_ms = sum(r["train_ms"] for r in rt)
    step_ms = train_ms / train_steps
    images_s = train_steps * PATH_BATCH / (train_ms / 1e3)
    MEMORY_ROWS["cnn"] = results["memory"]
    MFU_RUNS["cnn"] = dict(argv=CNN_ARGV, num_classes=10,
                           example=list(results["test"].images.shape[1:]),
                           tokens=False, step_ms=step_ms, workers=1)
    print(f"[cnn] {params:,} params; {len(stats) // 2} BatchNorms, all "
          f"statistics finite and moved; wall {wall:.1f} s; "
          f"{train_steps} train steps; train step {step_ms:.3f} ms; "
          f"{images_s:.0f} images/s; first-batch loss {first:.4f} -> "
          f"last-epoch mean {last:.4f}; val loss "
          f"{results['global_val_losses'][-1]:.4f}; test loss "
          f"{ev['loss']:.4f}, accuracy {ev['accuracy']:.2f}%; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    for r in rt:
        print(f"[cnn] round {r['epoch']}: {r['train_steps']} train steps in "
              f"{r['train_ms']:.1f} ms; round wall {r['compute_ms']:.1f} ms")
    return counts, results


def _worker_state_host(engine, state) -> dict:
    """Every tensor of a worker's checkpointed state, copied to the host,
    with its count, StepLR clock and seed words."""
    ws = engine.checkpoint_state(state)
    out = {k: v.detach().to("cpu", copy=True)
           for k, v in ws.tensors().items()}
    out.update(count=ws.count, lr_epoch=ws.lr_epoch,
               rng=[int(w) for w in ws.rng])
    return out


def phase_ckpt() -> dict:
    """Phase ckpt: the gpt2 path at 2 rounds saving every round (kept 2),
    epoch 2 restored into a fresh engine against the run's final state,
    then --resume to 3 rounds.  Returns the two runs' summed launches."""
    import torch
    from importlib import import_module
    t_ckpt = import_module(f"{PKG}.checkpoint")
    t_driver = import_module(f"{PKG}.driver")
    train = import_module(f"{PKG}.train")
    cfg = import_module(f"{PKG}.config").config_from_args(CKPT_ARGV)
    t0 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    counts, res, wall, _ = drive("[ckpt] 2 rounds", CKPT_ARGV,
                                 PATHS["gpt2"][1])
    check_losses("ckpt", res)
    rt = res["round_timings"]
    summary = res["checkpoint"]
    if len(rt) != 2 or summary["saves"] != 2 or t_ckpt.committed_epochs(
            CKPT_DIR) != [1, 2]:
        fail(f"ckpt: {len(rt)} rounds, summary {summary}, committed "
             f"{t_ckpt.committed_epochs(CKPT_DIR)}")
    device = next(res["model"].parameters()).device
    final = _worker_state_host(
        train.LocalSGDEngine(res["model"], cfg, device), res["state"])
    for r in rt:
        if not (r["ckpt_snapshot_ms"] > 0 and r["ckpt_write_ms"] > 0):
            fail(f"ckpt: round {r['epoch']} timings {r}")
        print(f"[ckpt] round {r['epoch']}: snapshot "
              f"{r['ckpt_snapshot_ms']:.3f} ms (the round loop's stall), "
              f"write {r['ckpt_write_ms']:.3f} ms (writer thread), train "
              f"{r['train_ms']:.1f} ms")
    shard = os.path.join(CKPT_DIR, "ckpt_2", "shard_0.msgpack")
    print(f"[ckpt] {summary['saves']} saves of {summary['bytes_per_host']:,} "
          f"payload bytes each; shard file {os.path.getsize(shard):,}"
          f" bytes; stall total {summary['stall_ms_total']:.3f} ms, write "
          f"total {summary['write_ms_total']:.3f} ms; run wall {wall:.1f} s")
    del res
    torch.cuda.empty_cache()

    # epoch 2 into a fresh engine: every tensor bit for bit
    t1 = time.perf_counter()
    model = t_driver.build_model_for(cfg, 1000, device, (PATH_LEN,))
    engine = train.LocalSGDEngine(model, cfg, device)
    state = engine.init_state()
    restored, epoch = t_ckpt.restore_checkpoint(
        os.path.join(CKPT_DIR, "ckpt_2"), engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, restored)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    got = _worker_state_host(engine, state)
    differ = [k for k in final if not (
        torch.equal(final[k], got[k]) if isinstance(final[k], torch.Tensor)
        else final[k] == got[k])]
    n_tensors = sum(isinstance(v, torch.Tensor) for v in final.values())
    print(f"[ckpt] epoch {epoch} restored into a fresh engine in "
          f"{restore_s * 1e3:.1f} ms (read, crc32, decode, convert, copy to "
          f"the card): {n_tensors} tensors + count/lr_epoch/rng, "
          f"{len(differ)} differ from the run's final state")
    if epoch != 2 or differ:
        fail(f"ckpt: restored epoch {epoch}; differing: {differ[:5]}")
    del model, engine, state, restored, final, got
    torch.cuda.empty_cache()

    argv = [*CKPT_ARGV, "--epochs_global", "3", "--resume"]
    counts2, res2, wall2, _ = drive("[ckpt] --resume to 3 rounds", argv,
                                    PATHS["gpt2"][1])
    rounds = [r["epoch"] for r in res2["round_timings"]]
    committed = t_ckpt.committed_epochs(CKPT_DIR)
    print(f"[ckpt] resumed run trained rounds {rounds} in {wall2:.1f} s; "
          f"committed epochs {committed}; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    if rounds != [2] or committed != [2, 3]:
        fail(f"ckpt: the resumed run trained rounds {rounds}, committed "
             f"{committed} (expected [2] and [2, 3])")
    del res2
    torch.cuda.empty_cache()
    return {k: counts[k] + counts2[k] for k in counts}


def _serve(argv: list[str], record: int = 0):
    """main.run(["serve", *argv]) with the launch counters reset; with
    ``record``, the logits of requests 0..record-1 at every generated
    position (prefill's last position, then each decode step), kept on the
    device while the run goes (no copy, no sync) and moved to the host
    after it.  Returns (results, {rid: [logits]}, launches, wall s)."""
    import torch
    from importlib import import_module
    from unittest import mock
    fl = import_module(f"{PKG}.ops.flash")
    main = import_module(f"{PKG}.main")
    engine_cls = import_module(f"{PKG}.serve.engine").ServeEngine
    seen: dict[int, list] = {}
    prefill, decode = engine_cls.prefill, engine_cls.decode

    def rec_prefill(self, prompt, page_row, temperature, rid, **kw):
        tok, last = prefill(self, prompt, page_row, temperature, rid, **kw)
        if rid < record:
            seen.setdefault(rid, []).append(last)
        return tok, last

    def rec_decode(self, tokens, lengths, table, temps, rids, active):
        nxt, logits = decode(self, tokens, lengths, table, temps, rids,
                             active)
        for i in range(len(rids)):
            if active[i] and rids[i] < record:
                seen[int(rids[i])].append(logits[i])
        return nxt, logits

    fl.reset_launch_counts()
    with mock.patch.object(engine_cls, "prefill", rec_prefill), \
            mock.patch.object(engine_cls, "decode", rec_decode):
        t0 = time.perf_counter()
        results = main.run(["serve", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    seen = {rid: [t.float().cpu() for t in ts] for rid, ts in seen.items()}
    return results, seen, dict(fl.LAUNCHES), wall


def _serve_checks(name: str, results, want_programs: set) -> dict:
    tele = results["serve"]
    programs = {(p, tuple(shape)) for p, shape in tele["programs"]}
    if tele["pages"]["leaked"] or programs != want_programs:
        fail(f"serve {name}: leaked {tele['pages']['leaked']} pages; "
             f"programs {sorted(programs)}, expected {sorted(want_programs)}")
    return tele


def phase_serve(name: str, ckpt_dir: str) -> dict:
    """Phase serve: 16 greedy requests off ``ckpt_dir`` through `main
    serve`, with the checks of the module docstring; returns the
    telemetry with ``streams`` (rid -> tokens) and ``margins`` (rid -> each
    generated position's top-2 margin over max |logit| in this run's own
    logits) added."""
    import torch
    argv = ["--checkpoint_dir", ckpt_dir, *SERVE_ARGV]
    results, seen, launches, wall = _serve(argv,
                                           record=SERVE_REQUESTS)
    tele = results["serve"]
    buckets = tele["prefill_buckets"]
    want = {("prefill", (1, b)) for b in buckets} | {("decode", (8, 1))}
    _serve_checks(name, results, want)
    tag = f"[serve {name}]"
    if (tele["tokens_generated"] != SERVE_TOKENS
            or not set(buckets) <= {32, 128}):
        fail(f"serve {name}: {tele['tokens_generated']} tokens, buckets "
             f"{buckets}")
    engine = results["engine"]
    model = engine.model
    _set_attention(model, "flash")
    worst, checked, agree, margins = 0.0, 0, 0, 0
    for c in results["completions"][:SERVE_CHECKED]:
        paged = torch.stack(seen[c.rid])
        prompt = [int(t) for t in results["requests"][c.rid].prompt]
        ids = torch.tensor([prompt + c.tokens], device=engine.device)
        with torch.no_grad():
            full = model(ids)[0, len(prompt) - 1:-1].float().cpu()
        if paged.shape != full.shape or len(c.tokens) != SERVE_NEW_TOKENS:
            fail(f"serve {name}: request {c.rid}: paged {tuple(paged.shape)} "
                 f"vs full {tuple(full.shape)}")
        scale = full.abs().amax(-1)
        err = (paged - full).abs().amax(-1) / scale
        worst = max(worst, float(err.max()))
        top2 = full.topk(2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > SERVE_LOGIT_TOL * scale
        toks = torch.tensor(c.tokens)
        margins += int(sure.sum())
        agree += int((toks[sure] == full.argmax(-1)[sure]).sum())
        checked += len(c.tokens)
    print(f"{tag} paged vs full-sequence forward (flash, "
          f"{model.dtype}) over {checked} generated positions of "
          f"{SERVE_CHECKED} requests: worst max abs err / max |full| "
          f"{worst:.3g} (limit {SERVE_LOGIT_TOL}); token = full argmax at "
          f"{agree} of the {margins} positions whose top-2 margin exceeds "
          f"the limit")
    if not (math.isfinite(worst) and worst <= SERVE_LOGIT_TOL
            and agree == margins):
        fail(f"serve {name}: paged decode departs from the full forward")
    tele["streams"] = {c.rid: c.tokens for c in results["completions"]}
    tele["margins"] = {}
    for rid, logits in seen.items():
        lg = torch.stack(logits)
        top2 = lg.topk(2, -1).values
        tele["margins"][rid] = ((top2[:, 0] - top2[:, 1])
                                / lg.abs().amax(-1)).tolist()
    mem = tele["memory"]
    print(f"{tag} launches {launches} (paged decode runs no custom kernel)")
    print(f"{tag} {tele['tokens_generated']} tokens from "
          f"{tele['requests']} requests in {tele['wall_s']:.3f} s: "
          f"{tele['tokens_per_s']:.1f} tokens/s; decode latency p50 "
          f"{tele['latency_ms']['p50']:.3f} ms p99 "
          f"{tele['latency_ms']['p99']:.3f} ms; TTFT p50 "
          f"{tele['ttft_ms']['p50']:.3f} ms p99 {tele['ttft_ms']['p99']:.3f}"
          f" ms; {tele['decode_steps']} decode steps; peak pages "
          f"{tele['pages']['peak_in_use']} ({tele['pages']['peak_bytes']:,} "
          f"bytes); max_memory_allocated "
          f"{mem['max_memory_allocated'] / 2**30:.3f} GiB (params "
          f"{mem['params_bytes'] / 2**30:.3f}, pools "
          f"{mem['kv_pool_bytes'] / 2**30:.3f}); restore "
          f"{tele['restore_ms']:.1f} ms; programs {tele['programs']}; "
          f"main.run wall {wall:.1f} s")
    MEMORY_ROWS[f"serve {name}"] = tele["memory"]
    profile_serve(name, engine)
    return tele


def profile_serve(name: str, engine) -> None:
    """Where a decode step's time goes: 8 requests of 32 prompt tokens and
    PROFILE_NEW_TOKENS new ones (one batch: 8 prefills, then the decode
    steps) through the served engine under torch.profiler."""
    import numpy as np
    from importlib import import_module
    sched = import_module(f"{PKG}.serve.scheduler")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, engine.spec.vocab, 32).tolist()
               for _ in range(8)]

    def window():
        sched.ContinuousBatchingScheduler(engine).run(
            [sched.Request(rid=i, prompt=p,
                           max_new_tokens=PROFILE_NEW_TOKENS)
             for i, p in enumerate(prompts)])
    steps = ("8 prefills in each pool + speculation ticks (draft decode x "
             f"{engine.spec_tokens}, one verify)" if engine.draft is not None
             else f"8 prefills + {PROFILE_NEW_TOKENS - 1} decode steps")
    profile_window(f"[profile serve {name}]",
                   f"8 requests x (32 prompt + {PROFILE_NEW_TOKENS} new) "
                   f"tokens, {steps}",
                   window, engine.device)


def phase_draft() -> dict:
    """Phase draft: train the speculative draft (gpt_small, head_dim 32)
    for one round of 16 steps, saving its checkpoint; ``drive`` checks the
    launches of the D=32 kernel instances.  Returns the counts."""
    from importlib import import_module
    t_ckpt = import_module(f"{PKG}.checkpoint")
    shutil.rmtree(DRAFT_CKPT_DIR, ignore_errors=True)
    counts, results, wall, peak = drive("[draft]", DRAFT_ARGV, DRAFT_LAYERS)
    steps = sum(r["train_steps"] for r in results["round_timings"])
    first, last = check_losses("draft", results)
    model = results["model"]
    head_dim = model.blocks[0].attn.head_dim
    committed = t_ckpt.committed_epochs(DRAFT_CKPT_DIR)
    if steps < 16 or head_dim != 32 or committed != [1]:
        fail(f"draft: {steps} train steps, head_dim {head_dim}, committed "
             f"{committed}")
    params = sum(p.numel() for p in model.parameters())
    print(f"[draft] gpt_small {params:,} params, head_dim {head_dim}; "
          f"{steps} train steps in {wall:.1f} s (step "
          f"{sum(r['train_ms'] for r in results['round_timings']) / steps:.3f}"
          f" ms); first-batch loss {first:.4f} -> last-epoch mean "
          f"{last:.4f}; checkpoint epochs {committed}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    del results, model
    import torch
    torch.cuda.empty_cache()
    return counts


def _serve_line(tele: dict) -> str:
    mem = tele["memory"]
    pools = mem["kv_pool_bytes"] + mem.get("draft_kv_pool_bytes", 0)
    params = mem["params_bytes"] + mem.get("draft_params_bytes", 0)
    return (f"{tele['tokens_per_s']:.1f} tokens/s; decode p50 "
            f"{tele['latency_ms']['p50']:.3f} ms p99 "
            f"{tele['latency_ms']['p99']:.3f} ms; TTFT p50 "
            f"{tele['ttft_ms']['p50']:.3f} ms p99 {tele['ttft_ms']['p99']:.3f}"
            f" ms; {tele['decode_steps']} target steps; acceptance "
            f"{tele['spec']['acceptance_rate']}, target steps per token "
            f"{tele['spec']['target_steps_per_token']}; max_memory_allocated "
            f"{mem['max_memory_allocated'] / 2**30:.3f} GiB (params "
            f"{params / 2**30:.3f}, pools {pools / 2**30:.3f}); restore "
            f"{tele['restore_ms']:.1f} ms")


def _against_plain(name: str, results, plain: dict) -> tuple:
    """Hold a speculative run's streams against the plain run's (``plain``:
    phase_serve's telemetry of this call): each equal up to the plain
    run's first near tie (top-2 margin <= SERVE_LOGIT_TOL x max |logit|),
    and, where the two split at all, split at a position whose plain
    logits (the same context before the split) hold a near tie.  Returns
    (streams equal in full, positions up to the first near ties, positions
    agreed before the splits)."""
    full, compared, agreed = 0, 0, 0
    for c in results["completions"]:
        ref, margins = plain["streams"][c.rid], plain["margins"][c.rid]
        tie = [m <= SERVE_LOGIT_TOL for m in margins]
        sure = tie.index(True) if True in tie else len(tie)
        split = next((i for i, (a, b) in enumerate(zip(c.tokens, ref))
                      if a != b), None)
        if len(c.tokens) != len(ref):
            fail(f"serve {name}: request {c.rid} has {len(c.tokens)} "
                 f"tokens, the plain run {len(ref)}")
        if split is not None and (split < sure or not tie[split]):
            fail(f"serve {name}: request {c.rid} departs from the plain "
                 f"stream at position {split} (plain top-2 margin "
                 f"{margins[split]:.3g} of max |logit|; first near tie at "
                 f"{sure})")
        full += split is None
        compared += sure
        agreed += len(ref) if split is None else split
    return full, compared, agreed


def phase_serve_spec(plain: dict) -> dict:
    """Phase serve gpt2 spec: serve gpt2's traffic with the draft and
    SPEC_TOKENS, against the plain run ``plain`` (phase_serve's telemetry
    of this call); then the target as its own draft.  Returns the
    launches."""
    import torch
    base = ["--checkpoint_dir", CKPT_DIR, *SERVE_ARGV,
            "--serve_spec_tokens", str(SPEC_TOKENS)]
    results, _, launches, wall = _serve(
        [*base, "--serve_draft_ckpt", DRAFT_CKPT_DIR])
    tele = results["serve"]
    buckets = tele["prefill_buckets"]
    want = ({("prefill", (1, b)) for b in buckets}
            | {("verify", (8, SPEC_TOKENS + 1))})
    _serve_checks("gpt2 spec", results, want)
    draft_programs = {(p, tuple(shape)) for p, shape
                      in tele["draft_programs"]}
    want_d = {("prefill", (1, b)) for b in buckets} | {("decode", (8, 1))}
    if (tele["tokens_generated"] != SERVE_TOKENS
            or tele["pages"]["draft_leaked"] or draft_programs != want_d
            or any(launches.values())):
        fail(f"serve gpt2 spec: {tele['tokens_generated']} tokens, draft "
             f"leaked {tele['pages']['draft_leaked']}, draft programs "
             f"{sorted(draft_programs)}, launches {launches}")
    full, compared, agreed = _against_plain("gpt2 spec", results, plain)
    tag = "[serve gpt2 spec]"
    print(f"{tag} {len(results['completions'])} streams equal the plain "
          f"serve gpt2 streams over {compared} of {SERVE_TOKENS} positions "
          f"(each up to its first plain top-2 margin <= {SERVE_LOGIT_TOL} x "
          f"max |logit|), and agree over {agreed} positions up to where "
          f"they split, each split at a plain near tie; {full} of "
          f"{len(results['completions'])} equal in "
          f"full; launches {launches}; programs {tele['programs']}, draft "
          f"{tele['draft_programs']}; peak pages "
          f"{tele['pages']['peak_in_use']} / draft {tele['pages']['draft_peak_in_use']}; main.run wall "
          f"{wall:.1f} s")
    print(f"{tag} speculative (k={SPEC_TOKENS}): {_serve_line(tele)}")
    print(f"{tag} plain (same call):  {_serve_line(plain)}")
    profile_serve("gpt2 spec", results["engine"])
    del results
    torch.cuda.empty_cache()
    selfd, _, _, wall = _serve([*base, "--serve_draft_ckpt", CKPT_DIR])
    t_self = selfd["serve"]
    if t_self["tokens_generated"] != SERVE_TOKENS or t_self["pages"][
            "leaked"] or t_self["pages"]["draft_leaked"]:
        fail(f"serve gpt2 self-draft: {t_self['tokens_generated']} tokens, "
             f"pages {t_self['pages']}")
    same, _, agreed = _against_plain("gpt2 self-draft", selfd, plain)
    print(f"{tag} the target as its own draft: {_serve_line(t_self)}; "
          f"{same} of {len(selfd['completions'])} streams equal the plain "
          f"run's in full, the rest split at plain near ties ({agreed} "
          f"positions agreed before); main.run wall {wall:.1f} s")
    del selfd
    torch.cuda.empty_cache()
    return launches


def phase_serve_shared(ckpt_dir: str) -> None:
    """The shared 96-token prompt with --serve_prefill_chunk 32: 8
    requests cold, then 32 with --serve_prefix_cache; every stream must be
    the cold one, with pages reused."""
    base = ["--checkpoint_dir", ckpt_dir, *SERVE_ARGV, *SHARED_ARGV]
    want = {("prefill_chunk", (1, 32)), ("decode", (8, 1))}
    cold, _, _, _ = _serve([*base, "--serve_requests", "8"])
    warm, _, _, _ = _serve([*base, "--serve_prefix_cache"])
    streams = {tuple(c.tokens) for c in cold["completions"]}
    tele_c = _serve_checks("gpt2 shared cold", cold, want)
    tele = _serve_checks("gpt2 shared prefix", warm, want)
    same = sum(tuple(c.tokens) in streams for c in warm["completions"])
    print(f"[serve gpt2] shared 96-token prompt, prefill chunk 32: cold "
          f"({tele_c['requests']} requests) {tele_c['tokens_per_s']:.1f} "
          f"tokens/s, TTFT p50 {tele_c['ttft_ms']['p50']:.3f} ms; prefix "
          f"cache ({tele['requests']} requests) {tele['tokens_per_s']:.1f} "
          f"tokens/s, TTFT p50 {tele['ttft_ms']['p50']:.3f} ms p99 "
          f"{tele['ttft_ms']['p99']:.3f} ms, page_reuse_ratio "
          f"{tele['page_reuse_ratio']}, prefill tokens saved "
          f"{tele['prefill_tokens_saved']}, {tele['prefill_chunks']} chunks; "
          f"{same} of {len(warm['completions'])} streams equal the cold "
          f"stream ({len(streams)} distinct cold stream(s))")
    if (len(streams) != 1 or same != len(warm["completions"])
            or not tele["page_reuse_ratio"] > 0):
        fail("serve gpt2: prefix-cache streams differ from the cold run's, "
             "or no page was reused")


def modes_reference(x, n: int, how: str, topology: str, w: float):
    """The float64 numpy formula of one sync mode on worker-stacked
    leaves ``x`` [n, ...]: every worker's result, [n, ...]."""
    import numpy as np
    x = np.asarray(x, np.float64)
    if topology == "allreduce":
        total = x.sum(axis=0, keepdims=True)
        if how == "equal":
            return np.broadcast_to(total / n, x.shape)
        return w * x + (1 - w) * (total - x) / (n - 1)
    r1 = np.roll(x, 1, axis=0)               # worker i receives i - 1
    if topology == "ring":
        return (x + r1) / 2 if how == "equal" else w * x + (1 - w) * r1
    r2 = np.roll(x, 2, axis=0)               # i - 2 (itself at n = 2)
    if how == "equal":
        return (x + r1 + r2) / 3
    return w * x + (1 - w) / 2 * (r1 + r2)


def sync_modes_job(n: int, work_dir: str) -> tuple:
    """Phase 8a's inputs at ``n`` workers: ``(target, args after the store
    path, context)`` of comms.modes_worker on the card."""
    import numpy as np
    from importlib import import_module
    comms = import_module(f"{PKG}.comms")
    d = os.path.join(work_dir, f"modes{n}")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(n)
    leaves = [rng.normal(size=(n, *s)).astype(np.float32)
              for s in SYNC_MODE_SIZES]
    np.savez(os.path.join(d, "in.npz"),
             **{f"leaf{j}": a for j, a in enumerate(leaves)})
    return (comms.modes_worker, (SYNC_DEVICE, os.path.join(d, "in.npz"), d,
                                 SYNC_LOCAL_WEIGHT, 120.0),
            dict(d=d, leaves=leaves))


def rank_outputs(d: str, n: int, name: str = "rank{r}.npz",
                 timeout_s: float = 120.0) -> list:
    """Every rank's output file of a job in ``d`` (each written whole, by a
    rename), once all ``n`` are there: in a shared start the other ranks
    finish a job after rank 0 may have; npz files load as dicts, json as
    objects."""
    import numpy as np
    paths = [os.path.join(d, name.format(r=r)) for r in range(n)]
    t0 = time.perf_counter()
    while not all(os.path.exists(p) for p in paths):
        if time.perf_counter() - t0 > timeout_s:
            fail(f"outputs missing after {timeout_s:.0f} s: "
                 f"{[p for p in paths if not os.path.exists(p)]}")
        time.sleep(0.05)
    out = []
    for p in paths:
        if p.endswith(".json"):
            with open(p) as f:
                out.append(json.load(f))
        else:
            with np.load(p) as f:
                out.append({k: f[k] for k in f.files})
    return out


def check_sync_modes(n: int, ctx: dict, wall: float) -> dict:
    """Phase 8a at ``n`` workers: each mode of comms.modes_worker's
    outputs (``sync_modes_job``'s ``ctx``) against modes_reference.
    Returns label -> ms."""
    import numpy as np
    from importlib import import_module
    comms = import_module(f"{PKG}.comms")
    d, leaves = ctx["d"], ctx["leaves"]
    outs = rank_outputs(d, n)
    ms, worst = {}, 0.0
    for how, topology in comms.MODES:
        for j, x in enumerate(leaves):
            want = modes_reference(x, n, how, topology, SYNC_LOCAL_WEIGHT)
            for r in range(n):
                got = outs[r][f"{how}-{topology}-leaf{j}"]
                err = np.abs(got.astype(np.float64) - want[r])
                bad = err > SYNC_TOL + SYNC_TOL * np.abs(want[r])
                if got.dtype != np.float32 or bad.any():
                    fail(f"sync n={n} {how}/{topology} leaf{j} rank {r}: "
                         f"max abs err {err.max():.3g} beyond rtol=atol="
                         f"{SYNC_TOL} ({got.dtype})")
                worst = max(worst, float(err.max()))
        ms[f"{how}/{topology}"] = max(float(o[f"ms-{how}-{topology}"])
                                      for o in outs)
    sums = {str(o["checksum-equal-allreduce"]) for o in outs}
    if len(sums) != 1:
        fail(f"sync n={n}: ranks differ after equal/allreduce: {sums}")
    numel = sum(int(np.prod(s)) for s in SYNC_MODE_SIZES)
    print(f"[sync] modes n={n}: 12/12 modes (6 blends x gradients|weights, "
          f"one aggregate serves both) on {SYNC_DEVICE} match the float64 "
          f"formula "
          f"(max abs err {worst:.3g}, rtol=atol={SYNC_TOL}); equal/allreduce "
          f"bitwise identical on all {n} ranks; {numel:,} fp32 elements per "
          f"worker; slowest rank's sync ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; the modes' job in {wall:.1f} s (its {n} processes shared "
          "with the engines and the driver runs)")
    return ms


def gloo_job(work_dir: str) -> tuple:
    """The gloo probe's job: ``(target, args after the store path,
    context)`` of sync_harness.gloo_probe_worker."""
    from importlib import import_module
    sync_harness = import_module(f"{PKG}.sync_harness")
    d = os.path.join(work_dir, "gloo")
    os.makedirs(d, exist_ok=True)
    return sync_harness.gloo_probe_worker, (d, 60.0), dict(d=d)


def check_gloo(ctx: dict) -> dict:
    """Which gloo collectives this torch has and what they give, on a
    2-process group (CPU tensors): all_to_all_single on fp32, bf16, int8
    and uint8 (the bytes the fast engines move), all_gather into views
    (the engines' gather), all_gather_into_tensor and all_gather_single.
    Fails if a collective the engines use is missing or wrong."""
    import torch
    rows = rank_outputs(ctx["d"], 2, "gloo{r}.json")
    print(f"[gloo] collectives (torch {torch.__version__}, 2 processes): "
          + ", ".join(f"{k} {v}" for k, v in rows[0].items()))
    used = [k for k in rows[0] if k.startswith(("all_to_all_single",
                                                "all_gather/"))]
    bad = [(r, k, row[k]) for r, row in enumerate(rows) for k in used
           if not row[k].startswith("ok")]
    if bad:
        fail(f"gloo: collectives the fast engines use failed: {bad}")
    return rows[0]


def sync_engines_job(n: int, work_dir: str) -> tuple:
    """The fast engines' inputs at ``n`` workers: ``(target, args after
    the store path, context)`` of sync_harness.engines_worker on
    SYNC_MODE_SIZES, worker r's leaves scaled by 1 + r, the default 4 MiB
    buckets, each engine and wire, and the dense path timed the same
    way."""
    import numpy as np
    from importlib import import_module
    sync_harness = import_module(f"{PKG}.sync_harness")
    d = os.path.join(work_dir, f"engines{n}")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(n)
    leaves = [(rng.normal(size=(n, *s))
               * (1.0 + np.arange(n)).reshape(n, *[1] * len(s)))
              .astype(np.float32) for s in SYNC_MODE_SIZES]
    np.savez(os.path.join(d, "in.npz"),
             **{f"leaf{j}": a for j, a in enumerate(leaves)})
    cases, labels = [], []
    for engine, how, topology in SYNC_ENGINES:
        for wire in SYNC_WIRES:
            cases.append(dict(mode=engine, how=how, topology=topology,
                              wire=wire, ef=wire != "float32",
                              local_weight=SYNC_LOCAL_WEIGHT,
                              rounds=SYNC_ENGINE_ROUNDS))
            labels.append((engine, how, topology, wire))
    # the dense path timed the same way (quickest of the same rounds)
    for how, topology in {(h, t) for _e, h, t in SYNC_ENGINES}:
        cases.append(dict(mode="dense", how=how, topology=topology,
                          local_weight=SYNC_LOCAL_WEIGHT,
                          rounds=SYNC_ENGINE_ROUNDS))
        labels.append(("dense", how, topology, "float32"))
    if n == 2 * SYNC_HIER_SLICES:
        # the hierarchical engine at 2 x 2; its fp32 case also runs the
        # dense twin comms.aggregate_hier
        for how, topology in SYNC_HIER:
            for wire, outer in SYNC_HIER_WIRES:
                fp32 = wire == outer == "float32"
                cases.append(dict(mode="hier", slices=SYNC_HIER_SLICES,
                                  how=how, topology=topology, wire=wire,
                                  outer_wire=outer, ef=not fp32, twin=fp32,
                                  local_weight=SYNC_LOCAL_WEIGHT,
                                  rounds=SYNC_ENGINE_ROUNDS))
                labels.append(("hier", how, topology, f"{wire}/{outer}"))
    return (sync_harness.engines_worker,
            (SYNC_DEVICE, os.path.join(d, "in.npz"), cases, d, 120.0),
            dict(d=d, leaves=leaves, cases=cases, labels=labels))


def check_sync_engines(n: int, ctx: dict, wall: float,
                       dense_ms: dict) -> dict:
    """The fast engines at ``n`` workers on the card
    (sync_harness.engines_worker's outputs, ``sync_engines_job``'s
    ``ctx``): fp32 against the float64 formula at SYNC_TOL, an equal
    all-reduce bitwise the same on every rank; bf16 and int8 (with error
    feedback) within one quantum of each wire stage of the fp32 result,
    per element (sync_harness.compressed_bounds); the bytes handed to gloo
    equal to sync_wire_bytes; the slowest rank's quickest-round ms per
    engine and wire beside the dense modes' ms of this call."""
    import numpy as np
    import torch
    from importlib import import_module
    comms = import_module(f"{PKG}.comms")
    sync_harness = import_module(f"{PKG}.sync_harness")
    d, leaves = ctx["d"], ctx["leaves"]
    cases, labels = ctx["cases"], ctx["labels"]
    outs = rank_outputs(d, n)
    shapes = [(s, torch.float32) for s in SYNC_MODE_SIZES]
    ms, worst, share, fp32 = {}, {}, {}, {}
    for c, (engine, how, topology, wire) in enumerate(labels):
        if engine == "dense":
            ms[(engine, how, topology, wire)] = max(
                float(o[f"{c}/ms_min"]) for o in outs)
            continue
        if engine == "hier":
            continue
        got = [np.stack([o[f"{c}/first{j}"] for o in outs])
               for j in range(len(leaves))]
        if wire == "float32":
            fp32[(engine, how, topology)] = got
            err = 0.0
            for x, g in zip(leaves, got):
                want = modes_reference(x, n, how, topology,
                                       SYNC_LOCAL_WEIGHT)
                e = np.abs(g.astype(np.float64) - want)
                if (e > SYNC_TOL + SYNC_TOL * np.abs(want)).any():
                    fail(f"sync engines n={n} {engine} {how}/{topology}: "
                         f"max abs err {e.max():.3g} beyond rtol=atol="
                         f"{SYNC_TOL}")
                err = max(err, float(e.max()))
            if how == "equal" and topology == "allreduce" and any(
                    not np.array_equal(g[r], g[0]) for g in got
                    for r in range(n)):
                fail(f"sync engines n={n}: ranks differ after the sharded "
                     "equal all-reduce")
        else:
            _j, bounds, _r = sync_harness.compressed_bounds(
                leaves, n, mode=engine, how=how, wire=wire,
                local_weight=SYNC_LOCAL_WEIGHT, slack=SYNC_TOL)
            ref = fp32[(engine, how, topology)]
            errs = [np.abs(g.astype(np.float64) - f)
                    for g, f in zip(got, ref)]
            err = max(float(e.max()) for e in errs)
            share[(engine, how, topology, wire)] = max(
                float((e / b).max()) for e, b in zip(errs, bounds))
            if share[(engine, how, topology, wire)] > 1.0:
                fail(f"sync engines n={n} {engine} {how}/{topology} {wire}: "
                     f"{err:.3g} from the fp32 result, beyond one quantum "
                     f"of each wire stage (worst element at "
                     f"{share[(engine, how, topology, wire)]:.3g} of its "
                     "bound)")
        worst[(engine, how, topology, wire)] = err
        wdt = comms.WIRE_DTYPES[wire]
        want = comms.sync_wire_bytes(
            shapes, n, mode=engine, topology=topology,
            wire_dtype=None if wire == "float32" else wdt)
        if engine == "gossip":
            hops = comms._SHIFTS[topology]
            want = want * sum(1 for s in hops if s % n) // len(hops)
        sent = {int(o[f"{c}/wire_payload"]) for o in outs}
        if sent != {want}:
            fail(f"sync engines n={n} {engine} {how}/{topology} {wire}: "
                 f"handed gloo {sent} bytes, sync_wire_bytes {want}")
        ms[(engine, how, topology, wire)] = max(
            float(o[f"{c}/ms_min"]) for o in outs)
    numel = sum(int(np.prod(s)) for s in SYNC_MODE_SIZES)
    flat = sum(1 for lab in labels if lab[0] != "hier")
    print(f"[sync] engines n={n}: {flat} cases (sharded equal/"
          f"weighted, gossip ring/double_ring equal/weighted, each on the "
          f"fp32, bf16 and int8 wire with error feedback) on {SYNC_DEVICE}; "
          f"fp32 matches the float64 formula (max abs err "
          f"{max(v for k, v in worst.items() if k[3] == 'float32'):.3g}, "
          f"rtol=atol={SYNC_TOL}), the sharded equal all-reduce bitwise "
          f"identical on all {n} ranks; bf16 within "
          f"{max(v for k, v in worst.items() if k[3] == 'bfloat16'):.3g} "
          f"and int8 within "
          f"{max(v for k, v in worst.items() if k[3] == 'int8'):.3g} of "
          f"fp32, every element within one quantum of each wire stage "
          f"(worst at {max(share.values()):.3f} of its bound); bytes "
          f"handed to gloo = "
          f"sync_wire_bytes in every case; {numel:,} fp32 elements per "
          f"worker; the engines' job in {wall:.1f} s")
    for engine, how, topology in SYNC_ENGINES:
        print(f"[sync] engines n={n} {engine} {how}/{topology}: slowest "
              f"rank's ms (quickest of {SYNC_ENGINE_ROUNDS} rounds) "
              + ", ".join(f"{w} {ms[(engine, how, topology, w)]:.2f}"
                          for w in SYNC_WIRES)
              + f"; dense fp32 {ms[('dense', how, topology, 'float32')]:.2f}"
              f" the same way (one sync in [sync] modes: "
              f"{dense_ms[f'{how}/{topology}']:.2f})")
    if any(lab[0] == "hier" for lab in labels):
        check_hier_engines(n, ctx, outs)
    return ms


def check_hier_engines(n: int, ctx: dict, outs: list) -> None:
    """The hierarchical engine's cases at ``n`` = 2 slices x 2 workers
    (sync_harness.engines_worker): fp32 bitwise equal to the dense twin
    comms.aggregate_hier on every rank and within SYNC_TOL of the float64
    gossip of slice means (sync_harness.hier_reference); each compressed
    pair within one quantum of each wire stage of the fp32 result
    (sync_harness.hier_bounds); the bytes handed to gloo per level equal
    to hier_wire_bytes, the shift-2 hop of the double ring over 2 slices
    left out (the slice's own payload, taken locally)."""
    import numpy as np
    import torch
    from importlib import import_module
    comms = import_module(f"{PKG}.comms")
    sync_harness = import_module(f"{PKG}.sync_harness")
    leaves, labels = ctx["leaves"], ctx["labels"]
    shapes = [(s, torch.float32) for s in SYNC_MODE_SIZES]
    nw = n // SYNC_HIER_SLICES
    fp32, worst, share, ms = {}, {}, {}, {}
    for c, (engine, how, topology, wires) in enumerate(labels):
        if engine != "hier":
            continue
        wire, outer = wires.split("/")
        got = [np.stack([o[f"{c}/first{j}"] for o in outs])
               for j in range(len(leaves))]
        tag = f"sync engines n={n} hier {how}/{topology} {wires}"
        if wires == "float32/float32":
            fp32[(how, topology)] = got
            twin = [np.stack([o[f"{c}/twin{j}"] for o in outs])
                    for j in range(len(leaves))]
            if any(not np.array_equal(g, t) for g, t in zip(got, twin)):
                fail(f"{tag}: not bitwise the dense twin aggregate_hier")
            err = 0.0
            for x, g in zip(leaves, got):
                want = sync_harness.hier_reference(
                    x, SYNC_HIER_SLICES, topology=topology, how=how,
                    local_weight=SYNC_LOCAL_WEIGHT)
                e = np.abs(g.astype(np.float64) - want)
                if (e > SYNC_TOL + SYNC_TOL * np.abs(want)).any():
                    fail(f"{tag}: max abs err {e.max():.3g} beyond "
                         f"rtol=atol={SYNC_TOL}")
                err = max(err, float(e.max()))
        else:
            bounds = sync_harness.hier_bounds(
                leaves, SYNC_HIER_SLICES, topology=topology, how=how,
                wire=wire, outer_wire=outer, local_weight=SYNC_LOCAL_WEIGHT,
                slack=SYNC_TOL)
            errs = [np.abs(g.astype(np.float64) - f)
                    for g, f in zip(got, fp32[(how, topology)])]
            err = max(float(e.max()) for e in errs)
            share[(how, topology, wires)] = max(
                float((e / b).max()) for e, b in zip(errs, bounds))
            if share[(how, topology, wires)] > 1.0:
                fail(f"{tag}: {err:.3g} from the fp32 result, beyond one "
                     "quantum of each wire stage (worst element at "
                     f"{share[(how, topology, wires)]:.3g} of its bound)")
        worst[(how, topology, wires)] = err
        want = comms.hier_wire_bytes(
            shapes, nw, topology=topology,
            wire_dtype=comms.WIRE_DTYPES[wire],
            outer_wire_dtype=comms.WIRE_DTYPES[outer])
        hops = comms._SHIFTS[topology]
        handed_dcn = (want["dcn"] * sum(1 for h in hops
                                        if h % SYNC_HIER_SLICES)
                      // len(hops))
        sent = {(int(o[f"{c}/wire_ici"]), int(o[f"{c}/wire_dcn"]))
                for o in outs}
        if sent != {(want["ici"], handed_dcn)}:
            fail(f"{tag}: handed gloo (ici, dcn) {sent} bytes, "
                 f"hier_wire_bytes {want} (dcn handed {handed_dcn})")
        ms[(how, topology, wires)] = max(float(o[f"{c}/ms_min"])
                                         for o in outs)
    print(f"[sync] engines n={n} hier ({SYNC_HIER_SLICES} slices x {nw} "
          f"workers, {len(ms)} cases: ring/double_ring equal/weighted on "
          "the inner/outer wires "
          + ", ".join(f"{a}/{b}" for a, b in SYNC_HIER_WIRES)
          + f", compressed with both levels' error feedback) on "
          f"{SYNC_DEVICE}: fp32 bitwise the dense twin aggregate_hier on "
          f"every rank and within "
          f"{max(v for k, v in worst.items() if k[2] == 'float32/float32'):.3g}"
          f" of the float64 gossip of slice means (rtol=atol={SYNC_TOL}); "
          "compressed within "
          + ", ".join(f"{w} {max(v for k, v in worst.items() if k[2] == w):.3g}"
                      for w in (f"{a}/{b}" for a, b in SYNC_HIER_WIRES[1:]))
          + f" of fp32, every element within one quantum of each wire "
          f"stage (worst at {max(share.values()):.3f} of its bound); bytes "
          "handed to gloo per level = hier_wire_bytes (ici, dcn) in every "
          "case")
    for how, topology in SYNC_HIER:
        print(f"[sync] engines n={n} hier {how}/{topology}: slowest rank's "
              f"ms (quickest of {SYNC_ENGINE_ROUNDS} rounds) "
              + ", ".join(f"{a}/{b} {ms[(how, topology, f'{a}/{b}')]:.2f}"
                          for a, b in SYNC_HIER_WIRES))


def check_stale_rounds(label: str, k: int, rt: list, ar: dict) -> None:
    """A run under ``--sync_staleness k``: every round's delta delivered;
    rows 0..k carry no delivery, and from row k+1 on each row's entry
    took one in the loop, whose sync wall is above 0 on every rank.
    Prints the hidden fraction of those in-loop deliveries (rank 0's)
    apart from the drain's (the rest of async_rounds' totals)."""
    tag = f"[sync {label}]"
    if not (ar["enabled"] and ar["delivered"] == len(rt)):
        fail(f"sync {label}: async_rounds {ar}: every round's delta must "
             "be delivered")
    early, looped = rt[:k + 1], rt[k + 1:]
    if not looped:
        fail(f"sync {label}: {len(rt)} rounds at K={k}: no delta landed at "
             "a round's entry")
    if any(max(r["workers_sync_ms"]) > 0 for r in early):
        fail(f"sync {label}: a sync wall in rounds 0..{k}, before any delta "
             "was due")
    late = [r["epoch"] for r in looped if not min(r["workers_sync_ms"]) > 0]
    if late:
        fail(f"sync {label}: rounds {late} took a delta at their entry "
             "with no sync wall on some rank")
    loop_ms = sum(r["sync_ms"] for r in looped)
    loop_hidden = sum(r["sync_hidden_ms"] for r in looped)
    drain_ms = ar["sync_ms_total"] - loop_ms
    drain_hidden = ar["sync_hidden_ms_total"] - loop_hidden
    print(f"{tag} staleness K={k}: {len(looped)} delta(s) delivered at a "
          f"round's entry: sync {loop_ms:.1f} ms, hidden {loop_hidden:.1f} "
          f"ms, hidden_fraction {loop_hidden / loop_ms:.4f}; "
          f"{ar['delivered'] - len(looped)} at the drain: sync "
          f"{drain_ms:.1f} ms, hidden {drain_hidden:.1f} ms, "
          f"hidden_fraction "
          f"{drain_hidden / drain_ms if drain_ms > 0 else 0.0:.4f} "
          f"(rank 0's)")


def sync_argv(label: str, n: int, extra: list[str]) -> list[str]:
    """Phase 8b's launch line of one N-worker run: CNN_ARGV at one local
    epoch a round on 2,048 training images (the depth cut to make room for
    the rank grid's phases), --num_workers N (per slice under
    --num_slices)."""
    slices = (int(extra[extra.index("--num_slices") + 1])
              if "--num_slices" in extra else 1)
    return [*CNN_ARGV[:-1], os.path.join(OUT_DIR, label), "--num_workers",
            str(n // slices), "--aggregation_by", "weights",
            "--epochs_local", "1", "--limit_train_samples", "2560", *extra]


def run_sync(label: str, n: int, extra: list[str], one_worker_images_s: float,
             runner) -> tuple[dict, dict]:
    """Phase 8b: one N-worker run of CNN_ARGV through main (rank 0 in this
    process; ``runner()`` runs the next launch line of the shared start,
    ``sync_argv``'s) with the launch counters reset just before and read
    just after; checks it and prints its throughput, sync and memory."""
    import torch
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    _peak_reset()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    results = runner()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fl.LAUNCHES)
    tag = f"[sync {label}]"
    print(f"{tag} launches {counts} (rank 0's process; no attention: all 0)")
    if any(counts.values()):
        fail(f"sync {label}: flash kernels launched: {counts}")
    if len(results["all_workers_losses"]) != n:
        fail(f"sync {label}: {len(results['all_workers_losses'])} workers")
    first, last = check_losses(f"sync {label}", results)
    rt = results["round_timings"]
    steps = [sum(r["workers_train_steps"][i] for r in rt) for i in range(n)]
    train_ms = [sum(r["workers_train_ms"][i] for r in rt) for i in range(n)]
    if min(steps) < 4:
        fail(f"sync {label}: a worker ran only {min(steps)} train steps")
    step_ms = [t / s for t, s in zip(train_ms, steps)]
    summed = sum(s * PATH_BATCH / (t / 1e3) for s, t in zip(steps, train_ms))
    pooled = sum(steps) * PATH_BATCH / (max(train_ms) / 1e3)
    sums = results["param_checksums"]
    same = len(set(sums)) == 1
    equal_allreduce = "equal" in extra and "allreduce" in extra
    if equal_allreduce and not same:
        fail(f"sync {label}: ranks hold different parameters after an "
             f"equal all-reduce: {sums}")
    if "--num_slices" in extra:
        check_hier_run(label, n, extra, results)
    buffer_mb = 4 * CNN_PARAMS / 1e6
    wire_mb = rt[-1]["sync_wire_bytes"] / 1e6
    engine = results["sync_engine"]
    peaks = rt[-1]["workers_max_memory_allocated"]
    print(f"{tag} {n} worker processes on one card; wall {wall:.1f} s; "
          f"train steps per worker {steps}; step ms per worker "
          + "[" + ", ".join(f"{x:.3f}" for x in step_ms) + "]"
          f"; summed images/s {summed:.0f} (one worker, cnn phase of this "
          f"call: {one_worker_images_s:.0f}; x{summed / one_worker_images_s:.2f})"
          f"; pooled images/s over the slowest worker's train time "
          f"{pooled:.0f}; first-batch loss {first:.4f} -> last-epoch mean "
          f"{last:.4f}; test loss {results['test_eval']['loss']:.4f}, "
          f"accuracy {results['test_eval']['accuracy']:.2f}%")
    stale = ("; the wall of the sync delivered at this round's entry "
             "(a stale sync's delta lands K+1 rounds on, the last ones "
             "at the drain: async_rounds)" if "--sync_staleness" in extra
             else "")
    for r in rt:
        print(f"{tag} round {r['epoch']}: sync ms per rank "
              + "[" + ", ".join(f"{x:.1f}" for x in r["workers_sync_ms"])
              + f"]{stale}; round wall {r['compute_ms']:.1f} ms; train "
              f"steps {r['workers_train_steps']}")
    if engine["mode"] != "dense":
        # the same engine on the fp32 wire, from the bucket plan
        comms = import_module(f"{PKG}.comms")
        weights = import_module(f"{PKG}.weights")
        leaves, _pieces = weights.wire_layout(results["model"])
        topology = extra[extra.index("--topology") + 1]
        fp32_mb = (sum(comms.hier_wire_bytes(
            leaves, n // engine["num_slices"], topology=topology).values())
            if engine["mode"] == "hier" else comms.sync_wire_bytes(
                leaves, n, mode=engine["mode"], topology=topology)) / 1e6
        print(f"{tag} engine {engine['mode']} (opt_placement "
              f"{engine['opt_placement']}, residency "
              f"{engine['param_residency']}); modeled wire {wire_mb:.1f} MB "
              f"per worker per round = {wire_mb / fp32_mb:.4f} of the same "
              f"engine's fp32 wire ({fp32_mb:.1f} MB); the dense runs' "
              f"buffer {buffer_mb:.1f} MB (x{wire_mb / buffer_mb:.4f})")
        ar = results["async_rounds"]
        print(f"{tag} async_rounds {json.dumps(ar)}")
        if "--sync_staleness" in extra:
            check_stale_rounds(label, int(extra[extra.index(
                "--sync_staleness") + 1]), rt, ar)
    print(f"{tag} sync buffer {buffer_mb:.1f} MB per worker per round "
          f"(staged to pinned host memory and back), modeled wire "
          f"{wire_mb:.1f} MB sent per worker; least sync ms over the ranks "
          f"per round "
          + str([round(min(r["workers_sync_ms"]), 1) for r in rt])
          + "; max_memory_allocated per process (GiB) "
          + "[" + ", ".join(f"{p / 2**30:.2f}" for p in peaks) + "]"
          f"; sched_getaffinity {len(os.sched_getaffinity(0))} cores; "
          f"param checksums {'all equal' if same else 'differ'} across "
          f"ranks")
    return counts, dict(summed_images_s=summed, step_ms=step_ms, wall=wall)


def check_hier_run(label: str, n: int, extra: list[str], results) -> None:
    """The hierarchical run's own checks: the engine and its slices, round
    2's DCN bytes equal to hier_wire_bytes (and above 0), no implicit sync
    under --sanitize, the workers of each slice bitwise equal after every
    round (slices may differ), and the last checkpoint restored here (no
    new start of the ranks) bitwise the run's state: the resident rows
    (the parameters) and both levels' error-feedback residuals."""
    import numpy as np
    from importlib import import_module
    comms = import_module(f"{PKG}.comms")
    weights = import_module(f"{PKG}.weights")
    ckpt = import_module(f"{PKG}.checkpoint")
    tag = f"[sync {label}]"
    engine = results["sync_engine"]
    slices = int(extra[extra.index("--num_slices") + 1])
    nw = n // slices
    if (engine["mode"], engine["num_slices"]) != ("hier", slices):
        fail(f"sync {label}: engine {engine['mode']} over "
             f"{engine['num_slices']} slice(s)")
    model, st = results["model"], results["state"]
    leaves, pieces = weights.wire_layout(model)
    outer = comms.WIRE_DTYPES[extra[extra.index("--sync_dtype_outer") + 1]]
    topology = extra[extra.index("--topology") + 1]
    want = comms.hier_wire_bytes(leaves, nw, topology=topology,
                                 outer_wire_dtype=outer)
    rt = results["round_timings"]
    got = (rt[2]["sync_bytes_ici"], rt[2]["sync_bytes_dcn"])
    if got != (want["ici"], want["dcn"]) or not want["dcn"] > 0:
        fail(f"sync {label}: round 2 (ici, dcn) {got}, hier_wire_bytes "
             f"{want}")
    fp32_dcn = comms.hier_wire_bytes(leaves, nw, topology=topology)["dcn"]
    san = results["sanitize"]
    if not san["enabled"] or san["transfer_guard_violations"]:
        fail(f"sync {label}: sanitizer {san}")
    sums = results["round_checksums"]
    split = [[len(set(r[g * nw:(g + 1) * nw])) for g in range(slices)]
             for r in sums]
    if len(sums) != len(rt) or any(k != 1 for row in split for k in row):
        fail(f"sync {label}: the workers of a slice differ after a round: "
             f"{sums}")
    differ = [len(set(r[::nw])) > 1 for r in sums]
    for r in rt:
        print(f"{tag} round {r['epoch']}: of rank 0's sync "
              f"{r['sync_ms']:.1f} ms, attributed ICI {r['sync_ms_ici']:.1f} "
              f"ms, DCN "
              f"{r['sync_ms_dcn']:.1f} ms (a byte-proportional model of one "
              "measured wall; both levels are gloo over loopback on this one "
              "card); entry gather "
              f"{r['gather_ms']:.1f} ms; wire ICI {r['sync_bytes_ici']:,} B "
              f"+ DCN {r['sync_bytes_dcn']:,} B per worker")
    print(f"{tag} engine hier, {slices} slices x {nw} workers, levels "
          f"{engine['levels']}, residency {engine['param_residency']}; "
          f"round 2's DCN {got[1] / 1e6:.3f} MB = hier_wire_bytes "
          f"({got[1] / fp32_dcn:.4f} of the fp32 outer wire's "
          f"{fp32_dcn / 1e6:.3f} MB), ICI {got[0] / 1e6:.3f} MB; "
          f"per_worker_state_bytes {engine['per_worker_state_bytes']}; "
          f"--sanitize: {san['transfer_guard_violations']} implicit syncs "
          "(a violation raises in its rank); each slice's workers bitwise "
          f"equal after every round ({len(sums)} rounds); slices differ "
          f"after rounds {[r['epoch'] for r, d in zip(rt, differ) if d]}")
    # the last checkpoint, restored in this process into rank 0's template
    ckpt_dir = extra[extra.index("--checkpoint_dir") + 1]
    latest = ckpt.latest_checkpoint(ckpt_dir)
    meta = ckpt.manifest_metadata(latest)
    named = list(model.named_parameters())
    names = [k for k, _p in named]
    template = ckpt.WorkerState(
        params={}, buffers=dict(model.named_buffers()),
        mu=dict(zip(names, st.opt.mu)), nu=dict(zip(names, st.opt.nu)),
        count=st.opt.count, lr_epoch=st.lr_epoch, rng=st.rng,
        layout=weights.state_layout(model), worker=0, n_workers=n,
        residual=(None if st.sync_residual is None
                  else dict(zip(names, st.sync_residual))),
        params_resident=st.params_resident,
        residual_outer=st.sync_residual_outer)
    t0 = time.perf_counter()
    restored, epoch = ckpt.restore_checkpoint(
        latest, template, params_template=comms.ParamsTemplate.of(
            names, [p for _k, p in named], comms.WireLayout(leaves, pieces)),
        num_slices=slices)
    restore_ms = (time.perf_counter() - t0) * 1e3
    live, back = template.tensors(), restored.tensors()
    bad = [k for k in live if k not in back or not np.array_equal(
        live[k].detach().cpu().numpy(), np.asarray(back[k]))]
    scalars = (restored.count, restored.lr_epoch, list(restored.rng)) == (
        st.opt.count, st.lr_epoch, list(st.rng))
    n_res = len(restored.residual_outer or {})
    print(f"{tag} checkpoint epoch {epoch} (manifest num_slices "
          f"{meta.get('num_slices')}) restored in this process in "
          f"{restore_ms:.1f} ms into rank 0's template: {len(live)} tensors "
          f"({len(restored.params_resident or {})} resident rows, "
          f"{n_res} outer-residual rows, inner residual "
          f"{'none: the inner wire is fp32' if restored.residual is None else len(restored.residual)}"
          f"), {len(bad)} differ from the run's state; count, clock and "
          f"seed {'equal' if scalars else 'DIFFER'}")
    if (epoch != len(rt) or bad or not scalars or meta.get("num_slices")
            != slices or not n_res or not restored.params_resident):
        fail(f"sync {label}: the checkpoint of epoch {epoch} is not the "
             f"run's state (differing {bad[:4]}, scalars {scalars}, "
             f"metadata {meta.get('num_slices')})")


def sync_jobs(n: int, work_dir: str) -> tuple[list, list]:
    """Phase 8's jobs of one process count: at n=2 the gloo probe, then the
    modes and the engines at ``n`` workers on the card, then SYNC_RUNS of
    ``n`` workers through main.  Returns ``(jobs, contexts)``: the jobs of
    main.run_shared, one start of their ranks, and per job what its check
    needs."""
    jobs, ctxs = [], []
    if n == 2:
        target, args, ctx = gloo_job(work_dir)
        jobs.append((target, args))
        ctxs.append(("gloo", ctx))
    for kind, make in (("modes", sync_modes_job),
                       ("engines", sync_engines_job)):
        target, args, ctx = make(n, work_dir)
        jobs.append((target, args))
        ctxs.append((kind, ctx))
    for label, workers, extra in SYNC_RUNS:
        if workers != n:
            continue
        argv = sync_argv(label, n, extra)
        if "--checkpoint_dir" in extra:
            shutil.rmtree(extra[extra.index("--checkpoint_dir") + 1],
                          ignore_errors=True)
        # the slices' runs check every round's parameters on every rank
        jobs.append((argv, {"round_checksums": True})
                    if "--num_slices" in extra else argv)
        ctxs.append(("run", (label, extra)))
    return jobs, ctxs


def phase_sync(one_worker_images_s: float) -> tuple[dict, dict]:
    """Phase 8: at n=2 and at n=4, one start of the ranks (main.run_shared)
    runs the gloo probe (n=2), the 12 modes and the fast engines on CUDA
    (the hierarchical one at n=4), then the N-worker runs; returns rank
    0's summed launch counts and each run's summed images/s."""
    from importlib import import_module
    main = import_module(f"{PKG}.main")
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke", "sync")
    counts, rates = {}, {}
    for n in (2, 4):
        t_group = time.perf_counter()
        jobs, ctxs = sync_jobs(n, work)
        dense_ms = None
        with main.run_shared(jobs) as runner:
            for kind, ctx in ctxs:
                t_job = time.perf_counter()
                if kind != "run":
                    runner()
                    wall = time.perf_counter() - t_job
                if kind == "gloo":
                    check_gloo(ctx)
                elif kind == "modes":
                    dense_ms = check_sync_modes(n, ctx, wall)
                elif kind == "engines":
                    check_sync_engines(n, ctx, wall, dense_ms)
                else:
                    label, extra = ctx
                    c, info = run_sync(label, n, extra, one_worker_images_s,
                                       runner)
                    counts = {k: counts.get(k, 0) + v for k, v in c.items()}
                    rates[label] = info["summed_images_s"]
        print(f"[sync] n={n}: {len(jobs)} jobs ("
              + ", ".join(k if k != "run" else ctx[0] for k, ctx in ctxs)
              + f") from one start of {n} processes in "
              f"{time.perf_counter() - t_group:.1f} s")
    print(f"[sync] phase wall {time.perf_counter() - t0:.1f} s")
    return counts, rates


def _sim_run(tag: str, argv: list[str]):
    """main.run(argv) of a --sim_workers run with the launch counters reset
    just before and read just after and the peak memory reset; returns
    (counts, results, wall s, peak bytes)."""
    import torch
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    main = import_module(f"{PKG}.main")
    torch.cuda.empty_cache()
    _peak_reset()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    results = main.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fl.LAUNCHES)
    peak = _peak()
    return counts, results, wall, peak


def _sim_rates(results) -> tuple[float, list[float], list[float],
                                 list[float]]:
    """(summed images/s over the train loops, each round's summed images/s,
    round ms, sync ms).  The first round also pays cuDNN's first use of
    the grouped convs (the probe ran the one-worker convs)."""
    rt = results["round_timings"]
    per_round = [sum(r["workers_train_steps"]) * PATH_BATCH
                 / (r["train_ms"] / 1e3) for r in rt]
    images = sum(sum(r["workers_train_steps"]) for r in rt) * PATH_BATCH
    train_s = sum(r["train_ms"] for r in rt) / 1e3
    return (images / train_s, per_round, [r["compute_ms"] for r in rt],
            [r["sync_ms"] for r in rt])


def _check_sim(tag: str, results, counts, n: int) -> None:
    """No flash launch on a CNN path, N workers, every state value
    finite."""
    import torch
    if any(counts.values()):
        fail(f"{tag}: flash kernels launched on the CNN path: {counts}")
    if results["sim"]["workers"] != n or len(
            results["all_workers_losses"]) != n:
        fail(f"{tag}: results['sim']['workers'] "
             f"{results['sim']['workers']}, expected {n}")
    state = results["state"]
    bad = [i for i, t in enumerate((*state.params, *state.buffers,
                                    *state.opt.mu, *state.opt.nu))
           if not bool(torch.isfinite(t).all())]
    if bad:
        fail(f"{tag}: non-finite state tensors {bad[:5]}")


def phase_sim_cnn(one_worker_images_s: float, sync_rates: dict) -> dict:
    """Phase sim cnn: the scenario lab on the cnn run.  N=8 weighted
    double ring non-IID (the sync phase's n4_weighted_double_ring traffic
    at N=8, 2 rounds x 2 local epochs) and its profile; N=8 equal
    all-reduce, 1 round, every parameter's 8 rows bitwise equal after the
    sync; N=32 equal all-reduce, 1 round (the lab's ceiling on one card;
    4 steps a worker, so only finite values are checked, not a falling
    loss).  Returns the summed launches."""
    import torch
    t0 = time.perf_counter()
    runs = [("sim cnn n8", 8, SIM_WEIGHTED),
            ("sim cnn n8 allreduce", 8, SIM_ALLREDUCE),
            ("sim cnn n32", 32, SIM_ALLREDUCE)]
    counts = {}
    for label, n, extra in runs:
        tag = f"[{label}]"
        argv = [*CNN_ARGV[:-1], os.path.join(OUT_DIR, label.replace(" ", "_")),
                "--sim_workers", str(n), *extra]
        c, results, wall, peak = _sim_run(tag, argv)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        _check_sim(tag, results, c, n)
        losses = [x for w in results["all_workers_losses"] for x in w]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{tag}: non-finite losses")
        first = results["all_workers_losses"][0][0]
        last = results["worker_specific_train_losses"][-1]
        if n == 8:
            first, last = check_losses(label, results)
        rate, per_round, round_ms, sync_ms = _sim_rates(results)
        s = results["sim"]
        state = results["state"]
        print(f"{tag} launches {c} (no attention: all 0); {n} workers in "
              f"one process; wall {wall:.1f} s; summed images/s {rate:.0f}, "
              f"per round {[round(x) for x in per_round]} (the cnn phase's "
              f"one worker {one_worker_images_s:.0f}"
              + "".join(f"; {k} {v:.0f}" for k, v in sync_rates.items())
              + f"); round ms {[round(x, 1) for x in round_ms]}; stacked "
              f"blend sync ms {[round(x, 3) for x in sync_ms]}; "
              f"per_worker_sync_bytes {s['per_worker_sync_bytes']:,}; "
              f"per-worker state {s['per_worker_state_bytes']['params']:,} "
              f"params + {s['per_worker_state_bytes']['opt_state']:,} Adam "
              f"bytes; max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"first-batch loss {first:.4f} -> last-epoch mean {last:.4f}")
        if label == "sim cnn n8 allreduce":
            differ = [i for i, p in enumerate(state.params)
                      if not all(torch.equal(p[0], p[r]) for r in range(n))]
            print(f"{tag} after the equal all-reduce: {len(differ)} of "
                  f"{len(state.params)} parameters differ between rows")
            if differ:
                fail(f"{tag}: rows differ after an equal all-reduce in "
                     f"parameters {differ[:5]}")
        if label == "sim cnn n32" and not peak < 80e9:
            fail(f"{tag}: peak {peak / 2**30:.2f} GiB")
        if label == "sim cnn n8":
            MEMORY_ROWS[label] = results["memory"]
            rt = results["round_timings"]
            MFU_RUNS[label] = dict(
                argv=argv, num_classes=10,
                example=list(results["test"].images.shape[1:]),
                tokens=False, workers=n,
                step_ms=(sum(r["train_ms"] for r in rt)
                         / sum(r["train_steps"] for r in rt)))
            phase_profile_sim(results, argv)
        del results, state
        torch.cuda.empty_cache()
    print(f"[sim cnn] phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def phase_sim_parity() -> dict:
    """Phase sim parity n2: --sim_workers 2 against 2 worker processes of
    the same argv (fp32 compute, TF32 off in all three processes through
    NVIDIA_TF32_OVERRIDE=0, which the spawned rank inherits; 1 round, 1
    local epoch, 1,024 images), from the same seeded init (the spy records
    it): each reading of SIM_PARITY_TOL within its limit, and worker 0's
    parameters within 2 lr per Adam step.  Returns the readings."""
    import numpy as np
    from importlib import import_module
    from unittest import mock
    t_driver = import_module(f"{PKG}.driver")
    main = import_module(f"{PKG}.main")
    t0 = time.perf_counter()
    out = os.path.join(OUT_DIR, "sim_parity")
    inits = []
    with mock.patch.object(t_driver, "build_model_for",
                           _recording_inits(t_driver, inits)):
        sim = _sim_run("[sim parity n2]",
                       [*SIM_PARITY_ARGV, "--out_dir", out,
                        "--sim_workers", "2"])[1]
    old = os.environ.get("NVIDIA_TF32_OVERRIDE")
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    try:
        real = main.run([*SIM_PARITY_ARGV, "--out_dir", out,
                         "--num_workers", "2"])
    finally:
        if old is None:
            os.environ.pop("NVIDIA_TF32_OVERRIDE")
        else:
            os.environ["NVIDIA_TF32_OVERRIDE"] = old
    if sim["shard_sizes"] != real["shard_sizes"]:
        fail(f"sim parity: shards {sim['shard_sizes']} vs "
             f"{real['shard_sizes']}")
    got = dict(first=0.0, second=0.0, losses=0.0)
    for w in range(2):
        a = np.asarray(sim["all_workers_losses"][w])
        b = np.asarray(real["all_workers_losses"][w])
        if a.shape != b.shape or len(a) < 2:
            fail(f"sim parity: worker {w} ran {a.shape} vs {b.shape} steps")
        rel = np.abs(a - b) / np.abs(b)
        got["first"] = max(got["first"], float(rel[0]))
        got["second"] = max(got["second"], float(rel[1]))
        got["losses"] = max(got["losses"], float(rel.max()))
    a = np.asarray(sim["worker_specific_val_losses"])
    b = np.asarray(real["worker_specific_val_losses"])
    got["val"] = float(np.max(np.abs(a - b) / np.abs(b)))
    sums = {"update": [0.0, 0.0], "stats": [0.0, 0.0]}
    p_max = 0.0
    for k, v in real["variables"].items():
        v = v.float().cpu()
        d = sim["variables"][k].float().cpu() - v
        key = "stats" if ".running_" in k else "update"
        ref = v if key == "stats" else v - inits[0][k]
        sums[key][0] += float(d.square().sum())
        sums[key][1] += float(ref.square().sum())
        if key == "update":
            p_max = max(p_max, float(d.abs().max()))
    for key, (num, den) in sums.items():
        got[key] = math.sqrt(num / den)
    steps = int(sim["state"].opt.count[0])
    bound = 2 * SIM_PARITY_LR * steps
    print(f"[sim parity n2] --sim_workers 2 vs 2 worker processes, fp32, lr "
          f"{SIM_PARITY_LR}, {steps} Adam steps a worker; relative "
          f"differences (limit): "
          + ", ".join(f"{k} {got[k]:.3g} ({SIM_PARITY_TOL[k]})"
                      for k in SIM_PARITY_TOL)
          + f"; worker 0's parameters {p_max:.3g} at most (bound 2 lr x "
          f"steps = {bound:.3g}); wall {time.perf_counter() - t0:.1f} s")
    if p_max > bound or any(got[k] > SIM_PARITY_TOL[k]
                            for k in SIM_PARITY_TOL):
        fail("sim parity: the simulated run departs from the worker "
             "processes beyond the stated limits")
    return got


def phase_sim_scenario() -> None:
    """Phase sim scenario: N=8 cnn, 2 rounds x 1 local epoch on 1,024
    images with every scenario knob: the active/dropped counts equal the
    numpy draw for --seed, a dropped worker's parameters and moments are
    bitwise unchanged across its round, every value finite."""
    import numpy as np
    import torch
    from importlib import import_module
    from unittest import mock
    sim_mod = import_module(f"{PKG}.sim")
    t0 = time.perf_counter()
    draws, frozen = [], []
    start_fn, draw_fn = sim_mod.SimEngine.round_start, \
        sim_mod.SimEngine._draw_scenario

    def spy_draw(self):
        d = draw_fn(self)
        draws.append(d)
        return d

    def spy_round(self, state, *packs):
        before = [t.clone() for t in (*state.params, *state.opt.mu,
                                      *state.opt.nu)]
        state, handle = start_fn(self, state, *packs)
        after = (*state.params, *state.opt.mu, *state.opt.nu)
        for i in np.flatnonzero(draws[-1][1]):
            frozen.append((len(draws) - 1, int(i), all(
                torch.equal(a[i], b[i]) for a, b in zip(after, before))))
        return state, handle

    argv = [*CNN_ARGV[:-1], os.path.join(OUT_DIR, "sim_scenario"),
            "--sim_workers", "8", "--aggregation_by", "weights",
            "--epochs_local", "1", "--limit_train_samples", "1024",
            "--limit_eval_samples", "256", *SIM_SCENARIO]
    with mock.patch.object(sim_mod.SimEngine, "round_start", spy_round), \
            mock.patch.object(sim_mod.SimEngine, "_draw_scenario",
                              spy_draw):
        counts, results, wall, peak = _sim_run("[sim scenario]", argv)
    _check_sim("[sim scenario]", results, counts, 8)
    seed = import_module(f"{PKG}.config").config_from_args(argv).seed
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x51AB]))
    want = []
    for _ in results["sim"]["rounds_scenario"]:
        part = np.zeros(8, bool)
        part[rng.choice(8, size=4, replace=False)] = True
        dropped = rng.random(8) < 0.125
        want.append({"active": int((part & ~dropped).sum()),
                     "dropped": int(dropped.sum()), "byzantine": 1})
    got = results["sim"]["rounds_scenario"]
    losses = [x for w in results["all_workers_losses"] for x in w]
    print(f"[sim scenario] rounds_scenario {got} (numpy draw for --seed "
          f"{seed}: {want}); dropped rows frozen bitwise "
          f"{[(r, i, ok) for r, i, ok in frozen]}; staleness "
          f"{results['sim']['staleness']}; wall {wall:.1f} s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if got != want or not frozen or not all(ok for *_, ok in frozen):
        fail("sim scenario: draws or frozen rows differ from the seed's")
    if not all(math.isfinite(x) for x in losses):
        fail("sim scenario: non-finite losses")
    print(f"[sim scenario] phase wall {time.perf_counter() - t0:.1f} s")


def phase_sim_gpt2() -> dict:
    """Phase sim gpt2 n4: the gpt2 path with --sim_workers 4 (flash
    two-pass): ``drive`` checks one launch per layer per pass for all 4
    workers (the sim's own step counts), then the flash-vs-dense check on
    worker 0's logits.  Returns the counts."""
    import numpy as np
    import torch
    from importlib import import_module
    train = import_module(f"{PKG}.train")
    argv = [*PATHS["gpt2"][0][:-1], os.path.join(OUT_DIR, "sim_gpt2"),
            "--sim_workers", "4"]
    torch.cuda.empty_cache()
    counts, results, wall, peak = drive("[sim gpt2 n4]", argv,
                                        PATHS["gpt2"][1])
    rt = results["round_timings"]
    steps = sum(r["train_steps"] for r in rt)
    val = sum(r["val_steps"] for r in rt)
    if steps != 4 or val != 1 or results["sim"]["workers"] != 4:
        fail(f"sim gpt2: {steps} vmapped train steps and {val} val steps "
             "(expected 4 and 1)")
    first, last = check_losses("sim gpt2", results)
    model = results["model"]
    x = train.to_device(np.asarray(results["test"].images[:4]),
                        next(model.parameters()).device)
    flash_vs_dense("sim gpt2 n4", model, x)
    tokens = (sum(sum(r["workers_train_steps"]) for r in rt) * PATH_BATCH
              * PATH_LEN)
    train_ms = sum(r["train_ms"] for r in rt)
    print(f"[sim gpt2 n4] 4 x {sum(p.numel() for p in model.parameters()):,}"
          f" params in one process; {steps} vmapped train steps "
          f"(step {train_ms / steps:.3f} ms for 4 x {PATH_BATCH} sequences); "
          f"{tokens / (train_ms / 1e3):.0f} tokens/s summed; wall "
          f"{wall:.1f} s; first-batch loss {first:.4f} -> last-epoch mean "
          f"{last:.4f}; max_memory_allocated {peak / 2**30:.2f} GiB")
    del results, model
    torch.cuda.empty_cache()
    return counts


def phase_profile_sim(results, argv: list[str]) -> None:
    """Phase profile sim cnn n8: one more round of PROFILE_STEPS vmapped
    train steps + 1 val step of the N=8 run's trained state under
    torch.profiler, every worker on the same test images."""
    import numpy as np
    from importlib import import_module
    cfg = import_module(f"{PKG}.config").config_from_args(
        [*argv, "--epochs_local", "1"])
    sim_mod = import_module(f"{PKG}.sim")
    device = next(results["model"].parameters()).device
    engine = sim_mod.SimEngine(results["model"], cfg, device)
    state = results["state"]
    test = results["test"]
    k = PROFILE_STEPS * PATH_BATCH
    n = cfg.sim_workers
    shape = (1, PROFILE_STEPS, PATH_BATCH)
    one = (test.images[:k].reshape(shape + test.images.shape[1:]),
           test.labels[:k].reshape(shape), np.ones(shape, np.float32))
    pack = tuple(np.repeat(a, n, axis=0) for a in one)
    val = tuple(a[:, :1] for a in pack)
    profile_window("[profile sim cnn n8]",
                   f"{PROFILE_STEPS} vmapped train steps + 1 val step of "
                   f"{n} workers", lambda: engine.round(state, pack, val),
                   device)


def _round_rows(tag: str, flow: str, rows: list) -> None:
    for r in rows:
        print(f"{tag} {flow} round {r['epoch']}: "
              + ", ".join(f"{k} {r[k]:.3f}" if k in r else f"{k} -"
                          for k in OVERLAP_KEYS))


def _spy_partitions(t_driver, out: list):
    """``t_driver._capped`` recording a digest of every shard set packed
    (the prep thread's calls too); returns the original."""
    import hashlib
    import numpy as np
    real = t_driver._capped

    def spy(parts, batch, caps=None):
        h = hashlib.sha256()
        for p in parts:
            h.update(np.asarray(p, np.int64).tobytes())
        out.append(h.hexdigest())
        return real(parts, batch, caps)
    t_driver._capped = spy
    return real


def overlap_cfgs(n: int) -> list:
    """The overlap phase's pair at ``n`` workers: ``(tag, flow, config,
    train_kwargs)`` of the serial and the overlapped run, the probe and
    the walls pinned."""
    import functools
    import operator
    from importlib import import_module
    config = import_module(f"{PKG}.config")
    tag, argv = (("[overlap cnn]", OVERLAP_ARGV) if n == 1
                 else ("[overlap cnn n4]", OVERLAP_N4_ARGV))
    out = []
    for flow in ("serial", "overlapped"):
        cfg = config.config_from_args(
            argv + (["--no_overlap_rounds"] if flow == "serial" else []))
        kw = dict(simulated_durations=OVERLAP_PROBE[:n],
                  simulated_round_durations=functools.partial(
                      operator.getitem, [w[:n] for w in OVERLAP_WALLS]),
                  progress=False)
        out.append((tag, flow, cfg, kw))
    return out


def overlap_pair(n: int, run) -> dict:
    """Phase overlap cnn at ``n`` workers: the serial and the overlapped
    run (``run(cfg, kw)`` runs one: in this process at n=1, the next run of
    the deterministic child's shared start at n=4); every metric list, the
    parameters (every rank's checksum at N=4) and the partitions equal to
    the bit; each round's stage/compute/fetch/assemble/prep/gap ms of both
    flows and the rounds' total wall.  Returns the serial run's metric
    lists, parameter checksums and partitions."""
    import torch
    from importlib import import_module
    t_driver = import_module(f"{PKG}.driver")
    keys = ("all_workers_losses", "global_train_losses", "global_val_losses",
            "global_train_accuracies", "worker_specific_train_losses",
            "step_caps", "shard_sizes")
    runs = {}
    for tag, flow, cfg, kw in overlap_cfgs(n):
        parts: list = []
        real = _spy_partitions(t_driver, parts)
        t1 = time.perf_counter()
        try:
            res = run(cfg, kw)
        finally:
            t_driver._capped = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        rows = res["round_timings"]
        rounds_ms = sum(r["compute_ms"] for r in rows) + sum(
            r.get("gap_ms", 0.0) for r in rows)
        runs[flow] = (res, parts)
        _round_rows(tag, flow, rows)
        print(f"{tag} {flow}: rounds' total wall (compute + gaps) "
              f"{rounds_ms:.1f} ms; gap_ms "
              f"{[r['gap_ms'] for r in rows if 'gap_ms' in r]}; run wall "
              f"{wall:.1f} s")
        del res
    (a, pa), (b, pb) = runs["serial"], runs["overlapped"]
    same = [k for k in keys if a[k] != b[k]]
    if n == 1:
        params = all(torch.equal(a["variables"][k], b["variables"][k])
                     for k in a["variables"])
    else:
        params = a["param_checksums"] == b["param_checksums"]
    print(f"{tag} serial vs overlapped: metrics "
          f"{'bitwise equal' if not same else f'DIFFER in {same}'}; "
          f"parameters{' on every rank' if n > 1 else ''}"
          f" {'bitwise equal' if params else 'DIFFER'}; partitions "
          f"{'equal' if pa == pb else 'DIFFER'} ({len(set(pa))} distinct "
          "shard sets packed)")
    if same or not params or pa != pb or not pa:
        fail(f"{tag}: the overlapped run is not bitwise the serial run")
    return {**{k: a[k] for k in MULTIHOST_METRICS if k in a}, "parts": pa}


def _release_card() -> None:
    """Rank 0 of the next runs lives in this process: leave nothing of the
    last ones on the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _sync_debug_probe() -> dict:
    """Which host waits torch's sync-debug mode counts on this card: each
    call under set_sync_debug_mode("error"), raised or passed."""
    import numpy as np
    import torch
    x = torch.ones(1024, device="cuda")
    ev = torch.cuda.Event()
    side = torch.cuda.Stream()
    pinned = torch.empty(1024, pin_memory=True)
    calls = {
        "torch.cuda.synchronize()": torch.cuda.synchronize,
        "Event.synchronize()": lambda: (ev.record(), ev.synchronize()),
        "Event.query()": lambda: (ev.record(), ev.query()),
        "Stream.synchronize()": side.synchronize,
        "pinned D2H non_blocking": lambda: pinned.copy_(
            x, non_blocking=True),
        "tensor.item()": lambda: x.sum().item(),
        "tensor.cpu()": lambda: x.cpu(),
        "H2D torch.as_tensor(numpy)": lambda: torch.as_tensor(
            np.ones(4, np.float32), device="cuda"),
        "tensor.nonzero()": lambda: x.nonzero(),
    }
    out = {}
    for name, fn in calls.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[name] = "passes"
        except RuntimeError as e:
            out[name] = ("counts" if "synchronizing" in str(e)
                         else f"error {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def _findings_guard(found: list):
    """A stand-in for the driver's ``_round_guard`` that lists every
    implicit sync of the guarded rounds instead of raising at the first:
    the warn mode, each warning's Python location."""
    import contextlib
    import warnings
    import torch

    @contextlib.contextmanager
    def guard(san, device):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for w in rec:
            if "synchronizing" in str(w.message):
                path = os.path.relpath(w.filename, ROOT)
                found.append(f"{path}:{w.lineno}")
    return guard


def phase_sanitize() -> None:
    """Phase sanitize: which host waits count under the sync-debug mode;
    --sanitize on the cnn and gpt2 paths (2 short rounds): clean, every
    counter 0; an .item() planted in the train step: counted once and
    raised; then what the guard finds on every path, listed by place
    (warn mode), which fails nothing."""
    import collections
    import torch
    from importlib import import_module
    t_driver = import_module(f"{PKG}.driver")
    t_train = import_module(f"{PKG}.train")
    config = import_module(f"{PKG}.config")
    t0 = time.perf_counter()
    tag = "[sanitize]"
    for name, verdict in _sync_debug_probe().items():
        print(f"{tag} under the sync-debug mode: {name} {verdict}")
    run = lambda argv: t_driver.train_global(
        config.config_from_args([*argv, "--sanitize"]), progress=False)
    for name in SANITIZE_CLEAN:
        res = run(SANITIZE_RUNS[name])
        san = res["sanitize"]
        print(f"{tag} {name}: {json.dumps(san)}")
        if not san["enabled"] or any(san[k] for k in (
                "transfer_guard_violations", "retrace_count",
                "recompile_count", "donation_failures")):
            fail(f"sanitize: the {name} path is not clean: {san}")
    guards = []
    real_guard, real_step = t_driver._round_guard, t_train.LocalSGDEngine._train_step

    def spy(san, device):
        guards.append(san)
        return real_guard(san, device)

    def planted(self, *args):
        out = real_step(self, *args)
        out[0].item()                  # the planted implicit sync
        return out

    t_driver._round_guard, t_train.LocalSGDEngine._train_step = spy, planted
    err = None
    try:
        run(SANITIZE_RUNS["cnn"])
    except RuntimeError as e:
        err = e
    finally:
        t_driver._round_guard = real_guard
        t_train.LocalSGDEngine._train_step = real_step
    count = guards[0]["transfer_guard_violations"] if guards else None
    print(f"{tag} planted .item() in the train step: raised "
          f"{type(err).__name__ if err else None}; "
          f"transfer_guard_violations {count}")
    if err is None or t_driver.SYNC_DEBUG_ERROR not in str(err) or count != 1:
        fail(f"sanitize: the planted sync was not caught ({err!r}, {count})")
    for name, argv in SANITIZE_RUNS.items():
        found: list = []
        t_driver._round_guard = _findings_guard(found)
        try:
            run(argv)
        finally:
            t_driver._round_guard = real_guard
        sites = collections.Counter(found)
        print(f"{tag} findings {name}: "
              + (", ".join(f"{k} x{v}" for k, v in sites.most_common())
                 or "none"))
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")


def phase_profile_dir() -> None:
    """Phase profile_dir: one short cnn run with --profile_dir; the trace
    file is there and holds CUDA kernel rows."""
    from importlib import import_module
    t_driver = import_module(f"{PKG}.driver")
    config = import_module(f"{PKG}.config")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    t_driver.train_global(config.config_from_args(
        [*SANITIZE_RUNS["cnn"], "--epochs_global", "1", "--profile_dir",
         PROFILE_DIR]), progress=False)
    wall = time.perf_counter() - t0
    path = os.path.join(PROFILE_DIR, "trace_rank0.json")
    if not os.path.isfile(path):
        fail(f"profile_dir: no trace at {path}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"[profile_dir] {os.path.relpath(path, ROOT)}: "
          f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events, "
          f"{len(kernels)} CUDA kernel rows "
          f"({sum(e.get('dur', 0) for e in kernels) / 1e3:.1f} ms of "
          f"kernels); run wall {wall:.1f} s")
    if not kernels:
        fail("profile_dir: the trace holds no CUDA kernel row")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)


def phase_memory() -> None:
    """Phase memory: the memory rows of the cnn, gpt2 and sim cnn n8 runs
    and of the serve gpt2 telemetry (available, every registered program
    present); the lab's stacked total N x per worker; a peak reached
    before a tracked program's first call surviving in the process peak;
    bert's train-step temp bytes down the remat ladder."""
    import gc
    import torch
    from importlib import import_module
    probe = import_module(f"{PKG}.probe")
    tag = "[memory]"
    for label, want in MEMORY_PROGRAMS.items():
        mem = MEMORY_ROWS.get(label)
        if mem is None:
            fail(f"memory: no row from the {label} run")
        rows = {k: [(r["temp_bytes"], r["argument_bytes"], r["output_bytes"],
                     r["alias_bytes"]) for r in v]
                for k, v in mem["programs"].items()}
        print(f"{tag} {label}: available {mem['available']}; programs "
              f"(temp, argument, output, alias bytes) {rows}; unavailable "
              f"{mem['programs_unavailable']}; temp total "
              f"{mem['temp_bytes_total']:,}"
              + (f"; per-worker resident {mem['per_worker_resident_bytes']:,}"
                 f", state total {mem['state_bytes_total']:,} over "
                 f"{mem['workers']} worker(s)"
                 if "state_bytes_total" in mem else ""))
        if not mem["available"] or set(mem["programs"]) != want:
            fail(f"memory: {label}'s row is not available with programs "
                 f"{sorted(want)}: {sorted(mem['programs'])}, unavailable "
                 f"{mem['programs_unavailable']}")
    sim = MEMORY_ROWS["sim cnn n8"]
    if sim["state_bytes_total"] != 8 * sim["per_worker_resident_bytes"]:
        fail("memory: the lab's state total is not 8 x per worker")
    dev = torch.device("cuda")
    gc.collect()                     # no garbage freed under the check
    probe.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    big = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    del big
    probe.TrackedProgram("peak_check", lambda a: a * 2)(
        torch.ones(1 << 20, device=dev))
    card, process = torch.cuda.max_memory_allocated(dev), _peak()
    print(f"{tag} 1 GiB allocated and freed over {base / 2**30:.3f} GiB "
          f"held, then a tracked program: the card's peak statistic "
          f"{card / 2**30:.3f} GiB (reset by the program's measurement), "
          f"the process peak {process / 2**30:.3f} GiB")
    if not (process >= base + (1 << 30) > card):
        fail("memory: the process peak lost a peak to the probe's reset")
    ladder = [REMAT_TEMP.get(f"remat {p}") for p in
              ("none", "dots_saveable", "everything")]
    print(f"{tag} bert train_step temp_bytes: none {ladder[0]:,}, "
          f"dots_saveable {ladder[1]:,}, everything {ladder[2]:,}; "
          + ", ".join(f"{k.removeprefix('remat ')} {v:,}"
                      for k, v in REMAT_TEMP.items()
                      if k.removeprefix("remat ") not in
                      ("none", "dots_saveable", "everything")))
    if not ladder[0] >= ladder[1] >= ladder[2]:
        fail(f"memory: bert's temp bytes break the remat ladder {ladder}")


def phase_mfu(smi: str) -> None:
    """Phase mfu: each path's FLOPs per train step, counted on its dense
    twin on the meta device (the flash ops are opaque to the counter;
    JAX's benchmark uses the dense formulation too), and its MFU from the
    step time of this call; first the count against 2*M*N*K of one
    matmul layer."""
    import dataclasses
    import torch
    from importlib import import_module
    t_driver = import_module(f"{PKG}.driver")
    config = import_module(f"{PKG}.config")
    flops = import_module(f"{PKG}.utils.flops")
    m, k, n = MFU_LINEAR
    layer = torch.nn.Linear(k, n, bias=False, device="meta")
    got = flops.compiled_flops(layer, torch.empty(m, k, device="meta"))
    print(f"[mfu] one [{m}, {k}] x [{k}, {n}] layer: counted {got:.0f}, "
          f"2*M*N*K {2 * m * n * k}")
    if not abs(got - 2 * m * n * k) <= MFU_RTOL * 2 * m * n * k:
        fail("mfu: the FLOP count of one matmul layer is not 2*M*N*K")
    dev = torch.device("cuda")
    peak = flops.peak_flops(dev)
    print(f"[mfu] card {torch.cuda.get_device_name(0)} ({smi}); peak "
          f"{peak} FLOP/s bf16 dense, HBM {flops.hbm_bytes_per_sec(dev)} B/s "
          "(data sheet)")
    for name, run in MFU_RUNS.items():
        cfg = dataclasses.replace(config.config_from_args(run["argv"]),
                                  attention_impl="dense")
        model = t_driver.build_model_for(cfg, run["num_classes"],
                                         torch.device("meta"),
                                         tuple(run["example"]))
        x = torch.empty((PATH_BATCH, *run["example"]), device="meta",
                        dtype=torch.long if run["tokens"] else torch.float32)
        step = run["workers"] * flops.train_step_flops(model, x)
        mfu = flops.mfu(step, run["step_ms"] / 1e3, dev)
        print(f"[mfu] {name}: {step / 1e12:.4f} TFLOP per train step"
              + (f" ({run['workers']} workers)" if run["workers"] > 1
                 else "")
              + f", step {run['step_ms']:.3f} ms, "
              f"{step / (run['step_ms'] / 1e3) / 1e12:.1f} TFLOP/s, MFU "
              + (f"{100 * mfu:.2f} %" if mfu is not None else "not known"))


def llama_child() -> int:
    """The llama path, run in a child process whose environment has
    FLASH_BWD=fused before the port is imported; prints its counts as one
    tagged JSON line for the parent."""
    from importlib import import_module
    if not import_module(f"{PKG}.ops.flash")._use_fused_bwd():
        fail("the llama child does not see FLASH_BWD=fused")
    shutil.rmtree(LLAMA_CKPT_DIR, ignore_errors=True)
    counts, results = run_path("llama")
    r, summary = results["round_timings"][0], results["checkpoint"]
    print(f"[ckpt llama] one save of {summary['bytes_per_host']:,} payload "
          f"bytes: snapshot {r['ckpt_snapshot_ms']:.3f} ms, write "
          f"{r['ckpt_write_ms']:.3f} ms (writer thread), train "
          f"{r['train_ms']:.1f} ms")
    phase_profile("llama", results, PATHS["llama"][0])
    del results
    import torch
    torch.cuda.empty_cache()
    phase_serve("llama", LLAMA_CKPT_DIR)
    shutil.rmtree(LLAMA_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    tp_counts = tp_llama()
    print(RESULT_TAG + json.dumps({"counts": counts,
                                   "mfu": MFU_RUNS["llama"],
                                   "tp_counts": tp_counts}), flush=True)
    return 0


def start_llama() -> tuple:
    """Start llama_child in a child process with FLASH_BWD=fused, its
    output going to files (it runs beside the sync phase: a pipe nobody
    reads meanwhile could fill and stall it); ``phase_llama`` ends it."""
    env = {**os.environ, "FLASH_BWD": "fused"}
    os.makedirs(OUT_DIR, exist_ok=True)
    logs = (os.path.join(OUT_DIR, "llama_child.out"),
            os.path.join(OUT_DIR, "llama_child.err"))
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 LLAMA_PHASE], env=env, stdout=out,
                                stderr=err, text=True,
                                start_new_session=True)
    return proc, logs


def phase_llama(started: tuple) -> dict:
    """Wait for the llama child ``start_llama`` started (900 s at most:
    then it is killed with the ranks it spawned); echo its output and
    return its launch counts."""
    proc, (out_path, err_path) = started
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
    _end_session(proc, "the llama child")
    result = None
    with open(out_path) as f:
        for line in f.read().splitlines():
            if line.startswith(RESULT_TAG):
                result = json.loads(line[len(RESULT_TAG):])
            else:
                print(line)
    if proc.returncode != 0 or result is None:
        with open(err_path) as f:
            sys.stderr.write(f.read()[-6000:])
        fail(f"the llama child exited with {proc.returncode}"
             + ("" if result else " and printed no result line"))
    MFU_RUNS["llama"] = result["mfu"]
    GRID_COUNTS["tp_llama"] = result["tp_counts"]
    return result["counts"]


def _deterministic() -> None:
    """``torch.use_deterministic_algorithms(True)`` for eager code: its
    flag alone.  The public call also imports ``torch._inductor`` to set
    the compiler's flag, 8-13 s of a process's start on an H100 host
    (measured with ``python -X importtime``), and nothing here
    compiles."""
    import torch
    setter = getattr(torch._C, "_set_deterministic_algorithms", None)
    if setter is None:
        torch.use_deterministic_algorithms(True)
    else:
        setter(True)


def elastic_rank(*args) -> None:
    """A spawned rank of the elastic phase (``driver.rank_entry``'s
    arguments): deterministic algorithms on, then the port's worker."""
    from importlib import import_module
    _deterministic()
    import_module(f"{PKG}.main")._worker(*args)


def _elastic_kw(cfg, n: int, snapshot=None, checksums: bool = True) -> dict:
    """The elastic phase's driver arguments: the walls pinned; a run
    without chaos reads one wall per rank, and its probe is pinned too
    (the replicated and resident runs must train the same shards)."""
    import functools
    import operator
    elastic = bool(cfg.chaos) or snapshot is not None
    walls = ELASTIC_WALLS if elastic else [w[:n] for w in ELASTIC_WALLS]
    kw = dict(simulated_round_durations=functools.partial(
        operator.getitem, walls), progress=False, round_checksums=checksums)
    if not elastic:
        kw["simulated_durations"] = [1.0] * n
    return kw


def elastic_jobs(snap_dir: str) -> tuple[list, dict]:
    """The chaos runs of the deterministic child's shared start, in the
    order it runs them: [elastic tp gpt2]'s run (6 ranks) and its fresh
    twin, then [elastic cnn n4]'s run, its twin and its planted twin (4
    ranks each); a twin's snapshot is written into its directory of
    ``snap_dir`` before its job runs.  Returns the jobs and the
    directories."""
    from importlib import import_module
    config = import_module(f"{PKG}.config")
    dirs = {k: os.path.join(snap_dir, k)
            for k in ("tp_twin", "cnn_twin", "cnn_planted")}

    def job(argv, ranks, snapshot=None):
        cfg = config.config_from_args(argv)
        kw = _elastic_kw(cfg, ranks)
        if snapshot is not None:
            kw["elastic_snapshot"] = dirs[snapshot]
        return cfg, kw, ranks
    tp, cnn = ([*ELASTIC_TP_ARGV, *ELASTIC_TP_CHAOS],
               [*ELASTIC_ARGV, *ELASTIC_CHAOS])
    # a twin runs one round: the round after its snapshot
    one_round = lambda e: ["--epochs_global", str(e + 1)]
    return [job(tp, 6),
            job([*tp, *one_round(ELASTIC_TP_TWIN_EPOCH)], 4, "tp_twin"),
            job(cnn, 4), job(cnn, 4, "cnn_twin"),
            job([*cnn, *one_round(ELASTIC_TWIN_EPOCH)], 4, "cnn_planted")
            ], dirs


def _timed(start) -> tuple[dict, float]:
    """The shared start's next job: rank 0's results and the wall."""
    t0 = time.perf_counter()
    res = start.run()
    return res, time.perf_counter() - t0


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in a if ".running_" not in k)


def _planted_joiner(snap):
    """The snapshot with one fault planted: the joiner's per-worker rows
    (Adam moments and count, BatchNorm statistics, clock) cloned from the
    second survivor instead of the first."""
    import copy
    import numpy as np
    bad = copy.copy(snap)
    host = copy.copy(snap.host_state)
    j = snap.worker_ids.index(max(snap.worker_ids))
    for part in ("mu", "nu", "buffers"):
        tree = {k: np.array(v) for k, v in getattr(host, part).items()}
        for v in tree.values():
            v[j] = v[1]
        setattr(host, part, tree)
    bad.host_state = host
    return bad


def elastic_cnn(start, dirs: dict) -> dict:
    """Phase elastic cnn n4, in the deterministic child (whose environment
    sets CUBLAS_WORKSPACE_CONFIG before CUDA starts; its ranks inherit
    it), under torch.use_deterministic_algorithms: the chaos run, its
    fresh twin from the round-2 snapshot and a twin from a planted fault
    (``start``'s next three jobs).  Returns the summary."""
    import torch
    from importlib import import_module
    elastic_lib = import_module(f"{PKG}.elastic")
    tag = "[elastic cnn n4]"
    res, wall = _timed(start)
    el, rt = res["elastic"], res["round_timings"]
    eng = res["sync_engine"]
    print(f"{tag} engine {eng['mode']}, residency {eng['param_residency']}"
          f"; wall {wall:.1f} s; events {el['events']}; rejected "
          f"{el['rejected']}; reshard_ms {el['reshard_ms']}; boundary_ms "
          f"(rank 0's snapshot build + write) {el['boundary_ms']}; "
          f"recovery_ms {el['recovery_ms']} via {el['recovery_source']}")
    for r, sums in zip(rt, res["round_checksums"]):
        applied = [e for e in el["events"] if e["round"] == r["epoch"]]
        print(f"{tag} round {r['epoch']}: roster {r['worker_ids']}; events "
              f"{applied}; sync ms per rank "
              + str([round(x, 1) for x in r["workers_sync_ms"]])
              + f"; entry gather {r['gather_ms']:.1f} ms (rank 0); wire "
              f"{r['sync_bytes']:,} B per worker of which buddy "
              f"{r['sync_buddy_bytes']:,} B; sync_ok {r.get('sync_ok')}; "
              "held after the sync (GiB) "
              + str([round(x / 2**30, 3) for x in r["workers_memory_allocated"]])
              + "; max_memory_allocated (GiB) "
              + str([round(x / 2**30, 2)
                     for x in r["workers_max_memory_allocated"]])
              + f"; param checksums {'all equal' if len(set(sums)) == 1 else 'DIFFER'}")
    print(f"{tag} per_worker_state_bytes {eng['per_worker_state_bytes']}")
    if el["rosters"] != ELASTIC_ROSTERS:
        fail(f"elastic: rosters {el['rosters']}, expected {ELASTIC_ROSTERS}")
    if (el["crashes"], el["recoveries"], el["recovery_source"]) != (
            1, 1, ["buddy"]):
        fail(f"elastic: crash recovery {el['crashes']} crash(es), "
             f"{el['recoveries']} recoveries via {el['recovery_source']}")
    if [r["epoch"] for r in rt] != list(range(5)):
        fail(f"elastic: rounds run {[r['epoch'] for r in rt]}")
    strikes = {r["epoch"]: r.get("sync_ok", []).count(0.0) for r in rt}
    if el["quarantined_rounds"] != 1 or strikes.get(4) != 1:
        fail(f"elastic: quarantine strikes {strikes}, "
             f"{el['quarantined_rounds']} quarantined round(s)")
    for k in ("global_train_losses", "global_val_losses"):
        if not all(math.isfinite(x) for x in res[k]):
            fail(f"elastic: non-finite {k}: {res[k]}")
    if any(len(set(s)) != 1 for s in res["round_checksums"]):
        fail(f"elastic: ranks differ after an equal all-reduce round: "
             f"{res['round_checksums']}")
    losses = res["global_train_losses"]
    if not losses[-1] < losses[0]:
        fail(f"elastic: the loss did not fall: {losses}")

    snap = el["snapshots"][ELASTIC_TWIN_SNAPSHOT]
    e = snap.epoch
    if (e, snap.n_workers) != (ELASTIC_TWIN_EPOCH, 4):
        fail(f"elastic: the twin's snapshot is round {e}'s of "
             f"{snap.n_workers} workers")
    elastic_lib.save_snapshot(snap, dirs["cnn_twin"])
    twin, twin_wall = _timed(start)
    sound = _max_diff(twin["variables"], res["variables"])
    bitwise = (twin["param_checksums"] == res["param_checksums"]
               and twin["global_train_losses"] == losses[e:]
               and twin["round_checksums"] == res["round_checksums"][e:])
    # one round from the planted snapshot is enough to see the fault:
    # held against the continued run's parameters after that round
    elastic_lib.save_snapshot(_planted_joiner(snap), dirs["cnn_planted"])
    bad, bad_wall = _timed(start)
    planted_differs = bad["round_checksums"][0] != res["round_checksums"][e]
    print(f"{tag} twin from the round-{e} snapshot (roster "
          f"{snap.worker_ids}): bitwise {bitwise}; max |param diff| at the "
          f"end {sound:.3g}; with the joiner cloning the wrong row "
          f"(planted) the parameters after round {e} "
          f"{'differ' if planted_differs else 'EQUAL'}; twin wall "
          f"{twin_wall:.1f} s, planted {bad_wall:.1f} s")
    if not bitwise or sound != 0.0:
        fail(f"elastic: the fresh twin is not bitwise the continued run "
             f"(max |diff| {sound})")
    if not planted_differs:
        fail("elastic: a joiner cloning the wrong row went unseen")
    summary = dict(wall=wall, reshard_ms=el["reshard_ms"],
                   recovery_ms=el["recovery_ms"])
    del res, twin, bad, snap, el
    torch.cuda.empty_cache()
    return summary


def elastic_tp(start, twin_dir: str) -> dict:
    """Phase elastic tp gpt2 (in the deterministic child's shared start,
    its next two jobs): the gpt2 path on data=3,model=2 under kill, join
    and crash; the roster of worker blocks and the crash's re-run from the
    boundary snapshot; every rank of the final roster launches each flash
    kernel (its head shard) once per layer per pass, the voided round's
    included; falling losses; the boundary, join and recovery stalls and
    each rank's peak memory; the fresh twin from the round-2 snapshot (its
    one round) bitwise the continued run.  Returns the summary, rank 0's
    launch counts among it."""
    import torch
    from importlib import import_module
    tag = "[elastic tp gpt2]"
    layers = PATHS["gpt2"][1]
    argv = [*ELASTIC_TP_ARGV, *ELASTIC_TP_CHAOS]
    t0 = time.perf_counter()
    res, wall = _timed(start)
    el, rt, g = res["elastic"], res["round_timings"], res["grid"]
    print(f"{tag} 6 processes {{'data': 3, 'model': 2}} on one card; wall "
          f"{wall:.1f} s; events {el['events']}; reshard_ms (boundary "
          f"start to install: kill, join) {el['reshard_ms']}; boundary_ms "
          f"(rank 0's snapshot build + write) {el['boundary_ms']}; "
          f"recovery_ms {el['recovery_ms']} via {el['recovery_source']}; "
          f"losses {res['global_train_losses']}")
    peaks: dict[int, list] = {}
    steps_ms = {}
    for r in rt:
        ranks = len(r["ranks_max_memory_allocated"])
        step = max(r["ranks_train_ms"]) / max(r["train_steps"], 1)
        steps_ms[r["epoch"]] = step
        print(f"{tag} round {r['epoch']}: roster {r['worker_ids']} on "
              f"{ranks} ranks; train steps per worker "
              f"{r['workers_train_steps']}, slowest rank {step:.1f} ms a "
              f"step (the round's mean, its first step included); sync "
              f"{r['sync_ms']:.1f} ms; max_memory_allocated per rank (GiB) "
              + str([round(x / 2**30, 2)
                     for x in r["ranks_max_memory_allocated"]]))
        for i, x in enumerate(r["ranks_max_memory_allocated"]):
            peaks.setdefault(i, []).append(x)
        if min(r["workers_train_steps"]) < ELASTIC_TP_MIN_STEPS:
            fail(f"elastic tp: round {r['epoch']}'s workers ran "
                 f"{r['workers_train_steps']} train steps, fewer than "
                 f"{ELASTIC_TP_MIN_STEPS}")
    print(f"{tag} steady step on 6 ranks (round {ELASTIC_TP_STEADY_ROUND}: "
          f"no start or boundary before it) "
          f"{steps_ms[ELASTIC_TP_STEADY_ROUND]:.1f} ms; after the kill "
          f"(4 ranks) {steps_ms[2]:.1f} ms, the join (6) "
          f"{steps_ms[3]:.1f} ms, the crash (4) {steps_ms[4]:.1f} ms")
    if el["rosters"] != ELASTIC_TP_ROSTERS:
        fail(f"elastic tp: rosters {el['rosters']}, expected "
             f"{ELASTIC_TP_ROSTERS}")
    if (el["crashes"], el["recoveries"], el["recovery_source"]) != (
            1, 1, ["snapshot"]):
        fail(f"elastic tp: crash recovery {el['crashes']} crash(es), "
             f"{el['recoveries']} recoveries via {el['recovery_source']}")
    if [r["epoch"] for r in rt] != list(range(5)):
        fail(f"elastic tp: rounds run {[r['epoch'] for r in rt]}")
    if g["axes"] != {"data": 2, "model": 2}:
        fail(f"elastic tp: final grid {g['axes']}")
    losses = res["global_train_losses"]
    if not all(math.isfinite(x) for k in ("global_train_losses",
                                          "global_val_losses")
               for x in res[k]):
        fail(f"elastic tp: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"elastic tp: the loss did not fall: {losses}")
    if any(len(set(c)) != 1 for c in res["round_checksums"]):
        fail(f"elastic tp: workers differ after an equal all-reduce round: "
             f"{res['round_checksums']}")
    counts = check_grid_launches(tag, res, layers, argv)
    snap = el["snapshots"][ELASTIC_TP_TWIN_SNAPSHOT]
    e = snap.epoch
    if (e, snap.n_workers) != (ELASTIC_TP_TWIN_EPOCH, 2):
        fail(f"elastic tp: the twin's snapshot is round {e}'s of "
             f"{snap.n_workers} workers")
    import_module(f"{PKG}.elastic").save_snapshot(snap, twin_dir)
    twin, twin_wall = _timed(start)
    bitwise = (twin["global_train_losses"] == losses[e:e + 1]
               and twin["round_checksums"] == res["round_checksums"][e:e + 1])
    print(f"{tag} twin from the round-{e} snapshot (roster "
          f"{snap.worker_ids}, {2 * snap.n_workers} ranks), its one round: "
          f"loss and every worker's parameters after it bitwise the "
          f"continued run's: {bitwise}; twin wall {twin_wall:.1f} s")
    if not bitwise:
        fail("elastic tp: the fresh twin is not bitwise the continued run")
    peak = [max(v) for _i, v in sorted(peaks.items())]
    print(f"{tag} peak max_memory_allocated per rank (GiB, any round) "
          f"{[round(x / 2**30, 2) for x in peak]}; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    del res, twin, snap
    torch.cuda.empty_cache()
    import_module(f"{PKG}.ops.flash").reset_launch_counts()
    return dict(wall=wall, twin_wall=twin_wall,
                reshard_ms=el["reshard_ms"], boundary_ms=el["boundary_ms"],
                recovery_ms=el["recovery_ms"], counts=counts, peak=peak)


def layout_cfgs() -> list:
    """The elastic phase's layout runs: ``(name, config)`` of the
    replicated and the resident layout without chaos, 4 workers."""
    from importlib import import_module
    config = import_module(f"{PKG}.config")
    return [(name, config.config_from_args(
        [*ELASTIC_ARGV, "--epochs_global", str(ELASTIC_LAYOUT_ROUNDS),
         *extra]))
        for name, extra in (("replicated", ["--param_residency",
                                            "replicated",
                                            "--shard_redundancy", "off"]),
                            ("resident", []))]


def elastic_layouts(run) -> dict:
    """Phase elastic cnn n4's layouts: the replicated against the resident
    layout without chaos (``run(cfg, kw)``: the next run of the
    deterministic child's shared start): memory, sync ms, bitwise
    parameters."""
    tag = "[elastic cnn n4]"
    layouts = {}
    for name, cfg in layout_cfgs():
        t0 = time.perf_counter()
        lay = run(cfg, _elastic_kw(cfg, 4, checksums=False))
        lay_wall = time.perf_counter() - t0
        lrt = lay["round_timings"]
        layouts[name] = dict(
            checksums=lay["param_checksums"], wall=lay_wall,
            residency=lay["sync_engine"]["param_residency"],
            state=lay["sync_engine"]["per_worker_state_bytes"],
            sync_ms=[round(max(r["workers_sync_ms"]), 1) for r in lrt],
            held=[max(r["workers_memory_allocated"]) for r in lrt],
            peak=max(lrt[-1]["workers_max_memory_allocated"]),
            wire=lrt[-1]["sync_bytes"],
            buddy=lrt[-1]["sync_buddy_bytes"],
            gather_ms=[r["gather_ms"] for r in lrt])
        del lay
        print(f"{tag} layout {name} ({layouts[name]['residency']}), no "
              f"chaos, {ELASTIC_LAYOUT_ROUNDS} rounds: slowest rank's sync "
              f"ms per round {layouts[name]['sync_ms']}; rank 0's entry "
              f"gather ms {layouts[name]['gather_ms']}; held after the "
              "sync (GiB, most of the 4) "
              + str([round(x / 2**30, 3) for x in layouts[name]["held"]])
              + f"; max_memory_allocated {layouts[name]['peak'] / 2**30:.2f}"
              f" GiB; per_worker_state_bytes {layouts[name]['state']}; wire"
              f" {layouts[name]['wire']:,} B (buddy "
              f"{layouts[name]['buddy']:,}); wall {lay_wall:.1f} s")
    if layouts["resident"]["residency"] != "resident":
        fail("elastic: the resident layout resolved to "
             f"{layouts['resident']['residency']}")
    if layouts["resident"]["checksums"] != layouts["replicated"]["checksums"]:
        fail("elastic: the resident run's parameters are not bitwise the "
             "replicated run's")
    print(f"{tag} resident parameters bitwise the replicated run's: True")
    return layouts


def _sha256s(arrays: dict) -> dict:
    """The SHA-256 of each array's bytes, on 8 threads (hashlib lets go of
    the GIL on large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np

    def one(a):
        a = np.ascontiguousarray(a)
        return hashlib.sha256(a.reshape(-1).view(np.uint8)).hexdigest()
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(arrays, pool.map(one, arrays.values())))


def _row_digests(results: dict, rows_dir: str, rank: int) -> None:
    """Write the SHA-256 of every leaf of this rank's final checkpoint row
    (by JAX key path) into ``rows_dir``."""
    from importlib import import_module
    ckpt = import_module(f"{PKG}.checkpoint")
    weights = import_module(f"{PKG}.weights")
    model, st = results["model"], results["state"]
    names = [k for k, _p in model.named_parameters()]
    ws = ckpt.WorkerState(
        params=dict(model.named_parameters()),
        buffers=dict(model.named_buffers()),
        mu=dict(zip(names, st.opt.mu)), nu=dict(zip(names, st.opt.nu)),
        count=st.opt.count, lr_epoch=st.lr_epoch, rng=st.rng,
        layout=weights.state_layout(model), worker=rank, n_workers=4)
    leaves = ckpt.jax_leaves(ckpt.snapshot(ws))
    with open(os.path.join(rows_dir, f"rank{rank}.json"), "w") as f:
        json.dump(_sha256s(leaves), f)


def _rank_marks(t_driver, marks: dict) -> None:
    """Record, on this process's ranks' clock (``time.time()``), when the
    rank's rendezvous returned and when its first round started."""
    t_mesh = t_driver.mesh
    join, round_start = t_mesh.join_store, t_driver.LocalSGDEngine.round_start

    def joined(*args, **kw):
        out = join(*args, **kw)
        marks.setdefault("joined", time.time())
        return out

    def started(self, *args):
        marks.setdefault("first_round", time.time())
        return round_start(self, *args)
    t_mesh.join_store = joined
    t_driver.LocalSGDEngine.round_start = started


def _rank_done(results: dict, rank: int, marks: dict) -> None:
    """This rank's final row digests and its marks, into the rows
    directory."""
    marks["ended"] = time.time()
    rows_dir = os.path.join(MULTIHOST_DIR, "rows")
    _row_digests(results, rows_dir, rank)
    with open(os.path.join(rows_dir, f"marks{rank}.json"), "w") as f:
        json.dump(marks, f)


def multihost_rank(rank: int, world_size: int, cfg, store, timeout_s,
                   train_kwargs, generation, snapshot_dir) -> None:
    """A spawned rank of a launched process of [multihost cnn n4]
    (``driver.rank_entry``'s arguments): deterministic algorithms on, the
    run, then its final row's digests and its marks."""
    marks = {"entered": time.time()}
    from importlib import import_module
    _deterministic()
    t_driver = import_module(f"{PKG}.driver")
    _rank_marks(t_driver, marks)
    res = t_driver.train_rank(
        rank, world_size, store, timeout_s, cfg, train_kwargs,
        generation=generation, snapshot_dir=snapshot_dir)
    _rank_done(res, rank, marks)


def multihost_child() -> int:
    """One launched process of [multihost cnn n4] (``python3 chip_smoke.py
    multihost_rank`` with JAX's three variables set): [overlap cnn n4]'s
    serial run with its probe and walls pinned and a save every round,
    through ``driver.run_launched``; its first rank's final row digests
    and marks, then one tagged JSON line of what it saw."""
    marks = {"entered": time.time()}
    import hashlib
    from importlib import import_module
    import torch  # noqa: F401  (the mark times its import)
    marks["torch"] = time.time()
    _deterministic()
    t_driver = import_module(f"{PKG}.driver")
    config = import_module(f"{PKG}.config")
    marks["imported"] = time.time()
    _tag, _flow, _cfg, kw = overlap_cfgs(4)[0]
    cfg = config.config_from_args(
        [*OVERLAP_N4_ARGV, "--no_overlap_rounds", *MULTIHOST_CKPT])
    parts: list = []
    real = _spy_partitions(t_driver, parts)
    _rank_marks(t_driver, marks)
    try:
        res = t_driver.run_launched(cfg, train_kwargs=kw,
                                    target=multihost_rank)
    finally:
        t_driver._capped = real
    launch = res["launch"]
    _rank_done(res, launch["ranks"][0], marks)
    rt = res["round_timings"]
    print(MULTIHOST_TAG + json.dumps({
        "launch": launch, "round_flow": res["round_flow"],
        **{k: res[k] for k in MULTIHOST_METRICS}, "parts": parts,
        "parts_sha": hashlib.sha256("".join(parts).encode()).hexdigest(),
        "first_round_t": marks["first_round"],
        "checkpoint": res["checkpoint"],
        "rounds": [{k: r[k] for k in ("compute_ms", "train_ms",
                                      "workers_sync_ms",
                                      "workers_train_steps",
                                      "workers_wall_s", "ckpt_snapshot_ms",
                                      "ckpt_write_ms")} for r in rt]}),
        flush=True)
    return 0


def multihost_cnn(serial: dict) -> dict:
    """Phase [multihost cnn n4] (in the deterministic child, after the
    shared start): two OS processes started with ``subprocess.Popen``,
    each told the coordinator (127.0.0.1 and a free port), the process
    count and its id by JAX's three variables, each hosting 2 ranks on
    the card; checks both exit 0, their metric lists bitwise equal to each
    other's and to the serial [overlap cnn n4] run's of this call, the
    partitions and every rank's parameter checksum equal to that run's,
    the last manifest of the shared directory listing 4 shards, which this
    process restores bitwise to every rank's final row, and a falling
    loss.  Prints the wall, each process's ms from its start to its first
    round, round ms, sync ms per rank and images/s."""
    import socket
    from importlib import import_module
    ckpt = import_module(f"{PKG}.checkpoint")
    tag = "[multihost cnn n4]"
    shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    rows_dir = os.path.join(MULTIHOST_DIR, "rows")
    os.makedirs(rows_dir)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    # each process's output goes to files: a pipe that nobody reads while
    # the other process is waited for could fill and stall it
    logs = [(os.path.join(MULTIHOST_DIR, f"process{pid}.out"),
             os.path.join(MULTIHOST_DIR, f"process{pid}.err"))
            for pid in range(MULTIHOST_PROCESSES)]
    procs = []
    for pid, (out_path, err_path) in enumerate(logs):
        with open(out_path, "w") as out, open(err_path, "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), MULTIHOST_PHASE],
                env={**os.environ,
                     "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                     "JAX_NUM_PROCESSES": str(MULTIHOST_PROCESSES),
                     "JAX_PROCESS_ID": str(pid)},
                stdout=out, stderr=err, text=True, start_new_session=True))
    deadline = time.time() + 400
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for pid, proc in enumerate(procs):  # stop any process still
            if proc.poll() is None:         # running, and what it started
                os.killpg(proc.pid, 9)
            _end_session(proc, f"{tag} launched process {pid}")
    outs = []
    for pid, (proc, (out_path, err_path)) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            with open(err_path) as f:
                sys.stderr.write(f.read()[-6000:])
            fail(f"{tag}: launched process {pid} exited with "
                 f"{proc.returncode} (killed after 400 s: -9)")
        with open(out_path) as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith(MULTIHOST_TAG)]
        if not lines:
            fail(f"{tag}: launched process {pid} printed no result line")
        outs.append(json.loads(lines[-1][len(MULTIHOST_TAG):]))
    wall = time.time() - t0
    a, b = outs
    for r in outs:
        pid = r["launch"]["process_id"]
        print(f"{tag} process {pid}: ranks {r['launch']['ranks']} of "
              f"{r['launch']['world_size']}, {r['round_flow']} flow, "
              f"{(r['first_round_t'] - t0) * 1e3:.1f} ms from its start to "
              "its first round")
    for rank in range(4):
        with open(os.path.join(rows_dir, f"marks{rank}.json")) as f:
            m = json.load(f)
        print(f"{tag} rank {rank}: s after the processes' start: entered "
              f"{m['entered'] - t0:.1f}"
              + (f", torch imported {m['torch'] - t0:.1f}, the port "
                 f"{m['imported'] - t0:.1f}" if "imported" in m else "")
              + f", rendezvous done {m['joined'] - t0:.1f}, first round "
              f"{m['first_round'] - t0:.1f}, run returned "
              f"{m['ended'] - t0:.1f}")
    for i, row in enumerate(a["rounds"]):
        images = sum(row["workers_train_steps"]) * PATH_BATCH
        print(f"{tag} round {i}: {row['compute_ms']:.1f} ms (rank 0's "
              f"train {row['train_ms']:.1f} ms), sync ms per rank "
              f"{[round(x, 1) for x in row['workers_sync_ms']]}, walls s "
              f"{[round(x, 3) for x in row['workers_wall_s']]}, "
              f"{images / (row['compute_ms'] / 1e3):.1f} images/s summed "
              f"({images} images of the 4 workers' train steps); rank 0's "
              f"checkpoint snapshot {row['ckpt_snapshot_ms']:.1f} ms, "
              f"write {row['ckpt_write_ms']:.1f} ms")
    print(f"{tag} rank 0's checkpoint: {a['checkpoint']}")
    differ = [k for k in MULTIHOST_METRICS if a[k] != b[k]]
    vs_serial = [k for k in MULTIHOST_METRICS
                 if json.loads(json.dumps(serial[k])) != a[k]]
    parts_same = a["parts"] == b["parts"] == serial["parts"]
    print(f"{tag} process 0 vs 1: metrics "
          f"{'bitwise equal' if not differ else f'DIFFER in {differ}'}; vs "
          f"the serial [overlap cnn n4] run: "
          f"{'bitwise equal' if not vs_serial else f'DIFFER in {vs_serial}'}"
          f" (every rank's parameter checksum among them); partitions "
          f"{'equal' if parts_same else 'DIFFER'} "
          f"({len(set(a['parts']))} distinct shard sets, sha256 "
          f"{a['parts_sha'][:16]})")
    if differ or vs_serial or not parts_same or not a["parts"]:
        fail(f"{tag}: the launched run is not bitwise the serial run")
    losses = a["all_workers_losses"][0]
    curves = [c for w in a["all_workers_losses"] for c in w] + list(
        a["global_train_losses"]) + list(a["global_val_losses"])
    if not all(math.isfinite(x) for x in curves):
        fail(f"{tag}: non-finite loss")
    if not a["global_train_losses"][-1] < losses[0]:
        fail(f"{tag}: train loss did not fall: first batch {losses[0]}, "
             f"last epoch {a['global_train_losses'][-1]}")
    # the shared directory's last epoch, restored in this process (every
    # shard's size and crc32 checked against the manifest)
    t1 = time.perf_counter()
    ckpt_dir = MULTIHOST_CKPT[1]
    epochs = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                    if os.path.isfile(os.path.join(ckpt_dir, d,
                                                   ckpt.MANIFEST)))
    latest = os.path.join(ckpt_dir, f"ckpt_{epochs[-1]}")
    manifest = ckpt.read_manifest(latest) or {}
    tree, epoch = ckpt.host_tree(latest)
    restore_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    got = _sha256s({(rank, k): v[rank] for k, v in tree.items()
                    for rank in range(4)})
    bad = []
    for rank in range(4):
        with open(os.path.join(rows_dir, f"rank{rank}.json")) as f:
            want = json.load(f)
        mine = {k: d for (r, k), d in got.items() if r == rank}
        bad += [(rank, k) for k in set(want) | set(mine)
                if want.get(k) != mine.get(k)]
    nbytes = sum(int(v["bytes"]) for v in manifest.get("shards", {}).values())
    print(f"{tag} checkpoint epochs {epochs}; epoch {epoch}: manifest of "
          f"{len(manifest.get('shards', {}))} shards "
          f"({nbytes / 2**30:.3f} GiB), merged in this process in "
          f"{restore_s:.1f} s (crc32 checked), hashed in "
          f"{time.perf_counter() - t1:.1f} s: {len(tree)} leaves x 4 "
          f"ranks, {len(bad)} differ from the ranks' final rows")
    if (epoch != len(a["rounds"]) or sorted(manifest.get("shards", {}))
            != [f"shard_{r}.msgpack" for r in range(4)] or bad):
        fail(f"{tag}: the checkpoint of epoch {epoch} is not the run's "
             f"rows (differing {bad[:4]})")
    del tree
    shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    print(f"{tag} phase wall {time.time() - t0:.1f} s (the two processes "
          f"{wall:.1f} s)")
    return {"wall_s": wall, "epoch": epoch}


def deterministic_child(overlap: bool, elastic: bool) -> int:
    """The phases that compare runs bit for bit, in a child process whose
    environment sets CUBLAS_WORKSPACE_CONFIG before CUDA starts, under
    torch.use_deterministic_algorithms (cuDNN's choice of algorithm could
    otherwise make two runs of one flow differ by itself).  The overlap
    pair at N=4, the elastic layouts and the chaos runs with their twins
    share one start of their ranks (6 with the chaos runs: [elastic tp
    gpt2]'s; a 4-rank job leaves the last two idle; a join spawns its
    block, a retired rank goes on to the next job).  Prints one tagged
    JSON line for the parent."""
    import tempfile
    from importlib import import_module
    _deterministic()
    t_driver = import_module(f"{PKG}.driver")
    t0 = time.perf_counter()
    if overlap:
        overlap_pair(1, lambda cfg, kw: t_driver.train_global(cfg, **kw))
        _release_card()
    jobs = ([(cfg, kw, 4) for _t, _f, cfg, kw in overlap_cfgs(4)]
            if overlap else [])
    jobs += ([(cfg, _elastic_kw(cfg, 4, checksums=False), 4)
              for _n, cfg in layout_cfgs()] if elastic else [])
    snap_dir = tempfile.mkdtemp(prefix="chip-smoke-snapshots-")
    chaos, dirs = elastic_jobs(snap_dir) if elastic else ([], {})
    t1 = time.perf_counter()
    try:
        with t_driver.SharedStart(6 if elastic else 4, jobs + chaos,
                                  target=elastic_rank) as start:
            run = lambda _cfg, _kw: start.run()
            if overlap:
                serial = overlap_pair(4, run)
                print(f"[overlap cnn] phase wall "
                      f"{time.perf_counter() - t0:.1f} s")
            if elastic:
                layouts = elastic_layouts(run)
                tp = elastic_tp(start, dirs["tp_twin"])
                cnn = elastic_cnn(start, dirs)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    _release_card()
    if overlap:
        # its own processes, once the shared start's have gone
        multihost_cnn(serial)
    print(f"[deterministic] {len(jobs) + len(chaos)} runs ("
          + ", ".join((["overlap n4 serial", "overlap n4 overlapped"]
                       if overlap else [])
                      + (["layout replicated", "layout resident",
                          "elastic tp gpt2", "its twin", "elastic cnn n4",
                          "its twin", "its planted twin"]
                         if elastic else []))
          + f") from one start of {6 if elastic else 4} processes in "
          f"{time.perf_counter() - t1:.1f} s")
    if elastic:
        print(ELASTIC_RESULT_TAG + json.dumps({**cnn, "tp": tp, "layouts": {
            k: {kk: vv for kk, vv in v.items() if kk != "checksums"}
            for k, v in layouts.items()}}), flush=True)
    return 0


def phase_elastic() -> dict:
    """Run the overlap cnn and elastic cnn n4 phases in the deterministic
    child (CUBLAS_WORKSPACE_CONFIG set before CUDA starts); echo its
    output and return the elastic phase's result."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           DETERMINISTIC_PHASE], env=env,
                          capture_output=True, text=True, timeout=1000)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(ELASTIC_RESULT_TAG):
            result = json.loads(line[len(ELASTIC_RESULT_TAG):])
        else:
            print(line)
    if proc.returncode != 0 or result is None:
        sys.stderr.write(proc.stderr[-8000:])
        fail(f"the deterministic child exited with {proc.returncode}"
             + ("" if result else " and printed no result line"))
    print(f"[overlap cnn + elastic cnn n4] child wall "
          f"{time.perf_counter() - t0:.1f} s")
    return result


# ----------------------------------------------------------------------
# The rank grid: --mesh_shape data=D,fsdp=F,model=T
# ----------------------------------------------------------------------

def grid_run(tag: str, argv: list[str], runner=None):
    """main.run(argv) with this process's launch counters reset just
    before, or, given ``runner`` (main.run_shared's), the shared start's
    next job, whose launch line is ``argv``; returns (results, wall s)."""
    import torch
    from importlib import import_module
    import_module(f"{PKG}.ops.flash").reset_launch_counts()
    _peak_reset()
    t0 = time.perf_counter()
    results = (import_module(f"{PKG}.main").run(argv) if runner is None
               else runner())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in results["global_train_losses"]):
        fail(f"{tag}: non-finite train loss")
    return results, wall


def check_grid_launches(tag: str, results: dict, layers: int,
                        argv: list[str]) -> dict:
    """Every rank's flash launches in its train_global (gathered before
    rank 0's final evaluation): layers x its passes, the probe's on the
    dense twin (1 + --probe_batches, all heads) and its train and
    validation steps' (its head shard); the fused backward or the
    two-pass pair as FLASH_BWD says.  Returns rank 0's counts."""
    from importlib import import_module
    fused = import_module(f"{PKG}.ops.flash")._use_fused_bwd()
    probe_passes = 1 + import_module(f"{PKG}.config").config_from_args(
        argv).probe_batches
    g = results["grid"]
    for r, (counts, (train, val)) in enumerate(zip(g["launches"],
                                                   g["steps"])):
        grad = layers * (probe_passes + train)
        want = {"flash_fwd": layers * (probe_passes + train + val),
                "flash_bwd_dq": 0 if fused else grad,
                "flash_bwd_dkv": 0 if fused else grad,
                "flash_bwd_fused": grad if fused else 0}
        print(f"{tag} rank {r} {g['coords_of'][r]}: launches {counts}; "
              f"expected {want} ({layers} layers; {train} train steps, "
              f"{val} val steps, {probe_passes} probe passes)")
        if counts != want:
            fail(f"{tag}: rank {r}'s launch counts {counts} are not its "
                 f"passes' {want}")
    return g["launches"][0]


def grid_lines(tag: str, results: dict, wall: float) -> dict:
    """Per-rank step ms, TP all-reduce and FSDP gather/reduce-scatter ms
    and bytes per step, parameter and moment bytes, peak memory, and on a
    seq line the SP hops per pass, the seq gradient all-reduce per step and
    the flash launches; returns them by rank."""
    g, rt = results["grid"], results["round_timings"]
    rows = []
    for r in range(g["ranks"]):
        train, val = g["steps"][r]
        passes = max(train + val, 1)
        tp, fs, st = g["tp"][r], g["fsdp"][r], g["state_bytes"][r]
        sp = g["sp"][r]
        row = dict(
            coords=g["coords_of"][r], train_steps=train,
            step_ms=sum(x["ranks_train_ms"][r] for x in rt) / max(train, 1),
            tp_ms=tp["ms"] / passes, tp_bytes=tp["bytes"] / passes,
            tp_calls=tp["calls"] / passes,
            gather_ms=fs["gather_ms"] / max(train, 1),
            reduce_scatter_ms=fs["reduce_scatter_ms"] / max(train, 1),
            fsdp_bytes=(fs["gather_bytes"] + fs["reduce_scatter_bytes"])
            / max(train, 1),
            params_bytes=st["params"], opt_bytes=st["opt_state"],
            peak=max(x["ranks_max_memory_allocated"][r] for x in rt),
            sp_ms=sp["ms"] / passes, sp_bytes=sp["bytes"] / passes,
            sp_calls=sp["calls"] / passes,
            sp_grad_ms=sp["grad_ms"] / max(train, 1),
            sp_grad_bytes=sp["grad_bytes"] / max(train, 1),
            launches=sum(g["launches"][r].values()))
        rows.append(row)
        print(f"{tag} rank {r} {row['coords']}: train step "
              f"{row['step_ms']:.3f} ms over {train} steps; TP all-reduce "
              f"{row['tp_ms']:.3f} ms, {row['tp_calls']:.0f} calls, "
              f"{row['tp_bytes']:,.0f} B per pass (train + val); FSDP "
              f"gather {row['gather_ms']:.3f} ms + reduce-scatter "
              f"{row['reduce_scatter_ms']:.3f} ms, {row['fsdp_bytes']:,.0f} "
              f"B per train step; params {row['params_bytes']:,} B, Adam "
              f"moments {row['opt_bytes']:,} B; max_memory_allocated "
              f"{row['peak'] / 2**30:.2f} GiB")
        if sp["calls"]:
            print(f"{tag} rank {r} {row['coords']}: SP hops "
                  f"{row['sp_ms']:.3f} ms, {row['sp_calls']:.0f} calls, "
                  f"{row['sp_bytes']:,.0f} B per pass (train + val); seq "
                  f"gradient all-reduce {row['sp_grad_ms']:.3f} ms, "
                  f"{row['sp_grad_bytes']:,.0f} B per train step; flash "
                  f"launches {row['launches']}")
    print(f"{tag} {g['ranks']} processes {g['axes']} on one card; wall "
          f"{wall:.1f} s; losses {results['global_train_losses']}")
    return rows


def data_lines(tag: str, results: dict, wall: float) -> None:
    """The data-only twin's per-worker step ms and peak memory."""
    rt = results["round_timings"]
    n = len(rt[0]["workers_train_ms"])
    step = [sum(x["workers_train_ms"][w] for x in rt)
            / max(sum(x["workers_train_steps"][w] for x in rt), 1)
            for w in range(n)]
    peak = [max(x["workers_max_memory_allocated"][w] for x in rt)
            for w in range(n)]
    print(f"{tag} {n} worker process(es): train step per worker "
          f"{[round(x, 3) for x in step]} ms; max_memory_allocated per "
          f"worker {[round(x / 2**30, 2) for x in peak]} GiB; params "
          f"{results['sync_engine']['per_worker_state_bytes']['params']:,} B"
          f"; wall {wall:.1f} s; losses {results['global_train_losses']}")


def grid_parity(tag: str, twin_argv: list[str], grid_argv: list[str],
                rtol: float = GRID_RTOL, runner=None, twin=None) -> dict:
    """The fp32 pair: the grid run's global train and val losses against
    its data-only twin's at ``rtol``; both runs' per-rank (per-worker)
    step ms and memory printed side by side.  ``runner``: the grid run is
    a shared start's next job (the twin, one process, runs here first);
    ``twin``: an earlier run of the twin, reused."""
    import numpy as np
    if twin is None:
        twin, twin_wall = grid_run(tag, twin_argv)
        data_lines(f"{tag} fp32 data-only twin", twin, twin_wall)
    grid, wall = grid_run(tag, grid_argv, runner)
    grid_lines(f"{tag} fp32", grid, wall)
    for k in ("global_train_losses", "global_val_losses"):
        a, b = np.asarray(grid[k]), np.asarray(twin[k])
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        print(f"{tag} fp32 parity {k}: grid {a.tolist()} vs twin "
              f"{b.tolist()}: max rel diff {rel:.3g} (gate {rtol})")
        if not np.allclose(a, b, rtol=rtol, atol=0):
            fail(f"{tag}: fp32 {k} differ from the data-only twin's beyond "
                 f"rtol {rtol}")
    return grid


def tp_gpt2_argvs() -> tuple:
    """[tp gpt2]'s launch lines: the fp32 pair's data-only twin (2 worker
    processes) and grid run, and the timed bf16 run."""
    argv = PATHS["gpt2"][0]
    small = [*argv, *TP_GPT2_FP32]
    return ([*small, "--num_workers", "2"], [*small, *TP_GPT2_MESH],
            [*argv, *TP_GPT2_CUT, *TP_GPT2_MESH])


def phase_tp_gpt2(runner, twin: dict) -> dict:
    """[tp gpt2]: the gpt2 path on data=2,model=2 (4 processes): the fp32
    pair against --num_workers 2 (``twin``, run in the 2-process start),
    both timed, then the bf16 run timed; in both grid runs every rank
    launches each kernel (the fp32 instance, then the tensor-core one)
    once per layer per pass.  The grid runs are ``runner``'s next two
    jobs.  Returns the bf16 run's rank-0 counts."""
    layers = PATHS["gpt2"][1]
    tag = "[tp gpt2]"
    t0 = time.perf_counter()
    _twin_argv, fp32_argv, argv = tp_gpt2_argvs()
    fp32 = grid_parity(tag, None, fp32_argv, runner=runner, twin=twin)
    check_grid_launches(f"{tag} fp32", fp32, layers, fp32_argv)
    del fp32
    tp, wall = grid_run(tag, argv, runner)
    check_losses("tp gpt2", tp)
    counts = check_grid_launches(tag, tp, layers, argv)
    grid_lines(tag, tp, wall)
    del tp
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def stale_tp_argv() -> list[str]:
    """[stale tp gpt2]'s launch line: [tp gpt2]'s bf16 run with the stale
    sync over 3 rounds."""
    return [*tp_gpt2_argvs()[2], *STALE_TP_ARGV, "--out_dir",
            os.path.join(OUT_DIR, "stale_tp")]


def phase_stale_tp(runner) -> dict:
    """[stale tp gpt2]: the gpt2 path on data=2,model=2 with
    --sync_staleness 1 (``runner``'s next job): each coordinate's data
    line runs its stale sync on a second group of the line; one delta
    delivered a round (the last at the drain), the hidden fraction of the
    sync wall; every rank launches each kernel once per layer per pass;
    the losses finite and falling.  Returns rank 0's launch counts."""
    tag = "[stale tp gpt2]"
    argv = stale_tp_argv()
    res, wall = grid_run(tag, argv, runner)
    check_losses("stale tp gpt2", res)
    counts = check_grid_launches(tag, res, PATHS["gpt2"][1], argv)
    ar = res["async_rounds"]
    rounds = len(res["round_timings"])
    print(f"{tag} 4 processes {res['grid']['axes']} on one card; staleness "
          f"{ar['staleness']}: {ar['delivered']} deltas delivered over "
          f"{rounds} rounds; sync wall {ar['sync_ms_total']} ms, "
          f"{ar['sync_hidden_ms_total']} ms of it hidden under compute "
          f"(fraction {ar['hidden_fraction']}); wall {wall:.1f} s; losses "
          f"{res['global_train_losses']}")
    grid_lines(tag, res, wall)
    if not (ar["enabled"] and ar["delivered"] == rounds == 3):
        fail(f"{tag}: {ar['delivered']} deltas delivered over {rounds} "
             "rounds")
    return counts


def tp_llama() -> dict:
    """[tp llama] (in a FLASH_BWD=fused process): llama_medium with 4 K/V
    heads on data=1,model=2; each rank's fused backward launches once per
    layer per pass, the two-pass pair never."""
    from importlib import import_module
    if not import_module(f"{PKG}.ops.flash")._use_fused_bwd():
        fail("the tp llama run does not see FLASH_BWD=fused")
    argv, layers = PATHS["llama"]
    tag = "[tp llama]"
    argv = [*argv, *TP_LLAMA_CUT, "--checkpoint_dir", "",
            "--checkpoint_every", "0", *TP_LLAMA_MESH, "--out_dir",
            os.path.join(OUT_DIR, "tp_llama")]
    res, wall = grid_run(tag, argv)
    check_losses("tp llama", res)
    counts = check_grid_launches(tag, res, layers, argv)
    grid_lines(tag, res, wall)
    return counts


def fsdp_module_job(width: int = 64) -> dict:
    """[fsdp cnn]'s module job (grid_harness.module_job on data=1,fsdp=2):
    one fp32 step of the enhanced_cnn at ``width`` (its seeded init, the
    same on both ranks) on PATH_BATCH random images; each rank holds its
    logits and the joined gradients against the dense twin that
    normalises each half on its own (BatchNorm under FSDP, JAX
    train.py:1617-1622) and returns the largest differences."""
    import numpy as np
    rng = np.random.default_rng(0)
    return dict(model="enhanced_cnn", vocab=10, shape=(32, 32, 3),
                axes={"data": 1, "fsdp": 2}, kw={"model_width": width},
                summary=True,
                x=rng.normal(size=(PATH_BATCH, 32, 32, 3)).astype(
                    np.float32),
                y=rng.integers(0, 10, PATH_BATCH),
                m=np.ones(PATH_BATCH, np.float32))


def check_fsdp_module(ranks: list) -> None:
    """[fsdp cnn]'s one-step check: each rank's logits of its half of the
    batch and the joined gradients against the dense twin."""
    e_logits = max(r["logits_err"] for r in ranks)
    e_grads = max(r["grads_err"] for r in ranks)
    print(f"[fsdp cnn] one fp32 step at data=1,fsdp=2, "
          f"{ranks[0]['sharded']} of {ranks[0]['leaves']} leaves sharded: "
          f"logits max abs err "
          f"{e_logits:.3g} (gate {GRID_LOGITS_ATOL}), gradients max abs "
          f"err {e_grads:.3g} (gate {GRID_GRAD_ATOL}) against the dense "
          "twin normalising each half")
    if not (e_logits <= GRID_LOGITS_ATOL and e_grads <= GRID_GRAD_ATOL):
        fail("fsdp cnn: the sharded step differs from its dense twin")


def sp_attn_jobs() -> list:
    """[sp attn]'s jobs (grid_harness.sp_attention_job on data=1,seq=2):
    ring, ring_zigzag and all_to_all at each SP_ATTN_SHAPES shape, causal,
    in bf16 and fp32, against the dense attention on the whole
    sequence."""
    return [dict(kind="sp", axes={"data": 1, "seq": 2}, impl=impl,
                 causal=True, dtype=dtype, shape=shape[1:], seed=i,
                 summary=True,
                 label=f"{shape[0]} {list(shape[1:])} {impl} {dtype}")
            for i, (shape, impl, dtype) in enumerate(
                (s, m, d) for s in SP_ATTN_SHAPES
                for m in ("ring", "ring_zigzag", "all_to_all")
                for d in SP_ATTN_TOL)]


def check_sp_attn(jobs: list, results: list) -> None:
    """[sp attn]: each job's output and gradients of q, k and v within its
    dtype's fraction of max |dense|; the slower rank's wall of the
    forward and backward, rank 0's hops and bytes."""
    for job, ranks in zip(jobs, results):
        tol = SP_ATTN_TOL[job["dtype"]]
        err = [max(r["errors"][j] for r in ranks) for j in range(4)]
        st = ranks[0]["stats"]
        print(f"[sp attn] {job['label']}: max err / max |dense| out "
              f"{err[0]:.3g}, dq {err[1]:.3g}, dk {err[2]:.3g}, dv "
              f"{err[3]:.3g} (gate {tol}); fwd+bwd "
              f"{max(r['ms'] for r in ranks):.3f} ms, {st['calls']} hops "
              f"{st['bytes']:,} B {st['ms']:.3f} ms on rank 0")
        if not max(err) <= tol:
            fail(f"[sp attn] {job['label']}: differs from the dense "
                 f"attention beyond {tol}: {err}")


def fsdp_cnn_argv() -> list[str]:
    return [*CNN_ARGV[:-1], os.path.join(OUT_DIR, "fsdp_cnn"),
            *FSDP_CNN_CUT, *FSDP_CNN_MESH]


def phase_fsdp_cnn(runner) -> None:
    """[fsdp cnn]: the reference's enhanced_cnn run on data=2,fsdp=2 (4
    processes, ``runner``'s next job), bf16 and timed: finite falling
    losses, BatchNorm statistics equal along fsdp, each rank's parameter
    and moment bytes against the whole model's (its one-step fp32 check
    against the dense twin runs with the module checks)."""
    tag = "[fsdp cnn]"
    t0 = time.perf_counter()
    res, wall = grid_run(tag, fsdp_cnn_argv(), runner)
    check_losses("fsdp cnn", res)
    rows = grid_lines(tag, res, wall)
    sums = res["grid"]["buffer_checksums"]
    if not (sums[0] == sums[1] and sums[2] == sums[3]):
        fail("fsdp cnn: BatchNorm statistics differ along fsdp")
    # the whole worker's fp32 parameters, and Adam's two moments
    whole = {"params": 4 * CNN_PARAMS, "opt_state": 8 * CNN_PARAMS}
    for r, row in enumerate(rows):
        print(f"{tag} rank {r}: params {row['params_bytes']:,} B = "
              f"{row['params_bytes'] / whole['params']:.3f} of the whole "
              f"{whole['params']:,}; Adam moments {row['opt_bytes']:,} B = "
              f"{row['opt_bytes'] / whole['opt_state']:.3f} of "
              f"{whole['opt_state']:,}")
    print(f"{tag} BatchNorm statistics equal along fsdp: True; phase wall "
          f"{time.perf_counter() - t0:.1f} s")


def tp_fsdp_bert_argvs() -> tuple:
    """[tp fsdp bert]'s fp32 pair: the data=1 twin and the grid run."""
    small = [*PATHS["bert"][0], *GRID_FP32, "--limit_train_samples", "320",
             "--limit_eval_samples", "64"]
    return [*small, "--mesh_shape", "data=1"], [*small, *TP_FSDP_BERT_MESH]


def phase_tp_fsdp_bert(runner) -> dict:
    """[tp fsdp bert]: bert_base MLM on data=1,fsdp=2,model=2 (4
    processes, ``runner``'s next job): the fp32 pair against data=1, both
    timed, every rank of the grid run launching each kernel (its fp32
    instance) once per layer per pass."""
    layers = PATHS["bert"][1]
    tag = "[tp fsdp bert]"
    t0 = time.perf_counter()
    twin_argv, grid_argv = tp_fsdp_bert_argvs()
    grid = grid_parity(tag, twin_argv, grid_argv, runner=runner)
    counts = check_grid_launches(tag, grid, layers, grid_argv)
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def phase_tp_llama() -> dict:
    """Run tp_llama in a FLASH_BWD=fused child; echo it; its counts."""
    env = {**os.environ, "FLASH_BWD": "fused"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           TP_LLAMA_PHASE], env=env, capture_output=True,
                          text=True, timeout=600)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT_TAG):
            result = json.loads(line[len(RESULT_TAG):])
        else:
            print(line)
    if proc.returncode != 0 or result is None:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"the tp llama child exited with {proc.returncode}")
    return result["counts"]


def sp_argvs(path: str) -> tuple:
    """[sp <path>]'s launch lines: the fp32 pair's data-only twin and grid
    run, and the timed bf16 run under --sanitize."""
    argv, _layers = PATHS[path]
    _tag, mesh_argv, cut = SP_RUNS[path]
    argv = [*argv, "--attention_impl", "dense", "--out_dir",
            os.path.join(OUT_DIR, f"sp_{path}")]
    small = [*argv, *SP_FP32]
    return ([*small, "--mesh_shape", "data=1"], [*small, *mesh_argv],
            [*argv, *cut, *mesh_argv, "--sanitize"])


def phase_sp(path: str, runner) -> None:
    """[sp gpt2] / [sp bert]: the path on a seq line of 2 processes with
    its --sequence_parallel mode and dense attention: the fp32 pair (one
    round) against the data=1 twin, both timed, then the bf16 run timed
    under --sanitize (the parameters checked bitwise equal along seq after
    the round, no implicit sync); no rank launches a flash kernel.  The
    2-process runs are ``runner``'s next two jobs."""
    from importlib import import_module
    fl = import_module(f"{PKG}.ops.flash")
    tag = SP_RUNS[path][0]
    t0 = time.perf_counter()
    twin_argv, grid_argv, bf16_argv = sp_argvs(path)
    grid_parity(tag, twin_argv, grid_argv, runner=runner)
    res, wall = grid_run(tag, bf16_argv, runner)
    check_losses(f"sp {path}", res)
    rows = grid_lines(tag, res, wall)
    g = res["grid"]
    if any(row["launches"] for row in rows) or any(fl.LAUNCHES.values()):
        fail(f"{tag}: a flash kernel launched on the SP path: "
             f"{g['launches']}, {fl.LAUNCHES}")
    if not all(row["sp_calls"] > 0 for row in rows):
        fail(f"{tag}: a rank ran no SP hop: {g['sp']}")
    if g["seq_bitwise_rounds"] != len(res["round_timings"]):
        fail(f"{tag}: the parameters were checked along seq after "
             f"{g['seq_bitwise_rounds']} of {len(res['round_timings'])} "
             "rounds")
    if res["sanitize"]["transfer_guard_violations"]:
        fail(f"{tag}: implicit host-device syncs {res['sanitize']}")
    print(f"{tag} parameters bitwise equal along seq after "
          f"{g['seq_bitwise_rounds']} round(s); 0 flash launches; 0 "
          f"implicit syncs; phase wall {time.perf_counter() - t0:.1f} s")


def pp_argvs(schedule: str) -> tuple:
    """[pp gpt2]'s launch lines under ``schedule``: the fp32 grid run (its
    twin is the data=1 line of ``pp_twin_argv``) and the timed bf16 run."""
    argv, _layers = PATHS["gpt2"]
    argv = [*argv, "--out_dir", os.path.join(OUT_DIR, f"pp_{schedule}"),
            "--pp_schedule", schedule]
    return [*argv, *PP_FP32, *PP_MESH], [*argv, *PP_CUT, *PP_MESH]


def pp_twin_argv() -> list[str]:
    argv, _layers = PATHS["gpt2"]
    return [*argv, "--out_dir", os.path.join(OUT_DIR, "pp_twin"),
            *PP_FP32, "--mesh_shape", "data=1"]


def pp_toy_jobs() -> list:
    """The schedules on 2 processes of the card (grid_harness.
    pp_schedule_job, JAX tests/test_pp.py's matmul stages and head, 4
    microbatches of 2 x 16): each against the stages run in turn in the
    rank."""
    import numpy as np
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(PP_STAGES, 16, 16)) * 0.3).astype(np.float32)
    head = (rng.normal(size=(16, 3)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(4, 2, 16)).astype(np.float32)
    tgt = rng.normal(size=(4, 2, 3)).astype(np.float32)
    return [dict(kind="pp", axes={"data": 1, "pipe": PP_STAGES},
                 schedule=schedule, xs=xs, w=w, head=head, tgt=tgt,
                 summary=True) for schedule in PP_SCHEDULES]


def pp_module_jobs() -> list:
    """[pp gpt2]'s one-step checks (grid_harness.module_job on
    data=1,pipe=2): full-width gpt2_small in fp32 with flash attention,
    its seeded init (the same on both ranks), M = 2 microbatches of
    PP_MODULE_BATCH / 2 random sequences, under each schedule: the last
    stage's logits and the joined gradients against the dense twin."""
    import numpy as np
    rng = np.random.default_rng(1)
    b = PP_MODULE_BATCH
    argv = PATHS["gpt2"][0]
    model = argv[argv.index("--model") + 1]
    return [dict(model=model, vocab=1000, axes={"data": 1,
                                                "pipe": PP_STAGES},
                 schedule=schedule, summary=True,
                 kw=dict(attention_impl="flash", pp_schedule=schedule,
                         pp_microbatches=2,
                         mesh_shape=f"data=1,pipe={PP_STAGES}"),
                 x=rng.integers(0, 1000, (b, PATH_LEN)),
                 y=rng.integers(0, 1000, (b, PATH_LEN)),
                 m=np.ones(b, np.float32)) for schedule in PP_SCHEDULES]


def check_pp_toy(jobs: list, results: list) -> None:
    """The toy schedules: every piece within PP_TOY_ATOL of the stages
    run in turn; each stage's microbatches in flight at its bound (M
    under GPipe, min(P - s, M) under 1F1B)."""
    for job, ranks in zip(jobs, results):
        err = max(max(r["errors"].values()) for r in ranks)
        flight = [r["in_flight"] for r in ranks]
        bound = [r["in_flight_bound"] for r in ranks]
        print(f"[pp toy] {job['schedule']} on {PP_STAGES} processes, 4 "
              f"microbatches: max abs err {err:.3g} (gate {PP_TOY_ATOL}); "
              f"in flight by stage {flight} (bound {bound}); "
              f"{max(r['ms'] for r in ranks):.3f} ms")
        if not (err <= PP_TOY_ATOL and flight == bound):
            fail(f"[pp toy] {job['schedule']}: differs from the stages in "
                 f"turn ({err}) or held {flight} microbatches, not {bound}")


def check_pp_module(jobs: list, results: list) -> None:
    """[pp gpt2]'s one-step checks: the last stage's logits and the
    worker's joined gradients against the dense twin, at the grid's
    gates."""
    for job, ranks in zip(jobs, results):
        e_logits = max(r["logits_err"] for r in ranks)
        e_grads = max(r["grads_err"] for r in ranks)
        print(f"[pp gpt2] one fp32 step at data=1,pipe={PP_STAGES}, "
              f"{job['schedule']}, M=2, {ranks[0]['sharded']} of "
              f"{ranks[0]['leaves']} leaves cut into stages: logits max "
              f"abs err {e_logits:.3g} (gate {GRID_LOGITS_ATOL}), gradients "
              f"max abs err {e_grads:.3g} (gate {GRID_GRAD_ATOL}) against "
              "the dense twin")
        if not (e_logits <= GRID_LOGITS_ATOL and e_grads <= GRID_GRAD_ATOL):
            fail(f"pp gpt2 ({job['schedule']}): the staged step differs "
                 "from its dense twin")


def check_pp_run(tag: str, res: dict, schedule: str, m: int,
                 argv: list[str], wall: float) -> dict:
    """A [pp gpt2] run's gates and lines: every rank's flash launches =
    its 6 blocks x its passes (each step's M microbatch forwards and
    backwards, each validation step's M forwards) + the dense twin's 12
    blocks x the probe's passes; the replicated leaves checked bitwise
    equal along pipe after every round; the microbatches in flight (M
    under GPipe, at most P - s on stage s under 1F1B); each rank's
    parameter and moment bytes its stage's share.  Prints per rank the
    step ms and tokens/s, hop ms and bytes per pass, the replicated
    all-reduce, the microbatches in flight, state bytes and peak memory.
    Returns rank 0's launch counts."""
    from importlib import import_module
    fused = import_module(f"{PKG}.ops.flash")._use_fused_bwd()
    probe = 1 + import_module(f"{PKG}.config").config_from_args(
        argv).probe_batches
    g, rt = res["grid"], res["round_timings"]
    for r in range(g["ranks"]):
        s = g["coords_of"][r]["pipe"]
        train, val = g["steps"][r]
        grad = 2 * PP_STAGE_LAYERS * probe + PP_STAGE_LAYERS * m * train
        want = {"flash_fwd": 2 * PP_STAGE_LAYERS * probe
                + PP_STAGE_LAYERS * m * (train + val),
                "flash_bwd_dq": 0 if fused else grad,
                "flash_bwd_dkv": 0 if fused else grad,
                "flash_bwd_fused": grad if fused else 0}
        pp, st = g["pp"][r], g["state_bytes"][r]
        step_ms = sum(x["ranks_train_ms"][r] for x in rt) / max(train, 1)
        passes = max(train + val, 1)
        bound = m if schedule == "gpipe" else min(PP_STAGES - s, m)
        print(f"{tag} rank {r} stage {s}: launches {g['launches'][r]}; "
              f"expected {want} (6 blocks x {m} microbatches x {train} "
              f"train + {val} val steps, 12 blocks x {probe} probe passes)")
        print(f"{tag} rank {r} stage {s}: train step {step_ms:.3f} ms over "
              f"{train} steps, {PATH_BATCH * PATH_LEN / step_ms * 1e3:,.0f} "
              f"tokens/s; hops forward {pp['fwd_ms'] / passes:.3f} ms, "
              f"{pp['fwd_bytes'] / passes:,.0f} B per pass (train + val), "
              f"backward {pp['bwd_ms'] / max(train, 1):.3f} ms, "
              f"{pp['bwd_bytes'] / max(train, 1):,.0f} B per train step; "
              f"replicated all-reduce {pp['grad_ms'] / max(train, 1):.3f} "
              f"ms, {pp['grad_bytes'] / max(train, 1):,.0f} B per step; "
              f"in flight {pp['in_flight']} (bound {bound}), "
              f"{pp['mem_in_flight'] / 2**30:.2f} GiB allocated at the "
              f"most; params {st['params']:,} B, Adam moments "
              f"{st['opt_state']:,} B, {(st['params'] + st['opt_state'] - 4) / 1e6:.1f} MB; "
              f"max_memory_allocated "
              f"{max(x['ranks_max_memory_allocated'][r] for x in rt) / 2**30:.2f} GiB")
        if g["launches"][r] != want:
            fail(f"{tag}: rank {r}'s launch counts {g['launches'][r]} are "
                 f"not its passes' {want}")
        if (pp["in_flight"] > PP_STAGES - s if schedule == "1f1b"
                else pp["in_flight"] != m):
            fail(f"{tag}: stage {s} held {pp['in_flight']} microbatches in "
                 f"flight under {schedule} (M = {m})")
        if (st["params"], st["opt_state"]) != (4 * PP_RANK_PARAMS,
                                               8 * PP_RANK_PARAMS + 4):
            fail(f"{tag}: rank {r} holds {st['params']:,} B of parameters "
                 f"and {st['opt_state']:,} B of moments, not its stage's "
                 f"{4 * PP_RANK_PARAMS:,} and {8 * PP_RANK_PARAMS + 4:,}")
        if not (pp["fwd_calls"] and pp["bwd_calls"] and pp["grad_calls"]):
            fail(f"{tag}: rank {r} ran no hop or no replicated all-reduce "
                 f"{pp}")
    if g["pipe_bitwise_rounds"] != len(rt):
        fail(f"{tag}: the replicated leaves were checked along pipe after "
             f"{g['pipe_bitwise_rounds']} of {len(rt)} rounds")
    print(f"{tag} {g['ranks']} processes {g['axes']} on one card, "
          f"{schedule}, M={m}: replicated leaves bitwise equal along pipe "
          f"after {g['pipe_bitwise_rounds']} round(s); stage parameters "
          f"{PP_RANK_PARAMS:,} of {GPT2_PARAMS:,} "
          f"({PP_RANK_PARAMS / GPT2_PARAMS:.3f}); wall {wall:.1f} s; losses "
          f"{res['global_train_losses']}")
    return g["launches"][0]


def phase_pp(runner) -> dict:
    """[pp gpt2]: the gpt2 path at data=1,pipe=2 with flash attention: the
    fp32 pair under GPipe and under 1F1B (M = 2) against one data=1 twin,
    then the bf16 runs at M = 4, each checked by ``check_pp_run``, the
    bf16 ones' loss falling.  The 2-process runs are ``runner``'s next
    four jobs.  Returns rank 0's launch counts of the bf16 1F1B run."""
    tag = "[pp gpt2]"
    t0 = time.perf_counter()
    twin, twin_wall = grid_run(tag, pp_twin_argv())
    data_lines(f"{tag} fp32 data-only twin", twin, twin_wall)
    for schedule in PP_SCHEDULES:
        argv = pp_argvs(schedule)[0]
        t_run = time.perf_counter()
        res = grid_parity(f"{tag} {schedule}", None, argv, runner=runner,
                          twin=twin)
        check_pp_run(f"{tag} {schedule} fp32", res, schedule, PP_STAGES,
                     argv, time.perf_counter() - t_run)
        del res
    del twin
    counts = None
    for schedule in PP_SCHEDULES:
        argv = pp_argvs(schedule)[1]
        res, wall = grid_run(tag, argv, runner)
        check_losses(f"pp gpt2 {schedule}", res)
        counts = check_pp_run(f"{tag} {schedule}", res, schedule, 4, argv,
                              wall)
        del res
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def ep_argvs() -> tuple:
    """[ep moe]'s launch lines: the fp32 pair's data=1 twin and grid run,
    and the timed bf16 run."""
    argv = [*PATHS["moe"][0], "--out_dir", os.path.join(OUT_DIR, "ep_moe")]
    small = [*argv, *SP_FP32]
    return ([*small, "--mesh_shape", "data=1"], [*small, *EP_MESH],
            [*argv, *GRID_CUT, *EP_MESH])


def ep_module_job() -> dict:
    """[ep moe]'s one-step check (grid_harness.module_job on
    data=1,expert=2): the moe path's model (bert_base, 8 experts) in fp32
    with flash attention, its seeded init (the same on both ranks), on
    EP_MODULE_BATCH random sequences: the logits and the joined gradients,
    every gate leaf's included, against the dense twin; each rank's aux."""
    import numpy as np
    rng = np.random.default_rng(2)
    b = EP_MODULE_BATCH
    argv = PATHS["moe"][0]
    model = argv[argv.index("--model") + 1]
    return dict(model=model, vocab=1000, axes={"data": 1,
                                               "expert": EP_RANKS},
                summary=True, label="ep",
                kw=dict(attention_impl="flash", num_experts=MOE_EXPERTS,
                        mesh_shape=f"data=1,expert={EP_RANKS}"),
                x=rng.integers(0, 1000, (b, PATH_LEN)),
                y=rng.integers(0, 1000, (b, PATH_LEN)),
                m=np.ones(b, np.float32))


def check_ep_module(ranks: list) -> None:
    """[ep moe]'s one-step check: the logits and the joined gradients
    against the dense twin at the grid's gates; on every rank the flash
    launches of its pass (one forward and one backward of each of the 12
    layers) and its own aux loss, equal on both ranks, finite, at least
    layers / E and within EP_AUX_ATOL of the dense twin's."""
    layers = PATHS["moe"][1]
    e_logits = max(r["logits_err"] for r in ranks)
    e_grads = max(r["grads_err"] for r in ranks)
    auxes = [r["aux"] for r in ranks]
    e_aux = max(r["aux_err"] for r in ranks)
    want = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "flash_bwd_fused": 0}
    print(f"[ep moe] one fp32 step at data=1,expert={EP_RANKS}, "
          f"{ranks[0]['sharded']} of {ranks[0]['leaves']} leaves cut over "
          f"expert: logits max abs err {e_logits:.3g} (gate "
          f"{GRID_LOGITS_ATOL}), gradients (the gates' included) max abs err "
          f"{e_grads:.3g} (gate {GRID_GRAD_ATOL}) against the dense twin; "
          f"aux summed over {layers} layers by rank {auxes}, the dense "
          f"twin's {ranks[0]['dense_aux']}, max abs err {e_aux:.3g} (gate "
          f"{EP_AUX_ATOL}); launches by rank "
          f"{[r['launches'] for r in ranks]} (expected {want})")
    if not (e_logits <= GRID_LOGITS_ATOL and e_grads <= GRID_GRAD_ATOL):
        fail("ep moe: the expert-parallel step differs from its dense twin")
    if not (all(math.isfinite(a) and a >= layers / MOE_EXPERTS - 1e-6
                for a in auxes) and len(set(auxes)) == 1):
        fail(f"ep moe: the ranks' aux losses {auxes} are not finite, equal "
             f"and at least {layers}/{MOE_EXPERTS}")
    if not e_aux <= EP_AUX_ATOL:
        fail(f"ep moe: a rank's aux loss is {e_aux} from the dense twin's")
    if any(r["launches"] != want for r in ranks):
        fail("ep moe: a rank's launches in the one-step check are not one "
             "pass of each layer")


def check_ep_run(tag: str, res: dict, argv: list[str], wall: float) -> dict:
    """An [ep moe] run's gates and lines: every rank's flash launches =
    the 12 layers x its passes (the whole attention of the whole batch on
    every expert rank) + the dense twin's x the probe's; the replicated
    leaves checked bitwise equal along expert after every round; each
    rank's parameter and moment bytes its share (every leaf but the
    experts whole, half of the expert stacks).  Prints per rank the step
    ms and tokens/s, the EP all-reduce's calls, ms and bytes per pass,
    the state bytes and the peak.  Returns rank 0's launch counts."""
    layers = PATHS["moe"][1]
    counts = check_grid_launches(tag, res, layers, argv)
    g, rt = res["grid"], res["round_timings"]
    named = list(res["model"].named_parameters())
    total = sum(p.numel() for _n, p in named)
    experts = sum(p.numel() for n, p in named
                  if ".moe." in n and ".gate." not in n)
    share = total - experts + experts // EP_RANKS
    for r in range(g["ranks"]):
        train, val = g["steps"][r]
        passes = max(train + val, 1)
        ep, st = g["ep"][r], g["state_bytes"][r]
        step_ms = sum(x["ranks_train_ms"][r] for x in rt) / max(train, 1)
        print(f"{tag} rank {r} {g['coords_of'][r]}: train step "
              f"{step_ms:.3f} ms over {train} steps, "
              f"{PATH_BATCH * PATH_LEN / step_ms * 1e3:,.0f} tokens/s; EP "
              f"all-reduce {ep['ms'] / passes:.3f} ms, "
              f"{ep['calls'] / passes:.1f} calls, "
              f"{ep['bytes'] / passes:,.0f} B per pass (train + val), "
              f"{ep['bytes']:,} B in all; params {st['params']:,} B, Adam "
              f"moments {st['opt_state']:,} B, "
              f"{(st['params'] + st['opt_state'] - 4) / 1e6:.1f} MB "
              f"({share:,} of {total:,} parameters); max_memory_allocated "
              f"{max(x['ranks_max_memory_allocated'][r] for x in rt) / 2**30:.2f} GiB")
        if (st["params"], st["opt_state"]) != (4 * share, 8 * share + 4):
            fail(f"{tag}: rank {r} holds {st['params']:,} B of parameters "
                 f"and {st['opt_state']:,} B of moments, not its share's "
                 f"{4 * share:,} and {8 * share + 4:,}")
        if not ep["calls"]:
            fail(f"{tag}: rank {r} ran no expert all-reduce {ep}")
    if g["expert_bitwise_rounds"] != len(rt):
        fail(f"{tag}: the replicated leaves were checked along expert after "
             f"{g['expert_bitwise_rounds']} of {len(rt)} rounds")
    print(f"{tag} {g['ranks']} processes {g['axes']} on one card: "
          f"replicated leaves bitwise equal along expert after "
          f"{g['expert_bitwise_rounds']} round(s); wall {wall:.1f} s; losses "
          f"{res['global_train_losses']}")
    return counts


def phase_ep(runner) -> dict:
    """[ep moe]: the moe path at data=1,expert=2 with flash attention: the
    fp32 pair (one round of 2 steps) against the data=1 twin, then the
    bf16 run, each checked by ``check_ep_run``, the bf16 one's loss
    falling and the trained model's routing printed (``moe_routing``:
    each layer's aux at least 1/E).  The 2-process runs are ``runner``'s
    next two jobs.  Returns rank 0's launch counts of the bf16 run."""
    import numpy as np
    from importlib import import_module
    train = import_module(f"{PKG}.train")
    tag = "[ep moe]"
    t0 = time.perf_counter()
    twin_argv, grid_argv, bf16_argv = ep_argvs()
    t_run = time.perf_counter()
    res = grid_parity(tag, twin_argv, grid_argv, runner=runner)
    check_ep_run(f"{tag} fp32", res, grid_argv, time.perf_counter() - t_run)
    del res
    res, wall = grid_run(tag, bf16_argv, runner)
    check_losses("ep moe", res)
    counts = check_ep_run(tag, res, bf16_argv, wall)
    model = res["model"]
    moe_routing(model, train.to_device(
        np.asarray(res["test"].images[:PATH_BATCH]),
        next(model.parameters()).device))
    del res, model
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def phase_unrolled(runner) -> dict:
    """[unrolled gpt2]: the gpt2 path under --layer_scan off on 2 worker
    processes (``runner``'s next job), sharded int8 sync with error
    feedback, 2 rounds, a checkpoint of the last.  Checks each worker's
    launches (12 x its passes), the falling loss, both workers' parameters
    bitwise equal after the sync, the sync's 37 buckets and its wire bytes
    (``comms.sync_wire_bytes`` of the unrolled leaves), the MANIFEST
    (``scan_layers`` false, the 148 unrolled leaves in sorted order), the
    epoch restored into a fresh engine bit for bit, the epoch refused by
    an --layer_scan auto engine and by ``main serve`` with JAX's words.
    Returns rank 0's launch counts (its evaluation's included)."""
    import dataclasses
    import torch
    from importlib import import_module
    t_ckpt = import_module(f"{PKG}.checkpoint")
    t_driver = import_module(f"{PKG}.driver")
    comms = import_module(f"{PKG}.comms")
    config = import_module(f"{PKG}.config")
    fl = import_module(f"{PKG}.ops.flash")
    models = import_module(f"{PKG}.models")
    train = import_module(f"{PKG}.train")
    weights = import_module(f"{PKG}.weights")
    tag = "[unrolled gpt2]"
    layers = PATHS["gpt2"][1]
    t0 = time.perf_counter()
    shutil.rmtree(UNROLLED_DIR, ignore_errors=True)
    cfg = config.config_from_args(UNROLLED_ARGV)
    res, wall = grid_run(tag, UNROLLED_ARGV, runner)
    counts = dict(fl.LAUNCHES)
    first, last = check_losses("unrolled gpt2", res)
    probe = 1 + cfg.probe_batches
    for w, got in enumerate(res["worker_launches"]):
        train_steps, val_steps = got["steps"]
        want = {"flash_fwd": layers * (probe + train_steps + val_steps),
                "flash_bwd_dq": layers * (probe + train_steps),
                "flash_bwd_dkv": layers * (probe + train_steps),
                "flash_bwd_fused": 0}
        print(f"{tag} worker {w}: launches {got['launches']}; expected "
              f"{want} ({layers} layers; {train_steps} train steps, "
              f"{val_steps} val steps, {probe} probe passes)")
        if got["launches"] != want:
            fail(f"{tag}: worker {w}'s launches {got['launches']} are not "
                 f"its passes' {want}")
    sums = res["param_checksums"]
    if len(set(sums)) != 1:
        fail(f"{tag}: the workers hold different parameters after the "
             f"sync: {sums}")
    # the wire: JAX's unrolled leaves, buckets and bytes
    leaves, _pieces = weights.wire_layout(res["model"])
    bucket_bytes = int(cfg.sync_bucket_mb * (1 << 20))
    plan = comms.bucket_plan(leaves, 2, bucket_bytes)
    stacked = comms.bucket_plan(weights.wire_layout(models.get_model(
        "gpt2_small", num_classes=1000, device="meta"))[0], 2, bucket_bytes)
    want_bytes = comms.sync_wire_bytes(leaves, 2, mode="sharded",
                                       wire_dtype=torch.int8,
                                       bucket_bytes=bucket_bytes)
    rt = res["round_timings"]
    print(f"{tag} sync: {len(leaves)} leaves in {len(plan)} buckets (the "
          f"stacked layout: {len(stacked)}), wire "
          f"{[r['sync_wire_bytes'] for r in rt]} B a worker a round, "
          f"sync_wire_bytes {want_bytes:,}; sync ms per worker "
          f"{[r['workers_sync_ms'] for r in rt]}; losses first batch "
          f"{first:.4f} -> last epoch {last:.4f}; wall {wall:.1f} s")
    if (len(leaves), len(plan), len(stacked)) != (
            UNROLLED_LEAVES, UNROLLED_BUCKETS, STACKED_BUCKETS) or any(
            r["sync_wire_bytes"] != want_bytes for r in rt):
        fail(f"{tag}: {len(leaves)} leaves, {len(plan)} buckets "
             f"({len(stacked)} stacked), wire "
             f"{[r['sync_wire_bytes'] for r in rt]} B vs {want_bytes}")
    # the manifest: the unrolled layout, in JAX's sorted order
    path = t_ckpt.latest_checkpoint(UNROLLED_DIR)
    meta = t_ckpt.read_manifest(path)["metadata"]
    tops = list(dict.fromkeys(p[0][0] for p in meta["params_leaves"]))
    print(f"{tag} MANIFEST {os.path.basename(path)}: scan_layers "
          f"{meta['scan_layers']}, {len(meta['params_leaves'])} "
          f"params_leaves, top-level order (JAX's sorted keys: layer10 "
          f"before layer2) {tops}")
    if (meta["scan_layers"] is not False
            or len(meta["params_leaves"]) != UNROLLED_LEAVES
            or tops != sorted(tops) or "layers" in tops
            or [t for t in tops if t.startswith("layer")]
            != sorted(f"layer{i}" for i in range(layers))):
        fail(f"{tag}: the manifest does not hold the unrolled layout: "
             f"scan_layers {meta['scan_layers']}, top-level {tops}")
    device = next(res["model"].parameters()).device
    final = _worker_state_host(
        train.LocalSGDEngine(res["model"], cfg, device), res["state"])
    del res
    torch.cuda.empty_cache()

    def template(argv: list[str]):
        c = config.config_from_args(argv)
        engine = train.LocalSGDEngine(
            t_driver.build_model_for(c, 1000, device, (PATH_LEN,)), c,
            device)
        state = engine.init_state()
        return engine, state, dataclasses.replace(
            engine.checkpoint_state(state), worker=0, n_workers=2)

    # worker 0's row into a fresh engine, bit for bit
    t1 = time.perf_counter()
    engine, state, tmpl = template(UNROLLED_ARGV)
    restored, epoch = t_ckpt.restore_checkpoint(path, tmpl)
    state = engine.load_checkpoint_state(state, restored)
    torch.cuda.synchronize()
    got = _worker_state_host(engine, state)
    differ = [k for k in final if not (
        torch.equal(final[k], got[k]) if isinstance(final[k], torch.Tensor)
        else final[k] == got[k])]
    print(f"{tag} epoch {epoch} restored into a fresh engine in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms: "
          f"{sum(isinstance(v, torch.Tensor) for v in final.values())} "
          f"tensors + count/lr_epoch/rng, {len(differ)} differ")
    if epoch != 2 or differ or not any(k.startswith("residual/")
                                       for k in final):
        fail(f"{tag}: restored epoch {epoch}; differing {differ[:5]}")
    del engine, state, restored, final, got
    # the other layout's resume and `main serve` refuse it, with JAX's words
    _engine, _state, tmpl = template(
        [*UNROLLED_ARGV, "--layer_scan", "auto", "--resume"])
    refusals = {}
    try:
        t_ckpt.restore_checkpoint(path, tmpl)
    except ValueError as e:
        refusals["auto"] = str(e)
    del _engine, _state, tmpl
    try:
        import_module(f"{PKG}.main").run([
            "serve", "--checkpoint_dir", UNROLLED_DIR,
            *(["--device", cfg.device] if cfg.device else [])])
    except ValueError as e:
        refusals["serve"] = str(e)
    for what, text in refusals.items():
        print(f"{tag} {what}: {text}")
    if not re.fullmatch(
            rf"checkpoint {re.escape(path)} has no leaf \.params\['layers'\]"
            r"\S* required by the restore template \(engine config "
            r"mismatch\?\)", refusals.get("auto", "")) or not refusals.get(
                "serve", "").startswith(
                    "checkpoint was saved with an unrolled (non-layer-scan) "
                    "parameter layout"):
        fail(f"{tag}: the other layout's refusals are not JAX's: "
             f"{refusals}")
    shutil.rmtree(UNROLLED_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{tag} phase wall {time.perf_counter() - t0:.1f} s")
    return counts


def two_process_jobs(work_dir: str) -> tuple[list, list]:
    """The jobs of one start of 2 processes (main.run_shared): the module
    checks (grid_harness.module_worker: [fsdp cnn]'s one step, [sp attn],
    the toy schedules, [pp gpt2]'s one steps, [ep moe]'s one step), [tp
    gpt2]'s data-only twin (2 worker processes), the SP runs (each path's
    fp32 grid run and bf16 run), the PP runs (the fp32 grid run under each
    schedule, then the bf16 ones), the EP runs (the fp32 grid run and
    the bf16 one), then [unrolled gpt2].  Returns ``(jobs, module
    jobs)``."""
    import torch
    from importlib import import_module
    harness = import_module(f"{PKG}.grid_harness")
    module = [fsdp_module_job(GRID_CHECK_WIDTH), *sp_attn_jobs(),
              *pp_toy_jobs(), *pp_module_jobs(), ep_module_job()]
    os.makedirs(work_dir, exist_ok=True)
    spec = os.path.join(work_dir, "jobs.pt")
    torch.save({"axes": module[0]["axes"], "jobs": module}, spec)
    jobs = [(harness.module_worker, (spec, work_dir, GRID_CHECK_DEVICE)),
            tp_gpt2_argvs()[0]]
    for path in SP_RUNS:
        jobs += list(sp_argvs(path)[1:])
    jobs += [pp_argvs(s)[0] for s in PP_SCHEDULES]
    jobs += [pp_argvs(s)[1] for s in PP_SCHEDULES]
    jobs += list(ep_argvs()[1:])
    jobs.append(UNROLLED_ARGV)
    return jobs, module


def module_outputs(d: str, n: int, count: int) -> list:
    """Every rank's result of each of ``count`` module jobs in ``d``, once
    all are there (written by rename)."""
    import torch
    names = [f"rank{r}-{i}.pt" for i in range(count) for r in range(n)]
    t0 = time.perf_counter()
    while not all(os.path.exists(os.path.join(d, x)) for x in names):
        if time.perf_counter() - t0 > 120.0:
            fail(f"module check outputs missing in {d}")
        time.sleep(0.05)
    return [[torch.load(os.path.join(d, f"rank{r}-{i}.pt"),
                        weights_only=False) for r in range(n)]
            for i in range(count)]


def phase_two_process() -> tuple[dict, dict]:
    """The 2-process phases from ONE start of their ranks: the module
    checks ([fsdp cnn]'s one step, [sp attn], [pp toy], [pp gpt2]'s and
    [ep moe]'s one steps) on GRID_CHECK_DEVICE, [tp gpt2]'s data-only
    twin, [sp gpt2], [sp bert], [pp gpt2], [ep moe], [unrolled gpt2].  The
    module checks run with TF32 off in this process, restored after.
    Returns [pp gpt2]'s, [ep moe]'s and [unrolled gpt2]'s rank-0 launch
    counts, by path, and the twin's losses and round timings."""
    import torch
    from importlib import import_module
    main = import_module(f"{PKG}.main")
    t0 = time.perf_counter()
    work = os.path.join(OUT_DIR, "two_process")
    shutil.rmtree(work, ignore_errors=True)
    jobs, module = two_process_jobs(work)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with main.run_shared(jobs) as runner:
        runner()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        res = module_outputs(work, 2, len(module))
        kinds = [j.get("kind", "module") for j in module]
        check_fsdp_module(res[0])
        check_sp_attn([j for j in module if j.get("kind") == "sp"],
                      [r for r, k in zip(res, kinds) if k == "sp"])
        check_pp_toy([j for j in module if j.get("kind") == "pp"],
                     [r for r, k in zip(res, kinds) if k == "pp"])
        pp_module = [i for i, j in enumerate(module)
                     if j.get("schedule") and "model" in j]
        check_pp_module([module[i] for i in pp_module],
                        [res[i] for i in pp_module])
        check_ep_module(res[[j.get("label") for j in module].index("ep")])
        print(f"[fsdp cnn] + [sp attn] + [pp toy] + [pp gpt2] + [ep moe] "
              f"module checks wall {time.perf_counter() - t0:.1f} s")
        res, wall = grid_run("[tp gpt2]", tp_gpt2_argvs()[0], runner)
        data_lines("[tp gpt2] fp32 data-only twin", res, wall)
        twin = {k: res[k] for k in ("global_train_losses",
                                    "global_val_losses", "round_timings",
                                    "sync_engine")}
        del res
        for path in SP_RUNS:
            phase_sp(path, runner)
        counts = {"pp_gpt2": phase_pp(runner)}
        counts["ep_moe"] = phase_ep(runner)
        counts["unrolled_gpt2"] = phase_unrolled(runner)
    print(f"[two-process] {len(jobs)} jobs from one start of 2 processes "
          f"in {time.perf_counter() - t0:.1f} s")
    return counts, twin


def phase_grid() -> dict:
    """The rank grid's phases, from one start of 2 processes (the module
    checks, [tp gpt2]'s data-only twin, SP, PP and EP) and one of 4 ([tp
    gpt2]'s fp32 grid and bf16 runs, [tp fsdp bert]'s grid run, [fsdp
    cnn], [stale tp gpt2]); returns their rank-0 launch counts."""
    from importlib import import_module
    main = import_module(f"{PKG}.main")
    counts, twin = phase_two_process()
    t0 = time.perf_counter()
    jobs = [*tp_gpt2_argvs()[1:], tp_fsdp_bert_argvs()[1], fsdp_cnn_argv(),
            stale_tp_argv()]
    with main.run_shared(jobs) as runner:
        counts["tp_gpt2"] = phase_tp_gpt2(runner, twin)
        counts["tp_fsdp_bert"] = phase_tp_fsdp_bert(runner)
        phase_fsdp_cnn(runner)
        counts["stale_tp_gpt2"] = phase_stale_tp(runner)
    print(f"[grid] {len(jobs)} jobs from one start of 4 processes in "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def two_process_alone() -> int:
    """``python3 chip_smoke.py sp`` (or ``pp``, ``ep``): the 2-process
    phases alone (module checks, sp gpt2, sp bert, pp gpt2, ep moe,
    unrolled gpt2), with
    the kernels built and the pipeline stage's microbatch shape and the
    expert ranks' (the moe path's) checked."""
    import torch
    os.environ.pop("FLASH_BWD", None)
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        if shape[0] in ("pp_gpt2", "bert_path"):
            check_shape(*shape)
    counts, _twin = phase_two_process()
    print(json.dumps({"two_process_counts": counts}))
    print(f"[two-process] phases wall {time.perf_counter() - t0:.1f} s")
    return 0


def elastic_tp_alone() -> int:
    """``CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py elastic_tp``:
    [elastic tp gpt2] and [stale tp gpt2] alone, with the kernels built
    and the TP head-shard instance checked (a short card call while they
    change)."""
    import torch
    from importlib import import_module
    os.environ.pop("FLASH_BWD", None)
    phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        if shape[0] == "tp_gpt2":
            check_shape(*shape)
    import tempfile
    main = import_module(f"{PKG}.main")
    t_driver = import_module(f"{PKG}.driver")
    with main.run_shared([stale_tp_argv()]) as runner:
        counts = {"stale_tp_gpt2": phase_stale_tp(runner)}
    _deterministic()
    t_driver.fresh_rank()
    snap_dir = tempfile.mkdtemp(prefix="chip-smoke-snapshots-")
    jobs, dirs = elastic_jobs(snap_dir)
    try:
        with t_driver.SharedStart(6, jobs[:2],
                                  target=elastic_rank) as start:
            counts["elastic_tp_gpt2"] = elastic_tp(
                start, dirs["tp_twin"])["counts"]
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    print(json.dumps({"elastic_tp_counts": counts}))
    return 0


def grid_alone() -> int:
    """``python3 chip_smoke.py grid``: the rank grid's kernel shapes and
    phases alone (a short card call while they change)."""
    import torch
    os.environ.pop("FLASH_BWD", None)
    phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        if shape[0] in (*TP_SHAPES, "pp_gpt2"):
            check_shape(*shape)
    counts = phase_grid()
    counts["tp_llama"] = phase_tp_llama()
    print(json.dumps({"grid_counts": counts}))
    return 0


AB_PHASE = "kernels_ab"


def _kernel_set(csrc: str, build_dir: str) -> tuple[dict, float, int]:
    """Build the libraries of the kernel sources in ``csrc`` into
    ``build_dir`` with ops/_build.py's flags; return their C entry points
    by name, the build's wall (s) and the largest Lk at which the tree's
    fused kernel writes dq whole (its ``flash_bwd_fused_whole_keys``; 0
    for a tree without it, whose fused kernel adds every dq into a
    zero-filled fp32 accumulator).  ops/_build.py's own state is left as
    it was."""
    import ctypes
    from importlib import import_module
    from pathlib import Path
    build = import_module(f"{PKG}.ops._build")
    saved = (build.CSRC, build.BUILD_DIR, dict(build._loaded),
             dict(build._functions))
    build.CSRC, build.BUILD_DIR = Path(csrc), Path(build_dir)
    build._loaded.clear()
    build._functions.clear()
    try:
        t0 = time.perf_counter()
        logs = build.build_all()
        wall = time.perf_counter() - t0
        for name, text in logs.items():
            for line in text.splitlines():
                if any(w in line.lower() for w in ("ptxas", "spill", "error")):
                    print(f"[ab build] {csrc} {name}: {line.strip()}")
        fns = {sym: build.function(sym) for sym in build.SIGNATURES}
        try:
            whole_keys = ctypes.c_int.in_dll(build._loaded["flash_bwd_fused"],
                                             "flash_bwd_fused_whole_keys").value
        except ValueError:              # the symbol is absent
            whole_keys = 0
    finally:
        build.CSRC, build.BUILD_DIR = saved[:2]
        build._loaded.clear()
        build._loaded.update(saved[2])
        build._functions.clear()
        build._functions.update(saved[3])
    return fns, wall, whole_keys


# kernels this tree leaves as its parent had them: kernels_ab holds their
# outputs bitwise equal in the two trees
AB_SAME = ("flash_fwd", "flash_bwd_dkv")


def _fused_wrapper(fl, fn, whole_keys, q, k, v, do, lse, delta, causal):
    """ops/flash.py's kernel_bwd_fused for another tree's C entry point
    ``fn``: dq written whole at Lk <= ``whole_keys``, else the fp32
    accumulator's zero-fill, the launch and the cast."""
    import torch
    dq, dk, dv = _fused_outputs(
        q, k, v, q.dtype == torch.bfloat16 and k.shape[1] <= whole_keys)
    fl._check(fn(*fl._fused_args(q, k, v, do, lse, delta, dq, dk, dv,
                                 causal)), "flash_bwd_fused")
    return dq.to(q.dtype), dk, dv


def kernels_ab(other_csrc: str) -> int:
    """``python3 chip_smoke.py kernels_ab <csrc>``: the kernels of another
    tree (``csrc``, e.g. the parent commit's) beside this tree's in one
    card call; see the module docstring."""
    import torch
    import torch.nn.functional as F
    from importlib import import_module
    os.environ.pop("FLASH_BWD", None)
    name, smi = phase_device()
    fl = import_module(f"{PKG}.ops.flash")
    build = import_module(f"{PKG}.ops._build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sets, whole_keys = {}, {}
    for tree, csrc, where in (
            ("other", other_csrc, os.path.join(OUT_DIR, "ab_other")),
            ("this", str(build.CSRC), str(build.BUILD_DIR))):
        sets[tree], wall, whole_keys[tree] = _kernel_set(csrc, where)
        print(f"[ab build] {tree} ({csrc}): {wall:.1f} s; fused dq whole "
              f"up to Lk {whole_keys[tree]}")
    if whole_keys["this"] != fl.FUSED_WHOLE_KEYS:
        fail(f"[ab] csrc/flash_bwd_fused.cu writes dq whole up to Lk "
             f"{whole_keys['this']}, ops/flash.py assumes "
             f"{fl.FUSED_WHOLE_KEYS}")
    real_function = build.function
    rows = {}
    try:
        for label, b, l, h, kv, d, causal in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn(b, l, n, d, generator=g, device="cuda",
                                       dtype=torch.bfloat16)
                           for n in (h, kv, kv, h))
            f32 = [t.float() for t in (q, k, v, do)]
            o_ref, lse = fl.plain_forward(*f32[:3], causal)
            delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
            refs = {"flash_fwd": (o_ref,),
                    "flash_bwd_dq": (fl.plain_bwd_dq(*f32, lse, delta,
                                                     causal),),
                    "flash_bwd_dkv": fl.plain_bwd_dkv(*f32, lse, delta,
                                                      causal),
                    "flash_bwd_fused": fl.plain_bwd_fused(*f32, lse, delta,
                                                          causal)}
            calls = {
                "flash_fwd": lambda: fl.kernel_forward(q, k, v, causal,
                                                       True)[:1],
                "flash_bwd_dq": lambda: (fl.kernel_bwd_dq(
                    q, k, v, do, lse, delta, causal),),
                "flash_bwd_dkv": lambda: fl.kernel_bwd_dkv(
                    q, k, v, do, lse, delta, causal),
                # the wrapper whole: this tree's, the other's replayed
                "flash_bwd_fused": {
                    "this": lambda: fl.kernel_bwd_fused(
                        q, k, v, do, lse, delta, causal),
                    "other": lambda: _fused_wrapper(
                        fl, sets["other"]["flash_bwd_fused"],
                        whole_keys["other"], q, k, v, do, lse, delta,
                        causal)}}
            # the fused kernel's launch alone, without the wrapper's
            # zero-fill and cast where the tree needs them
            alone = {tree: _fused_kernel_alone(
                fl, q, k, v, do, lse, delta, causal,
                fn=sets[tree]["flash_bwd_fused"],
                whole_keys=whole_keys[tree]) for tree in sets}
            iters = 50 if l <= 256 else 10
            times = {kname: {"other": [], "this": [], "other_paced": [],
                             "this_paced": []}
                     for kname in (*calls, "flash_bwd_fused_kernel")}
            outs = {}
            # the outputs that repeat bitwise in this tree: all but a dq
            # the fused kernel sums by atomics
            atomic_dq = k.shape[1] > whole_keys["this"]
            for tree in ("other", "this", "this", "other"):
                build.function = sets[tree].__getitem__
                for kname, call in calls.items():
                    if isinstance(call, dict):
                        call = call[tree]
                    first, second = call(), call()
                    torch.cuda.synchronize()
                    tol = TOL_O if kname == "flash_fwd" else TOL_GRAD
                    for got, ref in zip(first, refs[kname]):
                        e, rel = _err(got, ref)
                        if not (math.isfinite(e) and rel <= tol):
                            fail(f"[ab] {label} {tree} {kname}: {rel:.3g} of "
                                 f"max |plain| exceeds {tol}")
                    skip = 1 if kname == "flash_bwd_fused" and atomic_dq \
                        else 0
                    repeat = all(torch.equal(x, y) for x, y
                                 in zip(first[skip:], second[skip:]))
                    if tree == "this" and not repeat:
                        fail(f"[ab] {label} {kname}: two runs differ")
                    outs[tree, kname] = first
                    times[kname][tree].append(cuda_ms(call, iters))
                    times[kname][tree + "_paced"].append(
                        cuda_ms(call, iters, paced=True))
                times["flash_bwd_fused_kernel"][tree].append(
                    cuda_ms(alone[tree], iters))
                times["flash_bwd_fused_kernel"][tree + "_paced"].append(
                    cuda_ms(alone[tree], iters, paced=True))
            build.function = real_function
            for kname in AB_SAME:
                if not all(torch.equal(got, ref) for got, ref in zip(
                        outs["this", kname], outs["other", kname])):
                    fail(f"[ab] {label} {kname}: the outputs differ "
                         f"between the trees, though this tree leaves it "
                         f"as it was")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kv != h), iters)
            aten_ms, aten_note = _sdpa_backward_ms(q, k, v, do, causal,
                                                   iters)
            work = kernel_work(b, l, h, kv, d, causal)
            row = rows[label] = {"shape": [b, l, h, kv, d, causal],
                                 "sdpa_fwd_ms": sdpa_ms,
                                 "aten_bwd_ms": aten_ms}
            for kname, t in times.items():
                mean = {key: sum(vals) / len(vals) for key, vals in t.items()}
                b_ms, b_by = bound(*work[kname.removesuffix("_kernel")])
                row[kname] = dict(mean, runs=t, bound_ms=b_ms, bound_by=b_by)
                runs = t["other"][:1] + t["this"] + t["other"][1:]  # in turn
                print(f"[ab] {label} [B={b} L={l} H={h} KV={kv} D={d} "
                      f"causal={causal}] {kname}: other "
                      f"{mean['other']:.4f} ms this {mean['this']:.4f} ms "
                      f"(x other {mean['this'] / mean['other']:.3f}; runs "
                      f"{' '.join(f'{x:.4f}' for x in runs)}) "
                      f"host-paced other {mean['other_paced']:.4f} this "
                      f"{mean['this_paced']:.4f}; bound {b_ms:.5f} ({b_by}),"
                      f" this x bound {mean['this'] / b_ms:.2f}")
            pair = {tree: row["flash_bwd_dq"][tree]
                    + row["flash_bwd_dkv"][tree] for tree in ("other", "this")}
            aten = "null" if aten_ms is None else f"{aten_ms:.4f}"
            x_aten = lambda ms: ("null" if aten_ms is None
                                 else f"{ms / aten_ms:.3f}")
            fk, fw = row["flash_bwd_fused_kernel"], row["flash_bwd_fused"]
            print(f"[ab] {label} flash_fwd x SDPA fwd ({sdpa_ms:.4f} ms): "
                  f"other {row['flash_fwd']['other'] / sdpa_ms:.3f} this "
                  f"{row['flash_fwd']['this'] / sdpa_ms:.3f}; pair dq+dkv "
                  f"other {pair['other']:.4f} this {pair['this']:.4f} ms vs "
                  f"{aten_note} {aten} (x aten other {x_aten(pair['other'])}"
                  f" this {x_aten(pair['this'])}); fused kernel x aten other "
                  f"{x_aten(fk['other'])} this {x_aten(fk['this'])}, wrapper "
                  f"other {x_aten(fw['other'])} this {x_aten(fw['this'])}")
    finally:
        build.function = real_function
    print(smi)
    print(json.dumps({"kernels_ab": rows, "device": name, "smi": smi}))
    return 0


def main() -> int:
    if sys.argv[1:] == [LLAMA_PHASE]:
        return llama_child()
    if sys.argv[1:] == [MULTIHOST_PHASE]:
        return multihost_child()
    if sys.argv[1:] == [TP_LLAMA_PHASE]:
        print(RESULT_TAG + json.dumps({"counts": tp_llama()}), flush=True)
        return 0
    if sys.argv[1:] == [GRID_PHASE]:
        return grid_alone()
    if sys.argv[1:] in ([SP_PHASE], [PP_PHASE], [EP_PHASE]):
        return two_process_alone()
    if sys.argv[1:] == [ELASTIC_PHASE]:
        return deterministic_child(overlap=False, elastic=True)
    if sys.argv[1:] == [ELASTIC_TP_PHASE]:
        return elastic_tp_alone()
    if sys.argv[1:] == [OVERLAP_PHASE]:
        return deterministic_child(overlap=True, elastic=False)
    if sys.argv[1:] == [DETERMINISTIC_PHASE]:
        return deterministic_child(overlap=True, elastic=True)
    if sys.argv[1:2] == [AB_PHASE] and len(sys.argv) == 3:
        return kernels_ab(sys.argv[2])
    if sys.argv[1:] == [ACCUM_PHASE]:
        # the [grad_accum] comparison alone (K=4 against K=1), e.g. on a
        # copy of the port with a fault planted in the accumulation
        phase_device()
        phase_remat(["none"])
        return 0
    # the gpt2 path runs the two-pass backward: the switch is read once, at
    # the port's import, so it must be gone before anything imports it
    os.environ.pop("FLASH_BWD", None)
    t_start = time.perf_counter()
    marks = [t_start]

    def lap(what: str) -> None:
        """Each phase's wall, for the room the limit leaves."""
        marks.append(time.perf_counter())
        print(f"[smoke] {what} wall {marks[-1] - marks[-2]:.1f} s")

    name, smi = phase_device()
    import torch  # noqa: F401  (device phase checked the card)
    phase_build()
    tensor_cores = phase_sass()
    lap("device, build, sass")
    rows = phase_kernels()
    lap("kernels")
    counts = {}
    counts["gpt2"], results = run_path("gpt2")
    phase_profile("gpt2", results, PATHS["gpt2"][0])
    del results                    # give the card back
    torch.cuda.empty_cache()
    lap("gpt2 path, profile")
    counts["ckpt"] = phase_ckpt()
    lap("ckpt")
    counts["draft"] = phase_draft()
    lap("draft")
    plain = phase_serve("gpt2", CKPT_DIR)
    lap("serve gpt2")
    counts["serve_spec"] = phase_serve_spec(plain)
    lap("serve gpt2 spec")
    phase_serve_shared(CKPT_DIR)
    lap("serve gpt2 shared")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    shutil.rmtree(DRAFT_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    for path in ("bert", "vit", "moe"):
        counts[path], results = run_path(path)
        if path == "vit":           # before the profile trains it further
            rt = results["round_timings"]
            steps = sum(r["train_steps"] for r in rt)
            plain_vit = dict(
                losses=results["all_workers_losses"][0],
                params={k: v.detach().cpu() for k, v
                        in results["model"].state_dict().items()},
                counts=counts[path], steps=steps,
                train_ms=sum(r["train_ms"] for r in rt),
                step_ms=sum(r["train_ms"] for r in rt) / steps,
                wall=results["smoke_wall_s"],
                peak=results["smoke_peak_bytes"])
        if path != "moe":
            phase_profile(path, results, PATHS[path][0])
        del results
        torch.cuda.empty_cache()
        if path == "vit":
            counts["stream_vit"] = phase_stream_vit(plain_vit)
            del plain_vit
            torch.cuda.empty_cache()
        lap(f"{path} path" + ("" if path == "moe" else ", profile")
            + (", stream vit" if path == "vit" else ""))
    phase_remat(REMAT_POLICIES)
    lap("remat, grad_accum")
    counts["cnn"], results = run_cnn()
    phase_profile("cnn", results, CNN_ARGV)
    lap("cnn, profile")
    rt = results["round_timings"]
    images_s = (sum(r["train_steps"] for r in rt) * PATH_BATCH
                / (sum(r["train_ms"] for r in rt) / 1e3))
    del results
    torch.cuda.empty_cache()
    phase_sanitize()
    lap("sanitize")
    phase_profile_dir()
    torch.cuda.empty_cache()
    lap("profile_dir")
    # the llama child runs beside the sync phase (each of them mostly
    # waits on the host, each on its own processes), which takes back the
    # child's wall; the timings of both are taken under the other's load
    llama = start_llama()
    counts["sync"], sync_rates = phase_sync(images_s)
    lap("sync (the llama child beside it)")
    counts["llama"] = phase_llama(llama)
    lap("llama child (path, profile, serve llama, tp llama) after sync")
    t_sim = time.perf_counter()
    counts["sim_cnn"] = phase_sim_cnn(images_s, sync_rates)
    phase_sim_parity()
    phase_sim_scenario()
    counts["sim_gpt2"] = phase_sim_gpt2()
    print(f"[sim] phases wall {time.perf_counter() - t_sim:.1f} s")
    torch.cuda.empty_cache()
    lap("sim")
    counts.update(phase_grid())
    counts["tp_llama"] = GRID_COUNTS["tp_llama"]
    lap("grid (one start of 2: module checks, sp gpt2, sp bert, pp gpt2, "
        "ep moe, unrolled gpt2; one of 4: tp gpt2, tp fsdp bert, fsdp cnn)")
    counts["elastic_tp_gpt2"] = phase_elastic()["tp"]["counts"]
    lap("elastic child (overlap, elastic cnn, elastic tp gpt2)")
    phase_memory()
    phase_mfu(smi)
    lap("memory, mfu")
    kernels = []
    for kname, (src, replaces, path, shape, _design) in KERNELS.items():
        kernels.append(dict(
            name=kname, route="cuda", source=f"{PKG}/{src}",
            replaces=f"{JAX_PKG}/{replaces}", launches=counts[path][kname],
            launches_by_path={p: c[kname] for p, c in counts.items()},
            path=path, tensor_cores=tensor_cores[kname],
            **rows[shape][kname],
            at_shapes={label: rows[label][kname]
                       for label in ROW_SHAPES}))
    left = _stop_leftovers()
    print(f"[smoke] processes left running at the end, now stopped: "
          f"{left or 'none'}")
    print(f"[smoke] total wall {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    _adopt_orphans()
    try:
        code = main()
    finally:
        for line in _stop_leftovers():
            print(f"chip_smoke: left running at the end, now stopped: "
                  f"{line}", file=sys.stderr)
    sys.exit(code)
