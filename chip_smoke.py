#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
   per source, sm_90a, all in parallel), with the build time;
3. kernel parity on the card against the plain PyTorch versions, at the
   main paths' shapes and at edge cases: the PER tree build and the
   segment tree bit for bit (P up to 2^20), the C51 projection to 1e-6
   and bit for bit against the CPU replay of its schedule, and the three
   with R = 4 and 16 replicas in one launch each (16384 leaves per tree)
   bit for bit against R one-tree plain calls, RMSNorm, flash attention
   and decode attention (RMSNORM_CASES, FLASH_CASES and DECODE_CASES: the
   serve and train paths' shapes, every arch's, and edge cases) to 2e-4
   in float32 and 2e-2 in bfloat16 (decode attention's absolute part
   scaled by its output's largest magnitude where that is below 1);
4. kernel times from CUDA events (median of up to 200 launches) beside
   the plain versions' times, a one-call PyTorch yardstick where one
   exists, and the bound the card's peak rates set; an empty kernel
   timed the same way gives the launch floor of the two latency-bound
   DQN kernels; the DQN kernels also at R = 4 and 16 replicas;
5. the DQN path: ConcurrentTrainer on examples/specs/dqn_nature84.json
   with the rainbow variant (84x84x4 pong frames, the Nature CNN, W=8,
   C=512, F=2, a 16384-slot replay): init_carry, 2 cycles and one eval,
   with each kernel's launches counted (the tree build's per cycle too),
   then the kernel launches and device busy time of a cycle (C cut to
   32) from a capture of CUDA activity alone (``launch_count``);
6. agreement with the port's CPU path (held against the JAX reference
   by tests/test_torch_cycle.py) on a small rainbow configuration;
7. determinism: two runs of one cycle (C cut to PROFILED_STEPS) from
   the full-size carry are bitwise equal;
8. the serve path: mistral-nemo-12b at full width in bfloat16 through
   the serve launcher's own functions (batch 8, a 1024-token fused
   prefill, 64 greedy tokens), with init, prefill, decode and memory
   figures and each kernel's launches counted; then a ring-cache run
   (window 16, prompt 32, 32 tokens) and one decode step under CUDA's
   sync check (the host never waits for the card between steps);
9. agreement of the serve path with its CPU path (held against the JAX
   reference by tests/test_torch_transformer.py) on reduced
   mistral-nemo-12b in float32: equal greedy tokens, logits within 1e-3;
10. the recurrent serve paths: zamba2-2.7b (Mamba2 + shared attention)
   and xlstm-125m (mLSTM + sLSTM) at full width and depth in bfloat16,
   as in phase 8 (batch 8, a 1024-token fused prefill, 64 greedy tokens),
   with a profile of a prefill and of 4 decode steps each;
11. agreement of each recurrent path with its CPU path (held against the
   JAX reference by tests/test_torch_recurrent.py) on the reduced arch in
   float32: equal greedy tokens, logits within 1e-3, and two runs on the
   card bitwise equal, caches included;
12. the sequential modes on catch: examples/specs/baseline_catch.json
   and synchronized_catch.json, prepopulate cut to RESUME_PREPOPULATE,
   through build_trainer (init, 2 cycles
   with s/cycle and env-steps/s, one eval, no custom kernel launched),
   two cycles from one carry bitwise equal, and a small configuration
   of each mode against the CPU path (integers exact, floats to 1e-4);
13. population: rainbow_fleet.json at its width (mode population, 4
   seeds, AdamW, rainbow on catch, W=8, F=2, replay 16384), C cut to
   RESUME_STEPS and prepopulate to RESUME_PREPOPULATE: pixels init and
   2 cycles,
   vector (the mlp net) init and 1 cycle; the P=1 point, one replica as
   mode concurrent (ConcurrentTrainer, seeds 1), init and 1 cycle in
   pixels and in vector mode; one pixels cycle at P=16; each with
   s/cycle, env-steps/s over all replicas and the replicas' losses, and
   the DQN kernels' launches counted (C/F descents and projections, at
   most 2 builds a cycle, at every P); all kernel launches of one cycle
   cut to PROFILED_STEPS at P=1 (concurrent) and P=4 (the profiler, CUDA
   activity only; P=4 at most 1.25x P=1), two runs of one cut P=4 cycle
   from one carry bitwise equal, and a small population against the CPU
   path;
14. Table 1 on the card: the 14 cells of launch/table1.py at 84x84x4
   (TABLE1_STEPS env steps a cell), each row and the paper's layout,
   with the reference's transaction invariants (synchronized inference
   = steps/W + 1, standard = steps + 1, updates = steps/F + 1), and what
   one update and one inference cost, on the host and on the device.
   Phases 12-14 run after the serve phases, and the card memory still
   allocated after them is printed;
15. resume on the card: rainbow_fleet.json for one replica (rainbow on
   catch, pixels), as written (P=4) and baseline_catch.json, cycles cut
   to RESUME_STEPS steps and prepopulate to RESUME_PREPOPULATE: 2 cycles
   checkpointed
   after each, step 2 deleted, step 1 restored through restore_latest
   and cycle 2 run again, bitwise equal to the uninterrupted cycle 2
   leaf for leaf, with both DQN kernels and the tree build launched in
   the resumed rainbow cycle; the same checkpoint restored on the CPU
   runs cycle 2 as the card does (integers exact, floats to 1e-4);
16. the launcher end to end: rl_train on rainbow_fleet.json with its 4
   seeds in processes of its own with --ckpt-dir and --metrics-jsonl for
   2 cycles, then --cycles 3 --resume (the resume line, 4 metrics rows
   per cycle, one per replica), then a changed
   spec refused with exit 2 and its field diff (in this process: the
   refusal comes before any init); beside the fleet's first call, one
   replica (mode concurrent, the launcher's single-carry branch) for 2
   cycles, one metrics row a cycle and a checkpoint; both first calls
   with --trace, each trace read with the port's report (one cycle span
   per cycle, the train span >= 90% covered by its children, env_steps
   = P x C x cycles, the card and its power limit in the header, the
   Chrome twin parsing), each trace's cycle steady p50 printed;
17. policy serving at full width: a checkpoint of dqn_nature84.json with
   rainbow (pong 84x84x4, a 16384-slot replay; one short cycle), its
   save and restore timed; SERVE_CLIENTS simulated clients x SERVE_TICKS
   ticks under greedy, egreedy and noisy, and the catch checkpoint of
   phase 16 at 256 clients (and through launch/serve_policy.py --smoke),
   with replica 2 of it served as policy_step acts on its parameters,
   with actions/s, p50 and p99 latency and microbatches per tick, every
   client answered on every tick, each tick split into the clients'
   and the server's parts, and one flush and one client step profiled
   (egreedy, noisy); served actions equal a direct
   policy_step on the same stacks and keys bitwise, and do not change
   when the same requests arrive in another bucket and company; the
   serve_policy call with --trace (one serve.flush span a tick, its
   serve.compute spans, serve.actions = clients x ticks);
18. sweeps: examples/specs/catch_lr_seeds_sweep.json as committed (2
   fleets of 3: lr {1e-3, 5e-4} x seeds {0, 1, 2}; catch 10x10, the
   small net, W=8, replay 16384 per replica, AdamW) in a copy with the
   rainbow preset, SWEEP_CYCLES cycles of RESUME_STEPS steps and an
   eval and checkpoint every cycle: the launcher with --sweep --trace 1
   in a process of its own, started before phase 15 and run beside
   phases 15-16, which check values (fleets fleet000-p3 and fleet001-p3, each
   run's result, metrics rows and trace; each fleet's s/cycle), then
   run_sweep here interrupted after fleet001's cycle 2, its newest
   checkpoint torn and resumed (fleet000 skipped, every run's
   result.json and final carry bitwise the launcher's, one descent and
   one projection launch per update for all 3 replicas, at most 2
   tree builds a cycle, the card's memory back within 4 MB), the
   launcher's --resume training nothing, a changed manifest refused
   naming its field, and load_policy on each run of a fleet equal to
   its slice of the fleet's final carry.
19. kernel gradients: flash attention (zamba2's 32 heads of 80, kv 32,
   and 32 heads of 128 over kv 8; with and without a window), RMSNorm
   (widths 2560, 5120, 768, 1536), the SSD scan (H 80, P = N = 64, a
   chunk of 31) and the sLSTM scan (H 4, Pd 192, cold and warm) at the
   shapes of phases 20-21, float32 and bfloat16, through their autograd
   Functions: the forward within 2e-4 / 2e-2 of the plain version with
   one launch, and, for one fixed random cotangent, every input gradient
   bitwise autograd of the plain version (the backward is that
   recompute), with no launch in it;
20. the LLM train launcher: ``python -m repro_torch.launch.train --arch
   xlstm-125m --no-reduced`` (full width and depth, bf16 compute,
   float32 parameters, batch 8, sequence 128, TRAIN_STEPS steps) in a
   process of its own, finite losses; then through its function
   xlstm-125m again and zamba2-2.7b at full width with its depth cut to
   AL_SUPERBLOCKS of 9 superblocks, with s/step, peak memory and each
   kernel's launches per step (those of the forward: the backward
   launches none), two runs of one step from one state bitwise equal;
   and the card against the CPU on both reduced archs in float32 for 2
   steps (losses to 1e-4; the first step's AdamW moments, its gradients,
   to 1e-3 of each leaf's largest; parameters to 1e-3 of each leaf's
   largest, or for at most 1% of the elements within the 2 lr of the
   AdamW steps that rounding turned);
21. the actor-learner on zamba2-2.7b at full width, cut to
   AL_SUPERBLOCKS superblocks, bf16 compute, float32 parameters,
   ALConfig's defaults: the fused ``make_actor_learner`` (init, 3 cycles
   with s/cycle, generated tokens/s, reward, loss, peak memory, each
   kernel's launches per cycle against what the code implies, two runs
   of one cycle from one carry bitwise equal), then
   ``DisaggregatedActorLearner`` with prioritized and distributional
   advantages on two streams of the card (3 cycles, the same figures,
   the segment tree, the tree build and the C51 projection launched by
   its learner; its cycle beside an actor-only and a learner-only run),
   and both forms on reduced zamba2 in float32 for 2 cycles of one
   update each against the CPU path (tokens, cursor, size and step
   equal, the AdamW moments to 1e-3 of each leaf's largest, parameters
   as in phase 20);
22. MoE serving: qwen2-moe-a2.7b at full width and depth in bf16 (60
   routed experts padded to 64, 4 shared; batch 8, a 1024-token fused
   prefill, 64 greedy tokens) through the serve launcher's function, with
   init, prefill, decode and memory figures, each kernel's launches
   against the config's count, a profile of a prefill and of 4 decode
   steps, and one more step under CUDA's sync check; then reduced
   granite-moe-1b-a400m and qwen2-moe-a2.7b in float32 on the card and
   on the CPU (a router margin of 1e-5 asserted first: tokens equal,
   prefill logits within 1e-3, two card runs bitwise equal, caches
   included; fused and ring);
23. MoE training: granite-moe-1b-a400m at full width and depth through
   the train launcher's function (bf16 compute, float32 parameters,
   batch 8, sequence 128, MOE_TRAIN_STEPS steps): finite losses with an
   auxiliary loss above 0, launches per step, peak memory, two runs of a
   step bitwise equal; then its reduced first step on the card against
   the CPU as in phase 20;
24. cross-attention serving: whisper-tiny at full size (a 1500-frame
   encoder, prompt 64, 64 tokens) and llama-3.2-vision-11b at full width
   with its 1601-patch memory, cut to VLM_SUPERBLOCKS of 8 superblocks
   (batch 8, prompt 1024, 64 tokens), with each kernel's launches
   (decode attention over the cross caches included) and the profiles of
   phase 22 (whisper's decode step also under the sync check); reduced whisper
   and llama (its gates set nonzero) against the CPU as in phase 22;
25. whisper-tiny training at full size (each step's memory drawn as the
   launcher draws it), as in phase 23, bitwise on a rerun;
26. parity at the paths' cases: phases 8-25 record, at the ``kernels/ops``
   entry points the models call, the case (shape, dtypes, options) of
   every call to RMSNorm, flash attention and decode attention on the
   card, and check that the calls recorded are the launches counted;
   each case phase 3 did not hold is held here against the plain
   version on fresh random inputs, and printed with its error;
27. the cost counter (roofline/cost.py) on mistral-nemo-12b's prefill at
   phase 8's shapes and on one qwen2-moe-a2.7b decode step at phase
   22's (full width, bf16, random weights from a seeded generator): the
   same flops, bytes and per-op counts on the card's tensors as on fake
   cuda tensors of the same shapes, exactly; each with its roofline
   terms, its time (median of 3), its useful flops (model_flops less
   the embedding and position lookups, no more than counted) and their
   share of the bf16 peak beside the card's name and power limit;
28. expert parallelism on one card: a 1-rank NCCL group (a FileStore in
   a temporary directory) and a (data 1, model 1) mesh; qwen2-moe-a2.7b
   at full width serves phase 22's prompts (EP_GEN tokens) with
   moe_impl="expert_parallel", its tokens and prefill logits bitwise
   the scatter run's, with one all-reduce per MoE layer per step; a
   granite-moe-1b-a400m gradient bitwise the scatter path's;
   replica_mesh is None;
29. the dry run (launch/dryrun.py), checked after phase 28: the grid of mistral-nemo-12b and qwen2-moe-a2.7b x
   train_4k, prefill_32k, decode_32k x 16x16 and 2x16x16 with expert
   parallelism (one process per arch on one host core, fake cuda
   tensors on a fake process group, started before phase 8: 12
   records, none failed, each with its per-device flops, bytes,
   collective bytes and dominant term), and --arch dqn on the card
   through the same entry point in this process (8 records, the PER
   and C51 presets counting their kernels). mistral-nemo-12b's prefill
   and decode records on both meshes are held to the reference's own
   dry-run figures (``DRYRUN_REFERENCE``, from ``python -m
   repro.launch.dryrun`` on a CPU) as tests/test_torch_dryrun.py holds
   them: the ratio within DRYRUN_RATIO, and within 3% once the two
   differences it names are counted out;
30. the DQN path in bfloat16: phase 5's run (dqn_nature84.json, rainbow,
   84x84x4 pong, the Nature CNN, W=8, replay 16384) with compute_dtype
   bfloat16, C cut to BF16_STEPS, prepopulate to BF16_PREPOPULATE and
   pong's episodes to BF16_EPISODE_STEPS steps: 2
   cycles and one eval with each kernel's launches counted as in phase 5
   (the DQN kernels still see float32), s/cycle beside a float32 cycle
   of the same C from the same carry and beside phase 5's cycles; the
   bf16 run of phase 6's small
   configuration on the card against the same on the CPU (integer state
   equal, float leaves within the rounding bound of
   tests/test_torch_dqn_bf16.py); two bf16 cycles (C=BF16_RERUN_STEPS)
   from one carry bitwise equal.
   Each phase prints its wall time, and the run its total; phases 15-18
   keep their checkpoints in a temporary directory they remove.

Phase 3 also holds the SSD scan and the sLSTM scan against their plain
versions (2e-4 in float32, 2e-2 in bfloat16: y or hs and the final
state) at the recurrent paths' shapes and at edge cases (several chunks,
18 chunks over a cluster of fewer ranks, a chunk of 64 with a partial
head group, S below the chunk, S no multiple of 16, warm states, several
batch tiles, the SSD scan's cluster and scalar bodies, the sLSTM's
cluster body and its stream body at Pd 512), prints both scans' plans at
their paths' shapes and checks that two launches of each there give the
same bits; flash attention at zamba2's head dim 80 (the wgmma body,
with and without a window) and decode attention with one query head per
KV head; decode attention at cache lengths on and around the boundaries
of the split the kernel picks (against the plain version and the
emulation of its split), the cross caches' included; and that two
launches of each attention kernel give the same bits at the serve
paths' shapes. Phase 4 times them, RMSNorm at the prefill's and the
decode step's rows, prints each attention kernel's and RMSNorm's time as a
ratio to SDPA's or F.rms_norm's, and times the sLSTM cluster body's
serial floor (its DSMEM exchange and cluster barrier alone, over the
path's 1024 steps).

Every kernel's launches in the JSON record are those of its own path's
run (phase 5 for the DQN kernels and the tree build, the full-cache run
of phase 8 for RMSNorm and the two attention kernels, phase 10's zamba2
run for the SSD scan and its xlstm run for the sLSTM scan), with all
counts set to 0
just before that run; ``launches_by_path`` adds each kernel's launches
per step or cycle on phases 20-21's paths, per step on phases 23 and
25's, per run on phases 22 and 24's and over phase 30's bf16 run. The line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero before
printing it. Without a CUDA device, or without the repository's src/
beside it, the script fails.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

SPEC = ROOT / "examples" / "specs" / "dqn_nature84.json"
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores, bf16 dense on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
# the serve path's run: mistral-nemo-12b at full width, bf16
SERVE_ARCH = "mistral-nemo-12b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
RING_PROMPT, RING_GEN, RING_WINDOW = 32, 32, 16
# the recurrent serve paths, at the same batch and lengths
RECURRENT_ARCHS = ("zamba2-2.7b", "xlstm-125m")
# zamba2-2.7b's SSD scan (B, S, H, P, N, chunk) and xlstm-125m's sLSTM
# scan (B, S, H, Pd) at those lengths
SSM_PATH = (SERVE_BATCH, SERVE_PROMPT, 80, 64, 64, 128)
SLSTM_PATH = (SERVE_BATCH, SERVE_PROMPT, 4, 192)
LLM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
TIMED_RUNS = 200
# the PER tree build's leaf counts and the descent's (P, n) in parity
TREE_BUILD_CASES = (1, 2, 8, 2048, 16384, 1 << 20)
# a population's replica counts: the DQN kernels' parity and times with R
# trees (or R minibatches) in one launch, and the fleet's runs against P
REPLICA_CASES = (4, 16)
SEGMENT_TREE_CASES = ((16384, 32), (16384, 4096), (1, 3), (8, 5), (2048, 64),
                      (1 << 20, 4096))
# the kernels whose rows carry the launch floor (floor_ms)
LATENCY_BOUND = ("segment_tree", "categorical_projection")
# C of the profiled cycle: 4 synchronized rounds and 16 updates at W=8, F=2
PROFILED_STEPS = 32
# the sequential modes' committed specs, and the env steps of each of
# Table 1's 14 cells
SEQUENTIAL_SPECS = ("baseline_catch", "synchronized_catch")
TABLE1_STEPS = 1000
# the checkpoint phases' cut (C and prepopulate), and the serving load:
# simulated clients on the pong checkpoint and ticks per policy
RESUME_STEPS, RESUME_PREPOPULATE = 32, 256
# the sweep phase's manifest, taken as committed and cut in a copy
SWEEP_MANIFEST = ROOT / "examples" / "specs" / "catch_lr_seeds_sweep.json"
SWEEP_CYCLES = 3
SERVE_CLIENTS, SERVE_TICKS, BREAKDOWN_TICKS = 1024, 50, 10
# phases 19-21: the train launcher on xlstm-125m at full width and depth
# (batch, sequence, steps), zamba2-2.7b cut to AL_SUPERBLOCKS of its 9
# superblocks for CUT_TRAIN_STEPS steps and for the actor-learner (AL_*:
# ALConfig's defaults, W streams of a prompt and generated tokens), its
# cycles
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "xlstm-125m", 8, 128, 4
AL_ARCH, AL_SUPERBLOCKS, CUT_TRAIN_STEPS, AL_CYCLES = "zamba2-2.7b", 3, 2, 3
AL_STREAMS, AL_SEQ = 8, 8 + 24
# phases 22-25: the MoE serve path (qwen2-moe-a2.7b at full size) and
# train path (granite-moe-1b-a400m at full size, steps), whisper-tiny at
# full size (its decoder's prompt and tokens inside its 448-token
# context; train steps) and llama-3.2-vision-11b at full width, cut to
# VLM_SUPERBLOCKS of its 8 superblocks (every superblock is the same)
MOE_SERVE_ARCH = "qwen2-moe-a2.7b"
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS = "granite-moe-1b-a400m", 3
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_GEN = "whisper-tiny", 64, 64
CROSS_TRAIN_STEPS = 3
VLM_ARCH, VLM_SUPERBLOCKS = "llama-3.2-vision-11b", 2
# whisper-tiny's encoder positions (its 3000 mel frames halved)
WHISPER_FRAMES = 1500
# RMSNorm's (rows, D) in parity: the serve paths' widths (mistral and
# zamba2's Mamba2 inner 5120, zamba2 2560, xlstm's mLSTM inner 1536 and
# 768, llama-3.2-vision 4096, qwen2-moe 2048, granite-moe 1024, whisper
# 384) at prefill and decode rows; whisper's encoder and decoder prompt;
# the train paths' rows at granite-moe's and whisper's widths; a row of
# 12 vectors, and a width that is no multiple of the vector
RMSNORM_CASES = tuple((rows, D) for D in (5120, 2560, 1536, 768, 4096,
                                          2048, 1024, 384)
                      for rows in (SERVE_BATCH * SERVE_PROMPT, SERVE_BATCH)
                      ) + ((SERVE_BATCH * WHISPER_FRAMES, 384),
                           (SERVE_BATCH * WHISPER_PROMPT, 384),
                           (TRAIN_BATCH * TRAIN_SEQ, 1024),
                           (TRAIN_BATCH * TRAIN_SEQ, 384),
                           (TRAIN_BATCH * WHISPER_FRAMES, 384),
                           (7, 96), (5, 4097))
# flash attention's (B, S, H, Hkv, D) in parity, each also with a window
# of 64 below the serve prompt's length: edge cases (S 300, GQA 12, MQA
# at D 80, D 64 and 96); the serve paths' prefills (mistral-nemo and
# llama-3.2-vision, zamba2, qwen2-moe's G 1 at D 128, whisper's decoder)
# and the train paths' (granite-moe, whisper)
FLASH_CASES = ((2, 300, 32, 8, 128), (1, 256, 24, 2, 128), (1, 128, 4, 1, 80),
               (2, 200, 8, 2, 64), (2, 300, 32, 32, 80), (1, 192, 8, 2, 96),
               (SERVE_BATCH, SERVE_PROMPT, 32, 8, 128),
               (SERVE_BATCH, SERVE_PROMPT, 32, 32, 80),
               (SERVE_BATCH, SERVE_PROMPT, 16, 16, 128),
               (SERVE_BATCH, WHISPER_PROMPT, 6, 6, 64),
               (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 64),
               (TRAIN_BATCH, TRAIN_SEQ, 6, 6, 64))
# decode attention's (B, H, Hkv, L, D) in parity, each at the cache
# lengths listed: mistral-nemo and llama-3.2-vision's self caches, a
# wrapped 16-slot ring, GQA 12, zamba2's attention, qwen2-moe's (G 1 at D
# 128), whisper's decoder, and the cross caches (whisper's 1500 frames at
# D 64 and G 1; the VLM's 1601 patches, odd L, G 4)
SERVE_CACHE = SERVE_PROMPT + SERVE_GEN
DECODE_CASES = (((SERVE_BATCH, 32, 8, SERVE_CACHE, 128),
                 (1, 517, SERVE_CACHE)),
                ((SERVE_BATCH, 32, 8, RING_WINDOW, 128), (40,)),
                ((2, 24, 2, SERVE_CACHE, 128), (517,)),
                ((SERVE_BATCH, 32, 32, SERVE_CACHE, 80), (SERVE_CACHE,)),
                ((SERVE_BATCH, 16, 16, SERVE_CACHE, 128),
                 (1, 517, SERVE_CACHE)),
                ((SERVE_BATCH, 6, 6, WHISPER_PROMPT + WHISPER_GEN, 64),
                 (1, WHISPER_PROMPT + WHISPER_GEN)),
                ((SERVE_BATCH, 6, 6, WHISPER_FRAMES, 64), (WHISPER_FRAMES,)),
                ((SERVE_BATCH, 32, 8, 1601, 128), (1601,)))
# the cross caches' (B, H, Hkv, D, L), also at the decode split's
# boundaries
CROSS_CACHES = ((SERVE_BATCH, 6, 6, 64, WHISPER_FRAMES),
                (SERVE_BATCH, 32, 8, 128, 1601))
# the three LLM kernels: the cases (``_kernel_case``) phase 3 held, and
# those the paths of phases 8-25 launched, with their calls counted
LLM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
PARITY_DONE: set = set()
PATH_CASES: set = set()
PATH_CALLS = dict.fromkeys(LLM_KERNELS, 0)
# phase 19's cases whose forward and backward are also timed
GRAD_TIMED = ((AL_STREAMS, AL_SEQ - 1, 32, 32, 80, None),
              (AL_STREAMS * (AL_SEQ - 1), 2560),
              (AL_STREAMS, AL_SEQ - 1, 80, 64, 64, "chunk 128"),
              (TRAIN_BATCH, TRAIN_SEQ, 4, 192, "cold"))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of one call, from a CUDA event pair per call.

    The host takes longer to launch these small calls than the card takes
    to run them. So each block of calls is queued while a sleep kernel
    holds the stream, and a block counts only if all of it was queued
    before the sleep ended (the event after the sleep had not completed
    when the last call was queued): the events then time the device, not
    the launches. A block that missed (sleep too short, or the driver's
    launch queue full) is thrown away and the next one is half as long."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_s = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    per_block = max(1, min(runs, int(0.05 / host_s)))
    samples, misses = [], 0
    while len(samples) < runs:
        torch.cuda._sleep(int((4.0 * per_block * host_s + 0.005) * 2e9))
        held = torch.cuda.Event()
        held.record()
        pairs = []
        for _ in range(per_block):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        queued_in_time = not held.query()
        torch.cuda.synchronize()
        if queued_in_time:
            samples += [a.elapsed_time(b) for a, b in pairs]
            continue
        misses += 1
        check(misses < 20, "could not queue a timed block behind the sleep")
        per_block = max(1, per_block // 2)
    return statistics.median(samples)


def time_graph_ms(fn, runs: int = 5) -> float:
    """Device time of a call that launches more kernels than CUDA's
    launch queue holds (the scans' plain versions loop over 1024 steps in
    Python), so that it cannot be queued behind a sleep: captured once
    into a CUDA graph, whose replay is one launch, and timed as
    ``time_ms`` times that."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, runs=runs)


def tree_case(P: int, n: int, gen: torch.Generator, dev):
    """Random float masses over the first 3/4 of the leaves, a zero tail,
    and targets spread over [0, 1.05 * total) so some exceed the total."""
    from repro_torch.kernels.segment_tree import tree_build
    leaves = torch.rand(P, generator=gen, dtype=torch.float64).float()
    leaves[(3 * P) // 4:] = 0.0
    tree = tree_build(leaves.to(dev))
    total = float(tree[1])
    targets = (torch.rand(n, generator=gen, dtype=torch.float64)
               * 1.05 * total).float().to(dev)
    targets[-1] = total                    # exactly the total
    return tree, targets


def projection_case(B: int, K: int, gen: torch.Generator, dev):
    logits = 3.0 * torch.randn(B, K, generator=gen)
    probs = torch.softmax(logits, dim=-1)
    probs[0] = 0.0
    probs[0, K // 2] = 1.0                  # one peaked row
    rewards = 15.0 * torch.randn(B, generator=gen)   # many outside the support
    dones = torch.rand(B, generator=gen) < 0.3
    dones[:2] = True
    return probs.to(dev), rewards.to(dev), dones.to(dev)


def phase_parity(dev):
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    gen = torch.Generator().manual_seed(0)
    errs = {"tree_build": 0.0}
    for P in TREE_BUILD_CASES:
        leaves = torch.rand(P, generator=gen, dtype=torch.float64).float()
        leaves[(3 * P) // 4:] = 0.0
        got = st.tree_build(leaves.to(dev))
        want = st.tree_build_plain(leaves.to(dev))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"tree_build differs from the plain version at P={P}: max abs "
              f"err {err}")
        errs["tree_build"] = max(errs["tree_build"], err)
    say(f"parity tree_build: bitwise equal at P in {TREE_BUILD_CASES}")
    for P, n in SEGMENT_TREE_CASES:
        tree, targets = tree_case(P, n, gen, dev)
        got = st.segment_tree_sample(tree, targets)
        want = st.segment_tree_sample_plain(tree, targets)
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max())
        check(torch.equal(got, want) and err == 0.0,
              f"segment_tree differs from the plain version at P={P} n={n}: "
              f"max abs err {err}")
        if (P, n) == (16384, 32):
            errs["segment_tree"] = err
            # zero-mass tail leaves are never reached below the total
            inside = targets < tree[1]
            check(bool((got[inside] < (3 * P) // 4).all()),
                  "segment_tree sampled a zero-mass leaf")
    say(f"parity segment_tree: bitwise equal at (P, n) in "
        f"{SEGMENT_TREE_CASES}")
    gamma_n = 0.9 ** 3
    cases = [(32, 51, -10.0, 10.0, gamma_n), (7, 1, -1.0, -1.0, 0.99),
             (7, 8, 2.0, 2.0, 0.9), (64, 512, -10.0, 10.0, gamma_n),
             (13, 51, -10.0, 10.0, 1.0)]
    for B, K, v_min, v_max, g in cases:
        probs, rewards, dones = projection_case(B, K, gen, dev)
        kw = dict(v_min=v_min, v_max=v_max, gamma_n=g)
        got = cp.categorical_projection(probs, rewards, dones, **kw)
        want = cp.categorical_projection_plain(probs, rewards,
                                               dones.float(), **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-6, rtol=1e-6),
              f"categorical_projection differs from the plain version at "
              f"B={B} K={K} v=[{v_min}, {v_max}]: max abs err {err}")
        check(torch.allclose(got.sum(-1), probs.sum(-1), atol=1e-5),
              "categorical_projection lost mass")
        replay = cp.projection_hat(probs.cpu(), rewards.cpu(), dones.cpu(),
                                   **kw)
        check(torch.equal(got.cpu(), replay),
              f"categorical_projection differs from projection_hat at "
              f"B={B} K={K} v=[{v_min}, {v_max}] gamma_n={g}")
        if (B, K) == (32, 51):
            errs["categorical_projection"] = err
    say(f"parity categorical_projection: within 1e-6 of the plain version "
        f"and bitwise equal to projection_hat on {len(cases)} cases "
        f"(K=1, v_min=v_max, rewards outside the support, dones); max abs "
        f"err at B=32 K=51: {errs['categorical_projection']:.3e}")
    _replica_parity(gen, dev)
    return errs


def replica_case(R: int, gen: torch.Generator, dev, P: int = 16384,
                 n: int = 32, B: int = 32, K: int = 51):
    """A population's inputs to the DQN kernels: R replicas' leaf masses
    (each its own zero tail), their targets over [0, 1.05 total) with
    the last at each total, and R minibatches of projection rows."""
    from repro_torch.kernels.segment_tree import tree_build
    leaves = torch.rand(R, P, generator=gen, dtype=torch.float64).float()
    for r in range(R):
        leaves[r, P - (r * P) // (2 * R):] = 0.0
    leaves = leaves.to(dev)
    trees = tree_build(leaves)
    targets = (torch.rand(R, n, generator=gen, dtype=torch.float64)
               * 1.05).float().to(dev) * trees[:, 1:2]
    targets[:, -1] = trees[:, 1]
    rows = [projection_case(B, K, gen, dev) for _ in range(R)]
    probs, rewards, dones = (torch.stack(x) for x in zip(*rows))
    return leaves, trees, targets, probs, rewards, dones


def _replica_parity(gen: torch.Generator, dev) -> None:
    """R replicas in one launch each (N = 16384 leaves, 32 targets, 32
    rows of 51 atoms per replica): the tree build and the descent bit for
    bit against R one-tree plain calls, the projection of R B rows bit
    for bit against projection_hat and within 1e-6 of R plain calls."""
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    for R in REPLICA_CASES:
        leaves, _, _, probs, rewards, dones = replica_case(R, gen, dev)
        before = read_launches()
        trees = st.tree_build(leaves)
        targets = (torch.rand(R, 32, generator=gen, dtype=torch.float64)
                   * 1.05).float().to(dev) * trees[:, 1:2]
        targets[:, -1] = trees[:, 1]
        got = st.segment_tree_sample(trees, targets)
        proj = cp.categorical_projection(probs, rewards, dones, **kw)
        torch.cuda.synchronize()
        after = read_launches()
        check((after["tree_build"] - before["tree_build"],
               after["segment_tree"] - before["segment_tree"],
               after["categorical_projection"]
               - before["categorical_projection"])
              == (len(st.tree_build_plan(16384)), 1, 1),
              f"R={R}: the replica calls launched {after} after {before}")
        for r in range(R):
            check(torch.equal(trees[r], st.tree_build_plain(leaves[r])),
                  f"tree_build at R={R} differs from the plain version on "
                  f"tree {r}")
            check(torch.equal(got[r], st.segment_tree_sample_plain(
                trees[r], targets[r])),
                  f"segment_tree at R={R} differs from the plain version on "
                  f"tree {r}")
            want = cp.categorical_projection_plain(
                probs[r], rewards[r], dones[r].float(), **kw)
            check(torch.allclose(proj[r], want, atol=1e-6, rtol=1e-6),
                  f"categorical_projection at R={R} differs from the plain "
                  f"version on replica {r}")
        check(torch.equal(proj.cpu(), cp.projection_hat(
            probs.cpu(), rewards.cpu(), dones.cpu(), **kw)),
              f"categorical_projection at R={R} differs from projection_hat")
    say(f"parity with R replicas in one launch each, R in {REPLICA_CASES} "
        "(16384 leaves, 32 targets, 32 x 51 rows per replica): tree_build "
        "and segment_tree bitwise equal to R one-tree plain calls, "
        "categorical_projection bitwise equal to projection_hat and within "
        "1e-6 of R plain calls")


def phase_times(dev):
    """Kernel, plain and yardstick times at the main path's shapes, and
    the launch floor: an empty kernel timed the same way."""
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    gen = torch.Generator().manual_seed(1)
    out = {}
    floor_ms = time_ms(lambda: st.empty_launch(dev))
    say(f"launch floor (an empty kernel through time_ms): {floor_ms:.4f} ms")
    P, n = 16384, 32
    tree, targets = tree_case(P, n, gen, dev)
    leaves = tree[P:].clone()
    depth = P.bit_length() - 1
    k_ms = time_ms(lambda: st.segment_tree_sample(tree, targets))
    p_ms = time_ms(lambda: st.segment_tree_sample_plain(tree, targets))
    l_ms = time_ms(lambda: torch.searchsorted(
        torch.cumsum(leaves, 0), targets, right=True).clamp_(max=P - 1))
    # the descent touches depth nodes per target, reads the targets once
    # and writes one index each; 3 f32 operations per level
    nbytes = n * depth * 4 + n * 4 + n * 4
    nops = n * depth * 3
    out["segment_tree"] = (k_ms, p_ms, l_ms, nbytes, nops)
    k_ms = time_ms(lambda: st.tree_build(leaves))
    p_ms = time_ms(lambda: st.tree_build_plain(leaves))
    # P leaves read once, the (2P,) tree written once, P - 1 adds
    out["tree_build"] = (k_ms, p_ms, None, 3 * P * 4, P - 1)
    B, K = 32, 51
    probs, rewards, dones = projection_case(B, K, gen, dev)
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    d32 = dones.float()
    k_ms = time_ms(lambda: cp.categorical_projection(probs, rewards, d32, **kw))
    p_ms = time_ms(lambda: cp.categorical_projection_plain(
        probs, rewards, d32, **kw))
    # probs, rewards, dones read once, (B, K) written once. The function
    # needs, per row, g = gamma_n * (1 - d) (2 ops) and, per (row, source
    # atom j), b_j (mul, add, max, min, sub, div), its floor and ceiling
    # (2), the two weights (2), and two products and two adds (4): 14.
    # The kernel's gather loop does K times more (a hat weight per (i, j)),
    # but that is its choice, not the function's work.
    nbytes = (2 * B * K + 2 * B) * 4
    nops = B * 2 + B * K * 14
    out["categorical_projection"] = (k_ms, p_ms, None, nbytes, nops)
    for name, (k_ms, p_ms, l_ms, nbytes, nops) in out.items():
        floor = (f", {k_ms / floor_ms:.2f}x the launch floor"
                 if name in LATENCY_BOUND else "")
        say(f"time {name}: kernel {k_ms:.4f} ms{floor}, plain {p_ms:.4f} ms, "
            f"library {'n/a' if l_ms is None else f'{l_ms:.4f} ms'}, "
            f"{nbytes} bytes, {nops} f32 ops")
    for R in REPLICA_CASES:
        leaves, trees, targets, probs, rewards, dones = replica_case(R, gen,
                                                                     dev)
        d32 = dones.float()
        rows = {
            "segment_tree": (
                time_ms(lambda: st.segment_tree_sample(trees, targets)),
                time_ms(lambda: st.segment_tree_sample_plain(trees, targets))),
            "tree_build": (time_ms(lambda: st.tree_build(leaves)),
                           time_ms(lambda: st.tree_build_plain(leaves))),
            "categorical_projection": (
                time_ms(lambda: cp.categorical_projection(probs, rewards,
                                                          d32, **kw)),
                time_ms(lambda: cp.categorical_projection_plain(
                    probs.reshape(-1, K), rewards.reshape(-1),
                    d32.reshape(-1), **kw)))}
        for name, (k_ms, p_ms) in rows.items():
            say(f"time {name} at R={R} replicas (one launch for all; P=1 "
                f"above {out[name][0]:.4f} ms): kernel {k_ms:.4f} ms, "
                f"{k_ms / floor_ms:.2f}x the launch floor, plain "
                f"{p_ms:.4f} ms")
    return out, floor_ms


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_clone(v) for v in obj])
    if isinstance(obj, tuple):
        return tuple(_clone(v) for v in obj)
    return obj


def _paths(obj, prefix=""):
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _paths(v, f"{prefix}.{k}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k, v in zip(obj._fields, obj):
            yield from _paths(v, f"{prefix}.{k}")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _paths(v, f"{prefix}[{i}]")


# phase 5's C and its cycles' seconds, which phase 30 prints beside its own
C_MAIN: list = []


def phase_main_path(dev):
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.api.trainers import ConcurrentTrainer
    from repro_torch.configs.dqn_nature import get_variant
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    spec = ExperimentSpec.from_json(SPEC.read_text())
    spec = dataclasses.replace(spec, variant=get_variant("rainbow"),
                               mode="concurrent")
    trainer = ConcurrentTrainer(spec, device="cuda")
    C = spec.schedule.cycle_steps
    per_cycle = C // spec.algo.train_period
    builds = len(st.tree_build_plan(
        st.next_pow2(spec.algo.replay_capacity)))
    reset_launches()
    t0 = time.perf_counter()
    carry = trainer.init_carry()
    torch.cuda.synchronize()
    say(f"main init_carry: {time.perf_counter() - t0:.2f} s (prepopulate "
        f"{spec.schedule.prepopulate}, replay {spec.algo.replay_capacity})")
    first = None
    C_MAIN[:] = [C]
    for i in range(2):
        t0 = time.perf_counter()
        carry, m = trainer.cycle(carry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        C_MAIN.append(dt)
        loss = float(m["loss"][0])
        say(f"main cycle {i + 1}: {dt:.3f} s, {C / dt:.1f} env-steps/s, "
            f"loss {loss:.6f}")
        check(torch.isfinite(m["loss"]).all().item(), "non-finite loss")
        for name, fn in (("segment_tree", st.segment_tree_sample),
                         ("categorical_projection",
                          cp.categorical_projection)):
            check(fn.launches == per_cycle * (i + 1),
                  f"{name} launched {fn.launches} times after {i + 1} "
                  f"cycle(s), expected {per_cycle * (i + 1)}")
        check(st.tree_build.launches == builds * (i + 1) and builds <= 2,
              f"tree_build launched {st.tree_build.launches} times after "
              f"{i + 1} cycle(s), expected {builds} (at most 2) per cycle")
        if first is None:
            first = _clone(carry)
    t0 = time.perf_counter()
    evals = trainer.eval(carry, trainer.eval_key(1))
    torch.cuda.synchronize()
    say(f"main eval: {time.perf_counter() - t0:.2f} s, return "
        f"{float(evals[0]):+.3f} over {spec.schedule.eval_episodes} streams")
    launches = read_launches()
    check(all(launches[k] == 0 for k in launches
              if k not in ("segment_tree", "categorical_projection",
                           "tree_build")),
          f"the DQN path launched a serve kernel: {launches}")
    check(torch.isfinite(evals).all().item(), "non-finite eval return")
    for path, t in _paths(carry, "carry"):
        check(t.device.type == "cuda", f"{path} is on {t.device}")
    check(tuple(carry.replay["obs"].shape) == (16384, 84, 84, 4)
          and carry.replay["obs"].dtype == torch.uint8,
          "replay frames are not (16384, 84, 84, 4) uint8")
    W, n_step = spec.envs, spec.variant.n_step
    want_size = spec.schedule.prepopulate + 2 * (C // W - (n_step - 1)) * W
    check(int(carry.replay["size"]) == want_size,
          f"replay size {int(carry.replay['size'])} after prepopulate and "
          f"2 cycles, expected {want_size}")
    say(f"main launches over init_carry + 2 cycles + eval: {launches}")
    return trainer, first, launches


def phase_profile(spec, carry):
    """What a cycle costs: the kernel launches and device busy time of a
    real ``trainer.cycle`` at full width, with C cut to PROFILED_STEPS
    (the full cycle repeats the same rounds and updates, in the same 1:4
    ratio), from a capture of CUDA activity alone (``launch_count``)."""
    from repro_torch.api.trainers import ConcurrentTrainer
    short = dataclasses.replace(spec, schedule=dataclasses.replace(
        spec.schedule, cycle_steps=PROFILED_STEPS))
    trainer = ConcurrentTrainer(short, device="cuda")
    carry = _clone(carry)
    launch_count(f"one cycle with C={PROFILED_STEPS} "
                 f"({PROFILED_STEPS // spec.envs} rounds, "
                 f"{PROFILED_STEPS // spec.algo.train_period} updates)",
                 lambda: trainer.cycle(carry))


def phase_against_cpu():
    """A small rainbow run on the card against the same run on the CPU."""
    from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
    from repro_torch.configs.dqn_nature import get_variant
    spec = ExperimentSpec(
        env="pong", mode="concurrent", variant=get_variant("rainbow"),
        envs=4, frame_size=10, net="tiny",
        schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64),
        algo=AlgoSpec(minibatch_size=8, replay_capacity=256,
                      optimizer="rmsprop"))
    _card_vs_cpu(spec, "pong 10x10, tiny net, rainbow")


def _bitwise(a, b, label: str) -> int:
    """Check two carries equal leaf for leaf, dtypes included; returns
    the number of tensors."""
    pb = dict(_paths(b))
    n = 0
    for path, t in _paths(a):
        check(t.dtype == pb[path].dtype and torch.equal(t, pb[path]),
              f"{label}carry{path} differs")
        n += 1
    return n


def phase_determinism(trainer, carry, label: str = ""):
    a, _ = trainer.cycle(_clone(carry))
    b, _ = trainer.cycle(_clone(carry))
    torch.cuda.synchronize()
    n = _bitwise(a, b, f"{label}between runs: ")
    say(f"{label}determinism: two cycles from one carry bitwise equal "
        f"({n} tensors)")


def _spec_file(name: str):
    from repro_torch.api.spec import ExperimentSpec
    return ExperimentSpec.from_json(
        (ROOT / "examples" / "specs" / f"{name}.json").read_text())


def _card_vs_cpu(spec, label: str) -> None:
    """One cycle of ``spec`` on the CPU and on the card from the port's
    own init: integer state equal, floats within 1e-4."""
    from repro_torch.api.trainers import build_trainer
    runs = {}
    for device in ("cpu", "cuda"):
        trainer = build_trainer(spec, device=device)
        runs[device], _ = trainer.cycle(trainer.init_carry())
    worst = _agree(runs["cpu"], runs["cuda"], label)
    say(f"agreement with the CPU path ({label}, 1 cycle): integer state "
        f"equal, floats within 1e-4 (max {worst:.2e})")


def _agree(on_cpu, on_card, label: str) -> float:
    """Check a carry from the card against one from the CPU: integer
    state equal, floats within 1e-4. Returns the largest float error."""
    card = dict(_paths(on_card, "carry"))
    worst = 0.0
    for path, a in _paths(on_cpu, "carry"):
        b = card[path].cpu()
        if a.dtype.is_floating_point:
            err = float((a - b).abs().max()) if a.numel() else 0.0
            worst = max(worst, err)
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{label} {path}: card and CPU differ by {err}")
        else:
            check(torch.equal(a, b), f"{label} {path}: card and CPU differ")
    return worst


def phase_sequential(dev):
    """The sequential modes on catch: examples/specs/baseline_catch.json
    and synchronized_catch.json (prepopulate cut) through build_trainer
    on the card (init, 2 cycles, one eval); two cycles from one carry
    bitwise equal; a small configuration of each mode against the CPU
    path."""
    from repro_torch.api.spec import AlgoSpec, ScheduleSpec
    from repro_torch.api.trainers import build_trainer
    from repro_torch.configs.dqn_nature import get_variant
    for name in SEQUENTIAL_SPECS:
        spec = _spec_file(name)
        # the replay's prepopulation cut (the sequential init fills it one
        # synchronized round after another)
        spec = dataclasses.replace(spec, schedule=dataclasses.replace(
            spec.schedule, prepopulate=RESUME_PREPOPULATE))
        trainer = build_trainer(spec, device="cuda")
        C = spec.schedule.cycle_steps
        reset_launches()
        t0 = time.perf_counter()
        carry = trainer.init_carry()
        torch.cuda.synchronize()
        say(f"{name} init_carry: {time.perf_counter() - t0:.2f} s "
            f"(prepopulate {spec.schedule.prepopulate}, W={spec.envs}, "
            f"F={spec.algo.train_period}, C={C}, {spec.variant.name}, "
            f"{spec.algo.optimizer})")
        for i in range(2):
            t0 = time.perf_counter()
            carry, m = trainer.cycle(carry)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            say(f"{name} cycle {i + 1}: {dt:.3f} s/cycle, "
                f"{C / dt:.1f} env-steps/s, loss {float(m['loss'][0]):.6f}")
            check(torch.isfinite(m["loss"]).all().item(),
                  f"{name}: non-finite loss")
        t0 = time.perf_counter()
        evals = trainer.eval(carry, trainer.eval_key(1))
        torch.cuda.synchronize()
        say(f"{name} eval: {time.perf_counter() - t0:.2f} s, return "
            f"{float(evals[0]):+.3f} over {spec.schedule.eval_episodes} "
            "streams")
        check(torch.isfinite(evals).all().item(), f"{name}: non-finite eval")
        launched = {k: v for k, v in read_launches().items() if v}
        check(not launched, f"{name} launched a kernel: {launched}")
        want = spec.schedule.prepopulate + 2 * C
        check(int(carry.replay["size"]) == want,
              f"{name}: replay size {int(carry.replay['size'])}, "
              f"expected {want}")
        phase_determinism(trainer, carry, f"{name} ")
        del trainer, carry
    for mode, variant in (("baseline", "double"),
                          ("synchronized", "dueling")):
        spec = dataclasses.replace(
            _spec_file(f"{mode}_catch"), variant=get_variant(variant),
            envs=4, net="tiny",
            schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64),
            algo=AlgoSpec(minibatch_size=8, replay_capacity=256,
                          train_period=4))
        _card_vs_cpu(spec, f"{mode}, catch 10x10, tiny net, {variant}")


def _fleet_cycles(spec, label: str, cycles: int) -> dict:
    """Init and ``cycles`` cycles of a fleet spec on the card through
    build_trainer, each printing s/cycle, env-steps/s over all replicas
    and the replicas' losses; the DQN kernels' and the tree build's
    launches counted over the cycles (set to 0 after the init) and
    checked: C/F descents and projections and at most 2 builds a cycle,
    whatever P. Returns the counts and the last cycle's seconds."""
    from repro_torch.api.trainers import build_trainer
    from repro_torch.kernels import segment_tree as st
    trainer = build_trainer(spec, device="cuda")
    P, C = trainer.replicas, spec.schedule.cycle_steps
    updates = C // spec.algo.train_period
    builds = len(st.tree_build_plan(st.next_pow2(spec.algo.replay_capacity)))
    t0 = time.perf_counter()
    carry = trainer.init_carry()
    torch.cuda.synchronize()
    say(f"fleet {label}: init {time.perf_counter() - t0:.2f} s (P={P}, "
        f"prepopulate {spec.schedule.prepopulate} over {P * spec.envs} "
        "streams)")
    reset_launches()
    for i in range(cycles):
        t0 = time.perf_counter()
        carry, m = trainer.cycle(carry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = ", ".join(f"{v:.6f}" for v in m["loss"].tolist())
        say(f"fleet {label} cycle {i + 1}: {dt:.3f} s/cycle, "
            f"{P * C / dt:.1f} env-steps/s over {P} replicas, losses "
            f"[{losses}]")
        check(tuple(m["loss"].shape) == (P,)
              and torch.isfinite(m["loss"]).all().item(),
              f"fleet {label}: losses {m['loss']}")
    launches = read_launches()
    for name in ("segment_tree", "categorical_projection"):
        check(launches[name] == updates * cycles,
              f"fleet {label}: {name} launched {launches[name]} times in "
              f"{cycles} cycle(s), expected {updates} a cycle")
    check(0 < launches["tree_build"] <= builds * cycles and builds <= 2,
          f"fleet {label}: tree_build launched {launches['tree_build']} "
          f"times in {cycles} cycle(s), expected {builds} a cycle")
    # a population's carry leads with P; the single replica's keeps the
    # concurrent layout
    lead = (P,) if spec.mode == "population" else ()
    obs_lead = tuple(carry.replay["obs"].shape[:len(lead) + 1])
    check(obs_lead == lead + (spec.algo.replay_capacity,)
          and all(t.device.type == "cuda" for _, t in _paths(carry)),
          f"fleet {label}: replay obs leads with {obs_lead}, expected "
          f"{lead + (spec.algo.replay_capacity,)}, or a leaf is not on the "
          "card")
    say(f"fleet {label}: launches over {cycles} cycle(s) "
        f"{ {k: v for k, v in launches.items() if v} }")
    del trainer, carry
    return {"launches": launches, "s": dt}


def phase_fleet(dev):
    """rainbow_fleet.json at its width (mode population, 4 seeds; AdamW;
    rainbow on catch, W=8, F=2, replay 16384), C cut to RESUME_STEPS and
    prepopulate to RESUME_PREPOPULATE: pixels init and 2 cycles, vector
    (the mlp net) init and 1 cycle; the P=1 point, one replica as mode
    concurrent (ConcurrentTrainer, seeds 1), init and 1 cycle in pixels
    and in vector mode; one pixels cycle at P=16; s/cycle and
    env-steps/s against P; the launches of one cycle cut to
    PROFILED_STEPS at P=1 (concurrent) and P=4; two runs of one P=4 cycle
    from one carry bitwise equal; a small population against the CPU
    path. Returns the launches of the P=4 and P=1 runs together."""
    from repro_torch.api.spec import AlgoSpec, ScheduleSpec
    from repro_torch.api.trainers import build_trainer
    from repro_torch.configs.dqn_nature import get_variant
    check(_spec_file("rainbow_fleet").mode == "population"
          and _spec_file("rainbow_fleet").seeds == 4,
          "rainbow_fleet.json is no longer a 4-seed population")
    # the fleet's cycles cut as the checkpoint phases cut them (its width
    # kept): at C=256 they took ~30 s each on a slow host, and the run
    # has to stay inside its time limit
    cut = dict(cycle_steps=RESUME_STEPS, prepopulate=RESUME_PREPOPULATE)
    fleet = _fleet_spec(**cut)
    total, per_p = {}, {}
    for obs, cycles in (("pixels", 2), ("vector", 1)):
        run = _fleet_cycles(dataclasses.replace(fleet, obs_mode=obs),
                            f"P=4 {obs}", cycles)
        one = _fleet_cycles(dataclasses.replace(_fleet_replica(**cut),
                                                obs_mode=obs),
                            f"P=1 {obs} (concurrent, one replica)", 1)
        for r in (run, one):
            for name, n in r["launches"].items():
                total[name] = total.get(name, 0) + n
        if obs == "pixels":
            per_p[4], per_p[1] = run["s"], one["s"]
    per_p[16] = _fleet_cycles(dataclasses.replace(fleet, seeds=16),
                              "P=16 pixels", 1)["s"]
    C = fleet.schedule.cycle_steps
    say(f"fleet against P (pixels, C={C}): " + ", ".join(
        f"P={P} {per_p[P]:.3f} s/cycle, {P * C / per_p[P]:.1f} env-steps/s"
        for P in sorted(per_p)))
    # the launches of one cut cycle at P=1 (concurrent) and P=4 (the
    # profiler)
    cut = dict(cycle_steps=PROFILED_STEPS, prepopulate=RESUME_PREPOPULATE)
    counts = {}
    for P, spec in ((1, _fleet_replica(**cut)), (4, _fleet_spec(**cut))):
        trainer = build_trainer(spec, device="cuda")
        carry = trainer.init_carry()
        counts[P] = launch_count(
            f"fleet P={P} cycle C={PROFILED_STEPS}",
            lambda: trainer.cycle(_clone(carry)))["launches"]
        if P == 4:
            phase_determinism(trainer, carry, "fleet P=4 ")
        del trainer, carry
    say(f"fleet launches of one cycle cut to C={PROFILED_STEPS}: P=1 "
        f"{counts[1]}, P=4 {counts[4]} ({counts[4] / counts[1]:.3f}x)")
    check(counts[4] <= 1.25 * counts[1],
          f"a P=4 cycle made {counts[4]} launches, more than 1.25x P=1's "
          f"{counts[1]}: the replica axis is not carried by the kernels")
    small = dataclasses.replace(
        fleet, variant=get_variant("rainbow"), seeds=3, envs=4, net="tiny",
        schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64),
        algo=AlgoSpec(minibatch_size=8, replay_capacity=256,
                      optimizer="adamw"))
    _card_vs_cpu(small, "population P=3, catch 10x10, tiny net, rainbow")
    return total


def phase_table1(dev):
    """Table 1 on the card: the 14 cells of launch/table1.py at the
    Nature geometry (84x84x4), with the reference's transaction
    invariants."""
    from repro_torch.launch import table1
    t0 = time.perf_counter()
    rows = table1.run_table1(steps=TABLE1_STEPS, frame_size=84,
                             device="cuda")
    wall = time.perf_counter() - t0
    steps, F = TABLE1_STEPS, 4
    say(f"table1: {len(rows)} cells of {steps} env steps each (84x84x4, "
        f"Nature CNN, F={F}, C={max(steps // 8, 64)}, replay 50000), "
        f"{wall:.1f} s")
    for line in table1.format_rows(rows).splitlines():
        say(f"table1 {line}")
    for line in table1.format_tables(rows).splitlines():
        say(f"table1 {line}")
    check(len(rows) == 14, f"table1 ran {len(rows)} cells, expected 14")
    for r in rows:
        sync = r["variant"] in ("synchronized", "both")
        want = (steps // r["threads"] if sync else steps) + 1
        check(r["infer_tx"] == want,
              f"table1 {r['variant']}-{r['threads']}: {r['infer_tx']} "
              f"inference transactions, expected {want}")
        check(r["update_tx"] == steps // F + 1,
              f"table1 {r['variant']}-{r['threads']}: {r['update_tx']} "
              f"update transactions, expected {steps // F + 1}")
    say("table1 invariants: synchronized inference = steps/W + 1, standard "
        "= steps + 1, updates = steps/F + 1 in every cell")
    _transaction_costs(dev)


def _transaction_costs(dev, runs: int = 50) -> None:
    """What Table 1's two transactions cost at 84x84x4: an update
    (minibatch 32) and an inference (batch 1 and W=8), each as the host's
    time per call and the device's (``time_ms``, queued behind a sleep on
    the stream the runner uses)."""
    from repro_torch import rng
    from repro_torch.core.host_runner import HostDQNRunner
    from repro_torch.launch import table1
    from repro_torch.models.nature_cnn import q_forward, q_init
    ncfg = table1.table1_config(84, 3)
    runner = HostDQNRunner(
        lambda p, o: q_forward(p, o, ncfg),
        q_init(ncfg, 3, rng.PRNGKey(0, device=dev)),
        table1.table1_dqn_config(TABLE1_STEPS, 8, ncfg.frame_stack),
        concurrent=True, synchronized=True, n_envs=8, frame_size=84,
        device="cuda")
    runner.run(0, prepopulate=256)
    t0 = time.perf_counter()
    for _ in range(runs):
        runner._dispatch_update(block=False)
    queue_s = (time.perf_counter() - t0) / runs
    runner._wait_trainer()
    total_s = (time.perf_counter() - t0) / runs
    with torch.cuda.stream(runner.trainer_stream):
        update_ms = time_ms(lambda: runner._dispatch_update(block=False),
                            runs=runs)
    runner._wait_trainer()
    runner.pending.clear()
    t0 = time.perf_counter()
    for _ in range(runs):
        runner._act(0.0, [0])
    act1_s = (time.perf_counter() - t0) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        runner._act(0.0, list(range(8)))
    act8_s = (time.perf_counter() - t0) / runs
    with torch.cuda.stream(runner.sampler_stream):
        frames = runner._to_device(runner.stacks)
        infer1_ms = time_ms(lambda: runner._infer(runner.target, frames[:1]),
                            runs=runs)
        infer8_ms = time_ms(lambda: runner._infer(runner.target, frames),
                            runs=runs)
    say(f"table1 one update (minibatch 32): host {queue_s * 1e3:.3f} ms to "
        f"queue ({total_s * 1e3:.3f} ms per update over {runs} queued "
        f"back to back), device {update_ms:.3f} ms")
    say(f"table1 one inference transaction (host round trip, stack to "
        f"action): {act1_s * 1e3:.3f} ms at batch 1, {act8_s * 1e3:.3f} ms "
        f"at batch 8; device forward {infer1_ms:.3f} ms at batch 1, "
        f"{infer8_ms:.3f} ms at batch 8")


def _fleet_spec(**schedule):
    """rainbow_fleet.json as written (a 4-seed population), its schedule
    cut by ``schedule``."""
    spec = _spec_file("rainbow_fleet")
    return dataclasses.replace(spec, schedule=dataclasses.replace(
        spec.schedule, **schedule))


def _fleet_replica(**schedule):
    """rainbow_fleet.json for one replica (mode concurrent, seeds 1),
    its schedule cut by ``schedule``."""
    return dataclasses.replace(_fleet_spec(**schedule), mode="concurrent",
                               seeds=1)


def _resume_round_trip(spec, label: str, dev, against_cpu: bool = False):
    """Two cycles with a checkpoint after each; step 2 deleted, step 1
    restored through restore_latest and cycle 2 run again: bitwise equal
    to the uninterrupted cycle 2, leaf for leaf. Returns the launches of
    the resumed cycle."""
    from repro_torch.api.trainers import build_trainer
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    trainer = build_trainer(spec, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        carry = trainer.init_carry()
        for i in range(2):
            carry, _ = trainer.cycle(carry)
            save_checkpoint(d, i + 1, carry)
        os.unlink(os.path.join(d, "step_00000002.npz"))
        template = trainer.init_template()
        step, restored, skipped = restore_latest(d, template, device=dev)
        check(step == 1 and not skipped,
              f"{label}: restored step {step}, skipped {skipped}")
        cpu = restore_latest(d, template)[1] if against_cpu else None
    reset_launches()
    resumed, _ = trainer.cycle(restored)
    torch.cuda.synchronize()
    launches = read_launches()
    n = _bitwise(resumed, carry, f"{label} resumed ")
    say(f"resume {label}: cycle 2 from the restored cycle-1 checkpoint "
        f"bitwise equal to the uninterrupted cycle 2 ({n} tensors); "
        f"launches in the resumed cycle "
        f"{ {k: v for k, v in launches.items() if v} }")
    if cpu is not None:
        on_cpu, _ = build_trainer(spec, device="cpu").cycle(cpu)
        worst = _agree(on_cpu, resumed, f"resume {label}")
        say(f"resume {label}: the checkpoint restored on the CPU runs cycle "
            f"2 as the card does: integer state equal, floats within 1e-4 "
            f"(max {worst:.2e})")
    return launches


def phase_resume(dev):
    """Checkpoints on the card: rainbow_fleet.json for one replica
    (rainbow on catch, pixels) and baseline_catch.json, each cut to
    RESUME_STEPS-step cycles, resumed bitwise; both DQN kernels and the
    tree build launch in the resumed rainbow cycle."""
    from repro_torch.api.spec import ScheduleSpec
    cut = dict(cycle_steps=RESUME_STEPS, prepopulate=RESUME_PREPOPULATE)
    say(f"resume: cycles cut to C={RESUME_STEPS} and prepopulate to "
        f"{RESUME_PREPOPULATE} (the specs: C=256, prepopulate 2048)")
    launches = _resume_round_trip(_fleet_replica(**cut), "rainbow_fleet "
                                  "replica (catch, rainbow)", dev,
                                  against_cpu=True)
    for name in ("segment_tree", "categorical_projection", "tree_build"):
        check(launches[name] > 0, f"{name} never launched in the resumed "
              "rainbow cycle")
    launches = _resume_round_trip(_fleet_spec(**cut), "rainbow_fleet "
                                  "population P=4 (catch, rainbow)", dev)
    updates = RESUME_STEPS // _fleet_spec().algo.train_period
    for name in ("segment_tree", "categorical_projection"):
        check(launches[name] == updates, f"{name} launched "
              f"{launches[name]} times in the resumed P=4 cycle, expected "
              f"{updates}")
    base = _spec_file("baseline_catch")
    _resume_round_trip(dataclasses.replace(base, schedule=ScheduleSpec(
        **{**dataclasses.asdict(base.schedule), **cut})),
        "baseline_catch (double)", dev)


def _rl_train_start(*args):
    """Start ``python -m repro_torch.launch.rl_train`` with ``args`` in a
    process of its own; ``_rl_train_wait`` ends it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.rl_train", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    atexit.register(_stop, proc)
    return proc, args, time.perf_counter()


def _rl_train_wait(started, expect: int = 0) -> str:
    """Wait for a process of ``_rl_train_start`` (killed after 300 s);
    returns its output (stdout, then stderr)."""
    proc, args, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = stdout + stderr
    check(proc.returncode == expect,
          f"rl_train {' '.join(args)} exited {proc.returncode}, expected "
          f"{expect}:\n{out[-3000:]}")
    say(f"launcher rl_train {' '.join(a for a in args if '/' not in a)}: "
        f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    return out


def _rl_train(*args, expect: int = 0) -> str:
    """``python -m repro_torch.launch.rl_train`` with ``args`` in a process
    of its own; returns its output (stdout, then stderr)."""
    return _rl_train_wait(_rl_train_start(*args), expect)


def _cut_spec_file(spec, path: str) -> str:
    """``spec`` cut as in phase_resume, its ε horizon pinned to the full
    run's so that --cycles may grow, written to ``path``."""
    spec = dataclasses.replace(spec, algo=dataclasses.replace(
        spec.algo, eps_anneal_steps=60 * 256 // 2))
    with open(path, "w") as f:
        f.write(spec.to_json())
    return path


def _check_trace(path: str, label: str, cycles: int, env_steps: int,
                 gpu: str) -> dict:
    """A launcher's --trace FILE, read with the port's report: one cycle
    span per cycle run, the train span's children covering >= 90% of
    it, the env_steps counter, the card and its power limit in the
    header, a Chrome twin that parses. Returns the summary rows."""
    from repro_torch.telemetry import chrome_path_for, report
    trace = report.load_trace(path)
    rows = {r["name"]: r for r in report.summarize(trace)}
    n = rows.get("cycle", {}).get("count", 0)
    cover = report.phase_coverage(trace, "train") or 0.0
    attrs = trace["meta"].get("attrs", {})
    check(n == cycles, f"{label} trace: {n} cycle spans, expected {cycles}")
    check(cover >= 0.9, f"{label} trace: the train span's children cover "
          f"{cover:.3f} of it, below 0.9")
    check(trace["counters"].get("env_steps") == env_steps,
          f"{label} trace: env_steps {trace['counters']}, expected "
          f"{env_steps}")
    check(attrs.get("gpu") == gpu, f"{label} trace: meta names "
          f"{attrs.get('gpu')!r}, the card is {gpu!r}")
    with open(chrome_path_for(path)) as f:
        events = json.load(f)["traceEvents"]
    say(f"trace {label}: {n} cycle spans, steady p50 "
        f"{rows['cycle']['steady_p50_us'] / 1e6:.3f} s (first "
        f"{rows['cycle']['first_us'] / 1e6:.3f} s), coverage of train "
        f"{cover:.4f}, env_steps {trace['counters']['env_steps']:.0f}, "
        f"{len(trace['compiles'])} compile records, meta {attrs.get('gpu')}, "
        f"torch {attrs.get('torch')}, CUDA {attrs.get('cuda')}; Chrome twin "
        f"{len(events)} events")
    return rows


def phase_launcher(d: str, gpu: str) -> str:
    """The launcher end to end on the card, in processes of its own:
    rainbow_fleet.json with its 4 seeds (cut as in phase_resume, its ε
    horizon pinned to the full run's so that --cycles may grow) with
    --ckpt-dir and --metrics-jsonl for 2 cycles, then --cycles 3
    --resume (4 metrics rows a cycle); then a changed spec refused.
    Beside the fleet's first call, in a process of its own, one replica
    (mode concurrent: the launcher's single-carry branch) for 2 cycles
    with a checkpoint, one metrics row a cycle. Both first calls run
    with --trace, each trace read back (``_check_trace``). Returns the
    fleet's checkpoint dir."""
    cut = dict(cycle_steps=RESUME_STEPS, prepopulate=RESUME_PREPOPULATE)
    one_ck = os.path.join(d, "replica")
    one_jsonl = os.path.join(one_ck, "m.jsonl")
    one_trace = os.path.join(d, "replica.trace.jsonl")
    single = _rl_train_start(
        "--spec", _cut_spec_file(_fleet_replica(**cut),
                                 os.path.join(d, "replica.json")),
        "--ckpt-dir", one_ck, "--metrics-jsonl", one_jsonl, "--cycles", "2",
        "--trace", one_trace)
    ck = os.path.join(d, "run")
    jsonl = os.path.join(ck, "m.jsonl")
    trace = os.path.join(d, "fleet.trace.jsonl")
    common = ["--spec", _cut_spec_file(_fleet_spec(**cut),
                                       os.path.join(d, "spec.json")),
              "--ckpt-dir", ck, "--metrics-jsonl", jsonl]
    try:
        _rl_train(*common, "--cycles", "2", "--trace", trace)
    finally:
        _rl_train_wait(single)
    _check_trace(one_trace, "one replica (concurrent)", 2,
                 2 * RESUME_STEPS, gpu)
    _check_trace(trace, "4 replicas", 2, 4 * 2 * RESUME_STEPS, gpu)
    with open(one_jsonl) as f:
        rows = [json.loads(ln) for ln in f]
    check([(x["cycle"], x["seed"], x["mode"]) for x in rows]
          == [(1, 0, "concurrent"), (2, 0, "concurrent")]
          and os.path.exists(os.path.join(one_ck, "step_00000002.npz")),
          f"one replica: metrics rows {rows}, checkpoints "
          f"{sorted(os.listdir(one_ck))}; expected one row a cycle and "
          "step 2's checkpoint")
    out = _rl_train(*common, "--cycles", "3", "--resume")
    check(f"resumed {ck} at cycle 2" in out, f"no resume line in:\n{out}")
    with open(jsonl) as f:
        rows = [json.loads(ln) for ln in f]
    cycles = [x["cycle"] for x in rows]
    check(cycles == [c for c in (1, 2, 3) for _ in range(4)]
          and [x["seed"] for x in rows] == [0, 1, 2, 3] * 3,
          f"metrics rows for (cycle, seed) "
          f"{[(x['cycle'], x['seed']) for x in rows]}, expected 4 a cycle")
    # the refusal comes before any init: in this process
    from repro_torch.launch import rl_train
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = rl_train.main([*common, "--cycles", "4", "--resume", "--envs",
                            "4"])
    check(rc == 2 and "envs: checkpoint=8, requested=4" in err.getvalue(),
          f"rl_train with a changed spec exited {rc}:\n{err.getvalue()}")
    say(f"launcher: one replica (concurrent) 2 cycles, a metrics row and a "
        f"checkpoint each; 4 replicas, resumed at cycle 2, metrics rows for "
        f"cycles {cycles}, a changed spec refused with its field diff")
    return ck


def _every_client_served(server, n: int):
    """Wrap ``server.flush`` so that every tick must answer all n
    clients."""
    flush = server.flush

    def checked(keys=None):
        out = flush(keys)
        check(sorted(out) == list(range(n)),
              f"a tick answered {len(out)} of {n} clients")
        return out

    server.flush = checked


def _serve_load(loaded, policy: str, clients: int, label: str,
                profile: bool = False) -> dict:
    from repro_torch.api.policy_client import SimulatedClients, drive
    from repro_torch.api.serve import ServeSpec, make_server
    server = make_server(loaded, ServeSpec(policy=policy))
    t0 = time.perf_counter()
    n = server.warm_start(clients)
    warm_s = time.perf_counter() - t0
    fleet = SimulatedClients(loaded.spec, clients, seed=1, device="cuda")
    _every_client_served(server, clients)
    stats = drive(server, fleet, SERVE_TICKS)
    check(stats["actions"] == clients * SERVE_TICKS,
          f"{label}: {stats['actions']} actions served")
    say(f"serve {label} {policy}: {clients} clients x {SERVE_TICKS} ticks, "
        f"{stats['actions_per_s']:.0f} actions/s, p50 "
        f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms, "
        f"{stats['microbatches_per_tick']:.2f} microbatches/tick "
        f"(warm start {n} buckets, {warm_s:.2f} s); "
        f"{stats['episodes']} episodes finished")
    # where a tick goes: each part ends in a copy to the host, so the
    # host clock covers its device work
    parts = {"observe": 0.0, "submit": 0.0, "flush": 0.0, "step": 0.0}
    for _ in range(BREAKDOWN_TICKS):
        t0 = time.perf_counter()
        obs = fleet.observations()
        t1 = time.perf_counter()
        server.submit_many(fleet.ids, obs, fleet.first)
        t2 = time.perf_counter()
        acts = server.flush()
        t3 = time.perf_counter()
        fleet.step([acts[i] for i in fleet.ids])
        t4 = time.perf_counter()
        for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[name] += dt * 1e3 / BREAKDOWN_TICKS
    say(f"serve {label} {policy} per tick (mean of {BREAKDOWN_TICKS} more): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + " (observe and step: the simulated clients; submit and flush: "
        "the server)")
    if profile:
        server.submit_many(fleet.ids, fleet.observations(), fleet.first)
        acts = {}
        profile_classes(f"serve {label} {policy} flush",
                        lambda: acts.update(server.flush()))
        if policy == "egreedy":
            profile_classes(f"serve {label} clients step",
                            lambda: fleet.step([acts[i] for i in fleet.ids]))
    return stats


def _serve_checks(loaded) -> None:
    """Served actions equal a direct policy_step on the same stacks and
    keys, bitwise, at one bucket; and a fixed set of streams gets the same
    actions whatever bucket and company its requests arrive in."""
    from repro_torch import rng
    from repro_torch.api.serve import ServeSpec, make_server
    from repro_torch.core.policy import policy_step
    from repro_torch.envs.preprocess import init_obs_stack, push_frame
    gen = torch.Generator().manual_seed(5)
    n = 64
    frames = torch.randint(0, 256, (n,) + loaded.pipe.shape, generator=gen,
                           dtype=torch.uint8).numpy()
    for policy in ("egreedy", "noisy"):
        serve = ServeSpec(policy=policy, seed=3)
        server = make_server(loaded, serve)
        server.submit_many(range(n), frames, [True] * n)
        got = server.flush()
        stacks = push_frame(init_obs_stack(n, loaded.pipe,
                                           loaded.frame_stack, "cuda"),
                            torch.from_numpy(frames).cuda())
        base = rng.PRNGKey(serve.seed, device="cuda")
        ids = torch.arange(n, device="cuda")
        keys = rng.fold_in(rng.fold_in(base, ids), torch.zeros_like(ids))
        noise = rng.fold_in(rng.fold_in(base, 7), 0) \
            if policy == "noisy" else None
        eps = serve.eps if policy == "egreedy" else 0.0
        with torch.no_grad():
            want = policy_step(loaded.q_forward, loaded.params, stacks,
                               eps, keys, noise).cpu().tolist()
        check([got[i] for i in range(n)] == want,
              f"serve {policy}: served actions differ from policy_step")
        # the same 64 requests inside 200, shuffled, in buckets of up to
        # 100 (64 and 100 rows) against the 64-row bucket above
        other = make_server(loaded, ServeSpec(policy=policy, seed=3,
                                              max_batch=100))
        order = torch.randperm(200, generator=gen).tolist()
        extra = torch.randint(0, 256, (200,) + loaded.pipe.shape,
                              generator=gen, dtype=torch.uint8).numpy()
        for i in order:
            other.submit(i if i < n else 1000 + i,
                         frames[i] if i < n else extra[i], first=True)
        mixed = other.flush()
        flipped = sum(mixed[i] != got[i] for i in range(n))
        check(flipped == 0, f"serve {policy}: {flipped} of {n} actions "
              "changed with the bucket and the batch's composition")
    say(f"serve checks: served actions equal policy_step on the same stacks "
        f"and keys at bucket {n} (egreedy, noisy), bitwise; the same {n} "
        "requests shuffled among 200 in buckets of 100 give the same actions")


def _serve_replica(ckpt_dir: str, r: int, dev) -> None:
    """load_policy serves replica r of the launcher's population
    checkpoint: replica r's parameters, and served actions equal to
    policy_step on them, bitwise."""
    from repro_torch import rng
    from repro_torch.api.serve import ServeSpec, load_policy, make_server
    from repro_torch.api.trainers import build_trainer
    from repro_torch.checkpoint import restore_latest
    from repro_torch.core.policy import policy_step
    from repro_torch.envs.preprocess import init_obs_stack, push_frame
    loaded = load_policy(ckpt_dir, replica=r, device="cuda")
    trainer = build_trainer(loaded.spec, device="cuda")
    carry = restore_latest(ckpt_dir, trainer.init_template(), device=dev)[1]
    own = {k: v[r] for k, v in carry.params.items()}
    check(all(torch.equal(loaded.params[k], own[k]) for k in own),
          f"load_policy replica {r}: parameters differ from the checkpoint's")
    n = 64
    frames = torch.randint(0, 256, (n,) + loaded.pipe.shape,
                           generator=torch.Generator().manual_seed(r),
                           dtype=torch.uint8).numpy()
    serve = ServeSpec(policy="egreedy", seed=3)
    server = make_server(loaded, serve)
    server.submit_many(range(n), frames, [True] * n)
    got = server.flush()
    stacks = push_frame(init_obs_stack(n, loaded.pipe, loaded.frame_stack,
                                       "cuda"),
                        torch.from_numpy(frames).cuda())
    base = rng.PRNGKey(serve.seed, device="cuda")
    ids = torch.arange(n, device="cuda")
    keys = rng.fold_in(rng.fold_in(base, ids), torch.zeros_like(ids))
    with torch.no_grad():
        want = policy_step(loaded.q_forward, own, stacks, serve.eps,
                           keys).cpu().tolist()
    check([got[i] for i in range(n)] == want,
          f"serve replica {r}: served actions differ from policy_step on "
          "its parameters")
    say(f"serve replica {r} of the {loaded.spec.seeds}-replica catch "
        f"checkpoint: its parameters, and {n} served actions equal to "
        "policy_step on them, bitwise")


def phase_policy_serving(dev, catch_dir: str):
    """Serving on the card at full width: a checkpoint of dqn_nature84.json
    with rainbow (pong 84x84x4, the Nature CNN, a 16384-slot replay; init
    with a short prepopulate and one cycle cut short), save and restore
    timed; then 1024 simulated clients x SERVE_TICKS ticks under greedy,
    egreedy and noisy, and the catch checkpoint at 256 clients, through
    the serve_policy launcher as well, with --trace: one serve.flush span
    a tick, its serve.compute spans, serve.actions = clients x ticks."""
    from repro_torch.api.serve import load_policy
    from repro_torch.api.spec import save_run_spec
    from repro_torch.api.trainers import build_trainer
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.configs.dqn_nature import get_variant
    from repro_torch.launch import serve_policy
    base = _spec_file("dqn_nature84")
    spec = dataclasses.replace(
        base, variant=get_variant("rainbow"),
        schedule=dataclasses.replace(base.schedule, cycle_steps=RESUME_STEPS,
                                     prepopulate=RESUME_PREPOPULATE))
    trainer = build_trainer(spec, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        carry, _ = trainer.cycle(trainer.init_carry())
        torch.cuda.synchronize()
        save_run_spec(d, spec)
        t0 = time.perf_counter()
        path = save_checkpoint(d, 1, carry)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del carry
        t0 = time.perf_counter()
        restored = restore_latest(d, trainer.init_template(), device=dev)[1]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tuple(restored.replay["obs"].shape) == (16384, 84, 84, 4),
              "restored replay is not (16384, 84, 84, 4)")
        del restored, trainer
        say(f"checkpoint at 84x84x4 (dqn_nature84, rainbow, C cut to "
            f"{RESUME_STEPS}): {size / 1e6:.1f} MB, save {save_s:.2f} s, "
            f"restore to the card {restore_s:.2f} s")
        t0 = time.perf_counter()
        loaded = load_policy(d, device="cuda")
        say(f"serve load_policy (spec.json + the newest checkpoint, "
            f"params to the card): {time.perf_counter() - t0:.2f} s")
    for policy in ("greedy", "egreedy", "noisy"):
        _serve_load(loaded, policy, SERVE_CLIENTS, "pong 84x84x4",
                    profile=policy != "greedy")
    _serve_checks(loaded)
    catch = load_policy(catch_dir, device="cuda")
    _serve_load(catch, "egreedy", 256, "catch (rainbow_fleet replica 0)")
    _serve_replica(catch_dir, 2, dev)
    from repro_torch.telemetry import report
    text = io.StringIO()
    trace = os.path.join(os.path.dirname(catch_dir), "serve.trace.jsonl")
    clients, ticks = 256, 10
    with contextlib.redirect_stdout(text):
        rc = serve_policy.main(["--ckpt-dir", catch_dir, "--clients",
                                str(clients), "--ticks", str(ticks),
                                "--warm-start", "--smoke", "--trace", trace])
    for line in text.getvalue().splitlines():
        say(f"serve_policy: {line}")
    check(rc == 0 and "SERVE OK" in text.getvalue(),
          f"serve_policy --smoke exited {rc}")
    got = report.load_trace(trace)
    rows = {r["name"]: r for r in report.summarize(got)}
    flushes = rows.get("serve.flush", {}).get("count", 0)
    computes = rows.get("serve.compute", {}).get("count", 0)
    actions = got["counters"].get("serve.actions")
    check(flushes == ticks and computes >= ticks
          and actions == clients * ticks,
          f"serve_policy --trace: {flushes} serve.flush spans, {computes} "
          f"serve.compute, serve.actions {actions}; expected {ticks}, >= "
          f"{ticks} and {clients * ticks}")
    say(f"serve_policy --trace: {flushes} serve.flush spans (steady p50 "
        f"{rows['serve.flush']['steady_p50_us'] / 1e3:.3f} ms), {computes} "
        f"serve.compute (steady p50 "
        f"{rows['serve.compute']['steady_p50_us'] / 1e3:.3f} ms), "
        f"serve.queue_wait steady p50 "
        f"{rows['serve.queue_wait']['steady_p50_us'] / 1e3:.3f} ms, "
        f"serve.actions {actions:.0f}")


def _npz_equal(a: str, b: str) -> bool:
    import numpy as np
    with np.load(a) as xa, np.load(b) as xb:
        return (sorted(xa.files) == sorted(xb.files)
                and all(np.array_equal(xa[k], xb[k]) for k in xa.files))


def _tracer_cost(d: str, dev, cycle_s: float, n: int = 2000) -> None:
    """What tracing adds to a launcher's cycle, in this process: the host
    time of a span with a count (its JSON line written) and of a fence
    with nothing queued, against NullTracer's; the launcher's cycle has
    5 spans (cycle, eval, metrics, checkpoint, and train's share), 2
    counts and 2 fences."""
    from repro_torch.telemetry import JsonlSink, NullTracer, Tracer
    x = torch.zeros(1, device=dev)
    costs = {}
    for name, tr in (("null", NullTracer()), ("traced", Tracer(
            [JsonlSink(os.path.join(d, "cost.jsonl"))],
            capture_compiles=False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            with tr.span("cycle", index=i):
                pass
            tr.count("cycles", 1)
        t1 = time.perf_counter()
        for _ in range(n):
            tr.fence(x)
        t2 = time.perf_counter()
        tr.close()
        costs[name] = ((t1 - t0) / n * 1e6, (t2 - t1) / n * 1e6)
    (span0, fence0), (span1, fence1) = costs["null"], costs["traced"]
    added = 5 * (span1 - span0) + 2 * (fence1 - fence0)
    say(f"tracer cost (host, mean of {n}): a span and a count "
        f"{span1:.2f} us traced, {span0:.2f} us null; a fence with "
        f"nothing queued {fence1:.2f} us traced, {fence0:.2f} us null; "
        f"per launcher cycle ~{added:.1f} us, {added / (cycle_s * 1e6):.2e}"
        f" of the traced fleet's {cycle_s:.3f} s (median, cycles 2..)")


def phase_sweep_start(d: str, dev):
    """Phase 18 (a), started: catch_lr_seeds_sweep.json cut as
    ``phase_sweep`` says, written to ``d``, through the launcher with
    --sweep --trace 1 in a process of its own. It runs beside phases
    15-16, which check values, and ``phase_sweep`` reads it."""
    from repro_torch.configs.dqn_nature import get_variant
    data = json.loads(SWEEP_MANIFEST.read_text())
    data["base"]["variant"] = dataclasses.asdict(get_variant("rainbow"))
    data["base"]["schedule"].update(
        cycles=SWEEP_CYCLES, cycle_steps=RESUME_STEPS,
        prepopulate=RESUME_PREPOPULATE, eval_every=1)
    data["base"]["checkpoint"].update(every=1)
    data["dir"] = os.path.join(d, "a")
    manifest = os.path.join(d, "sweep.json")
    with open(manifest, "w") as f:
        json.dump(data, f)
    return _rl_train_start("--sweep", manifest, "--trace", "1", "--device",
                           dev.type)


def phase_sweep(d: str, dev, out: str) -> None:
    """catch_lr_seeds_sweep.json as committed (catch 10x10, the small
    net, W=8, replay 16384 per replica, AdamW, lr {1e-3, 5e-4} x seeds
    {0, 1, 2}: 2 packed fleets of 3), in a copy with the rainbow preset
    (PER and C51 run), SWEEP_CYCLES cycles of RESUME_STEPS steps,
    prepopulate RESUME_PREPOPULATE, an eval and a checkpoint every
    cycle: (a) the launcher with --sweep --trace 1 in a process of its
    own (``phase_sweep_start``; ``out`` its output); (b) run_sweep here
    into a second root, interrupted after fleet001's cycle 2, its newest
    checkpoint torn, resumed: fleet000 skipped, every run's result.json
    and final carry bitwise (a)'s, the DQN kernels' launches counted,
    the card's memory back where it started; (c) the launcher's
    --resume trains nothing; (d) a changed manifest exits 2 naming its
    field; (e) load_policy on a run directory serves the slice of its
    fleet's final carry."""
    from repro_torch.api.serve import load_policy
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.api.sweep import SweepSpec, expand, pack, run_sweep
    from repro_torch.api.trainers import build_packed_fleet
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import rl_train
    from repro_torch.telemetry import report
    manifest = os.path.join(d, "sweep.json")
    with open(manifest) as f:
        data = json.load(f)
    a_root = data["dir"]
    sweep = SweepSpec.from_json(json.dumps(data))
    runs, fleets = expand(sweep), pack(expand(sweep))
    say(f"sweep: {len(runs)} runs in fleets "
        f"{[(f.id, f.seeds) for f in fleets]}; rainbow, C={RESUME_STEPS}, "
        f"prepopulate {RESUME_PREPOPULATE}, {SWEEP_CYCLES} cycles (the "
        "manifest: dqn, C=256, prepopulate 512, 40 cycles)")

    # (a) the launcher, traced
    check("SWEEP OK runs=6 trained=6 skipped=0" in out,
          f"rl_train --sweep printed:\n{out[-2000:]}")
    check(sorted(os.listdir(os.path.join(a_root, "fleets")))
          == ["fleet000-p3", "fleet001-p3"],
          f"fleets {os.listdir(os.path.join(a_root, 'fleets'))}")
    for run in runs:
        rdir = os.path.join(a_root, "runs", run.id)
        with open(os.path.join(rdir, "metrics.jsonl")) as f:
            cycles = [json.loads(ln)["cycle"] for ln in f]
        check(cycles == list(range(1, SWEEP_CYCLES + 1))
              and os.path.exists(os.path.join(rdir, "result.json"))
              and os.path.exists(os.path.join(rdir, "trace.jsonl")),
              f"{run.id}: metrics cycles {cycles}, files "
              f"{sorted(os.listdir(rdir))}")
    traced = {}
    for fleet in fleets:
        trace = report.load_trace(os.path.join(
            a_root, "runs", fleet.members[0].id, "trace.jsonl"))
        # a cycle's whole wall: its cycle, eval, metrics and checkpoint
        traced[fleet.id] = [sum(
            s["dur"] for s in trace["spans"] if s["depth"] == 2
            and s["attrs"].get("index") == i) / 1e6
            for i in range(1, SWEEP_CYCLES + 1)]
        durs = [s["dur"] / 1e6 for s in trace["spans"]
                if s["name"] == "cycle"]
        evals = [s["dur"] / 1e6 for s in trace["spans"]
                 if s["name"] == "eval"]
        init = sum(s["dur"] for s in trace["spans"]
                   if s["name"] == "init") / 1e6
        say(f"sweep {fleet.id} (launcher, traced, beside phases 15-16): "
            f"s/cycle {', '.join(f'{x:.3f}' for x in durs)}; eval s "
            f"{', '.join(f'{x:.3f}' for x in evals)}; init {init:.3f} s; "
            f"{3 * RESUME_STEPS / statistics.median(durs):.1f} env-steps/s "
            "over 3 replicas (median cycle)")

    # (b) here: interrupted, a torn checkpoint, resumed
    class Stop(Exception):
        pass

    stamps = {}

    def bomb(fleet_id: str, cycle: int) -> None:
        stamps[fleet_id, cycle] = time.perf_counter()
        if fleet_id.startswith("fleet001") and cycle == 2:
            raise Stop()

    b_root = os.path.join(d, "b")
    torch.cuda.synchronize()
    gc.collect()               # what earlier phases left for the collector
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        run_sweep(sweep, root=b_root, on_cycle=bomb, device=dev.type)
        check(False, "run_sweep was not interrupted")
    except Stop:
        pass
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    fdir = os.path.join(b_root, "fleets", "fleet001-p3")
    newest = os.path.join(fdir, "step_00000002.npz")
    with open(newest, "r+b") as f:
        f.truncate(57)                          # torn: a crash mid-write
    reset_launches()
    t0 = time.perf_counter()
    res = run_sweep(sweep, root=b_root, resume=True, device=dev.type)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = read_launches()
    gc.collect()
    mem2 = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    check([r["skipped"] for r in res] == [True] * 3 + [False] * 3,
          f"resumed sweep skipped {[r['skipped'] for r in res]}")
    final = f"step_{SWEEP_CYCLES:08d}.npz"
    for run in runs:
        a = os.path.join(a_root, "runs", run.id)
        b = os.path.join(b_root, "runs", run.id)
        with open(os.path.join(a, "result.json")) as fa, \
                open(os.path.join(b, "result.json")) as fb:
            check(fa.read() == fb.read(), f"{run.id}: result.json differs")
        check(_npz_equal(os.path.join(a, final), os.path.join(b, final)),
              f"{run.id}: the final carry differs from the launcher's")
    # two cycles replayed (2 and 3), C/F updates each, all 3 replicas in
    # one launch per update
    updates = (SWEEP_CYCLES - 1) * (RESUME_STEPS
                                    // sweep.base.algo.train_period)
    for name in ("segment_tree", "categorical_projection"):
        check(launches[name] == updates, f"{name} launched "
              f"{launches[name]} times in the resumed fleet, expected "
              f"{updates}")
    check(0 < launches["tree_build"] <= 2 * (SWEEP_CYCLES - 1),
          f"tree_build launched {launches['tree_build']} times")
    # the fleets' trainers and carries are gone once run_sweep returns
    check(mem1 - mem0 < 4e6 and mem2 - mem0 < 4e6,
          f"card memory allocated {mem0}, {mem1} after the interrupted "
          f"sweep, {mem2} after the resumed one (peak {peak})")
    # fleet000's cycles 2.. (cycle, eval, metrics and checkpoint) traced
    # in (a)'s process, beside phases 15-16, and untraced in this one,
    # which has run every earlier phase: a comparison across processes,
    # not the tracer's cost
    fid = fleets[0].id
    plain = [stamps[fid, i + 1] - stamps[fid, i]
             for i in range(1, SWEEP_CYCLES)]
    say(f"sweep {fid} s per cycle with its eval, metrics and checkpoint, "
        f"cycles 2..{SWEEP_CYCLES}: traced (launcher's process) "
        f"{', '.join(f'{x:.3f}' for x in traced[fid][1:])}, untraced "
        f"(this process) {', '.join(f'{x:.3f}' for x in plain)}")
    _tracer_cost(d, dev, statistics.median(traced[fid][1:]))
    say(f"sweep here: interrupted after fleet001's cycle 2, "
        f"step_00000002.npz torn, resumed in {resume_s:.1f} s: fleet000's "
        "3 runs skipped; result.json and final carry of all 6 runs bitwise "
        f"the launcher's (traced); launches in the resumed fleet "
        f"{ {k: v for k, v in launches.items() if v} } ({updates} "
        f"updates); card memory allocated {mem0 / 1e6:.3f} MB before, "
        f"{mem1 / 1e6:.3f} after the interruption, {mem2 / 1e6:.3f} after, "
        f"peak {peak / 1e6:.3f} MB")

    # (c) resume is idempotent; (d) a changed manifest is refused
    out = _rl_train("--sweep", manifest, "--resume", "--device", dev.type)
    check("trained=0 skipped=6" in out, f"--resume printed:\n{out[-2000:]}")
    data["axes"]["lr"] = [0.001, 0.0001]
    changed = os.path.join(d, "changed.json")
    with open(changed, "w") as f:
        json.dump(data, f)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = rl_train.main(["--sweep", changed, "--resume", "--device",
                            dev.type])
    check(rc == 2 and "axes.lr" in err.getvalue(),
          f"a changed manifest exited {rc}:\n{err.getvalue()}")

    # (e) a run directory serves its replica of the fleet's final carry
    fleet = fleets[1]
    fdir = os.path.join(a_root, "fleets", fleet.id)
    with open(os.path.join(fdir, "spec.json")) as f:
        fspec = ExperimentSpec.from_json(f.read())
    carry = restore_checkpoint(
        fdir, SWEEP_CYCLES, build_packed_fleet(
            fspec, list(fleet.seeds), device=dev.type).init_template(),
        device=dev)
    for r, member in enumerate(fleet.members):
        loaded = load_policy(os.path.join(a_root, "runs", member.id),
                             device=dev.type)
        check(loaded.step == SWEEP_CYCLES
              and all(torch.equal(v, carry.params[k][r])
                      for k, v in loaded.params.items()),
              f"load_policy {member.id}: not replica {r} of {fleet.id}")
    say(f"sweep: launcher --resume trained=0 skipped=6; a changed lr axis "
        f"refused (exit 2, axes.lr named); load_policy on each run of "
        f"{fleet.id} equals its slice of the fleet's final carry")


def kernel_table():
    """name -> (wrapper with a ``launches`` count, CUDA source, the TPU
    kernel it replaces), for every kernel of the port; the last,
    tree_build, replaces XLA code outside any Pallas call."""
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import segment_tree as st
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels import ssm_scan as ss
    csrc = "src/repro_torch/kernels/csrc/"
    tpu = "src/repro/kernels/"
    return {
        "segment_tree": (st.segment_tree_sample, csrc + "segment_tree.cu",
                         tpu + "segment_tree.py:95"),
        "categorical_projection": (
            cp.categorical_projection, csrc + "categorical_projection.cu",
            tpu + "categorical_projection.py:98"),
        "rmsnorm": (rn.rmsnorm, csrc + "rmsnorm.cu", tpu + "rmsnorm.py:33"),
        "flash_attention": (fa.flash_attention, csrc + "flash_attention.cu",
                            tpu + "flash_attention.py:97"),
        "decode_attention": (da.decode_attention,
                             csrc + "decode_attention.cu",
                             tpu + "decode_attention.py:74"),
        "ssm_scan": (ss.ssm_scan, csrc + "ssm_scan.cu",
                     tpu + "ssm_scan.py:77"),
        "slstm_scan": (sl.slstm_scan, csrc + "slstm_scan.cu",
                       tpu + "slstm_scan.py:82"),
        "tree_build": (st.tree_build, csrc + "segment_tree.cu",
                       tpu + "segment_tree.py:49"),
    }


def reset_launches() -> None:
    for fn, _, _ in kernel_table().values():
        fn.launches = 0
    PATH_CALLS.update(dict.fromkeys(LLM_KERNELS, 0))


def read_launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in kernel_table().items()}


def _randn(gen: torch.Generator, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)


def _llm_check(name, got, want, dtype, case,
               to_output: bool = False) -> float:
    """``got`` against ``want`` at LLM_TOL[dtype], absolute and relative;
    ``to_output``: in bfloat16 the absolute part scaled by the largest
    magnitude of ``want`` where that is below 1 (decode attention over a
    long cache averages its values down to a few hundredths). Returns
    the max abs error."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} at {case}: {got.dtype} {tuple(got.shape)}, plain "
          f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    tol = atol = LLM_TOL[dtype]
    if to_output and dtype == torch.bfloat16:
        atol = tol * min(1.0, float(w.abs().max()))
    check(bool(torch.isfinite(g).all()) and torch.allclose(g, w, atol=atol,
                                                            rtol=tol),
          f"{name} differs from the plain version at {case} {dtype}: max "
          f"abs err {err} (tolerance {atol} + {tol} relative)")
    return err


def _kernel_case(name: str, a: dict) -> tuple:
    """A call to one of LLM_KERNELS' wrappers, its arguments ``a`` by
    name, as the case it makes: the kernel, its shape (RMSNorm's rows
    folded into one axis), dtypes and options. Decode attention's cache
    length is left out: on the paths it is a device scalar, which
    reading would synchronise."""
    if name == "rmsnorm":
        x = a["x"]
        return (name, x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                a["gamma"].dtype, float(a["eps"]))
    q = a["q"]
    if name == "flash_attention":
        B, S, H, D = q.shape
        return (name, B, S, H, a["k"].shape[2], D, q.dtype, a["causal"],
                a["window"])
    B, _, H, D = q.shape
    _, Hkv, L, _ = a["k_cache"].shape
    return (name, B, H, Hkv, L, D, q.dtype)


def _llm_case(case: tuple, gen, dev, ns=()) -> float:
    """One case (``_kernel_case``) on fresh random inputs, the wrapper
    against its plain version (``_llm_check``); decode attention at each
    cache length of ``ns`` (by default 1, half of L and L), its caches a
    slice of a stack as a superblock's are. Adds the case to PARITY_DONE
    and returns the max abs error."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    name = case[0]
    if name == "rmsnorm":
        rows, D, dtype, g_dtype, eps = case[1:]
        x = _randn(gen, (rows, D), dtype, dev)
        g = _randn(gen, (D,), g_dtype, dev)
        err = _llm_check(name, rn.rmsnorm(x, g, eps),
                         rn.rmsnorm_plain(x, g, eps), dtype, case)
    elif name == "flash_attention":
        B, S, H, Hkv, D, dtype, causal, window = case[1:]
        q = _randn(gen, (B, S, H, D), dtype, dev)
        k = _randn(gen, (B, S, Hkv, D), dtype, dev)
        v = _randn(gen, (B, S, Hkv, D), dtype, dev)
        err = _llm_check(name, fa.flash_attention(q, k, v, causal, window),
                         fa.flash_attention_plain(q, k, v, causal, window),
                         dtype, case)
    else:
        B, H, Hkv, L, D, dtype = case[1:]
        q = _randn(gen, (B, 1, H, D), dtype, dev)
        kc = _randn(gen, (2, B, Hkv, L, D), dtype, dev)[1]
        vc = _randn(gen, (2, B, Hkv, L, D), dtype, dev)[1]
        err = 0.0
        for n in ns or sorted({1, (L + 1) // 2, L}):
            nd = torch.full((), n, dtype=torch.int32, device=dev)
            err = max(err, _llm_check(
                name, da.decode_attention(q, kc, vc, nd),
                da.decode_attention_plain(q, kc, vc, nd), dtype,
                case + (n,), to_output=True))
    PARITY_DONE.add(case)
    return err


def phase_llm_parity(dev):
    """The serve and train paths' three kernels against their plain
    versions at RMSNORM_CASES, FLASH_CASES and DECODE_CASES, in float32
    and bfloat16; returns the max abs errors in bf16 at the paths' own
    shapes (each kernel's under its name at mistral-nemo's)."""
    gen = torch.Generator().manual_seed(2)
    bf = torch.bfloat16
    labels = {
        ("rmsnorm", SERVE_BATCH * SERVE_PROMPT, 5120): "rmsnorm",
        ("rmsnorm", SERVE_BATCH * WHISPER_FRAMES, 384):
            "rmsnorm whisper encoder",
        ("flash_attention", SERVE_BATCH, SERVE_PROMPT, 32, 8, 128):
            "flash_attention",
        ("flash_attention", SERVE_BATCH, SERVE_PROMPT, 32, 32, 80):
            "flash_attention D80",
        ("flash_attention", SERVE_BATCH, SERVE_PROMPT, 16, 16, 128):
            "flash_attention G1 D128",
        ("flash_attention", TRAIN_BATCH, TRAIN_SEQ, 16, 8, 64):
            "flash_attention granite-moe train",
        ("decode_attention", SERVE_BATCH, 32, 8, SERVE_CACHE, 128):
            "decode_attention",
        ("decode_attention", SERVE_BATCH, 32, 32, SERVE_CACHE, 80):
            "decode_attention D80",
        ("decode_attention", SERVE_BATCH, 16, 16, SERVE_CACHE, 128):
            "decode_attention G1 D128",
        ("decode_attention", SERVE_BATCH, 6, 6, WHISPER_FRAMES, 64):
            "decode_attention L1500",
        ("decode_attention", SERVE_BATCH, 32, 8, 1601, 128):
            "decode_attention L1601"}
    errs = {}
    for dtype in (torch.float32, bf):
        cases = [(("rmsnorm", rows, D, dtype, torch.float32, 1e-5), ())
                 for rows, D in RMSNORM_CASES]
        cases += [(("flash_attention", *shape, dtype, True, window), ())
                  for shape in FLASH_CASES for window in (None, 64)
                  if window is None or shape[1] < SERVE_PROMPT]
        cases += [(("decode_attention", *shape, dtype), ns)
                  for shape, ns in DECODE_CASES]
        for case, ns in cases:
            err = _llm_case(case, gen, dev, ns)
            label = labels.get(case[:case.index(dtype)])
            if dtype == bf and label is not None and (
                    case[0] != "flash_attention" or case[-1] is None):
                errs[label] = err
    n_bounds = _decode_split_boundaries(gen, dev)
    _attention_bitwise(gen, dev)
    say("parity rmsnorm, flash_attention, decode_attention: within 2e-4 "
        "(float32) and 2e-2 (bfloat16; decode attention's absolute part "
        "scaled by its output's largest magnitude below 1) at "
        f"{len(RMSNORM_CASES)} RMSNorm (rows, D) (prefill and decode rows at "
        "widths 5120, 4096, 2560, 2048, 1536, 1024, 768 and 384, whisper's "
        "encoder and prompt, the train paths' rows, ragged and scalar "
        f"rows), {len(FLASH_CASES)} flash attention shapes (edge cases, "
        "the serve paths' prefills, qwen2-moe's G 1 at D 128, whisper's, "
        "the train paths'; window 64 below S 1024) and "
        f"{len(DECODE_CASES)} decode attention shapes (cache_len 1, 517, "
        "1088, a wrapped ring, zamba2's, qwen2-moe's, whisper's self cache, "
        "the cross caches L 1500 at D 64 and G 1 and L 1601 at G 4), and "
        f"{n_bounds} cache lengths at the decode split's boundaries; max "
        "abs err in bf16 at the paths' shapes: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# the attention shapes of the serve paths' prefills: mistral-nemo-12b
# and llama-3.2-vision-11b (GQA 4, D 128), zamba2-2.7b's shared attention
# (H = Hkv = 32, D 80) and qwen2-moe-a2.7b (H = Hkv = 16, D 128)
ATTN_PATHS = {"mistral": (SERVE_BATCH, 32, 8, 128),
              "zamba2": (SERVE_BATCH, 32, 32, 80),
              "qwen2-moe": (SERVE_BATCH, 16, 16, 128)}


def _decode_split_boundaries(gen, dev) -> int:
    """Decode attention (bf16) at the paths' shapes with cache_len on and
    around each boundary of the split the kernel picks for L = 1088, for
    a 16-slot ring and for the cross caches, against the plain version
    and the emulation of the kernel's split and combine. Returns the
    number of cases."""
    from repro_torch.kernels import decode_attention as da
    bf = torch.bfloat16
    cases = 0
    shapes = [(*shape, L) for shape in ATTN_PATHS.values()
              for L in (SERVE_CACHE, RING_WINDOW)] + list(CROSS_CACHES)
    for B, H, Hkv, D, L in shapes:
        splits, chunk = da.kernel_split_plan(B, H, Hkv, L, D, bf)
        check(chunk == da.split_chunk(L, splits),
              f"decode split of L={L}: chunk {chunk}, the emulation's "
              f"{da.split_chunk(L, splits)}")
        q = _randn(gen, (B, 1, H, D), bf, dev)
        kc = _randn(gen, (B, Hkv, L, D), bf, dev)
        vc = _randn(gen, (B, Hkv, L, D), bf, dev)
        lens = {1, L - 1, L, L + 5}
        for i in range(1, splits):
            lens |= {i * chunk - 1, i * chunk, i * chunk + 1}
        for n in sorted(lens):
            nd = torch.full((), n, dtype=torch.int32, device=dev)
            case = (B, H, Hkv, L, D, n, f"splits {splits}")
            _llm_check("decode_attention", da.decode_attention(
                q, kc, vc, nd), da.decode_attention_plain(q, kc, vc, nd),
                bf, case, to_output=True)
            _llm_check("decode_attention (emulated split)",
                       da.decode_attention(q, kc, vc, nd),
                       da.decode_attention_split(q, kc, vc, n, splits),
                       bf, case, to_output=True)
            cases += 1
    return cases


def _attention_bitwise(gen, dev) -> None:
    """Two launches of each attention kernel on the same inputs give the
    same bits, at the serve paths' shapes (bf16)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    L = SERVE_CACHE
    for name, (B, H, Hkv, D) in ATTN_PATHS.items():
        q = _randn(gen, (B, SERVE_PROMPT, H, D), bf, dev)
        k = _randn(gen, (B, SERVE_PROMPT, Hkv, D), bf, dev)
        v = _randn(gen, (B, SERVE_PROMPT, Hkv, D), bf, dev)
        check(torch.equal(fa.flash_attention(q, k, v, True, None),
                          fa.flash_attention(q, k, v, True, None)),
              f"flash_attention differs between two launches ({name})")
        qd = _randn(gen, (B, 1, H, D), bf, dev)
        kc = _randn(gen, (B, Hkv, L, D), bf, dev)
        vc = _randn(gen, (B, Hkv, L, D), bf, dev)
        nd = torch.full((), L - 3, dtype=torch.int32, device=dev)
        check(torch.equal(da.decode_attention(qd, kc, vc, nd),
                          da.decode_attention(qd, kc, vc, nd)),
              f"decode_attention differs between two launches ({name})")
    say("determinism: flash and decode attention bitwise equal over two "
        f"launches at the serve paths' shapes ({', '.join(ATTN_PATHS)}; "
        "bf16)")


@contextlib.contextmanager
def _recorded_calls():
    """While open, records the case (``_kernel_case``) of every call to
    one of LLM_KERNELS on a CUDA tensor in PATH_CASES and counts it in
    PATH_CALLS, at the ``kernels/ops`` entry points by which every model
    module calls them (the comparisons here call the kernels' own
    modules, and are not recorded)."""
    import inspect
    from repro_torch.kernels import ops
    originals = {name: getattr(ops, name) for name in LLM_KERNELS}

    def recording(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            if args[0].is_cuda:
                PATH_CASES.add(_kernel_case(name, a.arguments))
                PATH_CALLS[name] += 1
            return fn(*args, **kw)
        return call
    for name, fn in originals.items():
        setattr(ops, name, recording(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


def _all_calls_recorded(launches: dict, label: str) -> None:
    check(all(PATH_CALLS[n] == launches[n] for n in LLM_KERNELS),
          f"{label}: calls recorded {PATH_CALLS}, launches {launches}")


def phase_path_parity(dev) -> None:
    """Phase 26: every case the paths of phases 8-25 gave the three LLM
    kernels (``_recorded_calls``) that phase 3 did not hold, held against
    the plain version on fresh random inputs, decode attention at cache
    lengths 1, half of L and L."""
    gen = torch.Generator().manual_seed(26)
    todo = sorted(PATH_CASES - PARITY_DONE, key=repr)
    check(len(PATH_CASES) > 0, "no call of the LLM kernels was recorded")
    lines = [f"  {c[0]} {c[1:]}: max abs err {_llm_case(c, gen, dev):.3e}"
             for c in todo]
    per = {n: sum(c[0] == n for c in PATH_CASES) for n in LLM_KERNELS}
    say(f"parity at the paths' cases: {len(PATH_CASES)} cases launched on "
        f"the paths of phases 8-25 ({per}), {len(PATH_CASES) - len(todo)} "
        f"held in phase 3, the other {len(todo)} held here against the "
        "plain version (2e-4 float32, 2e-2 bfloat16):")
    for line in lines:
        say(line)


def _library(fn):
    """A PyTorch yardstick call, timed with deterministic algorithms off
    (it is no part of the port)."""
    torch.use_deterministic_algorithms(False)
    try:
        return time_ms(fn, runs=50)
    finally:
        torch.use_deterministic_algorithms(True)


def phase_llm_times(dev):
    """Kernel, plain and yardstick times of the serve path's kernels at
    its shapes (bf16), with the bytes and operations the bound counts."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    out = {}
    # rmsnorm at the prefill's rows: read x once, write once, read gamma;
    # 4 float32 operations per element (square-add, two products, and the
    # cast), on the f32 units
    # at the decode step's rows too (5103 of a mistral run's 5184 launches)
    for rows, D in ((SERVE_BATCH * SERVE_PROMPT, 5120), (SERVE_BATCH, 5120)):
        x = _randn(gen, (rows, D), bf, dev)
        g = _randn(gen, (D,), torch.float32, dev)
        g16 = g.to(bf)
        k_ms = time_ms(lambda: rn.rmsnorm(x, g, 1e-5))
        p_ms = time_ms(lambda: rn.rmsnorm_plain(x, g, 1e-5), runs=50)
        l_ms = _library(lambda: F.rms_norm(x, (D,), g16, 1e-5))
        name = "rmsnorm" if rows > SERVE_BATCH else "rmsnorm decode"
        out[name] = (k_ms, p_ms, l_ms, 2 * rows * D * 2 + D * 4,
                     4 * rows * D, PEAK_F32_PER_S, (rows, D))
        say(f"rmsnorm plan at ({rows}, {D}) bf16: "
            f"{rn.rmsnorm_plan(rows, D, 2)}")
        del x
    # flash attention at the prefill: q, k, v read once, out written once;
    # the causal triangle needs 4 D operations per (query, key) pair (QK^T
    # and PV), in bf16 on the tensor cores
    B, S, H, Hkv, D = SERVE_BATCH, SERVE_PROMPT, 32, 8, 128
    q = _randn(gen, (B, S, H, D), bf, dev)
    k = _randn(gen, (B, S, Hkv, D), bf, dev)
    v = _randn(gen, (B, S, Hkv, D), bf, dev)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_ms = time_ms(lambda: fa.flash_attention(q, k, v, True, None), runs=50)
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, None),
                   runs=20)
    l_ms = _library(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    out["flash_attention"] = (k_ms, p_ms, l_ms,
                              (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2,
                              4 * D * B * H * S * (S + 1) // 2,
                              PEAK_BF16_PER_S, (B, S, H, Hkv, D))
    del q, k, v, qh, kh, vh
    # decode attention at the last decode step: q read and out written
    # once, the n valid rows of both caches read once; 4 D operations per
    # (query head, position)
    L = n = SERVE_PROMPT + SERVE_GEN
    q = _randn(gen, (B, 1, H, D), bf, dev)
    kc = _randn(gen, (B, Hkv, L, D), bf, dev)
    vc = _randn(gen, (B, Hkv, L, D), bf, dev)
    nd = torch.full((), n, dtype=torch.int32, device=dev)
    mask = (torch.arange(L, device=dev) < nd).reshape(1, 1, 1, L)
    qh = q.transpose(1, 2).contiguous()
    k_ms = time_ms(lambda: da.decode_attention(q, kc, vc, nd))
    p_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, nd), runs=50)
    l_ms = _library(lambda: F.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=mask, enable_gqa=True))
    out["decode_attention"] = (k_ms, p_ms, l_ms,
                               (2 * B * H * D + 2 * B * Hkv * n * D) * 2 + 4,
                               4 * D * B * H * n, PEAK_BF16_PER_S,
                               (B, H, Hkv, L, D, n))
    del q, kc, vc
    for name, (k_ms, p_ms, l_ms, nbytes, nops, peak, shape) in out.items():
        bound = max(nbytes / PEAK_BYTES_PER_S, nops / peak) * 1e3
        say(f"time {name} at {shape} bf16: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms (kernel / library "
            f"{k_ms / l_ms:.3f}), bound {bound:.6f} ms, {nbytes} bytes, "
            f"{nops} operations")
    return out


def _scan_inputs(gen, B, S, H, P, N, dtype, dev):
    """SSD scan inputs as the model hands them over: x, Bm and Cm are
    slices of one (B, S, H P + 2 N) conv output, dt is a softplus and A
    negative."""
    import torch.nn.functional as F
    conv = _randn(gen, (B, S, H * P + 2 * N), dtype, dev)
    x = conv[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = conv[..., H * P: H * P + N], conv[..., H * P + N:]
    dt = F.softplus(_randn(gen, (B, S, H), torch.float32, dev))
    A = -torch.exp(_randn(gen, (H,), torch.float32, dev))
    return x, dt, A, Bm, Cm


def _slstm_inputs(gen, B, S, H, Pd, dtype, dev, warm: bool):
    """sLSTM scan inputs: wx, R scaled by Pd^-1/2 (the model's init), b,
    and the initial state (0, 0, 0, -1e9) or a random warm one."""
    d = H * Pd
    wx = _randn(gen, (B, S, 4 * d), dtype, dev)
    R = _randn(gen, (4, H, Pd, Pd), torch.float32, dev) / Pd ** 0.5
    b = 0.1 * _randn(gen, (4 * d,), torch.float32, dev)
    if warm:
        f = [_randn(gen, (B, d), torch.float32, dev) for _ in range(4)]
        state = (f[0], 1.0 + f[1].abs(), torch.tanh(f[2]), f[3])
    else:
        z = torch.zeros((B, d), device=dev)
        state = (z, z, z, torch.full((B, d), -1e9, device=dev))
    return wx, R, b, state


def phase_scan_parity(dev):
    """The SSD scan and the sLSTM scan against their plain versions, in
    float32 and bfloat16; returns each one's max abs error in bf16 at its
    path's shapes (the larger of the output's and the final state's)."""
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator().manual_seed(5)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in (SSM_PATH, (2, 384, 4, 64, 64, 128),
                     (1, 100, 2, 64, 64, 128), (2, 64, 3, 16, 8, 16),
                     (1, 2304, 2, 64, 64, 128),   # 18 chunks, 8 or 16 ranks
                     (2, 192, 12, 64, 64, 64)):   # L 64, 8 + 4 heads
            B, S, H, P, N, chunk = case
            L = min(chunk, S)
            plan = ss.kernel_plan(B, S, H, P, N, L, dtype)
            want = ("cluster" if dtype == torch.bfloat16 and P == N == 64
                    and L % 16 == 0 else "scalar")
            check(plan.body == want, f"ssm_scan at {case} {dtype} takes "
                  f"{plan}, expected the {want} body")
            x, dt, A, Bm, Cm = _scan_inputs(gen, B, S, H, P, N, dtype, dev)
            y, h = ss.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
            y_p, h_p = ss.ssm_scan_plain(x, dt, A, Bm, Cm)
            ey = _llm_check("ssm_scan y", y, y_p, dtype, case)
            eh = _llm_check("ssm_scan state", h, h_p, dtype, case)
            if case == SSM_PATH and dtype == torch.bfloat16:
                errs["ssm_scan"] = max(ey, eh)
                say(f"parity ssm_scan at {case} bf16: max abs err y {ey:.3e}, "
                    f"state {eh:.3e}")
            del x, dt, Bm, Cm, y, h, y_p, h_p
        for case in (SLSTM_PATH + (False,), (3, 37, 4, 192, True),
                     (11, 20, 2, 32, True), (2, 1, 4, 8, False),
                     (20, 9, 4, 192, True),     # three batch tiles
                     (2, 16, 4, 512, True)):    # the stream body
            B, S, H, Pd, warm = case
            wx, R, b, st = _slstm_inputs(gen, B, S, H, Pd, dtype, dev, warm)
            plan = sl.kernel_plan(B, H, Pd, dtype)
            want = "stream" if Pd in (8, 512) else "cluster"
            check(plan.body == want, f"slstm_scan at {case} takes {plan}, "
                  f"expected the {want} body")
            hs, st_k = sl.slstm_scan(wx, R, b, st, H)
            hs_p, st_p = sl.slstm_scan_plain(wx, R, b, st, H)
            eh = _llm_check("slstm_scan hs", hs, hs_p, dtype, case)
            es = max(_llm_check("slstm_scan state", a, e, dtype, case)
                     for a, e in zip(st_k, st_p))
            if case[:4] == SLSTM_PATH and dtype == torch.bfloat16:
                errs["slstm_scan"] = max(eh, es)
                say(f"parity slstm_scan at {case[:4]} bf16: max abs err hs "
                    f"{eh:.3e}, state {es:.3e}")
    _ssd_bitwise(gen, dev)
    _slstm_bitwise(gen, dev)
    say("parity ssm_scan, slstm_scan: within 2e-4 (float32) and 2e-2 "
        "(bfloat16) at the recurrent paths' shapes, 3 and 18 chunks, a "
        "chunk of 64 over 12 heads, S = 100 below the chunk, small heads "
        "(the cluster body in bf16 at P = N = 64, else the scalar body); "
        "S = 37, 20, 9 and 1, two and three batch tiles, warm states, the "
        "stream body at Pd 512 and 8")
    return errs


def _ssd_bitwise(gen, dev) -> None:
    """The SSD plan at the path's shape, and two launches there giving the
    same bits (bf16), final state included."""
    from repro_torch.kernels import ssm_scan as ss
    B, S, H, P, N, L = SSM_PATH
    bf = torch.bfloat16
    plan = ss.kernel_plan(B, S, H, P, N, L, bf)
    card = ss._lib().ssm_scan_smem(1, plan.heads)
    active = ss.max_active_clusters(plan.ranks, plan.heads)
    say(f"ssd plan at {SSM_PATH} bf16: body {plan.body}, cluster of "
        f"{plan.ranks} blocks (one per chunk), {plan.heads} heads per block, "
        f"{plan.smem_bytes} bytes of shared memory per block (the card's own "
        f"count for it: {card}), cudaOccupancyMaxActiveClusters {active} for "
        f"{B * -(-H // plan.heads)} clusters")
    check(plan.body == "cluster" and plan.ranks == S // L
          and plan.smem_bytes == card,
          f"ssm_scan's plan at {SSM_PATH}: {plan}, the card counts {card} "
          f"bytes")
    x, dt, A, Bm, Cm = _scan_inputs(gen, B, S, H, P, N, bf, dev)
    ya, ha = ss.ssm_scan(x, dt, A, Bm, Cm, chunk=L)
    yb, hb = ss.ssm_scan(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    check(torch.equal(ya, yb) and torch.equal(ha, hb),
          "ssm_scan differs between two launches at the path's shape")
    say("determinism: ssm_scan bitwise equal over two launches at "
        f"{SSM_PATH} bf16, final state included")


def _slstm_bitwise(gen, dev) -> None:
    """The sLSTM plan at the path's shape, and two launches there giving
    the same bits (bf16, a warm state)."""
    from repro_torch.kernels import slstm_scan as sl
    B, S, H, Pd = SLSTM_PATH
    bf = torch.bfloat16
    plan = sl.kernel_plan(B, H, Pd, bf)
    active = sl.max_active_clusters(Pd, plan.ranks, plan.splits, bf)
    say(f"slstm plan at {SLSTM_PATH} bf16: body {plan.body}, cluster of "
        f"{plan.ranks} blocks, {plan.splits} slices of the Pd rows, "
        f"{plan.smem_bytes} bytes of shared memory per block (the card's "
        f"own count for it: {sl._lib().slstm_scan_smem(1, Pd, plan.ranks, plan.splits, 1)}), "
        f"cudaOccupancyMaxActiveClusters {active} for "
        f"{H * -(-B // sl.BT)} clusters")
    check(plan.body == "cluster" and plan.ranks >= 8 and plan.smem_bytes
          == sl._lib().slstm_scan_smem(1, Pd, plan.ranks, plan.splits, 1),
          f"slstm_scan's plan at {SLSTM_PATH}: {plan}")
    wx, R, b, st = _slstm_inputs(gen, B, S, H, Pd, bf, dev, True)
    a, sa = sl.slstm_scan(wx, R, b, st, H)
    c, sc = sl.slstm_scan(wx, R, b, st, H)
    torch.cuda.synchronize()
    check(torch.equal(a, c) and all(torch.equal(x, y) for x, y in zip(sa, sc)),
          "slstm_scan differs between two launches at the path's shape")
    say("determinism: slstm_scan bitwise equal over two launches at "
        f"{SLSTM_PATH} bf16, final state included")


def phase_scan_times(dev):
    """Kernel and plain times of the SSD and sLSTM scans at their paths'
    shapes (bf16), with the bytes and operations the bound counts (no
    single PyTorch call computes either op); then flash and decode
    attention at zamba2's head dim 80, beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator().manual_seed(6)
    bf = torch.bfloat16
    out = {}
    # SSD scan: x, Bm, Cm (bf16), dt and A read once, y (bf16) and the
    # state written once. Operations: the chunked form needs C B^T once
    # per (b, chunk) over the L(L+1)/2 causal pairs (2N each), and per
    # (b, h, chunk) W x over those pairs (2P each), C h_prev and the
    # state update (2 L P N each); the sequential recurrence needs 5 P N
    # per token and head (decay, dt x B^T, add, C h). The bound counts
    # the fewer of the two at the bf16 tensor-core peak, which the
    # cluster body's products run on; the float32 peak's figure beside it
    # is the bound of earlier runs.
    B, S, H, P, N, L = SSM_PATH
    x, dt, A, Bm, Cm = _scan_inputs(gen, B, S, H, P, N, bf, dev)
    k_ms = time_ms(lambda: ss.ssm_scan(x, dt, A, Bm, Cm, chunk=L), runs=50)
    p_ms = time_graph_ms(lambda: ss.ssm_scan_plain(x, dt, A, Bm, Cm))
    nbytes = ((2 * B * S * H * P + 2 * B * S * N) * 2 + B * S * H * 4
              + H * 4 + B * H * P * N * 4)
    pairs = L * (L + 1) // 2
    nops = min(B * (S // L) * pairs * 2 * N
               + B * H * (S // L) * (pairs * 2 * P + 4 * L * P * N),
               B * S * H * 5 * P * N)
    out["ssm_scan"] = (k_ms, p_ms, None, nbytes, nops, PEAK_BF16_PER_S)
    say(f"bound ssm_scan at {SSM_PATH} bf16: bytes "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.6f} ms, operations "
        f"{nops / PEAK_BF16_PER_S * 1e3:.6f} ms at the bf16 peak "
        f"({nops / PEAK_F32_PER_S * 1e3:.6f} ms at the float32 peak)")
    del x, dt, Bm, Cm
    # sLSTM scan: wx (bf16), R, b and the state read once, hs (bf16) and
    # the state written once; per row and step the recurrent product
    # (2 x 4d x Pd) and ~30 float32 operations per unit for the gates
    B, S, H, Pd = SLSTM_PATH
    d = H * Pd
    wx, R, b, st = _slstm_inputs(gen, B, S, H, Pd, bf, dev, False)
    k_ms = time_ms(lambda: sl.slstm_scan(wx, R, b, st, H), runs=20)
    p_ms = time_graph_ms(lambda: sl.slstm_scan_plain(wx, R, b, st, H))
    nbytes = (B * S * 4 * d * 2 + 4 * H * Pd * Pd * 4 + 4 * d * 4
              + 8 * B * d * 4 + B * S * d * 2)
    nops = B * S * (2 * 4 * d * Pd + 30 * d)
    out["slstm_scan"] = (k_ms, p_ms, None, nbytes, nops, PEAK_F32_PER_S)
    # its serial floor: the path's S steps of the cluster body's h
    # exchange (DSMEM stores) and cluster barrier alone
    plan = sl.kernel_plan(B, H, Pd, bf)
    f_ms = time_ms(lambda: sl.exchange_floor(B, S, H, Pd, plan, dev),
                   runs=20)
    say(f"time slstm_scan serial floor at {SLSTM_PATH} ({plan.ranks} "
        f"ranks): {S} steps of DSMEM exchange and cluster barrier alone "
        f"{f_ms:.4f} ms ({1e3 * f_ms / S:.3f} us a step); the scan "
        f"{1e3 * k_ms / S:.3f} us a step")
    del wx
    for name, (k_ms, p_ms, _, nbytes, nops, peak) in out.items():
        kind = "bf16 tensor-core" if peak == PEAK_BF16_PER_S else "f32"
        say(f"time {name} at {SSM_PATH if name == 'ssm_scan' else SLSTM_PATH}"
            f" bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"none, {nbytes} bytes, {nops} {kind} operations")
    # zamba2's shared attention: H = Hkv = 32, D 80 (flash attention's
    # wgmma body with a 64 + 16 column split; decode attention with one
    # query head per KV head)
    Bq, Sq, Hq, D = SERVE_BATCH, SERVE_PROMPT, 32, 80
    q = _randn(gen, (Bq, Sq, Hq, D), bf, dev)
    k = _randn(gen, (Bq, Sq, Hq, D), bf, dev)
    v = _randn(gen, (Bq, Sq, Hq, D), bf, dev)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_ms = time_ms(lambda: fa.flash_attention(q, k, v, True, None), runs=20)
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, None),
                   runs=10)
    l_ms = _library(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    nbytes = 4 * Bq * Sq * Hq * D * 2
    nops = 4 * D * Bq * Hq * Sq * (Sq + 1) // 2
    say(f"time flash_attention at ({Bq}, {Sq}, {Hq}, {Hq}, {D}) bf16: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms (kernel "
        f"/ library {k_ms / l_ms:.3f}), bound "
        f"{max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_PER_S) * 1e3:.4f}"
        f" ms, {nbytes} bytes, {nops} operations")
    del q, k, v, qh, kh, vh
    Lc = n = SERVE_PROMPT + SERVE_GEN
    q = _randn(gen, (Bq, 1, Hq, D), bf, dev)
    kc = _randn(gen, (Bq, Hq, Lc, D), bf, dev)
    vc = _randn(gen, (Bq, Hq, Lc, D), bf, dev)
    nd = torch.full((), n, dtype=torch.int32, device=dev)
    mask = (torch.arange(Lc, device=dev) < nd).reshape(1, 1, 1, Lc)
    qh = q.transpose(1, 2).contiguous()
    k_ms = time_ms(lambda: da.decode_attention(q, kc, vc, nd))
    p_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, nd), runs=50)
    l_ms = _library(lambda: F.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=mask))
    nbytes = (2 * Bq * Hq * D + 2 * Bq * Hq * n * D) * 2 + 4
    nops = 4 * D * Bq * Hq * n
    say(f"time decode_attention at ({Bq}, {Hq}, {Hq}, {Lc}, {D}, {n}) bf16: "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms "
        f"(kernel / library {k_ms / l_ms:.3f}), "
        f"bound {max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_PER_S) * 1e3:.4f}"
        f" ms, {nbytes} bytes, {nops} operations")
    return out


def _kernel_class(name: str) -> str:
    for key, cls in (("flash_fwd", "flash_attention"),
                     ("decode_fwd", "decode_attention"),
                     ("rmsnorm_rows", "rmsnorm"),
                     ("ssd_scan", "ssm_scan"),
                     ("slstm_scan_", "slstm_scan")):
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and other"


def profile_classes(label: str, fn, steps: int = 1) -> None:
    """One torch.profiler capture of ``fn``: wall time, kernel launches
    and device time by kernel class, per step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launch = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"}
    dev, n_launch, by_name = {}, 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            cls = _kernel_class(e.name)
            dev[cls] = dev.get(cls, 0.0) + e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0) + 1
        elif e.name in launch:
            n_launch += 1
    busy = sum(dev.values())
    check(busy <= wall_us, f"{label}: device busy {busy:.0f} us exceeds the "
          f"wall {wall_us:.0f} us")
    say(f"profile {label} (per step, over {steps}; the profiler slows the "
        f"host): wall {wall_us / steps / 1e3:.3f} ms, {n_launch // steps} "
        f"launches, device busy {busy / steps / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}%)"
        if busy > 0 else f"profile {label}: device time not measured (no "
        f"device events recorded)")
    for cls, us in sorted(dev.items(), key=lambda kv: -kv[1]):
        say(f"profile {label} {cls}: {us / steps / 1e3:.3f} ms "
            f"({100 * us / busy:.1f}% of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profile {label} most launched kernels (per step): " + "; ".join(
        f"{n / steps:g} x {name[:60]}" for name, n in top))



def launch_count(label: str, fn) -> dict:
    """Kernel launches, device busy time and wall time of ``fn``, from a
    torch.profiler capture of CUDA activity alone, read from the raw
    events (what ``profile_classes`` reports without its CPU operator
    events and their parsing, ~7x faster at 200k launches)."""
    launch = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"}
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_launch, busy_ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += e.duration_ns()
        elif e.name() in launch:
            n_launch += 1
    busy_ms = busy_ns / 1e6
    check(n_launch > 0 and busy_ms <= wall_ms,
          f"{label}: {n_launch} launches, device busy {busy_ms:.1f} ms in "
          f"{wall_ms:.1f} ms")
    say(f"launches {label} (profiled, CUDA activity only; the profiler "
        f"slows the host): {n_launch} launches, device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.3f} ms wall ({100 * busy_ms / wall_ms:.2f}%)")
    return {"launches": n_launch, "busy_ms": busy_ms, "wall_ms": wall_ms}


def _serve_args(*extra):
    from repro_torch.launch import serve
    return serve.parse_args(["--arch", SERVE_ARCH, *extra])


def _serve_full(arch: str, dev, cfg=None, prompt: int = SERVE_PROMPT,
                gen: int = SERVE_GEN) -> dict:
    """One arch at full width in bf16 through the serve launcher's
    function (batch SERVE_BATCH, a fused prefill and greedy decode), each
    kernel's launches against ``_serve_launches``, then a profile of one
    prefill of fresh prompts and of 4 decode steps going on from the
    run's cache (past its end the slot clamps to the last). ``cfg``: a
    depth cut. Returns the run with its ``launches`` and ``peak_gb``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(serve.parse_args(
        ["--arch", arch, "--no-reduced", "--batch", str(SERVE_BATCH),
         "--prompt-len", str(prompt), "--gen", str(gen)]), cfg=cfg)
    res["launches"] = read_launches()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _all_calls_recorded(res["launches"], f"serve {arch}")
    cfg, toks = res["cfg"], res["tokens"]
    want = _serve_launches(cfg, gen - 1)
    check(res["launches"] == want, f"serve {arch}: launches "
          f"{res['launches']}, expected {want}")
    check(tuple(toks.shape) == (SERVE_BATCH, gen) and toks.dtype ==
          torch.int32 and toks.device.type == "cuda"
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"serve {arch}: generated {toks.dtype} {tuple(toks.shape)} on "
          f"{toks.device}")
    check(bool(torch.isfinite(res["prefill_logits"]).all()),
          f"serve {arch}: non-finite prefill logits")
    for path, t in _paths(res["cache"]["layers"], "cache"):
        check(t.device.type == "cuda" and bool(torch.isfinite(t).all()),
              f"serve {arch}: {path} is not finite on the card")
    check(int(res["cache"]["pos"]) == prompt + gen - 1,
          f"serve {arch}: the cache's position is wrong")
    full = get_config(arch).n_superblocks
    depth = (f"{cfg.n_superblocks} of {full} superblocks"
             if cfg.n_superblocks != full else "full depth")
    say(f"serve {arch} full width, {depth}, bf16 ({res['param_count']} "
        f"parameters), batch {SERVE_BATCH}, prompt {prompt}, {gen} tokens"
        + (f", memory {cfg.cross_memory_len}" if cfg.has_cross_attention
           else "") + f": init {res['init_s']:.2f} s, prefill "
        f"{res['prefill_ms']:.1f} ms, decode {res['decode_ms_per_step']:.2f} "
        f"ms/step, {res['tok_s']:.1f} tok/s, peak memory "
        f"{res['peak_gb']:.2f} GB")
    say(f"serve {arch} launches (prefill + {gen - 1} decode steps): "
        f"{res['launches']}")
    params, ec = res["params"], res["ec"]
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt),
                            generator=torch.Generator().manual_seed(7)
                            ).to(dev)
    profile_classes(f"{arch} prefill", lambda: T.forward(
        cfg, ec, params, prompts, res["memory"],
        collect_cache_len=prompt + gen))
    del prompts
    step = make_serve_step(cfg, ec)
    state = {"cache": res["cache"], "tok": toks[:, -1:]}

    def decode(n=4):
        for _ in range(n):
            state["tok"], state["cache"] = step(params, state["cache"],
                                                state["tok"])
    profile_classes(f"{arch} decode", decode, steps=4)
    return res


def _decode_without_sync(res, label: str, ring: bool = False) -> None:
    """One more decode step with CUDA's sync check turned to errors."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(res["cfg"], res["ec"], ring=ring)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(res["params"], res["cache"], res["tokens"][:, -1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say(f"serve {label} decode step under torch.cuda.set_sync_debug_mode("
        f"'error'): no host synchronisation")


def phase_serve(dev):
    """mistral-nemo-12b at full width, bf16, through the serve launcher's
    functions: a fused prefill and greedy decode (``_serve_full``), then
    a ring run and one ring step under the sync check."""
    from repro_torch.launch import serve
    res = _serve_full(SERVE_ARCH, dev)
    launches, params = res["launches"], res["params"]
    n_sb = res["cfg"].n_superblocks
    del res
    reset_launches()
    ring = serve.run(_serve_args(
        "--no-reduced", "--batch", str(SERVE_BATCH), "--prompt-len",
        str(RING_PROMPT), "--gen", str(RING_GEN), "--window",
        str(RING_WINDOW)), params=params)
    ring_launches = read_launches()
    _all_calls_recorded(ring_launches, f"serve {SERVE_ARCH} ring")
    ring_steps = RING_PROMPT + RING_GEN - 1
    want = {"segment_tree": 0, "categorical_projection": 0,
            "rmsnorm": (2 * n_sb + 1) * ring_steps, "flash_attention": 0,
            "decode_attention": n_sb * ring_steps, "ssm_scan": 0,
            "slstm_scan": 0, "tree_build": 0}
    check(ring_launches == want, f"ring launches {ring_launches}, "
          f"expected {want}")
    check(tuple(ring["tokens"].shape) == (SERVE_BATCH, RING_GEN)
          and int(ring["cache"]["pos"]) == ring_steps,
          "the ring run's tokens or position are wrong")
    say(f"serve ring (window {RING_WINDOW}, prompt {RING_PROMPT}, "
        f"{RING_GEN} tokens, wraps {ring_steps // RING_WINDOW} times): "
        f"{ring['decode_ms_per_step']:.2f} ms/step, launches {ring_launches}")
    _decode_without_sync(ring, f"{SERVE_ARCH} ring", ring=True)
    return launches


def _gated(params) -> None:
    """The VLM's cross-attention gates (drawn as zeros, which would hide
    the cross-attention) set to nonzero values, in place."""
    for block in params["layers"].values():
        if "gate_x" in block:
            n = block["gate_x"].shape[0]
            block["gate_x"].copy_(torch.linspace(
                0.5, -1.0, n, device=block["gate_x"].device).reshape(n, 1))


def _serve_against_cpu(arch: str, prompt: int = 24) -> None:
    """The reduced arch (float32) served on the card and on the CPU:
    equal greedy tokens, prefill logits within 1e-3, two card runs
    bitwise equal, caches included; a fused run and, where the arch has
    attention, a ring run. A MoE arch's routes are first asserted a
    margin of 1e-5 (the k-th router probability over the (k+1)-th, on
    the CPU), and the VLM's gates are set nonzero."""
    from repro_torch import rng
    from repro_torch.config import ExecConfig
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = reduced_config(arch)
    rings = ((), ("--window", "8")) if not cfg.attention_free else ((),)
    worst, margins = 0.0, []
    for extra in rings:
        runs = {}
        for d in ("cpu", "cuda", "cuda again"):
            dev = d.split()[0]
            params = None
            if cfg.family == "vlm":      # the launcher's init, gates set
                params = T.init_params(cfg, rng.PRNGKey(0, device=dev),
                                       ExecConfig(compute_dtype="float32"))
                _gated(params)
            with _router_margins() as seen:
                runs[d] = serve.run(serve.parse_args(
                    ["--arch", arch, "--batch", "4", "--prompt-len",
                     str(prompt), "--gen", "12", "--device", dev, *extra]),
                    params=params)
            if d == "cpu":
                margins += seen
        if cfg.moe is not None:
            check(len(margins) > 0, f"{arch}: no routing was recorded")
            margin = min(margins)
            check(margin > 1e-5, f"{arch}: a router near-tie ({margin:.2e}) "
                  f"on the CPU {extra}")
        check(torch.equal(runs["cpu"]["tokens"], runs["cuda"]["tokens"].cpu()),
              f"{arch}: greedy tokens differ between the card and the CPU "
              f"{extra}")
        again = dict(_paths(runs["cuda again"]["cache"]))
        for path, a in _paths(runs["cuda"]["cache"]):
            check(torch.equal(a, again[path]), f"{arch}: cache{path} differs "
                  f"between two runs on the card {extra}")
        check(torch.equal(runs["cuda"]["tokens"], runs["cuda again"]["tokens"]),
              f"{arch}: tokens differ between two runs on the card {extra}")
        if not extra:
            a = runs["cpu"]["prefill_logits"]
            b = runs["cuda"]["prefill_logits"].cpu()
            worst = float((a - b).abs().max())
            check(torch.allclose(a, b, atol=1e-3, rtol=1e-3),
                  f"{arch}: prefill logits differ between the card and the "
                  f"CPU by {worst}")
    say(f"serve agreement with the CPU path (reduced {arch}, float32, prompt "
        f"{prompt}, {'fused and ring' if len(rings) > 1 else 'fused'}): "
        f"tokens equal, prefill logits within 1e-3 (max {worst:.2e})"
        + (f", router margin {margin:.2e}" if margins else "")
        + "; two runs on the card bitwise equal, caches included")


# ---------------------------------------------------------------------------
# Phases 19-21: kernel gradients, LLM training, the actor-learner
# ---------------------------------------------------------------------------

def _grad_check(name: str, wrapper, plain, inputs, dtype, case) -> float:
    """``wrapper(*inputs)`` (the kernel's wrapper with a gradient, so its
    autograd Function) against ``plain(*inputs)``, both tuples of
    outputs: the forward to LLM_TOL, one launch and none in the backward,
    and the input gradients for one fixed random cotangent bitwise those
    of autograd through the plain version. Returns the forward's max abs
    error."""
    counter = kernel_table()[name][0]
    xs = [t.detach().clone().requires_grad_() for t in inputs]
    ys = [t.detach().clone().requires_grad_() for t in inputs]
    before = counter.launches
    outs = wrapper(*xs)
    check(counter.launches == before + 1,
          f"{name} at {case}: {counter.launches - before} launches, not 1")
    check(all("PlainRecompute" in type(o.grad_fn).__name__ for o in outs),
          f"{name} at {case}: the output does not come from the autograd "
          f"Function ({[type(o.grad_fn).__name__ for o in outs]})")
    want = plain(*ys)
    err = max(_llm_check(name, o.detach(), w.detach(), dtype, case)
              for o, w in zip(outs, want))
    gen = torch.Generator().manual_seed(11)
    cots = [torch.randn(w.shape, generator=gen).to(device=w.device,
                                                   dtype=w.dtype)
            for w in want]
    got = torch.autograd.grad(outs, xs, cots)
    ref = torch.autograd.grad(want, ys, cots)
    torch.cuda.synchronize()
    check(counter.launches == before + 1,
          f"{name} at {case}: the backward launched the kernel")
    for i, (a, b) in enumerate(zip(got, ref)):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{name} at {case} {dtype}: the gradient of input {i} is not "
              f"bitwise the plain version's (max abs diff "
              f"{float((a.float() - b.float()).abs().max())})")
    if dtype == torch.bfloat16 and case in GRAD_TIMED:
        ms = {}
        for label, fn in (("kernel forward + plain backward", wrapper),
                          ("plain forward + backward", plain)):
            runs = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.autograd.grad(fn(*xs), xs, cots)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            ms[label] = statistics.median(runs[1:])
        say(f"gradient {name} at {case} bf16, host clock to a synchronize "
            f"(median of 3 after one): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in ms.items()))
    return err


def phase_kernel_grads(dev) -> None:
    """Phase 19: the four kernels with a backward (flash attention,
    RMSNorm, the SSD scan, the sLSTM scan) through their autograd
    Functions at this slice's shapes, float32 and bfloat16."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import slstm_scan as sl
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator().manual_seed(19)
    B, S = AL_STREAMS, AL_SEQ - 1
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # zamba2's shared attention (32 heads of 80, kv 32) in the
        # learner's forward, and a GQA layout at head dim 128
        for H, Hkv, D in ((32, 32, 80), (32, 8, 128)):
            q = _randn(gen, (B, S, H, D), dtype, dev)
            k = _randn(gen, (B, S, Hkv, D), dtype, dev)
            v = _randn(gen, (B, S, Hkv, D), dtype, dev)
            for window in (None, 16):
                _grad_check(
                    "flash_attention",
                    lambda q, k, v: (fa.flash_attention(q, k, v, True,
                                                        window),),
                    lambda q, k, v: (fa.flash_attention_plain(
                        q, k, v, True, window),),
                    (q, k, v), dtype, (B, S, H, Hkv, D, window))
                n += 1
        for rows, D in ((B * S, 2560), (B * S, 5120),
                        (TRAIN_BATCH * TRAIN_SEQ, 768),
                        (TRAIN_BATCH * TRAIN_SEQ, 1536)):
            x = _randn(gen, (B, rows // B, D), dtype, dev)
            g = 1.0 + 0.1 * _randn(gen, (D,), torch.float32, dev)
            _grad_check("rmsnorm", lambda x, g: (rn.rmsnorm(x, g, 1e-5),),
                        lambda x, g: (rn.rmsnorm_plain(x, g, 1e-5),),
                        (x, g), dtype, (rows, D))
            n += 1
        _grad_check("ssm_scan", lambda *a: ss.ssm_scan(*a, chunk=128),
                    ss.ssm_scan_plain,
                    _scan_inputs(gen, B, S, 80, 64, 64, dtype, dev), dtype,
                    (B, S, 80, 64, 64, "chunk 128"))
        Bt, St, Hs, Pd = TRAIN_BATCH, TRAIN_SEQ, 4, 192
        for warm in (False, True):
            wx, R, b, st = _slstm_inputs(gen, Bt, St, Hs, Pd, dtype, dev,
                                         warm)
            _grad_check(
                "slstm_scan",
                lambda wx, R, b, *st: (lambda hs, s: (hs, *s))(
                    *sl.slstm_scan(wx, R, b, tuple(st), Hs)),
                lambda wx, R, b, *st: (lambda hs, s: (hs, *s))(
                    *sl.slstm_scan_plain(wx, R, b, tuple(st), Hs)),
                (wx, R, b, *st), dtype, (Bt, St, Hs, Pd, "warm" if warm
                                         else "cold"))
        n += 3
    with torch.no_grad():
        q = _randn(gen, (B, S, 32, 80), torch.bfloat16, dev)
        o = fa.flash_attention(q.requires_grad_(), q, q)
    check(o.grad_fn is None, "flash_attention under no_grad recorded a "
          "gradient")
    say(f"kernel gradients: {n} cases (flash attention at D 80 and 128 "
        f"with and without a window, RMSNorm at 4 widths, the SSD scan, "
        f"the sLSTM scan cold and warm; float32 and bfloat16): outputs "
        f"within 2e-4 / 2e-2 of the plain versions, one launch each and "
        f"none in the backward, input gradients bitwise autograd of the "
        f"plain versions")


def _per_kind(cfg) -> dict:
    from repro_torch.config import BLOCK_KINDS
    return {k: cfg.superblock.count(k) * cfg.n_superblocks
            for k in BLOCK_KINDS}


def _forward_launches(cfg) -> dict:
    """Each kernel's launches in one full-sequence forward of ``cfg``:
    one RMSNorm per recurrent block, two per attention block, three per
    cross-attention block, two per encoder layer, the encoder's final
    one and the stack's; one flash attention per (causal) self-attention,
    one scan per Mamba2 or sLSTM block. The encoder's and the
    cross-attention's non-causal attention is plain tensor ops."""
    from repro_torch.config import ATTN, CROSS_ATTN, MAMBA2, SLSTM
    per = _per_kind(cfg)
    encoder = 2 * cfg.n_encoder_layers + 1 if cfg.is_encoder_decoder else 0
    out = dict.fromkeys(kernel_table(), 0)
    out.update(rmsnorm=1 + cfg.n_layers + per[ATTN] + 2 * per[CROSS_ATTN]
               + encoder,
               flash_attention=per[ATTN] + per[CROSS_ATTN],
               ssm_scan=per[MAMBA2], slstm_scan=per[SLSTM])
    return out


def _serve_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in a fused prefill of ``cfg`` and ``steps``
    decode steps: a step's RMSNorms are the forward's but the encoder's,
    and it runs decode attention once per self-attention and once more
    per cross-attention (over the memory's K/V)."""
    from repro_torch.config import ATTN, CROSS_ATTN
    per = _per_kind(cfg)
    out = _forward_launches(cfg)
    step_norms = 1 + cfg.n_layers + per[ATTN] + 2 * per[CROSS_ATTN]
    out["rmsnorm"] += steps * step_norms
    out["decode_attention"] = steps * (per[ATTN] + 2 * per[CROSS_ATTN])
    return out


def _scaled(counts: dict, k: int) -> dict:
    return {name: k * v for name, v in counts.items()}


def _added(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def _leaves_agree(on_cpu, on_card, label: str, rel: float = 1e-3) -> float:
    """Each leaf of a tree from the card within ``rel`` of the CPU's
    leaf's largest magnitude; returns the worst error over that scale."""
    from repro_torch.optim.base import flatten
    card = flatten(on_card)
    worst = 0.0
    for path, a in flatten(on_cpu).items():
        a, b = a.double(), card[path].cpu().double()
        scale = max(float(a.abs().max()), 1e-30)
        e = float((a - b).abs().max()) / scale
        check(e <= rel, f"{label} {'/'.join(path)}: card and CPU differ by "
              f"{e:.2e} of the leaf's largest magnitude")
        worst = max(worst, e)
    return worst


def _params_agree(on_cpu, on_card, lr_sum: float, label: str,
                  rel: float = 1e-3):
    """Parameters from the card against the CPU's after AdamW steps: each
    element within ``rel`` of its leaf's largest magnitude, but at most
    1% of them within 2 lr summed over the steps instead. An AdamW step
    moves an element by about lr whatever its gradient's size, so where a
    gradient is near the noise of its sign, or near eps, rounding turns
    the step; and in a leaf that starts at zero (biases, A_log, dt_bias)
    the largest magnitude is itself only a few lr. Returns (worst error
    over its leaf's scale, elements that took the second bound, all
    elements)."""
    from repro_torch.optim.base import flatten
    card = flatten(on_card)
    worst, moved, total = 0.0, 0, 0
    for path, a in flatten(on_cpu).items():
        a, b = a.double(), card[path].cpu().double()
        err = (a - b).abs()
        scale = max(float(a.abs().max()), 1e-30)
        e = float(err.max()) if err.numel() else 0.0
        check(e <= max(rel * scale, 2 * lr_sum),
              f"{label} {'/'.join(path)}: card and CPU differ by {e} "
              f"(leaf scale {scale})")
        worst = max(worst, e / scale)
        moved += int((err > rel * scale).sum())
        total += err.numel()
    check(moved <= 1e-2 * total, f"{label}: {moved} of {total} elements "
          f"beyond {rel} of their leaf's scale")
    return worst, moved, total


def _train_args(arch: str, *extra):
    from repro_torch.launch import train
    return train.parse_args(["--arch", arch, "--batch", str(TRAIN_BATCH),
                             "--seq", str(TRAIN_SEQ), "--log-every", "1",
                             *extra])


def _train_rerun_bitwise(res, step: int, dev) -> int:
    """Two runs of one train step from the run's final state: bitwise
    equal; returns the number of tensors compared."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import step_memory
    cfg, ec = res["cfg"], res["ec"]
    step_fn, _ = make_train_step(cfg, ec, TrainConfig(
        learning_rate=3e-3, warmup_steps=10, remat=False))
    batch = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH).batch(step,
                                                                 device=dev)
    if cfg.has_cross_attention:
        batch["memory"] = step_memory(cfg, TRAIN_BATCH, step, dev)
    a = step_fn(res["params"], res["opt_state"], batch)
    b = step_fn(res["params"], res["opt_state"], batch)
    torch.cuda.synchronize()
    return _bitwise(a, b, f"{cfg.arch_id} train step between runs: ")


def phase_train(dev) -> dict:
    """Phase 20: the LLM train launcher. Returns each kernel's launches
    per step on the two full-width runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    paths = {}
    # the CLI in a process of its own: xlstm-125m at full width and depth
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--no-reduced", "--steps", str(TRAIN_STEPS),
           "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
           "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    check(res.returncode == 0, f"{' '.join(cmd[2:])} exited "
          f"{res.returncode}:\n{(res.stdout + res.stderr)[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split()[3]) for ln in lines]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train launcher printed {lines}")
    say(f"train launcher {' '.join(cmd[2:])}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; " + "; ".join(lines))
    # through the launcher's function: launches, memory, bitwise reruns
    cut = dataclasses.replace(get_config(AL_ARCH),
                              n_superblocks=AL_SUPERBLOCKS)
    for arch, cfg, steps in ((TRAIN_ARCH, None, TRAIN_STEPS),
                             (AL_ARCH, cut, CUT_TRAIN_STEPS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run = train.run(_train_args(arch, "--no-reduced", "--steps",
                                    str(steps)), cfg=cfg)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = run["cfg"]
        want = _forward_launches(cfg)
        check(launches == _scaled(want, steps), f"train {arch}: launches "
              f"{launches}, expected {steps} x {want} (the forward's; the "
              f"backward launches none)")
        check(all(map(math.isfinite, run["losses"])),
              f"train {arch}: losses {run['losses']}")
        n_params = sum(t.numel() for _, t in _paths(run["params"]))
        depth = (f"{cfg.n_superblocks} of 9 superblocks" if arch == AL_ARCH
                 else "full depth")
        label = f"train {arch} ({depth})"
        paths[label] = {k: v // steps for k, v in launches.items()}
        say(f"{label} full width, bf16 compute, float32 parameters "
            f"({n_params} parameters), batch {TRAIN_BATCH}, seq {TRAIN_SEQ}: "
            f"init {run['init_s']:.2f} s, {run['s_per_step']:.3f} s/step "
            f"over {steps} steps, peak memory {peak_gb:.2f} GB, losses "
            + ", ".join(f"{x:.4f}" for x in run["losses"]))
        say(f"{label} launches per step: {paths[label]}")
        n = _train_rerun_bitwise(run, steps, dev)
        say(f"{label}: two runs of one step from one state bitwise equal "
            f"({n} tensors)")
        del run
    # the card against the CPU on the reduced archs, float32, 2 steps
    for arch in (TRAIN_ARCH, AL_ARCH):
        _train_against_cpu(arch, 2)
    return paths


def _train_against_cpu(arch: str, steps: int) -> None:
    """The reduced arch (float32) trained for ``steps`` steps through the
    launcher's function on the CPU and on the card: losses to 1e-4, the
    first step's AdamW moments (its gradients) to 1e-3 of each leaf's
    largest, the final parameters by ``_params_agree``."""
    from repro_torch.launch import train
    from repro_torch.optim.schedule import warmup_cosine
    lr = warmup_cosine(3e-3, 10, 10_000)
    lr_sum = sum(float(lr(torch.tensor(i + 1))) for i in range(steps))
    runs, first = {}, {}
    for d in ("cpu", "cuda"):
        def keep(i, params, opt_state, d=d):
            if i == 0:       # the first step's moments: its gradients
                first[d] = opt_state
        runs[d] = train.run(_train_args(arch, "--steps", str(steps),
                                        "--device", d), on_step=keep)
    a, b = runs["cpu"]["losses"], runs["cuda"]["losses"]
    check(all(abs(x - y) <= 1e-4 + 1e-4 * abs(x) for x, y in zip(a, b)),
          f"train {arch} reduced: losses {a} on the CPU, {b} on the card")
    g_worst = max(_leaves_agree(first["cpu"][k], first["cuda"][k],
                                f"train {arch} reduced, step 1's {k}")
                  for k in ("m", "v"))
    worst, moved, total = _params_agree(
        runs["cpu"]["params"], runs["cuda"]["params"], lr_sum,
        f"train {arch} reduced")
    say(f"train agreement with the CPU path (reduced {arch}, float32, "
        f"{steps} steps): losses within 1e-4 ({a} / {b}); step 1's AdamW "
        f"moments within 1e-3 of each leaf's largest (max {g_worst:.2e}); "
        f"params after {steps} steps within 1e-3 of each leaf's largest (max "
        f"{worst:.2e}) but for {moved} of {total} elements, within 2 lr")


def _al_want(cfg, al, learner: bool, per_sample: bool) -> dict:
    """Each kernel's launches in one actor-learner cycle: the actor's
    prompt_len + gen_len decode steps, and, where the learner runs, its
    updates' forwards (the backward launches none) and, with
    ``per_sample``, one descent per update, one tree build and one C51
    projection per learner call."""
    from repro_torch.config import ATTN
    from repro_torch.kernels import segment_tree as st
    steps = al.prompt_len + al.gen_len
    attn = cfg.superblock.count(ATTN) * cfg.n_superblocks
    actor = dict.fromkeys(kernel_table(), 0)
    actor.update(rmsnorm=(1 + cfg.n_layers + attn) * steps,
                 decode_attention=attn * steps)
    if not learner:
        return actor
    out = _added(actor, _scaled(_forward_launches(cfg),
                                al.updates_per_cycle))
    if per_sample:
        out["segment_tree"] = al.updates_per_cycle
        out["tree_build"] = len(st.tree_build_plan(
            st.next_pow2(al.replay_capacity)))
        out["categorical_projection"] = 1
    return out


def _al_cycle_line(label, dt, al, m, launches) -> None:
    say(f"{label}: {dt:.3f} s, {al.n_streams * al.gen_len / dt:.1f} "
        f"generated tokens/s, reward {float(m['reward']):.4f}, loss "
        f"{float(m['loss']):.6f}, launches {launches}")


def phase_actor_learner(dev) -> dict:
    """Phase 21: the fused and the disaggregated actor-learner on
    zamba2-2.7b at full width, its depth cut. Returns each kernel's
    launches per cycle on both forms."""
    from repro_torch import rng
    from repro_torch.config import ExecConfig
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.actor_learner import ALConfig, make_actor_learner
    from repro_torch.core.disaggregated import DisaggregatedActorLearner
    from repro_torch.kernels import segment_tree as st
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    paths = {}
    cfg = dataclasses.replace(get_config(AL_ARCH),
                              n_superblocks=AL_SUPERBLOCKS)
    ec = ExecConfig(compute_dtype="bfloat16")
    al = ALConfig()
    n_params = P.param_count(T.model_param_spec(cfg, ec))
    say(f"actor-learner {AL_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, vocab {cfg.vocab}"
        f"), depth cut to {AL_SUPERBLOCKS} of 9 superblocks ("
        f"{AL_SUPERBLOCKS * cfg.superblock.count('mamba2')} Mamba2 blocks, "
        f"{AL_SUPERBLOCKS} calls of the shared attention; {n_params} "
        f"parameters: eager AdamW holds ~9 float32 copies of them at its "
        f"peak), bf16 compute, float32 parameters; {al}")
    # --- fused ------------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init, cycle = make_actor_learner(cfg, ec, al)
    t0 = time.perf_counter()
    carry = init(rng.PRNGKey(0, device=dev))
    torch.cuda.synchronize()
    say(f"actor-learner fused init: {time.perf_counter() - t0:.2f} s")
    want = _al_want(cfg, al, learner=True, per_sample=False)
    for c in range(AL_CYCLES):
        reset_launches()
        t0 = time.perf_counter()
        carry, m = cycle(carry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        check(launches == want, f"fused cycle {c + 1}: launches {launches}, "
              f"expected {want}")
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              f"fused cycle {c + 1}: {m}")
        _al_cycle_line(f"actor-learner fused cycle {c + 1}", dt, al, m,
                       launches)
    paths["actor-learner fused"] = want
    check(int(carry.step) == AL_CYCLES and int(carry.size) == min(
        AL_CYCLES * al.n_streams, al.replay_capacity),
        "fused carry's step or size is wrong")
    seqs = carry.seqs[: AL_CYCLES * al.n_streams]
    check(bool(((seqs >= 0) & (seqs < cfg.vocab)).all()),
          "a generated token lies outside the vocabulary")
    say(f"actor-learner fused peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    a, ma = cycle(carry)
    b, mb = cycle(carry)
    torch.cuda.synchronize()
    n = _bitwise(a, b, "fused cycle between runs: ")
    check(all(torch.equal(ma[k], mb[k]) for k in ma), "fused metrics differ")
    say(f"actor-learner fused: two runs of one cycle from one carry bitwise "
        f"equal ({n} tensors)")
    del carry, a, b
    # --- disaggregated, on two streams of the card ------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alpd = dataclasses.replace(al, prioritized=True, distributional_adv=True)
    t0 = time.perf_counter()
    dal = DisaggregatedActorLearner(cfg, ec, alpd, actor_device=dev,
                                    learner_device=dev)
    torch.cuda.synchronize()
    check(dal.actor_stream is not None and dal.learner_stream is not None,
          "the disaggregated actor-learner did not take two streams")
    say(f"actor-learner disaggregated (prioritized, distributional_adv; "
        f"actor and learner on two streams of the card) init: "
        f"{time.perf_counter() - t0:.2f} s")
    times = []
    for c in range(AL_CYCLES):
        reset_launches()
        t0 = time.perf_counter()
        m = dal.cycle()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        launches = read_launches()
        want = _al_want(cfg, alpd, learner=c > 0, per_sample=True)
        check(launches == want, f"disaggregated cycle {c + 1}: launches "
              f"{launches}, expected {want}")
        check(all(map(math.isfinite, m.values())),
              f"disaggregated cycle {c + 1}: {m}")
        _al_cycle_line(f"actor-learner disaggregated cycle {c + 1}", dt,
                       alpd, m, launches)
    paths["actor-learner disaggregated"] = want
    check(st.tree_build.launches <= 2, "tree_build over 2 launches a call")
    say(f"actor-learner disaggregated peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # its cycle beside the actor alone and the learner alone (a reading)
    key = rng.fold_in(rng.PRNGKey(3, device=dev), dal.step)
    kp, kg, kt = rng.split(key, 3)
    target = {k: v for k, v in dal.params.items()}
    prompts = rng.randint(kp, (alpd.n_streams, alpd.prompt_len), 0,
                          cfg.vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dal._actor(target, prompts, kg)
    torch.cuda.synchronize()
    actor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dal._learner(dal.params, dal.opt_state, dal.seqs, dal.advs, dal.size, kt)
    torch.cuda.synchronize()
    learner_s = time.perf_counter() - t0
    say(f"actor-learner disaggregated: a cycle on two streams "
        f"{statistics.median(times[1:]):.3f} s (median of cycles 2-"
        f"{AL_CYCLES}) beside the actor alone {actor_s:.3f} s + the learner "
        f"alone {learner_s:.3f} s = {actor_s + learner_s:.3f} s")
    del dal
    torch.cuda.empty_cache()
    # --- the card against the CPU on reduced zamba2, float32 --------------
    # the learner's forward takes L - 1 tokens, which the SSD scan's chunk
    # rule (the reference's) needs to be a multiple of reduced zamba2's
    # chunk of 16 (or below it): one more generated token, 8 + 25 - 1 = 32.
    # One update a cycle: reduced zamba2's float32 gradients agree between
    # the card and the CPU to ~2e-4 of a leaf's largest (phase 20), and
    # each further AdamW step at lr 1e-3 turns the elements whose gradient
    # is near that noise, until the parameters part by more than rounding;
    # so the check holds the one real update's moments, its gradient
    rcfg = reduced_config(AL_ARCH)
    ec32 = ExecConfig(compute_dtype="float32")
    al = dataclasses.replace(al, gen_len=al.gen_len + 1, updates_per_cycle=1)
    alpd = dataclasses.replace(alpd, gen_len=al.gen_len, updates_per_cycle=1)
    for label, kw in (("fused", None), ("disaggregated", alpd)):
        ends = {}
        for d in ("cpu", "cuda"):
            if kw is None:
                init, cycle = make_actor_learner(rcfg, ec32, al)
                carry = init(rng.PRNGKey(0, device=d))
                for _ in range(2):
                    carry, _ = cycle(carry)
                ends[d] = (carry.params, carry.opt_state, carry.seqs,
                           int(carry.cursor), int(carry.size),
                           int(carry.step))
            else:
                dal = DisaggregatedActorLearner(rcfg, ec32, kw,
                                                actor_device=d,
                                                learner_device=d)
                for _ in range(2):
                    dal.cycle()
                ends[d] = (dal.params, dal.opt_state, dal.seqs, dal.cursor,
                           dal.size, dal.step)
        cpu, card = ends["cpu"], ends["cuda"]
        check(torch.equal(cpu[2], card[2].cpu()),
              f"actor-learner {label}: tokens differ between the card and "
              f"the CPU")
        check(cpu[3:] == card[3:], f"actor-learner {label}: cursor, size, "
              f"step {cpu[3:]} on the CPU, {card[3:]} on the card")
        g_worst = max(_leaves_agree(cpu[1][k], card[1][k],
                                    f"actor-learner {label} reduced {k}")
                      for k in ("m", "v"))
        worst, moved, total = _params_agree(
            cpu[0], card[0], al.learning_rate,
            f"actor-learner {label} reduced")
        say(f"actor-learner {label} agreement with the CPU path (reduced "
            f"{AL_ARCH}, float32, 2 cycles of one update): tokens equal, "
            f"cursor, size and step equal, AdamW moments within 1e-3 of "
            f"each leaf's largest (max {g_worst:.2e}), params within 1e-3 "
            f"of each leaf's largest (max {worst:.2e}) but for {moved} of "
            f"{total} elements, within 2 lr")
    return paths


# ---------------------------------------------------------------------------
# Phases 22-25: mixture-of-experts and cross-attention
# ---------------------------------------------------------------------------

def _router_margins():
    """A context that records every routing's margin: the gap between
    the k-th and (k+1)-th router probability, its smallest over the
    tokens, in float64 on the routing's device."""
    from repro_torch.models import moe as M
    seen = []
    router = M._router

    def recording(x32, w, m):
        logits = x32.detach().double() @ w.detach().double()
        p = torch.sort(torch.softmax(logits, -1), -1, descending=True)[0]
        seen.append(float((p[:, m.top_k - 1] - p[:, m.top_k]).min()))
        return router(x32, w, m)

    @contextlib.contextmanager
    def ctx():
        M._router = recording
        try:
            yield seen
        finally:
            M._router = router
    return ctx()


def phase_moe_serve(dev) -> dict:
    """Phase 22: qwen2-moe-a2.7b at full width and depth, bf16
    (``_serve_full``), one more decode step under the sync check; reduced
    granite-moe and qwen2-moe against the CPU."""
    res = _serve_full(MOE_SERVE_ARCH, dev)
    _decode_without_sync(res, MOE_SERVE_ARCH)
    launches = res["launches"]
    del res
    for arch in (MOE_TRAIN_ARCH, MOE_SERVE_ARCH):
        _serve_against_cpu(arch)
    return {f"serve {MOE_SERVE_ARCH} (full, per run)": launches}


def _train_full(arch: str, steps: int, dev) -> dict:
    """One arch at full width and depth through the train launcher's
    function (bf16 compute, float32 parameters): finite losses, each
    kernel's launches per step, peak memory, two runs of a step bitwise
    equal. Returns the launches per step and the run's losses."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = train.run(_train_args(arch, "--no-reduced", "--steps", str(steps)))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _all_calls_recorded(launches, f"train {arch}")
    cfg = run["cfg"]
    want = _forward_launches(cfg)
    check(launches == _scaled(want, steps), f"train {arch}: launches "
          f"{launches}, expected {steps} x {want} (the forward's; the "
          f"backward launches none)")
    check(all(map(math.isfinite, run["losses"] + run["ces"])),
          f"train {arch}: losses {run['losses']}, ce {run['ces']}")
    aux = [a - c for a, c in zip(run["losses"], run["ces"])]
    if cfg.moe is not None:
        check(all(a > 0 for a in aux), f"train {arch}: aux {aux} (loss - ce)")
    n_params = sum(t.numel() for _, t in _paths(run["params"]))
    say(f"train {arch} full width and depth, bf16 compute, float32 "
        f"parameters ({n_params} parameters), batch {TRAIN_BATCH}, seq "
        f"{TRAIN_SEQ}: init {run['init_s']:.2f} s, {run['s_per_step']:.3f} "
        f"s/step over {steps} steps, peak memory {peak_gb:.2f} GB, losses "
        + ", ".join(f"{x:.4f}" for x in run["losses"])
        + (", aux (loss - ce) " + ", ".join(f"{x:.5f}" for x in aux)
           if cfg.moe is not None else ""))
    per_step = {k: v // steps for k, v in launches.items()}
    say(f"train {arch} launches per step: {per_step}")
    n = _train_rerun_bitwise(run, steps, dev)
    say(f"train {arch}: two runs of one step from one state bitwise equal "
        f"({n} tensors)")
    return per_step


def phase_moe_train(dev) -> dict:
    """Phase 23: granite-moe-1b-a400m at full width and depth through the
    train launcher's function, then its reduced first step on the card
    against the CPU."""
    per_step = _train_full(MOE_TRAIN_ARCH, MOE_TRAIN_STEPS, dev)
    with _router_margins() as seen:
        _train_against_cpu(MOE_TRAIN_ARCH, 1)
    check(min(seen) > 1e-5, f"{MOE_TRAIN_ARCH}: a router near-tie "
          f"({min(seen):.2e}) in the reduced step")
    say(f"train {MOE_TRAIN_ARCH} reduced: router margin {min(seen):.2e} "
        f"over {len(seen)} routings (CPU and card)")
    return {f"train {MOE_TRAIN_ARCH} (full depth, per step)": per_step}


def phase_cross_serve(dev) -> dict:
    """Phase 24: whisper-tiny at full width and depth (its 1500-frame
    encoder, the decoder's prompt inside its 448-token context) and
    llama-3.2-vision-11b at full width with its 1601-token memory, cut to
    VLM_SUPERBLOCKS of 8 superblocks; reduced whisper and llama against
    the CPU."""
    from repro_torch.configs import get_config
    paths = {}
    res = _serve_full(WHISPER_ARCH, dev, prompt=WHISPER_PROMPT,
                      gen=WHISPER_GEN)
    _decode_without_sync(res, WHISPER_ARCH)
    paths[f"serve {WHISPER_ARCH} (full, per run)"] = res["launches"]
    del res
    cut = dataclasses.replace(get_config(VLM_ARCH),
                              n_superblocks=VLM_SUPERBLOCKS)
    res = _serve_full(VLM_ARCH, dev, cfg=cut)
    paths[f"serve {VLM_ARCH} ({VLM_SUPERBLOCKS} of 8 superblocks, per run)"] \
        = res["launches"]
    del res
    for arch in (WHISPER_ARCH, VLM_ARCH):
        _serve_against_cpu(arch)
    return paths


def phase_cross_train(dev) -> dict:
    """Phase 25: whisper-tiny at full size through the train launcher's
    function, each step with its memory."""
    per_step = _train_full(WHISPER_ARCH, CROSS_TRAIN_STEPS, dev)
    return {f"train {WHISPER_ARCH} (full, per step)": per_step}


# phases 27-29: the cost counter and the roofline on the card (mistral's
# prefill at phase 8's shapes, one qwen2-moe decode step at phase 22's),
# expert parallelism over a 1-rank process group, and the dry run
COST_DECODE_CACHE = SERVE_PROMPT + SERVE_GEN
EP_GEN = 8
DRYRUN_ARCHS = ("mistral-nemo-12b", "qwen2-moe-a2.7b")
DRYRUN_SHAPES = "train_4k,prefill_32k,decode_32k"
# the reference's per-device flops for mistral's prefill and decode
# records (``python -m repro.launch.dryrun --arch mistral-nemo-12b --shape
# prefill_32k,decode_32k --mesh both --moe-impl expert_parallel`` on a
# CPU), the ratio the port's may have to them, and the data-parallel
# ways of each mesh
DRYRUN_REFERENCE = {("prefill_32k", "16x16"): 188026854136610.0,
                    ("prefill_32k", "2x16x16"): 94056382257954.0,
                    ("decode_32k", "16x16"): 22942182820.0,
                    ("decode_32k", "2x16x16"): 11471112288.0}
DRYRUN_RATIO = (0.9, 1.3)
DRYRUN_DATA_WAYS = {"16x16": 16, "2x16x16": 32}
# phase 30: the bf16 DQN run's C and prepopulate, the C of its rerun,
# and pong's episode cap (the eval runs the cap's rounds whatever the
# episodes do: 500 for pong as committed)
BF16_STEPS, BF16_PREPOPULATE, BF16_RERUN_STEPS = 64, 256, 24
BF16_EPISODE_STEPS = 250


def _random_params(cfg, ec, seed: int, dtype=None):
    """A full-size parameter tree on the card, drawn from a seeded
    generator with each leaf's init scale (a fast stand-in for
    ``init_params``: the values do not matter to these phases, only the
    shapes, dtypes and finiteness)."""
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    spec = P.drawn_in(T.model_param_spec(cfg, ec), dtype or ec.cdtype,
                      keep=T.F32_LEAVES)

    def draw(_, leaf):
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device="cuda")
        if leaf.init in ("ones", "const"):
            return torch.full(leaf.shape, 1.0 if leaf.init == "ones"
                              else leaf.value, dtype=leaf.dtype,
                              device="cuda")
        t = torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype,
                        device="cuda")
        return t.mul_(P._scale(leaf))
    return P._build(spec, draw)


def _fake_like(tree, fake_mode):
    """Fake tensors of ``tree``'s leaves' shapes, dtypes and devices."""
    if isinstance(tree, dict):
        return {k: _fake_like(v, fake_mode) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_like(v, fake_mode) for v in tree)
    with fake_mode:
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)


def _count_both(label: str, fn, args) -> dict:
    """``fn(*args)`` under the cost counter on the card's tensors and on
    fake tensors of the same shapes: the two must count the same flops,
    bytes and ops. Returns the card's summary."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.cost import CostCounter
    with torch.no_grad(), CostCounter() as card:
        fn(*args)
    torch.cuda.synchronize()
    fake_mode = FakeTensorMode()
    fake_args = _fake_like(args, fake_mode)
    with torch.no_grad(), fake_mode, CostCounter() as fake:
        fn(*fake_args)
    a, b = card.summary(), fake.summary()
    for key in ("flops", "bytes", "ops", "collectives"):
        check(a[key] == b[key], f"{label}: the counter's {key} on the card "
              f"({a[key]}) differ from fake tensors' ({b[key]})")
    say(f"cost {label}: {a['flops']:.6e} flops, {a['bytes']:.6e} bytes, "
        f"{sum(a['ops'].values())} ops counted, the same on card and fake "
        f"tensors; kernels "
        f"{ {k: v for k, v in a['ops'].items() if k.startswith('kernel.')} }")
    return a


def _roofline_line(label: str, counted: dict, cfg, tokens: int,
                   fn, gpu: str) -> None:
    """The roofline terms of ``counted``, the median of 3 timed calls of
    ``fn`` and the share of the bf16 peak that the useful flops of
    ``tokens`` inference tokens take (``useful_flops``: no more than the
    counter counted)."""
    from repro_torch.roofline.analysis import (HW, mfu, model_flops,
                                               roofline_terms, useful_flops)
    useful = useful_flops(cfg, tokens, "infer")
    reference = model_flops(cfg, tokens, "infer")[0]
    check(0 < useful <= counted["flops"], f"{label}: useful flops "
          f"{useful:.6e} above the counted {counted['flops']:.6e}")
    terms = roofline_terms(counted["flops"], counted["bytes"],
                           counted["collective_bytes"])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    say(f"roofline {label} on {gpu}: compute {terms['compute_s'] * 1e3:.3f}"
        f" ms, memory {terms['memory_s'] * 1e3:.3f} ms (dominant "
        f"{terms['dominant']}; {HW['name']}'s rates); measured "
        f"{s * 1e3:.3f} ms (median of 3: "
        + ", ".join(f"{t * 1e3:.3f}" for t in times)
        + f"); useful flops {useful:.6e} of {counted['flops']:.6e} "
        f"counted (model_flops {reference:.6e}, lookups included); share "
        f"of the bf16 peak {mfu(useful, s):.4f}")


def phase_cost(dev, gpu: str) -> None:
    """Phase 27: the counter on mistral-nemo-12b's prefill (full width,
    bf16, batch 8 x 1024) and on one qwen2-moe-a2.7b decode step (batch
    8 over a 1088-slot cache), each the same on the card's tensors and
    on fake ones, with its roofline terms, time and share of peak."""
    from repro_torch import rng
    from repro_torch.config import ExecConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    ec = ExecConfig(compute_dtype="bfloat16")
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    params = _random_params(cfg, ec, 27)
    batch = {"tokens": rng.randint(rng.PRNGKey(0, device=dev),
                                   (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)}
    step = make_prefill_step(cfg, ec)
    step(params, batch)
    counted = _count_both(f"{SERVE_ARCH} prefill", step, (params, batch))
    check(counted["ops"].get("kernel.flash_attention") == cfg.n_layers,
          f"prefill: flash attention counted {counted['ops']}")
    _roofline_line(f"{SERVE_ARCH} prefill (8 x 1024)", counted, cfg,
                   SERVE_BATCH * SERVE_PROMPT, lambda: step(params, batch),
                   gpu)
    del params, batch
    torch.cuda.empty_cache()
    cfg = get_config(MOE_SERVE_ARCH)
    params = _random_params(cfg, ec, 28)
    cache = T.init_cache(cfg, ec, SERVE_BATCH, COST_DECODE_CACHE,
                         device=dev)
    cache["pos"].fill_(SERVE_PROMPT)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    step = make_serve_step(cfg, ec)

    def decode(p, c, t):
        # the same slot each call: the cache's position moves back
        out = step(p, c, t)
        c["pos"].fill_(SERVE_PROMPT)
        return out
    decode(params, cache, tok)
    counted = _count_both(f"{MOE_SERVE_ARCH} decode step", decode,
                          (params, cache, tok))
    _roofline_line(f"{MOE_SERVE_ARCH} decode step (batch 8, cache "
                   f"{COST_DECODE_CACHE})", counted, cfg, SERVE_BATCH,
                   lambda: decode(params, cache, tok), gpu)
    del params, cache
    torch.cuda.empty_cache()


def _ep_serve(cfg, ec, params, prompts, gen: int):
    """A fused prefill and ``gen - 1`` greedy steps: (tokens, the last
    prompt position's logits)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    with torch.no_grad():
        logits, _, cache = T.forward(cfg, ec, params, prompts,
                                     collect_cache_len=prompts.shape[1] + gen)
        last = logits[:, -1, : cfg.vocab].clone()
        out = [torch.argmax(logits[:, -1:, : cfg.vocab], -1).to(torch.int32)]
        del logits
        step = make_serve_step(cfg, ec)
        for _ in range(gen - 1):
            nxt, cache = step(params, cache, out[-1])
            out.append(nxt)
    return torch.cat(out, 1), last


def phase_expert_parallel(dev) -> None:
    """Phase 28: a 1-rank NCCL group (a FileStore in a temp dir) and a
    (data 1, model 1) mesh. qwen2-moe-a2.7b at full width serves phase
    22's prompts with ``moe_impl="expert_parallel"``: its tokens and
    prefill logits bitwise the scatter run's, one all-reduce a MoE layer
    a step; a granite-moe-1b-a400m gradient (float32 parameters, bf16
    compute) bitwise the scatter path's; ``replica_mesh`` is None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import rng
    from repro_torch.compat import use_mesh
    from repro_torch.config import ExecConfig
    from repro_torch.configs import get_config
    from repro_torch.core.population import replica_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import softmax_cross_entropy
    from repro_torch.optim.base import value_and_grad
    from repro_torch.roofline.cost import CostCounter
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            scatter = ExecConfig(compute_dtype="bfloat16")
            ep = dataclasses.replace(scatter, moe_impl="expert_parallel")
            cfg = get_config(MOE_SERVE_ARCH)
            torch.cuda.empty_cache()
            params = _random_params(cfg, scatter, 28)
            prompts = rng.randint(rng.PRNGKey(0, device=dev),
                                  (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab)
            want = _ep_serve(cfg, scatter, params, prompts, EP_GEN)
            with use_mesh(mesh), CostCounter() as counter:
                got = _ep_serve(cfg, ep, params, prompts, EP_GEN)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  "expert parallel: tokens or logits differ from scatter's "
                  f"(max logit difference "
                  f"{float((got[1].float() - want[1].float()).abs().max())})")
            reduces = counter.ops.get("_c10d_functional.all_reduce", 0)
            n_moe = cfg.n_layers * EP_GEN
            check(reduces == n_moe, f"expert parallel: {reduces} all-reduces,"
                  f" expected {cfg.n_layers} MoE layers x {EP_GEN} steps")
            say(f"expert parallel {MOE_SERVE_ARCH} full width, bf16, batch "
                f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {EP_GEN} tokens on a "
                f"1-rank NCCL mesh (data 1, model 1): tokens and prefill "
                f"logits bitwise the scatter run's; {reduces} all-reduces "
                f"({cfg.n_layers} MoE layers x {EP_GEN} steps, "
                f"{counter.collectives['all-reduce'] / 2:.0f} bytes)")
            del params, prompts, got, want
            torch.cuda.empty_cache()
            cfg = get_config(MOE_TRAIN_ARCH)
            params = _random_params(cfg, scatter, 29, torch.float32)
            g = torch.Generator(device="cuda").manual_seed(29)
            batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH,
                                                            TRAIN_SEQ),
                                             generator=g, device=dev)}
            batch["labels"] = torch.roll(batch["tokens"], -1, 1)
            batch["mask"] = torch.ones((TRAIN_BATCH, TRAIN_SEQ),
                                       device=dev)

            def grads(ec):
                def loss_fn(p, b):
                    logits, aux = T.forward(cfg, ec, p, b["tokens"])
                    ce = softmax_cross_entropy(logits, b["labels"],
                                               cfg.vocab, b["mask"])
                    return ce + aux, ce
                return value_and_grad(loss_fn, params, batch, has_aux=True)
            (l0, _), g0 = grads(scatter)
            with use_mesh(mesh):
                (l1, _), g1 = grads(ep)
            torch.cuda.synchronize()
            pairs = list(zip(_paths(g0), _paths(g1)))
            bad = [pa for (pa, a), (_, b) in pairs if not torch.equal(a, b)]
            check(torch.equal(l0, l1) and not bad,
                  f"expert parallel: {MOE_TRAIN_ARCH} loss {float(l0)} / "
                  f"{float(l1)}, gradients differ at {bad[:4]}")
            say(f"expert parallel {MOE_TRAIN_ARCH} full size (float32 "
                f"parameters, bf16 compute), batch {TRAIN_BATCH} x "
                f"{TRAIN_SEQ}: loss and all {len(pairs)} gradients bitwise "
                "the scatter path's")
            check(replica_mesh(4) is None and replica_mesh(1) is None,
                  "replica_mesh on one card is not None")
            say("replica_mesh(P) on one card: None")
            del params, g0, g1
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()


def _dryrun_start(out: str, *args, env=None) -> tuple:
    """``launch.dryrun`` in a process of its own, writing its records to
    ``out`` and its output to ``out`` + ".log"; stopped at exit if it is
    still running (a failed phase ends the script early)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    with open(out + ".log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
             out, *args], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True)
    atexit.register(_stop, proc)
    return out, proc


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_dryrun_start(d: str) -> list:
    """Phase 29 (LLM grid started): the two archs x 3 shapes x both
    meshes with expert parallelism, one process per arch on one host
    core each (fake tensors: no card work), while phases 8-28 run."""
    return [_dryrun_start(f"{d}/{arch}.json", "--arch", arch, "--shape",
                          DRYRUN_SHAPES, "--mesh", "both", "--moe-impl",
                          "expert_parallel", env={"OMP_NUM_THREADS": "1"})
            for arch in DRYRUN_ARCHS]


def phase_dryrun_dqn(d: str) -> tuple:
    """Phase 29's DQN grid: each preset's cycle on the card under the
    counter, through ``launch.dryrun``'s entry point with --arch dqn in
    this process (the card and the kernels are already up). Returns
    (records file, exit code, its output)."""
    from repro_torch.launch import dryrun
    out = f"{d}/dqn.json"
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = dryrun.main(["--arch", "dqn", "--device", "cuda", "--out", out])
    return out, rc, text.getvalue()


def phase_dryrun_check(runs: list, dqn: tuple) -> None:
    """Phase 29: the LLM grid's processes (``runs``) and the DQN grid
    (``dqn``) exit 0; 12 LLM records and 8 DQN records, none failed,
    each with its per-device costs and dominant term; the PER and C51
    presets count their kernels."""
    done = []
    for out, proc in runs:
        proc.wait(timeout=600)
        done.append((out, proc.returncode, Path(out + ".log").read_text()))
    records = []
    for out, rc, text in [*done, dqn]:
        tail = "\n".join(text.strip().splitlines()[-3:])
        check(rc == 0, f"dry run {out}: exit {rc}: {text[-2000:]}")
        records.extend(json.loads(Path(out).read_text()))
        say(f"dry run {Path(out).stem}: {tail}")
    llm = [r for r in records if r["arch"] != "dqn"]
    dqn = [r for r in records if r["arch"] == "dqn"]
    check(len(llm) == 12 and len(dqn) == 8
          and not any("error" in r for r in records),
          f"dry run: {len(llm)} LLM and {len(dqn)} DQN records, errors "
          f"{[r.get('error') for r in records if 'error' in r]}")
    keys = ("flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "dominant", "hbm_gb_per_device",
            "model_flops_global", "useful_ratio", "trace_s")
    for r in llm:
        check(all(k in r for k in keys) and r["flops_per_device"] > 0,
              f"dry run record {r['arch']} {r['shape']} {r['mesh']}: {r}")
        say(f"dry run {r['arch']} {r['shape']} {r['mesh']}: "
            f"{r['flops_per_device']:.4e} flop/dev, "
            f"{r['bytes_per_device']:.4e} B/dev, coll "
            f"{r['collective_bytes_per_device']:.4e} B/dev, dominant "
            f"{r['dominant']}, {r['hbm_gb_per_device']:.2f} GB/dev, "
            f"useful {r['useful_ratio']:.3f}, trace {r['trace_s']} s")
    for r in llm:
        if (r["arch"] == "mistral-nemo-12b"
                and (r["shape"], r["mesh"]) in DRYRUN_REFERENCE):
            _dryrun_against_reference(r)
    for r in dqn:
        name = r["variant"]
        want = set()
        if name in ("per", "rainbow_lite", "rainbow"):
            want |= {"segment_tree", "tree_build"}
        if name in ("c51", "rainbow"):
            want.add("categorical_projection")
        check(set(r["kernel_calls"]) == want, f"dry run dqn {name}: kernels "
              f"{r['kernel_calls']}, expected {sorted(want)}")
        say(f"dry run dqn {name} (1x1, on the card): "
            f"{r['flops_per_device']:.4e} flop, {r['bytes_per_device']:.4e}"
            f" B, kernels {r['kernel_calls']}, {r['trace_s']} s")


def _dryrun_against_reference(r: dict) -> None:
    """A mistral record's per-device flops against the reference's:
    the ratio within DRYRUN_RATIO, and within 3% with the two differences
    counted out (tests/test_torch_dryrun.py): the port's K and V
    projections over all 8 KV heads on each of 16 model ranks (XLA's
    partitioner computes the one head a rank reads), and the reference's
    attention over every (query, key) pair (the port's flash kernel
    counts the causal pairs)."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    cfg, sc = get_config(r["arch"]), INPUT_SHAPES[r["shape"]]
    ref = DRYRUN_REFERENCE[(r["shape"], r["mesh"])]
    b_loc = sc.global_batch // DRYRUN_DATA_WAYS[r["mesh"]]
    tokens = b_loc * (1 if sc.kind == "decode" else sc.seq_len)
    hd, ways = cfg.resolved_head_dim, 16
    kv = (2 * 2 * tokens * cfg.d_model * (cfg.n_kv_heads - 1) * hd
          * cfg.n_layers if cfg.n_kv_heads % ways else 0)
    S = sc.seq_len
    masked = (0 if sc.kind == "decode" else 4 * hd * b_loc
              * (cfg.n_heads // ways) * cfg.n_layers
              * (S * S - S * (S + 1) // 2))
    port = r["flops_per_device"]
    ratio, attributed = port / ref, (port - kv + masked) / ref
    check(DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1]
          and abs(attributed - 1) <= 0.03,
          f"dry run {r['shape']} {r['mesh']}: {port:.4e} flop/dev against "
          f"the reference's {ref:.4e} ({ratio:.3f}x; {attributed:.3f}x with "
          f"the K/V projections and the masked pairs counted out)")
    say(f"dry run {r['arch']} {r['shape']} {r['mesh']} against the "
        f"reference: {port:.4e} vs {ref:.4e} flop/dev, {ratio:.3f}x "
        f"({attributed:.3f}x with the whole K/V projections, "
        f"{kv:.4e}, and the reference's masked pairs, {masked:.4e}, "
        f"counted out)")


def _bf16_spec(spec):
    return dataclasses.replace(spec, exec=dataclasses.replace(
        spec.exec, compute_dtype="bfloat16"))


def _agree_bf16(on_cpu, on_card, f32, depth: int, lr_steps: float,
                label: str) -> float:
    """A bf16 carry from the card against one from the CPU: integer state
    equal; a float leaf within the CPU's own bf16-to-float32 distance
    (``f32``: the same cycle in float32 on the CPU) plus 2 x depth bf16
    steps of its largest magnitude, a parameter also within 2 lr per
    update (tests/test_torch_dqn_bf16.py's bound). Returns the largest
    float error as a share of its bound."""
    card, ref32 = dict(_paths(on_card, "carry")), dict(_paths(f32, "carry"))
    worst = 0.0
    for path, a in _paths(on_cpu, "carry"):
        b = card[path].cpu()
        if not a.dtype.is_floating_point:
            check(torch.equal(a, b), f"{label} {path}: card and CPU differ")
            continue
        if not a.numel():
            continue
        noise = float((a - ref32[path]).abs().max())
        bound = noise + 2 * depth * 2.0 ** -8 * float(a.abs().max())
        if ".params." in path:
            bound = max(bound, lr_steps)
        err = float((a - b).abs().max())
        check(err <= bound, f"{label} {path}: card and CPU differ by {err} "
              f"(bound {bound})")
        worst = max(worst, err / bound if bound else 0.0)
    return worst


def phase_bf16(dev) -> dict:
    """Phase 30: the DQN path with the Q-network in bfloat16."""
    from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
    from repro_torch.api.trainers import ConcurrentTrainer, build_trainer
    from repro_torch.configs.dqn_nature import get_variant
    from repro_torch.core.population import tree_map
    from repro_torch.kernels import categorical_projection as cp
    from repro_torch.kernels import segment_tree as st
    spec = ExperimentSpec.from_json(SPEC.read_text())
    spec = dataclasses.replace(
        _bf16_spec(spec), variant=get_variant("rainbow"), mode="concurrent",
        env_params={**spec.env_params, "max_steps": BF16_EPISODE_STEPS},
        schedule=dataclasses.replace(spec.schedule, cycle_steps=BF16_STEPS,
                                     prepopulate=BF16_PREPOPULATE))
    trainer = ConcurrentTrainer(spec, device="cuda")
    f32 = ConcurrentTrainer(dataclasses.replace(
        spec, exec=dataclasses.replace(spec.exec, compute_dtype="float32")),
        device="cuda")
    per_cycle = BF16_STEPS // spec.algo.train_period
    builds = len(st.tree_build_plan(
        st.next_pow2(spec.algo.replay_capacity)))
    reset_launches()
    t0 = time.perf_counter()
    carry = trainer.init_carry()
    torch.cuda.synchronize()
    say(f"bf16 init_carry: {time.perf_counter() - t0:.2f} s (prepopulate "
        f"{BF16_PREPOPULATE})")
    check(all(v.dtype == torch.float32 for v in carry.params.values()),
          "bf16 run: parameters are not float32")
    first = None
    for i in range(2):
        t0 = time.perf_counter()
        carry, m = trainer.cycle(carry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(f"bf16 cycle {i + 1} (C={BF16_STEPS}): {dt:.3f} s, "
            f"{BF16_STEPS / dt:.1f} env-steps/s, loss "
            f"{float(m['loss'][0]):.6f}")
        check(torch.isfinite(m["loss"]).all().item(), "bf16: non-finite loss")
        for name, fn in (("segment_tree", st.segment_tree_sample),
                         ("categorical_projection",
                          cp.categorical_projection)):
            check(fn.launches == per_cycle * (i + 1),
                  f"bf16: {name} launched {fn.launches} times after {i + 1} "
                  f"cycle(s), expected {per_cycle * (i + 1)}")
        check(st.tree_build.launches == builds * (i + 1),
              f"bf16: tree_build launched {st.tree_build.launches} times "
              f"after {i + 1} cycle(s), expected {builds} per cycle")
        if first is None:
            first = _clone(carry)
    t0 = time.perf_counter()
    evals = trainer.eval(carry, trainer.eval_key(1))
    torch.cuda.synchronize()
    say(f"bf16 eval: {time.perf_counter() - t0:.2f} s, return "
        f"{float(evals[0]):+.3f} over {spec.schedule.eval_episodes} streams")
    launches = read_launches()
    check(torch.isfinite(evals).all().item(), "bf16: non-finite eval return")
    check(all(launches[k] == 0 for k in launches
              if k not in ("segment_tree", "categorical_projection",
                           "tree_build")),
          f"the bf16 DQN path launched a serve kernel: {launches}")
    for path, t in _paths(carry, "carry"):
        check(t.device.type == "cuda", f"bf16 {path} is on {t.device}")
    say(f"bf16 launches over init_carry + 2 cycles + eval: {launches}")
    # cycle 2 again in float32 (the same C, from the same carry)
    t0 = time.perf_counter()
    f32.cycle(_clone(first))
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    say(f"bf16 phase: cycle 2 (C={BF16_STEPS}) in bfloat16 {dt:.3f} s, in "
        f"float32 from the same carry {f32_s:.3f} s; phase 5's float32 "
        f"cycles at C={C_MAIN[0]}: "
        + ", ".join(f"{s:.3f} s ({s / C_MAIN[0] * BF16_STEPS:.3f} s per "
                    f"{BF16_STEPS} steps)" for s in C_MAIN[1:]))
    # the card against the CPU on phase 6's small configuration
    small = ExperimentSpec(
        env="pong", mode="concurrent", variant=get_variant("rainbow"),
        envs=4, frame_size=10, net="tiny",
        schedule=ScheduleSpec(cycles=1, cycle_steps=32, prepopulate=64),
        algo=AlgoSpec(minibatch_size=8, replay_capacity=256,
                      optimizer="rmsprop"))
    on_cpu = build_trainer(_bf16_spec(small), device="cpu")
    c0 = on_cpu.init_carry()
    runs = {}
    for label, sp, device in (("f32", small, "cpu"),
                              ("cpu", _bf16_spec(small), "cpu"),
                              ("cuda", _bf16_spec(small), "cuda")):
        runs[label], _ = build_trainer(sp, device=device).cycle(
            tree_map(lambda t: t.to(device, copy=True), c0))
    ncfg = on_cpu._c.ncfg
    depth = len(ncfg.convs) + 2 + int(ncfg.dueling)
    updates = small.schedule.cycle_steps // small.algo.train_period
    worst = _agree_bf16(runs["cpu"], runs["cuda"], runs["f32"], depth,
                        2 * 2.5e-4 * updates, "bf16 pong 10x10")
    say(f"bf16 agreement with the CPU path (pong 10x10, tiny net, rainbow, "
        f"1 cycle from one carry): integer state equal, floats within "
        f"{worst:.3f} of the bound (the CPU's bf16-to-float32 distance "
        f"plus {2 * depth} bf16 steps; params also 2 lr per update)")
    short = dataclasses.replace(spec, schedule=dataclasses.replace(
        spec.schedule, cycle_steps=BF16_RERUN_STEPS))
    phase_determinism(ConcurrentTrainer(short, device="cuda"), first,
                      f"bf16 C={BF16_RERUN_STEPS}: ")
    return {f"dqn_nature84 rainbow bf16 (C={BF16_STEPS}, 2 cycles + eval)":
            launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port itself, from src/ beside this script: without it, fail here
    from repro_torch.kernels import build
    from repro_torch.runtime import configure
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    say(gpu)                                         # name, power limit
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = configure("cuda")
    start = t0 = time.perf_counter()
    reports = build.build_all()
    say(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)}")
    for name, text in reports.items():
        notes = {}  # ptxas's wgmma notes (C75xx) per kernel instance
        for line in text.splitlines():
            if "(C75" in line:
                code = line.split("(C75", 1)[1][:2]
                fn = line.rsplit("function '", 1)[-1].rstrip("'")
                key = (f"C75{code}", fn.split("wgmma", 1)[-1][:10])
                notes[key] = notes.get(key, 0) + 1
            elif "registers" in line or "bytes stack" in line:
                say(f"  {name}: {line.strip()}")
        for (code, fn), n in sorted(notes.items()):
            say(f"  {name}: {n} ptxas notes {code} in instance {fn}")

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    errs = timed("3 (DQN kernel parity)", phase_parity, dev)
    errs.update(timed("3 (LLM kernel parity)", phase_llm_parity, dev))
    errs.update(timed("3 (scan parity)", phase_scan_parity, dev))
    dqn_times, floor_ms = timed("4 (DQN kernel times)", phase_times, dev)
    times = {name: (k_ms, p_ms, l_ms, nbytes, nops, PEAK_F32_PER_S)
             for name, (k_ms, p_ms, l_ms, nbytes, nops) in dqn_times.items()}
    times.update({name: t[:6] for name, t in
                  timed("4 (LLM kernel times)", phase_llm_times, dev).items()
                  if name in kernel_table()})
    times.update(timed("4 (scan times)", phase_scan_times, dev))
    trainer, carry, launches = timed("5 (main path)", phase_main_path, dev)
    timed("5 (profile)", phase_profile, trainer.spec, carry)
    timed("6 (against the CPU)", phase_against_cpu)
    # a cycle cut to C=PROFILED_STEPS from the full-size carry: the same
    # rounds, updates and kernels as C=512, in a tenth of the time
    short = dataclasses.replace(trainer.spec, schedule=dataclasses.replace(
        trainer.spec.schedule, cycle_steps=PROFILED_STEPS))
    timed("7 (determinism)", phase_determinism,
          type(trainer)(short, device="cuda"), carry,
          f"C={PROFILED_STEPS}: ")
    del trainer, carry
    # phase 29's LLM grid traces fake tensors on the host's cores while
    # the card runs phases 8-28; it is checked after phase 28
    dry = tempfile.TemporaryDirectory()
    runs = timed("29 (LLM dry run, started)", phase_dryrun_start, dry.name)
    # phases 8-25 record each case they give the three LLM kernels;
    # phase 26 holds those phase 3 did not
    recording = _recorded_calls()
    recording.__enter__()
    serve_launches = timed("8 (serve)", phase_serve, dev)
    for name in ("rmsnorm", "flash_attention", "decode_attention"):
        launches[name] = serve_launches[name]
    timed("9 (serve against the CPU)", _serve_against_cpu, SERVE_ARCH)
    for arch, name in zip(RECURRENT_ARCHS, ("ssm_scan", "slstm_scan")):
        launches[name] = timed(f"10 ({arch})", _serve_full, arch,
                               dev)["launches"][name]
        # a 128-token prompt: several SSD and mLSTM chunks
        timed(f"11 ({arch} against the CPU)", _serve_against_cpu, arch, 128)
    # the catch phases come after the serve phases: each stream they use
    # keeps card memory (below), which would count in the serve peaks
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    timed("12 (sequential modes)", phase_sequential, dev)
    fleet = timed("13 (population fleet)", phase_fleet, dev)
    for name in ("segment_tree", "categorical_projection", "tree_build"):
        check(fleet[name] > 0, f"{name} never launched on the catch fleet")
    timed("14 (table1)", phase_table1, dev)
    after = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    say(f"catch phases (sequential, fleet, table1): "
        f"{time.perf_counter() - t0:.1f} s; card memory allocated "
        f"{held / 1e9:.3f} GB before, {after / 1e9:.3f} GB after, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB with cuBLAS's "
        "per-stream workspaces cleared")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as sweep_dir:
        # phase 18's launcher run goes beside phases 15-16, which check
        # values; it ends before phase 17 measures serving
        sweep = timed("18 (sweep launcher, started)", phase_sweep_start,
                      sweep_dir, dev)
        timed("15 (resume)", phase_resume, dev)
        with tempfile.TemporaryDirectory() as d:
            catch_dir = timed("16 (launcher)", phase_launcher, d, gpu)
            sweep_out = timed("18 (sweep launcher, waited for)",
                              _rl_train_wait, sweep)
            timed("17 (policy serving)", phase_policy_serving, dev,
                  catch_dir)
        timed("18 (sweep)", phase_sweep, sweep_dir, dev, sweep_out)
    say(f"checkpoint, serving and sweep phases (resume, launcher, serving, "
        f"sweep): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timed("19 (kernel gradients)", phase_kernel_grads, dev)
    new_paths = timed("20 (train)", phase_train, dev)
    new_paths.update(timed("21 (actor-learner)", phase_actor_learner, dev))
    say(f"training and actor-learner phases (kernel gradients, train, "
        f"actor-learner): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    new_paths.update(timed("22 (MoE serve)", phase_moe_serve, dev))
    new_paths.update(timed("23 (MoE train)", phase_moe_train, dev))
    new_paths.update(timed("24 (cross-attention serve)", phase_cross_serve,
                           dev))
    new_paths.update(timed("25 (whisper train)", phase_cross_train, dev))
    say(f"MoE and cross-attention phases (serve and train): "
        f"{time.perf_counter() - t0:.1f} s")
    recording.__exit__(None, None, None)
    timed("26 (parity at the paths' cases)", phase_path_parity, dev)
    t0 = time.perf_counter()
    timed("27 (cost and roofline)", phase_cost, dev, gpu)
    timed("28 (expert parallel)", phase_expert_parallel, dev)
    dqn = timed("29 (DQN dry run)", phase_dryrun_dqn, dry.name)
    timed("29 (dry run)", phase_dryrun_check, runs, dqn)
    dry.cleanup()
    say(f"cost, expert-parallel and dry-run phases: "
        f"{time.perf_counter() - t0:.1f} s")
    new_paths.update(timed("30 (DQN in bf16)", phase_bf16, dev))

    kernels = []
    for name, (_, source, tpu) in kernel_table().items():
        k_ms, p_ms, l_ms, nbytes, nops, peak = times[name]
        check(launches[name] > 0, f"{name} never launched on its path")
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms,
            "launches_by_path": {path: counts[name] for path, counts
                                 in new_paths.items()}})
        if name in LATENCY_BOUND:
            kernels[-1]["floor_ms"] = floor_ms
    say(f"total wall time: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
