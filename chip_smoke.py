#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc/``
with nvcc for sm_90a (one compile per source, in parallel), holds each kernel
against its plain PyTorch version on the card, and drives the port's two
paths on the paper's 10k-node SBM and on the ``cl-100k-1d8-l5`` stand-in
(20 M directed edges):

* the embedding (``GEEEmbedder.fit_transform`` with the ``cuda`` backend,
  fused and staged; all 8 option settings on the SBM), held against the
  port's ``sparse_torch`` reference and the default setting against SciPy
  on the host;
* vertex-similarity retrieval (``build_index``, then 4,096 vertex-id queries
  through ``GEEQueryService`` in flushes of 64, fused and staged, at the
  default nprobe and at full probe, and brute force; l2 and cosine), with
  full probe held equal to brute force and fused to staged;
* out-of-core streaming (phase 10): ``synth_to_disk`` writes
  ``cl-100k-1d8-l5`` (10 M undirected entries) and a scale file (2 M nodes,
  20 M entries) as ``.geeb``; ``fit_transform_file`` streams them through
  the pinned-staging prefetch and the window fold, held against the
  in-memory ``cuda`` fit of ``load_file`` under all 8 settings (and SciPy),
  prefetch depth 0 against depth 2, the scale file against the in-memory
  ``sparse_torch`` fit, with its time, edges per second, the device's busy
  share, the fold's time per window and the peak device memory under a
  stated bound; retrieval over the streamed embedding; and the
  ``gee_run`` / ``gee_search --edge-file`` entry points in processes of
  their own;
* serving under deltas (phase 11): ``partial_fit`` under all 8 settings
  against fresh fits of the mutated graph; ``gee_stream`` on
  ``cl-100k-1d8-l5`` through ``GEEDeltaServer`` and a ``GEEQueryService`` on
  a live index (index repair and query flushes each batch), with no options
  and all on, against a cold ``cuda`` fit and a warm ``sparse_torch``
  refit of the mutated graph, with the device time split by kind; a
  ``gee_stream --snapshot-dir`` process SIGKILLed and recovered against an
  uninterrupted one; two read replicas behind a ``ReplicaRouter``;
* the multi-device folds (phase 12): an NCCL process group of one rank,
  joined in this process, runs ``gee_distributed`` (the scatter on
  cl-100k-1d8-l5 and sbm-10k, the ``gee_spmm`` plane on sbm-10k) and
  ``gee_streamed_sharded`` over phase 10's files and an sbm-10k ``.geeb``,
  under all 8 settings against the in-memory ``cuda`` fit, and the scale
  file's sharded stream is timed beside phase 10's; P = 4 on sbm-10k is
  replayed rank by rank on the card (NCCL takes one rank a card), and the
  shard planes and row blocks are held against the plain kernels;
* the autotune registry (phase 13): every launch geometry of phases 4-9
  resolved through ``autotune.REGISTRY`` to its policy's; measured search,
  by CUDA events, on cl-100k-1d8-l5's narrowest and widest buckets and a
  flush of ``scored_topk_gathered``, the winners recorded, a fit and the
  flush with them against the plain versions, save and load;
* LM serving (phase 14): ``qwen3-0.6b`` at its published widths and depth
  in bf16 on random seeded weights, held against the committed JAX fixture,
  the host, a full forward (prefill + decode), and served by
  ``BatchedServer`` (8 slots, 32 requests) with every emitted token's
  logits held against a forward; one decode step at B = 64 with a
  4,096-token cache timed beside its bytes bound;
* the MoE, SSM and hybrid decoders (phase 15): ``deepseek-moe-16b``,
  ``mamba2-2.7b`` and ``recurrentgemma-2b`` at their published widths in
  bf16 on seeded weights, each config's condition measured first; the
  committed JAX fixtures (the MoE server's tokens too), card against host
  and bf16 against f32 (deepseek cut to 2 layers for its f32 copy; tokens
  routed apart counted; mamba2, chaotic in bf16, held layer by layer),
  prefill + decode against a forward (recurrentgemma past its window, and
  ``generate``), deepseek's server graphed against eager, mamba2's against
  a forward, and one graphed step each beside its bytes bound;
* training (phase 16): one AdamW and one Adafactor step of reduced
  ``qwen3-0.6b`` against the committed JAX fixture (loss, grad norm, every
  leaf's gradient, the updated parameters), ``qwen3-0.6b`` at full width
  in bf16: one step against an f32 step of the same weights cut to 2
  layers (logits, loss, every leaf's gradient, the updated weights), then
  at all 28 layers the logits and first loss against f32 and 20 AdamW
  steps on ``batch_at`` data (step time, tokens/s beside the FLOP bound,
  peak memory, a falling loss, one step profiled), a few Adafactor steps,
  again with ``remat="full"`` (a lower peak) and at microbatches 2 against
  1, and ``repro_torch.launch.train`` SIGKILLed after an in-loop
  checkpoint and resumed to an uninterrupted run's digest;
* the patch and frame frontends and training on a mesh (phase 17):
  ``hubert-xlarge`` at its published widths and depth (the committed JAX
  fixture, bf16 against f32 cut to 2 layers, a timed forward and AdamW
  steps on ``encoder_batch_at`` frames with a falling loss);
  ``qwen2-vl-72b`` at its published widths cut to 16 of 80 layers (the
  fixture, a prefill of 256 patches and text then decode steps continuing
  the M-RoPE ``t`` coordinate against a forward, bf16 against f32 at 2
  layers, ``BatchedServer`` over token prompts); and one spawned NCCL rank
  per visible card, up to four, running ``tools/lm_ranks.py``'s work on a
  (data, model) mesh -- (2, 2), (1, 2) or (1, 1) -- with ``qwen3-0.6b`` at
  full width: an f32 step cut to 2 layers against the one-card step, the
  bf16 step timed, a checkpoint crossing meshes with an equal digest, an
  int8 compressed all-reduce against the exact mean;
* MoE training through the mesh's dispatch (phase 18):
  ``deepseek-moe-16b`` at its published widths in bf16, one step against
  an f32 step cut to 2 layers (the f32 run routed as the bf16 one, each
  token that would route apart counted and its margin held),
  then ``tools/lm_ranks.py``'s work at 2 of 28 layers in the same spawned
  ranks, the MoE layers through ``ShardedLM``'s dispatch (expert-parallel
  where the experts split over ``model``): AdamW steps at 8 x 512 with
  each step's drop fraction at the published capacity factor 1.25;
* the dry-run and the serving layout (phase 19): (a) phase 17's spawned
  rank also prefills (``ShardedLM.prefill``) and decodes
  (``distributed/serving.py::ServingLM``) ``qwen3-0.6b`` on its mesh
  against the one-device ``decode_step`` (f32 at 2 layers, bf16 at 28);
  (b) ``repro_torch.launch.dryrun`` in a process of its own, started
  before phase 14 and read here: phase 16's step traced on a fake group
  of one, its reckoned peak held against phase 16's measured peak and its
  counted FLOPs against phase 16's closed form, and two production cells
  traced on a fake 16 x 16 group.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; phase 11 counts its own checks apart, phase 12 its
replay.  Every kernel is timed with CUDA events beside its bound;
the two contraction kernels also per degree bucket with the L2 flushed,
with the device work one bucket launch enqueues, and a warm fit's device
time split by prep pass; the gathered launch the bucketed drivers make
(phase 6b) held bit for bit to the plane launch on every bucket of both
graphs under the 8 settings, and timed beside its bound, the plane kernel,
the plane passes it replaces and its plain version; ``pairwise_scores``
at its three shapes (index build, a flush's probe, the staged brute force)
with the kernels one call launches, both top-k kernels at other chunk
counts and widths of top-k, and the device time of a fused flush.
The line before the last lists the seven kernels; the last line of standard
output is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before those lines.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
# f32 sums in another order, up to 65,536 terms.  ATOL is scaled to each
# row (below): a Laplacian-scaled row of a hub holds values near 1e-6, so a
# fixed 1e-5 would pass a row that lost most of its terms.
RTOL = ATOL = 1e-5
# The retrieval scores are held to the f32 round-off of the terms they are
# computed from (``term_scale``), not to their own size: 1e-6 of the terms,
# about 8 units of f32 round-off.
TERM_ATOL = 1e-6
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gee_kernels.cu"
TOPK_SOURCE = "src/repro_torch/kernels/csrc/topk_kernels.cu"
REPLACES = {
    "gee_spmm": "src/repro/kernels/gee_spmm.py:208",
    "row_norm": "src/repro/kernels/row_norm.py:26",
    "gee_spmm_fused": "src/repro/kernels/gee_fused.py:122",
    "pairwise_scores": "src/repro/kernels/topk_score.py:171",
    "gathered_scores": "src/repro/kernels/topk_score.py:184",
    "scored_topk": "src/repro/kernels/topk_score.py:379",
    "scored_topk_gathered": "src/repro/kernels/topk_score.py:407",
}
# the one PyTorch call timed beside a kernel as its yardstick (phase 6)
LIBRARY = {"row_norm": "F.normalize", "gee_spmm": "torch.sparse.mm"}
# the streaming path (phase 10): a file of 2 M nodes, 20 M undirected
# entries and 5 classes (20 windows of the default 1,048,576 entries; 50 M
# and 48 windows until the dry-run's phase joined the script's time limit)
SCALE_SPEC = ("scale-2m-20m", 2_000_000, 20_000_000, 5)
# the retrieval path (phase 8): vertex-id queries, flushes of 64, top 10
N_QUERIES = 4096
FLUSH = 64
TOP_K = 10
# serving under deltas (phase 11): the parity run's SBM and its batches,
# the full-width stream's dataset, its batches with no options and the
# seconds the all-on stream may take (at least 8 batches), the timed
# sparse_torch refits of the mutated graph, and the kill-and-recover
# stream's SBM and batches
PARITY_NODES = 2000
PARITY_BATCHES = 16
STREAM_DATASET = "cl-100k-1d8-l5"
STREAM_BATCHES = 256
STREAM_ALL_ON_S = 35.0         # an all-on batch takes ~3.6 s on the H100
REFIT_REPS = 3
KILL_NODES = 2000
KILL_BATCHES = 24
# the multi-device folds (phase 12): the most device memory one rank's ELL
# plane may take for the ``cuda`` local backend to be run
PLANE_BUDGET_BYTES = 8 << 30
# LM serving (phase 14): the config, the committed reference fixture, the
# server's slots, cache, requests (prompt and new-token ranges), the timed
# step's batch and cache, and the sleep queued ahead of its timing (~0.1 s,
# longer than the host takes to enqueue one step's launches)
LM_ARCH = "qwen3-0.6b"
LM_FIXTURE = "tests/torch_fixtures/lm_qwen3_reduced.npz"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS = 8, 512, 16
SERVE_PROMPT, SERVE_NEW = (8, 64), (16, 64)
STEP_BATCH, STEP_CACHE, STEP_FILL_ROWS = 64, 4096, 2
STEP_SLEEP_CYCLES = 200_000_000
# Phase 14's tolerances, as max|got - want| <= REL * max|want| + F32_ATOL.
# f32 (card against host, against the JAX fixture, decode against forward):
# the same f32 function summed in another order, 1e-4 of the largest logit.
# bf16 against the f32 run of the same weights: bf16's unit roundoff 2^-8
# (taken at twice round-to-nearest's 2^-9) over the ~6 roundings a layer
# puts on the residual path (the norm outputs, q/k/v and the attention
# output, wo, the FFN's matmuls, the residual adds), 28 layers adding up
# as a random walk: 2^-8 * sqrt(6 * 28) = 0.0506.  Logits computed in fp8
# (unit roundoff 2^-4) would be off by ~16x that.
F32_REL, F32_ATOL = 1e-4, 1e-5
BF16_REL = 2.0 ** -8 * (6 * 28) ** 0.5
# The MoE, SSM and hybrid decoders (phase 15): the published configs, the
# committed JAX fixtures (reduced; the MoE one at capacity_factor 1.0, the
# hybrid at 7 layers), the layers of deepseek-moe-16b's f32 copy (its full
# depth would take 67.5 GB), the B x S of the f32 and bf16 checks, the
# servers' slots, cache, requests (prompt and new-token ranges), mamba2's
# prefill (a multiple of 128: the SSD at its published chunk) and decode,
# recurrentgemma's prefill past its 2,048-token window and its decode, the
# timed steps' batch and cache (mamba2's cache is its state, after a
# 4,096-token prefill of every row), and deepseek's prefill read for its
# drop share.
FAMILY_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b", "recurrentgemma-2b")
FAMILY_FIXTURES = {
    "deepseek-moe-16b": "tests/torch_fixtures/lm_deepseek_moe_reduced.npz",
    "mamba2-2.7b": "tests/torch_fixtures/lm_mamba2_reduced.npz",
    "recurrentgemma-2b": "tests/torch_fixtures/lm_recurrentgemma_l7.npz"}
MOE_FIXTURE_FACTOR = 1.0
MOE_F32_LAYERS = 2
CHECK_BATCH, CHECK_SEQ = 4, 64
FAMILY_SLOTS, FAMILY_MAX_LEN, FAMILY_REQUESTS = 8, 128, 12
FAMILY_PROMPT, FAMILY_NEW = (4, 16), (8, 16)
SSM_PREFILL, SSM_DECODE = 1024, 16
HYBRID_PREFILL, HYBRID_DECODE = 2560, 64
MOE_STEP_BATCH, MOE_STEP_CACHE = 8, 512
SSM_STEP_BATCH, SSM_STEP_PROMPT = 64, 4096
MOE_PREFILL_BATCH, MOE_PREFILL_SEQ = 4, 512
# Phase 15's bf16 bounds, derived as phase 14's, 2^-8 * sqrt(r * L), but
# with every rounding a layer puts on the residual path counted by itself
# (phase 14 lumped the dense layer's into 6 kinds), since the MoE layer has
# more than the dense one.  deepseek-moe-16b, cut to 2 layers: the
# attention half's 6 (the norm output, q/k/v, the rotary cast, the
# attention output, wo, the residual add) and the MoE half's 13 (the norm
# output; the experts' gate/up outputs, SiLU, product and down output; the
# router weights cast to bf16 and their product with the expert outputs;
# the sum over the k choices cast back; the shared experts' gate/up, SiLU
# product and down outputs and their add; the residual add): r = 19, L = 2
# -> 0.0241.  mamba2-2.7b: the norm output, w_in, the conv (products and
# sums, 2), its SiLU, the SSD's gated f32 output cast to bf16, the gated
# norm, w_out, the residual add: r = 9, L = 64 -> 0.0938.
# recurrentgemma-2b: a recurrent layer's 16 (the norm outputs, 2; the two
# branch matmuls, 2; the GeLU; the conv, 2; the LRU's output cast and gate
# product, 2; w_out; the FFN's gate/up, SiLU, product and down outputs, 4;
# the residual adds, 2) and an attention layer's 12, 18 and 8 of them:
# r = 15, L = 26 -> 0.0771.
ROUNDINGS = {"deepseek-moe-16b": 19, "mamba2-2.7b": 9,
             "recurrentgemma-2b": 15}
FAMILY_DEPTH = {"deepseek-moe-16b": MOE_F32_LAYERS, "mamba2-2.7b": 64,
                "recurrentgemma-2b": 26}
FAMILY_BF16_REL = {a: 2.0 ** -8 * (ROUNDINGS[a] * FAMILY_DEPTH[a]) ** 0.5
                   for a in ROUNDINGS}
# A stack of random layers can amplify round-off past that walk.  Phase 15
# measures it before it compares anything: S, the relative change of the
# f32 logits when every embedding entry is moved by one f32 unit roundoff
# (2^-23 times a standard normal), and kappa = S / 2^-23, the stack's
# condition.  f32 comparisons (card against host, decode against a
# forward) are held within max(F32_REL, 2^-23 * sqrt(r * L) * kappa): the
# rounding walk, each rounding amplified at most as an input's.  Where a
# bf16-sized input change would move the logits by O(1) (S * 2^15 >= 1:
# the stack is chaotic in bf16), bf16 is not compared with f32 end to end:
# each layer's contribution is held instead, fed the f32 run's input,
# within 2^-8 * sqrt(r) * max(1, kappa_l), kappa_l that layer's own
# condition measured the same way; the server and the decode path are held
# in f32, and the timed bf16 step against the eager bf16 step.
CHAOTIC_AT = 1.0
# A bf16 run routes a token to other experts where its f32 router logits'
# top-k margin lies within the round-off of the router's input h: each
# logit h . w_e moves by at most |dh| |w_e| (Cauchy-Schwarz), |dh| <= eps |h|
# with eps the layer's bf16 bound above, so two logits cross only within
# ROUTER_FLIP_SLACK * eps * |h| * max_e |w_e|.  Tokens routed apart are
# counted, not held to the logit bound.
ROUTER_FLIP_SLACK = 2.0
# Training (phase 16): the committed JAX fixture of one step (reduced
# qwen3-0.6b, f32, a constant lr, attention chunk 8); the full-width run's
# B x S (S = 1,024 would hold ~4x the masked schedule's f32 attention
# blocks, ~90 GB by PERF.md's reckoning: over the card), its AdamW steps and
# cosine schedule, the remat run's steps; the launcher's kill-and-resume
# run (reduced, in bf16, a checkpoint every 4 of 16 steps) and its wait.
TRAIN_FIXTURE = "tests/torch_fixtures/lm_train_reduced.npz"
TRAIN_FIXTURE_LR, TRAIN_FIXTURE_CHUNK = 1e-3, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
REMAT_STEPS, ADAFACTOR_STEPS = 3, 3
KILL_ARGS = ["--arch", LM_ARCH, "--steps", "16", "--batch", "8", "--seq",
             "128", "--ckpt-interval", "4", "--log-every", "50"]
# the launcher's main on the reduced config in bf16 (its checkpoints then
# hold bf16 leaves), given KILL_ARGS
KILL_MAIN = f"""
import dataclasses, sys
from repro_torch.configs import get_config
from repro_torch.launch import train
cfg = dataclasses.replace(get_config({LM_ARCH!r}).reduced(),
                          param_dtype="bfloat16", compute_dtype="bfloat16")
train.main(sys.argv[1:], cfg=cfg)
"""
KILL_WAIT_S = 300
U32 = 2.0 ** -24               # f32 unit roundoff
U_BF16 = 2.0 ** -8             # bf16's: 8 significant bits, nearest
# The bf16 step against an f32 step of the same weights, qwen3-0.6b at its
# published widths cut to CUT_LAYERS of 28 layers (the f32 copy's backward
# at full depth would not fit beside the bf16 run's), at a constant
# CUT_LR (an update far above a bf16 ulp of the weights, so a missing or
# wrong update cannot hide in their rounding).  Each bound adds up the
# roundings on its path in the worst case, each at most 2^-8 (their random
# walk, the square root of the count times 2^-8, is what a sound run should
# read; at two layers the head's roundings are a large part of it, so the
# walk over the layers alone, BF16_REL's form, is no bound there).  Logits:
# ~6 a layer, the final norm and the head's product: (6 * 2 + 2) * 2^-8 =
# 0.0547 of max|z|.  Each leaf's gradient, |g_bf16 - g_f32|_2 <=
# CUT_GRAD_REL * |g_f32|_2: on the path from the loss to a leaf and back,
# ~6 a layer forward and 12 back (each product's two gradients), 4 at the
# head and the loss (logits and their gradient, the head's two products):
# (18 * 2 + 4) * 2^-8 = 0.156.  The loss: |dCE| <= 2 max|dz| a token, with
# the measured max|dz|.  The updated weights: ``adamw_step_bound`` from
# each run's own clipped gradient, each p1 rounded to bf16 (a gradient
# whose sign differs between the runs may move its weight by 2 lr: there
# the bound is met nearly exactly).
CUT_LAYERS, CUT_LR = 2, 1e-2
CHECK_CHUNK = 1 << 25          # elements a float64 check takes at once
CUT_LOGIT_REL = (6 * CUT_LAYERS + 2) * 2.0 ** -8
CUT_GRAD_REL = (18 * CUT_LAYERS + 4) * 2.0 ** -8
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
# Phase 17: the patch and frame frontends and the (data, model) mesh.  The
# committed JAX fixtures (reduced, f32); hubert-xlarge's encoder steps (B x
# S = 4 x 512 frames: 30-45 GB with its AdamW state by PERF.md's
# reckoning, where 8 x 512 would need remat) on one batch at a cosine lr,
# which must make the loss fall;
# qwen2-vl-72b cut to VLM_LAYERS of 80 layers in bf16 (1.76 GB a layer and
# 4.98 GB of embedding and head: ~33 GB, over 20 GB left free; all 80 need
# the sharded serving layout) with B x (256 patches + VLM_TEXT tokens),
# VLM_PREFILL_TEXT of them prefilled, and its server's slots, cache and
# requests; the mesh ranks' arguments (``tools/lm_ranks.py``) and wait.
FRONTEND_FIXTURES = {
    "hubert-xlarge": "tests/torch_fixtures/lm_hubert_reduced.npz",
    "qwen2-vl-72b": "tests/torch_fixtures/lm_qwen2vl_reduced.npz"}
HUBERT_BATCH, HUBERT_SEQ, HUBERT_STEPS = 4, 512, 8
HUBERT_LR, HUBERT_WARMUP = 1e-3, 2
VLM_LAYERS, VLM_BATCH, VLM_TEXT, VLM_PREFILL_TEXT = 16, 2, 64, 32
VLM_SLOTS, VLM_MAX_LEN, VLM_REQUESTS = 8, 64, 16
VLM_PROMPT, VLM_NEW = (4, 12), (8, 16)
# bf16 decode against a bf16 forward of the same weights: each run's walk
# of 2^-8 over 6 roundings a layer (phase 14's BF16_REL at VLM_LAYERS),
# the two runs' added
VLM_BF16_PAIR_REL = 2 * 2.0 ** -8 * (6 * VLM_LAYERS) ** 0.5
MESH_RANKS_MAX, MESH_WAIT_S = 4, 420
MESH_ARGS = ["--steps", "6", "--batch", "8", "--seq", "512", "--serve-check"]
# Phase 18: deepseek-moe-16b training at its published widths through the
# mesh's MoE dispatch, cut in depth to fit one 80 GB card.  A layer is
# 587.8 M elements (64 experts of 3 x 2,048 x 1,408, attention 4 x 2,048^2,
# 2 shared experts), the embedding and head 419.4 M; bf16 parameters and
# gradients and f32 AdamW moments updated in place, 14 bytes an element:
# ~8.2 GB a layer and 5.9 GB for the embedding and head, plus the
# activations at 8 x 512 tokens.  4 layers read a 42.93 GB peak on the
# H100 (PERF.md section 6), ~8.6 GB a layer with its activations; 6 layers
# (58.04 GB) fit too, but the whole script must end within its time limit,
# so the run is cut to 2.
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-moe-16b", 2
MOE_TRAIN_ARGS = ["--arch", MOE_TRAIN_ARCH, "--layers", str(MOE_TRAIN_LAYERS),
                  "--steps", "6", "--batch", "8", "--seq", "512"]


# Phase 19: the dry-run and the serving layout.  (b) traces phase 16's
# step (B x S = TRAIN_BATCH x TRAIN_SEQ, mesh (1, 1), AdamW, remat none and
# full) and DRYRUN_CELLS on the production 16 x 16 group, in a process of
# its own (a fake process group cannot share one with phase 12's and 17's
# NCCL groups) started before phase 14, so its host work overlaps the LM
# phases.  The reckoned peak within DRYRUN_PEAK_REL of phase 16's
# max_memory_allocated (the caching allocator's, against MemTracker's sum
# of live tensors), the counted FLOPs within DRYRUN_FLOP_REL of phase
# 16's closed form as the port computes it (the weights' 6 N per token
# and the masked schedule's whole S x S, forward and backward: matmul_flop
# + 2 attn_causal).  Remat's recompute is counted apart (the remat run's
# count less the plain run's) and held above zero and at most one forward
# of the layers: torch's checkpoint ends a recompute once the tensors the
# backward saved are back, so a layer's last product (w_down's) is not
# redone.
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-moe-16b",
                                             "decode_32k"))
DRYRUN_PEAK_REL, DRYRUN_FLOP_REL = 0.25, 0.02
DRYRUN_WAIT_S = 900
DRYRUN_MAIN = """
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
arch, batch, seq, cells, path = json.loads(sys.argv[1])
out = {"phase_16": {}, "cells": []}
shape = ShapeSpec("phase_16", "train", seq, batch)
with dryrun.fake_world(1):
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    for remat in (get_config(arch).remat, "full"):
        r = dryrun.trace_cell(arch, shape, mesh, remat=remat, microbatches=1,
                              optimizer="adamw", opt_inplace=False)
        out["phase_16"][remat] = {"memory": r["memory"], "flops": r["flops"],
                                  "collectives": len(r["records"])}
args = dryrun.parse_args([])
with dryrun.production_world() as mesh:
    for a, sh in cells:
        out["cells"].append(dryrun.run_cell(a, sh, mesh, "single_pod_16x16",
                                            args))
with open(path, "w") as f:
    json.dump(out, f)
"""


def say(line: str) -> None:
    print(line, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper in its caller's module and keeps the
    arguments of every call, so the main path's exact kernel inputs can be
    compared and timed.  It calls the wrapper itself, which keeps counting
    its own launches."""

    # While it stands in, the wrapper's own ``launches += 1`` finds the
    # recorder under the wrapper's name; those capture launches are not
    # main-path launches, so they land here and are dropped.
    launches = 0

    def __init__(self, module, name, keep=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        self.keep = keep                 # keep the first ``keep`` calls

    def __call__(self, *args, **kwargs):
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def gpu_ms(torch, fn, reps: int = 20, warmup: int = 2,
           sleep_cycles: int = 1_000_000) -> float:
    """Median device time (ms) of ``fn``'s launches, by CUDA events.  A
    sleep kernel queued ahead of the start event lets the host enqueue all
    of ``fn``'s launches before the device reaches them, so host launch
    overhead does not show as device time (as long as the host finishes
    within the sleep and ``fn`` never waits for the device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


FLUSH_BYTES = 128 * 2**20       # more than twice the H100's 50 MB L2


def gpu_ms_cold(torch, fn, flush, reps: int = 10, warmup: int = 2) -> float:
    """``gpu_ms`` with the L2 flushed before each rep: outside the timed
    window, ``flush`` (a ``FLUSH_BYTES`` buffer) is written and then read,
    so L2 holds none of ``fn``'s inputs and no dirty line that would be
    written back inside the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(torch, fn, reps: int) -> float:
    """Median wall time (ms) of ``fn`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_busy(torch, prof) -> tuple:
    """The union of the device intervals (kernels, copies) a
    ``torch.profiler`` run recorded, in us, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us, len(spans)


def device_time_by_kind(torch, prof) -> tuple:
    """The device time (us, summed) and the records a ``torch.profiler``
    run recorded, by kind (kernels, host-to-device copies from pageable and
    from pinned memory, other copies, memsets), and each kernel's time by
    name."""
    out, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("Memcpy HtoD"):
            kind = "htod_pageable" if "Pageable" in e.name else "htod_pinned"
        elif e.name.startswith("Memcpy"):
            kind = "copy_other"
        elif e.name.startswith("Memset"):
            kind = "memset"
        else:
            kind = "kernel"
        dur = e.time_range.end - e.time_range.start
        us, n = out.get(kind, (0.0, 0))
        out[kind] = (us + dur, n + 1)
        if kind == "kernel":
            names[e.name] = names.get(e.name, 0.0) + dur
    return ({kind: {"us": us, "records": n} for kind, (us, n) in out.items()},
            names)


def max_err(torch, got, want, scale=None) -> tuple:
    """Hold ``got`` against ``want`` row by row: each entry within
    ``RTOL * |want| + ATOL * min(1, max |want row|)``, so every row is held
    to its own scale and never more loosely than rtol = atol = 1e-5; a row
    that should be all zeros must be exactly zero.  A retrieval score's row
    passes ``scale`` [rows, 1], its ``term_scale``: each entry is then held
    within ``RTOL * |want| + TERM_ATOL * scale``.  Returns the max-abs error
    and the max over rows of max |got - want| / the row's scale."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0, 0.0
    g = got.detach().double().reshape(got.shape[0], -1)
    w = want.detach().to(g.device).double().reshape(want.shape[0], -1)
    if scale is None:
        scale = w.abs().amax(dim=1, keepdim=True)
        atol = ATOL * scale.clamp(max=1.0)
    else:
        scale = torch.as_tensor(scale).to(g.device).double().reshape(-1, 1)
        atol = TERM_ATOL * scale
    diff = (g - w).abs()
    bad = ~(diff <= RTOL * w.abs() + atol)                       # NaN: bad
    row_err = diff.amax(dim=1, keepdim=True)
    rel = torch.where(scale > 0, row_err / scale,
                      torch.where(row_err > 0, float("inf"), 0.0))
    if bool(bad.any()):
        r = int(bad.any(dim=1).nonzero()[0])
        raise AssertionError(
            f"{int(bad.sum())} of {bad.numel()} entries off; first in row "
            f"{r}: got {g[r, :8].tolist()} want {w[r, :8].tolist()}")
    return float(diff.max()), float(rel.max())


def worst(pairs) -> tuple:
    """The largest max-abs and the largest relative error of ``max_err``
    results."""
    pairs = list(pairs)
    return max(a for a, _ in pairs), max(r for _, r in pairs)


def fmt_err(pairs) -> str:
    a, r = worst(pairs)
    return f"max_abs_err={a:.3g} max_rel_err={r:.3g}"


def rand_planes(rng, r, d, k, pad_frac=0.3):
    ylab = rng.integers(0, k, (r, d)).astype(np.int32)
    contrib = rng.uniform(0.1, 1.0, (r, d)).astype(np.float32)
    pad = rng.random((r, d)) < pad_frac
    ylab[pad] = -1
    contrib[pad] = 0.0
    ylab[0] = -1                       # an all-padding row
    contrib[0] = 0.0
    return ylab, contrib


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def edge_cases(torch, kernels, refs, errs):
    """Kernel vs plain on small shapes that stress the edges: K=1, K past
    one class tile, all -1 rows, row counts off the block, widths 8 and
    65,536, empty rowlab, correlation on and off; then ``row_norm``'s own
    cases (``row_norm_edge_cases``)."""
    gee_spmm, row_norm, gee_spmm_fused = kernels
    gee_spmm_ref, row_norm_ref, gee_spmm_fused_ref = refs
    rng = np.random.default_rng(0)
    dev = DEVICE
    shapes = [(13, 8, 1), (13, 8, 3), (300, 8, 7), (37, 100, 40),
              (16, 2048, 64), (5, 65536, 5), (1, 65536, 1), (9, 8192, 9)]
    n_cases = 0
    for r, d, k in shapes:
        y_np, c_np = rand_planes(rng, r, d, k)
        y, c = torch.from_numpy(y_np).to(dev), torch.from_numpy(c_np).to(dev)
        errs["gee_spmm"].append(max_err(torch, gee_spmm(y, c, k),
                                        gee_spmm_ref(y, c, k)))
        rowlab = torch.from_numpy(
            rng.integers(-1, k, r).astype(np.int32)).to(dev)
        dadd = torch.from_numpy(
            rng.uniform(0.1, 1.0, r).astype(np.float32)).to(dev)
        empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
        empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
        for rl, da in ((rowlab, dadd), (empty_i, empty_f)):
            for cor in (True, False):
                errs["gee_spmm_fused"].append(max_err(
                    torch, gee_spmm_fused(y, c, rl, da, k, correlation=cor),
                    gee_spmm_fused_ref(y, c, rl, da, k, correlation=cor)))
                n_cases += 1
        n_cases += 1
    n_cases += row_norm_edge_cases(torch, row_norm, row_norm_ref,
                                   gee_spmm_fused, rng, errs)
    return n_cases


def contraction_edge_cases(torch, gee_spmm, gee_spmm_fused, refs, errs,
                           span: int) -> int:
    """Both contraction kernels against their plain versions at the edges
    of the launch geometry: widths 1, 3, 4, 5 (one slot a load past the
    first), the largest segment row and the first span row (512, 516 at
    16-byte loads), S - 1, S, S + 1 and 2S + 3 for the span S (one row split
    into 1-3 blocks), the 65,536-slot hub width and a 262,144-slot row; K 1,
    5, 8, 9, 32 and 33 (exact K, then class tiles), K = 1,024 (fused) and
    1,500 (staged); diag and correlation on and off, ``rowlab = -1`` rows,
    all-padding rows and an all-padding plane, R = 0, and a ``contrib`` whose
    base is not 16-byte aligned (a contiguous view at an offset of one element).
    Every launch is made twice and must give the same bits; integer-valued
    planes, whose sums are exact, must give the plain version's bits."""
    gee_spmm_ref, gee_spmm_fused_ref = refs
    rng = np.random.default_rng(1)
    dev = DEVICE
    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
    widths = (1, 3, 4, 5, 128, 512, 516, span - 1, span, span + 1,
              2 * span + 3)
    cases = [(37, d, k, False) for k in (1, 5, 8, 9, 32, 33) for d in widths]
    cases += [(2, 65536, k, False) for k in (1, 5, 9)]
    cases += [(2, 262144, k, False) for k in (1, 5, 9)]
    cases += [(9, d, 1024, False) for d in (5, 516, 2 * span + 3)]
    cases += [(9, d, 1500, False) for d in (5, 516, 2 * span + 3)]
    cases += [(0, 4, 5, False), (0, 2 * span + 3, 5, False)]
    cases += [(37, d, k, True) for d in (128, 516, 2048, 2 * span + 4)
              for k in (5, 33)]

    def twice(fn, *a, **kw):
        got = fn(*a, **kw)
        if not torch.equal(got, fn(*a, **kw)):
            raise AssertionError(f"{fn.__name__}: two launches on the same "
                                 f"input differ")
        return got

    def offset_view(t):
        """A contiguous copy of ``t`` one element into a fresh buffer."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    n_cases = 0
    for r, d, k, misaligned in cases:
        y_np, c_np = rand_planes(rng, max(r, 1), d, k)
        if d == 65536:
            y_np[:] = -1                     # an all-padding plane
            c_np[:] = 0.0
        y_np, c_np = y_np[:r], c_np[:r]
        planes = [(torch.from_numpy(y_np).to(dev),
                   torch.from_numpy(c_np).to(dev))]
        ints = np.where(y_np >= 0, rng.integers(1, 4, y_np.shape), 0)
        planes.append((planes[0][0], torch.from_numpy(
            ints.astype(np.float32)).to(dev)))
        if misaligned:
            planes = [(y, offset_view(c)) for y, c in planes]
            if planes[0][1].data_ptr() % 16 == 0:
                raise AssertionError("offset view is 16-byte aligned")
        for i, (y, c) in enumerate(planes):
            got = twice(gee_spmm, y, c, k)
            want = gee_spmm_ref(y, c, k)
            errs["gee_spmm"].append(max_err(torch, got, want))
            if i == 1 and not torch.equal(got, want):
                raise AssertionError(f"gee_spmm R={r} D={d} K={k}: integer "
                                     f"planes differ from plain")
            n_cases += 1
            if k > 1024:
                continue
            rowlab = torch.from_numpy(
                rng.integers(-1, k, r).astype(np.int32)).to(dev)
            dadd = torch.from_numpy(
                rng.uniform(0.1, 1.0, r).astype(np.float32)).to(dev)
            for rl, da in ((rowlab, dadd), (empty_i, empty_f)):
                for cor in (True, False):
                    got = twice(gee_spmm_fused, y, c, rl, da, k,
                                correlation=cor)
                    want = gee_spmm_fused_ref(y, c, rl, da, k,
                                              correlation=cor)
                    errs["gee_spmm_fused"].append(max_err(torch, got, want))
                    if i == 1 and not cor and not rl.numel() \
                            and not torch.equal(got, want):
                        raise AssertionError(
                            f"gee_spmm_fused R={r} D={d} K={k}: integer "
                            f"planes differ from plain")
                    n_cases += 1
    return n_cases


def row_norm_edge_cases(torch, row_norm, row_norm_ref, gee_spmm_fused, rng,
                        errs) -> int:
    """``row_norm`` against its plain version: K on both sides of every
    lane-segment width (1 to 32 lanes a row) and past one warp (33, 200,
    1,025); row counts off every rows-per-warp and block multiple, and
    large enough that the grid strides; zero rows; a row whose squares are
    denormal (no flushed denormals); integer-valued rows, whose sums are
    exact, bit for bit.  Where the fused kernel takes K (<= 1,024), its
    full-warp epilogue run on the same rows (planes of one slot per class,
    so its contraction is exact) must give the same bits."""
    dev = DEVICE
    big = {1: 300_007, 5: 100_003, 32: 20_001}
    n_cases = 0
    for k in (1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 32, 33, 200, 1025):
        for n in (13, 1001, big.get(k)):
            if n is None:
                continue
            for integer in (False, True):
                if integer:
                    z = rng.integers(-3, 4, (n, k)).astype(np.float32)
                else:
                    z = rng.standard_normal((n, k)).astype(np.float32)
                z[rng.random(n) < 0.2] = 0.0           # zero rows stay zero
                if not integer:
                    z[1] = 1e-21           # its squares are denormal floats
                zt = torch.from_numpy(z).to(dev)
                got, want = row_norm(zt), row_norm_ref(zt)
                errs["row_norm"].append(max_err(torch, got, want))
                if integer and not torch.equal(got, want):
                    raise AssertionError(f"row_norm N={n} K={k}: integer-"
                                         f"valued rows differ from plain")
                if not integer:
                    # flushed, the denormal row's norm would read 0
                    torch.testing.assert_close(got[1], want[1], rtol=RTOL,
                                               atol=0.0)
                    if not bool((got[1] != 0).all()):
                        raise AssertionError("row_norm flushed a "
                                             "denormal-norm row")
                if k <= 1024:
                    ylab = torch.arange(k, dtype=torch.int32, device=dev
                                        ).expand(n, k).contiguous()
                    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
                    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
                    fused = gee_spmm_fused(ylab, zt, empty_i, empty_f, k,
                                           correlation=True)
                    if not torch.equal(got, fused):
                        raise AssertionError(f"row_norm N={n} K={k}: not the "
                                             f"fused epilogue's bits")
                n_cases += 1
    return n_cases


def contraction_bytes(a) -> int:
    """The bytes a contraction launch must move, from its arguments: a
    gathered launch (``cols, vals, row_ids, verts, winv, out, K``) 8 B a
    slot, 4 B a row id and 4 B an output (a fit's gathered launches also
    read its [N] vertex records once, 8 B a vertex, which the caller adds);
    a plane launch 8 B a slot, 4 B an output and, fused (``ylab, contrib,
    rowlab, dadd, K``), 8 B a row of rowlab/dadd."""
    r, d = a[0].shape
    k = a[-1]
    if len(a) == 7:
        return 8 * r * d + 4 * r * (1 + k)
    return 8 * r * d + 4 * r * k + (8 * a[2].numel() if len(a) == 5 else 0)


def bucket_table(torch, fn, calls, bell, flush) -> dict:
    """One contraction launch on each bucket of a fit (``calls``, in bucket
    order): real and padded rows (``bell``'s packing), width, bytes
    (``contraction_bytes``), the bytes bound and the time alone with L2
    flushed before each rep.  Also
    the device work one launch enqueues (``graph_nodes``) at the narrowest
    and the widest bucket (a split row: ticket and workspace included):
    anything but one kernel fails the run."""
    rows = []
    for (a, kw), b in zip(calls, bell.buckets):
        r, d = a[0].shape
        if r != b.num_rows or d != b.width:
            raise AssertionError(f"launch [{r}, {d}] is not bucket "
                                 f"[{b.num_rows} real rows, {b.width}]")
        nbytes = contraction_bytes(a)
        rows.append({"R": r, "R_pad": int(b.row_ids.shape[0]), "D": d,
                     "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "ms": gpu_ms_cold(torch, lambda: fn(*a, **kw), flush)})
    per_launch = {}
    for i in (0, len(calls) - 1):
        a, kw = calls[i]
        nodes = graph_nodes(torch, lambda: fn(*a, **kw))
        if nodes != {"kernel": 1}:
            raise AssertionError(f"{fn.__name__} on [{rows[i]['R']}, "
                                 f"{rows[i]['D']}] enqueued {nodes}, not one "
                                 f"kernel")
        per_launch[rows[i]["D"]] = sum(nodes.values())
    # the floor of a launch timed this way: an empty kernel, L2 flushed
    return {"rows": rows, "kernels_per_launch": per_launch,
            "empty_launch_ms": gpu_ms_cold(torch, lambda: torch.cuda._sleep(0),
                                           flush)}


# The functions the fused driver calls, whose device time a warm fit splits
# into: the class weights, the degrees and the Laplacian scale, the residual
# fixup of degree-0 rows, the vertex records and the buckets' gathered
# launches.
PREP_PASSES = ("class_weight_inv", "bucketed_degrees", "inv_sqrt_degrees",
               "apply_epilogue", "vertex_records", "gee_spmm_gathered")


def prep_passes(torch, module, fit) -> dict:
    """A warm default fit's device time (ms) by pass: one fit runs with
    each function of ``PREP_PASSES`` in the fused driver's ``module``
    keeping its calls' arguments, then each pass's calls are replayed in
    sequence and timed by ``gpu_ms`` behind a long sleep kernel, so no host
    time shows (CUDA events around each pass inside the fit read the
    kernel pass at 0.68 ms on cl-100k-1d8-l5, where its launches take 0.13:
    host gaps).  What the passes leave of the fit's device time is Z's
    zeros, the fixup's ones and gaps."""
    calls = {n: [] for n in PREP_PASSES}
    originals = {n: getattr(module, n) for n in PREP_PASSES}

    def keep(name, fn):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        call.launches = 0        # the kernel wrapper counts into its name
        return call

    try:
        for n in PREP_PASSES:
            setattr(module, n, keep(n, originals[n]))
        fit()
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)
    torch.cuda.synchronize()
    return {n: gpu_ms(torch, lambda: [originals[n](*a, **kw)
                                      for a, kw in calls[n]],
                      reps=10, sleep_cycles=20_000_000)
            for n in PREP_PASSES}


def planes_of(torch, args, kwargs, fused: bool):
    """The plane kernel call a gathered launch stands for: ``(args,
    kwargs)`` of ``gee_spmm_fused`` (``fused``) or ``gee_spmm`` on the
    planes ``ref.gathered_planes`` makes from the launch's operands, its
    rows in ``row_ids`` order."""
    from repro_torch.kernels.ref import gathered_planes

    cols, vals, row_ids, verts, winv, _, k = args
    _, ylab, contrib, rowlab, dadd = gathered_planes(
        cols, vals, row_ids, verts, winv,
        laplacian=kwargs.get("laplacian", False),
        diag_aug=kwargs.get("diag_aug", False))
    if not fused:
        return (ylab, contrib, k), {}
    return ((ylab, contrib, rowlab, dadd, k),
            {"correlation": kwargs.get("correlation", False)})


# Phase 6b's edge cases: (R, D, K) of random gathered operands -- widths
# off the 16-byte loads (D % 4 != 0, which the wrapper hands to the plane
# kernel), a warp's 2,048 slots and past it, a split row (D > SPAN), class
# tiles (K > 8) and K = 1, each of the last two also at a width the gathered
# kernel takes.
GATHERED_EDGE_SHAPES = ((37, 3, 1), (37, 12, 1), (300, 8, 5), (64, 130, 9),
                        (64, 132, 9), (40, 2048, 5), (9, 2052, 33),
                        (3, 9000, 5), (2, 8196, 40), (500, 16, 8))


def gathered_edge_cases(torch) -> int:
    """The gathered launch against the plane launch (``planes_of``), bit for
    bit, on random operands at ``GATHERED_EDGE_SHAPES`` under each of the 8
    option settings: neighbour ids partly outside [0, N) (clamped), zero and
    negative weights, unlabeled vertices, a permuted subset of rows in a Z
    filled with ``SENTINEL``.  Returns the count of launches held."""
    from repro_torch.core.gee import ALL_OPTION_SETTINGS, class_weight_inv
    from repro_torch.kernels.gee_fused import (gee_spmm_fused,
                                               gee_spmm_gathered,
                                               vertex_records)

    rng = np.random.default_rng(5)
    held = 0
    for r, d, k in GATHERED_EDGE_SHAPES:
        n = 2 * r + 7
        cols = rng.integers(-3, n + 3, (r, d)).astype(np.int32)
        vals = rng.uniform(-1.0, 2.0, (r, d)).astype(np.float32)
        vals[rng.random((r, d)) < 0.3] = 0.0
        labels = rng.integers(-1, k, n).astype(np.int32)
        dinv = rng.uniform(0.0, 1.5, n).astype(np.float32)
        dinv[rng.random(n) < 0.1] = 0.0
        t = {name: torch.from_numpy(v).to(DEVICE) for name, v in (
            ("cols", cols), ("vals", vals), ("labels", labels),
            ("dinv", dinv),
            ("row_ids", rng.permutation(n)[:r].astype(np.int32)))}
        winv = class_weight_inv(t["labels"], k)
        for opts in ALL_OPTION_SETTINGS:
            verts = vertex_records(t["labels"],
                                   t["dinv"] if opts.laplacian else None)
            flags = {"laplacian": opts.laplacian, "diag_aug": opts.diag_aug,
                     "correlation": opts.correlation}
            args = (t["cols"], t["vals"], t["row_ids"], verts, winv,
                    torch.full((n, k), SENTINEL, device=DEVICE), k)
            got = gee_spmm_gathered(*args, **flags)
            a, kw = planes_of(torch, args, flags, True)
            want = torch.full((n, k), SENTINEL, device=DEVICE)
            want[t["row_ids"].long()] = gee_spmm_fused(*a, **kw)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gathered edge case R={r} D={d} K={k} {opts.tag()}: "
                    f"{int((got != want).sum())} entries differ from the "
                    f"plane launch")
            held += 1
    return held


# Labels hidden (set to -1) in phase 6b's fits, as in a fold of the
# benchmark's refit traffic.
GATHERED_HIDE = 0.2
SENTINEL = -7.25


def gathered_phase(torch, card, graphs, prepared, flush) -> dict:
    """Phase 6b: the gathered launch (``gee_spmm_gathered``) held to the
    plane launch it replaces, bit for bit, and timed.

    For both graphs, the graph's labels with a seeded ``GATHERED_HIDE`` set
    to -1: under each of the 8 option settings the fused driver's operands
    (the base packing; ``dinv`` of degree + 1 with diag-aug), and with and
    without the Laplacian the staged driver's (the packing of A + I, no
    epilogue).  For every bucket, its real rows launched into a Z filled
    with ``SENTINEL`` must equal (``torch.equal``, every entry, so the rows
    outside the bucket are untouched too) the plane passes
    (``planes_of``) and ``gee_spmm_fused`` / ``gee_spmm`` scattered into
    another; the whole bucket with its padding rows (dump row N) must give
    the same Z; and the plain version holds it to ``max_err``.  The widest
    buckets of cl-100k-1d8-l5 take split rows (``spans`` > 1).

    Timing, default options, the fused driver's launches of one fit:
    the gathered launches against their bytes bound (8 B a slot, 4 B a row
    id, 4 B an output, and the fit's [N] vertex records read once), the
    plane kernel on the planes, the plane passes with the kernel and the
    scatter, the plain version; each bucket alone with L2 flushed, gathered
    against plane kernel; and the kernels one launch enqueues at the
    narrowest and widest bucket (anything but one fails the run)."""
    from repro_torch.core.epilogue import inv_sqrt_degrees
    from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                      class_weight_inv)
    from repro_torch.graph.ell import bucketed_degrees
    from repro_torch.kernels import gee_spmm as gs
    from repro_torch.kernels.gee_fused import (gee_spmm_fused,
                                               gee_spmm_gathered,
                                               vertex_records)
    from repro_torch.kernels.gee_spmm import gee_spmm
    from repro_torch.kernels.ref import gee_spmm_gathered_ref

    out = {"checks": 0, "errs": [], "graphs": {}}
    t0 = time.perf_counter()
    out["edge_cases"] = gathered_edge_cases(torch)
    for g, (edges, labels_np, k) in graphs.items():
        n = edges.num_nodes
        hide = np.random.default_rng(7).random(labels_np.size) < GATHERED_HIDE
        labels = torch.from_numpy(
            np.where(hide, -1, labels_np).astype(np.int32)).to(DEVICE)
        winv = class_weight_inv(labels, k)
        configs = [(o, False) for o in ALL_OPTION_SETTINGS] + [
            (GEEOptions(laplacian=lap), True) for lap in (True, False)]
        shapes, split = set(), set()
        for opts, staged in configs:
            bell = prepared[g].bucketed_ell(staged)
            dinv = None
            if opts.laplacian:
                deg = bucketed_degrees(bell, DEVICE)
                dinv = inv_sqrt_degrees(deg + 1.0 if opts.diag_aug else deg)
            verts = vertex_records(labels, dinv)
            flags = {"laplacian": opts.laplacian}
            if not staged:
                flags.update(diag_aug=opts.diag_aug,
                             correlation=opts.correlation)
            plane_fn = gee_spmm if staged else gee_spmm_fused
            for b in bell.buckets:
                real = b.real_rows()
                r, d = real.cols.shape

                def launch(bk):
                    z = torch.full((n, k), SENTINEL, device=DEVICE)
                    return gee_spmm_gathered(bk.cols, bk.vals, bk.row_ids,
                                             verts, winv, z, k, **flags)

                got = launch(real)
                args = (real.cols, real.vals, real.row_ids, verts, winv,
                        None, k)
                a, kw = planes_of(torch, args, flags, not staged)
                want = torch.full((n, k), SENTINEL, device=DEVICE)
                want[real.row_ids.long()] = plane_fn(*a, **kw)
                what = (f"{g} {opts.tag()} {'staged' if staged else 'fused'}"
                        f" bucket [{r}, {d}]")
                if not torch.equal(got, want):
                    off = int((got != want).sum())
                    raise AssertionError(f"{what}: the gathered launch "
                                         f"differs from the plane launch in "
                                         f"{off} entries")
                if not torch.equal(launch(b), got):
                    raise AssertionError(f"{what}: the padded bucket "
                                         f"differs from its real rows")
                plain = gee_spmm_gathered_ref(
                    *args[:5], torch.full((n, k), SENTINEL, device=DEVICE),
                    k, **flags, eps=1e-30)
                out["errs"].append(max_err(torch, got, plain))
                out["checks"] += 1
                shapes.add((r, d))
                geometry = gs.resolve_geometry(gs.GATHERED_KERNEL_NAME, d, k,
                                               gs._vec(real.cols, real.vals))
                if geometry[2] > 1:
                    split.add((r, d, geometry[2]))
        out["graphs"][g] = {"shapes": sorted(shapes), "split": sorted(split)}
    if not any(out["graphs"]["cl-100k-1d8-l5"]["split"]):
        raise AssertionError("no bucket of cl-100k-1d8-l5 split a row")
    torch.cuda.synchronize()
    out["check_s"] = time.perf_counter() - t0

    timing = {}
    for g, (edges, labels_np, k) in graphs.items():
        n = edges.num_nodes
        hide = np.random.default_rng(7).random(labels_np.size) < GATHERED_HIDE
        labels = torch.from_numpy(
            np.where(hide, -1, labels_np).astype(np.int32)).to(DEVICE)
        winv = class_weight_inv(labels, k)
        bell = prepared[g].bucketed_ell(False)
        dinv = inv_sqrt_degrees(bucketed_degrees(bell, DEVICE) + 1.0)
        verts = vertex_records(labels, dinv)
        flags = {"laplacian": True, "diag_aug": True, "correlation": True}
        z = torch.zeros((n, k), device=DEVICE)
        calls = [((b.cols, b.vals, b.row_ids, verts, winv, z, k), flags)
                 for b in (b.real_rows() for b in bell.buckets)]
        planes = [planes_of(torch, a, kw, True) for a, kw in calls]
        rows = [a[2].long() for a, _ in calls]

        def plane_passes():
            for (a, kw), rw in zip(calls, rows):
                pa, pkw = planes_of(torch, a, kw, True)
                z[rw] = gee_spmm_fused(*pa, **pkw)

        nbytes = sum(8 * a[0].numel() + 4 * a[0].shape[0] * (1 + k)
                     for a, _ in calls) + 8 * n       # + verts, read once
        t = {"launches_per_fit": len(calls), "bytes": nbytes,
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ms": gpu_ms(torch, lambda: [gee_spmm_gathered(*a, **kw)
                                          for a, kw in calls],
                          sleep_cycles=5_000_000),
             "plane_kernel_ms": gpu_ms(torch, lambda: [
                 gee_spmm_fused(*a, **kw) for a, kw in planes],
                 sleep_cycles=5_000_000),
             "plane_passes_ms": gpu_ms(torch, plane_passes, reps=10,
                                       sleep_cycles=20_000_000),
             "plain_ms": gpu_ms(torch, lambda: [
                 gee_spmm_gathered_ref(*a, **kw, eps=1e-30)
                 for a, kw in calls], reps=10, sleep_cycles=20_000_000)}
        t["buckets"] = [
            {"R": a[0].shape[0], "D": a[0].shape[1],
             "ms": gpu_ms_cold(torch, lambda: gee_spmm_gathered(*a, **kw),
                               flush),
             "plane_ms": gpu_ms_cold(torch, lambda: gee_spmm_fused(*pa, **pkw),
                                     flush)}
            for (a, kw), (pa, pkw) in zip(calls, planes)]
        per_launch = {}
        for i in (0, len(calls) - 1):
            a, kw = calls[i]
            nodes = graph_nodes(torch, lambda: gee_spmm_gathered(*a, **kw))
            if nodes != {"kernel": 1}:
                raise AssertionError(f"gee_spmm_gathered on [{a[0].shape[0]}"
                                     f", {a[0].shape[1]}] enqueued {nodes}, "
                                     f"not one kernel")
            per_launch[a[0].shape[1]] = sum(nodes.values())
        t["kernels_per_launch"] = per_launch
        timing[g] = t
        del calls, planes, z
    out["timing"] = timing
    say(f"phase 6b gathered launch ({card}): {out['edge_cases']} edge "
        f"cases and {out['checks']} bucket launches "
        f"(8 settings fused, 2 staged) equal to the plane launch bit for bit "
        f"with the rows outside untouched, padded buckets equal, vs plain "
        f"{fmt_err(out['errs'])}; shapes " + "; ".join(
            f"{g} {v['shapes']} split {v['split']}"
            for g, v in out["graphs"].items())
        + "; default fit, ms: " + "; ".join(
            f"{g} gathered {t['ms']:.4f} over {t['launches_per_fit']} "
              f"launches (bound {t['bound_ms']:.4f}; plane kernel "
              f"{t['plane_kernel_ms']:.4f}, plane passes + kernel + scatter "
              f"{t['plane_passes_ms']:.4f}, plain {t['plain_ms']:.4f}); per "
              f"bucket, L2 flushed, gathered/plane " + " ".join(
                  f"[{b['R']}, {b['D']}] {b['ms']:.4f}/{b['plane_ms']:.4f}"
                  for b in t["buckets"])
            for g, t in timing.items()))
    out["errs"] = worst(out["errs"])
    return out


def csr_operands(torch, edges, labels, k):
    """The contraction of a default fit as one cuSPARSE call's operands:
    A_csr, the CSR of the Laplacian-scaled A + I (the default options'
    graph), and W, the [N, K] one-hot of the labels scaled by 1 / n_k, so
    that ``torch.sparse.mm(A_csr, W)`` computes what the staged fit's
    ``gee_spmm`` launches compute (from CSR, not from ELL planes).  Also
    returns the port's ``sparse_torch`` embedding without the row norm, to
    hold the product against."""
    from repro_torch.core.gee import (GEEOptions, class_weight_inv,
                                      gee_sparse_torch,
                                      laplacian_edge_weights)
    from repro_torch.graph.containers import add_self_loops

    aug = add_self_loops(edges)
    w = laplacian_edge_weights(aug)
    e = aug.num_edges
    a = torch.sparse_coo_tensor(
        torch.stack([aug.src[:e].long(), aug.dst[:e].long()]), w[:e],
        (aug.num_nodes, aug.num_nodes)).coalesce().to_sparse_csr()
    lab = torch.from_numpy(labels).to(edges.device).long()
    winv = class_weight_inv(lab.int(), k)
    onehot = torch.zeros((aug.num_nodes, k), dtype=torch.float32,
                         device=edges.device)
    rows = torch.nonzero(lab >= 0)[:, 0]
    onehot[rows, lab[rows]] = winv[lab[rows]]
    want = gee_sparse_torch(edges, lab.int(), k, GEEOptions(
        laplacian=True, diag_aug=True, correlation=False))
    return a, onehot, want


# ---------------------------------------------------------------------------
# retrieval: comparisons
# ---------------------------------------------------------------------------

def score_err(torch, got, want, scale=None) -> tuple:
    """``max_err`` for masked scores: NEG_INF entries must be equal exactly,
    and are left out of the rest (and of each row's scale)."""
    from repro_torch.kernels.ref import NEG_INF

    gm, wm = got == NEG_INF, want.to(got.device) == NEG_INF
    if not torch.equal(gm, wm):
        raise AssertionError(f"NEG_INF entries differ in "
                             f"{int((gm != wm).sum())} places")
    return max_err(torch, torch.where(gm, 0.0, got),
                   torch.where(wm, 0.0, want.to(got.device)), scale)


def term_scale(torch, q, x, metric):
    """[Q, 1]: the size of the terms each query's scores are computed from,
    which scores are held to in place of their own row's max (``max_err``'s
    ``scale``, times ``TERM_ATOL``).  An l2 score (2·dot − ‖q‖²) − ‖x‖²
    rounds like ‖q‖² + ‖x‖² however small the difference (a row of a vertex
    against 5 nearby centroids holds only scores near 1e-3); the summands
    of a cosine score are bounded by 1.  ``x`` is the database [M, K] or
    the candidates [Q, M, K]."""
    if metric == "cosine":
        return torch.ones((q.shape[0], 1), dtype=torch.float64,
                          device=q.device)
    qn2 = q.double().square().sum(dim=1, keepdim=True)
    xn2 = x.double().square().sum(dim=-1)
    xn2 = xn2.amax() if x.dim() == 2 else xn2.amax(dim=1, keepdim=True)
    return qn2 + xn2


def check_topk(torch, got, want, full, scale, cand_ids=None,
               exact=False) -> tuple:
    """Hold a top-k kernel's ``(ids, scores)`` against its plain version's.

    ``full`` is the plain [Q, M] score matrix, ``scale`` its
    ``term_scale`` and ``cand_ids`` [Q, M] each candidate's database id
    (``None``: the id is the position).  Scores as ``score_err``; masked
    slots (-1) in the same places; every returned id a
    distinct candidate whose plain score is its reported score; and the id
    equal to the plain version's wherever no other candidate's plain score
    lies within the round-off (``TERM_ATOL * scale``, no rtol) of that
    slot's.  ``exact``: ids and scores equal bit for bit, tie order
    included."""
    err = score_err(torch, got[1], want[1], scale)
    gi, gs, wi, ws = (t.cpu().numpy() for t in (*got, *want))
    if exact:
        if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
            raise AssertionError("top-k differs on exactly representable "
                                 "inputs")
        return err
    if not np.array_equal(gi < 0, wi < 0):
        raise AssertionError("masked top-k slots differ")
    atol = TERM_ATOL * scale.cpu().numpy().reshape(-1, 1)
    full = full.cpu().numpy().astype(np.float64)
    ci = None if cand_ids is None else cand_ids.cpu().numpy()
    for r in range(gi.shape[0]):
        live = gi[r] >= 0
        ids = gi[r][live]
        if len(set(ids.tolist())) != ids.size:
            raise AssertionError(f"row {r}: an id repeats")
        if ci is None:
            pos = ids
        else:
            order = np.argsort(ci[r], kind="stable")
            pos = order[np.searchsorted(ci[r][order], ids)]
            if not np.array_equal(ci[r][pos], ids):
                raise AssertionError(f"row {r}: an id is no candidate")
        true = full[r, pos]
        tol = RTOL * np.abs(true) + atol[r]
        if np.any(np.abs(true - gs[r][live]) > tol):
            raise AssertionError(f"row {r}: an id's plain score is not its "
                                 f"reported score")
        for j in np.flatnonzero(live):
            w = float(ws[r, j])
            if np.count_nonzero(np.abs(full[r] - w) <= atol[r, 0]) <= 1 \
                    and gi[r, j] != wi[r, j]:
                raise AssertionError(f"row {r} slot {j}: id {gi[r, j]} != "
                                     f"{wi[r, j]} with no near tie")
    return err


def same_topk(got_ids, got_s, want_ids, want_s, scale) -> list:
    """Path-level agreement of two top-k results (numpy): the same masked
    slots; scores within the tolerance (``scale``: each query's
    ``term_scale``) slot by slot; ids equal where ``want``'s neighbouring
    scores differ by more than the round-off (``TERM_ATOL * scale``, no
    rtol: a cosine score near 1 would otherwise tie everything within
    1e-5), and within such a near-tie group the same set.  A group that reaches slot k-1 may continue past k, so
    its members are held by score only.  Returns the sizes of the near-tie
    groups of two or more slots."""
    if got_ids.shape != want_ids.shape:
        raise AssertionError(f"shape {got_ids.shape} != {want_ids.shape}")
    if not np.array_equal(got_ids < 0, want_ids < 0):
        raise AssertionError("masked slots differ")
    live = want_ids >= 0
    g = np.where(live, got_s, 0.0).astype(np.float64)
    w = np.where(live, want_s, 0.0).astype(np.float64)
    tie = TERM_ATOL * scale
    tol = RTOL * np.abs(w) + tie
    if np.any(np.abs(g - w) > tol):
        r = int(np.flatnonzero((np.abs(g - w) > tol).any(axis=1))[0])
        raise AssertionError(f"row {r}: scores {got_s[r]} != {want_s[r]}")
    k = w.shape[1]
    groups = []
    for r in range(w.shape[0]):
        j0 = 0
        while j0 < k:
            j1 = j0
            while j1 + 1 < k and abs(w[r, j1 + 1] - w[r, j1]) <= tie[r, 0]:
                j1 += 1
            if j1 < k - 1 and set(got_ids[r, j0:j1 + 1].tolist()) != set(
                    want_ids[r, j0:j1 + 1].tolist()):
                raise AssertionError(f"row {r}: ids {got_ids[r]} != "
                                     f"{want_ids[r]}")
            if j1 > j0:
                groups.append(j1 - j0 + 1)
            j0 = j1 + 1
    return groups


def topk_edge_cases(torch, ts, ref, errs) -> int:
    """The four retrieval kernels against their plain versions, both
    metrics: K = 1 and K = 200; Q = 1; M = 1; k > M; k = MAX_TOPK and
    MAX_TOPK + 1 (the staged route); all slots masked; zero-norm rows; M off
    every block and chunk size; and integer-valued inputs with many exact
    ties, where every sum is exact whatever its order, so ids and scores must
    equal the plain version's bit for bit."""
    rng = np.random.default_rng(1)
    dev = DEVICE
    mt = ts.MAX_TOPK
    # (Q, M, K, k, integer-valued, all masked)
    cases = [(1, 1, 1, 1, False, False), (1, 1, 3, 5, False, False),
             (3, 7, 1, 10, False, False), (5, 300, 200, 10, False, False),
             (64, 5, 5, 3, False, False), (17, 1007, 9, mt, False, False),
             (17, 1007, 9, mt + 1, False, False),
             (64, 70001, 5, 10, False, False), (1, 5000, 3, mt, False, False),
             (200, 2000, 3, 10, False, False), (9, 333, 4, 10, False, True),
             (64, 20000, 3, 10, True, False), (3, 4097, 2, mt, True, False),
             (5, 900, 1, mt + 1, True, False), (2, 50, 5, 64, True, False)]
    n = 0
    for q_, m_, k_dim, k, integer, all_masked in cases:
        def gen(shape):
            if integer:
                return rng.integers(-2, 3, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)

        q = torch.from_numpy(gen((q_, k_dim))).to(dev)
        x = torch.from_numpy(gen((m_, k_dim))).to(dev)
        cand = torch.from_numpy(gen((q_, m_, k_dim))).to(dev)
        q[0] = 0.0                                 # zero-norm rows
        x[0] = 0.0
        cand[:, 0] = 0.0
        live = 0.0 if all_masked else 0.8
        valid = torch.from_numpy((rng.random(m_) < live).astype(
            np.float32)).to(dev)
        mask = torch.from_numpy((rng.random((q_, m_)) < live).astype(
            np.float32)).to(dev)
        ids = torch.from_numpy(np.stack([rng.permutation(10 * m_)[:m_]
                                         for _ in range(q_)]).astype(
            np.int32)).to(dev)
        for metric in ("l2", "cosine"):
            sc, gsc = (term_scale(torch, q, x, metric),
                       term_scale(torch, q, cand, metric))
            full = ref.pairwise_scores_ref(q, x, valid, metric)
            errs["pairwise_scores"].append(score_err(
                torch, ts.pairwise_scores(q, x, valid, metric=metric), full,
                sc))
            gfull = ref.gathered_scores_ref(q, cand, mask, metric)
            errs["gathered_scores"].append(score_err(
                torch, ts.gathered_scores(q, cand, mask, metric=metric),
                gfull, gsc))
            before = (ts.scored_topk.launches,
                      ts.scored_topk_gathered.launches)
            got = ts.scored_topk(q, x, valid, k, metric=metric, fused=True)
            errs["scored_topk"].append(check_topk(
                torch, got, ref.masked_topk(full, None, k), full, sc,
                exact=integer))
            got = ts.scored_topk_gathered(q, cand, mask, ids, k,
                                          metric=metric, fused=True)
            errs["scored_topk_gathered"].append(check_topk(
                torch, got, ref.masked_topk(gfull, ids, k), gfull, gsc, ids,
                exact=integer))
            staged = min(k, m_) > mt
            fused_runs = (ts.scored_topk.launches - before[0],
                          ts.scored_topk_gathered.launches - before[1])
            if fused_runs != ((0, 0) if staged else (1, 1)):
                raise AssertionError(f"k={k}, M={m_}: the fused kernels ran "
                                     f"{fused_runs} times")
            n += 1
    return n


def gathered_topk_edge_cases(torch, ts, ref, errs) -> tuple:
    """``scored_topk_gathered`` against its plain version, both metrics:
    kk in {1, 2, 10, 16, 31, 32}; M < 32; M at a chunk boundary +- 1; one
    chunk and many; rows entirely masked; K on both sides of the widest
    K kept in registers (8); and integer-valued inputs whose exact ties
    straddle lanes, warps and chunks, held bit for bit.  In the ``bar``
    rows every live score ties, and the first 64 candidates of each chunk
    (warp 0's first round) score lower, so warp 0's list holds later m
    when the other warps' lists, of the same score and smaller m, are
    offered to it: each must displace the list's last entry.  K runs over
    every width the kernel keeps in registers (1-8) and past it (9, 200).
    Returns the number of cases and the chunk counts the wrapper chose."""
    rng = np.random.default_rng(2)
    dev = DEVICE
    chunk = ts._GATHER_MIN_CHUNK
    # (Q, M, K, k, integer-valued, pattern)
    cases = [(3, 20, 3, 10, False, None), (5, 31, 2, 32, True, None),
             (2, 1, 1, 1, False, None), (4, chunk - 1, 1, 1, True, None),
             (4, chunk + 1, 2, 2, True, None),
             (2, 2 * chunk - 1, 1, 16, True, None),
             (2, 2 * chunk + 1, 1, 31, True, None),
             (1, 70001, 1, 32, True, None), (64, 3 * chunk, 2, 16, True, None),
             (64, 58752, 5, 10, False, None), (7, 3000, 3, 10, False, "rows"),
             (3, 2 * chunk + 5, 1, 10, True, "bar"),
             (3, 2 * chunk + 5, 1, 32, True, "bar"),
             (5, 3001, 4, 10, True, None), (5, 3001, 6, 10, True, None),
             (5, 3001, 7, 10, True, None), (5, 3001, 8, 10, True, None),
             (5, 3001, 9, 10, True, None), (3, 300, 200, 10, False, None)]
    n, chunk_counts = 0, set()
    for q_, m_, k_dim, k, integer, pattern in cases:
        if integer:
            q = rng.integers(-2, 3, (q_, k_dim)).astype(np.float32)
            cand = rng.integers(-2, 3, (q_, m_, k_dim)).astype(np.float32)
        else:
            q = rng.standard_normal((q_, k_dim)).astype(np.float32)
            cand = rng.standard_normal((q_, m_, k_dim)).astype(np.float32)
        mask = (rng.random((q_, m_)) < 0.8).astype(np.float32)
        if pattern == "rows":
            mask[[0, 3]] = 0.0                     # rows entirely masked
        elif pattern == "bar":
            q[:] = 0.0                            # l2: -|x|^2; cosine: 0
            cand[:] = 0.0
            mask[:] = 1.0
            chunk_len = -(-m_ // ts._gathered_chunks(torch.device(dev), q_,
                                                     m_))
            for c0 in range(0, m_, chunk_len):
                cand[:, c0:c0 + 64] = 1.0          # l2 -1, cosine 0
        ids = np.stack([rng.permutation(10 * m_)[:m_]
                        for _ in range(q_)]).astype(np.int32)
        qt, ct, mt, it = (torch.from_numpy(a).to(dev)
                          for a in (q, cand, mask, ids))
        chunk_counts.add(ts._gathered_chunks(qt.device, q_, m_))
        for metric in ("l2", "cosine"):
            gfull = ref.gathered_scores_ref(qt, ct, mt, metric)
            before = ts.scored_topk_gathered.launches
            got = ts.scored_topk_gathered(qt, ct, mt, it, k, metric=metric,
                                          fused=True)
            if ts.scored_topk_gathered.launches != before + 1:
                raise AssertionError(f"M={m_} k={k}: the kernel did not run")
            errs["scored_topk_gathered"].append(check_topk(
                torch, got, ref.masked_topk(gfull, it, k), gfull,
                term_scale(torch, qt, ct, metric), it, exact=integer))
            n += 1
    if not (1 in chunk_counts and max(chunk_counts) > 8):
        raise AssertionError(f"chunk counts {sorted(chunk_counts)} miss one "
                             f"chunk or many")
    return n, sorted(chunk_counts)


def scored_topk_edge_cases(torch, ts, ref, errs) -> tuple:
    """``scored_topk`` against its plain version, both metrics: kk in {1, 2,
    10, 16, 31, 32}; M < 32 and M at a chunk boundary +- 1; Q in {1, QT - 1,
    QT + 1, 64, 65} (QT: the query tile); one chunk to the most; an
    all-invalid database; valid absent, f32, bool and uint8; K over every
    width the kernel keeps in registers (1-8) and past it (9, 200); and
    integer-valued inputs whose exact ties straddle lanes, warps, query
    tiles and chunks, held bit for bit.  In the ``bar`` rows every live
    score ties except the first 64 candidates of each chunk (warp 0's first
    round), which score lower, so warp 0's list holds later m than the
    other warps' lists of the same score.  Returns the number of cases and
    the chunk counts the wrapper chose."""
    rng = np.random.default_rng(3)
    dev = DEVICE
    qt, chunk = ts._QUERY_TILE, ts._MIN_CHUNK
    # (Q, M, K, k, integer-valued, pattern)
    cases = [(1, 1, 1, 1, True, None), (qt - 1, 20, 3, 10, False, None),
             (qt + 1, 31, 2, 32, True, None), (3, chunk - 1, 1, 1, True, None),
             (5, chunk + 1, 2, 2, True, None),
             (qt + 1, 2 * chunk - 1, 1, 16, True, None),
             (qt - 1, 2 * chunk + 1, 1, 31, True, None),
             (1, 92482, 1, 32, True, None), (64, 92482, 5, 10, False, None),
             (64, 92482, 5, 10, True, None), (65, 10000, 3, 10, False, None),
             (64, 3 * chunk, 2, 16, True, None),
             (7, 3000, 3, 10, False, "invalid"),
             (qt + 1, 2 * chunk + 5, 1, 10, True, "bar"),
             (65, 5000, 1, 32, True, "bar"),
             (5, 3001, 4, 10, True, None), (5, 3001, 6, 10, True, None),
             (5, 3001, 7, 10, True, None), (5, 3001, 8, 10, True, None),
             (5, 3001, 9, 10, True, None), (3, 300, 200, 10, False, None)]
    n, chunk_counts = 0, set()
    for case, (q_, m_, k_dim, k, integer, pattern) in enumerate(cases):
        if integer:
            q = rng.integers(-2, 3, (q_, k_dim)).astype(np.float32)
            x = rng.integers(-2, 3, (m_, k_dim)).astype(np.float32)
        else:
            q = rng.standard_normal((q_, k_dim)).astype(np.float32)
            x = rng.standard_normal((m_, k_dim)).astype(np.float32)
        valid = (rng.random(m_) < 0.8).astype(np.float32)
        chunks = ts._num_chunks(torch.device(dev), q_, m_)
        chunk_counts.add(chunks)
        if pattern == "invalid":
            valid[:] = 0.0
        elif pattern == "bar":
            q[:] = 0.0                            # l2: -|x|^2; cosine: 0
            x[:] = 0.0
            valid[:] = 1.0
            for c0 in range(0, m_, -(-m_ // chunks)):
                x[c0:c0 + 64] = 1.0                # l2 -1, cosine 0
        qt_, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        vt = (None, vt, vt > 0, (vt > 0).to(torch.uint8))[case % 4]
        if pattern == "invalid" and vt is None:
            vt = torch.zeros(m_, dtype=torch.bool, device=dev)
        for metric in ("l2", "cosine"):
            full = ref.pairwise_scores_ref(qt_, xt, vt, metric)
            before = ts.scored_topk.launches
            got = ts.scored_topk(qt_, xt, vt, k, metric=metric, fused=True)
            if ts.scored_topk.launches != before + 1:
                raise AssertionError(f"Q={q_} M={m_} k={k}: the kernel did "
                                     f"not run")
            errs["scored_topk"].append(check_topk(
                torch, got, ref.masked_topk(full, None, k), full,
                term_scale(torch, qt_, xt, metric), exact=integer))
            n += 1
    if not (1 in chunk_counts and max(chunk_counts) > 32):
        raise AssertionError(f"chunk counts {sorted(chunk_counts)} miss one "
                             f"chunk or many")
    return n, sorted(chunk_counts)


def pairwise_edge_cases(torch, ts, ref, errs) -> int:
    """``pairwise_scores`` against its plain version, both metrics: M from 1
    to 10 (the index's centroids, the few-row path) and past it (33, 1,000);
    Q on both sides of the kernels' blocks of query rows (128) and query
    tiles (8); K 1-9 and 200; valid absent, f32, bool and uint8, all zero
    too.  Integer-valued inputs bit for bit, the others within the
    tolerance; the three valid dtypes give the same bits."""
    rng = np.random.default_rng(4)
    dev = DEVICE
    n = 0
    shapes = [(1, 1), (127, 10), (129, 5), (9, 2), (64, 7), (8, 33),
              (9, 1000)]
    for k_dim in (1, 2, 3, 4, 5, 6, 7, 8, 9, 200):
        for (q_, m_), integer in zip(shapes * 2,
                                     [True] * len(shapes)
                                     + [False] * len(shapes)):
            gen = ((lambda s: rng.integers(-2, 3, s)) if integer else
                   rng.standard_normal)
            qt_ = torch.from_numpy(gen((q_, k_dim)).astype(np.float32)).to(dev)
            xt = torch.from_numpy(gen((m_, k_dim)).astype(np.float32)).to(dev)
            live = 0.0 if (q_, m_) == (9, 2) else 0.7
            vf = torch.from_numpy((rng.random(m_) < live).astype(
                np.float32)).to(dev)
            for metric in ("l2", "cosine"):
                sc = term_scale(torch, qt_, xt, metric)
                outs = []
                for v in (None, vf, vf > 0, (vf > 0).to(torch.uint8)):
                    got = ts.pairwise_scores(qt_, xt, v, metric=metric)
                    want = ref.pairwise_scores_ref(qt_, xt, v, metric)
                    errs["pairwise_scores"].append(score_err(torch, got, want,
                                                             sc))
                    if integer and not torch.equal(got, want):
                        raise AssertionError(f"pairwise_scores Q={q_} M={m_} "
                                             f"K={k_dim}: integer-valued "
                                             f"inputs differ from plain")
                    outs.append(got)
                    n += 1
                if not (torch.equal(outs[1], outs[2])
                        and torch.equal(outs[1], outs[3])):
                    raise AssertionError(f"pairwise_scores Q={q_} M={m_}: "
                                         f"bool, uint8 and f32 valid differ")
    return n

def chunk_sweep(torch, ts, name, a, kw) -> dict:
    """A top-k kernel (``scored_topk`` or ``scored_topk_gathered``) on one
    call's inputs at other chunk counts than its policy's: the time of
    each, and the same ids and scores (the total order makes the result
    independent of the chunking).  Also its time at other widths of top-k:
    k = 1 keeps the lists nearly empty, so it reads the cost of the scan
    alone."""
    fn = getattr(ts, name)
    kernel, counts, kpos = {
        "scored_topk": (ts.PAIRWISE_KERNEL, (1, 4, 8, 12, 16, 24, 32, 48), 3),
        "scored_topk_gathered": (ts.GATHERED_KERNEL,
                                 (1, 2, 4, 6, 8, 9, 12, 16, 24, 33, 66), 4),
    }[name]
    chunks = ts.resolve_chunks(kernel, a[0].device, a[0].shape[0],
                               a[1].shape[-2])
    want = fn(*a, **kw)
    by_k = {k: gpu_ms(torch, lambda: fn(*a[:kpos], k, *a[kpos + 1:], **kw))
            for k in (1, 2, 10, 32)}
    sweep = {}
    for n in counts:
        got = fn(*a, **kw, chunks=n)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} at {n} chunks differs from "
                                 f"{chunks} chunks")
        sweep[n] = gpu_ms(torch, lambda: fn(*a, **kw, chunks=n), reps=10)
    return {"chunks": chunks, "chunk_sweep_ms": sweep, "ms_by_k": by_k}


# cuGraphNodeGetType's CUgraphNodeType values (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(torch, fn) -> dict:
    """The device work one call of ``fn`` enqueues, by kind ({"kernel": 1,
    "memset": ...}), read from a CUDA graph of one call through the driver
    API.  ``torch.profiler`` dropped one of every four records of a
    contraction kernel in this script, in every session; a graph holds
    every node.  A warm-up call on the capture stream first makes what
    persists between calls on a stream (its ticket counters) outside the
    graph."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    counts = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")
        counts[name] = counts.get(name, 0) + 1
    del g
    torch.cuda.synchronize()
    return counts


def kernels_per_call(torch, fn, calls: int = 4, tries: int = 5) -> tuple:
    """How many device kernels one call of ``fn`` launches, as
    ``torch.profiler`` records them over ``calls`` calls (after a warm-up
    call), the kernels' names, and the sessions it took.  Now and then a
    session records no device activity, or loses some of it (4 calls of a
    one-kernel function recorded 3 kernels): a session whose kernels are
    not a whole number a call is repeated, up to ``tries`` sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names and len(names) % calls == 0:
            return len(names) / calls, sorted(set(names)), session
    raise AssertionError(f"the profiler recorded no whole number of kernels "
                         f"a call in {tries} sessions")


def streaming_phase(torch, card, all_kernels, replay, cl_spec,
                    scale_spec, tmp) -> dict:
    """Phase 10: out-of-core streaming at full size.  ``cl_spec`` is the
    Table 2 stand-in held against the in-memory fits, ``scale_spec`` the
    file held against ``sparse_torch`` and timed, both written into ``tmp``
    (their paths are returned for phase 12); ``replay`` is phase 8's query
    replay.  Counts every kernel's launches on the streaming path
    alone: each streamed call runs with every count set to 0 just before it
    and read just after, so the in-memory and SciPy fits it is held against
    add nothing.  Prints one line; returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.chunked import gee_chunked
    from repro_torch.core.fold import fold_degrees, fold_z
    from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                      class_weight_inv, gee_scipy)
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import load_file, synth_to_disk
    from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, ChunkedEdgeList,
                                      open_edge_list)
    from repro_torch.graph.prefetch import (DEFAULT_PREFETCH_DEPTH,
                                            prefetch_windows)
    from repro_torch.launch.gee_search import recall_at_k

    all_on, all_off = GEEEmbedder(num_classes=1).options, GEEOptions()
    stream = {"card": card, "cl_path": os.path.join(tmp, "cl.geeb"),
              "scale_path": os.path.join(tmp, "scale.geeb")}
    stream_launches = dict.fromkeys(all_kernels, 0)

    def on_path(fn):
        """Run one call of the streaming path, counting its launches."""
        for k_fn in all_kernels.values():
            k_fn.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for name, k_fn in all_kernels.items():
            stream_launches[name] += k_fn.launches
        return out

    # the Table 2 stand-in and the scale file, one entry per undirected
    # edge, written by the port's own writer
    cl_path = stream["cl_path"]
    t0 = time.perf_counter()
    synth_to_disk(cl_spec, cl_path, seed=0)
    stream["cl_write_s"] = time.perf_counter() - t0
    cl_file = load_file(cl_path)           # materialized on the card
    cl_k = cl_file.spec.num_classes
    cl_prep = PreparedGraph(cl_file.edges)
    cl_labels = cl_file.labels
    cl_windows = open_edge_list(cl_path).num_windows

    t0 = time.perf_counter()
    parity = {}
    for opts in ALL_OPTION_SETTINGS:
        z_s = on_path(lambda: GEEEmbedder(
            num_classes=cl_k, options=opts).fit_transform_file(cl_path))
        z_m = GEEEmbedder(num_classes=cl_k, options=opts,
                          backend="cuda").fit_transform(cl_prep,
                                                        cl_labels)
        if z_s.shape != (cl_file.spec.num_nodes, cl_k) \
                or not bool(torch.isfinite(z_s).all()):
            raise AssertionError(f"streamed {opts.tag()}: bad output")
        parity[opts.tag()] = max_err(torch, z_s, z_m)
    # the default setting against the host SciPy reference
    src, dst, w = cl_file.edges.valid_arrays()
    z_host = gee_scipy(src, dst, w, cl_labels, cl_k, all_on)
    z_s = on_path(lambda: GEEEmbedder(
        num_classes=cl_k).fit_transform_file(cl_path))
    scipy_stream = max_err(torch, z_s.cpu(), torch.from_numpy(z_host))
    # prefetch depths 0 and 2 on the same file
    by_depth = {d: on_path(lambda: gee_chunked(
        open_edge_list(cl_path), cl_labels, cl_k, all_on,
        prefetch_windows=d)) for d in (0, DEFAULT_PREFETCH_DEPTH)}
    depth_err = max_err(torch, by_depth[0],
                        by_depth[DEFAULT_PREFETCH_DEPTH])
    z_m = GEEEmbedder(num_classes=cl_k, backend="cuda").fit_transform(
        cl_prep, cl_labels)
    depth_vs_mem = [max_err(torch, z, z_m) for z in by_depth.values()]
    # retrieval over the streamed embedding: the index build, replays at
    # the default nprobe and at full probe, and brute force
    emb = on_path(lambda: GEEEmbedder(num_classes=cl_k).fit_file(
        cl_path))
    s_index = on_path(emb.build_index)
    rows = np.random.default_rng(11).integers(
        0, cl_file.spec.num_nodes, N_QUERIES)
    ids_d, sc_d, _, _ = on_path(lambda: replay(s_index, rows))
    ids_f, sc_f, _, _ = on_path(lambda: replay(
        s_index, rows, nprobe=s_index.num_cells))
    zq = s_index.z[torch.from_numpy(rows).to(DEVICE)]
    got = on_path(lambda: [
        s_index.search(zq[lo:lo + FLUSH], TOP_K, brute_force=True)
        for lo in range(0, zq.shape[0], FLUSH)])
    ids_b = torch.cat([i for i, _ in got]).cpu().numpy()
    sc_b = torch.cat([s_ for _, s_ in got]).cpu().numpy()
    if not np.array_equal(sc_f, sc_b):
        raise AssertionError("streamed index: full probe != brute force")
    s_recall = recall_at_k(ids_d, sc_d, ids_b, sc_b)
    s_nprobe = s_index.nprobe
    torch.cuda.synchronize()
    stream["cl_s"] = time.perf_counter() - t0
    stream.update(cl_parity=parity, cl_scipy=scipy_stream,
                  cl_depth_err=depth_err, cl_depth_vs_mem=depth_vs_mem,
                  cl_windows=cl_windows, cl_recall=s_recall,
                  cl_nprobe=s_nprobe)
    del cl_prep, cl_file, z_s, z_m, by_depth, emb, s_index

    # the scale file: 2,000,000 nodes, 50,000,000 undirected entries
    spec = scale_spec
    sc_path = stream["scale_path"]
    t0 = time.perf_counter()
    synth_to_disk(spec, sc_path, seed=0)
    stream["scale_write_s"] = time.perf_counter() - t0
    sc_src = open_edge_list(sc_path)
    sc_labels = np.load(sc_path + ".labels.npy")
    n, k, window = spec.num_nodes, spec.num_classes, sc_src.window_edges
    depth = DEFAULT_PREFETCH_DEPTH
    # what the streamed fit may hold on the card, whatever E is: Z's
    # float64 accumulator, its f32 rounding and the epilogue's two
    # [N, K] results (5 f32 units), six [N] f32 units (labels, the
    # float64 degrees, their f32 rounding, dinv), the windows in flight
    # (the one folded, ``depth`` queued, one being staged and one more
    # the reader may hold; 12 B an entry), a both-directions window's
    # fold temporaries (<= 160 B an entry) and 64 MiB of allocator
    # rounding
    bound = (5 * 4 * n * k + 6 * 4 * n + (depth + 3) * 12 * window
             + 2 * window * 160 + (64 << 20))

    def streamed(opts):
        return on_path(lambda: gee_chunked(sc_src, sc_labels, k, opts))

    scale = {"windows": sc_src.num_windows, "window": window,
             "bound_bytes": bound}
    for opts in (all_off, all_on):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        z_s = streamed(opts)
        torch.cuda.synchronize()
        peak_s = torch.cuda.max_memory_allocated() - base
        if peak_s >= bound:
            raise AssertionError(f"streamed peak {peak_s} B >= bound "
                                 f"{bound} B")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streamed(opts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t_med = float(np.median(times))
        del z_s
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sc_mem = PreparedGraph(load_file(sc_path).edges)
        z_m = GEEPlan.build(sc_mem, k, opts,
                            backend="sparse_torch").execute(sc_labels)
        torch.cuda.synchronize()
        peak_m = torch.cuda.max_memory_allocated() - base
        err = max_err(torch, streamed(opts), z_m)
        del sc_mem, z_m
        scale[opts.tag()] = {
            "max_err": err, "host_ms_median_of_3": t_med * 1e3,
            "host_ms": [t * 1e3 for t in times],
            "edges_per_s": 2 * spec.num_edges / t_med,
            "peak_bytes_streamed": peak_s,
            "peak_bytes_in_memory": peak_m}

    # where a streamed fit's time goes (no options, one pass, host
    # clock, median of 3): the same fit with synchronous copies, the
    # pipeline alone (read, ring fill, copy; nothing folded) and the
    # fold alone over the whole file already on the card
    def ingest():
        for _ in prefetch_windows(sc_src, depth, device=DEVICE).windows():
            pass

    resident = ChunkedEdgeList(
        src=torch.from_numpy(np.asarray(sc_src.src)).to(DEVICE),
        dst=torch.from_numpy(np.asarray(sc_src.dst)).to(DEVICE),
        weight=torch.from_numpy(np.asarray(sc_src.weight)).to(DEVICE),
        num_nodes=n, undirected=True)
    scale["split_ms"] = {
        "depth_0": host_ms(torch, lambda: gee_chunked(
            sc_src, sc_labels, k, all_off, prefetch_windows=0), 3),
        "pipeline_alone": host_ms(torch, ingest, 3),
        "fold_alone_resident": host_ms(torch, lambda: gee_chunked(
            resident, sc_labels, k, all_off), 3)}
    del resident

    # the device's busy share over one streamed fit (union of the
    # kernels' and copies' intervals that torch.profiler records, over
    # the host-clock time of the fit under the profiler)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streamed(all_on)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, records = device_busy(torch, prof)
    scale["busy_share_profiler"] = busy_us / wall_us
    scale["profiler_device_records"] = records

    # the fold's device time for one window, by CUDA events: the H2D
    # copy from pinned memory, the degree fold, the class fold
    w0 = next(iter(sc_src.windows()))
    pinned = [t.pin_memory() for t in (w0.src, w0.dst, w0.weight)]
    dev = [t.to(DEVICE) for t in pinned]
    lab = torch.from_numpy(sc_labels).to(DEVICE)
    winv = class_weight_inv(lab, k)
    dinv = torch.rand(n, device=DEVICE)
    deg = torch.zeros(n, device=DEVICE)
    z = torch.zeros(n * k, device=DEVICE)
    scale["window_copy_ms"] = gpu_ms(
        torch, lambda: [t.to(DEVICE, non_blocking=True) for t in pinned])
    scale["window_fold_degrees_ms"] = gpu_ms(
        torch, lambda: fold_degrees(deg, *dev, undirected=True))
    scale["window_fold_z_ms"] = gpu_ms(
        torch, lambda: fold_z(z, *dev, lab, winv, dinv, num_classes=k,
                              undirected=True))
    # all on: two passes, so two copies a window
    scale["busy_share_events"] = (
        sc_src.num_windows * (2 * scale["window_copy_ms"]
                              + scale["window_fold_degrees_ms"]
                              + scale["window_fold_z_ms"])
        / scale[all_on.tag()]["host_ms_median_of_3"])
    stream["scale"] = scale

    # the entry points, each in a process of its own
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gee_run",
         "--edge-file", cl_path, "--lap", "--diag", "--cor", "--verify"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    if run.returncode != 0 or \
            "0 entries off the row tolerance: ok" not in run.stdout:
        raise AssertionError(f"gee_run --edge-file failed "
                             f"(rc {run.returncode}):\n{run.stdout}\n"
                             f"{run.stderr[-4000:]}")
    report_path = os.path.join(tmp, "gee_search.json")
    search = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gee_search",
         "--edge-file", cl_path, "--nprobe", str(cl_k), "--queries",
         str(N_QUERIES), "--json", report_path],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    if search.returncode != 0:
        raise AssertionError(f"gee_search --edge-file failed "
                             f"(rc {search.returncode}):\n"
                             f"{search.stdout}\n{search.stderr[-4000:]}")
    with open(report_path) as f:
        search_report = json.load(f)
    if search_report["recall_at_k"] != 1.0:
        raise AssertionError(f"gee_search --edge-file at full probe: "
                             f"recall {search_report['recall_at_k']}")
    stream["gee_run_stdout"] = run.stdout
    stream["gee_search"] = {k_: v for k_, v in search_report.items()
                            if k_ != "service_stats"}
    for name in ("row_norm", "pairwise_scores", "scored_topk_gathered"):
        if stream_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the streaming "
                                 f"path")
    stream["launches"] = stream_launches
    sc_on, sc_off = scale[all_on.tag()], scale[all_off.tag()]
    say(f"phase 10 streaming ({card}): {cl_spec.name} written in "
        f"{stream['cl_write_s']:.1f} s, {cl_windows} windows of "
        f"{DEFAULT_CHUNK_EDGES}: fit_transform_file vs the in-memory cuda "
        f"fit of load_file, 8 settings {fmt_err(parity.values())}; default "
        f"vs host gee_scipy {fmt_err([scipy_stream])}; prefetch 0 vs 2 "
        f"{fmt_err([depth_err])} (each vs in-memory "
        f"{fmt_err(depth_vs_mem)}); streamed index: full probe == brute "
        f"force, recall@10 {s_recall:.4f} at nprobe {s_nprobe}; "
        f"launches {stream_launches} in {stream['cl_s']:.1f} s | scale "
        f"N={spec.num_nodes} E={spec.num_edges} K={k} written in "
        f"{stream['scale_write_s']:.1f} s, {scale['windows']} windows: "
        f"vs in-memory sparse_torch {all_off.tag()} "
        f"{fmt_err([sc_off['max_err']])}, {all_on.tag()} "
        f"{fmt_err([sc_on['max_err']])}; streamed fit (median of 3, host "
        f"clock) {sc_off['host_ms_median_of_3']:.1f} ms "
        f"({sc_off['edges_per_s'] / 1e6:.1f} M directed edges/s) "
        f"{all_off.tag()}, {sc_on['host_ms_median_of_3']:.1f} ms "
        f"({sc_on['edges_per_s'] / 1e6:.1f} M/s) {all_on.tag()}; device "
        f"busy {scale['busy_share_profiler']:.3f} of the fit (profiler, "
        f"{scale['profiler_device_records']} records; "
        f"{scale['busy_share_events']:.3f} from per-window event times); "
        f"per window: copy {scale['window_copy_ms']:.4f} ms, degree fold "
        f"{scale['window_fold_degrees_ms']:.4f} ms, class fold "
        f"{scale['window_fold_z_ms']:.4f} ms; split of the no-option fit "
        f"(ms): " + " ".join(f"{key} {v:.1f}"
                             for key, v in scale["split_ms"].items())
        + f"; peak device memory streamed "
        f"{sc_on['peak_bytes_streamed'] / 2**20:.1f} MiB (bound "
        f"{bound / 2**20:.1f} MiB) vs in-memory "
        f"{sc_on['peak_bytes_in_memory'] / 2**20:.1f} MiB; gee_run "
        f"--edge-file --verify ok, gee_search --edge-file recall@10 "
        f"{search_report['recall_at_k']:.4f} at full probe")
    return stream


def serving_phase(torch, card, all_kernels) -> dict:
    """Phase 11: serving under deltas.  (1) 8-setting parity of
    ``partial_fit`` on an SBM against fresh ``cuda`` and ``sparse_torch``
    fits of the mutated graph; (2) ``gee_stream`` on ``STREAM_DATASET``
    through ``GEEDeltaServer`` and a ``GEEQueryService`` on a live index,
    256 batches with no options and as many as ``STREAM_ALL_ON_S`` allows
    with all on, each against a cold from-scratch ``cuda`` fit and a warm
    ``sparse_torch`` refit of the mutated graph; (3) ``gee_stream
    --snapshot-dir`` SIGKILLed after two snapshots, recovered, against an
    uninterrupted run; (4) two replicas behind a router: a strict read
    catches one up, a full router sheds.  Counts every kernel's launches on
    the serving path alone (promotion, updates, repairs, query flushes,
    recovery, replica reads) and, apart, those of the phase's own checks
    (Z read back for comparison, full probe against brute force, the
    directories recovered to compare); the comparison fits run outside
    both.  Prints one line; returns the numbers."""
    import gc
    import signal

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.gee import ALL_OPTION_SETTINGS, gee_sparse_torch
    from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
    from repro_torch.graph.delta import (edge_delta_from_numpy,
                                         label_delta_from_numpy,
                                         symmetrize_delta)
    from repro_torch.graph.sbm import sample_sbm
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import row_norm as row_norm_mod
    from repro_torch.launch import gee_stream
    from repro_torch.launch.gee_search import recall_at_k
    from repro_torch.search import index as index_mod
    from repro_torch.search.service import LoadShedError
    from repro_torch.serve.replica import GEEReplica, ReplicaRouter
    from repro_torch.serve.snapshot import GEESnapshotter, recover

    device = DEVICE
    serving = {"card": card}
    launches = dict.fromkeys(all_kernels, 0)
    checks = dict.fromkeys(all_kernels, 0)
    kernel_errs = {"pairwise_scores": [], "row_norm": []}

    def counted(into, fn):
        """Run ``fn`` with every count set to 0 just before it, adding what
        it launched to ``into`` (a call that raises, as a shed read does,
        counts what it launched)."""
        for k_fn in all_kernels.values():
            k_fn.launches = 0
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for name, k_fn in all_kernels.items():
                into[name] += k_fn.launches
        return out

    def on_path(fn):
        """One call of the serving path."""
        return counted(launches, fn)

    def on_check(fn):
        """One of the phase's own checks."""
        return counted(checks, fn)

    # -- (1) parity under all 8 settings --------------------------------------
    t0 = time.perf_counter()
    s = sample_sbm(PARITY_NODES, seed=0, device="cpu")
    k = s.num_classes
    src, dst, w = s.edges.valid_arrays()
    keep = src < dst                              # one entry an edge
    rng = np.random.default_rng(0)
    perm = rng.permutation(int(keep.sum()))
    su, du, wu = src[keep][perm], dst[keep][perm], w[keep][perm]
    n_hold = su.size // 5                         # 20 % held out
    base = symmetrize(edge_list_from_numpy(
        su[n_hold:], du[n_hold:], wu[n_hold:], PARITY_NODES, device=device))
    parity = {}
    for opts in ALL_OPTION_SETTINGS:
        emb = GEEEmbedder(num_classes=k, options=opts, backend="cuda",
                          device=device).fit(base, s.labels)
        brng = np.random.default_rng(1)
        cancel = iter(np.random.default_rng(2).permutation(su.size - n_hold)
                      + n_hold)
        errs = []
        for b in range(PARITY_BATCHES):
            # 56 held-out edges in, 8 base edges cancelled (weight -w)
            ins = slice(b * 56, (b + 1) * 56)
            out_ = [next(cancel) for _ in range(8)]
            delta = symmetrize_delta(edge_delta_from_numpy(
                np.r_[su[ins], su[out_]], np.r_[du[ins], du[out_]],
                np.r_[wu[ins], -wu[out_]]))
            nodes = brng.integers(0, PARITY_NODES, 2)
            ldelta = label_delta_from_numpy(
                nodes, brng.integers(-1, k, 2).astype(np.int32))
            on_path(lambda: emb.partial_fit(delta).partial_fit(ldelta))
            if (b + 1) % 8:
                continue
            z = on_path(emb.transform)
            cur, y = emb.current_edges(), emb._labels
            z_fit = GEEEmbedder(num_classes=k, options=opts, backend="cuda",
                                device=device).fit_transform(cur, y)
            z_sp = gee_sparse_torch(cur, y, k, opts)
            if z.shape != (PARITY_NODES, k) or \
                    not bool(torch.isfinite(z).all()):
                raise AssertionError(f"partial_fit {opts.tag()}: bad Z")
            errs += [max_err(torch, z, z_fit), max_err(torch, z, z_sp)]
        parity[opts.tag()] = worst(errs)
        del emb
    torch.cuda.synchronize()
    serving["parity"] = parity
    serving["parity_s"] = time.perf_counter() - t0

    # -- (2) the full-width stream --------------------------------------------
    def stream(flags, batches, seconds=None):
        args = gee_stream.parse_args(
            ["--dataset", STREAM_DATASET, "--stream-frac", "0.01",
             "--batch", "64", "--max-batches", str(batches),
             "--queries", str(FLUSH), "--k", str(TOP_K),
             "--verify-every", "0", "--seed", "0", "--device", str(device)]
            + flags + ([] if seconds is None
                       else ["--max-seconds", str(seconds)]))
        # the profiler records the batches alone (not the promotion)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        out = on_path(lambda: gee_stream.run(args, around_batches=prof))
        inc, index = out["inc"], out["index"]
        busy_us, records = device_busy(torch, prof)
        by_kind, by_name = device_time_by_kind(torch, prof)
        # the update-against-recompute gap, against two refits of the
        # mutated graph outside the counted calls: a cold from-scratch cuda
        # fit (packing paid again) and a warm sparse_torch fit (no packing;
        # the median of REFIT_REPS after one warm-up), then an index build
        # over the refit, against a batch's update and repair
        cur = inc.to_edge_list()
        tf = time.perf_counter()
        z_fit = GEEEmbedder(num_classes=inc.k, options=inc.opts,
                            backend="cuda", device=device
                            ).fit_transform(cur, inc.labels)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - tf) * 1e3
        yt = torch.from_numpy(inc.labels).to(device)
        z_sp = gee_sparse_torch(cur, yt, inc.k, inc.opts)
        refit_ms = host_ms(torch, lambda: gee_sparse_torch(
            cur, yt, inc.k, inc.opts), REFIT_REPS)
        rebuild_ms = host_ms(torch, lambda: index_mod.ClassPartitionedIndex
                             .build(z_sp, inc.labels, inc.k), REFIT_REPS)
        z = on_check(inc.embedding)
        err = worst([max_err(torch, z, z_fit), max_err(torch, z, z_sp)])
        # the top 10 at full probe equals brute force (near ties as sets)
        rows = np.random.default_rng(5).integers(0, inc.n, 4 * FLUSH)
        zq = index.z[torch.from_numpy(rows).to(device)]
        ids_f, sc_f = on_check(lambda: index.search(
            zq, TOP_K, nprobe=index.num_cells))
        ids_b, sc_b = on_check(lambda: index.search(zq, TOP_K,
                                                    brute_force=True))
        ties = same_topk(ids_f.cpu().numpy(), sc_f.cpu().numpy(),
                         ids_b.cpu().numpy(), sc_b.cpu().numpy(),
                         term_scale(torch, zq, index.z, "l2").cpu().numpy())
        # the path's kernel inputs against the plain versions (uncounted):
        # a full repair's scoring (a label flip's shape) and, with
        # correlation, a full refresh's row norm
        every = np.arange(inc.n)
        with Recorder(index_mod, "pairwise_scores", keep=1) as rec_p:
            index.update_rows(every, inc.embedding(every))
        with Recorder(row_norm_mod, "row_norm", keep=1) as rec_n:
            inc._materialize_rows(every, inc._winv())
        for a, kw in rec_p.calls:
            kernel_errs["pairwise_scores"].append(score_err(
                torch, all_kernels["pairwise_scores"](*a, **kw),
                ref_mod.pairwise_scores_ref(a[0], a[1], a[2], kw["metric"]),
                term_scale(torch, a[0], a[1], kw["metric"])))
        for a, kw in rec_n.calls:
            kernel_errs["row_norm"].append(max_err(
                torch, all_kernels["row_norm"](*a, **kw),
                ref_mod.row_norm_ref(*a, **kw)))
        upd, q = np.asarray(out["update_ms"]), np.asarray(out["query_ms"])
        flush_p50 = float(np.percentile(upd, 50))
        upd_rep_p50 = float(np.percentile(upd + np.asarray(out["repair_ms"]),
                                          50))
        res = {
            "batches": out["batches_run"], "stream_s": out["stream_s"],
            "promote_host_ms": out["promote_ms"],
            "flush_ms_p50": flush_p50,
            "flush_ms_p95": float(np.percentile(upd, 95)),
            "rows_recomputed_per_batch": float(np.mean(
                out["rows_recomputed"])),
            "row_edges_scanned_per_batch": float(np.mean(
                out["row_edges_scanned"])),
            "repair_ms_p50": float(np.percentile(out["repair_ms"], 50)),
            "repair_rows_per_batch": float(np.mean(out["repair_rows"])),
            "bucket_moves_per_batch": float(np.mean(out["repair_moves"])),
            "query_flush_ms_p50": float(np.percentile(q, 50)),
            "busy_share": busy_us / (out["stream_s"] * 1e6),
            "profiler_device_records": records,
            "device_us_per_batch_by_kind": {
                kind: v["us"] / out["batches_run"]
                for kind, v in by_kind.items()},
            "device_records_by_kind": {
                kind: v["records"] for kind, v in by_kind.items()},
            "top_kernels_us_per_batch": {
                name[:100]: us / out["batches_run"] for name, us in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:8]},
            "cold_cuda_fit_ms": fit_ms, "warm_sparse_torch_fit_ms": refit_ms,
            # above 1, a batch's flush is faster than the faster refit
            "refit_over_flush_p50": min(fit_ms, refit_ms) / flush_p50,
            "index_rebuild_ms": rebuild_ms,
            "update_and_repair_ms_p50": upd_rep_p50,
            # the same with the index: a refit and a rebuild against a
            # batch's update and repair
            "refit_and_rebuild_over_update_and_repair_p50":
                (min(fit_ms, refit_ms) + rebuild_ms) / upd_rep_p50,
            "max_err": err,
            "near_tie_groups": len(ties), "watermark": out["watermark"]}
        del out, inc, index, cur, z_fit, z_sp, z, prof
        gc.collect()
        return res

    t0 = time.perf_counter()
    plain = stream([], STREAM_BATCHES)
    all_on = stream(["--lap", "--diag", "--cor"], STREAM_BATCHES,
                    STREAM_ALL_ON_S)
    if all_on["batches"] < 8:
        raise AssertionError(f"all-on stream ran {all_on['batches']} "
                             f"batches, fewer than 8")
    serving["stream"] = {"none": plain, "all_on": all_on}
    serving["stream_s"] = time.perf_counter() - t0

    # -- (3) kill and recover -------------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    kill_args = ["--sbm", str(KILL_NODES), "--lap", "--diag", "--batch", "64",
                 "--stream-frac", "0.2", "--max-batches", str(KILL_BATCHES),
                 "--snapshot-every", "2", "--verify-every", "0", "--seed",
                 "3", "--device", str(device)]

    def spawn(directory, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.gee_stream",
             *kill_args, "--snapshot-dir", directory, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)

    def finish(proc, what):
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate(timeout=60)
        if proc.returncode != 0:
            raise AssertionError(f"gee_stream {what} failed (rc "
                                 f"{proc.returncode}):\n{out[-4000:]}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ref_dir, kill_dir = (os.path.join(tmp, d) for d in ("ref", "kill"))
        procs = [spawn(ref_dir)]
        child = spawn(kill_dir)
        procs.append(child)
        try:
            # kill once two snapshots exist and the WAL holds a record past
            # the newer one, so the recovery below replays a batch
            snaps = os.path.join(kill_dir, "snapshots")
            wal = os.path.join(kill_dir, "wal")
            deadline = time.time() + 600
            killed = False
            while time.time() < deadline and child.poll() is None:
                steps = sorted(int(d[5:]) for d in (
                    os.listdir(snaps) if os.path.isdir(snaps) else ())
                    if d.startswith("step_"))
                recs = [int(r[4:14]) for r in (
                    os.listdir(wal) if os.path.isdir(wal) else ())
                    if r.startswith("rec_")]
                if len(steps) >= 2 and any(r >= steps[-1] for r in recs):
                    child.send_signal(signal.SIGKILL)
                    child.wait(timeout=60)
                    killed = True
                    break
                time.sleep(0.05)
            if not killed:
                raise AssertionError("the stream ended before the kill "
                                     "point")
            # recovery of the killed directory as found: snapshot load and
            # WAL replay, timed by its timeline
            found = on_path(lambda: recover(kill_dir, device=device))
            timeline = {e["event"]: e for e in found.timeline}
            del found
            resumed = finish(spawn(kill_dir, "--recover"), "--recover")
            finish(procs[0], "uninterrupted")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        ref = on_check(lambda: recover(ref_dir, device=device))
        rec = on_check(lambda: recover(kill_dir, device=device))
        if rec.inc.applied_seq != ref.inc.applied_seq:
            raise AssertionError(f"watermarks differ: recovered "
                                 f"{rec.inc.applied_seq}, uninterrupted "
                                 f"{ref.inc.applied_seq}")
        for name in ("S", "nk", "deg", "_dinv", "labels"):
            if not np.array_equal(getattr(rec.inc, name),
                                  getattr(ref.inc, name)):
                raise AssertionError(f"recovered {name} differs")
        z_ref = on_check(ref.inc.embedding)
        z_rec = on_check(rec.inc.embedding)
        kill_err = float((z_rec.double() - z_ref.double()).abs().max())
        if kill_err > 1e-5:
            raise AssertionError(f"recovered Z off by {kill_err:.3g}")
        rows = np.arange(0, KILL_NODES, 7)
        rq = torch.from_numpy(rows).to(device)
        ids_b, sc_b = on_check(lambda: ref.index.search(
            z_ref[rq], TOP_K, brute_force=True))
        ids_r, sc_r = on_check(lambda: rec.index.search(
            z_rec[rq], TOP_K, nprobe=rec.index.num_cells))
        same_topk(ids_r.cpu().numpy(), sc_r.cpu().numpy(),
                  ids_b.cpu().numpy(), sc_b.cpu().numpy(),
                  term_scale(torch, z_rec[rq], z_rec, "l2").cpu().numpy())
        if recall_at_k(ids_r.cpu().numpy(), sc_r.cpu().numpy(),
                       ids_b.cpu().numpy(), sc_b.cpu().numpy()) != 1.0:
            raise AssertionError("recovered top 10 != brute force")
        # one snapshot of the recovered state, timed (quiesce, capture,
        # durable write)
        snap = GEESnapshotter(os.path.join(tmp, "timed"), every=10**9)
        ts = time.perf_counter()
        snap.snapshot(rec.inc, rec.index)
        snapshot_ms = (time.perf_counter() - ts) * 1e3
        snap.close()
        serving["kill"] = {
            "watermark": int(rec.inc.applied_seq), "max_abs_err": kill_err,
            "snapshot_ms": snapshot_ms,
            "recover_load_ms": timeline["load_snapshot"]["ms"],
            "recover_replay_ms": timeline["replay"]["ms"],
            "recover_replayed_deltas": timeline["replay"][
                "replayed_deltas"],
            "recover_total_ms": timeline["recovered"]["ms"],
            "resumed_line": next(line for line in resumed.splitlines()
                                 if "recovered snapshot step" in line)}
        del ref

        # -- (4) replicas -------------------------------------------------
        reps = on_path(lambda: [GEEReplica.from_directory(
            kill_dir, name=f"r{i}", device=device, flush_every=10**9,
            max_pending=2 * FLUSH) for i in range(2)])
        router = ReplicaRouter(reps, max_lag=0)
        prng = np.random.default_rng(9)
        router.publish([edge_delta_from_numpy(
            prng.integers(0, KILL_NODES, 64), prng.integers(0, KILL_NODES, 64),
            np.ones(64, np.float32))])
        behind = [r.watermark for r in reps]
        ids, _ = on_path(lambda: router.read_rows(np.arange(FLUSH), TOP_K,
                                                  max_lag=0))
        if max(r.watermark for r in reps) != router.head_seq \
                or ids.shape != (FLUSH, TOP_K):
            raise AssertionError("a strict read did not catch up")
        shed = 0
        for _ in range(5):                  # 5 x 64 > 2 x 128 slots
            try:
                on_path(lambda: router.submit_rows(np.arange(FLUSH)))
            except LoadShedError:
                shed += 1
        if shed != 1:
            raise AssertionError(f"{shed} reads shed, not 1")
        on_path(router.flush_all)
        serving["replicas"] = {
            "watermarks_before": behind, "head_seq": router.head_seq,
            "stats": router.stats.to_dict()}
        router.close()
        del rec, reps
    serving["kill_s"] = time.perf_counter() - t0

    # the serving path launches row_norm (Z refreshes with correlation),
    # pairwise_scores (repairs, probes) and scored_topk_gathered (query
    # flushes, replica reads); scored_topk only the checks' brute force
    for name in ("row_norm", "pairwise_scores", "scored_topk_gathered"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 f"path")
    if checks["scored_topk"] <= 0:
        raise AssertionError("scored_topk never launched by the checks' "
                             "brute force")
    serving["launches"] = launches
    serving["launches_checks"] = checks
    serving["kernel_errs"] = kernel_errs

    def stream_line(tag, r):
        return (f"{tag}: {r['batches']} batches, promotion "
                f"{r['promote_host_ms']:.0f} ms, flush p50 "
                f"{r['flush_ms_p50']:.2f} p95 {r['flush_ms_p95']:.2f} ms, "
                f"{r['rows_recomputed_per_batch']:.0f} rows recomputed and "
                f"{r['row_edges_scanned_per_batch']:.0f} row edges scanned "
                f"a batch, index repair p50 {r['repair_ms_p50']:.2f} ms "
                f"({r['repair_rows_per_batch']:.0f} rows, "
                f"{r['bucket_moves_per_batch']:.1f} moved), query flush "
                f"p50 {r['query_flush_ms_p50']:.3f} ms, device busy "
                f"{r['busy_share']:.4f} ({r['profiler_device_records']} "
                f"records; us a batch by kind "
                + ", ".join(f"{kind} {us:.1f}" for kind, us in
                            r["device_us_per_batch_by_kind"].items())
                + f"), refit of the mutated graph: cold cuda "
                f"{r['cold_cuda_fit_ms']:.0f} ms, warm sparse_torch "
                f"{r['warm_sparse_torch_fit_ms']:.1f} ms, faster refit / "
                f"flush p50 {r['refit_over_flush_p50']:.3g}, with an index "
                f"rebuild ({r['index_rebuild_ms']:.2f} ms) against update "
                f"and repair p50 {r['update_and_repair_ms_p50']:.2f} ms "
                f"{r['refit_and_rebuild_over_update_and_repair_p50']:.3g}, "
                f"Z vs both "
                f"{fmt_err([r['max_err']])}, full probe == brute "
                f"force ({r['near_tie_groups']} near-tie groups)")

    kl = serving["kill"]
    say(f"phase 11 serving under deltas ({card}): partial_fit on "
        f"sbm-{PARITY_NODES}, {PARITY_BATCHES} batches, 8 settings vs fresh "
        f"cuda and sparse_torch fits {fmt_err(parity.values())} in "
        f"{serving['parity_s']:.1f} s | gee_stream {STREAM_DATASET} "
        + stream_line("no options", plain) + "; "
        + stream_line("all on", all_on)
        + f" | kill and recover (sbm-{KILL_NODES}, Lap+Diag): watermark "
        f"{kl['watermark']}, Z vs uninterrupted max_abs_err "
        f"{kl['max_abs_err']:.3g}, top 10 == brute force; snapshot "
        f"{kl['snapshot_ms']:.1f} ms, recovery {kl['recover_total_ms']:.1f} "
        f"ms (load {kl['recover_load_ms']:.1f}, replay of "
        f"{kl['recover_replayed_deltas']} deltas "
        f"{kl['recover_replay_ms']:.1f}) | replicas: caught up from "
        f"{serving['replicas']['watermarks_before']} to "
        f"{serving['replicas']['head_seq']}, 1 read shed, router "
        f"{serving['replicas']['stats']} | launches_serving {launches}, "
        f"the checks' own {checks}; "
        f"the path's inputs vs plain: " + ", ".join(
            f"{name} {fmt_err(e)}" for name, e in kernel_errs.items()))
    return serving


def window_plane_bytes(path, p: int) -> int:
    """The largest device plane a window of an edge file packs into for the
    ``cuda`` local backend at P ranks, 20 B a slot (cols, vals, scaled
    vals, ylab, contrib); the shape is the packer's own rule
    (``repro_torch.graph.partition.plane_width``)."""
    from repro_torch.core.fold import pad_nodes
    from repro_torch.graph.io import open_edge_list
    from repro_torch.graph.partition import directed_entries, plane_width

    ch = open_edge_list(path)
    most = 0
    for lo in range(0, ch.num_edges, ch.window_edges):
        hi = min(lo + ch.window_edges, ch.num_edges)
        src, _, w = directed_entries(
            np.asarray(ch.src[lo:hi]), np.asarray(ch.dst[lo:hi]),
            np.asarray(ch.weight[lo:hi]), ch.undirected)
        most = max(most, plane_width(src, w, p, laddered=True))
    return pad_nodes(ch.num_nodes, p) * most * 20


def plane_bytes(edges, p: int) -> int:
    """The device plane ``gee_distributed(local_backend="cuda")`` packs for
    one rank at P ranks, 20 B a slot."""
    from repro_torch.core.fold import pad_nodes
    from repro_torch.graph.partition import plane_width

    src, _, w = edges.valid_arrays()
    return pad_nodes(edges.num_nodes, p) * plane_width(src, w, p) * 20


def sharded_phase(torch, card, all_kernels, graphs, prepared, tmp,
                  stream) -> dict:
    """Phase 12: the multi-device folds on one card.

    (a) A real NCCL process group of one rank, joined in this process:
    ``gee_distributed`` with both local backends, ``gee_streamed_sharded``
    over phase 10's ``.geeb`` files and an sbm-10k one, each held against
    the in-memory ``cuda`` fit of the same graph, and the scale file's
    streamed fit timed beside phase 10's ``gee_chunked``.  (b) P = 4 on
    sbm-10k, each rank's body in turn on this card
    (``repro_torch.core.distributed.replay_ranks``: NCCL takes one rank a
    card), held against the same fits and against (a).  Kernel 1 is held
    against its plain version on the shard planes, kernel 2 on the row
    blocks; each kernel's launches on the sharded calls alone are
    ``launches_sharded`` (the replay's are counted apart).  A plane that
    would pass ``PLANE_BUDGET_BYTES`` on the card is not run, and the phase
    says which and why.  Prints one line; returns the numbers."""
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.core import fold as fold_mod
    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.chunked import gee_chunked
    from repro_torch.core.fold import (gather_rows, gee_streamed_sharded,
                                       pad_nodes, world_size)
    from repro_torch.core.gee import ALL_OPTION_SETTINGS, GEEOptions
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import load_file
    from repro_torch.graph.io import (ChunkedEdgeList, open_window_parallel,
                                      save_edge_list, save_labels)
    from repro_torch.graph.partition import shard_edges, shard_edges_to_ell
    from repro_torch.kernels import row_norm as row_norm_mod
    from repro_torch.kernels.gee_spmm import gee_spmm
    from repro_torch.kernels.ref import gee_spmm_ref, row_norm_ref
    from repro_torch.kernels.row_norm import row_norm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.cli import plan_span_coverage

    all_on = GEEOptions(laplacian=True, diag_aug=True, correlation=True)
    all_off = GEEOptions()
    out = {"card": card}
    launches = dict.fromkeys(all_kernels, 0)
    replay_launches = dict.fromkeys(all_kernels, 0)

    def counted(tally, fn):
        for k_fn in all_kernels.values():
            k_fn.launches = 0
        res = fn()
        torch.cuda.synchronize()
        for name, k_fn in all_kernels.items():
            tally[name] += k_fn.launches
        return res

    def cuda_fit(prep, labels, k, opts):
        return GEEEmbedder(num_classes=k, options=opts,
                           backend="cuda").fit_transform(prep, labels)

    # the planes each run would put on the card, reckoned before any runs
    sbm_edges, sbm_labels, sbm_k = graphs["sbm-10k"]
    cl_edges, cl_labels, cl_k = graphs["cl-100k-1d8-l5"]
    sbm_path = os.path.join(tmp, "sbm.geeb")
    save_edge_list(sbm_path, ChunkedEdgeList.from_edge_list(sbm_edges))
    save_labels(sbm_path, sbm_labels)
    plan_b = {"sbm-10k P=1": plane_bytes(sbm_edges, 1),
              "sbm-10k P=4": plane_bytes(sbm_edges, 4),
              "cl-100k-1d8-l5 P=1": plane_bytes(cl_edges, 1),
              "sbm-10k .geeb P=1": window_plane_bytes(sbm_path, 1),
              "cl-100k-1d8-l5 .geeb P=1": window_plane_bytes(
                  stream["cl_path"], 1),
              f"{SCALE_SPEC[0]} .geeb P=1": window_plane_bytes(
                  stream["scale_path"], 1)}
    skipped = {name: f"plane of {b / 2**30:.1f} GiB on the card (budget "
                     f"{PLANE_BUDGET_BYTES / 2**30:.0f} GiB)"
               for name, b in plan_b.items() if b > PLANE_BUDGET_BYTES}
    for name in ("sbm-10k P=1", "sbm-10k P=4", "sbm-10k .geeb P=1"):
        if name in skipped:
            raise AssertionError(f"{name}: {skipped[name]}")
    out["plane_bytes"], out["cuda_backend_not_run"] = plan_b, skipped

    store = os.path.join(tmp, "nccl_store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    part_s = {}
    t0 = time.perf_counter()
    try:
        if world_size() != 1 or dist.get_backend() != "nccl":
            raise AssertionError("not an NCCL group of one rank")
        errs = {}
        # (a) gee_distributed on both graphs, against the in-memory cuda fit
        runs = (("cl-100k-1d8-l5", "segment_sum"), ("sbm-10k", "segment_sum"),
                ("sbm-10k", "cuda"))
        one_rank = {}
        for g, lb in runs:
            edges, labels, k = graphs[g]
            e = []
            for opts in ALL_OPTION_SETTINGS:
                z = counted(launches, lambda: gather_rows(
                    tdist.gee_distributed(edges, labels, k, opts,
                                          local_backend=lb),
                    edges.num_nodes))
                if z.shape != (edges.num_nodes, k) \
                        or not bool(torch.isfinite(z).all()):
                    raise AssertionError(f"{g} {lb} {opts.tag()}: bad "
                                         f"output")
                e.append(max_err(torch, z,
                                 cuda_fit(prepared[g], labels, k, opts)))
                if g == "sbm-10k" and lb == "cuda":
                    one_rank[opts.tag()] = z
            errs[f"distributed {g} {lb}"] = worst(e)
        part_s["gee_distributed"] = time.perf_counter() - t0
        # (a) gee_streamed_sharded over edge files: phase 10's cl-100k file
        # (segment_sum; its graph, drawn by window, is not synth_like's)
        # and sbm-10k's directed entries (both local backends)
        cl_file = load_file(stream["cl_path"])
        cl_prep = PreparedGraph(cl_file.edges)
        files = ((stream["cl_path"], cl_prep, cl_file.labels, cl_k,
                  ("segment_sum",)),
                 (sbm_path, prepared["sbm-10k"], sbm_labels, sbm_k,
                  ("segment_sum", "cuda")))
        for path, prep, labels, k, backends in files:
            src = open_window_parallel(path, 1)
            for lb in backends:
                e = []
                for opts in ALL_OPTION_SETTINGS:
                    z = counted(launches, lambda: gather_rows(
                        gee_streamed_sharded(src, labels, k, opts,
                                             local_backend=lb),
                        src.num_nodes))
                    e.append(max_err(torch, z,
                                     cuda_fit(prep, labels, k, opts)))
                errs[f"streamed {os.path.basename(path)} {lb}"] = worst(e)
        del cl_file, cl_prep
        part_s["gee_streamed_sharded files"] = \
            time.perf_counter() - t0 - sum(part_s.values())
        # (a) the scale file, no options and all on: the streamed sharded
        # fit (median of 3, host clock) beside phase 10's gee_chunked and
        # beside gee_chunked timed here in turn (chunked, sharded, sharded,
        # chunked, ...: a streamed fit's time swings between points of a
        # process)
        sc_src = open_window_parallel(stream["scale_path"], 1)
        sc_labels = np.load(stream["scale_path"] + ".labels.npy")
        sc_k = int(sc_labels.max()) + 1
        scale = {}
        for opts in (all_off, all_on):
            def fit():
                return gather_rows(gee_streamed_sharded(
                    sc_src, sc_labels, sc_k, opts), sc_src.num_nodes)

            def chunked():
                return gee_chunked(sc_src, sc_labels, sc_k, opts)
            z = counted(launches, fit)
            err = max_err(torch, z, chunked())
            times = {"sharded": [], "chunked": []}
            for order in (("chunked", "sharded"), ("sharded", "chunked"),
                          ("chunked", "sharded")):
                for name in order:
                    times[name].append(host_ms(torch, (
                        lambda: counted(launches, fit)) if name == "sharded"
                        else chunked, 1))
            scale[opts.tag()] = {
                "max_err_vs_chunked": err,
                "host_ms_median_of_3": float(np.median(times["sharded"])),
                "host_ms": times["sharded"],
                "chunked_host_ms_median_of_3": float(
                    np.median(times["chunked"])),
                "chunked_host_ms": times["chunked"],
                "chunked_host_ms_median_of_3_phase_10":
                    stream["scale"][opts.tag()]["host_ms_median_of_3"]}
        out["scale"] = scale
        part_s["scale"] = time.perf_counter() - t0 - sum(part_s.values())
        # the plan's stage timings: each multi-device backend executed
        # through GEEPlan under the tracer lists every stage's ms; the
        # same execute untraced (median of 3) is the instrumentation's
        # yardstick
        tracer = obs_trace.Tracer()
        prev_tracer = obs_trace.set_tracer(tracer)
        try:
            stages = {}
            for b in ("streamed_sharded", "distributed"):
                plan = GEEPlan.build(prepared["sbm-10k"], sbm_k, all_on,
                                     backend=b)
                untraced = host_ms(torch, lambda: counted(
                    launches, lambda: plan.execute(sbm_labels)), 3)
                tracer.enable()
                counted(launches, lambda: plan.execute(sbm_labels))
                tracer.disable()
                names = [st.name for st in plan.stages]
                if set(plan.last_timings) != set(names) | {"total_ms"}:
                    raise AssertionError(f"{b}: stage timings "
                                         f"{plan.last_timings} miss stages "
                                         f"{names}")
                stages[b] = {"timings_ms": plan.last_timings,
                             "untraced_ms_median_of_3": untraced,
                             "coverage": plan_span_coverage(tracer),
                             "describe": plan.describe(timings=True)}
        finally:
            obs_trace.set_tracer(prev_tracer)
        out["plan_stages"] = stages
        nccl_s = time.perf_counter() - t0
        part_s["plan stages"] = nccl_s - sum(part_s.values())

        # (b) P = 4 on sbm-10k: each rank's body in turn on this card
        t1 = time.perf_counter()
        n_pad = pad_nodes(sbm_edges.num_nodes, 4)
        pre = shard_edges(sbm_edges, 4, device="cpu")
        cols, vals = shard_edges_to_ell(sbm_edges, 4, n_pad, device=DEVICE)
        replay_shards = {
            "segment_sum": [tdist.local_shard(
                pre, 4, r, local_backend="segment_sum", num_rows=n_pad,
                pre_sharded=True, device=DEVICE) for r in range(4)],
            "cuda": [(cols[lo:lo + n_pad], vals[lo:lo + n_pad])
                     for lo in range(0, 4 * n_pad, n_pad)]}
        for lb, shards in replay_shards.items():
            e, e1 = [], []
            for opts in ALL_OPTION_SETTINGS:
                z = counted(replay_launches, lambda: tdist.replay_ranks(
                    shards, sbm_labels, sbm_k, opts,
                    num_nodes=sbm_edges.num_nodes))
                e.append(max_err(torch, z, cuda_fit(
                    prepared["sbm-10k"], sbm_labels, sbm_k, opts)))
                e1.append(max_err(torch, z, one_rank[opts.tag()]))
            errs[f"replay P=4 sbm-10k {lb}"] = worst(e)
            errs[f"replay P=4 sbm-10k {lb} vs NCCL P=1 cuda"] = worst(e1)
        replay_s = time.perf_counter() - t1

        # the kernels against their plain versions on this path's inputs:
        # the P = 1 plane, a P = 4 rank's plane, every window's plane of
        # the sbm-10k stream, and the row blocks
        with Recorder(fold_mod, "gee_spmm", keep=2) as rec_p, \
                Recorder(row_norm_mod, "row_norm", keep=2) as rec_n:
            tdist.gee_distributed(sbm_edges, sbm_labels, sbm_k, all_on,
                                  local_backend="cuda")
            tdist.replay_ranks(replay_shards["cuda"], sbm_labels, sbm_k,
                               all_on, num_nodes=sbm_edges.num_nodes)
        if len(rec_p.calls) < 2:
            raise AssertionError("the shard planes were not captured")
        with Recorder(fold_mod, "gee_spmm") as rec_w:
            gee_streamed_sharded(open_window_parallel(sbm_path, 1),
                                 sbm_labels, sbm_k, all_on,
                                 local_backend="cuda")
        if not rec_w.calls:
            raise AssertionError("the stream's window planes were not "
                                 "captured")
        kernel_errs = {"gee_spmm": [], "row_norm": []}
        planes = {}
        named = list(zip(rec_p.calls, ("P=1", "P=4 rank 0")))
        widest = max(range(len(rec_w.calls)),
                     key=lambda i: rec_w.calls[i][0][0].shape[1])
        for i, call in enumerate(rec_w.calls):
            ylab, contrib, k = call[0]
            if i != widest:        # every window held, the widest timed
                kernel_errs["gee_spmm"].append(max_err(
                    torch, gee_spmm(ylab, contrib, k),
                    gee_spmm_ref(ylab, contrib, k)))
        named.append((rec_w.calls[widest], f"stream window {widest} of "
                      f"{len(rec_w.calls)} (the widest)"))
        for (args, _), name in named:
            ylab, contrib, k = args
            kernel_errs["gee_spmm"].append(max_err(
                torch, gee_spmm(ylab, contrib, k),
                gee_spmm_ref(ylab, contrib, k)))
            slots = ylab.numel()
            planes[name] = {
                "shape": list(ylab.shape),
                "ms": gpu_ms(torch, lambda: gee_spmm(ylab, contrib, k)),
                "plain_ms": gpu_ms(torch, lambda: gee_spmm_ref(
                    ylab, contrib, k), reps=5),
                "bound_ms": (8 * slots + 4 * ylab.shape[0] * k)
                / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        del rec_w
        for args, _ in rec_n.calls:
            zb = args[0]
            kernel_errs["row_norm"].append(max_err(torch, row_norm(zb),
                                                   row_norm_ref(zb)))
        if not rec_n.calls:
            raise AssertionError("no row block reached row_norm")
        torch.cuda.synchronize()
        part_s["kernels vs plain"] = time.perf_counter() - t1 - replay_s
    finally:
        dist.destroy_process_group()
    for name in ("gee_spmm", "row_norm"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the sharded "
                                 f"path")
    out.update(errs={k: list(v) for k, v in errs.items()},
               kernel_errs=kernel_errs, planes=planes, launches=launches,
               replay_launches=replay_launches, nccl_s=nccl_s,
               replay_s=replay_s, part_s=part_s)
    say(f"phase 12 multi-device folds ({card}): (a) an NCCL group of one "
        f"rank, in this process, {nccl_s:.1f} s; (b) P = 4 on sbm-10k, each "
        f"rank's body in turn on this card, {replay_s:.1f} s (by part: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items())
        + "); vs the "
        f"in-memory cuda fit, 8 settings each: "
        + "; ".join(f"{k} {fmt_err([v])}" for k, v in errs.items())
        + f"; {SCALE_SPEC[0]} streamed sharded (median of 3, host clock) "
        + ", ".join(f"{tag} {v['host_ms_median_of_3']:.1f} ms (gee_chunked "
                    f"in turn {v['chunked_host_ms_median_of_3']:.1f} ms, in "
                    f"phase 10 {v['chunked_host_ms_median_of_3_phase_10']:.1f}"
                    f" ms; vs it {fmt_err([v['max_err_vs_chunked']])})"
                    for tag, v in scale.items())
        + "; a traced plan's stages (ms) "
        + "; ".join(f"{b} " + ", ".join(f"{k} {v:.2f}" for k, v in
                                        st["timings_ms"].items())
                    + f" (untraced {st['untraced_ms_median_of_3']:.2f}, "
                    f"coverage {st['coverage']:.3f})"
                    for b, st in stages.items())
        + "; gee_spmm on the shard planes "
        + ", ".join(f"{k} {v['shape']} {v['ms']:.4f} ms (bound "
                    f"{v['bound_ms']:.4f}, plain {v['plain_ms']:.4f})"
                    for k, v in planes.items())
        + f", vs plain {fmt_err(kernel_errs['gee_spmm'])}; row_norm on the "
        f"row blocks vs plain {fmt_err(kernel_errs['row_norm'])}; cuda "
        f"backend not run: {skipped}; launches_sharded {launches}, the "
        f"replay's {replay_launches}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the autotune registry
# ---------------------------------------------------------------------------

def autotune_phase(torch, card, kernels, rkernels, captured, rcaptured,
                   fit, graphs, gcaptured) -> dict:
    """Phase 13.  (a) Every geometry phases 4-9 resolved through
    ``autotune.REGISTRY`` (its memo holds each key a launch looked up) is
    its policy's, with nothing recorded.  (b) Measured search, turned on
    through the API: the contraction kernels on cl-100k-1d8-l5's narrowest
    and widest buckets (the planes phases 4-5 stand for, and the fused
    driver's gathered launches, ``gcaptured``) and ``scored_topk_gathered``
    on a flush of phase 8, each candidate timed by CUDA events, the fastest
    recorded.  (c) A fused and a staged fit of the
    graph and that flush, with the recorded geometry, against the plain
    versions.  (d) The recorded entries saved and loaded into a fresh
    registry.  The recorded entries are cleared at the end.  Prints one
    line; returns the numbers."""
    from repro_torch.core.gee import gee_sparse_torch
    from repro_torch.core.api import GEEEmbedder
    from repro_torch.kernels import gee_spmm as gs
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import topk_score as ts
    from repro_torch.kernels.autotune import REGISTRY, AutotuneRegistry
    from repro_torch.kernels.gee_fused import EPS_NORM

    g = "cl-100k-1d8-l5"
    out = {}
    # (a) with nothing recorded, every resolution is the policy's
    port = (gs.KERNEL_NAME, gs.FUSED_KERNEL_NAME, gs.GATHERED_KERNEL_NAME,
            ts.PAIRWISE_KERNEL, ts.GATHERED_KERNEL)
    if any(REGISTRY.recorded(k) for k in port):
        raise AssertionError(f"entries recorded before phase 13: "
                             f"{REGISTRY.recorded()}")
    sms = ts._sm_count(torch.device(DEVICE))
    policy = {gs.KERNEL_NAME: gs._geometry_policy,
              gs.FUSED_KERNEL_NAME: gs._geometry_policy,
              gs.GATHERED_KERNEL_NAME: gs._geometry_policy,
              ts.PAIRWISE_KERNEL: lambda key: (ts._pairwise_policy(*key),),
              ts.GATHERED_KERNEL: lambda key: (ts._gathered_policy(*key),)}
    resolved = {k: REGISTRY.resolved(k) for k in port}
    for kernel, entries in resolved.items():
        for key, value in entries.items():
            if value != tuple(policy[kernel](key)):
                raise AssertionError(f"{kernel} {key} resolved {value}, "
                                     f"the policy says {policy[kernel](key)}")
    # every launch phases 4-9 captured resolves to its key there
    for gg in graphs:
        for name, calls in captured[gg].items():
            if name == "row_norm":
                continue
            kernel = gs.FUSED_KERNEL_NAME if name == "gee_spmm_fused" \
                else gs.KERNEL_NAME
            for a, _ in calls:
                k = a[4] if name == "gee_spmm_fused" else a[2]
                key = gs.geometry_key(a[0].shape[1], k, gs._vec(a[0], a[1]))
                if key not in resolved[kernel]:
                    raise AssertionError(f"{kernel} {key}: a main-path "
                                         f"launch never resolved it")
    out["resolved_keys"] = {k: len(v) for k, v in resolved.items()}
    for k in (ts.PAIRWISE_KERNEL, ts.GATHERED_KERNEL):
        if not all(key[0] == sms for key in resolved[k]):
            raise AssertionError(f"{k}: a key without this card's {sms} SMs")

    # (b) measured search through the API
    searches = []

    def ms_of(timings, cand):
        return timings[tuple(cand)] * 1e3

    for name in ("gee_spmm_fused", "gee_spmm"):
        calls = captured[g][name]
        widths = [a[0].shape[1] for a, _ in calls]
        for pick in sorted({widths.index(min(widths)),
                            widths.index(max(widths))}):
            a, kw = calls[pick]
            if name == "gee_spmm_fused":
                kernel = gs.FUSED_KERNEL_NAME
                default = gs.resolve_geometry(kernel, a[0].shape[1], a[4],
                                              gs._vec(a[0], a[1]))
                winner, timings = gs.measured_geometry_search(
                    a[0], a[1], a[4], a[2], a[3],
                    correlation=kw.get("correlation", True),
                    eps=EPS_NORM, repeats=5, persist=False)
            else:
                kernel = gs.KERNEL_NAME
                default = gs.resolve_geometry(kernel, a[0].shape[1], a[2],
                                              gs._vec(a[0], a[1]))
                winner, timings = gs.measured_geometry_search(
                    a[0], a[1], a[2], repeats=5, persist=False)
            searches.append({
                "kernel": kernel, "shape": list(a[0].shape),
                "default": list(default), "winner": list(winner),
                "candidates": len(timings),
                "default_ms": ms_of(timings, default),
                "winner_ms": ms_of(timings, winner)})
    calls = gcaptured[g]["gee_spmm_fused"]
    widths = [a[0].shape[1] for a, _ in calls]
    for pick in sorted({widths.index(min(widths)), widths.index(max(widths))}):
        a, kw = calls[pick]
        kernel = gs.GATHERED_KERNEL_NAME
        default = gs.resolve_geometry(kernel, a[0].shape[1], a[6],
                                      gs._vec(a[0], a[1]))
        winner, timings = gs.measured_gathered_search(
            *a, **kw, eps=EPS_NORM, repeats=5, persist=False)
        searches.append({
            "kernel": kernel, "shape": list(a[0].shape),
            "default": list(default), "winner": list(winner),
            "candidates": len(timings),
            "default_ms": ms_of(timings, default),
            "winner_ms": ms_of(timings, winner)})
    a, kw = rcaptured[(g, "l2")]["scored_topk_gathered"][0]
    default = (ts.resolve_chunks(ts.GATHERED_KERNEL, a[0].device,
                                 a[0].shape[0], a[1].shape[1]),)
    winner, timings = ts.measured_chunks_search(
        "scored_topk_gathered", a, {"metric": kw.get("metric", "l2")},
        repeats=5, persist=False)
    searches.append({"kernel": ts.GATHERED_KERNEL,
                     "shape": [list(t.shape) for t in a[:2]],
                     "default": list(default), "winner": list(winner),
                     "candidates": len(timings),
                     "default_ms": ms_of(timings, default),
                     "winner_ms": ms_of(timings, winner)})
    out["searches"] = searches
    recorded = {k: REGISTRY.recorded(k) for k in port}
    n_recorded = sum(len(v) for v in recorded.values())
    if n_recorded != len(searches):
        raise AssertionError(f"{n_recorded} entries recorded for "
                             f"{len(searches)} searches")

    # (c) the fits and the flush with the recorded geometry, against the
    # plain versions
    edges, labels, k = graphs[g]
    opts = GEEEmbedder(num_classes=1).options
    want = gee_sparse_torch(edges, torch.from_numpy(labels).to(DEVICE), k,
                            opts)
    fit_errs = [max_err(torch, fit(g, opts, fused), want)
                for fused in (True, False)]
    got = rkernels["scored_topk_gathered"](*a, **kw)
    full = ref_mod.gathered_scores_ref(a[0], a[1], a[2], kw["metric"])
    plain = ref_mod.scored_topk_gathered_ref(a[0], a[1], a[2], a[3], a[4],
                                             kw["metric"])
    flush_err = check_topk(torch, got, plain, full,
                           term_scale(torch, a[0], a[1], kw["metric"]), a[3])
    out["fit_errs"], out["flush_err"] = fit_errs, flush_err

    # (d) save and load round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        REGISTRY.save(path)
        fresh = AutotuneRegistry()
        for kernel in port:
            fresh.register(kernel, fallback=policy[kernel])
        if fresh.load(path) != n_recorded:
            raise AssertionError("the saved file does not hold every entry")
        for kernel, entries in recorded.items():
            for key, value in entries.items():
                if fresh.lookup(kernel, key) != value:
                    raise AssertionError(f"{kernel} {key}: loaded "
                                         f"{fresh.lookup(kernel, key)}, "
                                         f"recorded {value}")
    for kernel in port:
        REGISTRY.clear(kernel)
    say(f"phase 13 autotune ({card}): phases 4-9 resolved "
        f"{out['resolved_keys']} keys through the registry, each its "
        f"policy's; measured search (CUDA events, min of 5) "
        + "; ".join(f"{s['kernel']} {s['shape']}: default {s['default']} "
                    f"{s['default_ms']:.4f} ms, winner {s['winner']} "
                    f"{s['winner_ms']:.4f} ms of {s['candidates']}"
                    for s in searches)
        + f"; fits with the recorded geometry vs sparse_torch "
          f"{fmt_err(fit_errs)}, the flush vs plain "
          f"max_abs_err={flush_err[0]:.3g}; save/load round trip of "
          f"{n_recorded} entries")
    return out


# ---------------------------------------------------------------------------
# phase 14: LM serving at full width
# ---------------------------------------------------------------------------

def hold(torch, got, want, rel) -> float:
    """``|got - want| <= rel * max|want| + F32_ATOL`` everywhere, else
    raise; returns max|got - want| / max|want|."""
    g = got.detach().double()
    w = want.detach().to(g.device).double()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite logits")
    top = float(w.abs().max())
    err = float((g - w).abs().max())
    if not err <= rel * top + F32_ATOL:
        raise AssertionError(f"max-abs {err:.4g} > {rel:.3g} * {top:.4g} + "
                             f"{F32_ATOL:g}")
    return err / top


def lm_phase(torch, card, seed: int = 0) -> dict:
    """Phase 14: ``qwen3-0.6b`` at its published widths and depth, bf16.
    (a) the port's weights from a seeded generator on the card; (b) the
    committed reference fixture (JAX logits, reduced config) against the
    port's f32 forward and prefill + decode on the card; (c) an f32 copy of
    (a)'s weights, forward on the card against the same on the host; (d)
    prefill 48 + decode 16 against one forward over 64, f32 and bf16; (e)
    ``BatchedServer`` (8 slots, max_len 512) serving 32 greedy requests,
    every emitted token's logits held against one forward over prompt +
    output; (f) one decode step at B = 64 with a 4,096-token cache, timed
    beside its bytes bound, 2 rows held against a forward over 4,096
    tokens.  Prints one line; returns the numbers."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.convert import lm_params_from_reference, tree_from_flat
    from repro_torch.models import lm
    from repro_torch.serve.batching import BatchedServer, Request
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.serve.decode import GraphedDecodeStep, make_prefill

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls would run in TF32")
    # bf16 GEMMs reduce in f32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    rng = np.random.default_rng(seed)
    cfg = get_config(LM_ARCH)
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
              cfg.param_dtype, cfg.compute_dtype)
    if widths != (28, 1024, 16, 8, 128, 3072, 151_936, "bfloat16",
                  "bfloat16"):
        raise AssertionError(f"{LM_ARCH} is not the published config: "
                             f"{widths}")

    def sync():
        torch.cuda.synchronize()

    # (a) weights
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=DEVICE)
    sync()
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = sum(p.numel() * p.element_size()
                 for p in tree_leaves(params))
    if n != lm.tree_size_from_param_count(cfg) \
            or cfg.param_count() != 596_071_424:
        raise AssertionError(f"{n} parameters, param_count "
                             f"{cfg.param_count()}")
    out["a"] = {"param_count": cfg.param_count(), "tree_elements": n,
                "bytes": nbytes, "init_s": time.perf_counter() - t0}

    # (b) the reference fixture
    with np.load(os.path.join(REPO, LM_FIXTURE)) as f:
        fix = {k: f[k] for k in f.files}
    rcfg = cfg.reduced()
    fparams = lm_params_from_reference(tree_from_flat(fix, "param/"), rcfg,
                                       device=DEVICE)
    ftoks = torch.from_numpy(fix["tokens"]).to(DEVICE)
    half = int(fix["prefill_len"])
    flog, _, _ = lm.forward(fparams, {"tokens": ftoks}, rcfg)
    err_fwd = hold(torch, flog, torch.from_numpy(fix["logits_forward"]),
                   F32_REL)
    lg, caches, _ = lm.forward(fparams, {"tokens": ftoks[:, :half]}, rcfg,
                               mode="prefill", cache_len=ftoks.shape[1])
    outs = [lg[:, -1:]]
    for step in range(half, ftoks.shape[1]):
        lg, caches = lm.decode_step(fparams, ftoks[:, step:step + 1], caches,
                                    step, rcfg)
        outs.append(lg)
    err_dec = hold(torch, torch.cat(outs, 1),
                   torch.from_numpy(fix["logits_decode"]), F32_REL)
    out["b"] = {"forward_rel_err": err_fwd, "decode_rel_err": err_dec}
    del fparams, caches

    # (c) card against host, f32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                            .astype(np.int32))
    t0 = time.perf_counter()
    want_host, _, _ = lm.forward(tree_map(lambda t: t.cpu(), p32),
                                 {"tokens": toks}, cfg32)
    host_s = time.perf_counter() - t0
    full32, _, _ = lm.forward(p32, {"tokens": toks.to(DEVICE)}, cfg32)
    out["c"] = {"rel_err": hold(torch, full32, want_host, F32_REL),
                "host_forward_s": host_s}
    del want_host

    # (d) prefill 48, decode 16, against one forward over 64
    def prefill_decode(p, c):
        tk = toks.to(DEVICE)
        lg, caches, _ = lm.forward(p, {"tokens": tk[:, :48]}, c,
                                   mode="prefill", cache_len=64)
        outs = [lg[:, -1:]]
        for step in range(48, 64):
            lg, caches = lm.decode_step(p, tk[:, step:step + 1], caches, step,
                                        c)
            outs.append(lg)
        return torch.cat(outs, 1)

    dec32 = prefill_decode(p32, cfg32)
    dec16 = prefill_decode(params, cfg)
    full16, _, _ = lm.forward(params, {"tokens": toks.to(DEVICE)}, cfg)
    want = full32[:, 47:]
    out["d"] = {"f32_rel_err": hold(torch, dec32, want, F32_REL),
                "bf16_decode_rel_err": hold(torch, dec16, want, BF16_REL),
                "bf16_forward_rel_err": hold(torch, full16[:, 47:], want,
                                             BF16_REL),
                "bf16_decode_vs_bf16_forward_rel_err": float(
                    (dec16 - full16[:, 47:]).abs().max()
                    / full16[:, 47:].abs().max())}
    del full32, full16, dec32, dec16

    # (e) the server
    def requests():
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, int(rng.integers(
                        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(SERVE_NEW[0],
                                                    SERVE_NEW[1] + 1)))
                for i in range(SERVE_REQUESTS)]

    def serve(reqs):
        server = BatchedServer(params, cfg, SERVE_SLOTS, SERVE_MAX_LEN,
                               seed=seed, device=DEVICE)
        rec, call_ms, calls = {}, [], {"prefill": 0, "tick": 0}
        events = []
        orig = server._decode

        def wrapped(p, c, t, pos, rows):
            t0 = time.perf_counter()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, c = orig(p, c, t, pos, rows)
            ev[1].record()
            sync()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            events.append(ev)
            tick = False
            for s in rows:
                req = server.slot_req[s]
                if pos >= len(req.prompt) - 1:
                    rec.setdefault(req.uid, {})[pos] = logits[s, 0].clone()
                    tick = True
            calls["tick" if tick else "prefill"] += 1
            return logits, c

        server._decode = wrapped
        for r in reqs:
            server.submit(r)
        sync()
        t0 = time.perf_counter()
        done = server.run()
        sync()
        wall = time.perf_counter() - t0
        device_ms = sum(a.elapsed_time(b) for a, b in events)
        return server, done, rec, call_ms, calls, wall, device_ms

    server, done, rec, call_ms, calls, wall, device_ms = serve(requests())
    if len(done) != SERVE_REQUESTS:
        raise AssertionError(f"{len(done)} of {SERVE_REQUESTS} finished")
    errs, tokens = [], 0
    for req in done:
        seq = np.concatenate([req.prompt, np.asarray(req.output, np.int32)])
        want32, _, _ = lm.forward(p32, {"tokens": torch.from_numpy(seq)[None]
                                        .to(DEVICE)}, cfg32)
        p0 = len(req.prompt) - 1
        if sorted(rec[req.uid]) != list(range(p0, p0 + len(req.output))):
            raise AssertionError(f"request {req.uid}: logits missing")
        got = torch.stack([rec[req.uid][p0 + j]
                           for j in range(len(req.output))])
        errs.append(hold(torch, got, want32[0, p0:p0 + len(req.output)],
                         BF16_REL))
        if max(req.output) >= cfg.vocab_size:
            raise AssertionError("a padded id was emitted")
        tokens += len(req.output)
    stats = server.stats
    if stats["tokens_out"] != tokens:
        raise AssertionError("stats['tokens_out'] disagrees")
    lat = np.asarray(call_ms)
    # the same call eager (no graph) on the server's shapes: one slot
    # written at a mid-cache position, host clock ending in a sync
    eager_caches = lm.init_caches(cfg, SERVE_SLOTS, SERVE_MAX_LEN,
                                  device=DEVICE)
    eager_toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32,
                             device=DEVICE)
    eager_ms = host_ms(torch, lambda: lm.decode_step(
        params, eager_toks, eager_caches, SERVE_MAX_LEN // 2, cfg, rows=[0]),
        reps=20)
    # the device work one decode call enqueues, by kind, from a CUDA graph
    step_nodes = graph_nodes(torch, lambda: lm.decode_step(
        params, eager_toks, eager_caches,
        torch.full((1,), SERVE_MAX_LEN // 2, dtype=torch.int64,
                   device=DEVICE), cfg,
        rows=torch.arange(SERVE_SLOTS, device=DEVICE) == 0))
    del eager_caches
    out["e"] = {
        "requests": SERVE_REQUESTS, "slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN, "tokens_out": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "decode_call_ms_p50": float(np.percentile(lat, 50)),
        "decode_call_ms_p95": float(np.percentile(lat, 95)),
        "decode_calls": calls, "ticks": stats["ticks"],
        "decode_calls_per_tick": calls["tick"] / stats["ticks"],
        "mean_occupancy": float(np.mean(list(stats["batch_occupancy"]))),
        # the device's busy share: the decode calls' device time (CUDA
        # events around each graph replay; torch.profiler does not see the
        # kernels inside a replayed graph) over the run's wall time
        "device_ms_in_decode_calls": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "eager_decode_call_ms_median_of_20": eager_ms,
        "device_work_a_decode_call": step_nodes,
        "max_rel_err_vs_f32_forward": max(errs),
        "kv_cache_bytes": 2 * server.caches["k"].numel() * 2}
    del server, done, rec

    # (f) one decode step at B = 64 with a 4,096-token cache
    b, s = STEP_BATCH, STEP_CACHE
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                               .astype(np.int32)).to(DEVICE)
    torch.cuda.empty_cache()
    caches = lm.init_caches(cfg, b, s, device=DEVICE)
    cache_bytes = sum(caches[n].numel() * caches[n].element_size()
                      for n in ("k", "v"))
    # each row's 4,095-token prompt prefilled, two rows a call, attention in
    # one chunk of the whole prompt
    prefill = make_prefill(cfg, cache_len=s, chunk=s)
    t0 = time.perf_counter()
    for row in range(0, b, STEP_FILL_ROWS):
        rs = slice(row, row + STEP_FILL_ROWS)
        _, c = prefill(params, {"tokens": prompts[rs, :s - 1]})
        for name in ("k", "v", "pos"):
            caches[name][:, rs] = c[name]
        del c
    sync()
    fill_s = time.perf_counter() - t0
    tok = prompts[:, s - 1:]
    eager_step = lambda: lm.decode_step(params, tok, caches, s - 1,  # noqa
                                        cfg)[0]
    graph_step = GraphedDecodeStep(params, caches, cfg)
    logits = {"eager": eager_step().clone(),
              "graphed": graph_step(tok, s - 1).clone()}
    step_ms = gpu_ms(torch, lambda: graph_step(tok, s - 1), reps=10,
                     warmup=1)
    step_eager_ms = gpu_ms(torch, eager_step, reps=10, warmup=1,
                           sleep_cycles=STEP_SLEEP_CYCLES)
    step_host_ms = host_ms(torch, lambda: graph_step(tok, s - 1), reps=5)
    step_eager_host_ms = host_ms(torch, eager_step, reps=5)
    bound_ms = (nbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    rows_err = []
    for row in (0, b - 1):
        want32, _, _ = lm.forward(p32, {"tokens": prompts[row:row + 1]},
                                  cfg32, chunk=s)
        for got in logits.values():
            rows_err.append(hold(torch, got[row, 0], want32[0, -1],
                                 BF16_REL))
        del want32
    peak = torch.cuda.max_memory_allocated()
    del caches, logits, graph_step
    torch.cuda.empty_cache()
    d32 = SHAPES["decode_32k"]
    cut_bytes = (d32.global_batch * d32.seq_len * cfg.num_layers * 2
                 * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    out["f"] = {"batch": b, "cache_len": s, "cache_bytes": cache_bytes,
                "weight_bytes": nbytes, "fill_s": fill_s,
                "step_ms_median_of_10": step_ms,
                "step_host_ms_median_of_5": step_host_ms,
                "eager_step_ms_median_of_10": step_eager_ms,
                "eager_step_host_ms_median_of_5": step_eager_host_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "rows_rel_err_vs_f32_forward": rows_err,
                "peak_bytes": peak,
                "decode_32k_cache_bytes": cut_bytes}
    e, f = out["e"], out["f"]
    say(f"phase 14 LM serving {LM_ARCH} at full width ({card}): (a) "
        f"{n:,} parameter elements (param_count {cfg.param_count():,}), "
        f"{nbytes / 1e9:.3f} GB bf16, seeded on the card in "
        f"{out['a']['init_s']:.1f} s; (b) vs the JAX fixture f32 forward "
        f"{err_fwd:.3g}, prefill+decode {err_dec:.3g} (of max|want|; bound "
        f"{F32_REL:g}); (c) f32 card vs host {out['c']['rel_err']:.3g}; (d) "
        f"prefill 48 + decode 16 vs forward 64: f32 "
        f"{out['d']['f32_rel_err']:.3g}, bf16 "
        f"{out['d']['bf16_decode_rel_err']:.3g} (bound {BF16_REL:.4f}); (e) "
        f"{SERVE_REQUESTS} requests in {SERVE_SLOTS} slots, {tokens} tokens "
        f"in {wall:.2f} s ({e['tokens_per_s']:.1f} tok/s), decode call p50 "
        f"{e['decode_call_ms_p50']:.2f} ms p95 {e['decode_call_ms_p95']:.2f} "
        f"ms, {e['decode_calls_per_tick']:.2f} calls a tick, device busy "
        f"{e['device_busy_share']:.3f} of the run, a call {step_nodes} "
        f"of device work, the same call eager {eager_ms:.2f} ms, logits vs "
        f"f32 forward "
        f"{e['max_rel_err_vs_f32_forward']:.3g};"
        f" (f) B={b} x {s} cache ({cache_bytes / 1e9:.2f} GB, filled in "
        f"{fill_s:.1f} s): the graphed step {step_ms:.3f} ms (host "
        f"{step_host_ms:.3f} ms), eager {step_eager_ms:.3f} ms (host "
        f"{step_eager_host_ms:.3f} ms), beside its bytes bound "
        f"{bound_ms:.3f} ms; rows vs f32 forward "
        f"{max(rows_err):.3g}; decode_32k's cache "
        f"({cut_bytes / 1e9:.0f} GB) does not fit one card")
    return out


# ---------------------------------------------------------------------------
# phase 15: the MoE, SSM and hybrid decoders at full width
# ---------------------------------------------------------------------------

# the published widths phase 15 must find in each config
FAMILY_WIDTHS = {
    "deepseek-moe-16b": dict(
        family="moe", num_layers=28, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=128, vocab_size=102_400,
        moe=dict(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                 capacity_factor=1.25, router_z_loss=1e-3),
        param_dtype="bfloat16", compute_dtype="bfloat16"),
    "mamba2-2.7b": dict(
        family="ssm", num_layers=64, d_model=2560, vocab_size=50_280,
        ssm=dict(state_dim=128, head_dim=64, expand=2, conv_width=4,
                 chunk=128),
        param_dtype="bfloat16", compute_dtype="bfloat16"),
    "recurrentgemma-2b": dict(
        family="hybrid", num_layers=26, d_model=2560, num_heads=10,
        num_kv_heads=1, d_ff=7680, head_dim=256, vocab_size=256_000,
        sliding_window=2048, tie_embeddings=True,
        rglru=dict(lru_width=2560, conv_width=4, c_exponent=8.0,
                   block_pattern=("rec", "rec", "attn")),
        param_dtype="bfloat16", compute_dtype="bfloat16")}
FAMILY_PARAM_COUNTS = {"deepseek-moe-16b": 16_879_626_240,
                       "mamba2-2.7b": 2_830_946_816,
                       "recurrentgemma-2b": 2_658_664_960}


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(p.numel() * p.element_size() for p in tree_leaves(tree))


def serve_requests(rng, vocab, n, prompt, new):
    from repro_torch.serve.batching import Request

    return [Request(uid=i, prompt=rng.integers(
                0, vocab, int(rng.integers(prompt[0], prompt[1] + 1)))
                .astype(np.int32),
                max_new_tokens=int(rng.integers(new[0], new[1] + 1)))
            for i in range(n)]


def run_server(torch, server, reqs) -> dict:
    """Serve ``reqs`` through ``server``, recording every emitted token's
    logits (by request and position), each decode call's host time (ending
    in a sync) and the calls that were prefill or ticks."""
    rec, call_ms, calls = {}, [], {"prefill": 0, "tick": 0}
    orig = server._decode

    def wrapped(p, c, t, pos, rows):
        t0 = time.perf_counter()
        logits, c = orig(p, c, t, pos, rows)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        tick = False
        for s in rows:
            req = server.slot_req[s]
            if pos >= len(req.prompt) - 1:
                rec.setdefault(req.uid, {})[pos] = logits[s, 0].clone()
                tick = True
        calls["tick" if tick else "prefill"] += 1
        return logits, c

    server._decode = wrapped
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} finished")
    tokens = sum(len(r.output) for r in done)
    if server.stats["tokens_out"] != tokens:
        raise AssertionError("stats['tokens_out'] disagrees")
    lat = np.asarray(call_ms)
    return {"done": {r.uid: r for r in done}, "rec": rec,
            "summary": {"requests": len(reqs), "tokens_out": tokens,
                        "wall_s": wall, "tokens_per_s": tokens / wall,
                        "decode_call_ms_p50": float(np.percentile(lat, 50)),
                        "decode_call_ms_p95": float(np.percentile(lat, 95)),
                        "decode_calls": dict(calls),
                        "ticks": server.stats["ticks"]}}


def fixture_phase(torch, arch, cfg) -> dict:
    """(b): the committed JAX fixture (reduced) against the port's f32
    forward and prefill + decode on the card; the MoE one's server tokens
    from ``BatchedServer`` on the card (graphed)."""
    import dataclasses

    from repro_torch.convert import lm_params_from_reference, tree_from_flat
    from repro_torch.models import lm
    from repro_torch.serve.batching import BatchedServer, Request

    with np.load(os.path.join(REPO, FAMILY_FIXTURES[arch])) as f:
        fix = {k: f[k] for k in f.files}
    rcfg = cfg.reduced()
    if "num_layers" in fix:
        rcfg = dataclasses.replace(rcfg, num_layers=int(fix["num_layers"]))
    if rcfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=MOE_FIXTURE_FACTOR))
    params = lm_params_from_reference(tree_from_flat(fix, "param/"), rcfg,
                                      device=DEVICE)
    toks = torch.from_numpy(fix["tokens"]).to(DEVICE)
    half = int(fix["prefill_len"])
    logits, _, aux = lm.forward(params, {"tokens": toks}, rcfg)
    out = {"layers": rcfg.num_layers,
           "period_scanned": rcfg.use_period_scan,
           "forward_rel_err": hold(
               torch, logits, torch.from_numpy(fix["logits_forward"]),
               F32_REL)}
    for key in aux:
        out[f"aux_{key}_err"] = abs(float(aux[key])
                                    - float(fix[f"aux/{key}"]))
        if not out[f"aux_{key}_err"] <= F32_REL * abs(
                float(fix[f"aux/{key}"])) + F32_ATOL:
            raise AssertionError(f"aux {key}: {float(aux[key])} against "
                                 f"{float(fix[f'aux/{key}'])}")
    lg, caches, _ = lm.forward(params, {"tokens": toks[:, :half]}, rcfg,
                               mode="prefill", cache_len=toks.shape[1])
    outs = [lg[:, -1:]]
    for step in range(half, toks.shape[1]):
        lg, caches = lm.decode_step(params, toks[:, step:step + 1], caches,
                                    step, rcfg)
        outs.append(lg)
    out["decode_rel_err"] = hold(torch, torch.cat(outs, 1),
                                 torch.from_numpy(fix["logits_decode"]),
                                 F32_REL)
    uids = sorted(int(k.split("/")[1]) for k in fix if k.startswith("server/"))
    if uids:
        server = BatchedServer(params, rcfg,
                               batch_slots=int(fix["server_slots"]),
                               max_len=int(fix["server_max_len"]),
                               device=DEVICE)
        for uid in uids:
            server.submit(Request(uid=uid,
                                  prompt=fix[f"server_prompt/{uid}"],
                                  max_new_tokens=int(fix[f"server_new/{uid}"])))
        done = {r.uid: r.output for r in server.run()}
        for uid in uids:
            if done[uid] != fix[f"server/{uid}"].tolist():
                raise AssertionError(f"request {uid}: {done[uid]} against "
                                     f"the reference server's "
                                     f"{fix[f'server/{uid}'].tolist()}")
        out["server_requests_equal"] = len(uids)
        out["server_tokens"] = sum(len(v) for v in done.values())
    return out


def route_spy(torch, moe_mod, records, replay=None):
    """A stand-in for ``moe.moe_forward`` (the one installed when it is
    made) that records, a call, each token's top-k experts ``top_e`` [T, k],
    its top-k expert set and kept (within capacity) set [T, E], its f32
    router logits and the 2-norm of the router's input row, on the host.
    Given ``replay`` (another run's records), call i routes its tokens to
    ``replay[i]``'s experts (``moe.top_k`` swapped for the call: their
    probabilities renormalized as the top-k's are); what it records is
    still its own routing."""
    orig, top_k = moe_mod.moe_forward, moe_mod.top_k

    def spy(params, x, m):
        i = len(records)
        with torch.no_grad():
            xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
            logits = xf @ params["router"]
            t_ = xf.shape[0]
            r = moe_mod.route(logits, m, moe_mod.capacity(t_, m))
            kept = torch.zeros(t_ * m.top_k, dtype=torch.bool,
                               device=x.device)
            kept[r["sort_idx"]] = r["keep"]
            top = torch.zeros((t_, m.num_experts), dtype=torch.bool,
                              device=x.device)
            kept_set = top.clone()
            top.scatter_(1, r["top_e"], True)
            kept_set.scatter_(1, r["top_e"], kept.view(t_, m.top_k))
            rec = {"top_e": r["top_e"].cpu(), "top": top.cpu(),
                   "kept": kept_set.cpu(), "logits": logits.cpu(),
                   "h_norm": xf.norm(dim=-1).cpu(),
                   "w_norm": float(params["router"].norm(dim=0).max())}
        if replay is not None:
            pin = replay[i]["top_e"].to(x.device)
            moe_mod.top_k = lambda probs, k: (probs.gather(-1, pin), pin)
        try:
            y, aux = orig(params, x, m)
        finally:
            moe_mod.top_k = top_k
        records.append(rec)
        return y, aux

    return spy


def routing_flips(torch, rec32, rec16, k, eps) -> dict:
    """Tokens whose expert set differs between two runs (``rec32`` the
    reference, e.g. f32, ``rec16`` the other) in any layer: ``flipped``
    (the top-k set differs) and ``knock_on`` (the same top-k, a different
    kept set: another token's flip took or freed capacity).  Each flip's
    top-k margin in the reference's router logits is held below
    ``ROUTER_FLIP_SLACK * eps * |h| * max_e |w_e|``."""
    if len(rec32) != len(rec16) or not rec32:
        raise AssertionError(f"{len(rec32)} and {len(rec16)} MoE layers "
                             f"recorded")
    t_ = rec32[0]["top"].shape[0]
    flipped = torch.zeros(t_, dtype=torch.bool)
    kept_differs = flipped.clone()
    worst = 0.0
    for a, b in zip(rec32, rec16):
        f = (a["top"] != b["top"]).any(-1)
        flipped |= f
        kept_differs |= (a["kept"] != b["kept"]).any(-1)
        if bool(f.any()):
            srt = a["logits"][f].sort(dim=-1, descending=True).values
            margin = srt[:, k - 1] - srt[:, k]
            bound = ROUTER_FLIP_SLACK * eps * a["h_norm"][f] * a["w_norm"]
            ratio = float((margin / bound).max())
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(f"a routing flip at an f32 margin "
                                     f"{ratio:.3g} times its round-off bound")
    knock = kept_differs & ~flipped
    return {"tokens": t_, "flipped": int(flipped.sum()),
            "knock_on": int(knock.sum()),
            "held": int((~(flipped | knock)).sum()),
            "worst_margin_over_bound": worst,
            "differs": flipped | knock}


def hold_routed(torch, got, want, rec_got, rec_want, k, rel) -> dict:
    """``hold`` over the tokens ([B, S] of ``got`` / ``want``) that both
    runs routed alike in every MoE layer; the others counted by
    ``routing_flips``, each flip's margin held under its bound."""
    flips = routing_flips(torch, rec_want, rec_got, k, rel)
    held = ~flips.pop("differs").view(got.shape[:2]).to(got.device)
    err = (hold(torch, got[held], want.to(got.device)[held], rel)
           if bool(held.any()) else None)
    return {"bound": rel, "rel_err_held_tokens": err, **flips}


def layer_contributions(torch, lm, params, p32, cfg, cfg32, toks, r,
                        seed) -> dict:
    """Each layer's contribution (its output less its input) in bf16, fed
    the f32 run's input, against the f32 layer's, within 2^-8 * sqrt(r) *
    max(1, kappa_l); kappa_l is the f32 contribution's relative change from
    one unit roundoff of its input, over 2^-23.  An MoE layer holds the
    tokens both runs routed alike (``routing_flips``)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rope_tables

    inputs = []
    orig = lm._apply_block

    def spy(lp, x, *args, **kw):
        inputs.append(x)
        return orig(lp, x, *args, **kw)

    lm._apply_block = spy
    try:
        lm.forward(p32, {"tokens": toks}, cfg32)
    finally:
        lm._apply_block = orig
    b, s = toks.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=toks.device).expand(b, s)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope)
    gen = torch.Generator(device=toks.device)
    gen.manual_seed(seed + 4)

    def contribution(lp, x, c, layer_type):
        return orig(lp, x, positions, c, layer_type, mode="train",
                    rope=rope)[0].float() - x.float()

    worst, kappas, errs, routed_apart = 0.0, [], [], 0
    for i, layer_type in enumerate(cfg.layer_pattern):
        x = inputs[i]
        want = contribution(p32["layers"][i], x, cfg32, layer_type)
        top = float(want.abs().max())
        moved = x * (1 + 2.0 ** -23 * torch.randn(x.shape, generator=gen,
                                                  device=x.device))
        kappa = float((contribution(p32["layers"][i], moved, cfg32,
                                    layer_type) - want).abs().max()) / top \
            / 2.0 ** -23
        bound = 2.0 ** -8 * r ** 0.5 * max(1.0, kappa)
        held = slice(None)
        if cfg.moe is None or layer_type == "ssm":
            got = contribution(params["layers"][i],
                               x.to(params["embed"].dtype), cfg, layer_type)
        else:                        # tokens routed apart are not held
            rec32, rec16 = [], []
            spy32 = route_spy(torch, moe_mod, rec32)
            spy16 = route_spy(torch, moe_mod, rec16)
            plain = moe_mod.moe_forward
            try:
                moe_mod.moe_forward = spy32
                contribution(p32["layers"][i], x, cfg32, layer_type)
                moe_mod.moe_forward = spy16
                got = contribution(params["layers"][i],
                                   x.to(params["embed"].dtype), cfg,
                                   layer_type)
            finally:
                moe_mod.moe_forward = plain
            flips = routing_flips(torch, rec32, rec16, cfg.moe.top_k, bound)
            held = ~flips["differs"].view(b, s).to(x.device)
            routed_apart += flips["flipped"] + flips["knock_on"]
        err = float((got[held] - want[held]).abs().max()) / top
        if not err <= bound:
            raise AssertionError(f"layer {i}: bf16 contribution {err:.4g} "
                                 f"of max|want| > {bound:.4g} (kappa "
                                 f"{kappa:.3g})")
        worst = max(worst, err / bound)
        kappas.append(kappa)
        errs.append(err)
    return {"layers": len(errs), "token_layers_routed_apart": routed_apart,
            "max_rel_err": max(errs),
            "median_rel_err": float(np.median(errs)),
            "max_err_over_bound": worst, "kappa_max": max(kappas),
            "kappa_median": float(np.median(kappas))}


def family_phase(torch, card, arch, where: list, seed: int = 0) -> dict:
    """Phase 15 for one config at its published widths, bf16, random
    seeded weights: (a) the weights on the card and their element count;
    (b) the JAX fixture; (c) an f32 copy, card against host (deepseek cut to
    ``MOE_F32_LAYERS`` layers); (d) bf16 against that f32 copy (deepseek:
    routing flips counted, the other tokens held); (e) prefill + decode
    against a forward (mamba2, recurrentgemma); (f) deepseek's server
    graphed, replayed eager; (g) mamba2's server against a forward; (h) the
    timings.  ``where[0]`` names the check running.  Returns the
    numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.batching import BatchedServer
    from repro_torch.serve.decode import GraphedDecodeStep, generate
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    rng = np.random.default_rng(seed)
    cfg = get_config(arch)
    have = dataclasses.asdict(cfg)
    for key, want in FAMILY_WIDTHS[arch].items():
        got = have[key]
        if isinstance(want, dict):
            got = {k: got[k] for k in want}
        if got != want:
            raise AssertionError(f"{arch}: {key} {got}, published {want}")
    eps = FAMILY_BF16_REL[arch]

    def sync():
        torch.cuda.synchronize()

    # (a) weights
    where[0] = "(a) weights"
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=DEVICE)
    sync()
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = tree_bytes(params)
    if n != lm.tree_size_from_param_count(cfg) \
            or cfg.param_count() != FAMILY_PARAM_COUNTS[arch]:
        raise AssertionError(f"{arch}: {n} parameter elements, param_count "
                             f"{cfg.param_count()}")
    out["a"] = {"param_count": cfg.param_count(), "tree_elements": n,
                "bytes": nbytes, "init_s": time.perf_counter() - t0}

    # (b) the reference fixture
    where[0] = "(b) JAX fixture"
    out["b"] = fixture_phase(torch, arch, cfg)

    # (c) card against host, f32 (deepseek: its first layers)
    where[0] = "(c) the f32 runs"
    cut_cfg, cut = cfg, params
    if cfg.moe is not None:
        cut_cfg = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS)
        cut = dict(params, layers=params["layers"][:MOE_F32_LAYERS])
    cfg32 = dataclasses.replace(cut_cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), cut)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (CHECK_BATCH, CHECK_SEQ))
                            .astype(np.int32))
    # every run's routing, recorded by one spy each (made while the
    # layer is the plain one)
    records = {"host": [], "f32": [], "bf16": []}
    orig = moe_mod.moe_forward
    spies = {k: route_spy(torch, moe_mod, v) for k, v in records.items()}
    try:
        moe_mod.moe_forward = spies["host"]
        t0 = time.perf_counter()
        want_host, _, _ = lm.forward(tree_map(lambda t: t.cpu(), p32),
                                     {"tokens": toks}, cfg32)
        host_s = time.perf_counter() - t0
        moe_mod.moe_forward = spies["f32"]
        full32, _, _ = lm.forward(p32, {"tokens": toks.to(DEVICE)}, cfg32)
        moe_mod.moe_forward = spies["bf16"]
        full16, _, _ = lm.forward(cut, {"tokens": toks.to(DEVICE)}, cut_cfg)
    finally:
        moe_mod.moe_forward = orig
    # the stack's condition: the f32 logits' change from one unit
    # roundoff of every embedding entry
    where[0] = "(c) the stack's condition"
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 3)
    moved = dict(p32, embed=p32["embed"] * (1 + 2.0 ** -23 * torch.randn(
        p32["embed"].shape, generator=gen, device=DEVICE)))
    moved_logits, _, _ = lm.forward(moved, {"tokens": toks.to(DEVICE)},
                                    cfg32)
    sens = float((moved_logits - full32).abs().max() / full32.abs().max())
    del moved, moved_logits
    kappa = sens / 2.0 ** -23
    walk = (ROUNDINGS[arch] * cut_cfg.num_layers) ** 0.5
    f32_rel = max(F32_REL, 2.0 ** -23 * walk * kappa)
    chaotic = sens * 2.0 ** 15 >= CHAOTIC_AT
    out["condition"] = {"one_ulp_logit_change": sens, "kappa": kappa,
                        "f32_bound": f32_rel, "chaotic_in_bf16": chaotic}
    out["c"] = {"layers": cut_cfg.num_layers, "bound": f32_rel,
                "f32_bytes": tree_bytes(p32), "host_forward_s": host_s}
    where[0] = "(c) card vs host"
    if cfg.moe is None:
        out["c"]["rel_err"] = hold(torch, full32, want_host, f32_rel)
    else:
        out["c"].update(hold_routed(torch, full32, want_host, records["f32"],
                                    records["host"], cfg.moe.top_k,
                                    f32_rel))
    del want_host

    # (d) bf16 against f32 of the same weights
    where[0] = "(d) bf16 vs f32"
    if chaotic:
        out["d"] = {"bound": None, "end_to_end_rel_err_recorded": float(
            (full16 - full32).abs().max() / full32.abs().max()),
            "layers": layer_contributions(torch, lm, cut, p32, cut_cfg,
                                          cfg32, toks.to(DEVICE),
                                          ROUNDINGS[arch], seed)}
    elif cfg.moe is None:
        out["d"] = {"bound": eps,
                    "rel_err": hold(torch, full16, full32, eps)}
    else:
        out["d"] = hold_routed(torch, full16, full32, records["bf16"],
                               records["f32"], cfg.moe.top_k, eps)
    del full16, records

    # (e) prefill + decode against a forward
    if cfg.family == "ssm":
        b, s0, s1 = 2, SSM_PREFILL, SSM_PREFILL + SSM_DECODE
    elif cfg.family == "hybrid":
        b, s0, s1 = 1, HYBRID_PREFILL, HYBRID_PREFILL + HYBRID_DECODE
    if cfg.family in ("ssm", "hybrid"):
        where[0] = "(e) prefill + decode"
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s1))
                               .astype(np.int32)).to(DEVICE)

        def prefill_decode(p, c):
            lg, caches, _ = lm.forward(p, {"tokens": seq[:, :s0]}, c,
                                       mode="prefill", cache_len=s1)
            outs = [lg[:, -1:]]
            for step in range(s0, s1):
                lg, caches = lm.decode_step(p, seq[:, step:step + 1], caches,
                                            step, c)
                outs.append(lg)
            return torch.cat(outs, 1)

        want, _, _ = lm.forward(p32, {"tokens": seq}, cfg32)
        want = want[:, s0 - 1:]
        out["e"] = {"batch": b, "prefill": s0, "decode": s1 - s0,
                    "f32_rel_err": hold(torch, prefill_decode(p32, cfg32),
                                        want, f32_rel)}
        lo = prefill_decode(params, cfg)
        if chaotic:                  # recorded, not held (see ROUNDINGS)
            out["e"]["bf16_rel_err_recorded"] = float(
                (lo - want).abs().max() / want.abs().max())
        else:
            out["e"]["bf16_rel_err"] = hold(torch, lo, want, eps)
        del lo
        if cfg.family == "hybrid":
            # greedy through generate: each token the argmax of an f32
            # forward over the output, until a near tie
            gen = generate(p32, cfg32, seq[:, :s0], max_new_tokens=s1 - s0)
            ref, _, _ = lm.forward(p32, {"tokens": gen}, cfg32)
            ref = ref[0, s0 - 1:s1 - 1, :cfg.vocab_size]
            top2 = ref.topk(2, dim=-1).values
            tol = f32_rel * float(ref.abs().max()) + F32_ATOL
            agree = 0
            for j in range(s1 - s0):
                if float(top2[j, 0] - top2[j, 1]) <= 10 * tol:
                    break
                if int(gen[0, s0 + j]) != int(ref[j].argmax()):
                    raise AssertionError(f"generate's token {j} is not the "
                                         f"forward's argmax")
                agree += 1
            out["e"]["generate_tokens_checked"] = agree
            del gen, ref
        del want

    # (f) deepseek's server, graphed, then replayed eager
    if cfg.moe is not None:
        where[0] = "(f) the MoE server"

        def reqs():
            return serve_requests(np.random.default_rng(seed + 1),
                                  cfg.vocab_size, FAMILY_REQUESTS,
                                  FAMILY_PROMPT, FAMILY_NEW)

        graphed = run_server(torch, BatchedServer(
            params, cfg, FAMILY_SLOTS, FAMILY_MAX_LEN, seed=seed,
            device=DEVICE), reqs())
        eager_server = BatchedServer(params, cfg, FAMILY_SLOTS,
                                     FAMILY_MAX_LEN, seed=seed, device=DEVICE)
        eager_server._decode = lambda p, c, t, pos, rows: lm.decode_step(
            p, t, c, pos, cfg, rows=rows)
        eager = run_server(torch, eager_server, reqs())
        errs = []
        for uid, req in graphed["done"].items():
            if req.output != eager["done"][uid].output:
                raise AssertionError(f"request {uid}: graphed "
                                     f"{req.output} against eager "
                                     f"{eager['done'][uid].output}")
            for pos, lg in graphed["rec"][uid].items():
                errs.append(hold(torch, lg, eager["rec"][uid][pos], F32_REL))
        out["f"] = {"slots": FAMILY_SLOTS, "max_len": FAMILY_MAX_LEN,
                    "graphed": graphed["summary"],
                    "eager": eager["summary"],
                    "max_rel_err_graphed_vs_eager": max(errs),
                    "kv_cache_bytes": sum(
                        leaf.numel() * leaf.element_size()
                        for _, leaf, _ in lm.cache_leaves(
                            eager_server.caches))}
        del graphed, eager, eager_server

    # (g) mamba2's server against a forward (chaotic in bf16: the server
    # in f32 is held, the bf16 one timed)
    if cfg.family == "ssm":
        where[0] = "(g) the SSM server"

        def reqs():
            return serve_requests(np.random.default_rng(seed + 2),
                                  cfg.vocab_size, FAMILY_REQUESTS,
                                  FAMILY_PROMPT, FAMILY_NEW)

        timed = run_server(torch, BatchedServer(
            params, cfg, FAMILY_SLOTS, FAMILY_MAX_LEN, seed=seed,
            device=DEVICE), reqs())
        for req in timed["done"].values():
            if max(req.output) >= cfg.vocab_size:
                raise AssertionError("a padded id was emitted")
        served, bound = timed, eps
        if chaotic:
            served = run_server(torch, BatchedServer(
                p32, cfg32, FAMILY_SLOTS, FAMILY_MAX_LEN, seed=seed,
                device=DEVICE), reqs())
            bound = f32_rel
        errs = []
        for uid, req in served["done"].items():
            seq = np.concatenate([req.prompt, np.asarray(req.output,
                                                         np.int32)])
            want32, _, _ = lm.forward(p32, {"tokens": torch.from_numpy(seq)
                                            [None].to(DEVICE)}, cfg32)
            p0 = len(req.prompt) - 1
            got = torch.stack([served["rec"][uid][p0 + j]
                               for j in range(len(req.output))])
            errs.append(hold(torch, got,
                             want32[0, p0:p0 + len(req.output)], bound))
        out["g"] = {"slots": FAMILY_SLOTS, "max_len": FAMILY_MAX_LEN,
                    **timed["summary"], "held_in": "f32" if chaotic
                    else "bf16", "bound": bound,
                    "held_tokens": sum(len(r.output)
                                       for r in served["done"].values()),
                    "max_rel_err_vs_f32_forward": max(errs)}
        del served, timed

    # (h) one graphed decode step beside its bytes bound
    where[0] = "(h) the timed step"
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    row_bytes = cfg.d_model * params["embed"].element_size()
    if cfg.moe is not None or cfg.family == "ssm":
        if cfg.moe is not None:
            b, cache_len = MOE_STEP_BATCH, MOE_STEP_CACHE
            caches = lm.init_caches(cfg, b, cache_len, device=DEVICE)
            pos = cache_len // 2
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))
                                   .astype(np.int32)).to(DEVICE)
            fill_s, rows_err = None, None
        else:
            b, cache_len = SSM_STEP_BATCH, None
            caches = lm.init_caches(cfg, b, 1, device=DEVICE)
            prompts = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, SSM_STEP_PROMPT + 1))
                .astype(np.int32)).to(DEVICE)
            t0 = time.perf_counter()
            for row in range(0, b, 2):
                rs = slice(row, row + 2)
                _, c, _ = lm.forward(params,
                                     {"tokens": prompts[rs, :SSM_STEP_PROMPT]},
                                     cfg, mode="prefill")
                for name in caches:
                    caches[name][:, rs] = c[name]
                del c
            sync()
            fill_s = time.perf_counter() - t0
            pos = SSM_STEP_PROMPT
            tok = prompts[:, SSM_STEP_PROMPT:]
        # every weight but the embedding (B rows of it), the caches read
        # once, the SSM's state and conv tails written once
        cache_bytes = sum(leaf.numel() * leaf.element_size()
                          for _, leaf, _ in lm.cache_leaves(caches))
        written = cache_bytes if cfg.family == "ssm" else 0
        bound_ms = ((nbytes - embed_bytes + b * row_bytes + cache_bytes
                     + written) / HBM_BYTES_PER_S * 1e3)
        step = GraphedDecodeStep(params, caches, cfg)
        before = ({k: v.clone() for k, v in caches.items()}
                  if cfg.family == "ssm" and chaotic else None)
        logits = step(tok, pos).clone()
        step_ms = gpu_ms(torch, lambda: step(tok, pos), reps=10, warmup=1,
                         sleep_cycles=STEP_SLEEP_CYCLES)
        step_host_ms = host_ms(torch, lambda: step(tok, pos), reps=5)
        if before is not None:
            # chaotic in bf16: every row against the eager step on the
            # state the graphed one started from
            eager, _ = lm.decode_step(params, tok, before, pos, cfg)
            rows_err = [hold(torch, logits, eager, F32_REL)]
            del before, eager
        elif cfg.family == "ssm":
            # rows 0 and B-1 against the f32 prefill + one f32 decode step
            rows_err = []
            for row in (0, b - 1):
                _, c32, _ = lm.forward(
                    p32, {"tokens": prompts[row:row + 1, :SSM_STEP_PROMPT]},
                    cfg32, mode="prefill")
                want32, _ = lm.decode_step(p32, tok[row:row + 1], c32, pos,
                                           cfg32)
                rows_err.append(hold(torch, logits[row, 0], want32[0, 0],
                                     eps))
                del c32
        out["h_step"] = {"batch": b, "cache_len": cache_len,
                         "cache_bytes": cache_bytes, "fill_s": fill_s,
                         "weight_bytes": nbytes,
                         "step_ms_median_of_10": step_ms,
                         "step_host_ms_median_of_5": step_host_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes",
                         "rows_rel_err_vs_f32": rows_err,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        del step, caches, logits
    if cfg.moe is not None:
        # the share of (token, choice) pairs a full-width prefill drops
        where[0] = "(h) the prefill's drops"
        ptoks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (MOE_PREFILL_BATCH, MOE_PREFILL_SEQ))
            .astype(np.int32)).to(DEVICE)
        t0 = time.perf_counter()
        _, _, aux = lm.forward(params, {"tokens": ptoks}, cfg)
        sync()
        out["h_prefill"] = {
            "batch": MOE_PREFILL_BATCH, "seq": MOE_PREFILL_SEQ,
            "capacity": moe_mod.capacity(
                MOE_PREFILL_BATCH * MOE_PREFILL_SEQ, cfg.moe),
            "drop_fraction_summed_over_layers": float(aux["drop_fraction"]),
            "drop_fraction_mean_a_layer": float(aux["drop_fraction"])
            / cfg.num_layers,
            "load_balance_loss_summed": float(aux["load_balance_loss"]),
            "forward_s": time.perf_counter() - t0}
    del params, p32, cut, full32
    torch.cuda.empty_cache()
    return out


def families_phase(torch, card, seed: int = 0) -> dict:
    """Phase 15: ``deepseek-moe-16b``, ``mamba2-2.7b`` and
    ``recurrentgemma-2b`` at their published widths and depth in bf16 (see
    ``family_phase``), one after another, each freed before the next.
    Prints one line; returns the numbers."""
    import gc

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls would run in TF32")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for arch in FAMILY_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        where = ["start"]
        try:
            out[arch] = family_phase(torch, card, arch, where, seed)
        except Exception as exc:
            raise AssertionError(f"phase 15 {arch} {where[0]}: {exc}") \
                from exc
        out[arch]["phase_s"] = time.perf_counter() - t0
    def num(x):
        return "n/a" if x is None else f"{x:.3g}"

    parts = []
    for a in FAMILY_ARCHS:
        o = out[a]
        c, d, e = o["c"], o["d"], o.get("e", {})
        txt = (f"{a} (a) {o['a']['tree_elements']:,} elements, "
               f"{o['a']['bytes'] / 1e9:.2f} GB bf16, seeded in "
               f"{o['a']['init_s']:.1f} s; (b) fixture "
               f"{num(o['b']['forward_rel_err'])} / "
               f"{num(o['b']['decode_rel_err'])}; condition kappa "
               f"{o['condition']['kappa']:.3g} (one ulp of the embeddings "
               f"moves the logits {o['condition']['one_ulp_logit_change']:.3g}"
               f"); (c) f32 card vs host "
               f"{num(c.get('rel_err', c.get('rel_err_held_tokens')))} "
               f"(bound {c['bound']:.3g}, {c['layers']} layers")
        if "flipped" in c:
            txt += f", {c['flipped']} tokens routed apart"
        txt += "); (d) bf16 vs f32 "
        if d.get("layers"):
            lay = d["layers"]
            txt += (f"per layer {num(lay['max_rel_err'])} (worst "
                    f"{lay['max_err_over_bound']:.3g} of its bound, kappa_l "
                    f"up to {lay['kappa_max']:.3g}), end to end "
                    f"{num(d['end_to_end_rel_err_recorded'])} recorded")
        else:
            txt += (f"{num(d.get('rel_err', d.get('rel_err_held_tokens')))} "
                    f"(bound {d['bound']:.4f}")
            if "flipped" in d:
                txt += (f"; {d['held']} of {d['tokens']} tokens held, "
                        f"{d['flipped']} routed apart, {d['knock_on']} "
                        f"knock-ons, worst flip margin "
                        f"{d['worst_margin_over_bound']:.3g} of its bound")
            txt += ")"
        if e:
            txt += (f"; (e) prefill {e['prefill']} + decode {e['decode']} vs "
                    f"forward f32 {num(e['f32_rel_err'])}, bf16 "
                    f"{num(e.get('bf16_rel_err', e.get('bf16_rel_err_recorded')))}"
                    + (" recorded" if "bf16_rel_err_recorded" in e else ""))
            if "generate_tokens_checked" in e:
                txt += (f", generate's {e['generate_tokens_checked']} "
                        f"tokens the forward's argmax")
        if "f" in o:
            f = o["f"]
            txt += (f"; (f) {f['graphed']['tokens_out']} tokens at "
                    f"{f['graphed']['tokens_per_s']:.1f} tok/s, call p50 "
                    f"{f['graphed']['decode_call_ms_p50']:.2f} p95 "
                    f"{f['graphed']['decode_call_ms_p95']:.2f} ms (eager "
                    f"{f['eager']['tokens_per_s']:.1f} tok/s, p50 "
                    f"{f['eager']['decode_call_ms_p50']:.2f} ms), the same "
                    f"tokens, logits {num(f['max_rel_err_graphed_vs_eager'])}"
                    f" apart")
        if "g" in o:
            g = o["g"]
            txt += (f"; (g) {g['tokens_out']} tokens at "
                    f"{g['tokens_per_s']:.1f} tok/s, call p50 "
                    f"{g['decode_call_ms_p50']:.2f} p95 "
                    f"{g['decode_call_ms_p95']:.2f} ms, held in {g['held_in']}"
                    f" vs an f32 forward {num(g['max_rel_err_vs_f32_forward'])}")
        if "h_step" in o:
            h = o["h_step"]
            txt += (f"; (h) the B = {h['batch']} step "
                    f"{h['step_ms_median_of_10']:.3f} ms (host "
                    f"{h['step_host_ms_median_of_5']:.3f}) beside its bytes "
                    f"bound {h['bound_ms']:.3f} ms")
        if "h_prefill" in o:
            txt += (f", a {MOE_PREFILL_BATCH} x {MOE_PREFILL_SEQ} prefill "
                    f"drops {o['h_prefill']['drop_fraction_mean_a_layer']:.4f}"
                    f" of its choices a layer")
        parts.append(txt + f"; {o['phase_s']:.0f} s")
    say(f"phase 15 MoE, SSM and hybrid decoders at full width ({card}): "
        + " | ".join(parts))
    return out


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

def train_fixture_check(torch) -> dict:
    """(a) One AdamW and one Adafactor step of reduced qwen3-0.6b (f32, TF32
    off) from the weights of the LM fixture, against the committed JAX
    fixture: loss and grad norm within 1e-5 relative, every leaf's gradient
    within 1e-4 * max|want| + 1e-5, the updated parameters within the CPU
    tests' bounds (``adamw_step_bound``, ``adafactor_step_bound`` at 1e-4).
    -> the worst of each over its bound."""
    from repro_torch.configs import get_config
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference, tree_from_flat)
    from repro_torch.train import loop
    from repro_torch.train.optimizers import (adafactor_step_bound,
                                              adamw_step_bound, get_optimizer)
    from repro_torch.tree import flatten_with_paths

    def flat64(tree):
        return {k: v.double() for k, v in flatten_with_paths(tree).items()}

    cfg = get_config(LM_ARCH).reduced()
    with np.load(os.path.join(REPO, TRAIN_FIXTURE)) as f:
        fix = {k: f[k] for k in f.files}
    with np.load(os.path.join(REPO, LM_FIXTURE)) as f:
        params = lm_params_to_reference(lm_params_from_reference(
            tree_from_flat({k: f[k] for k in f.files}, "param/"), cfg,
            device=DEVICE), cfg)
    toks = torch.from_numpy(fix["tokens"]).to(DEVICE)
    p0 = flat64(params)
    _, g = loop.grad_and_metrics(params, {"tokens": toks}, cfg,
                                 chunk=TRAIN_FIXTURE_CHUNK)
    got_g = flat64(g)
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "param": 0.0}
    for name in ("adamw", "adafactor"):
        opt = get_optimizer(name, TRAIN_FIXTURE_LR)
        p1, _, m = loop.make_train_step(cfg, opt, chunk=TRAIN_FIXTURE_CHUNK)(
            params, opt.init(params), {"tokens": toks})
        for key in ("loss", "grad_norm"):
            want = float(fix[f"{name}/{key}"])
            worst[key] = max(worst[key],
                             abs(float(m[key]) - want) / abs(want) / 1e-5)
        s_got = min(1.0, 1.0 / max(float(m["grad_norm"]), 1e-9))
        s_want = min(1.0, 1.0 / max(float(fix[f"{name}/grad_norm"]), 1e-9))
        got_p = flat64(p1)
        for k, p in p0.items():
            want_g = torch.from_numpy(fix["grad/" + k]).to(DEVICE).double()
            bound = 1e-4 * float(want_g.abs().max()) + 1e-5
            worst["grad"] = max(worst["grad"], float(
                (got_g[k] - want_g).abs().max()) / bound)
            want_p = torch.from_numpy(fix[f"{name}/param/" + k]).to(
                DEVICE).double()
            if name == "adamw":
                bound = adamw_step_bound(got_g[k] * s_got, want_g * s_want,
                                         got_p[k], want_p, TRAIN_FIXTURE_LR)
            else:
                bound = adafactor_step_bound(want_p - p, p, 1e-4)
            worst["param"] = max(worst["param"], float(
                ((got_p[k] - want_p).abs() / bound).max()))
    for key, v in worst.items():
        if not v <= 1.0:
            raise AssertionError(f"training fixture: {key} at {v:.3g} of "
                                 f"its bound")
    return worst


def launcher_kill_resume(torch, tmp) -> dict:
    """(c) ``repro_torch.launch.train.main`` on the card in processes of
    its own (``KILL_MAIN``: reduced qwen3-0.6b in bf16, so its checkpoints
    hold bf16 leaves): an uninterrupted run; a run SIGKILLed once an in-loop
    checkpoint is on disk, then resumed with the same flags; their final
    checkpoints' digests and every leaf equal."""
    import signal

    from repro_torch.checkpoint import ckpt

    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")
           + os.pathsep + os.environ.get("PYTHONPATH", "")}

    def spawn(d):
        return subprocess.Popen(
            [sys.executable, "-c", KILL_MAIN, *KILL_ARGS, "--ckpt-dir", d],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def finish(proc):
        try:
            out, _ = proc.communicate(timeout=KILL_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate(timeout=30)
            raise AssertionError(f"train did not end in {KILL_WAIT_S} s:\n"
                                 f"{out[-2000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"train failed:\n{out[-2000:]}")
        return out

    straight, killed = os.path.join(tmp, "straight"), \
        os.path.join(tmp, "killed")
    t0 = time.perf_counter()
    procs = [spawn(straight), spawn(killed)]
    try:
        child = procs[1]
        deadline = time.time() + KILL_WAIT_S
        while time.time() < deadline and child.poll() is None:
            if ckpt.available_steps(killed):
                child.send_signal(signal.SIGKILL)
                child.wait(timeout=30)
                break
            time.sleep(0.01)
        finish(procs[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"the run was not killed mid-way "
                             f"(rc {child.returncode})")
    at_kill = ckpt.available_steps(killed)
    steps = int(KILL_ARGS[KILL_ARGS.index("--steps") + 1])
    if not at_kill or at_kill[-1] >= steps:
        raise AssertionError(f"no in-loop checkpoint at the kill: {at_kill}")
    resumed = finish(spawn(killed))
    if f"resumed from step {at_kill[-1]}" not in resumed:
        raise AssertionError(f"did not resume from {at_kill[-1]}:\n"
                             f"{resumed[-2000:]}")
    wall = time.perf_counter() - t0
    a, _ = ckpt.restore_arrays(straight, steps, verify=True)
    b, _ = ckpt.restore_arrays(killed, steps, verify=True)
    with open(os.path.join(straight, f"step_{steps:010d}",
                           "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(killed, f"step_{steps:010d}",
                           "manifest.json")) as f:
        mb = json.load(f)
    differ = sorted(k for k in a if a[k].tobytes() != b[k].tobytes())
    bf16 = sorted(k for k, e in mb["index"].items()
                  if e["dtype"] == "bfloat16")
    if ma["digest"] != mb["digest"] or differ or set(a) != set(b):
        raise AssertionError(f"resumed run differs: digests "
                             f"{ma['digest'][:12]} / {mb['digest'][:12]}, "
                             f"leaves {differ[:5]}")
    if not bf16:
        raise AssertionError("no bf16 leaf in the checkpoint")
    return {"killed_after_checkpoint": at_kill[-1], "steps": steps,
            "digest": mb["digest"], "leaves": len(a), "bf16_leaves": len(bf16),
            "wall_s": wall}


def bf16_step_against_f32(torch, cfg, batch, seed: int) -> dict:
    """One AdamW step of ``cfg`` at its published widths cut to
    ``CUT_LAYERS`` layers, in bf16 and in f32 from the same (bf16-valued)
    weights on ``batch``, at a constant ``CUT_LR``: the logits within
    ``CUT_LOGIT_REL``, the loss within 2 max|dz| of the two runs' logits,
    each leaf's gradient within ``CUT_GRAD_REL`` of its f32 norm, the
    updated weights within ``adamw_step_bound``.  With MoE the f32 run
    routes every token to the experts the bf16 run chose
    (``route_spy``'s replay): a top-k whose margin is within round-off
    may choose otherwise in f32, and a flip moves a token's output and its
    router gradient by far more than any rounding; each such flip is
    counted and its f32 margin held within round-off
    (``routing_flips``).  -> the readings."""
    import dataclasses

    from repro_torch.convert import lm_params_to_reference, unstack_layers
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.optimizers import adamw_step_bound, get_optimizer
    from repro_torch.tree import flatten_with_paths, tree_map

    cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    cut32 = dataclasses.replace(cut, param_dtype="float32",
                                compute_dtype="float32")
    runs = {}
    routes = {"bf16": [], "f32": []}
    p16 = lm_params_to_reference(lm.init_params(cut, seed, device=DEVICE),
                                 cut)
    for name, c, p in (("bf16", cut, p16),
                       ("f32", cut32, tree_map(lambda t: t.float(), p16))):
        if cfg.moe is not None:
            # the f32 run routes each call's tokens where the bf16 run did
            from repro_torch.models import moe as moe_mod

            plain = moe_mod.moe_forward
            moe_mod.moe_forward = route_spy(
                torch, moe_mod, routes[name],
                routes["bf16"] if name == "f32" else None)
        try:
            with torch.no_grad():
                z, _, _ = lm.forward(unstack_layers(p, c), batch, c)
            m, g = loop.grad_and_metrics(p, batch, c)
            # the update in place on a copy of the weights: one copy of the
            # f32 moments (deepseek-moe-16b's two layers: 12.8 GB)
            opt = get_optimizer("adamw", CUT_LR, inplace=True)
            p1, _, sm = loop.make_train_step(c, opt)(
                tree_map(torch.clone, p), opt.init(p), batch)
        finally:
            if cfg.moe is not None:
                moe_mod.moe_forward = plain
        runs[name] = {"z": z, "loss": float(sm["loss"]),
                      "grad_norm": float(sm["grad_norm"]),
                      "g": flatten_with_paths(g), "p1": flatten_with_paths(p1)}
        del z, g, p1
    a, b = runs["bf16"], runs["f32"]
    dz = float((a["z"] - b["z"]).abs().max())
    zmax = float(b["z"].abs().max())
    out = {"layers": CUT_LAYERS, "lr": CUT_LR, "logit_max_abs_diff": dz,
           "logit_bound": CUT_LOGIT_REL * zmax + F32_ATOL,
           "loss_bf16": a["loss"], "loss_f32": b["loss"],
           "loss_bound": 2 * dz}
    if cfg.moe is not None:
        flips = routing_flips(torch, routes["f32"], routes["bf16"],
                              cfg.moe.top_k, U_BF16)
        flips.pop("differs")
        out["routing"] = dict(flips, calls=len(routes["bf16"]))
    if not dz <= out["logit_bound"]:
        raise AssertionError(f"cut bf16 logits off f32 by {dz:.4g} > "
                             f"{out['logit_bound']:.4g}")
    del a["z"], b["z"]
    if not abs(a["loss"] - b["loss"]) <= 2 * dz:
        raise AssertionError(f"cut bf16 loss {a['loss']} vs f32 "
                             f"{b['loss']}: outside 2 max|dz| = {2 * dz:.4g}")
    p0 = flatten_with_paths(p16)
    s_a = min(1.0, 1.0 / max(a["grad_norm"], 1e-9))
    s_b = min(1.0, 1.0 / max(b["grad_norm"], 1e-9))
    del p                              # the f32 copy of the weights
    grad_rel, upd, moved, unused = {}, 0.0, 0, []
    for k, gb in b["g"].items():
        ga = a["g"][k].float()
        norm = float(gb.norm())
        if norm == 0 and not bool(ga.any()):
            unused.append(k)         # a leaf the loss does not reach
        elif not (norm > 0 and bool(torch.isfinite(ga).all())):
            raise AssertionError(f"cut gradient {k}: f32 norm {norm}, "
                                 f"bf16 finite {bool(torch.isfinite(ga).all())}")
        else:
            grad_rel[k] = float((ga - gb).norm()) / norm
        # in float64, a slice at a time (a whole stacked expert leaf's
        # temporaries would not fit beside the two runs)
        flat = [t.reshape(-1) for t in (ga, gb, a["p1"][k], b["p1"][k],
                                        p0[k])]
        for lo in range(0, flat[0].numel(), CHECK_CHUNK):
            g16, g32, p1a, p1b, p00 = (t[lo:lo + CHECK_CHUNK].double()
                                       for t in flat)
            bound = adamw_step_bound(g16 * s_a, g32 * s_b, p1a, p1b, CUT_LR,
                                     U_BF16)
            upd = max(upd, float(((p1a - p1b).abs() / bound).max()))
            moved += int((p1a != p00).sum())
    worst = max(grad_rel, key=grad_rel.get)
    out.update(grad_rel_worst=grad_rel[worst], grad_rel_worst_leaf=worst,
               grad_rel_median=float(np.median(list(grad_rel.values()))),
               grad_rel_bound=CUT_GRAD_REL, update_worst_over_bound=upd,
               elements=sum(v.numel() for v in b["p1"].values()),
               elements_moved_bf16=moved, leaves_without_gradient=unused)
    if not grad_rel[worst] <= CUT_GRAD_REL:
        raise AssertionError(f"cut bf16 gradient {worst} off f32 by "
                             f"{grad_rel[worst]:.4g} of its norm > "
                             f"{CUT_GRAD_REL:.4g}")
    if not upd <= 1.0:
        raise AssertionError(f"cut bf16 update at {upd:.3g} of its bound")
    return out


def train_phase(torch, card, seed: int = 0) -> dict:
    """Phase 16: training.  (a) ``train_fixture_check``; (b) ``qwen3-0.6b``
    at its published widths in bf16 on seeded weights and ``batch_at``
    data: ``bf16_step_against_f32`` (cut to ``CUT_LAYERS`` layers); at all
    28 layers, the bf16 logits and the first step's loss against an f32
    forward of the same weights, then ``TRAIN_STEPS`` AdamW steps at B x S
    = ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (step time, tokens/s beside the FLOP
    bound, peak memory, the loss curve, which must fall), a few Adafactor
    steps, the same shape with ``remat="full"`` (a lower peak), and one
    step at microbatches 2 against 1; (c) ``launcher_kill_resume``.  Prints
    one line; returns the numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference, unstack_layers
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.optimizers import (adamw_step_bound,
                                              cosine_schedule, get_optimizer)
    from repro_torch.tree import tree_leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls would run in TF32")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    t_phase = time.perf_counter()

    # (a) the committed JAX fixture
    t0 = time.perf_counter()
    out["a"] = train_fixture_check(torch)
    out["a"]["s"] = time.perf_counter() - t0

    # (b) full width
    cfg = get_config(LM_ARCH)
    if (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.param_dtype) != (28, 1024, 3072, 151_936, "bfloat16"):
        raise AssertionError(f"{LM_ARCH} is not the published config")
    b, s, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    dc = DataConfig(cfg.vocab_size, s, b, seed=seed)
    batches = [{"tokens": torch.from_numpy(batch_at(dc, i)["tokens"])
                .to(DEVICE)} for i in range(steps)]

    def fresh():
        """The seeded weights in the reference's layout, as the train step
        takes them."""
        return lm_params_to_reference(lm.init_params(cfg, seed, device=DEVICE),
                                      cfg)

    def sync():
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    out["cut"] = bf16_step_against_f32(torch, cfg, batches[0], seed)
    out["cut"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    params = fresh()
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = tree_bytes(params)
    # the bf16 and the f32 logits of the same weights on the first batch
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    with torch.no_grad():
        z16, _, _ = lm.forward(unstack_layers(params, cfg), batches[0], cfg)
        p32 = tree_map(lambda t: t.float(), params)
        del params
        logits32, _, _ = lm.forward(unstack_layers(p32, cfg32), batches[0],
                                    cfg32)
        del p32
        toks0 = batches[0]["tokens"]
        loss32, _ = loop.cross_entropy(logits32[:, :-1], toks0[:, 1:],
                                       cfg.vocab_size)
        loss32 = float(loss32)
        zmax = float(logits32.abs().max())
        dz = float((z16 - logits32).abs().max())
        del z16, logits32
    torch.cuda.empty_cache()
    logit_bound = BF16_REL * zmax + F32_ATOL
    if not dz <= logit_bound:
        raise AssertionError(f"bf16 logits off f32 by {dz:.4g} > "
                             f"{logit_bound:.4g}")

    def profile_step(p, state, step_fn):
        """One more step under ``torch.profiler``: its wall time (the
        profiler's own cost included), the device's busy time, and the aten
        ops with the most device time (their kernels', summed over the
        step), with the share of it in GEMM kernels and in ``aten::stack``
        (the backward of the layers' ``unbind``: each stacked leaf's
        gradient written once)."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step_fn(p, state, batches[0])
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, records = device_busy(torch, prof)
        _, by_name = device_time_by_kind(torch, prof)
        gemm_us = sum(us for name, us in by_name.items()
                      if "gemm" in name or "xmma" in name)
        avgs = prof.key_averages()
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in avgs
                      if e.key.startswith("aten::")
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
        stack = [(e.device_time_total / 1e3, e.count) for e in avgs
                 if e.key == "aten::stack"] or [(0.0, 0)]
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                "device_records": records, "gemm_kernel_ms": gemm_us / 1e3,
                "stack_ms": stack[0][0], "stack_calls": stack[0][1],
                "top_aten_ops_ms": [[k, round(ms, 3), n]
                                    for k, ms, n in ops[:12]]}

    def run(cfg_run, n_steps, micro=1, profile=False, opt_name="adamw"):
        p = fresh()
        opt = get_optimizer(opt_name, cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                                      steps))
        state = opt.init(p)
        step_fn = loop.make_train_step(cfg_run, opt, microbatches=micro)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, losses = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            p, state, m = step_fn(p, state, batches[i])
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(p, state, step_fn) if profile else None
        return times, losses, peak, base, prof

    times, losses, peak, base, prof = run(cfg, steps, profile=True)
    torch.cuda.empty_cache()
    # the FLOP bound: 6 N per token for the matmuls of the weights (N the
    # tree's elements: the tied embedding once, as the head), plus the
    # causal attention's QK^T and PV, forward (x1) and backward (x2), at
    # the bf16 tensor-core peak; and the work as the port does it, whose
    # masked schedule computes every block of S x S in f32
    attn_causal = 3 * 2 * 2 * b * cfg.num_heads * s * s \
        * cfg.resolved_head_dim * cfg.num_layers / 2
    matmul_flop = 6 * n * b * s
    flop = matmul_flop + attn_causal
    bound_ms = flop / BF16_OPS_PER_S * 1e3
    as_done_ms = (matmul_flop / BF16_OPS_PER_S
                  + 2 * attn_causal / FP32_OPS_PER_S) * 1e3
    steady = np.asarray(times[1:])
    p50 = float(np.percentile(steady, 50))
    head = np.mean(losses[:5])
    tail = np.mean(losses[-5:])
    if not tail < head:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    loss_bound = 2 * dz
    if not abs(losses[0] - loss32) <= loss_bound:
        raise AssertionError(f"bf16 loss {losses[0]} vs f32 {loss32}: "
                             f"outside {loss_bound:.4g}")
    out["b"] = {
        "batch": b, "seq": s, "steps": steps, "tokens_per_step": b * s,
        "param_elements": n, "param_bytes": nbytes,
        "state_bytes_at_start": base,
        "step_ms": times, "step_ms_p50": p50,
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": b * s / (p50 / 1e3),
        "flop_per_step": flop, "bound_ms": bound_ms, "bound_by": "operations",
        "bound_share": bound_ms / p50,
        "bound_ms_as_computed": as_done_ms,
        "bound_share_as_computed": as_done_ms / p50,
        "peak_bytes": peak, "losses": losses,
        "loss_first5_mean": float(head), "loss_last5_mean": float(tail),
        "first_loss_bf16": losses[0], "first_loss_f32": loss32,
        "first_loss_bound": loss_bound, "f32_max_abs_logit": zmax,
        "logit_max_abs_diff": dz, "logit_bound": logit_bound,
        "profiled_step": prof,
        "device_busy_share_of_p50": prof["device_busy_ms"] / p50}

    # Adafactor, same shape
    atimes, alosses, apeak, abase, _ = run(cfg, ADAFACTOR_STEPS,
                                           opt_name="adafactor")
    torch.cuda.empty_cache()
    out["adafactor"] = {"steps": ADAFACTOR_STEPS, "step_ms": atimes,
                        "step_ms_p50_after_first":
                            float(np.median(atimes[1:])),
                        "peak_bytes": apeak, "state_bytes_at_start": abase,
                        "losses": alosses}

    # remat full, same shape
    rcfg = dataclasses.replace(cfg, remat="full")
    rtimes, rlosses, rpeak, _, _ = run(rcfg, REMAT_STEPS)
    torch.cuda.empty_cache()
    if not rpeak < peak:
        raise AssertionError(f"remat peak {rpeak} not below {peak}")
    out["remat"] = {"steps": REMAT_STEPS, "step_ms": rtimes,
                    "step_ms_p50_after_first": float(np.median(rtimes[1:])),
                    "peak_bytes": rpeak, "losses": rlosses,
                    "first_loss_equal": rlosses[0] == losses[0]}

    # microbatches 2 against 1 on the first step
    lr = float(cosine_schedule(TRAIN_LR, TRAIN_WARMUP, steps)(
        torch.tensor(1)))
    p0 = fresh()
    _, g1 = loop.grad_and_metrics(p0, batches[0], cfg)
    half = b // 2
    ga = loop.grad_and_metrics(
        p0, {"tokens": batches[0]["tokens"][:half]}, cfg)[1]
    gb = loop.grad_and_metrics(
        p0, {"tokens": batches[0]["tokens"][half:]}, cfg)[1]
    g2 = [(x.float() + y.float()) / 2
          for x, y in zip(tree_leaves(ga), tree_leaves(gb))]
    del ga, gb
    res = {}
    for micro in (1, 2):
        opt = get_optimizer("adamw", cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                                     steps))
        p1, _, m = loop.make_train_step(cfg, opt, microbatches=micro)(
            p0, opt.init(p0), batches[0])
        res[micro] = (tree_leaves(p1), m)
        del p1
    l1, l2 = float(res[1][1]["loss"]), float(res[2][1]["loss"])
    if not abs(l2 - l1) <= 1e-5 * abs(l1):
        raise AssertionError(f"microbatch losses {l1} / {l2}")
    s1 = min(1.0, 1.0 / max(float(res[1][1]["grad_norm"]), 1e-9))
    s2 = min(1.0, 1.0 / max(float(res[2][1]["grad_norm"]), 1e-9))
    worst = 0.0
    differ = 0
    for x1, x2, ga_, gb_ in zip(res[1][0], res[2][0], tree_leaves(g1), g2):
        x1, x2 = x1.double(), x2.double()
        bound = adamw_step_bound(ga_.double() * s1, gb_.double() * s2, x1,
                                 x2, lr, U_BF16)
        worst = max(worst, float(((x1 - x2).abs() / bound).max()))
        differ += int((x1 != x2).sum())
    if not worst <= 1.0:
        raise AssertionError(f"microbatch updates at {worst:.3g} of their "
                             f"bound")
    out["microbatches"] = {"loss_1": l1, "loss_2": l2,
                           "loss_rel_diff": abs(l2 - l1) / abs(l1),
                           "update_worst_over_bound": worst,
                           "elements_that_differ": differ}
    del res, g1, g2, p0
    torch.cuda.empty_cache()

    # (c) the entry point, killed and resumed
    with tempfile.TemporaryDirectory() as tmp:
        out["c"] = launcher_kill_resume(torch, tmp)
    out["seconds"] = time.perf_counter() - t_phase
    bb, r, c, ct = out["b"], out["remat"], out["c"], out["cut"]
    say(f"phase 16 training ({card}): (a) reduced {LM_ARCH} vs the JAX "
        f"fixture, AdamW and Adafactor steps: worst of bound loss "
        f"{out['a']['loss']:.3g}, grad norm {out['a']['grad_norm']:.3g}, "
        f"gradients {out['a']['grad']:.3g}, parameters "
        f"{out['a']['param']:.3g}; (b) {LM_ARCH} full width cut to "
        f"{CUT_LAYERS} layers, one bf16 step vs f32: logits "
        f"{ct['logit_max_abs_diff']:.4g} (bound {ct['logit_bound']:.4g}), "
        f"loss {abs(ct['loss_bf16'] - ct['loss_f32']):.4g} (bound "
        f"{ct['loss_bound']:.4g}), gradients worst "
        f"{ct['grad_rel_worst']:.4g} of the f32 norm "
        f"({ct['grad_rel_worst_leaf']}; median {ct['grad_rel_median']:.4g}; "
        f"bound {CUT_GRAD_REL:.4g}), updates {ct['update_worst_over_bound']:.3g}"
        f" of bound; {LM_ARCH} full width bf16, {n:,} "
        f"elements, B={b} x S={s}, {steps} AdamW steps: step p50 "
        f"{bb['step_ms_p50']:.1f} ms p95 {bb['step_ms_p95']:.1f} ms, "
        f"{bb['tokens_per_s']:,.0f} tok/s, FLOP bound {bound_ms:.2f} ms "
        f"(share {bb['bound_share']:.3f}; as computed, f32 attention "
        f"{as_done_ms:.2f} ms, share {bb['bound_share_as_computed']:.3f}), "
        f"peak {peak / 1e9:.2f} GB, a profiled step's device busy "
        f"{prof['device_busy_ms']:.1f} ms ({prof['device_busy_ms'] / p50:.3f}"
        f" of the p50; GEMMs {prof['gemm_kernel_ms']:.1f} ms); loss "
        f"{losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 5 {head:.4f}, last 5 {tail:.4f}); logits "
        f"bf16 vs f32 {dz:.4g} (bound {logit_bound:.4g}), first loss "
        f"{abs(losses[0] - loss32):.4g} (bound {loss_bound:.4g}); the "
        f"gradients' stack {prof['stack_ms']:.2f} ms; Adafactor step "
        f"{out['adafactor']['step_ms_p50_after_first']:.1f} ms, peak "
        f"{apeak / 1e9:.2f} GB; remat full peak {rpeak / 1e9:.2f} GB, step "
        f"{r['step_ms_p50_after_first']:.1f} ms; microbatches 2 vs 1 loss "
        f"{out['microbatches']['loss_rel_diff']:.3g} rel, updates "
        f"{worst:.3g} of bound; (c) launcher killed after step "
        f"{c['killed_after_checkpoint']}, resumed to {c['steps']}: digest "
        f"equal ({c['bf16_leaves']} bf16 leaves); {out['seconds']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 17: the patch and frame frontends, and training on a mesh
# ---------------------------------------------------------------------------

def frontend_fixture_check(torch, arch) -> dict:
    """The committed JAX fixture of ``arch`` reduced (f32): the port's
    forward and, with a decode step, its prefill of the patches and the
    first tokens then decode steps, on the card, within F32_REL.  -> the
    errors over max|want|."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference, tree_from_flat
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    with np.load(os.path.join(REPO, FRONTEND_FIXTURES[arch])) as f:
        fix = {k: f[k] for k in f.files}
    params = lm_params_from_reference(tree_from_flat(fix, "param/"), cfg,
                                      device=DEVICE)
    batch = {k[len("batch/"):]: torch.from_numpy(v).to(DEVICE)
             for k, v in fix.items() if k.startswith("batch/")}
    out = {}
    with torch.no_grad():
        logits, _, _ = lm.forward(params, batch, cfg)
        out["forward_rel_err"] = hold(torch, logits, torch.from_numpy(
            fix["logits_forward"]), F32_REL)
        if "logits_decode" in fix:
            toks, n_p = batch["tokens"], cfg.frontend_tokens
            half = int(fix["prefill_len"])
            lg, caches, _ = lm.forward(
                params, dict(batch, tokens=toks[:, :half]), cfg,
                mode="prefill", cache_len=n_p + toks.shape[1])
            outs = [lg[:, -1:]]
            for i in range(half, toks.shape[1]):
                lg, caches = lm.decode_step(params, toks[:, i:i + 1], caches,
                                            n_p + i, cfg)
                outs.append(lg)
            out["decode_rel_err"] = hold(torch, torch.cat(outs, 1),
                                         torch.from_numpy(
                                             fix["logits_decode"]), F32_REL)
    return out


def hubert_phase(torch, seed: int = 0) -> dict:
    """(a) ``hubert-xlarge`` at its published widths and depth: the
    fixture; one bf16 step against f32 cut to ``CUT_LAYERS`` layers
    (``bf16_step_against_f32``); at all 48 layers a timed forward and
    ``HUBERT_STEPS`` AdamW steps on one batch of ``encoder_batch_at``
    frames (p50, frames/s beside the FLOP bound, peak memory, a falling
    loss)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference, unstack_layers
    from repro_torch.data.pipeline import DataConfig, encoder_batch_at
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train.optimizers import cosine_schedule, get_optimizer
    from repro_torch.tree import tree_leaves

    arch = "hubert-xlarge"
    cfg = get_config(arch)
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
              cfg.frontend, cfg.frontend_dim, cfg.causal, cfg.param_dtype)
    if widths != (48, 1280, 16, 16, 80, 5120, 504, "frame", 512, False,
                  "bfloat16"):
        raise AssertionError(f"{arch} is not the published config: "
                             f"{widths}")
    out = {"fixture": frontend_fixture_check(torch, arch)}
    b, s, steps = HUBERT_BATCH, HUBERT_SEQ, HUBERT_STEPS
    dc = DataConfig(cfg.vocab_size, s, b, seed=seed)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in encoder_batch_at(dc, 0, cfg.frontend_dim).items()}
    t0 = time.perf_counter()
    out["cut"] = bf16_step_against_f32(torch, cfg, batch, seed)
    out["cut"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    params = lm_params_to_reference(lm.init_params(cfg, seed, device=DEVICE),
                                    cfg)
    n = sum(p.numel() for p in tree_leaves(params))
    if n != lm.tree_size_from_param_count(cfg):
        raise AssertionError(f"{n} parameter elements")
    with torch.no_grad():
        fwd = lambda: lm.forward(unstack_layers(params, cfg),  # noqa: E731
                                 batch, cfg)[0]
        logits = fwd()
        if not bool(torch.isfinite(logits).all()) \
                or tuple(logits.shape) != (b, s, cfg.padded_vocab):
            raise AssertionError(f"hubert logits {tuple(logits.shape)}")
        del logits
        fwd_ms = gpu_ms(torch, fwd, reps=5, warmup=1,
                        sleep_cycles=STEP_SLEEP_CYCLES)
    opt = get_optimizer("adamw", cosine_schedule(HUBERT_LR, HUBERT_WARMUP,
                                                 steps))
    state = opt.init(params)
    step = loop.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    # one more step profiled: the device's busy time and the aten ops with
    # the most device time
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    busy_us, records = device_busy(torch, prof)
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    del params, state, prof
    torch.cuda.empty_cache()
    # encoder_batch_at draws a new label code at every step (ROADMAP.md
    # R8), so what the frames carry is learnable within a batch only: the
    # steps fit batch 0, and its loss must fall
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) \
            < np.mean(losses[:3]):
        raise AssertionError(f"hubert's loss did not fall: {losses}")
    tokens = b * s
    attn = 3 * 2 * 2 * b * cfg.num_heads * s * s * cfg.resolved_head_dim \
        * cfg.num_layers                          # bidirectional: all of S^2
    flop = 6 * n * tokens + attn
    bound_ms = flop / BF16_OPS_PER_S * 1e3
    fwd_bound_ms = (2 * n * tokens + attn / 3) / BF16_OPS_PER_S * 1e3
    p50 = float(np.percentile(times[1:], 50))
    out.update(param_elements=n, layers=cfg.num_layers, batch=b, seq=s,
               steps=steps,
               forward_ms=fwd_ms, forward_bound_ms=fwd_bound_ms,
               step_ms=times, step_ms_p50=p50,
               frames_per_s=tokens / (p50 / 1e3), bound_ms=bound_ms,
               bound_by="operations", bound_share=bound_ms / p50,
               peak_bytes=peak, losses=losses,
               profiled_step={"device_busy_ms": busy_us / 1e3,
                              "device_records": records,
                              "top_aten_ops_ms": [[k, round(ms, 3), c]
                                                  for k, ms, c in ops[:10]]})
    return out


def vlm_phase(torch, seed: int = 0) -> dict:
    """(b) ``qwen2-vl-72b`` at its published widths cut to ``VLM_LAYERS``
    layers, bf16: the fixture; a prefill of 256 patches and
    ``VLM_PREFILL_TEXT`` tokens, then decode steps continuing the text
    ``t`` coordinate, against one forward of the whole sequence; the same
    at 2 layers in bf16 and in f32 against the f32 forward; and
    ``BatchedServer`` over token prompts (tokens/s, a call's p50, one
    request's logits against a forward at its M-RoPE positions)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import frontends, lm
    from repro_torch.serve.batching import BatchedServer, Request
    from repro_torch.tree import tree_leaves, tree_map

    arch = "qwen2-vl-72b"
    full = get_config(arch)
    widths = (full.num_layers, full.d_model, full.num_heads,
              full.num_kv_heads, full.resolved_head_dim, full.d_ff,
              full.vocab_size, full.frontend, full.frontend_dim,
              full.frontend_tokens, full.rope, full.param_dtype)
    if widths != (80, 8192, 64, 8, 128, 29_568, 152_064, "patch", 1176, 256,
                  "mrope", "bfloat16"):
        raise AssertionError(f"{arch} is not the published config: "
                             f"{widths}")
    out = {"fixture": frontend_fixture_check(torch, arch)}
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=DEVICE)
    torch.cuda.synchronize()
    nbytes = tree_bytes(params)
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = nbytes
    out["free_bytes_after_init"] = torch.cuda.mem_get_info()[0]
    n_p, text = full.frontend_tokens, VLM_TEXT
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, full.vocab_size, (VLM_BATCH, text)).astype(np.int32))
             .to(DEVICE),
             "patches": torch.from_numpy(rng.standard_normal(
                 (VLM_BATCH, n_p, full.frontend_dim)).astype(np.float32))
             .to(DEVICE)}

    def prefill_decode(p, c):
        toks = batch["tokens"]
        lg, caches, _ = lm.forward(
            p, dict(batch, tokens=toks[:, :VLM_PREFILL_TEXT]), c,
            mode="prefill", cache_len=n_p + text)
        outs = [lg[:, -1:]]
        for i in range(VLM_PREFILL_TEXT, text):
            lg, caches = lm.decode_step(p, toks[:, i:i + 1], caches, n_p + i,
                                        c)
            outs.append(lg)
        return torch.cat(outs, 1)

    at = slice(n_p + VLM_PREFILL_TEXT - 1, n_p + text)
    with torch.no_grad():
        t0 = time.perf_counter()
        fwd16, _, _ = lm.forward(params, batch, cfg)
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        dec16 = prefill_decode(params, cfg)
        out["decode_vs_forward_rel_err"] = hold(
            torch, dec16, fwd16[:, at], VLM_BF16_PAIR_REL)
        del fwd16, dec16
        # two layers: bf16 and an f32 copy of the same weights
        cut = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
        p2 = dict(params, layers=params["layers"][:CUT_LAYERS])
        cut32 = dataclasses.replace(cut, param_dtype="float32",
                                    compute_dtype="float32")
        p32 = tree_map(lambda t: t.float(), p2)
        fwd32, _, _ = lm.forward(p32, batch, cut32)
        want = fwd32[:, at]
        del fwd32
        out["cut_f32_decode_rel_err"] = hold(
            torch, prefill_decode(p32, cut32), want, F32_REL)
        out["cut_bf16_decode_vs_f32_rel_err"] = hold(
            torch, prefill_decode(p2, cut), want, CUT_LOGIT_REL)
        del p32, p2, want
    torch.cuda.empty_cache()

    # the server over token prompts
    server = BatchedServer(params, cfg, VLM_SLOTS, VLM_MAX_LEN, seed=seed,
                           device=DEVICE)
    rec, call_ms = {}, []
    orig = server._decode

    def wrapped(p, c, t, pos, rows):
        t0 = time.perf_counter()
        logits, c = orig(p, c, t, pos, rows)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        for slot in rows:
            req = server.slot_req[slot]
            if req.uid == 0 and pos >= len(req.prompt) - 1:
                rec[pos] = logits[slot, 0].clone()
        return logits, c

    server._decode = wrapped
    reqs = [Request(uid=i, prompt=rng.integers(
                0, full.vocab_size, int(rng.integers(VLM_PROMPT[0],
                                                     VLM_PROMPT[1] + 1)))
                .astype(np.int32),
                max_new_tokens=int(rng.integers(VLM_NEW[0], VLM_NEW[1] + 1)))
            for i in range(VLM_REQUESTS)]
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    if len(done) != VLM_REQUESTS or any(max(r.output) >= full.vocab_size
                                        for r in done):
        raise AssertionError("the vlm server did not finish cleanly")
    # request 0 against a forward over its tokens at the positions the
    # server numbered them (the text t after a 256-patch grid)
    r0 = next(r for r in done if r.uid == 0)
    seq = np.concatenate([r0.prompt, np.asarray(r0.output, np.int32)])
    pos = torch.arange(len(seq), device=DEVICE)
    t_coord = frontends.text_mrope_t0(n_p) + pos - n_p
    with torch.no_grad():
        want, _, _ = lm.forward(params, {
            "tokens": torch.from_numpy(seq)[None].to(DEVICE),
            "patches": torch.zeros((1, 0, full.frontend_dim),
                                   device=DEVICE),
            "mrope_positions": t_coord[None, :, None].expand(1, -1, 3)},
            cfg)
    p0 = len(r0.prompt) - 1
    got = torch.stack([rec[p0 + j] for j in range(len(r0.output))])
    server_err = hold(torch, got, want[0, p0:p0 + len(r0.output)],
                      VLM_BF16_PAIR_REL)
    lat = np.asarray(call_ms)
    out["server"] = {"requests": VLM_REQUESTS, "slots": VLM_SLOTS,
                     "tokens_out": tokens, "wall_s": wall,
                     "tokens_per_s": tokens / wall,
                     "decode_call_ms_p50": float(np.percentile(lat, 50)),
                     "decode_call_ms_p95": float(np.percentile(lat, 95)),
                     "decode_calls": len(call_ms),
                     "request0_rel_err_vs_forward": server_err,
                     "bytes_bound_ms_a_call": nbytes / HBM_BYTES_PER_S * 1e3}
    out["layers"] = VLM_LAYERS
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del server, params, want, got, rec
    torch.cuda.empty_cache()
    return out


def mesh_phase(torch, argv=MESH_ARGS) -> dict:
    """(c) ``tools/lm_ranks.py``'s work (``argv``; by default qwen3-0.6b at
    full width and depth) in one spawned NCCL rank per visible card, up to
    ``MESH_RANKS_MAX``, on a (data, model) mesh -- (2, 2) on four cards,
    (1, 2) on two, (1, 1) on one.  -> rank 0's numbers."""
    import torch.multiprocessing as mp

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import lm_ranks

    world = min(torch.cuda.device_count(), MESH_RANKS_MAX)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        ctx = mp.start_processes(
            lm_ranks.spawned_rank,
            args=(world, os.path.join(tmp, "store"),
                  list(argv) + ["--ckpt-dir", os.path.join(tmp, "ckpt")],
                  out_path),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_WAIT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"{world} mesh ranks did not finish in "
                                     f"{MESH_WAIT_S} s")
        with open(out_path) as f:
            out = json.load(f)
    out["summary"] = lm_ranks.summary(out)
    return out


def frontends_mesh_phase(torch, card) -> dict:
    """Phase 17: (a) ``hubert_phase``, (b) ``vlm_phase``, (c)
    ``mesh_phase``.  Prints one line; returns the numbers."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for key, fn in (("hubert", hubert_phase), ("vlm", vlm_phase)):
        t0 = time.perf_counter()
        out[key] = fn(torch)
        out[key]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["mesh"] = mesh_phase(torch)
    out["mesh"]["s"] = time.perf_counter() - t0
    h, v, m = out["hubert"], out["vlm"], out["mesh"]
    hc, vs = h["cut"], v["server"]
    say(f"phase 17 frontends and the mesh ({card}): (a) hubert-xlarge "
        f"{h['param_elements']:,} elements: fixture "
        f"{h['fixture']['forward_rel_err']:.3g}; cut to {CUT_LAYERS} layers "
        f"bf16 vs f32 logits {hc['logit_max_abs_diff']:.4g} (bound "
        f"{hc['logit_bound']:.4g}), gradients worst "
        f"{hc['grad_rel_worst']:.4g} of the f32 norm (bound "
        f"{CUT_GRAD_REL:.4g}); {h['layers']} layers B={h['batch']} x "
        f"S={h['seq']} "
        f"frames: forward {h['forward_ms']:.1f} ms, AdamW step p50 "
        f"{h['step_ms_p50']:.1f} ms, {h['frames_per_s']:,.0f} frames/s, "
        f"FLOP bound {h['bound_ms']:.2f} ms (share {h['bound_share']:.3f}), "
        f"a profiled step's device busy "
        f"{h['profiled_step']['device_busy_ms']:.1f} ms, peak "
        f"{h['peak_bytes'] / 1e9:.2f} GB, loss {h['losses'][0]:.4f} -> "
        f"{h['losses'][-1]:.4f}; (b) qwen2-vl-72b cut to {v['layers']} of "
        f"80 layers ({v['param_bytes'] / 1e9:.2f} GB bf16): fixture "
        f"forward {v['fixture']['forward_rel_err']:.3g}, decode "
        f"{v['fixture']['decode_rel_err']:.3g}; 256 patches + "
        f"{VLM_PREFILL_TEXT} tokens prefilled, decode vs forward "
        f"{v['decode_vs_forward_rel_err']:.3g} (bound "
        f"{VLM_BF16_PAIR_REL:.4f}); at {CUT_LAYERS} layers f32 decode "
        f"{v['cut_f32_decode_rel_err']:.3g}, bf16 vs f32 "
        f"{v['cut_bf16_decode_vs_f32_rel_err']:.3g} (bound "
        f"{CUT_LOGIT_REL:.4f}); server {vs['tokens_out']} tokens "
        f"{vs['tokens_per_s']:.1f} tok/s, call p50 "
        f"{vs['decode_call_ms_p50']:.2f} ms (bytes bound "
        f"{vs['bytes_bound_ms_a_call']:.2f} ms), request 0 vs forward "
        f"{vs['request0_rel_err_vs_forward']:.3g}; (c) {m['summary']}")
    return out




# ---------------------------------------------------------------------------
# phase 19: the dry-run and the serving layout
# ---------------------------------------------------------------------------

def start_dryrun(tmp: str):
    """Phase 19 (b)'s process, started ahead (``DRYRUN_MAIN``) -> (the
    process, its output path, its log path, the start time)."""
    path = os.path.join(tmp, "dryrun_phase.json")
    log = open(os.path.join(tmp, "dryrun_phase.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_MAIN, json.dumps(
            [LM_ARCH, TRAIN_BATCH, TRAIN_SEQ, DRYRUN_CELLS, path])],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=tmp)
    return proc, path, log, time.perf_counter()


def dryrun_phase(torch, card, started, training: dict, mesh: dict) -> dict:
    """Phase 19: (a) phase 17's mesh serve check, read back; (b) the
    dry-run's process joined and its reckonings held (``DRYRUN_*``)."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = {}
    serve = mesh.get("serve")
    if not serve or serve["f32"]["layers"] != CUT_LAYERS \
            or serve["bf16"]["layers"] != get_config(LM_ARCH).num_layers:
        raise AssertionError(f"phase 19 (a): no mesh serve check: {serve}")
    for k in ("f32", "bf16"):
        if not serve[k]["worst_over_bound"] <= 1.0:
            raise AssertionError(f"phase 19 (a) {k}: {serve[k]}")
    out["a"] = dict(serve, mesh=mesh["mesh"], backend=mesh["backend"])

    proc, path, log, t_start = started
    try:
        proc.wait(timeout=max(DRYRUN_WAIT_S - (time.perf_counter()
                                               - t_start), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        with open(log.name) as f:
            raise AssertionError(f"phase 19 (b): the dry-run failed "
                                 f"(rc {proc.returncode}):\n"
                                 f"{f.read()[-3000:]}")
    with open(path) as f:
        dry = json.load(f)
    out["dryrun_s"] = time.perf_counter() - t_start
    cfg = get_config(LM_ARCH)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    n = training["b"]["param_elements"]
    attn_causal = 3 * 2 * 2 * b * cfg.num_heads * s * s \
        * cfg.resolved_head_dim * cfg.num_layers / 2
    matmul_flop = 6 * n * b * s
    as_done = matmul_flop + 2 * attn_causal
    layers = n - cfg.padded_vocab * cfg.d_model - cfg.d_model
    recompute_want = 2 * layers * b * s + 2 * attn_causal / 3
    plain, full = dry["phase_16"][cfg.remat], dry["phase_16"]["full"]
    recompute = full["flops"] - plain["flops"]
    checks = {
        "peak_" + cfg.remat: (plain["memory"]["peak_bytes"],
                              training["b"]["peak_bytes"], DRYRUN_PEAK_REL),
        "peak_full": (full["memory"]["peak_bytes"],
                      training["remat"]["peak_bytes"], DRYRUN_PEAK_REL),
        "flops": (plain["flops"], as_done, DRYRUN_FLOP_REL)}
    out["b"] = {"recompute_flops": {
        "reckoned": recompute, "forward_of_the_layers": recompute_want,
        "ratio": recompute / recompute_want}}
    if not 0 < recompute <= recompute_want:
        raise AssertionError(f"phase 19 (b): remat's recompute {recompute} "
                             f"FLOPs, not in (0, {recompute_want}]")
    for key, (got, want, rel) in checks.items():
        ratio = got / want
        out["b"][key] = {"reckoned": got, "measured_or_closed_form": want,
                         "ratio": ratio, "rel": rel}
        if not abs(ratio - 1) <= rel:
            raise AssertionError(f"phase 19 (b) {key}: reckoned {got} vs "
                                 f"{want} (ratio {ratio:.4f}, limit "
                                 f"{rel:.0%})")
    out["b"]["collectives_at_1x1"] = plain["collectives"]
    out["cells"] = []
    for rec in dry["cells"]:
        if rec["status"] != "ok":
            raise AssertionError(f"phase 19 (b) {rec['arch']} x "
                                 f"{rec['shape']}: {rec.get('error')}")
        out["cells"].append({k: rec[k] for k in (
            "arch", "shape", "mesh_tag", "status", "memory",
            "flops_per_device_raw", "num_collectives", "seconds_trace")}
            | {"wire_bytes": rec["collectives"]["total_wire_bytes"]})
    out["seconds"] = time.perf_counter() - t_phase
    a, bb = out["a"], out["b"]
    say(f"phase 19 dry-run and serving layout ({card}): (a) {LM_ARCH} "
        f"prefill + decode on the ({', '.join(map(str, a['mesh']))}) mesh "
        f"over {a['backend']} vs one device: f32 {a['f32']['layers']} "
        f"layers {a['f32']['worst_over_bound']:.3g} of bound, bf16 "
        f"{a['bf16']['layers']} layers {a['bf16']['worst_over_bound']:.3g} "
        f"of bound; (b) phase 16's step reckoned on a fake group of one "
        f"(a reckoning, not a time): peak {cfg.remat} "
        f"{bb['peak_' + cfg.remat]['reckoned'] / 1e9:.2f} GB vs measured "
        f"{bb['peak_' + cfg.remat]['measured_or_closed_form'] / 1e9:.2f} GB "
        f"({bb['peak_' + cfg.remat]['ratio']:.3f}), remat full "
        f"{bb['peak_full']['reckoned'] / 1e9:.2f} vs "
        f"{bb['peak_full']['measured_or_closed_form'] / 1e9:.2f} GB "
        f"({bb['peak_full']['ratio']:.3f}); FLOPs {bb['flops']['ratio']:.4f} "
        f"of matmul_flop + 2 attn_causal, remat's recompute "
        f"{bb['recompute_flops']['ratio']:.4f} of a forward of the layers; "
        + "; ".join(f"{c['arch']} x {c['shape']} on 16 x 16: {c['status']}, "
                    f"{c['flops_per_device_raw']:.3e} FLOPs, "
                    f"{c['memory']['peak_bytes'] / 1e9:.2f} GB peak, "
                    f"{c['num_collectives']} collectives, "
                    f"{c['wire_bytes']:.3e} wire bytes (traced in "
                    f"{c['seconds_trace']} s)" for c in out["cells"])
        + f"; the dry-run process, started {out['dryrun_s']:.0f} s "
        f"before this phase's end, ran beside phases 14-18")
    return out


# ---------------------------------------------------------------------------
# phase 18: MoE training through the mesh's dispatch
# ---------------------------------------------------------------------------

def moe_train_phase(torch, card, seed: int = 0) -> dict:
    """Phase 18: ``deepseek-moe-16b`` at its published widths in bf16.
    (a) ``bf16_step_against_f32`` cut to ``CUT_LAYERS`` layers on
    ``batch_at`` data at 8 x 512 (the published capacity factor 1.25), the
    f32 run routed where the bf16 one routed, the flips counted; (b)
    ``tools/lm_ranks.py``'s work at ``MOE_TRAIN_LAYERS`` of 28 layers in
    the spawned NCCL ranks of ``mesh_phase`` -- (1, 1) on one card, the MoE
    layers through ``ShardedLM``'s dispatch: the f32 step cut to 2 layers
    against one card's (at capacity factor E / k: no drops), AdamW steps
    at 8 x 512 (step p50, tokens/s, peak, each step's drop fraction at
    1.25, the loss), a checkpoint crossing meshes, the int8 mean.  Prints
    one line; returns the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_phase = time.perf_counter()
    cfg = get_config(MOE_TRAIN_ARCH)
    moe = cfg.moe
    if ((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.resolved_head_dim,
         cfg.vocab_size, cfg.param_dtype),
            (moe.num_experts, moe.top_k, moe.d_expert, moe.num_shared,
             moe.capacity_factor)) != (
            (28, 2048, 16, 128, 102_400, "bfloat16"), (64, 6, 1408, 2, 1.25)):
        raise AssertionError(f"{MOE_TRAIN_ARCH} is not the published config")
    dc = DataConfig(cfg.vocab_size, 512, 8, seed=seed)
    batch = {"tokens": torch.from_numpy(batch_at(dc, 0)["tokens"])
             .to(DEVICE)}
    out = {"device_bytes_held_at_start": torch.cuda.memory_allocated(),
           "device_bytes_reserved_at_start": torch.cuda.memory_reserved()}
    t0 = time.perf_counter()
    out["cut"] = bf16_step_against_f32(torch, cfg, batch, seed)
    out["cut"]["s"] = time.perf_counter() - t0
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["mesh"] = mesh_phase(torch, MOE_TRAIN_ARGS)
    out["mesh"]["s"] = time.perf_counter() - t0
    run = out["mesh"]["bf16"]
    if run["layers"] != MOE_TRAIN_LAYERS or not run["drop_fractions"]:
        raise AssertionError(f"phase 18 ran {run['layers']} layers, drop "
                             f"fractions {run['drop_fractions']}")
    if not all(np.isfinite(run["losses"])) or not all(
            0.0 <= d < 1.0 for d in run["drop_fractions"]):
        raise AssertionError(f"phase 18 losses {run['losses']}, drop "
                             f"fractions {run['drop_fractions']}")
    out["seconds"] = time.perf_counter() - t_phase
    ct, rt = out["cut"], out["cut"]["routing"]
    say(f"phase 18 MoE training ({card}): (a) {MOE_TRAIN_ARCH} full width "
        f"cut to {CUT_LAYERS} layers, one bf16 step vs f32 at 8 x 512, the "
        f"f32 run routed as the bf16 one ({rt['flipped']} of "
        f"{rt['tokens']} tokens would route apart in f32, each flip's "
        f"margin within {rt['worst_margin_over_bound']:.3g} of its "
        f"round-off bound): logits {ct['logit_max_abs_diff']:.4g} (bound "
        f"{ct['logit_bound']:.4g}), loss "
        f"{abs(ct['loss_bf16'] - ct['loss_f32']):.4g} (bound "
        f"{ct['loss_bound']:.4g}), gradients worst "
        f"{ct['grad_rel_worst']:.4g} of the f32 norm "
        f"({ct['grad_rel_worst_leaf']}; median {ct['grad_rel_median']:.4g};"
        f" bound {CUT_GRAD_REL:.4g}), updates "
        f"{ct['update_worst_over_bound']:.3g} of bound; (b) "
        f"{out['mesh']['summary']}; {out['seconds']:.1f} s")
    return out


def late_phases(torch, card, report: dict, dry) -> dict:
    """Phases 14-18 into ``report``, then phase 19 (``dry``: its dry-run
    process, started before them) -> phase 19's numbers."""
    # -- phase 14: LM serving at full width ------------------------------------
    torch.cuda.empty_cache()
    report["lm"] = lm_phase(torch, card)

    # -- phase 15: the MoE, SSM and hybrid decoders at full width ---------------
    torch.cuda.empty_cache()
    report["families"] = families_phase(torch, card)

    # -- phase 16: training at full width ----------------------------------------
    torch.cuda.empty_cache()
    report["training"] = train_phase(torch, card)

    # -- phase 17: the patch and frame frontends, training on a mesh ----------
    torch.cuda.empty_cache()
    report["frontends_mesh"] = frontends_mesh_phase(torch, card)

    # -- phase 18: MoE training through the mesh's dispatch --------------------
    torch.cuda.empty_cache()
    report["moe_training"] = moe_train_phase(torch, card)

    # -- phase 19: the dry-run and the serving layout ---------------------------
    return dryrun_phase(torch, card, dry, report["training"],
                        report["frontends_mesh"]["mesh"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    # the launch geometry comes from the policies alone: no cache file is
    # read and no search runs at launch time (phase 13 checks it)
    for var in ("REPRO_AUTOTUNE_CACHE", "REPRO_AUTOTUNE_MEASURE"):
        os.environ.pop(var, None)
    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.gee import (ALL_OPTION_SETTINGS, gee_scipy,
                                      gee_sparse_torch)
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import TABLE2, synth_like
    from repro_torch.graph.ell import edges_to_bucketed_ell
    from repro_torch.graph.sbm import sample_sbm
    from repro_torch.kernels import build, gee_fused, ops
    from repro_torch.kernels import gee_spmm as gee_spmm_mod
    from repro_torch.kernels import row_norm as row_norm_mod
    from repro_torch.kernels.gee_fused import ENV_FUSED, gee_spmm_fused
    from repro_torch.kernels.gee_spmm import gee_spmm
    from repro_torch.kernels.ref import (gee_spmm_fused_ref,
                                         gee_spmm_gathered_ref, gee_spmm_ref,
                                         row_norm_ref)
    from repro_torch.kernels.row_norm import row_norm
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import topk_score as topk_mod
    from repro_torch.search import index as index_mod

    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}
    kernels = {"gee_spmm": gee_spmm, "row_norm": row_norm,
               "gee_spmm_fused": gee_spmm_fused}

    # -- phase 1: device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(card)
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, tf32 off")
    report["card"] = card

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, compiler_out = build.build()
    lib = build.load_library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "nvcc_output.txt"), "w") as f:
        f.write(compiler_out)
    if lib.gee_kernels_max_classes() != gee_fused.MAX_CLASSES:
        raise AssertionError("MAX_CLASSES differs between the .cu source "
                             "and repro_torch.kernels.gee_fused")
    if lib.topk_kernels_max_topk() != topk_mod.MAX_TOPK:
        raise AssertionError("MAX_TOPK differs between the .cu source "
                             "and repro_torch.kernels.topk_score")
    # For comparison: the same sources in one nvcc call, one after the other
    # (after the build above, so the compiler's files are in the page cache).
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        "-o", os.path.join(tmp, "one_call.so"),
                        *(str(s) for s in build.sources()
                          if s.suffix == ".cu")],
                       capture_output=True, check=True)
        one_call_s = time.perf_counter() - t0
    say(f"phase 2 build: nvcc {' '.join(build.NVCC_FLAGS)} -c, one per "
        f"source, in parallel: {KERNEL_SOURCE} {TOPK_SOURCE} -> "
        f"{os.path.relpath(lib_path, REPO)} in {build_s:.2f} s (the same "
        f"sources in one nvcc -shared call: {one_call_s:.2f} s)")
    report["build_s"] = build_s
    report["build_one_call_s"] = one_call_s

    # -- phase 3a: kernel vs plain on edge cases -------------------------------
    errs = {name: [] for name in kernels}
    n_cases = edge_cases(torch, (gee_spmm, row_norm, gee_spmm_fused),
                         (gee_spmm_ref, row_norm_ref, gee_spmm_fused_ref),
                         errs)
    n_contraction = contraction_edge_cases(
        torch, gee_spmm, gee_spmm_fused, (gee_spmm_ref, gee_spmm_fused_ref),
        errs, gee_spmm_mod.SPAN)
    torch.cuda.synchronize()
    say(f"phase 3a kernel vs plain, {n_cases} edge cases and "
        f"{n_contraction} of the contraction's geometry (span "
        f"{gee_spmm_mod.SPAN}), each launched twice, same bits: "
        + ", ".join(f"{k} {fmt_err(v)}" for k, v in errs.items()))

    # -- phase 3c: the retrieval kernels vs plain on edge cases --------------
    rkernels = {"pairwise_scores": topk_mod.pairwise_scores,
                "gathered_scores": topk_mod.gathered_scores,
                "scored_topk": topk_mod.scored_topk,
                "scored_topk_gathered": topk_mod.scored_topk_gathered}
    errs.update({name: [] for name in rkernels})
    n_cases = topk_edge_cases(torch, topk_mod, ref_mod, errs)
    n_gathered, chunk_counts = gathered_topk_edge_cases(torch, topk_mod,
                                                        ref_mod, errs)
    n_scored, scored_counts = scored_topk_edge_cases(torch, topk_mod,
                                                     ref_mod, errs)
    n_pairwise = pairwise_edge_cases(torch, topk_mod, ref_mod, errs)
    torch.cuda.synchronize()
    say(f"phase 3c retrieval kernels vs plain, {n_cases} edge cases x "
        f"(l2, cosine), {n_gathered} more of scored_topk_gathered (chunk "
        f"counts {chunk_counts}), {n_scored} of scored_topk (chunk counts "
        f"{scored_counts}) and {n_pairwise} of pairwise_scores: "
        + ", ".join(f"{k} {fmt_err(errs[k])}" for k in rkernels))

    # -- graphs ---------------------------------------------------------------
    t0 = time.perf_counter()
    sbm = sample_sbm(10_000, seed=0)
    cl = synth_like(TABLE2["cl-100k-1d8-l5"], seed=0)
    gen_s = time.perf_counter() - t0
    graphs = {
        "sbm-10k": (sbm.edges, sbm.labels, sbm.num_classes),
        "cl-100k-1d8-l5": (cl.edges, cl.labels, cl.spec.num_classes),
    }
    prepared = {g: PreparedGraph(e) for g, (e, _, _) in graphs.items()}
    default = GEEEmbedder(num_classes=1).options
    say(f"graphs: sbm-10k N={sbm.edges.num_nodes} E={sbm.edges.num_edges}, "
        f"cl-100k-1d8-l5 N={cl.edges.num_nodes} E={cl.edges.num_edges} "
        f"(generated in {gen_s:.1f} s)")

    def fit(g, opts, fused):
        edges_or_prep = prepared[g]
        _, labels, k = graphs[g]
        os.environ[ENV_FUSED] = "1" if fused else "0"
        try:
            plan = GEEPlan.build(edges_or_prep, k, opts, backend="cuda")
            if plan.fused != fused:
                raise AssertionError(f"plan for {opts.tag()} is not "
                                     f"{'fused' if fused else 'staged'}")
            return GEEEmbedder(num_classes=k, options=opts,
                               backend="cuda").fit_transform(
                                   edges_or_prep, labels)
        finally:
            del os.environ[ENV_FUSED]

    # Capture the kernels' exact inputs on the main path (default options,
    # both graphs, fused and staged).  These launches come before the
    # counts are reset, so they do not count as main-path launches.  The
    # drivers make gathered launches (``gcaptured``, by the plane kernel
    # each driver's launch stands for); each plane kernel is held and timed
    # on the planes those launches stand for (``planes_of``).
    captured, gcaptured = {}, {}
    for g in graphs:
        with Recorder(gee_fused, "gee_spmm_gathered") as rec_f:
            fit(g, default, True)
        with Recorder(ops, "gee_spmm_gathered") as rec_s, \
                Recorder(row_norm_mod, "row_norm") as rec_n:
            fit(g, default, False)
        captured[g] = {
            "gee_spmm_fused": [planes_of(torch, a, kw, True)
                               for a, kw in rec_f.calls],
            "gee_spmm": [planes_of(torch, a, kw, False)
                         for a, kw in rec_s.calls],
            "row_norm": rec_n.calls}
        gcaptured[g] = {"gee_spmm_fused": rec_f.calls,
                        "gee_spmm": rec_s.calls}
    torch.cuda.synchronize()

    # -- phases 4-5: the main path, counted -----------------------------------
    # The bucketed drivers launch the contraction kernels through the
    # gathered source: those launches count to the plane kernel their
    # driver replaces (``gathered``), and the registry's counters must read
    # them all as gathered.
    for fn in kernels.values():
        fn.launches = 0
    gathered = {"gee_spmm_fused": 0, "gee_spmm": 0}
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.get_registry()
    routes = (reg.counter(gee_spmm_mod.GATHERED_COUNTER).value,
              reg.counter(gee_spmm_mod.PLANES_COUNTER).value)
    results = {}
    t0 = time.perf_counter()
    for g, settings in (("sbm-10k", ALL_OPTION_SETTINGS),
                        ("cl-100k-1d8-l5", (default,))):
        edges, labels, k = graphs[g]
        labels_dev = torch.from_numpy(labels).to(DEVICE)
        errs_g = {}
        for opts in settings:
            ref = gee_sparse_torch(edges, labels_dev, k, opts)
            for fused in (True, False):
                before = gee_fused.gee_spmm_gathered.launches
                z = fit(g, opts, fused)
                gathered["gee_spmm_fused" if fused else "gee_spmm"] += \
                    gee_fused.gee_spmm_gathered.launches - before
                if z.shape != (edges.num_nodes, k) \
                        or not bool(torch.isfinite(z).all()):
                    raise AssertionError(f"{g} {opts.tag()}: bad output")
                errs_g[f"{opts.tag()} {'fused' if fused else 'staged'}"] = \
                    max_err(torch, z, ref)
        results[g] = errs_g
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    routes = (reg.counter(gee_spmm_mod.GATHERED_COUNTER).value - routes[0],
              reg.counter(gee_spmm_mod.PLANES_COUNTER).value - routes[1])
    if routes != (sum(gathered.values()), 0) or not all(gathered.values()):
        raise AssertionError(f"main path: {routes} launches gathered and "
                             f"on planes, {gathered} gathered launches "
                             f"counted")
    launches = {name: fn.launches + gathered.get(name, 0)
                for name, fn in kernels.items()}

    # the default setting against the host SciPy reference (SBM)
    src, dst, w = sbm.edges.valid_arrays()
    z_host = gee_scipy(src, dst, w, sbm.labels, 3, default)
    z_dev = fit("sbm-10k", default, True).cpu()
    scipy_errs = [max_err(torch, z_dev, torch.from_numpy(z_host))]
    z_dev = fit("sbm-10k", default, False).cpu()
    scipy_errs.append(max_err(torch, z_dev, torch.from_numpy(z_host)))
    scipy_err = worst(scipy_errs)
    say(f"phase 4 main path sbm-10k: 8 settings x (fused, staged) vs "
        f"sparse_torch {fmt_err(results['sbm-10k'].values())}; default vs "
        f"host gee_scipy {fmt_err(scipy_errs)}")
    say(f"phase 5 main path cl-100k-1d8-l5: default (fused, staged) vs "
        f"sparse_torch {fmt_err(results['cl-100k-1d8-l5'].values())} "
        f"(phases 4-5 took {main_s:.1f} s; launches {launches}, of which "
        f"gathered {gathered}; registry counters, gathered and planes: "
        f"{routes})")
    report.update(main_path_errs=results, scipy_err=scipy_err,
                  launches=launches, launches_gathered=gathered)

    # -- phase 3b: kernel vs plain on the main path's real buckets -----------
    # (the contraction kernels on the planes, and through the gathered
    # source on the drivers' own operands, each into a Z of its own)
    plain = {"gee_spmm": gee_spmm_ref, "row_norm": row_norm_ref,
             "gee_spmm_fused": gee_spmm_fused_ref}
    n_real = 0
    for g in graphs:
        for name, calls in captured[g].items():
            for args, kwargs in calls:
                errs[name].append(max_err(torch, kernels[name](*args, **kwargs),
                                          plain[name](*args, **kwargs)))
                n_real += 1
        for name, calls in gcaptured[g].items():
            for a, kw in calls:
                got = gee_fused.gee_spmm_gathered(
                    *a[:5], torch.zeros_like(a[5]), a[6], **kw)
                want = gee_spmm_gathered_ref(
                    *a[:5], torch.zeros_like(a[5]), a[6], **kw)
                errs[name].append(max_err(torch, got, want))
                n_real += 1
    torch.cuda.synchronize()
    say(f"phase 3b kernel vs plain, {n_real} real launches of the main path: "
        + ", ".join(f"{k} {fmt_err(errs[k])}" for k in kernels))

    # -- phase 6: timing ------------------------------------------------------
    timing = {}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    # A contraction kernel's entry times what the main path launches: its
    # driver's gathered launches of one default fit (``gcaptured``), against
    # their bound and their plain version; the plane kernel on the planes
    # they stand for is ``plane_ms``, against ``plane_bound_ms``.
    for g in graphs:
        tg = {}
        for name, calls in captured[g].items():
            if name == "row_norm":
                run, fn, plain_fn = calls, kernels[name], plain[name]
                nbytes = sum(8 * a[0].numel() for a, _ in calls)
                ops_ = sum(3 * a[0].numel() for a, _ in calls)
            else:
                run, fn = gcaptured[g][name], gee_fused.gee_spmm_gathered
                plain_fn = gee_spmm_gathered_ref
                # + the fit's [N] vertex records, read once
                nbytes = sum(contraction_bytes(a) for a, _ in run) \
                    + 8 * run[0][0][3].shape[0]
                ops_ = sum(int((a[0] >= 0).sum()) for a, _ in calls)
            t_kernel = gpu_ms(torch, lambda: [fn(*a, **kw) for a, kw in run])
            per_launch = [gpu_ms(torch, lambda: fn(*a, **kw), reps=10)
                          for a, kw in run]
            buckets = None
            if name != "row_norm":
                # the staged fit packs A + I (the default's diag-aug)
                bell = prepared[g].bucketed_ell(name == "gee_spmm")
                buckets = bucket_table(torch, fn, run, bell, flush)
            t_plain = gpu_ms(torch, lambda: [plain_fn(*a, **kw)
                                             for a, kw in run], reps=10)
            lib_ms = None
            if name == "row_norm":
                import torch.nn.functional as F
                lib_ms = gpu_ms(torch, lambda: [
                    F.normalize(a[0], dim=1, eps=1e-30) for a, _ in calls])
            elif name == "gee_spmm":
                a_csr, w_dense, want = csr_operands(torch, *graphs[g])
                library_err = max_err(torch, torch.sparse.mm(a_csr, w_dense),
                                      want)
                lib_ms = gpu_ms(torch, lambda: torch.sparse.mm(a_csr,
                                                               w_dense))
                del a_csr, w_dense, want
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_ / FP32_OPS_PER_S * 1e3
            tg[name] = {
                "launches_per_fit": len(run), "ms": t_kernel,
                "ms_per_launch": t_kernel / len(run), "plain_ms": t_plain,
                "library_ms": lib_ms, "bytes": nbytes,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "shapes": [list(a[0].shape) for a, _ in run],
                "per_launch_ms": per_launch, "buckets": buckets}
            if name != "row_norm":
                plane_bytes = sum(contraction_bytes(a) for a, _ in calls)
                tg[name].update(
                    plane_ms=gpu_ms(torch, lambda: [kernels[name](*a, **kw)
                                                    for a, kw in calls]),
                    plane_bytes=plane_bytes,
                    plane_bound_ms=max(plane_bytes / HBM_BYTES_PER_S * 1e3,
                                       ops_ms))
            if name == "gee_spmm":
                tg[name]["library"] = "torch.sparse.mm(A_csr, W), cuSPARSE"
                tg[name]["library_err"] = library_err
        edges, labels, k = graphs[g]
        # end to end: warm (packing cached in the PreparedGraph) and cold
        warm = host_ms(torch, lambda: GEEEmbedder(num_classes=k).fit_transform(
            prepared[g], labels), reps=10)
        # the same warm fit on the device's clock: with the labels already
        # there nothing in the fit waits for the device, so this is device
        # prep + kernels, and warm minus it is host time
        labels_dev = torch.from_numpy(labels).to(DEVICE)
        warm_dev = gpu_ms(torch, lambda: GEEEmbedder(
            num_classes=k).fit_transform(prepared[g], labels_dev), reps=10,
            sleep_cycles=100_000_000)
        # what one cold fit adds at its peak to what this run holds already
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        GEEEmbedder(num_classes=k).fit_transform(edges, labels)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        cold = host_ms(torch, lambda: GEEEmbedder(num_classes=k).fit_transform(
            edges, labels), reps=3)
        pack = host_ms(torch, lambda: edges_to_bucketed_ell(edges), reps=3)
        tg["fit_transform_warm_ms"] = warm
        tg["fit_transform_warm_device_ms"] = warm_dev
        tg["warm_fit_device_ms_by_pass"] = prep_passes(
            torch, gee_fused, lambda: GEEEmbedder(num_classes=k).fit_transform(
                prepared[g], labels_dev))
        tg["fit_transform_cold_ms"] = cold
        tg["host_packing_ms"] = pack
        tg["cold_fit_peak_bytes"] = peak
        timing[g] = tg
        say(f"phase 6 timing {g} (default options, {card}): "
            + "; ".join(f"{n} {tg[n]['ms']:.4f} ms over "
                        f"{tg[n]['launches_per_fit']} launches "
                        f"(bound {tg[n]['bound_ms']:.4f}, plain "
                        f"{tg[n]['plain_ms']:.4f}"
                        + (f", plane kernel {tg[n]['plane_ms']:.4f} (bound "
                           f"{tg[n]['plane_bound_ms']:.4f})"
                           if "plane_ms" in tg[n] else "")
                        + (f", {LIBRARY[n]} {tg[n]['library_ms']:.4f}"
                           if tg[n]["library_ms"] is not None else "") + ")"
                        for n in kernels)
            + "; per bucket, L2 flushed, ms (x bound): " + "; ".join(
                f"{n} " + " ".join(
                    f"[{b['R']}/{b['R_pad']}, {b['D']}] {b['ms']:.4f} "
                    f"({b['ms'] / b['bound_ms']:.1f})" for b in
                    tg[n]["buckets"]["rows"])
                + f", kernels a launch {tg[n]['buckets']['kernels_per_launch']}"
                + f", an empty launch {tg[n]['buckets']['empty_launch_ms']:.4f}"
                for n in ("gee_spmm_fused", "gee_spmm"))
            + f"; fit_transform warm {warm:.2f} ms (device {warm_dev:.2f} "
              f"ms; by pass " + ", ".join(
                  f"{n} {t:.4f}" for n, t in
                  tg["warm_fit_device_ms_by_pass"].items()) + "), "
              f"cold {cold:.1f} ms, "
              f"host packing {pack:.1f} ms, peak memory of a cold fit "
              f"{peak / 2**20:.1f} MiB")
    report["timing"] = timing

    # -- phase 6b: the gathered launch against the plane launch ---------------
    report["gathered"] = gathered_phase(torch, card, graphs, prepared, flush)

    # -- phase 8: the retrieval path ------------------------------------------
    from repro_torch.launch.gee_search import recall_at_k
    from repro_torch.search.service import GEEQueryService

    class fused_env:
        """``REPRO_GEE_FUSED`` set for the block, then restored."""

        def __init__(self, flag):
            self.flag = flag

        def __enter__(self):
            self.prev = os.environ.get(ENV_FUSED)
            os.environ[ENV_FUSED] = self.flag

        def __exit__(self, *exc):
            if self.prev is None:
                del os.environ[ENV_FUSED]
            else:
                os.environ[ENV_FUSED] = self.prev

    def replay(index, rows, nprobe=None):
        """Vertex-id queries through the service, ``FLUSH`` a flush."""
        svc = GEEQueryService(index, None, flush_every=FLUSH, nprobe=nprobe,
                              default_k=TOP_K)
        t0 = time.perf_counter()
        tickets = [svc.submit_rows(rows[lo:lo + FLUSH])
                   for lo in range(0, rows.size, FLUSH)]
        svc.flush()
        wall = time.perf_counter() - t0
        flush_ms = list(svc.stats["flush_ms"])
        svc.close()
        return (np.concatenate([t.ids for t in tickets]),
                np.concatenate([t.scores for t in tickets]), wall, flush_ms)

    def brute(index, zq):
        """Brute-force search in batches of ``FLUSH`` queries."""
        got = [index.search(zq[lo:lo + FLUSH], TOP_K, brute_force=True)
               for lo in range(0, zq.shape[0], FLUSH)]
        return (torch.cat([i for i, _ in got]).cpu().numpy(),
                torch.cat([s for _, s in got]).cpu().numpy())

    def hold_true_scores(index, zq, ids, scores, metric, scale):
        """Every returned id's plain score equals its reported score."""
        t_ids = torch.from_numpy(ids).to(DEVICE)
        cand = index.z[t_ids.clamp(min=0).long()]
        want = ref_mod.gathered_scores_ref(zq, cand, (t_ids >= 0).float(),
                                           metric)
        return score_err(torch, torch.from_numpy(scores).to(DEVICE), want,
                         scale)


    def retrieval_graph(g, seed):
        """A default fit of ``g`` and ``N_QUERIES`` query rows."""
        _, labels, k = graphs[g]
        emb = GEEEmbedder(num_classes=k).fit(prepared[g], labels)
        emb.transform()
        rows = np.random.default_rng(seed).integers(
            0, prepared[g].num_nodes, N_QUERIES)
        return emb, rows

    # Capture the retrieval kernels' exact inputs on the main path (before
    # the counts are reset, so these launches do not count).
    rcaptured = {}
    for g in graphs:
        emb, rows = retrieval_graph(g, 1)
        for metric in ("l2", "cosine"):
            with Recorder(index_mod, "pairwise_scores") as rec_b:
                index = emb.build_index(metric=metric)
            zq = index.z[torch.from_numpy(rows[:2 * FLUSH]).to(DEVICE)]
            with fused_env("1"), \
                    Recorder(index_mod, "pairwise_scores", keep=2) as rec_p, \
                    Recorder(index_mod, "scored_topk_gathered",
                             keep=2) as rec_g:
                replay(index, rows[:2 * FLUSH])
            with fused_env("0"), \
                    Recorder(topk_mod, "gathered_scores", keep=2) as rec_s:
                replay(index, rows[:2 * FLUSH])
            with fused_env("1"), \
                    Recorder(index_mod, "scored_topk", keep=2) as rec_t:
                brute(index, zq)
            rcaptured[(g, metric)] = {
                "pairwise_scores": rec_b.calls + rec_p.calls,
                "gathered_scores": rec_s.calls,
                "scored_topk": rec_t.calls,
                "scored_topk_gathered": rec_g.calls}
    torch.cuda.synchronize()

    for fn in list(kernels.values()) + list(rkernels.values()):
        fn.launches = 0
    retrieval = {}
    t0 = time.perf_counter()
    for g in graphs:
        emb, rows = retrieval_graph(g, 2)
        for metric in ("l2", "cosine"):
            tb = time.perf_counter()
            index = emb.build_index(metric=metric)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - tb) * 1e3
            with fused_env("1"):
                ids_f, s_f, wall, flush_ms = replay(index, rows)
            with fused_env("0"):
                ids_s, s_s, wall_s, flush_ms_s = replay(index, rows)
            with fused_env("1"):
                ids_full, s_full, _, _ = replay(index, rows,
                                                nprobe=index.num_cells)
            zq = index.z[torch.from_numpy(rows).to(DEVICE)]
            with fused_env("1"):
                ids_bf, s_bf = brute(index, zq)
            with fused_env("0"):
                ids_bs, s_bs = brute(index, zq)
            for ids in (ids_f, ids_s, ids_full, ids_bf, ids_bs):
                if ids.shape != (N_QUERIES, TOP_K):
                    raise AssertionError(f"{g} {metric}: shape {ids.shape}")
            for s in (s_f, s_s, s_full, s_bf, s_bs):
                if not np.isfinite(s).all():
                    raise AssertionError(f"{g} {metric}: non-finite score")
            scale = term_scale(torch, zq, index.z, metric)
            scale_np = scale.cpu().numpy()
            ties = (same_topk(ids_s, s_s, ids_f, s_f, scale_np)  # routes
                    + same_topk(ids_bs, s_bs, ids_bf, s_bf, scale_np)
                    + same_topk(ids_full, s_full, ids_bf, s_bf,
                                scale_np))                     # exact
            score_errs = [hold_true_scores(index, zq, i, s, metric, scale)
                          for i, s in ((ids_f, s_f), (ids_s, s_s),
                                       (ids_full, s_full), (ids_bf, s_bf))]
            recall = recall_at_k(ids_f, s_f, ids_bf, s_bf)
            recall_full = recall_at_k(ids_full, s_full, ids_bf, s_bf)
            if recall_full != 1.0:
                raise AssertionError(f"{g} {metric}: full-probe recall "
                                     f"{recall_full}")
            lat = np.asarray(flush_ms)
            retrieval[f"{g} {metric}"] = {
                "num_cells": index.num_cells, "nprobe": index.nprobe,
                "bucket_capacity": index.bucket_capacity,
                "padding_fraction": index.padding_fraction(),
                "build_ms": build_ms,
                "recall_at_10": recall, "recall_at_10_full_probe":
                recall_full, "qps_fused": N_QUERIES / wall,
                "qps_staged": N_QUERIES / wall_s,
                "flush_ms_p50": float(np.percentile(lat, 50)),
                "flush_ms_p95": float(np.percentile(lat, 95)),
                "flush_ms_p50_staged": float(np.percentile(flush_ms_s, 50)),
                "score_err": worst(score_errs),
                # the size of the scores the tolerance separates: slots 1-9
                # of brute force (slot 0 is the query vertex itself)
                "top10_score_median": float(np.median(s_bf[:, 1:])),
                "slot10_score_median": float(np.median(s_bf[:, -1])),
                "tolerance_median": float(np.median(TERM_ATOL * scale_np)),
                "near_tie_groups": len(ties),
                "near_tie_group_max": max(ties, default=0)}
    torch.cuda.synchronize()
    phase8_s = time.perf_counter() - t0
    rlaunches = {name: fn.launches for name, fn in rkernels.items()}
    fit_launches = {name: fn.launches for name, fn in kernels.items()}

    # the captured calls against the plain versions
    plain_r = {
        "pairwise_scores": lambda q, x, v=None, metric="l2":
            ref_mod.pairwise_scores_ref(q, x, v, metric),
        "gathered_scores": lambda q, c, m, metric="l2":
            ref_mod.gathered_scores_ref(q, c, m, metric),
        "scored_topk": lambda q, x, v, k, metric="l2", fused=None:
            ref_mod.scored_topk_ref(q, x, v, k, metric),
        "scored_topk_gathered":
            lambda q, c, m, i, k, metric="l2", fused=None:
            ref_mod.scored_topk_gathered_ref(q, c, m, i, k, metric)}
    n_real = 0
    for calls_by_name in rcaptured.values():
        for name, calls in calls_by_name.items():
            for a, kw in calls:
                got = rkernels[name](*a, **kw)
                want = plain_r[name](*a, **kw)
                sc = term_scale(torch, a[0], a[1], kw["metric"])
                if name == "scored_topk":
                    full = ref_mod.pairwise_scores_ref(a[0], a[1], a[2],
                                                       kw["metric"])
                    errs[name].append(check_topk(torch, got, want, full, sc))
                elif name == "scored_topk_gathered":
                    full = ref_mod.gathered_scores_ref(a[0], a[1], a[2],
                                                       kw["metric"])
                    errs[name].append(check_topk(torch, got, want, full, sc,
                                                 a[3]))
                else:
                    errs[name].append(score_err(torch, got, want, sc))
                n_real += 1
    torch.cuda.synchronize()
    say(f"phase 8 retrieval path, {N_QUERIES} vertex-id queries in flushes "
        f"of {FLUSH}, top {TOP_K}, fused and staged, brute force and full "
        f"probe, on both graphs x (l2, cosine) in {phase8_s:.1f} s: "
        + "; ".join(f"{key} recall@10 {r['recall_at_10']:.4f} at nprobe "
                    f"{r['nprobe']} of {r['num_cells']} (full probe "
                    f"{r['recall_at_10_full_probe']:.1f}; top-10 scores "
                    f"median {r['top10_score_median']:.3g}, tolerance "
                    f"{r['tolerance_median']:.3g}, "
                    f"{r['near_tie_groups']} near-tie groups of up to "
                    f"{r['near_tie_group_max']})"
                    for key, r in retrieval.items())
        + f"; fused == staged, full probe == brute force; launches "
          f"{rlaunches} (and the fits' {fit_launches}); {n_real} captured "
          f"launches "
          f"vs plain: " + ", ".join(f"{k} {fmt_err(errs[k])}"
                                     for k in rkernels))
    report["retrieval"] = retrieval
    report["retrieval_launches"] = rlaunches

    # -- phase 9: retrieval timing --------------------------------------------
    def work(name, a, kw):
        """(bytes, operations) the call must move and do on this run's
        data: each input read once, each output written once; a masked
        gathered slot reads no candidate, and the gathered top-k reads only
        its winners' ids.  A score is 3 multiply-adds per
        class plus ~4 operations."""
        q = a[0]
        nq, kd = q.shape
        if name in ("pairwise_scores", "scored_topk"):
            m = a[1].shape[0]
            valid = a[2] if len(a) > 2 else kw.get("valid")
            nbytes = 4 * (nq * kd + m * kd) + (
                0 if valid is None else valid.element_size() * m)
            live = nq * m
        else:
            m = a[1].shape[1]
            live = int((a[2] > 0).sum())
            nbytes = 4 * (live * kd + nq * kd + nq * m)
            if name == "scored_topk_gathered":
                nbytes += 4 * nq * min(a[4], m)        # the winners' ids
        if name in ("pairwise_scores", "gathered_scores"):
            nbytes += 4 * nq * m
        else:
            nbytes += 8 * nq * (a[3] if name == "scored_topk" else a[4])
        return nbytes, live * (6 * kd + 4)

    # the floor of a launch timed this way: one launch of an empty kernel
    rtiming = {"empty_launch_ms": gpu_ms(torch, lambda: torch.cuda._sleep(0))}
    for g in graphs:
        cap = rcaptured[(g, "l2")]
        tg = {}
        brute = cap["scored_topk"][0][0]
        for name, calls in cap.items():
            # pairwise_scores: the index build, a flush's probe, and the
            # score pass of the staged brute force
            picks = {"pairwise_scores": {
                "build": calls[0], "probe": calls[1],
                "staged": (brute[:3], {"metric": "l2"})}}.get(
                    name, {"flush": calls[0]})
            for shape_name, (a, kw) in picks.items():
                nbytes, nops = work(name, a, kw)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = nops / FP32_OPS_PER_S * 1e3
                entry = {
                    "shape": [list(t.shape) for t in a
                              if isinstance(t, torch.Tensor)],
                    "ms": gpu_ms(torch, lambda: rkernels[name](*a, **kw)),
                    "plain_ms": gpu_ms(torch, lambda: plain_r[name](*a, **kw),
                                       reps=10),
                    "library_ms": None, "bytes": nbytes, "operations": nops,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations"}
                if name == "pairwise_scores":
                    # one call launches exactly one kernel: no cast of the
                    # index's bool mask, no copy
                    (entry["kernels_per_call"], entry["kernel_names"],
                     entry["profiler_sessions"]) = kernels_per_call(
                        torch, lambda: rkernels[name](*a, **kw))
                    if (entry["kernels_per_call"] != 1
                            or not all("pairwise_" in k
                                       for k in entry["kernel_names"])):
                        raise AssertionError(
                            f"pairwise_scores {shape_name}: one call "
                            f"launched {entry['kernels_per_call']} kernels "
                            f"({entry['kernel_names']})")
                if name == "scored_topk":
                    entry.update(chunk_sweep(torch, topk_mod, name, a, kw))
                    entry["staged_ms"] = gpu_ms(torch, lambda: topk_mod.
                                                masked_topk(topk_mod.
                                                pairwise_scores(a[0], a[1],
                                                a[2], metric="l2"), None,
                                                a[3]))
                elif name == "scored_topk_gathered":
                    entry["staged_ms"] = gpu_ms(torch, lambda: topk_mod.
                                                masked_topk(topk_mod.
                                                gathered_scores(a[0], a[1],
                                                a[2], metric="l2"), a[3],
                                                a[4]))
                    entry.update(chunk_sweep(torch, topk_mod, name, a, kw))
                tg[f"{name} {shape_name}"] = entry
        # launches per build and per flush, counted
        emb, rows = retrieval_graph(g, 3)
        counted = {}
        for what, flag in (("build", None), ("flush_fused", "1"),
                           ("flush_staged", "0")):
            if what == "build":
                for fn in rkernels.values():
                    fn.launches = 0
                index = emb.build_index(metric="l2")
            else:
                for fn in rkernels.values():
                    fn.launches = 0
                with fused_env(flag):
                    replay(index, rows[:FLUSH])
            counted[what] = {n: fn.launches for n, fn in rkernels.items()}
        tg["launches"] = counted
        tg["index_build_ms"] = host_ms(
            torch, lambda: emb.build_index(metric="l2"), reps=5)
        # a fused flush's device work (probe, cell sort, gather, top-k):
        # the part of its p50 that the host's clock does not blur
        zq = index.z[torch.from_numpy(rows[:FLUSH]).to(DEVICE)]
        with fused_env("1"):
            tg["flush_device_ms"] = gpu_ms(torch,
                                           lambda: index.search(zq, TOP_K))
        rtiming[g] = tg
        r = retrieval[f"{g} l2"]
        say(f"phase 9 retrieval timing {g} (l2, {card}): "
            + "; ".join(f"{n} {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} "
                        f"by {e['bound_by']}, plain {e['plain_ms']:.4f}"
                        + (f", staged {e['staged_ms']:.4f}"
                           if "staged_ms" in e else "")
                        + (f", {e['kernels_per_call']:g} kernel a call"
                           if "kernels_per_call" in e else "")
                        + (f", {e['chunks']} chunks; ms by chunk count "
                           + " ".join(f"{c}:{t:.4f}" for c, t in
                                      e["chunk_sweep_ms"].items())
                           + "; ms by k " + " ".join(
                               f"{c}:{t:.4f}" for c, t in
                               e["ms_by_k"].items())
                           if "chunk_sweep_ms" in e else "") + ")"
                        for n, e in tg.items()
                        if isinstance(e, dict) and "ms" in e)
            + f"; an empty launch {rtiming['empty_launch_ms']:.4f} ms"
            + f"; index build {tg['index_build_ms']:.2f} ms; replay "
              f"{r['qps_fused']:,.0f} QPS fused ({r['qps_staged']:,.0f} "
              f"staged), flush p50 {r['flush_ms_p50']:.3f} ms p95 "
              f"{r['flush_ms_p95']:.3f} ms, device time of a fused flush "
              f"{tg['flush_device_ms']:.4f} ms; launches {counted}")
    report["retrieval_timing"] = rtiming

    # -- phase 10: streaming ---------------------------------------------------
    all_kernels = {**kernels, **rkernels}
    from repro_torch.graph.datasets import DatasetSpec

    # phases 10-12 share one directory of edge files, removed at the end
    scratch = tempfile.TemporaryDirectory()
    try:
        stream = streaming_phase(torch, card, all_kernels, replay,
                                 TABLE2["cl-100k-1d8-l5"],
                                 DatasetSpec(*SCALE_SPEC), scratch.name)
        stream_launches = stream["launches"]
        report["streaming"] = stream

        # -- phase 11: serving under deltas -----------------------------------
        serving = serving_phase(torch, card, all_kernels)
        serving_launches = serving["launches"]
        serving_checks = serving["launches_checks"]
        for name, e in serving["kernel_errs"].items():
            errs[name].extend(e)
        report["serving"] = serving

        # -- phase 12: multi-device folds -------------------------------------
        sharded = sharded_phase(torch, card, all_kernels, graphs, prepared,
                                scratch.name, stream)
        for name, e in sharded["kernel_errs"].items():
            errs[name].extend(e)
        report["sharded"] = sharded
    finally:
        scratch.cleanup()

    # -- phase 13: the autotune registry ---------------------------------------
    report["autotune"] = autotune_phase(torch, card, kernels, rkernels,
                                        captured, rcaptured, fit, graphs,
                                        gcaptured)

    del captured, gcaptured, rcaptured, prepared
    # -- phase 19 (b), started here: the dry-run beside phases 14-18 ----------
    dry_tmp = tempfile.TemporaryDirectory()
    dry = start_dryrun(dry_tmp.name)
    try:
        report["dryrun"] = late_phases(torch, card, report, dry)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        dry_tmp.cleanup()


    # -- phase 7: the kernels line -------------------------------------------
    # Slice 1's kernels: ms per fit of cl-100k-1d8-l5.  The retrieval
    # kernels: ms per launch at cl-100k-1d8-l5's l2 shapes (pairwise_scores
    # at the index build, the others at a flush).  ``launches`` is the
    # count of the kernel's own main path (phases 4-5 or 8), where the
    # contraction kernels' include ``launches_gathered``, their launches
    # through the gathered source by the driver that replaced them; their
    # ``ms``, bound, plain time and errors are of those gathered launches
    # (phases 3b, 6), and ``plane_ms`` / ``plane_bound_ms`` the kernel's on
    # the planes they stand for;
    # ``launches_streaming`` is phase 10's and ``launches_serving`` phase
    # 11's serving path, each counted apart; ``launches_serving_checks``
    # is phase 11's own checks (brute force, full probe, Z read back);
    # ``launches_sharded`` phase 12's sharded calls (its P = 4 replay is
    # counted apart, in the report).
    line = {"kernels": []}
    rt = rtiming["cl-100k-1d8-l5"]
    for name in list(kernels) + list(rkernels):
        if name in kernels:
            t, source, n = (timing["cl-100k-1d8-l5"][name], KERNEL_SOURCE,
                            launches[name])
        else:
            t = rt[f"{name} build" if name == "pairwise_scores"
                   else f"{name} flush"]
            source, n = TOPK_SOURCE, rlaunches[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "launches": n,
            "launches_gathered": gathered.get(name, 0),
            "launches_streaming": stream_launches[name],
            "launches_serving": serving_launches[name],
            "launches_serving_checks": serving_checks[name],
            "launches_sharded": sharded["launches"][name],
            "max_abs_err": worst(errs[name])[0],
            "max_rel_err": worst(errs[name])[1], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "plane_ms": t.get("plane_ms"),
            "plane_bound_ms": t.get("plane_bound_ms")})
    report["kernels"] = line["kernels"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    missing = [k["name"] for k in line["kernels"] if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
