#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line of numbers each; any failed check raises and the exit code
is non-zero:

  1. device  — the CUDA device's name and nvidia-smi's name/power limit.
  2. build   — compiles the crms_grid, flash_attention and ssd CUDA kernels
               from the checkout's sources, all nvcc runs at once; ptxas'
               registers and spills, and each flash instantiation's (bf16 and
               f32, hd 32/64/128/256) and each ssd_chunk instantiation's (P,
               N) registers and spills on a line of its own (a spill fails
               the run).
  3. kernel  — crms_grid against its plain-torch version on numpy-seeded
               inputs at the main path's shape (72, 64) in per-app mode and a
               search-sized (20000, 64) in sum mode: rtol 1e-5 on lanes with
               rho <= 0.99, 1e-4 on all stable lanes (float32 with CUDA's
               expf/logf against torch's; near rho -> 1 the Erlang tail
               amplifies last-place differences), sentinel lanes > 1e6 in both.
               Times (CUDA events) of both, the kernel's graph-timed device
               time (graph_ms, below) and the lower bound from the shapes;
               the graph-replayed launch floor (a one-element kernel).
  4. main    — allocate("crms", ...) on the card for the paper's four apps
               (fitted) and make_tenant_mix(M), M in {8, 16, 32, 64}, and
               allocate("crms_p95", ...) at M=8 without and with a rollout
               budget (2 rollouts of 20 s), against the JAX reference's
               results in tests/data/torch_port_golden.json: identical counts,
               utility within rtol 1e-6, equal refinement / accepted-move /
               P1-call / rollout-call / accepted-rollout counters, and at least
               one kernel launch per refinement iteration.
  5. vector  — crms_priority (a per-app alpha vector) at M=8, which evaluates
               the grid with the float64 oracle, so it launches no kernel.
  6. flash   — the flash-attention kernel (bf16: wgmma with TMA-fed K/V;
               f32: 3xTF32 mma.sync with cp.async-fed K/V; both with the MQA
               heads packed per tile) against its plain version on
               numpy-seeded inputs: the serving path's shape (B 4, S 512, KV
               1, G 8, hd 256, causal) in bf16 and f32, (1, 256, 4, 1, 128)
               causal and the padding case (1, Sq 70, Skv 130, 2, 2, 32)
               non-causal in both, (2, 192, 2, 3, 64) causal (one head a
               tile) in f32; atol/rtol 2e-5 in f32,
               3e-2 in bf16 (the reference's bar), and in bf16 each element
               within one ulp of the plain version's with fewer than 1 %
               differing. At the path's shape: the kernel's, the plain
               version's and scaled_dot_product_attention's times, each as
               ms (CUDA events around back-to-back calls from Python, as in
               earlier runs) and as graph_ms / plain_graph_ms /
               library_graph_ms (device time: 20 calls captured in one CUDA
               graph, replayed between CUDA events; where a launch's device
               work is shorter than the host's cost per call, ms measures
               the host and graph_ms the card); the lower bound from the
               shapes. The new paths' shapes (B, Sq, Skv, KV, G, hd) in bf16
               and f32 under the same bars: moonshot-v1-16b-a3b's prefill (4,
               512, 512, 16, 1, 128) causal, and seamless-m4t-large-v2's
               encoder (4, 128, 128, 16, 1, 64), decoder self-attention (4,
               512, 512, 16, 1, 64) causal, cross-attention prefill (4, 512,
               128, 16, 1, 64) and cross-attention decode (4, 1, 128, 16, 1,
               64), all but the self-attention not causal; bf16 timed as the
               path's shape. The kernels line holds the f32 route's numbers
               under the flash entry's "float32", moonshot's shape under
               "moonshot" and seamless's under "seamless", each with the
               launches of its path.
  7. ssd     — the SSD chunk kernel (C Bᵀ once per head group, products in
               3xTF32 mma.sync) against its plain version on numpy-seeded
               inputs: the serving path's shape (B 4, S 512,
               H 24, P 64, N 128, chunk 256), the reference's test shapes
               (1, 128, 2, 32, 16, 64) and (2, 256, 4, 64, 32, 128), and the
               ragged chunk (2, 8, 4, 16, 16, 256); y_diag and the states
               within atol 2e-5 / rtol 2e-4 (the reference's bar), the cumsum
               bit for bit, and ops.ssd_chunks through the kernel against its
               plain route within the same bar; the log line names the head
               group and the product route. At the path's shape: the
               kernel's and the plain version's times (CUDA events), the
               kernel's graph_ms and the lower bound from the shapes.
  8. serve   — the port's Engine on the card (float32, attn_backend "auto")
               for reduced gemma-2b (hd 32 and 256), minitron-4b,
               codeqwen1.5-7b, mamba2-130m, moonshot-v1-16b-a3b,
               llama4-scout-17b-a16e and jamba-1.5-large-398b (flash, SSD and
               MoE in one model) against the JAX Engine's results in
               tests/data/torch_serve_golden.json: tokens equal up to the
               first position where the reference's top-1/top-2 margin is
               <= 1e-3, prefill logits within 1e-4 relative to max |logit|,
               one flash launch per self- and cross-attention layer and one
               ssd launch per Mamba layer per prefill.
  9. gemma   — gemma-2b at full width and depth (random bf16 weights from a
               seeded generator, bf16 compute): 8 requests of 512 tokens,
               32 new tokens each, 4 slots (two prefills). 18 kernel launches
               per prefill; prefill logits through the kernel within 3e-2
               (relative to max |logit|) of the plain version's; prefill and
               decode-step times, tokens/s, peak memory, the kernel's share of
               a prefill from its ms (as earlier runs) and from its graph_ms.
 10. mamba   — mamba2-130m at full width and depth, as phase 9: 24 ssd
               launches per prefill (48 in the run), the reference's realized
               parameter count, prefill logits through the kernel within 3e-2
               of the plain version's, the same timings.
 11. moe     — moonshot-v1-16b-a3b at full width and depth (28.06e9 random
               bf16 weights, the router float32, from a seeded generator on
               the card; gemma-2b and mamba2-130m freed first): one group of 4
               requests of 512 tokens, 16 new tokens each, 4 slots, a
               576-token cache; 48 flash launches; prefill logits through the
               kernel within 3e-2 of the plain version's with the routing
               held equal (the plain route takes the kernel route's expert
               ids), their top-1 agreement; the two routes free: their logits'
               distance, top-1 agreement and the share of (layer, token, slot)
               expert ids that differ (a one-ulp difference before a router
               flips near-ties, and each flip changes every later layer's
               input); prefill and decode-step times, tokens/s, peak memory,
               init and phase wall time.
 12. audio   — seamless-m4t-large-v2 at full width and depth through the
               serving steps: frames (4, 128, 1024) from the seed, the
               encoder's memory computed once (24 flash launches); the prefill
               of 4 x 512 tokens from frames (24 + 24 + 24 launches) equal bit
               for bit to the prefill from the memory (24 + 24); kernel
               against plain within 3e-2; the prompt replayed through decode
               steps, then 16 greedy steps, with the memory (24 cross-attention
               launches a step); the same timings.
               Phases 8-12 run under torch.inference_mode() (the parameters
               are trainable; serving builds no graph).
 13. train-kernels — flash attention through its autograd.Function on the
               card (the forward launches the kernel, counted) with dq, dk, dv
               from the plain backward held against autograd through the naive
               oracle: the training shape (2, 256, 256, 1, 8, 256) causal and
               tests/test_kernels.py's shapes, f32 (atol 5e-5 / rtol 5e-4) and
               bf16 (3e-2). At the training shape in bf16: the kernel's
               forward, the plain backward and scaled_dot_product_attention's
               forward + backward, as ms and graph_ms. ops.ssd_chunks'
               gradients through the kernel route against the plain route at
               (8, 512, 24, 64, 128, 256), within 2e-4 of each input's max
               |grad|; the kernel's forward (ms and graph_ms) and the plain
               backward (ms: it cannot be captured in a CUDA graph) timed.
 14. train-reduced — reduced gemma-2b, mamba2-130m, moonshot-v1-16b-a3b,
               jamba-1.5-large-398b and seamless-m4t-large-v2 trained for 6
               steps on the card in float32 through the kernels (AdamW, two
               microbatches) against the JAX reference's losses and gradient
               norms in tests/data/torch_train_golden.json: loss rtol 1e-4,
               grad_norm rtol 1e-3, the kernel launches the steps imply (one
               per attention / Mamba layer per microbatch, twice with the
               recompute); the Trainer's crash-and-resume on reduced gemma-2b
               against an uninterrupted run (parameters within 1e-6).
 15. gemma-train — gemma-2b at full width and depth: float32 parameters and
               AdamW (for_config), bf16 compute, B 8 x S 256 in 4 microbatches,
               6 steps on SyntheticTokens: losses finite and the last below
               the first, 144 flash launches a step (18 layers x 4
               microbatches x 2); one microbatch through the kernels against
               the plain forwards (loss within 1e-2 relative, global relative
               L2 gradient gap within 3e-2), with the same gap in float32
               compute (the kernel's part) and the plain route's bf16 gradients
               against its float32 ones (the bf16 backward's rounding) beside
               it; step times, tokens/s, peak memory, and from a profiled 7th
               step the device busy time and the flash forward's and
               backward's share of it.
 16. mamba-train — mamba2-130m at full width, B 8 x S 512 (two chunks of
               256) in one microbatch, the same checks and numbers with 48 ssd
               launches a step.
 17. simulate — the simulation at make_tenant_mix(64), the phase-4
               allocation: (1) one rollout of the incumbent and its 2M ±1
               moves (B 129, 40 s, 8 s warmup, seed 0) on the card against
               the host loop (backend "numpy") on the same draws: waits on
               valid customer slots bit for bit (else rtol 1e-12, the gap
               printed), mean/p95/pooled within rtol 1e-12; K, Kp, n_pad,
               cold and cached ms, device kernels (torch.profiler), the waits'
               bytes. (2) allocate("crms_p95") with 4 rollouts of 40 s against
               the golden file as phase 4 (rollout counters too), except that
               the counts may differ by a permutation inside a class of apps
               identical but for their names (the mix tiles its four apps
               with a factor cycle of three tiles, so nearly every move ties
               exactly with its twins' in the model and the last bits break
               the tie either way); crms_grid launches counted from zero, the
               rollouts' share of the solve's wall clock. (3) simulate_allocation (engine "vector", 2000 s,
               200 s warmup): finite mean and p95 for every served app; wall
               clock, customers/s, scan steps, and launches as the steps times
               the kernels per step of a profiled 40 s run. (4) the event
               engine (host) against the vector engine (card) over 400 s, and at
               make_tenant_mix(16) with MMPP arrivals, a cold-start ramp
               superseded mid-ramp and a scripted crash and repair: per
               customer, arrivals within rtol/atol 1e-9, responses within
               rtol 1e-7 / atol 1e-9; both wall clocks.
 18. scenarios — (runs right after phase 5, before any model is loaded)
               the policies and the scenario layer on the card (device
               None, des backend, vector engine): the six traces of
               tests/data/torch_scenario_golden.json, each built from its
               recorded description (the paper's four apps, alpha 1.4, beta
               0.2): smoke (join, cap resize, leave, drift; crms,
               predictive_crms, crms_priority, drf), azure_trace (from_trace on
               benchmarks/data/azure_synth.csv; crms, robust_crms), mmpp_p95
               (MMPP arrivals, p95 SLO 2 s; crms_p95 and robust_crms_p95 with
               2 rollouts of 20 s), flash_crowd (t_cold 2 s; crms,
               crms_lifecycle, robust_crms_lifecycle), failures (MTBF 60 s,
               a scripted crash and repair; crms, crms_failover, crms_shed)
               and the crunch (caps (4, 1.2): crms_failover, crms_shed, crms
               as single allocations). Each document valid (also compact) and
               equal to the reference's (its vector engine on the CPU) field
               by field: integers, booleans, strings and lists exactly, floats
               within rtol 1e-6, the wall clocks left out. Per trace its wall clock, solves, re-plans and each
               policy's replan_time_s_mean; crms_grid launches counted from
               zero at least the phase's re-plans through CRMS (all but
               drf's); the phase within 180 s.
 19. baselines — (right after phase 18) the search baselines and the fleet
               placement layer on the card (device None), against
               tests/data/torch_baselines_golden.json and
               tests/data/torch_fleet_golden.json (the reference on the CPU):
               (a) the paper's Figs. 11-14 comparison (the four apps, ground-
               truth κ, λ (8, 7, 10, 15), caps (30, 10)): crms; random_search
               (20000 samples), gpbo and tpebo at their defaults, each at
               seeds 0, 1, 2; drf; snfc1/2 at (120, 40) — counts exact,
               floats rtol 1e-6, flags equal; CRMS's latency reduction over
               every search baseline >= 14 %; each policy's wall clock and
               random search's peak device memory. (b) random_search at
               make_tenant_mix(16), 20000 samples: one float64 batch of
               20000 x 16 lanes at Erlang width 512, its wall clock and peak
               memory. (c) make_fleet(1000, 16): FleetPlanner.plan() and one
               incremental replan (the benchmark's drift on 4 apps and one
               migration) — assignment and counts exact, node utilities and
               64 sampled nodes' floats rtol 1e-6, counters equal; 8 sampled
               nodes against standalone p1_solve_batch within 1e-6; the
               untouched nodes byte-identical; wall clocks and one full row
               solve's device kernels (torch.profiler). (d) the 16 x 8
               migration scenario (4 epochs, the vector engine on the card)
               equal to the reference's document but for the wall clocks.
               The phase within 120 s.
 20. fleet-binding — (right after phase 19) the TPU-fleet binding on the
               card (device None) against
               tests/data/torch_fleet_binding_golden.json (the reference on
               the CPU): (a) default_workloads() and the profile data equal
               the reference's bit for bit; FleetManager(n_chips=256)'s fit of
               each of the ten architectures with an rmse at most 2e-3
               relative above the reference's and its Eq. (1) surface within
               5e-2 of the reference's on a 64 x 64 grid of the box (c in [1,
               256], m in [r_min, r_max]); (b) the plan on the reference's κ
               (put in after construction, the quasi-dynamic cache reset):
               the port's Ws and utility at the reference's quotas within
               their rounding envelope (Eq. (1)'s 1 - exp(-κ₂c) cancels at
               κ₂c ~ 1e-14, where the packages' exp differ by an ulp:
               check_fleet_eval); counts, flags and counters (refinement
               iterations, accepted moves, P1 calls, masked rows) equal,
               utility within rtol 2e-5, quotas and the replica groups'
               chips and HBM within 5e-2, each Ws within that or its
               envelope, slots within 5 % + 1 (check_fleet_record), at
               least one crms_grid launch per refinement iteration; (c) the
               plan on the
               card's own fit: the reference's counts, utility within rtol
               1e-4, within the pod, one group per container, every group >= 1
               slot; (d) drift x1.03 then x1.6: a re-plan only at x1.6, held
               as in (b); (e) launch.serve --plan and
               examples_torch/serve_multitenant.py: their plans equal (c)'s,
               both reduced tenants finish every request; (f)
               benchmarks_torch/fleet_tpu.py's comparison (crms, random_search
               with 20000 samples, tpebo) on the reference's κ: records held
               as in (b), CRMS's mean latency <= both baselines'. Wall clocks of the fit,
               the cold plan and the re-plan, crms_grid launches; the phase
               within 90 s.
 21. codeqwen — (after phase 12) codeqwen1.5-7b at full width and depth
               (random bf16 weights from the seeded generator, the card freed
               before and after): one group of 4 requests of 512 tokens, 16
               new tokens each; the realized parameter count equal to the
               config's, 32 flash launches, every request finished with
               in-vocabulary tokens, prefill logits through the kernel within
               3e-2 of the plain version's; prefill and decode-step times,
               tokens/s, peak memory; the phase within 120 s. Phase 6 checks
               the flash kernel at its shape (4, 512, 512, 32, 1, 128) causal
               in bf16 (timed, the kernels line's "codeqwen" entry) and f32.

 22. mesh    — (last) four ranks on the one card (launch.mesh.spawn over
               gloo, NCCL refusing two ranks on one device), each check
               against a single-rank run on the card with the same seeded
               weights: (a) the fleet's row solve on a (4,) "nodes" mesh at
               make_fleet(1000, 16), the cold plan and first re-plan against
               tests/data/torch_fleet_golden.json with phase 19's bars and
               within 1e-9 of phase 19's rows; (b) the MoE block at
               moonshot-v1-16b-a3b's width in float32 with given ids, a2a at
               4 x 512 tokens and replicated at a decode batch of 2 on (2, 2),
               against the local mode at atol 1e-5 / rtol 1e-4 dropless, and
               at cf 1.25 finite with the dropped share; (c) gemma-2b at full
               width and depth: a cache-filling prefill of 4 x 512 in the 2d
               layout (sequence-mode flash, the causal offset), then 16
               teacher-forced decode steps in the serving layout with T of
               the cache split over 'model', logits within 3e-2 of max
               |logit|, 18 flash launches a rank, the kernel at the rank's
               offset against its plain version; (d) mamba2-130m pure data
               parallel, one prefill of 4 x 512, 24 ssd launches a rank; (e)
               moonshot-v1-16b-a3b at full width cut to 4 layers, a prefill
               (a2a) and 8 decode steps at batch 2 (replicated) with the
               single rank's routes. Each part's time, collectives by kind
               with their input bytes (c10d_calls) and peak memory per
               rank; the offset kernel timed at rank 1's shape (2, 256, 512,
               1, 8, 256), offset 256; the phase within 150 s. Rehearse it
               on the CPU at reduced sizes: mesh_references("cpu",
               reduced=True), then run_mesh(refs, golden, "cpu",
               reduced=True).
 23. mesh-train — (last) the sharded train step on four ranks sharing the
               card (gloo, a (2, 2) ("data", "model") mesh, the 2d layout):
               (a) the five reduced entries of
               tests/data/torch_train_golden.json trained for 6 steps in
               float32 through the kernels, the MoE routes held (each rank
               replays its rows' ids): loss rtol 1e-4, grad_norm rtol 1e-3,
               and per rank the flash / ssd launches the steps imply (one per
               attention / Mamba layer per microbatch, twice with the
               recompute); (b) gemma-2b at full width cut to 4 of its 18
               layers (MESH_TRAIN_LAYERS: gloo's latency differs between
               hosts, and before a step held the weights it moves the phase
               took 120-190 s at 4 layers and 143-152 s at 6; since, 52 s
               at 4 in the script, 77-86 s alone on a slower host),
               float32 weights and
               AdamW, B 4 x S 256 in 2 microbatches: one float32-compute step
               against a single-rank step on the card with the same seeded
               weights and batch (loss rtol 1e-4, grad_norm rtol 1e-3, each
               leaf's gradient by digests: its L2 norm and its dot with a
               seeded normal tensor, summed over the shards, within 1e-3 of
               the single rank's norm), then two bf16-compute steps on the
               same batch with finite, falling losses; (c) mamba2-130m at
               full width and depth, pure data parallel, B 8 x S 512: one
               float32-compute step against the single rank's, 24 x 2 ssd
               launches a rank; (d) compress_allreduce_pod on a (2, 2) ("pod",
               "data") mesh, pods holding different gradients, bit for bit
               with a NumPy transcription of the reference's formula over two
               calls (the error state carried). Each rank holds the flash and
               SSD kernels against their plain versions at every shape it
               called them with. Each part's time, collectives by kind with
               their input bytes (c10d_calls) and peak memory per rank; the
               phase within 180 s. Rehearse it on the CPU at reduced sizes:
               refs = mesh_train_references("cpu", reduced=True), then
               run_mesh(refs | {"train_golden": golden}, None, "cpu",
               parts=tuple(TRAIN_PARTS), reduced=True).

The last three lines are nvidia-smi's "name, power.limit", a JSON object with
the kernels' numbers, and {"ok": true, "device": {...}}. Without a CUDA device
the script prints no result and exits non-zero.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PYCACHE = Path(__file__).resolve().parent / "build" / "pycache"
if __name__ == "__main__":
    # The script's own run keeps the bytecode it compiles under build/ and its
    # spawned ranks read it there (PYTHONPYCACHEPREFIX): on a host that keeps
    # no bytecode beside the sources, each rank of phases 22-23 would compile
    # torch anew, at its start and again (about a thousand modules) at a
    # train step's first DTensor and checkpoint calls.
    import os

    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    sys.dont_write_bytecode = False

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
SERVE_GOLDEN = ROOT / "tests" / "data" / "torch_serve_golden.json"
TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_train_golden.json"
SCENARIO_GOLDEN = ROOT / "tests" / "data" / "torch_scenario_golden.json"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/crms_grid.cu"
REPLACES = "src/repro/kernels/crms_grid.py:86"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:78"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd.py:51"
SEED = 0
KW = dict(caps_cpu=30.0, power_span=150.0, alpha=1.4, beta=0.2)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside
# the tensor cores, dense bf16 and TF32 on the tensor cores in operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
PEAK_TF32_OPS_S = 495e12
# float32 operations per lane of the crms_grid function: per term of the
# Erlang head sum (log k!, term, mask, running max, two exps, rescaled sum)
# and once per lane (Eq. (1), mu, rho, Stirling, tail, Ws, utility).
OPS_PER_TERM = 14
OPS_PER_LANE = 40
MAX_N = 128
# float32 operations of the online softmax per attention score: scale,
# running max, subtraction, exp, sum.
SOFTMAX_OPS = 5
# gemma-2b and mamba2-130m at full width and depth, the serving shape that
# phases 9 and 10 check and benchmarks_torch/profile_serve.py profiles:
# requests of PROMPT_LEN tokens in SLOTS slots over a MAX_LEN-token cache.
FULL_ARCH = "gemma-2b"
SSM_ARCH = "mamba2-130m"
N_REQUESTS, PROMPT_LEN, MAX_NEW, SLOTS, MAX_LEN = 8, 512, 32, 4, 576
# moonshot-v1-16b-a3b (phase 11) and seamless-m4t-large-v2 (phase 12) at full
# width: one group of SLOTS requests, MOE_NEW / AUDIO_NEW new tokens each, and
# seamless's AUDIO_FRAMES encoder frames (PROMPT_LEN // enc_frames_ratio)
MOE_ARCH = "moonshot-v1-16b-a3b"
AUDIO_ARCH = "seamless-m4t-large-v2"
MOE_NEW = AUDIO_NEW = 16
AUDIO_FRAMES = 128
# flash shapes (B, Sq, Skv, KV, G, hd, causal) of those paths
MOE_FLASH = (SLOTS, PROMPT_LEN, PROMPT_LEN, 16, 1, 128, True)
# codeqwen1.5-7b at full width (phase 21): one Engine group of SLOTS requests
# of PROMPT_LEN tokens, CODE_NEW new each, as moonshot's phase
CODE_ARCH = "codeqwen1.5-7b"
CODE_NEW = 16
CODE_FLASH = (SLOTS, PROMPT_LEN, PROMPT_LEN, 32, 1, 128, True)
CODE_LIMIT_S = 120.0
# training (phases 13-16): TRAIN_STEPS steps at full width, gemma-2b at
# GEMMA_TRAIN (B, S) in its 4 microbatches (attention (2, 256, 256, 1, 8, 256)
# each), mamba2-130m at MAMBA_TRAIN (two chunks of 256); the flash gradient
# cases besides the training shape: tests/test_kernels.py's (B, Sq, Skv, KV,
# G, hd, causal)
TRAIN_STEPS = 6
GEMMA_TRAIN = (8, 256)
MAMBA_TRAIN = (8, 512)
FLASH_TRAIN = (2, 256, 256, 1, 8, 256, True)
FLASH_GRAD_CASES = [(1, 96, 96, 2, 2, 32, True), (1, 70, 130, 2, 2, 32, False),
                    (2, 192, 192, 2, 3, 64, True), (1, 256, 256, 4, 1, 128, True)]
SSD_TRAIN = (8, 512, 24, 64, 128, 256)
AUDIO_FLASH = {
    "encoder": (SLOTS, AUDIO_FRAMES, AUDIO_FRAMES, 16, 1, 64, False),
    "self": (SLOTS, PROMPT_LEN, PROMPT_LEN, 16, 1, 64, True),
    "cross": (SLOTS, PROMPT_LEN, AUDIO_FRAMES, 16, 1, 64, False),
    "cross_decode": (SLOTS, 1, AUDIO_FRAMES, 16, 1, 64, False),
}


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def grid_inputs(B, M, seed, n_range=(3, 12)):
    """The kernel tests' input distribution; ``n_range`` bounds the counts
    (a wider range keeps whole 64-app rows stable for the sum mode)."""
    rng = np.random.default_rng(seed)
    kappa = np.stack(
        [rng.uniform(20, 120, M), rng.uniform(0.8, 2.5, M), rng.uniform(0.2, 0.5, M)], axis=1
    )
    lam = rng.uniform(4, 12, M)
    xbar = rng.uniform(4, 6, M)
    n = rng.integers(*n_range, (B, M)).astype(float)
    c = rng.uniform(0.5, 3.0, (B, M))
    m = rng.uniform(0.25, 0.5, (B, M))
    return kappa, lam, xbar, n, c, m


def grid_bound_ms(n, M, per_app):
    """Least time for the function on these inputs: each input read once and
    the output written once over the memory rate, against the float32
    operations these counts need (n-1 terms of the head sum per lane) over
    the float32 rate. Returns (ms, "bytes" | "operations")."""
    B = n.shape[0]
    n_bytes = 4 * (5 * M + 3 * B * M + (B * M if per_app else B))
    terms = np.minimum(n, MAX_N) - 1
    n_ops = float(OPS_PER_TERM * terms.sum() + OPS_PER_LANE * n.size)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=20, replays=5):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph after a warm-up on a side stream, the graph replayed
    between two CUDA events, divided by the calls. The host's cost per call
    (Python, ctypes, the wrapper's checks) stays out; the device work and
    the gaps between kernels inside the graph remain."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def launch_floor_ms():
    """graph_ms of a trivial kernel (one float incremented in place): the
    device time that any one launch takes in a replayed CUDA graph, the
    floor of a kernel whose work is a few microseconds or less."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(lambda: x.add_(1.0))


def ptxas_entries(log):
    """ptxas' -v report per compiled entry: {name: {"registers",
    "spill_stores", "spill_loads"}}."""
    entries, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entries[name] = {}
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            entries[name]["spill_stores"] = int(words[words.index("spill") - 2])
            entries[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            entries[name]["registers"] = int(words[words.index("registers") - 1])
    return entries


def check_kernel(B, M, reduce, reps, plain_reps, n_range=(3, 12)):
    """Kernel vs plain version on the card; returns the phase's numbers."""
    from repro_torch.kernels import crms_grid, ref

    arrays = grid_inputs(B, M, SEED + B, n_range)
    dev = [torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in arrays]
    per_app = reduce == "per_app"

    def kernel():
        return crms_grid.crms_grid_launch(*dev, per_app=per_app, **KW)

    def plain():
        return ref.crms_grid_plain(*dev, reduce=reduce, **KW)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    out, want = out.cpu().numpy(), want.cpu().numpy()
    kappa, lam, xbar, n, c, m = arrays
    d = kappa[:, 0] / (1.0 - np.exp(-kappa[:, 1] * c)) + np.exp(kappa[:, 2] / m)
    rho = lam / (n * 1000.0 / (xbar * d))
    rho = rho if per_app else rho.max(axis=1)
    stable = want < 1e8
    if not stable.any():
        raise AssertionError(f"crms_grid ({B},{M}) {reduce}: no stable lane to compare")
    tight = stable & (rho <= 0.99)
    np.testing.assert_allclose(out[tight], want[tight], rtol=1e-5)
    np.testing.assert_allclose(out[stable], want[stable], rtol=1e-4)
    if not (np.all(out[~stable] > 1e6) and np.all(want[~stable] > 1e6)):
        raise AssertionError("crms_grid: a sentinel lane is not > 1e6")
    if not np.all(np.isfinite(out)):
        raise AssertionError("crms_grid: non-finite output")
    ms = cuda_ms(kernel, reps)
    kernel_graph_ms = graph_ms(kernel)
    plain_ms = cuda_ms(plain, plain_reps, warmup=1)
    bound, bound_by = grid_bound_ms(n, M, per_app)
    res = {
        "shape": f"({B},{M})", "reduce": reduce, "stable_lanes": int(stable.sum()),
        "sentinel_lanes": int((~stable).sum()),
        "max_abs_err": float(np.max(np.abs(out[stable] - want[stable]))),
        "max_rel_err": float(np.max(np.abs(out[stable] - want[stable]) / np.abs(want[stable]))),
        "ms": ms, "graph_ms": kernel_graph_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by,
    }
    log("kernel", **res)
    return res


def build_instance(spec, device):
    from repro_torch.core.problem import ServerCaps
    from repro_torch.core.profiler import make_paper_apps, make_tenant_mix

    if spec["builder"] == "make_tenant_mix":
        apps, caps, _ = make_tenant_mix(spec["M"])
        return apps, caps
    apps = make_paper_apps(lam=spec["lam"], fitted=spec["fitted"], device=device)
    return apps, ServerCaps(*spec["caps"])


def twin_classes(apps):
    """Index groups of apps that differ only by name: the model cannot tell
    them apart, so a move on one ties exactly with the same move on another."""
    groups = {}
    for i, a in enumerate(apps):
        groups.setdefault(dataclasses.replace(a, name=""), []).append(i)
    return [g for g in groups.values() if len(g) > 1]


def match_twins(apps, n, r_cpu, ref_n, ref_cpu):
    """(order, ref_order): the app orders that pair the solve's apps with the
    reference's when the counts differ only inside classes of identical apps
    (sorted by count and CPU quota within each class); None if they differ
    elsewhere."""
    order, ref_order = np.arange(len(apps)), np.arange(len(apps))
    for g in twin_classes(apps):
        order[g] = np.asarray(g)[np.lexsort((r_cpu[g], n[g]))]
        ref_order[g] = np.asarray(g)[np.lexsort((ref_cpu[g], ref_n[g]))]
    return (order, ref_order) if np.array_equal(n[order], ref_n[ref_order]) else None


def run_entry(name, golden, device, twins_interchangeable=False):
    """One allocate() on the card against the golden entry; returns the
    kernel launches it made, its refinement iterations and the Allocation.
    ``twins_interchangeable``: counts may differ from the reference's by a
    permutation inside a class of identical apps (``twin_classes``), where
    every refinement choice is an exact tie in the model that the last bits
    of the card's and the reference's arithmetic break either way; the
    quotas are then compared in the matched order."""
    from repro_torch.api import AllocRequest, allocate
    from repro_torch.kernels import crms_grid

    entry = golden["entries"][name]
    apps, caps = build_instance(golden["instances"][entry["instance"]], device)
    before = crms_grid.launches
    t0 = time.perf_counter()
    res = allocate(entry["policy"], AllocRequest(apps, caps, extra=entry["extra"],
                                                 device=device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = crms_grid.launches - before
    alloc, diag = res.allocation, res.diagnostics
    ref_n, ref_cpu, ref_mem = (np.asarray(entry[k]) for k in ("n", "r_cpu", "r_mem"))
    order = ref_order = np.arange(len(apps))
    identical = list(map(int, alloc.n)) == entry["n"]
    matched = None if identical or not twins_interchangeable else match_twins(
        apps, np.asarray(alloc.n), np.asarray(alloc.r_cpu), ref_n, ref_cpu)
    if matched is not None:
        order, ref_order = matched
    elif not identical:
        raise AssertionError(f"{name}: counts {alloc.n.tolist()} != reference {entry['n']}")
    if not abs(alloc.utility - entry["utility"]) <= 1e-6 * abs(entry["utility"]):
        raise AssertionError(f"{name}: utility {alloc.utility!r} != reference {entry['utility']!r}")
    counters = alloc.meta["diagnostics"]  # the rollout counters ride here
    for k in ("refine_iters", "accepted_moves", "p1_calls", "rollout_calls", "rollout_accepted"):
        if counters[k] != entry[k]:
            raise AssertionError(f"{name}: {k} {counters[k]} != reference {entry[k]}")
    if not (res.feasible and res.stable and np.all(np.isfinite(alloc.ws))):
        raise AssertionError(f"{name}: infeasible, unstable or non-finite result")
    quota_err = max(
        float(np.max(np.abs(alloc.r_cpu[order] - ref_cpu[ref_order]) / np.abs(ref_cpu[ref_order]))),
        float(np.max(np.abs(alloc.r_mem[order] - ref_mem[ref_order]) / np.abs(ref_mem[ref_order]))),
    )
    log("main", case=name, policy=entry["policy"], M=len(apps), wall_s=wall,
        counts_identical=identical,
        counts_differ_at=np.flatnonzero(np.asarray(alloc.n) != ref_n).tolist(),
        utility=alloc.utility, utility_rel_err=abs(alloc.utility - entry["utility"])
        / abs(entry["utility"]), quota_rel_err=quota_err, refine_iters=diag.refine_iters,
        accepted_moves=diag.accepted_moves, p1_calls=diag.p1_calls, launches=launches,
        rollout_calls=counters["rollout_calls"], rollout_accepted=counters["rollout_accepted"],
        p1_rescued_rows=diag.p1_rescued_rows, ref_p1_rescued_rows=entry["p1_rescued_rows"],
        p1_masked_rows=diag.p1_masked_rows, ref_p1_masked_rows=entry["p1_masked_rows"])
    return launches, diag.refine_iters, alloc


def flash_bound_ms(B, Sq, Skv, KV, G, hd, causal, dtype, offset=0):
    """Least time for attention on these shapes: q, k, v read once and the
    output written once over the memory rate, against the products' 4·B·H·
    Sq·Skv·hd operations (halved for causal). bf16: at the bf16 tensor-core
    rate. float32: at the tensor cores' TF32 rate over three, the fastest way
    this card keeps float32 accuracy (one TF32 product misses the reference's
    bar), plus the softmax's elementwise work at the float32 rate: per score
    (halved for causal) a scale, a running max, a subtraction, an exp and a
    sum. At (4, 512, 512, 1, 8, 256) causal in float32: 4.29e9 product and
    2.1e7 elementwise operations, 0.0263 ms against 0.0113 ms of bytes.
    With a causal ``offset`` (query row i sees keys <= offset + i) the share
    of live scores is counted exactly. Returns (ms, "bytes" | "operations")."""
    H = KV * G
    share = 0.5 if causal else 1.0
    if causal and offset:
        share = sum(min(Skv, offset + i + 1) for i in range(Sq)) / (Sq * Skv)
    products = 4.0 * B * H * Sq * Skv * hd * share
    elem = torch.finfo(dtype).bits // 8
    n_bytes = elem * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    if dtype == torch.bfloat16:
        t_ops = products / PEAK_BF16_OPS_S
    else:
        elementwise = SOFTMAX_OPS * B * H * Sq * Skv * share
        t_ops = products / (PEAK_TF32_OPS_S / 3) + elementwise / PEAK_F32_OPS_S
    t_bytes = n_bytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa(q, k, v, causal, offset=0):
    """scaled_dot_product_attention on the kernel's inputs, in its (B, H, S,
    hd) layout (k/v expanded over G where ``enable_gqa`` is missing); a
    causal ``offset`` becomes a boolean mask (row i sees keys <= offset + i)."""
    F = torch.nn.functional
    if causal and offset:
        Sq, Skv = q.shape[2], k.shape[2]
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= offset + torch.arange(Sq, device=q.device)[:, None])
        G = q.shape[1] // k.shape[1]
        ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
        return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
    G = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)


def check_bf16_rounding(out, want, what):
    """Kernel and plain version round float32 results that differ only in the
    order of their sums to bf16 (8 significant bits): every element within
    one ulp (2^-7 relative, 2e-5 absolute near 0), and only the rare element
    whose two float32 values straddle a rounding boundary differs at all. A
    wrong load, rounding mode or store fails the second check."""
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=2.0 ** -7, err_msg=what)
    share = float(np.mean(out != want))
    if not share < 0.01:
        raise AssertionError(f"{what} bf16: {share:.2%} of elements differ from the plain "
                             "version's (rounding should differ on < 1%)")
    return share


def check_flash(B, Sq, Skv, KV, G, hd, causal, dtype, timed=False, offset=0):
    """Flash kernel vs its plain version on the card (``offset``: the causal
    diagonal's, a sequence-sharded query block's first row); returns the
    numbers."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + B * Sq + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               .to("cuda", dtype).contiguous()
               for shape in ((B, Sq, KV, G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal, offset=offset)

    def plain():
        return ref.flash_attention_plain(q, k, v, causal, offset=offset)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    out, want = out.float().cpu().numpy(), want.float().cpu().numpy()
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"flash {(B, Sq, Skv, KV, G, hd)}: non-finite output")
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(out, want, atol=tol, rtol=tol)
    res = {"shape": f"({B},{Sq},{Skv},{KV},{G},{hd})", "causal": causal,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(np.max(np.abs(out - want)))}
    if offset:
        res["offset"] = offset
    if dtype == torch.bfloat16:
        res["bf16_differing_share"] = check_bf16_rounding(out, want,
                                                          f"flash {(B, Sq, Skv, KV, G, hd)}")
    if timed:
        H = KV * G
        qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, hd).contiguous()
        kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
        lib = sdpa(qh, kh, vh, causal, offset)
        lib_out = lib().reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
        res["library_max_abs_err"] = float((lib_out.float().cpu() - torch.as_tensor(want))
                                           .abs().max())
        res["ms"] = cuda_ms(kernel, 50)
        res["graph_ms"] = graph_ms(kernel)
        res["plain_ms"] = cuda_ms(plain, 5, warmup=1)
        res["plain_graph_ms"] = graph_ms(plain, calls=5, replays=2)
        res["library_ms"] = cuda_ms(lib, 50)
        res["library_graph_ms"] = graph_ms(lib)
        res["bound_ms"], res["bound_by"] = flash_bound_ms(B, Sq, Skv, KV, G, hd, causal, dtype,
                                                          offset)
    log("flash", **res)
    return res


def ssd_bound_ms(B, S, H, P, N, Q):
    """Least time for the SSD chunk step on these shapes: x, B, C and da read
    once and y_diag, the states and the cumsum written once over the memory
    rate, against the least work for the function. Products, as
    multiply-adds of 2 operations: the scores C Bᵀ once per (batch, chunk)
    (B and C are shared by all heads) over the Q(Q+1)/2 pairs j <= i, 2N
    each; per (batch, chunk, head) the pairs' product with x, 2P each, and
    the state's Q·P·N multiply-adds. They run at the tensor cores' TF32
    rate over three, the fastest way this card keeps float32 accuracy (one
    TF32 product misses the reference's bar). Elementwise, at the float32
    rate: each pair's decay per head (subtract, exp, multiply), each
    position's decay to the chunk's end per head (subtract, exp) and its
    product with the narrower of the position's B row and x row (min(N, P)),
    and the cumsum (Q adds per head). The two compute times add; the bound
    is the larger of their sum and the memory time. At (4, 512, 24, 64, 128,
    256): 1.68e9 product and 2.2e7 elementwise operations, 0.0105 ms against
    0.0101 ms of bytes. Returns (ms, "bytes" | "operations")."""
    chunks = B * (S // Q)
    pairs = Q * (Q + 1) / 2
    products = chunks * (pairs * 2 * N + H * (pairs * 2 * P + 2 * Q * P * N))
    elementwise = chunks * H * (pairs * 3 + Q * (2 + min(N, P)) + Q)
    n_bytes = 4 * (2 * B * S * H * P + 2 * B * S * N + 2 * B * S * H
                   + B * (S // Q) * H * P * N)
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = products / (PEAK_TF32_OPS_S / 3) + elementwise / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_ssd(B, S, H, P, N, chunk, timed=False):
    """SSD chunk kernel vs its plain version on the card, on the reference
    test's input distributions; returns the numbers."""
    from repro_torch.kernels import ops, ref, ssd

    rng = np.random.default_rng(SEED + B * S + P)
    x = rng.standard_normal((B, S, H, P))
    bm, cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    da = -np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
    x, bm, cm, da = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                     for a in (x, bm, cm, da))
    Q = min(chunk, S)

    def kernel():
        return ssd.ssd_chunk_fwd(x, bm, cm, da, chunk=Q)

    def plain():
        return ref.ssd_chunk_plain(x, bm, cm, da, Q)

    got, want = kernel(), plain()
    y, final = ops.ssd_chunks(x, bm, cm, da, chunk=chunk)
    want_y, want_final = ops.ssd_chunks(x, bm, cm, da, chunk=chunk, backend="reference")
    torch.cuda.synchronize()
    what = f"ssd {(B, S, H, P, N, chunk)}"
    if not all(bool(torch.isfinite(t).all()) for t in (*got, y, final)):
        raise AssertionError(f"{what}: non-finite output")
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"{what}: the kernel's cumsum differs from the plain version's")
    errs = []
    for name, g, w in (("y_diag", got[0], want[0]), ("states", got[1], want[1]),
                       ("y", y, want_y), ("final_state", final, want_final)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-4, err_msg=f"{what} {name}")
        errs.append(float(np.max(np.abs(g - w))))
    res = {"shape": f"({B},{S},{H},{P},{N},{chunk})", "head_group": ssd.head_group(),
           "products": ssd.PRODUCTS, "max_abs_err": max(errs[:2]),
           "ssd_chunks_max_abs_err": max(errs[2:]),
           "max_abs_y": float(want[0].abs().max())}
    if timed:
        res["ms"] = cuda_ms(kernel, 50)
        res["graph_ms"] = graph_ms(kernel)
        res["plain_ms"] = cuda_ms(plain, 5, warmup=1)
        res["bound_ms"], res["bound_by"] = ssd_bound_ms(B, S, H, P, N, Q)
    log("ssd", **res)
    return res


def block_counts(cfg):
    """{block kind: layers} of a config's decoder stages."""
    count = {"self_attn": 0, "cross_attn": 0, "mlp": 0, "moe": 0, "mamba": 0}
    for stage in cfg.stages():
        for kind, _ in stage.blocks:
            count[kind] += stage.repeat
    return count


def prefill_launches(cfg, frames=False):
    """(flash, ssd) launches of one prefill: one flash launch per self- and
    cross-attention layer, and per encoder layer when ``frames`` are given;
    one ssd launch per Mamba layer."""
    count = block_counts(cfg)
    flash = count["self_attn"] + count["cross_attn"] + (cfg.enc_layers if frames else 0)
    return flash, count["mamba"]


def realized_params(cfg):
    """The reference's realized parameter count: total_params() leaves out
    each Mamba block's conv_b (Ch) and dt_bias (nh) (configs/base.py
    _mamba_params; the reference's own test accepts that at rel 0.02)."""
    n_mamba = block_counts(cfg)["mamba"]
    if not n_mamba:
        return cfg.total_params()
    m = cfg.mamba
    d_in, nh = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
    return cfg.total_params() + n_mamba * (d_in + 2 * m.d_state + nh)


def serve_reduced(name, entry, setup):
    """The port's Engine on the card against one golden entry; returns the
    flash and ssd kernel launches of its run."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.step import make_prefill_step

    cfg = get_config(entry["arch"]).reduced(**entry["overrides"])
    lm = interop.params_from_jax(interop.numpy_params(cfg, SEED), cfg, "cuda")
    rt = Runtime("cuda", torch.float32, "auto")
    eng = Engine(cfg, lm, rt, slots=setup["slots"], max_len=setup["max_len"])
    prompts = [np.asarray(p, np.int32) for p in setup["prompts"]]
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=setup["max_new"]))
    before = flash_attention.launches, ssd.launches
    tokens = [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]
    torch.cuda.synchronize()
    launches = flash_attention.launches - before[0], ssd.launches - before[1]
    groups = -(-len(prompts) // setup["slots"])
    want = tuple(n * groups for n in prefill_launches(cfg))
    if launches != want:
        raise AssertionError(f"{name}: (flash, ssd) launches {launches} != {want}: one per "
                             f"attention / Mamba layer x {groups} prefills")
    compared = 0
    for got, want, margins in zip(tokens, entry["tokens"], entry["margins"]):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} tokens, reference {len(want)}")
        for g, w, m in zip(got, want, margins):
            if g != w:
                if m > 1e-3:
                    raise AssertionError(f"{name}: token {g} != reference {w} at margin {m}")
                break
            compared += 1
    S = max(len(p) for p in prompts)
    toks = np.stack([np.pad(p, (S - len(p), 0)) for p in prompts])
    logits = make_prefill_step(cfg, rt)(lm, {"tokens": toks}).double().cpu().numpy()
    want = np.asarray(entry["prefill_logits"])
    err = float(np.max(np.abs(logits - want)) / np.max(np.abs(want)))
    if not err < 1e-4:
        raise AssertionError(f"{name}: prefill logits off the reference by {err} (> 1e-4)")
    log("serve", case=name, family=cfg.family, hd=cfg.resolved_head_dim, layers=cfg.n_layers,
        flash_launches=launches[0], ssd_launches=launches[1], tokens_equal=compared,
        tokens=sum(map(len, tokens)), logits_rel_err=err)
    return launches


def free_card():
    """Hands the memory of earlier phases' models (out of scope once their
    phase returns) back from the allocator's pool; returns the bytes still
    allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def init_full(arch):
    """``arch`` at full width with random bf16 weights from a seeded
    generator on the card; returns (cfg, lm, init seconds), the realized
    parameter count checked against the config's."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(arch)
    t0 = time.perf_counter()
    lm = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), torch.bfloat16,
                     "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    if n_params != realized_params(cfg):
        raise AssertionError(f"{arch}: {n_params} parameters != {realized_params(cfg)}")
    return cfg, lm, init_s


def kernel_vs_plain(arch, got, want):
    """Last-position prefill logits through the kernels (``got``) against
    the plain versions' (``want``): (error relative to max |logit|, top-1
    agreement). Fails on a non-finite logit."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    err = float((got - want).abs().max() / want.abs().max())
    return err, float((got.argmax(-1) == want.argmax(-1)).float().mean())


def serve_full(arch, kernel, kernel_times, phase, n_req=N_REQUESTS, max_new=MAX_NEW):
    """``arch`` at full width on the card, ``n_req`` requests of
    ``max_new`` new tokens; returns the launches of ``kernel`` (the
    flash_attention or ssd module, one launch per layer per prefill) in the
    Engine's run (the serving path, counted from zero). ``kernel_times``
    holds the kernel's ``ms`` and ``graph_ms`` at the path's shape, from
    which its share of a prefill is reported."""
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import init_cache
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    prompt_len, slots, max_len = PROMPT_LEN, SLOTS, MAX_LEN
    kname = kernel.__name__.rsplit(".", 1)[1]
    cfg, lm, init_s = init_full(arch)
    rt = Runtime("cuda", torch.bfloat16, "auto")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (n_req, prompt_len),
                                                   dtype=np.int32)
    eng = Engine(cfg, lm, rt, slots=slots, max_len=max_len)
    for rid in range(n_req):
        eng.submit(Request(rid=rid, prompt=prompts[rid], max_new=max_new))
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    groups = n_req // slots
    if launches != cfg.n_layers * groups:
        raise AssertionError(f"{arch}: {launches} {kname} launches != {cfg.n_layers} x {groups}")
    if sorted(r.rid for r in done) != list(range(n_req)):
        raise AssertionError(f"{arch}: not every request finished")
    for r in done:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"{arch}: request {r.rid} gave {r.out}")

    # prefill through the kernel against the plain version, same weights
    batch = {"tokens": torch.as_tensor(prompts[:slots], device="cuda")}
    prefill = make_prefill_step(cfg, rt)
    err, top1 = kernel_vs_plain(arch, prefill(lm, batch), make_prefill_step(
        cfg, Runtime("cuda", torch.bfloat16, "reference"))(lm, batch))
    if not err < 3e-2:
        raise AssertionError(f"{arch}: kernel prefill logits off the plain version's by {err}")

    prefill_ms = cuda_ms(lambda: prefill(lm, batch), 3, warmup=1)
    decode = make_decode_step(cfg, rt)
    caches = init_cache(cfg, rt, slots, max_len, dtype=torch.bfloat16)
    step = {"tokens": torch.as_tensor(prompts[:slots, :1], device="cuda"), "index": prompt_len}
    decode_ms = cuda_ms(lambda: decode(lm, step, caches), 20, warmup=2)
    log(phase, params=realized_params(cfg), init_s=init_s, requests=n_req, prompt_len=prompt_len,
        max_new=max_new, slots=slots, prefills=groups, engine_wall_s=wall,
        generated_tokens_per_s=n_req * max_new / wall, prefill_ms=prefill_ms,
        decode_step_ms=decode_ms, **{f"{kname}_launches": launches,
                                     f"{kname}_share_of_prefill":
                                     cfg.n_layers * kernel_times["ms"] / prefill_ms,
                                     f"{kname}_graph_share_of_prefill":
                                     cfg.n_layers * kernel_times["graph_ms"] / prefill_ms},
        max_memory_allocated_gb=peak / 1e9, logits_rel_err_vs_plain=err,
        top1_agreement_vs_plain=top1)
    return launches


def serve_moe_full():
    """moonshot-v1-16b-a3b at full width and depth on the card through the
    Engine: one group of SLOTS requests (the run's wall time is its decode
    steps, each of which multiplies all 64 experts' weights). Returns the
    flash launches of the Engine's run, counted from zero."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import moe
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import init_cache
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    held_gb = free_card() / 1e9
    cfg, lm, init_s = init_full(MOE_ARCH)
    if not all(b.moe.router.dtype == torch.float32 for layer in lm.layers for b in layer
               if b.kind == "moe"):
        raise AssertionError(f"{MOE_ARCH}: a router is not float32")
    rt = Runtime("cuda", torch.bfloat16, "auto")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (SLOTS, PROMPT_LEN),
                                                   dtype=np.int32)
    eng = Engine(cfg, lm, rt, slots=SLOTS, max_len=MAX_LEN)
    for rid in range(SLOTS):
        eng.submit(Request(rid=rid, prompt=prompts[rid], max_new=MOE_NEW))
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    want_launches = prefill_launches(cfg)[0]
    if launches != want_launches:
        raise AssertionError(f"{MOE_ARCH}: {launches} flash launches != {want_launches}")
    if sorted(r.rid for r in done) != list(range(SLOTS)):
        raise AssertionError(f"{MOE_ARCH}: not every request finished")
    for r in done:
        if len(r.out) != MOE_NEW or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"{MOE_ARCH}: request {r.rid} gave {r.out}")

    # prefill through the kernel against the plain version, same weights. A
    # one-ulp difference before a router can change a top-6 choice (bf16
    # router logits) and with it every later layer's input, so the routes are
    # held against each other twice: each free, with the share of (layer,
    # token, slot) expert ids that differ, and with the plain version taking
    # the kernel route's expert ids (the comparison the 3e-2 bar gates)
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    prefill = make_prefill_step(cfg, rt)
    plain = make_prefill_step(cfg, Runtime("cuda", torch.bfloat16, "reference"))
    with moe.recording_routes() as ids_kernel:
        got = prefill(lm, batch)
    with moe.recording_routes() as ids_plain:
        want_free = plain(lm, batch)
    with moe.replaying_routes(ids_kernel):
        want = plain(lm, batch)
    err, top1 = kernel_vs_plain(MOE_ARCH, got, want)
    free_err, free_top1 = kernel_vs_plain(MOE_ARCH, got, want_free)
    flipped = torch.stack(ids_kernel) != torch.stack(ids_plain)  # (L, B, S, k)
    per_layer = flipped.flatten(1).float().mean(dim=1)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = moe._capacity(SLOTS * PROMPT_LEN, k, E, cfg.moe_cf)
    dropped = float(torch.stack([moe._dispatch_positions(ids.reshape(-1), E) >= C
                                 for ids in ids_kernel]).float().mean())
    routes = dict(free_logits_rel_err_vs_plain=free_err, free_top1_agreement_vs_plain=free_top1,
                  expert_id_flip_share=float(flipped.float().mean()),
                  expert_id_flip_share_first_last_layer=(float(per_layer[0]),
                                                         float(per_layer[-1])),
                  capacity=C, dropped_slot_share=dropped)
    if not err < 3e-2:
        raise AssertionError(f"{MOE_ARCH}: kernel prefill logits off the plain version's by "
                             f"{err} with the routing held equal (top-1 agreement {top1}, "
                             f"{routes})")

    prefill_ms = cuda_ms(lambda: prefill(lm, batch), 3, warmup=1)
    decode = make_decode_step(cfg, rt)
    caches = init_cache(cfg, rt, SLOTS, MAX_LEN, dtype=torch.bfloat16)
    step = {"tokens": batch["tokens"][:, :1], "index": PROMPT_LEN}
    decode_ms = cuda_ms(lambda: decode(lm, step, caches), 10, warmup=2)
    log("moe", arch=MOE_ARCH, params=cfg.total_params(), init_s=init_s,
        held_before_gb=held_gb, requests=SLOTS, prompt_len=PROMPT_LEN, max_new=MOE_NEW,
        slots=SLOTS, engine_wall_s=wall, generated_tokens_per_s=SLOTS * MOE_NEW / wall,
        prefill_ms=prefill_ms, decode_step_ms=decode_ms, flash_attention_launches=launches,
        max_memory_allocated_gb=peak / 1e9, logits_rel_err_vs_plain=err,
        top1_agreement_vs_plain=top1, **routes, phase_wall_s=time.perf_counter() - t_phase)
    return launches


def serve_code_full(kernel_times):
    """Phase 21: codeqwen1.5-7b at full width and depth (random bf16 weights
    from the seeded generator) through the Engine, one group of SLOTS
    requests, on a card freed of the earlier models before and after.
    Returns the flash launches of the Engine's run, counted from zero."""
    from repro_torch.kernels import flash_attention

    t_phase = time.perf_counter()
    held_gb = free_card() / 1e9
    launches = serve_full(CODE_ARCH, flash_attention, kernel_times, "codeqwen", n_req=SLOTS,
                          max_new=CODE_NEW)
    free_card()
    wall = time.perf_counter() - t_phase
    log("codeqwen", held_before_gb=held_gb, phase_wall_s=wall)
    if wall > CODE_LIMIT_S:
        raise AssertionError(f"codeqwen: the phase took {wall:.1f} s > {CODE_LIMIT_S} s")
    return launches


def serve_audio_full():
    """seamless-m4t-large-v2 at full width and depth on the card through the
    serving steps, its encoder's memory computed once. Returns the flash
    launches of one prefill from frames and of one decode step."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import _encode_memory, init_cache
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    held_gb = free_card() / 1e9
    cfg, lm, init_s = init_full(AUDIO_ARCH)
    if AUDIO_FRAMES != PROMPT_LEN // cfg.enc_frames_ratio:
        raise AssertionError(f"{AUDIO_ARCH}: {AUDIO_FRAMES} frames for {PROMPT_LEN} tokens")
    frames = torch.as_tensor(
        np.random.default_rng(SEED).standard_normal((SLOTS, AUDIO_FRAMES, cfg.d_model)),
        dtype=torch.float32, device="cuda").to(torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SLOTS, PROMPT_LEN), dtype=np.int32), device="cuda")
    rt = Runtime("cuda", torch.bfloat16, "auto")
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    cross = block_counts(cfg)["cross_attn"]

    def counted(what, want, fn):
        flash_attention.launches = 0
        out = fn()
        torch.cuda.synchronize()
        if flash_attention.launches != want:
            raise AssertionError(f"{AUDIO_ARCH} {what}: {flash_attention.launches} flash "
                                 f"launches != {want}")
        return out

    torch.cuda.reset_peak_memory_stats()
    memory = counted("encoder", cfg.enc_layers,
                     lambda: _encode_memory(lm, cfg, rt, {"frames": frames}))
    from_frames = counted("prefill from frames", prefill_launches(cfg, frames=True)[0],
                          lambda: prefill(lm, {"tokens": tokens, "frames": frames}))
    from_memory = counted("prefill from memory", prefill_launches(cfg)[0],
                          lambda: prefill(lm, {"tokens": tokens, "memory": memory}))
    if not torch.equal(from_frames, from_memory):
        raise AssertionError(f"{AUDIO_ARCH}: the prefill from the memoised memory differs from "
                             "the prefill from frames")
    want = make_prefill_step(cfg, Runtime("cuda", torch.bfloat16, "reference"))(
        lm, {"tokens": tokens, "frames": frames})
    err, top1 = kernel_vs_plain(AUDIO_ARCH, from_frames, want)
    if not err < 3e-2:
        raise AssertionError(f"{AUDIO_ARCH}: kernel prefill logits off the plain version's "
                             f"by {err}")

    # the prompt replayed through decode steps to fill the cache (as the
    # Engine does), then greedy decode steps, all with the memoised memory
    caches = init_cache(cfg, rt, SLOTS, MAX_LEN, dtype=torch.bfloat16)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for t in range(PROMPT_LEN):
        _, logits, caches = decode(lm, {"tokens": tokens[:, t:t + 1], "index": t,
                                        "memory": memory}, caches)
    replay_err = float((logits.float() - from_frames.float()).abs().max()
                       / from_frames.float().abs().max())
    nxt, out = from_frames.argmax(-1).to(torch.int32), []
    for step in range(AUDIO_NEW):
        nxt, _, caches = decode(lm, {"tokens": nxt[:, None], "index": PROMPT_LEN + step,
                                     "memory": memory}, caches)
        out.append(nxt)
    out = torch.stack(out, dim=1).cpu()
    decode_wall = time.perf_counter() - t0
    decode_launches = flash_attention.launches
    if decode_launches != cross * (PROMPT_LEN + AUDIO_NEW):
        raise AssertionError(f"{AUDIO_ARCH}: {decode_launches} flash launches in "
                             f"{PROMPT_LEN + AUDIO_NEW} decode steps, {cross} a step expected")
    if not (out.shape == (SLOTS, AUDIO_NEW) and bool(((out >= 0) & (out < cfg.vocab)).all())):
        raise AssertionError(f"{AUDIO_ARCH}: decoded tokens {out.tolist()}")
    peak = torch.cuda.max_memory_allocated()

    prefill_ms = cuda_ms(lambda: prefill(lm, {"tokens": tokens, "frames": frames}), 3, warmup=1)
    prefill_memory_ms = cuda_ms(lambda: prefill(lm, {"tokens": tokens, "memory": memory}), 3,
                                warmup=1)
    step = {"tokens": tokens[:, :1], "index": PROMPT_LEN + AUDIO_NEW, "memory": memory}
    decode_ms = cuda_ms(lambda: decode(lm, step, caches), 10, warmup=2)
    log("audio", arch=AUDIO_ARCH, params=cfg.total_params(), init_s=init_s,
        held_before_gb=held_gb, frames=AUDIO_FRAMES, prompt_len=PROMPT_LEN, slots=SLOTS,
        decode_steps=PROMPT_LEN + AUDIO_NEW, new_tokens=AUDIO_NEW,
        prefill_flash_launches=prefill_launches(cfg, frames=True)[0],
        decode_flash_launches_per_step=cross, memory_prefill_bit_equal=True,
        prefill_ms=prefill_ms, prefill_from_memory_ms=prefill_memory_ms,
        decode_step_ms=decode_ms, decode_wall_s=decode_wall,
        generated_tokens_per_s=SLOTS * AUDIO_NEW / decode_wall,
        max_memory_allocated_gb=peak / 1e9, logits_rel_err_vs_plain=err,
        top1_agreement_vs_plain=top1, replay_last_step_rel_err_vs_prefill=replay_err,
        phase_wall_s=time.perf_counter() - t_phase)
    return {"prefill_from_frames": prefill_launches(cfg, frames=True)[0],
            "decode_step": cross}


# ----------------------------------------------------------------------------
# Training (phases 13-16)
# ----------------------------------------------------------------------------
def train_batch(cfg, setup, step):
    """Step ``step``'s batch of a training setup (the golden file's): the
    SyntheticTokens draws for (seed, step) and, for the vlm / audio
    families, patches (B, n_patches, d_vision) / frames (B, max(S //
    enc_frames_ratio, 4), d) from default_rng([seed, step]), as NumPy."""
    from repro_torch.data.pipeline import SyntheticTokens

    B, S, seed = setup["batch"], setup["seq_len"], setup["seed"]
    batch = SyntheticTokens(cfg.vocab, S, B, seed=seed).batch(step)
    rng = np.random.default_rng([seed, step])
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    if cfg.family == "audio":
        frames = (B, max(S // cfg.enc_frames_ratio, 4), cfg.d_model)
        batch["frames"] = rng.standard_normal(frames).astype(np.float32)
    return batch


def train_curve(cfg, setup, device, attn_backend="auto", routes=None):
    """The port's train step for ``setup["steps"]`` steps on
    ``interop.numpy_params(cfg, seed)`` weights and ``train_batch`` batches,
    float32, AdamW at ``setup["lr"]``, ``setup["microbatches"]``
    microbatches; with ``routes`` (per step, the expert ids of each MoE
    call) the MoE blocks replay them. Returns [(loss, grad_norm)] per step."""
    from repro_torch import interop
    from repro_torch.models import moe
    from repro_torch.models.layers import Runtime
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    lm = interop.params_from_jax(interop.numpy_params(cfg, setup["seed"]), cfg, device)
    opt = adamw(lr=setup["lr"])
    state = opt.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, Runtime(device, torch.float32, attn_backend), opt,
                              setup["microbatches"])
    curve = []
    for step in range(setup["steps"]):
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 train_batch(cfg, setup, step).items()}
        with (moe.replaying_routes([torch.as_tensor(ids, device=device) for ids in routes[step]])
              if routes else contextlib.nullcontext()):
            lm, state, metrics = step_fn(lm, state, batch)
        curve.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return curve


def train_launches(cfg, microbatches, frames=False):
    """(flash, ssd) launches of one train step: each layer's kernel once in
    the forward and once more in its recompute, per microbatch."""
    return tuple(2 * microbatches * n for n in prefill_launches(cfg, frames))


def check_flash_grad(B, Sq, Skv, KV, G, hd, causal, dtype):
    """Flash attention with its gradient on the card: the forward through
    ops.flash_attention launches the kernel once (counted), and dq, dk, dv
    from the plain backward are held against autograd through the naive
    oracle on the same inputs: atol 5e-5 / rtol 5e-4 in float32, 3e-2 in
    bf16 (the reference's bars)."""
    from repro_torch.kernels import flash_attention, ops, ref

    rng = np.random.default_rng(SEED + 7 + B * Sq + hd)
    q, k, v, dout = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
                     .to("cuda", dtype) for shape in ((B, Sq, KV, G, hd), (B, Skv, KV, hd),
                                                      (B, Skv, KV, hd), (B, Sq, KV, G, hd)))
    grads = {}
    for name, fn in (("kernel", ops.flash_attention), ("naive", ref.attention_naive)):
        t = [a.clone().requires_grad_() for a in (q, k, v)]
        before = flash_attention.launches
        out = fn(*t, causal=causal)
        launched = flash_attention.launches - before
        if launched != (name == "kernel"):
            raise AssertionError(f"flash grad {(B, Sq, Skv, KV, G, hd)}: {name} forward made "
                                 f"{launched} kernel launches")
        out.float().backward(dout.float())
        grads[name] = [a.grad.float().cpu().numpy() for a in t]
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16 else dict(atol=5e-5, rtol=5e-4)
    what = f"flash grad {(B, Sq, Skv, KV, G, hd)} {dtype}"
    for name, got, want in zip(("dq", "dk", "dv"), grads["kernel"], grads["naive"]):
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{what}: non-finite {name}")
        np.testing.assert_allclose(got, want, err_msg=f"{what} {name}", **tol)
    res = {"shape": f"({B},{Sq},{Skv},{KV},{G},{hd})", "causal": causal,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max(float(np.max(np.abs(g - w)))
                              for g, w in zip(grads["kernel"], grads["naive"]))}
    log("train-kernels", kernel="flash_attention", **res)
    return res


def time_flash_train(B, S, KV, G, hd, dtype):
    """At the training shape (causal): the kernel's forward, the plain
    backward, and scaled_dot_product_attention's forward + backward as the
    yardstick (in its (B, H, S, hd) layout, torch.autograd.grad), each as
    ms (CUDA events) and graph_ms (device time)."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 8)
    q, dout = (torch.as_tensor(rng.standard_normal((B, S, KV, G, hd)), dtype=torch.float32)
               .to("cuda", dtype) for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((B, S, KV, hd)), dtype=torch.float32)
            .to("cuda", dtype) for _ in range(2))
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True)

    def forward():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=True)

    def backward():
        return ref.flash_attention_bwd(q, k, v, out, dout, True)

    H = KV * G
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd).contiguous().requires_grad_()
    kh, vh = (t.permute(0, 2, 1, 3).contiguous().requires_grad_() for t in (k, v))
    doh = dout.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd).contiguous()
    lib_forward = sdpa(qh, kh, vh, True)

    def library():
        return torch.autograd.grad(lib_forward(), (qh, kh, vh), doh)

    res = {"shape": f"({B},{S},{S},{KV},{G},{hd})", "dtype": str(dtype).replace("torch.", ""),
           "fwd_ms": cuda_ms(forward, 50), "fwd_graph_ms": graph_ms(forward),
           "bwd_plain_ms": cuda_ms(backward, 20), "bwd_plain_graph_ms": graph_ms(backward),
           "library_fwd_bwd_ms": cuda_ms(library, 50),
           "library_fwd_bwd_graph_ms": graph_ms(library)}
    res["fwd_bwd_graph_ms"] = res["fwd_graph_ms"] + res["bwd_plain_graph_ms"]
    res["bound_ms"], res["bound_by"] = flash_bound_ms(B, S, S, KV, G, hd, True, dtype)
    log("train-kernels", kernel="flash_attention", timed="training shape", **res)
    return res


def check_ssd_grad(B, S, H, P, N, chunk):
    """ops.ssd_chunks' gradients (y and the final state summed with fixed
    weights) through the kernel route against the plain route on the same
    inputs: within 2e-4 of each input's max |grad|. Times of the kernel's
    forward (ms and graph_ms) and of the plain backward (the chunk step
    recomputed and differentiated; ms only: the autograd engine's stream
    synchronisation breaks a CUDA graph capture of it)."""
    from repro_torch.kernels import ops, ref, ssd

    rng = np.random.default_rng(SEED + 9 + B * S + P)
    arrays = (rng.standard_normal((B, S, H, P)), 0.5 * rng.standard_normal((B, S, N)),
              0.5 * rng.standard_normal((B, S, N)),
              -np.logaddexp(rng.standard_normal((B, S, H)), 0.0))
    x, bm, cm, da = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in arrays)
    wy = torch.as_tensor(rng.standard_normal((B, S, H, P)), dtype=torch.float32, device="cuda")
    ws = torch.as_tensor(rng.standard_normal((B, H, P, N)), dtype=torch.float32, device="cuda")
    grads = {}
    for backend in ("auto", "reference"):
        t = [a.clone().requires_grad_() for a in (x, bm, cm, da)]
        before = ssd.launches
        y, final = ops.ssd_chunks(*t, chunk=chunk, backend=backend)
        if ssd.launches - before != (backend == "auto"):
            raise AssertionError(f"ssd grad: the {backend} route made {ssd.launches - before} "
                                 "kernel launches")
        ((y * wy).sum() + (final * ws).sum()).backward()
        grads[backend] = [a.grad for a in t]
    gaps = {}
    for name, got, want in zip(("x", "B", "C", "da"), grads["auto"], grads["reference"]):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd grad: non-finite d{name}")
        gaps[name] = float((got - want).abs().max() / want.abs().max())
        if not gaps[name] < 2e-4:
            raise AssertionError(f"ssd grad {(B, S, H, P, N, chunk)}: d{name} off the plain "
                                 f"route's by {gaps[name]} of its max (> 2e-4)")
    Q = min(chunk, S)
    inputs = [a.detach().requires_grad_() for a in (x, bm, cm, da)]
    outs = ref.ssd_chunk_plain(*inputs, Q)
    upstream = [torch.ones_like(o) for o in outs]

    def backward():
        with torch.enable_grad():
            return torch.autograd.grad(ref.ssd_chunk_plain(*inputs, Q), inputs, upstream)

    def forward():
        return ssd.ssd_chunk_fwd(x, bm, cm, da, chunk=Q)

    res = {"shape": f"({B},{S},{H},{P},{N},{chunk})", "rel_grad_gaps": gaps,
           "fwd_ms": cuda_ms(forward, 20), "fwd_graph_ms": graph_ms(forward),
           "bwd_plain_ms": cuda_ms(backward, 5, warmup=1)}
    res["bound_ms"], res["bound_by"] = ssd_bound_ms(B, S, H, P, N, Q)
    log("train-kernels", kernel="ssd_chunk", **res)
    return res


def train_reduced(name, entry, setup):
    """One golden entry trained on the card through the kernels (float32),
    a MoE model on the reference's expert ids (the entry's routes): per
    step, loss within rtol 1e-4 and grad_norm within 1e-3 of the JAX
    reference's, and the kernel launches the steps imply. A MoE model is
    also trained with its routing free, and that run's largest loss gap is
    reported (a near-tie top-k choice can fall the other way). Returns the
    (flash, ssd) launches of the held run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd

    cfg = get_config(entry["arch"]).reduced()
    before = flash_attention.launches, ssd.launches
    curve = train_curve(cfg, setup, "cuda", routes=entry.get("routes"))
    launches = flash_attention.launches - before[0], ssd.launches - before[1]
    want = tuple(n * setup["steps"] for n in train_launches(cfg, setup["microbatches"],
                                                            frames=cfg.family == "audio"))
    if launches != want:
        raise AssertionError(f"{name}: (flash, ssd) launches {launches} != {want}")
    loss, gnorm = (np.array(c) for c in zip(*curve))
    loss_err = np.abs(loss - entry["loss"]) / np.abs(entry["loss"])
    gnorm_err = np.abs(gnorm - entry["grad_norm"]) / np.abs(entry["grad_norm"])
    if not (np.all(np.isfinite(loss)) and loss_err.max() < 1e-4 and gnorm_err.max() < 1e-3):
        raise AssertionError(f"{name}: losses {loss.tolist()} / grad norms {gnorm.tolist()} off "
                             f"the reference's {entry['loss']} / {entry['grad_norm']}")
    free = {}
    if entry.get("routes"):
        free_loss = np.array([c[0] for c in train_curve(cfg, setup, "cuda")])
        free["free_routes_loss_max_rel_err"] = float(
            (np.abs(free_loss - entry["loss"]) / np.abs(entry["loss"])).max())
    log("train-reduced", case=name, family=cfg.family, steps=setup["steps"],
        routes_held=bool(entry.get("routes")), flash_launches=launches[0],
        ssd_launches=launches[1], loss_first=float(loss[0]), loss_last=float(loss[-1]),
        loss_max_rel_err=float(loss_err.max()), grad_norm_max_rel_err=float(gnorm_err.max()),
        **free)
    return launches


def check_recovery(arch="gemma-2b"):
    """The Trainer on the card (reduced ``arch``, float32): a run that
    crashes at step 6 and resumes from the checkpoint of step 4 ends with the
    parameters of an uninterrupted 12-step run, within atol 1e-6 (the
    reference's test)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models.layers import Runtime
    from repro_torch.train.loop import Trainer, TrainerConfig, run_with_recovery

    cfg = get_config(arch).reduced()
    rt = Runtime("cuda", torch.float32, "auto")
    with tempfile.TemporaryDirectory() as tmp:
        def tcfg(sub):
            return TrainerConfig(seq_len=16, global_batch=4, steps=12, ckpt_every=4,
                                 ckpt_dir=str(Path(tmp) / sub), seed=SEED, log_every=1)

        ref = Trainer(cfg, tcfg("ref"), rt)
        ref.init_or_restore()
        ref.run()
        _, restarts = run_with_recovery(lambda: Trainer(cfg, tcfg("rec"), rt), total_steps=12,
                                        fail_at=6)
        rec = Trainer(cfg, tcfg("rec"), rt)
        step = rec.init_or_restore()
    if restarts != 1 or step != 12:
        raise AssertionError(f"recovery: {restarts} restarts, resumed at step {step}")
    err = max(float((a.detach() - b.detach()).abs().max())
              for a, b in zip(ref.params.parameters(), rec.params.parameters()))
    if not err <= 1e-6:
        raise AssertionError(f"recovery: recovered parameters off the uninterrupted run's by {err}")
    log("train-reduced", case=f"{arch} recovery", restarts=restarts, resumed_at=step,
        params_max_abs_err=err)


def profile_step(fn):
    """Device time of one call of ``fn`` (a train step) from a torch.profiler
    trace: the busy time (sum of kernel times), the hand-written forward
    kernels' time (flash_fwd*, ssd_chunk_kernel*) and the time of the
    kernels launched inside the two backwards' profiler ranges."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    spans = (ops.FLASH_BWD_RANGE, ops.SSD_BWD_RANGE)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in spans]

    def ms(es):
        return sum(e.time_range.elapsed_us() for e in es) / 1e3

    in_span = dict.fromkeys(spans, 0.0)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        node = e
        while node is not None and node.name not in in_span:
            node = node.cpu_parent
        if node is not None:
            in_span[node.name] += sum(k.duration for k in e.kernels) / 1e3
    busy = ms(kernels)
    return {"profiled_wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (1e3 * wall), "device_kernels": len(kernels),
            "flash_fwd_device_ms": ms(e for e in kernels if "flash_fwd" in e.name),
            "flash_bwd_device_ms": in_span[ops.FLASH_BWD_RANGE],
            "ssd_fwd_device_ms": ms(e for e in kernels if "ssd_chunk_kernel" in e.name),
            "ssd_bwd_device_ms": in_span[ops.SSD_BWD_RANGE]}


def grad_gap(lm, cfg, batch, want_launches):
    """One microbatch's loss and gradients through the kernels ("auto") and
    through the plain forwards ("reference", the same plain backwards) on the
    same weights, in bf16 compute (the gated comparison) and in float32
    compute (the kernels' own part of the gap); and the plain route's bf16
    gradients against its float32 ones (the rounding of a bf16 backward,
    which any change of the forward's last bits decorrelates). Returns
    {"loss_rel_gap_vs_plain", "grad_rel_l2_gap_vs_plain" (bf16),
    "grad_rel_l2_gap_vs_plain_f32", "plain_grad_rel_l2_gap_bf16_vs_f32"};
    the auto bf16 run's (flash, ssd)
    launches must be ``want_launches``. Relative L2 gaps are global: the
    norm of the difference over the norm of the second's gradient."""
    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import lm_loss

    def run(backend, dtype):
        lm.zero_grad(set_to_none=True)
        before = flash_attention.launches, ssd.launches
        loss, _ = lm_loss(lm, cfg, Runtime("cuda", dtype, backend), batch["tokens"],
                          batch["labels"])
        loss.backward()
        launches = flash_attention.launches - before[0], ssd.launches - before[1]
        if (backend, dtype) == ("auto", torch.bfloat16) and launches != want_launches:
            raise AssertionError(f"{cfg.name}: (flash, ssd) launches {launches} in one "
                                 f"microbatch, {want_launches} expected")
        grads = {n: p.grad for n, p in lm.named_parameters()}
        lm.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    def rel_l2(got, want):
        diff = sum(float(((got[n] - want[n]).double() ** 2).sum()) for n in want)
        return (diff / sum(float((want[n].double() ** 2).sum()) for n in want)) ** 0.5

    loss_ref, ref_bf16 = run("reference", torch.bfloat16)
    loss_auto, auto = run("auto", torch.bfloat16)
    out = {"loss_rel_gap_vs_plain": abs(loss_auto - loss_ref) / abs(loss_ref),
           "grad_rel_l2_gap_vs_plain": rel_l2(auto, ref_bf16)}
    del auto
    _, ref_f32 = run("reference", torch.float32)
    out["plain_grad_rel_l2_gap_bf16_vs_f32"] = rel_l2(ref_bf16, ref_f32)
    del ref_bf16
    out["grad_rel_l2_gap_vs_plain_f32"] = rel_l2(run("auto", torch.float32)[1], ref_f32)
    return out


def train_full(arch, batch_size, seq_len, phase):
    """``arch`` trained at full width and depth on the card: float32
    parameters and the optimizer of for_config, bf16 compute through the
    kernels, B ``batch_size`` x S ``seq_len`` in the config's microbatches,
    TRAIN_STEPS steps on SyntheticTokens. Checks: every loss finite, the last
    below the first, each step's kernel launches; one microbatch through the
    kernels against the plain forwards (loss within 1e-2 relative, global
    relative L2 gradient gap within 3e-2; the gaps in float32 compute and of
    the plain route's bf16 gradients from its float32 ones printed beside
    it). Prints step times, tokens/s, peak
    memory and, from a profiled extra step, the kernels' forward and the
    plain backwards' share of a step's device time. Returns the launches of
    the TRAIN_STEPS steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import for_config
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    held_gb = free_card() / 1e9
    cfg = get_config(arch)
    mb = cfg.microbatches
    t0 = time.perf_counter()
    lm = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), torch.float32,
                     "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    if n_params != realized_params(cfg):
        raise AssertionError(f"{arch}: {n_params} parameters != {realized_params(cfg)}")
    data = SyntheticTokens(cfg.vocab, seq_len, batch_size, seed=SEED)

    def device_batch(step, rows=None):
        return {k: torch.as_tensor(v[:rows], device="cuda") for k, v in data.batch(step).items()}

    per_step = train_launches(cfg, mb)
    gaps = grad_gap(lm, cfg, device_batch(0, batch_size // mb), tuple(n // mb for n in per_step))
    if not (gaps["loss_rel_gap_vs_plain"] < 1e-2 and gaps["grad_rel_l2_gap_vs_plain"] < 3e-2):
        raise AssertionError(f"{arch}: kernel route off the plain forwards: {gaps}")
    free_card()

    opt = for_config(cfg)
    state = opt.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, Runtime("cuda", torch.bfloat16, "auto"), opt)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], (0, 0)
    for step in range(TRAIN_STEPS):
        batch = device_batch(step)
        before = flash_attention.launches, ssd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm, state, metrics = step_fn(lm, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got = flash_attention.launches - before[0], ssd.launches - before[1]
        if got != per_step:
            raise AssertionError(f"{arch} step {step}: (flash, ssd) launches {got} != "
                                 f"{per_step}")
        launches = (launches[0] + got[0], launches[1] + got[1])
    peak = torch.cuda.max_memory_allocated()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: losses {losses}")
    batch = device_batch(TRAIN_STEPS)
    prof = profile_step(lambda: step_fn(lm, state, batch))
    steady_ms = float(np.median(step_ms[1:]))
    shares = {}
    for kname, fwd, bwd in (("flash", "flash_fwd_device_ms", "flash_bwd_device_ms"),
                            ("ssd", "ssd_fwd_device_ms", "ssd_bwd_device_ms")):
        if prof[fwd]:
            shares[f"{kname}_fwd_share_of_device"] = prof[fwd] / prof["device_busy_ms"]
            shares[f"{kname}_bwd_share_of_device"] = prof[bwd] / prof["device_busy_ms"]
    log(phase, arch=arch, params=n_params, init_s=init_s, held_before_gb=held_gb,
        batch=batch_size, seq_len=seq_len, microbatches=mb, optimizer=opt.name,
        steps=TRAIN_STEPS, losses=[round(x, 5) for x in losses], step_ms=step_ms,
        steady_step_ms=steady_ms, tokens_per_s=batch_size * seq_len / (steady_ms / 1e3),
        flash_launches_per_step=per_step[0], ssd_launches_per_step=per_step[1],
        max_memory_allocated_gb=peak / 1e9, **gaps, **prof, **shares,
        phase_wall_s=time.perf_counter() - t_phase)
    return {"launches": launches, "launches_per_step": per_step, "steady_step_ms": steady_ms,
            "peak_gb": peak / 1e9, **gaps, **prof}


SIM_M = 64  # the allocator's largest instance, simulated at the reference's defaults
SIM_HORIZON, SIM_WARMUP = 2000.0, 200.0  # simulate_allocation's defaults
PARITY_HORIZON, PARITY_WARMUP = 400.0, 40.0
STRUCT_M, STRUCT_HORIZON, T_COLD = 16, 300.0, 2.0
ROLLOUT_STATS = ("mean_s", "p95_s", "pooled_mean_s", "pooled_p95_s")


def profile_device(fn):
    """``fn()`` once under torch.profiler: (its result, device kernels, device
    copies and sets, device busy ms, profiled wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return out, len(device) - len(copies), len(copies), busy, 1e3 * wall


def rollout_batch(apps, alloc):
    """A refinement step's rollout input at ``alloc``: the incumbent and its
    2M ±1 moves (B = 2M + 1), every candidate at the incumbent's service
    rates."""
    from repro_torch.core.problem import service_rate

    M = len(apps)
    n0 = np.asarray(alloc.n, dtype=int)
    mu0 = np.array([float(service_rate(a, c, m, "cpu"))
                    for a, c, m in zip(apps, alloc.r_cpu, alloc.r_mem)])
    n = np.vstack([n0] + [n0 + d * np.eye(M, dtype=int)[i] for i in range(M) for d in (-1, 1)])
    return [a.name for a in apps], np.array([a.lam for a in apps]), np.tile(mu0, (len(n), 1)), n


def check_rollout_scan(apps, alloc, horizon):
    """Part 1: one rollout on the card against the host loop
    (``backend="numpy"``) on the same CRN draws: the waits on every valid
    customer slot bit for bit (else within rtol 1e-12, the gap printed), the
    statistics within rtol 1e-12; cold and cached times, launches, bytes."""
    from repro_torch.core import des_vector

    names, lam, mu, n = rollout_batch(apps, alloc)
    kw = dict(seed=SEED, warmup_s=0.2 * horizon)
    des_vector._CRN_CACHE.clear()
    times = []
    for _ in range(3):  # cold (draws made and committed), then cached
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ro = des_vector.rollout_candidates(names, lam, mu, n, horizon, device="cuda", **kw)
        times.append(1e3 * (time.perf_counter() - t0))
    ro, kernels, copies, busy_ms, prof_ms = profile_device(
        lambda: des_vector.rollout_candidates(names, lam, mu, n, horizon, device="cuda", **kw))
    waits = ro._raw[0]
    waits_bytes = waits.numel() * waits.element_size()
    waits = waits.cpu().numpy()
    t0 = time.perf_counter()
    host = des_vector.rollout_candidates(names, lam, mu, n, horizon, backend="numpy", **kw)
    host_ms = 1e3 * (time.perf_counter() - t0)
    want = host._raw[0]
    K = int(ro.n_arrivals.max())
    slots = differ = 0
    max_abs = max_rel = 0.0
    for i, k in enumerate(ro.n_arrivals):
        a, b = waits[:k, i], want[:k, i]
        slots += a.size
        differ += int(np.count_nonzero(a != b))
        if k:
            d = np.abs(a - b)
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float((d / np.maximum(np.abs(b), 1e-300)).max()))
    if differ and max_rel > 1e-12:
        raise AssertionError(f"rollout scan: {differ} of {slots} waits differ from the host "
                             f"loop's, max rel {max_rel} > 1e-12")
    for key in ROLLOUT_STATS:
        np.testing.assert_allclose(getattr(ro, key), getattr(host, key), rtol=1e-12, atol=0.0,
                                   err_msg=key)
    if not np.all(np.isfinite(ro.p95_s)):
        raise AssertionError("rollout scan: a non-finite p95")
    res = {"M": len(apps), "B": n.shape[0], "horizon_s": horizon, "K": K,
           "Kp": des_vector._pad_pow2(K), "n_pad": des_vector._pad_pow2(int(n.max())),
           "customers": int(ro.n_events), "valid_slots": slots, "slots_differ": differ,
           "max_abs_diff": max_abs, "max_rel_diff": max_rel,
           "cold_ms": times[0], "cached_ms": min(times[1:]), "profiled_ms": prof_ms,
           "device_kernels": kernels, "device_copies": copies,
           "kernels_per_step": kernels / K, "device_busy_ms": busy_ms,
           "host_loop_ms": host_ms, "waits_bytes": waits_bytes}
    log("simulate", part="scan", **res)
    return res


def solve_p95(golden):
    """Part 2: allocate("crms_p95") with a rollout budget on the card
    against the reference's result, its crms_grid launches counted from
    zero and the rollouts' share of its wall clock."""
    from repro_torch.core import des_vector
    from repro_torch.kernels import crms_grid

    rollout = des_vector.rollout_candidates
    spent = []

    def timed(*args, **kw):  # the solve reads p95_s: its copy and percentiles count
        t0 = time.perf_counter()
        ro = rollout(*args, **kw)
        ro.p95_s
        spent.append(time.perf_counter() - t0)
        return ro

    des_vector._CRN_CACHE.clear()
    des_vector.rollout_candidates = timed
    crms_grid.launches = 0
    try:
        t0 = time.perf_counter()
        launches, refine_iters, alloc = run_entry("p95_rollout_mix64", golden, "cuda",
                                                  twins_interchangeable=True)
        wall = time.perf_counter() - t0
    finally:
        des_vector.rollout_candidates = rollout
    if launches < refine_iters:
        raise AssertionError(f"crms_p95: {launches} crms_grid launches < {refine_iters} "
                             "refinement iterations")
    res = {"wall_s": wall, "rollouts": len(spent), "rollout_s": sum(spent),
           "rollout_share": sum(spent) / wall, "crms_grid_launches": launches,
           "refine_iters": refine_iters}
    log("simulate", part="crms_p95", **res)
    return res


def counted_scans():
    """Wraps des_vector.segment_scan to count the segments and customer
    steps a run scans; returns (the counts, a function that unwraps)."""
    from repro_torch.core import des_vector

    scan = des_vector.segment_scan
    counts = {"segments": 0, "steps": 0, "customer_steps": 0}

    def counted(W0, smask, gaps, svcs, valid, **kw):
        counts["segments"] += 1
        counts["steps"] += int(valid.sum(axis=0).max())
        counts["customer_steps"] += int(valid.sum())
        return scan(W0, smask, gaps, svcs, valid, **kw)

    des_vector.segment_scan = counted

    def restore():
        des_vector.segment_scan = scan

    return counts, restore


def simulate_fleet(apps, alloc):
    """Part 3: simulate_allocation on the card at the reference's defaults;
    launches per step from a profiled 2 % run of the same allocation."""
    from repro_torch.core.des import simulate_allocation

    served = [i for i, a in enumerate(apps) if alloc.n[i] > 0 and a.lam > 0]
    counts, restore = counted_scans()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = simulate_allocation(apps, alloc, horizon_s=SIM_HORIZON, warmup_s=SIM_WARMUP,
                                    seed=SEED, engine="vector", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full = dict(counts)
        counts.update(segments=0, steps=0, customer_steps=0)
        _, kernels, copies, busy_ms, prof_ms = profile_device(lambda: simulate_allocation(
            apps, alloc, horizon_s=0.02 * SIM_HORIZON, warmup_s=0.02 * SIM_WARMUP, seed=SEED,
            engine="vector", device="cuda"))
    finally:
        restore()
    bad = [apps[i].name for i in served
           if not (np.isfinite(stats[i].mean_response_s) and np.isfinite(stats[i].p95_response_s))]
    if bad:
        raise AssertionError(f"simulate_allocation: non-finite mean or p95 for {bad}")
    per_step = kernels / counts["steps"]
    res = {"M": len(apps), "horizon_s": SIM_HORIZON, "wall_s": wall, **full,
           "customers_per_s": full["customer_steps"] / wall,
           "completed_in_window": sum(s.n_completed for s in stats),
           "kernels_per_step": per_step, "launches": full["steps"] * per_step,
           "short_run": {"horizon_s": 0.02 * SIM_HORIZON, "steps": counts["steps"],
                         "device_kernels": kernels, "device_copies": copies,
                         "device_busy_ms": busy_ms, "profiled_ms": prof_ms,
                         "device_idle_share": 1.0 - busy_ms / prof_ms},
           "max_mean_response_s": max(stats[i].mean_response_s for i in served),
           "max_p95_response_s": max(stats[i].p95_response_s for i in served)}
    log("simulate", part="simulate_allocation", **res)
    return res


def engine_pair(apps, alloc, horizon, warmup, case, script=None, **fleet):
    """Part 4: the event engine (host) and the vector engine (card) on one
    allocation and script; per-customer arrival times within rtol/atol 1e-9
    and responses within rtol 1e-7 / atol 1e-9 (tests/test_des_vector.py's
    bars), the same crash/repair counts and downs; both wall clocks."""
    from repro_torch.core.des import FleetSimulator
    from repro_torch.core.problem import service_rate

    sims, walls = {}, {}
    for engine, kw in (("event", {}), ("vector", {"device": "cuda"})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = FleetSimulator(seed=SEED, engine=engine, **fleet, **kw)
        for i, a in enumerate(apps):
            mu = float(service_rate(a, alloc.r_cpu[i], alloc.r_mem[i], "cpu"))
            sim.add_app(a.name, a.lam, mu, int(alloc.n[i]))
        (script or (lambda s: s.run_until(horizon)))(sim)
        sim.drain()
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        sims[engine] = sim
    ev, vec = sims["event"], sims["vector"]
    customers = 0
    max_resp = 0.0
    for a in apps:
        ce = ev._clusters[a.name]
        te, re_ = np.asarray(ce.arr_log), np.asarray(ce.resp_log)
        tv, wv, sv = vec._clusters[a.name].logs()
        if te.shape != tv.shape or ce.n_arrived != vec._clusters[a.name].n_arrived:
            raise AssertionError(f"{case} {a.name}: {te.shape[0]} event against {tv.shape[0]} "
                                 "vector customers")
        oe, ov = np.argsort(te), np.argsort(tv)
        np.testing.assert_allclose(te[oe], tv[ov], rtol=1e-9, atol=1e-9, err_msg=a.name)
        np.testing.assert_allclose(re_[oe], (wv + sv)[ov], rtol=1e-7, atol=1e-9, err_msg=a.name)
        customers += te.shape[0]
        if te.size:
            max_resp = max(max_resp, float(np.max(np.abs(re_[oe] - (wv + sv)[ov]))))
    if ev.failure_stats() != vec.failure_stats() or ev.downs() != vec.downs():
        raise AssertionError(f"{case}: the engines' failure records differ")
    window = [np.mean(ev.responses(a.name, warmup, horizon)) for a in apps
              if ev.responses(a.name, warmup, horizon).size]
    res = {"case": case, "M": len(apps), "horizon_s": horizon, "customers": customers,
           "max_abs_response_diff": max_resp, "event_wall_s": walls["event"],
           "vector_wall_s": walls["vector"], "mean_window_response_s": float(np.mean(window))}
    log("simulate", part="event_vs_vector", **res)
    return res


def structural_script(apps, alloc):
    """The structural-parity paths in one run: a cold-start ramp with a
    configure landing mid-ramp, and a scripted crash and repair at segment
    boundaries (the fleet's arrivals are MMPP)."""
    a0, a1 = apps[0], apps[1]

    def script(sim):
        sim.run_until(100.0)
        sim.configure(a0.name, lam=1.5 * a0.lam, n_servers=int(alloc.n[0]) + 4)  # cold ramp
        sim.run_until(100.0 + 0.4 * T_COLD + 0.2)  # mid-ramp
        sim.configure(a0.name, n_servers=int(alloc.n[0]) + 2, warm_pool=2)  # supersedes it
        sim.crash(a1.name, 2)
        sim.run_until(200.0)
        sim.repair(a1.name, 2)
        sim.run_until(STRUCT_HORIZON)

    return script


def simulate_phase(golden, allocations):
    """Phase 17 at make_tenant_mix(64) (and 16 for the structural paths)."""
    from repro_torch.core.arrivals import mmpp2
    from repro_torch.core.lifecycle import LifecycleSpec
    from repro_torch.core.profiler import make_tenant_mix

    t_phase = time.perf_counter()
    apps, _, _ = make_tenant_mix(SIM_M)
    alloc = allocations[f"mix{SIM_M}"]
    scan = check_rollout_scan(apps, alloc, 40.0)
    p95 = solve_p95(golden)
    fleet = simulate_fleet(apps, alloc)
    pair = engine_pair(apps, alloc, PARITY_HORIZON, PARITY_WARMUP, f"mix{SIM_M}")
    apps16, _, _ = make_tenant_mix(STRUCT_M)
    alloc16 = allocations[f"mix{STRUCT_M}"]
    struct = engine_pair(apps16, alloc16, STRUCT_HORIZON, PARITY_WARMUP,
                         f"mix{STRUCT_M} mmpp+lifecycle+crash",
                         structural_script(apps16, alloc16),
                         arrival=mmpp2(burst=4.0, frac=0.15, cycle=40.0),
                         lifecycle=LifecycleSpec(T_COLD, warm_pool=1))
    log("simulate", phase_wall_s=time.perf_counter() - t_phase)
    return {"scan": scan, "crms_p95": p95, "simulate_allocation": fleet,
            "event_vs_vector": pair, "structural": struct}


# ----------------------------------------------------------------------------
# Scenarios (phase 18)
# ----------------------------------------------------------------------------
SCENARIO_RTOL = 1e-6
# left out of the comparison: the wall clocks
SCENARIO_SKIP = ("wall_clock_s", "replan_time_s_mean")
SCENARIO_LIMIT_S = 180.0
# re-plans that launch no crms_grid kernel: DRF's demands are SP1 solves
NO_CRMS_POLICIES = ("drf",)


def plain(obj):
    """JSON-safe copy: tuples as lists, NumPy scalars as Python numbers,
    non-finite floats as None (as the scenario documents store them)."""
    if isinstance(obj, dict):
        return {str(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, np.ndarray)):
        return [plain(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj) if np.isfinite(obj) else None
    return obj


def assert_same(ref, got, path="$", rtol=SCENARIO_RTOL):
    """Field by field: integers, booleans, strings, None and lists exactly,
    floats within ``rtol``, the keys in SCENARIO_SKIP left out. Both sides
    JSON-shaped (``plain``)."""
    if isinstance(ref, dict):
        if not (isinstance(got, dict) and set(got) == set(ref)):
            raise AssertionError(f"{path}: keys {sorted(got)} != reference {sorted(ref)}")
        for k in ref:
            if k not in SCENARIO_SKIP:
                assert_same(ref[k], got[k], f"{path}.{k}", rtol)
    elif isinstance(ref, list):
        if not (isinstance(got, list) and len(got) == len(ref)):
            raise AssertionError(f"{path}: {got!r} != reference {ref!r}")
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{path}[{i}]", rtol)
    elif isinstance(ref, float) and isinstance(got, (int, float)) and not isinstance(got, bool):
        if not abs(got - ref) <= rtol * abs(ref):
            raise AssertionError(f"{path}: {got!r} != reference {ref!r} (rtol {rtol})")
    elif not (type(got) is type(ref) and got == ref):
        raise AssertionError(f"{path}: {got!r} != reference {ref!r}")


def build_scenario(spec, api, problem):
    """The Scenario that the golden file's ``spec`` describes, built with the
    scenario package ``api`` and its problem module ``problem`` (the port's
    here; the parity tests pass the reference's too)."""
    def app(values):
        return problem.App(**{**values, "kappa": tuple(values["kappa"])})

    apps = tuple(app(a) for a in spec["apps"])
    caps = problem.ServerCaps(*spec["caps"])
    kw = dict(spec["kwargs"])
    if "drift" in kw:
        kw["drift"] = api.LambdaDrift(**kw["drift"])
    if "trace" in kw:
        kw["trace"] = ROOT / kw["trace"]
    events = []
    for ev in spec.get("events", ()):
        fields = {k: v for k, v in ev.items() if k != "kind"}
        if "app" in fields:
            fields["app"] = app(fields["app"])
        events.append(getattr(api, ev["kind"])(**fields))
    if events:
        kw["events"] = tuple(events)
    if spec["constructor"] == "Scenario":
        return api.Scenario(apps=apps, caps=caps, **kw)
    return getattr(api.Scenario, spec["constructor"])(apps, caps, **kw)


def _fresh(api, name):
    """The registered policy ``name`` with its state dropped."""
    policy = api.get_policy(name)
    if hasattr(policy, "reset"):
        policy.reset()
    return policy


def run_trace(spec, api, problem, des_engine="vector", backend=None, **runner_kw):
    """The document of one trace through ``api``'s ScenarioRunner."""
    r = spec["runner"]
    for name in r["policies"]:
        _fresh(api, name)
    return api.ScenarioRunner(
        build_scenario(spec, api, problem), r["policies"], quasi_dynamic=r["quasi_dynamic"],
        extra=r["extra"], backend=backend or r["backend"], epoch_s=r["epoch_s"],
        des_engine=des_engine, slo_p95_s=r["slo_p95_s"], **runner_kw).run()


def alloc_record(res) -> dict:
    """The comparison record of one allocate() result."""
    a, d = res.allocation, res.diagnostics
    return plain({
        "n": a.n, "r_cpu": a.r_cpu, "r_mem": a.r_mem, "utility": a.utility,
        "feasible": a.feasible, "stable": a.stable, "shed": d.shed,
        "admission": a.meta.get("admission"), "extra": d.extra,
        "refine_iters": d.refine_iters, "accepted_moves": d.accepted_moves,
        "p1_calls": d.p1_calls,
    })


def crunch_records(spec, api, problem, **request_kw):
    """The crunch's single allocations through ``api``: one record each and
    the wall clocks."""
    apps = tuple(problem.App(**{**a, "kappa": tuple(a["kappa"])}) for a in spec["apps"])
    records, walls = [], {}
    for call in spec["calls"]:
        policy = _fresh(api, call["policy"])
        t0 = time.perf_counter()
        res = policy.allocate(api.AllocRequest(
            apps=apps, caps=problem.ServerCaps(*spec["caps"]), alpha=spec["alpha"],
            beta=spec["beta"], seed=spec["seed"], extra=json.loads(json.dumps(call["extra"])),
            **request_kw))
        walls[call["policy"]] = time.perf_counter() - t0
        records.append({"policy": call["policy"], **alloc_record(res)})
    return records, walls


def counted_solves():
    """Wraps the policies' crms to count the solves; returns (a one-element
    count list, a function that unwraps)."""
    from repro_torch.api import policies

    solve = policies.crms
    count = [0]

    def counted(*args, **kw):
        count[0] += 1
        return solve(*args, **kw)

    policies.crms = counted

    def restore():
        policies.crms = solve

    return count, restore


def replay_trace(name, spec, device):
    """One trace through ScenarioRunner (des backend, vector engine) on
    ``device`` against the reference's document: equal field by field, the
    document and its compact form valid."""
    from repro_torch import api
    from repro_torch.core import problem

    solves, restore = counted_solves()
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc = run_trace(spec, api, problem, device=device)
        wall = time.perf_counter() - t0
    finally:
        restore()
    api.validate_scenarios_doc(doc)
    api.validate_scenarios_doc(api.compact_scenarios_doc(doc))
    assert_same(spec["doc"], plain(doc), name)
    matrix = doc["matrix"]
    res = {"trace": name, "M": len(spec["apps"]), "n_epochs": doc["scenario"]["n_epochs"],
           "epoch_s": spec["runner"]["epoch_s"], "cut": spec["cut"], "wall_s": wall,
           "solves": solves[0], "replans": sum(m["n_replans"] for m in matrix.values()),
           "crms_replans": sum(m["n_replans"] for p, m in matrix.items()
                               if p not in NO_CRMS_POLICIES),
           "replan_time_s_mean": {p: m["replan_time_s_mean"] for p, m in matrix.items()}}
    log("scenarios", **res)
    return res


def replay_crunch(spec, device):
    """The capacity crunch: single allocations (crms_failover, crms_shed,
    crms) on ``device`` against the reference's records."""
    from repro_torch import api
    from repro_torch.core import problem

    solves, restore = counted_solves()
    try:
        got, walls = crunch_records(spec, api, problem, device=device)
    finally:
        restore()
    assert_same(spec["results"], got, "crunch")
    failover = got[0]
    if not (failover["feasible"] and failover["stable"] and failover["shed"]):
        raise AssertionError("crunch: crms_failover did not shed to a feasible admitted set")
    res = {"trace": "crunch", "M": len(spec["apps"]), "solves": solves[0], "replans": len(got),
           "crms_replans": len(got),
           "wall_s": sum(walls.values()), "policy_wall_s": walls,
           "shed": failover["shed"], "admission": failover["admission"]}
    log("scenarios", **res)
    return res


def replay_scenarios(golden, device):
    traces = [replay_trace(name, spec, device) for name, spec in golden["traces"].items()]
    return traces + [replay_crunch(golden["crunch"], device)]


def scenario_phase():
    """Phase 18: the six traces of tests/data/torch_scenario_golden.json on
    the card (device None), crms_grid counted from zero."""
    from repro_torch.kernels import crms_grid

    golden = json.loads(SCENARIO_GOLDEN.read_text())
    t_phase = time.perf_counter()
    crms_grid.launches = 0
    traces = replay_scenarios(golden, None)
    launches = crms_grid.launches
    wall = time.perf_counter() - t_phase
    replans = sum(t["replans"] for t in traces)
    crms_replans = sum(t["crms_replans"] for t in traces)
    res = {"launches": launches, "replans": replans, "crms_replans": crms_replans,
           "solves": sum(t["solves"] for t in traces), "phase_wall_s": wall}
    log("scenarios", **res)
    if launches < crms_replans:
        raise AssertionError(f"scenarios: {launches} crms_grid launches < {crms_replans} "
                             "re-plans through CRMS")
    if wall > SCENARIO_LIMIT_S:
        raise AssertionError(f"scenarios: the phase took {wall:.1f} s > {SCENARIO_LIMIT_S} s")
    return res


# ----------------------------------------------------------------------------
# The search baselines and the fleet placement layer (phase 19)
# ----------------------------------------------------------------------------
BASELINES_GOLDEN = ROOT / "tests" / "data" / "torch_baselines_golden.json"
FLEET_GOLDEN = ROOT / "tests" / "data" / "torch_fleet_golden.json"
FIG_LAM = (8.0, 7.0, 10.0, 15.0)  # the paper's constrained comparison (Figs. 11-14)
FIG_CAPS, SUFFICIENT_CAPS = (30.0, 10.0), (120.0, 40.0)
FIG_SEEDS = (0, 1, 2)
SEARCHES = ("random_search", "gpbo", "tpebo")
RS_SAMPLES = 20000
MIN_REDUCTION_PCT = 14.0  # CRMS over the best search baseline (§VI)
SEARCH_M = 16
FLEET_NODES, FLEET_APPS, FLEET_SEED = 1000, 16, 0
FLEET_SAMPLED, PARITY_NODES, PARITY_TOL = 64, 8, 1e-6
FLEET_SCENARIO = (16, 8)
FLEET_DIAGS = ("nodes_total", "apps", "M_pad", "width", "profile", "nodes_failed",
               "p1_rescued_rows", "p1_masked_rows", "cold", "nodes_solved", "migrations",
               "exchange_accepted")
BASELINES_LIMIT_S = 120.0


def baseline_calls(seeds=FIG_SEEDS):
    """The Figs. 11-14 comparison as (key, policy, caps, seed, extra): crms,
    each search baseline at each seed (random search with 20000 samples, the
    BO baselines at their defaults), drf, and SNFC at the sufficient caps."""
    calls = [("crms", "crms", FIG_CAPS, 0, {})]
    for seed in seeds:
        calls += [(f"random_search/{seed}", "random_search", FIG_CAPS, seed,
                   {"n_samples": RS_SAMPLES}),
                  (f"gpbo/{seed}", "gpbo", FIG_CAPS, seed, {}),
                  (f"tpebo/{seed}", "tpebo", FIG_CAPS, seed, {})]
    return calls + [("drf", "drf", FIG_CAPS, 0, {}),
                    ("snfc1", "snfc1", SUFFICIENT_CAPS, 0, {}),
                    ("snfc2", "snfc2", SUFFICIENT_CAPS, 0, {})]


def baseline_record(res) -> dict:
    """The comparison record of one baseline's allocate() result."""
    a = res.allocation
    return plain({"n": a.n, "r_cpu": a.r_cpu, "r_mem": a.r_mem, "utility": a.utility,
                  "ws": a.ws, "feasible": a.feasible, "stable": a.stable})


def _on_card(request_kw) -> bool:
    return torch.cuda.is_available() and request_kw.get("device", "cuda") != "cpu"


def _sync(request_kw):
    if _on_card(request_kw):
        torch.cuda.synchronize()


def run_baselines(api, problem, profiler, seeds=FIG_SEEDS, **request_kw):
    """The Figs. 11-14 calls through ``api.allocate`` on the paper's four apps
    (ground-truth κ, λ (8, 7, 10, 15)): (records, wall clocks, random
    search's peak device bytes by key)."""
    apps = profiler.make_paper_apps(lam=FIG_LAM, fitted=False)
    records, walls, peaks = {}, {}, {}
    for key, policy, caps, seed, extra in baseline_calls(seeds):
        request = api.AllocRequest(apps=apps, caps=problem.ServerCaps(*caps), alpha=1.4,
                                   beta=0.2, seed=seed, extra=dict(extra), **request_kw)
        measure = policy == "random_search" and _on_card(request_kw)
        if measure:
            torch.cuda.reset_peak_memory_stats()
        _sync(request_kw)
        t0 = time.perf_counter()
        res = api.allocate(policy, request)
        _sync(request_kw)
        walls[key] = time.perf_counter() - t0
        if measure:
            peaks[key] = torch.cuda.max_memory_allocated()
        records[key] = baseline_record(res)
    return records, walls, peaks


def search_record(api, profiler, **request_kw):
    """Random search at make_tenant_mix(16), 20000 samples, seed 0: one
    float64 batch of 20000 x 16 lanes at Erlang width 512."""
    apps, caps, _ = profiler.make_tenant_mix(SEARCH_M)
    return baseline_record(api.allocate("random_search", api.AllocRequest(
        apps, caps, seed=0, extra={"n_samples": RS_SAMPLES}, **request_kw)))


def mean_latency_s(record) -> float:
    """The λ-weighted mean response of a Figs. 11-14 record (inf when an app
    is unstable), as benchmarks/common.py's mean_latency."""
    ws = record["ws"]
    if not record["stable"] or any(w is None for w in ws):
        return float("inf")
    lam = np.asarray(FIG_LAM)
    return float(np.sum(lam * np.asarray(ws)) / np.sum(lam))


def reductions_pct(records, seeds=FIG_SEEDS) -> dict:
    """CRMS's latency reduction over each search baseline, its latency the
    mean over the seeds' finite ones (benchmarks/fig11_14_constrained.py)."""
    w_crms = mean_latency_s(records["crms"])
    out = {}
    for name in SEARCHES:
        finite = [w for w in (mean_latency_s(records[f"{name}/{s}"]) for s in seeds)
                  if np.isfinite(w)]
        w = float(np.mean(finite)) if finite else float("inf")
        out[name] = 100.0 * (1.0 - w_crms / w) if np.isfinite(w) else 100.0
    return out


def fleet_drift(planner, seed=FLEET_SEED):
    """The incremental re-plan of benchmarks/fleet_placement.py:82-110 (its
    first): λ drift on max(2, N // 250) apps and one migration, drawn from
    ``seed + 1`` in the benchmark's order. Returns (lam, migrations)."""
    rng = np.random.default_rng(seed + 1)
    idx = rng.choice(planner.A, size=max(2, planner.N // 250), replace=False)
    mig_app = planner.apps[int(rng.integers(planner.A))].name
    mig_dst = int(rng.integers(planner.N))
    lam = {planner.apps[int(i)].name: float(planner.lam[int(i)]) * float(rng.uniform(0.85, 1.2))
           for i in idx}
    return lam, [(mig_app, mig_dst)]


def node_floats(planner, nodes) -> dict:
    """Per node of ``nodes`` its apps' quotas and response times, in app order."""
    on = [np.flatnonzero(planner.assignment == j) for j in nodes]
    return plain({"nodes": list(nodes), **{key: [getattr(planner, attr)[a] for a in on]
                                           for key, attr in (("r_cpu", "sol_c"),
                                                             ("r_mem", "sol_m"),
                                                             ("ws", "sol_ws"))}})


def fleet_record(planner, plan, cold, state=None):
    """A plan's comparison record. Cold: the assignment and counts whole, every
    node's utility, 64 sampled nodes' floats. Incremental (``state`` the
    (assignment, n) before it): what changed, the re-solved nodes and theirs."""
    rec = {"diagnostics": {k: plan.diagnostics[k] for k in FLEET_DIAGS},
           "utility": plan.utility}
    if cold:
        sample = np.sort(np.random.default_rng(FLEET_SEED + 2).choice(
            planner.N, size=min(FLEET_SAMPLED, planner.N), replace=False))
        rec.update(assignment=plan.assignment, n=plan.n, node_utility=plan.node_utility,
                   sampled=node_floats(planner, sample.tolist()))
    else:
        assignment, n = state
        moved = np.flatnonzero(plan.assignment != assignment)
        recount = np.flatnonzero(plan.n != n)
        rec.update(moved={str(i): int(plan.assignment[i]) for i in moved},
                   recount={str(i): int(plan.n[i]) for i in recount})
    return plain(rec)


def fleet_parity(planner, engine, nodes, **solve_kw) -> float:
    """Max relative difference of the sampled nodes' rows from each node's
    standalone p1_solve_batch at max_servers = the fleet's Erlang width
    (benchmarks/fleet_placement.py's gate)."""
    worst = 0.0
    for j in nodes:
        on_j, apps, caps, n_row, c_hint = planner.node_problem(int(j))
        ref = engine.p1_solve_batch(
            engine.PackedApps.from_apps(apps), caps, n_row, planner.alpha, planner.beta,
            c_hint=c_hint, profile=planner.profile, max_servers=planner._width, **solve_kw)
        if not (planner.node_ok[j] and bool(ref.converged[0])):
            raise AssertionError(f"fleet: node {j} failed its standalone solve")
        c, m = planner.sol_c[on_j], planner.sol_m[on_j]
        worst = max(worst,
                    float(np.max(np.abs(ref.r_cpu[0] - c) / np.abs(c))),
                    float(np.max(np.abs(ref.r_mem[0] - m) / np.abs(m))),
                    abs(float(ref.utility[0]) - float(planner.node_utility[j]))
                    / abs(float(planner.node_utility[j])))
    return worst


def run_fleet(placement, n_nodes=FLEET_NODES, apps_per_node=FLEET_APPS, **planner_kw):
    """make_fleet, a cold plan and the incremental re-plan through
    ``placement``'s FleetPlanner: (planner, cold record, re-plan record,
    the re-plan's re-solved nodes, numbers)."""
    apps, node_caps = placement.make_fleet(n_nodes, apps_per_node, seed=FLEET_SEED)
    sync = functools.partial(_sync, planner_kw)
    sync()
    t0 = time.perf_counter()
    planner = placement.FleetPlanner(apps, node_caps, alpha=1.4, beta=0.2, **planner_kw)
    init_s = time.perf_counter() - t0
    plan = planner.plan()
    sync()
    cold_s = time.perf_counter() - t0 - init_s
    cold = fleet_record(planner, plan, cold=True)
    lam, migrations = fleet_drift(planner)
    touched = sorted({int(planner.assignment[planner._name_idx[a]]) for a in lam}
                     | {int(planner.assignment[planner._name_idx[migrations[0][0]]]),
                        migrations[0][1]})
    state = (planner.assignment.copy(), planner.n.copy())
    sol = [getattr(planner, k).copy() for k in ("sol_c", "sol_m", "sol_ws", "node_utility")]
    sync()
    t0 = time.perf_counter()
    replan = planner.replan(lam=lam, migrations=migrations)
    sync()
    incr_s = time.perf_counter() - t0
    incr = fleet_record(planner, replan, cold=False, state=state)
    incr.update(drift=lam, migrations=plain(migrations), touched=touched,
                touched_utility=plain(planner.node_utility[touched]),
                touched_nodes=node_floats(planner, touched))
    # only the touched nodes re-solved: every other node's state byte-identical
    others = ~np.isin(planner.assignment, touched) & ~np.isin(state[0], touched)
    same_nodes = ~np.isin(np.arange(planner.N), touched)
    for name, before, after in zip(("sol_c", "sol_m", "sol_ws"), sol[:3],
                                   (planner.sol_c, planner.sol_m, planner.sol_ws)):
        if before[others].tobytes() != after[others].tobytes():
            raise AssertionError(f"fleet: the re-plan changed {name} off the touched nodes")
    if sol[3][same_nodes].tobytes() != planner.node_utility[same_nodes].tobytes():
        raise AssertionError("fleet: the re-plan changed an untouched node's utility")
    if replan.diagnostics["nodes_solved"] != len(touched):
        raise AssertionError(f"fleet: the re-plan solved {replan.diagnostics['nodes_solved']} "
                             f"nodes, {len(touched)} touched")
    numbers = {"nodes": n_nodes, "apps": planner.A, "init_s": init_s, "cold_plan_s": cold_s,
               "plan_wall_clock_s": plan.diagnostics["wall_clock_s"],
               "incremental_s": incr_s, "rows_cold": planner.N,
               "rows_incremental": replan.diagnostics["nodes_solved"],
               "width": planner._width, "M_pad": planner.M_pad}
    return planner, cold, incr, numbers


def fleet_scenario_doc(api, **runner_kw):
    """benchmarks/fleet_placement.py:143-160's migration trace: 16 nodes x 8
    apps, 4 epochs, λ x1.25 at epoch 1, app00001 to the last node at epoch 2,
    3 nodes a epoch validated through the vector engine."""
    n_nodes, m = FLEET_SCENARIO
    sc = api.FleetScenario.from_fleet(
        "fleet_migration", n_nodes, m, seed=0, n_epochs=4,
        events=(api.LambdaScale(1, 1.25), api.AppMigrate(2, "app00001", n_nodes - 1)),
        validate_nodes=3)
    return api.FleetScenarioRunner(sc, epoch_s=40.0, **runner_kw).run()


def check_fleet(golden, planner, cold, incr, engine, **solve_kw):
    """The port's fleet records against the reference's, and the parity gate."""
    ref = golden["plan"]
    for key in ("assignment", "n"):
        if cold[key] != ref[key]:
            bad = np.flatnonzero(np.asarray(cold[key]) != np.asarray(ref[key]))
            raise AssertionError(f"fleet: {key} differs from the reference at {bad[:10]}")
    assert_same(ref, cold, "fleet.plan")
    assert_same(golden["replan"], incr, "fleet.replan")
    sample = np.random.default_rng(FLEET_SEED + 3).choice(planner.N, PARITY_NODES,
                                                          replace=False)
    parity = fleet_parity(planner, engine, sample, **solve_kw)
    if not parity <= PARITY_TOL:
        raise AssertionError(f"fleet: node parity {parity:.3e} > {PARITY_TOL}")
    return parity


def baselines_phase():
    """Phase 19: the Figs. 11-14 comparison, the search-sized scoring, the fleet
    at 1000 x 16 and the migration scenario on the card, against the
    reference's records; crms_grid counted from zero."""
    from repro_torch import api
    from repro_torch.core import engine, placement, problem, profiler
    from repro_torch.kernels import crms_grid

    golden = json.loads(BASELINES_GOLDEN.read_text())
    fleet_golden = json.loads(FLEET_GOLDEN.read_text())
    t_phase = time.perf_counter()
    crms_grid.launches = 0

    # (a) Figs. 11-14
    records, walls, peaks = run_baselines(api, problem, profiler)
    assert_same(golden["fig11_14"], records, "baselines")
    red = reductions_pct(records)
    log("baselines", wall_s=walls, random_search_peak_bytes=peaks,
        reduction_pct=red, mean_latency_s={k: mean_latency_s(r) for k, r in records.items()},
        drf_stable=records["drf"]["stable"])
    if min(red.values()) < MIN_REDUCTION_PCT:
        raise AssertionError(f"baselines: CRMS cuts latency by {red} %, < {MIN_REDUCTION_PCT}")

    # (b) search-sized scoring
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search = search_record(api, profiler)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    assert_same(golden["search_mix16"], search, "baselines.search_mix16")
    log("baselines", case="random_search_mix16", lanes=RS_SAMPLES * SEARCH_M, width=512,
        wall_s=search_s, peak_bytes=torch.cuda.max_memory_allocated())

    # (c) the fleet at the reference's full size
    planner, cold, incr, numbers = run_fleet(placement)
    parity = check_fleet(fleet_golden, planner, cold, incr, engine)
    rows = fleet_rows(planner)  # phase 22 holds its mesh row solve to these
    _, kernels, copies, busy_ms, wall_ms = profile_device(
        lambda: planner._solve_nodes(range(planner.N)))
    log("fleet", **numbers, parity_max_rel=parity, exchange_accepted=cold["diagnostics"][
        "exchange_accepted"], solve_rows=planner.N, solve_device_kernels=kernels,
        solve_copies=copies, solve_device_busy_ms=busy_ms, solve_wall_ms=wall_ms)

    # (d) the migration scenario, the vector engine on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc = fleet_scenario_doc(api)
    scenario_s = time.perf_counter() - t0
    assert_same(fleet_golden["scenario"], plain(doc), "fleet.scenario")
    log("fleet-scenario", wall_s=scenario_s, **{k: doc["summary"][k] for k in (
        "replan_time_s_mean", "nodes_solved_mean", "migrations_total",
        "validation_gap_rel_mean", "all_nodes_ok")})

    launches = crms_grid.launches
    wall = time.perf_counter() - t_phase
    res = {"launches": launches, "phase_wall_s": wall, "fleet_rows": rows}
    log("baselines", crms_grid_launches=launches, phase_wall_s=wall)
    if launches == 0:
        raise AssertionError("baselines: the crms solve never launched the crms_grid kernel")
    if wall > BASELINES_LIMIT_S:
        raise AssertionError(f"baselines: the phase took {wall:.1f} s > {BASELINES_LIMIT_S} s")
    return res


# ----------------------------------------------------------------------------
# The TPU-fleet binding (phase 20)
# ----------------------------------------------------------------------------
FLEET_BINDING_GOLDEN = ROOT / "tests" / "data" / "torch_fleet_binding_golden.json"
FLEET_CHIPS = 256
FLEET_ALPHA, FLEET_BETA = 1.4, 0.2  # FleetManager's defaults (paper §VI)
FLEET_DRIFT = (1.03, 1.6)  # observed in turn: below, then past the 0.15 threshold
FIT_RMSE_REL = 2e-3  # a fit's rmse at most this far (relative) above the reference's
FIT_SURFACE_REL = 5e-2  # a fitted surface within this of the reference's on the box
FIT_GRID = 64  # the box's grid: c in [1, 256] chips, m in [r_min, r_max] GB
OWN_FIT_UTILITY_RTOL = 1e-4  # the plan on the port's own fit
# Records on the reference's κ. Eq. (1) evaluates 1 - exp(-κ₂c) with κ₂c
# down to ~5e-15 (gemma-2b, mamba2-130m at one chip), where one ulp of exp
# moves d by up to ~2e-2 relative; the reference's exp (XLA's) and torch's
# differ by one ulp on about a tenth of such arguments. Two checks:
# - the port's evaluation at the reference's quotas: each app's Ws and the
#   utility within their rounding envelope, how far moving every app's
#   1 - exp(-κ₂c) by EXP_ULPS ulps either way moves them (at least
#   EVAL_FLOOR, the rest of the evaluation's rounding);
# - the port's own solve: counts, flags and counters exactly, the utility
#   within FLEET_UTILITY_RTOL, quotas and the replica groups' chips and HBM
#   within FLEET_FLOAT_RTOL, each Ws within that or its envelope, batch
#   slots within that share plus one. The largest gaps measured: utility
#   7.5e-6 and quotas 1.7e-2 on the CPU, 1.8e-6 and 1.5e-2 on an H100 (a
#   solve's rounding moves the flat directions of P1; ROADMAP Queue 3).
EXP_ULPS = 2  # one ulp of each package's exp
EVAL_FLOOR = 1e-9
FLEET_UTILITY_RTOL = 2e-5
FLEET_FLOAT_RTOL = 5e-2
FLEET_BINDING_LIMIT_S = 90.0


def load_script(relpath):
    """A script of the checkout (an example or a benchmark) as a module."""
    import importlib.util

    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def eq1_np(kappa, c, m):
    """Eq. (1) in NumPy float64, 1 - exp(-κ₂c) as -expm1: κ₂c reaches ~5e-15
    on the fleet's box, where the subtraction keeps about two digits."""
    k1, k2, k3 = kappa
    return k1 / -np.expm1(-k2 * np.asarray(c, float)) + np.exp(k3 / np.asarray(m, float))


def fit_rmse(kappa, profile):
    """A fleet fit's rmse on its profile data (the quantity fit_family
    minimizes), from κ alone."""
    resid = eq1_np(kappa, profile["cs"], profile["ms"]) - np.asarray(profile["d"])
    return float(np.sqrt(np.mean(resid ** 2)))


def fit_surface(kappa, app):
    """Eq. (1) at ``kappa`` on the FIT_GRID x FIT_GRID grid of the app's box."""
    c = np.linspace(1.0, app["cpu_max"], FIT_GRID)[:, None]
    m = np.linspace(app["r_min"], app["r_max"], FIT_GRID)[None, :]
    return eq1_np(kappa, c, m)


def fleet_plan_record(alloc, groups, diagnostics=None) -> dict:
    """The comparison record of a FleetManager plan: the allocation, the
    replica groups and, when given, the solve's counters."""
    record = {"n": alloc.n, "r_cpu": alloc.r_cpu, "r_mem": alloc.r_mem, "ws": alloc.ws,
              "utility": alloc.utility, "feasible": alloc.feasible, "stable": alloc.stable,
              "groups": [[g.arch, g.chips, g.hbm_gb, g.batch_slots] for g in groups]}
    if diagnostics is not None:
        record.update({key: getattr(diagnostics, key) for key in (
            "refine_iters", "accepted_moves", "p1_calls", "p1_masked_rows")})
    return plain(record)


def rounding_envelope(apps, record, caps, device=None):
    """The port's Ws and utility at ``record``'s quotas on ``device``, and
    how far moving each app's 1 - exp(-κ₂c) by EXP_ULPS ulps (of the doubles
    just below 1) either way moves them, relative and at least EVAL_FLOOR:
    (ws, utility, ws bars, utility bar), non-finite values as None."""
    from repro_torch.core.problem import utility

    def at(sign):
        bent = [dataclasses.replace(a, kappa=(a.kappa[0], a.kappa[1] + sign * EXP_ULPS
                                              * 2.0 ** -53 / c, a.kappa[2]))
                for a, c in zip(apps, record["r_cpu"])]
        u, ws, _ = utility(bent, record["n"], record["r_cpu"], record["r_mem"], caps,
                           FLEET_ALPHA, FLEET_BETA, device=device)
        return np.asarray(ws.tolist() + [u])

    values = at(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        env = np.maximum(np.abs(at(1) / values - 1), np.abs(at(-1) / values - 1))
    bars = [max(EVAL_FLOOR, float(e)) if np.isfinite(v) else None for v, e in zip(values, env)]
    values = plain(values)
    return values[:-1], values[-1], bars[:-1], bars[-1]


def check_fleet_eval(ref, apps, caps, path, device=None):
    """The port's evaluation at the reference's quotas: each app's Ws and
    the utility within their rounding envelope of the reference's, the
    non-finite ones on the same apps. Returns (the Ws bars, the largest
    gaps and the largest gap's share of its bar)."""
    ws, u, ws_bars, u_bar = rounding_envelope(apps, ref, caps, device)
    gaps = {"ws": 0.0, "utility": None, "of_bar": 0.0}
    names = [a.name for a in apps] + ["utility"]
    for name, r, g, bar in zip(names, ref["ws"] + [ref["utility"]], ws + [u], ws_bars + [u_bar]):
        if (r is None) != (g is None):
            raise AssertionError(f"{path}: {name} evaluated at the reference's quotas: {g!r} != "
                                 f"reference {r!r}")
        if r is None:
            continue
        gap = abs(g / r - 1)
        if not gap <= bar:
            raise AssertionError(f"{path}: {name} evaluated at the reference's quotas: {g!r} != "
                                 f"reference {r!r} ({gap:.3g} > its rounding envelope {bar:.3g})")
        if name == "utility":
            gaps["utility"] = gap
        else:
            gaps["ws"] = max(gaps["ws"], gap)
        gaps["of_bar"] = max(gaps["of_bar"], gap / bar)
    return ws_bars, gaps


def check_fleet_record(ref, got, path, apps, caps, device=None):
    """A plan or baseline record ``got`` of the port on the reference's κ
    (``apps``, at the record's λ) against the reference's ``ref``: the
    port's evaluation at the reference's quotas (check_fleet_eval on
    ``device``); counts, flags, counters, the replica groups' archs and
    which floats are non-finite exactly; the utility within
    FLEET_UTILITY_RTOL; quotas and the groups' chips and HBM within
    FLEET_FLOAT_RTOL, each Ws within that or its rounding envelope, batch
    slots within that share plus one. Returns the largest gaps."""
    if set(got) != set(ref):
        raise AssertionError(f"{path}: keys {sorted(got)} != reference {sorted(ref)}")
    ws_bars, gaps = check_fleet_eval(ref, apps, caps, path, device)
    floats = ("utility", "r_cpu", "r_mem", "ws", "groups")
    assert_same({k: v for k, v in ref.items() if k not in floats},
                {k: v for k, v in got.items() if k not in floats}, path)
    if ref["utility"] is None or got["utility"] is None:
        assert_same(ref["utility"], got["utility"], f"{path}.utility")
    else:
        assert_same(ref["utility"], got["utility"], f"{path}.utility", FLEET_UTILITY_RTOL)
    gap = 0.0
    for key in ("r_cpu", "r_mem"):
        assert_same(ref[key], got[key], f"{path}.{key}", FLEET_FLOAT_RTOL)
        gap = max([gap] + [abs(g / r - 1) for r, g in zip(ref[key], got[key])])
    for i, (r, g, bar) in enumerate(zip(ref["ws"], got["ws"], ws_bars)):
        if r is None or g is None:
            assert_same(r, g, f"{path}.ws[{i}]")
        else:
            assert_same(r, g, f"{path}.ws[{i}]", max(FLEET_FLOAT_RTOL, bar))
            gap = max(gap, abs(g / r - 1))
    if "groups" in ref:
        if len(got["groups"]) != len(ref["groups"]):
            raise AssertionError(f"{path}: {len(got['groups'])} replica groups, reference "
                                 f"{len(ref['groups'])}")
        for i, (r, g) in enumerate(zip(ref["groups"], got["groups"])):
            assert_same(r[:3], g[:3], f"{path}.groups[{i}]", FLEET_FLOAT_RTOL)
            if not abs(g[3] - r[3]) <= FLEET_FLOAT_RTOL * r[3] + 1:
                raise AssertionError(f"{path}.groups[{i}]: {g[3]} batch slots, reference {r[3]}")
    return {"float_gap": gap, "utility_gap": (None if ref["utility"] is None else
                                              abs(got["utility"] / ref["utility"] - 1)),
            **{f"eval_{k}_gap": v for k, v in gaps.items()}}


def fleet_plan(fm):
    """``fm.plan()``: (its record, wall clock, crms_grid launches; the
    launches count only on the card, and a re-optimized plan launches at
    least one a refinement iteration)."""
    from repro_torch.kernels import crms_grid

    kw = {"device": fm.device}
    before = crms_grid.launches
    _sync(kw)
    t0 = time.perf_counter()
    alloc, groups = fm.plan()
    _sync(kw)
    wall = time.perf_counter() - t0
    record = fleet_plan_record(alloc, groups, fm.last_result.diagnostics)
    launches = crms_grid.launches - before
    solved = not fm.last_result.diagnostics.cache_hit
    if _on_card(kw) and solved and launches < record["refine_iters"]:
        raise AssertionError(f"fleet: {launches} crms_grid launches < "
                             f"{record['refine_iters']} refinement iterations")
    return record, wall, launches


def fleet_binding_drift(fm):
    """Observe FLEET_DRIFT in turn and plan after each: ([re-optimized per
    step], the last plan's record, its wall clock and crms_grid launches)."""
    flags = []
    for scale in FLEET_DRIFT:
        fm.observe({a.name: a.lam * scale for a in fm.apps})
        before = fm.allocator.reoptimizations
        record, wall, launches = fleet_plan(fm)
        flags.append(fm.allocator.reoptimizations > before)
    return flags, record, wall, launches


def check_fleet_fit(golden, fm, fleet):
    """(a) the workloads and the profile data equal the reference's bit for
    bit; each of ``fm``'s fits within FIT_RMSE_REL of the reference's rmse
    and FIT_SURFACE_REL of its surface. Returns {name: (rmse excess, surface
    gap)}."""
    workloads = [plain(dataclasses.asdict(w)) for w in fleet.default_workloads()]
    if workloads != golden["workloads"]:
        raise AssertionError("fleet: default_workloads() differs from the reference's")
    out = {}
    for i, (w, ref_app, app) in enumerate(zip(fm.workloads, golden["apps"], fm.apps)):
        profile = golden["profiles"][i]
        cs, ms, d = fleet.profile_workload(w, seed=i)
        if [cs.tolist(), ms.tolist(), d.tolist()] != [profile["cs"], profile["ms"], profile["d"]]:
            raise AssertionError(f"fleet: {w.name}'s profile data differ from the reference's")
        ref_rmse = fit_rmse(ref_app["kappa"], profile)
        excess = (fit_rmse(app.kappa, profile) - ref_rmse) / ref_rmse
        want = fit_surface(ref_app["kappa"], ref_app)
        gap = float(np.max(np.abs(fit_surface(app.kappa, ref_app) - want) / np.abs(want)))
        out[w.name] = (excess, gap)
        if not (excess <= FIT_RMSE_REL and gap <= FIT_SURFACE_REL):
            raise AssertionError(f"fleet: {w.name}'s fit: rmse {excess:+.3g} relative to the "
                                 f"reference's (bar {FIT_RMSE_REL}), surface gap {gap:.3g} "
                                 f"(bar {FIT_SURFACE_REL})")
    return out


def check_own_plan(golden, record, caps):
    """(c) a plan on the port's own fit: the reference's counts, utility
    within OWN_FIT_UTILITY_RTOL, and tests/test_fleet_engine.py's asserts."""
    ref = golden["plan"]
    n = np.asarray(record["n"])
    if record["n"] != ref["n"]:
        raise AssertionError(f"fleet: own-fit counts {record['n']} != reference {ref['n']}")
    if not abs(record["utility"] - ref["utility"]) <= OWN_FIT_UTILITY_RTOL * abs(ref["utility"]):
        raise AssertionError(f"fleet: own-fit utility {record['utility']} != reference "
                             f"{ref['utility']} (rtol {OWN_FIT_UTILITY_RTOL})")
    total_cpu = float(np.sum(n * np.asarray(record["r_cpu"])))
    total_mem = float(np.sum(n * np.asarray(record["r_mem"])))
    if not (total_cpu <= caps.r_cpu * 1.001 and total_mem <= caps.r_mem * 1.001):
        raise AssertionError(f"fleet: the plan takes {total_cpu} chips, {total_mem} GB")
    groups = record["groups"]
    if len(groups) != int(n.sum()) or not all(g[3] >= 1 for g in groups):
        raise AssertionError(f"fleet: {len(groups)} replica groups for N = {n.tolist()}")


def run_fleet_binding(golden, device=None):
    """(a)-(d) on ``device`` (None: the CUDA device): the fit of
    FleetManager(n_chips=256), the plan on the port's own fit, the plan on
    the reference's κ (put in after construction, as observe does, with the
    quasi-dynamic cache reset), and the drift sequence from there. Returns
    (own-fit record, numbers)."""
    from repro_torch.core import fleet
    from repro_torch.core.engine import PackedApps
    from repro_torch.core.problem import App
    from repro_torch.serve.fleet import FleetManager

    _sync({"device": device})
    t0 = time.perf_counter()
    fm = FleetManager(n_chips=FLEET_CHIPS, device=device)
    _sync({"device": device})
    fit_s = time.perf_counter() - t0
    fits = check_fleet_fit(golden, fm, fleet)

    # (c) the plan on the port's own fit
    own, own_s, _ = fleet_plan(fm)
    check_own_plan(golden, own, fm.caps)

    # (b) the plan on the reference's κ, cold
    fm.apps = [App(**{**a, "kappa": tuple(a["kappa"])}) for a in golden["apps"]]
    fm.packed = PackedApps.from_apps(fm.apps)
    fm.allocator.reset()
    plan, plan_s, plan_launches = fleet_plan(fm)
    plan_gaps = check_fleet_record(golden["plan"], plan, "fleet.plan", fm.apps, fm.caps, device)

    # (d) drift: x1.03 stays on the cached plan, x1.6 re-plans (warm)
    flags, drifted, replan_s, replan_launches = fleet_binding_drift(fm)
    if flags != golden["drift"]["reoptimized"]:
        raise AssertionError(f"fleet: re-optimized {flags} under drift {FLEET_DRIFT}, "
                             f"reference {golden['drift']['reoptimized']}")
    replan_gaps = check_fleet_record(golden["drift"]["plan"], drifted, "fleet.drift", fm.apps,
                                     fm.caps, device)
    numbers = {"fit_s": fit_s, "own_fit_plan_s": own_s, "cold_plan_s": plan_s,
               "replan_s": replan_s, "refine_iters": plan["refine_iters"],
               "replan_refine_iters": drifted["refine_iters"],
               "plan_crms_grid_launches": plan_launches,
               "replan_crms_grid_launches": replan_launches,
               "fit_rmse_excess_max": max(e for e, _ in fits.values()),
               "fit_surface_gap_max": max(g for _, g in fits.values()),
               "own_fit_utility": own["utility"], "plan_utility": plan["utility"],
               "reference_utility": golden["plan"]["utility"], "plan_gaps": plan_gaps,
               "replan_gaps": replan_gaps}
    return own, numbers


def check_fleet_launchers(own, device=None):
    """(e) ``launch.serve --plan`` and examples_torch/serve_multitenant on
    ``device``: both plans equal the own-fit plan ``own``, the drift flags
    [False, True], and both reduced tenants finish every request with
    in-vocabulary tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    argv = [] if device is None else ["--device", str(device)]
    fm, alloc, groups = serve.main(["--plan", *argv])
    assert_same(own, fleet_plan_record(alloc, groups, fm.last_result.diagnostics),
                "fleet.launcher")
    demo = load_script("examples_torch/serve_multitenant.py")
    out = demo.main(argv)
    got = fleet_plan_record(out["alloc"], out["groups"])
    assert_same({key: own[key] for key in got}, got, "serve_multitenant.plan")
    if out["reoptimized"] != [False, True]:
        raise AssertionError(f"serve_multitenant: re-optimized {out['reoptimized']}")
    for arch in demo.TENANTS:
        vocab = get_config(arch).reduced().vocab
        served = out["served"][arch]
        if sorted(served) != [0, 1, 2] or not all(
                len(t) == 6 and all(0 <= x < vocab for x in t) for t in served.values()):
            raise AssertionError(f"serve_multitenant: {arch} served {served}")
    return {"replica_groups": len(groups),
            "tenant_requests": {arch: len(out["served"][arch]) for arch in demo.TENANTS}}


def check_fleet_tpu(golden, device=None):
    """(f) benchmarks_torch/fleet_tpu.py's comparison on the reference's κ:
    the records equal the reference's, CRMS's mean latency <= both
    baselines'. Returns the mean latencies and wall clocks."""
    from repro_torch.core import fleet
    from repro_torch.core.problem import App

    bench = load_script("benchmarks_torch/fleet_tpu.py")
    apps = [App(**{**a, "kappa": tuple(a["kappa"])}) for a in golden["apps"]]
    caps = fleet.pod_caps(FLEET_CHIPS)
    records, walls = bench.compare(apps, caps, device=device)
    if set(records) != set(golden["fleet_tpu"]):
        raise AssertionError(f"fleet_tpu: policies {sorted(records)}")
    gaps = {key: check_fleet_record(golden["fleet_tpu"][key], records[key], f"fleet_tpu.{key}",
                                    apps, caps, device) for key in records}
    latency = {key: bench.mean_latency(apps, r) for key, r in records.items()}
    if not latency["crms"] <= min(latency["random_search"], latency["tpebo"]):
        raise AssertionError(f"fleet_tpu: CRMS's mean latency is not the lowest: {latency}")
    return {"mean_latency_s": latency, "wall_s": walls, "gaps": gaps}


def fleet_binding_phase():
    """Phase 20: the TPU-fleet binding on the card against the reference's
    records; crms_grid counted from zero."""
    from repro_torch.kernels import crms_grid

    golden = json.loads(FLEET_BINDING_GOLDEN.read_text())
    t_phase = time.perf_counter()
    crms_grid.launches = 0
    own, numbers = run_fleet_binding(golden)
    log("fleet-binding", **numbers)
    launchers = check_fleet_launchers(own)
    tpu = check_fleet_tpu(golden)
    launches = crms_grid.launches
    wall = time.perf_counter() - t_phase
    log("fleet-binding", **launchers, **tpu, crms_grid_launches=launches, phase_wall_s=wall)
    if wall > FLEET_BINDING_LIMIT_S:
        raise AssertionError(f"fleet: the phase took {wall:.1f} s > {FLEET_BINDING_LIMIT_S} s")
    return {"launches": launches,
            "refine_iters": numbers["refine_iters"] + numbers["replan_refine_iters"],
            "phase_wall_s": wall}

# ----------------------------------------------------------------------------
# The mesh (phase 22)
# ----------------------------------------------------------------------------
MESH_WORLD = 4  # ranks, all on the one card, joined by gloo
MESH_LIMIT_S = 150.0
MESH_BAR = 3e-2  # logits, relative to the single rank's max |logit| (bf16)
MESH_STEPS = 16  # gemma-2b's decode steps
MOE_LAYERS_CUT = 4  # moonshot-v1-16b-a3b's depth on the mesh
MOE_MESH_STEPS = 8  # its decode steps at batch 2
MOE_TOL = dict(atol=1e-5, rtol=1e-4)
ROWS_TOL = 1e-9  # the mesh row solve against the single rank's (tests/test_torch_rows.py)


def full_model(cfg, device, dtype=torch.bfloat16):
    """``cfg`` with random weights from the seeded generator on ``device``
    (every rank draws the same)."""
    from repro_torch.models.model import init_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    return init_params(cfg, gen, dtype, device)


def mesh_config(arch, reduced=False):
    """``arch`` at full width (its depth cut for moonshot-v1-16b-a3b, to
    MOE_LAYERS_CUT), or its reduced variant for a CPU rehearsal. The MoE runs
    dropless (cf = E / top_k): capacity drops differ between the modes by
    construction (a2a's capacity is per model rank's block of tokens)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    if arch == MOE_ARCH:
        cfg = dataclasses.replace(cfg, moe_cf=cfg.moe.n_experts / cfg.moe.top_k,
                                  n_layers=cfg.n_layers if reduced else MOE_LAYERS_CUT)
    return cfg


def mesh_size(reduced=False):
    """Phase 22's batch, prompt and step counts (a CPU rehearsal's are small)."""
    if reduced:
        return {"slots": SLOTS, "prompt": 32, "steps": 4, "moe_steps": 3}
    return {"slots": SLOTS, "prompt": PROMPT_LEN, "steps": MESH_STEPS,
            "moe_steps": MOE_MESH_STEPS}


def last_logits(logits):
    """The last position's logits (B, V) as float32 on the host, whole."""
    from repro_torch.models.layers import last_position, whole

    return whole(last_position(logits))[:, 0, :].float().cpu()


def logits_err(got, want, what):
    err = float((got - want).abs().max() / want.abs().max())
    if not (torch.isfinite(got).all() and err < MESH_BAR):
        raise AssertionError(f"mesh {what}: logits off the single rank's by {err} "
                             f"(bar {MESH_BAR})")
    return err


def decode_run(lm, cfg, rt, prompts, max_len, steps, tokens=None):
    """A prefill that fills the cache (apply_decode at index 0) and ``steps``
    decode steps fed ``tokens`` (teacher forcing) or the greedy ones; returns
    (logits (steps + 1, B, V), tokens (steps + 1, B))."""
    from repro_torch.models.model import apply_decode, init_cache

    B, S = prompts.shape
    caches = init_cache(cfg, rt, B, max_len, dtype=rt.compute_dtype)
    lg, caches = apply_decode(lm, cfg, rt, prompts, caches, 0)
    logits = [last_logits(lg)]
    fed = [logits[0].argmax(-1) if tokens is None else tokens[0]]
    for t in range(steps):
        lg, caches = apply_decode(lm, cfg, rt, fed[t].to(rt.device)[:, None], caches, S + t)
        logits.append(last_logits(lg))
        fed.append(logits[-1].argmax(-1) if tokens is None else tokens[t + 1])
    return torch.stack(logits), torch.stack(fed)


def mesh_references(device="cuda", reduced=False):
    """The single-rank runs (on ``device``, the same weights) that phase 22's
    parts are held to: gemma-2b's prefill and greedy decode, mamba2-130m's
    prefill, the cut moonshot's prefill and decode with their routes."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import apply_lm

    size = mesh_size(reduced)
    B, S = size["slots"], size["prompt"]
    rt = Runtime(device, torch.bfloat16, "auto")
    refs = {}
    with torch.inference_mode():
        cfg = mesh_config(FULL_ARCH, reduced)
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S))
        lm = full_model(cfg, device)
        refs["gemma"] = dict(zip(("logits", "tokens"), decode_run(
            lm, cfg, rt, torch.as_tensor(prompts), S + size["steps"], size["steps"])))
        refs["gemma"]["prompts"] = prompts
        del lm
        free_card_if(device)
        cfg = mesh_config(SSM_ARCH, reduced)
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S))
        lm = full_model(cfg, device)
        refs["mamba"] = {"prompts": prompts,
                         "logits": last_logits(apply_lm(lm, cfg, rt, prompts)[0])}
        del lm
        free_card_if(device)
        cfg = mesh_config(MOE_ARCH, reduced)
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (B, S))
        lm = full_model(cfg, device)
        with MOE.recording_routes() as routes:
            prefill = last_logits(apply_lm(lm, cfg, rt, prompts)[0])
            dec_logits, dec_tokens = decode_run(lm, cfg, rt, torch.as_tensor(prompts[:2]),
                                                S + size["moe_steps"], size["moe_steps"])
        refs["moonshot"] = {"prompts": prompts, "prefill": prefill, "logits": dec_logits,
                            "tokens": dec_tokens, "routes": [r.cpu() for r in routes]}
        del lm
    free_card_if(device)
    return refs


class Clock:
    """Seconds since the last call (the device synchronised first)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.t = time.perf_counter()

    def __call__(self):
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


C10D_CALLS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "barrier")


@contextlib.contextmanager
def c10d_calls():
    """Counts the c10d collectives issued inside (``torch.distributed``'s
    functions, wrapped meanwhile; every collective of the port goes through
    them): yields {name: [calls, input bytes]}. Unlike CommDebugMode, which
    intercepts every tensor operation, it costs nothing per operation."""
    import torch.distributed as dist

    counts = {}
    originals = {name: getattr(dist, name) for name in C10D_CALLS}

    def counted(name, fn):
        def call(*args, **kwargs):
            t = args[1] if name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                                    "all_to_all_single") else (args[0] if args else None)
            entry = counts.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def mesh_part(record, name, device):
    """Times one part on this rank, counts its collectives (``c10d_calls``'
    calls and bytes) and its peak memory; adds {"s", "collectives",
    "peak_gb"} to ``record[name]``."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = record.setdefault(name, {})
    t0 = time.perf_counter()
    with c10d_calls() as comm:
        yield out
    if cuda:
        torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    out["collectives"] = {k: {"calls": n, "gb": b / 1e9} for k, (n, b) in comm.items()}
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def kernel_calls():
    """The shapes at which the code run inside calls the flash and SSD
    kernels' ops (``ops.flash_attention`` and ``ops.ssd_chunks``, wrapped
    meanwhile; the kernels' launch counts are untouched): {"flash": {(B, Sq,
    Skv, KV, G, hd, causal, dtype, offset)}, "ssd": {(B, S, H, P, N,
    chunk)}}, the arguments of ``check_flash`` and ``check_ssd``."""
    from repro_torch.kernels import ops

    calls = {"flash": set(), "ssd": set()}
    flash, ssd_chunks = ops.flash_attention, ops.ssd_chunks

    def flash_call(q, k, v, causal=True, backend="auto", offset=0):
        B, Sq, KV, G, hd = q.shape
        calls["flash"].add((B, Sq, k.shape[1], KV, G, hd, bool(causal), q.dtype, int(offset)))
        return flash(q, k, v, causal=causal, backend=backend, offset=offset)

    def ssd_call(xh, bmat, cmat, da, chunk=128, backend="auto"):
        calls["ssd"].add((*xh.shape, bmat.shape[-1], chunk))
        return ssd_chunks(xh, bmat, cmat, da, chunk=chunk, backend=backend)

    ops.flash_attention, ops.ssd_chunks = flash_call, ssd_call
    try:
        yield calls
    finally:
        ops.flash_attention, ops.ssd_chunks = flash, ssd_chunks


def check_kernel_calls(calls):
    """Each kernel against its plain version at every shape (and causal
    offset) in ``calls`` (``kernel_calls``), with phases 6's and 9's bars;
    returns [{"kernel", "shape", "offset", "max_abs_err"}]."""
    checks = []
    for B, Sq, Skv, KV, G, hd, causal, dtype, offset in sorted(calls["flash"], key=str):
        res = check_flash(B, Sq, Skv, KV, G, hd, causal, dtype, offset=offset)
        checks.append({"kernel": "flash_attention", "shape": res["shape"], "offset": offset,
                       "max_abs_err": res["max_abs_err"]})
    for shape in sorted(calls["ssd"]):
        res = check_ssd(*shape)
        checks.append({"kernel": "ssd_chunk", "shape": res["shape"], "offset": 0,
                       "max_abs_err": res["max_abs_err"]})
    return checks


def mesh_checks(recs, kernel, parts=None):
    """The ranks' checks of ``kernel`` (``check_kernel_calls``) in ``parts``
    (default: phase 22's), one entry a (shape, offset) with the largest error
    over the ranks."""
    worst = {}
    for rec in recs:
        for part in parts or MESH_PARTS:
            for c in rec.get(part, {}).get("kernel_checks", ()):
                if c["kernel"] == kernel:
                    key = (c["shape"], c["offset"])
                    worst[key] = max(worst.get(key, 0.0), c["max_abs_err"])
    return [{"shape": shape, "offset": off, "max_abs_err": err}
            for (shape, off), err in sorted(worst.items())]


def place_module(module, mesh, model_only=False):
    """A lone module's parameters on ``mesh`` by the sharding rules."""
    from torch import nn

    from repro_torch.models.layers import distribute
    from repro_torch.sharding.rules import leaf_spec, placements

    for name, param in list(module.named_parameters()):
        spec = leaf_spec((name,), tuple(param.shape), mesh, model_only=model_only)
        mod_name, _, leaf = name.rpartition(".")
        mod = module.get_submodule(mod_name)
        mod._parameters[leaf] = nn.Parameter(distribute(param.data, mesh,
                                                        placements(spec, mesh)))
    return module


def moe_blocks(cfg, device, mesh, seed=SEED):
    """The MoE block with float32 weights seeded on ``device`` (the same on
    every rank), whole, and a copy laid out on ``mesh`` in the serving layout
    (each model rank its E / n experts, so no case moves a weight)."""
    import copy

    from repro_torch.models import moe as MOE

    block = MOE.MoE(cfg, device, torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * p.shape[-2] ** -0.5)
    return block, place_module(copy.deepcopy(block), mesh, model_only=True)


def mesh_moe_case(cfg, blocks, device, mesh, B, S, cf, seed=SEED):
    """The MoE block on ``mesh`` against its ``local`` mode on one rank, the
    same weights (``moe_blocks``) and the same given expert ids, on seeded
    inputs. Returns (mode, the mesh output, the local one at this rank's rows,
    the dropped (token, slot) share of the mesh run and of the local run)."""
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import Runtime, batch_rows

    E, k = cfg.moe.n_experts, cfg.moe.top_k
    block, placed = blocks
    gen = torch.Generator(device=device).manual_seed(seed + B * S)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    rng = np.random.default_rng(seed + B * S)
    ids = torch.as_tensor(np.argsort(rng.random((B, S, E)), axis=-1)[..., :k], device=device)
    rt = make_runtime(cfg, mesh, compute_dtype=torch.float32)
    rows = batch_rows(rt, B)
    with MOE.replaying_routes([ids]):
        want, _ = MOE.apply_moe(block, x, cfg, Runtime(device, torch.float32), cf=cf)
    with MOE.replaying_routes([ids]):
        got, _ = MOE.apply_moe(placed, x[rows], cfg, rt, cf=cf, batch=B)
    C = MOE._capacity(B * S, k, E, cf)
    local_dropped = float((MOE._dispatch_positions(ids.reshape(-1), E) >= C).float().mean())
    return (MOE.moe_mode(cfg, rt, B, S), got, want[rows], moe_dropped(cfg, rt, ids, B, S, cf),
            local_dropped)


def moe_dropped(cfg, rt, ids, B, S, cf):
    """The share of (token, slot) pairs past their expert's capacity in the
    mesh dispatch of ``ids`` (B, S, k) (this rank's share of it)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import batch_rows, model_rank

    from repro_torch.launch.mesh import mesh_shape

    E, k = cfg.moe.n_experts, cfg.moe.top_k
    n, j = rt.model_axis_size, model_rank(rt)
    mine = ids[batch_rows(rt, B)].reshape(-1, k)
    if MOE.moe_mode(cfg, rt, B, S) == "a2a":
        t_my = len(mine) // n
        pos = MOE._dispatch_positions(mine[j * t_my:(j + 1) * t_my].reshape(-1), E)
        return float((pos >= MOE._capacity(t_my, k, E, cf)).float().mean())
    E_loc = E // n
    loc = mine - j * E_loc
    is_mine = (loc >= 0) & (loc < E_loc)
    pos = MOE._dispatch_positions(torch.where(is_mine, loc, 0).reshape(-1), E_loc)
    data_shards = math.prod(mesh_shape(rt.mesh)[a] for a in rt.data_axes)
    C = MOE._capacity(max(B // data_shards, 1) * S, k, E, cf)
    return float(((pos >= C) & is_mine.reshape(-1)).float().sum() / max(int(is_mine.sum()), 1))


def part_fleet(out, ctx):
    """(a) the fleet's row solve on a (4,) "nodes" mesh: the cold plan and the
    first re-plan against the reference's records (phase 19's bars) and
    within ROWS_TOL of the single rank's rows."""
    from repro_torch.core import engine, placement

    planner, cold, incr, numbers = run_fleet(placement, device=ctx["device"],
                                             mesh=ctx["nodes"])
    check_fleet(ctx["fleet_golden"], planner, cold, incr, engine, device=ctx["device"])
    ref = ctx["refs"]["fleet"]
    out["rows_rel_diff"] = max(
        float(np.max(np.abs(getattr(planner, key) - ref[key])
                     / np.maximum(np.abs(ref[key]), 1e-300)))
        for key in ("sol_c", "sol_m", "sol_ws", "node_utility"))
    if not out["rows_rel_diff"] <= ROWS_TOL:
        raise AssertionError(f"mesh fleet: rows off the single rank's by {out['rows_rel_diff']}")
    out.update(cold_plan_s=numbers["cold_plan_s"], incremental_s=numbers["incremental_s"])


def part_moe(out, ctx):
    """(b) the MoE block at moonshot-v1-16b-a3b's width, float32, ids given:
    a2a and replicated against the local mode, dropless and at cf 1.25."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH).reduced() if ctx["reduced"] else get_config(MOE_ARCH)
    dropless = cfg.moe.n_experts / cfg.moe.top_k
    B, S = ctx["size"]["slots"], ctx["size"]["prompt"]
    blocks = moe_blocks(cfg, ctx["device"], ctx["mesh"])
    for name, B, S, cf in (("a2a", B, S, dropless), ("replicated", 2, 1, dropless),
                           ("a2a_cf", B, S, 1.25), ("replicated_cf", 2, 1, 1.25)):
        mode, got, want, dropped, local_dropped = mesh_moe_case(cfg, blocks, ctx["device"],
                                                                ctx["mesh"], B, S, cf)
        if mode != name.split("_")[0]:
            raise AssertionError(f"mesh moe {name}: took the {mode} mode")
        if not torch.isfinite(got).all():
            raise AssertionError(f"mesh moe {name}: non-finite output")
        if cf == dropless:
            torch.testing.assert_close(got, want, **MOE_TOL)
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "dropped_share": dropped, "local_dropped_share": local_dropped}


def part_gemma(out, ctx):
    """(c) gemma-2b at full width: a cache-filling prefill in the 2d layout,
    then teacher-forced decode steps in the serving layout."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.model import apply_decode, init_cache

    cfg, ref, device, mesh = mesh_config(FULL_ARCH, ctx["reduced"]), ctx["refs"]["gemma"], \
        ctx["device"], ctx["mesh"]
    B, S, steps = ctx["size"]["slots"], ctx["size"]["prompt"], ctx["size"]["steps"]
    lm = full_model(cfg, device)
    rt = make_runtime(cfg, mesh, torch.bfloat16)
    interop.place_params(lm, cfg, mesh)
    flash_attention.launches = 0
    caches = init_cache(cfg, rt, B, S + steps, dtype=torch.bfloat16)
    clock = Clock(device)
    lg, caches = apply_decode(lm, cfg, rt, torch.as_tensor(ref["prompts"]), caches, 0)
    out["prefill_s"] = clock()
    out["flash_launches"] = flash_attention.launches
    out["prefill_err"] = logits_err(last_logits(lg), ref["logits"][0], "gemma prefill")
    if device == "cuda" and out["flash_launches"] != cfg.n_layers:
        raise AssertionError(f"mesh gemma: {out['flash_launches']} flash launches on a rank, "
                             f"{cfg.n_layers} expected")
    del lg
    clock()
    interop.place_params(lm, cfg, mesh, model_only=True)
    out["relayout_s"] = clock()
    errs = []
    for t in range(steps):
        lg, caches = apply_decode(lm, cfg, rt, ref["tokens"][t].to(device)[:, None], caches,
                                  S + t)
        errs.append(logits_err(last_logits(lg), ref["logits"][t + 1], f"gemma step {t}"))
    out["decode_step_s"] = clock() / steps
    out["decode_err_max"] = max(errs)


def part_mamba(out, ctx):
    """(d) mamba2-130m at full width, pure data parallel: one prefill."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.model import apply_lm

    cfg, ref, mesh = mesh_config(SSM_ARCH, ctx["reduced"]), ctx["refs"]["mamba"], ctx["mesh"]
    lm = full_model(cfg, ctx["device"])
    rt = make_runtime(cfg, mesh, torch.bfloat16)
    interop.place_params(lm, cfg, mesh, pure_dp=True)
    ssd.launches = 0
    out["logits_err"] = logits_err(last_logits(apply_lm(lm, cfg, rt, ref["prompts"])[0]),
                                   ref["logits"], "mamba prefill")
    out["ssd_launches"] = ssd.launches
    if ctx["device"] == "cuda" and out["ssd_launches"] != cfg.n_layers:
        raise AssertionError(f"mesh mamba: {out['ssd_launches']} ssd launches on a rank")


def part_moonshot(out, ctx):
    """(e) moonshot-v1-16b-a3b at full width, depth cut: a prefill (a2a) and
    decode steps at batch 2 (replicated), with the single rank's routes."""
    from repro_torch import interop
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import apply_lm

    cfg, ref, device, mesh = mesh_config(MOE_ARCH, ctx["reduced"]), ctx["refs"]["moonshot"], \
        ctx["device"], ctx["mesh"]
    S, steps = ctx["size"]["prompt"], ctx["size"]["moe_steps"]
    lm = full_model(cfg, device)
    rt = make_runtime(cfg, mesh, torch.bfloat16)
    interop.place_params(lm, cfg, mesh, model_only=True)
    flash_attention.launches = 0
    with MOE.replaying_routes([r.to(device) for r in ref["routes"]]):
        out["prefill_err"] = logits_err(last_logits(apply_lm(lm, cfg, rt, ref["prompts"])[0]),
                                        ref["prefill"], "moonshot prefill")
        logits, _ = decode_run(lm, cfg, rt, torch.as_tensor(ref["prompts"][:2]), S + steps,
                               steps, ref["tokens"])
    out["decode_err_max"] = max(logits_err(g, w, "moonshot decode")
                                for g, w in zip(logits, ref["logits"]))
    out["flash_launches"] = flash_attention.launches
    out["modes"] = [MOE.moe_mode(cfg, rt, ctx["size"]["slots"], S), MOE.moe_mode(cfg, rt, 2, 1)]


MESH_PARTS = {"fleet": part_fleet, "moe": part_moe, "gemma": part_gemma, "mamba": part_mamba,
              "moonshot": part_moonshot}


def mesh_rank(rank, world, refs, fleet_golden, device_type, parts=tuple(MESH_PARTS),
              reduced=False):
    """Phase 22 (or 23) on one rank (every rank runs it): ``parts`` of
    MESH_PARTS (TRAIN_PARTS) in order, each timed with its collectives and
    peak memory counted, the serving parts under inference_mode. Returns
    this rank's numbers; any failed check raises."""
    t_enter = time.time()
    if sys.pycache_prefix == str(PYCACHE):  # what this rank compiles, the next ranks read
        sys.dont_write_bytecode = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh, make_smoke_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = {"refs": refs, "fleet_golden": fleet_golden, "device": device_type,
           "reduced": reduced, "size": mesh_size(reduced),
           "mesh": make_smoke_mesh(2, 2, device_type=device_type),
           "nodes": make_mesh((world,), ("nodes",), device_type)}
    rec = {"rank": rank, "t_enter": t_enter, "setup_s": time.time() - t_enter}
    for name in parts:
        train = name in TRAIN_PARTS
        with kernel_calls() as calls:
            with mesh_part(rec, name, device_type) as out, \
                    (contextlib.nullcontext() if train else torch.inference_mode()):
                (TRAIN_PARTS if train else MESH_PARTS)[name](out, ctx)
        if rank == 0:  # progress, while the other parts run
            print(f"[mesh-part] {name} s={out['s']:.2f} "
                  f"peak_gb={out.get('peak_gb', 0):.2f}", flush=True)
        if torch.device(device_type).type == "cuda":  # the kernels at this rank's shapes
            out["kernel_checks"] = check_kernel_calls(calls)
        free_card_if(device_type)
    from repro_torch.launch.mesh import RANK_TIMES

    rec["t_exit"] = time.time()
    rec["start_up"] = {k: v - t_enter for k, v in RANK_TIMES.items()}
    return rec


def free_card_if(device):
    if torch.device(device).type == "cuda":
        free_card()
    else:
        gc.collect()


def fleet_rows(planner):
    """A planner's node rows' solutions (after its re-plan): what the mesh row
    solve is held to."""
    return {key: getattr(planner, key).copy()
            for key in ("sol_c", "sol_m", "sol_ws", "node_utility")}


def run_mesh(refs, fleet_golden, device_type="cuda", world=MESH_WORLD,
             parts=tuple(MESH_PARTS), reduced=False, limit_s=MESH_LIMIT_S):
    """Phase 22's (or 23's) ranks: ``world`` processes over gloo (every rank
    on card 0 with CUDA: NCCL refuses two ranks on one device), each running
    ``mesh_rank``; returns their records. A failure on any rank raises."""
    from repro_torch.launch.mesh import spawn

    return spawn(mesh_rank, world, backend="gloo", device=device_type,
                 args=(refs, fleet_golden, device_type, tuple(parts), reduced),
                 timeout=limit_s * 4)


def mesh_phase(fleet_ref):
    """Phase 22: the mesh on four ranks sharing the card, against single-rank
    runs on the card (``fleet_ref``: phase 19's planner rows); returns the
    kernels line's mesh entries."""
    sys.path.insert(0, str(ROOT / "src"))
    fleet_golden = json.loads(FLEET_GOLDEN.read_text())
    t_phase = time.perf_counter()
    free_card()
    refs = mesh_references()
    refs["fleet"] = fleet_ref
    refs_s = time.perf_counter() - t_phase
    off = check_flash(SLOTS // 2, PROMPT_LEN // 2, PROMPT_LEN, 1, 8, 256, True, torch.bfloat16,
                      timed=True, offset=PROMPT_LEN // 2)
    free_card()
    t0, t_spawn = time.perf_counter(), time.time()
    recs = run_mesh(refs, fleet_golden)
    ranks_s = time.perf_counter() - t0
    startup_s = min(r.pop("t_enter") for r in recs) - t_spawn
    teardown_s = t_spawn + ranks_s - max(r.pop("t_exit") for r in recs)
    wall = time.perf_counter() - t_phase
    for rec in recs:
        log("mesh", **rec)
    parts = {name: max(r[name]["s"] for r in recs)
             for name in ("fleet", "moe", "gemma", "mamba", "moonshot")}
    flash = [r["gemma"]["flash_launches"] + r["moonshot"]["flash_launches"] for r in recs]
    ssd_l = [r["mamba"]["ssd_launches"] for r in recs]
    log("mesh", ranks=len(recs), references_s=refs_s, ranks_s=ranks_s,
        ranks_startup_s=startup_s, ranks_setup_s=max(r["setup_s"] for r in recs),
        ranks_teardown_s=teardown_s, parts_s=parts,
        flash_launches_per_rank=flash, ssd_launches_per_rank=ssd_l,
        peak_gb_per_rank=[max(r[p].get("peak_gb", 0) for p in parts) for r in recs],
        moe_dropped_share_cf125={k: recs[0]["moe"][k]["dropped_share"]
                                 for k in ("a2a_cf", "replicated_cf")},
        offset_kernel=off, phase_wall_s=wall)
    if min(flash) == 0 or min(ssd_l) == 0:
        raise AssertionError(f"mesh: a rank launched no flash {flash} or ssd {ssd_l} kernel")
    checked = {k: mesh_checks(recs, k) for k in ("flash_attention", "ssd_chunk")}
    log("mesh", kernels_checked_at_the_ranks_shapes=checked)
    for rec in recs:
        for part in ("gemma", "mamba", "moonshot"):
            if not rec[part].get("kernel_checks"):
                raise AssertionError(f"mesh {part}: rank {rec['rank']} checked no kernel "
                                     "at its shapes")
    if wall > MESH_LIMIT_S:
        raise AssertionError(f"mesh: the phase took {wall:.1f} s > {MESH_LIMIT_S} s")
    timed = ("shape", "offset", "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_graph_ms",
             "bound_ms", "bound_by", "library_ms", "library_graph_ms")
    return {"flash": {"launches": sum(flash), "launches_per_rank": flash,
                      "checked": checked["flash_attention"],
                      "offset_kernel": {key: off[key] for key in timed}},
            "ssd": {"launches": sum(ssd_l), "launches_per_rank": ssd_l,
                    "checked": checked["ssd_chunk"]}}


# ----------------------------------------------------------------------------
# 23. the sharded train step on the mesh
# ----------------------------------------------------------------------------
MESH_TRAIN_LIMIT_S = 180.0
MESH_TRAIN_LAYERS = 4  # gemma-2b's depth in part (b) (full width; 18 uncut)
MESH_TRAIN_GEMMA = (4, 256, 2)  # B, S, microbatches of part (b)
MESH_TRAIN_MAMBA = (8, 512)  # B x S of part (c), one microbatch (two chunks of 256)
DIGEST_TOL = 1e-3  # a leaf's gradient digests against the single rank's


def mesh_train_config(arch, reduced=False):
    """Phase 23's ``arch``: gemma-2b at full width cut to MESH_TRAIN_LAYERS
    layers, mamba2-130m whole (or their reduced variants for a CPU
    rehearsal)."""
    from repro_torch.configs import get_config

    if reduced:
        return get_config(arch).reduced()
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS) if arch == FULL_ARCH else cfg


def mesh_train_size(reduced=False):
    """Parts (b) and (c)'s (B, S, microbatches) (a CPU rehearsal's are small)."""
    if reduced:
        return {"gemma": (4, 32, 2), "mamba": (8, 32, 1)}
    return {"gemma": MESH_TRAIN_GEMMA, "mamba": (*MESH_TRAIN_MAMBA, 1)}


def mesh_train_curve(cfg, setup, mesh, device, routes=None, attn_backend="auto"):
    """``train_curve`` on ``mesh``: the same weights (``interop.numpy_params``)
    laid out in the 2d layout (pure data parallel where the config says so),
    the step on every rank with the same global batches, a MoE model on the
    recorded routes (each rank replays its rows' ids). Returns [(loss,
    grad_norm)] per step."""
    from repro_torch import interop
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models import moe
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    lm = interop.params_from_jax(interop.numpy_params(cfg, setup["seed"]), cfg, device)
    interop.place_params(lm, cfg, mesh, pure_dp=cfg.pure_dp)
    opt = adamw(lr=setup["lr"])
    state = opt.init(dict(lm.named_parameters()))
    rt = make_runtime(cfg, mesh, torch.float32, attn_backend)
    step_fn = make_train_step(cfg, rt, opt, setup["microbatches"])
    curve = []
    for step in range(setup["steps"]):
        batch = {k: torch.as_tensor(v, device=rt.device)
                 for k, v in train_batch(cfg, setup, step).items()}
        with (moe.replaying_routes([torch.as_tensor(ids, device=rt.device)
                                    for ids in routes[step]])
              if routes else contextlib.nullcontext()):
            lm, state, metrics = step_fn(lm, state, batch)
        curve.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return curve


def grad_digests(grads, seed=SEED):
    """{name: (L2 norm, dot with a seeded standard normal tensor)} of a dict
    of gradients in float64 sums; a ``DTensor`` leaf's from its local shard
    (of the random tensor too), summed over the mesh dims that split it, so
    that no whole gradient crosses processes."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    out = {}
    for i, (name, g) in enumerate(sorted(grads.items())):
        local = g.to_local() if isinstance(g, DTensor) else g
        gen = torch.Generator(device=local.device).manual_seed(seed + i)
        r = torch.randn(g.shape, generator=gen, device=local.device)
        if isinstance(g, DTensor):
            for d, pl in enumerate(g.placements):
                if pl.is_shard():
                    r = r.chunk(g.device_mesh.size(d), dim=pl.dim)[g.device_mesh.get_local_rank(d)]
        g64 = local.double()
        sums = torch.stack([(g64 * g64).sum(), (g64 * r.double()).sum()])
        del r
        if isinstance(g, DTensor):
            for d, pl in enumerate(g.placements):
                if pl.is_shard():
                    dist.all_reduce(sums, group=g.device_mesh.get_group(d))
        out[name] = (float(sums[0].sqrt()), float(sums[1]))
    return out


def digest_errs(got, want):
    """The largest relative gaps of the leaves' digests: the norms relative
    to the single rank's, the dots relative to its norm (a unit normal dot's
    scale)."""
    norm = max(abs(got[n][0] - w[0]) / max(w[0], 1e-30) for n, w in want.items())
    dot = max(abs(got[n][1] - w[1]) / max(w[0], 1e-30) for n, w in want.items())
    return norm, dot


def recording_grads(opt, sink):
    """``opt`` whose update first records the step's gradients' digests in
    ``sink``."""
    from repro_torch.train.optimizer import Optimizer

    def update(grads, state, params):
        sink.append(grad_digests(grads))
        return opt.update(grads, state, params)

    return Optimizer(init=opt.init, update=update, name=opt.name)


def one_step(lm, cfg, rt, batch, mb):
    """One AdamW step of ``lm``: (loss, grad_norm, gradient digests)."""
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    sink = []
    opt = recording_grads(adamw(), sink)
    state = opt.init(dict(lm.named_parameters()))
    _, state, metrics = make_train_step(cfg, rt, opt, mb)(lm, state, batch)
    return float(metrics["loss"]), float(metrics["grad_norm"]), sink[0], state


def mesh_train_batch(cfg, B, S, device):
    from repro_torch.data.pipeline import SyntheticTokens

    return {k: torch.as_tensor(v, device=device)
            for k, v in SyntheticTokens(cfg.vocab, S, B, seed=SEED).batch(0).items()}


def mesh_train_references(device="cuda", reduced=False):
    """The single-rank steps (on ``device``, the same seeded float32 weights
    and batch) that parts (b) and (c) are held to: loss, grad_norm and the
    gradient digests of one float32-compute step."""
    from repro_torch.models.layers import Runtime

    refs, size = {}, mesh_train_size(reduced)
    for part, arch in (("gemma", FULL_ARCH), ("mamba", SSM_ARCH)):
        cfg = mesh_train_config(arch, reduced)
        B, S, mb = size[part]
        lm = full_model(cfg, device, torch.float32)
        loss, gnorm, digests, _ = one_step(lm, cfg, Runtime(device, torch.float32, "auto"),
                                           mesh_train_batch(cfg, B, S, device), mb)
        refs[part] = {"loss": loss, "grad_norm": gnorm, "digests": digests}
        del lm
        free_card_if(device)
    return refs


def check_one_step(out, what, got, ref):
    """A mesh step's (loss, grad_norm, digests) against the single rank's."""
    loss, gnorm, digests = got
    out["loss_rel_err"] = abs(loss - ref["loss"]) / abs(ref["loss"])
    out["grad_norm_rel_err"] = abs(gnorm - ref["grad_norm"]) / abs(ref["grad_norm"])
    out["digest_norm_rel_err"], out["digest_dot_rel_err"] = digest_errs(digests, ref["digests"])
    if not (np.isfinite(loss) and out["loss_rel_err"] < 1e-4
            and out["grad_norm_rel_err"] < 1e-3
            and max(out["digest_norm_rel_err"], out["digest_dot_rel_err"]) < DIGEST_TOL):
        raise AssertionError(f"mesh-train {what}: the step is off the single rank's: {out}")


def part_train_golden(out, ctx):
    """(a) the golden file's reduced entries trained on the (2, 2) mesh in
    float32 through the kernels, a MoE model on the reference's routes:
    loss rtol 1e-4, grad_norm rtol 1e-3 (phase 14's bars), and the kernel
    launches the steps imply on each rank. Keeps each entry's curve."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd

    golden = ctx["refs"]["train_golden"]
    setup = golden["setup"]
    cuda = torch.device(ctx["device"]).type == "cuda"
    out["launches"] = [0, 0]
    for name, entry in golden["entries"].items():
        cfg = get_config(entry["arch"]).reduced()
        before = flash_attention.launches, ssd.launches
        curve = mesh_train_curve(cfg, setup, ctx["mesh"], ctx["device"], entry.get("routes"))
        launches = flash_attention.launches - before[0], ssd.launches - before[1]
        want = tuple(n * setup["steps"] for n in train_launches(
            cfg, setup["microbatches"], frames=cfg.family == "audio"))
        if cuda and launches != want:
            raise AssertionError(f"mesh-train {name}: (flash, ssd) launches {launches} != {want}")
        out["launches"] = [a + b for a, b in zip(out["launches"], launches)]
        loss, gnorm = (np.array(c) for c in zip(*curve))
        loss_err = float((np.abs(loss - entry["loss"]) / np.abs(entry["loss"])).max())
        gnorm_err = float((np.abs(gnorm - entry["grad_norm"]) / np.abs(entry["grad_norm"])).max())
        out[name] = {"loss_max_rel_err": loss_err, "grad_norm_max_rel_err": gnorm_err,
                     "curve": curve}
        if not (np.all(np.isfinite(loss)) and loss_err < 1e-4 and gnorm_err < 1e-3):
            raise AssertionError(f"mesh-train {name}: losses {loss.tolist()} / grad norms "
                                 f"{gnorm.tolist()} off the reference's")


def part_train_gemma(out, ctx):
    """(b) gemma-2b at full width (depth cut) in the 2d layout, float32
    weights, AdamW: one float32-compute step against the single rank's, then
    two bf16-compute steps on the same batch with losses finite and
    falling."""
    from repro_torch import interop
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.specs import make_runtime
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    cfg = mesh_train_config(FULL_ARCH, ctx["reduced"])
    B, S, mb = mesh_train_size(ctx["reduced"])["gemma"]
    device, mesh = ctx["device"], ctx["mesh"]
    clock = Clock(device)
    lm = interop.place_params(full_model(cfg, device, torch.float32), cfg, mesh)
    out["init_s"] = clock()
    batch = mesh_train_batch(cfg, B, S, device)
    flash_attention.launches = 0
    loss, gnorm, digests, _ = one_step(lm, cfg, make_runtime(cfg, mesh, torch.float32), batch, mb)
    out["f32_step_s"] = clock()
    out["flash_launches_f32_step"] = flash_attention.launches
    check_one_step(out, "gemma", (loss, gnorm, digests), ctx["refs"]["gemma"])
    opt = adamw()
    state = opt.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, make_runtime(cfg, mesh, torch.bfloat16), opt, mb)
    losses, step_s = [], []
    for _ in range(2):
        clock()
        lm, state, metrics = step_fn(lm, state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(clock())
    out.update(bf16_losses=losses, bf16_step_s=step_s, flash_launches=flash_attention.launches)
    if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f"mesh-train gemma: bf16 losses {losses}")
    want = 3 * 2 * mb * cfg.n_layers
    if torch.device(device).type == "cuda" and flash_attention.launches != want:
        raise AssertionError(f"mesh-train gemma: {flash_attention.launches} flash launches on "
                             f"a rank, {want} expected")


def part_train_mamba(out, ctx):
    """(c) mamba2-130m at full width and depth, pure data parallel: one
    float32-compute step against the single rank's."""
    from repro_torch import interop
    from repro_torch.kernels import ssd
    from repro_torch.launch.specs import make_runtime

    cfg = mesh_train_config(SSM_ARCH, ctx["reduced"])
    B, S, mb = mesh_train_size(ctx["reduced"])["mamba"]
    device, mesh = ctx["device"], ctx["mesh"]
    clock = Clock(device)
    lm = interop.place_params(full_model(cfg, device, torch.float32), cfg, mesh, pure_dp=True)
    ssd.launches = 0
    loss, gnorm, digests, _ = one_step(lm, cfg, make_runtime(cfg, mesh, torch.float32),
                                       mesh_train_batch(cfg, B, S, device), mb)
    out["step_s"] = clock()
    out["ssd_launches"] = ssd.launches
    check_one_step(out, "mamba", (loss, gnorm, digests), ctx["refs"]["mamba"])
    want = 2 * mb * cfg.n_layers
    if torch.device(device).type == "cuda" and ssd.launches != want:
        raise AssertionError(f"mesh-train mamba: {ssd.launches} ssd launches on a rank, "
                             f"{want} expected")


def pod_grads(pod, call):
    """Part (d)'s gradients of pod ``pod`` at call ``call``: "w" (64,) and "m"
    (16, 24) float32 from default_rng([SEED, pod, call])."""
    rng = np.random.default_rng([SEED, pod, call])
    return {"w": rng.normal(size=(64,)).astype(np.float32),
            "m": (3.0 * rng.normal(size=(16, 24))).astype(np.float32)}


def compress_numpy(pods, errors):
    """The reference's compress_allreduce_pod transcribed in NumPy float32 for
    pods that hold different gradients: ``pods`` [{leaf: g}] per pod, the
    pods' error states likewise. Returns (the reduced leaves, the pods' new
    errors)."""
    f32 = np.float32
    n = len(pods)
    red, new_err = {}, [{} for _ in pods]
    for leaf in pods[0]:
        qs, scales = [], []
        for p, (g, err) in enumerate(zip(pods, errors)):
            g32 = g[leaf].astype(f32) + err[leaf]
            scale = np.maximum(np.max(np.abs(g32)), f32(1e-12)) / f32(127.0)
            q = np.clip(np.round(g32 / scale), -127, 127).astype(np.int8)
            new_err[p][leaf] = g32 - q.astype(f32) * scale
            qs.append(q.astype(np.int32))
            scales.append(scale)
        qsum, ssum = sum(qs), f32(sum(scales))
        red[leaf] = qsum.astype(f32) * (ssum / f32(n)) / f32(n)
    return red, new_err


def run_compress(mesh, device, calls=2):
    """compress_allreduce_pod on ``mesh`` (("pod", "data")): each pod its own
    gradients (pod_grads), "m" a DTensor split over 'data', "w" a plain
    tensor; the error state carried over ``calls`` calls. Returns per call
    (the reduced leaves whole, this pod's new error whole) as NumPy."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.layers import distribute, whole
    from repro_torch.train.step import compress_allreduce_pod

    pod = mesh.get_local_rank("pod")
    err = None
    out = []
    for call in range(calls):
        g = {k: torch.as_tensor(v, device=device) for k, v in pod_grads(pod, call).items()}
        g["m"] = distribute(g["m"], mesh, (Replicate(), Shard(0)))
        if err is None:
            err = {"w": torch.zeros_like(g["w"]), "m": distribute(
                torch.zeros(g["m"].shape, device=device), mesh, g["m"].placements)}
        red, err = compress_allreduce_pod(g, mesh, err)
        out.append(tuple({k: whole(v).cpu().numpy() for k, v in t.items()} for t in (red, err)))
    return out


def check_compress(records, pods=2, calls=2):
    """``run_compress``'s records on a rank against ``compress_numpy`` bit for
    bit; returns the largest difference (0)."""
    errors = [{"w": np.zeros(64, np.float32), "m": np.zeros((16, 24), np.float32)}
              for _ in range(pods)]
    worst = 0.0
    for call, (red, err) in enumerate(records):
        want, errors = compress_numpy([pod_grads(p, call) for p in range(pods)], errors)
        for k in want:
            worst = max(worst, float(np.abs(red[k] - want[k]).max()))
            if not np.array_equal(red[k], want[k]):
                raise AssertionError(f"compress_allreduce_pod call {call}, {k}: off the "
                                     "NumPy transcription")
    return worst, errors


def part_train_pod(out, ctx):
    """(d) compress_allreduce_pod on a (2, 2) ("pod", "data") mesh against the
    NumPy transcription of the reference's formula, bit for bit, its error
    carried over two calls."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("pod", "data"), ctx["device"])
    records = run_compress(mesh, ctx["device"])
    worst, errors = check_compress(records)
    pod = mesh.get_local_rank("pod")
    if not all(np.array_equal(records[-1][1][k], errors[pod][k]) for k in errors[pod]):
        raise AssertionError("compress_allreduce_pod: the error state is off the transcription's")
    out["max_abs_diff"] = worst


TRAIN_PARTS = {"train_golden": part_train_golden, "train_gemma": part_train_gemma,
               "train_mamba": part_train_mamba, "train_pod": part_train_pod}


def mesh_train_phase(train_golden):
    """Phase 23: the sharded train step on four ranks sharing the card, against
    the golden file and single-rank steps on the card; returns the kernels
    line's entries."""
    sys.path.insert(0, str(ROOT / "src"))
    t_phase = time.perf_counter()
    free_card()
    refs = mesh_train_references()
    refs["train_golden"] = train_golden
    refs_s = time.perf_counter() - t_phase
    t0, t_spawn = time.perf_counter(), time.time()
    recs = run_mesh(refs, None, parts=tuple(TRAIN_PARTS), limit_s=MESH_TRAIN_LIMIT_S)
    ranks_s = time.perf_counter() - t0
    startup_s = min(r.pop("t_enter") for r in recs) - t_spawn
    teardown_s = t_spawn + ranks_s - max(r.pop("t_exit") for r in recs)
    wall = time.perf_counter() - t_phase
    for rec in recs:
        log("mesh-train", **rec)
    flash = [r["train_golden"]["launches"][0] + r["train_gemma"]["flash_launches"] for r in recs]
    ssd_l = [r["train_golden"]["launches"][1] + r["train_mamba"]["ssd_launches"] for r in recs]
    checked = {k: mesh_checks(recs, k, TRAIN_PARTS) for k in ("flash_attention", "ssd_chunk")}
    log("mesh-train", ranks=len(recs), references_s=refs_s, ranks_s=ranks_s,
        ranks_startup_s=startup_s, ranks_setup_s=max(r["setup_s"] for r in recs),
        ranks_teardown_s=teardown_s,
        parts_s={name: max(r[name]["s"] for r in recs) for name in TRAIN_PARTS},
        flash_launches_per_rank=flash, ssd_launches_per_rank=ssd_l,
        peak_gb_per_rank=[max(r[p].get("peak_gb", 0) for p in TRAIN_PARTS) for r in recs],
        kernels_checked_at_the_ranks_shapes=checked, phase_wall_s=wall)
    if min(flash) == 0 or min(ssd_l) == 0:
        raise AssertionError(f"mesh-train: a rank launched no flash {flash} or ssd {ssd_l} kernel")
    for rec in recs:
        for part in ("train_golden", "train_gemma", "train_mamba"):
            if not rec[part].get("kernel_checks"):
                raise AssertionError(f"mesh-train {part}: rank {rec['rank']} checked no kernel "
                                     "at its shapes")
    if wall > MESH_TRAIN_LIMIT_S:
        raise AssertionError(f"mesh-train: the phase took {wall:.1f} s > {MESH_TRAIN_LIMIT_S} s")
    return {"flash": {"launches": sum(flash), "launches_per_rank": flash,
                      "checked": checked["flash_attention"]},
            "ssd": {"launches": sum(ssd_l), "launches_per_rank": ssd_l,
                    "checked": checked["ssd_chunk"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import crms_grid, flash_attention, ssd

    golden = json.loads(GOLDEN.read_text())
    serve_golden = json.loads(SERVE_GOLDEN.read_text())
    train_golden = json.loads(TRAIN_GOLDEN.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", name=repr(device_name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build, all nvcc runs at once
    kernels = (crms_grid, flash_attention, ssd)
    with ThreadPoolExecutor(len(kernels)) as pool:
        futures = {m.__name__.rsplit(".", 1)[1]: pool.submit(m.build, force=True)
                   for m in kernels}
        builds = {name: f.result() for name, f in futures.items()}
    for kernel_name, built in builds.items():
        log("build", kernel=kernel_name, seconds=built["seconds"], library=built["library"])
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {kernel_name} ptxas:", line.strip(), flush=True)
    flash_entries = ptxas_entries(builds["flash_attention"]["log"])
    for dtype, fn in (("bfloat16", "flash_fwd_wgmma"), ("float32", "flash_fwd_tf32")):
        found = {int(re.search(fn + r"ILi(\d+)E", name).group(1)): e
                 for name, e in flash_entries.items() if fn in name}
        if sorted(found) != [32, 64, 128, 256]:
            raise AssertionError(f"build: {dtype} flash instantiations {sorted(found)} in "
                                 "ptxas' report, hd 32/64/128/256 expected")
        for hd, entry in sorted(found.items()):
            log("build", kernel="flash_attention", dtype=dtype, hd=hd, **entry)
            if entry["spill_stores"] or entry["spill_loads"]:
                raise AssertionError(f"build: the {dtype} flash kernel at hd {hd} spills {entry}")
    ssd_entries = {tuple(map(int, re.search(r"ssd_chunk_kernelILi(\d+)ELi(\d+)E", name).groups())):
                   e for name, e in ptxas_entries(builds["ssd"]["log"]).items()
                   if "ssd_chunk_kernel" in name}
    if len(ssd_entries) != 12:
        raise AssertionError(f"build: {len(ssd_entries)} ssd_chunk instantiations in ptxas' "
                             "report, 12 expected (P in 16/32/64, N in 16/32/64/128)")
    for (P, N), entry in sorted(ssd_entries.items()):
        log("build", kernel="ssd_chunk", P=P, N=N, **entry)
        if entry["spill_stores"] or entry["spill_loads"]:
            raise AssertionError(f"build: the ssd_chunk kernel at P {P}, N {N} spills {entry}")

    # 3. kernel against its plain version
    path_shape = check_kernel(72, 64, "per_app", reps=2000, plain_reps=20)
    check_kernel(20000, 64, "sum", reps=200, plain_reps=5, n_range=(8, 20))
    floor_ms = launch_floor_ms()
    log("kernel", library_equivalent="none (no single PyTorch call computes Erlang-C Ws)",
        launch_floor_graph_ms=floor_ms)

    # 4. the main path, counted from zero
    crms_grid.launches = 0
    allocations = {}
    for entry in ("paper_fitted", "mix8", "mix16", "mix32", "mix64", "p95_mix8",
                  "p95_rollout_mix8"):
        launches, refine_iters, allocations[entry] = run_entry(entry, golden, "cuda")
        if launches < refine_iters:
            raise AssertionError(f"{entry}: {launches} crms_grid launches < "
                                 f"{refine_iters} refinement iterations")
    main_launches = crms_grid.launches
    log("main", crms_grid_launches=main_launches)
    if main_launches == 0:
        raise AssertionError("the main path never launched the crms_grid kernel")

    # 5. vector alpha: the float64 oracle branch, no kernel launch
    launches, _, _ = run_entry("priority_mix8", golden, "cuda")
    if launches != 0:
        raise AssertionError(f"crms_priority launched the scalar-alpha kernel {launches} times")

    # 18. the policies and the scenario layer: six traces replayed on the card
    # against the reference's documents, crms_grid counted from zero. It runs
    # here, before any model is loaded: its solves are host-bound, and in a
    # process that has held the serving and training models each took ~1.8x
    # as long
    scenarios = scenario_phase()

    # 19. the search baselines and the fleet placement layer against the
    # reference's records, crms_grid counted from zero; also before any model
    baselines = baselines_phase()

    # 20. the TPU-fleet binding against the reference's records, crms_grid
    # counted from zero; also before any model
    fleet_binding = fleet_binding_phase()

    # 6. flash kernel against its plain version
    flash_path = check_flash(4, 512, 512, 1, 8, 256, True, torch.bfloat16, timed=True)
    flash_f32 = check_flash(4, 512, 512, 1, 8, 256, True, torch.float32, timed=True)
    for dtype in (torch.float32, torch.bfloat16):
        check_flash(1, 256, 256, 4, 1, 128, True, dtype)
        check_flash(1, 70, 130, 2, 2, 32, False, dtype)
    check_flash(2, 192, 192, 2, 3, 64, True, torch.float32)  # one head a tile (G 3)
    moe_flash = check_flash(*MOE_FLASH, torch.bfloat16, timed=True)
    check_flash(*MOE_FLASH, torch.float32)
    code_flash = check_flash(*CODE_FLASH, torch.bfloat16, timed=True)
    check_flash(*CODE_FLASH, torch.float32)
    audio_flash = {}
    for name, shape in AUDIO_FLASH.items():
        audio_flash[name] = check_flash(*shape, torch.bfloat16, timed=True)
        check_flash(*shape, torch.float32)

    # 7. ssd kernel against its plain version
    ssd_path = check_ssd(4, 512, 24, 64, 128, 256, timed=True)
    for shape in ((1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128), (2, 8, 4, 16, 16, 256)):
        check_ssd(*shape)
    log("ssd", library_equivalent="none (no single PyTorch call computes the chunked SSD)")

    # 8-12 serve: no autograd graph (the parameters are trainable)
    with torch.inference_mode():
        # 8. reduced serving against the JAX Engine's results
        for case, entry in serve_golden["entries"].items():
            serve_reduced(case, entry, serve_golden["setup"])

        # 9. gemma-2b at full width: the serving path, counted from zero
        flash_launches = serve_full(FULL_ARCH, flash_attention, flash_path, "gemma")
        if flash_launches == 0:
            raise AssertionError("the serving path never launched the flash kernel")

        # 10. mamba2-130m at full width: its serving path, counted from zero
        ssd_launches = serve_full(SSM_ARCH, ssd, ssd_path, "mamba")
        if ssd_launches == 0:
            raise AssertionError("the mamba serving path never launched the ssd kernel")

        # 11. moonshot-v1-16b-a3b at full width: its serving path, counted from zero
        moe_launches = serve_moe_full()

        # 12. seamless-m4t-large-v2 at full width through the serving steps
        audio_launches = serve_audio_full()

        # 21. codeqwen1.5-7b at full width: its serving path, counted from zero
        code_launches = serve_code_full(code_flash)

    # 13. the kernels with their gradients, on the card freed of the models
    t_phase = time.perf_counter()
    free_card()
    flash_grads = [check_flash_grad(*shape, dtype) for dtype in (torch.float32, torch.bfloat16)
                   for shape in (FLASH_TRAIN, *FLASH_GRAD_CASES)]
    flash_train = time_flash_train(*FLASH_TRAIN[:2], *FLASH_TRAIN[3:6], torch.bfloat16)
    ssd_train = check_ssd_grad(*SSD_TRAIN)
    log("train-kernels", phase_wall_s=time.perf_counter() - t_phase)

    # 14. reduced models trained on the card against the JAX reference's run
    t_phase = time.perf_counter()
    for case, entry in train_golden["entries"].items():
        train_reduced(case, entry, train_golden["setup"])
    check_recovery()
    log("train-reduced", phase_wall_s=time.perf_counter() - t_phase)

    # 15-16. gemma-2b and mamba2-130m trained at full width, counted from zero
    flash_attention.launches = ssd.launches = 0
    gemma_train = train_full(FULL_ARCH, *GEMMA_TRAIN, "gemma-train")
    mamba_train = train_full(SSM_ARCH, *MAMBA_TRAIN, "mamba-train")
    if gemma_train["launches"][0] == 0 or mamba_train["launches"][1] == 0:
        raise AssertionError("the training path never launched the flash or the ssd kernel")

    # 17. simulation on the card: the rollout scan against its host loop,
    # crms_p95 with rollouts (crms_grid counted from zero), simulate_allocation,
    # and the event engine against the vector engine
    free_card()
    simulated = simulate_phase(golden, allocations)

    # 22. the mesh: four ranks on the card over gloo against single-rank runs
    mesh = mesh_phase(baselines["fleet_rows"])

    # 23. the sharded train step: four ranks on the card over gloo against the
    # golden file and single-rank steps
    mesh_train = mesh_train_phase(train_golden)

    print(smi, flush=True)
    timed_keys = ("shape", "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_graph_ms",
                  "bound_ms", "bound_by", "library_ms", "library_graph_ms")
    print(json.dumps({"kernels": [{
        "name": "crms_grid", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": main_launches, "max_abs_err": path_shape["max_abs_err"],
        "ms": path_shape["ms"], "graph_ms": path_shape["graph_ms"],
        "plain_ms": path_shape["plain_ms"],
        "bound_ms": path_shape["bound_ms"], "bound_by": path_shape["bound_by"],
        "library_ms": None, "launch_floor_graph_ms": floor_ms,
        "crms_p95": {"launches": simulated["crms_p95"]["crms_grid_launches"],
                     "refine_iters": simulated["crms_p95"]["refine_iters"]},
        "scenarios": {"launches": scenarios["launches"], "replans": scenarios["replans"]},
        "baselines": {"launches": baselines["launches"]},
        "fleet_binding": {"launches": fleet_binding["launches"],
                          "refine_iters": fleet_binding["refine_iters"]},
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": flash_path["max_abs_err"], "ms": flash_path["ms"],
        "graph_ms": flash_path["graph_ms"], "plain_ms": flash_path["plain_ms"],
        "plain_graph_ms": flash_path["plain_graph_ms"], "bound_ms": flash_path["bound_ms"],
        "bound_by": flash_path["bound_by"], "library_ms": flash_path["library_ms"],
        "library_graph_ms": flash_path["library_graph_ms"],
        "float32": {key: flash_f32[key] for key in (
            "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_graph_ms", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms")},
        "moonshot": {"launches": moe_launches, **{key: moe_flash[key] for key in timed_keys}},
        "codeqwen": {"launches": code_launches, **{key: code_flash[key] for key in timed_keys}},
        "seamless": {"launches": audio_launches,
                     **{name: {key: res[key] for key in timed_keys}
                        for name, res in audio_flash.items()}},
        "mesh": mesh["flash"], "mesh_train": mesh_train["flash"],
        "training": {"launches": gemma_train["launches"][0],
                     "launches_per_step": gemma_train["launches_per_step"][0],
                     "grad_max_abs_err": max(r["max_abs_err"] for r in flash_grads),
                     "fwd_device_ms_per_step": gemma_train["flash_fwd_device_ms"],
                     "bwd_device_ms_per_step": gemma_train["flash_bwd_device_ms"],
                     "step_device_busy_ms": gemma_train["device_busy_ms"], **flash_train},
    }, {
        "name": "ssd_chunk", "route": "cuda", "source": SSD_SOURCE, "replaces": SSD_REPLACES,
        "launches": ssd_launches, "max_abs_err": ssd_path["max_abs_err"],
        "ms": ssd_path["ms"], "graph_ms": ssd_path["graph_ms"], "plain_ms": ssd_path["plain_ms"],
        "bound_ms": ssd_path["bound_ms"], "bound_by": ssd_path["bound_by"],
        "library_ms": None, "mesh": mesh["ssd"], "mesh_train": mesh_train["ssd"],
        "training": {"launches": mamba_train["launches"][1],
                     "launches_per_step": mamba_train["launches_per_step"][1],
                     "fwd_device_ms_per_step": mamba_train["ssd_fwd_device_ms"],
                     "bwd_device_ms_per_step": mamba_train["ssd_bwd_device_ms"],
                     "step_device_busy_ms": mamba_train["device_busy_ms"], **ssd_train},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
