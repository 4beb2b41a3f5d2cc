"""Drive the PyTorch port's serving, forward and training paths, the
paper's tables, the invariant checker, every model family and the
distribution layer on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (one line each, plus detail lines):
  1. card and build: the card's name and power limit (nvidia-smi), then
     the CUDA sources built from src/repro_torch/kernels/csrc (flash_decode,
     lowrank_flash for f32 and for bf16, lowrank_flash's backward for f32
     and for bf16), one nvcc per source, started together; each source's
     tensor-core opcode counted in its SASS (the bf16 backward's: HGMMA,
     and no HMMA), and ptxas's report of the bf16 backward's kernels held
     to no spill store;
  2. the flash-decode kernel against its plain PyTorch version on the card,
     f32 (2e-5, and the exact zero pattern of the probabilities) and bf16
     (two bf16 steps of each output element): the CPU tests' shapes, cases
     at the key splits the kernel's host plan picks on this card, and the
     serving path's shapes (decode, prefill chunk, and phase 15's draft read
     at r = 16 and verify block with per-row q_lens); then K and V as
     strided views of (b, rows, hkv, d) cache buffers (the few-query route
     of ``ops.flash_attention``: zamba2's and qwen2-vl's one-query decodes,
     a 16-query call, rows off 16 bytes), each also bitwise the kernel on
     contiguous copies (``tools/few_query_smoke.py --other`` holds the
     contiguous cases bitwise to another commit's build);
  3. full-width serving of the drrl-paper model (12 layers, d_model 768,
     seeded random weights) through ``repro_torch.serve.Engine`` with the
     kernel on: adaptive rank, again with the factor cache, again in fixed
     mode; a reduced model served on the card with the kernel and on the
     CPU without it must give identical greedy tokens;
  4. one full-width mixed engine step with the kernel and with the plain
     attention on the same inputs: logits must agree;
  5. times at the serving shapes (the four of phase 2), L2 flushed before
     each timed call:
     kernel and plain version with and without probabilities, one PyTorch
     library call for the same attention (no probabilities), and the
     kernel's bound for each; then the adaptive serving run under
     torch.profiler, device time by kernel;
  6. the lowrank_flash kernel against its plain version on the card, f32
     (2e-5) and bf16 (two bf16 steps of each element): the CPU tests'
     eleven cases, their two q_offset cases (one shaped like decode_step_dense's
     call) and that call at full width, and the forward path's shapes
     (b = 2, 12 heads, 4096 tokens, causal; r = dv = 64 masked, r = 32 /
     dv = 64 static); then one f32 case with q and k scaled by 4, which
     the kernel (split TF32) must meet and the plain version with TF32
     matrix products must miss; and that case's shape in bf16, which the
     bf16 kernel (P.V with P as two bf16 terms) must meet and the plain
     version with P rounded once to bf16 must miss (SDPA's error there
     logged); then the f32 backward kernel against its plain version on
     the same (q, k, v, out, lse, dout), TF32 off (each gradient within
     2e-5 of its largest magnitude): drrl-paper's masked and static shapes
     at 2 x 12 x 4096, GQA 4 and 7, q_offset > 0, non-causal, r = 192 with
     dv = 128, odd tails, and 1 and 16 queries with grad through
     ``ops.flash_attention`` (one lowrank_flash and one lowrank_flash_bwd
     launch, no flash_decode); the forward's out bitwise the same with and
     without its log-sum-exp, and two backward runs bitwise equal; then the
     bf16 backward kernel against its plain version on the same bf16
     inputs (2e-5 of each gradient's largest magnitude + two bf16 steps of
     each element, the tolerance tests/test_torch_flash_bf16_grad.py
     fixes): the same kinds of cases, r and dv odd, and qwen2.5-14b's
     2 x 40 / 8 x 4096 at r = dv = 128, and a long-sum case (8 q heads on
     one kv head over 16384 keys: 131,072 summands per dk / dv row); each
     case's worst error over the tolerance logged; the bf16 forward's
     log-sum-exp against the plain one, its out bitwise with and without
     it, and two backward runs bitwise equal at every case;
  7. the full-width cache-free forward ``forward_dense(chunked=True)`` at
     2 x 4096 tokens, adaptive/masked with fidelity and fixed/static:
     kernel launches (12 per attention call site), logits and ranks against
     the same forward through the kernel's plain version, and a reduced
     model on the card against the CPU;
  8. one-shot serving (``prefill_chunk=None``) of phase 3's adaptive
     workload: greedy tokens equal to the chunked run's;
  9. times of lowrank_flash at both forward shapes (kernel, plain version,
     ``scaled_dot_product_attention`` and the backend it picked; CUDA
     events, and device time per call by torch.profiler), its bound on the
     tensor cores (three TF32 passes: ``bound_ms``) and on the f32 CUDA
     cores, and each forward's wall time and device time by layer; the
     backward kernel at both shapes (CUDA events, L2 flushed) beside its
     plain version, autograd through ``scaled_dot_product_attention``'s
     backward (a yardstick the port never calls) and its bound (f32 CUDA
     cores; three TF32 passes beside it); the bf16 backward at qwen2.5-14b's
     training shapes ('off' r = dv = 128, static r = 32) and qwen2-vl-7b's
     (28 / 4 heads, r = dv = 128) beside its bound on the bf16 tensor cores
     and the flops it issues, its plain version and SDPA's bf16 backward;
 10. the full-width forward in drrl-paper's own rank mode 'drrl' (masked,
     with fidelity) at 2 x 4096 tokens, the agent from ``init_agent`` on a
     seeded generator: 24 lowrank_flash launches, logits, ranks, the
     agent's logits and delta_a_rel against the same forward through the
     kernel's plain version; ranks per layer, actions the Eq. 11 mask
     removed, wall time and device time by layer with the agent's parts
     (policy network, Eq. 6 features, weight_stats, conv_features) named;
 11. full-width serving in rank mode 'drrl' (phase 3's engine settings and
     workload): flash_decode launches, decisions, vetoes, tokens/s, device
     time per decision in eigh and in the policy; a reduced model in 'drrl'
     served on the card with the kernel and on the CPU without it must give
     identical greedy tokens and ranks; the profiled rerun (device time per
     decision in eigh and the policy) runs the first 4 layers;
 12. the agent's training at full width (``train.rl.train_agent``, 2 x 4096
     tokens of ``SyntheticLM``, chunked): 3 BC steps from the greedy oracle
     (108 lowrank_flash launches each: 12 forward + 12 x 8 oracle), then 3
     PPO steps of 2 epochs (24 launches per rollout); wall time per BC step,
     rollout and update, bc_loss, the share of oracle actions the Eq. 11
     mask forbids, reward, mean rank, fidelity and the first epoch's
     ratio_mean (1 within 1e-5); the first BC step again through the
     kernel's plain version (oracle rewards within 1e-4, actions equal where
     the top-two gap exceeds it, bc_loss and gradients within 1e-4
     relative); one BC step of the first 4 layers profiled by layer and
     part; the reduced model's
     BC stage on the card with the kernel and on the CPU without it
     (bc_loss within 1e-5 relative, identical oracle actions);
 13. full-width sampled serving (phase 3's engine with ``sampling=True,
     nucleus=True``; its prompts and arrivals, two requests each of greedy,
     temperature 0.8, top-k 40 and top-p 0.9, each with its own seed). Run
     A, adaptive: flash_decode launches, greedy requests bitwise phase 3's,
     tokens/s and ms/step beside phase 3's, the sampling tail's device time
     per step (a torch.profiler range over 16 decode steps), a second run
     and a one-shot run identical, every top-p draw inside its nucleus; the
     tail's parts on 8 x 50257 logits (CUDA events and device time). Run B, rank mode 'random' with
     ``drift_threshold`` 0.5 and two cancels (mid-prefill, mid-decode):
     forced decisions, the cancelled slots' pages freed, the other streams
     equal to a run without the cancels. ``core.prng`` on the card against
     the CPU (bits equal, gumbel within 2e-7), and a reduced sampled run on
     the card with the kernel against the CPU without it (identical, or a
     differing token only at a top-two gap under 1e-5);
 14. the comparison set at full width, 2 x 4096 tokens: rank mode 'random'
     (masked, fidelity: 24 lowrank_flash launches, logits and ranks
     against the plain path, ranks equal to ``prng``'s draws), 'performer'
     and 'nystrom' at fixed rank 32 (wall, device time by layer, peak
     memory); the rank-r cache (``prefill_lowrank`` of 2 x 2048 at rank 32,
     64 ``decode_step_lowrank`` steps fed ``decode_step_dense``'s greedy
     tokens: agreement reported, ms/step); the reduced model's forwards in
     the three modes and its rank-r cache, card against CPU;
 15. low-rank self-speculative decoding and the prefix cache at full width:
     (a) phase 3's workload, greedy, with the factor cache and
     ``speculative=True, draft_k=4, draft_rank_frac=0.25``: 60 flash_decode
     launches per speculative step (4 drafts and the verify, 12 layers
     each), accept rate, tokens/s and ms/step beside phase 3's factor-cache
     run, tokens against that run's, ``check_refs``; again with
     ``adaptive_draft`` (its eff_draft_k over the run); a profiled
     speculative run by layer; (b) run A's sampled requests, speculative,
     against run A's tokens; (c) 8 prompts sharing a 1024-token prefix
     (request 1 a cut of request 5's prompt, so request 5 copies a partly
     filled tail page) with ``prefix_cache=True`` against the same run
     without it: hits, reused tokens, copied pages, TTFT of the hits (each
     step synced, report only), peak memory, ``check_refs`` over the tree's
     pages after the run and after ``reset()``; then with speculation too;
     (d) the reduced model's speculative, prefix and combined runs, card
     with the kernel against the CPU without it (identical tokens, ranks and
     stats). Full-width tokens must equal the plain run's, or a stream's
     first differing token must sit where the plain run's top-two gap is
     under 1e-4 (printed, with the count of such streams).
 16. the serving front end at full width (phase 3's engine with the factor
     cache): (a) ``make_workload``'s four scenarios (8 requests x 64 tokens
     each) through one engine recording serving traces with obs tracing,
     flight dumps and per-token timing, against the same run with all of it
     off: tokens equal, 12 flash_decode launches per fused step, records,
     the Chrome trace valid, ms/step and the ``StepPhases`` split; (b)
     ``train_serve_policy`` on the card from that trace (wall per stage,
     learned vs heuristic), and its BC stages on the card and the CPU from
     the same initial params (within 2.5 x lr, 99 % of elements within
     1e-6); (c) the checkpoint loaded and served in rank mode 'learned'
     through a ``FrontEnd`` on phase 3's workload: tokens and ranks per
     step equal to the caller-stepped run's; (d) 15c's prompts through a
     2-replica ``Router`` on the card, affinity and round-robin (routed
     counts, hit rate, tokens/s; tokens against 15c's cold run); (e) a
     flight dump when a ``FrontEnd``'s step raises; (f) ``python -m
     repro_torch.launch.serve``; (g) the reduced model's traces and
     'learned' serving, card with the kernel against the CPU without it.
 17. the LM training stack at full width (drrl-paper in its rank mode
     'drrl', phase 10's seeded agent): (a) ``launch.train.main`` on 8 x 256
     tokens, 4 steps with checkpoints, then 6 steps resumed from step 4 (the
     line ``[ckpt] resumed from step 4``, finite losses, s/step; neither
     kernel launched: the step calls ``loss`` unchunked, as the reference
     does); (b) ``run_training`` 4 steps straight against 2 steps, a
     synchronous checkpoint and a resume to 4, under deterministic
     algorithms: equal; (c) one step with 2 microbatches and bf16
     error-feedback accumulation against one step on the whole batch;
     (d) one step profiled: device busy and idle, eigh's forward and
     backward, cuBLAS, eager ops, copies, AdamW, peak memory; (e) the last
     checkpoint loaded into a fresh (params, AdamWState) template and phase
     3's workload served from it, tokens equal to serving the in-memory
     params, 12 flash_decode launches per fused step; (f) the reduced model
     trained 3 steps on the card and on the CPU; (g) the reference's
     long-sequence training path: 3 steps of ``make_train_step`` with
     ``loss(chunked=True)`` at 2 x 4096 tokens, 12 lowrank_flash and 12
     lowrank_flash_bwd launches per step, step 1 against the same step with
     ``loss(chunked=False)`` (loss within 2e-5, grad norm within 1e-4
     relative, ranks identical), then step 1 again with ``remat`` 'full'
     and 'dots' (each layer checkpointed: 24 lowrank_flash, the forward and
     its recompute, and 12 lowrank_flash_bwd launches) against the plain
     step 1 with the same limits, ranks identical, whether its gradients
     are bitwise the plain step's, 'full''s peak below the plain step's;
     s/step, peak memory of every step, one step profiled (busy, idle, the
     backward kernel's share).
 18. the paper's tables and figures (``benchmarks/torch_*.py``): (a) the
     runner's canary, ``python -m benchmarks.torch_run --smoke``, in its own
     process; (b) every table and figure in quick mode (``bench_cfg``, 8 x
     128 tokens), Table 3 through ``examples/finetune_classification_torch.
     py``: each result's keys, lengths, finite perplexities, accuracies and
     curves, fractions in (0, 1], its CSV ``derived`` string and wall time;
     the paper's claims reported, not asserted; one ``train_lm`` step of
     ``bench_cfg`` profiled (eigh's share); (c) the same functions on
     drrl-paper at full width with phase 10's agent: 2 ``train_lm`` steps in
     'fixed', ``eval_ppl``, the FLOPs fraction in 'adaptive' and 'drrl', one
     Table 3 fine-tune step, Fig. 4's mean rank over 2 x 4096 tokens and the
     reduction at L = 4096, Fig. 5's heatmap on grid 16 ... 64; (d)
     ``train_lm`` and ``eval_ppl`` of ``bench_cfg`` on the card and on the
     CPU from the same weights (1e-4 relative, ranks equal); (e) neither
     kernel launched: the tables run unchunked at 128 tokens, as the
     reference's do.
 19. the invariant checker (``repro_torch.analysis``): (a) ``python
     tools/check_invariants_torch.py --selftest`` and its static pass over
     ``src/repro_torch`` in their own processes (clean; the suppressed
     findings counted by rule); (b) the runtime sanitizer's four scenarios
     (``mixed_sampling``, ``speculative``, ``learned_policy``,
     ``observability``) at full width: warm then steady, every fused step of
     the steady phase under ``torch.cuda.set_sync_debug_mode("error")``, zero
     kernel builds or dynamo graphs in the steady phase, and flash_decode
     launched 12 times per guarded step (48 per speculative one, draft_k 3);
     (c) the negative control: a mixed step that also calls ``.item()`` and a
     decode step that builds ``torch.tensor(0., device="cuda")`` must each trip
     the guard; (d) reported, not asserted: phase 3's adaptive serving run
     under ``set_sync_debug_mode("warn")``, every sync counted by the repo
     call site that made it.
 20. the dense configs and the MoE family at full width, bf16, seeded
     weights drawn on the card: (a) both kernels against their plain
     versions at the new shapes, f32 and bf16 (flash_decode at the serving
     shapes of qwen2.5-14b, 40/8 heads of 128, C = 1 and 128, the factor
     read at r = 64, granite's 24/8 of 64, and the GQA groups of internlm2,
     phi3 and deepseek-coder; lowrank_flash at qwen's 2 x 4096, masked r =
     128 and static r = 32 with dv = 128, and MLA's r = 192), timed in bf16
     beside their bounds and SDPA, with the ptxas lines of the
     instantiations they run; (b) qwen2.5-14b served at full width, cut to
     16 of its 48 layers (phase 3's settings and workload shape), 'off' then
     'adaptive': 16 flash_decode launches per fused step, ms/step, tokens/s,
     peak memory, one decision's eigh at full depth (384 Grams of 128 x
     128), tokens against the plain run's; (e) its first 8 layers in
     forward_dense(chunked=True) over 2 x 4096, adaptive/masked and
     fixed/static, against the plain path; (c) granite-moe-3b-a800m served
     at full width, cut to 16 of its 32 layers, in 'adaptive' (16 launches
     per step), the share of (token, expert) pairs capacity drops in mixed
     and decode steps, tokens against the plain run with the routing pinned,
     and a guarded steady run of its fused step (no sync, no build); (d)
     internlm2-20b, phi3-medium-14b and deepseek-coder-33b cut to 4 layers,
     one 'adaptive' run each against the plain run; (f) DeepSeek-V3 cut to 1
     dense + 1 MoE layer + MTP: forward_deepseek(chunked=True) over 2 x 4096
     in adaptive/masked (3 lowrank_flash launches at r = 192) against the
     plain path, then 16 decode_step_deepseek steps; (g) the reduced qwen,
     granite and DeepSeek-V3 on the card with the kernels against the CPU;
     (h) qwen2.5-14b's LM step in bf16, full width cut to 2 layers (20b's
     weights), ``make_train_step`` with ``loss(chunked=True)`` at 2 x 4096:
     3 steps in 'off' and one in fixed/static at r = 32 under the config's
     ``remat="dots"``, 4 lowrank_flash (the forward and each layer's
     recompute) and 2 lowrank_flash_bwd launches each, and in 'off' one step
     with ``remat="none"`` from the same start (2 + 2 launches); step 1's
     loss and grad norm, with and without remat, against an f32 reference on
     the same weights no farther than twice the unchunked bf16 step's; the
     dots step's gap to the none step; s/step and peak memory beside the
     unchunked step's, one step profiled (the bf16 backward's device share).
 21. the remaining families at full width, bf16, seeded weights drawn on
     the card (``tools/recurrent_families_smoke.py`` runs it alone): (a)
     lowrank_flash against its plain version, f32 and bf16, at zamba2's
     shared attention (2 x 4096, 32 heads of 112: r = dv = 112),
     seamless's decoder (2 x 2048, 16 of 64) and qwen2-vl's (2 x 4096,
     28/4 of 128), timed in bf16 beside its bound and SDPA, with the ptxas
     lines of those instantiations; then the one-query calls of zamba2's
     and qwen2-vl's dense-cache decodes through ``ops.flash_attention`` on
     views of the cache (flash_decode, one launch each) against
     lowrank_flash_plain, f32 and bf16, timed beside lowrank_flash on the
     copies the call site made before, SDPA and the bound; (b) zamba2-7b
     at full width cut from 81 to ZAMBA_LAYERS = 27 layers (18 Mamba2
     blocks + 9 shared-attention invocations):
     forward_zamba(chunked=True) over 2 x 4096 in 'off' (9 lowrank_flash
     launches) and 'adaptive'/masked with fidelity (18) against the plain
     path, then 4064 tokens prefilled into init_cache_zamba (9
     lowrank_flash launches) and 32 single-token decode steps (9
     flash_decode launches each) against the 'off' forward's logits; (c) rwkv6-1.6b at
     full depth: forward_rwkv over 1 x 4096 (no kernel), 4032 tokens as one
     decode step and 64 single-token steps against it (tokens/s), and layer
     0's wkv6_chunked against wkv6_naive in f32 on its own inputs; (d)
     seamless-m4t-medium: encode over 2 x 1024 frames, forward_encdec(
     chunked=True) over 2 x 2048 tokens (12 launches) against the plain
     path, then prefill_cross, a 64-token prompt and 16 decode steps against
     the forward; (e) qwen2-vl-7b at full depth: forward_dense(chunked=True)
     on 2 x (256 patch embeddings + 3840 tokens) at a 16 x 16 patch grid's
     M-RoPE positions (28 launches) against the plain path, then a 2048-token
     prompt (28 lowrank_flash launches) and 16 decode_step_dense steps (28
     flash_decode launches each) against the teacher-forced forward; wall and peak memory of each; (f) the four reduced models'
     chunked forwards over 1040 positions, card against CPU. Logits within
     two bf16 steps of the largest; a forward's greedy picks agree with the
     plain path's at 0.97 of the positions, and a decode's picks differ only
     at a top-two gap the logits bound allows.
 22. distribution on the card (``tools/dist_smoke.py`` runs it alone), on a
     one-rank NCCL group and its (1, 1) ("data", "model") host mesh: (a)
     drrl-paper at full width in rank mode 'drrl' (phase 17's 8 x 256 tokens
     and agent), its params placed by ``param_pspecs`` (the config's 'dp',
     then 'fsdp_tp', every matrix Shard-placed), 2 sharded training steps
     against the plain step from the same seed (loss, grad norm, every
     param), both steps' ms and the first sharded step's NCCL calls; (b)
     the sharded (params, AdamWState) saved with their specs and loaded
     with ``load(mesh=)``: bitwise, placed as stored; (c) ring attention and
     the pipeline at ring size 1 at 2 x 4096 x 12 x 64 against
     ``kernels/ref.py:flash_ref`` within 2e-5; (d) ``launch.train.main``, 2
     steps, its checkpoint's specs equal to ``param_pspecs`` on the host
     mesh. Neither kernel launches (training runs unchunked).
 23. the dry run (``repro_torch.launch.dryrun``; ``tools/dryrun_smoke.py``
     runs it alone): (a) qwen2.5-14b's three cells (train_4k, prefill_32k,
     decode_32k) at full depth and width on the single production mesh
     (rank 0 of a fake 256-rank group), traced with fake 'cuda' tensors and
     with fake 'cpu' ones, each in a subprocess of its own: FLOPs, bytes,
     collectives and memory equal, the roofline rows and trace seconds
     printed; (b) qwen2.5-14b cut to 2 layers at full widths, train_4k and
     decode_32k, each at the largest power-of-two batch whose one-rank
     prediction peaks at most 60 GB (else 1, if that fits 85 % of the
     card), run for real on a one-rank NCCL host mesh: FlopCounterMode's
     count equal to the prediction, the placed inputs' bytes equal to its
     argument bytes, its peak beside ``max_memory_allocated``, the median
     of 3 event-timed steps beside the roofline bound; prefill_32k's
     prediction printed, not run (it fits no card unchunked). Neither kernel
     launches (the cells run unchunked, as the reference's).

Exits non-zero, printing no result, when no CUDA device is present or any
phase fails. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RankConfig, TrainConfig  # noqa: E402
from repro_torch import nn  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import drrl, lowrank, ppo, prng  # noqa: E402
from repro_torch.data.synthetic import SyntheticClassification, SyntheticLM  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.pipeline import make_pipeline  # noqa: E402
from repro_torch.dist.ring_attention import make_ring_attention  # noqa: E402
from repro_torch.kernels import build, decode_attn, lowrank_flash, ops  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.kernels.ref import flash_ref  # noqa: E402
from repro_torch.configs import cells_for  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import BACKENDS, make_fake_mesh, make_host_mesh  # noqa: E402
from repro_torch.models import encdec, lowrank_cache, rwkv6, rwkv_lm, zamba2  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.deepseek_v3 import forward_deepseek  # noqa: E402
from repro_torch.models.transformer import decode_step_paged, forward_dense  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import make_lr_fn  # noqa: E402
from repro_torch.obs import validate_chrome_trace  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, FleetConfig, FrontEnd,  # noqa: E402
                               Router, SamplingParams, TraceReader, make_workload,
                               workload_names)
from repro_torch.serve.engine import params_to  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import rl  # noqa: E402
from repro_torch.train import serve_policy  # noqa: E402
from benchmarks import (torch_common, torch_fig4_flops_scaling,  # noqa: E402
                        torch_fig5_perturbation, torch_run, torch_table1_lm,
                        torch_table2_ablation, torch_table3_downstream)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores
# wgmma m64n128k16 bf16 with f32 accumulators, measured on an NVIDIA H100 80GB
# HBM3 at 700 W by tools/lowrank_flash_profile.py (tools/mma_tf32_peak.cu; PERF.md)
WGMMA_BF16_FLOPS = 987.4e12
TOL = 2e-5                     # f32 kernel vs plain version
# each kernel and its plain version both stay in f32 up to the one rounding
# of the output, so in bf16 they may differ by one bf16 step (at most 2^-7 of
# the value): hold them to two steps, relative to each element
BF16_REL = 2 ** -6
LOGIT_TOL = 1e-3               # f32 engine step / forward, kernel vs plain attention
GRID = (16, 24, 32, 40, 48, 56, 64)
DEV = "cuda"


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    log(f"{msg} (t = {time.perf_counter() - _T0:.1f} s)")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas=-v report: its
    (mangled) name and template arguments, registers, spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "entry function" in line:
            # the name after its mangled length, template arguments or none
            m = re.search(r"(?<=\d)((?:flash_decode|lowrank_flash)\w*?_kernel\w*?)I(\w*?)E+v",
                          line)
            plain = re.search(r"(?<=\d)((?:flash_decode|lowrank_flash)\w*?_kernel)E", line)
            name = (f"{m.group(1)}<{m.group(2)}>" if m else plain.group(1) if plain
                    else line.split("'")[1][:60])
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def check_bwd_bf16_build(secs: float) -> list:
    """Phase 1's checks of csrc/lowrank_flash_bwd_bf16.cu: no mma.sync
    (HMMA) in its SASS, every product on wgmma; and, when it was built in
    this run, a ptxas report for each of its kernels with no spill store.
    Returns the report's lines."""
    name = "lowrank_flash_bwd_bf16"
    if sass_count(name, "HMMA"):
        raise AssertionError(f"{name}.cu's SASS holds HMMA (mma.sync) instructions")
    lines = ptxas_summary(build.build_log.get(name, (0, ""))[1])
    if secs > 0:
        if not lines:
            raise AssertionError(f"no ptxas report for {name}.cu")
        spilled = [line for line in lines
                   if int(re.search(r"(\d+) bytes spill stores", line).group(1))]
        if spilled:
            raise AssertionError(f"{name}.cu spills: {spilled}")
        log(f"  ptxas: {name}.cu's {len(lines)} kernels store no spill; its SASS holds no HMMA")
    return lines


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of this opcode the built library of
    csrc/<name>.cu holds (cuobjdump -sass of the toolkit that built it)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                         text=True, check=True).stdout
    return sum(opcode in line for line in out.splitlines())


def ints(x):
    return None if x is None else torch.tensor(x, dtype=torch.int32, device=DEV)


# -- phase 2 ---------------------------------------------------------------

# b, hq, hkv, C, M, r, dv, kv_len, q_start, q_lens
CHECK_CASES = [
    (2, 4, 2, 1, 128, 16, 32, (100, 100), None, None),
    (1, 8, 8, 1, 256, 64, 64, (256,), None, None),
    (2, 2, 1, 1, 64, 8, 16, (1, 1), None, None),
    (1, 4, 1, 1, 96, 128, 128, (50,), None, None),
    (1, 8, 2, 1, 37, 24, 16, (30,), None, None),
    (2, 6, 3, 1, 65, 40, 48, (33, 65), None, None),
    (4, 4, 2, 1, 96, 16, 32, (1, 17, 96, 40), None, None),
    (4, 4, 2, 6, 96, 16, 32, (6, 23, 35, 65), (0, 17, 29, 64), None),
    (3, 6, 3, 5, 70, 24, 16, (5, 42, 4), (0, 40, 3), None),
    (2, 4, 4, 7, 40, 40, 8, (7, 37), (0, 30), None),
    (3, 4, 2, 6, 64, 24, 16, (6, 12, 50), (0, 10, 50), (6, 2, 0)),
]
# the serving path's shapes (drrl-paper full width, 8 slots, 2048 positions)
MAIN_DECODE = (8, 12, 12, 1, 2048, 64, 64, (2048, 1, 700, 1500, 2047, 64, 1024, 333),
               None, None)
MAIN_CHUNK = (8, 12, 12, 128, 2048, 64, 64,
              (128, 2048, 300, 1000, 129, 700, 1500, 64),
              (0, 1920, 172, 872, 1, 572, 1372, 63), None)
# speculative serving (phase 15): a draft's single-token read of the factor
# cache at the draft width r_cap = 16 of 64, at MAIN_DECODE's lengths; the
# verify block, C = spec_chunk = 128, q_lens = draft_k + 1 = 5 on six
# decode rows and two prefill rows (128, 70), probabilities on
MAIN_DRAFT = (8, 12, 12, 1, 2048, 16, 64, MAIN_DECODE[7], None, None)
MAIN_VERIFY = (8, 12, 12, 128, 2048, 64, 64,
               (128, 1505, 305, 1005, 134, 642, 2045, 69),
               (0, 1500, 300, 1000, 129, 572, 2040, 64),
               (128, 5, 5, 5, 5, 70, 5, 5))
# K and V as views of (b, rows, hkv, d + pad) cache buffers, as the
# few-query route of ops.flash_attention passes them (kv_len = M; q_start =
# q_offset, or M - 1 when not causal): zamba2's and qwen2-vl's one-query
# decodes, a 16-query call with GQA 7, a non-causal call, and key rows
# 27 elements apart (off 16 bytes: the kernels' plain-load staging):
# (case, (rows, pad))
STRIDED_CASES = [
    ((2, 32, 32, 1, 4064, 112, 112, (4064, 4064), (4063, 4063), None), (4096, 0)),
    ((2, 28, 4, 1, 2050, 128, 128, (2050, 2050), (2049, 2049), None), (2064, 0)),
    ((2, 28, 4, 16, 1100, 128, 128, (1100, 1100), (1084, 1084), None), (1200, 0)),
    ((2, 8, 2, 3, 1500, 64, 64, (1500, 1500), (1499, 1499), None), (1600, 0)),
    ((3, 6, 3, 5, 70, 24, 16, (70, 70, 70), (30, 65, 0), None), (90, 0)),
    ((2, 4, 1, 2, 300, 24, 24, (300, 151), (298, 149), None), (320, 3)),
]


def split_cases(dtype=torch.float32):
    """Cases at the key splits that ``decode_attn.split_plan`` picks on this
    card for the kernel of ``dtype``: kv_len equal to a split's size, one
    less and one more, rows of kv_len 1 and M, a GQA group of 4, and chunks
    in which some queries see no key of a whole split, on the decode path
    (C = 8) and the chunk path (C = 80: two query tiles in f32, three 64-row
    tiles of the kv head's (query, q head) rows in bf16)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split(b, hq, hkv, C, M):
        return decode_attn.split_plan(b, hq, hkv, C, M, sms, dtype)[1]

    L = split(6, 8, 8, 1, 2048)
    G = split(4, 16, 4, 1, 1024)
    D = split(3, 4, 2, 8, 1024)
    K = split(3, 4, 2, 80, 1024)
    return [
        (6, 8, 8, 1, 2048, 64, 64, (L, L - 1, L + 1, 1, 2048, min(2 * L + 3, 2048)),
         None, None),
        (4, 16, 4, 1, 1024, 64, 64, (G, G - 1, G + 1, 1024), None, None),
        (3, 4, 2, 8, 1024, 40, 24, (D + 4, D + 8, 8), (D - 4, D, 0), (8, 8, 5)),
        (3, 4, 2, 80, 1024, 32, 48, (K + 40, min(2 * K + 80, 1024), 80),
         (K - 40, min(2 * K, 944), 0), (80, 80, 70)),
    ]


def make_inputs(case, dtype, seed, return_probs=True, cache=None):
    """The case's inputs; with ``cache`` = (rows, pad), K and V are
    (b, hkv, M, d) views of (b, rows, hkv, d + pad) cache buffers."""
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, hq, C, r), generator=g, device=DEV).to(dtype)
    if cache is None:
        k = torch.randn((b, hkv, M, r), generator=g, device=DEV).to(dtype)
        v = torch.randn((b, hkv, M, dv), generator=g, device=DEV).to(dtype)
    else:
        rows, pad = cache
        k, v = (torch.randn((b, rows, hkv, d + pad), generator=g, device=DEV).to(dtype)
                [:, :M, :, :d].transpose(1, 2) for d in (r, dv))
    if C == 1:
        q = q[:, :, 0]
    return (q, k, v, ints(kl)), dict(scale=r ** -0.5, return_probs=return_probs,
                                     q_start=ints(qs), q_lens=ints(ql))


def visible_keys(q, k, kv_len, q_start, q_lens) -> torch.Tensor:
    """(b, 1, C, M) bool: query j of row b sees key p."""
    q4 = q if q.dim() == 4 else q[:, :, None]
    lens, qs, ql = decode_attn._defaults(q4, kv_len, q_start, q_lens)
    k_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    j = torch.arange(q4.shape[2], device=q.device)[None, None, :, None]
    return ((k_pos < lens[:, None, None, None]) & (k_pos <= qs[:, None, None, None] + j)
            & (j < ql[:, None, None, None]))


def check_decode_case(case, dtype, seed, label="", cache=None) -> float:
    """One case of flash_decode against its plain version: outputs f32
    within 2e-5 + 2e-5 |plain|, bf16 within 2e-5 + two bf16 steps of
    |plain|; probabilities (f32 on both sides, computed in f32 from the same
    inputs) 2e-5 + 2e-5 |plain| in both types. Exact zeros in both types:
    every masked key's probability, and the output of a query with no
    visible key; in f32 also the plain version's whole zero pattern. With
    ``cache`` (make_inputs), K and V are cache views and the outputs must
    also equal, bitwise, the kernel's on contiguous copies of them.
    Returns the larger max error."""
    args, kw = make_inputs(case, dtype, seed=seed, cache=cache)
    o, p = decode_attn.flash_decode(*args, **kw)
    if cache is not None:
        q, k, v, kl = args
        oc, pc = decode_attn.flash_decode(q, k.contiguous(), v.contiguous(), kl, **kw)
        if not (torch.equal(o, oc) and torch.equal(p, pc)):
            raise AssertionError(f"flash_decode on cache views differs from the call on "
                                 f"contiguous copies at {case} {dtype}, cache {cache}")
    torch.cuda.synchronize()
    ro, rp = decode_attn.flash_decode_plain(*args, **kw)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_p = (p - rp).abs().max().item()
    rel = TOL if dtype == torch.float32 else BF16_REL
    bad_o = ((o.float() - ro.float()).abs() > TOL + rel * ro.float().abs()).any().item()
    bad_p = ((p - rp).abs() > TOL + TOL * rp.abs()).any().item()
    ok = visible_keys(args[0], args[1], args[3], kw["q_start"], kw["q_lens"])
    o4, p4 = (o, p) if o.dim() == 4 else (o[:, :, None], p[:, :, None])
    blind = ~ok.any(dim=-1).expand(o4.shape[:3])          # queries with no visible key
    zeros = bool((p4.masked_select(~ok.expand(p4.shape)) == 0).all()
                 and (o4[blind] == 0).all())
    if dtype == torch.float32:
        zeros = zeros and torch.equal(p == 0, rp == 0)
    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(p).all())
    if bad_o or bad_p or not zeros or not finite:
        raise AssertionError(f"flash_decode disagrees with its plain version at "
                             f"{case} {dtype}: out {err_o:.3g} (tol {TOL:g} + "
                             f"{rel:.3g}*|plain|), probs {err_p:.3g}, zero pattern "
                             f"{zeros}, finite {finite}")
    view = "" if cache is None else f" (views of {cache[0]} cache rows, pad {cache[1]}; " \
                                    "bitwise the contiguous call)"
    log(f"  {label}{str(dtype)[6:]:8s} b,hq,hkv,C,M,r,dv={case[:7]} kv_len={case[7]}{view}: "
        f"max|out-plain| {err_o:.3g} (tol {TOL:g} + {rel:.3g}*|plain|), "
        f"max|probs-plain| {err_p:.3g}")
    return max(err_o, err_p)


def decode_cases() -> list:
    """Phase 2's contiguous (case, dtype) pairs, in order: every case in f32
    and bf16, then the bf16 kernel's own split boundaries in bf16."""
    cases = [(c, dt) for c in CHECK_CASES + split_cases()
             + [MAIN_DECODE, MAIN_CHUNK, MAIN_DRAFT, MAIN_VERIFY]
             for dt in (torch.float32, torch.bfloat16)]
    return cases + [(c, torch.bfloat16) for c in split_cases(torch.bfloat16)]


def check_kernel() -> float:
    """``decode_cases`` (seed = the index), then STRIDED_CASES in f32 and
    bf16 (``check_decode_case``); returns the largest f32 error."""
    worst = 0.0
    cases = [(c, dt, i, None) for i, (c, dt) in enumerate(decode_cases())]
    cases += [(c, dt, 1000 + i, cache) for i, (c, cache) in enumerate(STRIDED_CASES)
              for dt in (torch.float32, torch.bfloat16)]
    for case, dtype, seed, cache in cases:
        err = check_decode_case(case, dtype, seed=seed, cache=cache)
        if dtype == torch.float32:
            worst = max(worst, err)
    return worst


def check_bf16_decode_p_case() -> dict:
    """qwen2.5-14b's chunk shape in bf16 (40/8 heads, r = dv = 128, C =
    128): the kernel within 2e-5 + 2^-6 |plain| of the plain version, and
    the plain version with its probabilities rounded once to bf16 before P.V
    outside it, else the case could not catch a kernel that kept P as one
    bf16 term. Returns both counts."""
    case = FAMILY_DECODE["qwen2.5-14b chunk"]
    args, kw = make_inputs(case, torch.bfloat16, seed=202)
    o = decode_attn.flash_decode(*args, **kw)[0].float()
    torch.cuda.synchronize()
    ro, rp = decode_attn.flash_decode_plain(*args, **kw)
    ro = ro.float()
    v = args[2]
    one = torch.einsum("bhck,bhkd->bhcd", rp.to(torch.bfloat16).float(),
                       v.float().repeat_interleave(case[1] // case[2], dim=1))
    one = one.to(torch.bfloat16).float()
    lim = TOL + BF16_REL * ro.abs()
    res = {"outputs": ro.numel()}
    for name, x in (("kernel", o), ("plain_one_bf16_p", one)):
        d = (x - ro).abs()
        res[name] = {"max_abs_err": d.max().item(), "over_tol": int((d > lim).sum().item())}
    if res["kernel"]["over_tol"]:
        raise AssertionError(f"flash_decode disagrees with its plain version at {case[:7]} "
                             f"bf16: {res['kernel']} (tol {TOL:g} + {BF16_REL:.3g}*|plain|)")
    if not res["plain_one_bf16_p"]["over_tol"]:
        raise AssertionError(f"P rounded once to bf16 stays within the tolerance at {case[:7]} "
                             f"({res['plain_one_bf16_p']}): the case cannot tell one bf16 "
                             "term from two")
    log(f"  bfloat16 b,hq,hkv,C,M,r,dv={case[:7]} (qwen2.5-14b chunk): max|out-plain| "
        f"{res['kernel']['max_abs_err']:.3g}, 0 of {ro.numel()} past the tolerance; the plain "
        f"version with P rounded once to bf16 {res['plain_one_bf16_p']['max_abs_err']:.3g}, "
        f"{res['plain_one_bf16_p']['over_tol']} past it (tol {TOL:g} + {BF16_REL:.3g}*|plain|: "
        "the kernel meets it, one bf16 term of P would not)")
    return res


# -- phase 3 ---------------------------------------------------------------

def serve(cfg, params, agent=None, *, n_req=8, max_new=64, seed=1, per_request=None,
          driver=None, **knobs):
    """Phase 3's workload through Engine: ``per_request`` gives each
    request's SamplingParams keywords (greedy by default), ``driver(eng,
    handles)`` runs the loop instead of ``eng.run()``."""
    prompts, arrivals = phase3_workload(cfg.vocab_size, n_req, seed)
    return serve_prompts(cfg, params, agent, prompts=prompts, arrivals=arrivals,
                         max_new=max_new, per_request=per_request, driver=driver,
                         **knobs)


def phase3_workload(vocab, n_req=8, seed=1):
    """Phase 3's prompts (256..1536 tokens) and arrivals (every 2 steps)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(256, 1537, n_req)]
    return prompts, [2 * i for i in range(n_req)]


def serve_prompts(cfg, params, agent=None, *, prompts, arrivals, max_new=64,
                  per_request=None, driver=None, **knobs):
    """``prompts`` arriving at the steps ``arrivals`` through Engine; the
    launch counts are set to 0 just before warmup and read after the run.
    Returns (engine, tokens per request, flash_decode launches, vetoes)."""
    eng = Engine(cfg, params, agent, device=DEV, config=EngineConfig(**knobs))
    per_request = per_request or [{}] * len(prompts)
    hs = [eng.submit(p, SamplingParams(max_new=max_new, **sp), arrival=a)
          for p, a, sp in zip(prompts, arrivals, per_request)]
    reset_launches()
    eng.warmup()
    # bank each decision's veto flag (a device bool) as the run goes
    vetoes, decide = [], eng.core._decide

    def banked(*args):
        out = decide(*args)
        vetoes.append(out[4])
        return out
    if decide is not None:
        eng.core._decide = banked
    if driver is None:
        eng.run()
    else:
        driver(eng, hs)
    launches = decode_attn.LAUNCHES["flash_decode"]
    outs = [h.result() for h in hs]
    return eng, outs, launches, int(sum(bool(v) for v in vetoes))


def check_serving(cfg, params, label, card_name, agent=None, **knobs):
    knobs = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                 use_kernel=True, **knobs)
    eng, outs, launches, vetoes = serve(cfg, params, agent, **knobs)
    st = eng.stats
    n_req = len(outs)
    for i, o in enumerate(outs):
        assert o.shape == (64,), f"request {i} returned {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), f"request {i}: bad token ids"
    # every attention of every fused step, warmup's two steps included
    n_steps = st["steps"] + eng.core.warmup_steps
    want = cfg.num_layers * n_steps
    assert launches == want, f"{launches} kernel launches, expected {want}"
    ranks = {int(r) for step in eng.ranks_per_step() for r in step if r >= 0}
    assert ranks and ranks <= set(GRID), f"ranks {ranks} outside the grid"
    assert st["decides"] >= 2 * n_req, f"{st['decides']} decisions for {n_req} requests"
    tok_s = st["tokens_decoded"] / st["decode_s"]
    ms_step = 1e3 * st["decode_s"] / st["steps"]
    log(f"  {label}: {n_req} requests x 64 tokens, {st['steps']} fused steps "
        f"({st['mixed_steps']} mixed), {st['decides']} decisions ({vetoes} vetoed), "
        f"ranks {sorted(ranks)}, kernel launches {launches} = {cfg.num_layers} layers "
        f"x {n_steps} steps (warmup's 2 included); {tok_s:.1f} decoded tokens/s, "
        f"{ms_step:.2f} ms/step [{card_name}]")
    return outs, launches, st


def check_small_reference(mode="adaptive"):
    """Reduced drrl-paper: the card with the kernel vs the CPU without it.
    In rank mode 'drrl' (the reduced model's own), with a seeded agent."""
    cfg = get_config("drrl-paper", reduced=True)
    agent = None
    if mode == "drrl":
        agent = drrl.init_agent(torch.Generator().manual_seed(7), cfg.rank,
                                cfg.d_model, device="cpu")
    else:
        cfg = cfg.with_(rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16),
                                        segment_len=8))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    knobs = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
                 max_new_cap=12, prefill_chunk=8)
    outs = {}
    for device, use_kernel in ((DEV, True), ("cpu", False)):
        rng = np.random.default_rng(0)
        eng = Engine(cfg, params, agent, device=device,
                     config=EngineConfig(use_kernel=use_kernel, **knobs))
        hs = [eng.submit(rng.integers(0, 256, int(n)), SamplingParams(max_new=12),
                         arrival=2 * i) for i, n in enumerate(rng.integers(8, 33, 6))]
        eng.run()
        outs[device] = ([h.result() for h in hs], eng.ranks_per_step())
    (tok_gpu, rk_gpu), (tok_cpu, rk_cpu) = outs[DEV], outs["cpu"]
    for a, b in zip(tok_gpu, tok_cpu):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rk_gpu, rk_cpu):
        np.testing.assert_array_equal(a, b)
    ranks = sorted({int(r) for step in rk_gpu for r in step if r >= 0})
    log(f"  reduced model, {mode}: 6 requests, GPU kernel tokens and ranks == CPU "
        f"plain tokens and ranks ({len(rk_gpu)} steps, ranks {ranks})")


# -- phase 4 ---------------------------------------------------------------

def check_engine_step(cfg, params):
    """One full-width mixed step: 3 rows prefilling a 128-token chunk, 4
    rows decoding at their own lengths and ranks, 1 idle row."""
    g = torch.Generator(device=DEV).manual_seed(3)
    ns, ps, M, C = 8, 16, 2048, 128
    L, h, d = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    pps = M // ps
    pool_k = torch.randn((L, ns * pps + 1, ps, h, d), generator=g, device=DEV)
    pool_v = torch.randn((L, ns * pps + 1, ps, h, d), generator=g, device=DEV)
    page_table = torch.arange(1, ns * pps + 1, device=DEV).reshape(ns, pps)
    page_table[7] = 0
    lens = torch.tensor([0, 512, 1800, 7, 300, 1024, 2000, 0], device=DEV)
    active = torch.tensor([True] * 7 + [False], device=DEV)
    prefill = torch.tensor([True, True, True] + [False] * 5, device=DEV)
    q_lens = torch.where(prefill, torch.full_like(lens, C), torch.ones_like(lens))
    tokens = torch.randint(0, cfg.vocab_size, (ns, C), generator=g, device=DEV)
    basis = torch.linalg.qr(torch.randn((L, ns, h, d, d), generator=g, device=DEV))[0]
    ranks = torch.tensor([64, 64, 64, 16, 32, 48, 64, 64], device=DEV)
    mass = torch.zeros((L, ns, M, h), device=DEV)
    logits = {}
    for use_kernel in (True, False):
        lg, _ = decode_step_paged(cfg, params, pool_k.clone(), pool_v.clone(),
                                  page_table, tokens, slot_lens=lens,
                                  slot_ranks=ranks, basis=basis, active=active,
                                  use_kernel=use_kernel, mass_pool=mass.clone(),
                                  q_lens=q_lens, prefill_rows=prefill)
        logits[use_kernel] = lg[active]
    a, b = logits[True], logits[False]
    assert torch.isfinite(a).all() and a.shape == (7, 1, cfg.vocab_size)
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    assert err <= LOGIT_TOL * max(1.0, b.abs().max().item()), \
        f"engine step: kernel vs plain attention logits differ by {err}"
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"  full-width mixed step: max|logits(kernel) - logits(plain)| {err:.3g} "
        f"(relative {rel:.3g}, tol {LOGIT_TOL}), greedy agreement {same:.3f}")


# -- phase 5 ---------------------------------------------------------------

_FLUSH = []


def flush_l2() -> None:
    """Evict the 50 MB L2 before a timed call, outside its event pair: write
    a 256 MB buffer, then read another one, so that the written lines are
    written back here and not inside the timed call. Then hold the device
    for about half a millisecond, so that the host has queued the whole
    timed call before its first event fires: the events time the device,
    not the wrapper's host-side launch overhead."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(64 << 20, device=DEV) for _ in range(2))
    _FLUSH[0].zero_()
    _FLUSH[1].sum()
    torch.cuda._sleep(1_000_000)


def time_ms(fn, n=25) -> float:
    """Median of n individually event-timed calls after warm-up, each on a
    cold L2 (the serving caller's K/V do not stay in L2 between layers)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush_l2()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(case, probs=True, elem=4) -> tuple:
    """Least time for the work these inputs need: bytes (q, the K/V rows
    up to each row's kv_len and out at ``elem`` bytes an element, and the
    f32 probs when asked for) over HBM bandwidth, and the operations (2 (r +
    dv) per visible query-key pair) over the peak of the inputs' type: bf16
    (``elem`` 2) on the tensor cores, f32 outside them."""
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    kl = np.minimum(np.asarray(kl), M)
    qs = np.asarray(kl) - C if qs is None else np.asarray(qs)
    ql = np.full(b, C) if ql is None else np.asarray(ql)
    nbytes = (elem * (b * hq * C * r + hkv * kl.sum() * (r + dv) + b * hq * C * dv)
              + 4 * (b * hq * C * M if probs else 0) + 12 * b)
    j = np.arange(C)[None, :]
    vis = np.clip(np.minimum(kl[:, None], qs[:, None] + j + 1), 0, None) * (j < ql[:, None])
    flops = 2 * (r + dv) * hq * vis.sum()
    peak = BF16_FLOPS if elem == 2 else F32_FLOPS
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(case, q, k, v):
    """scaled_dot_product_attention on the same q/k/v and masks (no probs;
    a query past its row's q_lens sees no key)."""
    import torch.nn.functional as F
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    q4 = q if q.dim() == 4 else q[:, :, None]
    klt = torch.tensor(kl, device=DEV)
    qst = klt - C if qs is None else torch.tensor(qs, device=DEV)
    qlt = torch.full_like(klt, C) if ql is None else torch.tensor(ql, device=DEV)
    pos = torch.arange(M, device=DEV)
    j = torch.arange(C, device=DEV)
    mask = ((pos[None, None, :] <= qst[:, None, None] + j[None, :, None])
            & (pos < klt[:, None, None])
            & (j[None, :, None] < qlt[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                  scale=r ** -0.5, enable_gqa=hq != hkv)


def time_kernel(case, card_name, dtype=torch.float32):
    """The kernel and its plain version without probabilities (the library
    call's output) and with them (the serving path's call), SDPA, bounds.
    The first five keys are the no-probabilities numbers."""
    b, hq, hkv, C, M, r, dv, _, _, ql = case
    elem = torch.finfo(dtype).bits // 8
    res = {}
    for probs in (False, True):
        (q, k, v, kl), kw = make_inputs(case, dtype, seed=7, return_probs=probs)
        ms = time_ms(lambda: decode_attn.flash_decode(q, k, v, kl, **kw))
        plain_ms = time_ms(lambda: decode_attn.flash_decode_plain(q, k, v, kl, **kw))
        bnd, by = bound_ms(case, probs, elem)
        if not probs:
            lib_ms = time_ms(library_call(case, q, k, v))
            res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                       bound_by=by)
        else:
            res.update(ms_probs=ms, plain_ms_probs=plain_ms, bound_ms_probs=bnd)
        heads = f"hq=hkv={hq}" if hq == hkv else f"hq={hq}, hkv={hkv}"
        log(f"  flash_decode C={C} (b={b}, {heads}, r={r}, dv={dv}, M={M}"
            f"{'' if ql is None else ', q_lens ' + str(ql)}, {str(dtype)[6:]}, "
            f"{'with' if probs else 'no'} probs, L2 flushed): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of bound"
            + ("" if probs else f", sdpa (no probs) {lib_ms:.4f} ms") + f" [{card_name}]")
    return res


# CUPTI's own buffer handling, reported beside the kernels: not device work
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")
# device time by layer, first match wins (lower-case substrings of kernel names)
LAYERS = (("flash_decode kernel", ("flash_decode_kernel",)),
          ("lowrank_flash kernel", ("lowrank_flash_kernel",)),
          ("lowrank_flash backward kernel", ("lowrank_flash_bwd",)),
          ("eigh (cuSOLVER)", ("syev", "jacobi", "rotate_batch", "cusolver",
                               "sytrd", "ormtr")),
          ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv", "nvjet")),
          ("copies", ("memcpy", "memset")))
OTHER = "other (elementwise, gather, reduce)"


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


KernelSum = collections.namedtuple("KernelSum", "key count self_device_time_total")


def raw_device_kernels(prof):
    """The profile's device kernels (CUPTI's own buffer work left out),
    summed by kernel name from the profiler's raw events, without building
    its Python event tree (tens of seconds for a serving run's or a
    training step's 10^5 device events)."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name() not in PROFILER_OVERHEAD:
            n, us = agg.get(e.name(), (0, 0.0))
            agg[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    if not agg:
        raise AssertionError("the profiler recorded no device time")
    return [KernelSum(k, n, us) for k, (n, us) in agg.items()]


def kernel_us(fn, n=10, attempts=3) -> dict:
    """Mean device microseconds per call of each kernel fn launches
    (torch.profiler, L2 flushed before each call; flush_l2's own kernels
    left out). A profile that recorded no device activity (CUPTI now and
    then returns none for a short profile right after another) is taken
    again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        try:
            kern = raw_device_kernels(prof)
            break
        except AssertionError:
            if attempt == attempts - 1:
                raise
            log("  (the profiler recorded no device time; profiling again)")
    flush = ("spin_kernel", "FillFunctor<float>", "reduce_kernel")
    return {e.key: dev_us(e) / n for e in kern if not any(f in e.key for f in flush)}


def by_layer(kern) -> dict:
    """Device microseconds summed by LAYERS, the rest under OTHER."""
    out = {name: 0.0 for name, _ in LAYERS}
    out[OTHER] = 0.0
    for e in kern:
        low = e.key.lower()
        name = next((n for n, pats in LAYERS if any(p in low for p in pats)), OTHER)
        out[name] += dev_us(e)
    return out


def log_layers(layers: dict, busy: float) -> None:
    for name, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        if us > 0:
            log(f"    {us / 1e3:9.2f} ms {us / busy:6.1%}  {name}")


def profile_serving(cfg, params, card_name, plain_wall_s):
    """Where the time of a serving run goes on the card: the adaptive run
    of phase 3 again, device activity only under torch.profiler, its
    kernels' device time summed by layer. The idle share is taken against
    both the profiled wall time and ``plain_wall_s``, the same run's wall
    time without the profiler (tracing slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    eng = Engine(cfg, params, device=DEV, config=EngineConfig(
        n_slots=8, max_len=2048, page_size=16, prefill_chunk=128, use_kernel=True))
    for i, n in enumerate(rng.integers(256, 1537, 8)):
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)),
                   SamplingParams(max_new=64), arrival=2 * i)
    eng.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        wall_us = 1e6 * (time.perf_counter() - t0)

    kern = raw_device_kernels(prof)
    busy = sum(dev_us(e) for e in kern)
    st = eng.stats
    plain_us = 1e6 * plain_wall_s
    log(f"  profiled serving run: {st['steps']} steps ({st['mixed_steps']} mixed, "
        f"{st['decides']} decisions), device busy {busy / 1e3:.1f} ms; wall "
        f"{wall_us / 1e3:.1f} ms profiled (idle {1 - busy / wall_us:.1%}), "
        f"{plain_us / 1e3:.1f} ms unprofiled (idle {1 - busy / plain_us:.1%}) "
        f"[{card_name}]")
    layers = by_layer(kern)
    log_layers(layers, busy)
    log(f"  per decision: {layers['eigh (cuSOLVER)'] / 1e3 / st['decides']:.2f} "
        f"ms of eigh; per fused step: {layers['flash_decode kernel'] / 1e3 / st['steps']:.2f} "
        f"ms of flash_decode, {busy / 1e3 / st['steps']:.2f} ms of device work")
    log("  top kernels:")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / busy:6.1%} "
            f"x{e.count:<6d} {e.key[:90]}")


# -- phase 6 ---------------------------------------------------------------

# tests/test_torch_flash.py:FLASH_CASES plus its q_offset cases (the last
# one shaped like decode_step_dense's call: one query after a dense cache of
# more than 1024 keys), that call at full width, and the forward path's
# shapes: b, hq, hkv, sq, skv, r, dv, causal, q_offset
FLASH_CASES = [
    (2, 4, 2, 64, 64, 16, 32, True, 0),
    (1, 4, 4, 128, 128, 64, 64, True, 0),
    (2, 2, 1, 48, 96, 8, 16, False, 0),
    (1, 8, 2, 37, 37, 24, 16, True, 0),
    (1, 2, 2, 16, 16, 128, 128, True, 0),
    (2, 6, 3, 33, 65, 40, 48, True, 0),
    (1, 4, 2, 40, 40, 12, 16, True, 0),
    (2, 2, 2, 24, 24, 4, 8, True, 0),
    (1, 2, 1, 17, 17, 16, 16, True, 0),
    (1, 8, 2, 40, 40, 128, 128, True, 0),
    (1, 2, 2, 20, 20, 6, 10, True, 0),
    (1, 2, 2, 4, 32, 16, 16, True, 28),
    (1, 4, 2, 1, 1100, 16, 16, True, 1099),
    (2, 12, 12, 1, 1100, 64, 64, True, 1099),
]
PATH_MASKED = (2, 12, 12, 4096, 4096, 64, 64, True, 0)   # adaptive/masked: r = dh
PATH_STATIC = (2, 12, 12, 4096, 4096, 32, 64, True, 0)   # static_rank 32
# f32, q and k scaled by 4 (scores 16 times larger): one pass of TF32 (a
# 10-bit mantissa) misses 2e-5 here, so the check tells split TF32 from it
TF32_CASE = (1, 4, 4, 256, 256, 64, 64, True, 0)


def flash_inputs(case, dtype, seed):
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, hq, sq, r), generator=g, device=DEV).to(dtype)
    k = torch.randn((b, hkv, skv, r), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=g, device=DEV).to(dtype)
    return (q, k, v), dict(scale=r ** -0.5, causal=causal, q_offset=off)


def check_flash_case(case, dtype, seed, label="") -> float:
    """One case of lowrank_flash against its plain version: f32 within
    2e-5 + 2e-5 |plain|, bf16 within 2e-5 + two bf16 steps of |plain|.
    Returns the max error."""
    args, kw = flash_inputs(case, dtype, seed=seed)
    o = lowrank_flash.lowrank_flash(*args, **kw)
    torch.cuda.synchronize()
    ro = lowrank_flash.lowrank_flash_plain(*args, **kw)
    diff = (o.float() - ro.float()).abs()
    err = diff.max().item()
    atol = TOL
    rtol = atol if dtype == torch.float32 else BF16_REL
    tol = f"{atol:g} + {rtol:.3g}*|plain|"
    if (diff > atol + rtol * ro.float().abs()).any().item():
        raise AssertionError(f"lowrank_flash disagrees with its plain version "
                             f"at {case} {dtype}: {err:.3g} (tol {tol})")
    log(f"  {label}{str(dtype)[6:]:8s} b,hq,hkv,sq,skv,r,dv,causal,q_offset={case}: "
        f"max|out-plain| {err:.3g} (tol {tol})")
    return err


def check_flash() -> float:
    worst = 0.0
    for i, case in enumerate(FLASH_CASES + [PATH_MASKED, PATH_STATIC]):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_flash_case(case, dtype, seed=100 + i)
            if dtype == torch.float32:
                worst = max(worst, err)
    return max(worst, check_tf32_case())


def check_tf32_case() -> float:
    """TF32_CASE in f32: the kernel within 2e-5 + 2e-5 |plain| of the plain
    version, and the plain version run with TF32 matrix products outside
    it (else the case could not catch a kernel that took one pass)."""
    (q, k, v), kw = flash_inputs(TF32_CASE, torch.float32, seed=200)
    q, k = 4 * q, 4 * k
    o = lowrank_flash.lowrank_flash(q, k, v, **kw)
    torch.cuda.synchronize()
    ro = lowrank_flash.lowrank_flash_plain(q, k, v, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ro_tf32 = lowrank_flash.lowrank_flash_plain(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    lim = TOL + TOL * ro.abs()
    err, err_tf32 = ((o - ro).abs().max().item(), (ro_tf32 - ro).abs().max().item())
    if ((o - ro).abs() > lim).any().item():
        raise AssertionError(f"lowrank_flash disagrees with its plain version at "
                             f"{TF32_CASE} (q, k x 4): {err:.3g} (tol {TOL:g} + {TOL:g}*|plain|)")
    if not ((ro_tf32 - ro).abs() > lim).any().item():
        raise AssertionError(f"TF32 products stay within the tolerance at {TF32_CASE} "
                             f"(q, k x 4; {err_tf32:.3g}): the case cannot tell TF32 from f32")
    log(f"  float32  b,hq,hkv,sq,skv,r,dv,causal,q_offset={TF32_CASE}, q and k x 4: "
        f"max|out-plain| {err:.3g}; the plain version with TF32 products {err_tf32:.3g} "
        f"(tol {TOL:g} + {TOL:g}*|plain|: the kernel meets it, one TF32 pass would not)")
    return err


def check_bf16_p_case() -> dict:
    """TF32_CASE in bf16: the kernel within 2e-5 + 2^-6 |plain| of the
    plain version, and the plain version with P rounded once to bf16 before
    P.V outside it (else the case could not catch a kernel that kept P as
    one bf16 term, as FlashAttention and cuDNN do). SDPA on the same inputs
    is logged beside them, its worst error and its outputs past the
    tolerance: it computes a less accurate function."""
    import torch.nn.functional as F
    (q, k, v), kw = flash_inputs(TF32_CASE, torch.bfloat16, seed=201)
    o = lowrank_flash.lowrank_flash(q, k, v, **kw).float()
    torch.cuda.synchronize()
    ro = lowrank_flash.lowrank_flash_plain(q, k, v, **kw).float()
    n_rep = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(n_rep, dim=1)) * kw["scale"]
    sq, skv = s.shape[-2:]
    s = s.masked_fill(torch.arange(skv, device=DEV) > torch.arange(sq, device=DEV)[:, None],
                      float("-inf"))
    p_one = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    one = torch.einsum("bhqk,bhkd->bhqd", p_one, v.float().repeat_interleave(n_rep, dim=1))
    one = one.to(torch.bfloat16).float()
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=kw["scale"],
                                         enable_gqa=True).float()
    lim = TOL + BF16_REL * ro.abs()
    res = {}
    for name, x in (("kernel", o), ("plain_one_bf16_p", one), ("sdpa", lib)):
        d = (x - ro).abs()
        res[name] = {"max_abs_err": d.max().item(), "over_tol": int((d > lim).sum().item())}
    res["outputs"] = ro.numel()
    if res["kernel"]["over_tol"]:
        raise AssertionError(f"lowrank_flash disagrees with its plain version at {TF32_CASE} "
                             f"bf16: {res['kernel']} (tol {TOL:g} + {BF16_REL:.3g}*|plain|)")
    if not res["plain_one_bf16_p"]["over_tol"]:
        raise AssertionError(f"P rounded once to bf16 stays within the tolerance at {TF32_CASE} "
                             f"({res['plain_one_bf16_p']}): the case cannot tell one bf16 "
                             "term from two")
    log(f"  bfloat16 b,hq,hkv,sq,skv,r,dv,causal,q_offset={TF32_CASE}: max|out-plain| "
        f"{res['kernel']['max_abs_err']:.3g}, 0 of {ro.numel()} past the tolerance; the plain "
        f"version with P rounded once to bf16 {res['plain_one_bf16_p']['max_abs_err']:.3g}, "
        f"{res['plain_one_bf16_p']['over_tol']} past it; sdpa "
        f"{res['sdpa']['max_abs_err']:.3g}, {res['sdpa']['over_tol']} past it (tol {TOL:g} + "
        f"{BF16_REL:.3g}*|plain|: the kernel meets it, one bf16 term of P would not)")
    return res


# -- phase 6: the backward ----------------------------------------------------

# lowrank_flash_bwd against lowrank_flash_bwd_plain on the same (q, k, v, out,
# lse, dout), TF32 off: both are f32 sums over up to 4096 keys or queries,
# taken in another order (each side's gradients lie within about 1.6e-6 of
# the tensor's largest magnitude of a float64 backward at 1 x 2 x 4096,
# causal, r = dv = 64: a CPU check), so each gradient is held elementwise to
# BWD_TOL times its largest magnitude
BWD_TOL = 2e-5
# the kernel's log-sum-exp against torch.logsumexp of the plain scores: f32
# sums of up to 4096 terms, absolute + relative
LSE_TOL = 2e-5
# b, hq, hkv, sq, skv, r, dv, causal, q_offset: drrl-paper's masked and static
# training shapes, GQA 4 and 7, q_offset > 0 with sq < skv, non-causal, MLA's
# r = 192 with dv = 128, odd tails (r, dv off a multiple of 4: the plain-load
# staging), and one and 16 queries (which autograd sends here, not to
# flash_decode); the last, qwen2-vl-7b's GQA 7 at r = dv = 128, sums dk and dv
# over 7 x 4096 queries (its plain backward takes some 10 GB)
BWD_CASES = [
    PATH_MASKED,
    PATH_STATIC,
    (1, 8, 2, 300, 300, 64, 64, True, 0),
    (2, 14, 2, 200, 200, 64, 64, True, 0),
    (1, 4, 2, 100, 357, 48, 40, True, 257),
    (2, 4, 4, 130, 250, 64, 64, False, 0),
    (1, 4, 4, 200, 200, 192, 128, True, 0),
    (1, 3, 1, 77, 77, 20, 12, True, 0),
    (2, 2, 2, 65, 129, 36, 72, True, 64),
    (1, 28, 4, 4096, 4096, 128, 128, True, 0),
]
BWD_ROUTE_CASES = [(2, 12, 12, 1, 1100, 64, 64, True, 1099),
                   (1, 28, 4, 16, 1100, 128, 128, True, 1084)]


def bwd_inputs(case, seed, dtype=torch.float32):
    """flash_inputs in ``dtype`` and an output gradient from the same seed."""
    (q, k, v), kw = flash_inputs(case, dtype, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    do = torch.randn(q.shape[:3] + (v.shape[3],), generator=g, device=DEV).to(dtype)
    return (q, k, v, do), kw


def grads_close(got, want, label) -> dict:
    """Each of (dq, dk, dv) within BWD_TOL x its largest |plain| element;
    returns the largest absolute and scaled errors."""
    worst = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        top = w.abs().max().item()
        err = (g - w).abs().max().item()
        if not torch.isfinite(g).all().item() or err > BWD_TOL * top:
            raise AssertionError(f"lowrank_flash_bwd disagrees with its plain version at "
                                 f"{label}: {name} max|kernel-plain| {err:.3g}, tol "
                                 f"{BWD_TOL:g} x {top:.3g}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_scaled_err"] = max(worst["max_scaled_err"], err / top)
    return worst


def check_flash_bwd_case(case, seed) -> dict:
    """The kernel forward with its log-sum-exp (out bitwise the forward
    without it; lse within LSE_TOL of the plain one), then the backward
    kernel against lowrank_flash_bwd_plain on the same inputs."""
    (q, k, v, do), kw = bwd_inputs(case, seed)
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    out_only = lowrank_flash.lowrank_flash(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, out_only):
        raise AssertionError(f"lowrank_flash's out differs with and without lse at {case}")
    _, rlse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    lse_err = (lse - rlse).abs().max().item()
    if ((lse - rlse).abs() > LSE_TOL + LSE_TOL * rlse.abs()).any().item():
        raise AssertionError(f"lowrank_flash's lse disagrees with the plain one at {case}: "
                             f"{lse_err:.3g} (tol {LSE_TOL:g} + {LSE_TOL:g}*|plain|)")
    del rlse
    got = lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    want = lowrank_flash.lowrank_flash_bwd_plain(q, k, v, out, lse, do, **kw)
    res = grads_close(got, want, case)
    log(f"  backward b,hq,hkv,sq,skv,r,dv,causal,q_offset={case}: max|grad-plain| "
        f"{res['max_abs_err']:.3g} ({res['max_scaled_err']:.3g} of the largest |grad|; tol "
        f"{BWD_TOL:g}); lse {lse_err:.3g}; out bitwise with and without lse")
    return res


def check_flash_grad_route(case, seed) -> dict:
    """A call of few queries that requires grad, through ops.flash_attention
    and torch.autograd.grad: one lowrank_flash and one lowrank_flash_bwd
    launch (no flash_decode), the gradients within BWD_TOL of the plain
    backward of the plain forward."""
    (q, k, v, do), kw = bwd_inputs(case, seed)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
    if counts != {"flash_decode": 0, "lowrank_flash": 1, "lowrank_flash_bwd": 1}:
        raise AssertionError(f"a {case[3]}-query call with grad launched {counts}")
    ro, rlse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    if ((out.detach() - ro).abs() > TOL + TOL * ro.abs()).any().item():
        raise AssertionError(f"ops.flash_attention with grad disagrees at {case}")
    res = grads_close(got, lowrank_flash.lowrank_flash_bwd_plain(q, k, v, ro, rlse, do, **kw),
                      case)
    log(f"  ops.flash_attention with grad, {case[3]} queries, {case}: launches {counts}; "
        f"max|grad-plain| {res['max_abs_err']:.3g} ({res['max_scaled_err']:.3g} of the "
        f"largest |grad|)")
    return res


def check_flash_bwd() -> dict:
    """Phase 6's backward checks: every BWD_CASES and BWD_ROUTE_CASES case,
    and two backward runs at PATH_MASKED bitwise equal. Returns the largest
    errors."""
    worst = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    for i, case in enumerate(BWD_CASES):
        res = check_flash_bwd_case(case, seed=300 + i)
        worst = {key: max(worst[key], res[key]) for key in worst}
    for i, case in enumerate(BWD_ROUTE_CASES):
        res = check_flash_grad_route(case, seed=320 + i)
        worst = {key: max(worst[key], res[key]) for key in worst}
    (q, k, v, do), kw = bwd_inputs(PATH_MASKED, seed=330)
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    runs = [lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("two backward runs at PATH_MASKED differ")
    log(f"  two backward runs at {PATH_MASKED}: dq, dk, dv bitwise equal (no atomics)")
    return worst


# -- phase 6: the bf16 backward -----------------------------------------------

# lowrank_flash_bwd on bf16 inputs against lowrank_flash_bwd_plain on the same
# (q, k, v, out, lse, dout), both rounding their f32 gradients to bf16 once:
# each gradient elementwise within BWD_BF16_ATOL of its largest magnitude
# (f32 sums in another order) + BWD_BF16_RTOL of the element (two bf16 steps:
# the one rounding on each side). tests/test_torch_flash_bf16_grad.py fixes it
# on the CPU: the kernel's arithmetic, emulated, meets it against a float64
# backward at every case, and P and dS kept as one bf16 term miss it there
BWD_BF16_ATOL, BWD_BF16_RTOL = 2e-5, 2 ** -6
# the bf16 training shapes: qwen2.5-14b's 2 x 4096 (40 / 8 heads, dv 128; rank
# mode 'off' at r = 128, fixed/static at r = 32) and qwen2-vl-7b's (28 / 4)
QWEN_TRAIN = (2, 40, 8, 4096, 4096, 128, 128, True, 0)
QWEN_TRAIN_STATIC = (2, 40, 8, 4096, 4096, 32, 128, True, 0)
VL_TRAIN = (2, 28, 4, 4096, 4096, 128, 128, True, 0)
# b, hq, hkv, sq, skv, r, dv, causal, q_offset: BWD_CASES' drrl-paper
# training shapes, GQA 4 and 7, q_offset > 0 with sq < skv, non-causal, MLA's
# r = 192 with dv = 128, r and dv off a multiple of 8 (the plain-load
# staging; the last pair odd), and qwen2.5-14b's 2 x 40 / 8 x 4096 at
# r = dv = 128 (its plain backward takes some 25 GB)
BWD_BF16_CASES = [
    PATH_MASKED,
    PATH_STATIC,
    (1, 8, 2, 300, 300, 64, 64, True, 0),
    (2, 14, 2, 200, 200, 64, 64, True, 0),
    (1, 4, 2, 100, 357, 48, 40, True, 257),
    (2, 4, 4, 130, 250, 64, 64, False, 0),
    (1, 4, 4, 200, 200, 192, 128, True, 0),
    (1, 3, 1, 77, 77, 20, 12, True, 0),
    (1, 2, 1, 50, 90, 21, 13, True, 40),
    QWEN_TRAIN,
]
# the long sums: 8 q heads on one kv head over 16384 causal keys, 131,072
# summands per dk / dv row (qwen's shape: 20,480), which the kernel joins
# tile by tile with f32 adds (its plain backward holds about four 8.6 GB f32
# (1, 8, 16384, 16384) matrices)
BWD_BF16_LONG = (1, 8, 1, 16384, 16384, 128, 128, True, 0)


def grads_close_bf16(got, want, label) -> dict:
    """Each of (dq, dk, dv) within BWD_BF16_ATOL x its largest |plain|
    element + BWD_BF16_RTOL |plain| elementwise; returns the largest
    absolute error and the largest error over its limit."""
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16, (name, g.dtype, w.dtype)
        g, w = g.float(), w.float()
        d = (g - w).abs()
        top = w.abs().max().item()
        over = (d / (BWD_BF16_ATOL * top + BWD_BF16_RTOL * w.abs())).max().item()
        if not torch.isfinite(g).all().item() or over > 1.0:
            raise AssertionError(f"bf16 lowrank_flash_bwd disagrees with its plain version at "
                                 f"{label}: {name} max|kernel-plain| {d.max().item():.3g}, "
                                 f"{over:.3g} x the tolerance {BWD_BF16_ATOL:g} x {top:.3g} + "
                                 f"{BWD_BF16_RTOL:g} |plain|")
        worst["max_abs_err"] = max(worst["max_abs_err"], d.max().item())
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"], over)
    return worst


def check_flash_bwd_bf16_case(case, seed) -> dict:
    """The bf16 kernel forward with its log-sum-exp (out bitwise the forward
    without it and within the forward's tolerance of the plain one; lse
    within LSE_TOL of the plain one), then the bf16 backward kernel, twice
    (bitwise equal), against lowrank_flash_bwd_plain on the same inputs."""
    (q, k, v, do), kw = bwd_inputs(case, seed, torch.bfloat16)
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    out_only = lowrank_flash.lowrank_flash(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, out_only):
        raise AssertionError(f"bf16 lowrank_flash's out differs with and without lse at {case}")
    ro, rlse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    lse_err = (lse - rlse).abs().max().item()
    if ((lse - rlse).abs() > LSE_TOL + LSE_TOL * rlse.abs()).any().item():
        raise AssertionError(f"bf16 lowrank_flash's lse disagrees with the plain one at {case}: "
                             f"{lse_err:.3g} (tol {LSE_TOL:g} + {LSE_TOL:g}*|plain|)")
    if ((out.float() - ro.float()).abs() > TOL + BF16_REL * ro.float().abs()).any().item():
        raise AssertionError(f"bf16 lowrank_flash disagrees with its plain version at {case}")
    del ro, rlse
    got = lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw)
    again = lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two bf16 backward runs at {case} differ")
    del again
    want = lowrank_flash.lowrank_flash_bwd_plain(q, k, v, out, lse, do, **kw)
    res = grads_close_bf16(got, want, case)
    log(f"  bf16 backward b,hq,hkv,sq,skv,r,dv,causal,q_offset={case}: max|grad-plain| "
        f"{res['max_abs_err']:.3g} ({res['max_err_over_tol']:.3g} of the tolerance); lse "
        f"{lse_err:.3g}; out bitwise with and without lse; two runs bitwise")
    return res


def check_flash_grad_route_bf16(case, seed) -> dict:
    """check_flash_grad_route in bf16: one lowrank_flash and one
    lowrank_flash_bwd launch, no flash_decode; the gradients against the
    plain backward at the kernel forward's out."""
    (q, k, v, do), kw = bwd_inputs(case, seed, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
    if counts != {"flash_decode": 0, "lowrank_flash": 1, "lowrank_flash_bwd": 1}:
        raise AssertionError(f"a bf16 {case[3]}-query call with grad launched {counts}")
    ro, rlse = lowrank_flash.lowrank_flash_plain(q, k, v, return_lse=True, **kw)
    if ((out.detach().float() - ro.float()).abs()
            > TOL + BF16_REL * ro.float().abs()).any().item():
        raise AssertionError(f"bf16 ops.flash_attention with grad disagrees at {case}")
    res = grads_close_bf16(got, lowrank_flash.lowrank_flash_bwd_plain(
        q, k, v, out.detach(), rlse, do, **kw), case)
    log(f"  bf16 ops.flash_attention with grad, {case[3]} queries, {case}: launches {counts}; "
        f"max|grad-plain| {res['max_abs_err']:.3g} ({res['max_err_over_tol']:.3g} of the "
        f"tolerance)")
    return res


def check_flash_bwd_bf16() -> dict:
    """Phase 6's bf16 backward checks: every BWD_BF16_CASES case,
    BWD_BF16_LONG, and BWD_ROUTE_CASES' one and 16 queries in bf16. Returns
    the largest errors and each case's error over its tolerance."""
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    over = {}
    for i, case in enumerate(BWD_BF16_CASES + [BWD_BF16_LONG]):
        res = check_flash_bwd_bf16_case(case, seed=340 + i)
        worst = {key: max(worst[key], res[key]) for key in worst}
        over[str(case)] = res["max_err_over_tol"]
        free_memory()
    for i, case in enumerate(BWD_ROUTE_CASES):
        res = check_flash_grad_route_bf16(case, seed=360 + i)
        worst = {key: max(worst[key], res[key]) for key in worst}
        over[f"route {case}"] = res["max_err_over_tol"]
    log("  bf16 backward, worst error over the tolerance per case: "
        + ", ".join(f"{case} {x:.3f}" for case, x in over.items()))
    return {**worst, "over_tol_by_case": over}


# -- phase 7 ---------------------------------------------------------------

@contextlib.contextmanager
def plain_flash():
    """Route the model's flash branch through the kernel's plain version
    (on the card) for a reference run; the port itself has no such switch."""
    kernel = ops.flash_attention
    ops.flash_attention = lowrank_flash.lowrank_flash_plain
    try:
        yield
    finally:
        ops.flash_attention = kernel


def forward_cfg(cfg, mode, realisation):
    return cfg.with_(rank=RankConfig(mode=mode, realisation=realisation,
                                     rank_grid=GRID, fixed_rank=32, static_rank=32,
                                     segment_len=32))


# (rank mode, realisation, compute_fidelity)
FORWARDS = (("adaptive", "masked", True), ("fixed", "static", False))


def run_forward(cfg, params, tokens, fid):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux = forward_dense(cfg, params, tokens, chunked=True,
                                collect_aux="ranks", compute_fidelity=fid)
    torch.cuda.synchronize()
    return logits, aux["layers"], time.perf_counter() - t0


def check_forward(cfg_base, params, card_name) -> int:
    """The full-width 2 x 4096 forward in both realisations; returns the
    kernel's launches over both runs."""
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg_base.vocab_size, (2, 4096), generator=g, device=DEV)
    total = 0
    for mode, real, fid in FORWARDS:
        cfg = forward_cfg(cfg_base, mode, real)
        reset_launches()
        logits, aux, wall = run_forward(cfg, params, tokens, fid)
        launches = lowrank_flash.LAUNCHES["lowrank_flash"]
        want = cfg.num_layers * (2 if fid else 1)
        assert launches == want, f"{launches} lowrank_flash launches, expected {want}"
        total += launches
        assert logits.shape == (*tokens.shape, cfg.vocab_size) and torch.isfinite(logits).all()
        with plain_flash():
            logits_p, aux_p, wall_p = run_forward(cfg, params, tokens, fid)
        assert lowrank_flash.LAUNCHES["lowrank_flash"] == launches
        err = (logits - logits_p).abs().max().item()
        top = logits_p.abs().max().item()
        assert err <= LOGIT_TOL * max(1.0, top), \
            f"forward {mode}/{real}: kernel vs plain logits differ by {err}"
        assert torch.equal(aux["rank"], aux_p["rank"]), f"forward {mode}/{real}: ranks differ"
        ranks = sorted(set(aux["rank"].flatten().tolist()))
        line = (f"  {mode}/{real}{' + fidelity' if fid else ''}: {launches} lowrank_flash "
                f"launches = {cfg.num_layers} layers x {want // cfg.num_layers}; "
                f"max|logits - plain| {err:.3g} (max |logit| {top:.3g}, tol {LOGIT_TOL}), "
                f"ranks identical {ranks}")
        if fid:
            f_err = (aux["fidelity"] - aux_p["fidelity"]).abs().max().item()
            line += (f", fidelity {aux['fidelity'].mean().item():.4f} "
                     f"(|kernel - plain| {f_err:.3g})")
        log(line + f"; wall {wall * 1e3:.1f} ms kernel, {wall_p * 1e3:.1f} ms plain "
            f"(first calls) [{card_name}]")
    check_forward_reference()
    return total


def check_forward_reference():
    """Reduced drrl-paper at 1040 tokens (flash branch taken): the card with
    the kernel vs the CPU with the plain version."""
    base = get_config("drrl-paper", reduced=True)
    params = get_model(base).init(torch.Generator().manual_seed(0), device="cpu")
    params_dev = params_to(params, DEV)
    tokens = torch.randint(0, base.vocab_size, (2, 1040),
                           generator=torch.Generator().manual_seed(6))
    for mode, real in (("adaptive", "masked"), ("fixed", "static")):
        cfg = base.with_(rank=RankConfig(mode=mode, realisation=real, rank_grid=(4, 8, 12, 16),
                                         fixed_rank=8, static_rank=8, segment_len=8))
        out = {}
        for dev, p in ((DEV, params_dev), ("cpu", params)):
            lg, aux = forward_dense(cfg, p, tokens.to(dev), chunked=True,
                                    collect_aux="ranks", compute_fidelity=True)
            out[dev] = (lg.cpu(), aux["layers"]["rank"].cpu(), aux["layers"]["fidelity"].cpu())
        (lg, rk, fd), (lg_c, rk_c, fd_c) = out[DEV], out["cpu"]
        err = (lg - lg_c).abs().max().item()
        assert err <= 1e-4, f"reduced forward {mode}/{real}: card vs CPU logits differ by {err}"
        assert torch.equal(rk, rk_c), f"reduced forward {mode}/{real}: ranks differ"
        assert (fd - fd_c).abs().max().item() <= 1e-5
        log(f"  reduced model, 2 x 1040 tokens, {mode}/{real}: card kernel vs CPU plain "
            f"max|logits| diff {err:.3g} (tol 1e-4), ranks and fidelity equal")


# -- phase 8 ---------------------------------------------------------------

def check_oneshot(cfg, params, chunked_outs, card_name):
    """Phase 3's adaptive workload with one-shot prefill: the tokens of the
    chunked run, request by request."""
    eng, outs, launches, _ = serve(cfg, params, n_slots=8, max_len=2048, page_size=16,
                                   prefill_chunk=None, use_kernel=True)
    st = eng.stats
    n_steps = st["steps"] + eng.core.warmup_steps
    assert launches == cfg.num_layers * n_steps, f"{launches} flash_decode launches"
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0   # prefill needs probabilities
    assert st["mixed_steps"] == 0 and st["prefills"] == len(outs)
    for i, (a, b) in enumerate(zip(outs, chunked_outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}: one-shot != chunked")
    log(f"  one-shot: {len(outs)} requests x 64 tokens equal to the chunked run's; "
        f"{st['steps']} decode steps, {st['prefills']} prefills in "
        f"{st['prefill_s'] * 1e3:.1f} ms ({st['stall_s'] * 1e3:.1f} ms of decode stall), "
        f"{st['tokens_decoded'] / st['decode_s']:.1f} decoded tokens/s, flash_decode "
        f"launches {launches} [{card_name}]")


# -- phase 9 ---------------------------------------------------------------

def flash_bound_ms(case, dtype=torch.float32) -> tuple:
    """Least time for the work: q, k, v and out once over HBM bandwidth, and
    the operations (2 (r + dv) per visible query-key pair) over a peak.
    bf16 inputs: the bf16 tensor-core peak. f32 inputs need f32-accurate
    products, which the kernel runs on the tensor cores as three TF32
    products each (split TF32): the TF32 peak over those passes. Returns
    (the bound in ms, what binds it, extra), extra holding the byte time or
    the kernel's own passes over their peak, whichever is larger: for f32
    'bound_tf32_passes_ms' (the three TF32 passes at 495 TFLOP/s), for bf16
    'bound_bf16_passes_ms' (one bf16 pass for Q.K^T and two for P.V, P kept
    as two bf16 terms: 2 (r + 2 dv) per pair at 989 TFLOP/s); and
    'bound_cuda_core_ms', the bound on the f32 CUDA cores, which the
    CUDA-core design before them was held to."""
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    elem = torch.finfo(dtype).bits // 8
    n_bytes = elem * (b * hq * sq * r + b * hkv * skv * (r + dv) + b * hq * sq * dv)
    i = np.arange(sq)
    pairs = np.minimum(skv, off + i + 1).sum() if causal else sq * skv
    flops = 2.0 * b * hq * pairs * (r + dv)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_cc = max(t_bytes, 1e3 * flops / F32_FLOPS)
    if dtype == torch.bfloat16:
        t_ops = 1e3 * flops / BF16_FLOPS
        t_passes = max(t_bytes, 1e3 * 2.0 * b * hq * pairs * (r + 2 * dv) / BF16_FLOPS)
        extra = dict(bound_bf16_passes_ms=t_passes, bound_cuda_core_ms=t_cc)
    else:
        t_ops = max(t_bytes, 1e3 * 2.0 * b * hq * pairs * (3 * r + 3 * dv) / TF32_FLOPS)
        extra = dict(bound_tf32_passes_ms=t_ops, bound_cuda_core_ms=t_cc)
    return (t_bytes, "bytes", extra) if t_bytes >= t_ops else (t_ops, "operations", extra)


def sdpa_backend(q, k, v, scale, causal=True) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (PyTorch's own dispatch decision, the one the call below takes)."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, is_causal=causal, scale=scale,
                                     enable_gqa=True)
    return SDPBackend(choice).name


def time_flash(case, label, card_name, dtype=torch.float32, per_call=True) -> dict:
    import torch.nn.functional as F
    b, hq, hkv, sq, skv = case[:5]
    (q, k, v), kw = flash_inputs(case, dtype, seed=9)
    ms = time_ms(lambda: lowrank_flash.lowrank_flash(q, k, v, **kw), n=15)
    plain_ms = time_ms(lambda: lowrank_flash.lowrank_flash_plain(q, k, v, **kw), n=15)

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=kw["scale"],
                                              enable_gqa=True)
    lib_ms = time_ms(lib, n=15)
    backend = sdpa_backend(q, k, v, kw["scale"])
    bnd, by, extra = flash_bound_ms(case, dtype)
    prof_ms = lib_prof_ms = None
    names = []
    if per_call:
        us = kernel_us(lambda: lowrank_flash.lowrank_flash(q, k, v, **kw))
        names = sorted(name for name in us if "lowrank_flash_kernel" in name)
        prof_ms = sum(us[name] for name in names) / 1e3
        lib_prof_ms = sum(kernel_us(lib).values()) / 1e3
    heads = f"hq=hkv={hq}" if hq == hkv else f"hq={hq}, hkv={hkv}"
    passes = "bf16" if dtype == torch.bfloat16 else "TF32"
    passes_key = f"bound_{passes.lower()}_passes_ms"
    log(f"  lowrank_flash {label} (b={b}, {heads}, sq=skv={sq}, causal, "
        f"{str(dtype)[6:]}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({backend}) {lib_ms:.4f} ms; bound "
        f"{bnd:.4f} ms ({by}), {bnd / ms:.1%} of it; the kernel's {passes} passes "
        f"{extra[passes_key]:.4f} ms, {extra[passes_key] / ms:.1%} "
        f"of it; f32 CUDA-core bound {extra['bound_cuda_core_ms']:.4f} ms, "
        f"{extra['bound_cuda_core_ms'] / ms:.1%} of it"
        + (f"; torch.profiler per call: kernel {prof_ms:.4f} ms ({', '.join(names)}), sdpa "
           f"{lib_prof_ms:.4f} ms" if per_call else "") + f" [{card_name}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                **extra, profiler_ms=prof_ms, profiler_kernels=names,
                library_profiler_ms=lib_prof_ms, sdpa_backend=backend)


def flash_bwd_bound_ms(case, dtype=torch.float32) -> dict:
    """Least time for the backward's work: q, k, v, out, dout and lse read
    once and dq, dk, dv written once over HBM bandwidth, and the operations
    the function needs, S, dP, dv, dk and dq once each, 2 (3 r + 2 dv) per
    visible pair (the kernel's dq pass recomputes S and dP: its own choice,
    not counted). f32 inputs need f32-accurate products, which the tensor
    cores give as three TF32 products each (split TF32, as the forward's
    kernel): ``bound_ms`` takes those three passes at the TF32 peak, the
    larger of that and the byte time; ``bound_cuda_core_ms`` the same
    flops on the f32 CUDA cores (the kernel runs on the tensor cores in
    split TF32; this is the ceiling of a kernel that would not);
    ``bound_done_ms`` the work the kernel does, 2 (4 r + 3 dv) per visible
    pair with its dq pass's recompute, as three TF32 passes. bf16 inputs:
    ``bound_ms`` the needed flops at the bf16 peak (or the byte time);
    ``bound_issued_ms`` the flops the kernel issues, 12 r + 8 dv per pair
    (S and dP twice, P and dS as two bf16 terms in dv, dk and dq), at that
    peak, and ``bound_issued_wgmma_ms`` at wgmma bf16's measured rate
    (WGMMA_BF16_FLOPS)."""
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    i = np.arange(sq)
    pairs = float(np.minimum(skv, off + i + 1).sum() if causal else sq * skv) * b * hq
    flops = 2.0 * pairs * (3 * r + 2 * dv)
    elem = torch.finfo(dtype).bits // 8
    n_bytes = (elem * (2 * b * hq * sq * r + 2 * b * hkv * skv * (r + dv) + 2 * b * hq * sq * dv)
               + 4 * b * hq * sq)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    if dtype == torch.bfloat16:
        t_ops = 1e3 * flops / BF16_FLOPS
        bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        issued = pairs * (12 * r + 8 * dv)
        return dict(bound_ms=bnd, bound_by=by, bound_issued_ms=1e3 * issued / BF16_FLOPS,
                    bound_issued_wgmma_ms=1e3 * issued / WGMMA_BF16_FLOPS,
                    flops=flops, pairs=pairs)
    t_cc = max(t_bytes, 1e3 * flops / F32_FLOPS)
    t_tf32 = 1e3 * 3 * flops / TF32_FLOPS
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_tf32 else (t_tf32, "operations")
    t_done = 1e3 * 3 * 2.0 * pairs * (4 * r + 3 * dv) / TF32_FLOPS
    return dict(bound_ms=bnd, bound_by=by, bound_cuda_core_ms=t_cc, bound_done_ms=t_done,
                flops=flops, pairs=pairs)


def time_flash_bwd(case, label, card_name, dtype=torch.float32) -> dict:
    """The backward kernel at ``case`` (CUDA events, median, L2 flushed),
    its three device kernels' times per call (torch.profiler), its plain
    version, and autograd through scaled_dot_product_attention's backward
    on the same inputs (a yardstick only: the port never calls it), beside
    the bound."""
    import torch.nn.functional as F
    (q, k, v, do), kw = bwd_inputs(case, seed=9, dtype=dtype)
    out, lse = lowrank_flash.lowrank_flash(q, k, v, return_lse=True, **kw)
    ms = time_ms(lambda: lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do, **kw), n=15)
    # "void (anonymous namespace)::lowrank_flash_bwd_dq_kernel<8, 8>(float const*, ...)"
    # -> "dq_kernel<8, 8>"
    per_kernel = {re.sub(r".*lowrank_flash_bwd_|\(.*", "", name): us / 1e3 for name, us in
                  kernel_us(lambda: lowrank_flash.lowrank_flash_bwd(q, k, v, out, lse, do,
                                                                    **kw)).items()
                  if "lowrank_flash_bwd" in name}
    plain_ms = time_ms(lambda: lowrank_flash.lowrank_flash_bwd_plain(q, k, v, out, lse, do,
                                                                    **kw), n=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=kw["scale"],
                                                 enable_gqa=True)
    backend = sdpa_backend(q, k, v, kw["scale"])
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), n=15)
    del lib_out, leaves
    bnd = flash_bwd_bound_ms(case, dtype)
    b, hq, hkv, sq = case[:4]
    heads = f"hq=hkv={hq}" if hq == hkv else f"hq={hq}, hkv={hkv}"
    if dtype == torch.bfloat16:
        bounds = (f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, bf16 tensor cores), "
                  f"{bnd['bound_ms'] / ms:.1%} of it; the flops it issues (12 r + 8 dv per "
                  f"pair) {bnd['bound_issued_ms']:.4f} ms at 989 TFLOP/s, "
                  f"{bnd['bound_issued_ms'] / ms:.1%} of it, "
                  f"{bnd['bound_issued_wgmma_ms']:.4f} ms at wgmma's measured "
                  f"{WGMMA_BF16_FLOPS / 1e12:.1f}, {bnd['bound_issued_wgmma_ms'] / ms:.1%}")
    else:
        bounds = (f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, three TF32 passes), "
                  f"{bnd['bound_ms'] / ms:.1%} of it; the work it does (dq's recompute "
                  f"included) as three TF32 passes {bnd['bound_done_ms']:.4f} ms, "
                  f"{bnd['bound_done_ms'] / ms:.1%} of it; f32 CUDA-core bound "
                  f"{bnd['bound_cuda_core_ms']:.4f} ms, {bnd['bound_cuda_core_ms'] / ms:.1%} "
                  f"of it")
    log(f"  lowrank_flash backward {label} (b={b}, {heads}, sq=skv={sq}, causal, "
        f"{str(dtype)[6:]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
        f"({backend}) {lib_ms:.4f} ms; {bounds}; torch.profiler per call: "
        + ", ".join(f"{name} {t:.4f} ms" for name, t in sorted(per_kernel.items()))
        + f" [{card_name}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, sdpa_backend=backend,
                profiler_ms=per_kernel, **bnd)


def profile_forwards(cfg_base, params, card_name) -> None:
    """Each forward of phase 7 again: wall time unprofiled (median of 3),
    then one run under torch.profiler, device time by layer."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg_base.vocab_size, (2, 4096), generator=g, device=DEV)
    for mode, real, fid in FORWARDS:
        cfg = forward_cfg(cfg_base, mode, real)
        wall = statistics.median(run_forward(cfg, params, tokens, fid)[2] for _ in range(3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_forward(cfg, params, tokens, fid)
        kern = raw_device_kernels(prof)
        busy = sum(dev_us(e) for e in kern)
        log(f"  forward {mode}/{real}{' + fidelity' if fid else ''}, 2 x 4096 tokens: wall "
            f"{wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"(idle {1 - busy / (wall * 1e6):.1%}) [{card_name}]")
        log_layers(by_layer(kern), busy)


# -- phases 10 and 11 --------------------------------------------------------

# agent logits (O(0.01) at init) and delta_a_rel (the Eq. 9 bound already
# relative to ||A||), absolute: the forward through the kernel vs its plain version
AGENT_TOL = 1e-4
# the agent's parts, named in the profiles: (module, function, range name)
AGENT_PARTS = (("drrl", "policy_apply", "policy network"),
               ("drrl", "build_features", "Eq. 6 features"),
               ("drrl", "weight_stats", "weight_stats (w_t)"),
               ("drrl", "conv_features", "conv_features (h_t)"),
               ("policy", "policy_apply", "policy network"),
               ("policy", "build_features", "Eq. 6 features"))


def _modules() -> dict:
    from repro_torch.serve import policy
    return {"drrl": drrl, "policy": policy, "rl": rl, "ppo": ppo, "adamw": adamw}


@contextlib.contextmanager
def agent_ranges(parts=AGENT_PARTS):
    """Wrap ``parts`` (by default the agent's) in torch.profiler ranges for
    a profiled run (the functions are looked up through their modules at
    call time)."""
    from torch.profiler import record_function
    mods = _modules()
    saved = []
    for mod, fn, label in parts:
        inner = getattr(mods[mod], fn)

        def ranged(*a, _inner=inner, _label=label, **kw):
            with record_function(_label):
                return _inner(*a, **kw)
        saved.append((mods[mod], fn, inner))
        setattr(mods[mod], fn, ranged)
    try:
        yield
    finally:
        for mod, fn, inner in saved:
            setattr(mod, fn, inner)


def device_total_us(e) -> float:
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def profile_with_agent(fn, parts=AGENT_PARTS):
    """Run fn under torch.profiler (CPU and CUDA activity) with ranges
    around ``parts``: (device kernels outside the ranges' own entries,
    device µs per range name: the kernels launched inside it, the
    profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {label for _, _, label in parts}
    with agent_ranges(parts), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in raw_device_kernels(prof) if e.key not in names]
    ranges = {e.key: device_total_us(e) for e in prof.key_averages()
              if e.key in names and e.device_type == DeviceType.CPU}
    return kern, ranges, prof


def check_drrl_forward(cfg, params, agent, card_name) -> int:
    """drrl-paper's own rank mode at full width, 2 x 4096 tokens: returns
    the kernel's launches in the counted run."""
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4096), generator=g, device=DEV)

    def run(collect):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = forward_dense(cfg, params, tokens, policy_params=agent,
                                    chunked=True, collect_aux=collect,
                                    compute_fidelity=True)
        torch.cuda.synchronize()
        return logits, aux["layers"], time.perf_counter() - t0

    reset_launches()
    logits, aux, wall_first = run("ranks")
    launches = lowrank_flash.LAUNCHES["lowrank_flash"]
    want = 2 * cfg.num_layers
    assert launches == want, f"drrl forward: {launches} lowrank_flash launches, expected {want}"
    assert logits.shape == (*tokens.shape, cfg.vocab_size) and torch.isfinite(logits).all()
    # kernel vs plain, with the agent's logits ('rl' keeps them)
    logits_k, aux_k, _ = run("rl")
    with plain_flash():
        logits_p, aux_p, _ = run("rl")
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 2 * launches
    assert torch.equal(aux["rank"], aux_k["rank"]), "drrl forward: ranks differ between runs"
    err = (logits_k - logits_p).abs().max().item()
    top = logits_p.abs().max().item()
    assert err <= LOGIT_TOL * max(1.0, top), f"drrl forward: kernel vs plain logits differ by {err}"
    assert torch.equal(aux_k["rank"], aux_p["rank"]), "drrl forward: ranks differ from plain"
    assert torch.equal(aux_k["action_mask"], aux_p["action_mask"]), "drrl forward: masks differ"
    legal = aux_p["action_mask"]
    a_err = (aux_k["logits"] - aux_p["logits"])[legal].abs().max().item()
    d_err = (aux_k["delta_a_rel"] - aux_p["delta_a_rel"]).abs().max().item()
    assert a_err <= AGENT_TOL and d_err <= AGENT_TOL, \
        f"drrl forward: agent logits differ by {a_err}, delta_a_rel by {d_err}"
    mask = aux_k["action_mask"]
    lg = aux_k["logits"].sort(dim=-1).values
    two = lg[..., -2] > -1e29
    gap = (lg[..., -1] - lg[..., -2])[two].min().item() if two.any() else float("inf")
    log(f"  drrl/masked + fidelity: {launches} lowrank_flash launches = {cfg.num_layers} "
        f"layers x 2; max|logits - plain| {err:.3g} (tol {LOGIT_TOL}), ranks and Eq. 11 "
        f"masks identical, agent logits {a_err:.3g}, delta_a_rel {d_err:.3g} (tol "
        f"{AGENT_TOL}); fidelity {aux['fidelity'].mean().item():.4f}")
    per_layer = []
    for li in range(cfg.num_layers):
        r, c = torch.unique(aux["rank"][li], return_counts=True)
        per_layer.append("/".join(f"{int(a)}x{int(b)}" for a, b in zip(r, c)))
    log(f"  ranks per layer (rank x heads over b = 2): {', '.join(per_layer)}")
    log(f"  Eq. 11 mask (eps0 {cfg.rank.epsilon0}, rl_t 0) removed {int((~mask).sum())} of "
        f"{mask.numel()} actions; smallest top-two gap of legal logits {gap:.3g}")
    wall = statistics.median(run("ranks")[2] for _ in range(3))
    kern, parts, _ = profile_with_agent(lambda: run("ranks"))
    busy = sum(dev_us(e) for e in kern)
    log(f"  drrl forward, 2 x 4096 tokens: wall {wall * 1e3:.2f} ms (median of 3; first "
        f"call {wall_first * 1e3:.1f} ms), device busy {busy / 1e3:.2f} ms (idle "
        f"{1 - busy / (wall * 1e6):.1%}) [{card_name}]")
    log_layers(by_layer(kern), busy)
    log("  of which the agent's parts (device time of the kernels each launched):")
    for name, us in parts.items():
        log(f"    {us / 1e3:9.3f} ms {us / busy:6.2%}  {name}")
    return launches


# the profiled reruns of phases 11 (a drrl serving run) and 12 (a BC step)
# record host activity too, whose event tree takes minutes to build at 12
# layers: they run the first PROFILE_LAYERS layers (width unchanged)
PROFILE_LAYERS = 4


def profile_cut(cfg, params):
    """``cfg`` and ``params`` cut to their first PROFILE_LAYERS layers."""
    n = PROFILE_LAYERS
    return (cfg.with_(num_layers=n),
            {**params, "layers": tu.tree_map(lambda t: t[:n], params["layers"])})


def check_drrl_serving(cfg, params, agent, card_name) -> int:
    """Phase 3's workload and engine settings in rank mode 'drrl'; returns
    the kernel's launches."""
    _, launches, st = check_serving(cfg, params, "drrl", card_name, agent,
                                    segment_len=32)
    cut, cut_params = profile_cut(cfg, params)
    eng = Engine(cut, cut_params, agent, device=DEV, config=EngineConfig(
        n_slots=8, max_len=2048, page_size=16, prefill_chunk=128, use_kernel=True,
        segment_len=32))
    rng = np.random.default_rng(1)
    for i, n in enumerate(rng.integers(256, 1537, 8)):
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                   SamplingParams(max_new=64), arrival=2 * i)
    eng.warmup()
    kern, parts, _ = profile_with_agent(eng.run)
    n_dec = eng.stats["decides"]
    layers = by_layer(kern)
    busy = sum(dev_us(e) for e in kern)
    log(f"  profiled drrl serving run, cut to {cut.num_layers} of {cfg.num_layers} layers "
        f"(width unchanged): {n_dec} decisions, device busy {busy / 1e3:.1f} ms; "
        f"per decision {layers['eigh (cuSOLVER)'] / 1e3 / n_dec:.3f} ms of eigh, "
        f"{parts.get('policy network', 0.0) / 1e3 / n_dec:.3f} ms of policy network, "
        f"{parts.get('Eq. 6 features', 0.0) / 1e3 / n_dec:.3f} ms of Eq. 6 features "
        f"(device time) [{card_name}]")
    log_layers(layers, busy)
    check_small_reference("drrl")
    return launches


# -- phase 12 ----------------------------------------------------------------

# the first BC step through the kernel vs through its plain version: the
# oracle's rewards (absolute), bc_loss over the samples whose oracle action the
# mask allows (relative) and each gradient leaf (relative to the leaf's
# largest element)
TRAIN_TOL = 1e-4
# the same step's Eq. 6 features, elementwise: atol + rtol * |plain|; every
# layer's features read that layer's attention output (the kernel's)
FEAT_ATOL, FEAT_RTOL = 1e-5, 1e-5
# the first PPO epoch's ratio_mean: logp_old stored by the rollout's policy
# network vs the loss's fresh one, same agent and features
RATIO_TOL = 1e-5
# the reduced model's bc_loss history, card (kernel) vs CPU (plain), relative
REDUCED_TOL = 1e-5
# the reduced model's agent after 2 BC steps, card vs CPU: AdamW's first steps
# move a leaf by about sign(g) * lr, so a gradient near 0 whose sign differs
# between the two sides moves it by up to 2 lr. Every element is held to 2.5 x
# the largest step's lr (1.2e-4 at step 2 of the 5-step warm-up), and 99 % of
# the elements to 1e-6.
AGENT_ATOL, AGENT_TIGHT, AGENT_TIGHT_SHARE = 2.5 * 3e-4 * 2 / 5, 1e-6, 0.99
# the parts of a BC step named in its profile
TRAIN_PARTS = (("rl", "oracle_actions", "oracle"),
               ("drrl", "policy_apply", "policy network (forward's decisions)"),
               ("ppo", "policy_apply", "policy network (bc_loss forward)"),
               ("adamw", "update", "AdamW"))
_PROBED = (("bc", "rl", "collect_bc_batch"), ("rollout", "rl", "collect_rollout"),
           ("grad", "rl", "value_and_grad"), ("update", "adamw", "update"),
           ("oracle", "rl", "oracle_actions"))


@contextlib.contextmanager
def train_probe():
    """Record train_agent's parts as it runs (looked up through their
    modules at call time): for each call of collect_bc_batch,
    collect_rollout, value_and_grad, adamw.update and oracle_actions its
    wall seconds (the device synchronised before and after), the
    lowrank_flash launches inside it, its outputs and (value_and_grad) the
    loss function's name."""
    mods = _modules()
    rec = {key: [] for key, _, _ in _PROBED}
    saved = []
    for key, mod, fn in _PROBED:
        inner = getattr(mods[mod], fn)

        def probed(*a, _inner=inner, _key=key, **kw):
            torch.cuda.synchronize()
            n0 = lowrank_flash.LAUNCHES["lowrank_flash"]
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            torch.cuda.synchronize()
            rec[_key].append({"s": time.perf_counter() - t0, "out": out,
                              "launches": lowrank_flash.LAUNCHES["lowrank_flash"] - n0,
                              "fn": getattr(a[0], "__name__", "")})
            return out
        saved.append((mods[mod], fn, inner))
        setattr(mods[mod], fn, probed)
    try:
        yield rec
    finally:
        for mod, fn, inner in saved:
            setattr(mod, fn, inner)


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _top_two_gap(rewards):
    r = rewards.sort(dim=-1).values
    return r[..., -1] - r[..., -2]


def _forbidden(ys, mask):
    """Per sample: the oracle's action is one the Eq. 11 mask forbids."""
    return ~mask.gather(1, ys[:, None].long())[:, 0]


def check_grad_guard():
    """Where autograd records a call: ops.flash_attention on f32 and on bf16
    CUDA inputs runs lowrank_flash forward and, under torch.autograd.grad,
    its backward kernel for that type (one launch each);
    ops.decode_attention raises (flash_decode has no backward) and launches
    under no_grad."""
    g = torch.Generator(device=DEV).manual_seed(4)
    q, k, v = (torch.randn((1, 2, 20, 16), generator=g, device=DEV) for _ in range(3))
    kv_len = torch.tensor([12], dtype=torch.int32, device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        leaf = q.to(dtype).requires_grad_(True)
        reset_launches()
        (dq,) = torch.autograd.grad(ops.flash_attention(leaf, k.to(dtype), v.to(dtype),
                                                        scale=0.25).float().sum(), (leaf,))
        torch.cuda.synchronize()
        counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
        assert counts == {"flash_decode": 0, "lowrank_flash": 1, "lowrank_flash_bwd": 1}, counts
        assert dq.dtype == dtype and torch.isfinite(dq.float()).all()

    def call(x):
        return ops.decode_attention(x[:, :, 0].contiguous(), k, v, kv_len, scale=0.25)
    try:
        call(q.clone().requires_grad_(True))
    except RuntimeError as e:
        assert "backward" in str(e), e
    else:
        raise AssertionError("decode_attention took an input that requires grad")
    with torch.no_grad():
        assert torch.isfinite(call(q.clone().requires_grad_(True))).all()
    log("  ops.flash_attention with grad on f32 and on bf16 CUDA inputs: one lowrank_flash "
        "and one lowrank_flash_bwd launch each; ops.decode_attention raises (flash_decode "
        "has no backward) and launches under torch.no_grad()")


def check_training(cfg, params, agent, card_name) -> int:
    """train_agent on the full-width drrl-paper model at 2 x 4096 tokens,
    chunked: 3 BC steps, then 3 PPO steps of 2 epochs; the first BC step
    against the kernel's plain version, one BC step profiled, and the
    reduced model on the card against the CPU. Returns the kernel's
    launches in the train_agent run."""
    L, G = cfg.num_layers, len(cfg.rank.rank_grid)
    bc_steps, ppo_steps, epochs = 3, 3, 2
    data = SyntheticLM(cfg.vocab_size, 4096, 2, seed=0)
    check_grad_guard()
    reset_launches()
    with train_probe() as rec:
        t0 = time.perf_counter()
        new_agent, hist = rl.train_agent(cfg, params, agent, data, bc_steps=bc_steps,
                                         ppo_steps=ppo_steps, ppo_epochs=epochs,
                                         chunked=True)
        wall = time.perf_counter() - t0
    launches = lowrank_flash.LAUNCHES["lowrank_flash"]
    per_bc = [r["launches"] for r in rec["bc"]]
    per_roll = [r["launches"] for r in rec["rollout"]]
    want_bc, want_roll = L * (2 + G), 2 * L
    assert per_bc == [want_bc] * bc_steps, f"lowrank_flash launches per BC step {per_bc}"
    assert per_roll == [want_roll] * ppo_steps, f"launches per rollout {per_roll}"
    assert launches == sum(per_bc) + sum(per_roll), f"{launches} launches in train_agent"
    scalars = hist["bc_loss"] + [h[k] for h in hist["ppo"] for k in sorted(h)]
    assert all(np.isfinite(x) for x in scalars), f"non-finite loss or reward: {hist}"
    assert all(_finite(*tu.leaves(r["out"][1])) for r in rec["grad"]), "non-finite gradient"
    assert all(_finite(r["out"][1]["rewards"]) for r in rec["oracle"]), "non-finite oracle reward"
    assert _finite(*tu.leaves(new_agent)), "non-finite agent after training"
    log(f"  train_agent, {data.global_batch} x {data.seq_len} tokens: {bc_steps} BC steps, "
        f"{ppo_steps} PPO "
        f"steps x {epochs} epochs in {wall:.2f} s; lowrank_flash launches per BC step "
        f"{per_bc} (= {L} forward + {L} x {1 + G} oracle), per rollout {per_roll} (= {L} "
        f"x 2, fidelity), {launches} in all [{card_name}]")
    bc_grads = [r for r in rec["grad"] if r["fn"] == "bc_loss"]
    ppo_grads = [r for r in rec["grad"] if r["fn"] == "ppo_loss"]
    upd = [r["s"] for r in rec["update"]]
    for i, r in enumerate(rec["bc"]):
        _, ys, mask = r["out"]
        forb = _forbidden(ys, mask)
        step_s = r["s"] + bc_grads[i]["s"] + upd[i]
        oracle_s = sum(o["s"] for o in rec["oracle"][i * L:(i + 1) * L])
        log(f"  BC step {i}: wall {step_s * 1e3:.1f} ms (collect {r['s'] * 1e3:.1f}, of "
            f"which oracle {oracle_s * 1e3:.1f}; loss and backward "
            f"{bc_grads[i]['s'] * 1e3:.1f}; AdamW {upd[i] * 1e3:.2f}); bc_loss "
            f"{hist['bc_loss'][i]:.6g}; oracle actions the Eq. 11 mask forbids: "
            f"{int(forb.sum())} of {forb.numel()} ({forb.float().mean().item():.1%}); "
            f"oracle ranks {sorted(set(np.asarray(cfg.rank.rank_grid)[ys.cpu().numpy()].tolist()))}; "
            f"the mask removed {int((~mask).sum())} of {mask.numel()} actions")
    ratios = []
    for i, r in enumerate(rec["rollout"]):
        first = ppo_grads[i * epochs]["out"][0][1]
        ratios.append(first["ratio_mean"].item())
        upd_s = [ppo_grads[i * epochs + e]["s"] + upd[bc_steps + i * epochs + e]
                 for e in range(epochs)]
        h = hist["ppo"][i]
        log(f"  PPO step {i}: rollout {r['s'] * 1e3:.1f} ms, updates "
            f"{', '.join(f'{x * 1e3:.1f}' for x in upd_s)} ms; reward {h['reward']:.6g}, "
            f"mean rank {h['rank_mean']:.4g}, fidelity {h['fidelity']:.6g}, first "
            f"epoch's ratio_mean {ratios[-1]:.8f}, loss {h['loss']:.6g}")
    bad = [x for x in ratios if abs(x - 1.0) > RATIO_TOL]
    assert not bad, f"first-epoch ratio_mean {ratios} not 1 within {RATIO_TOL}"
    check_training_plain(cfg, params, agent, data, rec, bc_grads[0]["out"])
    profile_bc_step(*profile_cut(cfg, params), agent, data, card_name)
    check_training_reference()
    return launches


def check_training_plain(cfg, params, agent, data, rec, kernel_grad):
    """The first BC step of the train_agent run (kernel) again through the
    kernel's plain version on the card."""
    L = cfg.num_layers
    feats_k, ys_k, mask_k = rec["bc"][0]["out"]
    rw_k = torch.stack([r["out"][1]["rewards"] for r in rec["oracle"][:L]])
    n0 = lowrank_flash.LAUNCHES["lowrank_flash"]
    with plain_flash(), train_probe() as rec_p, torch.no_grad():
        feats_p, ys_p, mask_p = rl.collect_bc_batch(cfg, params, agent,
                                                    data.batch_at(0, device=DEV),
                                                    chunked=True)
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == n0, "the plain run launched the kernel"
    rw_p = torch.stack([r["out"][1]["rewards"] for r in rec_p["oracle"]])
    r_err = (rw_k - rw_p).abs().max().item()
    assert r_err <= TRAIN_TOL, f"oracle rewards, kernel vs plain: {r_err}"
    gap = _top_two_gap(rw_p).reshape(-1)
    sure = gap > TRAIN_TOL
    assert torch.equal(ys_k[sure], ys_p[sure]), "oracle actions differ, kernel vs plain"
    assert torch.equal(mask_k, mask_p), "Eq. 11 masks differ, kernel vs plain"
    f_err = 0.0
    for n in feats_p:
        err = (feats_k[n] - feats_p[n]).abs()
        bound = FEAT_ATOL + FEAT_RTOL * feats_p[n].abs()
        assert bool((err <= bound).all()), \
            f"feature {n}, kernel vs plain: {err.max().item()} (tol {FEAT_ATOL} + {FEAT_RTOL} |x|)"
        f_err = max(f_err, err.max().item())
    n_diff = int((ys_k != ys_p).sum())
    # a near-tie the two runs broke apart: the losses then differ by design,
    # so the plain side's loss takes the kernel's actions
    ys_loss = ys_k if n_diff else ys_p
    (loss_k, g_k), (loss_p, g_p) = kernel_grad, rl.value_and_grad(
        ppo.bc_loss, agent, feats_p, ys_loss, mask_p)
    g_rel = 0.0
    for path, gp in tu.leaves_with_path(g_p):
        gk = dict(tu.leaves_with_path(g_k))[path]
        err, top = (gk - gp).abs().max().item(), gp.abs().max().item()
        assert err <= TRAIN_TOL * top, f"bc gradient {path}: kernel vs plain {err} (max {top})"
        g_rel = max(g_rel, err / top if top else 0.0)
    # the whole bc_loss is about (forbidden share) x 1e30, set by the count of
    # forbidden oracle actions alone: compare it over the allowed samples
    ok = ~_forbidden(ys_loss, mask_p)
    assert bool(ok.any()), "the mask forbids every oracle action of the first BC step"
    with torch.no_grad():
        al_k, al_p = (ppo.bc_loss(agent, {n: f[ok] for n, f in feats.items()},
                                  ys_loss[ok], mask_p[ok]).item()
                      for feats in (feats_k, feats_p))
    l_rel = abs(al_k - al_p) / max(abs(al_p), 1e-30)
    assert l_rel <= TRAIN_TOL, f"bc_loss over allowed samples: kernel {al_k} vs plain {al_p}"
    log(f"  first BC step, kernel vs plain version: oracle rewards {r_err:.3g} (tol "
        f"{TRAIN_TOL}), smallest top-two reward gap {gap.min().item():.3g}, actions equal "
        f"where the gap exceeds {TRAIN_TOL} ({n_diff} differ in all), masks equal, features "
        f"{f_err:.3g} (tol {FEAT_ATOL} + {FEAT_RTOL} |x|); bc_loss {loss_k.item():.6g} vs "
        f"{loss_p.item():.6g}, over the {int(ok.sum())} of {ok.numel()} samples the mask "
        f"allows {al_k:.8g} vs {al_p:.8g} (relative {l_rel:.3g}); gradients {g_rel:.3g} of "
        f"each leaf's largest (tol {TRAIN_TOL})")


def profile_bc_step(cfg, params, agent, data, card_name):
    """One BC step (train_agent with bc_steps=1) under torch.profiler: device
    time by layer, the oracle, the policy network, its backward (the
    autograd engine's functions) and AdamW."""
    from torch.autograd import DeviceType

    def one_step():
        rl.train_agent(cfg, params, agent, data, bc_steps=1, ppo_steps=0, chunked=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern, ranges, prof = profile_with_agent(one_step, TRAIN_PARTS)
    busy = sum(dev_us(e) for e in kern)
    backward = sum(device_total_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.key.startswith("autograd::engine::evaluate_function"))
    log(f"  one BC step profiled, cut to {cfg.num_layers} layers (width unchanged): wall "
        f"{wall * 1e3:.1f} ms unprofiled, device busy "
        f"{busy / 1e3:.2f} ms (idle {1 - busy / (wall * 1e6):.1%}) [{card_name}]")
    log_layers(by_layer(kern), busy)
    log("  of which (device time of the kernels each part launched):")
    for name, us in list(ranges.items()) + [("policy backward (autograd engine)", backward)]:
        log(f"    {us / 1e3:9.3f} ms {us / busy:6.2%}  {name}"
            + ("  (not measured: no autograd events)" if name.startswith("policy back")
               and not us else ""))


def check_training_reference():
    """Reduced drrl-paper at 2 x 1040 tokens (the flash branch taken):
    train_agent's BC stage on the card with the kernel vs on the CPU with
    the plain version, from the same batches."""
    base = get_config("drrl-paper", reduced=True)
    params = get_model(base).init(torch.Generator().manual_seed(0), device="cpu")
    agent = drrl.init_agent(torch.Generator().manual_seed(7), base.rank, base.d_model,
                            device="cpu")
    data = SyntheticLM(base.vocab_size, 1040, 2, seed=0)
    out = {}
    for dev in (DEV, "cpu"):
        reset_launches()
        with train_probe() as rec:
            new, hist = rl.train_agent(base, params_to(params, dev), params_to(agent, dev),
                                       data, bc_steps=2, ppo_steps=0, chunked=True)
        ys = torch.cat([r["out"][1].cpu() for r in rec["bc"]])
        masks = torch.cat([r["out"][2].cpu() for r in rec["bc"]])
        rw = torch.stack([r["out"][1]["rewards"].cpu() for r in rec["oracle"]])
        out[dev] = (hist["bc_loss"], ys, masks, rw, lowrank_flash.LAUNCHES["lowrank_flash"],
                    params_to(new, "cpu"))
    (loss_g, ys_g, m_g, rw_g, n_g, a_g), (loss_c, ys_c, m_c, rw_c, n_c, a_c) = \
        out[DEV], out["cpu"]
    want = 2 * base.num_layers * (2 + len(base.rank.rank_grid))
    assert n_g == want and n_c == 0, f"reduced BC: {n_g} / {n_c} launches, expected {want} / 0"
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(loss_g, loss_c))
    assert err <= REDUCED_TOL, f"reduced BC: bc_loss card {loss_g} vs CPU {loss_c}"
    assert torch.equal(ys_g, ys_c), "reduced BC: oracle actions differ, card vs CPU"
    assert torch.equal(m_g, m_c), "reduced BC: masks differ, card vs CPU"
    a_err, tight, total = 0.0, 0, 0
    for (path, g), c in zip(tu.leaves_with_path(a_g), tu.leaves(a_c)):
        diff = (g - c).abs()
        assert diff.max().item() <= AGENT_ATOL, \
            f"reduced BC: agent leaf {path}, card vs CPU {diff.max().item()} (tol {AGENT_ATOL})"
        a_err = max(a_err, diff.max().item())
        tight += int((diff <= AGENT_TIGHT).sum())
        total += diff.numel()
    assert tight >= AGENT_TIGHT_SHARE * total, \
        f"reduced BC: {tight} of {total} agent elements within {AGENT_TIGHT}, card vs CPU"
    forb = _forbidden(ys_c, m_c)
    log(f"  reduced model, final agents card vs CPU: max|diff| {a_err:.3g} (tol "
        f"{AGENT_ATOL:.3g}), {tight} of {total} elements within {AGENT_TIGHT}")
    log(f"  reduced model, 2 x 1040 tokens, 2 BC steps: card kernel ({n_g} launches) vs CPU "
        f"plain bc_loss {loss_g} vs {loss_c} (relative {err:.3g}, tol {REDUCED_TOL}), "
        f"oracle actions and masks identical (smallest top-two reward gap "
        f"{_top_two_gap(rw_c).min().item():.3g}, rewards {(rw_g - rw_c).abs().max().item():.3g}"
        f"); forbidden oracle actions {int(forb.sum())} of {forb.numel()}")


# -- phase 13 ----------------------------------------------------------------

# phase 3's 8 requests: two each of greedy, temperature 0.8, top-k 40 and
# top-p 0.9 (temperature 1 for the last two), each sampled one with its own seed
SAMPLED = [{}, dict(temperature=0.8), dict(temperature=1.0, top_k=40),
           dict(temperature=1.0, top_p=0.9)] * 2
SAMPLED = [dict(sp, seed=100 + i) if sp else {} for i, sp in enumerate(SAMPLED)]
GREEDY_ROWS = (0, 4)
SAMPLE_KNOBS = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                    use_kernel=True, sampling=True, nucleus=True)
# a sampled token may differ, card vs CPU, only where the top two values of
# scaled + gumbel lie closer than this (gumbel's logs may differ by an ulp)
GAP_TOL = 1e-5
# drift threshold of run B: fires where a slot's rank leaves much of the
# newest K token's energy outside its basis (random ranks 16..64 of 64)
DRIFT = 0.5


def sample_scores(logits, out_pos, temps, topks, topps, seeds, cap=64):
    """scaled + gumbel of the engine's sampler (nucleus on), computed apart
    from it: the values whose argmax is a sampled token."""
    V = logits.shape[-1]
    thr = logits.topk(min(cap, V), dim=-1).values.gather(
        1, (topks.long() - 1).clamp(0, min(cap, V) - 1)[:, None])
    x = torch.where((topks[:, None] > 0) & (logits < thr), float("-inf"), logits)
    x = x / temps.clamp_min(1e-6)[:, None]
    pr = torch.softmax(x, dim=-1)
    srt = pr.sort(dim=-1, descending=True).values
    keep = (srt.cumsum(dim=-1) - srt) < topps[:, None]
    p_min = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
    x = torch.where((topps[:, None] < 1.0) & (pr < p_min), float("-inf"), x)
    return x + prng.gumbel(prng.fold_in(prng.key(seeds), out_pos), (V,))


def nucleus_violations(logits, tok, temps, topks, topps, cap=64):
    """Rows sampled with top_p < 1 and their draws outside the nucleus: the
    smallest probability-sorted set whose mass reaches top_p, recomputed in
    float64 after the top-k cut and the temperature."""
    rows = (temps > 0) & (topps < 1.0)
    if not rows.any():
        return 0, 0
    x = logits[rows].double()
    k = topks[rows].long()
    thr = x.topk(cap, dim=-1).values.gather(1, (k - 1).clamp(0, cap - 1)[:, None])
    x = torch.where((k[:, None] > 0) & (x < thr), float("-inf"), x)
    pr = torch.softmax(x / temps[rows].double()[:, None], dim=-1)
    srt = pr.sort(dim=-1, descending=True).values
    n_in = (srt.cumsum(dim=-1) < topps[rows].double()[:, None]).sum(dim=-1) + 1
    p_min = srt.gather(1, (n_in - 1).clamp(max=x.shape[-1] - 1)[:, None])[:, 0]
    p_tok = pr.gather(1, tok[rows].long()[:, None])[:, 0]
    return int(rows.sum()), int((p_tok < p_min * (1 - 1e-5)).sum())


def checked_selection(eng, counts):
    """Wrap the engine's sampler so that every draw is checked against its
    nucleus (a sync per step: used in a checking run only)."""
    inner = eng.core._select_token

    def select(logits, out_pos, temps, topks, topps, seeds):
        tok = inner(logits, out_pos, temps, topks, topps, seeds)
        n, bad = nucleus_violations(logits, tok, temps, topks, topps)
        counts[0] += n
        counts[1] += bad
        return tok
    eng.core._select_token = select


def sampling_tail_ms(card_name) -> dict:
    """The sampler's parts on 8 x 50257 f32 logits: top-k 64, the nucleus
    sort, the threefry gumbel draw, the whole tail with nucleus, and the
    greedy argmax it replaces. CUDA events (median of 25, L2 flushed: the
    host's launches included) and the device time of the kernels each
    launches (torch.profiler ranges, mean of 5 calls, L2 warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from types import SimpleNamespace
    from repro_torch.serve.engine import ServeEngine
    g = torch.Generator(device=DEV).manual_seed(11)
    V = 50257
    logits = 3 * torch.randn((8, V), generator=g, device=DEV)
    temps = torch.tensor([0, 0.8, 1, 1] * 2, device=DEV)
    topks = torch.tensor([0, 0, 40, 0] * 2, dtype=torch.int32, device=DEV)
    topps = torch.tensor([1, 1, 1, 0.9] * 2, device=DEV)
    seeds = torch.arange(100, 108, device=DEV)
    pos = torch.full((8,), 17, device=DEV)
    keys = prng.fold_in(prng.key(seeds), pos)
    pr = torch.softmax(logits, dim=-1)
    eng = SimpleNamespace(sampling=True, nucleus=True, top_k_cap=64)
    parts = {"topk": lambda: torch.topk(logits, 64, dim=-1),
             "sort": lambda: torch.sort(pr, dim=-1, descending=True),
             "threefry_gumbel": lambda: prng.gumbel(keys, (V,)),
             "tail": lambda: ServeEngine._select_token(eng, logits, pos, temps, topks,
                                                       topps, seeds),
             "argmax": lambda: torch.argmax(logits, dim=-1)}
    res = {k: time_ms(fn) for k, fn in parts.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            for k, fn in parts.items():
                with record_function(k):
                    fn()
        torch.cuda.synchronize()
    dev = {e.key: device_total_us(e) / 5e3 for e in prof.key_averages()
           if e.key in parts and e.device_type == DeviceType.CPU}
    assert set(dev) == set(parts) and all(v > 0 for v in dev.values()), dev
    log("  sampling tail on 8 x 50257 f32 logits, CUDA events (median of 25, L2 flushed) / "
        "device time of its kernels (torch.profiler): " + ", ".join(
            f"{k} {res[k]:.4f} / {dev[k]:.4f} ms" for k in parts) + f" [{card_name}]")
    return {**res, **{k + "_device": v for k, v in dev.items()}}


# the profiled window of run A: 16 fused steps after every prompt is in
# (the workload's last chunked prefill ends before step 30), 8 decode rows each
TAIL_WINDOW = (40, 16)


def profile_tail(cfg, params, card_name):
    """Run A again, with a torch.profiler range around the sampler over
    TAIL_WINDOW's decode steps: its device time per step, beside the
    window's. Returns (run A's tokens, tail device ms per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    res = {}

    def driver(eng, hs):
        inner = eng.core._select_token

        def ranged(*a):
            with record_function("sampling tail"):
                return inner(*a)
        eng.core._select_token = ranged
        start, n = TAIL_WINDOW
        for _ in range(start):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
        res["wall"] = 1e6 * (time.perf_counter() - t0)
        eng.run()
        kern = [e for e in raw_device_kernels(prof) if e.key != "sampling tail"]
        res["busy"] = sum(dev_us(e) for e in kern)
        res["tail"] = sum(device_total_us(e) for e in prof.key_averages()
                          if e.key == "sampling tail" and e.device_type == DeviceType.CPU)
    eng, outs, _, _ = serve(cfg, params, per_request=SAMPLED, driver=driver, **SAMPLE_KNOBS)
    n = TAIL_WINDOW[1]
    assert eng.stats["steps"] > sum(TAIL_WINDOW), "the window runs past the workload"
    log(f"  profiled window of run A (steps {TAIL_WINDOW[0]}..{sum(TAIL_WINDOW) - 1}, 8 "
        f"decode rows): device busy {res['busy'] / 1e3 / n:.3f} ms per step of "
        f"{res['wall'] / 1e3 / n:.2f} ms profiled wall, sampling tail "
        f"{res['tail'] / 1e3 / n:.4f} ms of device time per step "
        f"({res['tail'] / res['busy']:.2%}) [{card_name}]")
    return outs, res["tail"] / 1e3 / n


def check_sampled_serving(cfg, params, greedy_outs, greedy_st, card_name):
    """Run A: phase 3's engine with sampling and nucleus on, the sampled
    workload, adaptive ranks. Returns flash_decode's launches, the tail's
    device ms per step and run A's tokens."""
    eng, outs, launches, _ = serve(cfg, params, per_request=SAMPLED, **SAMPLE_KNOBS)
    st = eng.stats
    n_steps = st["steps"] + eng.core.warmup_steps
    assert launches == cfg.num_layers * n_steps, f"{launches} flash_decode launches"
    for i, o in enumerate(outs):
        assert o.shape == (64,) and ((o >= 0) & (o < cfg.vocab_size)).all(), f"request {i}"
    for i in GREEDY_ROWS:
        assert np.array_equal(outs[i], greedy_outs[i]), \
            f"greedy request {i} differs from phase 3's among sampled neighbours"
    moved = [i for i in range(8) if i not in GREEDY_ROWS
             and not np.array_equal(outs[i], greedy_outs[i])]
    assert len(moved) == 6, f"sampled requests equal to greedy ones: {moved}"
    tok_s = st["tokens_decoded"] / st["decode_s"]
    ms_step = 1e3 * st["decode_s"] / st["steps"]
    g_tok_s = greedy_st["tokens_decoded"] / greedy_st["decode_s"]
    g_ms = 1e3 * greedy_st["decode_s"] / greedy_st["steps"]
    log(f"  run A (adaptive, sampled): {st['steps']} fused steps, {st['decides']} decisions, "
        f"{launches} flash_decode launches = {cfg.num_layers} layers x {n_steps} steps; "
        f"greedy requests {GREEDY_ROWS} equal phase 3's tokens, the 6 sampled ones differ "
        f"from them; {tok_s:.1f} decoded tokens/s, {ms_step:.2f} ms/step (phase 3 greedy: "
        f"{g_tok_s:.1f} tokens/s, {g_ms:.2f} ms/step) [{card_name}]")
    again, tail_ms = profile_tail(cfg, params, card_name)
    counts = [0, 0]
    _, oneshot, _, _ = serve(cfg, params, per_request=SAMPLED,
                             driver=lambda e, h: (checked_selection(e, counts), e.run()),
                             **{**SAMPLE_KNOBS, "prefill_chunk": None})
    for i in range(8):
        assert np.array_equal(again[i], outs[i]), f"request {i}: a second run differs"
        assert np.array_equal(oneshot[i], outs[i]), f"request {i}: one-shot differs"
    assert counts[0] > 0 and counts[1] == 0, \
        f"top-p draws outside their nucleus: {counts[1]} of {counts[0]}"
    log(f"  a second run and a one-shot run (prefill_chunk=None) give run A's tokens; "
        f"{counts[0]} top-p draws (one-shot run) all inside their nucleus")
    return launches, tail_ms, outs


def check_sampled_random(cfg, params, card_name):
    """Run B: rank mode 'random' with the drift trigger, one request
    cancelled mid-prefill and one mid-decode, against the same run without
    the cancels. The victims are the last request to arrive (7) and one
    cancelled after every request was admitted (2): a freed slot taken by
    a later arrival would change that request's draws, which key on the
    slot."""
    rcfg = cfg.with_(rank=RankConfig(mode="random", rank_grid=GRID, segment_len=32))
    knobs = dict(SAMPLE_KNOBS, drift_threshold=DRIFT)
    rec = {"forced": 0, "cancel": {}}

    def count_forced(eng):
        inner = eng.core._check_drift

        def counted(live):
            before = eng.core.force_decide.copy()
            inner(live)
            rec["forced"] += int((eng.core.force_decide & ~before).sum())
        eng.core._check_drift = counted

    def with_cancels(eng, hs):
        count_forced(eng)
        core = eng.core
        rec["free0"] = core.cache.free_pages
        while eng.step():
            for s in core.sched.slots:
                if not s.active:
                    continue
                rid = s.req.rid
                mid_pf = rid == 7 and 0 < s.prefilled < s.prompt_len
                mid_dec = rid == 2 and s.n_out == 10
                if (mid_pf or mid_dec) and rid not in rec["cancel"]:
                    free = core.cache.free_pages
                    need = core.cache.pages_needed(s.prompt_len + s.req.max_new)
                    assert hs[rid].cancel()
                    rec["cancel"][rid] = (core.cache.free_pages - free, need,
                                          "mid-prefill" if mid_pf else "mid-decode")
                    break
        rec["free1"] = core.cache.free_pages

    eng, outs, launches, _ = serve(rcfg, params, per_request=SAMPLED, driver=with_cancels,
                                   **knobs)
    st = eng.stats
    assert launches == cfg.num_layers * (st["steps"] + eng.core.warmup_steps)
    assert sorted(rec["cancel"]) == [2, 7], f"cancels {rec['cancel']}"
    for rid, (freed, need, where) in rec["cancel"].items():
        assert freed == need, f"cancel of {rid} ({where}) freed {freed} pages of {need}"
    assert rec["free1"] == rec["free0"] == eng.core.cache.n_pages - 1
    assert len(outs[7]) == 0 and len(outs[2]) == 0   # nothing streamed to them
    assert rec["forced"] > 0, "the drift trigger never fired"
    ranks = {int(r) for step in eng.ranks_per_step() for r in step if r >= 0}
    forced_b = rec["forced"]
    rec["forced"] = 0
    _, ref, _, _ = serve(rcfg, params, per_request=SAMPLED,
                         driver=lambda e, h: (count_forced(e), e.run()), **knobs)
    for i in range(8):
        if i not in (2, 7):
            assert np.array_equal(outs[i], ref[i]), f"request {i} moved by the cancels"
    tok_s = st["tokens_decoded"] / st["decode_s"]
    log(f"  run B (random, drift > {DRIFT}, 2 cancels): {st['steps']} fused steps, "
        f"{st['decides']} decisions of which {forced_b} forced by the drift trigger "
        f"({rec['forced']} without the cancels), ranks {sorted(ranks)}, {launches} "
        f"flash_decode launches; cancels " + ", ".join(
            f"request {rid} {w} freed {f} pages" for rid, (f, _, w) in sorted(rec['cancel'].items()))
        + f"; free pages back to {rec['free1']}; the 6 other streams equal the run "
        f"without cancels; {tok_s:.1f} decoded tokens/s [{card_name}]")
    return launches


def emitting_rows(core) -> dict:
    """{row: (request id, output index)} of the rows whose token the fused
    step about to run emits (read before the step updates the host state):
    decode rows, and chunked rows that finish their prompt (token 0)."""
    rows = {}
    for i, st in enumerate(core.sched.slots):
        if not st.active:
            continue
        if not st.mid_prefill:
            rows[i] = (st.req.rid, st.n_out)
        elif st.prefilled + core.chunk >= st.prompt_len:
            rows[i] = (st.req.rid, 0)
    return rows


def check_sampled_reference():
    """Reduced drrl-paper, sampled workload, adaptive: the card with the
    kernel vs the CPU without it. Where an emitted token differs, the
    top-two gap of the values its argmax took (scaled + gumbel for a
    sampled row, the logits for a greedy one) must be under GAP_TOL."""
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    knobs = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
                 max_new_cap=12, prefill_chunk=8, sampling=True, nucleus=True)
    outs = {}
    for device, use_kernel in ((DEV, True), ("cpu", False)):
        rng = np.random.default_rng(0)
        eng = Engine(cfg, params, device=device,
                     config=EngineConfig(use_kernel=use_kernel, **knobs))
        calls = []
        inner = eng.core._select_token

        def recorded(*a, _inner=inner, _calls=calls, _core=eng.core):
            tok = _inner(*a)
            _calls.append(([x.cpu() for x in a], tok.cpu(), emitting_rows(_core)))
            return tok
        eng.core._select_token = recorded
        hs = [eng.submit(rng.integers(0, 256, int(n)),
                         SamplingParams(max_new=12, **SAMPLED[i]), arrival=2 * i)
              for i, n in enumerate(rng.integers(8, 33, 6))]
        eng.run()
        outs[device] = ([h.result() for h in hs], eng.ranks_per_step(), calls)
    (tok_g, rk_g, calls_g), (tok_c, rk_c, calls_c) = outs[DEV], outs["cpu"]
    assert len(calls_g) == len(calls_c)
    gaps = []
    for step, ((args, t_g, rows), (_, t_c, rows_c)) in enumerate(zip(calls_g, calls_c)):
        assert rows == rows_c, f"step {step}: the two engines emit from other rows"
        for row, (rid, j) in rows.items():
            if t_g[row] != t_c[row]:
                vals = (sample_scores(*args)[row] if args[2][row] > 0
                        else args[0][row]).sort().values
                gaps.append((step, rid, j, (vals[-1] - vals[-2]).item()))
    for step, rid, j, gap in gaps:
        log(f"  reduced sampled run: request {rid} token {j} (step {step}) differs, card "
            f"vs CPU; top-two gap {gap:.3g}")
        assert gap < GAP_TOL, f"token differs at a top-two gap of {gap}"
    if not gaps:
        for a, b in zip(tok_g, tok_c):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rk_g, rk_c):
            np.testing.assert_array_equal(a, b)
    log(f"  reduced model, sampled workload: GPU kernel tokens and ranks == CPU plain "
        f"tokens and ranks ({len(rk_g)} steps, {len(gaps)} emitted draws differ)")


def check_prng_card():
    """core.prng on the card against the CPU: bits equal, gumbel within one
    ulp (2e-7 of max(|g|, 1))."""
    keys = prng.fold_in(prng.key(torch.arange(100, 108)), torch.arange(8) * 7)
    b_c, g_c = prng.bits32(keys, (50257,)), prng.gumbel(keys, (50257,))
    k_d = keys.to(DEV)
    b_d, g_d = prng.bits32(k_d, (50257,)).cpu(), prng.gumbel(k_d, (50257,)).cpu()
    r_c = prng.randint(prng.key(17), (2, 12), 0, len(GRID))
    r_d = prng.randint(prng.key(17, device=DEV), (2, 12), 0, len(GRID)).cpu()
    assert torch.equal(b_c, b_d) and torch.equal(r_c, r_d), "prng bits differ, card vs CPU"
    rel = ((g_d - g_c).abs() / g_c.abs().clamp_min(1.0)).max().item()
    assert rel <= 2e-7, f"gumbel card vs CPU {rel}"
    log(f"  prng on the card: 8 x 50257 threefry words and randint draws equal the CPU's; "
        f"gumbel within {rel:.3g} of max(|g|, 1) (tol 2e-7), "
        f"{int((g_d != g_c).sum())} of {g_c.numel()} values not bitwise")


# -- phase 14 ----------------------------------------------------------------

def comparison_cfg(cfg, mode):
    return cfg.with_(rank=RankConfig(mode=mode, realisation="masked", rank_grid=GRID,
                                     fixed_rank=32, segment_len=32))


def check_comparison_forwards(cfg_base, params, card_name) -> dict:
    """The 2 x 4096 forward in rank mode 'random' (masked, fidelity; against
    the plain path) and in 'performer' / 'nystrom' (fixed rank 32); returns
    {'launches': lowrank_flash launches of the random forward, 'walls': ms}."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg_base.vocab_size, (2, 4096), generator=g, device=DEV)
    key = prng.key(5)          # on the host: the draws' tiny integer ops stay there

    def run(cfg, fid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = forward_dense(cfg, params, tokens, chunked=True, rank_rng=key,
                                    collect_aux="ranks", compute_fidelity=fid)
        torch.cuda.synchronize()
        return logits, aux["layers"], time.perf_counter() - t0

    cfg = comparison_cfg(cfg_base, "random")
    reset_launches()
    logits, aux, _ = run(cfg, True)
    launches = lowrank_flash.LAUNCHES["lowrank_flash"]
    assert launches == 2 * cfg.num_layers, f"random forward: {launches} launches"
    assert logits.shape == (*tokens.shape, cfg.vocab_size) and torch.isfinite(logits).all()
    with plain_flash():
        logits_p, aux_p, _ = run(cfg, True)
    err = (logits - logits_p).abs().max().item()
    top = logits_p.abs().max().item()
    assert err <= LOGIT_TOL * max(1.0, top), f"random forward: kernel vs plain {err}"
    assert torch.equal(aux["rank"], aux_p["rank"]), "random forward: ranks differ"
    want = grid_ranks(cfg, key, tokens.shape[0])
    assert torch.equal(aux["rank"].cpu(), want), "random forward: ranks are not the key's draws"
    ranks = sorted(set(aux["rank"].flatten().tolist()))
    log(f"  random/masked + fidelity: {launches} lowrank_flash launches = {cfg.num_layers} "
        f"layers x 2; max|logits - plain| {err:.3g} (max |logit| {top:.3g}, tol "
        f"{LOGIT_TOL}); ranks identical and equal to prng.randint of the split keys "
        f"{ranks}; fidelity {aux['fidelity'].mean().item():.4f}")
    walls = {}
    for mode in ("random", "performer", "nystrom"):
        mcfg = comparison_cfg(cfg_base, mode)
        fid = mode == "random"
        lg, _, first = run(mcfg, fid)
        assert torch.isfinite(lg).all(), f"{mode} forward: non-finite logits"
        torch.cuda.reset_peak_memory_stats()
        wall = statistics.median(run(mcfg, fid)[2] for _ in range(3))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(mcfg, fid)
        kern = raw_device_kernels(prof)
        busy = sum(dev_us(e) for e in kern)
        walls[mode] = wall * 1e3
        log(f"  forward {mode}{' + fidelity' if fid else ''}, 2 x 4096 tokens: wall "
            f"{wall * 1e3:.2f} ms (median of 3; first {first * 1e3:.1f} ms), device busy "
            f"{busy / 1e3:.2f} ms (idle {1 - busy / (wall * 1e6):.1%}), peak memory "
            f"{peak:.2f} GiB [{card_name}]")
        log_layers(by_layer(kern), busy)
    check_comparison_reference()
    return {"launches": launches, "walls": walls}


def grid_ranks(cfg, key, b):
    """The ranks rank mode 'random' draws from ``key``: split once per layer,
    randint over the grid per (row, head)."""
    grid = torch.tensor(cfg.rank.rank_grid, dtype=torch.int32)
    out, k = [], key.cpu()
    for _ in range(cfg.num_layers):
        k, sub = prng.split(k)
        out.append(grid[prng.randint(sub, (b, cfg.num_kv_heads), 0, len(grid)).long()])
    return torch.stack(out)


def check_lowrank_cache(cfg_base, params, card_name) -> float:
    """The rank-r cache at full width: prefill_lowrank of 2 x 2048 at rank 32,
    then 64 decode steps fed decode_step_dense's greedy tokens at full rank;
    the share of steps whose greedy token agrees (report only) and decode ms
    per step."""
    cfg = cfg_base.with_(rank=RankConfig(mode="off"))
    g = torch.Generator(device=DEV).manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (2, 2048), generator=g, device=DEV)
    n, r = 64, 32
    dense = get_model(cfg).init_cache(2, 2048 + n, device=DEV)
    lg, dense = get_model(cfg).decode_step(params, dense, prompt)
    want = [lg[:, -1].argmax(-1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n - 1):
        lg, dense = get_model(cfg).decode_step(params, dense, want[-1][:, None])
        want.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    dense_ms = 1e3 * (time.perf_counter() - t0) / (n - 1)
    cache = lowrank_cache.init_lowrank_cache(cfg, 2, 2048 + n, r, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = lowrank_cache.prefill_lowrank(cfg, params, prompt, cache, r)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    got = [lg[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(n - 1):
        lg, cache = lowrank_cache.decode_step_lowrank(cfg, params, cache, want[i][:, None])
        got.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / (n - 1)
    assert torch.isfinite(lg).all() and cache["len"] == 2048 + n - 1
    agree = (torch.stack(got) == torch.stack(want)).float().mean().item()
    log(f"  rank-r cache, rank {r}: prefill_lowrank of 2 x 2048 {prefill_ms:.1f} ms (first "
        f"call), decode_step_lowrank {dec_ms:.2f} ms/step vs decode_step_dense {dense_ms:.2f} "
        f"ms/step (64 steps, b = 2); greedy tokens agree with the full-rank dense decode at "
        f"{agree:.3f} of steps (report only) [{card_name}]")
    return dec_ms


def check_comparison_reference():
    """Reduced drrl-paper: the forward in 'random' (2 x 1040, chunked: the
    kernel on the card), 'performer' and 'nystrom', and the rank-r cache,
    card vs CPU."""
    base = get_config("drrl-paper", reduced=True)
    params = get_model(base).init(torch.Generator().manual_seed(0), device="cpu")
    params_dev = params_to(params, DEV)
    tokens = torch.randint(0, base.vocab_size, (2, 1040),
                           generator=torch.Generator().manual_seed(6))
    for mode in ("random", "performer", "nystrom"):
        cfg = base.with_(rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), fixed_rank=8,
                                         segment_len=8))
        out = {}
        for dev, p in ((DEV, params_dev), ("cpu", params)):
            lg, aux = forward_dense(cfg, p, tokens.to(dev), chunked=True,
                                    rank_rng=prng.key(3, device=dev), collect_aux="ranks")
            out[dev] = (lg.cpu(), aux["layers"].get("rank"))
        err = (out[DEV][0] - out["cpu"][0]).abs().max().item()
        assert err <= 1e-4, f"reduced forward {mode}: card vs CPU logits differ by {err}"
        if mode == "random":
            assert torch.equal(out[DEV][1].cpu(), out["cpu"][1]), "reduced random: ranks differ"
        log(f"  reduced model, 2 x 1040 tokens, {mode}: card vs CPU max|logits| diff "
            f"{err:.3g} (tol 1e-4){', ranks equal' if mode == 'random' else ''}")
    cfg = base.with_(rank=RankConfig(mode="off"))
    out = {}
    for dev, p in ((DEV, params_dev), ("cpu", params)):
        cache = lowrank_cache.init_lowrank_cache(cfg, 2, 48, 8, device=dev)
        lg, cache = lowrank_cache.prefill_lowrank(cfg, p, tokens[:, :32].to(dev), cache, 8)
        steps = [lg.cpu()]
        for i in range(32, 40):
            lg, cache = lowrank_cache.decode_step_lowrank(cfg, p, cache,
                                                          tokens[:, i:i + 1].to(dev))
            steps.append(lg.cpu())
        b = cache["basis"].cpu()
        out[dev] = (torch.cat(steps, 1), b @ b.transpose(-1, -2))
    err = (out[DEV][0] - out["cpu"][0]).abs().max().item()
    p_err = (out[DEV][1] - out["cpu"][1]).abs().max().item()
    assert err <= 1e-4 and p_err <= 1e-4, \
        f"reduced rank-r cache: card vs CPU logits {err}, projectors {p_err}"
    log(f"  reduced rank-r cache (rank 8, 32-token prefill, 8 steps): card vs CPU "
        f"max|logits| diff {err:.3g}, projectors E_r E_r^T {p_err:.3g} (tol 1e-4)")

# -- phase 15 ----------------------------------------------------------------

# phase 3's engine with the factor cache, speculative: 4 drafts at a quarter
# of the slot's rank (r_cap = 16 of 64), one verify block of 128 queries
SPEC_KNOBS = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                  use_kernel=True, factor_cache=True, speculative=True, draft_k=4,
                  draft_rank_frac=0.25)
# a speculative token may differ from the plain run's only where the plain
# run's top-two gap (logits, or scaled + gumbel for a sampled row) is under
# this: the verify reads through the chunk path, plain decode through the
# decode path, and their sums differ by float rounding
SPEC_GAP_TOL = 1e-4
PREFIX_LEN, COW_CUT = 1024, 1124          # 1124 = 70 pages of 16 + 4


def count_spec_launches(eng, per_step):
    """Wrap the speculative step: flash_decode launches of each call."""
    core = eng.core
    inner = core._step_spec

    def step(*a):
        n0 = decode_attn.LAUNCHES["flash_decode"]
        out = inner(*a)
        per_step.append(decode_attn.LAUNCHES["flash_decode"] - n0)
        return out
    core._step_spec = step


def record_gaps(eng, gaps):
    """Wrap a plain engine's sampler: gaps[(request id, output index)] is the
    top-two gap of the values the emitted token is the argmax of (logits for
    a greedy row, scaled + gumbel for a sampled one)."""
    core = eng.core
    inner = core._select_token

    def select(logits, out_pos, temps, topks, topps, seeds):
        rows = emitting_rows(core)
        tok = inner(logits, out_pos, temps, topks, topps, seeds)
        vals = logits
        if core.sampling:
            vals = torch.where((temps > 0)[:, None],
                               sample_scores(logits, out_pos, temps, topks, topps, seeds,
                                             core.top_k_cap), logits)
        top = vals.topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        for row, key in rows.items():
            gaps[key] = gap[row]
        return tok
    core._select_token = select


def compare_streams(got, want, rerun_ref, label, tol=SPEC_GAP_TOL) -> int:
    """Tokens equal, or each differing stream's first difference at a
    top-two gap under ``tol`` in the reference run; ``rerun_ref(gaps)``
    serves the reference again with ``record_gaps`` and returns its tokens
    (they must be the first run's). Returns the count of differing
    streams."""
    diff = {i: int(np.argmax(a != b)) for i, (a, b) in enumerate(zip(got, want))
            if not np.array_equal(a, b)}
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, f"{label}: request {i} has {a.shape} tokens, not {b.shape}"
    if not diff:
        log(f"  {label}: all {len(got)} streams equal the reference's tokens")
        return 0
    gaps = {}
    again = rerun_ref(gaps)
    for i, (a, b) in enumerate(zip(again, want)):
        assert np.array_equal(a, b), f"{label}: the reference's rerun differs at request {i}"
    for i, j in sorted(diff.items()):
        g = gaps[(i, j)]
        log(f"  {label}: request {i} first differs at token {j}; the reference's "
            f"top-two gap there {g:.3g} (tol {tol:g})")
        assert g < tol, f"{label}: request {i} differs at a top-two gap of {g}"
    log(f"  {label}: {len(diff)} of {len(got)} streams differ, each first at a near-tie")
    return len(diff)


def spec_summary(eng, per_step, launches, cfg) -> str:
    st = eng.stats
    n_fwd = eng.core.draft_k + 1
    want = cfg.num_layers * (st["steps"] - st["spec_steps"] + 1 + n_fwd * (st["spec_steps"] + 1))
    assert launches == want, f"{launches} flash_decode launches, expected {want}"
    assert per_step and set(per_step) == {n_fwd * cfg.num_layers}, \
        f"flash_decode launches per speculative step {sorted(set(per_step))}"
    core = eng.core
    tree = [] if core.prefix is None else core.prefix.all_pages()
    core.cache.check_refs(tree)
    assert core.cache.free_pages == core.cache.n_pages - 1 - len(tree)
    rate = st["spec_accepted"] / max(st["spec_drafted"], 1)
    return (f"{st['steps']} steps ({st['spec_steps']} speculative, {st['mixed_steps']} mixed), "
            f"accept rate {rate:.3f} ({st['spec_accepted']} of {st['spec_drafted']} drafts), "
            f"{st['spec_tokens'] / max(st['spec_steps'], 1):.2f} tokens per speculative step (all rows), "
            f"flash_decode {per_step[0]} launches per speculative step, {launches} in all; "
            f"{st['tokens_decoded'] / st['decode_s']:.1f} decoded tokens/s, "
            f"{1e3 * st['decode_s'] / st['steps']:.2f} ms/step")


def check_spec_serving(cfg, params, plain_outs, plain_st, card_name) -> dict:
    """15a: phase 3's workload, greedy, speculative with the factor cache,
    against phase 3's factor-cache run; then with the adaptive draft
    window. Returns the launches and times."""
    per_step = []
    eng, outs, launches, _ = serve(cfg, params, driver=lambda e, h: (
        count_spec_launches(e, per_step), e.run()), **SPEC_KNOBS)
    summary = spec_summary(eng, per_step, launches, cfg)
    st = eng.stats
    p_tok_s = plain_st["tokens_decoded"] / plain_st["decode_s"]
    p_ms = 1e3 * plain_st["decode_s"] / plain_st["steps"]
    log(f"  speculative, greedy (draft_k 4, r_cap {eng.core._draft_cap}): {summary} "
        f"(phase 3, factor cache: {p_tok_s:.1f} tokens/s, {p_ms:.2f} ms/step, "
        f"{plain_st['steps']} steps) [{card_name}]")
    plain_knobs = {k: v for k, v in SPEC_KNOBS.items()
                   if k not in ("speculative", "draft_k", "draft_rank_frac")}

    def rerun(gaps):
        return serve(cfg, params, driver=lambda e, h: (record_gaps(e, gaps), e.run()),
                     **plain_knobs)[1]
    n_diff = compare_streams(outs, plain_outs, rerun, "speculative vs phase 3")
    res = {"tok_s": st["tokens_decoded"] / st["decode_s"],
           "ms_step": 1e3 * st["decode_s"] / st["steps"], "steps": st["steps"],
           "spec_steps": st["spec_steps"],
           "accept_rate": st["spec_accepted"] / max(st["spec_drafted"], 1),
           "launches": launches, "launches_per_spec_step": per_step[0],
           "plain_tok_s": p_tok_s, "plain_ms_step": p_ms, "streams_differ": n_diff}

    eff = []

    def adaptive(e, h):
        while e.step():
            eff.append(e.stats["eff_draft_k"])
    eng_a, outs_a, _, _ = serve(cfg, params, driver=adaptive,
                                **SPEC_KNOBS, adaptive_draft=True)
    st_a = eng_a.stats
    runs = [(k, sum(1 for _ in g)) for k, g in __import__("itertools").groupby(eff)]
    log(f"  adaptive draft window: eff_draft_k over the run (value x steps) {runs}; "
        f"{st_a['steps']} steps, {st_a['spec_steps']} speculative, "
        f"{st_a['tokens_decoded'] / st_a['decode_s']:.1f} tokens/s [{card_name}]")
    res["adaptive_n_diff"] = compare_streams(outs_a, plain_outs, rerun,
                                             "adaptive draft vs phase 3")
    res["adaptive_tok_s"] = st_a["tokens_decoded"] / st_a["decode_s"]
    res.update(profile_spec_window(cfg, params, card_name))
    return res


# the profiled window of the speculative run: 8 speculative steps after
# every prompt is in (its last prefill chunk runs before step 26)
SPEC_WINDOW = (28, 8)


def profile_spec_window(cfg, params, card_name) -> dict:
    """15a's speculative run again, device activity only over SPEC_WINDOW's
    steps: device time per step by layer, and flash_decode's split between
    the drafts' decode-path launches and the verify's chunk-path ones."""
    from torch.profiler import ProfilerActivity, profile
    res = {}

    def driver(eng, hs):
        start, n = SPEC_WINDOW
        for _ in range(start):
            eng.step()
        torch.cuda.synchronize()
        spec0 = eng.stats["spec_steps"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
            res["wall"] = 1e6 * (time.perf_counter() - t0)
        res["spec"] = eng.stats["spec_steps"] - spec0
        eng.run()
        res["kern"] = raw_device_kernels(prof)
    eng, _, _, _ = serve(cfg, params, driver=driver, **SPEC_KNOBS)
    start, n = SPEC_WINDOW
    assert eng.stats["steps"] > start + n and res["spec"] == n, "the window leaves the spec steps"
    kern = res["kern"]
    busy = sum(dev_us(e) for e in kern)
    layers = by_layer(kern)
    draft = sum(dev_us(e) for e in kern if "flash_decode_kernel_split" in e.key
                or "flash_decode_kernel_combine" in e.key)
    verify = sum(dev_us(e) for e in kern if "flash_decode_kernel_chunk" in e.key)
    log(f"  profiled window of the speculative run (steps {start}..{start + n - 1}, all "
        f"speculative): device busy {busy / 1e3 / n:.2f} ms per step of "
        f"{res['wall'] / 1e3 / n:.2f} ms profiled wall (idle {1 - busy / res['wall']:.1%}); "
        f"flash_decode {layers['flash_decode kernel'] / 1e3 / n:.3f} ms per step: drafts "
        f"(split + combine) {draft / 1e3 / n:.3f}, verify (chunk) {verify / 1e3 / n:.3f} "
        f"[{card_name}]")
    log_layers(layers, busy)
    return {"window_busy_ms_per_step": busy / 1e3 / n,
            "window_wall_ms_per_step": res["wall"] / 1e3 / n,
            "window_flash_decode_ms_per_step": layers["flash_decode kernel"] / 1e3 / n,
            "window_draft_ms_per_step": draft / 1e3 / n,
            "window_verify_ms_per_step": verify / 1e3 / n}


def check_spec_sampled(cfg, params, run_a, card_name) -> dict:
    """15b: phase 13 run A's sampled workload, speculative: run A's tokens."""
    per_step = []
    knobs = dict(SAMPLE_KNOBS, speculative=True, draft_k=4, draft_rank_frac=0.25)
    eng, outs, launches, _ = serve(cfg, params, per_request=SAMPLED, driver=lambda e, h: (
        count_spec_launches(e, per_step), e.run()), **knobs)
    log(f"  speculative, sampled (run A's requests): {spec_summary(eng, per_step, launches, cfg)} "
        f"[{card_name}]")

    def rerun(gaps):
        return serve(cfg, params, per_request=SAMPLED, driver=lambda e, h: (
            record_gaps(e, gaps), e.run()), **SAMPLE_KNOBS)[1]
    n_diff = compare_streams(outs, run_a, rerun, "speculative sampled vs run A")
    st = eng.stats
    return {"tok_s": st["tokens_decoded"] / st["decode_s"],
            "ms_step": 1e3 * st["decode_s"] / st["steps"], "launches": launches,
            "streams_differ": n_diff}


def prefix_workload(vocab, seed=3):
    """8 prompts sharing one seeded 1024-token prefix, each with its own
    64..512-token suffix (request 0's at most 256, so that its prompt is in
    the tree by step 10). Request 1 is request 5's prompt cut to 1124
    tokens (not a multiple of 16): it arrives first, and request 5 then
    reuses its prompt end through a copied tail page. Arrivals: request 0
    at step 0, the others one every 2 steps from step 10."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PREFIX_LEN)
    suffix = rng.integers(64, 513, 8)
    suffix[0] = min(suffix[0], 256)
    suffix[5] = max(suffix[5], COW_CUT - PREFIX_LEN + 64)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, int(n))]).astype(np.int32)
               for n in suffix]
    prompts[1] = prompts[5][:COW_CUT].copy()
    return prompts, [0] + [10 + 2 * i for i in range(7)]


def check_prefix_serving(cfg, params, card_name):
    """15c: the shared-prefix workload with the prefix cache against the
    same run without it (greedy tokens equal, or near-ties), TTFT of the
    hits (each step synced: report only) and peak memory; the refcount
    invariant after the run and after reset(); then with speculation too.
    Returns (numbers, the cold run's tokens, its rerun with gaps)."""
    prompts, arrivals = prefix_workload(cfg.vocab_size)
    base = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                use_kernel=True, factor_cache=True)
    res = {}

    def ttft_driver(rec):
        def drive(eng, hs):
            core, admit, first = eng.core, {}, {}
            inner = core._apply_prefix_hit

            def applied(slot, req):
                admit[req.rid] = time.perf_counter()
                return inner(slot, req)
            core._apply_prefix_hit = applied
            while eng.step():
                torch.cuda.synchronize()
                now = time.perf_counter()
                for st in core.sched.slots:
                    if st.active and st.n_out >= 1 and st.req.rid not in first:
                        first[st.req.rid] = now
            for h in hs:
                first.setdefault(h.rid, now)
            rec["ttft"] = {rid: first[rid] - admit[rid] for rid in admit}
        return drive

    runs = {}
    for name, knobs in (("cold", {}), ("prefix", dict(prefix_cache=True))):
        rec, eng = {}, None
        runs.pop("engine", None)
        gc.collect()               # the drivers' wrappers make reference cycles
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng, outs, launches, _ = serve_prompts(cfg, params, prompts=prompts,
                                               arrivals=arrivals, driver=ttft_driver(rec),
                                               **base, **knobs)
        rec["peak"] = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        st = eng.stats
        assert launches == cfg.num_layers * (st["steps"] + eng.core.warmup_steps)
        runs[name] = (dict(st), outs, rec)
        runs["engine"] = eng
    (st_c, cold, rec_c), (st, hit, rec_p) = runs["cold"], runs["prefix"]
    eng = runs.pop("engine")
    tree = eng.core.prefix.all_pages()
    eng.core.cache.check_refs(tree)
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1 - len(tree)
    want_reuse = PREFIX_LEN * 6 + COW_CUT
    assert (st["prefix_hits"], st["prefix_misses"]) == (7, 1), st
    assert st["prefix_cow"] >= 1 and st["prefix_reused_tokens"] == want_reuse, st
    assert st["prefill_tokens"] == st_c["prefill_tokens"] - want_reuse
    hits = [rid for rid, hit in eng.core.request_prefix_hit.items() if hit]
    assert sorted(hits) == list(range(1, 8)), hits
    t_hit = np.mean([rec_p["ttft"][i] for i in hits]) * 1e3
    t_cold = np.mean([rec_c["ttft"][i] for i in hits]) * 1e3
    log(f"  prefix cache: {st['prefix_hits']} hits, {st['prefix_misses']} miss, "
        f"{st['prefix_reused_tokens']} reused tokens, {st['prefix_cow']} copied tail page(s), "
        f"{st['prefix_evictions']} evicted pages; prefill tokens {st['prefill_tokens']} "
        f"(cold {st_c['prefill_tokens']}); steps {st['steps']} (cold "
        f"{st_c['steps']}); TTFT of requests 1-7 from admission, each step synced: "
        f"{t_hit:.1f} ms (cold {t_cold:.1f} ms); the run's peak memory above what was "
        f"allocated before it {rec_p['peak']:.2f} GiB (cold {rec_c['peak']:.2f} GiB); tree {eng.core.prefix.n_nodes} nodes, {len(set(tree))} "
        f"pages; check_refs holds [{card_name}]")

    def rerun(gaps):
        return serve_prompts(cfg, params, prompts=prompts, arrivals=arrivals,
                             driver=lambda e, h: (record_gaps(e, gaps), e.run()), **base)[1]
    res["prefix_n_diff"] = compare_streams(hit, cold, rerun, "prefix hits vs cold")
    eng.reset()
    assert eng.core.prefix.n_nodes == 0 and eng.core.prefix.all_pages() == []
    eng.core.cache.check_refs(eng.core.prefix.all_pages())
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
    log("  after reset(): the tree is empty, every page free, check_refs holds")

    per_step = []
    eng_s, both, launches, _ = serve_prompts(
        cfg, params, prompts=prompts, arrivals=arrivals,
        driver=lambda e, h: (count_spec_launches(e, per_step), e.run()),
        **base, prefix_cache=True, speculative=True, draft_k=4, draft_rank_frac=0.25)
    tree = eng_s.core.prefix.all_pages()
    log(f"  prefix cache and speculation: {eng_s.stats['prefix_hits']} hits, "
        f"{eng_s.stats['prefix_cow']} copied tail page(s); "
        f"{spec_summary(eng_s, per_step, launches, cfg)} [{card_name}]")
    res["both_n_diff"] = compare_streams(both, cold, rerun, "prefix + speculative vs cold")
    res.update(ttft_hit_ms=t_hit, ttft_cold_ms=t_cold, peak_gib=rec_p["peak"],
               peak_cold_gib=rec_c["peak"], prefix_launches=launches,
               tok_s=eng_s.stats["tokens_decoded"] / eng_s.stats["decode_s"])
    return res, cold, rerun


def check_spec_prefix_reference():
    """15d: the reduced model's speculative, prefix and combined runs (the
    CPU tests' sizes), on the card with the kernel against the CPU without
    it: identical tokens, ranks and speculative / prefix stats."""
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    base = dict(n_slots=4, max_len=64, page_size=8, segment_len=8, max_new_cap=12,
                prefill_chunk=8, draft_k=3, draft_rank_frac=0.5)
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 256, 24)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)]) for n in (8, 13, 8)]
    keys = ("steps", "spec_steps", "spec_accepted", "prefix_hits", "prefix_reused_tokens",
            "decides")
    for label, knobs in (("speculative", dict(speculative=True)),
                         ("prefix", dict(prefix_cache=True)),
                         ("both", dict(speculative=True, prefix_cache=True))):
        outs = {}
        for device, use_kernel in ((DEV, True), ("cpu", False)):
            eng = Engine(cfg, params, device=device,
                         config=EngineConfig(use_kernel=use_kernel, **base, **knobs))
            hs = [eng.submit(p, SamplingParams(max_new=12), arrival=10 * i)
                  for i, p in enumerate(prompts)]
            eng.run()
            core = eng.core
            core.cache.check_refs([] if core.prefix is None else core.prefix.all_pages())
            outs[device] = ([h.result() for h in hs], eng.ranks_per_step(),
                            {k: eng.stats[k] for k in keys})
        (tg, rg, sg), (tc, rc, sc) = outs[DEV], outs["cpu"]
        for a, b in zip(tg, tc):
            np.testing.assert_array_equal(a, b)
        assert len(rg) == len(rc) and all(np.array_equal(a, b) for a, b in zip(rg, rc))
        assert sg == sc, (sg, sc)
        log(f"  reduced model, {label}: GPU kernel tokens, ranks and stats == CPU plain "
            f"({sg})")


# -- phase 16 ----------------------------------------------------------------

# phase 16's engine: phase 3's (adaptive, segment 32) with the factor cache
FRONT_KNOBS = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                   use_kernel=True, factor_cache=True)
# one engine serves the four scenarios: shared_prefix asks for the prefix
# cache, mixed_sampling for sampling with the top-p cut
SUITE_KNOBS = dict(prefix_cache=True, sampling=True, nucleus=True)
WAIT_S = 600.0              # bound on every wait for a stepping thread
POLICY_LR = 3e-3            # train_serve_policy's default peak lr
TRACE_INT_COLUMNS = ("rid", "slot", "seg_t", "kv_len", "layer_id", "prev_rank",
                     "chosen_rank", "has_prev", "n_tokens", "spec_accepted",
                     "spec_drafted")


def submit_spec(eng, spec):
    """Submit a ``make_workload`` spec's requests; returns the handles."""
    return [eng.submit(r["tokens"], SamplingParams(
        max_new=r["max_new"], temperature=r.get("temperature", 0.0),
        top_k=r.get("top_k", 0), top_p=r.get("top_p", 1.0), seed=r.get("seed", 0)),
        arrival=r["arrival"]) for r in spec.requests]


def record_suite(cfg, params, device, n_requests, max_new, max_prompt, **knobs):
    """``make_workload``'s four scenarios (seed 3) through one Engine, one
    after another; flash_decode launches counted from warmup on. Returns
    (engine, tokens per request, launches)."""
    eng = Engine(cfg, params, device=device, config=EngineConfig(**SUITE_KNOBS, **knobs))
    reset_launches()
    eng.warmup()
    outs = []
    for name in workload_names():
        spec = make_workload(name, seed=3, n_requests=n_requests, max_new=max_new,
                             vocab=cfg.vocab_size, max_prompt=max_prompt)
        hs = submit_spec(eng, spec)
        eng.run()
        outs += [h.result() for h in hs]
    return eng, outs, decode_attn.LAUNCHES["flash_decode"]


def wait_done(h, timeout=WAIT_S):
    """A handle's result, waiting at most ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not h.done:
        h._check_stopped()
        assert time.monotonic() < deadline, f"request {h.rid} timed out"
        h._advance(len(h._toks))
    return h._result


def check_trace_recording(cfg, params, out, card_name) -> dict:
    """16a: the four scenarios, 8 requests of 64 tokens each (long_context
    prompts 768..1536 tokens), through one full-width engine that records
    serving traces with obs tracing, flight dumps and per-token timing on,
    then through the same engine with all of that off: tokens equal, 12
    flash_decode launches per fused step in both."""
    wl = dict(n_requests=8, max_new=64, max_prompt=1536)
    trace_dir = os.path.join(out, "trace")
    t0 = time.perf_counter()
    eng, outs, launches = record_suite(
        cfg, params, DEV, **wl, **FRONT_KNOBS, record_traces=trace_dir, obs_trace=True,
        flight_dir=os.path.join(out, "flight"), time_per_token=True)
    manifest = eng.core.trace.flush()
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    assert launches == cfg.num_layers * (st["steps"] + eng.core.warmup_steps), \
        f"{launches} flash_decode launches for {st['steps']} steps"
    rec = TraceReader(trace_dir).records
    assert len(rec["slot"]) == manifest["n_records"] > 0
    assert set(rec["chosen_rank"].tolist()) <= set(GRID)
    assert np.isfinite(rec["s2"]).all() and rec["n_tokens"].sum() > 0
    doc = eng.obs.chrome_trace()
    errs = validate_chrome_trace(doc)
    assert errs == [], errs[:5]
    prom = eng.obs.prometheus()
    m = eng.obs.snapshot()["metrics"]
    n_req = 4 * wl["n_requests"]
    assert m["requests.admitted"] == m["requests.finished"] == n_req
    phases = {p: 1e3 * m[f"serve.phase.{p}_s"]["sum"] / st["steps"]
              for p in ("admit", "schedule", "decide", "dispatch", "fetch", "deliver")}
    tel = eng.obs.rank_telemetry(eng.core)
    plain, plain_outs, plain_launches = record_suite(cfg, params, DEV, **wl, **FRONT_KNOBS)
    ps = plain.stats
    assert plain_launches == cfg.num_layers * (ps["steps"] + plain.core.warmup_steps)
    for i, (a, b) in enumerate(zip(outs, plain_outs)):
        assert np.array_equal(a, b), f"request {i}: recording changed its tokens"
    ms, ms_plain = 1e3 * st["decode_s"] / st["steps"], 1e3 * ps["decode_s"] / ps["steps"]
    log(f"  traced run: {n_req} requests x 64 tokens, {st['steps']} fused steps "
        f"({st['mixed_steps']} mixed), {st['decides']} decisions, {st['prefix_hits']} "
        f"prefix hits; flash_decode launches {launches} = {cfg.num_layers} x "
        f"{st['steps'] + eng.core.warmup_steps} steps; {manifest['n_records']} trace "
        f"records in {len(manifest['shards'])} shard(s); {len(doc['traceEvents'])} trace "
        f"events, validate_chrome_trace == []; prometheus text {len(prom.splitlines())} "
        f"lines; wall {wall:.2f} s")
    log(f"  ms/step: recording + obs tracing + flight + per-token timing {ms:.2f}, "
        f"all off {ms_plain:.2f} (tokens equal, {ps['steps']} steps) [{card_name}]")
    log("  host ms per fused step by phase (StepPhases, per-token timing syncs inside "
        "dispatch): " + ", ".join(f"{p} {v:.3f}" for p, v in phases.items()))
    log(f"  rank telemetry: {tel['decisions']} decisions, {tel['rank_switches']} rank "
        f"switches, {tel['veto_fires']} veto fires, mean kept rank "
        f"{tel['mean_kept_rank']:.2f}")
    return {"records": manifest["n_records"], "shards": len(manifest["shards"]),
            "launches": launches, "steps": st["steps"], "ms_step": ms,
            "ms_step_plain": ms_plain, "prometheus_lines": len(prom.splitlines()),
            "trace_events": len(doc["traceEvents"]), "phase_ms": phases}


def check_policy_training(cfg, out, card_name) -> dict:
    """16b: the serving policy trained on the card from the 16a trace (30 BC
    steps, 2 PPO steps of 1 epoch), checkpointed; then its BC stages alone
    on the card and on the CPU from the same trace and initial params."""
    trace_dir, pol_dir = os.path.join(out, "trace"), os.path.join(out, "policy")
    t0 = time.perf_counter()
    _, hist = serve_policy.train_serve_policy(trace_dir, cfg.rank, out_dir=pol_dir,
                                              bc_steps=30, ppo_steps=2, ppo_epochs=1,
                                              device=DEV)
    wall = time.perf_counter() - t0
    ev = hist["eval"]
    log(f"  train_serve_policy on the card: {ev['n_records']} records, wall {wall:.2f} s "
        f"(dataset {hist['stage_s']['dataset']:.3f} s, BC {hist['stage_s']['bc']:.3f} s, "
        f"PPO {hist['stage_s']['ppo']:.3f} s; checkpoint after) [{card_name}]")
    for who in ("learned", "adaptive", "oracle"):
        e = ev[who]
        log(f"    {who:8s} reward {e['reward']:.6f}, mean rank {e['mean_rank']:.3f}, "
            f"agreement {e['agreement']:.6f}, read fraction {e['read_frac']:.4f}")
    log(f"    picked {ev['picked']} of " + ", ".join(
        f"{lab} ({e['reward']:.6f}, {e['mean_rank']:.3f})" for lab, e in hist["candidates"]))
    # the BC stages alone, card vs CPU, from the card's initial params
    G = len(cfg.rank.rank_grid)
    p0 = serve_policy._init(torch.Generator(DEV).manual_seed(0), drrl.feat_dims(cfg.rank),
                            G, serve_policy.POLICY_ARCH, DEV)
    kw = dict(bc_steps=30, ppo_steps=0, ppo_epochs=1, eval_every=30)
    card_p, card_h = serve_policy.train_serve_policy(trace_dir, cfg.rank, device=DEV, **kw)
    inner = serve_policy.init_policy
    serve_policy.init_policy = lambda gen, dims, n, **k: tu.tree_map(
        lambda x: x.to("cpu"), p0)
    try:
        cpu_p, cpu_h = serve_policy.train_serve_policy(trace_dir, cfg.rank, device="cpu",
                                                       **kw)
    finally:
        serve_policy.init_policy = inner
    ds_card = serve_policy.build_dataset(trace_dir, cfg.rank, device=DEV)
    ds_cpu = serve_policy.build_dataset(trace_dir, cfg.rank, device="cpu")
    oracle_diff = int((ds_card["oracle"].cpu() != ds_cpu["oracle"]).sum())
    diffs = [(a.cpu() - b).abs() for a, b in zip(tu.leaves(card_p), tu.leaves(cpu_p))]
    worst = max(float(d.max()) for d in diffs)
    n_far = sum(int((d > 1e-6).sum()) for d in diffs)
    n = sum(d.numel() for d in diffs)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(card_h["bc_loss"], cpu_h["bc_loss"]))
    log(f"  BC stages (30 steps) card vs CPU, same trace and initial params: params "
        f"max|diff| {worst:.3g} (tol 2.5 x lr = {2.5 * POLICY_LR:g}), {n - n_far} of {n} "
        f"elements within 1e-6 (tol 99 %); bc_loss relative {loss_rel:.3g}; oracle "
        f"actions differing {oracle_diff} of {ds_cpu['n']}")
    assert worst <= 2.5 * POLICY_LR and n_far <= 0.01 * n, (worst, n_far, n)
    return {"wall_s": wall, "stage_s": hist["stage_s"], "eval": ev,
            "bc_params_max_diff": worst, "bc_far_elements": n_far}


def check_learned_frontend(cfg, params, pol_dir, st_ref, card_name) -> dict:
    """16c: the trained policy loaded and served in rank mode 'learned'
    through a FrontEnd on phase 3's prompts and arrivals, against the same
    engine stepped by the caller: tokens and ranks per step equal, 12
    flash_decode launches per fused step."""
    lcfg = cfg.with_(rank=RankConfig(mode="learned", rank_grid=GRID, segment_len=32))
    pol = serve_policy.load_policy(pol_dir, device=DEV)
    prompts, arrivals = phase3_workload(cfg.vocab_size)
    ref, ref_outs, _, _ = serve_prompts(lcfg, params, pol, prompts=prompts,
                                        arrivals=arrivals, **FRONT_KNOBS)
    eng = Engine(lcfg, params, pol, device=DEV, config=EngineConfig(**FRONT_KNOBS))
    # every request is queued before the thread starts: the schedule is the
    # caller-stepped run's
    hs = [eng.submit(p, SamplingParams(max_new=64), arrival=a)
          for p, a in zip(prompts, arrivals)]
    reset_launches()
    fe = FrontEnd(eng, idle_poll_s=0.01)
    try:
        assert fe.drain(WAIT_S), "the front end did not drain"
    finally:
        fe.shutdown(drain=False, timeout=60.0)
    launches = decode_attn.LAUNCHES["flash_decode"]
    st = eng.stats
    assert launches == cfg.num_layers * (st["steps"] + eng.core.warmup_steps), launches
    outs = [h.result() for h in hs]
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        assert np.array_equal(a, b), f"request {i}: front end tokens differ"
    got, want = eng.ranks_per_step(), ref.ranks_per_step()
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    tel = eng.obs.rank_telemetry(eng.core)
    ranks = sorted({int(r) for row in got for r in row if r >= 0})
    tok_s, ms = st["tokens_decoded"] / st["decode_s"], 1e3 * st["decode_s"] / st["steps"]
    ref_tok_s = ref.stats["tokens_decoded"] / ref.stats["decode_s"]
    log(f"  learned, FrontEnd: 8 requests x 64 tokens, {st['steps']} fused steps, "
        f"flash_decode launches {launches} = {cfg.num_layers} x "
        f"{st['steps'] + eng.core.warmup_steps}; tokens and ranks per step equal the "
        f"caller-stepped run's; {tel['decisions']} decisions, {tel['rank_switches']} "
        f"rank switches, {tel['veto_fires']} veto fires, ranks {ranks}; {tok_s:.1f} decoded "
        f"tokens/s, {ms:.2f} ms/step (caller-stepped {ref_tok_s:.1f} tokens/s; phase 3 "
        f"adaptive with the factor cache {st_ref['tokens_decoded'] / st_ref['decode_s']:.1f} "
        f"tokens/s, {1e3 * st_ref['decode_s'] / st_ref['steps']:.2f} ms/step) [{card_name}]")
    return {"launches": launches, "tok_s": tok_s, "ms_step": ms, "ref_tok_s": ref_tok_s,
            "decisions": tel["decisions"], "rank_switches": tel["rank_switches"],
            "veto_fires": tel["veto_fires"], "ranks": ranks}


def check_router(cfg, params, cold, rerun, card_name) -> dict:
    """16d: phase 15c's shared-prefix prompts through a Router of 2 replicas
    on the one card, prefix-cache affinity and then round-robin: request 0
    first (it warms one replica), then the other 7 at once. Tokens against
    15c's single-engine cold run (equal, or a first difference at a near-tie
    of that run)."""
    prompts, _ = prefix_workload(cfg.vocab_size)
    res = {}
    for routing in ("affinity", "round_robin"):
        fleet = FleetConfig(engine=EngineConfig(**FRONT_KNOBS, prefix_cache=True),
                            n_replicas=2, routing=routing, idle_poll_s=0.01)
        reset_launches()
        router = Router(cfg, params, fleet=fleet, device=DEV)
        try:
            t0 = time.perf_counter()
            lead = router.submit(prompts[0], SamplingParams(max_new=64))
            wait_done(lead)
            hs = [lead] + [router.submit(p, SamplingParams(max_new=64)) for p in prompts[1:]]
            assert router.drain(WAIT_S), "the router did not drain"
            wall = time.perf_counter() - t0
        finally:
            router.shutdown(drain=False, timeout=60.0)
        launches = decode_attn.LAUNCHES["flash_decode"]
        n_steps = sum(fe.engine.stats["steps"] + fe.engine.core.warmup_steps
                      for fe in router.replicas)
        assert launches == cfg.num_layers * n_steps, (launches, n_steps)
        st = router.stats()
        for fe in router.replicas:
            fe.engine.core.cache.check_refs(fe.engine.core.prefix.all_pages())
        outs = [h.result() for h in hs]
        n_diff = compare_streams(outs, cold, rerun, f"router ({routing}) vs one engine")
        agg = st["aggregate"]
        res[routing] = {"routed": st["routed"], "route_kinds": st["route_kinds"],
                        "hit_rate": agg["hit_rate"], "tok_s_sum": agg["tok_per_s"],
                        "tok_s_wall": agg["tokens_decoded"] / wall, "wall_s": wall,
                        "launches": launches, "n_diff": n_diff}
        log(f"  router, {routing}: routed {st['routed']}, route kinds "
            f"{ {k: v for k, v in st['route_kinds'].items() if v} }, prefix hit rate "
            f"{agg['hit_rate']:.3f}; {agg['tokens_decoded']} decoded tokens, "
            f"{agg['tok_per_s']:.1f} tokens/s summed over replicas' decode clocks, "
            f"{agg['tokens_decoded'] / wall:.1f} tokens/s over the wall {wall:.2f} s; "
            f"flash_decode launches {launches} = {cfg.num_layers} x {n_steps} [{card_name}]")
        del router
        gc.collect()
        torch.cuda.empty_cache()
    return res


def check_flight_dump(cfg, params, out) -> None:
    """16e: a FrontEnd whose engine's step raises once a request is queued:
    the flight ring lands in flight_dir, the handle raises EngineStopped and
    drain() re-raises the step's error."""
    from repro_torch.serve import EngineStopped
    flight = os.path.join(out, "flight_error")
    eng = Engine(cfg, params, device=DEV, config=EngineConfig(
        n_slots=2, max_len=256, page_size=16, prefill_chunk=128, use_kernel=True,
        flight_dir=flight))
    inner = eng.core.step

    def failing():
        if eng.core.sched.depth():
            raise RuntimeError("injected step failure")
        return inner()
    eng.core.step = failing
    fe = FrontEnd(eng, idle_poll_s=0.01, warmup=False)
    try:
        h = fe.submit(np.arange(40, dtype=np.int32), SamplingParams(max_new=8))
        stopped = False
        try:
            wait_done(h, timeout=60.0)
        except EngineStopped:
            stopped = True
        cause = None
        try:
            fe.drain(60.0)
        except EngineStopped as e:
            cause = e.__cause__
    finally:
        fe.shutdown(drain=False, timeout=60.0)
    assert stopped and isinstance(cause, RuntimeError), (stopped, cause)
    dumps = sorted(f for f in os.listdir(flight) if f.startswith("flight_"))
    with open(os.path.join(flight, dumps[0])) as f:
        doc = json.load(f)
    assert doc["reason"] == "step_exception" and "injected step failure" in doc["error"]
    log(f"  step error: the handle raised EngineStopped, drain() re-raised "
        f"{type(cause).__name__}; {len(dumps)} flight dump(s) ({', '.join(dumps)}), the "
        f"first '{doc['reason']}' with {len(doc['events'])} events")


def check_cli(card_name) -> dict:
    """16f: ``python -m repro_torch.launch.serve`` as a subprocess on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device",
                        torch.device(DEV).type], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(("decoded", "TTFT"))]
    assert len(lines) == 2, r.stdout[-2000:]
    tok_s = float(re.search(r"at ([0-9.]+) tok/s", lines[0]).group(1))
    log(f"  python -m repro_torch.launch.serve (reduced config, the process's wall "
        f"{wall:.1f} s) [{card_name}]:")
    for ln in lines:
        log("    " + ln[:300])
    return {"tok_s": tok_s, "wall_s": wall}


def check_front_reference(out) -> None:
    """16g: the reduced model's trace of the four scenarios and 'learned'
    serving from one checkpoint, on the card with the kernel against the
    CPU without it: the traces' integer columns identical and their spectra
    within 1e-4 of each record's largest value; learned tokens and ranks
    identical."""
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    knobs = dict(n_slots=4, max_len=96, page_size=16, segment_len=8, max_new_cap=10,
                 prefill_chunk=8)
    recs = {}
    for device, use_kernel in ((DEV, True), ("cpu", False)):
        d = os.path.join(out, f"reduced_trace_{device}")
        eng, outs, _ = record_suite(cfg, params, device, 4, 10, 40, record_traces=d,
                                    use_kernel=use_kernel, **knobs)
        eng.core.trace.flush()
        recs[device] = (TraceReader(d).records, outs)
    (rg, og), (rc, oc) = recs[DEV], recs["cpu"]
    for a, b in zip(og, oc):
        np.testing.assert_array_equal(a, b)
    for col in TRACE_INT_COLUMNS:
        assert np.array_equal(rg[col], rc[col]), col
    worst = 0.0
    for col in ("s2", "prev_s2"):
        scale = np.abs(rc[col]).reshape(len(rc[col]), -1).max(axis=1)[:, None, None]
        err = np.abs(rg[col] - rc[col]) / np.maximum(scale, 1e-30)
        worst = max(worst, float(err.max()))
    assert worst <= 1e-4, worst
    pol_dir = os.path.join(out, "reduced_policy")
    serve_policy.train_serve_policy(os.path.join(out, "reduced_trace_cpu"), cfg.rank,
                                    out_dir=pol_dir, bc_steps=30, ppo_steps=2,
                                    ppo_epochs=1, device="cpu")
    lcfg = cfg.with_(rank=RankConfig(mode="learned", rank_grid=(4, 8, 12, 16),
                                     segment_len=8))
    runs = {}
    for device, use_kernel in ((DEV, True), ("cpu", False)):
        rng = np.random.default_rng(0)
        eng = Engine(lcfg, params, serve_policy.load_policy(pol_dir, device=device),
                     device=device, config=EngineConfig(
                         use_kernel=use_kernel, n_slots=3, max_len=64, page_size=16,
                         segment_len=8, max_new_cap=12, prefill_chunk=8))
        hs = [eng.submit(rng.integers(0, 256, int(n)), SamplingParams(max_new=12),
                         arrival=2 * i) for i, n in enumerate(rng.integers(8, 33, 6))]
        eng.run()
        runs[device] = ([h.result() for h in hs], eng.ranks_per_step())
    (tg, kg), (tc, kc) = runs[DEV], runs["cpu"]
    for a, b in zip(tg, tc):
        np.testing.assert_array_equal(a, b)
    assert len(kg) == len(kc) and all(np.array_equal(a, b) for a, b in zip(kg, kc))
    ranks = sorted({int(r) for row in kg for r in row if r >= 0})
    log(f"  reduced model: traces card (kernel) vs CPU (plain): {len(rc['slot'])} records, "
        f"integer columns identical, spectra within {worst:.3g} of each record's largest "
        f"(tol 1e-4), tokens identical; learned serving from one checkpoint: tokens and "
        f"ranks identical ({len(kg)} steps, ranks {ranks})")


# -- phase 17 ----------------------------------------------------------------

LM_BATCH, LM_SEQ = 8, 256          # the training CLI's defaults
# 17f: the reduced model's training, card vs CPU (tests/test_torch_train_loop.py's
# tolerances for rank mode 'drrl'): loss and grad norm relative; parameters:
# AdamW normalises each element's step, so a gradient element near zero in the
# last bits can move its parameter by up to about lr more on one side: every
# element within 2 x the summed lr, 99 % of each leaf's elements within 5e-5
LM_LOSS_TOL, LM_GNORM_TOL, LM_P99_TOL = 2e-5, 1e-4, 5e-5
# 17c: two bf16-accumulated microbatches against one batch, one step from the
# same params: the microbatches' mean loss is the batch's loss up to f32
# summation order; the bf16 accumulator rounds each summed gradient element
# once more (at most 2^-9 of it, the f32 error carried but not added back), so
# the grad norm moves by at most 2^-8 relative; the params by at most 2 lr
ACC_LOSS_TOL, ACC_GNORM_TOL = 1e-5, 2 ** -8


class _Tee:
    """stdout that also keeps what passes through it."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def lm_loss_fn(cfg, agent):
    """The training CLI's loss: rank mode 'drrl' with ``agent`` and the
    step's rank key."""
    fns = get_model(cfg)
    return lambda p, b, rng: fns.loss(p, b, policy_params=agent, rank_rng=rng)


def _tree_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(tu.leaves(a), tu.leaves(b)))


def check_train_cli(paper, out, card_name) -> dict:
    """17a: ``launch.train.main`` at full width, 4 steps with checkpoints,
    then 6 steps resumed from step 4. Returns the numbers and the second
    run's params (in memory) and checkpoint directory."""
    ckpt = os.path.join(out, "cli_ckpt")
    argv = ["--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--ckpt-dir", ckpt,
            "--device", DEV]
    runs = []
    for steps in (4, 6):
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            res = train_launch.main(argv + ["--steps", str(steps)])
        torch.cuda.synchronize()
        runs.append((res, "".join(tee.text), time.perf_counter() - t0))
    (r4, text4, wall4), (r6, text6, wall6) = runs
    assert "[ckpt]" not in text4, text4
    assert "[ckpt] resumed from step 4" in text6, text6
    hist = r4["history"] + r6["history"]
    assert [h["step"] for h in hist] == [0, 3, 5], hist
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist), hist
    steady = [h["s_per_step"] for h in hist[1:]]
    log(f"  launch.train.main, drrl-paper {paper.num_layers} x {paper.d_model} in rank "
        f"mode '{paper.rank.mode}', {LM_BATCH} x "
        f"{LM_SEQ} tokens: 4 steps in {wall4:.1f} s, then 6 resumed from step 4 in "
        f"{wall6:.1f} s (init and checkpoints included); losses "
        f"{[round(h['loss'], 4) for h in hist]} at steps 0, 3, 5; s/step "
        f"{hist[0]['s_per_step']:.3f} (step 0), {steady[0]:.3f} and {steady[1]:.3f} "
        f"(steps 3, 5) [{card_name}]")
    return {"s_per_step": steady, "s_first_step": hist[0]["s_per_step"],
            "losses": [h["loss"] for h in hist], "wall_s": [wall4, wall6],
            "params": r6["params"], "opt_state": r6["opt_state"], "ckpt": ckpt}


def check_train_resume(cfg, agent, out, card_name) -> float:
    """17b: run_training straight to 4 steps against 2 steps, a synchronous
    checkpoint and a resume to 4 (schedule 'constant', as
    tests/test_system.py), under torch.use_deterministic_algorithms: the
    index and gather backwards then sum in a fixed order instead of with
    atomics, so the runs must be equal. ``warn_only``: the Eq. 6 features'
    NER curve (a cumsum over each head's 64 eigenvalues, no gradient) has
    no path the switch accepts."""
    tc = TrainConfig(global_batch=2, seq_len=LM_SEQ, lr=3e-4, total_steps=4,
                     warmup_steps=1, checkpoint_every=2, log_every=100,
                     async_checkpoint=False, schedule="constant")
    kw = dict(init_fn=get_model(cfg).init, loss_fn=lm_loss_fn(cfg, agent),
              data=SyntheticLM(cfg.vocab_size, LM_SEQ, 2, seed=0), device=DEV)
    cm = CheckpointManager(os.path.join(out, "resume_ckpt"), async_save=False)
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            straight = train_loop.run_training(cfg, tc, **kw)
            train_loop.run_training(cfg, dataclasses.replace(tc, total_steps=2),
                                    ckpt_manager=cm, **kw)
            resumed = train_loop.run_training(cfg, tc, ckpt_manager=cm, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    assert cm.all_steps() == [2, 4], cm.all_steps()
    diff = max(_tree_diff(straight["params"], resumed["params"]),
               _tree_diff(straight["opt_state"], resumed["opt_state"]))
    assert diff == 0.0, f"resumed run differs from the straight one by {diff}"
    log(f"  run_training 4 steps straight vs 2 + checkpoint + resume to 4 (2 x "
        f"{LM_SEQ} tokens, deterministic algorithms): max|dparam| = max|dAdamW| = "
        f"{diff} (equality required); final loss {straight['history'][-1]['loss']:.6f} "
        f"[{card_name}]")
    return diff


def check_accumulation(cfg, agent, card_name) -> dict:
    """17c: one step with 2 microbatches and bf16 error-feedback
    accumulation against one step on the whole batch, same params and
    batch."""
    params = get_model(cfg).init(torch.Generator(DEV).manual_seed(0), device=DEV)
    batch = SyntheticLM(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0).batch_at(0, device=DEV)
    res = {}
    for mb, comp in ((1, "none"), (2, "bf16")):
        tc = TrainConfig(global_batch=LM_BATCH, seq_len=LM_SEQ, lr=3e-4, warmup_steps=1,
                         total_steps=4, microbatches=mb, grad_compression=comp)
        step = train_loop.make_train_step(cfg, tc, lm_loss_fn(cfg, agent))
        p, _, m = step(params, adamw.init(params), batch, prng.fold_in(prng.key(0), 0))
        res[comp] = (p, {k: float(v) for k, v in m.items()})
    (p1, m1), (p2, m2) = res["none"], res["bf16"]
    loss_err = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
    gn_err = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    dp = _tree_diff(p1, p2)
    assert loss_err <= ACC_LOSS_TOL, (m1, m2)
    assert gn_err <= ACC_GNORM_TOL, (m1, m2)
    assert dp <= 2 * m1["lr"], dp
    log(f"  one step, microbatches 1 ('none') vs 2 ('bf16'): loss {m1['loss']:.7f} vs "
        f"{m2['loss']:.7f} (relative {loss_err:.3g}, tol {ACC_LOSS_TOL}), grad norm "
        f"{m1['grad_norm']:.7f} vs {m2['grad_norm']:.7f} (relative {gn_err:.3g}, tol "
        f"{ACC_GNORM_TOL:.3g}), max|dparam| {dp:.3g} (lr {m1['lr']:.3g}) [{card_name}]")
    return {"loss": [m1["loss"], m2["loss"]], "grad_norm": [m1["grad_norm"], m2["grad_norm"]],
            "max_dparam": dp}


def profile_train_step(cfg, agent, card_name) -> dict:
    """17d: one training step of the CLI's shape (8 x 256): wall, and under
    torch.profiler (device activity) busy and idle, eigh's forward
    (cuSOLVER), cuBLAS, eager ops and copies; then the step's backward alone
    under torch.profiler with host activity too (eigh's backward, the
    autograd engine's LinalgEighBackward0, and the whole backward) and
    AdamW by CUDA events; peak memory and both kernels' launches. The
    forward's per-matrix eigh makes some 10^5 device events per step, so
    only device activity is traced over the whole step, and one eigh call
    of the forward's shape is profiled alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    params = get_model(cfg).init(torch.Generator(DEV).manual_seed(0), device=DEV)
    batch = SyntheticLM(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0).batch_at(0, device=DEV)
    tc = TrainConfig(global_batch=LM_BATCH, seq_len=LM_SEQ, lr=3e-4, warmup_steps=1,
                     total_steps=4)
    loss_fn = lm_loss_fn(cfg, agent)
    rng = prng.fold_in(prng.key(0), 0)
    step = train_loop.make_train_step(cfg, tc, loss_fn)
    opt = adamw.init(params)
    step(params, opt, batch, rng)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(params, opt, batch, rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch, rng)
        torch.cuda.synchronize()
    kern = raw_device_kernels(prof)
    t_prof = time.perf_counter() - t0
    launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
    assert launches == {"flash_decode": 0, "lowrank_flash": 0}, launches
    busy = sum(dev_us(e) for e in kern)
    layers = by_layer(kern)
    n_eigh_kernels = sum(e.count for e in kern if by_layer([e])["eigh (cuSOLVER)"])
    n_dtoh = sum(e.count for e in kern if "DtoH" in e.key)
    # the backward alone, host activity too: the autograd engine's functions
    live = tu.tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch, rng)[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bprof:
            grads = torch.autograd.grad(loss, tu.leaves(live))
            torch.cuda.synchronize()
    cpu_ops = [e for e in bprof.key_averages() if e.device_type == DeviceType.CPU]
    eigh_bwd = sum(device_total_us(e) for e in cpu_ops if "LinalgEighBackward" in e.key)
    backward = sum(device_total_us(e) for e in cpu_ops
                   if e.key.startswith("autograd::engine::evaluate_function"))
    grads = tu.unflatten(params, list(grads))
    del live, loss
    adamw_ms = time_ms(lambda: adamw.update(tc, make_lr_fn(tc), opt, params,
                                            grads), n=5)
    # one eigh call of the forward's shape alone: does cuSOLVER loop per matrix?
    hd = cfg.resolved_head_dim()
    x = torch.randn((LM_BATCH, cfg.num_heads, LM_SEQ, hd), device=DEV,
                    generator=torch.Generator(DEV).manual_seed(5))
    gram = lowrank.gram(x)
    lowrank.gram_spectrum(gram)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as eprof:
        lowrank.gram_spectrum(gram)
        torch.cuda.synchronize()
    ek = raw_device_kernels(eprof)
    eigh_one = {"matrices": LM_BATCH * cfg.num_heads,
                "cusolver_kernels": sum(e.count for e in ek
                                        if by_layer([e])["eigh (cuSOLVER)"]),
                "dtoh_copies": sum(e.count for e in ek if "DtoH" in e.key),
                "device_ms": by_layer(ek)["eigh (cuSOLVER)"] / 1e3}
    n_par = sum(p.numel() for p in tu.leaves(params))
    state_gib = 3 * 4 * n_par / 2 ** 30
    log(f"  one step, {LM_BATCH} x {LM_SEQ} tokens: wall {wall * 1e3:.1f} ms unprofiled, "
        f"device busy {busy / 1e3:.2f} ms (idle {1 - busy / (wall * 1e6):.1%}); "
        f"{n_par / 1e6:.1f} M parameters, with AdamW's two moments {state_gib:.2f} GiB; "
        f"the step's peak allocation {peak / 2 ** 30:.2f} GiB beyond what it started with; "
        f"{n_eigh_kernels} cuSOLVER kernels and {n_dtoh} device-to-host copies; "
        f"flash_decode / lowrank_flash launches {launches['flash_decode']} / "
        f"{launches['lowrank_flash']} (profiled in {t_prof:.1f} s) [{card_name}]")
    log_layers(layers, busy)
    log(f"  the backward alone: {backward / 1e3:.3f} ms of device time, of which eigh's "
        f"backward {eigh_bwd / 1e3:.3f} ms; AdamW over {n_par / 1e6:.1f} M parameters "
        f"{adamw_ms:.3f} ms (CUDA events, flushed L2)")
    log(f"  one eigh call of the forward's shape alone ({eigh_one['matrices']} Grams of "
        f"{hd} x {hd}): {eigh_one['device_ms']:.2f} ms of cuSOLVER device time, "
        f"{eigh_one['cusolver_kernels']} cuSOLVER kernels, {eigh_one['dtoh_copies']} "
        f"device-to-host copies")
    log("  top kernels:")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / busy:6.1%} "
            f"x{e.count:<6d} {e.key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "idle": 1 - busy / (wall * 1e6),
            "eigh_fwd_ms": layers["eigh (cuSOLVER)"] / 1e3, "eigh_bwd_ms": eigh_bwd / 1e3,
            "cusolver_kernels": n_eigh_kernels, "dtoh_copies": n_dtoh,
            "cublas_ms": layers["matrix products (cuBLAS)"] / 1e3,
            "eager_ms": layers[OTHER] / 1e3, "copies_ms": layers["copies"] / 1e3,
            "adamw_ms": adamw_ms, "backward_ms": backward / 1e3,
            "peak_above_gib": peak / 2 ** 30, "state_gib": state_gib, "eigh_one": eigh_one,
            "launches": launches}


def check_trained_serving(paper, trained, card_name) -> int:
    """17e: 17a's last checkpoint loaded into a fresh template, then phase
    3's workload served from it with the kernel (phase 3's adaptive
    settings), against serving the params 17a's run holds in memory."""
    fresh = get_model(paper).init(torch.Generator(DEV).manual_seed(123), device=DEV)
    cm = CheckpointManager(trained["ckpt"])
    (params, opt), step, _ = cm.load((fresh, adamw.init(fresh)))
    assert step == 6 and type(opt) is adamw.AdamWState, (step, type(opt))
    assert _tree_diff(params, trained["params"]) == 0.0
    assert _tree_diff(opt, trained["opt_state"]) == 0.0
    cfg = paper.with_(rank=RankConfig(mode="adaptive", rank_grid=GRID, segment_len=32))
    knobs = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                 use_kernel=True)
    runs = []
    for tree in (params, trained["params"]):
        eng, outs, launches, _ = serve(cfg, tree, **knobs)
        n_steps = eng.stats["steps"] + eng.core.warmup_steps
        assert launches == cfg.num_layers * n_steps, (launches, n_steps)
        runs.append((outs, launches, eng.stats))
    (outs, launches, st), (outs_mem, _, _) = runs
    for i, (a, b) in enumerate(zip(outs, outs_mem)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}: checkpoint vs memory")
    log(f"  step-6 checkpoint loaded into a fresh (params, AdamWState) template: equal to "
        f"the run's; phase 3's workload served from it: {len(outs)} requests x 64 tokens "
        f"equal to serving the in-memory params, flash_decode launches {launches} = "
        f"{cfg.num_layers} x {launches // cfg.num_layers} fused steps (warmup's 2 "
        f"included), {st['tokens_decoded'] / st['decode_s']:.1f} decoded tokens/s "
        f"[{card_name}]")
    return launches


def check_train_reference(card_name) -> None:
    """17f: the reduced model (its own rank mode 'drrl', a seeded agent)
    trained 3 steps on the card and on the CPU from the same params,
    agent and batches, TF32 off."""
    cfg = get_config("drrl-paper", reduced=True)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    agent = drrl.init_agent(torch.Generator().manual_seed(7), cfg.rank, cfg.d_model,
                            device="cpu")
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    tc = TrainConfig(global_batch=4, seq_len=64, lr=1e-2, warmup_steps=1, total_steps=3)
    out = {}
    for dev in (DEV, "cpu"):
        step = train_loop.make_train_step(cfg, tc, lm_loss_fn(cfg, params_to(agent, dev)))
        p = params_to(params, dev)
        opt, hist = adamw.init(p), []
        for i in range(3):
            p, opt, m = step(p, opt, data.batch_at(i, device=dev), prng.fold_in(prng.key(0), i))
            hist.append({k: float(v) for k, v in m.items()})
        out[dev] = (params_to(p, "cpu"), hist)
    (pg, hg), (pc, hc) = out[DEV], out["cpu"]
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for a, b in zip(hg, hc):
        for k in worst:
            worst[k] = max(worst[k], abs(a[k] - b[k]) / abs(b[k]))
    assert worst["loss"] <= LM_LOSS_TOL and worst["grad_norm"] <= LM_GNORM_TOL, (hg, hc)
    lr_sum = sum(h["lr"] for h in hc)
    p_max, p99 = 0.0, 0.0
    for (path, g), c in zip(tu.leaves_with_path(pg), tu.leaves(pc)):
        d = (g - c).abs().flatten()
        q = torch.quantile(d, 0.99).item()
        assert d.max().item() <= 2 * lr_sum and q <= LM_P99_TOL, (path, d.max().item(), q)
        p_max, p99 = max(p_max, d.max().item()), max(p99, q)
    log(f"  reduced model, 3 steps of 4 x 64 tokens, card vs CPU: loss within "
        f"{worst['loss']:.3g} (tol {LM_LOSS_TOL}), grad norm within "
        f"{worst['grad_norm']:.3g} (tol {LM_GNORM_TOL}), params max|diff| {p_max:.3g} "
        f"(tol {2 * lr_sum:.3g}), largest leaf 99th percentile {p99:.3g} (tol "
        f"{LM_P99_TOL}) [{card_name}]")


# 17g: drrl-paper's LM step with loss(chunked=True), the reference's
# long-sequence training path: lowrank_flash and its backward kernel in every
# layer, at the paper's own length
CHUNKED_BATCH, CHUNKED_SEQ, CHUNKED_STEPS = 2, 4096, 3
# step 1 chunked against the same step unchunked, same weights, batch and rank
# key, TF32 off: the two attention paths differ only in f32 summation order.
# Loss and grad norm relative, the updated parameters leaf by leaf: every
# element within 2 lr (AdamW's first step moves each by about lr times the
# sign of its gradient, so a gradient near zero may flip it), 99 % of each
# leaf's elements within CHUNKED_P99_TOL; the ranks identical. Each limit is
# about 10x the gap measured on an H100 (loss 8.4e-8, grad norm 9.5e-8,
# largest leaf 99th percentile 8.9e-8), far inside tests/test_torch_train_
# loop.py's 2e-5 / 1e-4 / 5e-5 for rank mode 'drrl'. A dK or dV misplaced in
# one layer flips many updates by 2 lr, past the 99th percentile; one scaled
# by 1.01 leaves AdamW's first update as it was and moves the grad norm
# (2.3e-5 relative in a 2-layer CPU rehearsal)
CHUNKED_LOSS_TOL, CHUNKED_GNORM_TOL, CHUNKED_P99_TOL = 1e-6, 1e-6, 1e-6


def param_gaps(a, b) -> dict:
    """|a - b| leaf by leaf over two parameter trees: the largest element
    and the largest leaf 99th percentile (numpy's, on the host: leaves past
    torch.quantile's 16M elements), each with its leaf, and the count of
    elements that differ."""
    res = {"max": 0.0, "max_leaf": None, "p99": 0.0, "p99_leaf": None, "differ": 0, "n": 0}
    for (path, x), y in zip(tu.leaves_with_path(a), tu.leaves(b)):
        d = (x - y).abs().flatten()
        top, q = d.max().item(), float(np.quantile(d.cpu().numpy(), 0.99))
        if top >= res["max"]:
            res["max"], res["max_leaf"] = top, path
        if q >= res["p99"]:
            res["p99"], res["p99_leaf"] = q, path
        res["differ"] += int((d > 0).sum())
        res["n"] += d.numel()
    return res


def chunked_loss_fn(cfg, agent, chunked, ranks):
    """lm_loss_fn with ``chunked``; each call's per-layer ranks (L, b, hkv)
    appended to ``ranks`` (on the device: no sync inside the step)."""
    fns = get_model(cfg)

    def lf(p, b, rng):
        loss, aux = fns.loss(p, b, policy_params=agent, rank_rng=rng, chunked=chunked,
                             collect_aux="ranks")
        ranks.append(aux["layers"]["rank"].detach().clone())
        return loss, aux
    return lf


@contextlib.contextmanager
def grads_seen(store: list):
    """The gradients that make_train_step hands ``adamw.update``, each
    step's leaves appended to ``store``."""
    real = train_loop.adamw.update

    def update(tc, lr_fn, state, params, grads, **kw):
        store.append(tu.leaves(grads))
        return real(tc, lr_fn, state, params, grads, **kw)
    train_loop.adamw.update = update
    try:
        yield store
    finally:
        train_loop.adamw.update = real


# 17g's and 20h's checkpointed steps (cfg.remat, models.common.remat_layer):
# the forward of lowrank_flash runs again in each layer's recompute (a ctypes
# kernel: selective checkpointing cannot save its outputs)
CHECKPOINTED = ("full", "dots")


def check_chunked_training(cfg, agent, card_name) -> dict:
    """17g: CHUNKED_STEPS steps of ``make_train_step`` with
    ``loss(chunked=True)`` at CHUNKED_BATCH x CHUNKED_SEQ tokens: per step
    one lowrank_flash and one lowrank_flash_bwd launch per layer, no
    flash_decode; step 1 against the same step with ``loss(chunked=False)``
    (loss, grad norm, ranks, the updated parameters leaf by leaf); then
    step 1 again under ``remat`` 'full' and 'dots' from the same weights,
    batch and rank key (two lowrank_flash launches per layer: the forward
    and its recompute), each against the plain step 1 with the same limits
    (and whether its gradients are bitwise the plain step's); s/step, peak
    memory of every step ('full' below the plain step), one step profiled
    (device busy and idle, the backward kernel's share)."""
    from torch.profiler import ProfilerActivity, profile
    params = get_model(cfg).init(torch.Generator(DEV).manual_seed(0), device=DEV)
    data = SyntheticLM(cfg.vocab_size, CHUNKED_SEQ, CHUNKED_BATCH, seed=0)
    tc = TrainConfig(global_batch=CHUNKED_BATCH, seq_len=CHUNKED_SEQ, lr=3e-4,
                     warmup_steps=1, total_steps=CHUNKED_STEPS)
    assert cfg.remat == "none", cfg.remat
    ranks = {True: [], False: [], **{r: [] for r in CHECKPOINTED}}
    steps = {c: train_loop.make_train_step(cfg, tc, chunked_loss_fn(cfg, agent, c, ranks[c]))
             for c in (True, False)}
    for r in CHECKPOINTED:
        cfg_r = cfg.with_(remat=r)
        steps[r] = train_loop.make_train_step(cfg_r, tc, chunked_loss_fn(cfg_r, agent, True,
                                                                         ranks[r]))
    L = cfg.num_layers

    def run(key, p, opt, i):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        p, opt, m = steps[key](p, opt, data.batch_at(i, device=DEV),
                               prng.fold_in(prng.key(0), i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
        return p, opt, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"]), "wall_s": wall, "launches": counts,
                        "peak_above_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}

    free_memory()
    p_plain, _, plain = run(False, params, adamw.init(params), 0)
    free_memory()
    assert plain["launches"] == {"flash_decode": 0, "lowrank_flash": 0,
                                 "lowrank_flash_bwd": 0}, plain["launches"]
    p, opt, hist, grads = params, adamw.init(params), [], []
    for i in range(CHUNKED_STEPS):
        with grads_seen(grads) if i == 0 else contextlib.nullcontext():
            p, opt, m = run(True, p, opt, i)
        want = {"flash_decode": 0, "lowrank_flash": L, "lowrank_flash_bwd": L}
        if m["launches"] != want:
            raise AssertionError(f"chunked step {i + 1} launched {m['launches']}, not {want}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"chunked step {i + 1}: {m}")
        hist.append(m)
        if i == 0:
            gaps = param_gaps(p, p_plain)
            p_first = [x.clone() for x in tu.leaves(p)]
            del p_plain
    first = hist[0]
    loss_err = abs(first["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_err = abs(first["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
    same_ranks = torch.equal(ranks[True][0], ranks[False][0])
    if (not same_ranks or loss_err > CHUNKED_LOSS_TOL or gn_err > CHUNKED_GNORM_TOL
            or gaps["max"] > 2 * first["lr"] or gaps["p99"] > CHUNKED_P99_TOL):
        raise AssertionError(f"chunked step 1 against unchunked: ranks equal {same_ranks}, "
                             f"loss {first['loss']} vs {plain['loss']} ({loss_err:.3g}), grad "
                             f"norm {first['grad_norm']} vs {plain['grad_norm']} ({gn_err:.3g}), "
                             f"parameters {gaps} (lr {first['lr']})")
    remat = {}
    for r in CHECKPOINTED:
        free_memory()
        seen = []
        with grads_seen(seen):
            p_r, opt_r, m = run(r, params, adamw.init(params), 0)
        want = {"flash_decode": 0, "lowrank_flash": 2 * L, "lowrank_flash_bwd": L}
        if m["launches"] != want:
            raise AssertionError(f"remat={r} chunked step 1 launched {m['launches']}, not {want}")
        g_r = seen[0]
        m.update(loss_rel_err=abs(m["loss"] - first["loss"]) / abs(first["loss"]),
                 grad_norm_rel_err=abs(m["grad_norm"] - first["grad_norm"]) / first["grad_norm"],
                 ranks_equal=torch.equal(ranks[r][0], ranks[True][0]),
                 grads_bitwise=all(torch.equal(a, b) for a, b in zip(g_r, grads[0])),
                 grads_max_abs_diff=max((a - b).abs().max().item()
                                        for a, b in zip(g_r, grads[0])),
                 param_gaps=param_gaps(p_r, tu.unflatten(p_r, p_first)))
        del g_r, seen
        # step 2 is the one timed: step 1 pays checkpointing's first-call
        # set-up (its imports), as the plain step 1 pays the step's
        _, _, m2 = run(r, p_r, opt_r, 1)
        if m2["launches"] != want:
            raise AssertionError(f"remat={r} chunked step 2 launched {m2['launches']}")
        m.update(step2_wall_s=m2["wall_s"], step2_peak_above_gib=m2["peak_above_gib"],
                 step2_loss=m2["loss"])
        del p_r, opt_r, m2
        remat[r] = m
        g = m["param_gaps"]
        bitwise = ("bitwise the plain step's" if m["grads_bitwise"] else "not bitwise")
        log(f"  remat={r}: step 1 from the same weights, batch and rank key: {L * 2} "
            f"lowrank_flash (the forward and its recompute) and {L} lowrank_flash_bwd "
            f"launches; loss {m['loss']:.7f} (relative {m['loss_rel_err']:.3g} to the plain "
            f"step, tol {CHUNKED_LOSS_TOL}), grad norm {m['grad_norm']:.7f} (relative "
            f"{m['grad_norm_rel_err']:.3g}, tol {CHUNKED_GNORM_TOL}), ranks "
            f"{'identical' if m['ranks_equal'] else 'DIFFER'}; gradients "
            f"{bitwise} (max |diff| {m['grads_max_abs_diff']:.3g}); updated parameters: largest |diff| "
            f"{g['max']:.3g} (tol 2 lr = {2 * m['lr']:.3g}), largest leaf 99th percentile "
            f"{g['p99']:.3g} (tol {CHUNKED_P99_TOL}), {g['differ']} of {g['n']} not equal; "
            f"step 2 (loss {m['step2_loss']:.5f}) {m['step2_wall_s']:.3f} s (step 1 "
            f"{m['wall_s']:.3f}) against the plain steps 2-{CHUNKED_STEPS}' "
            f"{statistics.mean(h['wall_s'] for h in hist[1:]):.3f} (step 1 "
            f"{first['wall_s']:.3f}); peak {m['peak_above_gib']:.2f} / "
            f"{m['step2_peak_above_gib']:.2f} GiB above the start (steps 1 / 2) against "
            f"{first['peak_above_gib']:.2f} [{card_name}]")
        if (not m["ranks_equal"] or m["loss_rel_err"] > CHUNKED_LOSS_TOL
                or m["grad_norm_rel_err"] > CHUNKED_GNORM_TOL or g["max"] > 2 * m["lr"]
                or g["p99"] > CHUNKED_P99_TOL):
            raise AssertionError(f"remat={r} chunked step 1 against the plain step: {m}")
    del p_first, grads
    if remat["full"]["peak_above_gib"] >= first["peak_above_gib"]:
        raise AssertionError(f"remat=full peaks at {remat['full']['peak_above_gib']:.2f} GiB, "
                             f"not below the plain step's {first['peak_above_gib']:.2f}")
    free_memory()
    batch = data.batch_at(0, device=DEV)
    rng = prng.fold_in(prng.key(0), 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps[True](p, opt, batch, rng)
        torch.cuda.synchronize()
    kern = raw_device_kernels(prof)
    busy = sum(dev_us(e) for e in kern)
    layers = by_layer(kern)
    steady = statistics.mean(h["wall_s"] for h in hist[1:])
    bwd_ms = layers["lowrank_flash backward kernel"] / 1e3
    fwd_ms = layers["lowrank_flash kernel"] / 1e3
    n_ranks = int(ranks[True][0].numel())
    log(f"  {CHUNKED_STEPS} steps of make_train_step with loss(chunked=True), drrl-paper "
        f"{L} x {cfg.d_model} in rank mode '{cfg.rank.mode}', {CHUNKED_BATCH} x "
        f"{CHUNKED_SEQ} tokens: losses {[round(h['loss'], 5) for h in hist]}, s/step "
        f"{[round(h['wall_s'], 3) for h in hist]}; {L} lowrank_flash and {L} "
        f"lowrank_flash_bwd launches per step, no flash_decode; peak "
        f"{max(h['peak_above_gib'] for h in hist):.2f} GiB above the start [{card_name}]")
    log(f"  step 1 against loss(chunked=False) on the same weights, batch and rank key: loss "
        f"{first['loss']:.7f} vs {plain['loss']:.7f} (relative {loss_err:.3g}, tol "
        f"{CHUNKED_LOSS_TOL}), grad norm {first['grad_norm']:.7f} vs {plain['grad_norm']:.7f} "
        f"(relative {gn_err:.3g}, tol {CHUNKED_GNORM_TOL}), the {n_ranks} ranks identical; "
        f"updated parameters: largest |diff| {gaps['max']:.3g} in {gaps['max_leaf']} (tol "
        f"2 lr = {2 * first['lr']:.3g}), largest leaf 99th percentile {gaps['p99']:.3g} in "
        f"{gaps['p99_leaf']} (tol {CHUNKED_P99_TOL}), {gaps['differ']} of {gaps['n']} "
        f"elements not equal; "
        f"unchunked step {plain['wall_s']:.3f} s, peak {plain['peak_above_gib']:.2f} GiB "
        f"above the start (chunked {first['peak_above_gib']:.2f}) [{card_name}]")
    log(f"  one chunked step profiled: device busy {busy / 1e3:.2f} ms of {steady * 1e3:.1f} ms "
        f"(steps 2-{CHUNKED_STEPS}' mean wall; idle {1 - busy / (steady * 1e6):.1%}); "
        f"lowrank_flash_bwd {bwd_ms:.2f} ms ({bwd_ms * 1e3 / busy:.1%} of busy), "
        f"lowrank_flash {fwd_ms:.2f} ms ({fwd_ms * 1e3 / busy:.1%}) [{card_name}]")
    log_layers(layers, busy)
    return {"steps": hist, "unchunked": plain, "loss_rel_err": loss_err,
            "grad_norm_rel_err": gn_err, "ranks_equal": same_ranks, "param_gaps": gaps,
            "remat": remat, "s_per_step": steady,
            "busy_ms": busy / 1e3, "idle": 1 - busy / (steady * 1e6), "bwd_ms": bwd_ms,
            "bwd_share": bwd_ms * 1e3 / busy, "fwd_ms": fwd_ms,
            "launches_per_step": hist[0]["launches"]}


def check_lm_training(paper, agent, card_name) -> dict:
    """Phase 17 on drrl-paper's own config (rank mode 'drrl') with phase
    10's seeded agent: 17a-g. Returns the launches of both kernels in 17a's
    training steps and of flash_decode in 17e's serving, and 17g's numbers."""
    out = os.path.join(ROOT, ".scratch", "phase17")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    reset_launches()
    run = check_train_cli(paper, out, card_name)
    step_launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                     "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
    assert step_launches == {"flash_decode": 0, "lowrank_flash": 0}, step_launches
    phase("  run_training resumed against straight; microbatches with bf16 accumulation")
    resume_diff = check_train_resume(paper, agent, out, card_name)
    accum = check_accumulation(paper, agent, card_name)
    phase("  one training step profiled")
    prof = profile_train_step(paper, agent, card_name)
    phase("  the trained checkpoint served; the reduced model card vs CPU")
    serve_launches = check_trained_serving(paper, run, card_name)
    check_train_reference(card_name)
    cli = {k: run[k] for k in ("s_per_step", "s_first_step", "losses", "wall_s")}
    del run
    shutil.rmtree(out, ignore_errors=True)
    free_memory()
    phase(f"  17g: loss(chunked=True) at {CHUNKED_BATCH} x {CHUNKED_SEQ}, through "
          "lowrank_flash and its backward kernel")
    chunked = check_chunked_training(paper, agent, card_name)
    log("phase 17 numbers: " + json.dumps({
        "cli": cli, "resume_max_dparam": resume_diff, "accumulation": accum,
        "step_profile": prof, "step_launches": step_launches,
        "serve_launches": serve_launches, "chunked_training": chunked, "card": card_name}))
    return {"step_launches": step_launches, "serve_launches": serve_launches,
            "chunked": chunked}


# -- phase 18 ----------------------------------------------------------------

QUICK = ("table1", "table2", "table3", "fig2", "fig3", "fig4", "fig5")
# 18d: bench_cfg trained 2 steps on the card and on the CPU from the same
# weights and batches, TF32 off: f32 up to summation order and the two
# eigensolvers' last bits, amplified through eigh's backward and AdamW's
# normalised first step (tests/test_torch_train_loop.py: 2e-5 / 1e-4)
TABLES_TOL = 1e-4
PAPER_FLOPS_FRAC = 0.6             # Table 1's claim: DR-RL under 0.6 of full rank
PAPER_L4096_PCT = 41.5             # Fig. 4's claim at L = 4096


def check_tables_canary(card_name) -> dict:
    """18a: ``python -m benchmarks.torch_run --smoke`` in its own process:
    the CSV header and one line, a finite perplexity, a FLOPs fraction in
    (0, 1]."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "benchmarks.torch_run", "--smoke",
                          "--device", DEV], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 2, lines
    name, us, derived = lines[1].split(",")
    fields = dict(kv.split("=") for kv in derived.split(";"))
    ppl, frac = float(fields["ppl"]), float(fields["attn_flops_frac"])
    assert name == "smoke" and np.isfinite(ppl) and 0.0 < frac <= 1.0, lines
    log(f"  canary: {lines[1]} ({wall:.1f} s with the process's start) [{card_name}]")
    return {"csv": lines[1], "wall_s": wall}


def _fracs_ok(res) -> None:
    for k, v in res.items():
        assert np.isfinite(v["ppl"]) and v["ppl"] > 0, (k, v)
        assert 0.0 < v["attn_flops_frac"] <= 1.0, (k, v)


def check_quick_result(name, res) -> None:
    """18b: the structure of one quick-mode result: its keys and lengths,
    finite perplexities, accuracies and curves, fractions in (0, 1]."""
    cfg = torch_common.bench_cfg("adaptive")
    grid = cfg.rank.rank_grid
    if name == "table1":
        assert tuple(res) == torch_table1_lm.METHODS, list(res)
        _fracs_ok(res)
    elif name == "table2":
        assert tuple(res) == tuple(torch_table2_ablation.VARIANTS), list(res)
        _fracs_ok(res)
    elif name == "table3":
        assert tuple(res) == torch_table3_downstream.METHODS, list(res)
        assert all(0.0 <= v["accuracy"] <= 1.0 for v in res.values()), res
    elif name == "fig2":
        lens = {k: len(v) for k, v in res.items()}
        assert lens == {"lm_loss_curve": 10, "bc_loss_curve": 3, "reward_curve": 5,
                        "rank_curve": 5, "fidelity_curve": 5}, lens
        assert np.isfinite([x for v in res.values() for x in v]).all(), res
    elif name == "fig3":
        assert set(res) == {"adaptive", "drrl"}, list(res)
        for v in res.values():
            assert len(v["per_layer_mean_rank"]) == cfg.num_layers, v
            assert all(grid[0] <= r <= grid[-1] for r in v["per_layer_mean_rank"]), v
    elif name == "fig4":
        assert len(res["rows"]) == len(torch_fig4_flops_scaling.LENGTHS), res
        assert grid[0] <= res["mean_rank"] <= grid[-1], res["mean_rank"]
        assert all(np.isfinite(list(r.values())).all() and r["full"] > 0
                   for r in res["rows"]), res["rows"]
    elif name == "fig5":
        n = len(grid)
        heat = np.asarray(res["heatmap"])
        assert heat.shape == (n, n) and np.isfinite(heat).all(), heat
        assert np.array(res["trust_region"]).dtype == bool, res["trust_region"]
        assert (np.diag(heat) == 0).all() and np.array(res["trust_region"]).diagonal().all()


def run_quick(card_name) -> dict:
    """18b: every table and figure in quick mode, Table 3 through
    ``examples/finetune_classification_torch.py``: each result's structure,
    its ``derived`` string and wall time; the paper's claims reported, not
    asserted (the synthetic corpus at 4 x 128 need not reach them)."""
    example = runpy.run_path(os.path.join(ROOT, "examples",
                                          "finetune_classification_torch.py"))["main"]
    results, walls, derived = {}, {}, {}
    for name in QUICK:
        sync()
        t0 = time.perf_counter()
        if name == "table3":
            res = example(["--device", DEV])
        else:
            res = torch_run.bench(name, quick=True, device=DEV)[0]
        sync()
        walls[name] = time.perf_counter() - t0
        check_quick_result(name, res)
        results[name], derived[name] = res, torch_run.derived(name, res)
        log(f"  {name}: {derived[name]} ({walls[name]:.1f} s) [{card_name}]")
    t1 = results["table1"]
    best = min(("fixed", "adaptive", "random"), key=lambda m: t1[m]["ppl"])
    claims = {
        "drrl_ppl": t1["drrl"]["ppl"], "full_ppl": t1["off"]["ppl"],
        "drrl_over_full_ppl": t1["drrl"]["ppl"] / t1["off"]["ppl"],
        "drrl_below_best_other": t1["drrl"]["ppl"] < t1[best]["ppl"],
        "drrl_flops_frac": t1["drrl"]["attn_flops_frac"],
        "drrl_flops_frac_below_0.6": t1["drrl"]["attn_flops_frac"] < PAPER_FLOPS_FRAC,
        "reduction_at_L4096_pct": results["fig4"]["claim_L4096_reduction_pct"],
        "paper_reduction_at_L4096_pct": PAPER_L4096_PCT}
    log("  the paper's claims on this run (reported, not asserted): " + json.dumps(claims))
    return {"derived": derived, "wall_s": walls, "claims": claims,
            "table3_accuracy": {k: v["accuracy"] for k, v in results["table3"].items()}}


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_bench_step(card_name) -> dict:
    """18b: where a ``train_lm`` step of ``bench_cfg`` (8 x 128 tokens,
    rank mode 'fixed') spends its device time: 3 steps under torch.profiler
    (device activity), eigh's share of busy time, busy against the steps'
    wall."""
    from torch.profiler import ProfilerActivity, profile
    cfg = torch_common.bench_cfg("fixed")
    torch_common.train_lm(cfg, steps=1, device=DEV)            # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = torch_common.train_lm(cfg, steps=3, device=DEV)
        sync()
    kern = raw_device_kernels(prof)
    busy = sum(dev_us(e) for e in kern)
    layers = by_layer(kern)
    eigh = layers["eigh (cuSOLVER)"]
    n_eigh = sum(e.count for e in kern if by_layer([e])["eigh (cuSOLVER)"])
    step_ms = out["wall_s"] * 1e3 / 3
    log(f"  one train_lm step of bench_cfg('fixed'), 8 x 128 tokens: {step_ms:.1f} ms "
        f"(profiled), device busy {busy / 3e3:.2f} ms per step, eigh {eigh / 3e3:.2f} ms "
        f"({eigh / busy:.1%} of busy; {n_eigh // 3} cuSOLVER kernels per step) [{card_name}]")
    log_layers(layers, busy)
    return {"step_ms_profiled": step_ms, "busy_ms": busy / 3e3, "eigh_ms": eigh / 3e3,
            "eigh_share": eigh / busy, "cusolver_kernels": n_eigh // 3}


def check_tables_full_width(paper, agent, card_name) -> dict:
    """18c: the tables' functions on drrl-paper at full width (seeded
    weights, phase 10's agent): 2 ``train_lm`` steps in 'fixed', one eval
    batch, the FLOPs fraction in 'adaptive' and 'drrl', one Table 3
    fine-tune step in 'drrl', Fig. 4's mean rank over 2 x 4096 tokens and
    the reduction at L = 4096 from it, Fig. 5's heatmap on grid 16 ... 64."""
    fixed = paper.with_(rank=dataclasses.replace(paper.rank, mode="fixed"))
    adaptive = paper.with_(rank=dataclasses.replace(paper.rank, mode="adaptive"))
    walls = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        return out

    out = timed("train_lm_2_steps", lambda: torch_common.train_lm(fixed, steps=2,
                                                                  device=DEV))
    assert np.isfinite(out["losses"]).all(), out["losses"]
    params = out["params"]
    ppl = timed("eval_ppl_1_batch", lambda: torch_common.eval_ppl(
        fixed, params, out["fns"], n_batches=1))
    frac_a = timed("flops_adaptive", lambda: torch_common.attn_flops_fraction(
        adaptive, params))
    frac_d = timed("flops_drrl", lambda: torch_common.attn_flops_fraction(
        paper, params, agent=agent))
    assert np.isfinite(ppl) and 0.0 < frac_a <= 1.0 and 0.0 < frac_d <= 1.0, (
        ppl, frac_a, frac_d)
    cls_params = {"trunk": params, "head": nn.dense_init(
        torch.Generator(DEV).manual_seed(5), paper.d_model, 2, device=DEV)}
    batch = SyntheticClassification(paper.vocab_size, torch_table3_downstream.CLS_SEQ,
                                    torch_common.BENCH_BATCH, seed=4).batch_at(0, device=DEV)
    tc = TrainConfig(lr=2e-3, total_steps=25, warmup_steps=2, weight_decay=0.0)

    def cls_step():
        nll, g = rl.value_and_grad(lambda p, b: torch_table3_downstream.cls_loss(
            paper, p, b, agent=agent)[0], cls_params, batch)
        new, _, m = adamw.update(tc, make_lr_fn(tc), adamw.init(cls_params), cls_params, g)
        return nll, g, new, m

    nll, g, new, m = timed("cls_loss_step", cls_step)
    with torch.no_grad():
        nll_after, acc = torch_table3_downstream.cls_loss(paper, new, batch, agent=agent)
    assert _finite(nll, nll_after, *tu.leaves(g)) and 0.0 <= float(acc) <= 1.0
    r_mean = timed("mean_rank_L4096", lambda: torch_fig4_flops_scaling.mean_rank(
        adaptive, params, L_run=4096))
    grid = paper.rank.rank_grid
    assert grid[0] <= r_mean <= grid[-1], r_mean
    rows = torch_fig4_flops_scaling.flops_rows(adaptive, r_mean)
    red = rows[torch_fig4_flops_scaling.LENGTHS.index(4096)]["reduction_qkv_pct"]
    hm = timed("fig5_heatmap", lambda: torch_fig5_perturbation.heatmap(adaptive, params))
    assert np.isfinite(hm["heatmap"]).all() and hm["heatmap"].shape == (len(grid),) * 2
    res = {"losses": out["losses"], "train_s_per_step": out["wall_s"] / 2, "ppl": ppl,
           "flops_frac_adaptive": frac_a, "flops_frac_drrl": frac_d,
           "cls_nll": float(nll), "cls_nll_after": float(nll_after), "cls_acc": float(acc),
           "cls_grad_norm": float(m["grad_norm"]), "mean_rank_L4096": r_mean,
           "reduction_at_L4096_pct": red,
           "trust_region_frac": float(np.mean(hm["trust_region"])), "wall_s": walls}
    log(f"  {paper.name} {paper.num_layers} x {paper.d_model}, 8 x 128 tokens: train_lm "
        f"losses {out['losses']} ({res['train_s_per_step']:.2f} s/step), ppl {ppl:.2f}, FLOPs fraction adaptive "
        f"{frac_a:.4f} / drrl {frac_d:.4f}; Table 3 step in 'drrl': nll {float(nll):.4f} -> "
        f"{float(nll_after):.4f}, grad norm {float(m['grad_norm']):.4f}; mean rank over "
        f"2 x 4096 {r_mean:.3f} of {paper.resolved_head_dim()}, reduction at L = 4096 "
        f"{red}% (paper {PAPER_L4096_PCT}%); Fig. 5 trust region "
        f"{res['trust_region_frac']:.3f} of {len(grid)} x {len(grid)} [{card_name}]")
    log("  walls (s): " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    return res


@contextlib.contextmanager
def same_init(params):
    """``train_lm`` initialises from ``params`` (moved to its device) in
    place of its seeded draw, which differs between the card's generator
    and the CPU's."""
    real = torch_common.get_model

    def patched(cfg):
        return real(cfg)._replace(init=lambda gen, device="cuda": params_to(params, device))
    torch_common.get_model = patched
    try:
        yield
    finally:
        torch_common.get_model = real


def check_tables_reference(card_name) -> dict:
    """18d: ``train_lm(bench_cfg('fixed'), steps=2)`` and ``eval_ppl`` on the
    card and on the CPU from the same initial weights: losses and perplexity
    within TABLES_TOL relative; the trained model's ranks, and the adaptive
    ranks of the initial weights, equal."""
    cfg = torch_common.bench_cfg("fixed")
    adaptive = torch_common.bench_cfg("adaptive")
    init = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tokens = SyntheticLM(cfg.vocab_size, torch_common.BENCH_SEQ, torch_common.BENCH_BATCH,
                         seed=3).batch_at(0, device="cpu")["tokens"]
    got = {}
    for dev in (DEV, "cpu"):
        with same_init(init):
            out = torch_common.train_lm(cfg, steps=2, device=dev)
        ppl = torch_common.eval_ppl(cfg, out["params"], out["fns"])
        with torch.no_grad():
            ranks = forward_dense(cfg, out["params"], tokens.to(dev),
                                  collect_aux="ranks")[1]["layers"]["rank"].cpu()
            ranks_a = forward_dense(adaptive, params_to(init, dev), tokens.to(dev),
                                    collect_aux="ranks")[1]["layers"]["rank"].cpu()
        got[dev] = (out["losses"], ppl, ranks, ranks_a)
    (lg, pg, rg, ag), (lc, pc, rc, ac) = got[DEV], got["cpu"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(lg + [pg], lc + [pc]))
    assert worst <= TABLES_TOL, (lg, pg, lc, pc)
    assert torch.equal(rg, rc) and torch.equal(ag, ac), (rg, rc, ag, ac)
    log(f"  bench_cfg('fixed') 2 steps, card vs CPU: losses {lg} / {lc}, ppl {pg:.4f} / "
        f"{pc:.4f}: within {worst:.3g} relative (tol {TABLES_TOL}); ranks equal, the "
        f"adaptive ranks of the initial weights equal (mean {ag.float().mean():.3f}) "
        f"[{card_name}]")
    return {"worst_rel": worst, "losses": {"card": lg, "cpu": lc}, "ppl": {"card": pg,
                                                                         "cpu": pc}}


def check_tables(paper, agent, card_name) -> dict:
    """Phase 18, the paper's tables and figures: 18a-e. Returns both kernels'
    launches across the phase's in-process work (none expected: the tables
    run unchunked at 128 tokens, Fig. 4's probe unchunked too, as the
    reference's do)."""
    reset_launches()
    t0 = time.perf_counter()
    canary = check_tables_canary(card_name)
    phase("  every table and figure in quick mode (bench_cfg, 8 x 128 tokens)")
    quick = run_quick(card_name)
    step = profile_bench_step(card_name)
    phase("  the tables' functions at full width")
    full = check_tables_full_width(paper, agent, card_name)
    phase("  bench_cfg card vs CPU")
    ref = check_tables_reference(card_name)
    launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
    assert launches == {"flash_decode": 0, "lowrank_flash": 0}, launches
    log("phase 18 numbers: " + json.dumps({
        "canary": canary, "quick": quick, "bench_step": step, "full_width": full,
        "card_vs_cpu": ref, "launches": launches,
        "phase_s": time.perf_counter() - t0, "card": card_name}))
    return launches


# -- phase 19 ----------------------------------------------------------------

SANITIZER_DRAFT_K = 3        # the sanitizer's speculative scenario (the reference's knob)
SYNC_MSG = "synchronizing CUDA operation"   # torch's sync debug mode, warn and error


def check_static_checker() -> dict:
    """19a: the port's checker in its own process: the seeded selftest, then
    the static pass over src/repro_torch (clean). Returns the suppressed
    findings by rule."""
    tool = os.path.join(ROOT, "tools", "check_invariants_torch.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, tool, "--selftest"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    log("  " + res.stdout.strip().splitlines()[-2])
    res = subprocess.run([sys.executable, tool, "--report", "json"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["ok"] and not doc["findings"], doc["findings"]
    by_rule = dict(sorted(collections.Counter(f["rule"] for f in doc["suppressed"]).items()))
    log(f"  static pass over src/repro_torch: invariants clean, suppressed by rule "
        f"{by_rule}")
    return by_rule


def check_sanitizer(cfg, card_name) -> dict:
    """19b: the four sanitizer scenarios at full width (drrl-paper 12 x 768,
    vocabulary 50257): zero builds in the steady phase, every guarded fused
    step free of syncs, and flash_decode launched in every guarded step, 12
    per step and 12 x (draft_k + 1) per speculative one."""
    from repro_torch.analysis import sanitizer

    out = {}
    for name in sanitizer.SCENARIOS:
        t0 = time.perf_counter()
        res = sanitizer.run_scenario(name, reduced=False, device=DEV)
        calls = res["guarded_by_step"]
        spec = calls.get("_step_spec", 0)
        want = cfg.num_layers * (sum(calls.values()) - spec
                                 + (SANITIZER_DRAFT_K + 1) * spec)
        log(f"  {name}: warm {res['warm_executables']} builds, steady "
            f"+{res['steady_new_executables']}, {res['guarded_steps']} guarded fused "
            f"steps {calls}, {res['flash_decode_launches']} flash_decode launches in "
            f"the guarded steady phase (expected {want}); "
            f"{time.perf_counter() - t0:.1f} s [{card_name}]")
        assert res["ok"], res
        assert res["steady_new_executables"] == 0, res["steady_compiles"]
        assert res["flash_decode_launches"] == want > 0, res
        if name == "speculative":
            assert spec > 0, calls
        out[name] = {k: res[k] for k in ("warm_executables", "steady_new_executables",
                                         "guarded_steps", "guarded_by_step",
                                         "flash_decode_launches", "steps")}
    return out


def check_guard_trips() -> dict:
    """19c: the negative control. One engine's mixed step also calls
    ``.item()``, another's plain decode step builds ``torch.tensor(0.,
    device="cuda")``: the guard must raise inside each, and restore the mode."""
    from repro_torch.analysis import sanitizer
    from repro_torch.serve import Request

    leaks = {"_step_mixed": ("item", lambda tok: tok.sum().item()),
             "_step": ("host tensor", lambda tok: torch.tensor(0., device="cuda"))}
    tripped = {}
    for attr, (label, leak) in leaks.items():
        eng = sanitizer.scenario_engine("mixed_sampling", device=DEV)
        real = getattr(eng, attr)

        def leaky(*args, _real=real, _leak=leak):
            out = _real(*args)
            _leak(out[1])
            return out
        setattr(eng, attr, leaky)
        calls = sanitizer.guard_steps(eng)
        for w in sanitizer._workload(6, 12, seed=7, sampling=True):
            eng.submit(Request(**w))
        try:
            eng.run()
        except RuntimeError as e:
            assert SYNC_MSG in str(e), e
            tripped[attr] = {"leak": label, "guarded_calls": calls[attr],
                             "error": str(e).splitlines()[0][:120]}
        else:
            raise AssertionError(f"the sync guard did not trip on {attr} + {label}")
        assert torch.cuda.get_sync_debug_mode() == 0, "the guard left its mode set"
        log(f"  negative control: {attr} + {label} tripped the guard at guarded call "
            f"{calls[attr]}: {tripped[attr]['error']}")
    return tripped


def trace_sync_sites(cfg, params, card_name) -> dict:
    """19d, reported only: phase 3's adaptive serving run at full width, warmed,
    then its whole loop under ``set_sync_debug_mode("warn")`` with no guard.
    Every sync warning is attributed to the innermost frame in this repo
    (``file:line``, the call that synced). The same loop's device-to-host
    copies are counted by torch.profiler, and those of one decision's
    ``eigh`` alone (its L x h Grams), which the sync debug mode does not see:
    cuSOLVER makes them inside the library."""
    from torch.profiler import ProfilerActivity, profile

    knobs = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                 use_kernel=True)
    prompts, arrivals = phase3_workload(cfg.vocab_size)
    eng = Engine(cfg, params, device=DEV, config=EngineConfig(**knobs))
    for p, a in zip(prompts, arrivals):
        eng.submit(p, SamplingParams(max_new=64), arrival=a)
    eng.warmup()
    torch.cuda.synchronize()
    sites = collections.Counter()
    src = os.path.join(ROOT, "src") + os.sep

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_MSG not in str(message):
            return
        site = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(src):
                site = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                break
        sites[site] += 1

    t0 = time.perf_counter()
    with warnings.catch_warnings(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    total = sum(sites.values())
    dtoh = sum(e.count for e in raw_device_kernels(prof) if "DtoH" in e.key)
    # one decision's eigh alone: the Grams of every layer and kv head
    hd = cfg.resolved_head_dim()
    x = torch.randn((cfg.num_layers, cfg.num_kv_heads, 256, hd), device=DEV,
                    generator=torch.Generator(DEV).manual_seed(5))
    gram = lowrank.gram(x)
    lowrank.gram_spectrum(gram)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as eprof:
        lowrank.gram_spectrum(gram)
        torch.cuda.synchronize()
    eigh_dtoh = sum(e.count for e in raw_device_kernels(eprof) if "DtoH" in e.key)
    log(f"  adaptive serving under sync warnings and the profiler: {total} syncs over "
        f"{st['steps']} fused steps and {st['decides']} decisions ({wall:.1f} s) "
        f"[{card_name}]; by site:")
    for site, n in sites.most_common():
        log(f"    {n:7d}  {site}")
    log(f"  the profile's device-to-host copies: {dtoh}; one decision's eigh alone "
        f"({cfg.num_layers * cfg.num_kv_heads} Grams of {hd} x {hd}) makes {eigh_dtoh}, "
        f"so the run's {st['decides']} decisions make {eigh_dtoh * st['decides']} inside "
        f"cuSOLVER, unseen by the sync debug mode")
    return {"total": total, "steps": st["steps"], "decides": st["decides"],
            "wall_s": wall, "sites": dict(sites.most_common()),
            "profiled_dtoh_copies": dtoh, "eigh_dtoh_per_decision": eigh_dtoh}


def check_invariants(cfg, params, card_name) -> dict:
    """Phase 19, the invariant checker: 19a-d. Returns the sanitizer's
    flash_decode launches by scenario and the phase's numbers."""
    t0 = time.perf_counter()
    static = check_static_checker()
    phase("  the runtime sanitizer's four scenarios at full width")
    scen = check_sanitizer(cfg, card_name)
    phase("  negative control: a leaked sync trips the guard")
    trips = check_guard_trips()
    phase("  sync sites of a steady adaptive serving run (reported)")
    sites = trace_sync_sites(cfg, params, card_name)
    secs = time.perf_counter() - t0
    log("phase 19 numbers: " + json.dumps({
        "suppressed_by_rule": static, "scenarios": scen, "negative_control": trips,
        "sync_sites": sites, "phase_s": secs, "card": card_name}))
    return {name: s["flash_decode_launches"] for name, s in scen.items()}


# -- phase 20 ----------------------------------------------------------------

def _family_case(hq, hkv, C, r, dv):
    """A flash_decode case at phase 3's engine settings (8 slots, 2048
    positions): MAIN_DECODE's lengths for C = 1, MAIN_CHUNK's chunk else."""
    if C == 1:
        return (8, hq, hkv, 1, 2048, r, dv, MAIN_DECODE[7], None, None)
    return (8, hq, hkv, C, 2048, r, dv, MAIN_CHUNK[7], MAIN_CHUNK[8], None)


# 20a: the serving shapes of the dense configs (head_dim 128: 'off' and a
# mixed step read it whole, an 'adaptive' decode row reads the factor cache
# at r_max = 64 of it) and granite (head_dim 64), and the GQA groups of
# internlm2 (6), phi3 (4) and deepseek-coder (7) at C = 1
FAMILY_DECODE = {
    "qwen2.5-14b decode": _family_case(40, 8, 1, 128, 128),
    "qwen2.5-14b factor decode": _family_case(40, 8, 1, 64, 128),
    "qwen2.5-14b chunk": _family_case(40, 8, 128, 128, 128),
    "granite decode": _family_case(24, 8, 1, 64, 64),
    "granite chunk": _family_case(24, 8, 128, 64, 64),
    "internlm2-20b decode": _family_case(48, 8, 1, 128, 128),
    "phi3-medium-14b decode": _family_case(40, 10, 1, 128, 128),
    "deepseek-coder-33b decode": _family_case(56, 8, 1, 128, 128),
}
FAMILY_DECODE_TIMED = ("qwen2.5-14b decode", "qwen2.5-14b factor decode",
                       "qwen2.5-14b chunk", "granite decode", "granite chunk")
# the earlier bf16 path at those shapes (csrc/decode_attn.cu's f32 kernel on
# bf16 loads, before csrc/decode_attn_bf16.cu), ms without / with
# probabilities on an NVIDIA H100 80GB HBM3 at 700.00 W: logged beside each
# new time
FAMILY_DECODE_EARLIER_MS = {"qwen2.5-14b decode": (0.1706, 0.1628),
                         "qwen2.5-14b factor decode": (0.1281, 0.1318),
                         "qwen2.5-14b chunk": (0.9906, 1.1826),
                         "granite decode": (0.0618, 0.0632),
                         "granite chunk": (0.2979, 0.4050)}
# lowrank_flash at the chunked forwards' shapes: qwen's 2 x 4096 (40/8 heads,
# dv 128; masked r = 128, static r = 32) and MLA's (128 heads, r = qk_nope +
# qk_rope = 192, dv 128; one sequence of 4096, the plain version's scores
# 8.6 GB): b, hq, hkv, sq, skv, r, dv, causal, q_offset
QWEN_FLASH = "qwen2.5-14b masked r=128"
FAMILY_FLASH = {
    QWEN_FLASH: (2, 40, 8, 4096, 4096, 128, 128, True, 0),
    "qwen2.5-14b static r=32": (2, 40, 8, 4096, 4096, 32, 128, True, 0),
    "deepseek-v3 MLA r=192": (1, 128, 128, 4096, 4096, 192, 128, True, 0),
}
# a bf16 stream may differ, kernel vs plain attention, only where the plain
# run's top-two logit gap is under four bf16 steps at a logit of 8 (the
# largest logit of a random-weight model: rms-normed states through a fan-in
# scaled head give logits of about unit spread): 4 x 2^-8 x 8
BF16_GAP_TOL = 0.125
# qwen's forward (20e): its first layers, 2 x 4096 tokens
FAMILY_FWD_LAYERS = 8
# 20b, 20c: qwen2.5-14b and granite served cut in depth (widths unchanged),
# for the smoke's 1200 s limit (their full depths: 48 and 32 layers)
FAMILY_SERVE_LAYERS = 16
# 20d: the other dense configs, cut in depth for time
DENSE_CUT_LAYERS = 4
# DeepSeek-V3 (20f): 1 dense + 1 MoE layer + the MTP block
DEEPSEEK_CUT = dict(num_layers=2, first_dense_layers=1)
DEEPSEEK_DECODE_STEPS = 16
# 20g: DeepSeek-V3 reduced, card (kernel) vs CPU (plain), f32 logits
REDUCED_LOGIT_TOL = 1e-5
# 20e/20f: full-width bf16 logits, kernel vs plain path. They are rounded to
# bf16 last, so they cannot agree closer than one bf16 step at the largest
# logit's magnitude; the readings were one step (0.03125 at max |logit| 6.31,
# qwen's 8-layer forward) and 1.25 steps (0.039 at 5.97, DeepSeek-V3's MTP
# logits). Held to two steps, and the greedy pick to agree at this share of
# the positions at least: random weights leave many top-two pairs tied at
# bf16's resolution, so it read 0.9911 (qwen), 0.9877 and 0.9811 (DeepSeek-V3
# and its MTP head)
LOGIT_BF16_STEPS = 2
GREEDY_FLOOR = 0.97
# the bf16 lowrank_flash times the kernels line gathers from phases 20a and 21a
BF16_TIME_KEYS = ("ms", "bound_ms", "bound_bf16_passes_ms", "plain_ms", "library_ms",
                  "sdpa_backend")
# ... and the bf16 flash_decode times from phase 20a
BF16_DECODE_TIME_KEYS = ("ms", "ms_probs", "bound_ms", "bound_ms_probs", "bound_by",
                         "plain_ms", "plain_ms_probs", "library_ms")


def family_ptxas() -> None:
    """The ptxas register and spill lines of the instantiations phase 20
    runs: lowrank_flash in bf16 at r = 128 / 192 / 32 with dv = 128 (KR
    128 / 192 / 32, DV 128) and in f32 at r = 128 / 192 (KR 16 / 24),
    flash_decode at r, dv up to 128 in f32 and in bf16 (MT 1 and 4 m-tiles
    at r = 128 / 64 with dv = 128, and at r = dv = 64)."""
    for name, keys in (("lowrank_flash_bf16", ("Li192ELi128>", "Li128ELi128>", "Li32ELi128>")),
                       ("lowrank_flash", ("Li24E", "Li16E")),
                       ("decode_attn", ("Li4E", "Li16E")),
                       ("decode_attn_bf16", ("ELi128ELi128>", "ELi64ELi128>", "ELi64ELi64>"))):
        for line in ptxas_summary(build.build_log.get(name, (0, ""))[1]):
            if any(k in line for k in keys):
                log("  ptxas: " + line)


def check_family_kernels(card_name) -> dict:
    """20a: both kernels against their plain versions at the new shapes, f32
    and bf16, then timed in bf16 (the models' type)."""
    family_ptxas()
    err = {"flash_decode": 0.0, "lowrank_flash": 0.0}
    for i, (label, case) in enumerate(FAMILY_DECODE.items()):
        for dtype in (torch.float32, torch.bfloat16):
            e = check_decode_case(case, dtype, seed=300 + i, label=f"{label}: ")
            if dtype == torch.float32:
                err["flash_decode"] = max(err["flash_decode"], e)
    for i, (label, case) in enumerate(FAMILY_FLASH.items()):
        for dtype in (torch.float32, torch.bfloat16):
            e = check_flash_case(case, dtype, seed=400 + i, label=f"{label}: ")
            if dtype == torch.float32:
                err["lowrank_flash"] = max(err["lowrank_flash"], e)
        torch.cuda.empty_cache()
    times = {"flash_decode": {}, "lowrank_flash": {}}
    for label in FAMILY_DECODE_TIMED:
        t = time_kernel(FAMILY_DECODE[label], card_name, torch.bfloat16)
        before, before_p = FAMILY_DECODE_EARLIER_MS[label]
        log(f"  {label}: {t['ms']:.4f} / {t['ms_probs']:.4f} ms without / with probs, "
            f"the earlier bf16 path {before:.4f} / {before_p:.4f} ({before / t['ms']:.2f}x / "
            f"{before_p / t['ms_probs']:.2f}x faster); sdpa {t['library_ms']:.4f} ms "
            f"[{card_name}]")
        times["flash_decode"][label] = t
    for label, case in FAMILY_FLASH.items():     # the device kernel's name at qwen's shape
        times["lowrank_flash"][label] = time_flash(case, label, card_name, torch.bfloat16,
                                                   per_call=label == QWEN_FLASH)
        torch.cuda.empty_cache()
    return {"max_abs_err": err, "times": times}


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def family_params(cfg, seed=0):
    """Seeded random weights drawn on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(seed), device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tu.leaves(params))
    log(f"  {cfg.name}: seeded init of {n / 1e9:.3f} B parameters ({cfg.param_dtype}; "
        f"n_params() {cfg.n_params() / 1e9:.3f} B) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return params


def family_rank(cfg, mode):
    return cfg.with_(rank=RankConfig(mode=mode, rank_grid=cfg.rank.rank_grid
                                     if mode == "off" else GRID, segment_len=32))


def serve_family(cfg, params, label, card_name, *, use_kernel=True, gaps=None,
                 **knobs):
    """Phase 3's workload (prompts from ``cfg``'s vocabulary) through Engine at
    phase 3's settings; asserts one flash_decode launch per layer per fused
    step with the kernel (none without it). Returns (tokens, stats, engine,
    ms/step, the run's flash_decode launches)."""
    knobs = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                 use_kernel=use_kernel, **knobs)
    prompts, arrivals = phase3_workload(cfg.vocab_size)

    def driver(eng, hs):
        if gaps is not None:
            record_gaps(eng, gaps)
        eng.run()
    torch.cuda.reset_peak_memory_stats()
    eng, outs, launches, vetoes = serve_prompts(cfg, params, prompts=prompts,
                                                arrivals=arrivals, driver=driver, **knobs)
    st = eng.stats
    n_steps = st["steps"] + eng.core.warmup_steps
    want = cfg.num_layers * n_steps if use_kernel else 0
    assert launches == want, f"{label}: {launches} flash_decode launches, expected {want}"
    for i, o in enumerate(outs):
        assert o.shape == (64,), f"{label}: request {i} returned {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), f"{label}: request {i}: bad ids"
    ranks = sorted({int(r) for step in eng.ranks_per_step() for r in step if r >= 0})
    if cfg.rank.mode != "off":
        assert ranks and set(ranks) <= set(cfg.rank.rank_grid), f"{label}: ranks {ranks}"
        assert st["decides"] >= len(outs), f"{label}: {st['decides']} decisions"
    ms_step = 1e3 * st["decode_s"] / st["steps"]
    log(f"  {label}{'' if use_kernel else ' (plain attention)'}: {len(outs)} requests x "
        f"64 tokens, {st['steps']} fused steps ({st['mixed_steps']} mixed), "
        f"{st['decides']} decisions ({vetoes} vetoed), ranks {ranks}; flash_decode launches "
        f"{launches} = {cfg.num_layers} x {n_steps}; "
        f"{st['tokens_decoded'] / st['decode_s']:.1f} decoded tokens/s, {ms_step:.2f} "
        f"ms/step; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card_name}]")
    return outs, st, eng, ms_step, launches


def plain_family_run(cfg, params, label, card_name, replay=None):
    """The plain-attention run a kernel run is held to, its top-two gaps
    recorded as it serves (``record_gaps``; under ``replay``'s pinned
    routing for the MoE family). Returns (tokens, gaps)."""
    gaps = {}
    with replay.replaying() if replay is not None else contextlib.nullcontext():
        toks = serve_family(cfg, params, label, card_name, use_kernel=False,
                            gaps=gaps)[0]
    return toks, gaps


def compare_family_streams(cfg, got, plain, label) -> int:
    """Kernel tokens against the plain run's by ``compare_streams``' rule,
    at BF16_GAP_TOL for a bf16 model; the gaps come from the plain run
    itself, so nothing is served again."""
    want, gaps = plain
    tol = SPEC_GAP_TOL if cfg.dtype == "float32" else BF16_GAP_TOL
    return compare_streams(got, want, lambda g: g.update(gaps) or want, label, tol)


def eigh_ms_per_decision(cfg, card_name) -> float:
    """Device time of one segment decision's eigh: the Grams of every layer
    and kv head (head_dim square), torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    hd = cfg.resolved_head_dim()
    x = torch.randn((cfg.num_layers, cfg.num_kv_heads, 256, hd), device=DEV,
                    generator=torch.Generator(DEV).manual_seed(5))
    gram = lowrank.gram(x)
    lowrank.gram_spectrum(gram)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lowrank.gram_spectrum(gram)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in raw_device_kernels(prof))
    log(f"  one decision's eigh: {cfg.num_layers * cfg.num_kv_heads} Grams of {hd} x {hd}, "
        f"{us / 1e3:.2f} ms of device time [{card_name}]")
    return us / 1e3


def check_qwen_serving(card_name):
    """20b: qwen2.5-14b at full width, cut to FAMILY_SERVE_LAYERS layers,
    'off' then 'adaptive' (segment 32, grid 16..64), kernel tokens against
    the plain run's; one decision's eigh at full depth."""
    full = get_config("qwen2.5-14b")
    base = full.with_(num_layers=FAMILY_SERVE_LAYERS)
    log(f"  qwen2.5-14b cut from {full.num_layers} to {base.num_layers} layers for "
        f"serving, width unchanged")
    params = family_params(base)
    out = {}
    for mode in ("off", "adaptive"):
        cfg = family_rank(base, mode)
        toks, st, eng, ms, launches = serve_family(cfg, params, f"qwen2.5-14b {mode}",
                                                   card_name)
        out[mode] = dict(ms_step=ms, tok_s=st["tokens_decoded"] / st["decode_s"],
                         steps=st["steps"], mixed_steps=st["mixed_steps"],
                         decides=st["decides"], launches_per_step=cfg.num_layers,
                         launches=launches,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del eng
        if mode == "adaptive":
            plain = plain_family_run(cfg, params, f"qwen2.5-14b {mode}", card_name)
            out[mode]["streams_differ"] = compare_family_streams(
                cfg, toks, plain, f"qwen2.5-14b {mode} vs plain")
    out["adaptive"]["eigh_ms_per_decision"] = eigh_ms_per_decision(full, card_name)
    return params, out


class RouteReplay:
    """Records the experts each ``moe.route`` call picks (the kernel run),
    then hands the same experts back to the same calls in the same order
    (the plain run), each with its own router probabilities and gates.
    Top-k routing is discontinuous: a hidden state one bf16 step away can
    flip an expert at the k-th place, a whole expert's output for that
    token and, through capacity, which pairs of the other rows are dropped.
    With the routing pinned, the plain run differs from the kernel run only
    through the attention's rounding, so ``compare_streams``' rule holds
    it row by row again."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.idx, self.pos = moe, [], None

    @contextlib.contextmanager
    def recording(self):
        inner = self.mod.route

        def rec(cfg, p, xf):
            probs, idx, gates = inner(cfg, p, xf)
            self.idx.append(idx)
            return probs, idx, gates
        self.mod.route, self.idx = rec, []
        try:
            yield self
        finally:
            self.mod.route = inner

    def dropped_share(self, cfg, n_slots) -> dict:
        """Of the recorded calls' (token, expert) pairs, the share capacity
        dropped, in mixed steps (more than ``n_slots`` rows) and in decode
        steps (``n_slots`` rows): the reference's C = max(int(T K / E x
        capacity_factor), 1) per expert."""
        m = cfg.moe
        out = {}
        for kind, pick in (("mixed", lambda t: t > n_slots), ("decode", lambda t: t == n_slots)):
            sel = [idx for idx in self.idx if pick(idx.shape[0])]
            if not sel:
                continue
            dropped = sum(
                (torch.bincount(idx.flatten(), minlength=m.num_experts)
                 - max(int(idx.shape[0] * m.top_k / m.num_experts * m.capacity_factor), 1)
                 ).clamp_min(0).sum() for idx in sel)
            out[kind] = int(dropped) / sum(idx.numel() for idx in sel)
        return out

    @contextlib.contextmanager
    def replaying(self):
        inner = self.mod.route
        self.pos = 0

        def rep(cfg, p, xf):
            probs, _, _ = inner(cfg, p, xf)
            idx = self.idx[self.pos]
            self.pos += 1
            gates = probs.gather(-1, idx)
            return probs, idx, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        self.mod.route = rep
        try:
            yield self
        finally:
            self.mod.route = inner
            assert self.pos == len(self.idx), (self.pos, len(self.idx))


def check_granite_serving(card_name):
    """20c: granite-moe-3b-a800m at full width, cut to FAMILY_SERVE_LAYERS
    layers, in 'adaptive': tokens against the plain run's with the kernel
    run's routing pinned (``RouteReplay``), the share of (token, expert)
    pairs the kernel run's capacity dropped, and a guarded steady run of its
    fused step."""
    full = get_config("granite-moe-3b-a800m")
    base = full.with_(num_layers=FAMILY_SERVE_LAYERS)
    log(f"  granite-moe-3b-a800m cut from {full.num_layers} to {base.num_layers} layers "
        f"for serving, width unchanged")
    params = family_params(base)
    cfg = base.with_(rank=RankConfig(mode="adaptive", rank_grid=base.rank.rank_grid,
                                     segment_len=32))
    replay = RouteReplay()
    with replay.recording():
        toks, st, eng, ms, launches = serve_family(cfg, params, "granite adaptive",
                                                   card_name)
    n_slots = eng.core.n_slots
    out = dict(ms_step=ms, tok_s=st["tokens_decoded"] / st["decode_s"], steps=st["steps"],
               mixed_steps=st["mixed_steps"], decides=st["decides"],
               launches_per_step=cfg.num_layers, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               dropped_share=replay.dropped_share(cfg, n_slots))
    del eng
    log(f"  granite: (token, expert) pairs dropped by capacity in the kernel run, "
        f"mixed and decode steps (warmup's included): {out['dropped_share']}")
    plain = plain_family_run(cfg, params, "granite adaptive, routing pinned", card_name,
                             replay)
    out["streams_differ"] = compare_family_streams(
        cfg, toks, plain, "granite adaptive vs plain (routing pinned)")
    out["sanitizer"] = guarded_family_run(cfg, params, card_name)
    return params, out


def guarded_family_run(cfg, params, card_name) -> dict:
    """The sanitizer's warm-then-steady run (phase 19's ``mixed_sampling``
    workload and knobs) on ``cfg``'s engine: zero builds in the steady
    phase, every fused step under ``set_sync_debug_mode("error")``."""
    from repro_torch.analysis import sanitizer
    from repro_torch.serve import Request, ServeEngine

    counter = sanitizer.CompileCounter()
    with counter.attached():
        eng = ServeEngine(cfg, params, device=DEV, n_slots=4, max_len=64, page_size=16,
                          segment_len=8, max_new_cap=12, prefill_chunk=8, use_kernel=True,
                          sampling=True, nucleus=True)
        for w in sanitizer._workload(6, 12, seed=0, sampling=True):
            eng.submit(Request(**w))
        eng.warmup()
        eng.run()
        warm = counter.count
        eng.reset()
        calls = sanitizer.guard_steps(eng)
        for w in sanitizer._workload(6, 12, seed=7, sampling=True):
            eng.submit(Request(**w))
        reset_launches()
        eng.run()
        launches = decode_attn.LAUNCHES["flash_decode"]
        steady = counter.count - warm
    guarded = sum(calls.values())
    log(f"  granite under the sync guard: warm {warm} builds, steady +{steady}, "
        f"{guarded} guarded fused steps {calls}, {launches} flash_decode launches "
        f"(expected {cfg.num_layers * guarded}) [{card_name}]")
    assert steady == 0, counter.messages[warm:]
    assert guarded > 0 and launches == cfg.num_layers * guarded
    return {"warm_builds": warm, "steady_builds": steady, "guarded_steps": guarded,
            "launches": launches}


def check_dense_cut(card_name) -> dict:
    """20d: internlm2, phi3 and deepseek-coder at full width, cut to
    DENSE_CUT_LAYERS layers; one 'adaptive' serving run each (phase 3's
    workload), tokens against the plain run's."""
    out = {}
    for arch in ("internlm2-20b", "phi3-medium-14b", "deepseek-coder-33b"):
        full = get_config(arch)
        cfg = family_rank(full.with_(num_layers=DENSE_CUT_LAYERS), "adaptive")
        log(f"  {arch}: cut from {full.num_layers} to {cfg.num_layers} layers, width "
            f"unchanged ({full.num_heads}/{full.num_kv_heads} heads of "
            f"{full.resolved_head_dim()}, d_model {full.d_model})")
        params = family_params(cfg)
        toks, st, eng, ms, _ = serve_family(cfg, params, f"{arch} adaptive", card_name)
        del eng
        plain = plain_family_run(cfg, params, f"{arch} adaptive", card_name)
        out[arch] = dict(layers=cfg.num_layers, ms_step=ms, steps=st["steps"],
                         streams_differ=compare_family_streams(
                             cfg, toks, plain, f"{arch} vs plain"))
        del params
        free_memory()
    return out


@contextlib.contextmanager
def plain_flash_by_heads(group=16):
    """Route the model's flash branch through the kernel's plain version,
    about ``group`` query heads (and their kv heads) at a time: the same
    function, head by head, within the card's memory at MLA's 128 heads x
    4096^2. A slice takes whole GQA groups (a multiple of hq / hkv heads),
    so each of its q heads keeps its own kv head."""
    kernel = ops.flash_attention

    def plain(q, k, v, **kw):
        rep = q.shape[1] // k.shape[1]
        g = rep * max(1, group // rep)
        outs = [lowrank_flash.lowrank_flash_plain(
            q[:, h:h + g], k[:, h // rep:(h + g) // rep],
            v[:, h // rep:(h + g) // rep], **kw) for h in range(0, q.shape[1], g)]
        return torch.cat(outs, dim=1)
    ops.flash_attention = plain
    try:
        yield
    finally:
        ops.flash_attention = kernel


def logits_err(a, b) -> tuple:
    """max |a - b|, its tolerance (LOGIT_BF16_STEPS bf16 steps at max |b|),
    and the share of positions whose argmax agrees."""
    err = (a.float() - b.float()).abs().max().item()
    top = b.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(max(top, 1.0))) - 7)
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return err, LOGIT_BF16_STEPS * step, same


def check_qwen_forward(params, card_name) -> dict:
    """20e: qwen's first FAMILY_FWD_LAYERS layers (full width) in
    forward_dense(chunked=True) over 2 x 4096 tokens, adaptive/masked and
    fixed/static: launches, logits and ranks against the plain path."""
    full = get_config("qwen2.5-14b")
    n = FAMILY_FWD_LAYERS
    cut = {**params, "layers": tu.tree_map(lambda t: t[:n], params["layers"])}
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, full.vocab_size, (2, 4096), generator=g, device=DEV)
    out = {}
    log(f"  qwen2.5-14b cut from {full.num_layers} to {n} layers for the forward, width "
        f"unchanged")
    for mode, real, fid in FORWARDS:
        cfg = forward_cfg(full.with_(num_layers=n), mode, real)
        reset_launches()
        logits, aux, wall = run_forward(cfg, cut, tokens, fid)
        launches = lowrank_flash.LAUNCHES["lowrank_flash"]
        want = n * (2 if fid else 1)
        assert launches == want, f"{launches} lowrank_flash launches, expected {want}"
        assert torch.isfinite(logits).all()
        with plain_flash():
            logits_p, aux_p, wall_p = run_forward(cfg, cut, tokens, fid)
        err, tol, same = logits_err(logits, logits_p)
        ranks_eq = torch.equal(aux["rank"], aux_p["rank"])
        ranks = sorted(set(aux["rank"].flatten().tolist()))
        log(f"  qwen2.5-14b {mode}/{real}{' + fidelity' if fid else ''}: {launches} "
            f"lowrank_flash launches = {n} layers x {want // n}; max|logits - plain| "
            f"{err:.4g} (tol {tol:.4g}; {cfg.dtype}), greedy agreement {same:.4f} (floor "
            f"{GREEDY_FLOOR}), ranks "
            f"{'identical' if ranks_eq else 'DIFFER'} {ranks}; wall {wall * 1e3:.1f} ms "
            f"kernel, {wall_p * 1e3:.1f} ms plain [{card_name}]")
        assert err <= tol, f"qwen forward {mode}/{real}: kernel vs plain logits differ by {err}"
        assert same >= GREEDY_FLOOR, f"qwen forward {mode}/{real}: greedy agreement {same}"
        assert ranks_eq, f"qwen forward {mode}/{real}: ranks differ"
        out[f"{mode}/{real}"] = dict(launches=launches, max_logit_err=err, wall_ms=1e3 * wall,
                                     plain_wall_ms=1e3 * wall_p, greedy_agreement=same)
        del logits, logits_p, aux, aux_p
        free_memory()
    return out


# 20h: qwen2.5-14b's LM step in bf16 with loss(chunked=True) at 2 x 4096,
# full width, cut to 2 layers (phase 23b's cut; its first 2 layers of 20b's
# weights), 3 steps in rank mode 'off' (r = dv = 128) and one in
# fixed/static at r = 32, each under the config's remat='dots'; in 'off' one
# more step with remat='none' from the same start
QWEN_TRAIN_LAYERS = 2
QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ, QWEN_TRAIN_STEPS = 2, 4096, 3
QWEN_TRAIN_MODES = {"off": 3, "fixed/static r=32": 1}     # mode -> chunked steps
# step 1's loss and grad norm, each bf16 step's relative distance to the f32
# reference on the same weights and batch: the chunked step's at most
# BF16_DRIFT_RATIO times the unchunked step's, or this floor if that is
# smaller. Both steps round every activation to bf16, so their distances are
# samples of the same rounding noise, and one can lie near zero by chance:
# below a quarter of one bf16 rounding of a single value (2^-9 / 4) neither
# says which run is closer
BF16_DISTANCE_FLOOR = 2 ** -11


def qwen_train_cfg(mode):
    cfg = get_config("qwen2.5-14b").with_(num_layers=QWEN_TRAIN_LAYERS)
    return cfg if mode == "off" else forward_cfg(cfg, "fixed", "static")


def f32_reference(cfg, params, batch) -> dict:
    """The loss and the global grad norm of ``loss(chunked=False)`` on the
    same weights in f32 (cfg computing in f32), no optimizer: the batch in
    two halves of one sequence each (half the activations' memory), their
    mean loss and their gradients' mean, summed in f32."""
    cfg32, p32 = upcast(cfg, params)
    fns = get_model(cfg32)
    total, grads = 0.0, None
    for i in range(QWEN_TRAIN_BATCH):
        half = {name: x[i:i + 1] for name, x in batch.items()}
        loss, g = rl.value_and_grad(lambda p, b: fns.loss(p, b, chunked=False)[0], p32, half)
        total += float(loss) / QWEN_TRAIN_BATCH
        g = [x / QWEN_TRAIN_BATCH for x in tu.leaves(g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        del g
    norm = float(torch.sqrt(sum(x.square().sum() for x in grads)))
    del p32, grads
    free_memory()
    return {"loss": total, "grad_norm": norm}


def check_qwen_bf16_training(params, card_name) -> dict:
    """20h: ``make_train_step`` with ``loss(chunked=True)`` on qwen2.5-14b in
    bf16, full width, QWEN_TRAIN_LAYERS layers, at QWEN_TRAIN_BATCH x
    QWEN_TRAIN_SEQ tokens, in each of QWEN_TRAIN_MODES: per step one bf16
    lowrank_flash and one lowrank_flash_bwd launch per layer, no
    flash_decode, finite metrics; step 1's loss and grad norm against the
    f32 reference, no farther than BF16_DRIFT_RATIO x the unchunked bf16
    step's distance (or BF16_DISTANCE_FLOOR); s/step and peak memory of
    both steps; in 'off', one chunked step profiled (device busy and idle,
    the bf16 backward kernel's share)."""
    from torch.profiler import ProfilerActivity, profile
    data = SyntheticLM(get_config("qwen2.5-14b").vocab_size, QWEN_TRAIN_SEQ, QWEN_TRAIN_BATCH,
                       seed=0)
    batch = data.batch_at(0, device=DEV)
    n = sum(t.numel() for t in tu.leaves(params))
    log(f"  qwen2.5-14b cut to {QWEN_TRAIN_LAYERS} layers for training, width unchanged: "
        f"{n / 1e9:.3f} B bf16 parameters")
    out = {}
    for mode, n_steps in QWEN_TRAIN_MODES.items():
        cfg = qwen_train_cfg(mode)
        L = cfg.num_layers
        tc = TrainConfig(global_batch=QWEN_TRAIN_BATCH, seq_len=QWEN_TRAIN_SEQ, lr=3e-4,
                         warmup_steps=1, total_steps=n_steps)
        fns = get_model(cfg)
        steps = {c: train_loop.make_train_step(
            cfg, tc, lambda p, b, rng, c=c: fns.loss(p, b, chunked=c)) for c in (True, False)}
        fns_none = get_model(cfg.with_(remat="none"))
        steps["remat=none"] = train_loop.make_train_step(
            cfg.with_(remat="none"), tc, lambda p, b, rng: fns_none.loss(p, b, chunked=True))

        def run(key, p, opt, i):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            p, opt, m = steps[key](p, opt, data.batch_at(i, device=DEV),
                                   prng.fold_in(prng.key(0), i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {**decode_attn.LAUNCHES, **lowrank_flash.LAUNCHES}
            return p, opt, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                            "wall_s": wall, "launches": counts,
                            "peak_above_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}

        free_memory()
        ref = f32_reference(cfg, params, batch)
        plain = run(False, params, adamw.init(params), 0)[2]     # its params and state go
        free_memory()
        assert plain["launches"] == {"flash_decode": 0, "lowrank_flash": 0,
                                     "lowrank_flash_bwd": 0}, plain["launches"]
        runs = {"unchunked": plain}
        if mode == "off":
            # the chunked step 1 without remat, its updated parameters kept
            # on the host (4.2 GB the steps below would not find room for)
            # for the checkpointed step 1 below
            p_n, opt_n, none = run("remat=none", params, adamw.init(params), 0)
            want = {"flash_decode": 0, "lowrank_flash": L, "lowrank_flash_bwd": L}
            if none["launches"] != want:
                raise AssertionError(f"qwen bf16 remat=none step launched {none['launches']}")
            p_n = [x.cpu() for x in tu.leaves(p_n)]
            del opt_n
            free_memory()
        p, opt, hist = params, adamw.init(params), []
        fwd = L * (1 if cfg.remat == "none" else 2)     # and the recompute's
        for i in range(n_steps):
            p, opt, m = run(True, p, opt, i)
            want = {"flash_decode": 0, "lowrank_flash": fwd, "lowrank_flash_bwd": L}
            if m["launches"] != want:
                raise AssertionError(f"qwen bf16 chunked step {i + 1} ({mode}) launched "
                                     f"{m['launches']}, not {want}")
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"qwen bf16 chunked step {i + 1} ({mode}): {m}")
            hist.append(m)
            if i == 0 and mode == "off":
                diffs = [(a - b.to(DEV)).abs().max().item() for a, b in zip(tu.leaves(p), p_n)]
                none.update(loss_gap=abs(m["loss"] - none["loss"]) / abs(none["loss"]),
                            grad_norm_gap=abs(m["grad_norm"] - none["grad_norm"])
                            / none["grad_norm"], params_max_abs_diff=max(diffs),
                            params_bitwise=max(diffs) == 0.0)
                del p_n
        runs["chunked"] = hist[0]
        if mode == "off":
            runs["remat=none"] = none
        dist = {}
        for key in ("loss", "grad_norm"):
            d_p = abs(plain[key] - ref[key]) / abs(ref[key])
            dist[key] = {name: abs(r[key] - ref[key]) / abs(ref[key])
                         for name, r in runs.items()}
            dist[key]["limit"] = BF16_DRIFT_RATIO * max(d_p, BF16_DISTANCE_FLOOR)
        res = {"steps": hist, "unchunked": plain, "f32": ref, "distance": dist,
               "remat": cfg.remat, "launches_per_step": hist[0]["launches"],
               "s_per_step": statistics.mean(h["wall_s"] for h in hist[1:]) if n_steps > 1
               else hist[0]["wall_s"]}
        if "remat=none" in runs:
            res["remat_none_step"] = runs["remat=none"]
        log(f"  {mode}: {n_steps} step(s) of make_train_step with loss(chunked=True), bf16, "
            f"remat={cfg.remat}, "
            f"{QWEN_TRAIN_BATCH} x {QWEN_TRAIN_SEQ} tokens: losses "
            f"{[round(h['loss'], 5) for h in hist]}, grad norms "
            f"{[round(h['grad_norm'], 5) for h in hist]}, s/step "
            f"{[round(h['wall_s'], 3) for h in hist]}; {fwd} lowrank_flash and {L} "
            f"lowrank_flash_bwd launches per step, no flash_decode; peak "
            f"{max(h['peak_above_gib'] for h in hist):.2f} GiB above the start; unchunked "
            f"step {plain['wall_s']:.3f} s, peak {plain['peak_above_gib']:.2f} GiB [{card_name}]")
        log(f"  {mode}: step 1 against the f32 reference (loss {ref['loss']:.7f}, grad norm "
            f"{ref['grad_norm']:.7f}): chunked loss {hist[0]['loss']:.7f} (distance "
            f"{dist['loss']['chunked']:.3g}), unchunked {plain['loss']:.7f} "
            f"({dist['loss']['unchunked']:.3g}); chunked grad norm {hist[0]['grad_norm']:.7f} "
            f"({dist['grad_norm']['chunked']:.3g}), unchunked {plain['grad_norm']:.7f} "
            f"({dist['grad_norm']['unchunked']:.3g}); limit {BF16_DRIFT_RATIO} x max(unchunked, "
            f"{BF16_DISTANCE_FLOOR:.3g})")
        if "remat=none" in runs:
            n = runs["remat=none"]
            log(f"  {mode}: the chunked step 1 with remat=none from the same start: loss "
                f"{n['loss']:.7f} (distance to f32 {dist['loss']['remat=none']:.3g}), grad norm "
                f"{n['grad_norm']:.7f} ({dist['grad_norm']['remat=none']:.3g}); the dots step "
                f"against it: loss {n['loss_gap']:.3g}, grad norm {n['grad_norm_gap']:.3g} "
                f"relative, updated parameters "
                f"{'bitwise equal' if n['params_bitwise'] else 'not bitwise equal'} (max |diff| "
                f"{n['params_max_abs_diff']:.3g}); {n['wall_s']:.3f} s against dots "
                f"{hist[0]['wall_s']:.3f} s (step 1), peak {n['peak_above_gib']:.2f} GiB above "
                f"the start against dots {hist[0]['peak_above_gib']:.2f} [{card_name}]")
        for key, d in dist.items():
            for name in runs:
                if name != "unchunked" and d[name] > d["limit"]:
                    raise AssertionError(f"qwen bf16 {name} step ({mode}): its {key} strays "
                                         f"{d[name]:.3g} from f32, the unchunked step's "
                                         f"{d['unchunked']:.3g} (limit {d['limit']:.3g})")
        del p, opt
        free_memory()
        if mode == "off":
            # step 1 again, from the weights it started from: under remat the
            # step leaves the allocator too fragmented for its 40 GiB beside a
            # third copy of the weights (step 3's)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                steps[True](params, adamw.init(params), batch, prng.fold_in(prng.key(0), 0))
                torch.cuda.synchronize()
            kern = raw_device_kernels(prof)
            busy = sum(dev_us(e) for e in kern)
            layers = by_layer(kern)
            bwd_ms = layers["lowrank_flash backward kernel"] / 1e3
            fwd_ms = layers["lowrank_flash kernel"] / 1e3
            step_s = res["s_per_step"]
            log(f"  {mode}: one chunked step profiled: device busy {busy / 1e3:.2f} ms of "
                f"{step_s * 1e3:.1f} ms (steps 2-{n_steps}' mean wall; idle "
                f"{1 - busy / (step_s * 1e6):.1%}); lowrank_flash_bwd (bf16) {bwd_ms:.2f} ms "
                f"({bwd_ms * 1e3 / busy:.1%} of busy), lowrank_flash {fwd_ms:.2f} ms "
                f"({fwd_ms * 1e3 / busy:.1%}) [{card_name}]")
            log_layers(layers, busy)
            res.update(busy_ms=busy / 1e3, idle=1 - busy / (step_s * 1e6), bwd_ms=bwd_ms,
                       bwd_share=bwd_ms * 1e3 / busy, fwd_ms=fwd_ms)
            free_memory()
        out[mode] = res
    return out


def check_deepseek(card_name) -> dict:
    """20f: DeepSeek-V3 at full width, cut to DEEPSEEK_CUT with MTP kept:
    forward_deepseek(chunked=True) over 2 x 4096 tokens in adaptive/masked
    (3 lowrank_flash launches at r = 192) against the plain path, then
    DEEPSEEK_DECODE_STEPS greedy decode_step_deepseek steps after a 64-token
    prompt."""
    full = get_config("deepseek-v3-671b")
    cfg = full.with_(**DEEPSEEK_CUT, rank=RankConfig(mode="adaptive", rank_grid=GRID))
    log(f"  deepseek-v3-671b cut from {full.num_layers} layers ({full.first_dense_layers} "
        f"dense) to {cfg.num_layers} ({cfg.first_dense_layers} dense + "
        f"{cfg.num_layers - cfg.first_dense_layers} MoE) + the MTP block; width unchanged")
    torch.cuda.reset_peak_memory_stats()
    params = family_params(cfg)
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4096), generator=g, device=DEV)
    rank_ctx = {"cfg": cfg.rank}

    def fwd():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, aux = forward_deepseek(cfg, params, tokens, rank_ctx0=rank_ctx, chunked=True)
        torch.cuda.synchronize()
        return lg, aux, time.perf_counter() - t0
    reset_launches()
    replay = RouteReplay()
    with replay.recording():
        logits, aux, wall = fwd()
    launches = lowrank_flash.LAUNCHES["lowrank_flash"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert launches == 3, f"{launches} lowrank_flash launches, expected 3"
    assert logits.shape == (2, 4096, cfg.vocab_size) and torch.isfinite(logits).all()
    assert aux["mtp_logits"].shape == (2, 4095, cfg.vocab_size)
    with plain_flash_by_heads(), replay.replaying():
        logits_p, aux_p, wall_p = fwd()
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == launches
    err, tol, same = logits_err(logits, logits_p)
    err_m, tol_m, same_m = logits_err(aux["mtp_logits"], aux_p["mtp_logits"])
    log(f"  forward_deepseek adaptive/masked, 2 x 4096: {launches} lowrank_flash launches "
        f"(dense, MoE and MTP blocks; r = 192, dv = 128); against the plain path with "
        f"the routing pinned: max|logits - plain| {err:.4g} (tol {tol:.4g}), greedy "
        f"agreement {same:.4f}; MTP {err_m:.4g} (tol {tol_m:.4g}), {same_m:.4f} (floor "
        f"{GREEDY_FLOOR}); aux_loss "
        f"{aux['aux_loss'].item():.5g} (plain {aux_p['aux_loss'].item():.5g}); wall "
        f"{wall * 1e3:.1f} ms kernel, {wall_p * 1e3:.1f} ms plain (first calls); peak "
        f"{peak:.1f} GiB [{card_name}]")
    assert err <= tol and err_m <= tol_m, "forward_deepseek: kernel vs plain logits differ"
    assert min(same, same_m) >= GREEDY_FLOOR, \
        f"forward_deepseek: greedy agreement {same}, MTP {same_m}"
    out = dict(launches=launches, max_logit_err=err, max_mtp_logit_err=err_m,
               greedy_agreement=same, mtp_greedy_agreement=same_m,
               wall_ms=1e3 * wall, plain_wall_ms=1e3 * wall_p, peak_gib=peak,
               n_params=cfg.n_params(), params=sum(p.numel() for p in tu.leaves(params)))
    del logits, aux, logits_p, aux_p
    free_memory()

    # decode: a 64-token prompt in one step, then greedy single tokens
    prompt = tokens[:, :64]
    cache = get_model(cfg).init_cache(2, 64 + DEEPSEEK_DECODE_STEPS, device=DEV)
    step = get_model(cfg).decode_step
    with torch.no_grad():
        lg, cache = step(params, cache, prompt)
        seq = [prompt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DEEPSEEK_DECODE_STEPS):
            nxt = lg[:, -1:].argmax(-1)
            seq.append(nxt)
            lg, cache = step(params, cache, nxt)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        assert torch.isfinite(lg).all() and cache["len"] == 64 + DEEPSEEK_DECODE_STEPS
        full_seq = torch.cat(seq, dim=1)
        ref, _ = forward_deepseek(cfg.with_(rank=RankConfig()), params, full_seq)
    agree = (ref[:, 63:-1].argmax(-1) == full_seq[:, 64:]).float().mean().item()
    log(f"  decode_step_deepseek: {DEEPSEEK_DECODE_STEPS} greedy steps after a 64-token "
        f"prompt, {1e3 * dec_s / DEEPSEEK_DECODE_STEPS:.1f} ms/step; the unchunked forward "
        f"over the same tokens picks the decoded token at {agree:.3f} of the steps "
        f"(reported: the step routes 2 tokens at a time, capacity 1 per expert) [{card_name}]")
    out.update(decode_ms_step=1e3 * dec_s / DEEPSEEK_DECODE_STEPS, decode_agreement=agree)
    del params, cache, ref
    free_memory()
    return out


def check_family_reference() -> None:
    """20g: the reduced qwen2.5-14b and granite served on the card with the
    kernel and on the CPU without it (identical greedy tokens and ranks, in
    'adaptive'), and the reduced DeepSeek-V3's chunked forward at 2 x 1040
    (logits within 1e-5)."""
    for arch in ("qwen2.5-14b", "granite-moe-3b-a800m"):
        base = get_config(arch, reduced=True)
        cfg = base.with_(rank=RankConfig(mode="adaptive", rank_grid=base.rank.rank_grid,
                                         segment_len=8))
        params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        knobs = dict(n_slots=3, max_len=64, page_size=16, segment_len=8, max_new_cap=12,
                     prefill_chunk=8)
        outs = {}
        for device, use_kernel in ((DEV, True), ("cpu", False)):
            rng = np.random.default_rng(0)
            eng = Engine(cfg, params, device=device,
                         config=EngineConfig(use_kernel=use_kernel, **knobs))
            hs = [eng.submit(rng.integers(0, 256, int(n)), SamplingParams(max_new=12),
                             arrival=2 * i) for i, n in enumerate(rng.integers(8, 33, 6))]
            eng.run()
            outs[device] = ([h.result() for h in hs], eng.ranks_per_step())
        for a, b in zip(outs[DEV][0], outs["cpu"][0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(outs[DEV][1], outs["cpu"][1]):
            np.testing.assert_array_equal(a, b)
        log(f"  reduced {arch}, adaptive: 6 requests, GPU kernel tokens and ranks == CPU "
            f"plain tokens and ranks ({len(outs[DEV][1])} steps)")
    cfg = get_config("deepseek-v3-671b", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=cfg.rank.rank_grid))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 1040),
                           generator=torch.Generator().manual_seed(6))
    res = {}
    for device, p in ((DEV, params_to(params, DEV)), ("cpu", params)):
        reset_launches()
        lg, aux = forward_deepseek(cfg, p, tokens.to(device), rank_ctx0={"cfg": cfg.rank},
                                   chunked=True)
        res[device] = (lg.cpu(), aux["mtp_logits"].cpu(),
                       lowrank_flash.LAUNCHES["lowrank_flash"])
    (lg, mtp, n), (lg_c, mtp_c, n_c) = res[DEV], res["cpu"]
    assert n == cfg.num_layers + 1 and n_c == 0, (n, n_c)
    err = max((lg - lg_c).abs().max().item(), (mtp - mtp_c).abs().max().item())
    assert err <= REDUCED_LOGIT_TOL, f"reduced DeepSeek-V3: card vs CPU logits differ by {err}"
    log(f"  reduced deepseek-v3-671b, 2 x 1040 tokens, adaptive/masked: card ({n} "
        f"lowrank_flash launches at r = 24) vs CPU plain, max|logits| and MTP diff "
        f"{err:.3g} (tol {REDUCED_LOGIT_TOL:g})")


def check_families(card_name) -> dict:
    """Phase 20, the dense configs and the MoE family: 20a-h. Returns the
    phase's numbers."""
    t0 = time.perf_counter()
    kern = check_family_kernels(card_name)
    free_memory()
    phase(f"  qwen2.5-14b served at full width, {FAMILY_SERVE_LAYERS} layers")
    qwen_params, qwen = check_qwen_serving(card_name)
    phase("  qwen2.5-14b forward_dense(chunked=True), 2 x 4096")
    qwen_fwd = check_qwen_forward(qwen_params, card_name)
    cut = {**qwen_params, "layers": tu.tree_map(lambda t: t[:QWEN_TRAIN_LAYERS].clone(),
                                                qwen_params["layers"])}
    del qwen_params
    free_memory()
    phase(f"  20h: qwen2.5-14b's LM step in bf16 with loss(chunked=True), "
          f"{QWEN_TRAIN_BATCH} x {QWEN_TRAIN_SEQ}, {QWEN_TRAIN_LAYERS} layers")
    qwen_train = check_qwen_bf16_training(cut, card_name)
    del cut
    free_memory()
    phase(f"  granite-moe-3b-a800m served at full width, {FAMILY_SERVE_LAYERS} layers")
    granite_params, granite = check_granite_serving(card_name)
    del granite_params
    free_memory()
    phase("  internlm2-20b, phi3-medium-14b, deepseek-coder-33b cut in depth")
    dense = check_dense_cut(card_name)
    phase("  deepseek-v3-671b at full width: forward with MLA and MTP, decode")
    deepseek = check_deepseek(card_name)
    phase("  reduced qwen2.5-14b, granite and deepseek-v3, card vs CPU")
    check_family_reference()
    secs = time.perf_counter() - t0
    nums = {"kernels": kern, "qwen_serving": qwen, "qwen_forward": qwen_fwd,
            "qwen_bf16_training": qwen_train, "granite": granite, "dense_cut": dense,
            "deepseek": deepseek, "phase_s": secs, "card": card_name}
    log("phase 20 numbers: " + json.dumps(nums))
    return nums


# -- phase 21 ----------------------------------------------------------------

# 21a: lowrank_flash at the chunked forwards' shapes of this phase: zamba2's
# shared attention (32 heads of 112: r = dv = 112, padded to the r <= 128,
# dv <= 128 instantiation), seamless's decoder self-attention (16 of 64, its
# 2 x 2048 target tokens) and qwen2-vl's (28/4 of 128, M-RoPE'd q and k):
# b, hq, hkv, sq, skv, r, dv, causal, q_offset
RECURRENT_FLASH = {
    "zamba2-7b r=dv=112": (2, 32, 32, 4096, 4096, 112, 112, True, 0),
    "seamless decoder r=dv=64": (2, 16, 16, 2048, 2048, 64, 64, True, 0),
    "qwen2-vl-7b r=dv=128": (2, 28, 4, 4096, 4096, 128, 128, True, 0),
}
# ... and the one-query calls of zamba2's and qwen2-vl's dense-cache
# decodes at their last step (the cache buffer holds exactly skv rows),
# which ops.flash_attention sends to flash_decode on views of the cache
RECURRENT_DECODE = {
    "zamba2-7b decode r=dv=112": (2, 32, 32, 1, 4096, 112, 112, True, 4095),
    "qwen2-vl-7b decode r=dv=128": (2, 28, 4, 1, 2064, 128, 128, True, 2063),
}
ZAMBA_DECODE_STEPS = 32
# 21b: zamba2-7b cut in depth from 81 layers (54 mamba blocks + 27 shared
# attention invocations) to 27 (18 + 9), widths unchanged, for the smoke's
# 1200 s once phase 20h joined it (the full depth took 62 s of a whole run)
ZAMBA_LAYERS = 27
RWKV_DECODE_STEPS = 64
SEAMLESS_DECODE_STEPS = 16
SEAMLESS_PROMPT = 64
VLM_DECODE_STEPS = 16
VLM_PROMPT = 2048
VLM_GRID = 16              # 256 patches on a 16 x 16 grid
# 21c: one full-width layer's wkv6_chunked against wkv6_naive in f32, both
# on the card: max |difference| relative to max |naive|
WKV_REL_TOL = 1e-4
# 21f: the reduced models in f32, card against CPU (the CPU tests' logit
# tolerance against JAX)
REDUCED_FAMILY_TOL = 1e-4
# 21b-e: a deep bf16 stack amplifies the one-ulp differences between the
# kernel's and the plain path's attention outputs (zamba2-7b's 81 layers:
# 0.23 at the logits, 3.7 bf16 steps, in PR 25's first run). So each
# full-width model also runs in f32 on the same weights, where the kernel
# run is held to the plain path within LOGIT_TOL; in bf16 each run's
# distance to the f32 plain run is compared, the kernel's at most this
# factor of the plain bf16 run's (or of two bf16 steps), and over a
# forward's 8192 positions its greedy agreement with the f32 run at most
# DRIFT_AGREE_SLACK below the plain's (six standard errors at the 0.89
# agreement zamba2's bf16 runs read)
BF16_DRIFT_RATIO = 2.0
DRIFT_AGREE_SLACK = 0.02


def recurrent_ptxas() -> None:
    """The ptxas lines of the lowrank_flash instantiations phase 21 runs:
    r = dv = 112 and 128 (bf16 KR 128 / DV 128, f32 KR 16 / ND 16) and r =
    dv = 64 (bf16 KR 64 / DV 64, f32 KR 8 / ND 8)."""
    for name, keys in (("lowrank_flash_bf16", ("Li128ELi128>", "Li64ELi64>")),
                       ("lowrank_flash", ("Li16ELi16>", "Li8ELi8>"))):
        for line in ptxas_summary(build.build_log.get(name, (0, ""))[1]):
            if any(k in line for k in keys):
                log("  ptxas: " + line)


def check_one_query(label, case, seed, card_name) -> dict:
    """One decode's one-query call (sq = 1 at q_offset = skv - 1: every key
    visible), f32 and bf16: ``ops.flash_attention`` on views of (b, skv,
    hkv, d) caches in attend's layout launches flash_decode once and no
    lowrank_flash, within 2e-5 + 2e-5 |plain| (f32) or two bf16 steps (bf16)
    of lowrank_flash_plain. Timed (CUDA events, L2 flushed): the routed call
    ('ms'), lowrank_flash on the contiguous copies the call site made before
    this route, copies included ('before_ms') and not ('before_kernel_ms'),
    flash_decode alone on the views with its lengths made beforehand
    ('decode_ms': the route's own fills left out), the plain version, SDPA
    on the views, and the bound."""
    import torch.nn.functional as F
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    assert sq == 1 and off == skv - 1, case
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=DEV).manual_seed(seed)
        q, kc, vc = (torch.randn(shape, generator=g, device=DEV).to(dtype)
                     for shape in ((b, sq, hq, r), (b, skv, hkv, r), (b, skv, hkv, dv)))
        views = tuple(t.transpose(1, 2) for t in (q, kc, vc))
        kw = dict(scale=r ** -0.5, causal=causal, q_offset=off)
        reset_launches()
        o = ops.flash_attention(*views, **kw)
        torch.cuda.synchronize()
        launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                    "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
        assert launches == {"flash_decode": 1, "lowrank_flash": 0}, (label, launches)
        ro = lowrank_flash.lowrank_flash_plain(*views, **kw)
        diff = (o.float() - ro.float()).abs()
        rel = TOL if dtype == torch.float32 else BF16_REL
        err = diff.max().item()
        if (diff > TOL + rel * ro.float().abs()).any().item():
            raise AssertionError(f"{label} {dtype}: the routed call differs from "
                                 f"lowrank_flash_plain by {err:.3g}")
        copies = tuple(t.contiguous() for t in views)
        q4, lens = views[0].contiguous(), torch.full((b,), skv, dtype=torch.int32, device=DEV)
        start = lens - 1

        def lib():
            return F.scaled_dot_product_attention(*views, scale=kw["scale"],
                                                  enable_gqa=hq != hkv)
        t = dict(
            ms=time_ms(lambda: ops.flash_attention(*views, **kw), n=15),
            before_ms=time_ms(lambda: lowrank_flash.lowrank_flash(
                *(x.contiguous() for x in views), **kw), n=15),
            before_kernel_ms=time_ms(lambda: lowrank_flash.lowrank_flash(*copies, **kw), n=15),
            decode_ms=time_ms(lambda: decode_attn.flash_decode(
                q4, views[1], views[2], lens, scale=kw["scale"], q_start=start), n=15),
            plain_ms=time_ms(lambda: lowrank_flash.lowrank_flash_plain(*views, **kw), n=15),
            library_ms=time_ms(lib, n=15),
            sdpa_backend=sdpa_backend(*views, kw["scale"], causal=False))
        bnd, by, _ = flash_bound_ms(case, dtype)
        t.update(bound_ms=bnd, bound_by=by, max_abs_err=err, launches=launches)
        log(f"  {label}, {str(dtype)[6:]}: ops.flash_attention on cache views -> "
            f"flash_decode (1 launch), max|out - lowrank_flash_plain| {err:.3g} (tol "
            f"{TOL:g} + {rel:.3g}*|plain|); routed {t['ms']:.4f} ms, before (lowrank_flash "
            f"+ copies) {t['before_ms']:.4f} ms ({t['before_kernel_ms']:.4f} without the "
            f"copies), flash_decode alone {t['decode_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, sdpa ({t['sdpa_backend']}) "
            f"{t['library_ms']:.4f} ms; bound {bnd:.4f} ms ({by}), {bnd / t['ms']:.1%} of "
            f"it; {t['before_ms'] / t['ms']:.2f}x faster than before [{card_name}]")
        out[str(dtype)[6:]] = t
        del q, kc, vc, views, copies, q4, lens, start, o, ro
        free_memory()
    return out


def check_recurrent_kernels(card_name) -> dict:
    """21a: lowrank_flash against its plain version at this phase's shapes,
    f32 and bf16, then timed in bf16 beside its bound and SDPA; the decodes'
    one-query calls through the route (``check_one_query``)."""
    recurrent_ptxas()
    err, times = 0.0, {}
    for i, (label, case) in enumerate(RECURRENT_FLASH.items()):
        for dtype in (torch.float32, torch.bfloat16):
            e = check_flash_case(case, dtype, seed=500 + i, label=f"{label}: ")
            if dtype == torch.float32:
                err = max(err, e)
        free_memory()
        times[label] = time_flash(case, label, card_name, torch.bfloat16, per_call=False)
        free_memory()
    one_query = {label: check_one_query(label, case, 520 + i, card_name)
                 for i, (label, case) in enumerate(RECURRENT_DECODE.items())}
    return {"max_abs_err": err, "times": times, "one_query": one_query}


def timed(fn):
    """(fn()'s result, its wall in s), synchronised on both sides, no grad."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def upcast(cfg, params):
    """The f32 twin of a bf16 model: the same weights, exactly, in f32, and
    the config computing in f32."""
    return (cfg.with_(dtype="float32", param_dtype="float32"),
            tu.tree_map(lambda t: t.float(), params))


def _agree(a, b) -> float:
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _flip_gap(got, want) -> float:
    """want's largest top-two gap where the greedy picks differ (0 if none)."""
    flips = got.argmax(-1) != want.argmax(-1)
    if not flips.any():
        return 0.0
    top2 = want.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1])[flips].max().item()


def compare_runs(label, k16, p16, k32, p32, card_name, floor=GREEDY_FLOOR) -> dict:
    """A kernel run against its plain reference in bf16 (k16, p16) and f32
    (k32, p32; the same weights upcast): f32 logits within LOGIT_TOL of the
    largest and the greedy picks agreeing at ``floor`` of the positions (a
    forward's 8192; a decode's few positions, ``floor=None``, are held by
    the logits bound, a pick differing only at a top-two gap under twice
    it). In bf16, where a deep stack amplifies one-ulp differences, the
    kernel run may stray from the f32 plain run at most BF16_DRIFT_RATIO as
    far as the plain bf16 run does (or two bf16 steps, if more) and, over a
    forward's positions, agree with its picks at most DRIFT_AGREE_SLACK
    less (a decode's 32-128 picks are too few to tell such a gap from
    chance: reported); the two bf16 runs' distance against LOGIT_BF16_STEPS
    bf16 steps is reported. Logged."""
    top = p32.abs().max().item()
    err32 = (k32 - p32).abs().max().item()
    tol32 = LOGIT_TOL * max(1.0, top)
    same32, gap32 = _agree(k32, p32), _flip_gap(k32, p32)
    e_k = (k16.float() - p32).abs().max().item()
    e_p = (p16.float() - p32).abs().max().item()
    a_k, a_p = _agree(k16, p32), _agree(p16, p32)
    err16, tol16, same16 = logits_err(k16, p16)
    log(f"  {label}: f32 max|logits - ref| {err32:.4g} (tol {tol32:.4g}), greedy "
        f"agreement {same32:.4f} ({'floor ' + str(floor) if floor else 'reported'}; largest "
        f"ref top-two gap at a differing pick {gap32:.4g}); bf16 against the f32 ref: this "
        f"run {e_k:.4g} / {a_k:.4f}, the bf16 ref {e_p:.4g} / {a_p:.4f} (max|diff| / greedy "
        f"agreement); bf16 run vs bf16 ref {err16:.4g} ({LOGIT_BF16_STEPS} bf16 steps: "
        f"{tol16:.4g}, {'within' if err16 <= tol16 else 'beyond'}), agreement {same16:.4f} "
        f"[{card_name}]")
    assert err32 <= tol32, f"{label}: f32 logits differ by {err32} (tol {tol32})"
    assert floor is None or same32 >= floor, f"{label}: f32 greedy agreement {same32}"
    assert gap32 <= 2 * tol32, f"{label}: an f32 pick differs at a top-two gap of {gap32}"
    assert e_k <= BF16_DRIFT_RATIO * max(e_p, tol16), \
        f"{label}: the bf16 kernel run strays {e_k} from f32, the plain run {e_p}"
    assert floor is None or a_k >= a_p - DRIFT_AGREE_SLACK, \
        f"{label}: bf16 agreement {a_k} against {a_p}"
    return {"f32_max_logit_err": err32, "f32_tol": tol32, "f32_greedy_agreement": same32,
            "bf16_kernel_vs_f32": e_k, "bf16_plain_vs_f32": e_p,
            "bf16_kernel_agreement_f32": a_k, "bf16_plain_agreement_f32": a_p,
            "bf16_kernel_vs_plain": err16, "bf16_two_steps": tol16,
            "bf16_greedy_agreement": same16}


def decode_run(step, cache, prompt, rest):
    """The prompt in one decode step, then ``rest``'s tokens one at a time
    (teacher-forced). Returns (the prompt's logits, the steps' logits, the
    final cache, prefill s, decode s)."""
    (lg_p, cache), pre_s = timed(lambda: step(cache, prompt))
    outs = []

    def steps():
        c = cache
        for i in range(rest.shape[1]):
            lg, c = step(c, rest[:, i:i + 1])
            outs.append(lg)
        return c
    cache, dec_s = timed(steps)
    return lg_p, torch.cat(outs, dim=1), cache, pre_s, dec_s


def kernel_and_plain(fwd, want_launches, label):
    """``fwd()`` through the kernel (its lowrank_flash launches counted,
    ``want_launches`` expected), then through its plain version, group by
    group of heads (no launch). Returns (kernel out, plain out, kernel s,
    plain s)."""
    reset_launches()
    out, wall = timed(fwd)
    launches = lowrank_flash.LAUNCHES["lowrank_flash"]
    assert launches == want_launches, f"{label}: {launches} launches, expected " \
                                      f"{want_launches}"
    with plain_flash_by_heads():
        out_p, wall_p = timed(fwd)
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == launches
    return out, out_p, wall, wall_p


def check_zamba(card_name) -> dict:
    """21b: zamba2-7b at full width, cut to ZAMBA_LAYERS layers (18 mamba
    blocks + 9 shared attention invocations): forward_zamba(chunked=True)
    over 2 x 4096 in 'off' (9 lowrank_flash launches) and 'adaptive'/masked
    with fidelity (18), each against the plain path, in bf16 and in f32;
    then the first 4096 - 32 tokens prefilled into init_cache_zamba (9
    lowrank_flash launches) and 32 single-token decode steps (9 flash_decode
    launches each: the few-query route), against the 'off' forward's
    logits."""
    full = get_config("zamba2-7b").with_(num_layers=ZAMBA_LAYERS)
    n_mamba, n_inv = zamba2.n_blocks(full)
    torch.cuda.reset_peak_memory_stats()
    params = family_params(full)
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, full.vocab_size, (2, 4096), generator=g, device=DEV)
    P = 4096 - ZAMBA_DECODE_STEPS
    modes = (("off", False), ("adaptive", True))

    def forward(cfg, p, fid):
        return lambda: zamba2.forward_zamba(cfg, p, tokens, chunked=True,
                                            collect_aux="ranks", compute_fidelity=fid)

    def decode(cfg, p):
        fns = get_model(cfg)
        reset_launches()
        res = decode_run(lambda c, t: fns.decode_step(p, c, t, chunked=True),
                         fns.init_cache(2, 4096, device=DEV), tokens[:, :P], tokens[:, P:])
        # the prefill's calls take lowrank_flash, the decode steps' one-query
        # calls flash_decode
        launches = {"lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"],
                    "flash_decode": decode_attn.LAUNCHES["flash_decode"]}
        assert launches == {"lowrank_flash": n_inv,
                            "flash_decode": n_inv * ZAMBA_DECODE_STEPS}, launches
        assert res[2]["len"] == 4096
        return res, launches

    runs16 = {}
    for mode, fid in modes:
        cfg = full if mode == "off" else forward_cfg(full, mode, "masked")
        runs16[mode] = kernel_and_plain(forward(cfg, params, fid), n_inv * (2 if fid else 1),
                                        f"zamba2 {mode}")
    (pre16, dec16, cache, pre_s, dec_s), launches_d = decode(full, params)
    del cache
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    cfg32, params = upcast(full, params)
    free_memory()
    out = {"n_mamba": n_mamba, "n_inv": n_inv}
    ref32 = None
    for mode, fid in modes:
        cfg = cfg32 if mode == "off" else forward_cfg(cfg32, mode, "masked")
        (k16, a16), (p16, ap16), wall, wall_p = runs16.pop(mode)
        (k32, a32), (p32, ap32), wall32, wall32_p = kernel_and_plain(
            forward(cfg, params, fid), n_inv * (2 if fid else 1), f"zamba2 {mode} f32")
        res = compare_runs(f"zamba2-7b {mode}{' + fidelity' if fid else ''}, "
                           f"{n_inv * (2 if fid else 1)} lowrank_flash launches per forward",
                           k16, p16, k32, p32, card_name)
        res.update(launches=n_inv * (2 if fid else 1), wall_ms=1e3 * wall,
                   plain_wall_ms=1e3 * wall_p, f32_wall_ms=1e3 * wall32,
                   f32_plain_wall_ms=1e3 * wall32_p)
        if mode != "off":
            assert torch.equal(a32["ranks"], ap32["ranks"]), "zamba2 f32: ranks differ"
            res.update(bf16_ranks_equal=torch.equal(a16["ranks"], ap16["ranks"]),
                       ranks=sorted(set(a32["ranks"].flatten().tolist())),
                       fidelity=a16["fidelity"].float().mean().item())
            log(f"  ranks: f32 identical {res['ranks']}, bf16 "
                f"{'identical' if res['bf16_ranks_equal'] else 'differ'}; fidelity mean "
                f"{res['fidelity']:.4f}")
        log(f"  walls: bf16 {1e3 * wall:.1f} ms kernel, {1e3 * wall_p:.1f} ms plain; f32 "
            f"{1e3 * wall32:.1f} / {1e3 * wall32_p:.1f} ms [{card_name}]")
        out[mode] = res
        if mode == "off":
            ref16, ref32 = k16, k32
        del k16, p16, k32, p32, a16, ap16, a32, ap32
        free_memory()
    (pre32, dec32, cache, _, dec32_s), _ = decode(cfg32, params)
    del cache, params
    ms = 1e3 * dec_s / ZAMBA_DECODE_STEPS
    pre = compare_runs(f"zamba2-7b prefill of {P} tokens into init_cache_zamba "
                       f"({pre_s:.2f} s) vs the forward", pre16, ref16[:, :P], pre32,
                       ref32[:, :P], card_name)
    dec = compare_runs(f"zamba2-7b {ZAMBA_DECODE_STEPS} single-token decode steps "
                       f"({ms:.1f} ms/step bf16, {1e3 * dec32_s / ZAMBA_DECODE_STEPS:.1f} "
                       f"f32; {launches_d['lowrank_flash']} lowrank_flash launches in the "
                       f"prefill, {launches_d['flash_decode']} flash_decode in the steps) vs "
                       f"the teacher-forced forward", dec16, ref16[:, P:], dec32,
                       ref32[:, P:], card_name, floor=None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  zamba2-7b peak {peak16:.1f} GiB in bf16, {peak:.1f} GiB with the f32 twin "
        f"[{card_name}]")
    out.update(prefill=dict(pre, s=pre_s), decode=dict(dec, ms_step=ms),
               decode_launches=launches_d, peak_gib=peak16, peak_with_f32_gib=peak)
    del ref16, ref32, pre16, dec16, pre32, dec32
    free_memory()
    return out


def check_rwkv(card_name) -> dict:
    """21c: rwkv6-1.6b at full width and depth: forward_rwkv over 1 x 4096
    (no kernel launched), the first 4096 - 64 tokens as one decode step from
    the zero state and 64 single-token steps against the forward's logits
    (bf16, and f32 on the same weights), and layer 0's wkv6_chunked against
    wkv6_naive in f32 on its own inputs."""
    full = get_config("rwkv6-1.6b")
    torch.cuda.reset_peak_memory_stats()
    params = family_params(full)
    g = torch.Generator(device=DEV).manual_seed(6)
    tokens = torch.randint(0, full.vocab_size, (1, 4096), generator=g, device=DEV)
    P = 4096 - RWKV_DECODE_STEPS
    captured = []
    chunked = rwkv6.wkv6_chunked

    def capture(*a, **kw):
        if not captured:
            captured.append(a)
        return chunked(*a, **kw)

    def run(cfg, p):
        fns = get_model(cfg)
        (lg, _), wall = timed(lambda: rwkv_lm.forward_rwkv(cfg, p, tokens))
        assert lg.shape == (1, 4096, cfg.vocab_size) and torch.isfinite(lg).all()
        pre, dec, _, pre_s, dec_s = decode_run(
            lambda c, t: fns.decode_step(p, c, t), fns.init_cache(1, 0, device=DEV),
            tokens[:, :P], tokens[:, P:])
        return lg, pre, dec, wall, pre_s, dec_s
    reset_launches()
    rwkv6.wkv6_chunked = capture
    try:
        lg16, pre16, dec16, wall, pre_s, dec_s = run(full, params)
    finally:
        rwkv6.wkv6_chunked = chunked
    launches = sum(lowrank_flash.LAUNCHES.values()) + sum(decode_attn.LAUNCHES.values())
    assert launches == 0, f"rwkv6 launched {launches} attention kernels"
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg32, params = upcast(full, params)
    lg32, pre32, dec32, wall32, _, dec32_s = run(cfg32, params)
    del params
    tps = RWKV_DECODE_STEPS / dec_s
    log(f"  rwkv6-1.6b forward_rwkv, 1 x 4096: wall {1e3 * wall:.1f} ms bf16, "
        f"{1e3 * wall32:.1f} ms f32; peak {peak:.1f} GiB (bf16); 0 kernel launches (no "
        f"attention) [{card_name}]")
    pre = compare_runs(f"rwkv6-1.6b {P} tokens in one decode step ({pre_s:.2f} s) vs the "
                       f"forward", pre16, lg16[:, :P], pre32, lg32[:, :P], card_name)
    dec = compare_runs(f"rwkv6-1.6b {RWKV_DECODE_STEPS} single-token steps "
                       f"({1e3 * dec_s / RWKV_DECODE_STEPS:.1f} ms/step, {tps:.1f} tokens/s "
                       f"at batch 1, bf16) vs the forward", dec16, lg16[:, P:], dec32,
                       lg32[:, P:], card_name, floor=None)
    a = captured[0]
    f32 = [t.float() if torch.is_tensor(t) else t for t in a]
    (y_c, s_c), wkv_ms = timed(lambda: rwkv6.wkv6_chunked(*f32))
    (y_n, s_n), naive_ms = timed(lambda: rwkv6.wkv6_naive(*f32[:6], state0=f32[7]))
    rel = max(((y_c - y_n).abs().max() / y_n.abs().max()).item(),
              ((s_c - s_n).abs().max() / s_n.abs().max()).item())
    log(f"  layer 0's wkv6_chunked vs wkv6_naive, f32, 1 x 4096 x 32 heads of 64: max "
        f"|chunked - naive| / max |naive| {rel:.3g} (tol {WKV_REL_TOL:g}); chunked "
        f"{1e3 * wkv_ms:.1f} ms, naive {1e3 * naive_ms:.1f} ms [{card_name}]")
    assert rel <= WKV_REL_TOL, f"wkv6 chunked vs naive: {rel}"
    out = dict(wall_ms=1e3 * wall, f32_wall_ms=1e3 * wall32, peak_gib=peak,
               prefill=dict(pre, s=pre_s),
               decode=dict(dec, ms_step=1e3 * dec_s / RWKV_DECODE_STEPS, tokens_s=tps,
                           f32_ms_step=1e3 * dec32_s / RWKV_DECODE_STEPS),
               wkv_rel_err=rel, wkv_chunked_ms=1e3 * wkv_ms, wkv_naive_ms=1e3 * naive_ms,
               launches=launches)
    del lg16, lg32, pre16, dec16, pre32, dec32, captured
    free_memory()
    return out


def check_seamless(card_name) -> dict:
    """21d: seamless-m4t-medium at full width: encode over 2 x 1024 frames,
    forward_encdec(chunked=True) over 2 x 2048 target tokens (12
    lowrank_flash launches, the decoder's self-attention) against the plain
    path, then prefill_cross, a 64-token prompt and 16 single-token decode
    steps against the forward's logits; bf16, and f32 on the same
    weights."""
    full = get_config("seamless-m4t-medium")
    torch.cuda.reset_peak_memory_stats()
    params = family_params(full)
    g = torch.Generator(device=DEV).manual_seed(7)
    frames = torch.randn((2, full.frontend_positions, full.d_model), generator=g,
                         device=DEV).to(torch.bfloat16)
    tokens = torch.randint(0, full.vocab_size, (2, 2048), generator=g, device=DEV)
    n = SEAMLESS_PROMPT + SEAMLESS_DECODE_STEPS

    def run(cfg, p):
        fr = frames.to(nn.dt(cfg.dtype))
        memory, enc_s = timed(lambda: encdec.encode(cfg, p, fr))
        assert memory.shape == fr.shape and torch.isfinite(memory).all()
        lg, lg_p, wall, wall_p = kernel_and_plain(
            lambda: encdec.forward_encdec(cfg, p, fr, tokens, chunked=True)[0],
            cfg.num_layers, "seamless")
        fns = get_model(cfg)
        cache = encdec.prefill_cross(cfg, p, memory, fns.init_cache(2, n, device=DEV))
        pre, dec, _, pre_s, dec_s = decode_run(
            lambda c, t: fns.decode_step(p, c, t), cache, tokens[:, :SEAMLESS_PROMPT],
            tokens[:, SEAMLESS_PROMPT:n])
        return dict(lg=lg, lg_p=lg_p, pre=pre, dec=dec, enc_s=enc_s, wall=wall,
                    wall_p=wall_p, dec_s=dec_s)
    r16 = run(full, params)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg32, params = upcast(full, params)
    free_memory()
    r32 = run(cfg32, params)
    del params
    fwd = compare_runs(f"seamless forward_encdec, 2 x 2048 tokens over 2 x 1024 frames, "
                       f"{full.num_layers} lowrank_flash launches, vs the plain path",
                       r16["lg"], r16["lg_p"], r32["lg"], r32["lg_p"], card_name)
    log(f"  seamless walls: encode {1e3 * r16['enc_s']:.1f} ms, forward "
        f"{1e3 * r16['wall']:.1f} ms kernel, {1e3 * r16['wall_p']:.1f} ms plain (bf16; f32 "
        f"{1e3 * r32['wall']:.1f} / {1e3 * r32['wall_p']:.1f} ms); peak {peak:.1f} GiB "
        f"(bf16) [{card_name}]")
    ms = 1e3 * r16["dec_s"] / SEAMLESS_DECODE_STEPS
    pre = compare_runs(f"seamless {SEAMLESS_PROMPT}-token prompt after prefill_cross vs the "
                       f"forward", r16["pre"], r16["lg"][:, :SEAMLESS_PROMPT], r32["pre"],
                       r32["lg"][:, :SEAMLESS_PROMPT], card_name, floor=None)
    dec = compare_runs(f"seamless {SEAMLESS_DECODE_STEPS} decode steps ({ms:.1f} ms/step "
                       f"bf16) vs the forward", r16["dec"],
                       r16["lg"][:, SEAMLESS_PROMPT:n], r32["dec"],
                       r32["lg"][:, SEAMLESS_PROMPT:n], card_name, floor=None)
    out = dict(fwd, launches=full.num_layers, encode_ms=1e3 * r16["enc_s"],
               wall_ms=1e3 * r16["wall"], plain_wall_ms=1e3 * r16["wall_p"],
               f32_wall_ms=1e3 * r32["wall"], peak_gib=peak, prompt=pre,
               decode=dict(dec, ms_step=ms))
    del r16, r32
    free_memory()
    return out


def vlm_positions(b, n_patch, s_txt, grid_w, device):
    """Qwen2-VL's (t, h, w) ids: one image's patches on a grid of ``grid_w``
    columns, then text whose three streams continue together."""
    i = torch.arange(n_patch, device=device)
    img = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w])
    txt = (img.max() + 1 + torch.arange(s_txt, device=device)).expand(3, s_txt)
    return torch.cat([img, txt], dim=1)[None].expand(b, 3, n_patch + s_txt)


def check_qwen_vl(card_name) -> dict:
    """21e: qwen2-vl-7b at full width and depth: forward_dense(chunked=True)
    on 2 x (256 patch embeddings + 3840 tokens) at patch-grid M-RoPE
    positions (28 lowrank_flash launches) against the plain path; then a
    2048-token text prompt (28 lowrank_flash launches) and 16 single-token
    decode_step_dense steps (the default 3-stream positions; 28 flash_decode
    launches each, the few-query route over more than 1024 keys) against the
    teacher-forced forward over the same 2064 tokens; bf16, and f32 on the
    same weights."""
    full = get_config("qwen2-vl-7b")
    torch.cuda.reset_peak_memory_stats()
    params = family_params(full)
    g = torch.Generator(device=DEV).manual_seed(8)
    n_patch = full.frontend_positions
    patches = torch.randn((2, n_patch, full.d_model), generator=g,
                          device=DEV).to(torch.bfloat16)
    text = torch.randint(0, full.vocab_size, (2, 4096 - n_patch), generator=g, device=DEV)
    pos = vlm_positions(2, n_patch, text.shape[1], VLM_GRID, DEV)
    n = VLM_PROMPT + VLM_DECODE_STEPS

    def run(cfg, p):
        pe = patches.to(nn.dt(cfg.dtype))
        lg, lg_p, wall, wall_p = kernel_and_plain(
            lambda: forward_dense(cfg, p, text, positions=pos, extra_embeddings=pe,
                                  chunked=True)[0], cfg.num_layers, "qwen2-vl")
        assert lg.shape == (2, 4096, cfg.vocab_size) and torch.isfinite(lg).all()
        fns = get_model(cfg)
        reset_launches()
        _, dec, _, pre_s, dec_s = decode_run(
            lambda c, t: fns.decode_step(p, c, t, chunked=True),
            fns.init_cache(2, n, device=DEV), text[:, :VLM_PROMPT], text[:, VLM_PROMPT:n])
        launches_d = {"lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"],
                      "flash_decode": decode_attn.LAUNCHES["flash_decode"]}
        assert launches_d == {"lowrank_flash": cfg.num_layers,
                              "flash_decode": cfg.num_layers * VLM_DECODE_STEPS}, launches_d
        ref, _ = timed(lambda: forward_dense(cfg, p, text[:, :n], chunked=True)[0])
        return dict(lg=lg, lg_p=lg_p, dec=dec, ref=ref[:, VLM_PROMPT:].clone(), wall=wall,
                    wall_p=wall_p, pre_s=pre_s, dec_s=dec_s, launches_d=launches_d)
    r16 = run(full, params)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg32, params = upcast(full, params)
    free_memory()
    r32 = run(cfg32, params)
    del params
    fwd = compare_runs(f"qwen2-vl-7b forward_dense, 2 x ({n_patch} patches + "
                       f"{text.shape[1]} tokens), M-RoPE on a {VLM_GRID} x {VLM_GRID} grid, "
                       f"{full.num_layers} lowrank_flash launches, vs the plain path",
                       r16["lg"], r16["lg_p"], r32["lg"], r32["lg_p"], card_name)
    log(f"  qwen2-vl-7b walls: forward {1e3 * r16['wall']:.1f} ms kernel, "
        f"{1e3 * r16['wall_p']:.1f} ms plain (bf16; f32 {1e3 * r32['wall']:.1f} / "
        f"{1e3 * r32['wall_p']:.1f} ms); peak {peak:.1f} GiB (bf16) [{card_name}]")
    ms = 1e3 * r16["dec_s"] / VLM_DECODE_STEPS
    dec = compare_runs(f"qwen2-vl-7b {VLM_DECODE_STEPS} decode_step_dense steps after a "
                       f"{VLM_PROMPT}-token prompt ({r16['pre_s']:.2f} s; {ms:.1f} ms/step "
                       f"bf16; {r16['launches_d']['lowrank_flash']} lowrank_flash launches in "
                       f"the prompt, {r16['launches_d']['flash_decode']} flash_decode in the "
                       f"steps) vs the teacher-forced forward", r16["dec"], r16["ref"], r32["dec"],
                       r32["ref"], card_name, floor=None)
    out = dict(fwd, launches=full.num_layers, wall_ms=1e3 * r16["wall"],
               plain_wall_ms=1e3 * r16["wall_p"], f32_wall_ms=1e3 * r32["wall"],
               peak_gib=peak, decode=dict(dec, ms_step=ms, launches=r16["launches_d"]))
    del r16, r32
    free_memory()
    return out


def reduced_family_forward(arch, cfg, params, device):
    """The reduced model's chunked forward over 1040 positions on
    ``device`` (logits on the CPU, lowrank_flash launches)."""
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1040), generator=g).to(device)
    reset_launches()
    if arch == "zamba2-7b":
        lg, _ = zamba2.forward_zamba(cfg, params, tokens, chunked=True)
    elif arch == "rwkv6-1.6b":
        lg, _ = rwkv_lm.forward_rwkv(cfg, params, tokens)
    elif arch == "seamless-m4t-medium":
        frames = torch.randn((2, cfg.frontend_positions, cfg.d_model), generator=g)
        lg, _ = encdec.forward_encdec(cfg, params, frames.to(device), tokens, chunked=True)
    else:
        patches = torch.randn((2, cfg.frontend_positions, cfg.d_model), generator=g)
        pos = vlm_positions(2, cfg.frontend_positions, 1040 - cfg.frontend_positions, 4,
                            "cpu")
        lg, _ = forward_dense(cfg, params, tokens[:, cfg.frontend_positions:],
                              positions=pos.to(device), extra_embeddings=patches.to(device),
                              chunked=True)
    return lg.cpu(), lowrank_flash.LAUNCHES["lowrank_flash"]


def check_recurrent_reference() -> None:
    """21f: the four reduced models (f32, 'adaptive' where attention has a
    rank), their chunked forwards over 1040 positions on the card with the
    kernel against the CPU without it."""
    for arch in ("zamba2-7b", "rwkv6-1.6b", "seamless-m4t-medium", "qwen2-vl-7b"):
        base = get_config(arch, reduced=True)
        cfg = base.with_(rank=RankConfig(mode="off" if arch == "rwkv6-1.6b" else "adaptive",
                                         rank_grid=base.rank.rank_grid))
        params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        lg, n = reduced_family_forward(arch, cfg, params_to(params, DEV), DEV)
        lg_c, n_c = reduced_family_forward(arch, cfg, params, "cpu")
        want = {"zamba2-7b": zamba2.n_blocks(cfg)[1], "rwkv6-1.6b": 0}.get(arch,
                                                                          cfg.num_layers)
        assert n == want and n_c == 0, (arch, n, n_c)
        err = (lg - lg_c).abs().max().item()
        log(f"  reduced {arch}, 2 x 1040, {cfg.rank.mode}: card ({n} lowrank_flash "
            f"launches) vs CPU plain, max|logits diff| {err:.3g} (tol "
            f"{REDUCED_FAMILY_TOL:g})")
        assert err <= REDUCED_FAMILY_TOL, f"reduced {arch}: card vs CPU logits differ by {err}"


def check_recurrent_families(card_name) -> dict:
    """Phase 21, the remaining model families: 21a-f. Returns the phase's
    numbers."""
    t0 = time.perf_counter()
    kern = check_recurrent_kernels(card_name)
    phase(f"  zamba2-7b at full width, {ZAMBA_LAYERS} of its 81 layers")
    zamba = check_zamba(card_name)
    phase("  rwkv6-1.6b at full width and depth")
    rwkv = check_rwkv(card_name)
    phase("  seamless-m4t-medium at full width")
    seamless = check_seamless(card_name)
    phase("  qwen2-vl-7b at full width and depth")
    qwen_vl = check_qwen_vl(card_name)
    phase("  the reduced zamba2, rwkv6, seamless and qwen2-vl, card vs CPU")
    check_recurrent_reference()
    secs = time.perf_counter() - t0
    nums = {"kernels": kern, "zamba2": zamba, "rwkv6": rwkv, "seamless": seamless,
            "qwen2_vl": qwen_vl, "phase_s": secs, "card": card_name}
    log("phase 21 numbers: " + json.dumps(nums))
    return nums

# -- phase 22 ----------------------------------------------------------------

# 22a: the sharded step on the one-rank mesh against the plain step, from the
# same params, agent and batches: at ring size 1 the model code runs the same
# ops on the same rows (dist.ctx's helpers reduce to the identity, one-rank
# groups skip their collectives), so the loss and the grad norm are held to
# 1e-7 relative and every element of every param to 1e-7 absolute (the
# shards' grad norm may sum its squares in another order; nothing else may
# differ)
DIST_TOL = 1e-7
# 22c: ring attention and the pipeline at ring size 1 against flash_ref, f32
RING_SHAPE = (2, 4096, 12, 64)          # b, S, h, d: drrl-paper's heads
DIST_STEPS = 2
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


@contextlib.contextmanager
def count_collectives():
    """A Counter of the process-group operations (``c10d`` and DTensor's
    functional collectives) dispatched inside the block."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in COLLECTIVE_NAMESPACES:
                counts[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))
    with Count():
        yield counts


def _timed_step(step, p, opt, batch, i, counts=None):
    """One training step on the card: (params, state, metrics as floats, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with count_collectives() if counts is not None else contextlib.nullcontext() as c:
        p, opt, m = step(p, opt, batch, prng.fold_in(prng.key(0), i))
        m = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    if counts is not None:
        counts.update(c)
    return p, opt, m, (time.perf_counter() - t0) * 1e3


def check_sharded_training(paper, agent, mesh, card_name) -> dict:
    """22a: full-width drrl-paper in rank mode 'drrl' (phase 17's 8 x 256
    tokens and agent), its params placed on the one-rank mesh by
    ``param_pspecs`` (the config's own 'dp', then 'fsdp_tp': every matrix
    ``Shard``-ed over both mesh axes), DIST_STEPS sharded training steps
    against the plain step from the same seed: loss, grad norm and every
    param. Returns the numbers and fsdp_tp's sharded state and specs."""
    # a schedule longer than the run, so every step moves the params
    tc = TrainConfig(global_batch=LM_BATCH, seq_len=LM_SEQ, warmup_steps=1,
                     total_steps=10 * DIST_STEPS)
    data = SyntheticLM(paper.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    batches = [data.batch_at(i, device=DEV) for i in range(DIST_STEPS)]
    out, kept = {}, None
    for sharding in ("dp", "fsdp_tp"):
        cfg = paper.with_(sharding=sharding)
        params = get_model(cfg).init(torch.Generator(DEV).manual_seed(0), device=DEV)
        specs = shd.param_pspecs(params, cfg, mesh)
        step = train_loop.make_train_step(cfg, tc, lm_loss_fn(cfg, agent))
        runs = {}
        for label, p in (("sharded", shd.distribute(params, specs, mesh)), ("plain", params)):
            opt, hist, ms = adamw.init(p), [], []
            counts = collections.Counter()
            for i in range(DIST_STEPS):
                # the first sharded step counts its collectives (the counter
                # dispatches every op through Python); the later ones are timed
                p, opt, m, t = _timed_step(step, p, opt, batches[i], i,
                                           counts if label == "sharded" and i == 0 else None)
                hist.append(m)
                ms.append(t)
            runs[label] = dict(hist=hist, ms=ms, collectives=dict(counts), p=p, opt=opt)
        sh, pl = runs["sharded"], runs["plain"]
        assert all(shd.is_dtensor(x) for x in tu.leaves(sh["p"]))
        assert all(shd.is_dtensor(x) for x in tu.leaves(sh["opt"].m))
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for a, b in zip(sh["hist"], pl["hist"]):
            for k in worst:
                worst[k] = max(worst[k], abs(a[k] - b[k]) / abs(b[k]))
        assert worst["loss"] <= DIST_TOL and worst["grad_norm"] <= DIST_TOL, (
            sh["hist"], pl["hist"])
        p_max, n_equal = 0.0, 0
        for (path, g), c in zip(tu.leaves_with_path(sh["p"]), tu.leaves(pl["p"])):
            d = (g.full_tensor() - c).abs().max().item()
            assert d <= DIST_TOL, (path, d)
            p_max, n_equal = max(p_max, d), n_equal + (d == 0.0)
        n_shard = sum(any(pl_.is_shard() for pl_ in x.placements) for x in tu.leaves(sh["p"]))
        log(f"  sharding '{sharding}', drrl-paper {cfg.num_layers} x {cfg.d_model} in rank "
            f"mode '{cfg.rank.mode}', {LM_BATCH} x {LM_SEQ} tokens on a {shd.mesh_sizes(mesh)} "
            f"mesh: {n_shard} of {len(tu.leaves(sh['p']))} leaves Shard-placed; losses "
            f"{[round(h['loss'], 5) for h in sh['hist']]}; sharded vs plain: loss within "
            f"{worst['loss']:.3g}, grad norm within {worst['grad_norm']:.3g}, params "
            f"max|diff| {p_max:.3g} (tol {DIST_TOL:g}), {n_equal} of "
            f"{len(tu.leaves(pl['p']))} leaves bitwise; "
            f"ms per step sharded {[round(t, 1) for t in sh['ms']]} (the first under the "
            f"collective counter), plain {[round(t, 1) for t in pl['ms']]} [{card_name}]")
        log(f"  NCCL calls in the first sharded step: {sum(sh['collectives'].values())} "
            f"{sh['collectives']} (every mesh axis has size 1: DTensor and the step skip "
            f"one-rank groups)")
        out[sharding] = {"ms_sharded": sh["ms"], "ms_plain": pl["ms"],
                         "nccl_calls_step": sum(sh["collectives"].values()),
                         "loss_rel": worst["loss"], "grad_norm_rel": worst["grad_norm"],
                         "param_max_abs": p_max, "leaves_bitwise": n_equal,
                         "shard_leaves": n_shard}
        if sharding == "fsdp_tp":
            kept = (sh["p"], sh["opt"], specs)
        del runs, sh, pl, params
        free_memory()
    return out, kept


def check_dist_checkpoint(kept, mesh, out_dir) -> dict:
    """22b: the sharded (params, AdamWState) saved with their specs
    (run_training's, the moments' too), then ``load(mesh=)`` into the
    same DTensor template: every leaf bitwise, placed as its spec resolves
    on the mesh."""
    params, opt, specs = kept
    save_specs = (specs, adamw.AdamWState(step=(), m=specs, v=specs))
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with count_collectives() as calls:
        mgr.save(DIST_STEPS, (params, opt), save_specs)
        mgr.wait()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    (p2, o2), step, _ = mgr.load((params, opt), mesh=mesh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    assert step == DIST_STEPS
    flat_spec = [s for _, s in tu.flatten_with_keys(save_specs, is_leaf=shd.is_spec)]
    n_bytes = 0
    for (path, a), (_, b), spec in zip(tu.flatten_with_keys((params, opt)),
                                       tu.flatten_with_keys((p2, o2)), flat_spec):
        fa, fb = shd.full_tensor(a), shd.full_tensor(b)
        assert fa.dtype == fb.dtype and torch.equal(fa, fb), path
        if spec:
            assert tuple(b.placements) == shd.to_placements(shd.resolve_spec(spec, mesh),
                                                            mesh), path
        n_bytes += fa.numel() * fa.element_size()
    log(f"  checkpoint of the sharded (params, AdamWState): {n_bytes / 2 ** 30:.2f} GiB "
        f"saved in {t_save:.2f} s (rank 0 writes; {sum(calls.values())} NCCL calls "
        f"{dict(calls)}), loaded onto the mesh in {t_load:.2f} s: every leaf bitwise, "
        f"placements as stored")
    return {"save_s": t_save, "load_s": t_load, "gib": n_bytes / 2 ** 30,
            "nccl_calls": sum(calls.values())}


def check_ring_and_pipeline(mesh, card_name) -> dict:
    """22c: ring attention and the pipeline over the mesh's one-rank data
    axis at 2 x 4096 x 12 x 64, f32, against ``kernels/ref.py:flash_ref``
    (the pipeline's one stage: attention with a projected q)."""
    gen = torch.Generator(DEV).manual_seed(0)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=DEV) for _ in range(3))
    scale = RING_SHAPE[-1] ** -0.5

    def ref(q_, k_, v_, causal):
        return flash_ref(q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                         scale=scale, causal=causal).transpose(1, 2)
    res = {}
    for causal in (True, False):
        ring = make_ring_attention(mesh, scale=scale, causal=causal, axis_name="data")
        with count_collectives() as calls:
            got = ring(q, k, v)
        want = ref(q, k, v, causal)
        err = (got - want).abs().max().item()
        assert err <= TOL, (causal, err)
        ms = {"ring": time_ms(lambda: ring(q, k, v), n=5),
              "flash_ref": time_ms(lambda: ref(q, k, v, causal), n=5)}
        res[f"ring_causal={causal}"] = {"max_abs_err": err, **ms,
                                        "nccl_calls": sum(calls.values())}
    w = {"wq": torch.randn((1, RING_SHAPE[-1], RING_SHAPE[-1]), generator=gen,
                           device=DEV) * scale}

    def stage(p, x):                             # x: (1, S, h, d), one microbatch
        return ref(x @ p["wq"], x, x, True)
    pipe = make_pipeline(mesh, stage, axis_name="data")
    x = q[:, None]                               # 2 microbatches of one row
    with count_collectives() as calls:
        got = pipe(w, x)
    want = torch.stack([stage({"wq": w["wq"][0]}, x[i]) for i in range(x.shape[0])])
    err = (got - want).abs().max().item()
    assert err <= TOL, err
    res["pipeline"] = {"max_abs_err": err, "nccl_calls": sum(calls.values())}
    log(f"  ring attention at ring size 1, {RING_SHAPE} f32, against flash_ref: "
        + ", ".join(f"{k} max|err| {v['max_abs_err']:.3g}, {v['ring']:.2f} ms against "
                    f"{v['flash_ref']:.2f} ms" for k, v in res.items() if k != "pipeline")
        + f"; the pipeline (one stage, 2 microbatches) max|err| {err:.3g}, "
        f"{res['pipeline']['nccl_calls']} NCCL call (the all-reduce) [{card_name}]")
    return res


def check_dist_cli(paper, out_dir, card_name) -> dict:
    """22d: ``launch.train.main`` for DIST_STEPS steps on the card: the host
    mesh and ``param_pspecs`` built, the specs stored in the checkpoint."""
    ckpt = os.path.join(out_dir, "cli")
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        res = train_launch.main(["--steps", str(DIST_STEPS), "--batch", str(LM_BATCH),
                                 "--seq", str(LM_SEQ), "--ckpt-dir", ckpt, "--device", DEV])
    wall = time.perf_counter() - t0
    hist = res["history"]
    assert [h["step"] for h in hist] == list(range(DIST_STEPS)), hist
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    manifest = json.loads(open(os.path.join(ckpt, f"step_{DIST_STEPS}",
                                            "manifest.json")).read())
    mesh = make_host_mesh(DEV)
    meta = get_model(paper).init(torch.Generator().manual_seed(0), device="meta")
    want = {shd.path_str(p): [list(a) if isinstance(a, tuple) else a for a in s]
            for p, s in tu.flatten_with_keys(shd.param_pspecs(meta, paper, mesh),
                                             is_leaf=shd.is_spec)}
    got = {k[2:]: v["spec"] for k, v in manifest["leaves"].items() if k.startswith("0/")}
    assert got == want, (got, want)
    log(f"  launch.train.main on the card, {DIST_STEPS} steps of {LM_BATCH} x {LM_SEQ}: "
        f"losses {[round(h['loss'], 4) for h in hist]}, {wall:.1f} s with init and "
        f"checkpoints; the manifest's specs are param_pspecs on the host mesh "
        f"{shd.mesh_sizes(mesh)} ('{paper.sharding}') [{card_name}]")
    return {"wall_s": wall, "losses": [h["loss"] for h in hist]}


def check_distribution(paper, agent, card_name) -> dict:
    """Phase 22 on a one-rank NCCL group started here (phase 17's training
    CLI ends the group it started) and its (1, 1) host mesh: 22a-d."""
    import torch.distributed as dist
    mesh = make_host_mesh(DEV)
    assert dist.get_backend() == BACKENDS[torch.device(DEV).type], dist.get_backend()
    assert tuple(mesh.shape) == (1, 1), mesh
    out_dir = os.path.join(ROOT, ".scratch", "phase22")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    reset_launches()
    steps, kept = check_sharded_training(paper, agent, mesh, card_name)
    phase("  the sharded checkpoint saved and loaded onto the mesh")
    ckpt = check_dist_checkpoint(kept, mesh, out_dir)
    del kept
    free_memory()
    phase("  ring attention and the pipeline at ring size 1; the training CLI")
    ring = check_ring_and_pipeline(mesh, card_name)
    cli = check_dist_cli(paper, out_dir, card_name)
    launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
    assert launches == {"flash_decode": 0, "lowrank_flash": 0}, launches
    shutil.rmtree(out_dir, ignore_errors=True)
    log("phase 22 numbers: " + json.dumps({
        "sharded_step": steps, "checkpoint": ckpt, "ring_pipeline": ring, "cli": cli,
        "launches": launches, "card": card_name}))
    return {"launches": launches}


# -- phase 23 ----------------------------------------------------------------

DRYRUN_ARCH = "qwen2.5-14b"
DRYRUN_REAL = {"num_layers": 2}        # 23b: full widths, cut in depth
DRYRUN_BUDGET = 60e9                   # 23b: predicted peak bytes for a batch
DRYRUN_CARD_SHARE = 0.85               # ... or, at batch 1, this share of the card
DRYRUN_CELLS = {"train_4k": ShapeCell("train_4k", 4096, 1, "train"),
                "decode_32k": ShapeCell("decode_32k", 32768, 1, "decode"),
                "prefill_32k": ShapeCell("prefill_32k", 32768, 1, "prefill")}


def start_dryrun_traces():
    """23a's two subprocesses: ``launch.dryrun`` over DRYRUN_ARCH's cells on
    the single production mesh, with fake tensors on the card's device type
    and on the CPU; each writes its artifacts under its own tag."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    procs = {}
    for tag, dev in (("__smoke_card", torch.device(DEV).type), ("__smoke_cpu", "cpu")):
        procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
             "--mesh", "single", "--force", "--device", dev, "--tag", tag],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def check_dryrun_traces(procs, card_name) -> dict:
    """23a: both traces of every cell agree in every count; the roofline
    rows (one H100's published peaks) and the trace seconds."""
    from benchmarks import torch_roofline
    recs = {}
    for tag, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        for line in out.splitlines():
            log(f"  [{tag}] {line}")
        assert proc.returncode == 0, (tag, proc.returncode)
        recs[tag] = {}
        for c in cells_for(DRYRUN_ARCH):
            path = dryrun.ART_DIR / f"{DRYRUN_ARCH}__{c.name}__single{tag}.json"
            recs[tag][c.name] = json.loads(path.read_text())
            path.unlink()
    card_tag, cpu_tag = list(procs)
    rows = {}
    for cell, rec in recs[card_tag].items():
        other = recs[cpu_tag][cell]
        for key in ("flops", "bytes_accessed", "collectives", "memory"):
            assert rec[key] == other[key], (cell, key, rec[key], other[key])
        row = torch_roofline.analyse(rec)
        rows[cell] = {k: row[k] for k in ("compute_s", "memory_s", "collective_s",
                                          "dominant", "useful_ratio", "roofline_frac")}
        rows[cell].update(trace_s={card_tag: rec["trace_s"], cpu_tag: other["trace_s"]},
                          flops=rec["flops"], bytes=rec["bytes_accessed"],
                          collective_bytes=rec["collectives"]["total"],
                          argument_gib=rec["memory"]["argument_bytes"] / 2 ** 30,
                          temp_gib=rec["memory"]["temp_bytes"] / 2 ** 30)
        log(f"  {DRYRUN_ARCH} {cell} on (data 16, model 16), fake {rec['device']} = fake "
            f"cpu in every count: FLOPs {rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e}, "
            f"collectives {rec['collectives']['total']:.4e} B; arguments "
            f"{rows[cell]['argument_gib']:.2f} GiB, temporaries {rows[cell]['temp_gib']:.2f} GiB "
            f"per rank; roofline compute {row['compute_s']:.4g} s, memory "
            f"{row['memory_s']:.4g} s, collective {row['collective_s']:.4g} s: "
            f"{row['dominant']}; traced in {rec['trace_s']} / {other['trace_s']} s")
    log(f"  roofline priced at {torch_roofline.header()}; the card here: {card_name}")
    return rows


def dryrun_predictions(device) -> dict:
    """23b's one-rank predictions: each cell of DRYRUN_CELLS, DRYRUN_REAL
    applied, traced on a fake (1, 1) mesh at batch 1, 2, 4, ... until the
    predicted peak passes DRYRUN_BUDGET (prefill at batch 1 only)."""
    import torch.distributed as dist
    out = {}
    for name, cell in DRYRUN_CELLS.items():
        b = 1
        while True:
            mesh = make_fake_mesh((1, 1), ("data", "model"), device)
            try:
                rec = dryrun.trace_step(DRYRUN_ARCH, dataclasses.replace(cell, global_batch=b),
                                        mesh, overrides=DRYRUN_REAL, device=device)
            finally:
                dist.destroy_process_group()
            rec["peak_bytes"] = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
            out.setdefault(name, {})[b] = rec
            if cell.kind == "prefill" or rec["peak_bytes"] > DRYRUN_BUDGET:
                break
            b *= 2
    return out


def pick_batch(preds: dict, card_bytes: int):
    """The largest batch predicted at most DRYRUN_BUDGET, else batch 1 if it
    fits DRYRUN_CARD_SHARE of the card, else None."""
    fits = [b for b, r in preds.items() if r["peak_bytes"] <= DRYRUN_BUDGET]
    if fits:
        return max(fits)
    return 1 if preds[1]["peak_bytes"] <= DRYRUN_CARD_SHARE * card_bytes else None


def check_dryrun_real(preds, card_name) -> dict:
    """23b: each cell run for real on a one-rank NCCL host mesh at the batch
    its prediction picks, against that prediction."""
    from benchmarks import torch_roofline
    from torch.utils.flop_counter import FlopCounterMode
    import torch.distributed as dist
    mesh = make_host_mesh(DEV)
    assert dist.get_backend() == BACKENDS[torch.device(DEV).type], dist.get_backend()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    peak_flops = torch_roofline.PEAKS[get_config(DRYRUN_ARCH).dtype]
    out = {}
    for name, cell in DRYRUN_CELLS.items():
        b = pick_batch(preds[name], card_bytes)
        for bb, r in preds[name].items():
            log(f"  {name} batch {bb}: predicted peak {r['peak_bytes'] / 1e9:.2f} GB (arguments "
                f"{r['memory']['argument_bytes'] / 1e9:.2f} GB), FLOPs {r['flops']:.4e}, "
                f"bytes {r['bytes_accessed']:.4e}")
        if b is None:
            log(f"  {name}: not run; batch 1 is predicted at "
                f"{preds[name][1]['peak_bytes'] / 1e9:.2f} GB, past "
                f"{DRYRUN_CARD_SHARE:.0%} of the card's {card_bytes / 1e9:.2f} GB")
            out[name] = {"run": False, "predicted_peak_gb": preds[name][1]["peak_bytes"] / 1e9}
            continue
        pred = preds[name][b]
        free_memory()
        reset_launches()
        base = torch.cuda.memory_allocated()
        fn, args = dryrun.build_cell(DRYRUN_ARCH, dataclasses.replace(cell, global_batch=b),
                                     mesh, overrides=DRYRUN_REAL, device=DEV)
        inputs = dryrun.local_tensors(args)
        for x in inputs:
            x.zero_()                            # valid tokens; values do not change the counts
        arg_bytes = dryrun.storage_bytes(inputs)
        assert arg_bytes == pred["memory"]["argument_bytes"], (name, arg_bytes, pred["memory"])
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            res = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert fc.get_total_flops() == pred["flops"], (name, fc.get_total_flops(), pred["flops"])
        assert all(torch.isfinite(x).all() for x in dryrun.local_tensors(res)
                   if x.is_floating_point())
        del res
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*args)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            del res
        launches = {"flash_decode": decode_attn.LAUNCHES["flash_decode"],
                    "lowrank_flash": lowrank_flash.LAUNCHES["lowrank_flash"]}
        assert launches == {"flash_decode": 0, "lowrank_flash": 0}, launches
        terms = {"compute_ms": pred["flops"] / peak_flops * 1e3,
                 "memory_ms": pred["bytes_accessed"] / torch_roofline.HBM_BW * 1e3}
        bound = max(terms.values())
        med = statistics.median(ms)
        out[name] = {"run": True, "batch": b, "flops": pred["flops"],
                     "argument_bytes": arg_bytes, "allocated_bytes": allocated,
                     "predicted_peak_bytes": pred["peak_bytes"], "max_memory_allocated": peak,
                     "peak_ratio": peak / pred["peak_bytes"], "ms": ms, "median_ms": med,
                     **terms, "bound_ms": bound, "share_of_bound": bound / med}
        log(f"  {DRYRUN_ARCH} x {DRYRUN_REAL['num_layers']} layers {name} at batch {b}, one "
            f"NCCL rank: FLOPs {fc.get_total_flops():.4e} = predicted; inputs {arg_bytes / 1e9:.3f}"
            f" GB = predicted ({allocated / 1e9:.3f} GB allocated); peak "
            f"{peak / 1e9:.2f} GB against {pred['peak_bytes'] / 1e9:.2f} GB predicted (ratio "
            f"{peak / pred['peak_bytes']:.4f}); step {[round(t, 2) for t in ms]} ms, median "
            f"{med:.2f} ms against the eager, unfused program's {max(terms, key=terms.get)[:-3]} "
            f"bound of {bound:.2f} ms ({bound / med:.1%} of it) [{card_name}]")
        del fn, args, inputs
    return out


def check_dryrun(card_name) -> dict:
    """Phase 23: 23a's traces in two subprocesses while 23b's predictions
    run here; then 23b's real steps, once the subprocesses are done."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    procs = start_dryrun_traces()
    try:
        preds = dryrun_predictions(torch.device(DEV).type)
        traces = check_dryrun_traces(procs, card_name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_traces = time.perf_counter() - t0
    phase("  the one-rank steps run for real")
    real = check_dryrun_real(preds, card_name)
    dist.destroy_process_group()
    log("phase 23 numbers: " + json.dumps({
        "production_mesh": traces, "real": real, "traces_s": t_traces, "card": card_name}))
    return {"traces": traces, "real": real}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    log(card_name)
    phase(f"[1/23] card and build: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    sources = ["decode_attn", "decode_attn_bf16", "lowrank_flash", "lowrank_flash_bf16",
               "lowrank_flash_bwd", "lowrank_flash_bwd_bf16"]
    secs = build.build(sources)
    for name in sources:
        log(f"  built {name}.cu in {secs[name]:.1f} s")
        for line in ptxas_summary(build.build_log.get(name, (0, ""))[1]):
            log("  ptxas: " + line)
    for name, opcode, what in (("lowrank_flash_bf16", "HGMMA", "wgmma"),
                               ("decode_attn_bf16", "HMMA", "mma.sync"),
                               ("lowrank_flash_bwd", "HMMA", "mma.sync"),
                               ("lowrank_flash_bwd_bf16", "HGMMA", "wgmma")):
        n = sass_count(name, opcode)
        if n == 0:
            raise AssertionError(f"{name}.cu's SASS holds no {opcode} ({what}) instruction")
        log(f"  sass: {name}.cu holds {n} {opcode} ({what}) instructions")
    bwd_bf16_ptxas = check_bwd_bf16_build(secs["lowrank_flash_bwd_bf16"])

    phase("[2/23] flash_decode kernel vs its plain version on the card")
    max_err = check_kernel()
    bf16_decode_p = check_bf16_decode_p_case()

    phase("[3/23] full-width drrl-paper serving through Engine, kernel on")
    cfg = get_config("drrl-paper").with_(
        rank=RankConfig(mode="adaptive", rank_grid=GRID, segment_len=32))
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    log(f"  seeded init of {sum(p.numel() for p in tu.leaves(params)) / 1e6:.1f} M "
        f"parameters in {time.perf_counter() - t0:.1f} s")
    outs, launches, st_adaptive = check_serving(cfg, params, "adaptive", card_name)
    outs_f, _, st_f = check_serving(cfg, params, "adaptive, factor cache", card_name,
                                    factor_cache=True)
    agree = np.mean([np.mean(a == b) for a, b in zip(outs, outs_f)])
    log(f"  factor cache vs dense K read: {agree:.3f} of greedy tokens equal")
    fixed = cfg.with_(rank=RankConfig(mode="fixed", rank_grid=GRID, fixed_rank=32,
                                      segment_len=32))
    check_serving(fixed, params, "fixed rank 32", card_name)
    check_small_reference()

    phase("[4/23] full-width engine step: kernel vs plain attention")
    check_engine_step(cfg, params)

    phase("[5/23] times at the serving shapes")
    t_dec = time_kernel(MAIN_DECODE, card_name)
    t_chunk = time_kernel(MAIN_CHUNK, card_name)
    t_draft = time_kernel(MAIN_DRAFT, card_name)
    t_verify = time_kernel(MAIN_VERIFY, card_name)
    profile_serving(cfg, params, card_name, st_adaptive["decode_s"])

    phase("[6/23] lowrank_flash kernel vs its plain version on the card; its backward")
    flash_err = check_flash()
    bf16_p = check_bf16_p_case()
    bwd_err = check_flash_bwd()
    phase("  the bf16 backward")
    bwd_bf16_err = check_flash_bwd_bf16()

    phase("[7/23] full-width forward_dense(chunked=True), 2 x 4096 tokens")
    flash_launches = check_forward(cfg, params, card_name)

    phase("[8/23] one-shot serving (prefill_chunk=None) vs the chunked run")
    check_oneshot(cfg, params, outs, card_name)

    phase("[9/23] lowrank_flash times at the forward shapes, its backward's; the forwards "
          "by layer")
    t_flash = time_flash(PATH_MASKED, "masked r=64, dv=64", card_name)
    t_static = time_flash(PATH_STATIC, "static r=32, dv=64", card_name)
    t_bwd = time_flash_bwd(PATH_MASKED, "masked r=64, dv=64", card_name)
    t_bwd_static = time_flash_bwd(PATH_STATIC, "static r=32, dv=64", card_name)
    t_bwd_bf16 = {label: time_flash_bwd(case, label, card_name, torch.bfloat16)
                  for label, case in (("qwen2.5-14b off r=dv=128", QWEN_TRAIN),
                                      ("qwen2.5-14b static r=32, dv=128", QWEN_TRAIN_STATIC),
                                      ("qwen2-vl-7b r=dv=128", VL_TRAIN))}
    free_memory()
    profile_forwards(cfg, params, card_name)

    # drrl-paper's own config: rank mode 'drrl', masked, grid 16..64
    paper = get_config("drrl-paper")
    agent = drrl.init_agent(torch.Generator(device=DEV).manual_seed(7), paper.rank,
                            paper.d_model, device=DEV)
    phase("[10/23] full-width forward_dense(chunked=True) in rank mode 'drrl', "
          "2 x 4096 tokens")
    drrl_flash = check_drrl_forward(paper, params, agent, card_name)

    phase("[11/23] full-width drrl-paper serving in rank mode 'drrl', kernel on")
    drrl_decode = check_drrl_serving(paper, params, agent, card_name)

    phase("[12/23] the agent's training at full width: BC from the greedy oracle, then PPO")
    train_flash = check_training(paper, params, agent, card_name)

    phase("[13/23] full-width sampled serving: adaptive (run A), random with the drift "
          "trigger and cancels (run B)")
    sampled_decode, tail_ms, run_a = check_sampled_serving(cfg, params, outs, st_adaptive,
                                                          card_name)
    tail = sampling_tail_ms(card_name)
    phase("  run B")
    random_decode = check_sampled_random(cfg, params, card_name)
    check_prng_card()
    phase("  reduced sampled run, card vs CPU")
    check_sampled_reference()

    phase("[14/23] full-width forwards of the comparison set (2 x 4096) and the "
          "rank-r cache")
    comp = check_comparison_forwards(cfg, params, card_name)
    lr_ms = check_lowrank_cache(cfg, params, card_name)
    log("phases 13-14 times: " + json.dumps({
        "sampling_tail_ms": {"per_step_profiled": tail_ms, **tail},
        "comparison_forward_ms": comp["walls"], "lowrank_cache_decode_ms": lr_ms,
        "card": card_name}))

    phase("[15/23] full-width speculative decoding and the prefix cache")
    spec = check_spec_serving(cfg, params, outs_f, st_f, card_name)
    phase("  speculative, sampled")
    spec_sampled = check_spec_sampled(cfg, params, run_a, card_name)
    phase("  the prefix cache")
    prefix, prefix_cold, prefix_rerun = check_prefix_serving(cfg, params, card_name)
    phase("  reduced speculative and prefix runs, card vs CPU")
    check_spec_prefix_reference()
    log("phase 15 numbers: " + json.dumps({
        "speculative": spec, "speculative_sampled": spec_sampled, "prefix": prefix,
        "card": card_name}))

    phase("[16/23] the serving front end at full width: traces, the learned policy, "
          "FrontEnd, Router")
    out = os.path.join(ROOT, ".scratch", "phase16")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    traced = check_trace_recording(cfg, params, out, card_name)
    phase("  the serving policy trained on the card")
    trained = check_policy_training(cfg, out, card_name)
    phase("  learned serving through a FrontEnd")
    learned = check_learned_frontend(cfg, params, os.path.join(out, "policy"), st_f,
                                     card_name)
    phase("  Router, 2 replicas on the card")
    routed = check_router(cfg, params, prefix_cold, prefix_rerun, card_name)
    phase("  flight dump on a step error; the CLI; the reduced model card vs CPU")
    check_flight_dump(cfg, params, out)
    cli = check_cli(card_name)
    check_front_reference(out)
    log("phase 16 numbers: " + json.dumps({
        "traced": traced, "trained": trained, "learned_frontend": learned,
        "router": routed, "cli": cli, "card": card_name}))

    phase("[17/23] the LM training stack at full width")
    lm = check_lm_training(paper, agent, card_name)

    phase("[18/23] the paper's tables and figures")
    tables = check_tables(paper, agent, card_name)

    phase("[19/23] the invariant checker: the static pass, the runtime sanitizer at "
          "full width, its negative control, the serving run's sync sites")
    sanitizer_launches = check_invariants(cfg, params, card_name)

    del params
    free_memory()
    phase("[20/23] the dense configs and the MoE family at full width: qwen2.5-14b and "
          "granite served, qwen2.5-14b trained in bf16 through the flash branch, internlm2, "
          "phi3, deepseek-coder cut in depth, DeepSeek-V3 with MLA and MTP")
    fam = check_families(card_name)

    phase("[21/23] the remaining families at full width: zamba2-7b (Mamba2 and the shared "
          "attention), rwkv6-1.6b, seamless-m4t-medium, qwen2-vl-7b (M-RoPE)")
    rec = check_recurrent_families(card_name)

    free_memory()
    phase("[22/23] distribution on the card, a one-rank NCCL group: the sharded training "
          "step, the checkpoint round trip, ring attention and the pipeline, the CLI")
    dist_out = check_distribution(paper, agent, card_name)
    import torch.distributed as dist
    dist.destroy_process_group()

    free_memory()
    phase("[23/23] the dry run: qwen2.5-14b's cells on the (16, 16) production mesh, fake "
          "'cuda' against fake 'cpu'; 2-layer steps on one NCCL rank against their "
          "predictions")
    check_dryrun(card_name)

    phase("all phases passed")
    print(json.dumps({"kernels": [
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "bf16_source": "src/repro_torch/kernels/csrc/decode_attn_bf16.cu",
         "replaces": "src/repro/kernels/decode_attn.py:122",
         "launches": launches, "drrl_launches": drrl_decode,
         "sampled_launches": sampled_decode, "random_drift_launches": random_decode,
         "spec_launches": spec["launches"],
         "spec_launches_per_step": spec["launches_per_spec_step"],
         "prefix_spec_launches": prefix["prefix_launches"],
         "front_launches": {"traced": traced["launches"], "learned": learned["launches"],
                            "router": {k: v["launches"] for k, v in routed.items()}},
         "max_abs_err": max_err, **t_dec, "chunk": t_chunk, "draft": t_draft,
         "verify": t_verify,
         "train_lm_launches": {"train_step": lm["step_launches"]["flash_decode"],
                               "serve_trained": lm["serve_launches"]},
         "distribution_launches": dist_out["launches"]["flash_decode"],
         "tables_launches": tables["flash_decode"],
         "sanitizer_launches": sanitizer_launches,
         "families_launches": {
             "qwen2.5-14b": {m: fam["qwen_serving"][m]["launches"] for m in ("off", "adaptive")},
             "granite": fam["granite"]["launches"],
             "granite_guarded": fam["granite"]["sanitizer"]["launches"]},
         "bf16_times": {label: {key: t[key] for key in BF16_DECODE_TIME_KEYS}
                        for label, t in fam["kernels"]["times"]["flash_decode"].items()},
         "bf16_p_case": bf16_decode_p,
         "families": fam["kernels"]["times"]["flash_decode"],
         "families_max_abs_err": fam["kernels"]["max_abs_err"]["flash_decode"],
         "recurrent_decode_launches": {
             "zamba2-7b": rec["zamba2"]["decode_launches"]["flash_decode"],
             "qwen2-vl-7b": rec["qwen2_vl"]["decode"]["launches"]["flash_decode"]},
         "one_query": rec["kernels"]["one_query"]},
        {"name": "lowrank_flash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lowrank_flash.cu",
         "bf16_source": "src/repro_torch/kernels/csrc/lowrank_flash_bf16.cu",
         "replaces": "src/repro/kernels/lowrank_flash.py:82",
         "launches": flash_launches, "drrl_launches": drrl_flash,
         "train_launches": train_flash, "random_launches": comp["launches"],
         "train_lm_launches": {"train_step": lm["step_launches"]["lowrank_flash"]},
         "distribution_launches": dist_out["launches"]["lowrank_flash"],
         "tables_launches": tables["lowrank_flash"],
         "families_launches": {"qwen2.5-14b": {k: v["launches"]
                                               for k, v in fam["qwen_forward"].items()},
                               "deepseek-v3": fam["deepseek"]["launches"]},
         "recurrent_families_launches": {
             "zamba2-7b": {"off": rec["zamba2"]["off"]["launches"],
                           "adaptive_fidelity": rec["zamba2"]["adaptive"]["launches"],
                           "prefill": rec["zamba2"]["decode_launches"]["lowrank_flash"]},
             "rwkv6-1.6b": rec["rwkv6"]["launches"],
             "seamless-m4t-medium": rec["seamless"]["launches"],
             "qwen2-vl-7b": {"forward": rec["qwen2_vl"]["launches"],
                             "prompt": rec["qwen2_vl"]["decode"]["launches"]["lowrank_flash"]}},
         "max_abs_err": flash_err, **t_flash, "r32": t_static,
         "backward_source": "src/repro_torch/kernels/csrc/lowrank_flash_bwd.cu",
         "backward_launches": {
             "chunked_train_step": lm["chunked"]["launches_per_step"]["lowrank_flash_bwd"],
             "chunked_train_steps": sum(h["launches"]["lowrank_flash_bwd"]
                                        for h in lm["chunked"]["steps"]),
             "chunked_train_forward": sum(h["launches"]["lowrank_flash"]
                                          for h in lm["chunked"]["steps"]),
             "chunked_train_step_remat": {r: m["launches"]
                                          for r, m in lm["chunked"]["remat"].items()}},
         "backward_max_abs_err": bwd_err["max_abs_err"],
         "backward_max_scaled_err": bwd_err["max_scaled_err"],
         "backward": t_bwd, "backward_r32": t_bwd_static,
         "bf16_backward_source": "src/repro_torch/kernels/csrc/lowrank_flash_bwd_bf16.cu",
         "bf16_backward_launches": {
             mode: {"remat": res["remat"],
                    "train_step": res["launches_per_step"]["lowrank_flash_bwd"],
                    "train_steps": sum(h["launches"]["lowrank_flash_bwd"] for h in res["steps"]),
                    "train_forward": sum(h["launches"]["lowrank_flash"] for h in res["steps"]),
                    **({"remat_none_step": res["remat_none_step"]["launches"]}
                       if "remat_none_step" in res else {})}
             for mode, res in fam["qwen_bf16_training"].items()},
         "bf16_backward_max_abs_err": bwd_bf16_err["max_abs_err"],
         "bf16_backward_max_err_over_tol": bwd_bf16_err["max_err_over_tol"],
         "bf16_backward_over_tol_by_case": bwd_bf16_err["over_tol_by_case"],
         "bf16_backward_ptxas": bwd_bf16_ptxas,
         "bf16_backward": t_bwd_bf16,
         "bf16_times": {label: {key: t[key] for key in BF16_TIME_KEYS}
                        for label, t in {**fam["kernels"]["times"]["lowrank_flash"],
                                         **rec["kernels"]["times"]}.items()},
         "bf16_p_case": bf16_p,
         "families": fam["kernels"]["times"]["lowrank_flash"],
         "families_max_abs_err": fam["kernels"]["max_abs_err"]["lowrank_flash"],
         "recurrent_families": rec["kernels"]["times"],
         "recurrent_families_max_abs_err": rec["kernels"]["max_abs_err"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
