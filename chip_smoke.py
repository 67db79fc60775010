#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --periodic-ab OLD/flit_sim.cu [OTHER.cu ...]
    python3 chip_smoke.py --traces
    python3 chip_smoke.py --streaming
    python3 chip_smoke.py --training
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --stream-sharded
    python3 chip_smoke.py --decode-attention

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

1. card: print ``nvidia-smi``'s name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, bitwise (``torch.equal``), with CUDA-event timings of both: the
   flit-simulator kernels at the design-space paths' shapes and at about
   2^20 cells (the one-chunk kernels chunk by chunk over a run, timed one
   call and on the card; the run kernels ``symmetric_run`` and
   ``pipelining_run``, whole adaptive runs in one launch, against the
   plain run's state rows, first converged chunks and exit chunk, and the
   periodic detectors ``asymmetric_periodic`` and ``symmetric_periodic``,
   timed one call, back to back and on the card beside their bounds;
   ptxas's registers, stack frame and spills of every flit kernel logged,
   a spill fatal, and a stack frame of a periodic detector too; the run
   kernels' two reciprocal divisions against the IEEE
   quotient over all 2^46 pairs of f32 significands each, about 2 min,
   run while the mesh phases' ranks share the card),
   ``pack_flits`` at 64, 2^16 and 2^20 lines with the unpack round trip
   (timed one call, back to back and on the card); the trace scans
   ``symmetric_trace`` and ``asymmetric_trace`` (port kernels with no TPU
   counterpart) at the serving frontier's shape (9 traces x 6 phases,
   2048 and 4096 cycles a phase), at one phase (189 and 126 cells, also
   against the fixed engine's static cells), at ragged phase counts from
   ``pad_traces``, at ~2^20 cells of 6 phases and at a streamed chunk's
   shape (4096 cells x 3 and 2 protocols, one phase of 64 cycles: the
   per-cell fixed-horizon runner), bitwise, each timed one
   call, back to back and on the card beside its bound and a logged
   chain-latency estimate, the plain version timed once at each shape;
4. main path, each path driven with the launch counts set to 0 just
   before it and read just after:

   a. the explorer's ``--bridge`` run on the card at full width, its
      summary held against the whole of
      ``experiments/golden/design_space_summary.json`` (``asymmetric_periodic``,
      ``symmetric_run``: one launch per adaptive symmetric run, each
      runner's ``elapsed_s`` logged; the serving section exactly one
      ``symmetric_trace`` and one ``asymmetric_trace`` launch, its wall
      logged, and once more with the plain trace cores on the card);
   a'. the serving frontier alone, the card's run against the CPU's:
      winner labels equal, ``trace_efficiency`` and the winners' GB/s
      within 1e-6;
   b. a shallow-queue design space (backlogs 1, 2, 4 x 21 read
      fractions; ``symmetric_periodic``), its detected cells held bitwise
      against the fixed engine;
   c. the Fig-13 pipelining design space (k 1..8 x 2 link UIs x 3 device
      UIs; ``pipelining_run``, one launch) against the same space on the
      CPU and the
      card's fixed engine, and ``simulate_lpddr6_pipelining(4)`` = 1;
   d. the explorer's ``--sweep`` on the card against the CPU
      (``symmetric_run``, ``asymmetric_periodic``);
   e. the quickstart's values on the card against the CPU;
   f. the Fig 8/9 flit data path: 2^16 lines packed (``pack_flits``) and
      unpacked, every line, header and checksum back;
   f'. streamed evaluation: the reference's ``joint_1e7`` space (2500
      ``g_slots`` scales x 4 PHYs x 25 backlogs x 41 read fractions,
      64-cycle horizons: 2,562,500 stream cells, 10,250,000 joint cells)
      streamed as ``sim_bandwidth_gbs`` in 4096-cell chunks at prefetch 2
      and 1: 16384 joint cells a chunk, one ``symmetric_trace`` and one
      ``asymmetric_trace`` launch a dispatch and no call of the eager
      per-cycle cores; winners, win counts and bests bitwise equal to the
      card's materialized fixed engine; wall, dispatches, overlap and
      peak memory (streamed and materialized) logged; then a
      ``catalog_param x phy x read_fraction x shoreline_mm`` evaluation
      and a ``protocol_param`` space under ADAPTIVE_SIM against the CPU
      (labels equal, numbers within 1e-6), ``sweep_perturbed`` under
      ADAPTIVE_SIM against FIXED_SIM (1e-3) and a constrained analytic
      stream against the materialized frontier;
   g. LM serving (``flash_attention_fwd``, ``rglru_scan``): the launcher
      refusing recurrentgemma-2b at its default ``--max-len 128`` (below
      the window: R4), the launcher
      with recurrentgemma-2b at full width (8 requests, 4 slots, 16 new
      tokens, ``--max-len 2048``); an engine run of recurrentgemma-2b with
      4 prompts of 2100-2400 tokens (``max_len`` 2560, 8 new tokens), where
      the local window and the ring caches bite; the launcher with
      smollm-360m at full width; each with the launches asserted (8
      ``flash_attention_fwd`` and 18 ``rglru_scan`` per recurrentgemma-2b
      prefill, 32 ``flash_attention_fwd`` per smollm-360m prefill, none per
      decode step, whose ``decode_attention`` calls come in whole ticks of
      one a layer with a KV cache); mamba2-2.7b at full width and depth (64 layers,
      2,832,074,240 parameters; ``ssd_scan``): the launcher (8 requests,
      4 slots, 16 new tokens, ``--max-len 128``) and an engine run with 4
      prompts of 2000-2400 tokens, at least two not a multiple of the
      256-step chunk (``max_len`` 2560, 8 new tokens), 64 ``ssd_scan``
      launches per prefill and none per decode step; the long-prompt runs
      decoded again one request at a time against a longer prefill
      (greedy tokens equal except at near ties; the logits within the bf16
      bound, mamba2-2.7b's 64 layers within 1e-3 of the largest logit in
      f32 compute, its bf16 share reported); then
      the three models at full width and reduced depth (3, 2 and 2
      layers, weights from one seed) on the card against the same model
      on the CPU, prompts of 40 and 300 tokens, prefill and teacher-forced
      decode logits within the bf16 tolerance and greedy tokens equal
      except at near ties;
   h. the moe, vision and enc-dec families (``flash_attention_fwd``):
      olmoe-1b-7b at full width and depth (16 layers, 6,919,096,320
      parameters, 6,919,620,608 with the padded vocabulary, 64 experts
      top-8): the launcher (8 requests of 4-11
      tokens, 4 slots, 16 new tokens) and an engine run with 4 prompts of
      2000-2400 tokens (``max_len`` 2560, 8 new tokens), 16
      ``flash_attention_fwd`` launches per prefill and none per decode
      step (16 ``decode_attention`` calls a tick), the share of (token, choice) pairs each prefill's capacity
      drops logged; its long prompts decoded again one request at a time
      with capacity factor 8 (no drops: the reference's own test's factor)
      against a longer prefill; internvl2-1b (256 patch embeddings + 40
      tokens, 24 launches) and seamless-m4t-large-v2 (1000 frames + 40
      tokens, 72 launches: encoder, decoder and cross attention) at full
      depth through ``Model``, a prefill and 8 decode steps each; then the
      four models at full width on the card against the CPU
      (olmoe-1b-7b 2 layers, llama4-scout-17b-a16e 1 layer, internvl2-1b 2
      layers with 256 patch embeddings, seamless-m4t-large-v2 2 + 2 layers
      with 37 and 1000 frames), each MoE layer's expert choices recorded
      on both: the smallest k-th/(k+1)-th probability gap and the tokens
      whose experts differ logged per layer; a row past the bf16 bound is
      held again with the CPU on the card's experts, where they differ
      only at near ties;
   i. training (``flash_attention_fwd``, ``rglru_scan``, ``ssd_scan`` in
      a training step's forward, each through its
      ``torch.autograd.Function``): one step (loss and every gradient) at
      full width on one ``SyntheticLM`` batch for smollm-360m (2 layers,
      2 x 256 tokens), recurrentgemma-2b (3 layers, one whole rec, rec,
      attn pattern, 2 x 2048 on the card, and 2 x 256 against the CPU),
      mamba2-2.7b (2 layers, 2 x 2048) and olmoe-1b-7b (2 layers, 2 x 256;
      the CPU on the card's expert choices), on the card against the CPU: every leaf's gradient finite
      and non-zero on the card, the loss within 8 bf16 epsilons of the
      CPU's and each leaf within 16 of its largest CPU magnitude (the
      bounds ``tests/test_torch_train.py`` holds against the reference),
      the launches of a forward and of a rematerialized step exact; each
      Function's gradients against autograd of its plain version at those
      shapes (f32 within 1e-5 of the largest gradient), its kernel forward,
      its backward and the plain forward + backward timed; the training
      launcher at full width and depth (smollm-360m, 12 steps of 8 x 512
      tokens, a checkpoint every 4, a failure at step 6): one restart, the
      loss falling, the replayed steps' losses against the first pass's
      bitwise (where not, the gather and matmul backwards run twice on the
      same inputs to name the op), median step wall, tokens/s and peak
      memory; ``torch.profiler`` over one such step: kernel ms by kind and
      the idle share;
   j. the multi-device path (``flash_attention_fwd`` and ``rglru_scan`` on
      each rank's local shards): four ranks, NCCL with a card each, else
      gloo with every collective staged through host memory (the backend
      and the transport logged); the training launcher at full width and
      depth on a (2, 2) mesh (smollm-360m, 4 steps of 8 x 512 tokens, a
      checkpoint every 2, a failure at step 3: one restart, the replayed
      losses bitwise, the launches of a step exact on each rank); its last
      checkpoint restored onto one card and onto a (4, 1) mesh, every leaf
      bitwise; then one sharded step at full width of smollm-360m (2
      layers, the query-sequence attention branch) and olmoe-1b-7b (2
      layers, capacity factor 8: the KV-heads branch and the
      expert-parallel MoE) on (2, 2) and recurrentgemma-2b (3 layers) on
      (4, 1), 2 x 256 tokens a rank, against one card's step from the same
      draw (the loss within 8 bf16 epsilons, each gathered gradient leaf
      within 16 of its largest magnitude, the parameters after the step
      within 5e-2; each rank's blocks equal to the spec's slices of the
      whole leaves bitwise, its launches exact), that step timed: its
      wall, peak GiB and collective bytes a rank;
   k. every family under a mesh (the three LM kernels on each rank's
      block): the kernels at the rank-local shapes held against their
      plain versions and timed beside their bounds; four ranks as in j;
      (k1) one sharded training step at full width, 2 x 256 tokens a rank,
      against one card's at j's bounds: recurrentgemma-2b (3 layers) on
      (1, 4), its ranks cutting the 256-channel gate heads and taking the
      query-row attention branch; mamba2-2.7b (2 layers) on (2, 2), the
      fused ``in_proj`` cut inside ``x`` and the SSD scan on 40 heads;
      internvl2-1b (2 layers) on (2, 2), 256 patch rows and the KV-head
      branch with ``qkv_bias``; seamless-m4t-large-v2 (2 + 2 layers) on
      (2, 2) with 1000 frames; (k2) a prefill (2 x 256 text tokens a data
      rank) and 8 teacher-forced decodes of smollm-360m, olmoe-1b-7b
      (capacity factor 8), recurrentgemma-2b, mamba2-2.7b, internvl2-1b
      and seamless-m4t-large-v2 (2-3 layers) under (2, 2) and (1, 4), the
      parameters in their 'model' blocks replicated over 'data' (the
      serving placement) and the caches as ``Model.cache_specs`` places
      them, against one card's run from the same draw: the logits and the
      caches gathered back within 8 bf16 epsilons of the largest value,
      every cache leaf replicated over 'model' bitwise equal on every rank
      after every step, the launches a prefill exact and none a decode;
      (k3) ``ServingEngine(ctx=)`` under (1, 4): recurrentgemma-2b at full
      width and depth, max_len 2048, the reference launcher's 8 requests
      of 4-11 tokens, 4 slots, 16 new tokens: tok/s, peak GiB a rank, the
      collective bytes and calls a tick, the launches a rank a prefill
      (exact), the tokens every rank picked (equal), and the tokens that
      differ from one card's engine on the same weights with the first
      difference's top-2 logit gap (a measurement);
   l. the dry run and sequence parallelism: (l1) seven dry-run cells at
      full width and depth, traced in a subprocess a device (fake tensors
      on the card, and on the CPU, the two side by side while phases j
      and k run): olmoe-1b-7b train_4k, smollm-360m prefill_32k,
      recurrentgemma-2b long_500k, mamba2-2.7b decode_32k, internvl2-1b
      prefill_32k and seamless-m4t-large-v2 decode_32k on the 16 x 16
      mesh, and mistral-large-123b train_4k on 2 x 16 x 16 with sequence
      parallelism: each cell's trace wall, FLOPs, read and write bytes,
      collective bytes, dominant term and mix logged, the counts on the
      card equal to the CPU's exactly, no kernel launched and under 1 MiB
      of the card allocated by the tracing process;
      ``bridge_design_space`` over the seven reports on the card equal to
      the CPU's (labels exactly, numbers within 1e-6), and
      ``joint_frontier`` and ``serving_frontier`` on the card with their
      kernels' launches counted; (l2) in phase j's world, k1's four
      sharded steps again with ``sequence_parallel`` on, against one
      card's step at the loss and gradient bounds (rank 0's one-card
      steps of k1 reused; no timed warm step), and internvl2-1b's k2
      prefill and
      decodes under (1, 4) with it on at the serving bound; per rank the
      residual stream's bytes, collective bytes and calls and the kernels'
      launches logged beside k1's steps without it;
   m. the sharded stream (``symmetric_trace``, ``asymmetric_trace``), in
      phase j's world after k: each of the four ranks streams f''s
      ``joint_1e7`` space with ``StreamConfig(devices=4)`` on its card
      (slot r of every 16384-cell window: 157 dispatches a rank, 9,788
      padded cells, 16,384 joint cells a chunk), the launch counts set to
      0 just before it and read just after: one launch of each trace
      kernel a dispatch of the rank and no eager per-cycle core; its
      winners, win counts and bests (one end-of-stream all-reduce and
      all-gather) bitwise equal on every rank to f''s one-card stream
      (compared as digests: a SHA-256 of the winner codes, the counts,
      the bests' hex); f''s constrained catalog stream at ``devices=4``
      bitwise against the rank's one-card stream of it, ``(none)``
      included; each rank's wall, marshal, overlap, dispatches, peak
      GiB, the reduction's wall and bytes and its transport logged;

   The RG-LRU scan is held bitwise against its plain version in phase 3
   (it keeps the plain version's order) at nine cases (the serving
   shapes, a ragged tile, C % 4 != 0, C below a block's width, one step,
   a view not 16-byte aligned), with ptxas's registers and spills (a
   spill fails the run), and one-call, back-to-back and on-card times
   beside its bound.  The
   flash-attention kernel and the SSD scan are held
   against their plain versions in phase 3 to a tolerance (f32: atol
   3e-5, rtol 1e-4; bf16: atol 4e-3, rtol 2^-7, about one output ulp;
   the SSD scan: atol 5e-5, rtol 1e-4 at ``tests/test_kernels.py``'s
   shapes, 1e-4 of the largest |y| and |state| at mamba2-2.7b's), at
   ``tests/test_kernels.py``'s shapes and the serving runs' (attention in
   bf16 as served, and in f32; the SSD scan against its chunked form
   everywhere and the sequential oracle at the test shapes, the launcher
   prompt, a ragged 2100 steps and the cases at the edges of its 128-step
   chunk (1, 127, 128, 129 and 389 steps; N 16 and 32; P 80); some cases
   with step sizes as trained Mamba2 has them, so the state carried from
   chunk to chunk counts, and some from a given initial state, four rows
   of 300 steps with both), with ``scaled_dot_product_attention``
   timed beside the attention kernel as the library yardstick (not used
   by the port; with the same boolean mask, where it hides nothing also
   with none, and where the mask is plain causal also ``is_causal=True``
   on the flash backend, the fastest taken); the attention kernel's bf16
   serving shapes (those of the twelfth slice's families too: olmoe-1b-7b
   and llama4-scout at hd 128, internvl2-1b's 256 patches + text, and
   seamless-m4t-large-v2's non-causal encoder and cross attention, Sq !=
   Skv, at 37 and 1000 frames) timed with
   their share of the bound and TFLOP/s, and ptxas's registers and spills
   of every flash instance logged (a spill in the bf16 tensor-core kernel
   fails the run).  The decode-attention kernel (no TPU counterpart: it
   replaces the plain ``attend_decode``) at the two olmoe-1b-7b cells'
   tick shapes (32 slots of 2560 positions, 16 slots of 4160; 16 KV heads
   of 128; each slot's live positions drawn from the cell's mix), held
   within two bf16 ulps of the largest output of its plain version, timed
   one call, back to back and on the card (its three kernels summed)
   beside its bound (the live bf16 K and V read once), the plain version
   and ``scaled_dot_product_attention`` on the same mask; ptxas's
   registers and spills of each instance logged (a spill of a served
   instance, a group of one or two, fails the run);

5. report: one ``{"kernels": [...]}`` line, then the result line.

``--wrapper-ab PARENT_ROOT`` times the LM kernels' wrappers of another tree
(its ``src/repro_torch/kernels/*/ops.py``) and of this one, one call at the
launcher prompts, in turns, and prints one ``{"wrapper_ab": [...]}`` line
last.  ``--dryrun`` runs only phases 1-2 and l1, and prints one
``{"dryrun": {...}}`` line last.
``--dryrun-cells DEVICE DIR`` is l1's subprocess: it traces the cells on
``DEVICE``, writes their artifacts and a ``summary.json`` into ``DIR``,
and prints no result line.

``--training`` runs only phases 1-2 and the training phase (i), and prints
one ``{"training": {...}}`` line last; ``--mesh`` only phases 1-2 and the
multi-device phases (j, k, l2 and m), and one ``{"mesh": {...}}`` line
last; ``--stream-sharded`` only phases 1-2 and m, in a world of four
ranks of its own (f''s one-card stream run first in this process), and
one ``{"stream_sharded": {...}}`` line last.
``--periodic-ab`` runs only
phases 1-2 and the periodic detectors of
phase 3, for other ``flit_sim.cu`` files (a parent commit's, unpacked with
``git archive``) and this tree's in turns in one process, and prints one
``{"periodic_ab": [...]}`` line last.  ``--traces`` runs only phases 1-2
and the trace kernels of phase 3, and prints one ``{"traces": {...}}``
line last.  ``--streaming`` runs only phases 1-2 and the streamed and
perturbation phases of 4 (f'), and prints one ``{"streaming": {...}}``
line last.  ``--decode-attention`` runs only phases 1-2 (its library) and
the decode-attention kernel of phase 3, and prints one
``{"decode_attention": {...}}`` line last.
"""
import argparse
import concurrent.futures
import contextlib
import ctypes
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _build, explorer, quickstart  # noqa: E402
from repro_torch.configs import get as get_config  # noqa: E402
from repro_torch.core import flitsim  # noqa: E402
from repro_torch.core.selector import SelectionConstraints  # noqa: E402
from repro_torch.core.space import (  # noqa: E402
    ADAPTIVE_SIM, DesignSpace, StreamConfig, axis,
)
from repro_torch.core.ucie import (  # noqa: E402
    UCIE_A_32G_55U, UCIE_A_48G_45U, UCIE_S_32G, UCIE_S_48G_110U,
)
from repro_torch.explorer import bridge_mode, sweep_mode  # noqa: E402
from repro_torch.kernels.flit_pack import ops as pack_ops  # noqa: E402
from repro_torch.kernels.flit_pack import ref as pack_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flit_sim import kernel as flit_kernel  # noqa: E402
from repro_torch.kernels.flit_sim import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as lru_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as lru_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import routes  # noqa: E402
from repro_torch.models.routes import Routes  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402
from repro_torch.traces import (  # noqa: E402
    DEFAULT_MODELS, DEFAULT_QPS, ModelTrafficSpec, TrafficTrace, pad_traces,
    synthetic_serving_trace,
)

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: f32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: ... and dense TF32 operations/s of the tensor cores
PEAK_TF32_OPS_PER_S = 495e12
#: ... and dense bf16 operations/s of the tensor cores
PEAK_BF16_OPS_PER_S = 989e12
#: f32 operations of one cycle of the symmetric step (flitsim
#: _symmetric_stepfn: adds, multiplies, divisions, min/max, floor)
SYM_STEP_OPS = 51
#: ... and of one access of the asymmetric step
ASYM_STEP_OPS = 6
#: f32 operations of one line of the pipelining step as the kernel does it
#: (modulo 4, 8 compares and 8 selects to read the ready entry, max,
#: 2 adds, 8 selects to write it back, idx + 1)
PIPE_STEP_OPS = 32
#: rows of the pipelining chunk's operands that the function needs: params
#: 0-2, state 0-10 (ready table, link_free, idx, previous report), hist 0
#: (the T1 anchor), and the PIPE_ROWS rows it writes
PIPE_READ_ROWS = 3 + 11 + 1
#: ... and of its report / convergence epilogue
PIPE_REPORT_OPS = 20
#: f32 operations of the symmetric chunk's epilogue (report, drift,
#: convergence)
SYM_REPORT_OPS = 60
#: cycles of a symmetric step's critical path in the run kernel's SASS, at
#: nominal latencies, not measured: rdata -> credit_r -> rq_elig -> tot_q
#: -> its reciprocal -> sent_r -> resp -> g_resp -> rdata, 25 dependent
#: operations, 24 FADD/FMUL/FFMA/FMNMX at 4 cycles and one MUFU.RCP at
#: 16.  Only logged, as an estimate of the chain-latency bound of a run's
#: steps (the bound that ranks a grid too small to fill the card)
SYM_CHAIN_CYCLES = 24 * 4 + 16
#: ... and of the asymmetric step's loop-carried chain, at nominal
#: latencies, not measured: the credit's FADD, its SET and the FADD that
#: drops it, 3 dependent operations at 4 cycles
ASYM_CHAIN_CYCLES = 3 * 4
#: cycles a phase of the serving frontier's trace scans (each family's
#: static horizon)
TRACE_CYCLES = {"symmetric_trace": 2048, "asymmetric_trace": 4096}
#: f32 operations of a trace step beyond the plain step (the warm flag's
#: product and the two adds; the asymmetric step has none) and of each
#: phase's end (mix division, report)
TRACE_STEP_EXTRA = {"symmetric_trace": 3, "asymmetric_trace": 0}
TRACE_PHASE_OPS = 8
#: parameter rows each trace kernel reads, and phase rows a phase
TRACE_PARAM_ROWS = {"symmetric_trace": 11, "asymmetric_trace": 6}
TRACE_PHASE_ROWS = {"symmetric_trace": 3, "asymmetric_trace": 2}
#: the adaptive runs of the main path: horizon, chunk and tolerance
#: (ADAPTIVE_SIM at the flit simulators' default horizons)
SYM_RUN = dict(K=16, chunk=128, tol=1e-3)
PIPE_RUN = dict(K=8, chunk=64, tol=1e-3, n_lines=512)
DEV = torch.device("cuda")
F32 = torch.float32

SOURCES = {"symmetric_run": "src/repro_torch/csrc/flit_sim.cu",
           "asymmetric_periodic": "src/repro_torch/csrc/flit_sim.cu",
           "symmetric_periodic": "src/repro_torch/csrc/flit_sim.cu",
           "pipelining_run": "src/repro_torch/csrc/flit_sim.cu",
           "symmetric_trace": "src/repro_torch/csrc/flit_sim.cu",
           "asymmetric_trace": "src/repro_torch/csrc/flit_sim.cu",
           "pack_flits": "src/repro_torch/csrc/flit_pack.cu",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
           "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
           "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
           "decode_attention": "src/repro_torch/csrc/decode_attention.cu"}
REPLACES = {"symmetric_run": "src/repro/kernels/flit_sim/kernel.py:84",
            "asymmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:105",
            "symmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:127",
            "pipelining_run":
                "src/repro/kernels/flit_sim/kernel.py:152",
            # no TPU kernel: the reference's XLA trace-scan cores
            "symmetric_trace": "src/repro/core/flitsim.py:527",
            "asymmetric_trace": "src/repro/core/flitsim.py:561",
            "pack_flits": "src/repro/kernels/flit_pack/kernel.py:66",
            "flash_attention_fwd":
                "src/repro/kernels/flash_attention/kernel.py:93",
            "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:64",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:81",
            # no TPU kernel: the reference's plain attend_decode
            "decode_attention": "src/repro/models/attention.py:165"}
#: the Fig-13 design space of the main path (48 cells)
FIG13_KS = tuple(range(1, 9))
FIG13_US = (8.0, 16.0)
FIG13_DS = (16.0, 32.0, 64.0)
#: lines of the flit data path on the main path
PACK_MAIN_LINES = 1 << 16
#: the reference's streaming benchmark space ``joint_1e7``
#: (benchmarks/bench_streaming.py): 2500 g_slots scales x 4 PHYs x 25
#: backlogs x 41 read fractions, 64-cycle horizons, 4096 cells a chunk
JOINT_PERTS, JOINT_BACKLOGS, JOINT_MIXES = 2500, 25, 41
JOINT_CYCLES = 64
JOINT_CHUNK = 4096
JOINT_PHYS = (UCIE_S_32G, UCIE_A_32G_55U, UCIE_S_48G_110U, UCIE_A_48G_45U)


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Progress line with the seconds since start, flushed at once."""
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stream_ms(fn, calls: int = 10) -> float:
    """CUDA-event time of ``calls`` back-to-back ``fn()`` over ``calls``,
    ms: the host enqueues the next call while the card runs one, so a
    long call's time is the card's alone (``time_ms`` times one call on
    an idle card, the host's side of the call included)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def hold(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fail unless ``got`` equals ``want`` bitwise; returns max |diff|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got - want).abs().max().item() \
            if got.shape == want.shape else float("nan")
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max |diff| {diff})")
    return 0.0      # equal everywhere (an inf - inf would read NaN)


def close(name: str, got, want, atol: float) -> float:
    """Fail unless ``got`` is within ``atol`` of ``want`` everywhere;
    returns max |diff|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape} "
                             f"or non-finite values")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if err > atol:
        raise AssertionError(f"{name}: max |diff| {err} > {atol}")
    return err


# -- operands -----------------------------------------------------------------


def sym_rows(keys, fracs, backlogs) -> torch.Tensor:
    ps = flitsim.SymmetricFlitParams.stack(
        [flitsim.SYMMETRIC_PARAMS[k] for k in keys], DEV)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=F32, device=DEV)
    y = 100.0 - x
    return flitsim._sym_param_rows(
        ps, x, y, torch.as_tensor(backlogs, dtype=F32, device=DEV))


def asym_rows(fracs) -> torch.Tensor:
    ps = flitsim.AsymmetricLaneParams.stack(
        [flitsim.ASYMMETRIC_PARAMS[k] for k in flitsim.ASYMMETRIC_PARAMS],
        DEV)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=F32, device=DEV)
    return flitsim._asym_param_rows(ps, x, 100.0 - x)


def chunk_steps(params: torch.Tensor, horizon: int = 2048,
                chunk: int = 128):
    """The (state-independent) hist/scal builder of the adaptive loop, run
    with the plain version so that every chunk's inputs are known."""
    K = horizon // chunk
    K0 = max(K // 4, 1)
    min_k = max(4, K0 + 1)
    cells = params.shape[1]
    z = lambda r: torch.zeros((r, cells), dtype=F32, device=DEV)
    state = z(ref.SYM_ROWS)
    Dh, TDh, Ph = [z(1)], [z(1)], [z(5)]
    for k in range(1, K + 1):
        m = max(k - 4, (k + 1) // 2)
        mid = (m + k + 1) // 2
        hist = torch.cat([
            Ph[max(k - 3, 0)], Dh[m] if m < k else z(1),
            TDh[m] if m < k else z(1), Dh[mid] if mid < k else z(1),
            TDh[mid] if mid < k else z(1), Dh[K0] if k > K0 else z(1),
            z(6)])
        scal = flitsim._scal_row(
            [k, m, mid, K0, K, chunk, 1e-3,
             1.0 if (k >= min_k and k > 3) else 0.0,
             1.0 if k >= K else 0.0, 2.0], DEV)
        yield state, hist, scal
        state = ref.symmetric_chunk_compute(params, state, hist, scal,
                                            chunk=chunk)
        Dh.append(state[7:8])
        TDh.append(state[8:9])
        Ph.append(state[0:5])


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    ops.reset_launches()
    pack_ops.reset_launches()
    fa_ops.reset_launches()
    lru_ops.reset_launches()
    ssd_ops.reset_launches()
    da_ops.reset_launches()


def read_counts() -> dict:
    """Every kernel's launch count since :func:`reset_counts`."""
    return {**ops.launches, **pack_ops.launches, **fa_ops.launches,
            **lru_ops.launches, **ssd_ops.launches, **da_ops.launches}


def pipe_rows(ks, us, ds) -> torch.Tensor:
    return flitsim._pipe_param_rows(
        torch.as_tensor(ks, device=DEV),
        torch.as_tensor(us, dtype=F32, device=DEV),
        torch.as_tensor(ds, dtype=F32, device=DEV))


def pipe_steps(params: torch.Tensor, horizon: int = 512, chunk: int = 64):
    """The adaptive pipelining loop's per-chunk inputs (horizon 512, chunk
    64: the path's schedule), run with the plain version."""
    K = horizon // chunk
    cells = params.shape[1]
    state = torch.zeros((ref.PIPE_ROWS, cells), dtype=F32, device=DEV)
    hist = torch.zeros((ref.ASYM_ROWS, cells), dtype=F32, device=DEV)
    for k in range(1, K + 1):
        scal = flitsim._scal_row([k, K, chunk, 1e-3,
                                  1.0 if k >= min(4, K) else 0.0,
                                  1.0 if k >= K else 0.0, horizon], DEV)
        yield state, hist, scal
        state = ref.pipelining_chunk_compute(params, state, hist, scal,
                                             chunk=chunk)
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros(
                (ref.ASYM_ROWS - 1, cells), dtype=F32, device=DEV)])


def pack_inputs(n: int, seed: int):
    g = torch.Generator(device=DEV).manual_seed(seed)
    f = pack_ref.flits_needed(n)
    return [torch.randint(0, 256, shape, generator=g, device=DEV,
                          dtype=torch.int32)
            for shape in ((n, pack_ref.LINE_BYTES), (f, pack_ref.HS_BYTES),
                          (f, pack_ref.META_BYTES))]


def round_trip(name: str, flits, args) -> None:
    """Unpack ``flits`` and fail unless every line, header, meta byte and
    checksum comes back."""
    lines, headers, meta, ok = pack_ops.unpack(flits, args[0].shape[0])
    if not bool(ok.all()):
        raise AssertionError(f"{name}: {int((~ok).sum())} flits fail "
                             f"their checksum")
    for got, want in zip((lines, headers, meta), args):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: unpack does not return the "
                                 f"packed bytes")


# -- phase 3: each kernel against its plain version ---------------------------


def check_symmetric_chunk(params, reps):
    """All 16 chunks of a run, kernel vs plain on identical inputs; times
    the chunk of the middle of the run one call and on the card.  Returns
    (max_abs, ms, plain_ms, card_ms)."""
    err, timed = 0.0, None
    for k, (state, hist, scal) in enumerate(chunk_steps(params), 1):
        got = ops.symmetric_chunk(params, state, hist, scal, chunk=128)
        want = ref.symmetric_chunk_compute(params, state, hist, scal,
                                           chunk=128)
        err = max(err, hold(f"symmetric_chunk k={k}", got, want))
        if k == 8:
            timed = (state, hist, scal)
    state, hist, scal = timed
    call = lambda: ops.symmetric_chunk(params, state, hist, scal, chunk=128)
    ms = time_ms(call, reps)
    card = kernel_ms(call, r"(symmetric_chunk_kernel)")
    plain = time_ms(lambda: ref.symmetric_chunk_compute(
        params, state, hist, scal, chunk=128), max(reps // 5, 2))
    return err, ms, plain, card["symmetric_chunk_kernel"]


def check_pipelining_chunk(params, reps):
    """All 8 chunks of a run, kernel vs plain on identical inputs; times
    chunk 4 (the first that may exit) one call and on the card.  Returns
    (max_abs, ms, plain_ms, card_ms)."""
    err, timed = 0.0, None
    for k, (state, hist, scal) in enumerate(pipe_steps(params), 1):
        got = ops.pipelining_chunk(params, state, hist, scal, chunk=64)
        want = ref.pipelining_chunk_compute(params, state, hist, scal,
                                            chunk=64)
        err = max(err, hold(f"pipelining_chunk k={k}", got, want))
        if k == 4:
            timed = (state, hist, scal)
    state, hist, scal = timed
    call = lambda: ops.pipelining_chunk(params, state, hist, scal, chunk=64)
    ms = time_ms(call, reps)
    card = kernel_ms(call, r"(pipelining_chunk_kernel)")
    plain = time_ms(lambda: ref.pipelining_chunk_compute(
        params, state, hist, scal, chunk=64), max(reps // 5, 2))
    return err, ms, plain, card["pipelining_chunk_kernel"]


def check_run(name, run, plain, reps):
    """A whole adaptive run, kernel vs plain run on the same operands:
    the state rows, each cell's first converged chunk and the exit chunk
    bitwise.  Returns a record: max_abs_err, one call, back to back and
    on-card ms, the plain run's ms and the exit chunk."""
    got, want = run(), plain()
    err = max(hold(f"{name} {what}", g, w) for what, g, w in
              zip(("state rows", "conv_at", "exit chunk"), got, want))
    return dict(max_abs_err=err, k_exit=int(want[2].item()),
                ms=time_ms(run, reps), back_to_back_ms=stream_ms(run),
                card_ms=kernel_ms(run, rf"({name}_kernel)")[f"{name}_kernel"],
                plain_ms=time_ms(plain, max(reps // 10, 2)))


def check_symmetric_run(params, reps):
    budget = flitsim._escalation_budget(params.shape[1], SYM_RUN["chunk"],
                                        SYM_RUN["K"] * SYM_RUN["chunk"])
    return check_run(
        "symmetric_run",
        lambda: ops.symmetric_run(params, budget=budget, **SYM_RUN),
        lambda: ref.symmetric_run_compute(params, budget=budget, **SYM_RUN),
        reps)


def check_pipelining_run(params, reps):
    return check_run(
        "pipelining_run", lambda: ops.pipelining_run(params, **PIPE_RUN),
        lambda: ref.pipelining_run_compute(params, **PIPE_RUN), reps)


def check_pack(n: int, reps: int):
    """``pack_flits`` vs ``pack_flits_ref`` on ``n`` random lines, then the
    round trip.  Returns a record: max_abs_err, one call, back to back and
    on-card ms, the plain version's ms and the flits."""
    args = pack_inputs(n, seed=n)
    got = pack_ops.pack(*args)
    err = hold(f"pack_flits n={n}", got, pack_ref.pack_flits_ref(*args))
    round_trip(f"pack_flits n={n}", got, args)
    call = lambda: pack_ops.pack(*args)
    return dict(max_abs_err=err, ms=time_ms(call, reps),
                back_to_back_ms=stream_ms(call),
                card_ms=kernel_ms(call, r"(flit_pack_kernel)")[
                    "flit_pack_kernel"],
                plain_ms=time_ms(lambda: pack_ref.pack_flits_ref(*args),
                                 max(reps // 5, 2)), flits=got.shape[0])


def check_periodic(name, fn, plain_fn, params, reps):
    """A periodic detector, kernel vs plain on the same operands, bitwise.
    Returns a record (max_abs_err, one call, back to back and on-card ms,
    the plain version's ms) and the plain output."""
    want = plain_fn(params)
    err = hold(name, fn(params), want)
    call = lambda: fn(params)
    return dict(max_abs_err=err, ms=time_ms(call, reps),
                back_to_back_ms=stream_ms(call),
                card_ms=kernel_ms(call, rf"({name}_kernel)")[f"{name}_kernel"],
                plain_ms=time_ms(lambda: plain_fn(params),
                                 max(reps // 5, 2))), want


def periodic_records(ops_in, label, reps):
    """Both periodic detectors at one shape of :func:`kernel_shapes`:
    their :func:`check_periodic` records with cells and bounds.  The
    bounds count the plain version's observation (PERIOD_OBS steps) and
    lag search, the least work for the function; the kernels replay up to
    twice as many steps instead of keeping the window."""
    records = {}
    p = ops_in["asymmetric_periodic"]
    cells = p.shape[1]
    log(f"checking asymmetric_periodic @ {label} ({cells} cells)")
    r, out = check_periodic(
        "asymmetric_periodic",
        lambda q: ops.asymmetric_periodic(q, n_accesses=4096),
        lambda q: ref.asymmetric_periodic_compute(q, n_accesses=4096), p,
        reps)
    # data-dependent detection work: the lag search stops at the detected
    # period (all PERIOD_MAX lags for undetected cells)
    lags = torch.where(out[1] > 0.5, out[2],
                       float(ref.PERIOD_MAX)).sum().item()
    b, by = bound_ms(4.0 * 2 * ref.ASYM_ROWS * cells,
                     cells * (ref.PERIOD_OBS * ASYM_STEP_OPS + 24)
                     + 3 * lags)
    records["asymmetric_periodic"] = dict(cells=cells, bound_ms=b,
                                          bound_by=by, **r)
    p = ops_in["symmetric_periodic"]
    cells = p.shape[1]
    log(f"checking symmetric_periodic @ {label} ({cells} cells)")
    r, out = check_periodic(
        "symmetric_periodic",
        lambda q: ops.symmetric_periodic(q, n_flits=2048),
        lambda q: ref.symmetric_periodic_compute(q, n_flits=2048), p, reps)
    lags = torch.where(out[1] > 0.5, out[2],
                       float(ref.PERIOD_MAX)).sum().item()
    b, by = bound_ms(4.0 * (ref.SYM_ROWS + ref.SYM_PERIODIC_ROWS) * cells,
                     cells * (ref.SYM_PERIOD_OBS * SYM_STEP_OPS
                              + 2 * ref.PERIOD_WINDOW + 40)
                     + 7 * lags)
    records["symmetric_periodic"] = dict(cells=cells, bound_ms=b,
                                         bound_by=by, **r)
    return records


def bound_ms(bytes_moved: float, ops_done: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_done / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_shapes():
    """Operands of each kernel at its main-path shapes (the bridge's grids,
    the Fig-13 space, the flit data path's lines) and at ~2^20 cells (the catalog protocols
    over a dense read-fraction x backlog grid; k 1..8 x 128 link UIs x
    1024 device UIs; 2^20 lines)."""
    keys = tuple(flitsim.SYMMETRIC_PARAMS)
    fr21 = np.linspace(0.0, 1.0, 21)
    return {
        "path": {
            "symmetric_chunk": sym_rows(keys, fr21, [2.0, 8.0, 64.0]),
            "asymmetric_periodic": asym_rows(fr21),
            "symmetric_periodic": sym_rows(keys, fr21, [1.0, 2.0, 4.0]),
            "pipelining_chunk": pipe_rows(FIG13_KS, FIG13_US, FIG13_DS),
            "pack_flits": PACK_MAIN_LINES,
        },
        "2^20 cells": {
            "symmetric_chunk": sym_rows(keys, np.linspace(0, 1, 2731),
                                        np.linspace(1.0, 128.0, 128)),
            "asymmetric_periodic": asym_rows(np.linspace(0, 1, 1 << 19)),
            "symmetric_periodic": sym_rows(keys, np.linspace(0, 1, 2731),
                                           np.linspace(0.25, 4.0, 128)),
            "pipelining_chunk": pipe_rows(FIG13_KS,
                                          np.linspace(4.0, 32.0, 128),
                                          np.linspace(8.0, 256.0, 1024)),
            "pack_flits": 1 << 20,
        },
    }


def phase_kernels():
    """Every kernel against its plain version at its main-path shapes and
    at ~2^20 cells; returns per-kernel records per shape."""
    shapes = kernel_shapes()
    records = {}
    for label, ops_in in shapes.items():
        reps = 20 if label == "path" else 10
        p = ops_in["symmetric_chunk"]
        cells = p.shape[1]
        log(f"checking symmetric_chunk @ {label} ({cells} cells)")
        err, ms, plain, card = check_symmetric_chunk(p, reps)
        b, by = bound_ms(4.0 * (3 * ref.SYM_ROWS * cells + ref.SCAL_COLS
                                + ref.SYM_ROWS * cells),
                         cells * (128 * (SYM_STEP_OPS + 4) + 60))
        records.setdefault(label, {})["symmetric_chunk"] = dict(
            cells=cells, max_abs_err=err, ms=ms, card_ms=card,
            plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"checking symmetric_run @ {label} ({cells} cells)")
        r = check_symmetric_run(p, reps)
        steps = r["k_exit"] * SYM_RUN["chunk"]
        b, by = bound_ms(4.0 * (2 * ref.SYM_ROWS + 1) * cells,
                         cells * (steps * (SYM_STEP_OPS + 4)
                                  + r["k_exit"] * SYM_REPORT_OPS))
        records[label]["symmetric_run"] = dict(
            cells=cells, bound_ms=b, bound_by=by, **r)
        log(f"symmetric_run @ {label}: chain-latency estimate "
            f"{steps * SYM_CHAIN_CYCLES / max_sm_clock_hz() * 1e3:.4f} ms "
            f"({steps} steps x {SYM_CHAIN_CYCLES} cycles at nominal "
            f"latencies, not measured; the card took "
            f"{r['card_ms']:.4f} ms)")

        records[label].update(periodic_records(ops_in, label, reps))

        p = ops_in["pipelining_chunk"]
        cells = p.shape[1]
        log(f"checking pipelining_chunk @ {label} ({cells} cells)")
        err, ms, plain, card = check_pipelining_chunk(p, reps)
        b, by = bound_ms(4.0 * ((PIPE_READ_ROWS + ref.PIPE_ROWS) * cells
                                + ref.SCAL_COLS),
                         cells * (64 * PIPE_STEP_OPS + PIPE_REPORT_OPS))
        records[label]["pipelining_chunk"] = dict(
            cells=cells, max_abs_err=err, ms=ms, card_ms=card,
            plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"checking pipelining_run @ {label} ({cells} cells)")
        r = check_pipelining_run(p, reps)
        b, by = bound_ms(4.0 * (2 * ref.PIPE_ROWS + 1) * cells,
                         cells * r["k_exit"] * (PIPE_RUN["chunk"]
                                                * PIPE_STEP_OPS
                                                + PIPE_REPORT_OPS))
        records[label]["pipelining_run"] = dict(
            cells=cells, bound_ms=b, bound_by=by, **r)

        if label == "path":
            r = check_pack(64, reps)
            log(f"kernel pack_flits @ 64 lines ({r['flits']} flits): "
                f"bitwise equal to plain, round trip good; kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms")
        n = ops_in["pack_flits"]
        log(f"checking pack_flits @ {label} ({n} lines)")
        r = check_pack(n, reps)
        flits = r.pop("flits")
        # bytes: every line, header and meta word read once, every flit
        # word written once; operations: one XOR per checksummed byte
        b, by = bound_ms(4.0 * (pack_ref.LINE_BYTES * n
                                + (pack_ref.HS_BYTES + pack_ref.META_BYTES
                                   + pack_ref.FLIT_BYTES) * flits),
                         pack_ref.BODY_BYTES * flits)
        records[label]["pack_flits"] = dict(cells=n, bound_ms=b,
                                            bound_by=by, **r)
        for name, r in records[label].items():
            run = "".join(f", {what} {r[key]:.4f} ms" for key, what in (
                ("back_to_back_ms", "back to back"),
                ("card_ms", "on the card")) if key in r)
            if "k_exit" in r:
                run += f", exit chunk {r['k_exit']}"
            log(f"kernel {name} @ {label} ({r['cells']} cells/lines): bitwise "
                  f"equal to plain; kernel {r['ms']:.4f} ms{run}, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    return records


def trace_rows(traces, sym_traces=None):
    """Operands of both trace kernels: the catalog protocols' parameter
    rows over ``traces`` (the symmetric family over ``sym_traces`` where
    given) and the phase rows of their read/write mixes and backlogs."""
    out = []
    for family, ts in (("symmetric", sym_traces or traces),
                       ("asymmetric", traces)):
        xs = torch.as_tensor(np.asarray([[100.0 * r for r in tr.read_fractions]
                                         for tr in ts], np.float32),
                             device=DEV)
        grids = (xs, 100.0 - xs)
        if family == "symmetric":
            ps = flitsim.SymmetricFlitParams.stack(
                list(flitsim.SYMMETRIC_PARAMS.values()), DEV)
            bls = torch.as_tensor(np.asarray([list(tr.backlogs)
                                              for tr in ts], np.float32),
                                  device=DEV)
            out.append(flitsim._trace_rows(ps, ref.SYM_ROWS, *grids, bls))
        else:
            pa = flitsim.AsymmetricLaneParams.stack(
                list(flitsim.ASYMMETRIC_PARAMS.values()), DEV)
            out.append(flitsim._trace_rows(pa, ref.ASYM_ROWS, *grids))
    return out


def random_traces(n: int, phases: int, seed: int):
    """``n`` traces of ``phases`` phases: read fractions uniform in [0, 1],
    backlogs in [1, 128]."""
    rng = np.random.default_rng(seed)
    rf = rng.uniform(0.0, 1.0, (n, phases))
    bl = rng.uniform(1.0, 128.0, (n, phases))
    return [TrafficTrace(f"t{i}", (1.0,) * phases, tuple(rf[i]),
                         tuple(bl[i])) for i in range(n)]


def trace_cases():
    """Operands of the trace kernels: the serving frontier's 9 traces x 6
    phases (the main path's shape), one phase at the bridge's 21 read
    fractions x backlogs 2, 8, 64 (189 and 126 cells), ragged phase counts
    padded by ``pad_traces`` (512 cycles a phase), ~2^20 cells of 6
    phases, and a streamed chunk of ``joint_1e7`` (4096 cells x 3 and 2
    protocols, one phase of 64 cycles)."""
    frontier = [synthetic_serving_trace(ModelTrafficSpec.from_name(m),
                                        qps=q, name=f"{m}@q{q:g}")
                for m in DEFAULT_MODELS for q in DEFAULT_QPS]
    fr21 = np.linspace(0.0, 1.0, 21)
    one = [TrafficTrace.steady(f"s{b:g}/{r:.2f}", float(r), b)
           for b in (2.0, 8.0, 64.0) for r in fr21]
    rng = np.random.default_rng(20)
    ragged = pad_traces([TrafficTrace(
        f"r{i}", (1.0,) * k, tuple(rng.uniform(0, 1, k)),
        tuple(rng.uniform(1, 128, k)))
        for i, k in enumerate((1, 6, 2, 3, 5, 4, 1, 6))])
    return {
        "path": (trace_rows(frontier), TRACE_CYCLES),
        "one phase": (trace_rows(one[:21], one), TRACE_CYCLES),
        "ragged": (trace_rows(ragged), {k: 512 for k in TRACE_CYCLES}),
        "2^20 cells": (trace_rows(random_traces(1 << 19, 6, 21),
                                  random_traces(349526, 6, 22)),
                       TRACE_CYCLES),
        "stream chunk": (trace_rows(random_traces(JOINT_CHUNK, 1, 23)),
                         {k: JOINT_CYCLES for k in TRACE_CYCLES}),
    }


def once_ms(fn):
    """``fn()``'s result and its CUDA-event time, ms, from one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_traces():
    """Both trace kernels against their plain versions at each case of
    :func:`trace_cases`, bitwise (the one-phase case also against the
    fixed engine's static cells); each timed one call, back to back and
    on the card beside its bound (operations at the f32 peak, or bytes)
    and a chain-latency estimate (logged only), the plain version timed
    once.  Returns records per case."""
    records = {}
    for case, ((sym, asym), cycles) in trace_cases().items():
        reps = 10 if case == "2^20 cells" else 20
        for name, rows, fn, plain in (
                ("symmetric_trace", sym, ops.symmetric_trace,
                 ref.symmetric_trace_compute),
                ("asymmetric_trace", asym, ops.asymmetric_trace,
                 ref.asymmetric_trace_compute)):
            cyc = cycles[name]
            cells, phases = rows[0].shape[1], rows[1].shape[0]
            log(f"checking {name} @ {case} ({cells} cells, {phases} phases "
                f"x {cyc} cycles)")
            want, plain_ms = once_ms(lambda: plain(*rows, cycles=cyc))
            call = lambda: fn(*rows, cycles=cyc)
            err = hold(f"{name} @ {case}", call(), want)
            r = dict(max_abs_err=err, ms=time_ms(call, reps),
                     back_to_back_ms=stream_ms(call),
                     card_ms=kernel_ms(call, rf"({name}_kernel)")[
                         f"{name}_kernel"], plain_ms=plain_ms)
            steps = phases * cyc
            step_ops = (SYM_STEP_OPS if name == "symmetric_trace"
                        else ASYM_STEP_OPS) + TRACE_STEP_EXTRA[name]
            b, by = bound_ms(
                4.0 * cells * (TRACE_PARAM_ROWS[name]
                               + (TRACE_PHASE_ROWS[name] + 1) * phases),
                cells * (steps * step_ops + phases * TRACE_PHASE_OPS))
            chain = steps * (SYM_CHAIN_CYCLES if name == "symmetric_trace"
                             else ASYM_CHAIN_CYCLES)
            r.update(cells=cells, phases=phases, cycles=cyc, bound_ms=b,
                     bound_by=by)
            records.setdefault(case, {})[name] = r
            log(f"kernel {name} @ {case}: bitwise equal to plain; kernel "
                f"{r['ms']:.4f} ms, back to back "
                f"{r['back_to_back_ms']:.4f} ms, on the card "
                f"{r['card_ms']:.4f} ms, plain {plain_ms:.2f} ms (once), "
                f"bound {b:.5f} ms ({by}); chain-latency estimate "
                f"{chain / max_sm_clock_hz() * 1e3:.4f} ms ({steps} steps x "
                f"{chain // steps} cycles at nominal latencies, not "
                f"measured)")
            if case == "one phase":
                fixed_cell(name, rows, cyc, want)
    return records


def fixed_cell(name, rows, cycles, got):
    """A one-phase trace equals the fixed engine's static cell bitwise:
    the symmetric rows are 21 read fractions x backlogs 2, 8, 64, the
    asymmetric rows the 21 read fractions."""
    fr = rows[1][0, :21]
    if name == "symmetric_trace":
        ps = flitsim.SymmetricFlitParams.stack(
            list(flitsim.SYMMETRIC_PARAMS.values()), DEV)
        fixed = flitsim._symmetric_grid(
            ps, fr, 100.0 - fr, torch.tensor([2.0, 8.0, 64.0], device=DEV),
            n_flits=cycles)
    else:
        pa = flitsim.AsymmetricLaneParams.stack(
            list(flitsim.ASYMMETRIC_PARAMS.values()), DEV)
        fixed = flitsim._asymmetric_grid(pa, fr, 100.0 - fr,
                                         n_accesses=cycles)
    hold(f"{name} one phase vs the fixed engine", got[0],
         fixed.reshape(-1))
    log(f"{name} @ one phase: bitwise equal to the fixed engine's "
        f"{fixed.numel()} static cells")


#: the flit-simulator kernels whose ptxas report ``flit_ptxas`` logs
FLIT_KERNELS = ("symmetric_chunk_kernel", "symmetric_run_kernel",
                "pipelining_chunk_kernel", "pipelining_run_kernel",
                "asymmetric_periodic_kernel", "symmetric_periodic_kernel",
                "symmetric_trace_kernel", "asymmetric_trace_kernel")
#: kernels for which a stack frame is fatal too (they keep everything in
#: registers by design)
NO_STACK_KERNELS = ("asymmetric_periodic_kernel",
                    "symmetric_periodic_kernel", "symmetric_trace_kernel",
                    "asymmetric_trace_kernel")


def flit_ptxas(text=None, strict: bool = True) -> None:
    """Log ptxas's registers, stack frame (local memory) and spills of
    every flit-simulator kernel in a build log (default: this build's); a
    spill in a chunk or run kernel, or a stack frame or spill in a
    periodic detector or a trace scan, fails the run unless not
    ``strict``."""
    text = _build.BUILD_LOG.get("flit_sim") if text is None else text
    if text is None:
        log("ptxas [flit_sim]: library was already built, no report")
        return
    report = {}
    for kernel in FLIT_KERNELS:
        report.update(ptxas_instances(text, kernel))
    log(f"ptxas, flit kernels: {json.dumps(report)}")
    if not strict:
        return
    for name, r in report.items():
        spills = r.get("spill_stores") or r.get("spill_loads")
        if ("_chunk_kernel" in name or "_run_kernel" in name) and spills:
            raise AssertionError(f"ptxas spills in {name}: {r}")
        if name.startswith(NO_STACK_KERNELS) and (spills or r.get("stack")):
            raise AssertionError(f"ptxas gives {name} local memory: {r}")
    if not any("_run_kernel" in name for name in report):
        raise AssertionError("no run kernel in ptxas's report")
    for name in NO_STACK_KERNELS:
        if not any(k.startswith(name) for k in report):
            raise AssertionError(f"no {name} in ptxas's report")


def phase_division() -> dict:
    """The run kernels' divisions (by a cell constant; by the varying
    ``tot_q``, with the approximate reciprocal's scaling over the
    exponents -50..50) against ``__fdiv_rn`` over every pair of f32
    significands in [1, 2), 2^46 pairs each: the certificate that the
    reciprocal division is the IEEE quotient over its whole range.  Fails
    on any differing pair."""
    out = {}
    for varying in (False, True):
        t0 = time.perf_counter()
        bad = 0
        for lo in range(0, 1 << 23, 1 << 16):
            d = torch.arange(lo, lo + (1 << 16), dtype=torch.int32,
                             device=DEV) | 0x3F800000
            bad += flit_kernel.division_check(d, varying=varying)
        what = "by tot_q" if varying else "by a cell constant"
        if bad:
            raise AssertionError(f"division {what}: {bad} significand "
                                 f"pairs differ from the IEEE quotient")
        out[what] = {"pairs": 1 << 46, "differ": 0,
                     "seconds": time.perf_counter() - t0}
        log(f"division {what}: equal to __fdiv_rn on all 2^46 significand "
            f"pairs ({out[what]['seconds']:.1f} s)")
    return out


def periodic_ab(sources) -> list:
    """The periodic detectors of other ``flit_sim.cu`` files (``sources``,
    such as a parent commit's) and of this tree's in turns (each source,
    the tree, then the same in reverse), in one process on one card, each
    turn through :func:`periodic_records` at both shapes.  The libraries
    are built together with the same flags; their ptxas reports, the
    tree's too, are only logged (the full run fails on them).  Returns the
    records of each turn."""
    procs = []
    for n, src in enumerate(sources):
        out = _build.BUILD_DIR / "ab" / f"libflit_sim_{n}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs.append((src, out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    _build.build(["flit_sim"])
    libs = {}
    for src, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{text}")
        log(f"source {src}:")
        flit_ptxas(text, strict=False)
        libs[src] = flit_kernel.declare(ctypes.CDLL(str(out)))
    log("this tree's source:")
    flit_ptxas(strict=False)
    libs["tree"] = flit_kernel._lib()
    shapes = kernel_shapes()
    turns = []
    for which in list(libs) + list(libs)[::-1]:
        flit_kernel._LIB[:] = [libs[which]]
        for label, ops_in in shapes.items():
            recs = periodic_records(ops_in, label,
                                    20 if label == "path" else 10)
            for name, r in recs.items():
                log(f"{which} {name} @ {label}: {json.dumps(r)}")
            turns.append({"source": which, "shape": label, **recs})
    flit_kernel._LIB[:] = [libs["tree"]]
    return turns


# -- phase 4: the main path ---------------------------------------------------


#: the LM kernels' wrappers, by their files in a tree
WRAPPERS = {"flash_attention_fwd": "kernels/flash_attention/ops.py",
            "rglru_scan": "kernels/rglru_scan/ops.py",
            "ssd_scan": "kernels/ssd_scan/ops.py"}


def wrapper_ab(parent: str, reps: int = 500) -> list:
    """``--wrapper-ab PARENT``: the LM kernels' wrappers of another tree
    (a parent's, unpacked with ``git archive``; its ``ops.py`` files loaded
    beside this tree's, on the same kernels) and of this tree, each timed
    one call at its launcher prompt in turns (parent, tree, tree, parent,
    twice) in one process.  Returns the records of each turn."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    fa_case = FA_CASES[FA_PATH]
    q, k, v = fa_inputs(fa_case, gen)
    causal, window, q_offset = fa_case[6:9]
    shape = LRU_CASES[LRU_PATH]
    log_a = -torch.rand(shape, generator=gen, device=DEV) * 2.0
    b = torch.randn(shape, generator=gen, device=DEV)
    x, dt, bb, c, a_log, _ = ssd_inputs(SSD_CASES[SSD_PATH], gen)
    calls = {"flash_attention_fwd": lambda m: m.flash_attention(
                 q, k, v, causal, window, q_offset),
             "rglru_scan": lambda m: m.lru(log_a, b),
             "ssd_scan": lambda m: m.ssd(x, dt, bb, c, a_log)}
    tree = {"flash_attention_fwd": fa_ops, "rglru_scan": lru_ops,
            "ssd_scan": ssd_ops}
    old = {}
    for name, rel in WRAPPERS.items():
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}_ops", Path(parent) / "src" / "repro_torch" / rel)
        old[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old[name])
    turns = []
    for turn, side in enumerate(("parent", "tree", "tree", "parent") * 2):
        mods = old if side == "parent" else tree
        rec = {"turn": turn, "side": side}
        for name, fn in calls.items():
            rec[name] = time_ms(lambda: fn(mods[name]), reps)
        turns.append(rec)
        log(f"wrapper A/B turn {turn} ({side}): one call at the launcher "
            f"prompts, ms: " + ", ".join(f"{n} {rec[n]:.4f}" for n in calls)
            + f" [{card_line()}]")
    return turns


def load_summarize():
    spec = importlib.util.spec_from_file_location(
        "design_space_summary", ROOT / "tools" / "design_space_summary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.summarize


@contextlib.contextmanager
def runner_times(store: dict):
    """Records, under each fused runner's name, every call's ``elapsed_s``,
    cells, cycles run, launches and stragglers (``last_run_info``)."""
    saved = {}
    for name, fam in (("_run_symmetric_fused", "flitsim.symmetric"),
                      ("_run_pipelining_fused", "flitsim.pipelining")):
        fn = saved[name] = getattr(flitsim, name)

        def wrapped(*a, _fn=fn, _fam=fam, _name=name, **kw):
            out = _fn(*a, **kw)
            info = flitsim.last_run_info()[_fam]
            store.setdefault(_name, []).append(
                {k: info[k] for k in ("elapsed_s", "cells", "cycles_run",
                                      "launches", "stragglers")})
            return out
        setattr(flitsim, name, wrapped)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(flitsim, name, fn)


def one_launch_per_run(path: str, counts: dict, runs: dict) -> str:
    """Fail unless the path launched each run kernel once per adaptive run
    of its runner and no one-chunk kernel; returns the runners'
    ``elapsed_s`` for the log."""
    for kernel, runner in (("symmetric_run", "_run_symmetric_fused"),
                           ("pipelining_run", "_run_pipelining_fused")):
        n = len(runs.get(runner, []))
        if counts[kernel] != n:
            raise AssertionError(f"{path}: {counts[kernel]} {kernel} "
                                 f"launches for {n} adaptive runs")
    for kernel in ("symmetric_chunk", "pipelining_chunk"):
        if counts[kernel]:
            raise AssertionError(f"{path} launched {kernel}")
    return json.dumps({name: [{k: r[k] for k in ("cells", "cycles_run",
                                                 "elapsed_s")}
                              for r in rs] for name, rs in runs.items()})


@contextlib.contextmanager
def serving_section(store: dict):
    """Records the serving section's wall (s, the card's work included)
    and the kernel launches made inside it, in ``store``."""
    real = explorer.serving_frontier_report

    def timed(*a, **kw):
        before = read_counts()
        t0 = time.perf_counter()
        rep = real(*a, **kw)
        torch.cuda.synchronize()
        store["wall_s"] = time.perf_counter() - t0
        store["launches"] = {k: n - before[k]
                             for k, n in read_counts().items()
                             if n != before[k]}
        return rep
    explorer.serving_frontier_report = timed
    try:
        yield
    finally:
        explorer.serving_frontier_report = real


@contextlib.contextmanager
def plain_trace_cores():
    """The trace wrappers replaced by their plain versions, on the card:
    what the serving section would cost without the kernels."""
    saved = ops.symmetric_trace, ops.asymmetric_trace
    ops.symmetric_trace = ref.symmetric_trace_compute
    ops.asymmetric_trace = ref.asymmetric_trace_compute
    try:
        yield
    finally:
        ops.symmetric_trace, ops.asymmetric_trace = saved


def phase_main_path():
    golden = json.loads(
        (ROOT / "experiments/golden/design_space_summary.json").read_text())
    summarize = load_summarize()
    log("main path: bridge on the card")
    runs: dict = {}
    serving: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    with runner_times(runs), serving_section(serving):
        ds = bridge_mode(device="cuda", verbose=False)
    torch.cuda.synchronize()
    bridge_s = time.perf_counter() - t0
    bridge_counts = read_counts()
    got = summarize(ds)
    bad = sorted(set(golden) | set(got))
    bad = [k for k in bad if got.get(k) != golden.get(k)]
    if bad:
        raise AssertionError(f"bridge summary differs from the golden in "
                             f"sections {bad}")
    for name in ("asymmetric_periodic", "symmetric_run"):
        if bridge_counts[name] <= 0:
            raise AssertionError(f"the bridge never launched {name}")
    elapsed = one_launch_per_run("the bridge", bridge_counts, runs)
    want = {"symmetric_trace": 1, "asymmetric_trace": 1}
    if serving["launches"] != want or \
            ds["serving_frontier"]["launches"] != want:
        raise AssertionError(f"the serving section launched "
                             f"{serving['launches']}, want {want}")
    runners = {fam: d["elapsed_s"] for fam, d in
               ds["serving_frontier"]["telemetry"].items()}
    log(f"main path: bridge on the card in {bridge_s:.2f} s, summary "
          f"equals the whole golden ({sorted(golden)}); launches "
          f"{bridge_counts}; adaptive runs {elapsed}; serving section "
          f"{serving['wall_s']:.4f} s, launches {serving['launches']}, "
          f"trace runners' elapsed_s {runners}")
    t0 = time.perf_counter()
    with plain_trace_cores():
        plain = explorer.serving_frontier_report(device="cuda",
                                                 verbose=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if plain["winner_by_model_qps"] != \
            ds["serving_frontier"]["winner_by_model_qps"]:
        raise AssertionError("the plain trace cores on the card pick other "
                             "serving winners than the kernels")
    serving["plain_wall_s"] = plain_s
    log(f"main path: serving section with the plain trace cores on the "
        f"card: {plain_s:.3f} s (with the kernels {serving['wall_s']:.4f} "
        f"s), the same winners")
    serving["frontier_vs_cpu"] = phase_serving_frontier(
        ds["serving_frontier"])

    # shallow queues: the symmetric periodic detector's path
    fracs = np.linspace(0.0, 1.0, 21)
    runs = {}
    reset_counts()
    with runner_times(runs):
        res = DesignSpace([axis("read_fraction", fracs),
                           axis("backlog", [1.0, 2.0, 4.0])],
                          sim=ADAPTIVE_SIM, device="cuda").evaluate(
                              metrics=("sim_efficiency",))
    torch.cuda.synchronize()
    shallow_counts = read_counts()
    one_launch_per_run("the shallow-queue space", shallow_counts, runs)
    if shallow_counts["symmetric_periodic"] <= 0:
        raise AssertionError("the shallow-queue space never launched "
                             "symmetric_periodic")
    if not np.all(np.isfinite(res["sim_efficiency"].values)):
        raise AssertionError("non-finite simulated efficiency")
    rows = sym_rows(tuple(flitsim.SYMMETRIC_PARAMS), fracs, [1.0, 2.0, 4.0])
    out = ops.symmetric_periodic(rows, n_flits=2048)
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), DEV)
    x = torch.as_tensor(100.0 * fracs, dtype=F32, device=DEV)
    fixed = flitsim._symmetric_grid(
        ps, x, 100.0 - x, torch.tensor([1.0, 2.0, 4.0], device=DEV),
        n_flits=2048).reshape(-1)
    det = out[1] > 0.5
    if not torch.equal(out[0][det], fixed[det]):
        raise AssertionError("symmetric_periodic detected cells differ "
                             "from the fixed engine")
    log(f"shallow-queue space: launches {shallow_counts}; "
          f"{int(det.sum())} detected cells bitwise equal to the fixed "
          f"engine")
    return {"bridge": bridge_counts, "serving": serving,
            "shallow": shallow_counts,
            "fig13": phase_fig13(), "sweep": phase_sweep(),
            "quickstart": phase_quickstart(), "flit_pack": phase_flit_pack()}


def phase_serving_frontier(card: dict) -> dict:
    """The serving frontier alone: the bridge's section from the card
    against the same section on the CPU (winner labels equal exactly, the
    winners' GB/s within 1e-6), and ``trace_efficiency`` over the same
    traces on both devices within 1e-6."""
    from repro_torch.core.ucie import UCIE_A_32G_55U
    log("main path: the serving frontier, card against the CPU")
    t0 = time.perf_counter()
    cpu = explorer.serving_frontier_report(device="cpu", verbose=False)
    cpu_s = time.perf_counter() - t0
    for key in ("winner_by_model_qps", "protocol_by_model_qps",
                "qps_sensitive", "traces", "trace_names"):
        if card[key] != cpu[key]:
            raise AssertionError(f"serving frontier {key} differ between "
                                 f"the card and the CPU")
    err_gbs = close("serving winners' GB/s card vs CPU",
                    [v for m in card["models"] for v in
                     card["winner_gbs_by_model_qps"][m].values()],
                    [v for m in cpu["models"] for v in
                     cpu["winner_gbs_by_model_qps"][m].values()], 1e-6)
    traces = [TrafficTrace(name, **card["traces"][name])
              for name in card["trace_names"]]
    eff = {}
    for dev in ("cuda", "cpu"):
        eff[dev] = DesignSpace([axis("trace", traces)], phy=UCIE_A_32G_55U,
                               device=dev).evaluate(
            metrics=("trace_efficiency", "trace_phase_efficiency"))
    err_eff = max(close(f"{m} card vs CPU", eff["cuda"][m].values,
                        eff["cpu"][m].values, 1e-6)
                  for m in ("trace_efficiency", "trace_phase_efficiency"))
    log(f"main path: serving frontier card vs CPU: winners equal "
        f"({card['winner_by_model_qps']}), winners' GB/s max |diff| "
        f"{err_gbs}, trace efficiency max |diff| {err_eff}; the CPU's "
        f"section {cpu_s:.2f} s")
    return {"max_abs_gbs": err_gbs, "max_abs_efficiency": err_eff,
            "cpu_wall_s": cpu_s}


def joint_space(device) -> DesignSpace:
    """The reference's ``joint_1e7`` space: 2,562,500 stream cells x 4
    PHYs = 10,250,000 joint cells."""
    return DesignSpace([
        axis("protocol_param", [{"g_slots": float(g)} for g in
                                np.linspace(1.0, 4.0, JOINT_PERTS)]),
        axis("phy", list(JOINT_PHYS)),
        axis("backlog", list(np.linspace(2.0, 128.0, JOINT_BACKLOGS))),
        axis("read_fraction", list(np.linspace(0.0, 1.0, JOINT_MIXES))),
    ], n_flits=JOINT_CYCLES, n_accesses=JOINT_CYCLES, device=device)


@contextlib.contextmanager
def eager_loop_calls(store: dict):
    """Counts, in ``store``, the calls of the fixed engine's eager
    per-cycle cores and of the trace kernels' plain versions."""
    saved = {}
    for mod, name in ((flitsim, "_symmetric_efficiency"),
                      (flitsim, "_asymmetric_efficiency"),
                      (ref, "symmetric_trace_compute"),
                      (ref, "asymmetric_trace_compute")):
        fn = saved[mod, name] = getattr(mod, name)
        store[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            store[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def streamed(space, prefetch: int):
    """One streamed ``sim_bandwidth_gbs`` frontier of ``space`` with the
    launch counts set to 0 just before it and read just after: ``(result,
    wall s, counts, eager-loop calls, telemetry, peak GiB)``."""
    eager: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with eager_loop_calls(eager):
        sr = space.evaluate(metrics=("sim_bandwidth_gbs",),
                            stream=StreamConfig(chunk_cells=JOINT_CHUNK,
                                                prefetch=prefetch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (sr, wall, counts, eager,
            dict(flitsim.last_run_info()["stream.sim"]), peak)


def phase_streaming() -> dict:
    """The streamed path at full width: the ``joint_1e7`` space streamed
    on the card at prefetch 2 (the default) and 1, one launch of each
    trace kernel per dispatch and no eager per-cycle loop; its winners,
    win counts and bests held bitwise against the card's materialized
    fixed engine; then the perturbation axes on the card against the
    CPU."""
    log("streaming: joint_1e7 on the card")
    space = joint_space("cuda")
    runs: dict = {2: [], 1: []}
    first = None
    # the first run warms the card and the host up; then the two depths
    # in turns
    for turn, prefetch in enumerate((2, 1, 2, 1, 2)):
        sr, wall, counts, eager, info, peak = streamed(space, prefetch)
        rec = dict(wall_s=wall, dispatches=sr.n_dispatches,
                   overlap_frac=info["overlap_frac"],
                   marshal_s=info["marshal_s"],
                   elapsed_s=info["elapsed_s"], peak_gib=peak,
                   launches={k: n for k, n in counts.items() if n})
        if turn:
            runs[prefetch].append(rec)
        if sr.peak_cells_per_chunk != JOINT_CHUNK * len(JOINT_PHYS):
            raise AssertionError(f"joint_1e7: {sr.peak_cells_per_chunk} "
                                 f"cells a chunk, want "
                                 f"{JOINT_CHUNK * len(JOINT_PHYS)}")
        want = {"symmetric_trace": sr.n_dispatches,
                "asymmetric_trace": sr.n_dispatches}
        if rec["launches"] != want:
            raise AssertionError(f"joint_1e7 stream launched "
                                 f"{rec['launches']}, want {want}")
        if any(eager.values()):
            raise AssertionError(f"the eager per-cycle cores ran on the "
                                 f"stream: {eager}")
        if first is None:
            first = sr
        elif not (np.array_equal(sr.winners.values, first.winners.values)
                  and sr.win_counts == first.win_counts
                  and sr.best_by_label == first.best_by_label):
            raise AssertionError("joint_1e7: prefetch 1 and 2 differ")
        log(f"streaming: joint_1e7 at prefetch {prefetch}"
            f"{' (warm-up)' if not turn else ''}: "
            f"{sr.n_stream_cells} stream cells, {sr.n_cells} joint cells "
            f"in {sr.n_dispatches} dispatches, {wall:.3f} s wall "
            f"(runner {info['elapsed_s']:.3f} s, marshal "
            f"{info['marshal_s']:.3f} s, overlap_frac "
            f"{info['overlap_frac']:.4f}); launches {rec['launches']}"
            f"; peak {peak:.4f} GiB; eager loop calls {eager}")
    sr = first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat = space.evaluate(metrics=("sim_bandwidth_gbs",))["sim_bandwidth_gbs"]
    torch.cuda.synchronize()
    mat_wall = time.perf_counter() - t0
    mat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    win = mat.argbest("protocol")
    if win.dims != sr.winners.dims or win.coords != sr.winners.coords or \
            not np.array_equal(win.values, sr.winners.values):
        raise AssertionError("joint_1e7: streamed winners differ from the "
                             "card's materialized fixed engine")
    idx = np.argmax(mat.values, axis=1).ravel()
    counts = np.bincount(idx, minlength=len(sr.labels))
    v = np.moveaxis(mat.values, 1, 0).reshape(len(sr.labels), -1)
    bests = {k: float(v[i].max()) for i, k in enumerate(sr.labels)}
    if sr.win_counts != {k: int(counts[i])
                         for i, k in enumerate(sr.labels)} or \
            sr.best_by_label != bests:
        raise AssertionError(f"joint_1e7: win counts / bests differ from "
                             f"the materialized run ({sr.win_counts} vs "
                             f"{counts.tolist()}; {sr.best_by_label} vs "
                             f"{bests})")
    log(f"streaming: joint_1e7 winners, win counts {sr.win_counts} and "
        f"bests bitwise equal to the card's materialized fixed engine "
        f"({mat_wall:.3f} s wall, peak {mat_peak:.4f} GiB; streamed peak "
        f"{runs[2][0]['peak_gib']:.4f} GiB)")
    return {"joint_1e7": {"runs": runs, "materialized_wall_s": mat_wall,
                          "materialized_peak_gib": mat_peak,
                          "digest": stream_digest(sr),
                          "n_cells": sr.n_cells,
                          "n_stream_cells": sr.n_stream_cells,
                          "dispatches": sr.n_dispatches,
                          "peak_cells_per_chunk": sr.peak_cells_per_chunk,
                          "win_counts": sr.win_counts},
            **phase_perturbation()}


#: the constrained analytic stream of phases f' and m: its constraints and
#: chunk (its space: :func:`catalog_stream_space`)
CAT_STREAM_CONS = dict(packaging="UCIe-A", max_power_w=40.0)
CAT_STREAM_CHUNK = 64
#: the digest keys of the dispatch plan, which differ with the ranks
PLAN_KEYS = ("n_dispatches", "chunk_cells", "devices",
             "peak_cells_per_chunk")


def catalog_stream_space(device) -> DesignSpace:
    """101 read fractions x 4 shorelines: 404 analytic cells."""
    return DesignSpace([axis("read_fraction",
                             list(np.linspace(0.0, 1.0, 101))),
                        axis("shoreline_mm", [2.0, 4.0, 8.0, 16.0])],
                       device=device)


def stream_digest(sr) -> dict:
    """Everything a ``StreamResult`` holds, small: the winners' dims, a
    SHA-256 of their coords and one of their label codes, the win counts
    and each best as ``float.hex`` (NaN too), and the dispatch plan."""
    import hashlib
    vals = np.asarray(sr.winners.values, dtype=object)
    codes = np.full(vals.shape, -1, np.int8)
    for i, lab in enumerate(tuple(sr.labels) + ("(none)",)):
        codes[vals == lab] = i
    return {"dims": list(sr.winners.dims),
            "coords_sha256": hashlib.sha256(
                repr(sr.winners.coords).encode()).hexdigest(),
            "codes_sha256": hashlib.sha256(codes.tobytes()).hexdigest(),
            "unlabelled": int(np.sum(codes < 0)),
            "win_counts": dict(sr.win_counts),
            "best_by_label": {k: float(v).hex()
                              for k, v in sr.best_by_label.items()},
            "n_cells": sr.n_cells, "n_dispatches": sr.n_dispatches,
            "chunk_cells": sr.chunk_cells, "devices": sr.devices,
            "peak_cells_per_chunk": sr.peak_cells_per_chunk}


def one_card_stream() -> dict:
    """Phase f''s one-card ``joint_1e7`` stream where f' does not run in
    this process: its digest and wall, after a warm-up."""
    log("stream sharded: joint_1e7 on one card (phase f' did not run)")
    streamed(joint_space("cuda"), 2)
    sr, wall, _, _, info, _ = streamed(joint_space("cuda"), 2)
    log(f"stream sharded: one card: {sr.n_dispatches} dispatches, "
        f"{wall:.3f} s wall (runner {info['elapsed_s']:.3f} s, marshal "
        f"{info['marshal_s']:.3f} s)")
    return {"digest": stream_digest(sr), "wall_s": wall}


def _differs(got: dict, want: dict) -> list:
    """The keys of two digests that differ, the plan's left out."""
    return [k for k in want if k not in PLAN_KEYS and got[k] != want[k]]


def _stream_sharded_work(rank: int, world: int, out_dir: str) -> dict:
    """Phase m on one rank of a world of ``world``: the ``joint_1e7``
    space streamed with ``StreamConfig(devices=world)`` on this rank's
    card with the launch counts set to 0 just before it and read just
    after (one ``symmetric_trace`` and one ``asymmetric_trace`` launch a
    dispatch of this rank, no eager per-cycle core), its digest against
    phase f''s one-card digest; then phase f''s constrained catalog
    stream sharded against this rank's one-card stream of it.  Raises on
    any difference."""
    from repro_torch.launch import mesh as mesh_mod
    dev = mesh_mod.default_device()
    torch.distributed.barrier()
    t_phase = time.perf_counter()
    # warm-up: the flit library loaded and the world's collectives used
    DesignSpace([axis("protocol_param", [{}, {"g_slots": 2.0}]),
                 axis("phy", list(JOINT_PHYS)), axis("backlog", [2.0]),
                 axis("read_fraction", [0.0, 0.5, 1.0])],
                n_flits=JOINT_CYCLES, n_accesses=JOINT_CYCLES,
                device=dev).evaluate(
        metrics=("sim_bandwidth_gbs",),
        stream=StreamConfig(chunk_cells=2, devices=world))
    space = joint_space(dev)
    eager: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    reset_counts()
    t0 = time.perf_counter()
    with eager_loop_calls(eager):
        sr = space.evaluate(metrics=("sim_bandwidth_gbs",),
                            stream=StreamConfig(chunk_cells=JOINT_CHUNK,
                                                devices=world))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    info = dict(flitsim.last_run_info()["stream.sim"])
    n = sr.n_stream_cells
    chunk = min(JOINT_CHUNK, -(-n // world))
    n_disp = -(-n // (world * chunk))
    want = {"symmetric_trace": n_disp, "asymmetric_trace": n_disp}
    t1 = time.perf_counter()
    digest = stream_digest(sr)
    digest_s = time.perf_counter() - t1
    with open(Path(out_dir) / "one_card.json") as f:
        one = json.load(f)["digest"]
    bad = _differs(digest, one)
    if bad or counts != want or any(eager.values()) or \
            (sr.n_dispatches, sr.chunk_cells, sr.devices,
             sr.peak_cells_per_chunk, info["pad_cells"]) != \
            (n_disp, chunk, world, chunk * len(JOINT_PHYS),
             n_disp * world * chunk - n):
        raise AssertionError(
            f"stream sharded: rank {rank}: joint_1e7 differs from one card "
            f"in {bad}; launches {counts} (want {want}); eager {eager}; "
            f"plan {sr.n_dispatches} dispatches of {sr.chunk_cells} cells, "
            f"devices {sr.devices}, peak {sr.peak_cells_per_chunk}, pad "
            f"{info['pad_cells']}")
    cons = SelectionConstraints(**CAT_STREAM_CONS)
    cat = catalog_stream_space(dev)
    c_one, c_sh = (cat.evaluate(metrics=("bandwidth_gbs",), stream=
                                StreamConfig(chunk_cells=CAT_STREAM_CHUNK,
                                             constraints=cons, devices=d))
                   for d in (1, world))
    c_bad = _differs(stream_digest(c_sh), stream_digest(c_one))
    c_info = dict(flitsim.last_run_info()["stream.catalog"])
    if c_bad or c_sh.devices != world or "(none)" not in c_sh.win_counts:
        raise AssertionError(f"stream sharded: rank {rank}: the catalog "
                             f"stream differs from one card in {c_bad}")
    return dict(rank=rank, device=str(dev), phase_s=time.perf_counter()
                - t_phase, wall_s=wall,
                elapsed_s=info["elapsed_s"], marshal_s=info["marshal_s"],
                overlap_frac=info["overlap_frac"],
                dispatches=info["dispatches"], pad_cells=info["pad_cells"],
                reduce_s=info["reduce_s"], reduce_bytes=info["reduce_bytes"],
                transport=info["transport"],
                backend=torch.distributed.get_backend(), peak_gib=peak,
                launches=counts, digest_s=digest_s,
                win_counts=sr.win_counts, n_cells=sr.n_cells,
                chunk_cells=sr.chunk_cells,
                peak_cells_per_chunk=sr.peak_cells_per_chunk,
                catalog=dict(cells=c_sh.n_cells,
                             dispatches=c_sh.n_dispatches,
                             chunk_cells=c_sh.chunk_cells,
                             one_card_dispatches=c_one.n_dispatches,
                             none_cells=c_sh.win_counts["(none)"],
                             reduce_s=c_info["reduce_s"],
                             reduce_bytes=c_info["reduce_bytes"]))


def _stream_rank(rank: int, world: int, out_dir: str) -> None:
    """``--stream-sharded``'s rank: phase m alone."""
    rec = _stream_sharded_work(rank, world, out_dir)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump({"stream_sharded": rec}, f)


def stream_sharded_report(recs: list, cards: int, one_card: dict) -> dict:
    """Phase m's lines from every rank's record and ``one_card``'s stream,
    and its record."""
    one = one_card["digest"]
    for r in recs:
        log(f"stream sharded: rank {r['rank']} on {r['device']}: joint_1e7 "
            f"({r['n_cells']} joint cells, {r['chunk_cells']} stream cells "
            f"a dispatch, {r['peak_cells_per_chunk']} joint cells) in "
            f"{r['dispatches']} dispatches ({r['pad_cells']} padded cells "
            f"in all), {r['wall_s']:.3f} s wall (set-up "
            f"{r['wall_s'] - r['elapsed_s']:.3f} s, runner "
            f"{r['elapsed_s']:.3f} s, marshal {r['marshal_s']:.3f} s, "
            f"overlap_frac {r['overlap_frac']:.4f}); reduction "
            f"{r['reduce_s']:.4f} s for {r['reduce_bytes']} bytes over "
            f"{r['backend']} (transport {r['transport']}); launches "
            f"{r['launches']}; peak {r['peak_gib']:.4f} GiB; digest "
            f"{r['digest_s']:.2f} s; phase m on the rank {r['phase_s']:.2f} "
            f"s; catalog {r['catalog']}")
    log(f"stream sharded: {len(recs)} ranks on {cards} card(s): winners, "
        f"win counts {one['win_counts']} and bests bitwise equal to one "
        f"card's stream on every rank; the constrained catalog stream "
        f"({recs[0]['catalog']['cells']} cells, "
        f"{recs[0]['catalog']['dispatches']} dispatches a rank) bitwise "
        f"equal to one card's, (none) {recs[0]['catalog']['none_cells']} "
        f"[{card_line()}]")
    return {"world": len(recs), "cards": cards, "ranks": recs,
            "one_card_dispatches": one["n_dispatches"],
            "one_card_wall_s": one_card["wall_s"]}


def phase_stream_sharded() -> dict:
    """Phase m alone (``--stream-sharded``): a world of four ranks (NCCL
    with a card a rank, else gloo in host memory) for
    :func:`_stream_sharded_work`."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as mesh_mod
    world, cards = 4, torch.cuda.device_count()
    out_dir = tempfile.mkdtemp(prefix="repro_torch_stream_")
    one_card = one_card_stream()
    try:
        with open(Path(out_dir) / "one_card.json", "w") as f:
            json.dump(one_card, f)
        log(f"stream sharded: {world} ranks on {cards} card(s), backend "
            f"{mesh_mod.backend_for('cuda', world)}")
        t0 = time.perf_counter()
        mesh_mod.spawn(_stream_rank, world, (out_dir,), device="cuda")
        spawn_s = time.perf_counter() - t0
        recs = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())[
            "stream_sharded"] for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rec = stream_sharded_report(recs, cards, one_card)
    rec["spawn_wall_s"] = spawn_s
    return rec


def phase_perturbation() -> dict:
    """The perturbation axes on the card against the CPU: a
    ``catalog_param x phy x read_fraction x shoreline_mm`` evaluation and
    a ``protocol_param`` space under ADAPTIVE_SIM (labels equal, numbers
    within 1e-6), ``sweep_perturbed`` under ADAPTIVE_SIM against FIXED_SIM
    (within 1e-3), and a constrained analytic stream against the card's
    materialized frontier."""
    log("perturbation axes on the card")
    cat_axes = [axis("catalog_param", [{}, {"power_pj_per_bit": 0.8},
                                       {"linear_density_gbs_mm": 1.25,
                                        "areal_density_gbs_mm2": 0.5}]),
                axis("phy", list(JOINT_PHYS)),
                axis("read_fraction", list(np.linspace(0.0, 1.0, 41))),
                axis("shoreline_mm", [2.0, 4.0, 8.0, 16.0])]
    metrics = ("bandwidth_gbs", "pj_per_bit", "power_w", "gbs_per_watt",
               "linear_density_gbs_mm", "areal_density_gbs_mm2",
               "approach_pj_per_bit")
    res = {d: DesignSpace(cat_axes, device=d).evaluate(metrics=metrics)
           for d in ("cuda", "cpu")}
    err_cat = max(close(f"catalog_param {m} card vs CPU",
                        res["cuda"][m].values, res["cpu"][m].values, 1e-6)
                  for m in metrics)
    cons = SelectionConstraints(**CAT_STREAM_CONS)
    fronts = [r.frontier("bandwidth_gbs", where=r.feasible(cons)).values
              for r in res.values()]
    if not np.array_equal(fronts[0], fronts[1]):
        raise AssertionError("catalog_param frontier differs between the "
                             "card and the CPU")
    sim_axes = [axis("protocol_param", [{}, {"g_slots": 2.0},
                                        {"credit_lines": 0.5},
                                        {"read_lanes": 0.8,
                                         "total_lanes": 1.2}]),
                axis("phy", list(JOINT_PHYS)),
                axis("backlog", [1.0, 2.0, 8.0, 64.0]),
                axis("read_fraction", list(np.linspace(0.0, 1.0, 21)))]
    runs: dict = {}
    reset_counts()
    with runner_times(runs):
        card = DesignSpace(sim_axes, sim=ADAPTIVE_SIM, device="cuda")\
            .evaluate(metrics=("sim_bandwidth_gbs",))["sim_bandwidth_gbs"]
    torch.cuda.synchronize()
    counts = read_counts()
    one_launch_per_run("the protocol_param space", counts, runs)
    if counts["asymmetric_periodic"] <= 0 or \
            counts["symmetric_periodic"] + counts["symmetric_run"] <= 0:
        raise AssertionError(f"the protocol_param space launched {counts}")
    cpu = DesignSpace(sim_axes, sim=ADAPTIVE_SIM, device="cpu").evaluate(
        metrics=("sim_bandwidth_gbs",))["sim_bandwidth_gbs"]
    err_sim = close("protocol_param adaptive card vs CPU", card.values,
                    cpu.values, 1e-6)
    if not np.array_equal(card.argbest("protocol").values,
                          cpu.argbest("protocol").values):
        raise AssertionError("protocol_param winners differ between the "
                             "card and the CPU")
    perts = [{}, {"credit_lines": 0.5}, {"g_slots": 0.8},
             {"read_lanes": 0.8, "total_lanes": 1.2}]
    kw = dict(mixes=[(1, 0), (2, 1), (1, 1), (1, 3), (0, 1)],
              backlogs=[2.0, 16.0, 64.0], device="cuda")
    ada = flitsim.sweep_perturbed(perts, sim=ADAPTIVE_SIM, **kw)[
        "sim_efficiency"].values
    fix = flitsim.sweep_perturbed(perts, **kw)["sim_efficiency"].values
    err_sweep = close("sweep_perturbed adaptive vs fixed", ada, fix, 1e-3)
    cat_space = catalog_stream_space("cuda")
    ref = cat_space.evaluate(metrics=("bandwidth_gbs", "power_w"))
    csr = cat_space.evaluate(metrics=("bandwidth_gbs",), stream=StreamConfig(
        chunk_cells=CAT_STREAM_CHUNK, constraints=cons))
    if not np.array_equal(csr.winners.values, ref.frontier(
            "bandwidth_gbs", where=ref.feasible(cons)).values):
        raise AssertionError("the streamed analytic frontier differs from "
                             "the card's materialized one")
    log(f"perturbation axes: catalog_param card vs CPU max |diff| "
        f"{err_cat}, frontiers equal; protocol_param ADAPTIVE_SIM "
        f"(sim_bandwidth_gbs) card vs CPU max |diff| {err_sim}, winners "
        f"equal, launches {counts}; sweep_perturbed adaptive vs fixed max "
        f"|diff| {err_sweep}; constrained analytic stream "
        f"({csr.n_dispatches} dispatches) equal to the materialized "
        f"frontier")
    return {"perturbation": {"catalog_max_abs": err_cat,
                             "protocol_param_max_abs": err_sim,
                             "sweep_adaptive_vs_fixed": err_sweep,
                             "launches": counts}}


def phase_fig13():
    """The Fig-13 pipelining space on the card (adaptive: the fused
    ``pipelining_chunk`` loop) against the CPU and the fixed engine."""
    axes = [axis("k", FIG13_KS), axis("ucie_line_ui", FIG13_US),
            axis("device_line_ui", FIG13_DS)]
    log("main path: Fig-13 pipelining space on the card")
    runs: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    with runner_times(runs):
        res = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cuda").evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if counts["pipelining_run"] != 1:
        raise AssertionError(f"the Fig-13 space launched pipelining_run "
                             f"{counts['pipelining_run']} times (want 1)")
    elapsed = one_launch_per_run("the Fig-13 space", counts, runs)
    util = res["utilization"].values
    cpu = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cpu").evaluate()
    err_cpu = close("Fig-13 card vs CPU", util,
                    cpu["utilization"].values, 1e-6)
    fixed = DesignSpace(axes, device="cuda").evaluate()
    err_fixed = close("Fig-13 adaptive vs fixed", util,
                      fixed["utilization"].values, 1e-3)
    u4 = flitsim.simulate_lpddr6_pipelining(4, device="cuda")
    close("simulate_lpddr6_pipelining(4)", [u4], [1.0], 1e-3)
    sat = {}
    for a, u in enumerate(FIG13_US):
        for b, d in enumerate(FIG13_DS):
            ok = np.flatnonzero(util[:, a, b] >= 1.0 - 1e-3)
            sat[f"u={u:g},d={d:g}"] = int(FIG13_KS[ok[0]]) if ok.size \
                else None
    log(f"main path: Fig-13 space in {wall:.3f} s, launches {counts}, "
        f"adaptive runs {elapsed}; "
        f"card vs CPU max |diff| {err_cpu}, vs fixed {err_fixed}; "
        f"simulate_lpddr6_pipelining(4) = {u4}; smallest saturating k "
        f"per (ucie_line_ui, device_line_ui): {sat}")
    return counts


def phase_sweep():
    """The explorer's ``--sweep`` on the card against the CPU."""
    log("main path: --sweep on the card")
    runs: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    with runner_times(runs):
        card = sweep_mode(device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for name in ("symmetric_run", "asymmetric_periodic"):
        if counts[name] <= 0:
            raise AssertionError(f"the sweep never launched {name}")
    one_launch_per_run("the sweep", counts, runs)
    cpu = sweep_mode(device="cpu", verbose=False)
    for key in ("regimes", "catalog_regimes", "protocols"):
        if card[key] != cpu[key]:
            raise AssertionError(f"sweep {key} differ between the card and "
                                 f"the CPU")
    err = close("sweep efficiency card vs CPU", card["efficiency"],
                cpu["efficiency"], 1e-6)
    engines = {fam: {k: info[k] for k in ("engine", "launches",
                                          "stragglers", "elapsed_s")}
               for fam, info in card["run_info"].items()
               if fam != "flitsim.pipelining"}
    log(f"main path: --sweep on the card in {wall:.3f} s (simulated part "
        f"{card['sim_s']:.3f} s; engines {engines}), launches {counts}; "
        f"regimes equal to the CPU run, efficiency max |diff| {err}; "
        f"backlog-64 regimes {card['regimes']}")
    return counts


def _flat(q) -> list:
    """Every number of a quickstart result, in a fixed order."""
    out = []
    for key in ("linear_density", "pj_per_bit"):
        for vals in q[key].values():
            out += vals
    out += list(q["bus_density"].values())
    out += list(q["latency_speedup"].values())
    for r in q["sim_vs_analytic"].values():
        out += [r["analytic"], r["simulated"]]
    out += [r["bandwidth_gbs"] for r in q["ranking"]]
    out.append(q["best"]["gbs_per_watt"])
    return out


def phase_quickstart():
    log("main path: quickstart on the card")
    reset_counts()
    t0 = time.perf_counter()
    card = quickstart.collect("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    cpu = quickstart.collect("cpu")
    if [r["key"] for r in card["ranking"]] != \
            [r["key"] for r in cpu["ranking"]] or \
            card["best"]["key"] != cpu["best"]["key"]:
        raise AssertionError("quickstart ranking differs between the card "
                             "and the CPU")
    err = close("quickstart card vs CPU", _flat(card), _flat(cpu), 1e-6)
    log(f"main path: quickstart on the card in {wall:.3f} s, launches "
        f"{counts}; values max |diff| vs CPU {err}; best "
        f"{card['best']['key']}")
    return counts


def phase_flit_pack():
    log(f"main path: flit data path, {PACK_MAIN_LINES} lines")
    args = pack_inputs(PACK_MAIN_LINES, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    flits = pack_ops.pack(*args)
    round_trip("flit data path", flits, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    hold("flit data path", flits, pack_ref.pack_flits_ref(*args))
    if counts["pack_flits"] <= 0:
        raise AssertionError("the flit data path never launched pack_flits")
    log(f"main path: {flits.shape[0]} flits packed and unpacked in "
        f"{wall:.4f} s, bitwise equal to the plain version, every checksum "
        f"good; launches {counts}")
    return counts


# -- the LM serving slice: flash attention, RG-LRU scan, serving -----------

#: flash-attention cases held against the plain version: tests/test_kernels.py's
#: shapes (b, k, g, sq, skv, hd, causal, window, q_offset, dtype), then the
#: serving runs' prefill shapes (the launchers' prompts of 4-11 tokens, a
#: long prompt), a 512-token smollm-360m prefill and a continuation chunk
#: (q_offset > 0), each of these in bf16 as served and in f32
FA_CASES = {
    "causal 2x2x3 128": (2, 2, 3, 128, 128, 64, True, 0, 0, "f32"),
    "causal 1x1x1 256 hd128": (1, 1, 1, 256, 256, 128, True, 0, 0, "f32"),
    "causal 2x2x2 96": (2, 2, 2, 96, 96, 64, True, 0, 0, "f32"),
    "causal 64 vs 192": (1, 1, 2, 64, 192, 64, True, 0, 128, "f32"),
    "window 16": (1, 2, 2, 128, 128, 64, True, 16, 0, "f32"),
    "window 32": (1, 2, 2, 128, 128, 64, True, 32, 0, "f32"),
    "window 64": (1, 2, 2, 128, 128, 64, True, 64, 0, "f32"),
    "cross": (2, 1, 1, 64, 160, 64, False, 0, 0, "f32"),
    "dtype f32": (1, 1, 2, 64, 64, 64, True, 0, 0, "f32"),
    "dtype bf16": (1, 1, 2, 64, 64, 64, True, 0, 0, "bf16"),
}
FA_SERVING = {
    "recurrentgemma-2b launcher prompt": (1, 1, 10, 7, 7, 256, True, 2048, 0),
    "smollm-360m launcher prompt": (1, 5, 3, 7, 7, 64, True, 0, 0),
    "recurrentgemma-2b long prompt": (1, 1, 10, 2304, 2304, 256, True, 2048,
                                      0),
    "smollm-360m 512 tokens": (1, 5, 3, 512, 512, 64, True, 0, 0),
    "recurrentgemma-2b continuation": (1, 1, 10, 256, 2304, 256, True, 2048,
                                       2048),
    "olmoe-1b-7b launcher prompt": (1, 16, 1, 7, 7, 128, True, 0, 0),
    "olmoe-1b-7b long prompt": (1, 16, 1, 2300, 2300, 128, True, 0, 0),
    "llama4-scout 300 tokens": (1, 8, 5, 300, 300, 128, True, 0, 0),
    "internvl2-1b 256 + 40": (1, 2, 7, 296, 296, 64, True, 0, 0),
    "internvl2-1b 256 + 300": (1, 2, 7, 556, 556, 64, True, 0, 0),
    "seamless encoder 37": (1, 16, 1, 37, 37, 64, False, 0, 0),
    "seamless encoder 1000": (1, 16, 1, 1000, 1000, 64, False, 0, 0),
    "seamless cross 40 x 37": (1, 16, 1, 40, 37, 64, False, 0, 0),
    "seamless cross 40 x 1000": (1, 16, 1, 40, 1000, 64, False, 0, 0),
    "seamless cross 300 x 37": (1, 16, 1, 300, 37, 64, False, 0, 0),
}
FA_CASES.update({label + ("" if dt == "bf16" else " f32"): case + (dt,)
                 for dt in ("bf16", "f32")
                 for label, case in FA_SERVING.items()})
#: tolerances against the plain version: f32 as tests/test_kernels.py; bf16
#: one output ulp (both round an f32 result once, and the two f32 results
#: agree to ~1e-6: atol covers the ulp of 2^-8 below 1, rtol the ulp above)
FA_TOL = {"f32": (3e-5, 1e-4), "bf16": (4e-3, 2.0 ** -7)}
#: the bf16 cases timed (with the library yardstick): the path's shape (the
#: recurrentgemma-2b launcher run, where the launches are read), the largest
#: (the long-prompt run's) and the other serving shapes
FA_PATH = "recurrentgemma-2b launcher prompt"
FA_LARGEST = "recurrentgemma-2b long prompt"
FA_TIMED = (FA_PATH, "smollm-360m launcher prompt", FA_LARGEST,
            "smollm-360m 512 tokens", "recurrentgemma-2b continuation",
            "olmoe-1b-7b launcher prompt", "olmoe-1b-7b long prompt",
            "llama4-scout 300 tokens", "internvl2-1b 256 + 300",
            "seamless encoder 1000", "seamless cross 40 x 1000")
#: RG-LRU scan shapes [B, S, C], each held bitwise: recurrentgemma-2b's
#: launcher prompt and long prompt, the long prompt plus a ragged tile,
#: four rows of 4096, C % 4 != 0 (the cp.async copies), C below one
#: block's width, small shapes, one step, and a view one element into its
#: storage (LRU_OFFSET: not 16-byte aligned, so cp.async)
LRU_CASES = {"recurrentgemma-2b launcher prompt": (1, 7, 2560),
             "recurrentgemma-2b long prompt": (1, 2304, 2560),
             "long prompt + 1": (1, 2305, 2560),
             "4 x 4096": (4, 4096, 2560),
             "C 37": (2, 300, 37),
             "C 12": (1, 129, 12),
             "3 x 77 x 40": (3, 77, 40),
             "one step": (2, 1, 8),
             "offset view": (1, 256, 2560)}
LRU_OFFSET = {"offset view": 1}
LRU_PATH = "recurrentgemma-2b launcher prompt"
LRU_LARGEST = "4 x 4096"
#: timed three ways (one call, back to back, on the card alone)
LRU_TIMED = (LRU_PATH, "recurrentgemma-2b long prompt", LRU_LARGEST)
#: launches per prefill on the serving path (one per attention / recurrent
#: layer; none per decode step: the one-step recurrence and SSM step are
#: plain PyTorch)
PER_PREFILL = {"recurrentgemma-2b": {"flash_attention_fwd": 8,
                                     "rglru_scan": 18, "ssd_scan": 0},
               "smollm-360m": {"flash_attention_fwd": 32, "rglru_scan": 0,
                               "ssd_scan": 0},
               "mamba2-2.7b": {"flash_attention_fwd": 0, "rglru_scan": 0,
                               "ssd_scan": 64},
               "olmoe-1b-7b": {"flash_attention_fwd": 16, "rglru_scan": 0,
                               "ssd_scan": 0},
               "internvl2-1b": {"flash_attention_fwd": 24, "rglru_scan": 0,
                                "ssd_scan": 0},
               # 24 encoder, 24 decoder and 24 cross attentions
               "seamless-m4t-large-v2": {"flash_attention_fwd": 72,
                                         "rglru_scan": 0, "ssd_scan": 0}}
#: decode-attention calls per decode step on one card: one a layer that
#: attends over a KV cache (an enc-dec decoder's self attention; its cross
#: attention is the plain ``attend_decode``)
PER_DECODE_STEP = {"recurrentgemma-2b": 8, "smollm-360m": 32,
                   "mamba2-2.7b": 0, "olmoe-1b-7b": 16, "internvl2-1b": 24,
                   "seamless-m4t-large-v2": 24}
#: bf16 tolerance of the card-vs-CPU model comparison: TOL_EPS bf16
#: epsilons (2^-7) of the largest CPU logit (tests/test_torch_models.py)
BF16_EPS = 2.0 ** -7
TOL_EPS = 8
#: the decode check of mamba2-2.7b's long prompts in f32 compute, relative
#: to the largest logit: 64 bf16 layers carry the rounding of two
#: computation orders (prefill + decode against one longer prefill) past
#: the bf16 bound, f32 compute does not; a fault in the carried states
#: would move the logits by their own size
F32_REL = 1e-3
#: the moe family served at full width and depth (16 layers, 64 experts,
#: top-8): the config's count over its 50,304-token vocabulary, and the
#: schema's with the embedding tables padded to 50,432 rows (the
#: reference's counts both); seamless-m4t-large-v2's frames in the
#: card-vs-CPU check
OLMOE = "olmoe-1b-7b"
OLMOE_PARAMS = (6_919_096_320, 6_919_620_608)
ENC_FRAMES = (37, 1000)


def fa_inputs(case, gen):
    b, k, g, sq, skv, hd, _, _, _, dt = case
    dtype = F32 if dt == "f32" else torch.bfloat16
    mk = lambda shape: torch.randn(shape, generator=gen, device=DEV).to(dtype)
    return mk((b, k, g, sq, hd)), mk((b, k, skv, hd)), mk((b, k, skv, hd))


def fa_ops_count(case) -> float:
    """Operations one flash-attention call needs: QK and PV at 2 per
    multiply-add for every visible (query, key) pair."""
    b, k, g, sq, skv, hd, causal, window, off, _ = case
    pairs = int(fa_ref.attention_mask(sq, skv, causal, window, off,
                                      DEV).sum().item())
    return 4.0 * b * k * g * pairs * hd


def fa_bound(case):
    """Least time of one flash-attention call: q, k, v read and out
    written once against ``fa_ops_count`` at the dense bf16 tensor-core
    rate."""
    b, k, g, sq, skv, hd, _, _, _, dt = case
    size = 4 if dt == "f32" else 2
    nbytes = size * (2 * b * k * g * sq * hd + 2 * b * k * skv * hd)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = fa_ops_count(case) / PEAK_BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_causal(case) -> bool:
    """The mask is plain causal from offset 0 (a window wider than the
    prompt cuts nothing), so ``is_causal=True`` computes the same."""
    _, _, _, sq, skv, _, causal, window, off, _ = case
    return causal and off == 0 and sq == skv and (window <= 0 or window >= sq)


def sdpa_ms(case, q, k, v, reps) -> dict:
    """The library yardstick: ``scaled_dot_product_attention`` on the same
    inputs with K/V expanded to the G heads and the same boolean mask; for
    a mask that hides nothing (non-causal) also with no mask, and for a
    plain causal mask also ``is_causal=True`` on the flash backend (timed
    only; the port never calls it).  ms of each form."""
    b, kh, g, sq, skv, hd, causal, window, off, _ = case
    qh = q.reshape(b, kh * g, sq, hd)
    kx = k[:, :, None].expand(b, kh, g, skv, hd).reshape(b, kh * g, skv, hd)
    vx = v[:, :, None].expand(b, kh, g, skv, hd).reshape(b, kh * g, skv, hd)
    mask = fa_ref.attention_mask(sq, skv, causal, window, off, DEV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=off)
    got = sdpa(qh, kx, vx, attn_mask=mask).reshape(want.shape)
    close("scaled_dot_product_attention vs plain", got.float().cpu(),
          want.float().cpu(), 3e-2)
    out = {"masked": time_ms(lambda: sdpa(qh, kx, vx, attn_mask=mask), reps)}
    if bool(mask.all()):
        got = sdpa(qh, kx, vx).reshape(want.shape)
        close("scaled_dot_product_attention (no mask) vs plain",
              got.float().cpu(), want.float().cpu(), 3e-2)
        out["no_mask"] = time_ms(lambda: sdpa(qh, kx, vx), reps)
    if plain_causal(case):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            got = sdpa(qh, kx, vx, is_causal=True).reshape(want.shape)
            close("scaled_dot_product_attention (flash, is_causal) vs plain",
                  got.float().cpu(), want.float().cpu(), 3e-2)
            out["is_causal_flash"] = time_ms(
                lambda: sdpa(qh, kx, vx, is_causal=True), reps)
    return out


def ptxas_instances(log: str, kernel: str) -> dict:
    """ptxas's report of each instance of ``kernel`` in a build log:
    ``{"kernel<args>": {"registers": n, "stack": bytes, "spill_stores":
    bytes, "spill_loads": bytes}}`` (``"kernel"`` where it is no
    template)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            hit = re.search(rf"({kernel}\w*?)I((?:Li\d+E)+)E", m.group(1))
            if hit:
                args = ", ".join(re.findall(r"Li(\d+)E", hit.group(2)))
                name = f"{hit.group(1)}<{args}>"
                out[name] = {}
            elif re.search(rf"\d{kernel}E", m.group(1)):
                name = kernel               # not a template
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name]["stack"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
            out[name]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_lm_kernels():
    """flash_attention_fwd against its plain version on the card; timings
    at the serving path's shapes."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    records = {"flash_attention_fwd": {}}
    log_text = _build.BUILD_LOG.get("flash_attention")
    if log_text is None:
        log("ptxas [flash_attention]: library was already built, no report")
    else:
        insts = ptxas_instances(log_text, "flash_fwd_kernel")
        for name, rep in insts.items():
            log(f"ptxas {name}: {rep.get('registers')} registers, "
                f"{rep.get('spill_stores')} bytes spill stores, "
                f"{rep.get('spill_loads')} bytes spill loads")
        if not any("bf16" in name for name in insts):
            raise AssertionError("no bf16 flash instance in the ptxas report")
        spills = [n for n, r in insts.items() if "bf16" in n and
                  (r.get("spill_stores", 1) or r.get("spill_loads", 1))]
        if spills:
            raise AssertionError(f"the tensor-core flash kernel spills: "
                                 f"{spills}")
        records["flash_attention_fwd"]["ptxas"] = insts
    err_all = 0.0
    for label, case in FA_CASES.items():
        causal, window, off, dt = case[6:]
        q, k, v = fa_inputs(case, gen)
        got = fa_ops.flash_attention(q, k, v, causal, window, off)
        torch.cuda.synchronize()
        want = fa_ref.attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=off)
        if got.dtype != q.dtype or got.shape != want.shape:
            raise AssertionError(f"flash_attention_fwd {label}: dtype or "
                                 f"shape differs from the plain version")
        g32, w32 = got.float(), want.float()
        atol, rtol = FA_TOL[dt]
        if not torch.isfinite(g32).all() or \
                not torch.allclose(g32, w32, atol=atol, rtol=rtol):
            raise AssertionError(f"flash_attention_fwd {label}: differs from "
                                 f"its plain version beyond atol {atol} "
                                 f"rtol {rtol} (max |diff| "
                                 f"{(g32 - w32).abs().max().item()})")
        err = float((g32 - w32).abs().max().item())
        err_all = max(err_all, err)
        rec = dict(case=list(case), max_abs_err=err,
                   rms_out=float(w32.square().mean().sqrt().item()))
        if label in FA_TIMED:
            rec["ms"] = time_ms(lambda: fa_ops.flash_attention(
                q, k, v, causal, window, off), 20)
            rec["plain_ms"] = time_ms(lambda: fa_ref.attention_ref(
                q, k, v, causal=causal, window=window, q_offset=off), 5)
            rec["sdpa_ms"] = sdpa_ms(case, q, k, v, 20)
            rec["library_ms"] = min(rec["sdpa_ms"].values())
            rec["bound_ms"], rec["bound_by"] = fa_bound(case)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["tflops"] = fa_ops_count(case) / rec["ms"] * 1e-9
        records["flash_attention_fwd"][label] = rec
        log(f"kernel flash_attention_fwd @ {label} {case}: max |diff| vs "
            f"plain {err:.3g} (atol {atol}, rtol {rtol}; rms of the output "
            f"{rec['rms_out']:.3g})"
            + (f"; kernel {rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s, "
               f"{100 * rec['share_of_bound']:.1f}% of its bound), plain "
               f"{rec['plain_ms']:.4f} ms, scaled_dot_product_attention "
               + ", ".join(f"{form} {t:.4f} ms"
                           for form, t in rec["sdpa_ms"].items())
               + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
               if "ms" in rec else ""))
    records["flash_attention_fwd"]["max_abs_err"] = err_all

    return records


def lru_bound(shape):
    """Least time of one RG-LRU scan: log_a and b read and h written once
    (12 bytes an element) against 3 f32 operations an element."""
    n = shape[0] * shape[1] * shape[2]
    t_bytes = 12.0 * n / PEAK_BYTES_PER_S * 1e3
    t_ops = 3.0 * n / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_lru_kernel():
    """rglru_scan against its plain version on the card, bitwise at every
    case (the kernel keeps the plain version's order); ptxas's registers
    and spills (a spill fails the run); one-call, back-to-back and
    on-card times with the share of the bound."""
    log_text = _build.BUILD_LOG.get("rglru_scan")
    records = {}
    if log_text is None:
        log("ptxas [rglru_scan]: library was already built, no report")
    else:
        insts = ptxas_instances(log_text, "rglru_scan_kernel")
        for name, rep in insts.items():
            log(f"ptxas {name}: {rep.get('registers')} registers, "
                f"{rep.get('spill_stores')} bytes spill stores, "
                f"{rep.get('spill_loads')} bytes spill loads")
        if len(insts) != 1:
            raise AssertionError(f"rglru_scan: ptxas reported {len(insts)} "
                                 f"kernel instances")
        spills = [n for n, r in insts.items()
                  if r.get("spill_stores", 1) or r.get("spill_loads", 1)]
        if spills:
            raise AssertionError(f"rglru_scan kernel spills: {spills}")
        records["ptxas"] = insts
    gen = torch.Generator(device=DEV).manual_seed(17)
    err_all = 0.0
    for label, shape in LRU_CASES.items():
        off = LRU_OFFSET.get(label, 0)
        n = shape[0] * shape[1] * shape[2]
        log_a = (-torch.rand(n + off, generator=gen, device=DEV)
                 * 2.0)[off:].view(shape)
        b = torch.randn(n + off, generator=gen, device=DEV)[off:].view(shape)
        p = lru_kernel.plan(shape, (log_a.data_ptr(), b.data_ptr()))
        got = lru_ops.lru(log_a, b)
        want = lru_ref.lru_ref(log_a, b)
        err = hold(f"rglru_scan {label} {shape}", got, want)
        err_all = max(err_all, err)
        rec = dict(shape=list(shape), offset=off, max_abs_err=err,
                   plan=p._asdict())
        msg = ""
        if label in LRU_TIMED:
            call = lambda: lru_ops.lru(log_a, b)
            rec["ms"] = time_ms(call, 20)
            rec["stream_ms"] = stream_ms(call, 20)
            rec["device_ms"] = kernel_ms(call, r"(rglru_scan)_kernel")[
                "rglru_scan"]
            rec["plain_ms"] = time_ms(lambda: lru_ref.lru_ref(log_a, b), 3)
            rec["bound_ms"], rec["bound_by"] = lru_bound(shape)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["share_of_bound_device"] = rec["bound_ms"] / rec["device_ms"]
            msg = (f"; one call {rec['ms']:.4f} ms, back to back "
                   f"{rec['stream_ms']:.4f} ms, on the card "
                   f"{rec['device_ms']:.4f} ms ({rec['share_of_bound']:.1%} "
                   f"/ {rec['share_of_bound_device']:.1%} of the bound "
                   f"{rec['bound_ms']:.4f} ms, {rec['bound_by']}), plain "
                   f"{rec['plain_ms']:.4f} ms")
        records[label] = rec
        log(f"kernel rglru_scan @ {label} {shape}: bitwise equal to plain "
            f"({p.route}, width {p.width}, {p.blocks} blocks, tile "
            f"{p.tile} x {p.width}, {p.stages} stages){msg}")
    records["max_abs_err"] = err_all
    records["bitwise"] = True
    return records


#: SSD scan cases (B, S, H, P, N, chunk of the plain chunked form):
#: tests/test_kernels.py's four shapes, then mamba2-2.7b's (80 heads, P 64,
#: N 128, chunk 256): the launcher prompt, a 2048-token prefill, a ragged
#: 2100 tokens and four rows of 2048; then slow-decay and initial-state
#: variants (SSD_SLOW, SSD_INIT); then the edges of the kernel's 128-step
#: chunk (1, 127, 128, 129 and 3 x 128 + 5 steps), N 16 and 32, P 80 (a
#: 64-column tile and a ragged one) and four rows under a slow decay from
#: a given state
SSD_CASES = {"test 2x64x4 P16 N8": (2, 64, 4, 16, 8, 16),
             "test 1x128x2 P32 N16": (1, 128, 2, 32, 16, 32),
             "test 2x96x3 P16 N8": (2, 96, 3, 16, 8, 32),
             "test 1x64x1 P64 N32": (1, 64, 1, 64, 32, 64),
             "mamba2-2.7b launcher prompt": (1, 7, 80, 64, 128, 256),
             "mamba2-2.7b 2048 tokens": (1, 2048, 80, 64, 128, 256),
             "mamba2-2.7b ragged 2100 tokens": (1, 2100, 80, 64, 128, 256),
             "4 x 2048": (4, 2048, 80, 64, 128, 256),
             "test 2x96x3 P16 N8 slow": (2, 96, 3, 16, 8, 32),
             "test 2x64x4 P16 N8 slow init": (2, 64, 4, 16, 8, 16),
             "mamba2-2.7b launcher prompt init": (1, 7, 80, 64, 128, 256),
             "mamba2-2.7b 2048 tokens slow": (1, 2048, 80, 64, 128, 256),
             "mamba2-2.7b ragged 2100 tokens slow":
                 (1, 2100, 80, 64, 128, 256),
             "mamba2-2.7b ragged 2100 tokens slow init":
                 (1, 2100, 80, 64, 128, 256),
             "mamba2-2.7b 1 token": (1, 1, 80, 64, 128, 256),
             "mamba2-2.7b 127 tokens": (1, 127, 80, 64, 128, 256),
             "mamba2-2.7b 128 tokens": (1, 128, 80, 64, 128, 256),
             "mamba2-2.7b 129 tokens": (1, 129, 80, 64, 128, 256),
             "mamba2-2.7b 389 tokens": (1, 389, 80, 64, 128, 256),
             "389 tokens N16": (1, 389, 80, 64, 16, 256),
             "389 tokens N32": (1, 389, 80, 64, 32, 256),
             "389 tokens P80": (1, 389, 80, 80, 128, 256),
             "4 x 300 slow init": (4, 300, 80, 64, 128, 256)}
#: cases with dt = softplus(N(0, 1) + SSD_SLOW_DT), about 0.011, as trained
#: Mamba2 step sizes are, so a 64-step chunk decays by about 0.5 (a
#: 128-step one by about 0.25) and the state carried from chunk to chunk
#: counts (with dt = softplus(N(0, 1)) a 64-step chunk hands on about
#: exp(-51) of it) ...
SSD_SLOW = tuple(k for k in SSD_CASES if " slow" in k)
SSD_SLOW_DT = -5.0
#: ... and with a random initial state (a continued prefill)
SSD_INIT = tuple(k for k in SSD_CASES if k.endswith(" init"))
#: held to the reference's own tolerance (tests/test_kernels.py) ...
SSD_TOL = (5e-5, 1e-4)
#: ... the full-width shapes to a bound relative to the largest |y| (and
#: |final state|), written down before the first run: the reference's rtol
SSD_REL = 1e-4
#: also held against the sequential oracle ssd_ref (every case is held
#: against ssd_chunked)
SSD_ORACLE = tuple(k for k in SSD_CASES
                   if k.startswith("test") or "launcher" in k
                   or "ragged" in k or "2048" not in k)
SSD_PATH = "mamba2-2.7b launcher prompt"
SSD_LARGEST = "4 x 2048"
SSD_TIMED = (SSD_PATH, "mamba2-2.7b 2048 tokens",
             "mamba2-2.7b ragged 2100 tokens", SSD_LARGEST)


def ssd_ops_per_step(s, h, p, n):
    """The fewest f32 operations per step and head that the SSD function
    needs, whatever the kernel's own chunk: the smaller of the
    recurrence's 5 N P (state = a state + dt x B^T: a product and an FMA
    per element; y = state C: an FMA) and the chunked form at its best
    chunk Q, (Q + 1) (P + N / H) + 4 N P + 2 N P / Q (the lower triangles
    of C B^T, shared by the H heads of one group, and of M x; the chunk's
    states and C state^T; the recurrence over chunk states).  Elementwise
    terms of order P + N are left out.  At mamba2-2.7b's P 64, N 128,
    H 80: 40,960 against 34,907 at Q = 16."""
    chunked = min((q + 1) * (p + n / h) + 4 * n * p + 2 * n * p / q
                  for q in range(1, max(s, 1) + 1))
    return min(5.0 * n * p, chunked)


def ssd_bound(case):
    """Least time of one SSD scan on the route the kernel takes: x, dt, b,
    c, a_log read and y and the final state written once, against
    :func:`ssd_ops_per_step` operations per step and head run as 3xTF32 on
    the tensor cores (three TF32 products for each f32 one, at the dense
    TF32 rate).  Returns (ms, "bytes" or "operations", the f32 bound: the
    same operations at the f32 CUDA-core rate, ms)."""
    bsz, s, h, p, n, _ = case
    nbytes = 4.0 * (2 * bsz * s * h * p + bsz * s * h + 2 * bsz * s * n + h
                    + bsz * h * p * n)
    ops_ = bsz * h * s * ssd_ops_per_step(s, h, p, n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tf32 = 3 * ops_ / PEAK_TF32_OPS_PER_S * 1e3
    f32_ms = max(t_bytes, ops_ / PEAK_F32_OPS_PER_S * 1e3)
    if t_bytes >= t_tf32:
        return t_bytes, "bytes", f32_ms
    return t_tf32, "operations", f32_ms


def ssd_inputs(case, gen, slow=False, init=False):
    """x, dt, b, c, a_log and the initial state (None unless ``init``)."""
    bsz, s, h, p, n, _ = case
    rn = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    dt = torch.nn.functional.softplus(rn(bsz, s, h)
                                      + (SSD_SLOW_DT if slow else 0.0))
    return (rn(bsz, s, h, p), dt, rn(bsz, s, n) * 0.5, rn(bsz, s, n) * 0.5,
            rn(h) * 0.3, rn(bsz, h, p, n) if init else None)


def kernel_ms(fn, pattern: str, calls: int = 5) -> dict:
    """Device ms a launch of each kernel whose name matches ``pattern``, by
    the pattern's first group, from ``torch.profiler`` over ``calls``
    calls: the mean over the launches the profiler recorded (it does not
    always record every launch; fewer are logged).  Where it records none
    in three tries and ``pattern`` names one kernel, CUDA events time the
    calls (logged)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, seen = {}, {}
        for evt in prof.events():
            m = re.search(pattern, evt.name)
            if evt.device_type == torch.autograd.DeviceType.CUDA and m:
                us[m.group(1)] = us.get(m.group(1), 0.0) + \
                    evt.time_range.elapsed_us()
                seen[m.group(1)] = seen.get(m.group(1), 0) + 1
        if us:
            short = {k: n for k, n in seen.items() if n < calls}
            if short:
                log(f"the profiler recorded {short} of {calls} calls' "
                    f"launches")
            return {k: us[k] / 1e3 / seen[k] for k in us}
    # it recorded nothing three times: a one-kernel call is timed with
    # CUDA events over the calls instead (launch gaps included)
    one = re.fullmatch(r"\((\w+)\)\w*", pattern)
    if one is None:
        raise AssertionError(f"the profiler saw no kernel {pattern}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / calls
    log(f"the profiler saw no kernel {pattern} in three tries; CUDA events "
        f"over {calls} calls: {ms:.4f} ms a call")
    return {one.group(1): ms}


def phase_ssd_kernel():
    """ssd_scan against its plain versions on the card (the chunked form
    at every case, the sequential oracle at the test shapes, the launcher
    prompt and the ragged 2100 steps; slow-decay and initial-state cases
    among them); timings at the serving shapes."""
    gen = torch.Generator(device=DEV).manual_seed(14)
    records, err_all = {}, 0.0
    for label, case in SSD_CASES.items():
        x, dt, b, c, a_log, s0 = ssd_inputs(case, gen, label in SSD_SLOW,
                                            label in SSD_INIT)
        chunk = min(case[5], case[1])
        y, fs = ssd_ops.ssd(x, dt, b, c, a_log, chunk, init_state=s0)
        torch.cuda.synchronize()
        plains = {"ssd_chunked": lambda: ssd_chunked(
            x, dt, b[:, :, None], c[:, :, None], a_log, chunk,
            init_state=s0)}
        if label in SSD_ORACLE:
            plains["ssd_ref"] = lambda: ssd_ref.ssd_ref(x, dt, b, c, a_log,
                                                        init_state=s0)
        test = label.startswith("test")
        # the mean decay over one of the kernel's 128-step chunks
        a = torch.exp(a_log) * dt[:, :min(128, case[1])].sum(1)
        rec = dict(case=list(case), max_abs_err=0.0,
                   chunk_decay=float(torch.exp(-a).mean().item()),
                   max_abs_y=float(y.abs().max().item()),
                   max_abs_state=float(fs.abs().max().item()))
        for pname, plain in plains.items():
            wy, wfs = plain()
            for what, got, want in (("y", y, wy), ("state", fs, wfs)):
                err = float((got - want).abs().max().item())
                if test:
                    atol, rtol = SSD_TOL
                    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
                    limit = f"atol {atol} rtol {rtol}"
                else:
                    bound = SSD_REL * float(want.abs().max().item())
                    ok = err <= bound
                    limit = f"{SSD_REL} of max |{what}| = {bound:.3g}"
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"ssd_scan {label}: {what} differs from {pname} "
                        f"beyond {limit} (max |diff| {err})")
                rec[f"err_{what}_vs_{pname}"] = err
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
        err_all = max(err_all, rec["max_abs_err"])
        if label in SSD_TIMED:
            rec["ms"] = time_ms(lambda: ssd_ops.ssd(x, dt, b, c, a_log,
                                                    chunk), 20)
            rec["stream_ms"] = stream_ms(lambda: ssd_ops.ssd(x, dt, b, c,
                                                             a_log, chunk))
            rec["stage_ms"] = kernel_ms(lambda: ssd_ops.ssd(
                x, dt, b, c, a_log, chunk), r"ssd_scan_(\w+?)_kernel")
            rec["plain_ms"] = time_ms(plains["ssd_chunked"], 3)
            if "ssd_ref" in plains:
                rec["oracle_ms"] = time_ms(plains["ssd_ref"], 1)
            rec["bound_ms"], rec["bound_by"], rec["bound_f32_ms"] = \
                ssd_bound(case)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["share_of_f32_bound"] = rec["bound_f32_ms"] / rec["ms"]
        records[label] = rec
        errs = {k: f"{v:.3g}" for k, v in rec.items() if k.startswith("err_")}
        log(f"kernel ssd_scan @ {label} {case}: max |diff| {errs} (max |y| "
            f"{rec['max_abs_y']:.3g}, max |state| {rec['max_abs_state']:.3g}"
            f", mean decay of a 128-step chunk {rec['chunk_decay']:.3g})"
            + (f"; kernel {rec['ms']:.4f} ms ({rec['stream_ms']:.4f} ms a "
               f"call back to back), plain ssd_chunked "
               f"{rec['plain_ms']:.4f} ms"
               + (f", ssd_ref {rec['oracle_ms']:.2f} ms"
                  if "oracle_ms" in rec else "")
               + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
               f"3xTF32; {rec['share_of_bound']:.1%} of it), f32 bound "
               f"{rec['bound_f32_ms']:.4f} ms ({rec['share_of_f32_bound']:.1%}"
               f" of it); device ms a call by kernel "
               + json.dumps({k: round(v, 4) for k, v in
                             rec["stage_ms"].items()})
               if "ms" in rec else ""))
    records["max_abs_err"] = err_all
    return records


def serving_run(name, fn, arch, n_prefills):
    """Run ``fn`` with the launch counts at 0 around it; assert the serving
    path's launches; returns a record with the wall, tokens/s and peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    done = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: n * n_prefills for k, n in PER_PREFILL[arch].items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want} "
                             f"({n_prefills} prefills, none per decode step)")
    # a whole number of ticks of decode-attention calls, some if the
    # model attends over a KV cache
    per_step, calls = PER_DECODE_STEP[arch], counts["decode_attention"]
    if calls % max(per_step, 1) or (calls > 0) != (per_step > 0):
        raise AssertionError(f"{name}: {calls} decode-attention calls, not "
                             f"ticks of {per_step}")
    others = {k: v for k, v in counts.items()
              if k not in want and k != "decode_attention" and v}
    if others:
        raise AssertionError(f"{name}: unexpected launches {others}")
    tokens = sum(len(r.generated) for r in done)
    log(f"main path: {name}: {len(done)} requests, {tokens} tokens in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s), peak memory "
        f"{peak:.2f} GiB; launches {got}, decode attention {calls} "
        f"({calls // max(per_step, 1)} ticks of {per_step})")
    return dict(wall_s=wall, tokens=tokens, tok_per_s=tokens / wall,
                peak_gib=peak, launches=got, decode_attention_calls=calls)


def check_requests(name, done, n, new_tokens, vocab):
    if len(done) != n or any(len(r.generated) != new_tokens
                             or not all(0 <= t < vocab for t in r.generated)
                             for r in done):
        raise AssertionError(f"{name}: want {n} requests of {new_tokens} "
                             f"tokens in the vocabulary")


def phase_serving():
    """LM serving on the card: the launcher and the engine at full width,
    with their launches asserted, then full width at reduced depth on the
    card against the CPU."""
    runs = {}
    cfg = get_config("recurrentgemma-2b")
    try:
        serve_launcher.main(["--arch", "recurrentgemma-2b"])
    except ValueError as err:
        if "max_len=128" not in str(err) or "window=2048" not in str(err):
            raise
        log(f"main path: launcher at its default --max-len 128 refuses "
            f"recurrentgemma-2b (R4): {err}")
    else:
        raise AssertionError("the launcher served recurrentgemma-2b with "
                             "max_len 128 below its window of 2048")
    argv = ["--arch", "recurrentgemma-2b", "--requests", "8",
            "--batch-slots", "4", "--max-new-tokens", "16",
            "--max-len", "2048"]
    log(f"main path: launcher {' '.join(argv)}")
    out = {}
    runs["recurrentgemma-2b launcher"] = serving_run(
        "recurrentgemma-2b launcher",
        lambda: out.setdefault("r", serve_launcher.main(argv))["requests"],
        "recurrentgemma-2b", 8)
    check_requests("recurrentgemma-2b launcher", out["r"]["requests"], 8, 16,
                   cfg.vocab_size)

    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(2100, 2401, 4)]

    def long_prompts():
        eng = ServingEngine(model, params, batch_slots=4, max_len=2560,
                            device=DEV)
        for i, n in enumerate(lens):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
        return eng.run_until_drained()
    log(f"main path: recurrentgemma-2b engine, prompts of {lens} tokens, "
        f"max_len 2560")
    done = []
    runs["recurrentgemma-2b long prompts"] = serving_run(
        "recurrentgemma-2b long prompts",
        lambda: done.extend(long_prompts()) or done, "recurrentgemma-2b", 4)
    check_requests("recurrentgemma-2b long prompts", done, 4, 8,
                   cfg.vocab_size)
    runs["recurrentgemma-2b long prompts"]["prompt_lens"] = lens
    decode_check("recurrentgemma-2b long prompts", "the ring caches", model,
                 params, done)
    del model, params
    torch.cuda.empty_cache()

    argv = ["--arch", "smollm-360m"]
    log(f"main path: launcher {' '.join(argv)}")
    runs["smollm-360m launcher"] = serving_run(
        "smollm-360m launcher",
        lambda: out.setdefault("s", serve_launcher.main(argv))["requests"],
        "smollm-360m", 8)
    check_requests("smollm-360m launcher", out["s"]["requests"], 8, 16,
                   get_config("smollm-360m").vocab_size)
    torch.cuda.empty_cache()

    runs.update(phase_ssm_serving())
    runs["card vs CPU"] = {arch: card_vs_cpu(arch, layers)
                           for arch, layers in (("recurrentgemma-2b", 3),
                                                ("smollm-360m", 2),
                                                ("mamba2-2.7b", 2))}
    return runs


def phase_ssm_serving():
    """mamba2-2.7b at full width and depth: the launcher's traffic and an
    engine run with long prompts, at least two of them ragged (not a
    multiple of the 256-step chunk: the reference's fault R6), each with
    its ``ssd_scan`` launches asserted (64 per prefill, none per tick)."""
    arch = "mamba2-2.7b"
    cfg = get_config(arch)
    model = build_model(cfg)
    if cfg.num_layers != 64 or model.param_count() != 2_832_074_240:
        raise AssertionError(f"{arch}: {cfg.num_layers} layers, "
                             f"{model.param_count():,} parameters")
    runs, out = {}, {}
    argv = ["--arch", arch, "--requests", "8", "--batch-slots", "4",
            "--max-new-tokens", "16", "--max-len", "128"]
    log(f"main path: launcher {' '.join(argv)}")
    runs["mamba2-2.7b launcher"] = serving_run(
        "mamba2-2.7b launcher",
        lambda: out.setdefault("m", serve_launcher.main(argv))["requests"],
        arch, 8)
    check_requests("mamba2-2.7b launcher", out["m"]["requests"], 8, 16,
                   cfg.vocab_size)
    runs["mamba2-2.7b launcher"]["launcher_s"] = out["m"]["seconds"]
    del out
    torch.cuda.empty_cache()

    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(2000, 2401, 4)]
    if sum(n % 256 != 0 for n in lens) < 2:
        raise AssertionError(f"want two ragged prompts, got {lens}")

    def long_prompts():
        eng = ServingEngine(model, params, batch_slots=4, max_len=2560,
                            device=DEV)
        for i, n in enumerate(lens):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
        return eng.run_until_drained()
    log(f"main path: mamba2-2.7b engine, prompts of {lens} tokens, "
        f"max_len 2560")
    done = []
    runs["mamba2-2.7b long prompts"] = serving_run(
        "mamba2-2.7b long prompts", lambda: done.extend(long_prompts())
        or done, arch, 4)
    check_requests("mamba2-2.7b long prompts", done, 4, 8, cfg.vocab_size)
    runs["mamba2-2.7b long prompts"]["prompt_lens"] = lens
    runs["mamba2-2.7b long prompts"]["decode_check"] = decode_check(
        "mamba2-2.7b long prompts", "the SSM states", model, params, done,
        deep=True)
    del model, params
    torch.cuda.empty_cache()
    return runs


def real_vocab(name, logits, vocab: int):
    """The columns of the real vocabulary; fails unless the padding
    columns (a vocabulary that is not a multiple of 256, as mamba2-2.7b's
    50280) hold the model's mask value -1e9 exactly, so that they take no
    part in the tolerances below."""
    pad = logits[..., vocab:]
    mask = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
    if pad.numel() and not bool(torch.all(pad == mask)):
        raise AssertionError(f"{name}: padding logits are not -1e9")
    return logits[..., :vocab]


def within(name, got, want, rel=TOL_EPS * BF16_EPS, hold=True) -> float:
    """Fail unless ``got`` is within ``rel`` (TOL_EPS bf16 epsilons) of
    the largest |want|; returns the share of that tolerance used (only
    reported, not held, with ``hold=False``)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if not np.all(np.isfinite(got)) or (hold and err > tol):
        raise AssertionError(f"{name}: max |diff| {err} > {tol}")
    return err / tol


@contextlib.contextmanager
def compute_dtype(dtype):
    """The port's models compute on ``dtype`` operands inside the block
    (``models.layers.COMPUTE_DTYPE``, bf16 as served)."""
    served = model_layers.COMPUTE_DTYPE
    model_layers.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        model_layers.COMPUTE_DTYPE = served


def same_token(name, g: int, want) -> bool:
    """Whether token ``g`` is the greedy token of the logit row ``want``;
    a disagreement is allowed (False) only where ``g``'s logit is within
    the tolerance of the top one (a near tie), and fails otherwise."""
    want = want.float()
    w = int(torch.argmax(want))
    if g == w:
        return True
    gap = float(want[w] - want[g])
    if gap > TOL_EPS * BF16_EPS * float(want.abs().max()):
        raise AssertionError(f"{name}: greedy token {g} != {w}, {gap} "
                             f"below the top logit")
    return False


def decode_check(name, caches_are, model, params, done, deep=False):
    """The long-prompt requests again, one at a time: prefill, then the
    engine's tokens decoded against the caches; each greedy token equals
    the engine's (the engine decoded 4 slots at once) except at a near
    tie, and the last decode's logits equal a prefill of the prompt and the
    first 7 tokens (recurrentgemma-2b: the window of 2048 and the ring
    wrap in both; mamba2-2.7b: ragged prefills, decode steps carrying the
    SSM states).  Returns the worst share of each tolerance used.

    With ``deep`` (mamba2-2.7b's 64 layers) the bf16 logits' share of the
    bf16 bound is reported, not held: 64 bf16 layers carry the rounding of
    the two computation orders past it (the reference's own bf16 states
    move 9 epsilons from its f32 ones at two reduced layers,
    ``tests/test_torch_models.py``).  The logits are held instead with the
    model computing in f32, at ``F32_REL`` of the largest logit."""
    vocab = model.cfg.vocab_size

    def replay(req, ties=None):
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64), device=DEV)
        logits, caches = model.prefill(params, toks[None],
                                       pad_cache_to=2560)
        n = toks.shape[0]
        for j, tok in enumerate(req.generated[:-1]):
            if ties is not None:
                what = f"{name} check rid {req.rid} step {j}"
                if not same_token(what, tok,
                                  real_vocab(what, logits[0], vocab)):
                    ties.append((req.rid, j))
            logits, caches = model.decode_step(
                params, torch.tensor([[tok]], device=DEV), caches,
                torch.tensor([[n + j]], device=DEV))
        if ties is not None:
            what = f"{name} check rid {req.rid} last step"
            if not same_token(what, req.generated[-1],
                              real_vocab(what, logits[0], vocab)):
                ties.append((req.rid, len(req.generated) - 1))
        longer = torch.cat([toks, torch.as_tensor(
            req.generated[:-1], device=DEV)])[None]
        want, _ = model.prefill(params, longer)
        what = f"{name} check rid {req.rid}"
        return (what, real_vocab(what, logits, vocab),
                real_vocab(what, want, vocab))

    ties, out = [], {"bf16": 0.0}
    for req in done:
        out["bf16"] = max(out["bf16"], within(*replay(req, ties),
                                              hold=not deep))
    if deep:
        out["f32"] = 0.0
        with compute_dtype(torch.float32):
            for req in done:
                out["f32"] = max(out["f32"], within(*replay(req),
                                                    rel=F32_REL))
    log(f"main path: {name}: decode against {caches_are} gives the "
        f"engine's tokens"
        f"{'' if not ties else f' except near ties at {ties}'} and, after "
        f"7 tokens, the logits of the longer prefill: worst "
        f"{out['bf16']:.2f} of the bf16 bound ({TOL_EPS} epsilons"
        + ("; reported, not held)" if deep else ")")
        + (f", in f32 compute worst {out['f32']:.3f} of {F32_REL} of the "
           f"largest logit" if deep else ""))
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _merge_routes(reports: list, layers: int) -> list:
    """Per layer over all calls (:func:`routes.parted`'s reports): the
    smallest k-th/(k+1)-th gap, the tokens whose expert set or only its
    order differs, how many of them follow the router's input, the
    farthest apart the others' experts are on one input and the largest
    difference between the two routers on one input (f32 ulps)."""
    out = []
    for i in range(layers):
        rs = reports[i::layers]
        out.append(dict(min_gap=min(r["min_gap"] for r in rs),
                        **{key: sum(r[key] for r in rs)
                           for key in ("sets", "order", "by_input")},
                        **{key: max(r[key] for r in rs)
                           for key in ("ulps", "router_ulps")}))
    return out


def _routes_line(merged: list) -> str:
    return "; ".join(
        f"L{i} {r['min_gap']:.3g}, {r['sets']} / {r['order']}, "
        f"{r['by_input']}, {r['ulps']:.3g}, {r['router_ulps']:.3g}"
        for i, r in enumerate(merged))


ROUTES_KEY = ("smallest k-th/(k+1)-th gap, tokens whose expert set / only "
              "order differs, of them following the router input (one "
              "side's router on the other's input picks the other's "
              "experts), f32 ulps of the k-th probability between the "
              "rest's experts on one input (at most "
              f"{routes.TIE_ULPS}), largest difference between the two "
              "routers on one input in f32 ulps")


def hold_routed(name, row, want, diff, rerun):
    """Hold logit row ``row`` within the bf16 bound of ``want``.  For an
    moe model (``diff``: :func:`routes.parted`'s reports of the run that
    gave ``want`` against ``row``'s, which has failed unless every token
    whose expert choices differ follows the router's input) one such
    token can move a row by a whole expert's share: past the bound the
    choices must differ, and ``rerun()``, ``want``'s side again on
    ``row``'s experts, is held instead.  Returns (the share held, the
    share before the rerun or None)."""
    share = within(name, row, want, hold=diff is None)
    if share <= 1.0:
        return share, None
    if not any(r["sets"] or r["order"] for r in diff):
        raise AssertionError(f"{name}: {share:.2f} of the bf16 bound, "
                             f"routes {diff}")
    forced = within(name + " (on the same experts)", row, rerun())
    log(f"main path: {name}: an expert choice that follows the router's "
        f"input alone moves the logits to {share:.2f} of the bf16 bound; "
        f"on the same experts they are within {forced:.2f} of it")
    return forced, share


def card_vs_cpu(arch, layers, cases=((40, {}), (300, {}))):
    """Full width, ``layers`` layers (of the encoder and of the decoder of
    an encoder-decoder model), weights drawn on the card from seed 0 and
    copied to the CPU: prefill and four teacher-forced decode steps on
    both devices, for each case of (prompt tokens, extra prefill inputs:
    ``{"patch_embeds" or "frames": positions}``, drawn from seed 1).

    An moe model's router inputs and expert choices are recorded on both
    devices; a token whose k-th and (k+1)-th probabilities nearly tie may
    take another expert on each (the router's input is bf16, rounded in
    other orders).  Every such token must follow the router's input: the
    CPU's router on the card's input picks the card's experts
    (:func:`routes.parted`).  Per layer the smallest such gap and the
    tokens whose expert set (or only their order) differs are logged, and
    a row past the bound is held with the CPU on the card's experts
    (:func:`hold_routed`); the unforced share is reported as a measured
    gap."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    cpu_params = _to(params, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    worst, ties, steps, reports, gaps = 0.0, [], 0, [], []

    def both(name, run):
        """One prefill or decode step on the card and on the CPU; the
        logit rows held."""
        cpu = torch.device("cpu")
        diff, on_card = None, Routes()
        if not cfg.is_moe:
            (lg_g, c_g), (lg_c, c_c) = run(DEV), run(cpu)
        else:
            with on_card:
                lg_g, c_g = run(DEV)
            with Routes() as on_cpu:
                lg_c, c_c = run(cpu)
            diff = routes.parted(on_cpu, on_card, cfg, name)
            reports.extend(diff)
        out = {}

        def rerun():
            with Routes(forced=on_card.own):
                out["c"] = run(cpu)
            return real_vocab(name, out["c"][0][0], cfg.vocab_size)
        share, unforced = hold_routed(
            name, real_vocab(name, lg_g[0], cfg.vocab_size),
            real_vocab(name, lg_c[0], cfg.vocab_size), diff, rerun)
        if unforced is not None:
            gaps.append((name, unforced, share))
            lg_c, c_c = out["c"]
        return lg_g, c_g, lg_c, c_c, share

    t0 = time.perf_counter()
    for n, extra in cases:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)))
        inputs = {key: torch.randn((1, m, cfg.d_model), generator=gen)
                  for key, m in extra.items()}
        offset = extra.get("patch_embeds", 0)
        max_len = max(cfg.window, offset + n + 8)
        caches = {}

        def prefill(dev):
            p = params if dev == DEV else cpu_params
            return model.prefill(p, toks.to(dev), pad_cache_to=max_len,
                                 **{key: v.to(dev)
                                    for key, v in inputs.items()})
        what = f"{arch} {layers} layers, prompt {n}" + "".join(
            f", {m} {key}" for key, m in extra.items())
        lg_g, caches[DEV], lg_c, caches["cpu"], share = both(
            f"{what}, prefill", prefill)
        for step in range(5):
            name = f"{what}, step {step}"
            worst = max(worst, share)
            if not same_token(name, int(torch.argmax(real_vocab(
                    name, lg_g[0], cfg.vocab_size))),
                    real_vocab(name, lg_c[0], cfg.vocab_size)):
                ties.append((n, step))
            steps += 1
            if step == 4:
                break
            tok = torch.argmax(lg_c[0]).reshape(1, 1)
            pos = torch.tensor([[offset + n + step]])

            def decode(dev):
                p = params if dev == DEV else cpu_params
                c = caches[DEV if dev == DEV else "cpu"]
                return model.decode_step(p, tok.to(dev), c, pos.to(dev))
            lg_g, caches[DEV], lg_c, caches["cpu"], share = both(
                f"{what}, step {step + 1}", decode)
    wall = time.perf_counter() - t0
    out = dict(worst_share_of_tol=worst, near_ties=ties, steps=steps)
    route_log = ""
    if cfg.is_moe:
        out["routes"] = _merge_routes(reports, layers)
        out["measured_gaps"] = gaps
        route_log = f"; router per layer, CPU against card ({ROUTES_KEY}): " \
            + _routes_line(out["routes"])
    log(f"main path: {arch} full width, {layers} layers, card vs CPU: "
        f"{steps} logit rows (prefill + 4 decode steps for prompts of "
        f"{[n for n, _ in cases]} tokens"
        + "".join(f", {extra}" for _, extra in cases if extra)
        + f") within {TOL_EPS} bf16 epsilons of the CPU's largest "
        f"logit (worst {worst:.2f} of the tolerance); greedy tokens equal"
        f"{'' if not ties else f' except near ties at {ties}'}; "
        f"{wall:.1f} s{route_log}")
    return out


def dropped_at_prefill(model, params, prompts) -> list:
    """The largest share of (token, choice) pairs any layer drops at each
    prompt's prefill (the served capacity factor), from the recorded
    expert choices."""
    cfg, out = model.cfg, []
    for p in prompts:
        toks = torch.as_tensor(np.asarray(p, np.int64), device=DEV)[None]
        with Routes() as r:
            model.prefill(params, toks)
        cap = moe_mod.capacity(toks.shape[1], cfg)
        out.append(max(float((~moe_mod.dispatch(
            e, cfg.num_experts, cap)[1]).float().mean()) for e in r.own))
    return out


def moe_decode_check(name, model, params, done) -> dict:
    """olmoe's long prompts again, one at a time, with capacity factor 8
    (no pair is dropped at any batch, as the reference's own test sets it:
    at the served 1.25 a long prefill drops pairs that a decode step never
    does): prefill, then the engine's tokens decoded against the KV caches
    (fed, not held: the engine chose them at 1.25), and the last decode's
    logits against a prefill of the prompt and the first 7 tokens, within
    the bf16 bound.  Both orders' router inputs and expert choices are
    recorded; where the longer prefill's choices differ from the
    decode's, they must follow the router's input
    (:func:`routes.parted`), and the longer prefill runs again on the
    decode's choices."""
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    worst, reports, gaps = 0.0, [], []
    for req in done:
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64), device=DEV)
        n = toks.shape[0]
        with Routes() as stepped:
            logits, caches = model.prefill(params, toks[None],
                                           pad_cache_to=2560)
            for j, tok in enumerate(req.generated[:-1]):
                logits, caches = model.decode_step(
                    params, torch.tensor([[tok]], device=DEV), caches,
                    torch.tensor([[n + j]], device=DEV))
        longer = torch.cat([toks, torch.as_tensor(
            req.generated[:-1], device=DEV)])[None]
        with Routes() as whole:
            want, _ = model.prefill(params, longer)
        seq = stepped.per_layer(layers)
        what = f"{name} check rid {req.rid}"
        diff = routes.parted(whole, seq, model.cfg, what)
        reports.extend(diff)

        def rerun():
            with Routes(forced=seq.own):
                return real_vocab(what, model.prefill(params, longer)[0],
                                  vocab)
        share, unforced = hold_routed(what, real_vocab(what, logits, vocab),
                                      real_vocab(what, want, vocab), diff,
                                      rerun)
        if unforced is not None:
            gaps.append((req.rid, unforced, share))
        worst = max(worst, share)
    merged = _merge_routes(reports, layers)
    log(f"main path: {name}: with capacity factor 8, decode against the KV "
        f"caches gives, after 7 tokens, the logits of the longer prefill: "
        f"worst {worst:.2f} of the bf16 bound ({TOL_EPS} epsilons)"
        + (f"; expert choices that follow the router's input alone moved "
           f"{gaps} (rid, share, share on the decode's experts)"
           if gaps else "")
        + f"; router per layer, longer prefill against decode ({ROUTES_KEY}): "
        + _routes_line(merged))
    return dict(worst_share_of_tol=worst, measured_gaps=gaps,
                routes=merged)


def model_run(arch, n_text, extra, steps=8) -> dict:
    """``arch`` at full width and depth through ``Model``: one prefill of
    ``n_text`` tokens with the extra inputs (patch embeddings or frames,
    ``{name: positions}``), then ``steps`` greedy decode steps; launches
    asserted (``PER_PREFILL`` for the prefill, none for a step); wall,
    tokens/s and peak memory logged."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, n_text), generator=gen,
                         device=DEV)
    inputs = {key: torch.randn((1, m, cfg.d_model), generator=gen,
                               device=DEV) for key, m in extra.items()}
    offset = extra.get("patch_embeds", 0)
    max_len = offset + n_text + steps + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, toks, pad_cache_to=max_len,
                                   **inputs)
    generated = [int(torch.argmax(real_vocab(arch, logits[0],
                                             cfg.vocab_size)))]
    prefill_s = time.perf_counter() - t0
    at_prefill = read_counts()
    for j in range(steps):
        logits, caches = model.decode_step(
            params, torch.tensor([[generated[-1]]], device=DEV), caches,
            torch.tensor([[offset + n_text + j]], device=DEV))
        generated.append(int(torch.argmax(real_vocab(arch, logits[0],
                                                     cfg.vocab_size))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = PER_PREFILL[arch]
    got = {key: at_prefill[key] for key in want}
    # the decode steps add one decode-attention call a layer each
    after = dict(at_prefill, decode_attention=at_prefill["decode_attention"]
                 + steps * PER_DECODE_STEP[arch])
    if got != want or counts != after:
        raise AssertionError(f"{arch}: launches {got} at the prefill (want "
                             f"{want}), {counts} after {steps} decode "
                             f"steps (want {after})")
    if not torch.isfinite(logits.float()).all() or \
            logits.shape != (1, cfg.padded_vocab):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                             f"finite")
    tokens = len(generated)
    log(f"main path: {arch} full width and depth through Model: prefill "
        f"of {n_text} tokens" + "".join(f" + {m} {key}"
                                        for key, m in extra.items())
        + f" ({prefill_s:.3f} s) and {steps} decode steps: {tokens} tokens "
        f"in {wall:.3f} s ({tokens / wall:.1f} tok/s), peak memory "
        f"{peak:.2f} GiB; launches {got} at the prefill, in decode only "
        f"{PER_DECODE_STEP[arch]} decode-attention calls a step")
    return dict(wall_s=wall, prefill_s=prefill_s, tokens=tokens,
                tok_per_s=tokens / wall, peak_gib=peak, launches=got,
                params=model.param_count())


def phase_new_families() -> dict:
    """The moe, vision and enc-dec families: olmoe-1b-7b served at full
    width and depth (the launcher, a long-prompt engine run, its decode
    check with capacity factor 8); internvl2-1b and seamless-m4t-large-v2
    at full depth through ``Model``; the four models at full width and
    reduced depth on the card against the CPU, with the router's near ties
    counted."""
    import dataclasses
    runs = {}
    cfg = get_config(OLMOE)
    model = build_model(cfg)
    if cfg.num_layers != 16 or \
            (cfg.param_count(), model.param_count()) != OLMOE_PARAMS:
        raise AssertionError(f"{OLMOE}: {cfg.num_layers} layers, "
                             f"{cfg.param_count():,} parameters "
                             f"({model.param_count():,} padded)")
    out = {}
    argv = ["--arch", OLMOE, "--requests", "8", "--batch-slots", "4",
            "--max-new-tokens", "16"]
    log(f"main path: launcher {' '.join(argv)}")
    runs["olmoe-1b-7b launcher"] = serving_run(
        "olmoe-1b-7b launcher",
        lambda: out.setdefault("o", serve_launcher.main(argv))["requests"],
        OLMOE, 8)
    check_requests("olmoe-1b-7b launcher", out["o"]["requests"], 8, 16,
                   cfg.vocab_size)
    runs["olmoe-1b-7b launcher"]["launcher_s"] = out["o"]["seconds"]
    del out
    torch.cuda.empty_cache()

    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(2000, 2401, 4)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def long_prompts():
        eng = ServingEngine(model, params, batch_slots=4, max_len=2560,
                            device=DEV)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        return eng.run_until_drained()
    log(f"main path: {OLMOE} engine, prompts of {lens} tokens, max_len "
        f"2560, capacity factor {cfg.moe_capacity_factor}")
    done = []
    runs["olmoe-1b-7b long prompts"] = serving_run(
        "olmoe-1b-7b long prompts", lambda: done.extend(long_prompts())
        or done, OLMOE, 4)
    check_requests("olmoe-1b-7b long prompts", done, 4, 8, cfg.vocab_size)
    rec = runs["olmoe-1b-7b long prompts"]
    rec["prompt_lens"] = lens
    rec["capacity"] = [moe_mod.capacity(n, cfg) for n in lens]
    rec["dropped"] = dropped_at_prefill(model, params, prompts)
    log(f"main path: {OLMOE} long prompts: capacity {rec['capacity']} "
        f"slots an expert; each prefill's most-dropping layer drops "
        f"{[round(d, 4) for d in rec['dropped']]} of its (token, choice) "
        f"pairs")
    roomy = build_model(dataclasses.replace(cfg, moe_capacity_factor=8.0))
    rec["decode_check"] = moe_decode_check("olmoe-1b-7b long prompts",
                                           roomy, params, done)
    del model, roomy, params
    torch.cuda.empty_cache()

    runs["internvl2-1b full depth"] = model_run(
        "internvl2-1b", 40, {"patch_embeds": 256})
    torch.cuda.empty_cache()
    runs["seamless-m4t-large-v2 full depth"] = model_run(
        "seamless-m4t-large-v2", 40, {"frames": 1000})
    torch.cuda.empty_cache()

    runs["card vs CPU new families"] = {
        OLMOE: card_vs_cpu(OLMOE, 2),
        "llama4-scout-17b-a16e": card_vs_cpu("llama4-scout-17b-a16e", 1),
        "internvl2-1b": card_vs_cpu(
            "internvl2-1b", 2, cases=((40, {"patch_embeds": 256}),
                                      (300, {"patch_embeds": 256}))),
        "seamless-m4t-large-v2": card_vs_cpu(
            "seamless-m4t-large-v2", 2,
            cases=tuple((40, {"frames": se}) for se in ENC_FRAMES)),
    }
    torch.cuda.empty_cache()
    return runs


# -- the training slice: the LM kernels in a training step -------------------

#: (arch, layers, tokens a sequence on the card, on the CPU) of the
#: training step at full width, 2 sequences: recurrentgemma-2b at 3
#: layers, one whole (rec, rec, attn) pattern, so that a local attention
#: layer is in it.  Its CPU step at 2 x 2048 took 224 s on the 8 host
#: cores of an H100 80GB HBM3 machine (22 TFLOP of bf16 products, its
#: 256k-row vocabulary most of them), so the card-vs-CPU comparison runs a
#: second card step at 2 x 256; its card step at 2 x 2048 is held to the
#: launches and to finite, non-zero gradients
TRAIN_CASES = (("smollm-360m", 2, 256, 256),
               ("recurrentgemma-2b", 3, 2048, 256),
               ("mamba2-2.7b", 2, 2048, 2048), ("olmoe-1b-7b", 2, 256, 256))
#: a gradient leaf within GRAD_EPS bf16 epsilons of its largest CPU
#: magnitude, the loss within TOL_EPS of |loss|: the bounds
#: tests/test_torch_train.py holds the port to against the reference
GRAD_EPS = 16
#: the Functions' backwards against autograd of their plain versions, f32:
#: within F32_GRAD of the largest |gradient| (the CPU tests' atol 1e-5,
#: scaled to the gradient's size: the adjoint scan sums in another order)
F32_GRAD = 1e-5
#: the training launcher at full width and depth
TRAIN_ARGV = ["--arch", "smollm-360m", "--steps", "12", "--global-batch",
              "8", "--seq-len", "512", "--ckpt-every", "4", "--fail-at",
              "6"]
LM_KERNELS = ("flash_attention_fwd", "rglru_scan", "ssd_scan")
#: the kernel each layer kind's forward launches
KERNEL_OF_KIND = {"attn": "flash_attention_fwd",
                  "moe": "flash_attention_fwd", "rec": "rglru_scan",
                  "ssm": "ssd_scan"}


def lm_counts() -> dict:
    counts = read_counts()
    return {k: counts[k] for k in LM_KERNELS}


def step_launches(cfg, forward_only=False) -> dict:
    """The LM kernels' launches of one training step of ``cfg``: each
    layer's kernel once in the forward and, rematerialized, once more in
    the backward's recompute; the RG-LRU scan a third time for its
    adjoint (the attention and SSD backwards are their plain forms)."""
    out = {k: 0 for k in LM_KERNELS}
    for kind in cfg.layer_kinds():
        name = KERNEL_OF_KIND[kind]
        out[name] += 1 if forward_only else \
            (1 + cfg.remat + (name == "rglru_scan"))
    return out


def family_launches(cfg, forward_only=False) -> dict:
    """:func:`step_launches`, also for an encoder-decoder model: flash
    attention for each encoder layer and twice (self and cross) for each
    decoder layer."""
    if not cfg.is_encdec:
        return step_launches(cfg, forward_only)
    out = {k: 0 for k in LM_KERNELS}
    out["flash_attention_fwd"] = (cfg.encoder_layers + 2 * cfg.num_layers) \
        * (1 if forward_only else 1 + cfg.remat)
    return out


def leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_by_path(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def card_step(model, params, cfg, batch, what):
    """One training step on the card: (loss, gradients by leaf, launches
    a forward, launches a step, its routes, wall s, peak GiB), the
    launches held to :func:`step_launches` and every gradient leaf to
    finite and non-zero."""
    from repro_torch.train.train_step import value_and_grad
    reset_counts()
    with torch.no_grad():
        model.loss(params, batch)
    torch.cuda.synchronize()
    fwd = lm_counts()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Routes() as on_card:
        loss, _, grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step = lm_counts()
    if fwd != step_launches(cfg, forward_only=True) or \
            step != step_launches(cfg):
        raise AssertionError(f"{what}: launches {fwd} a forward, {step} a "
                             f"step; want {step_launches(cfg, True)}, "
                             f"{step_launches(cfg)}")
    named = leaves_by_path(grads)
    bad = [n for n, g in named if not (bool(torch.isfinite(g).all())
                                       and bool((g != 0).any()))]
    if bad:
        raise AssertionError(f"{what}: leaves with a zero or non-finite "
                             f"gradient on the card: {bad}")
    return (loss, named, fwd, step, on_card, wall,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def train_card_vs_cpu(arch, layers, seq, cpu_seq) -> dict:
    """One training step (loss and every gradient) of ``arch`` at full
    width and ``layers`` layers on one ``SyntheticLM`` batch of 2 x
    ``seq`` tokens on the card, weights drawn on the card from seed 0:
    every leaf's gradient finite and non-zero, the launches of a forward
    and of a step exactly :func:`step_launches`.  Then, at 2 x
    ``cpu_seq`` tokens, against the same step on the CPU (weights copied):
    the loss and each leaf within the CPU tests' bounds.  An moe model's
    CPU step runs on the card's expert choices, its own recorded and
    checked against the router's input (:func:`routes.parted`)."""
    import dataclasses
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.train import SyntheticLM
    from repro_torch.train.train_step import value_and_grad
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    srcs = {n: SyntheticLM(cfg, ShapeSpec("train", n, 2, "train"))
            for n in {seq, cpu_seq}}

    def place(n, dev):
        return srcs[n].place(srcs[n].batch_for_step(0), dev)
    what = f"{arch} {layers} layers, 2 x {seq} tokens"
    loss, named, fwd, step, on_card, card_s, peak = card_step(
        model, params, cfg, place(seq, DEV), what)
    if cpu_seq != seq:
        log(f"training: {what}: loss {float(loss):.6f}, {len(named)} "
            f"leaves, every card gradient finite and non-zero; launches "
            f"{fwd} a forward, {step} a step (remat); {card_s:.2f} s "
            f"({peak:.2f} GiB)")
        what = f"{arch} {layers} layers, 2 x {cpu_seq} tokens"
        loss, named, _, _, on_card, _, _ = card_step(
            model, params, cfg, place(cpu_seq, DEV), what)
    cpu_params = _to(params, torch.device("cpu"))
    t0 = time.perf_counter()
    with Routes(forced=on_card.own if cfg.is_moe else None) as on_cpu:
        cpu_loss, _, cpu_grads = value_and_grad(
            model, cpu_params, place(cpu_seq, torch.device("cpu")))
    cpu_s = time.perf_counter() - t0
    parted = routes.parted(on_cpu, on_card, cfg, what) if cfg.is_moe \
        else None
    loss_share = abs(float(loss) - float(cpu_loss)) / (
        TOL_EPS * BF16_EPS * abs(float(cpu_loss)))
    shares = {}
    for (name, g), (_, w) in zip(named, leaves_by_path(cpu_grads)):
        w = w.float()
        tol = GRAD_EPS * BF16_EPS * float(w.abs().max())
        shares[name] = float((g.float().cpu() - w).abs().max()) / tol
    worst = max(shares, key=shares.get)
    if loss_share > 1.0 or shares[worst] > 1.0:
        raise AssertionError(f"{what}: loss {float(loss)} vs CPU "
                             f"{float(cpu_loss)} ({loss_share:.2f} of "
                             f"{TOL_EPS} bf16 eps); worst leaf {worst} at "
                             f"{shares[worst]:.2f} of {GRAD_EPS} bf16 eps")
    log(f"training: {what}: loss {float(loss):.6f} card, "
        f"{float(cpu_loss):.6f} CPU ({loss_share:.3f} of the bound); "
        f"{len(named)} leaves, every card gradient finite and non-zero, "
        f"worst {worst} at {shares[worst]:.3f} of {GRAD_EPS} bf16 "
        f"epsilons; launches {fwd} a forward, {step} a step (remat); card "
        f"{card_s:.2f} s ({peak:.2f} GiB), CPU {cpu_s:.2f} s"
        + ("" if parted is None else
           f"; CPU held on the card's experts, tokens whose experts "
           f"differ per layer {[r['sets'] + r['order'] for r in parted]}, "
           f"all following the router's input"))
    return dict(loss=float(loss), cpu_loss=float(cpu_loss),
                loss_share=loss_share, worst_leaf=worst,
                worst_share=shares[worst], leaves=len(named),
                tokens=2 * seq, cpu_tokens=2 * cpu_seq,
                forward_launches=fwd, step_launches=step, card_s=card_s,
                cpu_s=cpu_s, peak_gib=peak,
                routes=None if parted is None else [
                    {k: r[k] for k in ("sets", "order", "by_input")}
                    for r in parted])


def grads_close(name, got, want) -> float:
    """Fail unless each gradient is within ``F32_GRAD`` of its largest
    |plain gradient|; returns the worst share of that bound."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        tol = F32_GRAD * float(w.abs().max())
        err = float((g - w).abs().max())
        if not bool(torch.isfinite(g).all()) or err > tol:
            raise AssertionError(f"{name}: gradient {i} max |diff| {err} "
                                 f"> {tol}")
        worst = max(worst, err / tol if tol else 0.0)
    return worst


def function_record(name, fn, plain, ins, cot, fwd) -> dict:
    """``fn`` (the Function on the kernel) against autograd of ``plain``
    on the same inputs: gradients held (:func:`grads_close`); the kernel
    forward ``fwd``, the Function's backward alone and the plain version's
    forward and backward timed (CUDA events, median)."""
    leaves = [t.detach().requires_grad_(True) for t in ins]
    out = fn(*leaves)
    got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    want = torch.autograd.grad(plain(*leaves), leaves, cot)
    share = grads_close(name, got, want)
    rec = dict(share_of_tol=share,
               fwd_ms=time_ms(lambda: fwd(*ins), 10),
               bwd_ms=time_ms(lambda: torch.autograd.grad(
                   out, leaves, cot, retain_graph=True), 5),
               plain_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                   plain(*leaves), leaves, cot), 3))
    log(f"training: {name}: the Function's gradients within "
        f"{share:.3f} of {F32_GRAD} x the largest plain gradient; kernel "
        f"forward {rec['fwd_ms']:.4f} ms, the Function's backward "
        f"{rec['bwd_ms']:.4f} ms, plain forward + backward "
        f"{rec['plain_fwd_bwd_ms']:.4f} ms")
    return rec


#: the Functions' shapes: the attention layers of the card-vs-CPU steps of
#: smollm-360m and recurrentgemma-2b ([B, K, G, S, hd], window), its
#: RG-LRU scan ([B, S, C]) and mamba2-2.7b's SSD scan ([B, S, H, P, N],
#: chunk)
TRAIN_FA_SHAPES = (("smollm-360m", (2, 5, 3, 256, 64), 0),
                   ("recurrentgemma-2b", (2, 1, 10, 2048, 256), 2048))
TRAIN_LRU_SHAPE = (2, 2048, 2560)
TRAIN_SSD_CASE = (2, 2048, 80, 64, 128, 256)


def train_functions() -> dict:
    """Each kernel's ``torch.autograd.Function`` at the training step's
    shapes (the attention in bf16, as trained, and in f32; the RG-LRU scan
    and the SSD scan in f32) against autograd of its plain version."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    recs = {}
    for label, (b, k, g, s, hd), window in TRAIN_FA_SHAPES:
        for dtype in (torch.bfloat16, F32):
            ins = [rn(b, k, g, s, hd).to(dtype), rn(b, k, s, hd).to(dtype),
                   rn(b, k, s, hd).to(dtype)]
            cot = rn(b, k, g, s, hd).to(dtype)
            name = f"flash_attention_fwd {label} [{b},{k},{g},{s},{hd}] " \
                f"{'bf16' if dtype != F32 else 'f32'}"
            recs[name] = function_record(
                name, lambda *t, w=window: fa_ops.FlashAttention.apply(
                    *t, True, w, 0, fa_ops._launch),
                lambda *t, w=window: fa_ref.attention_ref(
                    *t, causal=True, window=w),
                ins, cot, lambda *t, w=window: fa_ops._launch(
                    *t, causal=True, window=w, q_offset=0))
    shape = TRAIN_LRU_SHAPE
    log_a = -torch.rand(shape, generator=gen, device=DEV) * 2.0
    name = f"rglru_scan {list(shape)}"
    recs[name] = function_record(
        name, lambda la, bb: lru_ops.LRUScan.apply(la, bb, lru_ops._launch),
        lru_ref.lru_ref, [log_a, rn(*shape)], rn(*shape), lru_ops._launch)
    case = TRAIN_SSD_CASE
    x, dt, bb, cc, a_log, _ = ssd_inputs(case, gen, slow=True)
    name = f"ssd_scan {list(case[:5])}"
    recs[name] = function_record(
        name, lambda *t: ssd_ops.SSDScan.apply(*t, None, case[5],
                                               ssd_ops._launch)[0],
        lambda *t: ssd_ops.chunked(*t, case[5])[0], [x, dt, bb, cc, a_log],
        (rn(*case[:4]),), lambda *t: ssd_ops._launch(*t, None))
    return recs


def replay_probe(params) -> dict:
    """Which of the step's ops give other bits from the same inputs: the
    embedding gather's backward (``index_put_`` with accumulate) and a
    matmul's backward, each run twice."""
    tokens = torch.randint(0, params["embedding"]["embed"].shape[0],
                           (8, 512), device=DEV,
                           generator=torch.Generator(device=DEV)
                           .manual_seed(5))
    emb = params["embedding"]["embed"].detach().requires_grad_(True)
    g = torch.randn(8, 512, emb.shape[1], device=DEV)
    gather = [torch.autograd.grad(emb[tokens], emb, g)[0]
              for _ in range(2)]
    w = params["blocks"]["layer_00"]["mlp"]["wi"].detach().to(
        torch.bfloat16).requires_grad_(True)
    xm = torch.randn(8 * 512, w.shape[0], device=DEV).to(torch.bfloat16)
    gm = torch.randn(8 * 512, w.shape[1], device=DEV).to(torch.bfloat16)
    mm = [torch.autograd.grad(xm @ w, w, gm)[0] for _ in range(2)]
    return {"embedding gather backward (index_put_ accumulate)":
            bool(torch.equal(*gather)),
            "matmul backward": bool(torch.equal(*mm))}


def train_launcher() -> dict:
    """The training launcher at full width and depth (smollm-360m, 12
    steps of 8 x 512 tokens, a checkpoint every 4 steps, a failure
    injected at step 6): one restart, the loss falling from the first step
    to the last, the replayed steps' losses compared with the first
    pass's bitwise; step wall, tokens/s, peak memory and the kernels'
    launches a step logged."""
    import shutil
    import tempfile
    from repro_torch.launch import train as train_launcher_mod
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    argv = TRAIN_ARGV + ["--ckpt-dir", ckpt_dir]
    log(f"training: launcher {' '.join(argv)}")
    cfg = get_config("smollm-360m")
    try:
        reset_counts()
        out = train_launcher_mod.main(argv)
        counts = lm_counts()
    finally:
        disk = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*")
                   if f.is_file()) / 2 ** 30
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rep = out["report"]
    first = [out["losses"][s][0] for s in sorted(out["losses"])]
    replayed = {s: v for s, v in out["losses"].items() if len(v) > 1}
    if rep.restarts != 1 or rep.restored_steps != [3] or \
            sorted(replayed) != [4, 5]:
        raise AssertionError(f"training launcher: restarts {rep.restarts}, "
                             f"restored {rep.restored_steps}, replayed "
                             f"{sorted(replayed)}")
    if not first[-1] < first[0]:
        raise AssertionError(f"training launcher: loss {first[0]} -> "
                             f"{first[-1]} did not fall")
    want = step_launches(cfg)
    if any(n != want for n in out["launches"]):
        raise AssertionError(f"training launcher: launches a step "
                             f"{out['launches']}, want {want}")
    bitwise = {s: v[0] == v[1] for s, v in replayed.items()}
    rec = dict(losses=first, replayed={s: v for s, v in replayed.items()},
               replay_bitwise=bitwise, median_step_s=out["median_step_s"],
               tokens_per_s=out["tokens_per_step"] / out["median_step_s"],
               peak_gib=out["peak_gib"], launches_per_step=want,
               launches=counts,
               wall_s=out["wall_s"], checkpoint_gib=disk,
               step_s=out["step_s"])
    if not all(bitwise.values()):
        rec["probe"] = replay_probe(build_model(cfg).init(
            torch.Generator(device=DEV).manual_seed(0)))
    log(f"training: launcher: loss {first[0]:.4f} -> {first[-1]:.4f} "
        f"over 12 steps, one restart from step 3; replayed steps 4, 5 "
        f"bitwise {bitwise}" + (f" (same inputs twice, bitwise: "
                                f"{rec['probe']})" if "probe" in rec else "")
        + f"; median step {1e3 * rec['median_step_s']:.1f} ms "
        f"({rec['tokens_per_s']:.0f} tokens/s), peak {rec['peak_gib']:.2f} "
        f"GiB, {want} launches a step, checkpoints {disk:.2f} GiB on disk, "
        f"wall {out['wall_s']:.1f} s [{card_line()}]")
    return rec


TRAIN_KINDS = ("flash fwd", "attention bwd", "matmul", "cast/copy",
               "optimizer", "other")


def train_kind(kernel_name: str) -> str:
    """A kernel's kind by its name alone (``profile_serve.kind_of``; the
    RG-LRU and SSD scans, absent from smollm-360m, fall in "other")."""
    from repro_torch.launch.profile_serve import kind_of
    return {"flash_attention_fwd": "flash fwd", "matmul": "matmul",
            "cast/copy": "cast/copy"}.get(kind_of(kernel_name), "other")


def kernels_under(prof, needle: str) -> dict:
    """Kernel ms by name of every CPU event whose name holds ``needle``,
    and of everything under it."""
    seen, out = set(), {}

    def walk(evt):
        if id(evt) in seen:
            return
        seen.add(id(evt))
        for k in evt.kernels:
            out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
        for child in evt.cpu_children:
            walk(child)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU and \
                needle in evt.name:
            walk(evt)
    return out


def train_profile() -> dict:
    """``torch.profiler`` over one smollm-360m training step at full width
    and depth (8 x 512 tokens, after two unprofiled steps): kernel ms by
    kind (the flash forward, the attention backward under
    ``FlashAttentionBackward``, the optimizer under its range, matmuls,
    casts and copies, the rest) and the idle share of the profiled
    wall."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.profile_serve import device_ms
    from repro_torch.train import (AdamW, SyntheticLM, cosine_schedule,
                                   init_state, make_train_step)
    from repro_torch.train.train_step import OPTIMIZER_RANGE
    cfg = get_config("smollm-360m")
    model = build_model(cfg)
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 10, 12))
    state = init_state(model, torch.Generator(device=DEV).manual_seed(0),
                       opt)
    step = make_train_step(model, opt)
    src = SyntheticLM(cfg, ShapeSpec("cli", 512, 8, "train"))
    batches = [src.place(src.batch_for_step(i), DEV) for i in range(3)]
    for b in batches[:2]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[2])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by_name = device_ms(prof)
    by_name.pop(OPTIMIZER_RANGE, None)      # the range's span, no kernel
    busy = sum(by_name.values())
    if busy <= 0.0:
        raise AssertionError("training profile: no device kernel time")
    kinds = {k: 0.0 for k in TRAIN_KINDS}
    for kname, ms in by_name.items():
        kinds[train_kind(kname)] += ms
    # the ranges' kernels move from their name's kind to the range's
    for kind, needle in (("attention bwd", "FlashAttentionBackward"),
                         ("optimizer", OPTIMIZER_RANGE)):
        for kname, ms in kernels_under(prof, needle).items():
            kinds[train_kind(kname)] -= ms
            kinds[kind] += ms
    rec = dict(wall_ms=wall, profiled_wall_ms=prof_wall, device_ms=busy,
               idle=1.0 - busy / prof_wall, kinds=kinds,
               top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    log(f"training: profile of one smollm-360m step (8 x 512 tokens, 32 "
        f"layers, remat): wall {wall:.2f} ms; profiled wall "
        f"{prof_wall:.2f} ms, kernels {busy:.2f} ms (idle "
        f"{100 * rec['idle']:.1f}%): "
        + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())
        + f" [{card_line()}]")
    for kname, ms in rec["top"]:
        log(f"    {ms:9.3f} ms  {kname[:110]}")
    return rec


def training_kernel_record(name: str, training: dict) -> dict:
    """A kernel's entry of the training phase: its launches a step of the
    launcher run and of each card-vs-CPU step, and its Function's times
    at the training shapes."""
    return {
        "launches": training["launcher"]["launches"][name],
        "launches_from": "smollm-360m training launcher (12 steps + 2 "
                         "replayed)",
        "launches_per_step": training["launcher"]["launches_per_step"][name],
        "card_vs_cpu_step_launches": {
            arch: rec["step_launches"][name]
            for arch, rec in training["card vs CPU"].items()},
        "functions": {label: rec for label, rec in
                      training["functions"].items()
                      if label.startswith(name)}}


def phase_training() -> dict:
    """The training slice: one step at full width on the card against the
    CPU for four models, each kernel's Function against autograd of its
    plain version, the launcher at full width and depth with a restart,
    and a profiled step."""
    t0 = time.perf_counter()
    out = {"card vs CPU": {}}
    for arch, layers, seq, cpu_seq in TRAIN_CASES:
        out["card vs CPU"][arch] = train_card_vs_cpu(arch, layers, seq,
                                                     cpu_seq)
        torch.cuda.empty_cache()
    out["functions"] = train_functions()
    torch.cuda.empty_cache()
    out["launcher"] = train_launcher()
    torch.cuda.empty_cache()
    out["profile"] = train_profile()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"training: phase wall {out['wall_s']:.1f} s")
    return out


#: phase j: the sharded training steps, (arch, layers, mesh, local rows,
#: config replacements, sequence, encoder frames): each held against one
#: card's step from the same full draw
MESH_SEQ = 256
MESH_CASES = (("smollm-360m", 2, (2, 2), 2, {}, MESH_SEQ, None),
              ("olmoe-1b-7b", 2, (2, 2), 2, {"moe_capacity_factor": 8.0},
               MESH_SEQ, None),
              ("recurrentgemma-2b", 3, (4, 1), 1, {}, MESH_SEQ, None))
#: timed sharded steps after the checked one
MESH_STEPS = 1
#: the training launcher on a (2, 2) mesh, full width and depth
MESH_ARGV = ["--arch", "smollm-360m", "--steps", "4", "--global-batch", "8",
             "--seq-len", "512", "--ckpt-every", "2", "--fail-at", "3",
             "--mesh", "2,2"]
#: the elastic restores of the launcher's last checkpoint
ELASTIC_MESH = (4, 1)


#: rank 0's one-card step of each k1 case (its record and the gradients
#: and parameters on the host), kept for l2's run of the same case
_ONE_CARD: dict = {}


def _mesh_step_case(case, ctx, grads_only: bool = False) -> dict:
    """One sharded training step of ``case`` (see :data:`MESH_CASES`) on
    this rank, then :data:`MESH_STEPS` timed ones.  Rank 0 first runs one
    card's step from the same full draw and batch; the sharded step's loss,
    gradients (gathered leaf by leaf) and updated parameters are held to
    it.  ``grads_only`` (l2): the checked step alone, its loss and
    gradients held, the parameters not gathered."""
    import dataclasses
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import sharding
    from repro_torch.train import AdamW, SyntheticLM, constant_schedule
    from repro_torch.train.train_step import value_and_grad
    t_case = time.perf_counter()
    parts, t_part = {}, [t_case]

    def mark(name):
        """Seconds since the last mark, under ``name`` (where the case's
        wall goes)."""
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - t_part[0]
        t_part[0] = now
    arch, layers, shape, rows, rep, seq, frames = case
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, **rep)
    model = build_model(cfg)
    dev = ctx.mesh.device
    rank0 = ctx.mesh.rank == 0
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    specs = model.param_specs(ctx)
    local = model.shard_params(full, ctx)
    mark("draw_s")
    # each rank's blocks against the spec's slices of the whole draw (the
    # gathers back are held by the gradient comparison below, and bitwise
    # by phase j's elastic restore)
    placed = all(bool(torch.equal(a, sharding.shard(b, sp, ctx)))
                 for (_, a), (_, sp), (_, b) in zip(
                     leaves_by_path(local), leaves_by_path(specs),
                     leaves_by_path(full)))
    mark("placement_check_s")
    src = SyntheticLM(cfg, ShapeSpec("t", seq, rows * ctx.dp_size(),
                                     "train"))
    opt = AdamW(learning_rate=constant_schedule(1e-2), weight_decay=0.0)

    def batch_for(step):
        """The step's batch; an encoder's ``frames`` drawn at their own
        length (SyntheticLM draws as many frames as tokens)."""
        b = src.batch_for_step(step)
        if frames is not None:
            rng = np.random.default_rng(step)
            b["frames"] = (rng.standard_normal(
                (b["tokens"].shape[0], frames, cfg.d_model)) * 0.02).astype(
                    np.float32)
        return b
    batch0 = batch_for(0)
    rec = dict(arch=arch, layers=layers, mesh=list(shape),
               tokens_per_rank=rows * seq, frames=frames,
               want_launches=family_launches(cfg))
    if rank0 and repr(case) in _ONE_CARD:
        # the same draw and batch as an earlier case's (l2 repeats k1's
        # cases with sequence parallelism): the same one-card step
        one, want_g, want_p = _ONE_CARD[repr(case)]
        rec.update(one, one_card_reused=True)
    elif rank0:
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss1, _, grads1 = value_and_grad(model, full, src.place(batch0,
                                                                 dev))
        params1, opt1, m1 = opt.update(grads1, opt.init(full), full)
        torch.cuda.synchronize(dev)
        one = dict(one_card_s=time.perf_counter() - t0,
                   one_card_launches=lm_counts(), one_card_loss=float(loss1),
                   one_card_grad_norm=float(m1["grad_norm"]))
        rec.update(one)
        want_g = {n: g.cpu() for n, g in leaves_by_path(grads1)}
        want_p = {n: p.cpu() for n, p in leaves_by_path(params1)}
        if case in FAMILY_STEPS:
            _ONE_CARD[repr(case)] = (one, want_g, want_p)
        del loss1, grads1, params1, opt1, m1
    del full
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    mark("one_card_s")

    state_opt = opt.init(local)
    walls, launches, traffic = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    rec["base_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30
    for i in range(1 if grads_only else 1 + MESH_STEPS):
        batch = src.place(batch_for(i) if i else batch0, dev, ctx)
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        reset_counts()
        sharding.reset_traffic()
        t0 = time.perf_counter()
        loss, _, grads = value_and_grad(model, local, batch, ctx)
        new, new_opt, metrics = opt.update(grads, state_opt, local, ctx,
                                           specs)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        launches.append(lm_counts())
        traffic.append(dict(sharding.traffic))
        local, state_opt = new, new_opt
        del new, new_opt
        mark("steps_s")
        if i == 0:
            rec.update(loss=float(loss), grad_norm=float(metrics["grad_norm"]),
                       residual_bytes=sharding.residual["bytes"],
                       residual_shape=list(sharding.residual["shape"]))
            shares, pdiff, finite = {}, 0.0, True
            # gathered leaf by leaf to rank 0 alone and compared on its
            # card, one leaf at a time: four ranks may share the card's
            # memory
            for (name, g), (_, p), (_, sp) in zip(
                    leaves_by_path(grads), leaves_by_path(local),
                    leaves_by_path(specs)):
                g = sharding.gather_to(g, sp, ctx)
                p = None if grads_only else sharding.gather_to(p, sp, ctx)
                if rank0:
                    w = want_g[name].to(dev).float()
                    tol = GRAD_EPS * BF16_EPS * max(float(w.abs().max()),
                                                    1e-30)
                    shares[name] = float((g.float() - w).abs().max()) / tol
                    finite = finite and bool(torch.isfinite(g).all())
                    if p is not None:
                        pdiff = max(pdiff, float(
                            (p - want_p[name].to(dev)).abs().max()))
                    del w
                del g, p
            if rank0:
                worst = max(shares, key=shares.get)
                rec.update(worst_leaf=worst, worst_share=shares[worst],
                           finite=finite,
                           param_max_diff=None if grads_only else pdiff,
                           loss_share=abs(rec["loss"] - rec["one_card_loss"])
                           / (TOL_EPS * BF16_EPS
                              * abs(rec["one_card_loss"])))
            mark("compare_s")
        del grads
    rec.update(placed_bitwise=placed, step_s=walls, launches=launches,
               traffic=traffic,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    torch.distributed.barrier()
    mark("steps_s")
    rec.update(case_s=time.perf_counter() - t_case, parts=parts)
    return rec


def _elastic_check(ckpt_dir, ctx) -> dict:
    """The launcher's last checkpoint restored onto ``ctx``'s mesh: every
    rank's blocks gathered back equal, on rank 0, the whole leaves as
    ``ckpt.load`` assembles them, bitwise."""
    from repro_torch.checkpoint import ckpt, elastic
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import unshard_state
    model = build_model(get_config("smollm-360m"))
    state, step = elastic.restore_elastic(ckpt_dir, model, ctx)
    gathered = unshard_state(state, model, ctx)
    rec = dict(step=step, leaves=len(tree_leaves(state.params)))
    if ctx.mesh.rank == 0:
        whole, _ = ckpt.load(ckpt_dir, step)
        rec["whole_bitwise"] = all(
            torch.equal(a.cpu(), b) for tree, ref in zip(
                (gathered.params, gathered.opt.mu, gathered.opt.nu),
                (whole[".params"], whole[".opt"][".mu"],
                 whole[".opt"][".nu"]))
            for a, b in zip(tree_leaves(tree), tree_leaves(ref))) and \
            int(gathered.opt.step) == int(whole[".opt"][".step"])
    torch.distributed.barrier()
    return rec


def _mesh_rank(rank, world, ckpt_dir, out_dir) -> None:
    """Phase j on one rank: the elastic restore onto (4, 1), then every
    case of :data:`MESH_CASES`, then phase k's rank work and phase m's in
    the same world; each rank writes its records."""
    from repro_torch.models import sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx_of = _mesh_ctxs()
    out = {"elastic": _elastic_check(ckpt_dir, ctx_of(ELASTIC_MESH)),
           "steps": []}
    if rank == 0:
        log(f"mesh: rank 0: elastic restore onto {ELASTIC_MESH} checked")
    torch.cuda.empty_cache()
    for case in MESH_CASES:
        ctx = ctx_of(case[2])
        out["steps"].append(_mesh_step_case(case, ctx))
        out["transport"] = sharding.transport(ctx, ctx.mesh.device)
        out["backend"] = ctx.mesh.backend
        torch.cuda.empty_cache()
        if rank == 0:
            log(f"mesh: rank 0: {case[0]} on {case[2]} done in "
                f"{out['steps'][-1]['case_s']:.1f} s "
                + json.dumps({k: round(v, 1) for k, v in
                              out["steps"][-1]["parts"].items()}))
    out["families"] = _families_work(rank, ctx_of)
    torch.cuda.empty_cache()
    out["stream_sharded"] = _stream_sharded_work(rank, world, out_dir)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def phase_mesh(one_card: dict = None):
    """Phase j, the multi-device path: the training launcher at full width
    and depth on a (2, 2) mesh (a failure, a restart, the replay bitwise),
    its last checkpoint restored onto (4, 1) and onto one card bitwise,
    then one sharded step of each of :data:`MESH_CASES` against one card's
    and timed steps; four ranks, NCCL with a card each, gloo with the
    tensors staged through host memory where they share cards.  The same
    ranks then run phase k's work and phase m, the sharded stream (one
    world, one warm-up); returns the record (phase m's under
    ``"stream_sharded"``) and each rank's phase k records for
    :func:`phase_families`.  ``one_card``: phase f''s ``joint_1e7`` digest
    and wall (streamed here when None)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import ckpt, elastic
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_launcher_mod
    from repro_torch.train.optimizer import tree_leaves
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    world = 4
    backend = mesh_mod.backend_for("cuda", world)
    log(f"mesh: {world} ranks on {cards} card(s), backend {backend}"
        + ("" if backend == "nccl" else ", tensors staged through host "
           "memory (transport=host-staged)"))
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    out_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_out_")
    cfg = get_config("smollm-360m")
    try:
        # phase m's yardstick
        one_card = one_card or one_card_stream()
        with open(Path(out_dir) / "one_card.json", "w") as f:
            json.dump(one_card, f)
        argv = MESH_ARGV + ["--ckpt-dir", ckpt_dir]
        log(f"mesh: launcher {' '.join(argv)}")
        out = train_launcher_mod.main(argv)
        rep = out["report"]
        first = [out["losses"][s][0] for s in sorted(out["losses"])]
        replayed = {s: v for s, v in out["losses"].items() if len(v) > 1}
        bitwise = {s: v[0] == v[1] for s, v in replayed.items()}
        want = step_launches(cfg)
        if rep.restarts != 1 or rep.restored_steps != [1] or \
                sorted(replayed) != [2] or not all(bitwise.values()) \
                or not first[-1] < first[0] or \
                any(n != want for n in out["launches"]):
            raise AssertionError(
                f"mesh launcher: restarts {rep.restarts}, restored "
                f"{rep.restored_steps}, replayed {replayed}, losses {first}, "
                f"launches {out['launches']} (want {want} a step)")
        per_step = [sum(t[k] for k in ("all_reduce", "all_gather"))
                    for t in out["traffic"]]
        launcher = dict(losses=first, replayed=replayed,
                        replay_bitwise=bitwise,
                        median_step_s=out["median_step_s"],
                        tokens_per_s=out["tokens_per_step"]
                        / out["median_step_s"], peak_gib=out["peak_gib"],
                        launches_per_step=want, step_s=out["step_s"],
                        wall_s=out["wall_s"], backend=out["backend"],
                        transport=out["transport"],
                        collective_bytes_per_step=sorted(per_step)[
                            len(per_step) // 2],
                        collective_calls_per_step=out["traffic"][0]["calls"])
        log(f"mesh: launcher --mesh 2,2 (smollm-360m, 32 layers, 8 x 512 "
            f"tokens): loss {first[0]:.4f} -> {first[-1]:.4f}, one restart "
            f"from step 1, replayed step 2 bitwise {bitwise}; median "
            f"step {1e3 * launcher['median_step_s']:.1f} ms "
            f"({launcher['tokens_per_s']:.0f} tokens/s), rank 0 peak "
            f"{out['peak_gib']:.2f} GiB, {want} launches a step on each "
            f"rank, collectives {launcher['collective_bytes_per_step'] / 2**30:.3f} "
            f"GiB in {launcher['collective_calls_per_step']} calls a step "
            f"on rank 0; backend {out['backend']}, transport "
            f"{out['transport']} [{card_line()}]")
        log(f"mesh: this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of the card "
            f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) as the "
            f"ranks start")
        # four ranks share one card's memory where there is one card
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        mesh_mod.spawn(_mesh_rank, world, (ckpt_dir, out_dir), device="cuda")
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(world)]
        # the same checkpoint onto one card
        model = build_model(cfg)
        state, step = elastic.restore_elastic(ckpt_dir, model, None,
                                              device=DEV)
        whole, _ = ckpt.load(ckpt_dir, step)
        one_ok = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(state.params) + tree_leaves(state.opt.mu)
            + tree_leaves(state.opt.nu),
            tree_leaves(whole[".params"]) + tree_leaves(
                whole[".opt"][".mu"]) + tree_leaves(whole[".opt"][".nu"])))
        del state, whole
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    el = [r["elastic"] for r in ranks]
    if not (one_ok and el[0]["whole_bitwise"]):
        raise AssertionError(f"mesh: elastic restore not bitwise: one card "
                             f"{one_ok}, {ELASTIC_MESH} {el[0]}")
    log(f"mesh: the launcher's step-{el[0]['step']} checkpoint restored "
        f"onto one card and onto {ELASTIC_MESH}: every leaf bitwise "
        f"({el[0]['leaves']} parameter leaves, moments too)")
    steps = []
    for i, case in enumerate(MESH_CASES):
        recs = [r["steps"][i] for r in ranks]
        r0 = recs[0]
        bad = [r for r in recs if not r["placed_bitwise"]
               or any(n != r["want_launches"] for n in r["launches"])]
        if bad or r0["loss_share"] > 1.0 or r0["worst_share"] > 1.0 or \
                not r0["finite"] or r0["param_max_diff"] >= 5e-2:
            raise AssertionError(f"mesh step {case}: {json.dumps(r0)[:3000]}")
        med = [sorted(r["step_s"][1:])[len(r["step_s"][1:]) // 2]
               for r in recs]
        byt = [sum(r["traffic"][-1][k] for k in ("all_reduce", "all_gather"))
               for r in recs]
        rec = dict(arch=case[0], layers=case[1], mesh=list(case[2]),
                   tokens_per_rank=r0["tokens_per_rank"],
                   loss=r0["loss"], one_card_loss=r0["one_card_loss"],
                   loss_share=r0["loss_share"], worst_leaf=r0["worst_leaf"],
                   worst_share=r0["worst_share"],
                   param_max_diff=r0["param_max_diff"],
                   grad_norm=r0["grad_norm"],
                   one_card_grad_norm=r0["one_card_grad_norm"],
                   launches_per_rank_step=r0["launches"][0],
                   median_step_s=max(med), first_step_s=r0["step_s"][0],
                   one_card_step_s=r0["one_card_s"],
                   peak_gib_per_rank=[r["peak_gib"] for r in recs],
                   collective_bytes_per_rank_step=byt,
                   collective_calls_per_step=r0["traffic"][-1]["calls"],
                   case_s=r0["case_s"])
        steps.append(rec)
        log(f"mesh: {case[0]} {case[1]} layers on {case[2]}, "
            f"{rec['tokens_per_rank']} tokens a rank: loss "
            f"{rec['loss']:.6f} sharded, {rec['one_card_loss']:.6f} one card "
            f"({rec['loss_share']:.3f} of the bound); worst gradient leaf "
            f"{rec['worst_leaf']} at {rec['worst_share']:.3f} of {GRAD_EPS} "
            f"bf16 epsilons; parameters after the step within "
            f"{rec['param_max_diff']:.2e}; grad norm {rec['grad_norm']:.6f} "
            f"vs {rec['one_card_grad_norm']:.6f}; placements bitwise; "
            f"launches {rec['launches_per_rank_step']} a rank a step; step "
            f"wall {1e3 * rec['median_step_s']:.1f} ms after the first "
            f"{1e3 * rec['first_step_s']:.1f} ms (one card "
            f"{1e3 * rec['one_card_step_s']:.1f} ms, its first call); peak "
            f"{max(rec['peak_gib_per_rank']):.2f} GiB a rank; collectives "
            f"{max(byt) / 2**30:.3f} GiB in {rec['collective_calls_per_step']} "
            f"calls a rank a step; the case {rec['case_s']:.1f} s "
            f"[{card_line()}]")
    rec = dict(world=world, cards=cards, backend=ranks[0]["backend"],
               transport=ranks[0]["transport"], launcher=launcher,
               elastic=dict(one_card=one_ok, mesh=list(ELASTIC_MESH),
                            step=el[0]["step"]),
               steps=steps, wall_s=time.perf_counter() - t0,
               stream_sharded=stream_sharded_report(
                   [r["stream_sharded"] for r in ranks], cards, one_card))
    log(f"mesh: phase wall {rec['wall_s']:.1f} s (with phase k's rank work)")
    return rec, [r["families"] for r in ranks]


# -- phase k: every family under a mesh -----------------------------------------

#: (k1) sharded training steps of the hybrid, ssm, vlm and enc-dec
#: families (see :data:`MESH_CASES`): the cut gate heads and the
#: query-row branch; the cut in_proj, the norm over d_inner and the SSD
#: scan on 40 heads; 256 patch rows and the KV-head branch with qkv_bias;
#: an encoder of 1000 frames
FAMILY_STEPS = (
    ("recurrentgemma-2b", 3, (1, 4), 2, {}, 256, None),
    ("mamba2-2.7b", 2, (2, 2), 2, {}, 256, None),
    ("internvl2-1b", 2, (2, 2), 2, {}, 512, None),
    ("seamless-m4t-large-v2", 2, (2, 2), 2, {"encoder_layers": 2}, 256,
     ENC_FRAMES[1]))
#: (k2) a prefill of 2 x 256 text tokens a data rank (a vision model's 256
#: patch rows besides, an encoder's 1000 frames) and teacher-forced decodes
#: under each mesh, against one card's run from the same draw
FAMILY_SERVE = (("smollm-360m", 2, {}),
                (OLMOE, 2, {"moe_capacity_factor": 8.0}),
                ("recurrentgemma-2b", 3, {}),
                ("mamba2-2.7b", 2, {}),
                ("internvl2-1b", 2, {}),
                ("seamless-m4t-large-v2", 2, {"encoder_layers": 2}))
FAMILY_MESHES = ((2, 2), (1, 4))
FAMILY_ROWS, FAMILY_TEXT, FAMILY_DECODES, FAMILY_MAX_LEN = 2, 256, 8, 1024
#: (k3) the serving engine under (1, 4) at full width and depth, with the
#: reference launcher's traffic
FAMILY_ENGINE = dict(arch="recurrentgemma-2b", mesh=(1, 4), slots=4,
                     max_len=2048, requests=8, new_tokens=16, seed=0)
#: rank-local shapes of the LM kernels in phase k (flash attention:
#: B, K, G, Sq, Skv, hd, causal, window, q_offset, dtype; the RG-LRU scan:
#: B, S, channels; the SSD scan: B, S, H, P, N, chunk)
FAMILY_FA = {
    "recurrentgemma-2b (1, 4) query rows": (2, 1, 10, 64, 256, 256, True,
                                            2048, 192, "bf16"),
    "recurrentgemma-2b (2, 2) 5 heads": (2, 5, 1, 256, 256, 256, True,
                                         2048, 0, "bf16"),
    "internvl2-1b (2, 2) KV head": (2, 1, 7, 512, 512, 64, True, 0, 0,
                                    "bf16"),
    "seamless encoder (2, 2) 8 heads": (2, 8, 1, 1000, 1000, 64, False, 0,
                                        0, "bf16"),
    "seamless cross (2, 2) 8 heads": (2, 8, 1, 256, 1000, 64, False, 0, 0,
                                      "bf16"),
}
FAMILY_LRU = {"recurrentgemma-2b (1, 4)": (2, 256, 640),
              "recurrentgemma-2b (2, 2)": (2, 256, 1280)}
FAMILY_SSD = {"mamba2-2.7b (2, 2)": (2, 256, 40, 64, 128, 256),
              "mamba2-2.7b (1, 4)": (2, 256, 20, 64, 128, 256)}
#: (l2) the k2 case (and its mesh) served again with sequence parallelism
SP_SERVE = (("internvl2-1b", 2, {}), (1, 4))


def family_kernels() -> dict:
    """Each LM kernel at phase k's rank-local shapes, on the card: held
    against its plain version (flash attention to its tolerance, the
    RG-LRU scan bitwise, the SSD scan to 1e-4 of its largest value) and
    timed beside it, its bound and, for attention, the library's call."""
    gen = torch.Generator(device=DEV).manual_seed(25)
    out = {"flash_attention_fwd": {}, "rglru_scan": {}, "ssd_scan": {}}
    for label, case in FAMILY_FA.items():
        causal, window, off = case[6:9]
        q, k, v = fa_inputs(case, gen)
        got = fa_ops.flash_attention(q, k, v, causal, window, off).float()
        want = fa_ref.attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=off).float()
        atol, rtol = FA_TOL["bf16"]
        if not torch.isfinite(got).all() or \
                not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"flash_attention_fwd {label}: differs "
                                 f"from its plain version")
        rec = dict(case=list(case),
                   max_abs_err=float((got - want).abs().max()),
                   ms=time_ms(lambda: fa_ops.flash_attention(
                       q, k, v, causal, window, off), 20),
                   plain_ms=time_ms(lambda: fa_ref.attention_ref(
                       q, k, v, causal=causal, window=window, q_offset=off),
                       5))
        rec["library_ms"] = min(sdpa_ms(case, q, k, v, 20).values())
        rec["bound_ms"], rec["bound_by"] = fa_bound(case)
        out["flash_attention_fwd"][label] = rec
    for label, shape in FAMILY_LRU.items():
        log_a = -torch.rand(shape, generator=gen, device=DEV) * 2.0
        b = torch.randn(shape, generator=gen, device=DEV)
        err = hold(f"rglru_scan {label} {shape}", lru_ops.lru(log_a, b),
                   lru_ref.lru_ref(log_a, b))
        rec = dict(shape=list(shape), max_abs_err=err,
                   ms=time_ms(lambda: lru_ops.lru(log_a, b), 20),
                   plain_ms=time_ms(lambda: lru_ref.lru_ref(log_a, b), 3),
                   library_ms=None)
        rec["bound_ms"], rec["bound_by"] = lru_bound(shape)
        out["rglru_scan"][label] = rec
    for label, case in FAMILY_SSD.items():
        x, dt, b, c, a_log, _ = ssd_inputs(case, gen)
        chunk = case[5]
        y, fs = ssd_ops.ssd(x, dt, b, c, a_log, chunk)
        wy, wfs = ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                              chunk)
        err = max(float((y - wy).abs().max()), float((fs - wfs).abs().max()))
        if err > SSD_REL * max(float(wy.abs().max()),
                               float(wfs.abs().max())):
            raise AssertionError(f"ssd_scan {label}: differs from "
                                 f"ssd_chunked by {err}")
        rec = dict(case=list(case), max_abs_err=err,
                   ms=time_ms(lambda: ssd_ops.ssd(x, dt, b, c, a_log,
                                                  chunk), 20),
                   plain_ms=time_ms(lambda: ssd_chunked(
                       x, dt, b[:, :, None], c[:, :, None], a_log, chunk),
                       3),
                   library_ms=None)
        rec["bound_ms"], rec["bound_by"], _ = ssd_bound(case)
        out["ssd_scan"][label] = rec
    for name, recs in out.items():
        for label, rec in recs.items():
            log(f"mesh families: kernel {name} @ rank-local {label}: max "
                f"|diff| vs plain {rec['max_abs_err']:.3g}; kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms"
                + (f", library {rec['library_ms']:.4f} ms"
                   if rec["library_ms"] is not None else "")
                + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) "
                f"[{card_line()}]")
    return out


def _leaves_with_specs(tree, specs):
    """``(tensor, spec)`` of every cache leaf (dicts and tuples)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, specs)
                for x in _leaves_with_specs(t, s)]
    return [(tree, specs)]


def _replicated_equal(caches, specs, ctx) -> bool:
    """Every cache leaf the spec keeps whole over 'model' holds the same
    bits on every 'model' rank."""
    from repro_torch.models import sharding
    ok = True
    for t, spec in _leaves_with_specs(caches, specs):
        if ctx.tp_axis in sharding.sharded_axes(spec):
            continue
        every = sharding.all_gather(t[None], ctx, ctx.tp_axis, 0)
        ok = ok and all(bool(torch.equal(every[0], every[i]))
                        for i in range(1, every.shape[0]))
    return ok


def _share(got, want) -> float:
    """|got - want| over the serving bound (:data:`TOL_EPS` bf16 epsilons
    of the largest |want|): at most 1 holds."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    tol = TOL_EPS * BF16_EPS * max(float(want.abs().max()), 1e-6)
    return float((got - want).abs().max()) / tol


def _cpu_caches(caches):
    from repro_torch.models import sharding
    return sharding.map_tree(lambda t: None if t is None else
                             t.detach().to("cpu", copy=True), caches)


def _caches_share(got, want) -> float:
    """The largest :func:`_share` over the cache leaves."""
    gl = [t for t, _ in _leaves_with_specs(got, got)]     # (no specs: the
    wl = [t for t, _ in _leaves_with_specs(want, want)]   # tree's own walk)
    if len(gl) != len(wl) or any(a.shape != b.shape for a, b in zip(gl, wl)):
        raise AssertionError("gathered caches differ in structure or shape "
                             "from one card's")
    return max(_share(a, b) for a, b in zip(gl, wl))


def serving_ctx(ctx):
    """The parameters' placement for serving: 'model' blocks, replicated
    over 'data' (no FSDP gathers a forward; the caches as the spec
    places them)."""
    import dataclasses
    return dataclasses.replace(ctx, fsdp_axis=None)


def _family_serve_case(case, ctx) -> dict:
    """(k2) one case of :data:`FAMILY_SERVE` on this rank: rank 0 runs one
    card's prefill and teacher-forced decodes from the full draw; then
    every rank the sharded prefill and decodes with the same tokens.
    Logits, the caches gathered back and the replicated cache leaves are
    held on rank 0 (on the host)."""
    import dataclasses
    from repro_torch.models import sharding
    t_case = time.perf_counter()
    arch, layers, rep = case
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, **rep)
    model = build_model(cfg)
    dev = ctx.mesh.device
    rank0 = ctx.mesh.rank == 0
    rows = FAMILY_ROWS * ctx.dp_size()
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        rows, FAMILY_TEXT)), device=dev)
    extra, off = {}, 0
    if cfg.frontend == "vision":
        off = cfg.frontend_tokens
        extra["patch_embeds"] = torch.as_tensor((rng.standard_normal((
            rows, off, cfg.d_model)) * 0.02).astype(np.float32), device=dev)
    if cfg.is_encdec:
        extra["frames"] = torch.as_tensor((rng.standard_normal((
            rows, ENC_FRAMES[1], cfg.d_model)) * 0.02).astype(np.float32),
            device=dev)
    pos = lambda step: torch.full((rows, 1), off + FAMILY_TEXT + step,
                                  device=dev)
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    rec = dict(arch=arch, layers=layers, mesh=list(ctx.mesh.devices_shape),
               rows=rows, text=FAMILY_TEXT, positions=off + FAMILY_TEXT)
    feed = [None]
    if rank0:
        with torch.no_grad():
            logits, caches = model.prefill(full, tokens, FAMILY_MAX_LEN,
                                           **extra)
            want_logits = [logits.float().cpu()]
            want_caches = [_cpu_caches(caches)]
            feed[0] = []
            for step in range(FAMILY_DECODES):
                tok = torch.argmax(logits, dim=-1)[:, None]
                feed[0].append(tok.cpu())
                logits, caches = model.decode_step(full, tok, caches,
                                                   pos(step))
                want_logits.append(logits.float().cpu())
            want_caches.append(_cpu_caches(caches))
        del logits, caches
    torch.distributed.broadcast_object_list(feed, src=0)
    local = model.shard_params(full, ctx)
    del full
    torch.cuda.empty_cache()
    specs = model.cache_specs(ctx, rows, FAMILY_MAX_LEN)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.distributed.barrier()
    torch.cuda.synchronize(dev)
    reset_counts()
    sharding.reset_traffic()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = model.prefill(local, tokens, FAMILY_MAX_LEN,
                                       ctx=ctx, **extra)
    torch.cuda.synchronize(dev)
    rec.update(prefill_s=time.perf_counter() - t0,
               prefill_residual_bytes=sharding.residual["bytes"],
               prefill_launches=lm_counts(),
               want_prefill_launches=family_launches(cfg, True),
               prefill_traffic=dict(sharding.traffic))
    got_logits = [logits.float().cpu()]
    same = _replicated_equal(caches, specs, ctx)
    got_caches = [_cpu_caches(sharding.gather_tree_to(caches, specs, ctx,
                                                      device="cpu"))]
    ticks, tick_traffic, decode_launches = [], [], []
    for step, tok in enumerate(feed[0]):
        torch.cuda.synchronize(dev)
        reset_counts()
        sharding.reset_traffic()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = model.decode_step(local, tok.to(dev), caches,
                                               pos(step), ctx=ctx)
        torch.cuda.synchronize(dev)
        ticks.append(time.perf_counter() - t0)
        tick_traffic.append(dict(sharding.traffic))
        decode_launches.append(lm_counts())
        got_logits.append(logits.float().cpu())
        same = same and _replicated_equal(caches, specs, ctx)
    got_caches.append(_cpu_caches(sharding.gather_tree_to(
        caches, specs, ctx, device="cpu")))
    rec.update(decode_s=ticks, tick_traffic=tick_traffic,
               decode_launches=decode_launches, replicated_bitwise=same,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if rank0:
        rec["logits_share"] = max(_share(g, w) for g, w in
                                  zip(got_logits, want_logits))
        rec["caches_share"] = max(_caches_share(g, w) for g, w in
                                  zip(got_caches, want_caches))
    del local, caches, logits
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    rec["case_s"] = time.perf_counter() - t_case
    return rec


class _Tap:
    """Wraps a model for a serving engine and records each request's
    logits on the host: its prefill's, then one row a tick while it holds
    a slot."""

    def __init__(self, model):
        self.model, self.prefills, self.rows, self.engine = model, [], {}, \
            None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        logits, caches = self.model.prefill(*args, **kw)
        self.prefills.append(logits[0].float().cpu())
        return logits, caches

    def decode_step(self, *args, **kw):
        logits, caches = self.model.decode_step(*args, **kw)
        rows = logits.float().cpu()
        for i, req in enumerate(self.engine.active):
            if req is not None:
                self.rows.setdefault(req.rid, []).append(rows[i])
        return logits, caches

    def logits(self, rid):
        return [self.prefills[rid]] + self.rows.get(rid, [])


def _engine_requests(cfg):
    rng = np.random.default_rng(FAMILY_ENGINE["seed"])
    out = []
    for i in range(FAMILY_ENGINE["requests"]):
        plen = int(rng.integers(4, 12))
        out.append(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=FAMILY_ENGINE["new_tokens"]))
    return out


def _family_engine(ctx) -> dict:
    """(k3) the serving engine under ``ctx`` at full width and depth.  The
    ranks draw the full weights one at a time (four ranks share one
    card's memory); rank 0 first serves the same requests on one card."""
    from repro_torch.models import sharding
    t_case = time.perf_counter()
    cfg = get_config(FAMILY_ENGINE["arch"])
    model = build_model(cfg)
    dev = ctx.mesh.device
    rank0 = ctx.mesh.rank == 0
    kw = dict(batch_slots=FAMILY_ENGINE["slots"],
              max_len=FAMILY_ENGINE["max_len"])
    rec = dict(arch=cfg.name, layers=cfg.num_layers,
               mesh=list(ctx.mesh.devices_shape), **kw)
    local, one = None, None
    for r in range(ctx.mesh.size):
        if ctx.mesh.rank == r:
            full = model.init(torch.Generator(device=dev).manual_seed(0))
            if rank0:
                tap = _Tap(model)
                eng = ServingEngine(tap, full, device=dev, **kw)
                tap.engine = eng
                for req in _engine_requests(cfg):
                    eng.submit(req)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                done = eng.run_until_drained()
                torch.cuda.synchronize(dev)
                one = dict(wall_s=time.perf_counter() - t0,
                           tokens={q.rid: q.generated for q in done}, tap=tap)
                del eng
            local = model.shard_params(full, ctx)
            del full
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    rec["draws_s"] = time.perf_counter() - t_case
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(model, local, device=dev, ctx=ctx, **kw)
    for req in _engine_requests(cfg):
        eng.submit(req)
    ticks, traffic = [], []
    torch.distributed.barrier()
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    while eng.queue or any(q is not None for q in eng.active):
        sharding.reset_traffic()
        t1 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize(dev)
        ticks.append(time.perf_counter() - t1)
        traffic.append(dict(sharding.traffic))
    wall = time.perf_counter() - t0
    launches = lm_counts()
    tokens = {q.rid: q.generated for q in eng.finished}
    every = [None] * ctx.mesh.size
    torch.distributed.all_gather_object(every, tokens)
    n_tok = sum(len(v) for v in tokens.values())
    per_tick = [t["all_reduce"] + t["all_gather"] for t in traffic]
    rec.update(wall_s=wall, tokens=n_tok, tok_per_s=n_tok / wall,
               ticks=len(ticks), tick_s=ticks,
               collective_bytes_per_tick=sorted(per_tick)[len(per_tick) // 2],
               collective_calls_per_tick=sorted(
                   t["calls"] for t in traffic)[len(traffic) // 2],
               collective_bytes_max_tick=max(per_tick),
               launches=launches,
               launches_per_prefill={k: v / FAMILY_ENGINE["requests"]
                                     for k, v in launches.items()},
               want_per_prefill=family_launches(cfg, True),
               ranks_agree=all(e == every[0] for e in every),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if rank0:
        diffs, first = 0, []
        for rid, want in one["tokens"].items():
            got = tokens[rid]
            rows = one["tap"].logits(rid)
            d = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
            diffs += len(d)
            if d:
                top = torch.topk(rows[d[0]], 2).values
                first.append(dict(rid=rid, step=d[0],
                                  top2_gap=float(top[0] - top[1])))
        rec.update(one_card_wall_s=one["wall_s"],
                   one_card_tok_per_s=n_tok / one["wall_s"],
                   tokens_differing=diffs, first_differences=first)
    del eng, local
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    rec["case_s"] = time.perf_counter() - t_case
    return rec


def _families_work(rank, ctx_of) -> dict:
    """Phase k on one rank: (k1) the sharded steps, (k2) prefill and
    decodes under each mesh, then phase l2's sequence-parallel steps and
    prefill, then (k3) the engine; ``ctx_of(shape)`` gives the ctx of a
    live mesh."""
    import dataclasses
    from repro_torch.models import sharding
    out = {"steps": [], "serve": []}
    for case in FAMILY_STEPS:
        out["steps"].append(_mesh_step_case(case, ctx_of(case[2])))
        torch.cuda.empty_cache()
        if rank == 0:
            log(f"mesh families: rank 0: step {case[0]} on {case[2]} done "
                f"in {out['steps'][-1]['case_s']:.1f} s "
                + json.dumps({k: round(v, 1) for k, v in
                              out["steps"][-1]["parts"].items()}))
    for shape in FAMILY_MESHES:
        for case in FAMILY_SERVE:
            out["serve"].append(_family_serve_case(
                case, serving_ctx(ctx_of(shape))))
            if rank == 0:
                log(f"mesh families: rank 0: serve {case[0]} on {shape} "
                    f"done in {out['serve'][-1]['case_s']:.1f} s")
    # (l2) k1's steps and one k2 case again with sequence parallelism on,
    # before k3's full-depth engine (so that the peaks compare with k1's)
    sp_of = lambda shape: dataclasses.replace(ctx_of(shape),
                                              sequence_parallel=True)
    out["sp_steps"] = []
    for case in FAMILY_STEPS:
        out["sp_steps"].append(_mesh_step_case(case, sp_of(case[2]),
                                               grads_only=True))
        torch.cuda.empty_cache()
        if rank == 0:
            log(f"sequence parallel: rank 0: step {case[0]} on {case[2]} "
                f"done in {out['sp_steps'][-1]['case_s']:.1f} s")
    out["sp_serve"] = _family_serve_case(SP_SERVE[0], serving_ctx(sp_of(
        SP_SERVE[1])))
    out["engine"] = _family_engine(serving_ctx(ctx_of(
        FAMILY_ENGINE["mesh"])))
    ctx = ctx_of(FAMILY_MESHES[0])
    out["transport"] = sharding.transport(ctx, ctx.mesh.device)
    out["backend"] = ctx.mesh.backend
    return out


def _mesh_ctxs():
    """``ctx_of(shape)``: the ctx of a live (data, model) mesh, each built
    once, in the same order on every rank."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import sharding
    meshes = {}

    def ctx_of(shape):
        if shape not in meshes:
            meshes[shape] = sharding.from_mesh(mesh_mod.init_mesh(
                shape, ("data", "model")))
        return meshes[shape]
    return ctx_of


def phase_families(ranks) -> dict:
    """Phase k: every family under a (data, model) mesh, four ranks (NCCL
    with a card a rank, else gloo staged through host memory): the LM
    kernels at their rank-local shapes on the card; (k1) a sharded
    training step of the hybrid, ssm, vlm and enc-dec families against one
    card's; (k2) prefill and teacher-forced decodes of six families under
    (2, 2) and (1, 4) against one card's run (logits and gathered caches
    within the serving bound, replicated cache leaves bitwise across the
    'model' ranks); (k3) the serving engine under (1, 4) at full width and
    depth beside one card's engine.  The kernels' launches a rank are
    counted around each sharded run and held exactly.  ``ranks``: each
    rank's records of that work, run in phase j's world
    (:func:`phase_mesh`)."""
    t0 = time.perf_counter()
    kernels = family_kernels()
    torch.cuda.empty_cache()
    steps = []
    for i, case in enumerate(FAMILY_STEPS):
        recs = [r["steps"][i] for r in ranks]
        r0 = recs[0]
        bad = [r for r in recs if not r["placed_bitwise"]
               or any(n != r["want_launches"] for n in r["launches"])]
        if bad or r0["loss_share"] > 1.0 or r0["worst_share"] > 1.0 or \
                not r0["finite"] or r0["param_max_diff"] >= 5e-2:
            raise AssertionError(f"mesh families step {case[:3]}: "
                                 f"{json.dumps(r0)[:3000]}")
        byt = [sum(r["traffic"][-1][k] for k in ("all_reduce", "all_gather"))
               for r in recs]
        rec = dict(arch=case[0], layers=case[1], mesh=list(case[2]),
                   tokens_per_rank=r0["tokens_per_rank"],
                   frames=r0["frames"], loss=r0["loss"],
                   one_card_loss=r0["one_card_loss"],
                   loss_share=r0["loss_share"], worst_leaf=r0["worst_leaf"],
                   worst_share=r0["worst_share"],
                   param_max_diff=r0["param_max_diff"],
                   launches_per_rank_step=r0["launches"][0],
                   step_s=max(r["step_s"][-1] for r in recs),
                   first_step_s=r0["step_s"][0],
                   one_card_step_s=r0["one_card_s"],
                   peak_gib_per_rank=[r["peak_gib"] for r in recs],
                   collective_bytes_per_rank_step=byt,
                   collective_calls_per_step=r0["traffic"][-1]["calls"],
                   case_s=r0["case_s"])
        steps.append(rec)
        log(f"mesh families k1: {case[0]} {case[1]} layers on {case[2]}, "
            f"{rec['tokens_per_rank']} tokens a rank"
            + (f", {case[6]} frames" if case[6] else "")
            + f": loss {rec['loss']:.6f} sharded, {rec['one_card_loss']:.6f}"
            f" one card ({rec['loss_share']:.3f} of the bound); worst "
            f"gradient leaf {rec['worst_leaf']} at {rec['worst_share']:.3f} "
            f"of {GRAD_EPS} bf16 epsilons; parameters within "
            f"{rec['param_max_diff']:.2e}; launches "
            f"{rec['launches_per_rank_step']} a rank a step; step "
            f"{1e3 * rec['step_s']:.1f} ms after the first "
            f"{1e3 * rec['first_step_s']:.1f} ms (one card "
            f"{1e3 * rec['one_card_step_s']:.1f} ms, its first call); peak "
            f"{max(rec['peak_gib_per_rank']):.2f} GiB a rank; collectives "
            f"{max(byt) / 2**30:.3f} GiB in "
            f"{rec['collective_calls_per_step']} calls a rank a step "
            f"[{card_line()}]")
    serve = []
    for i, r0 in enumerate(ranks[0]["serve"]):
        recs = [r["serve"][i] for r in ranks]
        bad = [r for r in recs if not r["replicated_bitwise"]
               or r["prefill_launches"] != r["want_prefill_launches"]
               or any(sum(n.values()) for n in r["decode_launches"])]
        what = f"mesh families k2 {r0['arch']} on {tuple(r0['mesh'])}"
        if bad or r0["logits_share"] > 1.0 or r0["caches_share"] > 1.0:
            raise AssertionError(f"{what}: {json.dumps(r0)[:3000]}")
        tick = sorted(max(r["decode_s"][j] for r in recs)
                      for j in range(FAMILY_DECODES))[FAMILY_DECODES // 2]
        tb = [t["all_reduce"] + t["all_gather"] for t in r0["tick_traffic"]]
        rec = dict(arch=r0["arch"], layers=r0["layers"], mesh=r0["mesh"],
                   rows=r0["rows"], positions=r0["positions"],
                   logits_share=r0["logits_share"],
                   caches_share=r0["caches_share"],
                   prefill_launches_per_rank=r0["prefill_launches"],
                   prefill_s=max(r["prefill_s"] for r in recs),
                   tick_s=tick, tick_bytes=sorted(tb)[len(tb) // 2],
                   tick_calls=r0["tick_traffic"][-1]["calls"],
                   prefill_bytes=r0["prefill_traffic"]["all_reduce"]
                   + r0["prefill_traffic"]["all_gather"],
                   prefill_calls=r0["prefill_traffic"]["calls"],
                   peak_gib_per_rank=[r["peak_gib"] for r in recs],
                   case_s=r0["case_s"])
        serve.append(rec)
        log(f"{what}: {rec['layers']} layers, {rec['rows']} rows of "
            f"{rec['positions']} positions, {FAMILY_DECODES} decodes: logits "
            f"at {rec['logits_share']:.3f} and gathered caches at "
            f"{rec['caches_share']:.3f} of the bound ({TOL_EPS} bf16 "
            f"epsilons of the largest), replicated cache leaves bitwise on "
            f"every 'model' rank; {rec['prefill_launches_per_rank']} launches "
            f"a rank a prefill, none a decode; prefill "
            f"{1e3 * rec['prefill_s']:.1f} ms ({rec['prefill_bytes'] / 2**20:.2f}"
            f" MiB in {rec['prefill_calls']} calls), tick "
            f"{1e3 * rec['tick_s']:.1f} ms ({rec['tick_bytes'] / 2**20:.3f} "
            f"MiB in {rec['tick_calls']} calls); peak "
            f"{max(rec['peak_gib_per_rank']):.2f} GiB a rank [{card_line()}]")
    engs = [r["engine"] for r in ranks]
    e0 = engs[0]
    if not all(e["ranks_agree"] for e in engs) or any(
            e["launches_per_prefill"] != e["want_per_prefill"]
            for e in engs):
        raise AssertionError(f"mesh families k3: {json.dumps(e0)[:3000]}")
    engine = {k: v for k, v in e0.items() if k not in ("tick_s",
                                                       "want_per_prefill")}
    engine["peak_gib_per_rank"] = [e["peak_gib"] for e in engs]
    engine["median_tick_s"] = sorted(e0["tick_s"])[len(e0["tick_s"]) // 2]
    log(f"mesh families k3: ServingEngine {e0['arch']} ({e0['layers']} "
        f"layers) under {tuple(e0['mesh'])}, {FAMILY_ENGINE['requests']} "
        f"requests of 4-11 tokens, {e0['batch_slots']} slots, max_len "
        f"{e0['max_len']}: {e0['tokens']} tokens in {e0['wall_s']:.2f} s "
        f"({e0['tok_per_s']:.1f} tok/s; one card's engine "
        f"{e0['one_card_tok_per_s']:.1f} tok/s; the draws and one card's "
        f"engine before it {e0['draws_s']:.1f} s), {e0['ticks']} ticks, median "
        f"{1e3 * engine['median_tick_s']:.1f} ms; peak "
        f"{max(engine['peak_gib_per_rank']):.2f} GiB a rank; collectives "
        f"{e0['collective_bytes_per_tick'] / 2**20:.3f} MiB in "
        f"{e0['collective_calls_per_tick']} calls a tick (median; max "
        f"{e0['collective_bytes_max_tick'] / 2**20:.3f} MiB); launches a "
        f"rank a prefill {e0['launches_per_prefill']}; tokens differing from "
        f"one card's engine {e0['tokens_differing']} of {e0['tokens']}, "
        f"first differences {e0['first_differences']} [{card_line()}]")
    rec = dict(world=len(ranks), cards=torch.cuda.device_count(),
               backend=ranks[0]["backend"], transport=ranks[0]["transport"],
               kernels=kernels, steps=steps, serve=serve, engine=engine,
               wall_s=time.perf_counter() - t0)
    log(f"mesh families: phase wall {rec['wall_s']:.1f} s (the ranks' work "
        f"ran in phase j's world, inside its wall)")
    return rec


# -- phase l: the dry run and sequence parallelism -------------------------------

#: (l1) one dry-run cell of each family and shape kind at full width and
#: depth, the cheaper cells of each (the two trains are the costly ones;
#: `--all` traces the rest): (arch, shape, multi-pod, sequence parallel)
DRYRUN_CELLS = ((OLMOE, "train_4k", False, False),
                ("smollm-360m", "prefill_32k", False, False),
                ("recurrentgemma-2b", "long_500k", False, False),
                ("mamba2-2.7b", "decode_32k", False, False),
                ("internvl2-1b", "prefill_32k", False, False),
                ("seamless-m4t-large-v2", "decode_32k", False, False),
                ("mistral-large-123b", "train_4k", True, True))
#: the devices l1 traces on, one subprocess each
DRYRUN_DEVICES = ("cuda", "cpu")
#: the card memory the tracing process may allocate (the bridge's small
#: tensors; a traced step's tensors would take gigabytes)
DRYRUN_CARD_BYTES = 1 << 20


def dryrun_cells(device: str, out_dir: str) -> None:
    """``--dryrun-cells``: every cell of :data:`DRYRUN_CELLS` traced on
    ``device``'s fake tensors (:func:`repro_torch.launch.dryrun.run_cell`),
    its artifact written into ``out_dir``, and ``summary.json``: per cell
    its trace wall, counts, roofline and mix; the kernels' launches and
    the card memory this process allocated over all of them."""
    from repro_torch.launch import dryrun
    # below the ranks of phases j and k, which run beside it: this
    # process fills the host's idle time
    os.nice(10)
    reset_counts()
    cells = []
    for arch, shape, mp, sp in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, multi_pod=mp, sequence_parallel=sp,
                            out_dir=out_dir, device=device)
        cells.append(dict({k: r[k] for k in (
            "arch", "shape", "mesh", "chips", "trace_s", "counts",
            "roofline")}, mix=r["memsys_bridge"]["mix"],
            sequence_parallel=sp))
    card = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    with open(Path(out_dir) / "summary.json", "w") as f:
        json.dump(dict(cells=cells, launches=read_counts(),
                       card_bytes=card), f)


def phase_dryrun_start() -> dict:
    """Start l1's subprocesses, one a device of :data:`DRYRUN_DEVICES`
    (they run beside phases j and k)."""
    import tempfile
    started = {"t0": time.perf_counter(), "procs": {}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for dev in DRYRUN_DEVICES:
        out = tempfile.mkdtemp(prefix=f"repro_torch_dryrun_{dev}_")
        logf = open(Path(out) / "log.txt", "w")
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
             dev, out], stdout=logf, stderr=subprocess.STDOUT, env=env)
        started["procs"][dev] = (proc, out, logf)
    log(f"dryrun: {len(DRYRUN_CELLS)} cells traced on "
        f"{', '.join(DRYRUN_DEVICES)} in subprocesses")
    return started


def _close(got, want, path="") -> float:
    """The largest |difference| of two decoded reports' numbers, raising
    where their labels or structure differ."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"dryrun bridge {path}: keys differ")
        return max([_close(got[k], want[k], f"{path}.{k}") for k in want],
                   default=0.0)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"dryrun bridge {path}: lengths differ")
        return max([_close(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    if isinstance(want, (str, bool)) or want is None:
        if got != want:
            raise AssertionError(f"dryrun bridge {path}: {got!r} != {want!r}")
        return 0.0
    if float(got) == float(want):
        return 0.0
    return abs(float(got) - float(want))


def phase_dryrun_finish(started: dict) -> dict:
    """(l1) collect the subprocesses' cells: the card's counts equal to the
    CPU's exactly, nothing launched; then the design space over the cells
    on the card against the CPU, and the joint and serving frontiers on
    the card with their kernels counted."""
    import shutil
    from repro_torch.core.space import joint_frontier
    from repro_torch.roofline import analysis
    summaries = {}
    for dev, (proc, out, logf) in started["procs"].items():
        rc = proc.wait(timeout=900)
        logf.close()
        text = (Path(out) / "log.txt").read_text()
        if rc != 0:
            raise AssertionError(f"dryrun on {dev}: exit {rc}\n{text[-4000:]}")
        summaries[dev] = json.loads((Path(out) / "summary.json").read_text())
        shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - started["t0"]
    card, host = summaries["cuda"], summaries["cpu"]
    launched = {k: v for s in summaries.values()
                for k, v in s["launches"].items() if v}
    if launched or card["card_bytes"] > DRYRUN_CARD_BYTES:
        raise AssertionError(f"dryrun: launches {launched}, card bytes "
                             f"{card['card_bytes']}")
    cells, differ = [], []
    for c, h in zip(card["cells"], host["cells"]):
        if c["counts"] != h["counts"] or c["roofline"] != h["roofline"]:
            differ.append((c["arch"], c["shape"], {
                k: (v, h["counts"][k]) for k, v in c["counts"].items()
                if v != h["counts"][k]}))
        n, r = c["counts"], c["roofline"]
        cells.append(dict(
            arch=c["arch"], shape=c["shape"], mesh=c["mesh"],
            sequence_parallel=c["sequence_parallel"],
            trace_s=c["trace_s"], cpu_trace_s=h["trace_s"],
            flops=n["flops"], read_bytes=n["read_bytes"],
            write_bytes=n["write_bytes"],
            collective_bytes=n["collective_bytes"], by_kind=n["by_kind"],
            peak_live_bytes=n["peak_live_bytes"], ops=n["ops"],
            kernel_calls=n["kernel_calls"], dominant=r["dominant"],
            compute_s=r["compute_s"], memory_s=r["memory_s"],
            collective_s=r["collective_s"], mix=c["mix"]))
        log(f"dryrun l1: {c['arch']} × {c['shape']} × {c['mesh']}"
            + (" sequence parallel" if c["sequence_parallel"] else "")
            + f": trace {c['trace_s']:.1f} s on cuda ({h['trace_s']:.1f} s "
            f"on cpu), {n['ops']} operators; FLOPs {n['flops']:.4e}, read "
            f"{n['read_bytes']:.4e} B, write {n['write_bytes']:.4e} B, "
            f"collectives {n['collective_bytes']:.4e} B "
            f"{json.dumps(n['by_kind'])}, peak live "
            f"{n['peak_live_bytes']:.4e} B; kernel operators "
            f"{json.dumps(n['kernel_calls'])}; {r['dominant']}-bound "
            f"(compute {1e3 * r['compute_s']:.2f} ms, memory "
            f"{1e3 * r['memory_s']:.2f} ms, collective "
            f"{1e3 * r['collective_s']:.2f} ms); mix {c['mix']}")
    if differ:
        raise AssertionError(f"dryrun: the card's counts differ from the "
                             f"CPU's (card, cpu): {json.dumps(differ)}")
    reports = {f"{c['arch']}__{c['shape']}__{c['mesh']}":
               analysis.RooflineReport(**c["roofline"]) for c in card["cells"]}
    t0 = time.perf_counter()
    ds = analysis.bridge_design_space(reports, device="cuda")
    bridge_s = time.perf_counter() - t0
    diff = _close(json.loads(json.dumps(ds)), json.loads(json.dumps(
        analysis.bridge_design_space(reports, device="cpu"))))
    if diff > 1e-6:
        raise AssertionError(f"dryrun bridge: card vs CPU differ by {diff}")
    reset_counts()
    t0 = time.perf_counter()
    jf = joint_frontier(sim=ADAPTIVE_SIM, device="cuda")
    joint_s, joint_launches = time.perf_counter() - t0, read_counts()
    reset_counts()
    t0 = time.perf_counter()
    sf = DesignSpace.serving_frontier(device="cuda")
    serving_s, serving_launches = time.perf_counter() - t0, read_counts()
    joint_launches = {k: v for k, v in joint_launches.items() if v}
    serving_launches = {k: v for k, v in serving_launches.items() if v}
    if not joint_launches or not serving_launches or \
            not jf["simulated_best"] or not sf["models"]:
        raise AssertionError(f"dryrun frontiers: joint {joint_launches}, "
                             f"serving {serving_launches}")
    rec = dict(cells=cells, subprocess_wall_s=wall, bridge_s=bridge_s,
               bridge_max_abs_diff=diff,
               winners={n: w["best"] for n, w in ds["workloads"].items()},
               joint_s=joint_s, joint_launches=joint_launches,
               serving_s=serving_s, serving_launches=serving_launches)
    log(f"dryrun l1: design space over {len(reports)} cells on the card "
        f"in {bridge_s:.2f} s, equal to the CPU's (max |diff| {diff:.1e}); "
        f"winners {json.dumps(rec['winners'])}; joint_frontier "
        f"{joint_s:.1f} s, launches {json.dumps(joint_launches)}; "
        f"serving_frontier {serving_s:.1f} s, launches "
        f"{json.dumps(serving_launches)}; the traces' subprocesses "
        f"{wall:.1f} s [{card_line()}]")
    return rec


def phase_sequence_parallel(ranks) -> dict:
    """(l2) the sequence-parallel steps and prefill of phase j's world
    (``ranks``: each rank's phase k records), held as k1 and k2 hold
    theirs, logged beside k1's steps without sequence parallelism."""
    steps = []
    for i, case in enumerate(FAMILY_STEPS):
        recs = [r["sp_steps"][i] for r in ranks]
        plain = [r["steps"][i] for r in ranks]
        r0 = recs[0]
        bad = [r for r in recs if not r["placed_bitwise"]
               or any(n != r["want_launches"] for n in r["launches"])]
        if bad or r0["loss_share"] > 1.0 or r0["worst_share"] > 1.0 or \
                not r0["finite"]:
            raise AssertionError(f"sequence parallel step {case[:3]}: "
                                 f"{json.dumps(r0)[:3000]}")
        byt = lambda rs: [sum(r["traffic"][-1][k] for k in (
            "all_reduce", "all_gather")) for r in rs]
        rec = dict(
            arch=case[0], layers=case[1], mesh=list(case[2]),
            tokens_per_rank=r0["tokens_per_rank"], loss=r0["loss"],
            one_card_loss=r0["one_card_loss"], loss_share=r0["loss_share"],
            worst_leaf=r0["worst_leaf"], worst_share=r0["worst_share"],
            residual_bytes_per_rank=[r["residual_bytes"] for r in recs],
            plain_residual_bytes_per_rank=[r["residual_bytes"]
                                           for r in plain],
            residual_shape=r0["residual_shape"],
            plain_residual_shape=plain[0]["residual_shape"],
            collective_bytes_per_rank_step=byt(recs),
            plain_collective_bytes_per_rank_step=byt(plain),
            collective_calls_per_step=r0["traffic"][-1]["calls"],
            plain_collective_calls_per_step=plain[0]["traffic"][-1]["calls"],
            launches_per_rank_step=r0["launches"][0],
            plain_launches_per_rank_step=plain[0]["launches"][0],
            first_step_s=max(r["step_s"][0] for r in recs),
            plain_first_step_s=max(r["step_s"][0] for r in plain),
            step_gib_per_rank=[r["peak_gib"] - r["base_gib"] for r in recs],
            plain_step_gib_per_rank=[r["peak_gib"] - r["base_gib"]
                                     for r in plain])
        steps.append(rec)
        log(f"sequence parallel l2: {case[0]} {case[1]} layers on "
            f"{case[2]}: loss {rec['loss']:.6f} ({rec['loss_share']:.3f} of "
            f"the bound against one card); worst gradient leaf "
            f"{rec['worst_leaf']} at {rec['worst_share']:.3f} of {GRAD_EPS} "
            f"bf16 epsilons; residual stream {rec['residual_shape']} = "
            f"{rec['residual_bytes_per_rank']} B a rank (without: "
            f"{rec['plain_residual_shape']} = "
            f"{rec['plain_residual_bytes_per_rank']} B); collectives "
            f"{rec['collective_bytes_per_rank_step']} B in "
            f"{rec['collective_calls_per_step']} calls a rank a step "
            f"(without: {rec['plain_collective_bytes_per_rank_step']} B in "
            f"{rec['plain_collective_calls_per_step']}); launches "
            f"{rec['launches_per_rank_step']} (without: "
            f"{rec['plain_launches_per_rank_step']}); first step "
            f"{1e3 * rec['first_step_s']:.1f} ms (without: "
            f"{1e3 * rec['plain_first_step_s']:.1f} ms); the step's peak "
            f"above what the rank held before it "
            f"{max(rec['step_gib_per_rank']):.2f} GiB a rank (without: "
            f"{max(rec['plain_step_gib_per_rank']):.2f}) [{card_line()}]")
    recs = [r["sp_serve"] for r in ranks]
    r0 = recs[0]
    bad = [r for r in recs if not r["replicated_bitwise"]
           or r["prefill_launches"] != r["want_prefill_launches"]
           or any(sum(n.values()) for n in r["decode_launches"])]
    if bad or r0["logits_share"] > 1.0 or r0["caches_share"] > 1.0:
        raise AssertionError(f"sequence parallel prefill: "
                             f"{json.dumps(r0)[:3000]}")
    plain = next(r for r in ranks[0]["serve"] if r["arch"] == SP_SERVE[0][0]
                 and tuple(r["mesh"]) == SP_SERVE[1])
    serve = dict(arch=r0["arch"], mesh=r0["mesh"],
                 logits_share=r0["logits_share"],
                 caches_share=r0["caches_share"],
                 residual_bytes_per_rank=[r["prefill_residual_bytes"]
                                          for r in recs],
                 plain_residual_bytes=plain["prefill_residual_bytes"],
                 prefill_bytes=r0["prefill_traffic"]["all_reduce"]
                 + r0["prefill_traffic"]["all_gather"],
                 plain_prefill_bytes=plain["prefill_traffic"]["all_reduce"]
                 + plain["prefill_traffic"]["all_gather"],
                 prefill_calls=r0["prefill_traffic"]["calls"],
                 prefill_launches_per_rank=r0["prefill_launches"],
                 prefill_s=max(r["prefill_s"] for r in recs))
    log(f"sequence parallel l2: prefill and {FAMILY_DECODES} decodes of "
        f"{serve['arch']} on {tuple(serve['mesh'])}: logits at "
        f"{serve['logits_share']:.3f} and caches at "
        f"{serve['caches_share']:.3f} of the serving bound; residual "
        f"stream {serve['residual_bytes_per_rank']} B a rank (without: "
        f"{serve['plain_residual_bytes']} B); prefill collectives "
        f"{serve['prefill_bytes']} B in {serve['prefill_calls']} calls "
        f"(without: {serve['plain_prefill_bytes']} B); launches "
        f"{serve['prefill_launches_per_rank']} a rank [{card_line()}]")
    return dict(steps=steps, serve=serve)


def family_kernel_record(name: str, families: dict) -> dict:
    """A kernel's entry of phase k: its times at the rank-local shapes and
    its launches a rank in each sharded run."""
    launches = {f"step {st['arch']} {st['mesh']}":
                st["launches_per_rank_step"][name]
                for st in families["steps"]}
    launches.update({f"prefill {sv['arch']} {sv['mesh']}":
                     sv["prefill_launches_per_rank"][name]
                     for sv in families["serve"]})
    launches["engine prefill"] = families["engine"][
        "launches_per_prefill"][name]
    return {"rank_local": families["kernels"][name],
            "launches_per_rank": launches,
            "backend": families["backend"],
            "transport": families["transport"]}


#: decode attention at the benchmark's olmoe-1b-7b ticks: (slots,
#: max_len, KV heads, group, hd) and the mixes' (prompt median, sigma,
#: clip; output median, sigma, clip), whose log-normal draws set each
#: slot's live positions (its prompt and a uniform share of its output)
DA_PATH = {
    "chat": ((32, 2560, 16, 1, 128), (1020, 0.6, 128, 2048),
             (129, 0.7, 16, 512)),
    "code": ((16, 4160, 16, 1, 128), (1500, 0.6, 256, 4096),
             (13, 0.8, 4, 64)),
}


def da_lengths(prompt, output, slots: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)

    def draw(median, sigma, lo, hi):
        return np.clip(np.round(median * np.exp(
            sigma * rng.standard_normal(slots))), lo, hi)
    n = draw(*prompt) + np.floor(rng.random(slots) * draw(*output)) + 1
    return torch.as_tensor(n, dtype=torch.int32)


def da_ptxas() -> dict:
    """ptxas's registers and spills of each decode-attention kernel
    instance (mangled names); a spill of an instance with a group of at
    most 2 (the served shapes) is fatal."""
    text = _build.BUILD_LOG.get("decode_attention")
    if text is None:
        log("ptxas [decode_attention]: library was already built, no report")
        return {}
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "decode_attn" in m.group(1) else None
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    for name, rep in out.items():
        log(f"ptxas {name}: {rep}")
        small = re.search(r"Li([12])ELi4E", name)
        if small and rep.get("spills", 1):
            raise AssertionError(f"decode attention instance {name} spills")
    return out


def phase_decode_attention() -> dict:
    """The decode-attention kernel at the two olmoe cells' tick shapes:
    held against its plain version (bf16: rtol and atol 2^-7 of the
    largest), timed one call, back to back and on the card (the profiler's
    three kernels of a call, summed) beside its bound (each slot's live
    bf16 K and V read once, q read and the output written once, at 3.35
    TB/s), the plain version, and ``scaled_dot_product_attention`` on the
    same boolean mask (timed only; the port never calls it)."""
    records = {"ptxas": da_ptxas()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, ((b, s, kh, g, hd), prompt, output) in DA_PATH.items():
        gen = torch.Generator(device=DEV).manual_seed(31)
        q, k, v = (torch.randn(shape, generator=gen, device=DEV).to(
            torch.bfloat16) for shape in ((b, 1, kh, g, hd), (b, s, kh, hd),
                                          (b, s, kh, hd)))
        lengths = torch.clamp(da_lengths(prompt, output, b, 41), max=s)
        live = int(lengths.sum())
        lengths = lengths.to(DEV)
        got = da_ops.decode_attention(q, k, v, lengths)
        want = da_ref.decode_attention_ref(q, k, v, lengths)
        err = close(f"decode_attention @ {label}", got.float().cpu(),
                    want.float().cpu(),
                    2.0 ** -6 * want.float().abs().max().item())
        nbytes = 2 * (2 * live * kh * hd + 2 * b * kh * g * hd)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        call = lambda: da_ops.decode_attention(q, k, v, lengths)
        card = kernel_ms(call, r"(decode_attn_\w+?)_kernel")
        mask = (torch.arange(s, device=DEV)[None, :]
                < lengths[:, None])[:, None, None, :]
        qs = q.reshape(b, kh * g, 1, hd)
        ks, vs = (t.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
                  .contiguous() for t in (k, v))
        rec = dict(
            shape=[b, s, kh, g, hd], live_positions=live,
            mean_live=live / b, max_abs_err=err, bytes=nbytes,
            ms=time_ms(call, 20), back_to_back_ms=stream_ms(call, 20),
            card_ms=sum(card.values()), stage_ms=card,
            plain_ms=time_ms(lambda: da_ref.decode_attention_ref(
                q, k, v, lengths), 5),
            library_ms=time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), 20),
            bound_ms=bound, bound_by="bytes")
        rec["share_of_bound"] = bound / rec["card_ms"]
        records[label] = rec
        log(f"kernel decode_attention @ {label} {rec['shape']} (mean live "
            f"{rec['mean_live']:.0f} positions): max |diff| vs plain "
            f"{err:.3g}; one call {rec['ms']:.4f} ms, back to back "
            f"{rec['back_to_back_ms']:.4f} ms, on the card "
            f"{rec['card_ms']:.4f} ms ({card}), "
            f"{100 * rec['share_of_bound']:.1f}% of its bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB); plain "
            f"{rec['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"{rec['library_ms']:.4f} ms")
    return records


def lm_kernel_records(lm_records, serving):
    """The ``{"kernels": [...]}`` entries of the serving slices' kernels:
    times at the largest shape (and the path's), launches from the
    launcher run of the model whose prefill runs them."""
    out = []
    for name, largest, path, run in (
            ("flash_attention_fwd", FA_LARGEST, FA_PATH,
             "recurrentgemma-2b launcher"),
            ("rglru_scan", LRU_LARGEST, LRU_PATH,
             "recurrentgemma-2b launcher"),
            ("ssd_scan", SSD_LARGEST, SSD_PATH, "mamba2-2.7b launcher")):
        rs = lm_records[name]
        r = rs[largest]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serving[run]["launches"][name], "launches_from": run,
            "max_abs_err": rs["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": largest, "path_shape": path,
            "path_ms": rs[path]["ms"], "path_plain_ms": rs[path]["plain_ms"],
            "path_bound_ms": rs[path]["bound_ms"],
            "path_library_ms": rs[path].get("library_ms"),
            "timed": {label: {k: rec.get(k) for k in (
                "ms", "plain_ms", "oracle_ms", "bound_ms", "bound_by",
                "bound_f32_ms", "share_of_f32_bound", "stream_ms",
                "stage_ms", "device_ms", "share_of_bound_device",
                "library_ms",
                "sdpa_ms", "share_of_bound", "tflops")
                if k in rec}
                for label, rec in rs.items()
                if isinstance(rec, dict) and "ms" in rec},
            "launches_per_run": {label: rec["launches"][name]
                                 for label, rec in serving.items()
                                 if "launches" in rec},
        })
    out[0]["ptxas"] = lm_records["flash_attention_fwd"].get("ptxas")
    out[1]["bitwise"] = lm_records["rglru_scan"]["bitwise"]
    out[1]["ptxas"] = lm_records["rglru_scan"].get("ptxas")
    line = {run: {k: rec[k] for k in ("wall_s", "tokens", "tok_per_s",
                                      "peak_gib", "launcher_s") if k in rec}
            for run, rec in serving.items() if "launches" in rec}
    log(f"serving runs: {json.dumps(line)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--periodic-ab", metavar="FLIT_SIM_CU", nargs="+",
                    help="only time the periodic detectors of these "
                         "flit_sim.cu files and of the tree's in turns")
    ap.add_argument("--traces", action="store_true",
                    help="only check and time the trace-scan kernels")
    ap.add_argument("--streaming", action="store_true",
                    help="only run the streamed and perturbation phases")
    ap.add_argument("--training", action="store_true",
                    help="only run the training phase")
    ap.add_argument("--mesh", action="store_true",
                    help="only run the multi-device phases (j, k, l2 "
                         "and m)")
    ap.add_argument("--stream-sharded", action="store_true",
                    help="only run the sharded stream (phase m) in a "
                         "world of four ranks")
    ap.add_argument("--wrapper-ab", metavar="PARENT_ROOT",
                    help="only time the LM kernels' wrappers of another "
                         "tree and of this one in turns")
    ap.add_argument("--dryrun", action="store_true",
                    help="only run the dry-run phase (l1)")
    ap.add_argument("--decode-attention", action="store_true",
                    help="only check and time the decode-attention kernel "
                         "at the olmoe cells' tick shapes")
    ap.add_argument("--dryrun-cells", nargs=2, metavar=("DEVICE", "DIR"),
                    help="l1's subprocess: trace the cells on DEVICE "
                         "into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if args.dryrun_cells:
        dryrun_cells(*args.dryrun_cells)
        return
    card = card_line()
    log(f"card: {card}")
    if args.periodic_ab:
        turns = periodic_ab(args.periodic_ab)
        print(card)
        print(json.dumps({"periodic_ab": turns}))
        return
    if args.traces:
        _build.build(["flit_sim"])
        flit_ptxas()
        records = phase_traces()
        print(card)
        print(json.dumps({"traces": records}))
        return
    if args.wrapper_ab:
        _build.build(["flash_attention", "rglru_scan", "ssd_scan"])
        turns = wrapper_ab(args.wrapper_ab)
        print(card)
        print(json.dumps({"wrapper_ab": turns}))
        return
    if args.decode_attention:
        secs = _build.build(["decode_attention"])
        log(f"build: {secs} s")
        records = phase_decode_attention()
        print(card)
        print(json.dumps({"decode_attention": records}))
        return
    if args.dryrun:
        _build.build(["flit_sim"])
        records = phase_dryrun_finish(phase_dryrun_start())
        print(card)
        print(json.dumps({"dryrun": records}))
        return
    if args.streaming:
        _build.build(["flit_sim"])
        records = phase_streaming()
        print(card)
        print(json.dumps({"streaming": records}))
        return
    if args.stream_sharded:
        _build.build(["flit_sim"])
        records = phase_stream_sharded()
        print(card)
        print(json.dumps({"stream_sharded": records}))
        return
    if args.training:
        _build.build(["flash_attention", "rglru_scan", "ssd_scan"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        records = phase_training()
        print(card)
        print(json.dumps({"training": records}))
        return
    if args.mesh:
        _build.build(["flash_attention", "rglru_scan", "ssd_scan",
                      "flit_sim"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        records, fam = phase_mesh()
        records["families"] = phase_families(fam)
        records["sequence_parallel"] = phase_sequence_parallel(fam)
        print(card)
        print(json.dumps({"mesh": records}))
        return
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {secs} s (wall {time.perf_counter() - t0:.1f} s)")
    for name, text in _build.BUILD_LOG.items():
        log(f"ptxas [{name}]:\n{text.strip()}")
    flit_ptxas()

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is f32
    torch.backends.cudnn.allow_tf32 = False
    records = phase_kernels()
    trace_records = phase_traces()
    lm_records = phase_lm_kernels()
    lm_records["rglru_scan"] = phase_lru_kernel()
    lm_records["ssd_scan"] = phase_ssd_kernel()
    decode_attn = phase_decode_attention()
    counts = phase_main_path()
    stream = phase_streaming()
    serving = phase_serving()
    serving.update(phase_new_families())
    training = phase_training()
    # the division check keeps the card busy while the mesh phases' ranks,
    # sharing it, stage their collectives through host memory
    dry = phase_dryrun_start()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        division = pool.submit(phase_division)
        mesh, fam = phase_mesh({
            "digest": stream["joint_1e7"]["digest"],
            "wall_s": stream["joint_1e7"]["runs"][2][0]["wall_s"]})
        division.result()
    families = phase_families(fam)
    seq_parallel = phase_sequence_parallel(fam)
    dryrun_rec = phase_dryrun_finish(dry)

    big = records["2^20 cells"]
    #: the main-path run each kernel's launch count is read from
    path_of = {"asymmetric_periodic": "bridge", "symmetric_run": "bridge",
               "symmetric_periodic": "shallow", "pipelining_run": "fig13",
               "pack_flits": "flit_pack"}
    kernels = []
    for name in ("asymmetric_periodic", "symmetric_periodic",
                 "symmetric_run", "pipelining_run", "pack_flits"):
        r = big[name]
        launches = counts[path_of[name]][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"],
                               records["path"][name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "cells": r["cells"],
            "path_cells": records["path"][name]["cells"],
            "path_ms": records["path"][name]["ms"],
            "path_plain_ms": records["path"][name]["plain_ms"],
            "path_bound_ms": records["path"][name]["bound_ms"],
        })
        kernels[-1].update({
            f"{where}{key}": rec[key]
            for where, rec in (("", r), ("path_", records["path"][name]))
            for key in ("back_to_back_ms", "card_ms", "k_exit") if key in rec})
        if "k_exit" in r:           # a run kernel, and its one-chunk kernel
            one = name.replace("_run", "_chunk")
            kernels[-1]["one_chunk"] = {
                "name": one, "ms": big[one]["ms"],
                "card_ms": big[one]["card_ms"],
                "path_ms": records["path"][one]["ms"],
                "path_card_ms": records["path"][one]["card_ms"],
                "bound_ms": big[one]["bound_ms"],
                "path_bound_ms": records["path"][one]["bound_ms"]}
    for name in ("symmetric_trace", "asymmetric_trace"):
        r, path = trace_records["2^20 cells"][name], \
            trace_records["path"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "tpu_kernel": False,
            "launches": counts["serving"]["launches"][name],
            "launches_from": "bridge serving section",
            "max_abs_err": max(rec[name]["max_abs_err"]
                               for rec in trace_records.values()),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "back_to_back_ms", "card_ms", "cells",
                                 "phases", "cycles")},
            "library_ms": None,
            **{f"path_{k}": path[k] for k in (
                "ms", "plain_ms", "bound_ms", "back_to_back_ms", "card_ms",
                "cells", "phases", "cycles")},
            "serving_wall_s": counts["serving"]["wall_s"],
            "serving_plain_wall_s": counts["serving"]["plain_wall_s"],
            "stream_launches": stream["joint_1e7"]["runs"][2][0][
                "launches"][name],
            "stream_dispatches": stream["joint_1e7"]["dispatches"],
            "stream_sharded_launches_per_rank": [
                r["launches"][name]
                for r in mesh["stream_sharded"]["ranks"]],
            "stream_sharded_dispatches_per_rank": [
                r["dispatches"] for r in mesh["stream_sharded"]["ranks"]],
            **{f"stream_chunk_{k}": trace_records["stream chunk"][name][k]
               for k in ("ms", "back_to_back_ms", "card_ms", "plain_ms",
                         "bound_ms", "bound_by", "cells", "cycles")},
        })
    kernels += lm_kernel_records(lm_records, serving)
    chat = decode_attn["chat"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": SOURCES["decode_attention"],
        "replaces": REPLACES["decode_attention"], "tpu_kernel": False,
        "launches": "one call (three kernels) a layer a decode tick",
        "ptxas": decode_attn["ptxas"],
        **{k: chat[k] for k in ("ms", "back_to_back_ms", "card_ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "share_of_bound",
                                "max_abs_err", "shape")},
        "code": {k: decode_attn["code"][k] for k in (
            "ms", "back_to_back_ms", "card_ms", "plain_ms", "library_ms",
            "bound_ms", "share_of_bound", "max_abs_err", "shape")}})
    for rec in kernels:
        if rec["name"] in LM_KERNELS:
            rec["training"] = training_kernel_record(rec["name"], training)
            rec["mesh"] = {
                "launches_per_rank_step": {
                    f"{st['arch']} {st['mesh']}":
                        st["launches_per_rank_step"][rec["name"]]
                    for st in mesh["steps"]},
                "launcher_launches_per_rank_step":
                    mesh["launcher"]["launches_per_step"][rec["name"]],
                "backend": mesh["backend"], "transport": mesh["transport"]}
            rec["mesh_families"] = family_kernel_record(rec["name"],
                                                        families)
            rec["sequence_parallel_launches_per_rank_step"] = {
                f"{st['arch']} {st['mesh']}":
                    st["launches_per_rank_step"][rec["name"]]
                for st in seq_parallel["steps"]}
            rec["dryrun_operator_calls"] = {
                f"{c['arch']} {c['shape']} {c['mesh']}":
                    c["kernel_calls"].get(f"repro_torch::{rec['name']}", 0)
                for c in dryrun_rec["cells"]}
        else:
            rec["dryrun_frontier_launches"] = {
                "joint_frontier": dryrun_rec["joint_launches"].get(
                    rec["name"], 0),
                "serving_frontier": dryrun_rec["serving_launches"].get(
                    rec["name"], 0)}
    log(f"streaming [{card}]: {json.dumps(stream)}")
    log(f"mesh [{card}]: {json.dumps(mesh)}")
    log(f"stream sharded [{card}]: {json.dumps(mesh['stream_sharded'])}")
    log(f"mesh families [{card}]: {json.dumps(families)}")
    log(f"dryrun [{card}]: {json.dumps(dryrun_rec)}")
    log(f"sequence parallel [{card}]: {json.dumps(seq_parallel)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
