#!/usr/bin/env python3
"""Chip smoke: drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

The main path is the paper's program-once / stream-many inference of
the deep sensor app (784→200→100→10, threshold hidden layers) at its
published width, on both systems: ``compile_chip`` (split → pack →
place → route → program) → ``CompiledChip.stream`` → ``chip.serve``.
The memristor system streams through the crossbar kernel
(``csrc/crossbar_mvm.cu``), the digital system through the int8 MAC
kernel (``csrc/int8_matmul.cu``); both are built here from source.

Phases, each of which ends the run with a non-zero exit on failure:
  1. kernel vs plain version on the card, at the deep app's shapes, on
     the test sweep and at the serving batches 1 and 4 (crossbar: both
     modes, f32 and bf16, ragged batches, 16-column tiles; int8: fused
     and raw, signed and unsigned codes, unaligned rows);
  2. stream: 16,384 items through each system's chip, with the kernel
     launch counters showing three launches a call, checked layer by
     layer against the einsum (plain) path on the card;
  3. serve: ``chip.serve(slots=4)`` drains 8 requests whose outputs
     equal the direct stream;
  4. times: CUDA events over many launches after warm-up, for each
     kernel, its plain version and one PyTorch call computing the same
     function, at the pace the host launches them (``ms``, ``plain_ms``,
     ``library_ms``) and queued behind a sleep so that they time the
     card's own work (``device_ms``, ``plain_device_ms``,
     ``library_device_ms``), with the least time the card could take on
     the kernel's route (the bound); the same at the serving batches 4
     and 1; stream items/s of the kernel and einsum paths in
     alternating rounds, with the device's busy time from
     ``torch.profiler``; and engine steps/s, the median of three drains
     after a warm-up drain;
  5. variability: the deep app on the memristor system with a noisy,
     drifting ``NoiseModel`` (write σ, stuck cells, IR drop, drift):
     8 calls of 16,384 items, three crossbar launches each, checked
     layer by layer against the einsum path at ages 0, 16,384 and
     114,688; the drift clock; ``NoiseModel()`` equal to no model on
     both systems; ``reprogram_chip`` with no compile; the canary
     recalibration loop back to accuracy 1.0; and the drifting chip's
     stream times against the ideal chip's;
  6. paper apps: every app's ``compile_app(...).report()`` and RISC
     cost against ``tests/golden/fleet_tables.json`` at 1e-9, and every
     weighted net of the five apps streamed (16,384 items) through the
     kernels on both systems, checked layer by layer;
  7. wide digital: the deep app on the digital system at 12-bit codes,
     streamed (16,384 items) through the raw int8 kernel in byte planes
     (four launches a layer) and equal to the einsum path to the bit;
     the raw kernel against its plain version at the plane shapes; a
     ``serve()`` drain; the raw kernel's times and bound, and the wide
     stream's items/s against the einsum path's;
  8. fleet: the deep app on both systems as ``shard_chip(chip, 4)``,
     four logical chips on the one card: streams of 16,384 and 4,097
     items against the chip's, resize 4→2→4 and reprogram with no
     compile, phase 5's drifting chip as a fleet at three ages against
     the chip, a ``FleetRouter`` draining a sensor-fed ``StreamSource``
     (32 requests of 9 windows) whose outputs match the direct stream,
     and ``fleet.report``; then fleet and chip timed alternately (ms a
     batch, device busy time, kernels a batch) and router steps/s
     beside ``chip.serve(slots=16)`` on the same requests;
  9. ranks: the deep app as a fleet of 2 processes × 2 logical chips
     sharing the card, spawned as fresh interpreters in one gloo group
     (``python -m repro_torch.fleet --distributed-worker``): each
     rank's ``stream_local`` on its 8,192 rows against the chip (bit
     for bit, three launches a call) and the one-process stream (rel
     ≤ 1e-6), the lockstep ``DistributedFleetRouter`` on each rank's
     sensor feed, ``stats_global`` identical on both ranks and equal to
     ``assemble_stats`` of their rows; a lockstep fleet losing rank 1
     and a federated one losing rank 0 mid-serve, the survivor
     absorbing the dead feed with every uid completed once and no
     compile; the cost of one ``any_across_hosts``, a lane batch's
     ``stream_local`` in each rank alone and with both ranks on the
     card, each rank's CUDA memory, and the lockstep router's
     aggregate rate beside one process's ``FleetRouter`` with the same
     lanes and requests.

 10. deploy: the declarative entry point (``repro_torch.deploy``) on
     the deep app: (a) ``deploy()`` of one app on each system equal to
     ``shard_chip(compile_chip(...))`` bit for bit with the chip's
     three launches a batch; (b) a memristor and an 8-bit digital
     tenant on 2 logical chips serving 32 requests of 16 items each off
     two ``StreamSource``s, every routed output against the direct
     stream, the per-app stats rolled up exactly, with (e)
     ``repro_torch.obs`` on: the phase shares of a served step and a
     Chrome trace written under ``build/`` and reloaded; (c) ``tune()``
     on the reference tune selftest's spec (deep and 12-bit ocr at 1e5
     items/s) and ``deploy(tuned.spec)``: deep on memristor 128×64, ocr
     on digital 128×64 through the raw int8 kernel's byte planes (new
     shapes: K = 2500 → 60 → 26), its report equal to the tuner's at
     1e-9, each tenant's 16,384 items checked against the einsum path
     (memristor rel ≤ 1e-5 layer by layer, 12 bits to the bit), and a
     mixed drain; (d) the canary loop on a deployed drifting deep
     tenant, journaled on a heartbeat board, with no compile. Then the
     two-tenant router's steps/s beside one ``FleetRouter`` with the
     same lanes, and each tuned tenant's ms a batch and busy time.
 11. lm: language-model tenants (``repro_torch.lm``) on the published
     qwen1.5-0.5B (24 layers, d 1,024, seeded weights on the card, f32
     glue), on both systems (128×64 and 256×128 tiles): (a)
     ``compile_lm`` programs the 168 block linears and routes nothing;
     (b) a 2 × 32 prefill and a per-slot decode against the dense
     forward on the card, logits and cache within rel ≤ 1e-5, each
     layer's residual stream printed, 168 crossbar launches a forward;
     (c) an ``LMMember`` (4 lanes, a 128-slot ring) serving 6 requests
     of 16 tokens through ``MultiAppRouter``, token for token equal to
     the dense ``Engine``, ``lm.tokens`` equal to the 96 items; (e) the
     tenant's steps/s and tokens/s beside the ``Engine`` (memristor),
     a decode step's and a prefill's wall, busy time and kernels, and
     the crossbar kernel at the LM's shapes (4 and 32 rows; 1024→1024,
     1024→2816, 2816→1024) with its plain version, ``torch.matmul`` on
     the folded weights and the bound; (d) ``deploy()`` of the deep
     sensor app and the ``reduced_serving()`` LM on 2 logical chips,
     tokens equal to the ``Engine``'s, the LM's report row priced.
 12. train: ex-situ training (``repro_torch.optim.qat``,
     ``repro_torch.launch.train``): (a) the deep app QAT-trained on the
     card (8-bit weights and activations, threshold, 300 steps on
     ``mnist_like(seed=0, n=2048)``), compiled on memristor 128×64 and
     digital 256×128, the test set (``mnist_like(seed=1, n=512)``)
     streamed through K1 and K2: predictions equal to the einsum
     path's outside the near-zero band, deployed accuracy within 3
     points of the QAT forward; the same net at 12 bits through K3's
     byte planes, equal to the einsum path to the bit; (b) Fig. 12 at
     full width (bits 32, 8, 6, 4 × sigmoid, threshold, 250 steps
     each; the reference benchmark's rule printed, not gated) and a
     variation-aware net against the clean one on phase 5's noisy
     chip; (c) the full-width qwen1.5-0.5B (12 of its 24 layers:
     ``TRAIN_LAYERS``) trained 6 steps (global
     batch 8 × 128 tokens, 2 microbatches, AdamW, bf16 compute,
     remat "full", checkpoints every 3 steps in a temporary
     directory), the same job stopped after its step-3 checkpoint and
     resumed to 6, equal to the straight run at rel ≤ 1e-6 (with
     deterministic algorithms only if it is not), the loss falling,
     each step's loss and wall, two further steps' busy time and
     kernels, peak memory, each checkpoint save's and restore's
     seconds and bytes; (d) the step-6 checkpoint restored into the
     port's tree and served through ``compile_lm`` (memristor 128×64):
     a 2 × 32 prefill and a decode within rel 1e-5 of the dense f32
     forward, 168 K1 launches a forward, an ``LMMember`` serving 6
     prompts × 16 tokens equal to the dense ``Engine``'s.
 13. families: the Eq. 3 model and the other architectures: (a)
     ``eq3_dot_product``, ``effective_weights`` and ``crossbar_forward``
     on the card against the CPU (rel ≤ 1e-6) on 128×64 and 256×128
     tiles, B = 16,384, wire resistance 0 and 2.5 Ω, the de-gained
     unquantised forward against ``x @ w``, and K1 on one tile's pairs
     (scale = 1/column_gain) against Eq. 3 (rel ≤ 1e-5), with the
     threshold epilogue against Eq. 3's signs; (b) the seven new
     reduced archs (deepseek, granite, gemma2, internvl2, musicgen,
     moonshot, dbrx) against the CPU: loss, gradients, one AdamW step,
     prefill and prefill/decode consistency; (c) gemma2-9b at its
     published width, 8 of 42 layers, through ``compile_lm`` on both
     systems: a 4,160-token prefill (past the 4,096 window) and 8
     greedy decode steps within rel 1e-5 of the dense f32 forward, 56
     K1 launches a forward, tokens equal to the dense ones and an
     ``LMMember``'s equal to the dense ``Engine``'s, each path's
     forward times, and K1 at its five linear shapes at M = 1 and
     4,160 beside ``torch.matmul`` and the bound; (d)
     moonshot-v1-16b-a3b at its published width, 12 of 48 layers: a
     4 × 1,024 prefill at capacity factor 1.25 and its drop share a
     layer, layer 0's sort-based dispatch against a per-token loop
     (nothing dropped, rel ≤ 1e-5), prefill/decode consistency, and
     the dense ``Engine`` serving 6 prompts × 16 tokens on 4 lanes:
     steps/s, a decode step's wall, busy time and kernels, peak CUDA
     memory.
 14. state space: the hybrid (zamba2-1.2b: Mamba2 SSD blocks and one
     shared attention block) and ssm (xlstm-350m: mLSTM and sLSTM)
     families, plain PyTorch as the reference's are plain jnp (no
     kernel launch): (a) both reduced archs against the CPU, as (b) of
     phase 13; (b) zamba2-1.2b at its published width and depth (38
     Mamba2 layers, d 2,048, 64 SSM heads × 64, state 64; the shared
     block's window 4,096; f32, seed 0): layer 0's ``ssd_chunked`` on
     4,160 tokens (16 chunks of 260) against its per-token recurrence
     (rel ≤ 1e-5, outputs and final state), a 4,160-token prefill and
     16 greedy decodes against one 4,176-token prefill (rel < 0.02, the
     greedy picks equal to its argmaxes outside top-two gaps of 1e-5),
     and ``Engine(slots=4, cache_len=128)`` serving 6 prompts of 8–48
     tokens × 16, each request's tokens equal to its own B = 1 greedy
     decode (steps/s, tokens/s, a decode step's wall, busy time and
     kernels, peak memory); (c) xlstm-350m at its published width and
     depth (24 layers = 3 × (7 mLSTM + 1 sLSTM), d 1,024): the same on
     layer 0's ``mlstm_cell_chunked`` at 1,024 tokens, a 4 × 1,024
     prefill and 16 decodes against a 4 × 1,040 prefill, the same
     ``Engine`` drain; (d) both trained through
     ``repro_torch.launch.train`` (global batch 8 × 512 tokens, the
     configs' bf16 compute, remat and
     accumulation, AdamW; 12 of zamba2's 38 layers and 8 of xlstm's
     24): zamba2 2 steps with no checkpoint, xlstm 4 steps
     checkpointed every 2 in a temporary directory, stopped after
     step 2 and resumed, equal to the straight run to the bit; each
     step's loss and wall, a further step's busy time and kernels, peak
     memory, xlstm's checkpoint seconds and bytes.
 15. parallel: the training substrate's parallelism on 2 ranks sharing
     the card (``launch_local_fleet``, one gloo group): (a) the
     full-width qwen1.5-0.5B, 3 steps of global batch 8 × 128 tokens
     (2 microbatches) on ``TokenPipeline(seed=0)``, AdamW eps 1e-4 —
     one process first on the card (f32 compute, then the config's
     bf16), then the ranks as data parallelism with replicated
     parameters (``steps.make_dp_train_step``: each rank its half of
     every microbatch, the f32 gradients all-reduced over gloo on the
     card's tensors; gloo's functional collectives, which DTensor
     issues, crash on CUDA tensors, so phase 17 runs the DTensor step
     over the staged group); each rank's f32 losses and final
     parameters within
     rel 1e-5 of the one process's, its bf16 losses within 1e-3; per
     rank each step's wall and seconds and bytes in collectives, a
     further step's busy time and kernels, peak memory; (b)
     ``compressed_psum`` at qwen's full gradient tree (464 M f32
     elements) between the ranks, different seeded gradients on each,
     5 steps of error feedback: every leaf's mean within scale/2 of the
     plain ``all_reduce`` mean, the summed means within one step's
     bound of the summed plain means; the seconds of each reduction
     and the wire bytes.

 16. launch tools: (a) the dry run (``repro_torch.launch.dryrun`` on
     one position) predicts the full-width qwen1.5-0.5B train step (8 ×
     128 tokens, 2 microbatches, bf16, full remat) and a 4-lane decode
     step (cache 128) — peak bytes, FLOPs, the H100 roofline bound —
     and the steps run on the card: the predicted peak within 10 % of
     ``max_memory_allocated``, the bound no more than the profiler's
     busy time, the useful FLOP share in (0, 1]; (b) the dry-run sweep
     of every reduced arch × shape on the reference's 16×16 and
     2×16×16 meshes (fake groups, the host's cores): each cell ok or
     skipped with ``applicable``'s reason, the committed reduced qwen
     and moonshot ``train_4k`` cells' ``model_flops`` and
     ``cost.bytes_per_device`` reproduced; (c) qwen's 24 blocks as a
     4-stage GPipe pipeline (``launch/pipeline.py``) on 4 ranks sharing
     the card, f32, 8 × 128 tokens in 4 microbatches, every rank
     within rel 1e-5 of one process's sequential forward; its wall,
     bubble and the bytes at each boundary (the collective counter);
     then the pipelined train step of the whole model: every rank holds
     the embedding and final norm replicated and its 6 blocks, embeds
     ``TokenPipeline(seed=0)``'s batch, runs the pipeline forward and
     backward (GPipe's stash, the reverse schedule), computes the loss
     of the replicated output and takes one AdamW step (eps 1e-4,
     clipped by the global norm across the ranks) on what it holds —
     its loss, block gradients, embedding and final-norm gradients and
     updated parameters within rel 1e-5 of one process's sequential
     step; 1,048,576 B a microbatch at each boundary both ways; per
     rank the forward, backward and update walls, the seconds in gloo's
     send/recv/broadcast, the staged bytes and the peak memory, beside
     the one process's step wall and peak.

 17. sharded: qwen1.5-0.5B sharded FSDP × TP on 4 ranks sharing the
     card (``make_debug_mesh(model=2)``: {'data': 2, 'model': 2}; one
     process group whose CUDA collectives go through the staged
     backend — pinned host buffers and gloo — so DTensor runs on the
     card's tensors), f32, held to one process's run of the same jobs
     on the card: (a) serving at full width with the weights resident
     (the decode rules): a prefill of 4 × 128 tokens and 16 greedy
     decode steps into a cache of 256 with its sequence on ``model``,
     every step's logits within rel 1e-5, the tokens equal up to a
     top-2 tie; (b) 3 train steps of global batch 8 × 128 (2
     microbatches), AdamW eps 1e-4: losses and the final parameters
     within rel 1e-5, ``wq`` and ``w2`` sharded on both axes; (c) the
     launcher itself on the 4 ranks (``--model-parallel 2``, a step-2
     checkpoint of ~5.6 GB gathered on every rank and written by rank
     0) at the config's bf16 compute, then resumed from a copy of it on
     a (4, 1) mesh, its step-2 loss within rel 1e-3; (d) the reduced
     MoE, hybrid and ssm configs: a train step and a 4-token decode
     each against one process's.
     Per rank the step walls, the staged bytes and seconds, the peak
     memory, beside one process's.

The ``kernels`` line counts each kernel's launches on the main path
(phases 2–3) and in phases 5–17 (phase 9: what the ranks report; a
killed rank reports nothing; phases 14–17 launch none).

It prints the card's name and power limit first, one JSON line per
measurement, the kernel table as one ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}`` last. Without a CUDA card, or
without the repository's ``src/`` beside it, it exits non-zero and
prints no result. It never falls back to the CPU or to a plain
version.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances (max |diff| / max |plain|), with their reasons
TOL_F32 = 1e-5     # crossbar kernel, f32: sums run in another order
TOL_BF16 = 1e-2    # crossbar kernel, bf16 x: the kernel rounds the combined
#                    tile to bf16 (as the TPU kernel does), the plain
#                    version keeps it f32
TOL_I8 = 1e-6      # fused int8: the same int32 sum and epilogue rounding
BAND = 1e-5        # threshold units may flip only within this × max|pre|

# the bound's rates: the H100 SXM's spec-sheet peaks (dense), from the
# port's roofline (one source); without ``src/`` beside this script
# main() reports it and exits
sys.path.insert(0, os.path.join(ROOT, "src"))
try:
    from repro_torch.launch import roofline as _sheet
except ImportError:
    _sheet = None
HBM_BYTES_PER_S = _sheet and _sheet.HBM_BW
F32_FLOPS = _sheet and _sheet.PEAK_F32      # IEEE f32, CUDA cores (no TF32)
TF32_FLOPS = _sheet and _sheet.PEAK_TF32    # TF32 tensor cores
INT8_OPS = _sheet and _sheet.PEAK_INT8
TF32_PRODUCTS = 3          # the crossbar kernel's f32 route: 3×TF32

DEEP = (784, 200, 100, 10)
STREAM_B = 16384
STREAM_ROUNDS = 5      # × (einsum, kernel, kernel, einsum) stream timings
SERVE_BATCHES = (4, 1)  # kernel times at the engine's batches (slots = 4)
SERVE_DRAINS = 3       # engine drains timed after one warm-up drain
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: covers 20 launches

# phase 5: the deep app on non-ideal devices. The drift rate moves the
# canary's answers past the SLO within one batch of 16,384 items, and
# the output by far more than rel 1e-3 at the oldest checked age.
DRIFT_RATE = 1e-7
NOISE_KW = dict(program_sigma=0.1, stuck_on_frac=0.01, stuck_off_frac=0.01,
                ir_drop_r_seg=1.0, drift_rate=DRIFT_RATE, seed=0)
DRIFT_CALLS = 8                 # streamed calls: ages 0 .. 7 × 16,384
DRIFT_CHECK_CALLS = (0, 1, 7)   # the ages checked against plain
CANARY_ROWS = 256
CANARY_SLO = 0.99
CANARY_STEPS = 4
REPORT_RTOL = 1e-9      # the golden Tables II–VI pins' own tolerance

WIDE_BITS = 12          # phase 7: two byte planes of input and synapses
FLEET_CHIPS = 4         # phase 8: logical chips on the one card
FLEET_RAGGED_B = 4097   # a batch that 4 chips do not divide
FLEET_TOL = 1e-6        # fleet vs chip: K1 runs at another batch size
FLEET_LANES = 4         # router lanes a chip: 16 lanes, as serve(slots=16)
FLEET_REQUESTS = 32     # sensor frames (9 windows of 28×28 each)
RANKS = 2               # phase 9: processes sharing the one card
RANK_CHIPS = 2          # logical chips a rank
RANK_REQUESTS = 32      # sensor frames a rank's feed
RANK_DRAINS = 4         # lockstep drains a rank; the first warms up
DEPLOY_CHIPS = 2        # phase 10: logical chips of a deployment
DEPLOY_LANES = 4        # lanes a chip for each tenant: 8 a tenant, 16 in all
DEPLOY_REQUESTS = 32    # requests a tenant
DEPLOY_ITEMS = 16       # items a request
TUNE_SLO = 1e5          # the reference tune selftest's SLO for both tenants
VAR_LANES = 128         # lanes a chip of the drifting tenant: 256 rows a step
VAR_ITEMS = 160         # items a request of the drifting tenant: 160 steps
LM_PROMPT = 32          # phase 11: prompt tokens of the parity prefill
LM_LANES = 4            # decode lanes of the served LM tenant
LM_CACHE = 128          # its per-lane KV ring
LM_PROMPTS = (8, 16, 24, 32, 40, 48)   # served prompts' lengths
LM_NEW = 16             # tokens generated a served request
LM_TOL = 1e-5           # mapped vs dense on the card: K1 runs 3xTF32
LM_SHAPES = ("wq", "w1", "w2")         # 1024->1024, 1024->2816, 2816->1024
LM_SHAPE_ROWS = (4, 32)                # a decode step's lanes, a prefill's
QAT_TRAIN_N = 2048      # phase 12: mnist_like(seed=0) training images
QAT_TEST_N = 512        # mnist_like(seed=1) test images
QAT_STEPS = 300         # the reference example's QAT run (batch 128, lr 0.05)
QAT_DROP = 0.03         # deployed may lose ≤ 3 points (Fig. 12, threshold)
FIG12_STEPS = 250       # benchmarks/fig12_bitwidth.py's steps
FIG12_BITS = (32, 8, 6, 4)
FIG12_ACTS = ("sigmoid", "threshold")
TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--steps", "6", "--global-batch", "8",
              "--seq-len", "128", "--ckpt-every", "3"]
# the training legs of phases 12 and 14 run the published configs at a
# smaller depth, widths untouched, so that the smoke with phase 17 stays
# inside its 1,200 s (at full depth it ran past 1,250 s on the H100)
TRAIN_LAYERS = 12       # of qwen1.5-0.5B's 24
TRAIN_RESUME_AT = 3     # the interrupted leg stops after its step-3 save
TRAIN_TOL = 1e-6        # resumed vs straight: the reference's own bound
TRAIN_PROFILED = 2      # train steps profiled for busy time and kernels
EQ3_B = 16384           # phase 13(a): inputs through one Eq. 3 tile
EQ3_GEOMS = ((128, 64), (256, 128))
EQ3_R_SEGS = (0.0, 2.5)  # ideal wires, and the reference's 2.5 Ω a segment
EQ3_TOL = 1e-6          # Eq. 3 on the card vs the CPU: another sum order
FAMILY_ARCHS = ("deepseek-7b", "granite-3-8b", "gemma2-9b", "internvl2-26b",
                "musicgen-large", "moonshot-v1-16b-a3b", "dbrx-132b")
GEMMA_LAYERS = 8        # (c): 4 of gemma2-9b's 21 local/global layer pairs
GEMMA_PROMPT = 4160     # past the 4,096-token window
GEMMA_NEW = 8           # greedy decode steps
GEMMA_SHAPES = ("wq", "wk", "wo", "w1", "w2")  # its five linear shapes
MOE_LAYERS = 12         # (d): 12 of moonshot-v1-16b-a3b's 48 layers
MOE_BATCH = (4, 1024)   # the prefill at the published capacity factor
MOE_LOOP_TOKENS = 512   # tokens of the per-token loop check (layer 0)
MOE_PROMPTS = (8, 16, 24, 32, 40, 48)
MOE_NEW = 16
MOE_LANES = 4
MOE_CACHE = 128
STATE_ARCHS = ("zamba2-1.2b", "xlstm-350m")   # phase 14
STATE_CHUNK = 256       # the reference's scan chunk
STATE_TOL = 1e-5        # a chunked scan against its per-token recurrence
STATE_TIE = 1e-5        # the least top-two logit gap within which greedy
#                         may flip (see _state_consistency)
HYBRID_SCAN = 4160      # (b) zamba2's scan check: 16 chunks of 260
HYBRID_BATCH = (1, 4160)    # a prompt past the shared block's 4,096 window
SSM_SCAN = 1024         # (c) xlstm's: 4 chunks of 256
SSM_BATCH = (4, 1024)
STATE_NEW = 16          # greedy decodes; the long prefill adds as many
STATE_PROMPTS = (8, 16, 24, 32, 40, 48)
STATE_LANES = 4
STATE_CACHE = 128
HYBRID_TRAIN_ARGS = ["--arch", "zamba2-1.2b", "--steps", "2",
                     "--global-batch", "8", "--seq-len", "512",
                     "--ckpt-every", "0"]   # a checkpoint would be ~14 GB
HYBRID_TRAIN_LAYERS = 12    # of zamba2-1.2b's 38: two shared-block calls
SSM_TRAIN_ARGS = ["--arch", "xlstm-350m", "--steps", "4", "--global-batch",
                  "8", "--seq-len", "512", "--ckpt-every", "2"]
SSM_TRAIN_LAYERS = 8    # of xlstm-350m's 24: one group, 7 mLSTM + 1 sLSTM
SSM_RESUME_AT = 2       # the interrupted leg stops after its step-2 save
PAR_RANKS = 2           # phase 15: ranks sharing the one card
PAR_SPEC = {"arch": "qwen1.5-0.5b", "reduced": False, "global_batch": 8,
            "seq_len": 128, "steps": 3, "psum_steps": 5}
PAR_LR = 3e-4           # the launcher's default peak lr (cosine, warm-up 1)
PAR_EPS = 1e-4          # AdamW eps of the parity runs (ROADMAP "Parity traps")
PAR_TOL = 1e-5          # f32 losses and parameters, 2 ranks vs one process
PAR_BF16_TOL = 1e-3     # bf16 losses: the halves of a microbatch round
#                         their products (8-bit mantissas) otherwise;
#                         8.4e-5 measured on the H100 at 700 W
PAR_TIMEOUT_S = 900.0   # the supervisor's deadline for a launch of ranks
PAR_GROUP_TIMEOUT_S = 600.0   # a rank's wait in a collective
LAUNCH_SPEC = {"arch": "qwen1.5-0.5b", "reduced": False, "global_batch": 8,
               "seq_len": 128, "decode_lanes": 4, "decode_cache": 128,
               "sweep_archs": None, "sweep_shapes": "all",
               "sweep_meshes": ("single", "multi"),
               "pipe_stages": 4, "pipe_microbatches": 4, "pipe_layers": None}
LAUNCH_PEAK_TOL = 0.10  # phase 16(a): predicted vs measured peak
LAUNCH_SWEEP_TIMEOUT_S = 900.0   # (b): one dry-run process's deadline
PIPE_TOL = 1e-5         # (c): the pipeline vs one process (forward, step)
PIPE_SEED = 16
PIPE_TIMEOUT_S = 600.0
SHARD_RANKS = 4         # phase 17: ranks sharing the card
SHARD_MODEL = 2         # make_debug_mesh(model=2): {'data': 2, 'model': 2}
SHARD_SPEC = {"arch": "qwen1.5-0.5b", "reduced": False, "prompts": 4,
              "prompt_len": 128, "new_tokens": 16, "cache_len": 256,
              "global_batch": 8, "seq_len": 128, "steps": 3,
              "ckpt_every": 2,
              "launcher_args": ["--arch", "qwen1.5-0.5b", "--steps", "3",
                                "--global-batch", "8", "--seq-len", "128"],
              "families": ["moonshot-v1-16b-a3b", "zamba2-1.2b",
                           "xlstm-350m"],
              "family_seq_len": 16, "family_new_tokens": 4,
              "family_cache_len": 32}
SHARD_TOL = 1e-5        # f32 logits, losses and the parameter tree
# (c) runs the launcher at the config's bf16, where the (2, 2) and (4, 1)
# meshes round their partial products apart: PAR_BF16_TOL, phase 15's
# bound for bf16 losses
SHARD_LAUNCHER_TOL = PAR_BF16_TOL
SHARD_TIMEOUT_S = 900.0
# the two-axis placements of phase 17(b) (tests/test_torch_sharding.py's)
SHARD_PLACEMENTS = {"['stack']['attn']['wq']": "(Shard(dim=1), Shard(dim=2))",
                    "['stack']['mlp']['w2']": "(Shard(dim=2), Shard(dim=1))"}


class SmokeFailure(Exception):
    pass


def _rel(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------- #
# phase 1: kernels vs plain versions
# --------------------------------------------------------------------- #
def _cb_operands(torch, gen, dev, B, R, C, rows, cols):
    x = torch.rand((B, R, rows), generator=gen, device=dev) * 2 - 1
    gp = 8e-9 + torch.rand((R, C, rows, cols), generator=gen,
                           device=dev) * 8e-6
    gn = 8e-9 + torch.rand((R, C, rows, cols), generator=gen,
                           device=dev) * 8e-6
    sc = (0.2 + 2.8 * torch.rand((R, C, cols), generator=gen, device=dev)
          ) / (gp + gn).sum(2)
    bias = torch.randn(C * cols, generator=gen, device=dev) * 0.1
    return x, gp, gn, sc, bias


def phase_kernels(torch, ops, ref, dev) -> int:
    gen = torch.Generator(device=dev).manual_seed(0)
    deep = [(STREAM_B, 7, 4, 128, 64), (STREAM_B, 2, 2, 128, 64),
            (STREAM_B, 1, 1, 128, 64)]
    # the test sweep, the serving batches (1, 4) at the deep app's first
    # layer, and 16-column tiles several of which share a block tile
    sweep = [(1, 1, 1, 128, 64), (8, 1, 1, 128, 128), (200, 3, 2, 128, 64),
             (128, 2, 3, 64, 32), (5, 4, 1, 32, 16), (STREAM_B - 1, 7, 4,
                                                       128, 64),
             (1, 7, 4, 128, 64), (4, 7, 4, 128, 64), (37, 2, 5, 32, 16)]
    checks = 0
    worst = {"crossbar_f32": 0.0, "crossbar_bf16": 0.0, "int8_fused": 0.0}
    for shape in deep + sweep:
        x, gp, gn, sc, bias = _cb_operands(torch, gen, dev, *shape)
        acts = ("linear", "threshold", "sigmoid", "relu", "tanh") \
            if shape in sweep else ("linear",)
        for act in acts:
            out = ops.crossbar_mvm(x, gp, gn, sc, bias, activation=act)
            plain = ref.crossbar_mvm_ref(x, gp, gn, sc, bias, activation=act)
            if act == "threshold":
                # ±1 rails: a flip is allowed only in the near-zero band
                pre = ref.crossbar_mvm_ref(x, gp, gn, sc, bias)
                near = pre.abs() <= BAND * pre.abs().max()
                _require(bool(((out != plain) & ~near).sum() == 0),
                         f"crossbar threshold {shape}")
            else:
                e = _rel(out, plain)
                worst["crossbar_f32"] = max(worst["crossbar_f32"], e)
                _require(e <= TOL_F32, f"crossbar {act} {shape}: rel {e:.3g}")
            checks += 1
        out = ops.crossbar_mvm(x, gp, gn, sc, partials=True)
        e = _rel(out, ref.crossbar_mvm_partials_ref(x, gp, gn, sc))
        worst["crossbar_f32"] = max(worst["crossbar_f32"], e)
        _require(e <= TOL_F32, f"crossbar partials {shape}: rel {e:.3g}")
        xb = x.to(torch.bfloat16)
        for partials in (False, True):
            if partials:
                out = ops.crossbar_mvm(xb, gp, gn, sc, partials=True)
                plain = ref.crossbar_mvm_partials_ref(xb, gp, gn, sc)
            else:
                out = ops.crossbar_mvm(xb, gp, gn, sc, bias)
                plain = ref.crossbar_mvm_ref(xb, gp, gn, sc, bias)
            e = _rel(out, plain)
            worst["crossbar_bf16"] = max(worst["crossbar_bf16"], e)
            _require(e <= TOL_BF16, f"crossbar bf16 {shape}: rel {e:.3g}")
        checks += 3
    for B in (STREAM_B, 37, 4, 1):
        for K, N in ((784, 200), (200, 100), (100, 10)):
            w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            s = torch.rand(N, generator=gen, device=dev) * 1e-2
            o = torch.randn(N, generator=gen, device=dev)
            for dtype, lo, hi in ((torch.uint8, 0, 256),
                                  (torch.int8, -128, 128)):
                x = torch.randint(lo, hi, (B, K), generator=gen, device=dev,
                                  dtype=dtype)
                _require(torch.equal(ops.int8_matmul(x, w),
                                     ref.int8_matmul_ref(x, w)),
                         f"int8 raw {B, K, N, dtype} not exact")
                for act in ("linear", "threshold", "sigmoid", "tanh"):
                    e = _rel(ops.int8_matmul(x, w, s, o, activation=act),
                             ref.int8_matmul_fused_ref(x, w, s, o,
                                                       activation=act))
                    worst["int8_fused"] = max(worst["int8_fused"], e)
                    _require(e <= TOL_I8, f"int8 fused {act} {B, K, N}: "
                                          f"rel {e:.3g}")
                checks += 5
    torch.cuda.synchronize()
    _line({"phase": "kernels_vs_plain", "checks": checks,
           "worst_rel": worst, "tol": {"crossbar_f32": TOL_F32,
                                       "crossbar_bf16": TOL_BF16,
                                       "int8_fused": TOL_I8,
                                       "int8_raw": "exact"}})
    return checks


# --------------------------------------------------------------------- #
# phases 2-3: the main path
# --------------------------------------------------------------------- #
def _layerwise_check(torch, tcompile, tq, chip, x, system, age=None):
    """Each layer's kernel pre-activation vs the einsum path's on the
    same input (the einsum path's previous activations), at drift
    ``age`` (an f32 scalar tensor) where the chip drifts; threshold
    units may differ only in the near-zero band. Returns the number of
    such flips and a mask of the rows with none: on those rows the two
    end-to-end streams see identical activations at every layer."""
    h = x
    flips = 0
    clear = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for i, layer in enumerate(chip.plan):
        lin = dataclasses.replace(layer, activation="linear")
        pre_k = tcompile._apply_stream_layer(lin, h, True, age)
        pre_p = tcompile._apply_stream_layer(lin, h, False, age)
        e = _rel(pre_k, pre_p)
        _require(e <= TOL_F32, f"{system} layer {i} pre-activation rel "
                               f"{e:.3g}")
        act = tq.make_activation(layer.activation)
        if layer.activation == "threshold":
            near = pre_p.abs() <= BAND * pre_p.abs().max()
            differ = act(pre_k) != act(pre_p)
            _require(not bool((differ & ~near).any()),
                     f"{system} layer {i}: a threshold unit outside the "
                     f"near-zero band took the other rail")
            flips += int(differ.sum())
            clear &= ~differ.any(dim=1)
        h = act(pre_p)
    return flips, clear


def phase_main_path(torch, ops, tcompile, tq, tcl, chip_mod, dev, name):
    """compile → stream 16,384 items → serve 8 requests, on both
    systems, with every launch counter reset just before and read just
    after."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    rng_items = torch.Generator().manual_seed(2)
    items = [torch.rand((3 + i % 4, DEEP[0]), generator=rng_items).numpy()
             for i in range(8)]
    chips, outs, steps, per_call = {}, {}, {}, {}

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for system in ("memristor", "digital"):
        params = tcl.mlp_init(spec,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
        chip = chip_mod.compile_chip(spec, params=params, system=system,
                                     device=dev)
        before = ops.launch_counts()
        outs[system] = chip.stream(x)
        after = ops.launch_counts()
        per_call[system] = {k: after[k] - before[k] for k in after}
        eng = chip.serve(slots=4)
        for uid, it in enumerate(items):
            eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
        done = eng.run_until_drained()
        _require(len(done) == 8, f"{system}: served {len(done)} of 8")
        steps[system] = (eng, done)
        chips[system] = chip
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    _line({"phase": "main_path", "launches": launches,
           "launches_per_stream_call": per_call,
           "engine_steps": {s: steps[s][0].steps for s in steps},
           "seconds": main_s})

    # every kernel of the path went through, 3 launches per call
    _require(per_call["memristor"]["crossbar_mvm"] == 3,
             f"memristor stream launches {per_call['memristor']}")
    _require(per_call["digital"]["int8_matmul_fused"] == 3,
             f"digital stream launches {per_call['digital']}")
    _require(launches["crossbar_mvm"] ==
             3 * (1 + steps["memristor"][0].steps),
             f"crossbar launches {launches['crossbar_mvm']}")
    _require(launches["int8_matmul_fused"] ==
             3 * (1 + steps["digital"][0].steps),
             f"int8 launches {launches['int8_matmul_fused']}")

    for system, chip in chips.items():
        out = outs[system]
        _require(tuple(out.shape) == (STREAM_B, DEEP[-1]),
                 f"{system} stream shape {tuple(out.shape)}")
        _require(bool(torch.isfinite(out).all()), f"{system}: non-finite")
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        system)
        plain = chip.stream(x, use_kernel=False)
        e = _rel(out[clear], plain[clear])
        _require(e <= TOL_F32, f"{system} stream vs plain rel {e:.3g}")
        eng, done = steps[system]
        served_diff = max(
            float((torch.from_numpy(st.result) -
                   chip.stream(torch.from_numpy(st.request.items).to(dev))
                   .cpu()).abs().max())
            for st in done)
        # the reference selftest's bound: lanes batch differently
        _require(served_diff <= 1e-5, f"{system}: served outputs differ "
                                      f"from the direct stream by "
                                      f"{served_diff:.3g}")
        _line({"phase": "stream_and_serve", "system": system,
               "items": STREAM_B, "stream_vs_plain_rel": e,
               "threshold_flips_in_band": flips,
               "rows_compared": int(clear.sum()),
               "served_requests": len(done), "engine_steps": eng.steps,
               "items_emitted": eng.items_emitted,
               "served_max_abs_diff_vs_direct_stream": served_diff,
               "card": name})
    return chips, launches


# --------------------------------------------------------------------- #
# phase 4: times
# --------------------------------------------------------------------- #
def _time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean ms a call, CUDA events around ``iters`` calls after
    ``warmup``, at the pace the host launches them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean ms a call of the card's own work: the calls are queued behind
    a sleep on the stream, so the events see them back to back whatever
    the host's launch overhead. The sleep must outlast the queueing; if
    it ran out first, the measurement is taken again with a longer one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        starved = start.query()
        torch.cuda.synchronize()
        if not starved:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SmokeFailure("device timing: the host could not queue the calls "
                       "within the sleep")


def _quartiles(values):
    v = sorted(values)
    n = len(v)
    return v[n // 2], v[n // 4], v[(3 * n) // 4]


def _device_busy(torch, chip, x, use_kernel: bool, wall_ms: float) -> dict:
    """Device time of one streamed batch, summed over the CUDA kernels
    a profiler sees in 5 batches, beside the batch's wall time (CUDA
    events, without the profiler): the device's idle share, and the
    kernels that take the time."""
    return _busy(torch, lambda: chip.stream(x, use_kernel=use_kernel),
                 wall_ms)


def _busy(torch, fn, wall_ms: float, n: int = 5) -> dict:
    """``_device_busy`` of any call ``fn``, over ``n`` calls. The
    profiler records the card's activity only, and its raw events are
    summed by name: a train step of 400 k kernels then costs seconds to
    read, where ``key_averages`` over CPU and CUDA events took 260 s
    (PR 22)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ns, count = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns[e.name()] = ns.get(e.name(), 0) + e.duration_ns()
            count += 1
    busy_ms = sum(ns.values()) / n / 1e6
    if busy_ms <= 0:
        return {"device_busy_ms": "not measured",
                "device_idle_share": "not measured"}
    top = sorted(ns, key=lambda k: -ns[k])[:5]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_batch": count / n,
            "top_kernels_ms": {k[:60]: ns[k] / n / 1e6 for k in top}}


def _bound(nbytes: float, ops_: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / rate * 1e3
    return t_bytes, t_ops


# a kernel row's times: (key, timer, which callable)
TIME_KEYS = (("ms", "_time_ms", 0), ("plain_ms", "_time_ms", 1),
             ("library_ms", "_time_ms", 2), ("device_ms", "_device_ms", 0),
             ("plain_device_ms", "_device_ms", 1),
             ("library_device_ms", "_device_ms", 2))


def _times(torch, kernel, plain, library, iters=None) -> dict:
    """A kernel row's times of the kernel, its plain version and the
    library call: at the host's launch pace (``_time_ms``: ``ms``,
    ``plain_ms``, ``library_ms``, which include the Python wrapper's
    overhead where it is the longer) and the card's own time
    (``_device_ms``: the same keys with ``device_``)."""
    fns = (kernel, plain, library)
    timers = {"_time_ms": _time_ms, "_device_ms": _device_ms}
    kw = {} if iters is None else {"iters": iters}
    return {key: timers[timer](torch, fns[i], **kw)
            for key, timer, i in TIME_KEYS}


def _kernel_row(name, source, replaces, launches, layers):
    """Sum per-layer numbers into one row: the times of one streamed
    batch (one launch per layer)."""
    t_bytes = sum(r["bytes_ms"] for r in layers)
    t_ops = sum(r["ops_ms"] for r in layers)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in layers),
           "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in layers),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           **{key: sum(r[key] for r in layers) for key, _, _ in TIME_KEYS}}
    if "ops_ms_f32_cuda_cores" in layers[0]:
        row["bound_ms_f32_cuda_cores"] = sum(
            max(r["bytes_ms"], r["ops_ms_f32_cuda_cores"]) for r in layers)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
    return row


def phase_times(torch, ops, ref, tcompile, tcl, chip_mod, chips, launches,
                dev, name):
    rows_cb, rows_i8, rows_raw, rows_serve = [], [], [], []
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(3)).to(dev)

    # crossbar kernel, partials mode, on the memristor chip's own tiles
    # and each layer's own input
    h = x
    for i, layer in enumerate(chips["memristor"].plan):
        p = layer.tiles
        R, C, rows, cols = p.gp.shape
        xt = tcl.tile_inputs(p, h)
        w_fold = tcl.folded_weights(p, torch.float32).permute(
            0, 2, 1, 3).reshape(R, rows, C * cols).contiguous()
        xr = xt.transpose(0, 1)
        out = ops.crossbar_mvm(xt, p.gp, p.gn, p.scale, partials=True)
        plain = ref.crossbar_mvm_partials_ref(xt, p.gp, p.gn, p.scale)
        e = _rel(out, plain)
        _require(e <= TOL_F32, f"crossbar layer {i} (chip operands): rel "
                               f"{e:.3g}")
        nbytes = 4 * (xt.numel() + 2 * p.gp.numel() + p.scale.numel() +
                      out.numel())
        flops = 2 * STREAM_B * R * rows * C * cols
        # the route the kernel takes (3×TF32 on the tensor cores), and
        # the IEEE f32 CUDA-core bound the first kernel was held to
        t_bytes, t_ops = _bound(nbytes, TF32_PRODUCTS * flops, TF32_FLOPS)
        t_ops_f32 = _bound(nbytes, flops, F32_FLOPS)[1]
        rows_cb.append({
            "kernel": "crossbar_mvm", "layer": i,
            "shape": [STREAM_B, R, C, rows, cols], "mode": "partials",
            "max_abs_err": float((out - plain).abs().max()),
            **_times(torch,
                     lambda: ops.crossbar_mvm(xt, p.gp, p.gn, p.scale,
                                              partials=True),
                     lambda: ref.crossbar_mvm_partials_ref(
                         xt, p.gp, p.gn, p.scale),
                     lambda: torch.matmul(xr, w_fold)),
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "ops_ms_f32_cuda_cores": t_ops_f32})
        for b in SERVE_BATCHES:
            xs = xt[:b]
            rows_serve.append({
                "kernel": "crossbar_mvm", "layer": i, "batch": b,
                **_times(torch,
                         lambda: ops.crossbar_mvm(xs, p.gp, p.gn, p.scale,
                                                  partials=True),
                         lambda: ref.crossbar_mvm_partials_ref(
                             xs, p.gp, p.gn, p.scale),
                         lambda: torch.matmul(xs.transpose(0, 1), w_fold))})
        h = tcompile._apply_stream_layer(layer, h, False)

    # int8 kernel, fused, on the digital chip's own synapses and codes;
    # then on the layer's f32 inputs with the DAC in the kernel's load
    rows_dac = []
    h = x
    for i, layer in enumerate(chips["digital"].plan):
        p = layer.tiles
        xq = tcl.quantize_inputs(p, h).to(torch.uint8)
        offset = p.offset + layer.bias
        K, N = p.wq.shape
        out = ops.int8_matmul(xq, p.wq, p.scale, offset)
        plain = ref.int8_matmul_fused_ref(xq, p.wq, p.scale, offset)
        e = _rel(out, plain)
        _require(e <= TOL_I8, f"int8 layer {i} (chip operands): rel {e:.3g}")
        dac = tcl.dac_of(p)
        _require(torch.equal(ops.int8_matmul(h, p.wq, p.scale, offset,
                                             dac=dac), out),
                 f"int8 layer {i}: the kernel's DAC differs from the chain")
        t_bytes, t_ops = _bound(4 * h.numel() + p.wq.numel() + 8 * N +
                                4 * out.numel(), 2 * STREAM_B * K * N,
                                INT8_OPS)
        rows_dac.append({
            "kernel": "int8_matmul_fused", "mode": "f32 x, DAC in the load",
            "layer": i, "shape": [STREAM_B, K, N],
            "max_abs_err": float((out - ref.int8_matmul_dac_ref(
                h, p.wq, p.scale, offset, dac)).abs().max()),
            **_times(torch,
                     lambda: ops.int8_matmul(h, p.wq, p.scale, offset,
                                             dac=dac),
                     lambda: ref.int8_matmul_dac_ref(h, p.wq, p.scale,
                                                     offset, dac),
                     lambda: torch.addcmul(
                         offset, tcl.quantize_inputs(p, h) @ p.wq.float(),
                         p.scale)),
            "bytes_ms": t_bytes, "ops_ms": t_ops})
        nbytes = xq.numel() + p.wq.numel() + 8 * N + 4 * out.numel()
        t_bytes, t_ops = _bound(nbytes, 2 * STREAM_B * K * N, INT8_OPS)
        wf = p.wq.float()

        def lib_fused():
            return torch.addcmul(offset, xq.float() @ wf, p.scale)

        rows_i8.append({
            "kernel": "int8_matmul_fused", "layer": i,
            "shape": [STREAM_B, K, N],
            "max_abs_err": float((out - plain).abs().max()),
            **_times(torch,
                     lambda: ops.int8_matmul(xq, p.wq, p.scale, offset),
                     lambda: ref.int8_matmul_fused_ref(xq, p.wq, p.scale,
                                                       offset),
                     lib_fused),
            "bytes_ms": t_bytes, "ops_ms": t_ops})
        for b in SERVE_BATCHES:
            xs = xq[:b]
            rows_serve.append({
                "kernel": "int8_matmul_fused", "layer": i, "batch": b,
                **_times(torch,
                         lambda: ops.int8_matmul(xs, p.wq, p.scale, offset),
                         lambda: ref.int8_matmul_fused_ref(
                             xs, p.wq, p.scale, offset),
                         lambda: torch.addcmul(offset, xs.float() @ wf,
                                               p.scale))})
        raw = ops.int8_matmul(xq, p.wq)
        _require(torch.equal(raw, ref.int8_matmul_ref(xq, p.wq)),
                 f"int8 raw layer {i} (chip operands) not exact")
        nbytes_raw = xq.numel() + p.wq.numel() + 4 * raw.numel()
        rb, ro = _bound(nbytes_raw, 2 * STREAM_B * K * N, INT8_OPS)
        rows_raw.append({
            "kernel": "int8_matmul_raw", "layer": i,
            "shape": [STREAM_B, K, N],
            "max_abs_err": float((raw - ref.int8_matmul_ref(xq, p.wq))
                                 .abs().max()),
            **_times(torch, lambda: ops.int8_matmul(xq, p.wq),
                     lambda: ref.int8_matmul_ref(xq, p.wq),
                     lambda: xq.float() @ wf),
            "bytes_ms": rb, "ops_ms": ro})
        h = tcompile._apply_stream_layer(layer, h, False)
    for r in rows_cb + rows_i8 + rows_dac + rows_raw + rows_serve:
        r["card"] = name
        _line(r)
    # the serving batches: each kernel's times summed over the 3 layers,
    # the launches of one engine step
    serve = {}
    for r in rows_serve:
        sums = serve.setdefault(r["kernel"], {}).setdefault(
            str(r["batch"]), {key: 0.0 for key, _, _ in TIME_KEYS})
        for key in sums:
            sums[key] += r[key]
    _line({"serving_batch_kernel_ms": serve, "card": name})

    kernels = [
        _kernel_row("crossbar_mvm", "src/repro_torch/kernels/csrc/"
                    "crossbar_mvm.cu", "src/repro/kernels/crossbar_mvm.py:54",
                    launches["crossbar_mvm"], rows_cb),
        _kernel_row("int8_matmul_fused", "src/repro_torch/kernels/csrc/"
                    "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:48",
                    launches["int8_matmul_fused"], rows_i8),
    ]
    # the same kernel on f32 inputs (the stream's mode): its own line, so
    # the launches stay counted once
    _line({"kernel_mode": "f32 x, DAC in the load", "card": name,
           **_kernel_row("int8_matmul_fused", "src/repro_torch/kernels/"
                         "csrc/int8_matmul.cu",
                         "src/repro/kernels/int8_matmul.py:48",
                         launches["int8_matmul_fused"], rows_dac)})

    # end to end: stream items/s at B = 16,384, in alternating rounds
    # (einsum, kernel, kernel, einsum) so the two paths share the card's
    # state; then where the time goes (profiler); then engine steps/s
    for system, chip in chips.items():
        times = {True: [], False: []}
        for _ in range(STREAM_ROUNDS):
            for use_kernel in (False, True, True, False):
                times[use_kernel].append(_time_ms(
                    torch, lambda: chip.stream(x, use_kernel=use_kernel),
                    iters=10))
        for use_kernel, ms in times.items():
            med, q1, q3 = _quartiles(ms)
            _line({"metric": "stream_items_per_s", "system": system,
                   "use_kernel": use_kernel, "batch": STREAM_B,
                   "ms_per_batch_median": med, "ms_per_batch_q1": q1,
                   "ms_per_batch_q3": q3, "runs": len(ms),
                   "items_per_s": STREAM_B / med * 1e3,
                   **_device_busy(torch, chip, x, use_kernel, med),
                   "card": name})
        rates = []
        for _ in range(1 + SERVE_DRAINS):   # the first drain warms up
            eng = chip.serve(slots=4)
            gen = torch.Generator().manual_seed(4)
            for uid in range(32):
                eng.submit(chip_mod.ChipRequest(
                    uid=uid, items=torch.rand((16, DEEP[0]),
                                              generator=gen).numpy()))
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            rates.append(eng.steps / (time.perf_counter() - t0))
        _line({"metric": "engine_steps_per_s", "system": system,
               "slots": 4, "steps": eng.steps, "drains": rates[1:],
               "warm_up_drain": rates[0],
               "steps_per_s": _quartiles(rates[1:])[0], "card": name})
    return kernels


# --------------------------------------------------------------------- #
# phase 5: non-ideal devices
# --------------------------------------------------------------------- #
class StandInDeployment:
    """What the recalibrator drives: one app on one chip, reprogrammed
    in place through ``reprogram_chip`` (zero compile passes)."""

    def __init__(self, chip_mod, chip, params):
        self._reprogram = chip_mod.reprogram_chip
        self.chip = chip
        self._params = params

    def params(self, app):
        return self._params

    def reprogram(self, app, params):
        self.chip = self._reprogram(self.chip, params)


def _deltas(after, before):
    return {k: after[k] - before[k] for k in after}


def _on_path(ops, path):
    """A caller that counts the launches of one path call into ``path``
    and returns (result, that call's launches)."""
    def call(fn, *args, **kw):
        before = ops.launch_counts()
        out = fn(*args, **kw)
        per = _deltas(ops.launch_counts(), before)
        for k, v in per.items():
            path[k] += v
        return out, per
    return call


def phase_variability(torch, ops, tcompile, tq, tcl, chip_mod, var, dev,
                      card):
    """The deep app on non-ideal memristor devices: a noisy, drifting
    chip streamed at ages 0 .. (DRIFT_CALLS - 1) × 16,384 through the
    crossbar kernel, the ideal model's identity, reprogram and the
    canary recalibration loop. Launch counters reset just before and
    read just after; the kernel-vs-plain checks come after the read."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(5)).to(dev)
    canary = torch.rand((CANARY_ROWS, DEEP[0]),
                        generator=torch.Generator().manual_seed(6)).numpy()
    noise = var.NoiseModel(**NOISE_KW)
    drift_only = var.NoiseModel(drift_rate=DRIFT_RATE, seed=0)

    ops.reset_launch_counts()
    chip = chip_mod.compile_chip(spec, params=params, noise=noise,
                                 device=dev)
    outs, per_call = {}, []
    for call in range(DRIFT_CALLS):
        age = chip.items_streamed
        _require(age == call * STREAM_B, f"drift clock {age} at call {call}")
        before = ops.launch_counts()
        out = chip.stream(x)
        per_call.append(_deltas(ops.launch_counts(), before)["crossbar_mvm"])
        if call in DRIFT_CHECK_CALLS:
            outs[age] = out
    probe_age = chip.items_streamed
    chip.stream(x, advance_age=False)
    _require(chip.items_streamed == probe_age == DRIFT_CALLS * STREAM_B,
             f"a probe moved the clock: {chip.items_streamed}")
    # the ideal model is the same code path as no model, on both systems
    identical = {}
    for system in ("memristor", "digital"):
        a = chip_mod.compile_chip(spec, params=params, system=system,
                                  device=dev)
        b = chip_mod.compile_chip(spec, params=params, system=system,
                                  noise=var.NoiseModel(), device=dev)
        identical[system] = bool(torch.equal(a.stream(x), b.stream(x))) \
            and all(layer.drift is None for layer in b.plan)
    # reprogram: no compile, the clock back to 0, and on a drift-only
    # model the re-flashed chip streams the age-0 output again
    ro = chip_mod.compile_chip(spec, params=params, noise=drift_only,
                               device=dev)
    fresh = ro.stream(x, advance_age=False)
    for _ in range(3):
        ro.stream(x)
    aged = ro.stream(x, advance_age=False)
    c0 = chip_mod.compile_count()
    re_noisy = chip_mod.reprogram_chip(chip, params)
    re_drift = chip_mod.reprogram_chip(ro, params)
    reprogram_delta = chip_mod.compile_count() - c0
    restored = re_drift.stream(x, advance_age=False)
    # the canary loop over a stand-in deployment of the drift-only chip
    # (write noise re-rolls at a reprogram, so only a drift-only chip
    # can come back to its attach-time answers exactly)
    dep = StandInDeployment(chip_mod,
                            chip_mod.compile_chip(spec, params=params,
                                                  noise=drift_only,
                                                  device=dev), params)
    monitor = var.AccuracyMonitor(lambda: dep.chip, canary, name="deep")
    recal = var.Recalibrator(dep, "deep", monitor,
                             var.RecalPolicy(slo=CANARY_SLO))
    c1 = chip_mod.compile_count()
    monitor.score()
    for _ in range(CANARY_STEPS):
        dep.chip.stream(x)
        monitor.on_step(None)
        recal.on_step(None)
    canary_delta = chip_mod.compile_count() - c1
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    _require(per_call == [3] * DRIFT_CALLS,
             f"drifting stream launches per call {per_call}")
    _require(all(identical.values()), f"NoiseModel() differs from no model "
                                      f"{identical}")
    _require(reprogram_delta == 0 and re_noisy.items_streamed == 0 and
             re_drift.items_streamed == 0,
             f"reprogram: compile delta {reprogram_delta}")
    _require(not torch.equal(aged, fresh), "drift did not move the output")
    _require(bool(torch.equal(restored, fresh)),
             "the reprogrammed drift-only chip differs from its age-0 output")
    accs = monitor.series()["accuracy"]
    _require(bool(recal.events), f"the canary never breached: {accs}")
    _require(min(accs) < CANARY_SLO and canary_delta == 0 and
             all(e.accuracy_after == 1.0 and e.compile_delta == 0
                 for e in recal.events),
             f"canary loop: {accs}, compile delta {canary_delta}")

    # kernel vs plain, layer by layer, at each checked age
    checks = []
    ages = sorted(outs)
    for age in ages:
        age_t = torch.full((), float(age), dtype=torch.float32, device=dev)
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        "memristor (drifting)", age_t)
        plain = tcompile.stream_pipeline(chip.plan, x, use_kernel=False,
                                         age=age_t)
        e = _rel(outs[age][clear], plain[clear])
        _require(e <= TOL_F32, f"drifting stream at age {age}: rel {e:.3g}")
        _require(bool(torch.isfinite(outs[age]).all()), f"non-finite at "
                                                        f"age {age}")
        checks.append({"age": age, "stream_vs_plain_rel": e,
                       "threshold_flips_in_band": flips,
                       "rows_compared": int(clear.sum())})
    moved = _rel(outs[ages[-1]], outs[ages[0]])
    _require(moved > 1e-3, f"drift moved the output by only rel {moved:.3g} "
                           f"at age {ages[-1]}")
    _line({"phase": "variability", "noise": NOISE_KW,
           "launches_per_stream_call": per_call, "launches": launches,
           "checks": checks, "tol": TOL_F32,
           "output_moved_rel_oldest_vs_age0": moved,
           "noise_model_ideal_equal_to_none": identical,
           "reprogram_compile_delta": reprogram_delta,
           "drift_only_reprogram_restores_age0": True,
           "canary": {"rows": CANARY_ROWS, "slo": CANARY_SLO,
                      "drift_rate": DRIFT_RATE, "series": monitor.series(),
                      "recals": len(recal.events),
                      "accuracy_after": [e.accuracy_after
                                         for e in recal.events],
                      "compile_delta": canary_delta},
           "card": card})
    return chip, x, launches


def phase_variability_times(torch, chip_mod, tcl, drifting, x, dev, card):
    """The drifting chip's stream against the ideal chip's on the kernel
    path, in alternating rounds (ideal, drifting, drifting, ideal), and
    both chips' device busy time."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    chips = {"ideal": chip_mod.compile_chip(spec, params=params, device=dev),
             "drifting": drifting}
    times = {k: [] for k in chips}
    for _ in range(STREAM_ROUNDS):
        for k in ("ideal", "drifting", "drifting", "ideal"):
            times[k].append(_time_ms(torch, lambda: chips[k].stream(x),
                                     iters=10))
    for k, ms in times.items():
        med, q1, q3 = _quartiles(ms)
        _line({"metric": "variability_stream_items_per_s", "chip": k,
               "system": "memristor", "use_kernel": True, "batch": STREAM_B,
               "ms_per_batch_median": med, "ms_per_batch_q1": q1,
               "ms_per_batch_q3": q3, "runs": len(ms),
               "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, chips[k], x, True, med), "card": card})


# --------------------------------------------------------------------- #
# phase 6: the paper's five apps
# --------------------------------------------------------------------- #
def _close(got, want, path):
    if isinstance(want, dict):
        _require(isinstance(got, dict) and set(got) == set(want),
                 f"{path}: keys")
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        _require(len(got) == len(want), f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        # equal covers the infinite rates (a fabric with no mesh link)
        _require(got == want or
                 abs(got - want) <= REPORT_RTOL * abs(want) + 1e-12,
                 f"{path}: {got!r} != {want!r}")
    else:
        _require(got == want, f"{path}: {got!r} != {want!r}")


def _app_nets(apps, app_id, system):
    nets = []
    for _, dims in apps[app_id].nets(system):
        if tuple(dims) not in nets:
            nets.append(tuple(dims))
    return nets


def phase_paper_apps(torch, ops, tcompile, tq, tcl, chip_mod, dev, card):
    """Every app's Tables II–VI report against the golden file, then
    every weighted net of every app streamed through the kernels on both
    systems (counters reset just before, read just after), then checked
    layer by layer against the einsum path."""
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.core.costmodel import risc_cost
    with open(os.path.join(ROOT, "tests", "golden",
                           "fleet_tables.json")) as f:
        golden = json.load(f)["apps"]
    reports = 0
    for app_id, app in APPS.items():
        for key, system in (("1t1m", "memristor"), ("digital", "digital")):
            rep = chip_mod.compile_app(app, system, device=dev).report()
            _close(rep.to_dict(), golden[app_id][key], f"{app_id}.{key}")
            reports += 1
        risc = dataclasses.asdict(risc_cost(app))
        risc.pop("mapping")
        risc.pop("route")
        _close(risc, golden[app_id]["risc"], f"{app_id}.risc")
        reports += 1

    runs = []
    ops.reset_launch_counts()
    for app_id in APPS:
        for system in ("memristor", "digital"):
            for k, dims in enumerate(_app_nets(APPS, app_id, system)):
                spec = tcl.MLPSpec(dims, activation="threshold",
                                   out_activation="linear")
                params = tcl.mlp_init(
                    spec, generator=torch.Generator().manual_seed(10 + k),
                    device=dev)
                chip = chip_mod.compile_chip(spec, params=params,
                                             system=system, device=dev)
                x = torch.rand((STREAM_B, dims[0]),
                               generator=torch.Generator().manual_seed(k)
                               ).to(dev)
                before = ops.launch_counts()
                out = chip.stream(x)
                runs.append((app_id, system, dims, chip, x, out,
                             _deltas(ops.launch_counts(), before)))
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    rows = []
    for app_id, system, dims, chip, x, out, per_call in runs:
        key = "crossbar_mvm" if system == "memristor" else \
            "int8_matmul_fused"
        _require(per_call[key] == len(dims) - 1,
                 f"{app_id} {system} {dims}: launches {per_call}")
        _require(tuple(out.shape) == (STREAM_B, dims[-1]) and
                 bool(torch.isfinite(out).all()),
                 f"{app_id} {system} {dims}: output")
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        f"{app_id} {system} {dims}")
        plain = chip.stream(x, use_kernel=False)
        e = _rel(out[clear], plain[clear])
        _require(e <= TOL_F32, f"{app_id} {system} {dims}: stream vs "
                               f"plain rel {e:.3g}")
        rows.append({"app": app_id, "system": system, "dims": list(dims),
                     "tiles": [list(layer.tiles.gp.shape[:2])
                               if system == "memristor" else
                               list(layer.tiles.wq.shape)
                               for layer in chip.plan],
                     "launches": per_call[key], "stream_vs_plain_rel": e,
                     "threshold_flips_in_band": flips,
                     "rows_compared": int(clear.sum())})
    _line({"phase": "paper_apps", "reports_equal_golden": reports,
           "report_rtol": REPORT_RTOL, "nets": rows, "items": STREAM_B,
           "launches": launches, "tol": TOL_F32, "card": card})
    return launches


# --------------------------------------------------------------------- #
# phase 7: wide digital codes through the raw int8 kernel's byte planes
# --------------------------------------------------------------------- #
def _layer_planes(torch, tcl, chip, x):
    """Each wide layer's input-code and synapse byte planes on the
    einsum path's own activations: [(layer, x planes, w planes)]."""
    from repro_torch.chip import compile as tcompile
    h, out = x, []
    for i, layer in enumerate(chip.plan):
        p = layer.tiles
        xq = tcl.quantize_inputs(p, h.to(torch.float32))
        out.append((i, tcl.unsigned_byte_planes(xq, -(-p.bits // 8)),
                    p.planes))
        h = tcompile._apply_stream_layer(layer, h, False)
    return out


def phase_wide_digital(torch, ops, ref, tcl, chip_mod, dev, card):
    """The deep app on the digital system at 12-bit codes: stream and
    serve through the raw int8 kernel's byte planes (counters reset
    just before, read just after), then the stream against the einsum
    path (to the bit) and the raw kernel against its plain version at
    the plane shapes."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(7)).to(dev)
    gen = torch.Generator().manual_seed(8)
    items = [torch.rand((3 + i % 4, DEEP[0]), generator=gen).numpy()
             for i in range(8)]

    ops.reset_launch_counts()
    chip = chip_mod.compile_chip(spec, params=params, system="digital",
                                 weight_bits=WIDE_BITS, device=dev)
    before = ops.launch_counts()
    out = chip.stream(x)
    per_call = _deltas(ops.launch_counts(), before)
    eng = chip.serve(slots=4)
    for uid, it in enumerate(items):
        eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    planes = [tuple(layer.tiles.planes.shape) for layer in chip.plan]
    per_layer = (-(-WIDE_BITS // 8)) * chip.plan[0].tiles.planes.shape[0]
    _require(per_call == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                          "int8_matmul_raw": per_layer * len(chip.plan)},
             f"wide digital stream launches {per_call}")
    _require(len(done) == len(items), f"wide digital: served {len(done)}")
    _require(launches["int8_matmul_raw"] ==
             per_layer * len(chip.plan) * (1 + eng.steps),
             f"wide digital launches {launches}")
    plain = chip.stream(x, use_kernel=False)
    _require(bool(torch.equal(out, plain)),
             f"wide digital stream differs from the einsum path: rel "
             f"{_rel(out, plain):.3g}")
    _require(tuple(out.shape) == (STREAM_B, DEEP[-1]) and
             bool(torch.isfinite(out).all()), "wide digital output")
    served_equal = all(
        torch.equal(torch.from_numpy(st.result),
                    chip.stream(torch.from_numpy(st.request.items)
                                .to(dev)).cpu()) for st in done)
    _require(served_equal, "wide digital: served outputs differ from the "
                           "direct stream")
    checks = 0
    for i, xp, wp in _layer_planes(torch, tcl, chip, x):
        for a in range(xp.shape[0]):
            for b in range(wp.shape[0]):
                _require(torch.equal(ops.int8_matmul(xp[a], wp[b]),
                                     ref.int8_matmul_ref(xp[a], wp[b])),
                         f"raw int8 layer {i} planes ({a}, {b}) not exact")
                checks += 1
    _line({"phase": "wide_digital", "bits": WIDE_BITS, "items": STREAM_B,
           "planes": planes, "launches_per_stream_call": per_call,
           "launches": launches, "stream_equal_to_einsum_path": True,
           "served_requests": len(done), "engine_steps": eng.steps,
           "served_equal_to_direct_stream": True,
           "raw_plane_checks_exact": checks, "card": card})
    return chip, x, launches


def phase_wide_digital_times(torch, ops, ref, tcl, chip, x, launches, card):
    """The raw int8 kernel's row of the ``kernels`` line (``launches``:
    the main path's): per layer, the plane products of one streamed
    batch (one launch each), against the plain version and one PyTorch
    matmul a product, with the bound; then the wide stream's items/s
    through the planes and on the einsum path, alternating."""
    rows = []
    for i, xp, wp in _layer_planes(torch, tcl, chip, x):
        pairs = [(a, b) for a in range(xp.shape[0])
                 for b in range(wp.shape[0])]
        B, K = xp.shape[1:]
        N = wp.shape[2]
        wf = [w.float() for w in wp]
        err = max(float((ops.int8_matmul(xp[a], wp[b]) -
                         ref.int8_matmul_ref(xp[a], wp[b])).abs().max())
                  for a, b in pairs)
        # each x and w plane read once, each int32 product written once
        nbytes = (xp.shape[0] * B * K + wp.shape[0] * K * N +
                  4 * len(pairs) * B * N)
        t_bytes, t_ops = _bound(nbytes, len(pairs) * 2 * B * K * N,
                                INT8_OPS)
        rows.append({
            "kernel": "int8_matmul_raw", "layer": i, "bits": WIDE_BITS,
            "plane_products": len(pairs), "shape": [B, K, N],
            "max_abs_err": err,
            **_times(torch,
                     lambda: [ops.int8_matmul(xp[a], wp[b])
                              for a, b in pairs],
                     lambda: [ref.int8_matmul_ref(xp[a], wp[b])
                              for a, b in pairs],
                     lambda: [xp[a].float() @ wf[b] for a, b in pairs]),
            "bytes_ms": t_bytes, "ops_ms": t_ops, "card": card})
    for r in rows:
        _line(r)
    # the wide stream end to end, planes and einsum path alternating
    times = {True: [], False: []}
    for _ in range(STREAM_ROUNDS):
        for use_kernel in (False, True, True, False):
            times[use_kernel].append(_time_ms(
                torch, lambda: chip.stream(x, use_kernel=use_kernel),
                iters=10))
    for use_kernel, ms in times.items():
        med, q1, q3 = _quartiles(ms)
        _line({"metric": "wide_digital_stream_items_per_s",
               "bits": WIDE_BITS, "use_kernel": use_kernel,
               "batch": STREAM_B, "ms_per_batch_median": med,
               "ms_per_batch_q1": q1, "ms_per_batch_q3": q3,
               "runs": len(ms), "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, chip, x, use_kernel, med), "card": card})
    return _kernel_row("int8_matmul_raw", "src/repro_torch/kernels/csrc/"
                       "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:36",
                       launches["int8_matmul_raw"], rows)


# --------------------------------------------------------------------- #
# phase 8: the fleet — four logical chips on the one card
# --------------------------------------------------------------------- #
def _fleet_vs_chip(torch, got, want):
    e = _rel(got, want)
    _require(e <= FLEET_TOL and tuple(got.shape) == tuple(want.shape),
             f"fleet vs chip rel {e:.3g}")
    return {"equal": bool(torch.equal(got, want)), "rel": e}


def phase_fleet(torch, ops, tcompile, tcl, chip_mod, drifting, dev, card):
    """The deep app on both systems as four logical chips on the one
    card (counters reset just before, read just after): streams of
    16,384 and 4,097 items, resize 4 → 2 → 4, reprogram, the drifting
    chip as a fleet at three ages, a sensor-fed router drain and the
    report; then each result against the chip's."""
    import numpy as np

    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    params2 = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(9),
                           device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(10)).to(dev)
    pipe = SensorPipeline(window=28, stride=18)
    _require(pipe.d_item == DEEP[0] and pipe.items_per_step == 9,
             "sensor windows are not the deep app's items")
    chips = {s: chip_mod.compile_chip(spec, params=params, system=s,
                                      device=dev)
             for s in ("memristor", "digital")}

    ops.reset_launch_counts()
    c0 = chip_mod.compile_count()
    got, per_batch, routers = {}, {}, {}
    for system, chip in chips.items():
        fleet = shard_chip(chip, FLEET_CHIPS)
        before = ops.launch_counts()
        got[system, "batch"] = fleet.stream(x)
        per_batch[system] = _deltas(ops.launch_counts(), before)
        got[system, "ragged"] = fleet.stream(x[:FLEET_RAGGED_B])
        for n in (2, FLEET_CHIPS):
            fleet.resize(n)
            got[system, f"resize_{n}"] = fleet.stream(x)
        fleet.reprogram(params2)
        got[system, "reprogram"] = fleet.stream(x)
        router = FleetRouter(fleet, lanes_per_chip=FLEET_LANES)
        source = StreamSource(pipe, n_requests=FLEET_REQUESTS, capacity=8)
        done = sorted(router.serve(source), key=lambda st: st.request.uid)
        routers[system] = (fleet, router, source, done)
    ages, drift_fleet = [], shard_chip(drifting, FLEET_CHIPS)
    for _ in range(3):
        ages.append(drifting.items_streamed)
        got["drifting", ages[-1]] = drift_fleet.stream(x)
    compile_delta = chip_mod.compile_count() - c0
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    _require(compile_delta == 0, f"fleet compile delta {compile_delta}")
    kernel = {"memristor": "crossbar_mvm", "digital": "int8_matmul_fused"}
    for system, per in per_batch.items():
        want = {k: 3 if k == kernel[system] else 0 for k in per}
        _require(per == want, f"{system} fleet batch launches {per}")
    _require([b - a for a, b in zip(ages, ages[1:])] == [STREAM_B] * 2 and
             drifting.items_streamed == ages[-1] + STREAM_B,
             f"fleet drift clock {ages}, {drifting.items_streamed}")
    results = {}
    for system, chip in chips.items():
        re = chip_mod.reprogram_chip(chip, params2)
        want = {"batch": chip.stream(x),
                "ragged": chip.stream(x[:FLEET_RAGGED_B]),
                "resize_2": chip.stream(x),
                f"resize_{FLEET_CHIPS}": chip.stream(x),
                "reprogram": re.stream(x)}
        results[system] = {k: _fleet_vs_chip(torch, got[system, k], w)
                           for k, w in want.items()}
        fleet, router, source, done = routers[system]
        _require(len(done) == FLEET_REQUESTS and source.exhausted and
                 all(st.result.shape == (9, DEEP[-1]) for st in done),
                 f"{system} router drained {len(done)}")
        items = torch.from_numpy(np.concatenate([st.request.items
                                                 for st in done])).to(dev)
        direct = fleet.stream(items).cpu()
        served = torch.from_numpy(np.concatenate([st.result for st in done]))
        diff = float((served - direct).abs().max())
        # the reference selftest's bound: lanes batch differently
        _require(diff <= 1e-5, f"{system} router outputs differ from the "
                               f"direct stream by {diff:.3g}")
        rep = fleet.report(router)
        chip_rep = chip.report()
        _require(rep.n_chips == FLEET_CHIPS and
                 abs(rep.power_mw - FLEET_CHIPS * chip_rep.power_mw) < 1e-9
                 and rep.served.items == FLEET_REQUESTS * 9,
                 f"{system} fleet report {rep}")
        results[system]["router"] = {
            "requests": len(done), "steps": router.steps,
            "lanes": router.slots, "items": router.items_emitted,
            "served_equal_to_direct_stream": bool(torch.equal(served,
                                                              direct)),
            "served_max_abs_diff": diff,
            "report_capacity_items_per_s": rep.capacity_items_per_second}
    drift = {}
    for age in ages:
        age_t = torch.full((), float(age), dtype=torch.float32, device=dev)
        want = tcompile.stream_pipeline(drifting.plan, x, use_kernel=True,
                                        replication=drifting.replication,
                                        age=age_t)
        drift[age] = _fleet_vs_chip(torch, got["drifting", age], want)
    _line({"phase": "fleet", "chips": FLEET_CHIPS, "on": "one card",
           "items": STREAM_B, "ragged_items": FLEET_RAGGED_B,
           "tol": FLEET_TOL, "launches_per_fleet_batch": per_batch,
           "compile_delta": compile_delta, "systems": results,
           "drifting": {str(a): d for a, d in drift.items()},
           "launches": launches, "card": card})
    return chips, x, launches


def phase_fleet_times(torch, chip_mod, chips, x, card):
    """Fleet and single chip alternating in one process (chip, fleet,
    fleet, chip): ms a batch, device busy time, idle share and kernels a
    batch, with the fleet held to the chip's kernels and busy time; then
    router steps/s beside ``chip.serve(slots=16)`` on the same
    requests, the median of three drains after a warm-up."""
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, shard_chip
    pipe = SensorPipeline(window=28, stride=18)
    requests = [pipe.batch(step).numpy() for step in range(FLEET_REQUESTS)]
    for system, chip in chips.items():
        paths = {"chip": chip, "fleet": shard_chip(chip, FLEET_CHIPS)}
        times = {k: [] for k in paths}
        for _ in range(STREAM_ROUNDS):
            for k in ("chip", "fleet", "fleet", "chip"):
                times[k].append(_time_ms(torch, lambda: paths[k].stream(x),
                                         iters=10))
        busy = {}
        for k, ms in times.items():
            med, q1, q3 = _quartiles(ms)
            busy[k] = _device_busy(torch, paths[k], x, True, med)
            _line({"metric": "fleet_stream_items_per_s", "system": system,
                   "path": k, "chips": FLEET_CHIPS if k == "fleet" else 1,
                   "batch": STREAM_B, "ms_per_batch_median": med,
                   "ms_per_batch_q1": q1, "ms_per_batch_q3": q3,
                   "runs": len(ms), "items_per_s": STREAM_B / med * 1e3,
                   **busy[k], "card": card})
        if all(b["device_busy_ms"] != "not measured"
               for b in busy.values()):
            _require(busy["fleet"]["kernels_per_batch"] <=
                     busy["chip"]["kernels_per_batch"] + 2,
                     f"{system} fleet kernels a batch {busy}")
            _require(busy["fleet"]["device_busy_ms"] <=
                     1.05 * busy["chip"]["device_busy_ms"],
                     f"{system} fleet device busy {busy}")
        engines = {
            "fleet_router": lambda: FleetRouter(
                paths["fleet"], lanes_per_chip=FLEET_LANES),
            "chip_engine": lambda: chip.serve(
                slots=FLEET_LANES * FLEET_CHIPS)}
        rates = {k: [] for k in engines}
        steps = {}
        for _ in range(1 + SERVE_DRAINS):   # the first round warms up
            for k, make in engines.items():
                eng = make()
                for uid, it in enumerate(requests):
                    eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
                t0 = time.perf_counter()
                eng.run_until_drained()
                torch.cuda.synchronize()
                rates[k].append(eng.steps / (time.perf_counter() - t0))
                steps[k] = eng.steps
        for k, r in rates.items():
            _line({"metric": "fleet_router_steps_per_s", "system": system,
                   "engine": k, "lanes": FLEET_LANES * FLEET_CHIPS,
                   "requests": FLEET_REQUESTS, "steps": steps[k],
                   "drains": r[1:], "warm_up_drain": r[0],
                   "steps_per_s": _quartiles(r[1:])[0], "card": card})


# --------------------------------------------------------------------- #
# phase 9: the fleet over ranks — processes sharing the one card
# --------------------------------------------------------------------- #
def _ranks_failed(summary) -> str:
    """What a failed multi-process run says about itself."""
    bad = {r: w.get("error") or {k: w[k] for k in w if k not in
                                 ("memristor", "digital")}
           for r, w in summary["workers"].items() if not w.get("ok")}
    return json.dumps(bad)[:2000] if bad else "a parent-side check failed"


def phase_ranks(torch, chip_mod, device, card):
    """The deep app as a fleet of RANKS ranks × RANK_CHIPS logical chips
    sharing the one card: the parent builds the kernels, spawns the
    ranks (fresh interpreters, one gloo group through a ``file://``
    store) through ``launch_local_fleet`` and reads each rank's last
    JSON line. Lockstep fleet, both systems: each rank's
    ``stream_local`` on its block of STREAM_B rows equals the chip's
    stream of the same rows bit for bit with three kernel launches a
    call and the one-process stream within FLEET_TOL; the lockstep
    router drains each rank's ``StreamSource.for_host`` feed
    RANK_DRAINS times with the same steps on every rank; ``stats_global``
    is identical on every rank and equal to ``assemble_stats`` of the
    ranks' own rows; each rank's lockstep router then degrades to its
    own chips, resizes to twice them and drains locally, its stream
    equal to the chip's. Then rank 1 of a lockstep fleet and rank 0 of a
    federated one are killed mid-serve, and the survivor absorbs the
    dead feed with every uid accounted once and no compile. Last, the
    lockstep router's aggregate rate against one process's
    ``FleetRouter`` with the same lanes and requests. Returns the ranks'
    kernel launches (the victims', killed, are not reported)."""
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    from repro_torch.fleet import __main__ as fmain
    on_card = torch.device("cuda" if device is None else device).type == \
        "cuda"
    t0 = time.perf_counter()
    dist = fmain.run_distributed_selftest(
        RANKS, RANK_CHIPS, device=device, rows=STREAM_B,
        requests=RANK_REQUESTS, drains=RANK_DRAINS, verbose=False,
        timeout=300.0)
    dist_s = time.perf_counter() - t0
    _require(dist["pass"], f"fleet of ranks: {_ranks_failed(dist)}")
    workers = [dist["workers"][r] for r in sorted(dist["workers"])]
    launches = {}
    for w in workers:
        for k, v in w["launches"].items():
            launches[k] = launches.get(k, 0) + v
    systems = {}
    for system in fmain.SYSTEMS:
        rows = [w[system] for w in workers]
        for row in rows:
            per = row["launches_per_call"]
            want = {k: 3 if on_card and k == fmain.KERNEL[system] else 0
                    for k in per}
            _require(per == want and row["equal_chip"] and
                     row["rel_one_process"] <= FLEET_TOL,
                     f"{system} rank stream_local: {per}, "
                     f"rel {row['rel_one_process']}")
            _require(row["degraded_resized"]["equal_chip"] and
                     row["degraded_resized"]["chips"] == 2 * RANK_CHIPS,
                     f"{system} rank degrade + resize: "
                     f"{row['degraded_resized']}")
        drains = rows[0]["drains"]
        timed = drains[1:] or drains
        systems[system] = {
            "launches_per_stream_local_call": [r["launches_per_call"]
                                               for r in rows],
            "equal_to_chip": [r["equal_chip"] for r in rows],
            "rel_one_process": [r["rel_one_process"] for r in rows],
            "steps_per_rank": [r["counts"][2] for r in rows],
            "degraded_resized": [r["degraded_resized"] for r in rows],
            "stats_global": rows[0]["stats_global"],
            "lockstep_drains": drains,
            # each rank's seconds a drain in the lockstep reduction
            "lockstep_in_reduce_s": [[d["in_reduce_s"] for d in r["drains"]]
                                     for r in rows],
            "lockstep_items_per_s": _quartiles(
                [d["items_per_s"] for d in timed])[0],
            "lockstep_steps_per_s": _quartiles(
                [d["steps_per_s"] for d in timed])[0]}

    chaos = {}
    for name, lockstep, kill_rank in (("lockstep_degrade", True, 1),
                                      ("federated_chaos", False, 0)):
        t0 = time.perf_counter()
        res = fmain.run_chaos_selftest(
            RANKS, kill_rank=kill_rank, kill_step=3, lockstep=lockstep,
            chips_per_process=RANK_CHIPS, device=device, verbose=False,
            timeout=300.0)
        _require(res["pass"], f"{name}: {_ranks_failed(res)}")
        (survivor,) = res["workers"].values()
        _require(survivor["compile_delta"] == 0 and
                 survivor["absorbed"] == [kill_rank] and
                 survivor["degraded"] == lockstep and
                 survivor["resize_rel"] == 0.0,
                 f"{name} survivor {survivor}")
        for k, v in survivor["launches"].items():
            launches[k] = launches.get(k, 0) + v
        chaos[name] = {
            "killed_rank": kill_rank, "kill_step": 3,
            "survivor": survivor["rank"],
            "uids_completed_once": res["completed"],
            "rejected": res["rejected"],
            "victim_completed_at_death": res["victim_completed_at_death"],
            "degraded_in_place": survivor["degraded"],
            "compile_delta": survivor["compile_delta"],
            "board_stats_requests": survivor["stats_requests"],
            "board_stats_items": survivor["stats_items"],
            "resized_chips": survivor["resized_chips"],
            "resize_rel": survivor["resize_rel"],
            "degraded_items_per_s": survivor["degraded_ips"],
            "seconds": time.perf_counter() - t0}
    _line({"phase": "ranks", "ranks": RANKS, "chips_per_rank": RANK_CHIPS,
           "on": "one card", "rows": STREAM_B, "tol": FLEET_TOL,
           "requests_per_rank": RANK_REQUESTS,
           "lanes_per_rank": fmain.LANES_PER_CHIP * RANK_CHIPS,
           "systems": systems, **chaos, "seconds": dist_s,
           "launches": launches, "card": card})
    _line({"metric": "any_across_hosts_us", "ranks": RANKS,
           "calls": fmain.AAH_CALLS,
           "per_rank": [w["any_across_hosts_us"] for w in workers],
           "card": card})
    _line({"metric": "rank_lane_stream_ms", "rows": fmain.LANES_PER_CHIP *
           RANK_CHIPS, "calls": fmain.LANE_CALLS,
           "per_rank": [w["lane_stream_ms"] for w in workers], "card": card})
    if on_card:
        _line({"metric": "rank_cuda_max_memory_allocated_bytes",
               "per_rank": [w["cuda_max_memory_allocated_bytes"]
                            for w in workers], "card": card})

    # the same lanes and requests served by one process's FleetRouter
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    pipe = SensorPipeline(window=28, stride=18)
    for system in fmain.SYSTEMS:
        fleet = shard_chip(fmain._deep_chip(system, dev), RANKS * RANK_CHIPS)
        rates = []
        for _ in range(RANK_DRAINS):
            router = FleetRouter(fleet, lanes_per_chip=fmain.LANES_PER_CHIP,
                                 queue_limit=4)
            router.serve(StreamSource(pipe, n_requests=RANKS * RANK_REQUESTS,
                                      capacity=3))
            s = router.stats()
            _require(s.requests == RANKS * RANK_REQUESTS,
                     f"one-process router served {s.requests}")
            rates.append({"steps": s.steps, "wall_s": s.wall_s,
                          "items_per_s": s.items_per_second,
                          "steps_per_s": s.steps / s.wall_s})
        timed = rates[1:] or rates
        one = {"items_per_s": _quartiles([r["items_per_s"]
                                          for r in timed])[0],
               "steps_per_s": _quartiles([r["steps_per_s"]
                                          for r in timed])[0]}
        lock = systems[system]
        _line({"metric": "ranks_router_rate", "system": system,
               "lanes": fmain.LANES_PER_CHIP * RANKS * RANK_CHIPS,
               "requests": RANKS * RANK_REQUESTS,
               "lockstep_ranks": RANKS,
               "lockstep_items_per_s": lock["lockstep_items_per_s"],
               "lockstep_steps_per_s": lock["lockstep_steps_per_s"],
               "lockstep_drains": lock["lockstep_drains"],
               "one_process_items_per_s": one["items_per_s"],
               "one_process_steps_per_s": one["steps_per_s"],
               "one_process_drains": rates,
               "first_drain_is_warm_up": len(rates) > 1, "card": card})
    return launches


# --------------------------------------------------------------------- #
# phase 10: the declarative deployment and the tuner
# --------------------------------------------------------------------- #
class _Frames:
    """A (seed, step)-pure request pipeline: DEPLOY_ITEMS deep-app items
    a step."""

    def __init__(self, torch, seed):
        self.torch, self.seed = torch, seed

    def batch(self, step):
        gen = self.torch.Generator().manual_seed(1000 * self.seed + step)
        return self.torch.rand((DEPLOY_ITEMS, DEEP[0]),
                               generator=gen).numpy()


def _roll_up(stats):
    """The per-app rows' sums beside the fleet row's counters."""
    keys = ("requests", "items", "rejected", "lanes")
    apps = {k: sum(getattr(s, k) for s in stats.apps.values())
            for k in keys}
    fleet = {k: getattr(stats.fleet, k) for k in keys}
    return apps, fleet


def _served_diff(torch, d, done, dev):
    """Max |routed output − the tenant's direct stream| over ``done``."""
    import numpy as np
    diff = 0.0
    for app in {st.request.key for st in done}:
        mine = [st for st in done if st.request.key == app]
        items = torch.from_numpy(np.concatenate([st.request.items
                                                 for st in mine])).to(dev)
        served = torch.from_numpy(np.concatenate([st.result
                                                  for st in mine]))
        diff = max(diff, float((served - d.stream(app, items).cpu())
                               .abs().max()))
    return diff


def phase_deploy(torch, ops, ref, tcompile, tq, tcl, chip_mod, var, dev,
                 card):
    """(a) single-app ``deploy()`` against ``shard_chip``, (b)+(e) the
    two-tenant served drain under telemetry, (c) the tuned heterogeneous
    fabric, (d) the canary loop on a deployed drifting tenant. The
    path's launches are counted around each path call (``on_path``);
    the checks against ``shard_chip``, the direct stream and the einsum
    path run outside it."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.fleet import StreamSource, shard_chip
    from repro_torch.fleet.ha import HeartbeatBoard
    from repro_torch.obs.trace import phase_breakdown, trace_ok
    from repro_torch.tune import tune

    t_phase = time.perf_counter()
    path = {k: 0 for k in ops.launch_counts()}
    on_path = _on_path(ops, path)

    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(12)).to(dev)
    kernel = {"memristor": "crossbar_mvm", "digital": "int8_matmul_fused"}
    lines = {}

    # (a) one app on each system: the chip's stream, the chip's launches
    single = {}
    for system in ("memristor", "digital"):
        d = deploy(AppSpec("deep", spec, params=params, system=system),
                   n_chips=DEPLOY_CHIPS, device=dev)
        y, per = on_path(d.stream, "deep", x)
        want = shard_chip(chip_mod.compile_chip(spec, params=params,
                                                system=system, device=dev),
                          DEPLOY_CHIPS).stream(x)
        _require(per == {k: 3 if k == kernel[system] else 0 for k in per},
                 f"deploy {system} launches a batch {per}")
        _require(bool(torch.equal(y, want)),
                 f"deploy {system} differs from shard_chip: rel "
                 f"{_rel(y, want):.3g}")
        single[system] = {"launches_per_batch": per,
                          "equal_to_shard_chip": True}
    lines["single_app"] = single

    # (b) + (e): two tenants on DEPLOY_CHIPS chips, served under
    # telemetry; the trace goes under build/ and is read back
    two = deploy(DeploymentSpec(apps=(
        AppSpec("deep_memristor", spec, params=params,
                lanes_per_chip=DEPLOY_LANES),
        AppSpec("deep_digital", spec, params=params, system="digital",
                lanes_per_chip=DEPLOY_LANES)), n_chips=DEPLOY_CHIPS,
        device=dev))
    sources = {app: StreamSource(_Frames(torch, i),
                                 n_requests=DEPLOY_REQUESTS, capacity=8)
               for i, app in enumerate(two.apps)}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tel = obs.configure()
    try:
        done, per = on_path(two.serve, sources)
        # the chip's own spans, off the path: a direct stream, timed on
        # the card by events resolved after one synchronise
        two.chip("deep_memristor").stream(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        unresolved = tel.tracer.resolve_device_times()
        events = tel.tracer.trace_events()
        trace_path = two.trace(os.path.join(ROOT, "build",
                                            "phase10_trace.json"))
    finally:
        obs.disable()
    with open(trace_path) as f:
        doc = json.load(f)
    brk = phase_breakdown(events)
    tiled = sum(brk["phases"].values()) / brk["step_us"]
    steps = two.router.steps
    _require(len(done) == 2 * DEPLOY_REQUESTS and
             all(src.exhausted for src in sources.values()),
             f"two-tenant serve finished {len(done)}")
    _require(per["crossbar_mvm"] == 3 * steps and
             per["int8_matmul_fused"] == 3 * steps,
             f"two-tenant launches {per} in {steps} steps")
    diff = _served_diff(torch, two, done, dev)
    _require(diff <= 1e-5, f"two-tenant routed outputs differ from the "
                           f"direct stream by {diff:.3g}")
    apps_sum, fleet = _roll_up(two.stats())
    _require(apps_sum == fleet == {
        "requests": 2 * DEPLOY_REQUESTS,
        "items": 2 * DEPLOY_REQUESTS * DEPLOY_ITEMS, "rejected": 0,
        "lanes": 2 * DEPLOY_LANES * DEPLOY_CHIPS},
        f"two-tenant roll-up {apps_sum} vs {fleet}")
    _require(trace_ok(doc, len(done)) and brk["steps"] == steps and
             0.90 <= tiled <= 1.02,
             f"trace: {brk['steps']} steps, phases/steps {tiled:.4f}")
    chip_spans = [e for e in events if e.get("cat") == "chip"]
    streams = [e for e in chip_spans if e["name"] == "chip.stream"]
    _require(len(streams) == 1 and unresolved == 0 and
             streams[0]["args"]["compile_delta"] == 0 and
             all(("device_ms" in e["args"]) == (dev.type == "cuda")
                 for e in chip_spans),
             f"chip spans {[(e['name'], e['args']) for e in chip_spans]}")
    lines["two_tenants"] = {
        "requests": len(done), "steps": steps, "launches": per,
        "served_max_abs_diff": diff, "roll_up": fleet,
        "step_phase_share": {k: v / brk["step_us"]
                             for k, v in sorted(brk["phases"].items())},
        "step_ms_mean": brk["step_us"] / brk["steps"] / 1e3,
        "phases_over_steps": tiled,
        "chip_span_device_ms": [[e["name"], e["args"].get("device_ms")]
                                for e in chip_spans],
        "trace": os.path.relpath(trace_path, ROOT),
        "trace_events": len(doc["traceEvents"])}

    # (c) the tuned heterogeneous fabric
    tuned = tune(DeploymentSpec(apps=(
        AppSpec("deep", "deep", items_per_second=TUNE_SLO),
        AppSpec("ocr", "ocr", items_per_second=TUNE_SLO, weight_bits=12)),
        device=dev))
    picked = {a: (p.system, p.geometry)
              for a, p in tuned.assignment.items()}
    _require(picked == {"deep": ("memristor", "128x64"),
                        "ocr": ("digital", "128x64")} and
             tuned.n_chips == 2, f"tuned assignment {picked}")
    het = deploy(tuned.spec)
    rep = het.report()
    cost_rel = max(abs(rep.area_mm2 - tuned.area_mm2) / tuned.area_mm2,
                   abs(rep.power_mw - tuned.power_mw) / tuned.power_mw)
    _require(het.chip_systems == tuned.chip_systems and
             cost_rel <= REPORT_RTOL, f"tuned report rel {cost_rel:.3g}")
    xs, outs, per_batch = {}, {}, {}
    for i, name in enumerate(het.apps):
        d_in = APPS[name].nets(picked[name][0])[0][1][0]
        xs[name] = torch.rand((STREAM_B, d_in),
                              generator=torch.Generator().manual_seed(20 + i)
                              ).to(dev)
        outs[name], per_batch[name] = on_path(het.stream, name, xs[name])
    gen = torch.Generator().manual_seed(30)
    for name in het.apps:
        d_in = xs[name].shape[1]
        for _ in range(8):
            het.submit(name, torch.rand((DEPLOY_ITEMS, d_in),
                                        generator=gen).numpy())
    mixed, _ = on_path(het.run_until_drained)
    deep_chip, ocr_chip = het.chip("deep"), het.chip("ocr")
    _require(per_batch["deep"] == {"crossbar_mvm": 3, "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 0} and
             per_batch["ocr"] == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                                  "int8_matmul_raw": 8},
             f"tuned launches a batch {per_batch}")
    flips, clear = _layerwise_check(torch, tcompile, tq, deep_chip,
                                    xs["deep"], "tuned deep")
    plain = deep_chip.stream(xs["deep"], use_kernel=False)
    e_deep = _rel(outs["deep"][clear], plain[clear])
    _require(e_deep <= TOL_F32, f"tuned deep vs einsum rel {e_deep:.3g}")
    _require(bool(torch.equal(outs["ocr"], ocr_chip.stream(
        xs["ocr"], use_kernel=False))), "tuned 12-bit ocr differs from the "
                                        "einsum path")
    plane_checks = 0
    for i, xp, wp in _layer_planes(torch, tcl, ocr_chip, xs["ocr"]):
        for a in range(xp.shape[0]):
            for b in range(wp.shape[0]):
                for rows in (STREAM_B, 4):
                    _require(torch.equal(
                        ops.int8_matmul(xp[a][:rows], wp[b]),
                        ref.int8_matmul_ref(xp[a][:rows], wp[b])),
                        f"raw int8 ocr layer {i} planes ({a}, {b}), "
                        f"{rows} rows, not exact")
                    plane_checks += 1
    diff = _served_diff(torch, het, mixed, dev)
    apps_sum, fleet = _roll_up(het.stats())
    _require(len(mixed) == 16 and diff <= 1e-5 and apps_sum == fleet,
             f"tuned mixed drain: {len(mixed)}, diff {diff:.3g}, "
             f"{apps_sum} vs {fleet}")
    lines["tuned"] = {
        "chip_systems": list(tuned.chip_systems), "assignment": picked,
        "area_mm2": tuned.area_mm2, "power_mw": tuned.power_mw,
        "report_rel": cost_rel, "launches_per_batch": per_batch,
        "deep_vs_einsum_rel": e_deep, "deep_threshold_flips_in_band": flips,
        "deep_rows_compared": int(clear.sum()),
        "ocr_equal_to_einsum_path": True,
        "ocr_planes": [list(lay.tiles.planes.shape) for lay in ocr_chip.plan],
        "raw_plane_checks_exact": plane_checks,
        "mixed_requests": len(mixed), "mixed_served_max_abs_diff": diff,
        "mixed_roll_up": fleet}

    # (d) the canary loop on a deployed drifting deep tenant: drift only,
    # as phase 5's loop — write noise re-rolls at every reprogram, so a
    # chip with it cannot return to its attach-time answers
    canary = torch.rand((CANARY_ROWS, DEEP[0]),
                        generator=torch.Generator().manual_seed(6)).numpy()
    n_req = VAR_LANES * DEPLOY_CHIPS
    frames = torch.rand((n_req * VAR_ITEMS, DEEP[0]),
                        generator=torch.Generator().manual_seed(13)).numpy()
    with tempfile.TemporaryDirectory() as tmp, deploy(AppSpec(
            "deep", spec, params=params,
            noise=var.NoiseModel(drift_rate=DRIFT_RATE, seed=0),
            lanes_per_chip=VAR_LANES), n_chips=DEPLOY_CHIPS,
            device=dev) as drifting:
        board = HeartbeatBoard(tmp)
        monitor = drifting.attach_monitor("deep", canary,
                                          every_steps=CANARY_STEPS)
        recal = drifting.attach_recalibration(
            "deep", policy=var.RecalPolicy(slo=CANARY_SLO), board=board)
        for i in range(n_req):
            drifting.submit("deep", frames[i * VAR_ITEMS:
                                           (i + 1) * VAR_ITEMS])
        c0 = chip_mod.compile_count()
        var_done, _ = on_path(drifting.run_until_drained)
        delta = chip_mod.compile_count() - c0
        events = recal.events
        journaled = len(board.events("recalibration"))
        accs = monitor.series()["accuracy"]
        var_steps = drifting.router.steps
    _require(len(var_done) == n_req and events and delta == 0 and
             min(accs) < CANARY_SLO and journaled == len(events) and
             all(e.accuracy_after >= CANARY_SLO and e.compile_delta == 0
                 for e in events),
             f"deployed canary loop: {[dataclasses.asdict(e) for e in events]}"
             f", compile delta {delta}")
    lines["canary_loop"] = {
        "noise": {"drift_rate": DRIFT_RATE, "seed": 0},
        "lanes": n_req, "steps": var_steps, "requests": len(var_done),
        "recals": [{"step": e.step, "items_streamed": e.items_streamed,
                    "before": e.accuracy_before, "after": e.accuracy_after}
                   for e in events],
        "journaled": journaled, "min_accuracy": min(accs),
        "compile_delta": delta}
    torch.cuda.synchronize()
    _line({"phase": "deploy", **lines, "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return two, het, xs, path


def phase_deploy_times(torch, chip_mod, two, het, xs, card):
    """The two-tenant router's steps/s beside one ``FleetRouter`` over
    the memristor tenant's fleet with the same 16 lanes serving the same
    64 requests (medians of three drains after a warm-up); then each
    tuned tenant's ms a batch (10 timings of 10 batches), device busy
    time, idle share and kernels a batch."""
    from repro_torch.deploy import MultiAppRouter
    from repro_torch.fleet import FleetRouter
    members = two.router.members
    frames = {app: _Frames(torch, i) for i, app in enumerate(members)}
    requests = [(app, frames[app].batch(step)) for step in
                range(DEPLOY_REQUESTS) for app in members]
    lanes = DEPLOY_LANES * DEPLOY_CHIPS
    engines = {
        "two_tenant_router": lambda: MultiAppRouter(
            members, lanes={app: lanes for app in members}),
        "one_app_fleet_router": lambda: FleetRouter(
            members["deep_memristor"],
            lanes_per_chip=DEPLOY_LANES * len(members))}
    rates = {k: [] for k in engines}
    steps = {}
    for _ in range(1 + SERVE_DRAINS):       # the first round warms up
        for k, make in engines.items():
            eng = make()
            for uid, (app, items) in enumerate(requests):
                eng.submit(chip_mod.ChipRequest(
                    uid=uid, items=items,
                    key=app if k == "two_tenant_router" else None))
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            rates[k].append(eng.steps / (time.perf_counter() - t0))
            steps[k] = eng.steps
    for k, r in rates.items():
        _line({"metric": "deploy_router_steps_per_s", "engine": k,
               "lanes": 2 * lanes, "requests": len(requests),
               "items": len(requests) * DEPLOY_ITEMS, "steps": steps[k],
               "drains": r[1:], "warm_up_drain": r[0],
               "steps_per_s": _quartiles(r[1:])[0], "card": card})
    for name, x in xs.items():
        member = het.router.members[name]
        ms = [_time_ms(torch, lambda: het.stream(name, x), iters=10)
              for _ in range(2 * STREAM_ROUNDS)]
        med, q1, q3 = _quartiles(ms)
        chip = het.chip(name)
        _line({"metric": "deploy_tuned_tenant_stream", "app": name,
               "system": chip.system,
               "geometry": f"{chip.geom.rows}x{chip.geom.cols}",
               "dims": list(chip.dims), "batch": STREAM_B,
               "ms_per_batch_median": med, "ms_per_batch_q1": q1,
               "ms_per_batch_q3": q3, "runs": len(ms),
               "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, member, x, True, med), "card": card})


# --------------------------------------------------------------------- #
# phase 11: LM tenants — the full-width qwen1.5-0.5B on the crossbar path
# --------------------------------------------------------------------- #
def _lm_drain(engine, prompts, make_request):
    """Submit every prompt, drain, and return {uid: tokens} and steps."""
    for uid, p in enumerate(prompts):
        engine.submit(make_request(uid, p))
    engine.run_until_drained()
    return engine


def _first_divergence(got, want):
    for uid in sorted(want):
        g, w = got.get(uid, []), want[uid]
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return {"uid": uid, "token": i, "got": a, "want": b}
        if len(g) != len(w):
            return {"uid": uid, "lengths": [len(g), len(w)]}
    return None


def _lm_tenant(torch, on_path, cfg, params, system, dev, toks, step, pos,
               dense, prompts, oracle):
    """One LM tenant's checks on ``params``: (a) ``compile_lm`` programs
    the 7 × num_layers linears and routes nothing; (b) a prefill of
    ``toks`` and a per-slot decode against the dense forward's
    ``dense`` = (logits, cache, step logits, step cache) within
    ``LM_TOL``, 7 × num_layers crossbar launches each, and each layer's
    residual stream; (c) an ``LMMember`` serving ``prompts`` through
    ``MultiAppRouter`` token for token against ``oracle`` (the dense
    ``Engine``'s tokens). Returns (result, the compiled LM, the drained
    router, a factory of fresh routers)."""
    from repro_torch import obs
    from repro_torch.deploy import MultiAppRouter
    from repro_torch.lm import LMMember, TransformerParams, compile_lm
    from repro_torch.lm import compile as lmc
    from repro_torch.lm import lm_request, tokens_from_state
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tf

    d_logits, d_cache, d_step, d_next = dense
    res = {}
    # (a) compile: program the 7 × num_layers linears, route nothing
    torch.cuda.synchronize()
    t0 = t_sys = time.perf_counter()
    clm, per = on_path(compile_lm, TransformerParams(cfg, params),
                       system=system, device=dev)
    torch.cuda.synchronize()
    res["compile_s"] = time.perf_counter() - t0
    res["geometry"] = f"{clm.geom.rows}x{clm.geom.cols}"
    res["cuda_memory_bytes"] = torch.cuda.memory_allocated(dev) \
        if dev.type == "cuda" else None
    _require("chip" not in clm.__dict__ and set(per.values()) == {0},
             f"compile_lm {system}: routed or launched {per}")
    per_forward = {k: 7 * cfg.num_layers if k == "crossbar_mvm" else 0
                   for k in per}
    tile_bytes = sum(4 * (pl.tiles.gp.numel() + pl.tiles.gn.numel())
                     for plans in clm.plans for pl in plans.values())
    res["tile_bytes"] = tile_bytes

    # (b) prefill and per-slot decode against the dense forward
    (m_logits, m_cache), per = on_path(clm.prefill, toks)
    _require(per == per_forward, f"prefill {system} launches {per}")
    (m_step, m_next), per = on_path(clm.decode, m_cache, step, pos)
    _require(per == per_forward, f"decode {system} launches {per}")
    rels = {"prefill_logits": _rel(m_logits, d_logits),
            "prefill_cache": max(_rel(m_cache[k], d_cache[k])
                                 for k in d_cache),
            "decode_logits": _rel(m_step, d_step),
            "decode_cache": max(_rel(m_next[k], d_next[k])
                                for k in d_next)}
    res["rel"] = rels
    res["launches_per_forward"] = per
    # each layer's residual stream, both paths from the same
    # embedding (check launches: not the path's)
    h_d = model_lib._embed_in(cfg, params, {"tokens": toks},
                              torch.float32)
    h_m = h_d
    positions = model_lib.positions_for(cfg, {}, 2, LM_PROMPT,
                                        "prefill", dev)
    windows = tf._layer_windows(cfg)
    res["residual_rel"] = []
    for layer in range(cfg.num_layers):
        p_l = tf.layer_slice(params["stack"], layer)
        kw = dict(positions=positions, mode="prefill", cache=None,
                  window=windows[layer])
        h_d = tf._block_apply(p_l, cfg, h_d, **kw)[0]
        h_m = tf._block_apply(
            p_l, cfg, h_m, **kw,
            project=lmc._projector(clm.plans[layer], True),
            mlp_fn=lmc._mlp_fn(clm.plans[layer], cfg, True))[0]
        res["residual_rel"].append(_rel(h_m, h_d))
    for key, r in rels.items():
        _require(r <= LM_TOL, f"{system} {key}: rel {r:.3g} "
                              f"(residual rel by layer "
                              f"{res['residual_rel']})")

    t_parity = time.perf_counter() - t_sys

    # (c) an LMMember served through the multi-app router
    def make_router():
        member = LMMember(clm, lanes=LM_LANES, cache_len=LM_CACHE)
        return MultiAppRouter({"lm": member}, lanes={"lm": LM_LANES})

    tel = obs.configure(trace=False)
    try:
        router, per = on_path(_lm_drain, make_router(), prompts,
                              lambda uid, p: lm_request(
                                  p, LM_NEW, uid=uid, key="lm"))
        counted = tel.metrics.snapshot()["counters"].get("lm.tokens")
    finally:
        obs.disable()
    got = {st.request.uid: tokens_from_state(st)
           for st in router.finished}
    stats = router.stats()
    res["serving"] = {
        "requests": len(got), "steps": router.steps, "launches": per,
        "items": stats.apps["lm"].items, "lm_tokens_counter": counted,
        "tokens_equal_engine": got == oracle,
        "first_divergence": _first_divergence(got, oracle)}
    _require(got == oracle, f"{system}: served tokens differ from the "
                            f"dense Engine: "
                            f"{res['serving']['first_divergence']}")
    _require(stats.apps["lm"].items == len(prompts) * LM_NEW ==
             counted, f"{system}: items {stats.apps['lm'].items}, "
                      f"lm.tokens {counted}")
    _require(per["crossbar_mvm"] == 7 * cfg.num_layers *
             (router.steps + len(prompts)),
             f"{system} serving launches {per} in {router.steps} "
             f"steps")
    t_serve = time.perf_counter() - t_sys - t_parity
    res["seconds"] = (t_parity, t_serve)
    return res, clm, router, make_router


def phase_lm(torch, ops, ref, tcl, dev, card, cfg=None, reduced=None):
    """(a) ``compile_lm`` of the full-width qwen1.5-0.5B on both systems,
    (b) prefill and per-slot decode against the dense forward, layer by
    layer, with 7 × num_layers crossbar launches a forward, (c) an
    ``LMMember`` serving requests through ``MultiAppRouter`` against the
    dense ``Engine``, token for token, then (e) the tenant's times; (d)
    ``deploy()`` of the reference selftest's sensor + LM duo at the
    reduced width. ``cfg``/``reduced`` default to the published config
    and ``reduced_serving()`` (the CPU rehearsal passes smaller ones)."""
    import numpy as np

    from repro_torch.configs import qwen1p5_0p5b
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Engine, Request

    t_phase = time.perf_counter()
    cfg = (cfg or qwen1p5_0p5b.CONFIG).replace(compute_dtype="float32",
                                                decode_per_slot=True)
    reduced = reduced or qwen1p5_0p5b.reduced_serving()
    path = {k: 0 for k in ops.launch_counts()}
    on_path = _on_path(ops, path)
    gen = torch.Generator().manual_seed(21)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT),
                         generator=gen).to(dev)
    step = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen).to(dev)
    pos = torch.tensor([LM_PROMPT, LM_PROMPT // 2 + 1], dtype=torch.int32,
                       device=dev)
    d_logits, d_cache = model_lib.prefill(cfg, params, {"tokens": toks})
    d_step, d_next = model_lib.decode_step(cfg, params, d_cache, step, pos)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=gen).tolist() for n in LM_PROMPTS]
    engine = _lm_drain(Engine(cfg, params, slots=LM_LANES,
                              cache_len=LM_CACHE), prompts,
                       lambda uid, p: Request(uid=uid, prompt=p,
                                              max_new_tokens=LM_NEW))
    oracle = {st.request.uid: st.generated for st in engine.finished}
    head_bytes = 4 * cfg.padded_vocab * cfg.d_model
    out = {"config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "init_s": init_s, "systems": {}}

    for system in ("memristor", "digital"):
        t_sys = time.perf_counter()
        res, clm, router, make_router = _lm_tenant(
            torch, on_path, cfg, params, system, dev, toks, step, pos,
            (d_logits, d_cache, d_step, d_next), prompts, oracle)
        t_parity, t_serve = res.pop("seconds")
        tile_bytes = res["tile_bytes"]
        # the serving rates once (memristor): the digital tenant runs the
        # same glue on other tiles, whose K1 times the forward lines show
        phase_lm_times(torch, ops, ref, tcl, cfg, params, clm,
                       make_router if system == "memristor" else None,
                       engine_factory=lambda: Engine(
                           cfg, params, slots=LM_LANES, cache_len=LM_CACHE),
                       prompts=prompts, toks=toks, system=system,
                       tile_bytes=tile_bytes, head_bytes=head_bytes,
                       card=card)
        torch.cuda.synchronize()
        res["seconds"] = {"compile_and_parity": t_parity,
                          "serving": t_serve,
                          "times": time.perf_counter() - t_sys - t_parity
                          - t_serve}
        out["systems"][system] = res
        del clm, router
        torch.cuda.empty_cache()

    # (d) deploy() of the reference selftest's duo at the reduced width
    rparams = model_lib.init_params(reduced, 0, device=dev)
    dep = deploy(DeploymentSpec(apps=(
        AppSpec("sensor", "deep", items_per_second=100.0, lanes_per_chip=2),
        AppSpec("lm", reduced, params=rparams, items_per_second=50.0,
                lanes_per_chip=2, cache_len=64)),
        n_chips=DEPLOY_CHIPS, device=dev))
    rng = np.random.default_rng(0)
    rprompts = [[int(t) for t in rng.integers(0, reduced.vocab_size, n)]
                for n in (5, 3, 7, 4, 6)]
    for p in rprompts:
        _require(dep.submit_tokens("lm", p, max_new_tokens=6),
                 "deploy duo: submit_tokens refused")
    batches = [rng.uniform(0, 1, (3 + i, 784)).astype(np.float32)
               for i in range(3)]
    for b in batches:
        dep.submit("sensor", b)
    _, per = on_path(dep.run_until_drained)
    got = dep.generated_tokens("lm")
    eng = _lm_drain(Engine(reduced, rparams, slots=len(rprompts),
                           cache_len=64), rprompts,
                    lambda uid, p: Request(uid=uid, prompt=p,
                                           max_new_tokens=6))
    want = {st.request.uid: st.generated for st in eng.finished}
    apps_sum, fleet = _roll_up(dep.stats())
    rep = dep.report()
    _require(got == want, f"deploy duo tokens differ from the Engine: "
                          f"{_first_divergence(got, want)}")
    _require(apps_sum == fleet and dep.stats().apps["lm"].items ==
             6 * len(rprompts), f"deploy duo roll-up {apps_sum} vs {fleet}")
    _require(set(rep.apps) == {"sensor", "lm"} and
             rep.apps["lm"].area_mm2 > 0 and
             abs(rep.area_mm2 - sum(a.area_mm2 for a in rep.apps.values()))
             < 1e-9, f"deploy duo report rows {sorted(rep.apps)}")
    out["deploy_duo"] = {
        "config": reduced.name, "chips": DEPLOY_CHIPS,
        "tokens_equal_engine": True, "launches": per, "roll_up": fleet,
        "report_rows": {name: {"area_mm2": a.area_mm2,
                               "power_mw": a.power_mw, "cores": a.cores}
                        for name, a in rep.apps.items()}}
    dep.close()
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _line({"phase": "lm", **out, "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


def _k1_blocks(dev, m, R, n):
    """The thread blocks K1's launcher gives a partials-mode call: one
    per 128 rows × 64 columns, times R row chunks when those alone would
    leave SMs idle (``crossbar_mvm_launch``)."""
    import torch
    if dev.type != "cuda":
        return None
    tiles = -(-n // 64) * -(-m // 128)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return tiles * (R if R > 1 and tiles < sms else 1)


def phase_lm_times(torch, ops, ref, tcl, cfg, params, clm, make_router,
                   engine_factory, prompts, toks, system, tile_bytes,
                   head_bytes, card):
    """The mapped tenant's decode steps/s and tokens/s beside the dense
    ``Engine`` on the same requests (medians of three drains after a
    warm-up, the two alternating; skipped when ``make_router`` is None);
    one decode step's and one prefill's
    wall, busy time and kernels, mapped and dense; K1 at the LM's shapes
    (layer 0's wq, w1, w2 at 4 and 32 rows) against its plain version
    and ``torch.matmul`` on the folded weights, with the bound."""
    from repro_torch.lm import lm_request
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Request

    rates = {"mapped": [], "dense": []} if make_router else {}
    steps = {}
    for _ in range(1 + SERVE_DRAINS if rates else 0):  # 1st warms up
        for kind in ("mapped", "dense"):
            if kind == "mapped":
                eng = make_router()
                make = lambda uid, p: lm_request(  # noqa: E731
                    p, LM_NEW, uid=uid, key="lm")
            else:
                eng = engine_factory()
                make = lambda uid, p: Request(  # noqa: E731
                    uid=uid, prompt=p, max_new_tokens=LM_NEW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _lm_drain(eng, prompts, make)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rates[kind].append((eng.steps / wall,
                                len(prompts) * LM_NEW / wall))
            steps[kind] = eng.steps
    for kind, r in rates.items():
        _line({"metric": "lm_serving", "system": system, "engine": kind,
               "lanes": LM_LANES, "requests": len(prompts),
               "tokens": len(prompts) * LM_NEW, "steps": steps[kind],
               "drains_steps_per_s": [a for a, _ in r[1:]],
               "warm_up_steps_per_s": r[0][0],
               "steps_per_s": _quartiles([a for a, _ in r[1:]])[0],
               "tokens_per_s": _quartiles([b for _, b in r[1:]])[0],
               "card": card})

    # one decode step (4 lanes at different positions) and one prefill
    dev = toks.device
    cache = clm.init_cache(LM_LANES, LM_CACHE)
    t4 = toks[:, :1].repeat(2, 1)
    p4 = torch.tensor([LM_PROMPT, 17, 40, 8], dtype=torch.int32, device=dev)
    calls = {
        ("decode", "mapped"): lambda: clm.decode(cache, t4, p4),
        ("decode", "dense"): lambda: model_lib.decode_step(
            cfg, params, cache, t4, p4),
        ("prefill", "mapped"): lambda: clm.prefill(toks[:1]),
        ("prefill", "dense"): lambda: model_lib.prefill(
            cfg, params, {"tokens": toks[:1]})}
    weights = {"decode": LM_LANES, "prefill": LM_PROMPT}
    for (what, kind), fn in calls.items():
        ms = _time_ms(torch, fn, iters=5)
        before = ops.launch_counts()["crossbar_mvm"]
        fn()
        k1 = ops.launch_counts()["crossbar_mvm"] - before
        _line({"metric": "lm_forward", "system": system, "what": what,
               "path": kind, "rows": weights[what], "ms": ms,
               "crossbar_launches": k1,
               "bound_ms_k1_weights": tile_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_ms_head": head_bytes / HBM_BYTES_PER_S * 1e3,
               **_busy(torch, fn, ms, n=2), "card": card})

    # K1 at the LM's shapes, on layer 0's programmed tiles
    _k1_at_lm_shapes(torch, ops, ref, tcl, clm, LM_SHAPES, LM_SHAPE_ROWS,
                     system, card, seed=23)


def _k1_at_lm_shapes(torch, ops, ref, tcl, clm, names, rows, system, card,
                     *, seed, iters=None, extra=None):
    """K1 in partials mode on layer 0's programmed tiles of each linear
    in ``names``, at each row count in ``rows``: against its plain
    version (``TOL_F32``), timed beside the plain version and
    ``torch.matmul`` on the folded weights, with the bound. One line a
    (linear, rows), with ``extra`` keys added."""
    dev = clm.device
    gen = torch.Generator().manual_seed(seed)
    for name in names:
        p = clm.plans[0][name].tiles
        R, C, tile_rows, cols = p.gp.shape
        w_fold = tcl.folded_weights(p, torch.float32).permute(
            0, 2, 1, 3).reshape(R, tile_rows, C * cols).contiguous()
        for m in rows:
            x = (torch.rand((m, p.d_in), generator=gen) * 2 - 1).to(dev)
            xt = tcl.tile_inputs(p, x)
            xr = xt.transpose(0, 1)
            got = ops.crossbar_mvm(xt, p.gp, p.gn, p.scale, partials=True)
            plain = ref.crossbar_mvm_partials_ref(xt, p.gp, p.gn, p.scale)
            # in f32, in place: a prefill's partials are gigabytes
            max_abs = float(torch.sub(got, plain).abs_().max())
            e = max_abs / max(float(plain.abs().max()), 1e-12)
            _require(e <= TOL_F32, f"crossbar {system} {name} M={m}: rel "
                                   f"{e:.3g}")
            nbytes = 4 * (xt.numel() + 2 * p.gp.numel() + p.scale.numel() +
                          got.numel())
            del got, plain
            t_bytes, t_ops = _bound(nbytes, TF32_PRODUCTS * 2 * m * R *
                                    tile_rows * C * cols, TF32_FLOPS)
            _line({"kernel": "crossbar_mvm", "lm_shape": name,
                   "system": system, "shape": [m, R, C, tile_rows, cols],
                   "d_in": p.d_in, "d_out": p.d_out, "mode": "partials",
                   "rel": e, "max_abs_err": max_abs,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "blocks": _k1_blocks(dev, m, R, C * cols),
                   **(extra or {}),
                   **_times(torch,
                            lambda: ops.crossbar_mvm(xt, p.gp, p.gn,
                                                     p.scale, partials=True),
                            lambda: ref.crossbar_mvm_partials_ref(
                                xt, p.gp, p.gn, p.scale),
                            lambda: torch.matmul(xr, w_fold), iters=iters),
                   "card": card})


# --------------------------------------------------------------------- #
# phase 12: ex-situ training
# --------------------------------------------------------------------- #
def _argmax_accuracy(torch, logits, y) -> float:
    return float((logits.argmax(-1) == y).to(torch.float32).mean())


def phase_train_qat(torch, ops, tcompile, tq, tcl, chip_mod, var, dev,
                    on_path):
    """(a) the paper's §III.D pipeline: QAT-train the deep app (8-bit
    weights and activations, threshold), compile it on memristor 128×64
    and digital 256×128 and stream the test set through the kernels,
    against the einsum path; a 12-bit net through K3's byte planes; (b)
    Fig. 12 at full width and a variation-aware pair on phase 5's noisy
    memristor chip."""
    from repro_torch.data import mnist_like
    from repro_torch.optim import qat

    xtr, ytr = mnist_like(seed=0, n=QAT_TRAIN_N)
    xte, yte = mnist_like(seed=1, n=QAT_TEST_N)
    x, y = xte.to(dev), yte.to(dev)

    def train(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = qat.train_mlp(xtr, ytr, DEEP, device=dev, **kw)
        torch.cuda.synchronize()
        return t, time.perf_counter() - t0

    tr8, train_s = train(activation="threshold", weight_bits=8, act_bits=8,
                         steps=QAT_STEPS)
    acc_qat = qat.accuracy(tr8["params"], tr8["spec"], x, y, mode="qat")
    out = {"train": {"steps": QAT_STEPS, "images": QAT_TRAIN_N,
                     "seconds": train_s, "qat_accuracy": acc_qat},
           "deployed": {}}
    for system in ("memristor", "digital"):
        chip = chip_mod.compile_chip(tr8["spec"], params=tr8["params"],
                                     system=system, device=dev)
        logits, per = on_path(chip.stream, x)
        plain = chip.stream(x, use_kernel=False)
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        system)
        pk, pp = logits.argmax(-1), plain.argmax(-1)
        _require(torch.equal(pk[clear], pp[clear]),
                 f"trained deep app, {system}: kernel predictions differ "
                 f"from the einsum path's outside the near-zero band")
        acc_k = _argmax_accuracy(torch, logits, y)
        acc_e = _argmax_accuracy(torch, plain, y)
        acc_api, _ = on_path(qat.accuracy, tr8["params"], tr8["spec"], x,
                             y, mode=system, chip=chip)
        _require(acc_api == acc_k, f"{system}: accuracy(chip=) {acc_api} "
                                   f"vs the stream's {acc_k}")
        _require(abs(acc_k - acc_qat) <= QAT_DROP,
                 f"{system}: deployed accuracy {acc_k:.4f} vs QAT forward "
                 f"{acc_qat:.4f}")
        out["deployed"][system] = {
            "geometry": f"{chip.geom.rows}x{chip.geom.cols}",
            "kernel_accuracy": acc_k, "einsum_accuracy": acc_e,
            "qat_minus_kernel": acc_qat - acc_k,
            "launches_per_batch": per, "threshold_flips_in_band": flips,
            "rows_compared": int(clear.sum())}

    # the same net at 12 bits on the digital system: K3's byte planes
    tr12, train12_s = train(activation="threshold", weight_bits=12,
                            act_bits=12, steps=QAT_STEPS)
    chip12 = chip_mod.compile_chip(tr12["spec"], params=tr12["params"],
                                   system="digital", weight_bits=12,
                                   device=dev)
    out12, per12 = on_path(chip12.stream, x)
    planes = (-(-12 // 8)) * chip12.plan[0].tiles.planes.shape[0]
    _require(per12["int8_matmul_raw"] == planes * len(chip12.plan) and
             per12["int8_matmul_fused"] == per12["crossbar_mvm"] == 0,
             f"12-bit trained stream launches {per12}")
    _require(torch.equal(out12, chip12.stream(x, use_kernel=False)),
             "12-bit trained stream differs from the einsum path")
    out["wide_12_bit"] = {
        "seconds": train12_s, "launches_per_batch": per12,
        "equal_to_einsum_path": True,
        "qat_accuracy": qat.accuracy(tr12["params"], tr12["spec"], x, y,
                                     mode="qat", weight_bits=12,
                                     act_bits=12),
        "kernel_accuracy": _argmax_accuracy(torch, out12, y)}

    # (b) Fig. 12 at full width: error against bit width and activation
    acc, fig = {}, {}
    t0 = time.perf_counter()
    for act in FIG12_ACTS:
        for bits in FIG12_BITS:
            t, _ = train(activation=act, weight_bits=bits, act_bits=bits,
                         steps=FIG12_STEPS)
            mode = "float" if bits >= 32 else "qat"
            acc[act, bits] = qat.accuracy(t["params"], t["spec"], x, y,
                                          mode=mode, weight_bits=bits,
                                          act_bits=bits)
            fig.setdefault(act, {})[str(bits)] = 1.0 - acc[act, bits]
    base = acc["sigmoid", 32]
    d_sig = base - acc["sigmoid", 8]
    d_th = base - acc["threshold", 8]
    out["fig12"] = {"steps": FIG12_STEPS, "error": fig,
                    "delta_sigmoid_8b": d_sig, "delta_threshold_8b": d_th,
                    "reference_rule_d_sig_lt_0.03_d_th_lt_0.08":
                    bool(d_sig < 0.03 and d_th < 0.08),
                    "seconds": time.perf_counter() - t0}

    # a variation-aware net against the clean one on phase 5's noisy chip
    hard, _ = train(activation="threshold", weight_bits=8, act_bits=8,
                    steps=QAT_STEPS,
                    noise=var.NoiseModel(program_sigma=0.1, seed=0))
    pair = {}
    for name, t in (("clean", tr8), ("variation_aware", hard)):
        chip = chip_mod.compile_chip(t["spec"], params=t["params"],
                                     noise=var.NoiseModel(**NOISE_KW),
                                     device=dev)
        logits, per = on_path(chip.stream, x)
        pair[name] = {"qat_accuracy": qat.accuracy(
            t["params"], t["spec"], x, y, mode="qat"),
            "noisy_chip_accuracy": _argmax_accuracy(torch, logits, y),
            "launches_per_batch": per}
    out["variation_aware_pair"] = pair
    return out


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _tree_rel(torch, got, want):
    """(max over leaves of rel, every leaf equal to the bit)."""
    from repro_torch.pytree import leaves
    rel, equal = 0.0, True
    for a, b in zip(leaves(got), leaves(want)):
        rel = max(rel, _rel(a.to(torch.float64), b.to(torch.float64)))
        equal = equal and bool(torch.equal(a, b))
    return rel, equal


def _train_legs(torch, launch_train, train_loop, args, root,
                resume_at=TRAIN_RESUME_AT):
    """The straight run of ``args`` through ``launch_train.main``, then
    the same job in two legs: ``setup`` + ``train_loop.run`` stopped
    after its step-``resume_at`` checkpoint (an interruption), and
    ``main`` again, which resumes from it. Returns the two runs'
    outputs, the straight run's peak CUDA memory, both runs' per-step
    log records, the legs' checkpoint directory and the job's config,
    train step and pipeline."""
    import shutil

    dir_a, dir_b = os.path.join(root, "straight"), os.path.join(root, "legs")
    log_a, log_b = dir_a + ".jsonl", dir_b + ".jsonl"
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    straight = launch_train.main(args + ["--ckpt-dir", dir_a, "--log",
                                         log_a])
    peak = torch.cuda.max_memory_allocated() if cuda else None
    shutil.rmtree(dir_a)              # its state stays in memory
    leg = launch_train.setup(launch_train.parse_args(
        args + ["--ckpt-dir", dir_b]))
    train_loop.run(dataclasses.replace(leg["loop"], total_steps=resume_at),
                   train_step=leg["train_step"], params=leg["params"],
                   opt_state=leg["opt_state"], pipeline=leg["pipeline"],
                   log_path=log_b)
    kit = {k: leg[k] for k in ("cfg", "train_step", "pipeline")}
    del leg
    if cuda:
        torch.cuda.empty_cache()
    resumed = launch_train.main(args + ["--ckpt-dir", dir_b, "--log",
                                        log_b])
    with open(log_a) as f:
        recs = [json.loads(line) for line in f]
    with open(log_b) as f:
        recs_b = [json.loads(line) for line in f]
    return straight, resumed, peak, recs, recs_b, dir_b, kit


@contextlib.contextmanager
def _launcher_depth(layers):
    """Inside, ``repro_torch.launch.train`` builds a published config
    (``configs.get_config``) at ``layers`` layers, its widths untouched;
    the reduced configs stay as they are."""
    from repro_torch import configs

    real = configs.get_config
    configs.get_config = lambda arch: real(arch).replace(num_layers=layers)
    try:
        yield
    finally:
        configs.get_config = real


def _timed_ckpt_io(torch, ckpt_lib, io):
    """``ckpt_lib.save`` and ``restore`` wrapped to append each
    publishing save's and each restore's seconds and bytes to ``io``."""
    real_save, real_restore = ckpt_lib.save, ckpt_lib.restore

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        published = ckpt_lib.published_steps(ckpt_dir)
        where = real_save(ckpt_dir, step, tree, **kw)
        if step not in published:
            io.append({"op": "save", "step": step,
                       "seconds": time.perf_counter() - t0,
                       "bytes": _dir_bytes(where)})
        return where

    def timed_restore(ckpt_dir, step, tree_like, **kw):
        t0 = time.perf_counter()
        got = real_restore(ckpt_dir, step, tree_like, **kw)
        torch.cuda.synchronize()
        io.append({"op": "restore", "step": step,
                   "seconds": time.perf_counter() - t0,
                   "bytes": _dir_bytes(os.path.join(
                       ckpt_dir, f"step_{step:08d}"))})
        return got

    return timed_save, timed_restore


def _resumed_legs(torch, launch_train, train_loop, args, root, tol,
                  resume_at=TRAIN_RESUME_AT):
    """``_train_legs``, and the resumed run held against the straight
    one: where they differ by more than ``tol``, both run again with
    PyTorch's deterministic algorithms (atomics off). Returns
    ``_train_legs``' outputs, then the rel, whether every leaf is equal
    to the bit, and whether deterministic algorithms were needed."""
    legs = _train_legs(torch, launch_train, train_loop, args, root,
                       resume_at)
    rel, equal = _tree_rel(torch, (legs[1]["params"], legs[1]["opt_state"]),
                           (legs[0]["params"], legs[0]["opt_state"]))
    if rel <= tol:
        return (*legs, rel, equal, False)
    del legs
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        legs = _train_legs(torch, launch_train, train_loop, args,
                           os.path.join(root, "deterministic"), resume_at)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    rel, equal = _tree_rel(torch, (legs[1]["params"], legs[1]["opt_state"]),
                           (legs[0]["params"], legs[0]["opt_state"]))
    return (*legs, rel, equal, True)


def phase_train(torch, ops, ref, tcompile, tq, tcl, chip_mod, var, dev,
                card, train_args=None):
    """Ex-situ training: (a)–(b) ``phase_train_qat``; (c) the full-width
    qwen1.5-0.5B at ``TRAIN_LAYERS`` of its 24 layers trained through
    ``repro_torch.launch.train`` (6 steps,
    AdamW, bf16 compute, remat "full", checkpoints every 3 steps), the
    same job interrupted after step 3 and resumed, equal to the straight
    run at rel ≤ 1e-6, each step's loss and wall, two steps' busy time
    and kernels, peak memory, each checkpoint save's and restore's
    seconds and bytes; (d) the step-6 checkpoint restored and served
    through ``compile_lm`` (memristor 128×64): prefill and decode
    against the dense forward, an ``LMMember`` against the dense
    ``Engine``. ``train_args`` defaults to ``TRAIN_ARGS`` (the CPU
    rehearsal passes a reduced run)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Engine, Request
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    path = {k: 0 for k in ops.launch_counts()}
    on_path = _on_path(ops, path)
    out = {"qat": phase_train_qat(torch, ops, tcompile, tq, tcl, chip_mod,
                                  var, dev, on_path)}
    _line({"phase": "train_qat", **out["qat"], "card": card})

    # (c) the LM trained, interrupted and resumed
    args = list(train_args or TRAIN_ARGS) + ["--log-every", "1"]
    io = []
    real_save, real_restore = ckpt_lib.save, ckpt_lib.restore
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt_lib.save, ckpt_lib.restore = _timed_ckpt_io(torch, ckpt_lib, io)
    try:
        t0 = time.perf_counter()
        with _launcher_depth(TRAIN_LAYERS):
            (straight, resumed, peak, recs, recs_b, dir_b, kit, rel, equal,
             deterministic) = _resumed_legs(torch, launch_train, train_loop,
                                            args, root, TRAIN_TOL)
        legs_s = time.perf_counter() - t0
        _require(resumed["resumed_from"] == TRAIN_RESUME_AT,
                 f"resumed from {resumed['resumed_from']}")
        _require(rel <= TRAIN_TOL, f"resumed run vs straight run: rel "
                                   f"{rel:.3g} (deterministic "
                                   f"algorithms: {deterministic})")
        losses = [r["loss"] for r in recs]
        _require(all(map(math.isfinite, losses)) and
                 losses[-1] < losses[0],
                 f"the LM's loss did not fall: {losses}")

        # two more steps at the run's shapes, for busy time and kernels
        cfg, step_fn = kit["cfg"], kit["train_step"]
        total = launch_train.parse_args(args).steps
        state = (resumed["params"], resumed["opt_state"])
        profiled = []
        for i in range(TRAIN_PROFILED):
            batch = kit["pipeline"].batch(total + i)

            def one(batch=batch):
                return step_fn(state[0], state[1], batch)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            profiled.append({"wall_ms": wall_ms,
                             **_busy(torch, one, wall_ms, n=1)})

        # (d) the step-6 checkpoint restored into the port's tree, served
        (params, opt_state), manifest = ckpt_lib.restore(dir_b, total,
                                                         state)
        rrel, requal = _tree_rel(torch, (params, opt_state), state)
        _require(requal, f"restored checkpoint differs: rel {rrel:.3g}")
    finally:
        ckpt_lib.save, ckpt_lib.restore = real_save, real_restore
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    del straight, resumed, state, opt_state
    out["lm_train"] = {
        "config": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "remat": cfg.remat, "compute_dtype": cfg.compute_dtype,
        "grad_accum": cfg.grad_accum, "args": args,
        "steps": [{k: r[k] for k in ("step", "loss", "accuracy",
                                      "grad_norm", "lr", "step_time_s")}
                  for r in recs],
        "resumed_leg_steps": [r["step"] for r in recs_b],
        "profiled_steps": profiled, "peak_cuda_bytes": peak,
        "checkpoint_io": io, "resume_rel": rel, "resume_bit_equal": equal,
        "deterministic_algorithms_needed": deterministic,
        "restored_step": manifest["step"], "seconds": legs_s}
    _line({"phase": "train_lm", **out["lm_train"], "card": card})

    cfg = cfg.replace(compute_dtype="float32", decode_per_slot=True)
    gen = torch.Generator().manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT),
                         generator=gen).to(dev)
    step = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen).to(dev)
    pos = torch.tensor([LM_PROMPT, LM_PROMPT // 2 + 1], dtype=torch.int32,
                       device=dev)
    d_logits, d_cache = model_lib.prefill(cfg, params, {"tokens": toks})
    dense = (d_logits, d_cache,
             *model_lib.decode_step(cfg, params, d_cache, step, pos))
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=gen).tolist() for n in LM_PROMPTS]
    engine = _lm_drain(Engine(cfg, params, slots=LM_LANES,
                              cache_len=LM_CACHE), prompts,
                       lambda uid, p: Request(uid=uid, prompt=p,
                                              max_new_tokens=LM_NEW))
    oracle = {st.request.uid: st.generated for st in engine.finished}
    res, clm, router, _ = _lm_tenant(torch, on_path, cfg, params,
                                     "memristor", dev, toks, step, pos,
                                     dense, prompts, oracle)
    res["seconds"] = dict(zip(("compile_and_parity", "serving"),
                              res["seconds"]))
    out["served"] = res
    del clm, router, params, engine
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _line({"phase": "train_served", **res, "card": card})
    _line({"phase": "train", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# phase 13: the Eq. 3 model and the other architectures
# --------------------------------------------------------------------- #
def phase_eq3(torch, ops, dev, card, on_path):
    """(a) Eq. 3 on the card: ``eq3_dot_product``, ``effective_weights``
    and ``crossbar_forward`` on CUDA tensors against the CPU's
    (``EQ3_TOL``) on each tile geometry and wire resistance; the
    de-gained unquantised forward against ``x @ w`` (``LM_TOL``); then
    K1 on one tile's programmed pairs (R = 1, scale = 1/column_gain)
    against Eq. 3 (``LM_TOL``), and with the threshold epilogue and a
    positive per-column gain against Eq. 3's signs outside the band."""
    from repro_torch.core import crossbar as tcb
    from repro_torch.core import quantization as tq
    from repro_torch.core.device import DEFAULT_DEVICE

    rows_out = []
    gen = torch.Generator().manual_seed(31)
    for rows, cols in EQ3_GEOMS:
        x = torch.rand((EQ3_B, rows), generator=gen) * 2 - 1
        w = torch.randn((rows, cols), generator=gen) * 0.2
        gp, gn, _ = tcb.pairs_from_weights(w)
        gain_pos = 0.2 + 2.8 * torch.rand((cols,), generator=gen)
        xd, wd, gpd, gnd = (t.to(dev) for t in (x, w, gp, gn))
        for r_seg in EQ3_R_SEGS:
            res = {"tile": [rows, cols], "r_seg": r_seg, "batch": EQ3_B}
            fns = {"eq3_dot_product": lambda x, w, gp, gn:
                   tcb.eq3_dot_product(x, gp, gn, r_seg),
                   "effective_weights": lambda x, w, gp, gn:
                   tcb.effective_weights(gp, gn, r_seg),
                   "crossbar_forward": lambda x, w, gp, gn:
                   tcb.crossbar_forward(x, w, r_seg=r_seg)}
            res["card_vs_cpu_rel"] = {
                name: _rel(fn(xd, wd, gpd, gnd).cpu(), fn(x, w, gp, gn))
                for name, fn in fns.items()}
            for name, r in res["card_vs_cpu_rel"].items():
                _require(r <= EQ3_TOL, f"eq3 {rows}x{cols} r_seg {r_seg} "
                                       f"{name}: card vs cpu rel {r:.3g}")
            if not r_seg:
                fwd = tcb.crossbar_forward(xd, wd, quantize=False)
                r = _rel(fwd, xd.double() @ wd.double())
                res["unquantised_forward_vs_matmul_rel"] = r
                _require(r <= LM_TOL, f"eq3 {rows}x{cols}: de-gained "
                                      f"forward vs x @ w rel {r:.3g}")
            # K1 on the tile's pairs (attenuated as Eq. 3 sees them)
            att = tcb.wire_attenuation(rows, cols, DEFAULT_DEVICE.g_on,
                                       r_seg, device=dev) if r_seg else 1.0
            gpa = (gpd * att)[None, None].contiguous()
            gna = (gnd * att)[None, None].contiguous()
            gain = tcb.column_gain(gpa[0, 0], gna[0, 0])
            dp = tcb.eq3_dot_product(xd, gpd, gnd, r_seg)
            k1, per = on_path(ops.crossbar_mvm, xd[:, None, :], gpa, gna,
                              (1.0 / gain)[None, None].contiguous())
            res["k1_vs_eq3_rel"] = _rel(k1, dp)
            _require(per["crossbar_mvm"] == 1 and
                     res["k1_vs_eq3_rel"] <= LM_TOL,
                     f"eq3 {rows}x{cols} r_seg {r_seg}: K1 vs Eq. 3 rel "
                     f"{res['k1_vs_eq3_rel']:.3g}, launches {per}")
            scale = (gain_pos.to(dev) / gain)[None, None].contiguous()
            signs, _ = on_path(ops.crossbar_mvm, xd[:, None, :], gpa, gna,
                               scale, activation="threshold")
            clear = dp.abs() > BAND * dp.abs().max()
            flips = int((signs != tq.threshold(dp))[clear].sum())
            res.update(threshold_flips_outside_band=flips,
                       outputs_in_band=int((~clear).sum()))
            _require(flips == 0, f"eq3 {rows}x{cols} r_seg {r_seg}: "
                                 f"{flips} threshold signs differ")
            res["k1_ms"] = _time_ms(torch, lambda: ops.crossbar_mvm(
                xd[:, None, :], gpa, gna, scale, activation="threshold"))
            res["eq3_ms"] = _time_ms(torch, lambda: tcb.eq3_dot_product(
                xd, gpd, gnd, r_seg))
            rows_out.append(res)
    return rows_out


def _np_batch(np, cfg, seed, B, S):
    """A seeded numpy train batch of the config's modality."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.frontend != "none":
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) *
                           0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    return batch


def _grow_ring(torch, cfg, cache, length):
    """Pad each attention ring of ``cache`` (its ring axis in the
    stack's ``cache_axes``) to ``length`` slots; recurrent states (the
    hybrid's Mamba2, xLSTM's) pass through, as the reference test's
    ``_grow_ring`` passes them."""
    from repro_torch.models import model as model_lib

    def grow(c, axes):
        if isinstance(c, dict):
            return {k: grow(v, axes[k] if isinstance(axes, dict) else axes)
                    for k, v in c.items()}
        ring = axes[1]
        if ring is None:
            return c
        return torch.nn.functional.pad(
            c, [0, 0] * (c.dim() - 1 - ring) + [0, length - c.shape[ring]])
    return grow(cache, model_lib.cache_axes(cfg))


def phase_reduced_archs(torch, dev, card, archs=FAMILY_ARCHS):
    """(b) each of ``archs`` (phase 13: the seven new reduced archs;
    phase 14: the two state-space ones) on the card against the CPU on
    the same
    seeded weights (f32 compute): the loss (rel ≤ 1e-5), each gradient
    leaf (rel ≤ 1e-4), the router's aux (rel ≤ 1e-6), one AdamW step
    (eps 1e-4, rel ≤ 1e-4), the prefill logits (rel ≤ 1e-5) and
    prefill/decode consistency (the reference test's rel < 0.02)."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.pytree import flatten_with_path, tree_map
    from repro_torch.train import steps

    out = {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get_reduced(arch).replace(compute_dtype="float32")
        cpu_p = model_lib.init_params(cfg, 0, device="cpu")
        card_p = tree_map(lambda p: p.to(dev), cpu_p)
        batch = {k: torch.from_numpy(v) for k, v in
                 _np_batch(np, cfg, 13, 2, 32).items()}
        m_cpu, g_cpu = steps.value_and_grad(cfg, cpu_p, batch)
        m_card, g_card = steps.value_and_grad(
            cfg, card_p, {k: v.to(dev) for k, v in batch.items()})
        res = {"loss": float(m_card["loss"]),
               "loss_rel": _rel(m_card["loss"].cpu(), m_cpu["loss"])}
        want = dict(flatten_with_path(g_cpu))
        res["grad_rel"] = max(_rel(g.cpu(), want[k])
                              for k, g in flatten_with_path(g_card))
        res["grad_norm"] = math.sqrt(sum(
            float(g.double().square().sum()) for g in want.values()))
        _require(math.isfinite(res["loss"]) and res["loss"] > 0 and
                 math.isfinite(res["grad_norm"]) and res["grad_norm"] > 0,
                 f"{arch}: loss {res['loss']}, grad norm "
                 f"{res['grad_norm']}")
        _require(res["loss_rel"] <= 1e-5 and res["grad_rel"] <= 1e-4,
                 f"{arch}: card vs cpu loss rel {res['loss_rel']:.3g}, "
                 f"grad rel {res['grad_rel']:.3g}")
        if cfg.family == "moe":
            res["moe_aux_rel"] = max(_rel(m_card[k].cpu(), m_cpu[k])
                                     for k in ("moe_aux", "moe_drop"))
            _require(res["moe_aux_rel"] <= 1e-6,
                     f"{arch}: router aux rel {res['moe_aux_rel']:.3g}")
        opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 1, 4), eps=1e-4)
        step, _ = steps.make_train_step(cfg, opt, global_batch=2)
        p_cpu, s_cpu, _ = step(cpu_p, opt.init(cpu_p), batch)
        p_card, s_card, _ = step(card_p, opt.init(card_p), batch)
        want = dict(flatten_with_path((p_cpu, s_cpu)))
        res["step_rel"] = max(_rel(v.cpu(), want[k]) for k, v in
                              flatten_with_path((p_card, s_card)))
        _require(res["step_rel"] <= 1e-4,
                 f"{arch}: AdamW step card vs cpu rel {res['step_rel']:.3g}")
        toks = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (2, 32), dtype=np.int32)).to(dev)
        full, _ = model_lib.prefill(cfg, card_p, {"tokens": toks})
        full_cpu, _ = model_lib.prefill(cfg, cpu_p, {"tokens": toks.cpu()})
        _, cache = model_lib.prefill(cfg, card_p, {"tokens": toks[:, :31]})
        dec, _ = model_lib.decode_step(cfg, card_p,
                                       _grow_ring(torch, cfg, cache, 32),
                                       toks[:, 31:], torch.tensor(31))
        res["prefill_rel"] = _rel(full.cpu(), full_cpu)
        res["decode_vs_prefill_rel"] = _rel(dec, full)
        _require(res["prefill_rel"] <= 1e-5 and
                 res["decode_vs_prefill_rel"] < 0.02,
                 f"{arch}: prefill card vs cpu rel "
                 f"{res['prefill_rel']:.3g}, decode vs prefill "
                 f"{res['decode_vs_prefill_rel']:.3g}")
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
    return out


def phase_gemma2(torch, ops, ref, tcl, dev, card, on_path, cfg=None,
                 prompt=GEMMA_PROMPT, new=GEMMA_NEW, shape_rows=None):
    """(c) gemma2-9b at its published width, cut to ``GEMMA_LAYERS``
    layers (seed-0 weights on the card, f32), through ``compile_lm`` on
    memristor 128×64 and digital 256×128: a ``prompt``-token prefill
    (past the 4,096 window, so the local layers mask) and ``new``
    greedy decode steps, mapped against the dense f32 forward at each
    step (``LM_TOL``; both fed the dense path's tokens), 7 × layers K1
    launches a forward, the mapped greedy tokens equal to the dense
    ones, an ``LMMember`` served through ``MultiAppRouter`` equal to the
    dense ``Engine`` token for token; each path's prefill and decode
    wall and busy time; K1 at the five linear shapes at M = 1 and the
    prefill's M."""
    from repro_torch.configs import gemma2_9b
    from repro_torch.deploy import MultiAppRouter
    from repro_torch.lm import (LMMember, TransformerParams, compile_lm,
                                lm_request, tokens_from_state)
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Engine, Request

    cfg = (cfg or gemma2_9b.CONFIG.replace(num_layers=GEMMA_LAYERS)) \
        .replace(compute_dtype="float32", decode_per_slot=True)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out = {"config": cfg.name, "layers": L, "published_layers": 42,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                            cfg.num_kv_heads,
                                            cfg.head_dim],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "window": cfg.sliding_window,
           "softcaps": [cfg.attn_softcap, cfg.final_softcap],
           "params": cfg.param_count(), "prompt": prompt,
           "decode_steps": new, "init_s": time.perf_counter() - t0,
           "systems": {}}
    gen = torch.Generator().manual_seed(37)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt),
                         generator=gen).to(dev)
    ring = prompt + new + 1

    def greedy_run(prefill, decode, feed=None):
        """Prefill, then ``new`` decodes, each fed the token ``feed``
        gives (default: the run's own greedy picks): each step's logits
        and the run's greedy picks."""
        logits, cache = prefill()
        steps_, picks = [logits], [int(logits.argmax(-1))]
        cache = _grow_ring(torch, cfg, cache, ring)
        for i in range(new):
            tok = torch.tensor([[(feed or picks)[i]]], device=dev)
            pos = torch.tensor([prompt + i], dtype=torch.int32, device=dev)
            logits, cache = decode(cache, tok, pos)
            steps_.append(logits)
            picks.append(int(logits.argmax(-1)))
        return steps_, picks

    dense_steps, dense_tokens = greedy_run(
        lambda: model_lib.prefill(cfg, params, {"tokens": toks}),
        lambda c, t, p: model_lib.decode_step(cfg, params, c, t, p))
    engine = _lm_drain(Engine(cfg, params, slots=1, cache_len=ring),
                       [toks[0].tolist()],
                       lambda uid, p: Request(uid=uid, prompt=p,
                                              max_new_tokens=new + 1))
    oracle = {st.request.uid: st.generated for st in engine.finished}
    out["dense_tokens"] = dense_tokens
    out["engine_tokens"] = oracle[0]
    del engine
    window_masks = _rel(model_lib.prefill(
        cfg.replace(local_global=False, sliding_window=0), params,
        {"tokens": toks})[0], dense_steps[0])
    out["full_attention_twin_rel"] = window_masks
    _require(window_masks > 1e-4, f"gemma2: the windowed prefill equals "
                                  f"full attention (rel {window_masks:.3g})")

    for system in ("memristor", "digital"):
        t_sys = time.perf_counter()
        res = {}
        clm, per = on_path(compile_lm, TransformerParams(cfg, params),
                           system=system, device=dev)
        torch.cuda.synchronize()
        res["compile_s"] = time.perf_counter() - t_sys
        res["geometry"] = f"{clm.geom.rows}x{clm.geom.cols}"
        res["tile_bytes"] = sum(4 * (pl.tiles.gp.numel() +
                                     pl.tiles.gn.numel())
                                for plans in clm.plans
                                for pl in plans.values())
        if dev.type == "cuda":
            res["cuda_memory_bytes"] = torch.cuda.memory_allocated(dev)
        launches = []

        def counted(fn, *a):
            got, per = on_path(fn, *a)
            launches.append(per["crossbar_mvm"])
            return got

        m_steps, m_tokens = greedy_run(
            lambda: counted(clm.prefill, toks),
            lambda c, t, p: counted(clm.decode, c, t, p),
            feed=dense_tokens)
        res["launches_per_forward"] = sorted(set(launches))
        res["rel"] = [_rel(m, d) for m, d in zip(m_steps, dense_steps)]
        res["tokens_equal_dense"] = m_tokens == dense_tokens
        _require(launches == [7 * L] * (new + 1),
                 f"gemma2 {system}: K1 launches a forward {launches}")
        _require(max(res["rel"]) <= LM_TOL,
                 f"gemma2 {system}: mapped vs dense rel by step "
                 f"{res['rel']}")
        _require(res["tokens_equal_dense"],
                 f"gemma2 {system}: greedy tokens {m_tokens} vs dense "
                 f"{dense_tokens}")
        member = LMMember(clm, lanes=1, cache_len=ring)
        router, per = on_path(
            _lm_drain, MultiAppRouter({"lm": member}, lanes={"lm": 1}),
            [toks[0].tolist()],
            lambda uid, p: lm_request(p, new + 1, uid=uid, key="lm"))
        got = {st.request.uid: tokens_from_state(st)
               for st in router.finished}
        res["served_tokens_equal_engine"] = got == oracle
        res["serving_launches"] = per["crossbar_mvm"]
        _require(got == oracle, f"gemma2 {system}: served tokens differ "
                                f"from the dense Engine: "
                                f"{_first_divergence(got, oracle)}")
        _require(per["crossbar_mvm"] == 7 * L * (router.steps + 1),
                 f"gemma2 {system}: serving launches {per} in "
                 f"{router.steps} steps")
        del router, member
        res["parity_s"] = time.perf_counter() - t_sys - res["compile_s"]

        # one forward of each kind, timed: wall, busy time, kernels
        cache = _grow_ring(torch, cfg, clm.prefill(toks)[1], ring)
        tok = torch.tensor([[dense_tokens[0]]], device=dev)
        pos = torch.tensor([prompt], dtype=torch.int32, device=dev)
        calls = {("decode", "mapped"): lambda: clm.decode(cache, tok, pos),
                 ("decode", "dense"): lambda: model_lib.decode_step(
                     cfg, params, cache, tok, pos),
                 ("prefill", "mapped"): lambda: clm.prefill(toks),
                 ("prefill", "dense"): lambda: model_lib.prefill(
                     cfg, params, {"tokens": toks})}
        for (what, kind), fn in calls.items():
            if system == "digital" and kind == "dense":
                continue
            ms = _time_ms(torch, fn, iters=3, warmup=1)
            _line({"metric": "lm_forward", "config": cfg.name,
                   "layers": L, "system": system, "what": what,
                   "path": kind, "rows": 1 if what == "decode" else prompt,
                   "ms": ms, **_busy(torch, fn, ms, n=1), "card": card})
        del cache
        _k1_at_lm_shapes(torch, ops, ref, tcl, clm, GEMMA_SHAPES,
                         shape_rows or (1, prompt), system, card, seed=41,
                         iters=5, extra={"config": cfg.name})
        res["seconds"] = time.perf_counter() - t_sys
        out["systems"][system] = res
        del clm
        torch.cuda.empty_cache()
    return out


def _moe_loop(torch, p, cfg, x):
    """The plain MoE: token by token, each token's top-k experts by
    ``torch.topk`` on its softmax, renormalised gates, plus the shared
    experts. x (T, d) → (T, d)."""
    from repro_torch.models.layers import act_fn

    act = act_fn(cfg.act)
    sh = p.get("shared")
    out = []
    for t in range(x.shape[0]):
        xt = x[t]
        gates, ids = torch.topk(torch.softmax(xt @ p["router"], -1),
                                cfg.top_k)
        gates = gates / gates.sum()
        y = torch.zeros_like(xt)
        for g, e in zip(gates, ids.tolist()):
            y = y + g * ((act(xt @ p["w1"][e]) * (xt @ p["w3"][e]))
                         @ p["w2"][e])
        if sh is not None:
            y = y + (act(xt @ sh["w1"]) * (xt @ sh["w3"])) @ sh["w2"]
        out.append(y)
    return torch.stack(out)


def phase_moe(torch, dev, card, cfg=None, batch=MOE_BATCH,
              loop_tokens=MOE_LOOP_TOKENS, prompts=MOE_PROMPTS,
              new=MOE_NEW):
    """(d) moonshot-v1-16b-a3b at its published width, cut to
    ``MOE_LAYERS`` layers (seed-0 weights on the card, f32): a prefill
    of ``batch`` tokens at the published capacity factor (the drop
    share a layer, wall, busy time); on layer 0, with a capacity factor
    at which nothing drops, the sort-based dispatch against a plain
    per-token loop (``LM_TOL``); prefill/decode consistency on 2 × 32
    tokens at that capacity factor (rel < 0.02, the reference test's
    bound); the dense
    ``Engine`` serving ``prompts`` × ``new`` tokens on ``MOE_LANES``
    lanes at the published capacity factor: steps/s over drains, a
    decode step's wall, busy time and kernels, and peak CUDA memory."""
    from repro_torch.configs import moonshot_v1_16b_a3b
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm
    from repro_torch.serving import Engine, Request

    cfg = (cfg or moonshot_v1_16b_a3b.CONFIG.replace(
        num_layers=MOE_LAYERS)).replace(compute_dtype="float32")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out = {"config": cfg.name, "layers": L, "published_layers": 48,
           "d_model": cfg.d_model, "experts": [cfg.num_experts, cfg.top_k,
                                               cfg.num_shared_experts],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "params": cfg.param_count(),
           "active_params": cfg.param_count(active_only=True),
           "init_s": time.perf_counter() - t0}
    gen = torch.Generator().manual_seed(43)
    toks = torch.randint(0, cfg.vocab_size, batch, generator=gen).to(dev)

    # a prefill at the published capacity factor
    def prefill():
        return model_lib.forward(cfg, params, {"tokens": toks},
                                 mode="prefill")
    h, _, aux = prefill()
    _require(bool(torch.isfinite(h).all()), "moe prefill: not finite")
    ms = _time_ms(torch, prefill, iters=3, warmup=1)
    out["prefill"] = {
        "tokens": list(batch), "capacity_factor": cfg.capacity_factor,
        "capacity": moe_mod.capacity(batch[0] * batch[1], cfg),
        "drop_frac_summed_over_layers": float(aux["drop_frac"]),
        "drop_frac_per_layer": float(aux["drop_frac"]) / L,
        "aux_loss_per_layer": float(aux["aux_loss"]) / L,
        "ms": ms, **_busy(torch, prefill, ms, n=1)}
    del h, aux

    # layer 0's dispatch against the per-token loop, nothing dropped
    p0 = tf.layer_slice(params["stack"], 0)
    x = rms_norm(model_lib._embed_in(cfg, params,
                                     {"tokens": toks[:1, :loop_tokens]},
                                     torch.float32),
                 p0["mlp_norm"], cfg.norm_eps)
    roomy = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    y, aux0 = moe_mod.moe_apply(p0["mlp"], roomy, x)
    t1 = time.perf_counter()
    y_loop = _moe_loop(torch, p0["mlp"], roomy, x[0])
    torch.cuda.synchronize()
    out["dispatch_vs_loop"] = {
        "tokens": loop_tokens, "capacity_factor": roomy.capacity_factor,
        "capacity": moe_mod.capacity(loop_tokens, roomy),
        "drop_frac": float(aux0["drop_frac"]), "rel": _rel(y[0], y_loop),
        "loop_s": time.perf_counter() - t1}
    _require(out["dispatch_vs_loop"]["drop_frac"] == 0.0 and
             out["dispatch_vs_loop"]["rel"] <= LM_TOL,
             f"moe dispatch vs loop {out['dispatch_vs_loop']}")

    # prefill/decode consistency on 2 × 32 tokens, at the capacity
    # factor where nothing drops (at 1.25 the 64-token prefill's
    # capacity is 8 a expert, and the tokens it drops are not the
    # decode's)
    ctoks = toks[:2, :32]
    full, _ = model_lib.prefill(roomy, params, {"tokens": ctoks})
    _, cache = model_lib.prefill(roomy, params, {"tokens": ctoks[:, :31]})
    dec, _ = model_lib.decode_step(roomy, params,
                                   _grow_ring(torch, roomy, cache, 32),
                                   ctoks[:, 31:], torch.tensor(31))
    out["decode_vs_prefill"] = {"capacity_factor": roomy.capacity_factor,
                                "rel": _rel(dec, full)}
    _require(out["decode_vs_prefill"]["rel"] < 0.02,
             f"moe decode vs prefill {out['decode_vs_prefill']}")
    del cache

    # the dense Engine serving requests
    pgen = torch.Generator().manual_seed(47)
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=pgen).tolist()
            for n in prompts]
    rates, tokens = [], None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(1 + SERVE_DRAINS):      # the first drain warms up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng = _lm_drain(Engine(cfg, params, slots=MOE_LANES,
                               cache_len=MOE_CACHE), reqs,
                        lambda uid, p: Request(uid=uid, prompt=p,
                                               max_new_tokens=new))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        rates.append((eng.steps / wall, len(reqs) * new / wall))
        got = {st.request.uid: st.generated for st in eng.finished}
        _require(tokens is None or got == tokens,
                 "moe Engine: drains gave different tokens")
        tokens = got
    _require(sorted(len(v) for v in tokens.values()) == [new] * len(reqs)
             and all(0 <= t < cfg.vocab_size for v in tokens.values()
                     for t in v), f"moe Engine tokens {tokens}")
    cache = model_lib.init_cache(cfg, MOE_LANES, MOE_CACHE, device=dev)
    dcfg = cfg.replace(decode_per_slot=True)
    step_tok = toks[:MOE_LANES, :1]
    step_pos = torch.tensor([8, 17, 30, 47][:MOE_LANES], dtype=torch.int32,
                            device=dev)
    decode = lambda: model_lib.decode_step(  # noqa: E731
        dcfg, params, cache, step_tok, step_pos)
    ms = _time_ms(torch, decode, iters=5)
    out["serving"] = {
        "lanes": MOE_LANES, "requests": len(reqs), "new_tokens": new,
        "prompt_lengths": list(prompts), "steps": eng.steps,
        "drains_steps_per_s": [a for a, _ in rates[1:]],
        "warm_up_steps_per_s": rates[0][0],
        "steps_per_s": _quartiles([a for a, _ in rates[1:]])[0],
        "tokens_per_s": _quartiles([b for _, b in rates[1:]])[0],
        "peak_cuda_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "decode_step": {"ms": ms, **_busy(torch, decode, ms, n=2)}}
    return out


def phase_families(torch, ops, ref, tcl, dev, card, gemma=None, moe=None):
    """Phase 13: (a) ``phase_eq3``, (b) ``phase_reduced_archs``,
    (c) ``phase_gemma2``, (d) ``phase_moe``. ``gemma``/``moe`` are keyword
    overrides of (c) and (d) (the CPU rehearsal passes reduced
    configs and short prompts). Returns the launches of (a) and (c)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()   # (c) and (d) take 27–53 GB in large blocks
    path = {k: 0 for k in ops.launch_counts()}
    on_path = _on_path(ops, path)
    t0 = time.perf_counter()
    eq3 = phase_eq3(torch, ops, dev, card, on_path)
    _line({"phase": "families_eq3", "tiles": eq3,
           "seconds": time.perf_counter() - t0, "card": card})
    t0 = time.perf_counter()
    reduced = phase_reduced_archs(torch, dev, card)
    _line({"phase": "families_reduced", "archs": reduced,
           "seconds": time.perf_counter() - t0, "card": card})
    t0 = time.perf_counter()
    g = phase_gemma2(torch, ops, ref, tcl, dev, card, on_path,
                     **(gemma or {}))
    torch.cuda.empty_cache()
    _line({"phase": "families_gemma2", **g,
           "seconds": time.perf_counter() - t0, "card": card})
    t0 = time.perf_counter()
    m = phase_moe(torch, dev, card, **(moe or {}))
    torch.cuda.empty_cache()
    _line({"phase": "families_moe", **m,
           "seconds": time.perf_counter() - t0, "card": card})
    _line({"phase": "families", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


# --------------------------------------------------------------------- #
# phase 14: the state-space families — zamba2 (Mamba2 SSD) and xlstm
# --------------------------------------------------------------------- #
def _scan_check(torch, cfg, params, toks):
    """Layer 0's chunked scan (the hybrid's ``ssd_chunked``, xLSTM's
    ``mlstm_cell_chunked``) on the embedded ``toks``, against its own
    per-token recurrence (the decode update, once a position): the rel
    of the outputs and of the final state, and each form's seconds."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm, xlstm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm

    h = model_lib._embed_in(cfg, params, {"tokens": toks}, torch.float32)
    g0 = tf.layer_slice(params["stack"]["groups"], 0)
    if cfg.family == "hybrid":
        x = rms_norm(h, g0["mamba_norm"][0], cfg.norm_eps)
        ops = ssm.ssd_inputs(tf.layer_slice(g0["mamba"], 0), cfg, x)[4:]
        forms = (lambda: ssm.ssd_chunked(*ops, STATE_CHUNK),
                 lambda: ssm.ssd_recurrence(*ops))
    else:
        ops = xlstm.mlstm_inputs(tf.layer_slice(g0["mlstm"], 0), cfg,
                                 h)[3:8]
        forms = (lambda: xlstm.mlstm_cell_chunked(*ops, None, STATE_CHUNK),
                 lambda: xlstm.mlstm_recurrence(*ops))
    outs, seconds = [], []
    for form in forms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(form())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    (y, state), (y_rec, state_rec) = outs
    res = {"op": "ssd_chunked" if cfg.family == "hybrid" else
           "mlstm_cell_chunked", "shape": list(toks.shape),
           "chunks": ssm.chunk_geometry(toks.shape[1], STATE_CHUNK),
           "y_rel": _rel(y, y_rec), "chunked_s": seconds[0],
           "recurrence_s": seconds[1]}
    if cfg.family == "hybrid":
        res["state_rel"] = _rel(state, state_rec)
    else:
        # C and n are stored scaled by exp(-m): compare them at the
        # recurrence's stabiliser
        C, n = xlstm.restabilise(state, state_rec[2])
        res["state_rel"] = max(_rel(C, state_rec[0]), _rel(n, state_rec[1]))
    _require(res["y_rel"] <= STATE_TOL and res["state_rel"] <= STATE_TOL,
             f"{cfg.name}: chunked scan vs its recurrence {res}")
    return res


def _state_consistency(torch, cfg, params, toks, new):
    """Prefill ``toks`` (B, S), ``new`` greedy decode steps, then one
    prefill of the S + ``new`` tokens: each step's logits against the
    long prefill's at the same position (rel < 0.02), and the greedy
    picks against its argmaxes. A pick may differ only where the long
    prefill's top two logits are closer than the logits compared may
    differ: within max(``STATE_TIE``, 2·max|decode − long|) at that
    step. (xLSTM's cache holds the mLSTM state ``C`` in bf16, as the
    reference's does, so its decode drifts from the f32 prefill by rel
    ~1e-3 a step; the hybrid's state is f32, and its band is
    ``STATE_TIE``'s or a few times it.) The count of picks that differ
    where the gap is above ``STATE_TIE`` alone is reported too."""
    from repro_torch.models import model as model_lib

    B, S = toks.shape
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(cfg, params, {"tokens": toks})
    steps_, picks = [logits], [logits.argmax(-1)]
    for i in range(new):
        logits, cache = model_lib.decode_step(
            cfg, params, cache, picks[-1][:, None], torch.tensor(S + i))
        steps_.append(logits)
        picks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    long = torch.cat([toks, torch.stack(picks[:new], 1)], 1)
    t0 = time.perf_counter()
    h, _, _ = model_lib.forward(cfg, params, {"tokens": long},
                                mode="prefill")
    want = model_lib._head(cfg, params, h[:, S - 1:])    # (B, new + 1, V)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    top2 = torch.topk(want, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                   # (B, new + 1)
    got = torch.stack(steps_, 1)
    band = torch.clamp(2 * (got - want).abs().amax(-1), min=STATE_TIE)
    differ = got.argmax(-1) != want.argmax(-1)
    res = {"prompt": [B, S], "decode_steps": new,
           "long_prefill": list(long.shape),
           "rel": [_rel(steps_[i], want[:, i]) for i in range(new + 1)],
           "tokens_differ": int(differ.sum()),
           "tokens_differ_outside_ties": int((differ &
                                              (gap >= STATE_TIE)).sum()),
           "tokens_differ_outside_band": int((differ & (gap >= band)).sum()),
           "differ_at": [{"lane": int(b), "step": int(i),
                          "gap": float(gap[b, i]), "band": float(band[b, i])}
                         for b, i in differ.nonzero().tolist()],
           "largest_band": float(band.max()),
           "smallest_top2_gap": float(gap.min()),
           "prefill_and_decodes_s": decode_s, "long_prefill_s": long_s}
    _require(bool(torch.isfinite(got).all()),
             f"{cfg.name}: non-finite logits")
    _require(max(res["rel"]) < 0.02 and
             res["tokens_differ_outside_band"] == 0,
             f"{cfg.name}: decode vs the long prefill {res}")
    return res


def _state_serving(torch, cfg, params, dev, prompts, new):
    """``Engine(slots=STATE_LANES, cache_len=STATE_CACHE)`` serving
    ``prompts`` × ``new`` tokens: each request's tokens against its own
    B = 1 ``prefill`` + ``decode_step`` greedy decode, whose cache is
    stored as an ``Engine`` lane stores it (``init_cache``'s dtypes, its
    ring) but never passes through ``kvcache``; steps/s and tokens/s
    (median of ``SERVE_DRAINS`` drains after a warm-up), a decode
    step's wall, busy time and kernels, peak CUDA memory."""
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import tree_map
    from repro_torch.serving import Engine, Request

    gen = torch.Generator().manual_seed(53)
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in prompts]
    like = model_lib.init_cache(cfg, 1, STATE_CACHE, device=dev)
    ring = min(STATE_CACHE, cfg.sliding_window or STATE_CACHE)
    oracle = {}
    for uid, p in enumerate(reqs):
        logits, cache = model_lib.prefill(cfg, params, {"tokens": [p]})
        cache = tree_map(lambda a, b: a.to(b.dtype),
                         _grow_ring(torch, cfg, cache, ring), like)
        toks = [int(logits.argmax(-1))]
        for i in range(new - 1):
            logits, cache = model_lib.decode_step(
                cfg, params, cache, torch.tensor([[toks[-1]]], device=dev),
                torch.tensor(len(p) + i))
            toks.append(int(logits.argmax(-1)))
        oracle[uid] = toks
    del like, cache
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(1 + SERVE_DRAINS):      # the first drain warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = _lm_drain(Engine(cfg, params, slots=STATE_LANES,
                               cache_len=STATE_CACHE), reqs,
                        lambda uid, p: Request(uid=uid, prompt=p,
                                               max_new_tokens=new))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append((eng.steps / wall, len(reqs) * new / wall))
        got = {st.request.uid: st.generated for st in eng.finished}
        _require(got == oracle, f"{cfg.name} Engine: tokens differ from "
                                f"each request's own greedy decode: "
                                f"{_first_divergence(got, oracle)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    cache = model_lib.init_cache(cfg, STATE_LANES, STATE_CACHE, device=dev)
    dcfg = cfg.replace(decode_per_slot=True)
    step_tok = torch.tensor([[reqs[i % len(reqs)][0]]
                             for i in range(STATE_LANES)], device=dev)
    step_pos = torch.tensor([8, 17, 30, 47][:STATE_LANES],
                            dtype=torch.int32, device=dev)
    decode = lambda: model_lib.decode_step(  # noqa: E731
        dcfg, params, cache, step_tok, step_pos)
    ms = _time_ms(torch, decode, iters=5)
    return {"lanes": STATE_LANES, "cache_len": STATE_CACHE,
            "requests": len(reqs), "new_tokens": new,
            "prompt_lengths": list(prompts), "steps": eng.steps,
            "tokens_equal_own_greedy": True,
            "drains_steps_per_s": [a for a, _ in rates[1:]],
            "warm_up_steps_per_s": rates[0][0],
            "steps_per_s": _quartiles([a for a, _ in rates[1:]])[0],
            "tokens_per_s": _quartiles([b for _, b in rates[1:]])[0],
            "peak_cuda_memory_bytes": peak,
            "decode_step": {"ms": ms, **_busy(torch, decode, ms, n=2)}}


def phase_state_model(torch, dev, card, cfg, scan_len, batch,
                      new=STATE_NEW, prompts=STATE_PROMPTS,
                      serve_new=STATE_NEW):
    """(b)/(c) one state-space model at its published width (seed-0
    weights on the card, f32 compute): ``_scan_check`` on a
    ``scan_len``-token prompt, ``_state_consistency`` on a ``batch``
    prefill and ``new`` greedy decodes, ``_state_serving``."""
    from repro_torch.models import model as model_lib

    cfg = cfg.replace(compute_dtype="float32")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out = {"config": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "param_bytes": 4 * cfg.param_count(),
           "init_s": time.perf_counter() - t0}
    gen = torch.Generator().manual_seed(59)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, scan_len),
                             generator=gen).to(dev)
        out["scan"] = _scan_check(torch, cfg, params, toks)
        toks = torch.randint(0, cfg.vocab_size, batch, generator=gen).to(dev)
        out["consistency"] = _state_consistency(torch, cfg, params, toks, new)
        out["serving"] = _state_serving(torch, cfg, params, dev, prompts,
                                        serve_new)
    return out


def phase_state_train(torch, dev, card, hybrid_args=None, ssm_args=None,
                      resume_at=SSM_RESUME_AT):
    """(d) both models trained at their published widths through
    ``repro_torch.launch.train`` (the configs' bf16 compute, remat,
    grad_accum; AdamW) at ``HYBRID_/SSM_TRAIN_LAYERS`` of their 38 and
    24 layers: zamba2 with no checkpoint, xlstm checkpointed every 2
    steps in a temporary directory, stopped after its
    step-``resume_at`` checkpoint and resumed, equal to the straight run
    to the bit (with deterministic algorithms only if it is not). Each
    step's loss and wall, one more step's busy time and kernels, peak
    CUDA memory; xlstm's checkpoint seconds and bytes."""
    import shutil

    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import train_loop

    def profiled_step(kit, params, opt_state, step):
        batch = kit["pipeline"].batch(step)
        one = lambda: kit["train_step"](params, opt_state, batch)  # noqa
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        return {"wall_ms": wall_ms, **_busy(torch, one, wall_ms, n=1)}

    def summary(cfg, args, recs, peak):
        return {"config": cfg.name, "layers": cfg.num_layers,
                "d_model": cfg.d_model, "params": cfg.param_count(),
                "remat": cfg.remat, "compute_dtype": cfg.compute_dtype,
                "grad_accum": cfg.grad_accum, "args": args,
                "steps": [{k: r[k] for k in ("step", "loss", "accuracy",
                                              "grad_norm", "lr",
                                              "step_time_s")}
                          for r in recs],
                "peak_cuda_bytes": peak}

    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_state_train_")
    try:
        # zamba2: the launcher's setup and loop, no checkpoint
        args = list(hybrid_args or HYBRID_TRAIN_ARGS) + [
            "--log-every", "1", "--ckpt-dir", os.path.join(root, "hybrid")]
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _launcher_depth(HYBRID_TRAIN_LAYERS):
            run = launch_train.setup(launch_train.parse_args(args))
        res = train_loop.run(run["loop"], train_step=run["train_step"],
                             params=run["params"],
                             opt_state=run["opt_state"],
                             pipeline=run["pipeline"])
        peak = torch.cuda.max_memory_allocated() if cuda else None
        losses = [r["loss"] for r in res["metrics"]]
        _require(all(map(math.isfinite, losses)),
                 f"{run['cfg'].name} training: losses {losses}")
        out["hybrid"] = {**summary(run["cfg"], args, res["metrics"], peak),
                         "profiled_step": profiled_step(
                             run, res["params"], res["opt_state"],
                             run["loop"].total_steps),
                         "seconds": time.perf_counter() - t0}
        _line({"phase": "state_space_train_hybrid", **out["hybrid"],
               "card": card})
        del run, res
        torch.cuda.empty_cache()

        # xlstm: straight, then stopped after a checkpoint and resumed
        args = list(ssm_args or SSM_TRAIN_ARGS) + ["--log-every", "1"]
        io = []
        real = ckpt_lib.save, ckpt_lib.restore
        ckpt_lib.save, ckpt_lib.restore = _timed_ckpt_io(torch, ckpt_lib,
                                                         io)
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "ssm"))
        try:
            with _launcher_depth(SSM_TRAIN_LAYERS):
                (straight, resumed, peak, recs, recs_b, _, kit, rel, equal,
                 deterministic) = _resumed_legs(
                    torch, launch_train, train_loop, args,
                    os.path.join(root, "ssm"), 0.0, resume_at)
        finally:
            ckpt_lib.save, ckpt_lib.restore = real
        _require(resumed["resumed_from"] == resume_at and equal,
                 f"xlstm resumed from {resumed['resumed_from']}, vs the "
                 f"straight run rel {rel:.3g}, equal to the bit: {equal}")
        losses = [r["loss"] for r in recs]
        _require(all(map(math.isfinite, losses)),
                 f"{kit['cfg'].name} training: losses {losses}")
        total = launch_train.parse_args(args).steps
        out["ssm"] = {**summary(kit["cfg"], args, recs, peak),
                      "resumed_leg_steps": [r["step"] for r in recs_b],
                      "checkpoint_io": io, "resume_rel": rel,
                      "resume_bit_equal": equal,
                      "deterministic_algorithms_needed": deterministic,
                      "profiled_step": profiled_step(
                          kit, resumed["params"], resumed["opt_state"],
                          total),
                      "seconds": time.perf_counter() - t0}
        _line({"phase": "state_space_train_ssm", **out["ssm"],
               "card": card})
        del straight, resumed, kit
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def phase_state_space(torch, ops, dev, card, hybrid=None, ssm=None,
                      train=None):
    """Phase 14: (a) ``phase_reduced_archs`` on the two state-space
    archs, (b) zamba2-1.2b and (c) xlstm-350m at their published widths
    (``phase_state_model``), (d) both trained (``phase_state_train``).
    ``hybrid``/``ssm``/``train`` are keyword overrides of (b), (c) and
    (d) (the CPU rehearsal passes reduced configs and short runs).
    Returns the phase's kernel launches (none: the scans, cells and
    convs are plain PyTorch, as the reference's are plain jnp)."""
    from repro_torch.configs import xlstm_350m, zamba2_1p2b

    t_phase = time.perf_counter()
    before = ops.launch_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reduced = phase_reduced_archs(torch, dev, card, archs=STATE_ARCHS)
    _line({"phase": "state_space_reduced", "archs": reduced,
           "seconds": time.perf_counter() - t0, "card": card})
    for name, cfg, kw in (
            ("hybrid", zamba2_1p2b.CONFIG,
             dict(scan_len=HYBRID_SCAN, batch=HYBRID_BATCH)),
            ("ssm", xlstm_350m.CONFIG,
             dict(scan_len=SSM_SCAN, batch=SSM_BATCH))):
        kw.update((hybrid if name == "hybrid" else ssm) or {})
        t0 = time.perf_counter()
        res = phase_state_model(torch, dev, card, kw.pop("cfg", cfg), **kw)
        torch.cuda.empty_cache()
        _line({"phase": f"state_space_{name}", **res,
               "seconds": time.perf_counter() - t0, "card": card})
    phase_state_train(torch, dev, card, **(train or {}))
    path = _deltas(ops.launch_counts(), before)
    _line({"phase": "state_space", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


# --------------------------------------------------------------------- #
# phase 15: the training substrate's parallelism across ranks
# --------------------------------------------------------------------- #
def _par_optimizer(steps):
    """The launcher's AdamW and cosine schedule, with eps 1e-4: Adam
    divides each gradient by its root mean square plus eps, and at the
    default 1e-8 the reduction-order noise of ~1e-8-sized gradients
    becomes ±lr steps (ROADMAP "Parity traps")."""
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    return AdamW(lr=cosine_schedule(PAR_LR, max(steps // 20, 1), steps),
                 eps=PAR_EPS)


def _par_config(spec):
    from repro_torch.configs import get_config, get_reduced
    cfg = get_reduced(spec["arch"]) if spec["reduced"] else \
        get_config(spec["arch"])
    return cfg.replace(**spec.get("overrides", {}))


def _par_pipeline(cfg, spec):
    from repro_torch.data.pipeline import TokenPipeline
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"],
                         global_batch=spec["global_batch"], seed=0)


def _par_reference(torch, spec, compute_dtype, dev, out_dir=None):
    """One process's ``spec["steps"]`` steps of the job on ``dev``: the
    losses and step walls, and (with ``out_dir``) the final parameters
    written there as one ``.npy`` a leaf, then freed."""
    import numpy as np

    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten_with_path
    from repro_torch.train import steps as steps_lib

    cfg = _par_config(spec).replace(compute_dtype=compute_dtype)
    opt = _par_optimizer(spec["steps"])
    pipe = _par_pipeline(cfg, spec)
    params = model_lib.init_params(cfg, 0, device=dev)
    state = opt.init(params)
    step, accum = steps_lib.make_train_step(
        cfg, opt, global_batch=spec["global_batch"])
    losses, walls = [], []
    for i in range(spec["steps"]):
        t0 = time.perf_counter()
        params, state, m = step(params, state, pipe.batch(i))
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    if out_dir is not None:
        for i, (_, leaf) in enumerate(flatten_with_path(params)):
            np.save(os.path.join(out_dir, f"{i}.npy"),
                    leaf.detach().cpu().numpy())
    del params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_walls_s": walls, "accum": accum}


class _Collectives:
    """``torch.distributed``'s ``names`` (by default ``all_reduce`` and
    ``all_gather_into_tensor``) wrapped to add each call's seconds
    (synchronised on both sides: the tensor's card, else ``dev`` when
    it is one) and bytes (the tensor's) while ``on``."""

    def __init__(self, torch, dist,
                 names=("all_reduce", "all_gather_into_tensor"), dev=None):
        self.torch, self.dist, self.on, self.dev = torch, dist, False, dev
        self.seconds, self.bytes, self.calls = 0.0, 0, 0
        self.real = {n: getattr(dist, n) for n in names}
        for name, fn in self.real.items():
            setattr(dist, name, self._wrap(fn))

    def _wrap(self, fn):
        def timed(tensor, *args, **kw):
            if not self.on:
                return fn(tensor, *args, **kw)
            src = args[0] if fn is self.real.get("all_gather_into_tensor") \
                else tensor
            self._sync(src)
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kw)
            self._sync(src)
            self.seconds += time.perf_counter() - t0
            self.bytes += src.numel() * src.element_size()
            self.calls += 1
            return out
        return timed

    def _sync(self, t):
        dev = t.device if t.device.type == "cuda" else self.dev
        if dev is not None and dev.type == "cuda":
            self.torch.cuda.synchronize(dev)

    def take(self):
        out = {"seconds": self.seconds, "bytes": self.bytes,
               "calls": self.calls}
        self.seconds, self.bytes, self.calls = 0.0, 0, 0
        return out

    def close(self):
        for name, fn in self.real.items():
            setattr(self.dist, name, fn)


def _par_dp_leg(torch, spec, compute_dtype, dev, col, ref_dir=None):
    """This rank's leg of the data-parallel job
    (``steps.make_dp_train_step``: replicated parameters, each rank its
    rows of every microbatch, the f32 gradient sums all-reduced over
    gloo on the card's tensors): each step's loss, wall and collective
    seconds and bytes; with ``ref_dir`` the final parameters against
    the one process's, leaf by leaf; then one more step under the
    profiler for busy time and kernels."""
    import numpy as np

    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten_with_path
    from repro_torch.train import steps as steps_lib

    cfg = _par_config(spec).replace(compute_dtype=compute_dtype)
    opt = _par_optimizer(spec["steps"])
    pipe = _par_pipeline(cfg, spec)
    params = model_lib.init_params(cfg, 0, device=dev)
    state = opt.init(params)
    step, accum = steps_lib.make_dp_train_step(
        cfg, opt, global_batch=spec["global_batch"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    for i in range(spec["steps"]):
        col.on = True
        t0 = time.perf_counter()
        params, state, m = step(params, state, pipe.batch(i))
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        col.on = False
        rows.append({"loss": loss, "wall_s": wall, **{
            f"collective_{k}": v for k, v in col.take().items()}})
    out = {"steps": rows, "accum": accum}
    if ref_dir is not None:
        worst, big, diff = 0.0, 0.0, 0.0
        worst_leaf = None
        for i, (path, leaf) in enumerate(flatten_with_path(params)):
            want = torch.from_numpy(np.load(os.path.join(
                ref_dir, f"{i}.npy"))).to(dev)
            d = float((leaf.double() - want.double()).abs().max())
            b = float(want.abs().max())
            diff, big = max(diff, d), max(big, b)
            if d / max(b, 1e-12) > worst:
                worst, worst_leaf = d / max(b, 1e-12), path
            del want
        out.update(params_rel=diff / big, worst_leaf_rel=worst,
                   worst_leaf=worst_leaf)
    if on_card:
        out["peak_cuda_bytes"] = torch.cuda.max_memory_allocated(dev)
        state_box = [params, state]

        def one():
            state_box[0], state_box[1], _ = step(
                state_box[0], state_box[1], pipe.batch(spec["steps"]))

        wall_ms = 1e3 * min(r["wall_s"] for r in rows[1:] or rows)
        out["profiled_step"] = _busy(torch, one, wall_ms, n=1)
        del state_box
    del params, state
    if on_card:
        torch.cuda.empty_cache()
    return out


def _par_psum_leg(torch, spec, dev, col):
    """``compressed_psum`` at the full gradient tree's shapes between
    the ranks: each rank its own seeded gradients a step (different on
    every rank), ``spec["psum_steps"]`` steps of error feedback; at the
    first step (no error yet) each leaf's compressed mean against the
    plain ``all_reduce`` mean (within ``scale_shared / 2`` and f32
    rounding), and over all steps the summed means against the summed
    plain means (within the largest step's bound: what is left is the
    last step's error), with each reduction's seconds."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import grad_compression as gc
    from repro_torch.pytree import leaves

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = mesh_lib.make_mesh((world,), ("data",), device=dev)
    cfg = _par_config(spec)
    shapes = [tuple(x.shape) for x in leaves(
        model_lib.init_params(cfg, 0, device="meta"))]
    n = sum(math.prod(s) for s in shapes)
    error = [torch.zeros(s, device=dev) for s in shapes]
    sum_c = [torch.zeros(s, device=dev) for s in shapes]
    sum_p = [torch.zeros(s, device=dev) for s in shapes]
    worst_miss, bound_max, rows = 0.0, 0.0, []
    for t in range(spec["psum_steps"]):
        gen = torch.Generator(device=dev).manual_seed(1000 * t + rank)
        grads = [torch.randn(s, generator=gen, device=dev) *
                 (1.0 + rank) for s in shapes]
        scales = torch.stack([(g + e).abs().max().clamp(min=1e-12) / 127.0
                              for g, e in zip(grads, error)])
        dist.all_reduce(scales, op=dist.ReduceOp.MAX)
        plain = [g.clone() for g in grads]
        col.on = True
        for p in plain:
            dist.all_reduce(p)
        plain_c = col.take()
        mean, error = gc.compressed_psum(mesh, ("data",), grads, error)
        comp_c = col.take()
        col.on = False
        for i, (m, p, s) in enumerate(zip(mean, plain, scales.tolist())):
            p.div_(world)
            if t == 0:      # no error fed back yet: one reduction's bound
                miss = float((m - p).abs().max())
                worst_miss = max(worst_miss, miss / (s / 2))
                _require(miss <= s / 2 * (1 + 1e-5) + 1e-6,
                         f"compressed mean off the plain mean by "
                         f"{miss:.3g} at leaf {i} (scale {s:.3g})")
            sum_c[i].add_(m)
            sum_p[i].add_(p)
            bound_max = max(bound_max, s / 2)
        del grads, plain, mean
        rows.append({"plain": plain_c, "compressed": comp_c})
    drift = max(float((a - b).abs().max()) for a, b in zip(sum_c, sum_p))
    _require(drift <= bound_max * (1 + 1e-5) + 1e-5,
             f"error feedback: Σ compressed off Σ plain by {drift:.3g} "
             f"(one step's bound {bound_max:.3g})")
    del error, sum_c, sum_p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"elements": n, "leaves": len(shapes), "steps": rows,
            "sum_drift": drift, "one_step_bound": bound_max,
            "first_step_worst_miss_over_half_scale": worst_miss,
            # per rank and step, bytes sent + received, counted from the
            # algorithms (not measured): int8 all-gather n·W; a ring
            # all-reduce of f32 2·(W−1)/W·4n each way
            "wire_bytes_compressed": n * world,
            "wire_bytes_plain": 2 * 2 * (world - 1) * 4 * n // world}


def _parallel_worker(spec) -> int:
    """One rank of phase 15, started by ``launch_local_fleet``: joins the
    gloo group, runs the data-parallel legs (f32, then the config's own
    compute dtype) and the compressed reduction, and prints one JSON
    line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh_lib.init_fleet_group(PAR_GROUP_TIMEOUT_S)
    dev = mesh_lib.rank_device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    col = _Collectives(torch, dist)
    out = {"rank": rank, "device": str(dev)}
    try:
        out["f32"] = _par_dp_leg(torch, spec, "float32", dev, col,
                                 ref_dir=spec["ref_dir"])
        out["own_dtype"] = _par_dp_leg(torch, spec, spec["own_dtype"], dev,
                                       col)
        out["psum"] = _par_psum_leg(torch, spec, dev, col)
        out["ok"] = True
    except SmokeFailure as exc:
        out.update(ok=False, error=str(exc))
    finally:
        col.close()
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if out["ok"] else 1


def phase_parallel(torch, ops, dev, card, spec=None):
    """Phase 15: the training substrate's parallelism on PAR_RANKS ranks
    sharing the card (``launch_local_fleet``: fresh interpreters, one
    gloo group through a ``file://`` store, a supervisor timeout).
    (a) qwen1.5-0.5B at full width: one process's PAR_SPEC job on the
    card first (f32 compute, then the config's bf16), its results kept
    as host numpy and its memory freed; then the ranks run it as data
    parallelism with replicated parameters — the form the first card
    call decided (gloo's functional collectives, which DTensor issues,
    crash on CUDA tensors; its ``all_reduce`` and
    ``all_gather_into_tensor`` work; phase 17 runs the DTensor form
    over the staged group) — and each rank's f32 losses and
    final parameters are held to the one process's at PAR_TOL, its
    bf16 losses at PAR_BF16_TOL; (b) ``compressed_psum`` at qwen's full
    gradient tree between the ranks, with different seeded gradients
    on each. ``spec`` overrides PAR_SPEC (the CPU rehearsal passes a
    reduced one).
    Returns the phase's kernel launches (none: the dense training path
    and the reductions are plain PyTorch and gloo, as the reference's
    are plain jnp and XLA collectives)."""
    import shutil

    from repro_torch.launch import simdev

    spec = dict(PAR_SPEC, **(spec or {}))
    spec["device"] = None if dev.type == "cuda" else str(dev)
    spec.setdefault("own_dtype", _par_config(spec).compute_dtype)
    t_phase = time.perf_counter()
    before = ops.launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        spec["ref_dir"] = os.path.join(root, "ref")
        os.makedirs(spec["ref_dir"])
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        one = {"f32": _par_reference(torch, spec, "float32", dev,
                                     spec["ref_dir"]),
               "own_dtype": _par_reference(torch, spec, spec["own_dtype"],
                                           dev)}
        if dev.type == "cuda":
            one["peak_cuda_bytes"] = torch.cuda.max_memory_allocated()
        ref_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = simdev.launch_local_fleet(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--parallel-worker", json.dumps(spec)], PAR_RANKS,
            timeout=PAR_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        workers = []
        for r in res:
            try:
                workers.append(simdev.last_json_line(r.stdout))
            except ValueError:
                workers.append({"rank": r.rank, "ok": False,
                                "error": r.stderr_tail})
        bad = [w for w in workers if not w.get("ok")]
        _require(not bad, f"parallel ranks: {json.dumps(bad)[:2000]}")
        rows = []
        for w in workers:
            got = [s["loss"] for s in w["f32"]["steps"]]
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(got, one["f32"]["losses"])]
            _require(max(rel) <= PAR_TOL and
                     w["f32"]["params_rel"] <= PAR_TOL,
                     f"rank {w['rank']} f32: losses {got} vs "
                     f"{one['f32']['losses']}, params rel "
                     f"{w['f32']['params_rel']:.3g}")
            own = [s["loss"] for s in w["own_dtype"]["steps"]]
            own_rel = [abs(a - b) / abs(b) for a, b in
                       zip(own, one["own_dtype"]["losses"])]
            _require(max(own_rel) <= PAR_BF16_TOL and
                     all(map(math.isfinite, own)),
                     f"rank {w['rank']} {spec['own_dtype']}: losses {own} "
                     f"vs {one['own_dtype']['losses']}")
            rows.append({"rank": w["rank"], "f32_loss_rel": rel,
                         "own_dtype_loss_rel": own_rel, **w})
        _line({"phase": "parallel_dp", "config": spec["arch"],
               "reduced": spec["reduced"], "ranks": PAR_RANKS,
               "on": "one card" if dev.type == "cuda" else str(dev),
               "form": "B: replicated parameters, gradients all-reduced",
               "global_batch": spec["global_batch"],
               "seq_len": spec["seq_len"], "steps": spec["steps"],
               "own_dtype": spec["own_dtype"], "tol": PAR_TOL,
               "own_dtype_tol": PAR_BF16_TOL, "one_process": one,
               "one_process_seconds": ref_s,
               "ranks_seconds": ranks_s,
               "workers": [{k: v for k, v in r.items() if k != "psum"}
                           for r in rows], "card": card})
        _line({"phase": "parallel_psum", "ranks": PAR_RANKS,
               "workers": [{"rank": w["rank"], **w["psum"]}
                           for w in workers], "card": card})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path = _deltas(ops.launch_counts(), before)
    _line({"phase": "parallel", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


# --------------------------------------------------------------------- #
# phase 16: the launch tools
# --------------------------------------------------------------------- #
def _launch_config(spec):
    from repro_torch.configs import get_config, get_reduced

    return (get_reduced if spec["reduced"] else get_config)(spec["arch"])


def _predict(cfg, shape):
    """The dry run of one step on one position (``mesh=None``: the
    one-process step, nothing placed): the prediction held against
    the card."""
    from repro_torch.launch import dryrun

    r = dryrun.lower_cell(cfg, shape, None, verbose=False)
    return {"peak_bytes": r["memory"]["peak_bytes_per_device"],
            "state_bytes": r["memory"]["state_bytes"],
            "flops": r["cost"]["flops_per_device"],
            "bytes": r["cost"]["bytes_per_device"],
            "bound_s": r["roofline"]["bound_s"],
            "dominant": r["roofline"]["dominant"],
            "model_flops": r["model_flops"],
            "useful_flops_frac": r["useful_flops_frac"],
            "run_s": r["compile_s"]}


def _measure(torch, dev, make_args, step):
    """One call of ``step`` on ``dev`` after a warm-up call on arguments
    of its own (which leaves the libraries' workspaces allocated): its
    wall, the peak of the memory allocated from before its arguments
    (``make_args``) were made, and the card's busy time over a third
    call."""
    out = step(*make_args())
    del out
    before = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
    args = make_args()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"wall_ms": wall_ms}
    if dev.type == "cuda":
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - before
        del out
        row.update(_busy(torch, lambda: step(*args), wall_ms, n=1))
    return row


def _launch_predicted_vs_measured(torch, spec, dev):
    """(a): the dry run's peak, FLOPs and bound of a train step and a
    decode step, then the steps on ``dev``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train import steps as steps_lib

    cfg = _launch_config(spec)
    B, S = spec["global_batch"], spec["seq_len"]
    lanes, cache_len = spec["decode_lanes"], spec["decode_cache"]
    pred = {"train": _predict(cfg, ShapeConfig("phase16_train", S, B,
                                               "train")),
            "decode": _predict(cfg, ShapeConfig("phase16_decode", cache_len,
                                                lanes, "decode"))}
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
    train, accum = steps_lib.make_train_step(cfg, opt, global_batch=B)
    batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, seed=0).batch(0)

    def train_args():
        params = model_lib.init_params(cfg, 0, device=dev)
        return params, opt.init(params), batch

    meas = {"train": _measure(torch, dev, train_args, train)}
    decode = steps_lib.make_decode_step(cfg)

    def decode_args():
        return (model_lib.init_params(cfg, 0, device=dev),
                model_lib.init_cache(cfg, lanes, cache_len, device=dev),
                torch.zeros((lanes, 1), dtype=torch.int32, device=dev),
                torch.tensor(cache_len // 2, dtype=torch.int32, device=dev))

    meas["decode"] = _measure(torch, dev, decode_args, decode)
    rows = {}
    for k in ("train", "decode"):
        p, m = pred[k], meas[k]
        row = {"predicted": p, "measured": m}
        _require(0.0 < p["useful_flops_frac"] <= 1.0,
                 f"phase 16(a) {k}: useful FLOP share "
                 f"{p['useful_flops_frac']}")
        if dev.type == "cuda":
            row["peak_rel"] = (p["peak_bytes"] - m["peak_bytes"]) / \
                m["peak_bytes"]
            _require(abs(row["peak_rel"]) <= LAUNCH_PEAK_TOL,
                     f"phase 16(a) {k}: predicted peak {p['peak_bytes']} B "
                     f"vs measured {m['peak_bytes']} B")
            busy = m["device_busy_ms"]
            _require(busy != "not measured" and
                     p["bound_s"] * 1e3 <= busy,
                     f"phase 16(a) {k}: bound {p['bound_s'] * 1e3} ms vs "
                     f"busy {busy} ms")
            row["bound_over_busy"] = p["bound_s"] * 1e3 / busy
        rows[k] = row
    rows["train"]["accum"] = accum
    return rows


def _launch_sweep(spec, out_dir):
    """(b): every reduced arch × shape on the production meshes, one
    dry-run process an (arch, mesh) (the fake group is a process's),
    as many at a time as the host has cores."""
    import subprocess as sp

    from repro_torch.configs import ARCH_IDS

    archs = spec["sweep_archs"] or ARCH_IDS
    jobs = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", spec["sweep_shapes"], "--mesh", m, "--reduced",
             "--out", out_dir] for a in archs for m in spec["sweep_meshes"]]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    width = max(1, min(len(jobs), os.cpu_count() or 1))
    running, failed = [], []
    while jobs or running:
        while jobs and len(running) < width:
            argv = jobs.pop(0)
            running.append((argv, sp.Popen(argv, cwd=ROOT, env=env,
                                           stdout=sp.PIPE, stderr=sp.PIPE,
                                           text=True)))
        argv, proc = running.pop(0)
        try:
            _, err = proc.communicate(timeout=LAUNCH_SWEEP_TIMEOUT_S)
        except sp.TimeoutExpired:
            proc.kill()
            proc.communicate()
            err = "timed out"
        if proc.returncode != 0:
            failed.append((argv[4], argv[8], err[-1500:]))
    cells = [json.load(open(os.path.join(out_dir, f)))
             for f in sorted(os.listdir(out_dir)) if f.endswith(".json")]
    return cells, failed


def _check_sweep(cells, failed):
    from repro_torch.configs import SHAPES_BY_NAME, applicable, get_reduced

    _require(not failed, f"phase 16(b): dry-run processes failed: "
                         f"{failed}")
    for c in cells:
        ok, reason = applicable(get_reduced(_arch_id(c["arch"])),
                                SHAPES_BY_NAME[c["shape"]])
        if c["status"] == "skip":
            _require(not ok and c["reason"] == reason,
                     f"phase 16(b): {c['arch']} {c['shape']} skipped: "
                     f"{c.get('reason')}")
        else:
            _require(c["status"] == "ok", f"phase 16(b): {c['arch']} "
                     f"{c['shape']} {c['mesh']}: {c.get('error')}")
    for arch in ("qwen1.5-0.5b", "moonshot-v1-16b-a3b"):
        with open(os.path.join(ROOT, "experiments", "dryrun",
                               f"{arch}__train_4k__single.json")) as f:
            want = json.load(f)
        got = [c for c in cells if c["status"] == "ok" and
               c["shape"] == "train_4k" and c["mesh"] == "16x16" and
               _arch_id(c["arch"]) == arch]
        _require(len(got) == 1, f"phase 16(b): no {arch} train_4k cell")
        _require(got[0]["model_flops"] == want["model_flops"] and
                 got[0]["cost"]["bytes_per_device"] ==
                 want["cost"]["bytes_per_device"],
                 f"phase 16(b): {arch}: model_flops "
                 f"{got[0]['model_flops']} vs {want['model_flops']}, "
                 f"bytes {got[0]['cost']['bytes_per_device']} vs "
                 f"{want['cost']['bytes_per_device']}")


def _arch_id(name):
    """A registry id from a config's name (a reduced config is named
    ``<family>-smoke``)."""
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced

    for a in ARCH_IDS:
        if name in (a, get_config(a).name, get_reduced(a).name):
            return a
    raise KeyError(name)


def _pipe_config(spec):
    cfg = _launch_config(spec).replace(compute_dtype="float32")
    if spec["pipe_layers"]:
        cfg = cfg.replace(num_layers=spec["pipe_layers"])
    return cfg


def _pipe_layers(torch, cfg, layers, dev):
    """Blocks ``layers`` of ``init_params(cfg, 0)``'s stack, drawn on
    their own from the same seed streams (nothing else is built)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tf

    def gen(layer, leaf):
        return torch.Generator(device=dev).manual_seed(
            model_lib.stream_seed(0, model_lib._STACK, layer, leaf))

    return tf._stack_trees([tf._block_init(
        lambda i, _l=layer: gen(_l, i), cfg, dev) for layer in layers])


def _pipe_blocks(cfg, p, h, first_layer):
    """The dense stack's blocks of ``p`` over h (B, S, d), in order,
    each rematerialised as ``cfg.remat`` says (``DenseStack.apply``'s
    arithmetic)."""
    import torch

    from repro_torch.models import transformer as tf

    B, S = h.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=h.device)[None] \
        .expand(B, S)
    windows = tf._layer_windows(cfg)
    for i in range(p["attn_norm"].shape[0]):
        def block(h, p_l=tf.layer_slice(p, i), w=windows[first_layer + i]):
            return tf._block_apply(p_l, cfg, h, positions=pos, mode="train",
                                   cache=None, window=w)[0]
        h = tf._remat(block, cfg, "train")(h)
    return h


def _pipe_input(torch, cfg, spec, dev):
    g = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    return torch.randn((spec["global_batch"], spec["seq_len"], cfg.d_model),
                       generator=g, device=dev, dtype=torch.float32)


def _pipe_batch(torch, cfg, spec, dev):
    from repro_torch.data.pipeline import TokenPipeline

    b = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"],
                      global_batch=spec["global_batch"], seed=0).batch(0)
    return {k: v.to(dev) for k, v in b.items()}


def _pipe_held(torch, cfg, layers, dev):
    """What a pipeline rank holds of ``init_params(cfg, 0)``: the
    embedding table (and an untied head) and the final norm,
    replicated, and blocks ``layers`` of the stack; each leaf drawn on
    its own from ``init_params``'s seed streams."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import dense_init, embed_init, pdtype

    def gen(*words):
        return torch.Generator(device=dev).manual_seed(
            model_lib.stream_seed(0, *words))

    dt = pdtype(cfg)
    held = {"embed": {"table": embed_init(
                gen(model_lib._EMBED), (cfg.padded_vocab, cfg.d_model), dt,
                device=dev)},
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "stack": _pipe_layers(torch, cfg, layers, dev)}
    if not cfg.tie_embeddings:
        held["lm_head"] = {"w": dense_init(
            gen(model_lib._HEAD), (cfg.d_model, cfg.padded_vocab), dt,
            device=dev)}
    return held


def _pipe_loss(cfg, held, layers, batch, mesh, microbatches, stats):
    """A rank's loss of the pipelined model, the same on every rank and
    ``loss_fn``'s arithmetic: the replicated embedding, blocks
    ``layers`` as this rank's stage of ``pipeline_apply``, then the
    replicated final norm, head and cross-entropy of its replicated
    output."""
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import cdtype, cross_entropy, rms_norm

    h = model_lib._embed_in(cfg, held, batch, cdtype(cfg))
    h = pipeline_apply(lambda p, h: _pipe_blocks(cfg, p, h, layers[0]),
                       held["stack"], h, mesh=mesh, axis="pod",
                       microbatches=microbatches, stats=stats)
    h = rms_norm(h, held["final_norm"], cfg.norm_eps)
    loss, _ = cross_entropy(model_lib._head(cfg, held, h), batch["labels"],
                            cfg.vocab_size)
    return loss


def _pipe_step(torch, cfg, opt, held, state, batch, layers, mesh,
               microbatches, stats, sync):
    """One pipelined train step of this rank: the loss, the gradients of
    what it holds (its stage's blocks; the replicated leaves whole), and
    one ``opt`` step on them, clipped by the global gradient norm as one
    process's ``opt.update`` clips (the blocks' squares summed over the
    ranks, the replicated leaves' counted once). Returns (loss,
    gradients, new held, new state, the forward, backward and update
    walls)."""
    import torch.distributed as dist

    from repro_torch.pytree import leaves, tree_map, unflatten_like

    def sumsq(tree):
        return torch.stack([torch.square(g.to(torch.float32)).sum()
                            for g in leaves(tree)]).sum()

    live = tree_map(lambda p: p.detach().requires_grad_(True), held)
    t0 = time.perf_counter()
    loss = _pipe_loss(cfg, live, layers, batch, mesh, microbatches, stats)
    sync()
    t1 = time.perf_counter()
    grads = unflatten_like(held, list(torch.autograd.grad(
        loss, leaves(live))))
    sync()
    t2 = time.perf_counter()
    scaled = grads
    if opt.clip_norm:
        blocks = sumsq(grads["stack"]).cpu()
        dist.all_reduce(blocks, group=mesh.get_group("pod"))
        gnorm = torch.sqrt(blocks.to(loss.device) + sumsq(
            {k: v for k, v in grads.items() if k != "stack"}))
        scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
        scaled = tree_map(lambda g: g * scale, grads)
    new, state, _ = dataclasses.replace(opt, clip_norm=0.0).update(
        scaled, state, held)
    del scaled
    sync()
    walls = {"forward_s": t1 - t0, "backward_s": t2 - t1,
             "update_s": time.perf_counter() - t2}
    return loss.detach(), grads, new, state, walls


def _leaf_file(path):
    """``['stack']['attn']['wq']`` → ``stack.attn.wq.npy``."""
    return path.strip("[]'").replace("']['", ".") + ".npy"


def _pipe_compare(torch, ref_dir, tree, layers, dev):
    """``tree`` against the one process's leaves under ``ref_dir`` (the
    stack's at ``layers``): ``rel``, the max over leaves of each leaf's
    rel (``_tree_rel``'s), its ``worst`` leaf, and ``tree_rel``, the
    largest difference over the largest magnitude in the tree (phase
    15's ``params_rel``)."""
    import numpy as np

    from repro_torch.pytree import flatten_with_path

    worst, where, diff, big = 0.0, None, 0.0, 0.0
    for path, leaf in flatten_with_path(tree):
        want = np.load(os.path.join(ref_dir, _leaf_file(path)),
                       mmap_mode="r")
        if path.startswith("['stack']"):
            want = want[layers[0]:layers[-1] + 1]
        want = torch.from_numpy(np.ascontiguousarray(want)).to(dev)
        d = float((leaf.double() - want.double()).abs().max())
        b = float(want.abs().max())
        diff, big = max(diff, d), max(big, b)
        if d / max(b, 1e-12) >= worst:
            worst, where = d / max(b, 1e-12), path
    return {"rel": worst, "worst": where, "tree_rel": diff / max(big, 1e-12)}


def _pipe_train(torch, dist, cfg, spec, held, layers, mesh, dev, sync):
    """(c)'s train step on this rank, run twice from the same start (the
    first warms the backward's libraries up); the second's loss,
    gradients and updated parameters against the one process's, with
    its walls, seconds in the links, staged bytes, collectives and
    peak memory."""
    from repro_torch.launch.roofline import CollectiveCounter

    on_card = dev.type == "cuda"
    opt = _par_optimizer(1)
    batch = _pipe_batch(torch, cfg, spec, dev)
    state = opt.init(held)
    col = _Collectives(torch, dist, names=("send", "recv", "broadcast",
                                           "all_reduce"), dev=dev)
    runs = []
    try:
        for _ in range(2):
            stats = {}
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            sync()
            col.on = True
            t0 = time.perf_counter()
            with CollectiveCounter() as c:
                loss, grads, new, _, walls = _pipe_step(
                    torch, cfg, opt, held, state, batch, layers, mesh,
                    spec["pipe_microbatches"], stats, sync)
            wall = time.perf_counter() - t0
            col.on = False
            link = col.take()
            runs.append({"wall_s": wall, **walls,
                         "link_s": link["seconds"],
                         "other_s": wall - link["seconds"],
                         "link_calls": link["calls"],
                         "link_bytes": link["bytes"], **stats,
                         "by_op": c.stats.by_op, "counts": c.stats.counts,
                         "peak_cuda_bytes": torch.cuda.max_memory_allocated(
                             dev) if on_card else None})
    finally:
        col.close()
    rep = {k: v for k, v in grads.items() if k != "stack"}
    out = {"loss": float(loss), "warm_up": runs[0], **runs[-1]}
    ref = spec["ref_dir"]
    out["block_grads"] = _pipe_compare(
        torch, os.path.join(ref, "grads"), {"stack": grads["stack"]}, layers,
        dev)
    out["replicated_grads"] = _pipe_compare(
        torch, os.path.join(ref, "grads"), rep, layers, dev)
    out["params"] = _pipe_compare(torch, os.path.join(ref, "params"), new,
                                  layers, dev)
    return out


def _pipeline_worker(spec) -> int:
    """One stage of phase 16(c), started by ``launch_local_fleet``:
    builds what it holds, runs ``pipeline_apply``'s forward on the
    ``pod`` mesh of the ranks (its output written for the parent), then
    the pipelined train step against the one process's (written by the
    parent), and prints one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.pipeline import pipeline_apply, stage_index
    from repro_torch.launch.roofline import CollectiveCounter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh_lib.init_fleet_group(PAR_GROUP_TIMEOUT_S)
    dev = mesh_lib.rank_device(spec["device"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = _pipe_config(spec)
    n = spec["pipe_stages"]
    mesh = mesh_lib.make_mesh((n,), ("pod",), "cpu")
    s = stage_index("pod", mesh=mesh)
    per = cfg.num_layers // n
    layers = list(range(s * per, (s + 1) * per))
    held = _pipe_held(torch, cfg, layers, dev)
    x = _pipe_input(torch, cfg, spec, dev)
    with torch.no_grad():     # warm-up: the libraries' first calls
        _pipe_blocks(cfg, held["stack"], x[:1], layers[0])
    stats = {}
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    with CollectiveCounter() as c:
        out = pipeline_apply(
            lambda p, h: _pipe_blocks(cfg, p, h, layers[0]), held["stack"],
            x, mesh=mesh, axis="pod", microbatches=spec["pipe_microbatches"],
            stats=stats)
    sync()
    wall = time.perf_counter() - t0
    torch.save(out.cpu(), os.path.join(spec["out_dir"], f"stage{s}.pt"))
    row = {"rank": rank, "stage": s, "layers": layers, "wall_s": wall,
           "graph": out.grad_fn is not None, "by_op": c.stats.by_op,
           "counts": c.stats.counts, **stats}
    del out, x
    row["train"] = _pipe_train(torch, dist, cfg, spec, held, layers, mesh,
                               dev, sync)
    print(json.dumps(row), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _pipe_reference(torch, cfg, spec, dev, ref_dir):
    """One process's sequential step of the same model on ``dev``
    (``init_params(cfg, 0)``, ``value_and_grad`` and one AdamW step, the
    second of two runs timed; its gradients and new parameters written
    under ``ref_dir``, one ``.npy`` a leaf) and its no-grad forward of
    the blocks over the random input (returned on the host; the second
    of two runs timed)."""
    import numpy as np

    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten_with_path
    from repro_torch.train import steps as steps_lib

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    params = model_lib.init_params(cfg, 0, device=dev)
    x = _pipe_input(torch, cfg, spec, dev)
    with torch.no_grad():
        for _ in range(2):     # the first loads the libraries' kernels
            sync()
            t0 = time.perf_counter()
            want = _pipe_blocks(cfg, params["stack"], x, 0)
            sync()
            forward_s = time.perf_counter() - t0
    want = want.cpu()
    del x
    opt = _par_optimizer(1)
    batch = _pipe_batch(torch, cfg, spec, dev)
    walls = []
    for _ in range(2):
        grads = new = None
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        metrics, grads = steps_lib.value_and_grad(cfg, params, batch)
        new, _, _ = opt.update(grads, opt.init(params), params)
        sync()
        walls.append(time.perf_counter() - t0)
    one = {"loss": float(metrics["loss"]), "step_s": walls[-1],
           "warm_up_step_s": walls[0], "sequential_forward_s": forward_s,
           "peak_cuda_bytes": torch.cuda.max_memory_allocated(dev)
           if on_card else None}
    for name, tree in (("grads", grads), ("params", new)):
        os.makedirs(os.path.join(ref_dir, name))
        for path, leaf in flatten_with_path(tree):
            np.save(os.path.join(ref_dir, name, _leaf_file(path)),
                    leaf.detach().cpu().numpy())
    del params, grads, new
    if on_card:
        torch.cuda.empty_cache()
    return one, want


def _launch_pipeline(torch, spec, dev, root):
    """(c): the dense stack's blocks as pipe_stages stages on as many
    ranks sharing ``dev``: the forward against one process's sequential
    forward, then the pipelined train step against one process's."""
    from repro_torch.launch import simdev
    from repro_torch.launch.pipeline import bubble_fraction

    cfg = _pipe_config(spec)
    n, m = spec["pipe_stages"], spec["pipe_microbatches"]
    _require(cfg.num_layers % n == 0, f"phase 16(c): {cfg.num_layers} "
                                      f"layers do not split into {n}")
    ref_dir = os.path.join(root, "pipe_ref")
    t0 = time.perf_counter()
    one, want = _pipe_reference(torch, cfg, spec, dev, ref_dir)
    one_s = time.perf_counter() - t0
    wspec = dict(spec, device=None if dev.type == "cuda" else str(dev),
                 out_dir=root, ref_dir=ref_dir)
    t0 = time.perf_counter()
    res = simdev.launch_local_fleet(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--pipeline-worker", json.dumps(wspec)], n, timeout=PIPE_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    workers = []
    for r in res:
        _require(r.returncode == 0, f"phase 16(c): rank {r.rank}: "
                                    f"{r.stderr_tail}")
        workers.append(simdev.last_json_line(r.stdout))
    mb_bytes = spec["global_batch"] // m * spec["seq_len"] * \
        cfg.d_model * 4
    for w in workers:
        s = w["stage"]
        got = torch.load(os.path.join(root, f"stage{s}.pt"))
        w["rel"] = _rel(got, want)
        _require(w["rel"] <= PIPE_TOL and not w["graph"],
                 f"phase 16(c): stage {s} rel {w['rel']:.3g}, graph "
                 f"{w['graph']}")
        sends = w["counts"].get("collective-permute", 0)
        w["boundary_bytes_per_microbatch"] = \
            w["by_op"].get("collective-permute", 0.0) / sends if sends \
            else None
        _require(sends == (m if s < n - 1 else 0) and
                 (not sends or w["boundary_bytes_per_microbatch"] ==
                  mb_bytes), f"phase 16(c): stage {s} sent "
                             f"{w['by_op']} in {w['counts']}")
        t = w["train"]
        # the gradients leaf by leaf; the parameters over the tree, as
        # phase 15 holds them: a zero-initialised bias moves by ±lr in
        # its first AdamW step, where eps turns a gradient's rounding
        # into a step (ROADMAP "Parity traps")
        t["loss_rel"] = abs(t["loss"] - one["loss"]) / abs(one["loss"])
        got = {"loss": t["loss_rel"],
               "block gradients": t["block_grads"]["rel"],
               "replicated gradients": t["replicated_grads"]["rel"],
               "parameters": t["params"]["tree_rel"]}
        for k, v in got.items():
            _require(v <= PIPE_TOL, f"phase 16(c): stage {s} train {k} "
                     f"rel {v:.3g} (loss {t['loss']} vs {one['loss']}; "
                     f"{t['block_grads']}, {t['replicated_grads']}, "
                     f"{t['params']})")
        sends = t["counts"].get("collective-permute", 0)
        t["boundary_bytes_per_microbatch"] = \
            t["by_op"].get("collective-permute", 0.0) / sends
        _require(sends == m * ((s < n - 1) + (s > 0)) and
                 t["boundary_bytes_per_microbatch"] == mb_bytes and
                 t["counts"].get("broadcast") == 2,
                 f"phase 16(c): stage {s} train step sent {t['by_op']} "
                 f"in {t['counts']}")
    return {"stages": n, "microbatches": m,
            "layers_per_stage": cfg.num_layers // n,
            "bubble_fraction": bubble_fraction(n, m),
            "boundary_bytes_per_microbatch": mb_bytes,
            "ranks_seconds": ranks_s, "one_process_seconds": one_s,
            "sequential_s": one["sequential_forward_s"],
            "pipeline_wall_s": max(w["wall_s"] for w in workers),
            "train_step_wall_s": max(w["train"]["wall_s"]
                                     for w in workers),
            "one_process": one, "tol": PIPE_TOL, "workers": workers}


def phase_launch_tools(torch, ops, dev, card, spec=None):
    """Phase 16: the launch tools. (a) the dry run's prediction of a
    full-width qwen1.5-0.5B train step (LAUNCH_SPEC: 8 × 128 tokens,
    its grad_accum 2, bf16 compute, full remat) and a 4-lane decode
    step (cache 128) on one position (no mesh) — peak bytes, FLOPs,
    the roofline bound — beside the steps run on the card: the peak of
    ``max_memory_allocated`` within LAUNCH_PEAK_TOL, the bound no more
    than the profiler's busy time, the useful FLOP share in (0, 1];
    (b) the dry-run sweep of every reduced arch × shape on 16×16 and
    2×16×16 (the reference's production meshes, fake groups of 256 and
    512), each cell ok or skipped with ``applicable``'s reason, the
    committed reduced qwen and moonshot ``train_4k`` cells'
    ``model_flops`` and ``cost.bytes_per_device`` reproduced; (c) the
    24 blocks as 4 stages × 6 layers on 4 ranks sharing the card
    (``launch_local_fleet``), f32, 8 × 128 tokens in 4 microbatches,
    each rank building only its own blocks, every rank's output within
    PIPE_TOL of one process's sequential forward; the wall, the
    bubble fraction and the bytes that cross each boundary (the
    collective counter); then the pipelined train step of the whole
    model (``_pipe_step``: the embedding and final norm replicated,
    each rank's blocks a stage, one AdamW step on what it holds) held
    to one process's sequential step at PIPE_TOL — loss, gradients,
    updated parameters — with M sends each way at each boundary.
    ``spec`` overrides LAUNCH_SPEC (the CPU rehearsal passes reduced
    ones). Returns the phase's kernel launches (none: the dry run only
    counts, and the steps and the pipeline are plain products, as the
    reference's are jnp)."""
    import shutil

    spec = dict(LAUNCH_SPEC, **(spec or {}))
    t_phase = time.perf_counter()
    before = ops.launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        t0 = time.perf_counter()
        steps = _launch_predicted_vs_measured(torch, spec, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _line({"phase": "launch_dryrun_vs_card", "config": spec["arch"],
               "reduced": spec["reduced"], "global_batch":
               spec["global_batch"], "seq_len": spec["seq_len"],
               "decode_lanes": spec["decode_lanes"], "decode_cache":
               spec["decode_cache"], "peak_tol": LAUNCH_PEAK_TOL,
               **steps, "seconds": time.perf_counter() - t0, "card": card})
        t0 = time.perf_counter()
        sweep_dir = os.path.join(root, "dryrun")
        os.makedirs(sweep_dir)
        cells, failed = _launch_sweep(spec, sweep_dir)
        _check_sweep(cells, failed)
        _line({"phase": "launch_dryrun_sweep", "cells": [
            {k: c.get(k) for k in ("arch", "shape", "mesh", "status",
                                   "reason")} |
            ({"peak_gib": c["memory"]["peak_bytes_per_device"] / 2**30,
              "dominant": c.get("roofline", {}).get("dominant"),
              "bound_ms": c["roofline"]["bound_s"] * 1e3
              if "roofline" in c else None, "run_s": c["compile_s"]}
             if c["status"] == "ok" else {}) for c in cells],
            "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        pipe = _launch_pipeline(torch, spec, dev, root)
        _line({"phase": "launch_pipeline", "config": spec["arch"],
               "reduced": spec["reduced"], **pipe,
               "seconds": time.perf_counter() - t0, "card": card})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path = _deltas(ops.launch_counts(), before)
    _line({"phase": "launch_tools", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


# --------------------------------------------------------------------- #
# phase 17: sharded (FSDP × TP) serving and training on ranks of the card
# --------------------------------------------------------------------- #
def _shard_config(arch, reduced):
    """``arch``'s config (reduced or published) with f32 compute, as
    phases 15 and 16 hold their parity runs."""
    from repro_torch.configs import get_config, get_reduced
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg.replace(compute_dtype="float32")


def _whole(t):
    """A DTensor's whole value on every rank (a collective); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _grow_cache(torch, cache, axes, cache_len):
    """A prefill's cache with every ring leaf zero-padded along its ring
    axis to ``cache_len`` slots; the decode masks the empty slots by
    position, as it does the slots the serving engine's lane writes
    leave (``serving.kvcache.write_slot``). State leaves stay as they
    are."""
    if isinstance(cache, dict):
        return {k: _grow_cache(torch, v, axes[k] if isinstance(axes, dict)
                               else axes, cache_len)
                for k, v in cache.items()}
    _, ring = axes
    if ring is None or cache.shape[ring] >= cache_len:
        return cache
    pad = [0, 0] * (cache.dim() - 1 - ring) + \
        [0, cache_len - cache.shape[ring]]
    return torch.nn.functional.pad(cache, pad)


def _shard_serve(torch, cfg, params, prompts, new_tokens, cache_len,
                 mesh=None, sync=lambda: None):
    """Greedy serving of ``prompts`` (B, S) through the port's steps:
    ``make_prefill_step`` under the prefill rules, its cache gathered
    and grown to ``cache_len`` slots (:func:`_grow_cache`), then
    ``new_tokens`` ``make_decode_step`` calls under the decode rules
    with the cache placed by ``specs.cache_shardings`` (its sequence on
    ``model``). ``params`` are placed by the caller (the decode rules'
    placements under a mesh: weights resident). Returns each step's
    whole logits (B, padded_vocab) on the device (the prefill's first),
    each step's greedy tokens (B,) over the model's vocab, the
    prefill's and each decode step's wall, and whether the cache keeps
    a state in bf16 (xLSTM's mLSTM ``C``, as the reference keeps it)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import axis_rules, tree_distribute
    from repro_torch.train import steps as steps_lib

    B, S = prompts.shape

    def rules(mode):
        return {} if mesh is None else \
            make_rules(cfg, mesh, mode, global_batch=B)

    def pick(logits):
        return logits[:, :cfg.vocab_size].argmax(-1)

    sync()
    t0 = time.perf_counter()
    with axis_rules(mesh, rules("prefill")):
        logits, cache = steps_lib.make_prefill_step(cfg)(
            params, {"tokens": prompts})
        logits = _whole(logits)
        cache = tree_map(_whole, cache)
    cache = _grow_cache(torch, cache, model_lib.cache_axes(cfg), cache_len)
    sync()
    info = {"prefill_s": time.perf_counter() - t0, "decode_step_s": [],
            "bf16_state": any(x.dtype == torch.bfloat16
                              for x in leaves(cache))}
    out, tokens = [logits], [pick(logits)]
    decode = steps_lib.make_decode_step(cfg)
    with axis_rules(mesh, rules("decode")):
        if mesh is not None:
            cache = tree_distribute(
                cache, specs_lib.cache_shardings(cfg, mesh), mesh)
        for i in range(new_tokens):
            t0 = time.perf_counter()
            logits, cache = decode(
                params, cache, tokens[-1][:, None].to(torch.int32),
                torch.tensor(S + i, dtype=torch.int32,
                             device=prompts.device))
            logits = _whole(logits)
            sync()
            info["decode_step_s"].append(time.perf_counter() - t0)
            out.append(logits)
            tokens.append(pick(logits))
    return out, tokens, info


def _place(cfg, tree, mesh, mode, global_batch, opt_state=None):
    """``tree`` (and, given, its AdamW state) distributed by ``mode``'s
    rule table on ``mesh`` (every rank holds them whole and keeps its
    shards); as they are without a mesh."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import make_rules
    from repro_torch.sharding import axis_rules, tree_distribute

    if mesh is None:
        return tree if opt_state is None else (tree, opt_state)
    with axis_rules(mesh, make_rules(cfg, mesh, mode,
                                     global_batch=global_batch)):
        psh = specs_lib.param_shardings(cfg, mesh)
        if opt_state is None:
            return tree_distribute(tree, psh, mesh)
        return tree_distribute((tree, opt_state),
                               (psh, specs_lib.opt_shardings(psh, mesh)),
                               mesh)


def _shard_train(torch, cfg, params, pipe, steps, global_batch, mesh=None,
                 sync=lambda: None, opt=None):
    """``steps`` train steps of ``cfg`` from ``params`` (every rank's
    whole tree) on ``pipe``'s batches with ``opt`` (default phase 15's
    AdamW: eps 1e-4, cosine lr): under a mesh the parameters and the AdamW state placed
    by the train rules and ``make_train_step`` run under them (FSDP ×
    TP; the gradients reduce-scattered onto the shards). Returns the
    final (params, state), and per step its loss, wall, and the staged
    bytes and seconds of the group's collectives in it."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.rules import make_rules
    from repro_torch.sharding import axis_rules
    from repro_torch.train import steps as steps_lib

    opt = opt or _par_optimizer(steps)
    params, state = _place(cfg, params, mesh, "train", global_batch,
                           opt.init(params))
    rules = {} if mesh is None else \
        make_rules(cfg, mesh, "train", global_batch=global_batch)
    rows = []
    with axis_rules(mesh, rules):
        step, accum = steps_lib.make_train_step(
            cfg, opt, global_batch=global_batch,
            dp=1 if mesh is None else mesh_lib.dp_degree(mesh))
        for i in range(steps):
            sync()
            b0, s0 = mesh_lib.staged_bytes(), mesh_lib.staged_seconds()
            t0 = time.perf_counter()
            params, state, m = step(params, state, pipe.batch(i))
            loss = float(m["loss"])
            sync()
            rows.append({"loss": loss, "wall_s": time.perf_counter() - t0,
                         "staged_bytes": mesh_lib.staged_bytes() - b0,
                         "staged_s": mesh_lib.staged_seconds() - s0})
    return params, state, rows, accum


def _shard_prompts(torch, cfg, spec, dev):
    """The serving prompts: ``TokenPipeline(seed=0)``'s first batch of
    ``prompts`` rows × ``prompt_len`` tokens, on ``dev``."""
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab_size,
                         seq_len=spec["prompt_len"],
                         global_batch=spec["prompts"], seed=0)
    return torch.as_tensor(pipe.batch(0)["tokens"]).to(dev)


def _top2_gap(torch, logits, vocab):
    """Per lane, the gap between the two largest logits over the vocab,
    over the largest |logit| of the lane."""
    top = logits[:, :vocab].double().topk(2, dim=-1).values
    big = logits[:, :vocab].double().abs().amax(-1).clamp(min=1e-30)
    return ((top[:, 0] - top[:, 1]) / big).tolist()


def _shard_reference(torch, spec, dev, ref_dir):
    """One process's run of phase 17's (a) and (b) on ``dev``: the
    serving job (each step's logits written under ``ref_dir`` as
    ``logits{i}.npy``), its tokens and top-2 gaps; then the training
    job, its losses and walls and its final parameters written as
    ``params/{i}.npy``."""
    import numpy as np

    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten_with_path

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = _shard_config(spec["arch"], spec["reduced"])
    params = model_lib.init_params(cfg, 0, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        logits, tokens, serve_info = _shard_serve(
            torch, cfg, params, _shard_prompts(torch, cfg, spec, dev),
            spec["new_tokens"], spec["cache_len"], sync=sync)
    gaps = []
    for i, lg in enumerate(logits):
        np.save(os.path.join(ref_dir, f"logits{i}.npy"), lg.cpu().numpy())
        gaps.append(_top2_gap(torch, lg, cfg.vocab_size))
    one = {"tokens": [t.tolist() for t in tokens], "top2_gap": gaps,
           "serve": serve_info}
    del logits
    new, state, rows, accum = _shard_train(
        torch, cfg, params, _par_pipeline(cfg, spec), spec["steps"],
        spec["global_batch"], sync=sync)
    os.makedirs(os.path.join(ref_dir, "params"))
    for i, (_, leaf) in enumerate(flatten_with_path(new)):
        np.save(os.path.join(ref_dir, "params", f"{i}.npy"),
                leaf.detach().cpu().numpy())
    one.update(train=rows, accum=accum, peak_cuda_bytes=torch.cuda.
               max_memory_allocated(dev) if on_card else None)
    del params, new, state
    if on_card:
        torch.cuda.empty_cache()
    return one


def _shard_serve_leg(torch, cfg, spec, mesh, dev, sync):
    """(a) on this rank: the full-width model placed by the decode rules
    (weights resident), the serving job sharded, each step's logits
    against the one process's (``rel``) and its tokens, walls and
    staged bytes."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib

    whole = model_lib.init_params(cfg, 0, device=dev)
    params = _place(cfg, whole, mesh, "decode", spec["prompts"])
    del whole
    b0, s0 = mesh_lib.staged_bytes(), mesh_lib.staged_seconds()
    with torch.no_grad():
        logits, tokens, info = _shard_serve(
            torch, cfg, params, _shard_prompts(torch, cfg, spec, dev),
            spec["new_tokens"], spec["cache_len"], mesh=mesh, sync=sync)
    rel = [_rel(lg, torch.from_numpy(np.load(os.path.join(
        spec["ref_dir"], f"logits{i}.npy"))).to(dev))
        for i, lg in enumerate(logits)]
    del params, logits
    return {"rel": rel, "tokens": [t.tolist() for t in tokens], **info,
            "staged_bytes": mesh_lib.staged_bytes() - b0,
            "staged_s": mesh_lib.staged_seconds() - s0}


def _shard_train_leg(torch, cfg, spec, mesh, dev, sync):
    """(b) on this rank: the training job sharded (FSDP × TP), its
    losses, walls and staged bytes, the placements of two weights, and
    the final parameters over the whole tree against the one
    process's."""
    import numpy as np

    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten_with_path

    whole = model_lib.init_params(cfg, 0, device=dev)
    params, state, rows, accum = _shard_train(
        torch, cfg, whole, _par_pipeline(cfg, spec), spec["steps"],
        spec["global_batch"], mesh=mesh, sync=sync)
    del whole, state
    flat = flatten_with_path(params)
    placements = {k: str(x.placements) for k, x in flat
                  if k in SHARD_PLACEMENTS}
    diff, big = 0.0, 0.0
    for i, (_, leaf) in enumerate(flat):
        want = torch.from_numpy(np.load(os.path.join(
            spec["ref_dir"], "params", f"{i}.npy"))).to(dev)
        got = _whole(leaf)
        diff = max(diff, float((got.double() - want.double()).abs().max()))
        big = max(big, float(want.abs().max()))
        del want, got
    return {"steps": rows, "accum": accum, "params_rel": diff / big,
            "placements": placements}


def _shard_family_leg(torch, arch, spec, mesh, dev, sync):
    """(d) on this rank: ``arch``'s reduced config, one process's train
    step (AdamW at a constant lr 1e-3, eps 1e-4, as
    ``tests/test_torch_sharding.py``'s) and greedy decode computed here,
    then the same sharded; the loss and the parameters over the tree,
    the logits and the tokens against the one process's."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.rules import kv_repeat_for
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, constant_schedule
    from repro_torch.pytree import leaves

    base = _shard_config(arch, True)
    cfg = base.replace(kv_repeat=kv_repeat_for(base,
                                               mesh_lib.tp_degree(mesh)))
    p0 = model_lib.init_params(base, 0, device=dev)
    pipe = TokenPipeline(vocab_size=base.vocab_size,
                         seq_len=spec["family_seq_len"],
                         global_batch=spec["global_batch"], seed=4)
    prompts = torch.as_tensor(pipe.batch(0)["tokens"][
        :spec["prompts"]]).to(dev)
    t0 = time.perf_counter()
    opt = AdamW(lr=constant_schedule(1e-3), eps=PAR_EPS)
    one_p, _, one_rows, _ = _shard_train(torch, base, p0, pipe, 1,
                                         spec["global_batch"], sync=sync,
                                         opt=opt)
    with torch.no_grad():
        one_logits, one_tokens, one_info = _shard_serve(
            torch, base, p0, prompts, spec["family_new_tokens"],
            spec["family_cache_len"], sync=sync)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_p, _, rows, _ = _shard_train(torch, cfg, p0, pipe, 1,
                                     spec["global_batch"], mesh=mesh,
                                     sync=sync, opt=opt)
    diff = max(float((_whole(a) - b).abs().max())
               for a, b in zip(leaves(got_p), leaves(one_p)))
    big = max(float(b.abs().max()) for b in leaves(one_p))
    with torch.no_grad():
        logits, tokens, _ = _shard_serve(
            torch, cfg, _place(cfg, p0, mesh, "decode", spec["prompts"]),
            prompts, spec["family_new_tokens"], spec["family_cache_len"],
            mesh=mesh, sync=sync)
    return {"arch": arch, "family": base.family,
            "loss": rows[0]["loss"], "one_loss": one_rows[0]["loss"],
            "params_rel": diff / big,
            "logits_rel": [_rel(a, b) for a, b in zip(logits, one_logits)],
            "bf16_state": one_info["bf16_state"],
            "tokens_equal": all(bool(torch.equal(a, b))
                                for a, b in zip(tokens, one_tokens)),
            "one_gap_min": min(min(_top2_gap(torch, lg, base.vocab_size))
                               for lg in one_logits),
            "one_process_s": one_s, "sharded_s": time.perf_counter() - t0}


def _shard_worker(spec) -> int:
    """One rank of phase 17, started by ``launch_local_fleet``: joins the
    group the port chooses for ranks sharing the card (the staged
    backend), builds the (data, model) mesh, runs (a), (b) and (d), and
    prints one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_lib.rank_device(spec["device"])
    rank = mesh_lib.init_fleet_group(
        PAR_GROUP_TIMEOUT_S,
        backend=spec.get("backend") or mesh_lib.group_backend(dev))
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    mesh = mesh_lib.make_debug_mesh(model=SHARD_MODEL, device=dev)
    cfg = _shard_config(spec["arch"], spec["reduced"])
    out = {"rank": rank, "device": str(dev),
           "backend": str(dist.get_backend()),
           "mesh": mesh_lib.mesh_axis_sizes(mesh)}
    out["serve"] = _shard_serve_leg(torch, cfg, spec, mesh, dev, sync)
    out["train"] = _shard_train_leg(torch, cfg, spec, mesh, dev, sync)
    out["families"] = [_shard_family_leg(torch, arch, spec, mesh, dev,
                                         sync)
                       for arch in spec["families"]]
    out["peak_cuda_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if on_card else None
    out["staged_bytes"] = mesh_lib.staged_bytes()
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _decode_tol(bf16_state):
    """The decode steps' logits tolerance: SHARD_TOL, or PAR_BF16_TOL
    where the cache keeps a state in bf16. There a reduction-order
    difference of 1e-7 moves a state entry across a bf16 rounding
    boundary: one process's own decode of the reduced xLSTM moves by
    up to 1.35e-4 of its largest logit in 4 steps when its weights
    move by 1e-7, its prefill by 7.8e-7 (on the CPU;
    ``tests/test_torch_staged_group.py`` pins it)."""
    return PAR_BF16_TOL if bf16_state else SHARD_TOL


def _check_serving(one, w, tol):
    """(a)'s gate on one rank: the tokens equal the one process's up to
    the first step where they differ, which must be one where the one
    process's top-2 gap is under ``tol`` of its largest |logit| (phase
    11's rule); every step's logits up to and including that step
    within ``tol``. Returns the first differing step (None: none)."""
    first = None
    for i, (a, b) in enumerate(zip(w["serve"]["tokens"], one["tokens"])):
        if a != b:
            first = i
            lanes = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
            _require(all(one["top2_gap"][i][j] < tol for j in lanes),
                     f"phase 17(a): rank {w['rank']} step {i} tokens {a} "
                     f"vs {b}, one process's gaps {one['top2_gap'][i]}")
            break
    last = len(one["tokens"]) if first is None else first + 1
    rel = w["serve"]["rel"]
    step_tol = _decode_tol(one["serve"]["bf16_state"])
    _require(rel[0] <= tol and max(rel[1:last], default=0.0) <= step_tol,
             f"phase 17(a): rank {w['rank']} logits rel {rel}")
    return first


def _shard_launcher(spec, dev, root):
    """(c): the launcher on SHARD_RANKS ranks with ``--model-parallel
    2``, then resumed from a copy of its step-2 checkpoint with
    ``--model-parallel 1`` (a (4, 1) mesh), both at the config's bf16
    compute; the resumed step-2 loss against the straight run's at
    SHARD_LAUNCHER_TOL."""
    import shutil

    from repro_torch.launch import simdev
    from repro_torch.train import checkpoint as ckpt_lib

    device = [] if dev.type == "cuda" else ["--device", str(dev)]
    base = [sys.executable, "-m", "repro_torch.launch.train",
            *spec["launcher_args"], *device, "--log-every", "1"]

    def run(mp, ckpt, log, every):
        t0 = time.perf_counter()
        res = simdev.launch_local_fleet(
            base + ["--model-parallel", str(mp), "--ckpt-dir", ckpt,
                    "--log", log, "--ckpt-every", str(every)],
            SHARD_RANKS, timeout=SHARD_TIMEOUT_S)
        for r in res:
            _require(r.returncode == 0, f"phase 17(c): launcher rank "
                                        f"{r.rank}: {r.stderr_tail}")
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        return res, recs, time.perf_counter() - t0

    straight, resumed = os.path.join(root, "straight"), \
        os.path.join(root, "resumed")
    res_a, recs_a, wall_a = run(SHARD_MODEL, straight, straight + ".jsonl",
                                spec["ckpt_every"])
    name = _shard_config(spec["arch"], spec["reduced"]).name
    want = f"mesh: {{'data': 2, 'model': 2}} (dp=2, tp=2); arch={name}"
    for r in res_a:
        _require(want in r.stdout, f"phase 17(c): rank {r.rank} printed "
                                   f"{r.stdout[-500:]}")
    at = spec["ckpt_every"]
    _require(at in ckpt_lib.published_steps(straight),
             f"phase 17(c): steps published "
             f"{ckpt_lib.published_steps(straight)}")
    src = os.path.join(straight, f"step_{at:08d}")
    size = sum(os.path.getsize(os.path.join(src, n))
               for n in os.listdir(src))
    os.makedirs(resumed)
    shutil.copytree(src, os.path.join(resumed, f"step_{at:08d}"))
    shutil.rmtree(straight, ignore_errors=True)
    res_b, recs_b, wall_b = run(1, resumed, resumed + ".jsonl", 0)
    for r in res_b:
        _require(f"resumed_from={at}" in r.stdout and
                 "mesh: {'data': 4, 'model': 1} (dp=4, tp=1)" in r.stdout,
                 f"phase 17(c): resumed rank {r.rank} printed "
                 f"{r.stdout[-500:]}")
    # every rank's save walls (the gather on every rank; rank 0 writes)
    saves = [[(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"\[checkpoint\] step (\d+) saved in ([0-9.]+)s", r.stdout)]
        for r in res_a]
    _require(all(at in dict(s) for s in saves),
             f"phase 17(c): checkpoint walls {saves}")
    loss_a = [x["loss"] for x in recs_a if x["step"] == at][0]
    loss_b = [x["loss"] for x in recs_b if x["step"] == at][0]
    rel = abs(loss_b - loss_a) / abs(loss_a)
    _require(rel <= SHARD_LAUNCHER_TOL, f"phase 17(c): resumed step-{at} "
                                        f"loss {loss_b} vs {loss_a}")
    return {"straight": {"steps": recs_a, "seconds": wall_a,
                         "stdout_tail": res_a[0].stdout[-300:]},
            "resumed": {"steps": recs_b, "seconds": wall_b,
                        "stdout_tail": res_b[0].stdout[-300:]},
            "checkpoint_bytes": size, "checkpoint_save_s": saves,
            "resume_loss_rel": rel}


def phase_sharded(torch, ops, dev, card, spec=None):
    """Phase 17: sharded (FSDP × TP) serving and training on SHARD_RANKS
    ranks sharing the card, one ``launch_local_fleet`` group (the staged
    backend: each collective's tensors through pinned host buffers and
    gloo), ``make_debug_mesh(model=2)`` = {'data': 2, 'model': 2}, f32
    without TF32. One process's run of the same jobs on the card first,
    its results kept under a temporary directory. (a) qwen1.5-0.5B at
    full width, weights resident per the decode rules: a prefill of 4
    × 128 tokens, then 16 greedy decode steps into a cache of 256 with
    its sequence on ``model``; every step's logits within SHARD_TOL of
    one process's, the tokens equal up to the first step where one
    process's top-2 gap is under SHARD_TOL of its largest |logit|;
    (b) 3 train steps of global batch 8 × 128 (2 microbatches) on
    ``TokenPipeline(seed=0)``, AdamW eps 1e-4, cosine lr 3e-4, placed
    by the train rules: losses within SHARD_TOL, the final parameters
    within SHARD_TOL over the tree, ``wq`` and ``w2`` on both axes; (c)
    the launcher itself on the ranks with ``--model-parallel 2`` and a
    step-2 checkpoint at the config's bf16 compute, then resumed from a
    copy of it on a (4, 1) mesh, the step-2 losses within
    SHARD_LAUNCHER_TOL; (d) the reduced MoE, hybrid and
    ssm configs: a train step and a 4-token decode each against one
    process's. Per rank: step walls, staged bytes and seconds, peak
    memory. ``spec`` overrides SHARD_SPEC (the CPU rehearsal passes a
    reduced one). Returns the phase's kernel launches (none: the
    sharded steps are plain products and collectives)."""
    import shutil

    from repro_torch.launch import simdev

    spec = dict(SHARD_SPEC, **(spec or {}))
    spec["device"] = None if dev.type == "cuda" else str(dev)
    t_phase = time.perf_counter()
    before = ops.launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        spec["ref_dir"] = os.path.join(root, "ref")
        os.makedirs(spec["ref_dir"])
        t0 = time.perf_counter()
        one = _shard_reference(torch, spec, dev, spec["ref_dir"])
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = simdev.launch_local_fleet(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--shard-worker", json.dumps(spec)], SHARD_RANKS,
            timeout=SHARD_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        workers = []
        for r in res:
            _require(r.returncode == 0, f"phase 17: rank {r.rank}: "
                                        f"{r.stderr_tail}")
            workers.append(simdev.last_json_line(r.stdout))
        for w in workers:
            _require(w["mesh"] == {"data": 2, "model": 2},
                     f"phase 17: rank {w['rank']} mesh {w['mesh']}")
            w["serve"]["first_token_difference"] = _check_serving(
                one, w, SHARD_TOL)
            t = w["train"]
            t["loss_rel"] = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                             for a, b in zip(t["steps"], one["train"])]
            _require(max(t["loss_rel"]) <= SHARD_TOL and
                     t["params_rel"] <= SHARD_TOL and
                     t["accum"] == one["accum"],
                     f"phase 17(b): rank {w['rank']} losses "
                     f"{t['steps']} vs {one['train']}, params rel "
                     f"{t['params_rel']:.3g}")
            _require(t["placements"] == SHARD_PLACEMENTS,
                     f"phase 17(b): placements {t['placements']}")
            for f in w["families"]:
                f["loss_rel"] = abs(f["loss"] - f["one_loss"]) / \
                    abs(f["one_loss"])
                step_tol = _decode_tol(f["bf16_state"])
                _require(f["loss_rel"] <= SHARD_TOL and
                         f["params_rel"] <= SHARD_TOL and
                         f["logits_rel"][0] <= SHARD_TOL and
                         max(f["logits_rel"][1:]) <= step_tol and
                         (f["tokens_equal"] or f["one_gap_min"] <
                          SHARD_TOL),
                         f"phase 17(d): rank {w['rank']} {f}")
        _line({"phase": "sharded_ranks", "config": spec["arch"],
               "reduced": spec["reduced"], "ranks": SHARD_RANKS,
               "backend": workers[0]["backend"],
               "mesh": workers[0]["mesh"], "tol": SHARD_TOL,
               "one_process": one, "one_process_seconds": one_s,
               "ranks_seconds": ranks_s, "workers": workers,
               "card": card})
        t0 = time.perf_counter()
        launcher = _shard_launcher(spec, dev, root)
        _line({"phase": "sharded_launcher", **launcher,
               "seconds": time.perf_counter() - t0, "card": card})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path = _deltas(ops.launch_counts(), before)
    _line({"phase": "sharded", "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return path


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        return _parallel_worker(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--pipeline-worker"]:
        return _pipeline_worker(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--shard-worker"]:
        return _shard_worker(json.loads(sys.argv[2]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script runs only "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch.chip as chip_mod
        import repro_torch.variability as var
        from repro_torch.chip import compile as tcompile
        from repro_torch.core import crossbar_layer as tcl
        from repro_torch.core import quantization as tq
        from repro_torch.kernels import build, ops, ref
        from repro_torch.launch import mesh as mesh_lib
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/repro_torch is not beside "
              f"this script ({exc})", file=sys.stderr)
        return 2
    # the plain versions' products stay IEEE f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi
    try:
        t0 = time.perf_counter()
        # the ranks' staged backend (a host C++ build) beside the kernels
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            staged = pool.submit(mesh_lib.build_staged_backend)
            seconds = build.build()
            seconds["staged_backend"] = staged.result()
        _line({"phase": "build", "seconds": time.perf_counter() - t0,
               "per_kernel_s": seconds, "dir": str(build.BUILD_DIR)})
        phase_kernels(torch, ops, ref, dev)
        chips, launches = phase_main_path(torch, ops, tcompile, tq, tcl,
                                          chip_mod, dev, card)
        kernels = phase_times(torch, ops, ref, tcompile, tcl, chip_mod,
                              chips, launches, dev, card)
        drifting, x_var, var_launches = phase_variability(
            torch, ops, tcompile, tq, tcl, chip_mod, var, dev, card)
        phase_variability_times(torch, chip_mod, tcl, drifting, x_var, dev,
                                card)
        app_launches = phase_paper_apps(torch, ops, tcompile, tq, tcl,
                                        chip_mod, dev, card)
        wide, x_wide, wide_launches = phase_wide_digital(
            torch, ops, ref, tcl, chip_mod, dev, card)
        fleet_chips, x_fleet, fleet_launches = phase_fleet(
            torch, ops, tcompile, tcl, chip_mod, drifting, dev, card)
        kernels.append(phase_wide_digital_times(
            torch, ops, ref, tcl, wide, x_wide, launches, card))
        phase_fleet_times(torch, chip_mod, fleet_chips, x_fleet, card)
        rank_launches = phase_ranks(torch, chip_mod, None, card)
        two, het, x_tuned, deploy_launches = phase_deploy(
            torch, ops, ref, tcompile, tq, tcl, chip_mod, var, dev, card)
        phase_deploy_times(torch, chip_mod, two, het, x_tuned, card)
        lm_launches = phase_lm(torch, ops, ref, tcl, dev, card)
        train_launches = phase_train(torch, ops, ref, tcompile, tq, tcl,
                                     chip_mod, var, dev, card)
        family_launches = phase_families(torch, ops, ref, tcl, dev, card)
        state_launches = phase_state_space(torch, ops, dev, card)
        parallel_launches = phase_parallel(torch, ops, dev, card)
        launch_launches = phase_launch_tools(torch, ops, dev, card)
        sharded_launches = phase_sharded(torch, ops, dev, card)
        # each kernel's launches: the main path's and the later phases'
        for row in kernels:
            for later in (var_launches, app_launches, wide_launches,
                          fleet_launches, rank_launches, deploy_launches,
                          lm_launches, train_launches, family_launches,
                          state_launches, parallel_launches,
                          launch_launches, sharded_launches):
                row["launches"] += later[row["name"]]
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    _line({"kernels": kernels})
    _line({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
