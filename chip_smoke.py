#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. setup   — prints the card's name and power limit, builds every CUDA
             kernel from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
             parallel) and prints the build seconds;
2. kernels — holds each kernel to its plain PyTorch version on the card at
             the main path's shape (the payload rows of the full smollm-135m
             wire layout, 262,752) and on a ragged chunk view, fixed and
             adaptive, float32 and bfloat16: int8, int4, int2 and top-k
             (k = 8, 16, 64, 256) payload bytes must be equal, the three
             combines' outputs bitwise equal or within 1 ulp; the per-leaf
             quantizer's codes and scales equal and its combine within
             1 ulp on each of the 11 leaves' padded rows; the flash-decode
             partials within the CPU test's float32 tolerances at the
             serve shape and at decode_32k's, for float32 and bf16 inputs
             alike and for a float32 q over a bf16 cache (each kernel's
             grid printed), with and without a softcap, on masks with a ragged
             frontier, masked tiles and random holes, and at long_500k
             with gemma2-9b's heads (b 1, S 524,288, kvh 8, g 2, hd 256,
             softcap 50; a frontier, holes and a 4,096-position window),
             and at the zoo's decode shapes (qwen3-0.6b, yi-9b,
             chameleon-34b, gemma2-9b with its 4,096 window and its
             long-serve cache with the 32,768 cap), and at the MoE decode shapes
             (granite-moe-3b-a800m g 3 hd 64, deepseek-moe-16b g 1 hd
             128), jamba-v0.1-52b's (g 4 hd 128) and whisper-small's
             self and cross attention (g 1 hd 64, 448 and 1,504
             positions: ``DECODE_SHAPES``);
3. main    — ``repro_torch.launch.train.main`` on the full smollm-135m, 4
             ADC-DGD nodes (fixed grid), each run with every launch counter
             zeroed just before it: 5 steps of the int8 wire, then 3 steps
             each of ``--wire-codec int4``, ``int2`` and ``topk``: losses
             finite and near ln(vocab) at random init, the codec's two
             kernels launched 4 x steps times and no other kernel, the wire
             bytes per step as the codec's payload width says; then 6 steps
             of ``--wire-codec adaptive`` over int2/int4/int8 with a codec
             period of 2, whose launches must match the codec it chose at
             each step; then 2 steps of the int8 wire in adaptive mode;
             then the per-leaf transport and compressed_dgd, each run
             counted on its own: 3 steps of ``--wire-packing per_leaf``
             (the per-leaf kernels launched 4 x 11 x 3 times each, no other
             kernel; the per-leaf wire bytes), whose final parameters must
             be bitwise equal to a 3-step packed run's from the same seed,
             and 3 steps each of ``--algorithm compressed_dgd`` packed and
             per-leaf, with its losses printed beside adc_dgd's; then
             wire plans and transports on the same model, each run counted
             on its own (one encode and one combine launch per node,
             transfer unit and codec run): 3 steps each of plan A
             (``--wire-plan mixed:norm=int4,embed=int4,*=int8``) packed and
             pipelined over 4 chunks (bitwise equal: params, x_tilde,
             m_agg), #1 on a 1,024-column noise buffer against its plain
             version, plan B (``mixed:embed=topk:k=64,norm=int2,*=int8``)
             packed, int8 packed, pipelined and async at staleness 0 (all
             three bitwise equal) and at staleness 1, each with the
             reference's wire bytes and 2 x units collectives per step;
             then 6 steps of ``--wire-codec adaptive`` over plan A whose
             launches and wire bytes must match the plan of each step; the
             launches per step of every plan and tier are also held to the
             written-out ``PLAN_STEP_LAUNCHES``;
             then the time-varying ring on the full smollm-135m x 5 nodes
             (``--ring-strides 1,2 --schedule-period 2``, int8 fixed, 5
             steps: stride 1 at steps 1-2 and 5, stride 2 at 3-4, the
             m_agg resync at 3 and 5) packed, pipelined over 4 units, async
             at staleness 0 and 1 and per-leaf, each counted on its own
             (launches per node and unit, or per leaf; the reference's wire
             bytes 809,276,160 / 809,670,400 and collectives; each step's
             stride and resync), packed == pipelined == async s0 bitwise;
             an uncounted probe run in which the m_agg each combine reads
             at a resync equals ``side * (x_tilde[i - s] + x_tilde[i +
             s])`` recomputed from the step's input, and step 3's exchange
             with the plain versions of #1 and #2 equals the kernels'; the
             exchange time at a resync against steps without one;
             then the lossy and directed rings (``phase_faults``), each
             run counted and every exchange watched: 4 nodes on the
             directed ring with push-sum, adaptive grid, loss seed 1, 3
             steps at loss None, 0.0, 0.05 and 0.2 packed, then 0.2
             pipelined over 4 units, async at staleness 0 and per-leaf,
             the Gilbert-Elliott burst channel (p 0.1, r 0.9) with int8
             and plan B, async at staleness 1 with 20% straggler
             deadlines, and the strided 5-node ring at loss 0.2 with one
             resync retry: the zero payloads each exchange reads equal the
             host keep mask's drops per transfer unit, the delivered bytes
             per node the formula, push-sum weights stay exactly 1; loss
             0.0 equals lossless and at 0.2 packed == pipelined == async
             s0 == per-leaf, bitwise; step 3 of the lossy packed, per-leaf
             and async runs and of the strided one through the plain
             versions of #1-#4 equals the kernels'; a failed resync keeps
             the carried m_agg bitwise; the 4-node int8 exchange timed
             symmetric and directed, with and without loss, and with
             push-sum alone; then push-sum ADC-DGD int8, CHOCO and CEDAS
             on ``directed_erdos_renyi(20, 0.3, seed=1)`` and ADC-DGD
             under ``DirectedErdosRenyiSchedule(20, 0.3, horizon=250,
             seed=0)`` at P 2^22, 250 counted steps each (#3 once per
             step, weights positive and summing to 20, one message per
             directed edge), and kernel against plain trajectories;
             then elastic membership and the two-level hierarchy
             (``phase_elastic``), each run counted and watched: the
             reference's churn sweep on 4 nodes (node 2 out for the second
             of 4-step epochs, 9 steps) packed, pipelined over 4 units,
             async at staleness 0 and 1, and 13 steps under the burst
             channel: active nodes 4 / 3 / 4, node 2's parameters and
             shadows frozen bitwise through steps 5-8, resyncs at steps 5
             and 9 only (none at 13, where the mask has clamped), the
             reference's wire bytes (540,218,112), one encode
             and one combine per active node and unit, packed ==
             pipelined == async s0 bitwise, step 5 through the plain
             versions equal to the kernels; the hierarchy sweep (2 pods
             of 2 nodes, 4 steps) packed, pipelined 4, async s1 and plan
             B: pod members bitwise replicas after every step, one launch
             per pod, 3 collectives per step packed, the outer payload
             plus the inner fp32 bytes; pods 4 == the flat ring and pods
             1 == ``--algorithm allreduce`` bitwise (2 steps each); a
             single all-active
             mask == no membership bitwise; the exchange timed flat, in
             the hole, at the two resyncs and at pods 2 (its inner mean
             apart); then ``run_elastic`` (with and without push-sum)
             and ``run_hierarchical`` (pods 5, 20, 1; pods 20 == ``run``
             on ``ring(20)`` bitwise) at N 20, P 2^22, 250 counted steps
             each, and run_elastic through #3 and its plain version
             bitwise over 20 steps;
             then telemetry, checkpoints and gradient accumulation
             (``phase_telemetry``) on the same 4 nodes, each run counted:
             ``--telemetry`` for 4 steps on packed, pipelined over 4 units
             and async at staleness 1 beside the same run without it (the
             sink valid under ``core.telemetry.validate_file``, every
             exchange phase in the trace, the async in-flight span over
             the next step's forward/backward, 271,160,064 shipped bytes
             per step, losses and metrics of every step, final params,
             shadows and in-flight payloads bitwise equal, launches
             equal; each run's exchange windows and phases read from its
             trace); the measured split of one packed exchange from its
             CUDA events (the phases and the glue adding up to the window
             within 0.1 ms), the exchange with a span recorder against
             without (within 0.2 ms) and the trainer's consensus_err
             metric alone; a 2-step ``--checkpoint-every 2``
             run loaded into a fresh state and run through steps 3-4,
             bitwise equal to a 4-step run, async at staleness 1, with
             the bytes and seconds of save and load; 3 steps of
             ``--microbatches 2`` beside 1, its gradient bitwise the two
             halves' gradients added and halved;
             then the consensus ring over processes
             (``phase_process_ring``): gloo ranks, all on cuda:0, each
             training one node of the full smollm-135m through
             ``train.main --process-ring``, its payloads crossing
             loopback TCP through pinned host buffers: 4 ranks for 3
             steps of int8 packed, int8 pipelined over 4 units, int2
             packed, dgd and int8 async s1, and 3 of the directed
             push-sum ring on the adaptive grid at loss 0.2, per-leaf
             and async s1 with 20% stragglers; 9 of the churn schedule
             on async s1 (rank 2 out for steps 5-8: it launches and sends
             nothing there; resyncs at 5 and 9; ``active_nodes`` 4, 3, 4),
             4 of pods of 2 packed (each rank adds its partner's fp32
             delta, then runs the outer exchange as its pod's replica),
             and int8 async s1 also saving its last step with
             ``--checkpoint-dir`` (one file, the stacked checkpoint's
             size, each rank's rows loaded back equal to the stacked
             fingerprints); 5 ranks for 5 steps of
             strides 1,2 (period 2) on async s1, resyncs at steps 3 and
             5.  Each run mirrors a stacked run of an earlier phase,
             whose fingerprints it kept (dgd's runs here): its
             fixed-input exchange (step 1) equal on every rank to the
             stacked exchange's row (payload bytes of each unit or leaf,
             state, x_next, by fingerprint), each rank's launches exact
             (#1 / #2, #5 / #6 once per unit and step, #3 / #4 once per
             leaf), the per-node losses, parameters and consensus state
             bitwise the stacked run's, the static wire bytes and the
             measured bytes sent equal to the stacked accounting (a
             resync's fp32 x_tilde apart, at its steps only), nothing in
             flight after a run; step time, the inner sum's and the node
             sum's wire time, the exchange's split
             (quantize, device-to-host copy, gloo transfer, host-to-device
             copy, dequant_combine, glue), the loopback rate, each rank's
             peak memory and the card's free memory, and per step the
             async run's wait at the retire and its flight's
             posted-to-landed beside int8 packed's wait;
4. serve   — ``repro_torch.launch.serve.main`` on the full smollm-135m:
             32 prompts of 1,984 tokens and 64 new tokens (capacity 2,048,
             a 3.0 GB float32 KV cache): the flash-decode kernel launched
             30 x 63 times and no other kernel, every token in range, and
             for 2 sequences the decode logits within SERVE_LOGIT_TOL of a
             train-mode forward over the generated sequence; then
             ``torch.profiler`` (CPU and CUDA) over steady decode steps of
             the same batch: the top kernels by device time, the flash-
             decode kernel's share of the step and the device's idle share;
4b. zoo    — the dense model zoo at full width on random weights from
             seed 0 (``phase_zoo``), each model freed before the next:
             ``serve.main`` on gemma2-9b at 5 of its 21 periods (10
             layers, 4 x 6,080 + 64 tokens), gemma2-9b ``--long-serve``
             at 2 periods (1 x 32,832 + 64: the 32,768 cap of its 'A'
             blocks bites), yi-9b at 12 of its 48 layers (8 x 1,984 +
             64), chameleon-34b at 3 of its 48 layers (4 x 1,984 + 64)
             and qwen3-0.6b at 7 of its 28 layers (32 x 1,984 + 64),
             each counted: #9 launched layers x 63 times
             and no other kernel, tokens in range, the decode logits of 2
             sequences within ZOO_LOGIT_TOL of a train-mode forward (and
             for long-serve, apart from the uncapped one), and one decode
             step through the plain #9 within SERVE_LOGIT_TOL of the
             kernel's; prefill seconds, decode ms per token and peak
             memory printed; then the trainer on full qwen3-0.6b, 3 nodes
             x 4 x 512 tokens, int8 packed, 3 steps: #1 and #2 launched 9
             times each and nothing else, every call of them bitwise equal
             to its plain version on the same inputs
             (``KernelVsPlain``), the reference's 1,201,413,120 wire bytes
             per step, a finite loss near ln(151,936);
4c. moe    — the mixture-of-experts family at full width (``phase_moe``),
             each model freed before the next: ``serve.main`` on
             granite-moe-3b-a800m at 8 of its 32 layers (32 x 1,984 + 64
             tokens) and
             deepseek-moe-16b at full depth (its dense 'D' prelude and 27
             'E' periods, 2 x 1,984 + 64), each counted: #9 launched
             layers x 63 times (g 3 hd 64; g 1 hd 128) and no other kernel,
             tokens in range, the share of routed assignments dropped at
             prefill and at the first decode step (``RouteWatch`` on
             ``models.moe.route``); then, on a copy of the config whose
             capacity factor ``n_experts / top_k`` drops nothing, 8
             prompts of 64 tokens each prefilled alone and decoded
             together: nothing dropped, the decode logits within
             ZOO_LOGIT_TOL of a train-mode forward up to each sequence's
             first routing flip, which must be a near tie (margin below
             MOE_TIE_MARGIN), with at least MOE_MIN_COMPARED (252) of the
             504 decode steps compared, and one decode step after 2 of the
             served prompts through the plain #9 within SERVE_LOGIT_TOL of
             the kernel's; the routing
             of one full-width MoE layer of each arch at capacity factor
             1.25 against a per-token loop (chosen experts and kept set
             equal, output within MOE_ORACLE_TOL, some assignments
             dropped); then the trainer on granite-moe-3b-a800m cut to 3
             of 32 periods, 4 nodes x 4 x 512 tokens, int8 packed, 3
             steps: #1 and #2 launched 12 times each and nothing else,
             every call bitwise equal to its plain version, the
             reference's 913,476,864 wire bytes per step, a finite loss
             near ln(49,155) + 0.01 aux and the ``aux`` metric;
4d. ssm    — the state-space family at full width (``phase_ssm``), each
             model freed before the next: ``serve.main`` on mamba2-1.3b at
             12 of its 48 'M' layers at 32 x 2,048 + 64 and 1 x 32,768
             + 64 (prompts a multiple of the 256-token chunk), counted: no
             kernel launched, decode logits within SSM_LOGIT_TOL of a
             train-mode forward (padded to a chunk multiple past the
             compared positions), beside the distance of each from the
             same forward in float64; jamba-v0.1-52b at 1 of its 4 periods
             ('MXMXAXMX', 53 GB of weights), 4 x 2,048 + 64, through the
             MoE run's checks (#9 63 times on its one 'A' layer, the drop
             shares, the no-drop check, a plain-#9 step); then the trainer
             on mamba2-1.3b cut to 8 of 48 periods, 4 nodes x 4 x 512
             tokens, int8 packed, 5 steps: #1 and #2 launched 20 times
             each, every call bitwise equal to its plain version, the
             reference's 624,318,720 wire bytes per step;
4e. whisper — whisper-small at full width and depth (``phase_whisper``:
             12 encoder and 12 decoder layers, d 768): ``serve.main`` on
             32 requests of 1,504 frames and a 384-token prompt + 64 new
             tokens (capacity 448, whisper's decoder context), counted:
             #9 launched 2 x 12 x 63 = 1,512 times (self and cross
             attention per decoder layer and step) and nothing else,
             decode logits of 2 sequences within ZOO_LOGIT_TOL of a
             train-mode forward with the same frames, a plain-#9 step
             within SERVE_LOGIT_TOL, the encoder alone timed with CUDA
             events; then the trainer, 4 nodes x 1 x 1,536 tokens with
             their 1,504 frames, int8 packed, 5 steps: #1 and #2 launched
             20 times each, every call bitwise equal to its plain version,
             the reference's 725,008,896 wire bytes per step, a loss near
             ln(51,865);
4f. precision — the reference's production configuration, bfloat16
             (``phase_precision``; every trainer run of the earlier phases
             passes ``--remat none``, so their rows stay comparable): the
             smollm-135m trainer of phase 2 at ``--compute-dtype bfloat16``
             and ``--remat`` full, dots and none, 2 steps each: #1 and #2
             launched 8 times each, every call bitwise equal to its plain
             version, the reference's 271,160,064 wire bytes per step,
             bfloat16 parameters and float32 shadows after the run, the
             same first loss at every remat choice (later ones within
             PREC_REMAT_LOSS_RTOL), step time and peak memory beside the
             float32 run's; then ``serve.main`` at bfloat16 compute and
             cache on smollm-135m (32 x 1,984 + 64) and on chameleon-34b
             at all 48 layers (4 x 1,984 + 64: 68.59 GB of bfloat16
             weights), counted (#9 once per layer and step, every call on
             bfloat16 K and V), decode logits within BF16_LOGIT_TOL of the
             largest logit of a bfloat16 train-mode forward (smollm-135m's
             also beside a float64 forward), a plain-#9 step within
             BF16_STEP_TOL; #9 is also timed in bfloat16 at both decode
             shapes, at decode_32k, long_500k and whisper-small's cross
             attention, with a sweep of its ranges per row at the serve and
             chameleon-34b shapes (phase 7);
4g. analysis — the cost model (``phase_analysis``): the smollm-135m
             trainer of phase 3 (4 nodes x 4 x 512, int8 packed, remat
             none) counted once on ``meta`` by ``launch.dryrun`` and once
             on the card, both under ``launch.op_cost.CostCounter``:
             equal FLOPs, HBM bytes, launches per aten op and kernel
             calls, #1 and #2 launched 4 times each; the state bytes the
             dry run predicts against ``torch.cuda.memory_allocated()``
             after the real setup is built (within ALLOC_ROUND bytes per
             tensor); the counted TFLOP, 6ND, the useful ratio and the MFU
             against the card's float32 peak from an uncounted step; the
             dry runs of ANALYSIS_DRYRUNS (started after the build, one
             process each, on the host's cores) with their three roofline
             terms and ``fits``; ``measure_consensus_overhead`` on the
             live 4-node state (PROBE_CALLS exchanges, the state bitwise
             unchanged); the trainer CLI for 3 steps with its probe (the
             earlier phases set it aside: ``_no_probe``); the examples at
             reduced size: ``torch_serve_batched`` (#9 launched layers x
             15 times, tokens equal to a run through the plain #9),
             ``torch_decentralized_train`` (#1 / #2 launched 6 x 2 times
             by ADC-DGD alone, wire bytes the static accounting) and
             ``torch_quickstart`` (no kernel; ADC-DGD below direct
             compression);
5. parity  — reduced smollm-135m, 2 steps on the card and on the CPU from
             the same weights and quantization noise, for the int8, int4
             and top-k wires, the per-leaf transport, compressed_dgd
             (packed and per-leaf), plans A and B, plan A pipelined over 3
             chunks and int8 async at staleness 1: final parameters
             agree to float32 rounding but in at most MAX_FRAC_OFF of the
             elements, and those within MAX_GRID_STEPS quantization grid
             steps; losses
             within LOSS_RTOL; and reduced serving (2 prompts of 16 tokens,
             8 new tokens) on the card and on the CPU from the same
             weights: the same tokens, or a flip at a near tie whose
             logits agree within SERVE_LOGIT_TOL; also int8 at ring
             strides (1, 2) re-wired every step (step 2 a resync);
6. paper   — the paper's reference algorithms (``repro_torch.core``) on
             ``paper_circle_problem(20, dim=2^22)`` over the 20-node
             circle, StepSize(0.01, eta=0.5): kernel #3 through
             ``Int8BlockQuantizer`` (163,840 rows, fixed and adaptive)
             with codes and scales equal to its plain version; identity
             ADC-DGD bitwise equal to DGD over 50 steps; then, each launch
             counted, 250 steps each of ADC-DGD int8 fixed and adaptive,
             CompressedDGD int8 adaptive and DGD, and ADC-DGD int8 fixed
             and DGD under a periodic circle/torus schedule and an
             Erdős-Rényi schedule (the stack copied to the card once, the
             bytes billed per step's messages) (kernel #3 launched once
             per compressed step and nothing else launched), with step
             time, final metrics, wire bytes and peak memory; the Fig. 1
             contrast (direct compression at least 10x farther from DGD's
             iterate than ADC-DGD); and 20 ADC-DGD steps through kernel #3
             and through its plain version, bitwise equal, on the circle
             and under each schedule; then
             ``on_wire_plan`` ADC-DGD and CHOCO through plan A on a
             two-leaf ``proj`` + ``norm1`` layout of ~2^22 elements at N 20:
             100 counted steps each (one #5 and one #1 launch per node and
             step), equal cumulative bytes, and 10 ADC-DGD steps through
             the kernels and through their plain versions, bitwise equal;
7. timing  — each kernel and its plain version (``time_calls``: a run of
             back-to-back launches between two CUDA events, queued behind a
             spin kernel so that no host gap lies between them, over the
             count; each wrapper's host time per call on its own line),
             beside the least time the card needs for the bytes and
             operations (H100 SXM data sheet rates); for the flash-decode
             kernel, at the serve shape (over 4 operand sets in turn, so
             K and V are cold in L2) and at decode_32k's (b = 128, S =
             32,768), the library call ``scaled_dot_product_attention`` on
             the same inputs (each layout and backend it takes them in, the
             fastest reported) and a sweep of the ranges per row, and at
             long_500k's shape; the step
             time of each codec, the exchange time of each codec and the
             peak memory; the same for each plan and transport path, with
             the card's clocks, power and temperature sampled beside each
             (``CardSampler``); and the copies an exchange avoids (the
             async ring transfer, combine outputs written in place) timed
             apart at full width.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Needs one card; exits non-zero with no result without one, or
when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 rate outside the
#: tensor cores.  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BLOCK, PAYLOAD = 512, 516
#: 4 x 512 tokens per node per step
NODES, STEPS, SEQ = 4, 5, 512
CODEC_STEPS, ADAPTIVE_STEPS = 3, 6
TIMING_REPS = 25
#: spin-kernel cycles per second: above the H100's highest SM clock
#: (1.98 GHz), so a spin lasts at least the seconds asked for
SPIN_CYCLES_PER_S = 2.0e9

#: bytes one node puts on the ring per step at the main path's 262,752
#: payload rows: 2 x rows x payload width (516, 258, 130 and 130 bytes)
WIRE_BYTES = {"int8": 271_160_064, "int4": 135_580_032,
              "int2": 68_315_520, "topk": 68_315_520}

#: mixed wire plans (``core/wireplan.py``) on the same rows: plan A ships
#: the norms and the embedding (55,366 rows) in int4 and the rest in int8,
#: plan B the embedding in top-k (k 64), the norms in int2 and the rest in
#: int8; the reference's ``wire_bytes_per_step`` of each
PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"
PLAN_WIRE_BYTES = {PLAN_A: 242_591_208, PLAN_B: 228_417_512}
PIPELINE_CHUNKS = 4
_A_PACKED = {"subbyte_encode_payload": 4, "quantize_payload": 4,
             "subbyte_decode_combine": 4, "dequant_combine_payload": 4}
#: launches per step (4 nodes) of each ``phase_plans`` run and adaptive
#: tier, written out as designed: one encode and one combine per node,
#: transfer unit and codec run.  Held beside the counts derived from the
#: port's own plans, so a fault in its run geometry cannot move both.
PLAN_STEP_LAUNCHES = {
    "planA packed": _A_PACKED,
    "planA pipelined": {"subbyte_encode_payload": 4, "quantize_payload": 12,
                        "subbyte_decode_combine": 4,
                        "dequant_combine_payload": 12},
    "planB packed": {"topk_encode_payload": 4, "subbyte_encode_payload": 4,
                     "quantize_payload": 4, "topk_decode_combine": 4,
                     "subbyte_decode_combine": 4,
                     "dequant_combine_payload": 4},
    "int8 packed": {"quantize_payload": 4, "dequant_combine_payload": 4},
    "int8 pipelined": {"quantize_payload": 16, "dequant_combine_payload": 16},
    "int8 async s0": {"quantize_payload": 4, "dequant_combine_payload": 4},
    "int8 async s1": {"quantize_payload": 4, "dequant_combine_payload": 4},
    # adaptive over plan A, by the plan each step ran (plan A's placement:
    # the int4 tier is one merged int4 run, the int2 tier two runs)
    PLAN_A: _A_PACKED,
    "int4": {"subbyte_encode_payload": 4, "subbyte_decode_combine": 4},
    "mixed:norm=int4,embed=int4,*=int2": {"subbyte_encode_payload": 8,
                                          "subbyte_decode_combine": 8},
}

#: the time-varying ring (``phase_strides``): full smollm-135m on 5 nodes,
#: so that stride 2 reaches other nodes than stride 1, at strides (1, 2)
#: held 2 steps each: stride 1 at steps 1-2 and 5, stride 2 at 3-4, and
#: the m_agg resync at steps 3 and 5 (5 steps: the second resync is the
#: last, cut for the script's time)
STRIDE_NODES, STRIDE_STEPS, STRIDE_PERIOD = 5, 5, 2
STRIDE_ARGV = ("--ring-strides", "1,2", "--schedule-period",
               str(STRIDE_PERIOD))
STRIDE_SEQ = [1, 1, 2, 2, 1]
RESYNC_STEPS = (3, 5)
#: the reference's wire bytes per step there: the int8 payload plus the
#: resync's fp32 x_tilde both ways, amortized over the period
#: (2 x rows x 512 x 4 / 2): packed 271,160,064 + 538,116,096, per-leaf
#: 271,292,160 + 538,378,240
STRIDE_WIRE_BYTES = {"packed": 809_276_160, "per_leaf": 809_670_400}
#: each stride run: (extra flags, launches per step as designed (one
#: encode and one combine per node and transfer unit; per leaf on the
#: per-leaf transport), collectives per step by the reference's formula
#: (2 x units + 2 x units / period; per leaf 4 x 11 + 2 x 11 / period))
STRIDE_RUNS = {
    "packed": ((), {"quantize_payload": 5, "dequant_combine_payload": 5},
               3.0),
    "pipelined": (("--wire-packing", "pipelined", "--pipeline-chunks",
                   str(PIPELINE_CHUNKS)),
                  {"quantize_payload": 20, "dequant_combine_payload": 20},
                  12.0),
    "async s0": (("--wire-packing", "async", "--staleness", "0"),
                 {"quantize_payload": 5, "dequant_combine_payload": 5}, 3.0),
    "async s1": (("--wire-packing", "async", "--staleness", "1"),
                 {"quantize_payload": 5, "dequant_combine_payload": 5}, 3.0),
    "per_leaf": (("--wire-packing", "per_leaf"),
                 {"quantize_blocks": 55, "dequant_combine": 55}, 55.0),
}

#: the per-leaf transport: the 11 leaves of the full smollm-135m tree, each
#: padded to its own TILE_N multiple, 262,880 rows in all, so
#: 2 x 262,880 x 516 bytes per step
N_LEAVES, PER_LEAF_WIRE_BYTES = 11, 271_292_160

#: serving: 32 prompts of 1,984 tokens + 64 new tokens fill SmolLM-135M's
#: 2,048 positions; decode_32k (``src/repro/models/config.py:165``) is
#: b = 128 over a 32,768-position cache.  smollm has 3 KV heads of 64 and
#: 3 queries per KV head.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 32, 1984, 64
KVH, GROUP, HEAD_DIM = 3, 3, 64
#: (b, S, kvh, g, hd) of each flash-decode shape held and timed: smollm's
#: heads at the serve and decode_32k shapes, and the longest cache the
#: reference serves (long_500k, ``src/repro/models/config.py:166``) at
#: gemma2-9b's heads (8 KV heads of 256, 2 queries each, softcap 50:
#: ``src/repro/configs/gemma2_9b.py``); K and V are 4.3 GB each in float32
#: The zoo's serve runs (``phase_zoo``) decode at their own heads: qwen3-0.6b
#: (b 32, capacity 2,048, 8 KV heads of 128, g 2), yi-9b (b 8, 4 of 128,
#: g 8), chameleon-34b (b 4, 8 of 128, g 8), gemma2-9b (b 4, capacity
#: 6,144; and long-serve, b 1, capacity 32,896); the MoE runs
#: (``phase_moe``) granite-moe-3b-a800m (b 32, capacity 2,048, 8 KV heads
#: of 64, g 3) and deepseek-moe-16b (b 2, 16 KV heads of 128, g 1: MHA);
#: the state-space run (``phase_ssm``) jamba-v0.1-52b's one 'A' layer per
#: period (b 4, capacity 2,112, 8 KV heads of 128, g 4); whisper-small
#: (``phase_whisper``: b 32, 12 KV heads of 64, g 1) its decoder's
#: self-attention over its 448-position context and its cross attention
#: over 1,504 frames, every one valid
DECODE_SHAPES = {"serve": (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, KVH, GROUP,
                           HEAD_DIM),
                 "decode_32k": (128, 32768, KVH, GROUP, HEAD_DIM),
                 "long_500k": (1, 524288, 8, 2, 256),
                 "qwen3-0.6b": (32, 2048, 8, 2, 128),
                 "yi-9b": (8, 2048, 4, 8, 128),
                 "chameleon-34b": (4, 2048, 8, 8, 128),
                 "gemma2-9b": (4, 6144, 8, 2, 256),
                 "gemma2-9b long-serve": (1, 32896, 8, 2, 256),
                 "granite-moe-3b-a800m": (32, 2048, 8, 3, 64),
                 "deepseek-moe-16b": (2, 2048, 16, 1, 128),
                 "jamba-v0.1-52b": (4, 2112, 8, 4, 128),
                 "whisper-small": (32, 448, 12, 1, 64),
                 "whisper-small cross": (32, 1504, 12, 1, 64)}
#: the softcap each shape is also held with (gemma2-9b's own is 50)
DECODE_SOFTCAP = {"serve": 30.0, "decode_32k": 30.0, "long_500k": 50.0,
                  "qwen3-0.6b": 30.0, "yi-9b": 30.0, "chameleon-34b": 30.0,
                  "gemma2-9b": 50.0, "gemma2-9b long-serve": 50.0,
                  "granite-moe-3b-a800m": 30.0, "deepseek-moe-16b": 30.0,
                  "jamba-v0.1-52b": 30.0, "whisper-small": 30.0,
                  "whisper-small cross": 30.0}
#: the sliding window a shape's masks also take: gemma2-9b's 'L' blocks
#: (4,096), and the long-serve cap of its 'A' blocks (32,768)
DECODE_WINDOW = {"long_500k": 4096, "gemma2-9b": 4096,
                 "gemma2-9b long-serve": 32768}
#: the shapes a decode reads whole: a cross attention sees every frame, so
#: they are also held, and timed, on an all-valid mask
DECODE_ALL_VALID = ("whisper-small cross",)
#: the flash-decode partials against their plain version, on acc / l and
#: on m + log l (the reference's float32 kernel-test tolerances).  bf16
#: K and V widen to float32 exactly on both sides, which then sum in
#: float32 (the kernel's tensor cores multiply exact bfloat16 slices of q
#: and p, each product exact in float32), so bf16 inputs are held to the
#: same bounds: only the order and rounding of the sums differ
DECODE_TOL = (1e-5, 5e-5)
#: decode logits against a train-mode forward, and card against CPU in
#: serving (the CPU test's tolerance, absolute and relative)
SERVE_LOGIT_TOL = 1e-5

#: card-vs-CPU parity: float32 matmuls sum in other orders on the two
#: devices, so now and then a stochastic rounding lands on the other side
#: of its threshold and moves one element by one grid step (fixed_step0 at
#: step 1); every other element agrees to float32 rounding (FLOAT_ATOL on
#: parameters of magnitude below 1)
MAX_GRID_STEPS, MAX_FRAC_OFF, FLOAT_ATOL, LOSS_RTOL = 2.0, 1e-4, 1e-6, 1e-5


#: wall seconds of each phase that ``main`` called itself, in call order
PHASE_S = {}
_PHASE_DEPTH = [0]


def time_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that it prints
    its wall seconds when it returns ("[time]"); the phases ``main`` calls
    itself (not those a phase calls) are kept in ``PHASE_S``."""
    import functools

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            _PHASE_DEPTH[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                _PHASE_DEPTH[0] -= 1
                s = time.perf_counter() - t0
                if not _PHASE_DEPTH[0]:
                    PHASE_S[name] = PHASE_S.get(name, 0.0) + s
                print(f"[time] {name}: {s:.1f} s", flush=True)
        return timed
    g = globals()
    for name in [n for n in g if n.startswith("phase_")]:
        g[name] = wrap(name, g[name])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors of finite values."""
    import torch
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    # map the sign-magnitude float order onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


class CardSampler:
    """The card's SM and memory clocks, power draw, temperature and clock
    event reasons, read through NVML (``libnvidia-ml``, the library under
    ``nvidia-smi``) every SAMPLE_S from a thread while the ``with`` body
    runs: a few microseconds of host time per sample.  ``summary()`` gives
    their ranges, to set beside a host-bound time."""

    SAMPLE_S = 0.1

    def __enter__(self):
        import ctypes
        import threading
        self.rows, self._stop, self._thread = [], threading.Event(), None
        try:
            self._nvml = ctypes.CDLL("libnvidia-ml.so.1")
            self._h = ctypes.c_void_p()
            if self._nvml.nvmlInit_v2() != 0 \
                    or self._nvml.nvmlDeviceGetHandleByIndex_v2(
                        0, ctypes.byref(self._h)) != 0:
                return self
        except (OSError, AttributeError):
            return self     # no NVML: summary() says so
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self) -> None:
        import ctypes
        nv, h = self._nvml, self._h
        reasons_fn = (getattr(nv, "nvmlDeviceGetCurrentClocksEventReasons",
                              None)
                      or nv.nvmlDeviceGetCurrentClocksThrottleReasons)
        sm, mem, mw, temp = (ctypes.c_uint() for _ in range(4))
        reasons = ctypes.c_ulonglong()
        while not self._stop.is_set():
            if (nv.nvmlDeviceGetClockInfo(h, 1, ctypes.byref(sm))
                    | nv.nvmlDeviceGetClockInfo(h, 2, ctypes.byref(mem))
                    | nv.nvmlDeviceGetPowerUsage(h, ctypes.byref(mw))
                    | nv.nvmlDeviceGetTemperature(h, 0, ctypes.byref(temp))
                    | reasons_fn(h, ctypes.byref(reasons))) == 0:
                self.rows.append((sm.value, mem.value, mw.value / 1e3,
                                  temp.value, reasons.value))
            self._stop.wait(self.SAMPLE_S)

    def __exit__(self, *exc) -> bool:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._nvml.nvmlShutdown()
        return False

    def summary(self) -> str:
        if not self.rows:
            return "clocks and power not read"
        sm, mem, power, temp, reasons = zip(*self.rows)
        seen = 0
        for r in reasons:
            seen |= r
        return (f"SM clock {min(sm)}-{max(sm)} MHz (median "
                f"{statistics.median(sm):.0f}), memory clock {min(mem)}-"
                f"{max(mem)} MHz, power {min(power):.1f}-{max(power):.1f} W, "
                f"<= {max(temp)} C, clock event reasons {seen:#x}, over "
                f"{len(self.rows)} samples")


def time_calls(fn, reps: int = TIMING_REPS) -> tuple[float, float, bool]:
    """(device ms, host ms, gapless) per call of ``fn``, or of a list of
    callables taken in turn (distinct operands, so that each call finds
    them cold in the 50 MB L2).  After a warm-up call of each, ``reps``
    back-to-back calls sit between two CUDA events, queued behind a spin
    kernel long enough that the host has enqueued them all before the
    first starts: the device time then holds no host gap (``gapless``).
    The host time is the wall time of enqueueing them (the wrapper's own
    work), measured meanwhile.  A callable that waits for the device (a
    plain version that reads a result back) ends the spin at its first
    call: its time then includes its host work, and ``gapless`` is
    False."""
    import torch
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    t0 = time.perf_counter()
    for f in fns:
        f()
    torch.cuda.synchronize()
    spin_s = 2.0 * reps * (time.perf_counter() - t0) / len(fns) + 2e-3
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        fns[0]()
        waits = start.query()      # the first call waited out the spin
        for i in range(1, reps):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        ran_ahead = start.query()  # the spin ended before the last enqueue
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        if waits or not ran_ahead:
            break
        spin_s *= 4
    return ms, host_ms, not ran_ahead


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device ms per call (``time_calls``)."""
    return time_calls(fn, reps)[0]


def kernel_time(name, fn, reps: int = TIMING_REPS) -> float:
    """Device ms per call of a kernel's wrapper, with no host gap between
    launches (a wrapper never waits for the device), and its host time on
    a line of its own."""
    ms, host_ms, gapless = time_calls(fn, reps)
    if not gapless:
        fail(f"timing {name}: the wrapper waited for the device, or the "
             "host could not run ahead of it")
    print(f"[timing] {name}: wrapper host time {host_ms:.4f} ms per call "
          f"(device {ms:.4f} ms)")
    return ms


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_rows(train) -> tuple[int, list[int]]:
    """Payload rows per node of the main path, and the padded rows of each
    leaf on the per-leaf transport: the wire layout of the full smollm-135m
    parameter tree (shapes only, on the ``meta`` device)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.kernels.ops import padded_block_rows
    from repro_torch.models.params import meta_params
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    params = T.tree_map(lambda a: a.expand((NODES,) + a.shape),
                        meta_params(setup.defs.storage))
    layout = setup.consensus.state_layout(params)
    return layout.n_rows, [padded_block_rows(s.size) for s in layout.slots]


def decoded(Q, payload):
    """The values a payload carries: codes times their row's scale."""
    codes, scales = Q.unpack_payload(payload)
    return codes.float() * scales


def phase_kernels(torch, Q, D, n_rows):
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    # differentials at the scale the trainer produces them (lr * grad),
    # with heavy tails so the fixed grid also clips
    y = torch.randn((n_rows, BLOCK), generator=g, device=dev) * 0.05
    u = torch.rand((n_rows, BLOCK), generator=g, device=dev)
    ragged = dict(row_offset=37, n_rows=1001)
    q_abs = 0.0
    for dt in (torch.float32, torch.bfloat16):
        yy = y.to(dt)
        for step in (None, 1e-3):
            for view in ({}, ragged):
                a = Q.quantize_payload(yy, u, step, **view)
                b = Q.quantize_payload_plain(yy, u, step, **view)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    fail(f"quantize_payload {dt} step={step} view={view}: "
                         f"{int((a != b).sum())} bytes differ from the "
                         "plain version")
                q_abs = max(q_abs, float((decoded(Q, a) - decoded(Q, b))
                                         .abs().max()))
    print(f"[kernels] quantize_payload: bytes equal to the plain version "
          f"(fixed+adaptive, f32+bf16, full {n_rows} rows + ragged view), "
          f"max |decoded diff| {q_abs}")
    pays = [Q.quantize_payload(y * (i + 1), u, None) for i in range(3)]
    xt = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    mb = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    worst_ulp, worst_abs = 0, 0.0
    cases = [(pays, {}), ([p[37:1038].contiguous() for p in pays], ragged),
             (pays, ragged)]
    for deamp in (1.0, 0.37):
        for ps, view in cases:
            a = D.dequant_combine_payload(*ps, xt, mb, 0.5, 0.25, deamp,
                                          **view)
            b = D.dequant_combine_payload_plain(*ps, xt, mb, 0.5, 0.25,
                                                deamp, **view)
            torch.cuda.synchronize()
            for x, z in zip(a, b):
                worst_ulp = max(worst_ulp, ulp_diff(x, z))
                worst_abs = max(worst_abs, float((x - z).abs().max()))
    if worst_ulp > 1:
        fail(f"dequant_combine_payload differs from the plain version by "
             f"{worst_ulp} ulp")
    why = ("bitwise equal" if worst_ulp == 0 else
           "1 ulp: a product/sum rounded in another order")
    print(f"[kernels] dequant_combine_payload: {why} (max ulp {worst_ulp})")
    return {"quantize_payload": q_abs, "dequant_combine_payload": worst_abs}


def phase_codec_kernels(torch, BP, n_rows):
    """The sub-byte and top-k encoders and combines against their plain
    versions at the main path's rows and on a ragged chunk view."""
    from repro_torch.core.codec import by_name
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    y = torch.randn((n_rows, BLOCK), generator=g, device=dev) * 0.05
    # one noise buffer of top-k's width; the sub-byte encoders read its
    # leading BLOCK columns through the row stride
    u = torch.rand((n_rows, 2 * BLOCK), generator=g, device=dev)
    ragged = dict(row_offset=37, n_rows=1001)
    errs = {}
    for name, kernel, plain, decode, params in (
            ("subbyte_encode_payload", BP.subbyte_encode_payload,
             BP.subbyte_encode_plain, BP.subbyte_decode_plain, (4, 2)),
            ("topk_encode_payload", BP.topk_encode_payload,
             BP.topk_encode_plain, BP.topk_decode_plain, (8, 16, 64, 256))):
        worst = 0.0
        for param in params:
            for dt in (torch.float32, torch.bfloat16):
                yy = y.to(dt)
                for step in (None, 1e-3):
                    for view in ({}, ragged):
                        a = kernel(yy, u, param, step, **view)
                        b = plain(yy, u, param, step, **view)
                        torch.cuda.synchronize()
                        if not torch.equal(a, b):
                            fail(f"{name} {param} {dt} step={step} "
                                 f"view={view}: {int((a != b).any(1).sum())}"
                                 " rows differ from the plain version")
                        worst = max(worst, float(
                            (decode(a, param) - decode(b, param)).abs().max()))
        errs[name] = worst
        print(f"[kernels] {name}: bytes equal to the plain version for "
              f"{params} (fixed+adaptive, f32+bf16, full {n_rows} rows + "
              f"ragged view), max |decoded diff| {worst}")
    xt = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    mb = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    for name, codecs in (("subbyte_decode_combine", ("int4", "int2")),
                         ("topk_decode_combine",
                          ("topk:k=16", "topk", "topk:k=256"))):
        worst_ulp, worst_abs = 0, 0.0
        for spec in codecs:
            cd = by_name(spec)
            param = getattr(cd, "code_bits", None) or cd.k
            plain = (BP.subbyte_combine_plain if name.startswith("subbyte")
                     else BP.topk_combine_plain)
            pays = [cd.encode_payload(y * (i + 1), u, 1e-3) for i in range(3)]
            cases = [(pays, {}),
                     ([p[37:1038].contiguous() for p in pays], ragged),
                     (pays, ragged)]
            for deamp in (1.0, 0.37):
                for ps, view in cases:
                    a = cd.decode_combine(*ps, xt, mb, 0.5, 0.25, deamp,
                                          **view)
                    b = plain(*ps, xt, mb, 0.5, 0.25, deamp, param, **view)
                    torch.cuda.synchronize()
                    for x, z in zip(a, b):
                        worst_ulp = max(worst_ulp, ulp_diff(x, z))
                        worst_abs = max(worst_abs, float((x - z).abs().max()))
        if worst_ulp > 1:
            fail(f"{name} differs from the plain version by {worst_ulp} ulp")
        why = ("bitwise equal" if worst_ulp == 0 else
               "1 ulp: a product/sum rounded in another order")
        print(f"[kernels] {name} {codecs}: {why} (max ulp {worst_ulp})")
        errs[name] = worst_abs
    return errs


def phase_block_kernels(torch, Q, D, leaf_rows):
    """The per-leaf quantizer and combine against their plain versions on
    each leaf's padded rows of the full smollm-135m tree."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    total = sum(leaf_rows)
    y = torch.randn((total, BLOCK), generator=g, device=dev) * 0.05
    u = torch.rand((total, BLOCK), generator=g, device=dev)
    xt = torch.randn((total, BLOCK), generator=g, device=dev)
    mb = torch.randn((total, BLOCK), generator=g, device=dev)
    spans, r0 = [], 0
    for n in leaf_rows:
        spans.append((r0, n))
        r0 += n
    q_abs = 0.0
    for dt in (torch.float32, torch.bfloat16):
        yy = y.to(dt)
        for step in (None, 1e-3):
            for r0, n in spans:
                a = Q.quantize_blocks(yy[r0:r0 + n], u[r0:r0 + n], step)
                b = Q.quantize_blocks_plain(yy[r0:r0 + n], u[r0:r0 + n],
                                            step)
                torch.cuda.synchronize()
                if not (torch.equal(a[0], b[0]) and torch.equal(
                        a[1].view(torch.int32), b[1].view(torch.int32))):
                    fail(f"quantize_blocks {dt} step={step} rows {n}: "
                         f"{int((a[0] != b[0]).sum())} codes and "
                         f"{int((a[1] != b[1]).sum())} scales differ from "
                         "the plain version")
                q_abs = max(q_abs, float((a[0].float() * a[1]
                                          - b[0].float() * b[1])
                                         .abs().max()))
    print(f"[kernels] quantize_blocks: codes and scales equal to the plain "
          f"version on each of the {len(spans)} leaves' padded rows "
          f"({total} in all; fixed+adaptive, f32+bf16), max |decoded "
          f"diff| {q_abs}")
    worst_ulp, worst_abs = 0, 0.0
    for r0, n in spans:
        sides = []
        for i in range(3):
            sides += Q.quantize_blocks(y[r0:r0 + n] * (i + 1), u[r0:r0 + n])
        for deamp in (1.0, 0.37):
            a = D.dequant_combine(*sides, xt[r0:r0 + n], mb[r0:r0 + n], 0.5,
                                  0.25, deamp)
            b = D.dequant_combine_plain(*sides, xt[r0:r0 + n],
                                        mb[r0:r0 + n], 0.5, 0.25, deamp)
            torch.cuda.synchronize()
            for x, z in zip(a, b):
                worst_ulp = max(worst_ulp, ulp_diff(x, z))
                worst_abs = max(worst_abs, float((x - z).abs().max()))
    if worst_ulp > 1:
        fail(f"dequant_combine differs from the plain version by "
             f"{worst_ulp} ulp")
    why = ("bitwise equal" if worst_ulp == 0 else
           "1 ulp: a product/sum rounded in another order")
    print(f"[kernels] dequant_combine: {why} on each leaf's padded rows "
          f"(max ulp {worst_ulp})")
    return {"quantize_blocks": q_abs, "dequant_combine": worst_abs}


def decode_inputs(torch, b, seq, dtype, seed, kvh=KVH, grp=GROUP,
                  hd=HEAD_DIM):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, kvh, grp, hd), (b, seq, kvh, hd),
                               (b, seq, kvh, hd)))


def decode_invariants(torch, m, l, acc):
    """acc / l and m + log l: what any order of summation keeps."""
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def holes_mask(torch, seq, seed):
    """An arbitrary mask: about 30% of the positions valid at random, and
    every 128-position block whose index is 1 mod 3 masked, so that fully
    masked tiles lie between valid ones."""
    import numpy as np
    pos = np.arange(seq)
    valid = ((np.random.default_rng(seed).random(seq) < 0.3)
             & ((pos // 128) % 3 != 1))
    return torch.from_numpy(valid).to("cuda")


def decode_masks(torch, shape, seq):
    """The masks a shape is held on: a frontier inside a tile, random
    holes, the later tiles fully masked (except at long_500k), and a sliding
    window before the frontier where the shape has one (the decode mask
    ``gpos > pos - window``)."""
    pos = torch.arange(seq, device="cuda")
    masks = {"frontier": pos < seq - 37, "holes": holes_mask(torch, seq, seq)}
    if shape in DECODE_WINDOW:
        w = DECODE_WINDOW[shape]
        masks[f"window {w}"] = (pos < seq - 37) & (pos > seq - 38 - w)
    if shape in DECODE_ALL_VALID:
        masks["all valid"] = pos >= 0
    if shape != "long_500k":
        masks["masked tiles"] = pos < seq // 2 + 201
    return masks


#: the operand types #9 is held in: (name, q, K and V); a float32 q over a
#: bfloat16 cache is float32 compute with ``--cache-dtype bfloat16``
DECODE_DTYPES = (("f32", "float32", "float32"), ("bf16", "bfloat16",
                                                 "bfloat16"),
                 ("f32 q over bf16", "float32", "bfloat16"))


def phase_decode_kernel(torch, G):
    """The flash-decode kernel against its plain version at each of
    DECODE_SHAPES: float32, bf16, and a float32 q over a bf16 cache, with
    and without the shape's softcap, on each of its masks; the grid each
    kernel launches."""
    worst = 0.0
    for shape, (b, seq, kvh, grp, hd) in DECODE_SHAPES.items():
        masks = decode_masks(torch, shape, seq)
        grids = {}
        for dname, qdt, kvdt in DECODE_DTYPES:
            q, k, v = decode_inputs(torch, b, seq, getattr(torch, qdt), seq,
                                    kvh, grp, hd)
            if kvdt != qdt:                 # q stays the float32 draw
                k, v = k.to(getattr(torch, kvdt)), v.to(getattr(torch, kvdt))
            grids[dname] = G.decode_grid(q, k)
            tol, lse_tol = DECODE_TOL
            for cap in (None, DECODE_SOFTCAP[shape]):
                for mask_name, valid in masks.items():
                    got = G.gqa_decode(q, k, v, valid, softcap=cap)
                    want = G.gqa_decode_plain(q, k, v, valid, softcap=cap)
                    torch.cuda.synchronize()
                    (o, lse), (wo, wlse) = (decode_invariants(torch, *got),
                                            decode_invariants(torch, *want))
                    err = float((o - wo).abs().max())
                    lse_err = float((lse - wlse).abs().max())
                    if not (torch.allclose(o, wo, atol=tol, rtol=tol)
                            and lse_err <= lse_tol):
                        fail(f"gqa_decode {shape} {dname} softcap={cap} "
                             f"{mask_name}: |out diff| {err}, |lse diff| "
                             f"{lse_err} (tolerances {tol}, {lse_tol})")
                    worst = max(worst, err)
                    del got, want
            del q, k, v
            torch.cuda.empty_cache()
        grid = "; ".join(
            f"{d}: {nr} ranges of {rl} positions per row, {ctas} CTAs per "
            f"SM, {cl} clusters of {nr} resident at once"
            for d, (rl, nr, ctas, cl) in grids.items())
        print(f"[kernels] gqa_decode {shape} (b={b}, S={seq}, kvh={kvh}, "
              f"g={grp}, hd={hd}): within tolerance of the plain version "
              f"({', '.join(grids)}; softcap none+"
              f"{DECODE_SOFTCAP[shape]:g}; {', '.join(masks)}); {grid}")
    return {"gqa_decode": worst}


#: the two kernels each codec's exchange launches
CODEC_KERNELS = {
    "int8": ("quantize_payload", "dequant_combine_payload"),
    "int4": ("subbyte_encode_payload", "subbyte_decode_combine"),
    "int2": ("subbyte_encode_payload", "subbyte_decode_combine"),
    "topk": ("topk_encode_payload", "topk_decode_combine"),
}


#: every trainer run of the phases before ``phase_precision`` keeps its
#: activations (the trainer's default, the reference's, is full
#: recompute): their times and peaks stay comparable with earlier runs
NO_REMAT = ("--remat", "none")


def train_argv(steps: int, *extra: str) -> list[str]:
    return ["--arch", "smollm-135m", "--algorithm", "adc_dgd", "--nodes",
            str(NODES), "--batch", str(4 * NODES), "--seq", str(SEQ),
            "--steps", str(steps), "--quant-mode", "fixed", "--lr", "1e-2",
            "--device", "cuda", *NO_REMAT, *extra]


def run_counted(torch, train, entries, argv, **kw):
    """One trainer run with every launch counter zeroed just before it and
    read just after; also its peak device memory."""
    for entry in entries.values():
        entry.launches = 0
    torch.cuda.reset_peak_memory_stats()
    hist = train.main(argv, **kw)
    launches = {name: entry.launches for name, entry in entries.items()}
    return hist, launches, torch.cuda.max_memory_allocated() / 1e9


def expected_launches(entries, codecs) -> dict:
    """Launches per kernel for a run whose steps used ``codecs``."""
    want = {name: 0 for name in entries}
    for codec in codecs:
        for name in CODEC_KERNELS[codec]:
            want[name] += NODES
    return want


def phase_main(torch, train, entries):
    main_launches = {name: 0 for name in entries}
    step_s, peak_gb, first_loss = {}, {}, {}
    for codec, steps in (("int8", STEPS), ("int4", CODEC_STEPS),
                         ("int2", CODEC_STEPS), ("topk", CODEC_STEPS)):
        extra = () if codec == "int8" else ("--wire-codec", codec)
        (hist, state), launches, peak_gb[codec] = run_counted(
            torch, train, entries, train_argv(steps, *extra),
            return_state=True)
        if codec == "int2":
            keep_stacked(torch, "int2 packed", hist, state)
        del state
        want = expected_launches(entries, [codec] * steps)
        if launches != want:
            fail(f"{codec} run launched {launches}, want {want} "
                 f"({NODES} nodes x {steps} steps of its two kernels)")
        for name in CODEC_KERNELS[codec]:
            main_launches[name] += launches[name]
        losses = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{codec}: non-finite loss: {losses}")
        if abs(losses[0] - math.log(49152)) > 0.5:
            fail(f"{codec}: step-1 loss {losses[0]} far from ln(49152) at "
                 "random init")
        wire = hist[-1]["wire_bytes_per_step"]
        if wire != WIRE_BYTES[codec] or {h["codec"] for h in hist} != {codec}:
            fail(f"{codec}: wire_bytes_per_step {wire} (want "
                 f"{WIRE_BYTES[codec]}), codecs {[h['codec'] for h in hist]}")
        step_s[codec] = statistics.median(h["step_s"] for h in hist[1:])
        first_loss[codec] = losses[0]
        print(f"[main] smollm-135m x {NODES} nodes, adc_dgd fixed, "
              f"{codec} wire: losses {losses}; launches "
              f"{ {n: v for n, v in launches.items() if v} }; "
              f"wire_bytes_per_step {wire:.0f}; overflow_frac "
              f"{[h['overflow_frac'] for h in hist]}; median step "
              f"{step_s[codec]:.4f} s; peak memory {peak_gb[codec]:.2f} GB")
    hist, launches, _ = run_counted(
        torch, train, entries, train_argv(
            ADAPTIVE_STEPS, "--wire-codec", "adaptive", "--codec-ladder",
            "int2,int4,int8", "--codec-period", "2"))
    codecs = [h["codec"] for h in hist]
    want = expected_launches(entries, codecs)
    if launches != want or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"adaptive codec run: codecs per step {codecs}, launches "
             f"{launches}, want {want}, losses {[h['loss'] for h in hist]}")
    print(f"[main] adaptive codec (ladder int2,int4,int8, period 2): codec "
          f"per step {codecs}; launches "
          f"{ {n: v for n, v in launches.items() if v} } match them")
    hist_a = train.main(["--arch", "smollm-135m", "--nodes", str(NODES),
                         "--batch", str(4 * NODES), "--seq", "512",
                         "--steps", "2", "--quant-mode", "adaptive",
                         "--lr", "1e-2", "--device", "cuda", *NO_REMAT])
    if not all(math.isfinite(h["loss"]) for h in hist_a):
        fail(f"non-finite adaptive-mode loss: {hist_a}")
    print(f"[main] adaptive mode: losses {[h['loss'] for h in hist_a]}")
    return main_launches, step_s, peak_gb, first_loss


def codec_kernels(codec: str) -> tuple[str, str]:
    """The encode and combine kernels of one codec name of a plan."""
    return CODEC_KERNELS["topk" if codec.startswith("topk") else codec]


def full_plan(train, spec, layout_spec=None):
    """The WirePlan of ``spec`` on the full smollm-135m x 4-node layout
    (shapes only), placed by ``layout_spec``'s codec groups (default
    ``spec``'s own), as the trainer builds it."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.core import wireplan
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    from repro_torch.models.params import meta_params
    rt = ConsensusRuntime(ConsensusConfig(wire_codec=spec), NODES,
                          layout_spec=layout_spec and wireplan.parse_spec(
                              layout_spec))
    defs = train.build_train_setup(get_config("smollm-135m"),
                                   consensus_nodes=NODES, device="cuda").defs
    params = T.tree_map(lambda a: a.expand((NODES,) + a.shape),
                        meta_params(defs.storage))
    return rt.wire_plan_for(rt.state_layout(params))


def plan_launches(entries, plan, units=None) -> dict:
    """Launches of one step on ``plan``: per node, one encode and one
    combine for each codec run of each transfer unit."""
    want = {name: 0 for name in entries}
    for unit in plan.transfer_units(units):
        for f in plan.unit_runs(unit):
            for name in codec_kernels(f.codec):
                want[name] += NODES
    return want


def host_state(state) -> dict:
    """A run's final parameters and consensus state, copied to the host so
    that the card holds nothing of it while later runs' peaks are read."""
    from repro_torch.core import tree as T
    return {"params": T.tree_map(lambda a: a.cpu(), state["params"]),
            "consensus": {k: v.cpu() for k, v in state["consensus"].items()}}


def same_state(torch, a, b) -> bool:
    """Final parameters, x_tilde and m_agg of two runs bitwise equal."""
    from repro_torch.core import tree as T
    return (all(torch.equal(x, y) for x, y in zip(T.tree_leaves(a["params"]),
                                                   T.tree_leaves(b["params"])))
            and all(torch.equal(a["consensus"][k], b["consensus"][k])
                    for k in ("x_tilde", "m_agg")))


#: the plans' runs that the process ring mirrors, by their ring labels
PLAN_RING_LABELS = {"int8 packed": "int8 packed",
                    "int8 pipelined": "int8 pipelined 4",
                    "int8 async s1": "int8 async s1"}


def phase_plans(torch, Q, train, entries, n_rows):
    """Mixed wire plans and the pipelined and async transports on the full
    smollm-135m x 4 nodes, each run counted on its own: plan A packed and
    pipelined (bitwise equal), plan B packed (after #1 on a 1,024-column
    noise buffer against its plain version), uniform int8 packed,
    pipelined and async at staleness 0 (all three bitwise equal) and 1,
    and the adaptive controller over plan A.  Returns (launches, step
    seconds, peak GB, #1's decoded error on the wide buffer)."""
    launches_total = {name: 0 for name in entries}
    step_s, peak_gb = {}, {}
    pipelined = ("--wire-packing", "pipelined", "--pipeline-chunks",
                 str(PIPELINE_CHUNKS))

    def counted(label, wire, *extra):
        argv = train_argv(CODEC_STEPS, *(("--wire-plan", wire)
                                         if wire != "int8" else ()), *extra)
        with CardSampler() as card:
            (hist, state), launches, peak_gb[label] = run_counted(
                torch, train, entries, argv, return_state=True)
        units = PIPELINE_CHUNKS if "pipelined" in extra else None
        per_step = plan_launches(entries, full_plan(train, wire), units)
        if {n: v for n, v in per_step.items() if v} \
                != PLAN_STEP_LAUNCHES[label]:
            fail(f"{label}: the port's plan gives {per_step} launches per "
                 f"step, designed {PLAN_STEP_LAUNCHES[label]}")
        want = {name: CODEC_STEPS * n for name, n in per_step.items()}
        if launches != want:
            fail(f"{label}: launched {launches}, want {want}")
        losses = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in losses) \
                or abs(losses[0] - math.log(49152)) > 0.5:
            fail(f"{label}: losses {losses}")
        want_bytes = PLAN_WIRE_BYTES.get(wire, WIRE_BYTES["int8"])
        coll = {h["collectives_per_step"] for h in hist}
        if {h["wire_bytes_per_step"] for h in hist} != {want_bytes} \
                or coll != {2.0 * (units or 1)}:
            fail(f"{label}: wire_bytes_per_step "
                 f"{[h['wire_bytes_per_step'] for h in hist]} (want "
                 f"{want_bytes}), collectives {sorted(coll)}")
        for name, n in launches.items():
            launches_total[name] += n
        step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
        if label in PLAN_RING_LABELS:
            keep_stacked(torch, PLAN_RING_LABELS[label], hist, state)
        print(f"[plans] {label}: {CODEC_STEPS} steps, losses {losses}; "
              f"launches per step "
              f"{ {n: v for n, v in per_step.items() if v} }; "
              f"wire_bytes_per_step {want_bytes}; collectives "
              f"{sorted(coll)}; overflow_frac "
              f"{[h['overflow_frac'] for h in hist]}; median step "
              f"{step_s[label]:.4f} s; peak memory {peak_gb[label]:.2f} GB; "
              f"card: {card.summary()}", flush=True)
        return host_state(state)

    pa = counted("planA packed", PLAN_A)
    pp = counted("planA pipelined", PLAN_A, *pipelined)
    if not same_state(torch, pa, pp):
        fail("plan A pipelined over 4 chunks differs from plan A packed")
    print("[plans] plan A pipelined (4 chunks) == plan A packed bitwise "
          "(params, x_tilde, m_agg)")
    del pa, pp

    # #1 on the shared 1,024-column noise buffer plan B hands it
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    y = torch.randn((n_rows, BLOCK), generator=g, device="cuda") * 0.05
    u = torch.rand((n_rows, 2 * BLOCK), generator=g, device="cuda")
    wide_abs = 0.0
    for step in (None, 1e-3):
        for view in ({}, dict(row_offset=37, n_rows=1001)):
            a = Q.quantize_payload(y, u, step, **view)
            b = Q.quantize_payload_plain(y, u, step, **view)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"quantize_payload on 1,024-column noise step={step} "
                     f"view={view}: {int((a != b).sum())} bytes differ")
            wide_abs = max(wide_abs, float((decoded(Q, a) - decoded(Q, b))
                                           .abs().max()))
    u8 = u[:, :BLOCK].contiguous()
    ms_wide = kernel_time("quantize_payload, 1,024-column noise",
                          lambda: Q.quantize_payload(y, u, 1e-3))
    ms_lead = time_ms(lambda: Q.quantize_payload(y, u8, 1e-3))
    print(f"[kernels] quantize_payload on a 1,024-column noise buffer (4 KB "
          f"row stride): bytes equal to the plain version (fixed+adaptive, "
          f"full {n_rows} rows + ragged view), max |decoded diff| "
          f"{wide_abs}; {ms_wide:.4f} ms against {ms_lead:.4f} ms on a "
          f"512-column copy")
    del y, u, u8, a, b

    counted("planB packed", PLAN_B)
    i8 = counted("int8 packed", "int8")
    ip = counted("int8 pipelined", "int8", *pipelined)
    a0 = counted("int8 async s0", "int8", "--wire-packing", "async",
                 "--staleness", "0")
    if not (same_state(torch, i8, ip) and same_state(torch, i8, a0)):
        fail("int8 pipelined (4 chunks) or async at staleness 0 differs "
             "from int8 packed")
    print("[plans] int8 pipelined (4 chunks) == int8 async staleness 0 == "
          "int8 packed bitwise (params, x_tilde, m_agg)")
    del ip, a0
    a1 = counted("int8 async s1", "int8", "--wire-packing", "async",
                 "--staleness", "1")
    fly = tuple(a1["consensus"]["fly_self"].shape)
    if same_state(torch, i8, a1) or fly != (NODES, PAYLOAD * n_rows):
        fail(f"int8 async staleness 1 equals the packed exchange, or its "
             f"in-flight payloads are {fly}")
    print(f"[plans] int8 async staleness 1: one step stale (its state "
          f"differs from packed), in-flight payloads {fly} uint8 x 3")
    del i8, a1

    for entry in entries.values():
        entry.launches = 0
    hist = train.main(train_argv(
        ADAPTIVE_STEPS, "--wire-codec", "adaptive", "--wire-plan", PLAN_A,
        "--codec-ladder", "int2,int4,int8", "--codec-period", "2"))
    launches = {name: entry.launches for name, entry in entries.items()}
    want = {name: 0 for name in entries}
    for h in hist:
        # every tier keeps plan A's placement (the state's row order)
        plan = full_plan(train, h["codec"], layout_spec=PLAN_A)
        per_step = plan_launches(entries, plan)
        if {n: v for n, v in per_step.items() if v} \
                != PLAN_STEP_LAUNCHES.get(h["codec"]):
            fail(f"adaptive over plan A, {h['codec']}: the port's plan "
                 f"gives {per_step} launches per step, designed "
                 f"{PLAN_STEP_LAUNCHES.get(h['codec'])}")
        for name, n in per_step.items():
            want[name] += n
        if h["wire_bytes_per_step"] != 2 * plan.payload_bytes:
            fail(f"adaptive over plan A, {h['codec']}: wire bytes "
                 f"{h['wire_bytes_per_step']}, want {2 * plan.payload_bytes}")
    if launches != want or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"adaptive over plan A: plans {[h['codec'] for h in hist]}, "
             f"launches {launches}, want {want}")
    for name, n in launches.items():
        launches_total[name] += n
    print(f"[plans] adaptive over plan A (ladder int2,int4,int8, period 2): "
          f"plan per step {[h['codec'] for h in hist]}; launches "
          f"{ {n: v for n, v in launches.items() if v} } match them")
    return launches_total, step_s, peak_gb, wide_abs


def stride_argv(steps: int, *extra: str) -> list[str]:
    return ["--arch", "smollm-135m", "--algorithm", "adc_dgd", "--nodes",
            str(STRIDE_NODES), "--batch", str(4 * STRIDE_NODES), "--seq",
            "512", "--steps", str(steps), "--quant-mode", "fixed", "--lr",
            "1e-2", "--device", "cuda", *NO_REMAT, *STRIDE_ARGV, *extra]


def stride_probe(torch, Q, D, train):
    """An uncounted packed run of the stride path, watched
    (``ExchangeWatch``): at each step the m_agg each node's combine read
    (steps 3 and 5: ``side * (x_tilde[i - s] + x_tilde[i + s])`` of the
    step's input shadows, recomputed with ``roll``, bitwise; other steps:
    the carried m_agg itself), and at step 3 the same exchange through
    the plain versions on the card, bitwise equal."""
    with ExchangeWatch(torch, Q, D, RESYNC_STEPS[0], combine=True) as watch:
        train.main(stride_argv(RESYNC_STEPS[-1]))
    got = [(r["stride"], r["resync"], r["m_agg_ok"]) for r in watch.steps]
    want = [(STRIDE_SEQ[k - 1], k in RESYNC_STEPS, True)
            for k in range(1, RESYNC_STEPS[-1] + 1)]
    if got != want:
        fail(f"stride probe: (stride, resync, m_agg into the combine as "
             f"designed) per step {got}, want {want}")
    if not watch.plain_equal:
        fail(f"stride path step {RESYNC_STEPS[0]}: the kernel exchange "
             "differs from the plain versions' on the card")
    print(f"[strides] m_agg into the combine at steps {RESYNC_STEPS} == "
          "side * (x_tilde[i - s] + x_tilde[i + s]) of the step's input "
          "bitwise (s = 2, then 1), the carried m_agg at the other steps; "
          f"step {RESYNC_STEPS[0]}'s exchange (a resync) with the plain "
          "versions of #1 and #2 == the kernels' bitwise (params and the "
          "consensus state)", flush=True)


def phase_strides(torch, Q, D, train, entries):
    """The time-varying ring on the full smollm-135m x 5 nodes, strides
    (1, 2) held 2 steps each, int8 fixed grid: 5 steps on each transport,
    each run counted on its own (launches as designed, the reference's
    wire bytes and collectives, the stride and resync of every step);
    packed == pipelined == async at staleness 0 bitwise; the watched probe
    (``stride_probe``); then the exchange at a resync step against steps
    without one, CUDA events.  Returns (launches, step s, exchange ms,
    peak GB)."""
    launches_total = {name: 0 for name in entries}
    step_s, peak_gb, finals = {}, {}, {}
    for label, (extra, per_step, coll) in STRIDE_RUNS.items():
        with CardSampler() as card:
            (hist, state), launches, peak_gb[label] = run_counted(
                torch, train, entries, stride_argv(STRIDE_STEPS, *extra),
                return_state=True)
        want = {name: STRIDE_STEPS * per_step.get(name, 0)
                for name in entries}
        if launches != want:
            fail(f"strides {label}: launched {launches}, want {want}")
        losses = [h["loss"] for h in hist]
        wire = STRIDE_WIRE_BYTES["per_leaf" if label == "per_leaf"
                                 else "packed"]
        got = ([h["ring_stride"] for h in hist],
               [h["resync"] for h in hist],
               {h["wire_bytes_per_step"] for h in hist},
               {h["collectives_per_step"] for h in hist})
        if not all(math.isfinite(x) for x in losses) \
                or abs(losses[0] - math.log(49152)) > 0.5 \
                or got != (STRIDE_SEQ, [k in RESYNC_STEPS for k in
                                        range(1, STRIDE_STEPS + 1)],
                           {wire}, {coll}):
            fail(f"strides {label}: losses {losses}, strides / resyncs / "
                 f"wire bytes / collectives {got}, want {STRIDE_SEQ}, "
                 f"resyncs at {RESYNC_STEPS}, {wire}, {coll}")
        for name, n in launches.items():
            launches_total[name] += n
        step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
        if label == "async s1":       # the process ring's 5-rank run
            keep_stacked(torch, "strides async s1", hist, state)
        if label in ("packed", "pipelined", "async s0"):
            finals[label] = host_state(state)
        del state
        print(f"[strides] {label}: {STRIDE_STEPS} steps at strides "
              f"{STRIDE_SEQ}, resyncs at {RESYNC_STEPS}; losses {losses}; "
              f"launches per step {per_step}; wire_bytes_per_step {wire}; "
              f"collectives {coll}; consensus_err "
              f"{[h['consensus_err'] for h in hist]}; median step "
              f"{step_s[label]:.4f} s; peak memory {peak_gb[label]:.2f} GB; "
              f"card: {card.summary()}", flush=True)
    if not (same_state(torch, finals["packed"], finals["pipelined"])
            and same_state(torch, finals["packed"], finals["async s0"])):
        fail("strides: pipelined or async at staleness 0 differs from packed")
    print("[strides] pipelined (4 units) == async staleness 0 == packed "
          "bitwise across the resyncs (params, x_tilde, m_agg)")
    del finals
    stride_probe(torch, Q, D, train)

    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    setup = train.build_train_setup(
        get_config("smollm-135m"), consensus_nodes=STRIDE_NODES,
        ring_strides=(1, 2), schedule_period=STRIDE_PERIOD, device="cuda")
    st = train.init_train_state(setup, 0)
    x_half = T.tree_map(lambda a: a + 1e-4, st["params"])
    rt = setup.consensus
    exchange_ms = {}
    for step, label in ((2, "stride 1"), (4, "stride 2"),
                        (3, "stride 2, resync")):
        with CardSampler() as card:
            exchange_ms[label] = time_ms(lambda: rt.exchange(
                st["params"], x_half, st["consensus"], step), reps=5)
        print(f"[timing] one 5-node strided exchange at step {step} "
              f"({label}): {exchange_ms[label]:.2f} ms; card: "
              f"{card.summary()}", flush=True)
    del st, x_half
    torch.cuda.empty_cache()
    return launches_total, step_s, exchange_ms, peak_gb


#: the lossy and directed rings (``phase_faults``) on the full smollm-135m
#: x 4 nodes: the reference's packet-loss sweep (``benchmarks/
#: consensus_step.py:171-174``: directed-ring push-sum on the adaptive
#: grid, loss seed 1, rates None / 0.0 / 0.05 / 0.2; 3 of its 8 steps, cut
#: for the script's time: 4 until the process ring's 5-rank group), its
#: burst
#: channel (``CHURN_BURST``, :202), the async transport's straggler
#: deadlines, and the strided 5-node ring of ``phase_strides`` with one
#: resync retry (some handshakes fail)
FAULT_STEPS, LOSS_SEED, STRAGGLE = 3, 1, 0.2
LOSS_RATES = (None, 0.0, 0.05, 0.2)
CHURN_BURST = "gilbert:p=0.1,r=0.9"
FAULT_ARGV = ("--topology", "directed-ring", "--quant-mode", "adaptive",
              "--loss-seed", str(LOSS_SEED))
#: the step of each checked run whose exchange is run again through the
#: plain versions of its kernels and compared bitwise
PLAIN_STEP = 3
#: the paper path on directed graphs: the reference's own draws
#: (``tests/test_topology.py:60`` and ``:137``, there at n 12 and 8)
DIRECTED_P, DIRECTED_SEED, DIRECTED_SCHED_SEED = 0.3, 1, 0


class PlainKernels:
    """Within the block the exchange's kernel entry points (``ops``: #1,
    #2, #3, #4) run their plain PyTorch versions on the card; whatever
    they were is restored after it."""

    NAMES = ("quantize_payload", "dequant_combine_payload",
             "quantize_blocks", "dequant_combine")

    def __init__(self, Q, D):
        self.Q, self.D = Q, D

    def __enter__(self):
        from repro_torch.kernels import ops
        Q, D = self.Q, self.D
        self.saved = {k: getattr(ops, k) for k in self.NAMES}

        def plain_q(y, noise, fixed_step=None, row_offset=0, n_rows=None,
                    out=None):
            return Q._into(out, Q.quantize_payload_plain(
                y, noise, fixed_step, row_offset, n_rows))

        def plain_d(ps, pl, pr, xt, mb, w_self, w_side, deamp, row_offset=0,
                    n_rows=None, out=None):
            return Q._into(out, D.dequant_combine_payload_plain(
                ps, pl, pr, xt, mb, w_self, w_side, deamp, row_offset,
                n_rows))

        ops.quantize_payload, ops.dequant_combine_payload = plain_q, plain_d
        ops.quantize_blocks = (lambda y, noise, fixed_step=None:
                               Q.quantize_blocks_plain(y, noise, fixed_step))
        ops.dequant_combine = D.dequant_combine_plain
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.kernels import ops
        for k, v in self.saved.items():
            setattr(ops, k, v)
        return False


class ExchangeWatch:
    """Within the block every ``ConsensusRuntime.exchange`` is watched
    (no kernel launches of its own): per step, its stride and resync, the
    zero payloads it read (``zero_payloads``), its per-node delivered
    bytes and fraction, and the push-sum weights.  At ``plain_step`` the
    exchange runs again through ``PlainKernels`` and must give the
    kernels' bits (``plain_equal``).  With ``combine`` the m_agg each
    node's int8 combine read is held (``m_agg_ok``): at a resync to the
    aggregate rebuilt from the step's input shadows where the node's
    handshake landed and to the carried one where it failed, at other
    steps to the carried one itself.  Around each check the peak memory
    so far is kept (``peak_gb``) and the peak counter restarts after it,
    so that a run's peak leaves the checks' temporaries out."""

    def __init__(self, torch, Q, D, plain_step=None, combine=False):
        self.torch, self.Q, self.D = torch, Q, D
        self.plain_step, self.combine = plain_step, combine
        self.steps, self.plain_equal = [], None
        self.peak_gb = 0.0

    def _check(self, fn):
        """``fn()`` with its memory kept out of the run's peak."""
        torch = self.torch
        self.peak_gb = max(self.peak_gb,
                           torch.cuda.max_memory_allocated() / 1e9)
        got = fn()
        torch.cuda.reset_peak_memory_stats()
        return got

    def __enter__(self):
        from repro_torch.core import distributed as Dist
        from repro_torch.kernels import ops
        torch, watch = self.torch, self
        self.real = real = Dist.ConsensusRuntime.exchange
        self.real_d = ops.dequant_combine_payload
        m_args = []

        def combine_spy(*args, **kw):
            m_args.append(args[4])
            return watch.real_d(*args, **kw)

        def exchange_spy(rt, x_prev, x_half, state, step, seed=0,
                         noise=None):
            z0 = rt.zero_payloads
            xt, mb = state.get("x_tilde"), state.get("m_agg")
            m_args.clear()
            got = real(rt, x_prev, x_half, state, step, seed, noise)
            m = got[2]
            ok = rt.resync_ok(step)
            rec = {"step": step, "zero": rt.zero_payloads - z0,
                   "stride": rt.stride_at(step),
                   "resync": rt.resync_at(step),
                   "resync_ok": None if ok is None else ok.tolist()}
            for key in ("wire_bytes_delivered", "delivered_frac",
                        "push_sum_weight"):
                if key in m:
                    rec[key] = m[key].cpu().numpy()
            watch.steps.append(rec)

            def m_agg_check():
                if len(m_args) != rt.n_nodes:
                    return False
                if not rec["resync"]:
                    return all(a.data_ptr() == mb[i].data_ptr()
                               for i, a in enumerate(m_args))
                s, side = rec["stride"], rt.cfg.side_weight
                built = (xt.roll(s, 0) + xt.roll(-s, 0)) * side
                return all(torch.equal(a, built[i] if ok is None or ok[i]
                                       else mb[i])
                           for i, a in enumerate(m_args))
            if watch.combine:
                rec["m_agg_ok"] = watch._check(m_agg_check)
            m_args.clear()
            if step == watch.plain_step:
                def plain_check():
                    z1 = rt.zero_payloads
                    with PlainKernels(watch.Q, watch.D):
                        plain = real(rt, x_prev, x_half, state, step, seed,
                                     noise)
                    rt.zero_payloads = z1
                    return (all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(got[0]), tree_leaves(plain[0])))
                        and sorted(got[1]) == sorted(plain[1])
                        and all(torch.equal(got[1][k], plain[1][k])
                                for k in got[1]))
                watch.plain_equal = watch._check(plain_check)
            return got

        Dist.ConsensusRuntime.exchange = exchange_spy
        if self.combine:
            ops.dequant_combine_payload = combine_spy
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.core import distributed as Dist
        from repro_torch.kernels import ops
        Dist.ConsensusRuntime.exchange = self.real
        ops.dequant_combine_payload = self.real_d
        return False


def tree_leaves(tree):
    from repro_torch.core import tree as T
    return T.tree_leaves(tree)


def arrival_mask(model, step, n, straggler=None):
    """``(2, n)`` host mask of the payloads a step's exchange retires
    (``straggler``: the async transport's deadlines, ANDed)."""
    keep = model.keep_mask_host(n, [step])[0]
    if straggler is not None:
        keep = keep & straggler.keep_mask_host(n, [step])[0]
    return keep


def fault_checks(label, watch, model, units, bpd, n, async_s1=False,
                 straggler=None, push=True):
    """Each watched step of a run: the zero payloads read equal the host
    keep mask's drops x transfer units, the delivered bytes per node equal
    ``f32(bytes per direction) x surviving directions``, and the push-sum
    weight is exactly 1.  Returns (drops per step, delivered fractions)."""
    drops, fracs = [], []
    for rec in watch.steps:
        k = rec["step"]
        if model is None:
            if rec["zero"] or "delivered_frac" in rec:
                fail(f"{label} step {k}: no loss model, yet "
                     f"{rec['zero']} zero payloads / delivered metrics")
            drops.append(0)
        else:
            mask = arrival_mask(model, k - 1 if async_s1 else k, n,
                                straggler)
            d = int((~mask).sum())
            delivered = mask.sum(axis=0).astype(np.float32)
            want = delivered * np.float32(bpd)
            if rec["zero"] != units * d \
                    or not np.array_equal(rec["wire_bytes_delivered"], want) \
                    or not np.array_equal(rec["delivered_frac"],
                                          delivered / 2):
                fail(f"{label} step {k}: {rec['zero']} zero payloads (want "
                     f"{units} x {d}), delivered bytes "
                     f"{rec.get('wire_bytes_delivered')} (want {want}), "
                     f"delivered {rec.get('delivered_frac')}")
            drops.append(d)
            fracs.append(float(rec["delivered_frac"].mean()))
        if push and not np.array_equal(rec["push_sum_weight"],
                                       np.ones(n, np.float32)):
            fail(f"{label} step {k}: push-sum weights "
                 f"{rec['push_sum_weight']} are not exactly 1")
    return drops, fracs


def phase_faults(torch, Q, D, train, entries):
    """Lossy and directed rings on the full smollm-135m, each run counted
    on its own and watched (``ExchangeWatch``): (a) 4 nodes, directed-ring
    push-sum on the adaptive grid at loss None / 0.0 / 0.05 / 0.2,
    packed; (b) 0.2 on pipelined 4 units, async at staleness 0 and
    per-leaf, each bitwise equal to (a)'s packed run (and 0.0 to None);
    (c) the burst channel, int8 and plan B; (d) async at staleness 1 with
    straggler deadlines; (e) the strided 5-node ring at loss 0.2 with one
    resync retry, a failed handshake keeping the carried m_agg bitwise;
    then the exchange timed with and without loss, directed against
    symmetric; then the paper path on directed graphs
    (``phase_paper_directed``).  Returns (launches, step s, exchange ms,
    peak GB)."""
    from repro_torch.core import faults
    launches_total = {name: 0 for name in entries}
    step_s, peak_gb, finals = {}, {}, {}
    packed_per_step = {"quantize_payload": NODES,
                       "dequant_combine_payload": NODES}
    payload = WIRE_BYTES["int8"] // 2
    pipelined = ("--wire-packing", "pipelined", "--pipeline-chunks",
                 str(PIPELINE_CHUNKS))
    bernoulli = lambda rate: (None if rate is None  # noqa: E731
                              else faults.LossModel(rate, LOSS_SEED))
    burst = faults.GilbertElliottLoss(p=0.1, r=0.9, seed=LOSS_SEED,
                                      n_nodes=NODES)
    lossy = ("--link-loss", "0.2")
    # (label, argv, loss model, launches per step, units, bytes per
    # direction, async s1 straggler or None, plain check)
    runs = []
    for rate in LOSS_RATES:
        runs.append((f"directed loss {rate}", train_argv(
            FAULT_STEPS, *FAULT_ARGV,
            *(() if rate is None else ("--link-loss", str(rate)))),
            bernoulli(rate), packed_per_step, 1, payload + 4, None,
            rate == 0.2))
    runs += [
        ("directed loss 0.2 pipelined", train_argv(
            FAULT_STEPS, *FAULT_ARGV, *lossy, *pipelined),
         bernoulli(0.2), {k: v * PIPELINE_CHUNKS
                          for k, v in packed_per_step.items()},
         PIPELINE_CHUNKS, payload + 4, None, False),
        ("directed loss 0.2 async s0", train_argv(
            FAULT_STEPS, *FAULT_ARGV, *lossy, "--wire-packing", "async",
            "--staleness", "0"), bernoulli(0.2), packed_per_step, 1,
         payload + 4, None, False),
        ("directed loss 0.2 per-leaf", train_argv(
            FAULT_STEPS, *FAULT_ARGV, *lossy, "--wire-packing", "per_leaf"),
         bernoulli(0.2), {"quantize_blocks": NODES * N_LEAVES,
                          "dequant_combine": NODES * N_LEAVES}, N_LEAVES,
         PER_LEAF_WIRE_BYTES // 2 + 4, None, True),
        ("directed burst int8", train_argv(
            FAULT_STEPS, *FAULT_ARGV, "--link-loss-model", CHURN_BURST),
         burst, packed_per_step, 1, payload + 4, None, False),
        ("directed burst plan B", train_argv(
            FAULT_STEPS, *FAULT_ARGV, "--link-loss-model", CHURN_BURST,
            "--wire-plan", PLAN_B), burst,
         {n: v for n, v in plan_launches(entries, full_plan(
             train, PLAN_B)).items() if v}, 1,
         PLAN_WIRE_BYTES[PLAN_B] // 2 + 4, None, False),
        ("directed loss 0.2 async s1 straggle", train_argv(
            FAULT_STEPS, *FAULT_ARGV, *lossy, "--wire-packing", "async",
            "--staleness", "1", "--straggle", str(STRAGGLE)),
         bernoulli(0.2), packed_per_step, 1, payload + 4,
         faults.StragglerModel(STRAGGLE, 0), True)]
    for label, argv, model, per_step, units, bpd, late, plain in runs:
        with CardSampler() as card, ExchangeWatch(
                torch, Q, D, PLAIN_STEP if plain else None) as watch:
            (hist, state), launches, peak = run_counted(
                torch, train, entries, argv, return_state=True)
        peak_gb[label] = max(peak, watch.peak_gb)
        want = {name: FAULT_STEPS * per_step.get(name, 0)
                for name in entries}
        losses = [h["loss"] for h in hist]
        if launches != want or not all(math.isfinite(x) for x in losses) \
                or abs(losses[0] - math.log(49152)) > 0.5:
            fail(f"faults {label}: launched {launches} (want {want}), "
                 f"losses {losses}")
        if len(watch.steps) != FAULT_STEPS:
            fail(f"faults {label}: {len(watch.steps)} exchanges watched")
        async_s1 = "--straggle" in argv
        drops, fracs = fault_checks(label, watch, model, units, bpd, NODES,
                                    async_s1=async_s1, straggler=late)
        if plain and not watch.plain_equal:
            fail(f"faults {label}: step {PLAIN_STEP}'s exchange through "
                 "the plain versions differs from the kernels'")
        if {h["wire_bytes_per_step"] for h in hist} != {2.0 * bpd}:
            fail(f"faults {label}: wire_bytes_per_step "
                 f"{[h['wire_bytes_per_step'] for h in hist]}, want "
                 f"{2 * bpd}")
        for name, n in launches.items():
            launches_total[name] += n
        step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
        if label in RING_RUNS:        # the process ring mirrors it
            keep_stacked(torch, label, hist, state)
        if "async s1" not in label and "burst" not in label:
            finals[label] = host_state(state)
        del state
        print(f"[faults] {label}: {FAULT_STEPS} steps, losses {losses}; "
              f"launches per step {per_step}; dropped payloads per step "
              f"{drops} (x {units} units read as zero payloads, as the "
              f"host mask says); delivered_frac {fracs}; wire bytes "
              f"delivered as the formula; push_sum_weight exactly 1; "
              + (f"step {PLAIN_STEP} through the plain versions bitwise "
                 "equal; " if plain else "")
              + f"consensus_err {[h['consensus_err'] for h in hist]}; "
              f"median step {step_s[label]:.4f} s; peak memory "
              f"{peak_gb[label]:.2f} GB; card: {card.summary()}",
              flush=True)
    keys = ("x_tilde", "m_agg", "ps_w", "ps_nbr")

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"])))
            and all(torch.equal(a["consensus"][k], b["consensus"][k])
                    for k in keys))
    if not same(finals["directed loss None"], finals["directed loss 0.0"]):
        fail("faults: loss 0.0 differs from the lossless run")
    base = finals["directed loss 0.2"]
    for label in ("pipelined", "async s0", "per-leaf"):
        if not same(base, finals[f"directed loss 0.2 {label}"]):
            fail(f"faults: loss 0.2 {label} differs from packed")
    if same(base, finals["directed loss None"]):
        fail("faults: loss 0.2 gave the lossless run's bits")
    print("[faults] loss 0.0 == lossless bitwise; at loss 0.2 packed == "
          "pipelined (4 units) == async staleness 0 == per-leaf bitwise "
          "(params, x_tilde, m_agg, ps_w, ps_nbr), and != lossless",
          flush=True)
    del finals, base

    # (e) the strided 5-node ring, one resync retry
    label = "strided loss 0.2, 1 retry"
    model = faults.LossModel(0.2, LOSS_SEED)
    with CardSampler() as card, ExchangeWatch(torch, Q, D, RESYNC_STEPS[0],
                                              combine=True) as watch:
        hist, launches, peak = run_counted(
            torch, train, entries, stride_argv(
                STRIDE_STEPS, "--link-loss", "0.2", "--loss-seed",
                str(LOSS_SEED), "--resync-retries", "1"))
    peak_gb[label] = max(peak, watch.peak_gb)
    want = {name: STRIDE_STEPS * STRIDE_RUNS["packed"][1].get(name, 0)
            for name in entries}
    if launches != want or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"faults {label}: launched {launches} (want {want})")
    drops, fracs = fault_checks(label, watch, model, 1, payload,
                                STRIDE_NODES, push=False)
    resyncs = [r for r in watch.steps if r["resync"]]
    oks = [r["resync_ok"] for r in resyncs]
    if [r["step"] for r in resyncs] != list(RESYNC_STEPS) \
            or not all(r["m_agg_ok"] for r in watch.steps) \
            or all(all(o) for o in oks) or not any(any(o) for o in oks) \
            or not watch.plain_equal:
        fail(f"faults {label}: resyncs {oks} at "
             f"{[r['step'] for r in resyncs]}, m_agg into the combine as "
             f"designed {[r['m_agg_ok'] for r in watch.steps]}, plain "
             f"equal {watch.plain_equal}")
    for name, n in launches.items():
        launches_total[name] += n
    step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
    print(f"[faults] {label} ({STRIDE_NODES} nodes, strides 1,2, period "
          f"{STRIDE_PERIOD}): resync handshakes landed per node {oks} at "
          f"steps {RESYNC_STEPS}; each combine read the rebuilt m_agg where "
          "it landed and the carried m_agg bitwise where it failed (and "
          "the carried one at the other steps); step "
          f"{RESYNC_STEPS[0]} through the plain versions bitwise equal; "
          f"dropped payloads per step {drops}; delivered_frac {fracs}; "
          f"median step {step_s[label]:.4f} s; peak memory "
          f"{peak_gb[label]:.2f} GB; card: {card.summary()}", flush=True)

    exchange_ms, exchange_gb = phase_fault_timing(torch, train)
    for name, n in phase_paper_directed(torch, Q, entries).items():
        launches_total[name] += n
    return launches_total, step_s, exchange_ms, exchange_gb, peak_gb


def phase_fault_timing(torch, train):
    """One 4-node int8 exchange (fixed grid, step 2) of the full smollm-135m
    state: symmetric and directed ring, each lossless and at loss 0.2, and
    push-sum alone on the symmetric ring (its numerator product and
    de-bias division without the directed correction), CUDA events, with
    the peak memory over each set of calls."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    params = train.init_train_state(setup, 0)["params"]
    x_half = T.tree_map(lambda a: a + 1e-4, params)
    loss = dict(link_loss=0.2, loss_seed=LOSS_SEED)
    ms, gb = {}, {}
    for label, kw in (("symmetric", {}), ("symmetric loss 0.2", loss),
                      ("directed", {"topology": "directed-ring"}),
                      ("directed loss 0.2", {"topology": "directed-ring",
                                             **loss}),
                      ("symmetric push-sum", {"push_sum": True}),
                      ("symmetric, again", {})):
        rt = ConsensusRuntime(ConsensusConfig(**kw), NODES)
        cons = rt.init_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with CardSampler() as card:
            ms[label] = time_ms(lambda: rt.exchange(params, x_half, cons, 2),
                                reps=5)
        gb[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
        drops = "" if rt.loss is None else (
            f", {int((~rt.keep_mask(2)).sum())} of {2 * NODES} payloads "
            "dropped")
        print(f"[timing] one 4-node {label} exchange{drops}: {ms[label]:.2f} "
              f"ms, {gb[label]:.2f} GB above the state at peak; card: "
              f"{card.summary()}", flush=True)
        del cons
    del params, x_half, setup
    torch.cuda.empty_cache()
    return ms, gb


def phase_paper_directed(torch, Q, entries):
    """The paper's reference algorithms with push-sum at N 20, P 2^22
    (``paper_circle_problem``'s data) on ``directed_erdos_renyi(20, 0.3,
    seed=1)``: ADC-DGD int8 fixed, CHOCO int8 adaptive (its first message
    is x itself) and CEDAS int8 fixed, and ADC-DGD under
    ``DirectedErdosRenyiSchedule(20, 0.3, horizon=PAPER_STEPS, seed=0)``,
    PAPER_STEPS steps each, counted; then ADC-DGD's kernel and plain
    trajectories over TRAJECTORY_STEPS, bitwise equal."""
    from repro_torch.core import compression as C
    from repro_torch.core import consensus as K
    from repro_torch.core import problems as P
    from repro_torch.core import topology as T
    prob = P.paper_circle_problem(PAPER_NODES, seed=0, dim=PAPER_DIM,
                                  device="cuda")
    mix = T.directed_erdos_renyi(PAPER_NODES, DIRECTED_P, seed=DIRECTED_SEED)
    sched = T.DirectedErdosRenyiSchedule(PAPER_NODES, DIRECTED_P,
                                         horizon=PAPER_STEPS,
                                         seed=DIRECTED_SCHED_SEED)
    step = K.StepSize(0.01, eta=0.5)
    fixed = C.Int8BlockQuantizer(mode="fixed")
    algs = {"adc_dgd int8 fixed, directed ER": K.ADCDGD(mix, fixed, step),
            "choco int8 adaptive, directed ER": K.CHOCOGossip(
                mix, C.Int8BlockQuantizer(mode="adaptive"), step),
            "cedas int8 fixed, directed ER": K.CEDAS(mix, fixed, step),
            "adc_dgd int8 fixed, directed ER schedule": K.ADCDGD(
                sched, fixed, step)}
    print(f"[paper] directed Erdős-Rényi (n {PAPER_NODES}, p {DIRECTED_P}, "
          f"seed {DIRECTED_SEED}): {mix.n_messages} directed edges, rows "
          f"summing to {mix.w.sum(axis=1).min():.3f}-"
          f"{mix.w.sum(axis=1).max():.3f}; schedule seed "
          f"{DIRECTED_SCHED_SEED}: {sched.n_messages:.1f} edges per step on "
          "average", flush=True)
    for entry in entries.values():
        entry.launches = 0
    for name, alg in algs.items():
        r, st = paper_run(torch, K, alg, prob, PAPER_STEPS)
        ps = r["ps_w_final"]
        finite = all(np.isfinite(r[m]).all() for m in
                     ("obj", "grad_norm", "consensus", "max_tx", "x_final"))
        per_msg = alg.compressor.wire_bytes(PAPER_DIM)
        msgs = (sched.messages_per_step(PAPER_STEPS) if alg.mixing is sched
                else np.full(PAPER_STEPS, mix.n_messages))
        if not finite or ps.shape != (PAPER_NODES, 1) or ps.min() <= 0 \
                or abs(ps.sum() - PAPER_NODES) > 1e-3 * PAPER_NODES \
                or not np.allclose(r["bytes"], np.cumsum(msgs * per_msg),
                                   rtol=1e-12):
            fail(f"{name}: finite {finite}, ps_w_final {ps.ravel()}, bytes "
                 f"{r['bytes'][-1]}")
        print(f"[paper] {name}, {PAPER_STEPS} steps: step "
              f"{st['step_ms']:.4f} ms (CUDA events, median of steps "
              f"{PAPER_STEP0}-{PAPER_STEPS}); final grad_norm "
              f"{r['grad_norm'][-1]!r}, consensus {r['consensus'][-1]!r}; "
              f"ps_w_final {float(ps.min())!r}-{float(ps.max())!r}, sum "
              f"{float(ps.sum())!r}; {r['bytes'][-1]:.0f} bytes in all (one "
              f"message per directed edge); peak memory "
              f"{st['peak_gb']:.2f} GB", flush=True)
    launches = {name: entry.launches for name, entry in entries.items()}
    want = {name: 0 for name in entries}
    want["quantize_blocks"] = len(algs) * PAPER_STEPS
    if launches != want:
        fail(f"paper path on directed graphs launched {launches}, want "
             f"{want}")
    for label in ("adc_dgd int8 fixed, directed ER",
                  "adc_dgd int8 fixed, directed ER schedule"):
        kern, _ = paper_run(torch, K, algs[label], prob, TRAJECTORY_STEPS,
                            key=5)
        real = Q.quantize_blocks
        Q.quantize_blocks = Q.quantize_blocks_plain
        try:
            plain, _ = paper_run(torch, K, algs[label], prob,
                                 TRAJECTORY_STEPS, key=5)
        finally:
            Q.quantize_blocks = real
        for name in ("x_final", "ps_w_final", "obj", "grad_norm",
                     "consensus", "max_tx", "bytes"):
            if not np_equal(kern[name], plain[name]):
                fail(f"{label} through kernel #3 and through its plain "
                     f"version differ in {name}")
        print(f"[paper] {label} through kernel #3 and through "
              f"quantize_blocks_plain: bitwise equal trajectories over "
              f"{TRAJECTORY_STEPS} steps (x_final, ps_w_final, metrics)")
    del prob
    torch.cuda.empty_cache()
    return launches


#: elastic membership (``phase_elastic``): the reference's churn sweep
#: (``benchmarks/consensus_step.py:179-202``, ``CHURN_MASKS`` and
#: ``CHURN_PERIOD``): node 2 out for schedule epoch 1 of 4-step epochs,
#: 13 of its 16 steps on one run (``CHURN_LONG_STEPS``: step 13 opens the
#: epoch where the mask has clamped, and no resync runs there) and 9 on the
#: others (cut for the script's time; step 9, the rejoin, is the last
#: resync): nodes 0, 1, 3 at steps 5-8, all four at the others; the resync
#: at steps 5 and 9
CHURN_SPEC, CHURN_PERIOD, CHURN_STEPS = "2@1:2", 4, 9
CHURN_LONG_STEPS = 13
CHURN_ARGV = ("--node-failures", CHURN_SPEC, "--schedule-period",
              str(CHURN_PERIOD))
CHURN_ACTIVE = [4] * 4 + [3] * 4 + [4] * 5
CHURN_RESYNCS = (5, 9)
CHURN_HOLE = (True, True, False, True)
#: the reference's wire bytes per step: the int8 payload and the amortized
#: resync, 271,160,064 + 2 x 262,752 x 512 x 4 / 4
CHURN_WIRE_BYTES = 540_218_112
#: the reference's hierarchy sweep (``HIER_PODS``, ``HIER_GOSSIP_STEPS``,
#: ``benchmarks/consensus_step.py:218-232``): 2 pods of 2 of the 4 nodes,
#: 4 of its 6 steps (cut for the script's time)
HIER_PODS, HIER_STEPS = 2, 4
#: the paper path's membership (nodes 3 and 7 of 20 out for epochs 1-2
#: and 2-3 of 50 steps) and pod counts
PAPER_MEMBERSHIP, PAPER_EPOCH = "3@1:3;7@2:4", 50
PAPER_PODS = (5, 20, 1)


class ElasticWatch:
    """Within the block every ``ConsensusRuntime.exchange`` is watched
    (no kernel launches of its own): per step its resync flag and active
    ring elements, whether every inactive element's nodes came out with
    their parameters, ``x_tilde`` and ``m_agg`` bitwise as they went in
    (``frozen``), and, on the pod ring, whether every pod's members are
    bitwise equal after it (``replicas``)."""

    def __init__(self, torch):
        self.torch, self.steps = torch, []

    def __enter__(self):
        from repro_torch.core import distributed as Dist
        torch, watch = self.torch, self
        self.real = real = Dist.ConsensusRuntime.exchange

        def spy(rt, x_prev, x_half, state, step, seed=0, noise=None):
            got = real(rt, x_prev, x_half, state, step, seed, noise)
            x_next, new, _ = got
            wiring, m = rt.wiring_at(step), rt.pod_size
            out = [i for e in wiring.inactive
                   for i in range(e * m, (e + 1) * m)]
            frozen = all(torch.equal(a[i], b[i]) for i in out
                         for a, b in zip(tree_leaves(x_next),
                                         tree_leaves(x_prev)))
            frozen = frozen and all(torch.equal(new[k][i], state[k][i])
                                    for i in out
                                    for k in ("x_tilde", "m_agg"))
            replicas = None
            if m > 1 and rt.ring_len > 1:
                replicas = all(
                    torch.equal(a[i], a[i - i % m])
                    for a in tree_leaves(x_next) + list(new.values())
                    for i in range(rt.n_nodes))
            watch.steps.append({"step": step, "resync": rt.resync_at(step),
                                "active": wiring.active, "frozen": frozen,
                                "replicas": replicas})
            return got

        Dist.ConsensusRuntime.exchange = spy
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.core import distributed as Dist
        Dist.ConsensusRuntime.exchange = self.real
        return False


def phase_elastic(torch, Q, D, train, entries):
    """Elastic membership and the two-level hierarchy on the full
    smollm-135m x 4 nodes, each run counted on its own and watched
    (``ElasticWatch``, ``ExchangeWatch``): (a) the churn sweep, 9 steps
    on packed, pipelined 4 units, async at staleness 0 and 1, and 13 on
    packed under the burst channel: 4 / 3 / 4 active, node 2 frozen bitwise
    through steps 5-8, resyncs at 5 and 9 only, the reference's wire
    bytes, launches per active node, packed == pipelined == async s0
    bitwise, step 5 through the plain versions equal to the kernels, zero
    payloads and delivered bytes as the burst mask says for the active
    receivers; (b) the hierarchy sweep, 4 steps: pods 2 packed, pipelined
    4, async s1 and plan B (members bitwise replicas after every step, 3
    collectives per step packed, the outer payload plus the inner fp32
    bytes), pods 4 == the flat ring and pods 1 == ``--algorithm
    allreduce`` bitwise (2 steps each); then the exchange timed (``phase_elastic_timing``)
    and the paper path (``phase_paper_elastic``).  Returns (launches, step
    s, exchange ms, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.core import faults
    from repro_torch.core.hierarchy import HierarchySpec
    launches_total = {name: 0 for name in entries}
    step_s, peak_gb, finals = {}, {}, {}
    payload = WIRE_BYTES["int8"] // 2
    pipelined = ("--wire-packing", "pipelined", "--pipeline-chunks",
                 str(PIPELINE_CHUNKS))
    burst = faults.GilbertElliottLoss(p=0.1, r=0.9, seed=LOSS_SEED,
                                      n_nodes=NODES)
    masks = [CHURN_HOLE if 5 <= k <= 8 else (True,) * NODES
             for k in range(1, CHURN_LONG_STEPS + 1)]
    # (label, extra flags, transfer units, loss model, plain-check step,
    # steps): the burst run reaches the clamped mask's epoch
    runs = [("churn packed", (), 1, None, CHURN_RESYNCS[0], CHURN_STEPS),
            ("churn pipelined 4", pipelined, PIPELINE_CHUNKS, None, None,
             CHURN_STEPS),
            ("churn async s0", ("--wire-packing", "async", "--staleness",
                                "0"), 1, None, None, CHURN_STEPS),
            ("churn async s1", ("--wire-packing", "async", "--staleness",
                                "1"), 1, None, CHURN_RESYNCS[0],
             CHURN_STEPS),
            ("churn burst", ("--link-loss-model", CHURN_BURST,
                             "--loss-seed", str(LOSS_SEED)), 1, burst,
             None, CHURN_LONG_STEPS)]
    for label, extra, units, model, plain, steps in runs:
        with CardSampler() as card, ExchangeWatch(
                torch, Q, D, plain) as watch, ElasticWatch(torch) as ew:
            (hist, state), launches, peak = run_counted(
                torch, train, entries,
                train_argv(steps, *CHURN_ARGV, *extra),
                return_state=True)
        peak_gb[label] = max(peak, watch.peak_gb)
        active = CHURN_ACTIVE[:steps]
        per_node = units * sum(active)
        want = {name: 0 for name in entries}
        want["quantize_payload"] = want["dequant_combine_payload"] = per_node
        losses = [h["loss"] for h in hist]
        got = ([h["active_nodes"] for h in hist],
               [r["step"] for r in ew.steps if r["resync"]],
               {h["wire_bytes_per_step"] for h in hist},
               all(r["frozen"] for r in ew.steps),
               [r["active"] for r in ew.steps][4])
        if launches != want or not all(math.isfinite(x) for x in losses) \
                or abs(losses[0] - math.log(49152)) > 0.5 \
                or got != (active, list(CHURN_RESYNCS),
                           {CHURN_WIRE_BYTES}, True, [0, 1, 3]):
            fail(f"elastic {label}: launched {launches} (want {want}), "
                 f"losses {losses}, active / resyncs / wire bytes / frozen "
                 f"/ step-5 active {got}")
        if plain and not watch.plain_equal:
            fail(f"elastic {label}: step {plain}'s exchange through the "
                 "plain versions differs from the kernels'")
        drops = []
        for rec, mask in zip(watch.steps, masks):
            act = np.asarray(mask)
            keep = (np.ones((2, NODES), bool) if model is None
                    else arrival_mask(model, rec["step"], NODES))
            d = int((~keep)[:, act].sum())
            delivered = np.where(act, keep.sum(axis=0), 0).astype(
                np.float32)
            if rec["zero"] != units * d or (model is not None and (
                    not np.array_equal(rec["wire_bytes_delivered"],
                                       delivered * np.float32(payload))
                    or not np.array_equal(rec["delivered_frac"],
                                          delivered / 2))):
                fail(f"elastic {label} step {rec['step']}: {rec['zero']} "
                     f"zero payloads (want {units} x {d}), delivered "
                     f"{rec.get('delivered_frac')}")
            drops.append(d)
        for name, n in launches.items():
            launches_total[name] += n
        step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
        if label in ("churn packed", "churn pipelined 4", "churn async s0"):
            finals[label] = host_state(state)
        if label in RING_RUNS:              # phase_process_ring mirrors it
            keep_stacked(torch, label, hist, state)
        del state
        print(f"[elastic] {label}: {steps} steps, active_nodes "
              f"{got[0]}; node 2 frozen bitwise through steps 5-8; resyncs "
              f"at {got[1]}; launches {({n: v for n, v in launches.items() if v})} "
              f"(one per active node and unit); wire_bytes_per_step "
              f"{CHURN_WIRE_BYTES}; "
              + (f"step {plain} through the plain versions bitwise equal; "
                 if plain else "")
              + (f"dropped arrivals at active nodes per step {drops}; "
                 if model is not None else "")
              + f"losses {losses}; consensus_err "
              f"{[h['consensus_err'] for h in hist]}; median step "
              f"{step_s[label]:.4f} s; peak memory {peak_gb[label]:.2f} GB; "
              f"card: {card.summary()}", flush=True)
    base = finals["churn packed"]
    for label in ("churn pipelined 4", "churn async s0"):
        if not same_state(torch, base, finals[label]):
            fail(f"elastic: {label} differs from churn packed")
    print("[elastic] churn: packed == pipelined (4 units) == async "
          "staleness 0 bitwise (params, x_tilde, m_agg)", flush=True)
    del base
    finals.clear()

    # (b) the hierarchy sweep
    layout = full_plan(train, "int8").layout
    inner = HierarchySpec(HIER_PODS).inner_bytes_per_step(layout.n_elements,
                                                          NODES)
    plan_b = {n: v // HIER_PODS for n, v in plan_launches(
        entries, full_plan(train, PLAN_B)).items() if v}
    pods2 = ("--hierarchy", f"pods={HIER_PODS}")
    two = {"quantize_payload": HIER_PODS, "dequant_combine_payload": HIER_PODS}
    # (label, flags, launches per step, collectives, wire bytes)
    hruns = [("pods=2 packed", pods2, two, 3.0, WIRE_BYTES["int8"] + inner),
             ("pods=2 pipelined 4", (*pods2, *pipelined),
              {k: v * PIPELINE_CHUNKS for k, v in two.items()},
              1.0 + 2 * PIPELINE_CHUNKS, WIRE_BYTES["int8"] + inner),
             ("pods=2 async s1", (*pods2, "--wire-packing", "async"), two,
              3.0, WIRE_BYTES["int8"] + inner),
             ("pods=2 plan B", (*pods2, "--wire-plan", PLAN_B), plan_b, 3.0,
              PLAN_WIRE_BYTES[PLAN_B] + inner),
             ("pods=4", ("--hierarchy", "pods=4"),
              {k: 2 * v for k, v in two.items()}, 2.0, WIRE_BYTES["int8"]),
             ("flat", (), {k: 2 * v for k, v in two.items()}, 2.0,
              WIRE_BYTES["int8"]),
             ("pods=1", ("--hierarchy", "pods=1"), {}, 3.0 * N_LEAVES,
              2.0 * 0.75 * 4 * layout.n_elements),
             ("allreduce", ("--algorithm", "allreduce"), {},
              3.0 * N_LEAVES, 0.0)]
    for label, extra, per_step, coll, wire in hruns:
        # the degenerate pod counts and their counterparts: half the steps
        steps = HIER_STEPS if label.startswith("pods=2") else HIER_STEPS // 2
        with CardSampler() as card, ElasticWatch(torch) as ew:
            (hist, state), launches, peak_gb[label] = run_counted(
                torch, train, entries, train_argv(steps, *extra),
                return_state=True)
        want = {name: steps * per_step.get(name, 0) for name in entries}
        losses = [h["loss"] for h in hist]
        got = ({h["collectives_per_step"] for h in hist},
               {h["wire_bytes_per_step"] for h in hist},
               {r["replicas"] for r in ew.steps})
        rep = {True} if label.startswith("pods=2") else {None}
        if launches != want or not all(math.isfinite(x) for x in losses) \
                or got != ({coll}, {wire}, rep):
            fail(f"elastic {label}: launched {launches} (want {want}), "
                 f"losses {losses}, collectives / wire bytes / pod replicas "
                 f"{got}, want {coll}, {wire}, {rep}")
        for name, n in launches.items():
            launches_total[name] += n
        step_s[label] = statistics.median(h["step_s"] for h in hist[1:])
        if label in ("pods=4", "flat", "pods=1", "allreduce"):
            finals[label] = host_state(state)
        if label in RING_RUNS:              # phase_process_ring mirrors it
            keep_stacked(torch, label, hist, state)
        del state
        print(f"[elastic] hierarchy {label}: {steps} steps; launches "
              f"{({n: v for n, v in launches.items() if v})}; "
              f"collectives_per_step {coll}; wire_bytes_per_step {wire:.0f}"
              + (" (outer payload + inner fp32 "
                 f"{inner:.0f}); pod members bitwise replicas after every "
                 "step" if label.startswith("pods=2") else "")
              + f"; losses {losses}; consensus_err "
              f"{[h.get('consensus_err') for h in hist]}; median step "
              f"{step_s[label]:.4f} s; peak memory {peak_gb[label]:.2f} GB; "
              f"card: {card.summary()}", flush=True)
    if not same_state(torch, finals["pods=4"], finals["flat"]):
        fail("elastic: pods=4 differs from the flat ring")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(finals["pods=1"]["params"]),
            tree_leaves(finals["allreduce"]["params"]))):
        fail("elastic: pods=1 differs from --algorithm allreduce")
    print("[elastic] pods=4 == the flat ring bitwise (params, x_tilde, "
          "m_agg); pods=1 == --algorithm allreduce bitwise (params)",
          flush=True)
    del finals
    exchange_ms = phase_elastic_timing(torch, train)
    for name, n in phase_paper_elastic(torch, Q, entries).items():
        launches_total[name] += n
    return launches_total, step_s, exchange_ms, peak_gb


def phase_elastic_timing(torch, train):
    """One 4-node int8 exchange (fixed grid) of the full smollm-135m state,
    CUDA events: the flat ring, a single all-active mask (its outputs
    bitwise the flat ring's), the hole mask (node 2 out), the churn
    schedule at step 5 (a resync into the hole) and step 9 (a resync out
    of it, 4 active) against step 2 (no resync), and pods=2 whole and its
    inner mean alone."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    params = train.init_train_state(setup, 0)["params"]
    x_half = T.tree_map(lambda a: a + 1e-4, params)
    churn = (tuple([True] * NODES), CHURN_HOLE, tuple([True] * NODES))
    flat = ConsensusRuntime(ConsensusConfig(), NODES)
    allm = ConsensusRuntime(ConsensusConfig(membership=(churn[0],)), NODES)
    a = flat.exchange(params, x_half, flat.init_state(params), 2)
    b = allm.exchange(params, x_half, allm.init_state(params), 2)
    if not (all(torch.equal(p, q) for p, q in zip(tree_leaves(a[0]),
                                                  tree_leaves(b[0])))
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1])):
        fail("elastic: an all-active mask differs from no membership")
    del a, b
    print("[elastic] one full-width exchange under a single all-active "
          "mask == without membership, bitwise", flush=True)
    ms = {}
    for label, kw, step in (
            ("flat", {}, 2), ("all-active mask", {"membership": (churn[0],)},
                              2),
            ("hole (3 active)", {"membership": (CHURN_HOLE,)}, 2),
            ("churn step 5 (resync, 3 active)",
             {"membership": churn, "schedule_period": CHURN_PERIOD}, 5),
            ("churn step 9 (resync, 4 active)",
             {"membership": churn, "schedule_period": CHURN_PERIOD}, 9),
            ("pods=2", {"hierarchy": HIER_PODS}, 2),
            ("flat, again", {}, 2)):
        rt = ConsensusRuntime(ConsensusConfig(**kw), NODES)
        cons = rt.init_state(params)
        with CardSampler() as card:
            ms[label] = time_ms(lambda: rt.exchange(params, x_half, cons,
                                                    step), reps=5)
        print(f"[timing] one 4-node {label} exchange at step {step}: "
              f"{ms[label]:.2f} ms; card: {card.summary()}", flush=True)
        if label == "pods=2":
            with CardSampler() as card:
                ms["pods=2 inner mean"] = time_ms(
                    lambda: rt._pod_mean_delta(params, x_half), reps=5)
            print(f"[timing] pods=2 inner mean alone: "
                  f"{ms['pods=2 inner mean']:.2f} ms, so the outer "
                  f"exchange {ms['pods=2'] - ms['pods=2 inner mean']:.2f} "
                  f"ms; card: {card.summary()}", flush=True)
        del cons
    del params, x_half, setup
    torch.cuda.empty_cache()
    return ms


#: the telemetry phase: 4 steps of each transport with and without
#: ``--telemetry``; the checkpoint resume (2 + 2 against 4 steps: the async
#: s1 run without telemetry); 3 steps of ``--microbatches 2`` and of 1
TEL_STEPS, MICRO_STEPS = 4, 3
CKPT_STEPS = TEL_STEPS
TEL_RUNS = {"packed": (),
            "pipelined 4": ("--wire-packing", "pipelined",
                            "--pipeline-chunks", str(PIPELINE_CHUNKS)),
            "async s1": ("--wire-packing", "async", "--staleness", "1")}
#: the measured spans of one exchange add up to its window within this
SPAN_SUM_TOL_MS = 0.1
#: the exchange with a span recorder installed against without, CUDA events
TEL_OVERHEAD_MS = 0.2


def tel_trace_checks(label, sink, trace_path, hist):
    """One ``--telemetry`` run's sink and trace: valid records under the
    port's validator, one step record per step whose shipped bytes are the
    int8 payload's, every phase in the trace, and on the async transport an
    in-flight span overlapping the next step's forward/backward."""
    from repro_torch.core import telemetry
    problems = telemetry.validate_file(sink)
    with open(sink) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    steps = [r for r in recs if r["kind"] == "step"]
    shipped = {r["metrics"]["wire_bytes_shipped"] for r in steps}
    with open(trace_path) as f:
        trace = json.load(f)
    cov = telemetry.trace_phase_coverage(trace)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    fly = [(e["ts"], e["ts"] + e["dur"]) for e in spans
           if e["name"].startswith("in_flight")]
    fwd = [(e["ts"], e["ts"] + e["dur"]) for e in spans
           if e["name"].startswith("fwd/bwd")]
    over_next = any(f0 < w1 and w0 < f1 for f0, f1 in fly for w0, w1 in fwd)
    # per rendered step (2-5): the window and its phases, in ms
    split = {}
    for e in spans:
        if e["name"].startswith("exchange step"):
            split[e["args"]["step"]] = {"window": e["dur"] / 1e3,
                                        "phases": {}, "t": (e["ts"],)}
    for e in spans:
        ph = e["name"].split()[0]
        if ph in ("quantize", "launch", "retire", "dequant_combine"):
            row = split[e["args"]["step"]]
            row["phases"][ph] = row["phases"].get(ph, 0.0) + e["dur"] / 1e3
    if problems or len(steps) != len(hist) or shipped != {WIRE_BYTES["int8"]} \
            or min(cov.values()) < 1 or trace["otherData"]["spans"] != \
            "cuda-events" or (label == "async s1") != over_next:
        fail(f"telemetry {label}: sink problems {problems[:3]}, "
             f"{len(steps)} step records for {len(hist)} steps, shipped "
             f"{shipped}, phases {cov}, spans {trace['otherData']}, "
             f"in-flight over the next fwd/bwd {over_next}")
    return cov, over_next, split


def phase_telemetry(torch, train, entries, main_int8):
    """Telemetry, checkpoints and gradient accumulation on the full
    smollm-135m x 4 nodes, int8 fixed grid, each trainer run counted:
    (a) ``--telemetry`` for 4 steps on packed, pipelined 4 and async s1
    beside the same run without it: the sink valid, every phase in the
    trace, async's in-flight span over the next step's compute, shipped
    bytes = the int8 payload, losses and metrics of every step, final
    params, shadows and in-flight payloads bitwise equal, launches equal,
    each run's exchange windows and phases from its trace; the measured
    split of one packed exchange (its spans adding up to the window), the
    exchange with and without a recorder, and the trainer's
    ``consensus_err`` metric timed alone; (b) a 2-step run
    saving at step 2 (``--checkpoint-every 2``), loaded into a fresh state
    of another seed and run through steps 3-4, bitwise equal to the 4-step
    async s1 run of (a) without telemetry, with bytes and seconds of save
    and load; (c)
    ``--microbatches 2`` for 3 steps beside the main phase's int8 run
    (``main_int8``: its median step s, peak GB and step-1 loss), its
    gradient bitwise the two halves' gradients added and halved.  Returns
    (launches, the measured split in ms, summary lines)."""
    import tempfile
    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import telemetry
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import (ConsensusConfig,
                                              ConsensusRuntime,
                                              _consensus_error)
    from repro_torch.data import SyntheticLMDataset
    launches_total = {name: 0 for name in entries}
    summary = []

    def counted(argv):
        (hist, state), launches, peak = run_counted(
            torch, train, entries, argv, return_state=True)
        for name, n in launches.items():
            launches_total[name] += n
        return hist, state, launches, peak

    # (a) telemetry on and off
    for label, extra in TEL_RUNS.items():
        with tempfile.TemporaryDirectory() as tmp:
            hist_on, on, l_on, _ = counted(train_argv(
                TEL_STEPS, *extra, "--telemetry", "--telemetry-dir", tmp,
                "--run-id", "smoke"))
            cov, over, tsplit = tel_trace_checks(
                label, os.path.join(tmp, "telemetry-smoke.jsonl"),
                os.path.join(tmp, "trace-smoke.json"), hist_on)
        hist_off, off, l_off, _ = counted(train_argv(TEL_STEPS, *extra))
        keys = ("loss", "overflow_frac", "residual_norm", "consensus_err")
        same_hist = all(a[k] == b[k] for a, b in zip(hist_on, hist_off)
                        for k in keys)
        same = (all(torch.equal(a, b) for a, b in zip(
            tree_leaves(on["params"]), tree_leaves(off["params"])))
            and sorted(on["consensus"]) == sorted(off["consensus"])
            and all(torch.equal(on["consensus"][k], off["consensus"][k])
                    for k in on["consensus"]))
        if not (same and same_hist) or l_on != l_off:
            fail(f"telemetry {label}: telemetry on differs from off: state "
                 f"bitwise {same}, per-step metrics {same_hist}, launches "
                 f"{l_on} against {l_off}")
        exch = [h["consensus_exchange_s"] * 1e3 for h in hist_on[1:]]
        phases = {ph: statistics.median(r["phases"].get(ph, 0.0)
                                        for r in tsplit.values())
                  for ph in ("quantize", "launch", "retire",
                             "dequant_combine")}
        glue = statistics.median(r["window"] - sum(r["phases"].values())
                                 for r in tsplit.values())
        print(f"[telemetry] {label}: {TEL_STEPS} steps with --telemetry == "
              f"without, bitwise (params, {sorted(on['consensus'])}) and "
              f"per step ({', '.join(keys)}); launches equal "
              f"{({n: v for n, v in l_on.items() if v})}; spans per phase "
              f"{cov}; in-flight over the next step's fwd/bwd {over}; "
              f"wire_bytes_shipped {WIRE_BYTES['int8']} per step; exchange "
              f"window per step {[round(x, 3) for x in exch]} ms, of it "
              f"(median of steps 2-{TEL_STEPS}) "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f" and glue {glue:.3f} ms (with the trainer's consensus_err)",
              flush=True)
        if label == "packed":
            trainer_split = {"trainer window": statistics.median(exch),
                             "trainer glue": glue}
        if label == "async s1":
            # (b)'s uninterrupted run: the same argv (CKPT_STEPS steps)
            uninterrupted = off
        del on, off
    # the measured split of one packed exchange, and the recorder's cost
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    state = train.init_train_state(setup, 0)
    params, cons = state["params"], state["consensus"]
    x_half = T.tree_map(lambda a: a + 1e-4, params)
    rt_on = ConsensusRuntime(ConsensusConfig(telemetry=True), NODES)
    rec = telemetry.SpanRecorder("cuda").install()
    splits = []
    for _ in range(5):
        rec.step_begin()
        with telemetry.exchange_window():
            rt_on.exchange(params, x_half, cons, 2)
        torch.cuda.synchronize()
        splits.append(rec.measure())
    rec.uninstall()
    for sp in splits:
        parts = sp["glue_parts"]
        total = sum(sp["phases"].values()) + sum(parts.values())
        if abs(total - sp["window_s"]) * 1e3 > SPAN_SUM_TOL_MS or \
                min(parts.values()) < 0:
            fail(f"telemetry: the spans {sp} do not add up to the window")
    med = {ph: statistics.median(sp["phases"][ph] for sp in splits) * 1e3
           for ph in splits[0]["phases"]}
    glue = {k: statistics.median(sp["glue_parts"][k] for sp in splits) * 1e3
            for k in ("before", "between", "after")}
    window = statistics.median(sp["window_s"] for sp in splits) * 1e3
    print(f"[telemetry] measured split of one 4-node int8 packed exchange "
          f"(CUDA events, median of 5, fixed grid, step 2): window "
          f"{window:.3f} ms = quantize {med['quantize']:.3f} + launch "
          f"{med['launch']:.3f} + retire {med['retire']:.3f} + "
          f"dequant_combine {med['dequant_combine']:.3f} + glue "
          f"{sum(glue.values()):.3f} (before the first mark: pack, "
          f"differential, noise {glue['before']:.3f}; launch->retire: the "
          f"overflow census {glue['between']:.3f}; after the combine: "
          f"unpack, residual {glue['after']:.3f}); the spans add up to the "
          f"window within {SPAN_SUM_TOL_MS} ms", flush=True)
    rt_off = ConsensusRuntime(ConsensusConfig(), NODES)

    def timed_on():
        rec.step_begin()
        with telemetry.exchange_window():
            rt_on.exchange(params, x_half, cons, 2)

    ms = {"off": [], "on": []}
    for key in ("off", "on", "on", "off"):
        if key == "on":
            rec.install()
            ms[key].append(time_ms(timed_on, reps=5))
            rec.uninstall()
        else:
            ms[key].append(time_ms(lambda: rt_off.exchange(
                params, x_half, cons, 2), reps=5))
    t_on, t_off = statistics.mean(ms["on"]), statistics.mean(ms["off"])
    if abs(t_on - t_off) > TEL_OVERHEAD_MS:
        fail(f"telemetry: the exchange with a recorder took {ms['on']} ms "
             f"against {ms['off']} ms without")
    print(f"[telemetry] one 4-node int8 exchange with telemetry and a span "
          f"recorder {t_on:.3f} ms ({ms['on']}) against without "
          f"{t_off:.3f} ms ({ms['off']}), in turns off/on/on/off",
          flush=True)
    cerr = time_ms(lambda: _consensus_error(x_half), reps=5)
    print(f"[telemetry] the consensus_err metric alone (the trainer's "
          f"exchange computes it, the timed exchanges do not): {cerr:.3f} "
          "ms", flush=True)
    split = {"window": window, **med, **{f"glue {k}": v
                                         for k, v in glue.items()},
             "exchange on": t_on, "exchange off": t_off,
             **trainer_split, "consensus_err": cerr}
    del state, params, cons, x_half, rec
    torch.cuda.empty_cache()

    # (b) checkpoint and resume
    saves = []
    real_save = train.save_checkpoint

    def timed_save(directory, step, tree, **kw):
        t0 = time.perf_counter()
        path = real_save(directory, step, tree, **kw)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path

    train.save_checkpoint = timed_save
    try:
        # async s1 only (packed cut for the script's time); its state
        # holds every consensus entry packed's does
        for label, extra in (("async s1", TEL_RUNS["async s1"]),):
            with tempfile.TemporaryDirectory() as tmp:
                _, half, _, _ = counted(train_argv(
                    2, *extra, "--checkpoint-dir", tmp,
                    "--checkpoint-every", "2"))
                del half
                full = uninterrupted
                setup = train.build_train_setup(
                    get_config("smollm-135m"), consensus_nodes=NODES,
                    lr=1e-2, quant_mode="fixed", device="cuda",
                    total_steps=2, track_consensus_error=True, remat=False,
                    wire_packing="async" if extra else "packed")
                template = train.init_train_state(setup, 7)
                t0 = time.perf_counter()
                state, step = checkpoint.load_checkpoint(tmp, template)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                del template
                ds = SyntheticLMDataset(setup.cfg.vocab_size, SEQ,
                                        4 * NODES, n_shards=NODES)
                for k in range(step, CKPT_STEPS):
                    state, _ = train.train_step(setup, state,
                                                ds.global_batch_arrays(k))
                torch.cuda.synchronize()
            same = (state["step"] == full["step"] == CKPT_STEPS
                    and all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(state["params"]),
                        tree_leaves(full["params"])))
                    and sorted(state["consensus"]) == sorted(full["consensus"])
                    and all(torch.equal(state["consensus"][k],
                                        full["consensus"][k])
                            for k in full["consensus"]))
            save_s, nbytes = saves[-1]
            STACKED_CKPT.update(bytes=nbytes, save_s=save_s)
            if not same or step != 2:
                fail(f"checkpoint {label}: steps 3-{CKPT_STEPS} resumed from "
                     f"the step-{step} checkpoint differ from the "
                     "uninterrupted run")
            line = (f"checkpoint {label}: saved {nbytes} bytes in "
                    f"{save_s:.2f} s ({sorted(full['consensus'])}, params, "
                    f"step), loaded in {load_s:.2f} s; steps 3-{CKPT_STEPS} "
                    f"from it == the uninterrupted {CKPT_STEPS}-step run "
                    "bitwise (params, every consensus entry)")
            print(f"[telemetry] {line}", flush=True)
            summary.append(line)
            del state, full, setup, uninterrupted
            torch.cuda.empty_cache()
    finally:
        train.save_checkpoint = real_save

    # (c) microbatches
    hist, state, _, peak = counted(train_argv(MICRO_STEPS,
                                              "--microbatches", "2"))
    losses = [h["loss"] for h in hist]
    micro_s = statistics.median(h["step_s"] for h in hist[1:])
    del state
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - main_int8[2]) > 1e-4 * main_int8[2]:
        fail(f"microbatches 2: losses {losses}, step 1 of the int8 run "
             f"{main_int8[2]}")
    setups = {m: train.build_train_setup(
        get_config("smollm-135m"), consensus_nodes=NODES, device="cuda",
        microbatches=m, remat=False) for m in (1, 2)}
    params = train.init_train_state(setups[1], 0)["params"]
    batch = SyntheticLMDataset(setups[1].cfg.vocab_size, SEQ, 4 * NODES,
                               n_shards=NODES).global_batch_arrays(0)
    halves = [{k: np.concatenate([v[i * 4 + j * 2:i * 4 + j * 2 + 2]
                                  for i in range(NODES)])
               for k, v in batch.items()} for j in range(2)]
    loss2, g2 = train._node_grads(setups[2], params, batch)
    parts = [train._node_grads(setups[1], params, h) for h in halves]
    same = torch.equal(loss2, (parts[0][0] + parts[1][0]) * 0.5) and all(
        torch.equal(g, (a + b) * 0.5) for g, a, b in zip(
            tree_leaves(g2), tree_leaves(parts[0][1]),
            tree_leaves(parts[1][1])))
    if not same:
        fail("microbatches 2: the gradient differs from the two halves' "
             "gradients added and halved")
    del params, g2, parts
    torch.cuda.empty_cache()
    line = (f"--microbatches 2: {MICRO_STEPS} steps, losses {losses}, "
            f"median step {micro_s:.4f} s, peak memory {peak:.2f} GB, "
            f"against 1 (the main phase's int8 run): {main_int8[0]:.4f} s, "
            f"{main_int8[1]:.2f} GB; the gradient bitwise the two halves' "
            "added and halved")
    print(f"[telemetry] {line}", flush=True)
    summary.append(line)
    return launches_total, split, summary


def phase_paper_elastic(torch, Q, entries):
    """The paper path at N 20, P 2^22 (``paper_circle_problem``'s data,
    int8 fixed through #3): ``run_elastic`` under ``MembershipSchedule.
    from_spec(PAPER_MEMBERSHIP, 20)`` with PAPER_EPOCH-step epochs, with
    and without push-sum; ``run_hierarchical`` at pods 5, 20 and 1, pods
    20 bitwise ``run`` on ``ring(20)``; PAPER_STEPS counted steps each;
    then run_elastic with push-sum through #3 and through its plain
    version over TRAJECTORY_STEPS, bitwise equal.  Returns the launches."""
    from repro_torch.core import compression as C
    from repro_torch.core import consensus as K
    from repro_torch.core import problems as P
    from repro_torch.core import topology as T
    prob = P.paper_circle_problem(PAPER_NODES, seed=0, dim=PAPER_DIM,
                                  device="cuda")
    step = K.StepSize(0.01, eta=0.5)
    fixed = C.Int8BlockQuantizer(mode="fixed")
    alg = K.ADCDGD(T.ring(PAPER_NODES), fixed, step)
    mem = T.MembershipSchedule.from_spec(PAPER_MEMBERSHIP, PAPER_NODES)
    active = np.asarray([sum(mem.mask_at(i // PAPER_EPOCH))
                         for i in range(PAPER_STEPS)], np.float32)
    rejoins = sum(len(mem.rejoiners_at(e)) for e in range(
        1, min(mem.n_epochs, -(-PAPER_STEPS // PAPER_EPOCH))))
    for entry in entries.values():
        entry.launches = 0
    want = {name: 0 for name in entries}

    def timed(fn, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        r = fn(step_events=events, **kw)
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        return r, statistics.median(ms[PAPER_STEP0:]), \
            torch.cuda.max_memory_allocated() / 1e9

    per_iter = alg.bytes_per_iteration(prob)
    for push in (False, True):
        label = f"run_elastic{' push-sum' if push else ''}"
        r, ms, gb = timed(lambda **kw: K.run_elastic(
            alg, prob, PAPER_STEPS, mem, schedule_period=PAPER_EPOCH,
            push_sum=push, **kw))
        want["quantize_blocks"] += PAPER_STEPS
        finite = all(np.isfinite(r[m]).all() for m in
                     ("obj", "grad_norm", "consensus", "max_tx", "x_final"))
        nbytes = np.cumsum(per_iter * (active / np.float32(PAPER_NODES)))
        ok = (finite and np.array_equal(r["active_nodes"], active)
              and np.allclose(r["bytes"], nbytes, rtol=1e-6))
        extra = ""
        if push:
            ps = r["ps_w_final"]
            # mixing and the handoff keep the weights' sum; each rejoin's
            # warm restart re-seeds one weight at 1.  The float32 columns
            # of W sum to 1 within 2^-24 (f32(1/3) x 3), so each step may
            # move the sum by that share
            total = PAPER_NODES + rejoins
            ok = ok and ps.min() > 0 and abs(float(ps.sum()) - total) \
                <= total * PAPER_STEPS * 2.0 ** -24
            extra = (f"; ps_w_final {float(ps.min())!r}-"
                     f"{float(ps.max())!r}, sum {float(ps.sum())!r} "
                     f"({PAPER_NODES} + {rejoins} rejoins)")
        if not ok:
            fail(f"paper {label}: finite {finite}, active "
                 f"{r['active_nodes'][::PAPER_EPOCH]}, bytes "
                 f"{r['bytes'][-1]} (want {nbytes[-1]}){extra}")
        print(f"[paper] {label} under {PAPER_MEMBERSHIP!r} ({PAPER_EPOCH}-"
              f"step epochs), {PAPER_STEPS} steps: step {ms:.4f} ms (CUDA "
              f"events, median of steps {PAPER_STEP0}-{PAPER_STEPS}); "
              f"active per epoch {r['active_nodes'][::PAPER_EPOCH].tolist()}"
              f"; final grad_norm {r['grad_norm'][-1]!r}, consensus "
              f"{r['consensus'][-1]!r}; {r['bytes'][-1]:.0f} bytes{extra}; "
              f"peak memory {gb:.2f} GB", flush=True)
    hier = {}
    for pods in PAPER_PODS:
        r, ms, gb = timed(lambda **kw: K.run_hierarchical(
            prob, pods, PAPER_STEPS, compressor=fixed, stepsize=step, **kw))
        hier[pods] = r
        if pods > 1:
            want["quantize_blocks"] += PAPER_STEPS
        if not all(np.isfinite(r[m]).all() for m in
                   ("obj", "grad_norm", "consensus", "x_final")):
            fail(f"paper run_hierarchical pods {pods}: non-finite metrics")
        print(f"[paper] run_hierarchical pods {pods} (pod size "
              f"{r['pod_size']}), {PAPER_STEPS} steps: step {ms:.4f} ms; "
              f"final grad_norm {r['grad_norm'][-1]!r}, consensus "
              f"{r['consensus'][-1]!r}; bytes outer "
              f"{r['bytes_outer'][-1]:.0f} + inner {r['bytes_inner'][-1]:.0f}"
              f"; peak memory {gb:.2f} GB", flush=True)
    flat = K.run(K.ADCDGD(T.ring(PAPER_NODES, 0.5), fixed, step), prob,
                 PAPER_STEPS)
    want["quantize_blocks"] += PAPER_STEPS
    if not all(np_equal(hier[PAPER_NODES][k], flat[k]) for k in
               ("x_final", "obj", "grad_norm", "consensus", "max_tx",
                "bytes")):
        fail("paper: run_hierarchical at pods 20 differs from run on "
             "ring(20)")
    launches = {name: entry.launches for name, entry in entries.items()}
    if launches != want:
        fail(f"paper path under membership and hierarchy launched "
             f"{launches}, want {want}")
    print(f"[paper] run_hierarchical pods {PAPER_NODES} == run on "
          f"ring({PAPER_NODES}) bitwise (x_final, metrics, bytes); launches "
          f"{({n: v for n, v in launches.items() if v})}", flush=True)
    # 4-step epochs: the 5 epochs of the schedule fit in the run, which
    # ends with every node active (a departed node's x / ps_w is 0 / 0)
    kern = K.run_elastic(alg, prob, TRAJECTORY_STEPS, mem,
                         schedule_period=TRAJECTORY_STEPS // 5,
                         push_sum=True, key=5)
    real = Q.quantize_blocks
    Q.quantize_blocks = Q.quantize_blocks_plain
    try:
        plain = K.run_elastic(alg, prob, TRAJECTORY_STEPS, mem,
                              schedule_period=TRAJECTORY_STEPS // 5,
                              push_sum=True, key=5)
    finally:
        Q.quantize_blocks = real
    for name in ("x_final", "ps_w_final", "obj", "grad_norm", "consensus",
                 "max_tx", "bytes", "active_nodes"):
        if not np_equal(kern[name], plain[name]):
            fail(f"run_elastic through kernel #3 and through its plain "
                 f"version differ in {name}")
    print(f"[paper] run_elastic push-sum through kernel #3 and through "
          f"quantize_blocks_plain: bitwise equal over {TRAJECTORY_STEPS} "
          "steps across the outages (x_final, ps_w_final, metrics)",
          flush=True)
    del prob
    torch.cuda.empty_cache()
    return launches


def phase_perleaf(torch, train, entries):
    """The per-leaf transport and compressed_dgd on the full smollm-135m x
    4 nodes, each run counted on its own."""
    per_leaf_kernels = ("quantize_blocks", "dequant_combine")
    launches_total = {name: 0 for name in entries}

    def counted(label, steps, want, *extra):
        (hist, state), launches, _ = run_counted(
            torch, train, entries, train_argv(steps, *extra),
            return_state=True)
        full = {name: want.get(name, 0) for name in entries}
        if launches != full:
            fail(f"{label}: launched {launches}, want {full}")
        losses = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{label}: non-finite loss: {losses}")
        for name, n in launches.items():
            launches_total[name] += n
        return hist, state

    per_leaf = {name: NODES * N_LEAVES * CODEC_STEPS
                for name in per_leaf_kernels}
    hist_pl, st_pl = counted("adc_dgd per_leaf", CODEC_STEPS, per_leaf,
                             "--wire-packing", "per_leaf")
    wire = [h["wire_bytes_per_step"] for h in hist_pl]
    coll = [h["collectives_per_step"] for h in hist_pl]
    if set(wire) != {PER_LEAF_WIRE_BYTES} or set(coll) != {4.0 * N_LEAVES}:
        fail(f"per_leaf: wire_bytes_per_step {wire} (want "
             f"{PER_LEAF_WIRE_BYTES}), collectives {coll}")
    packed = {name: NODES * CODEC_STEPS for name in CODEC_KERNELS["int8"]}
    hist_pk, st_pk = counted("adc_dgd packed", CODEC_STEPS, packed)
    from repro_torch.core import tree as T
    same = all(torch.equal(a, b) for a, b in zip(
        T.tree_leaves(st_pl["params"]), T.tree_leaves(st_pk["params"])))
    same_state = all(torch.equal(st_pl["consensus"][k], st_pk["consensus"][k])
                     for k in st_pk["consensus"])
    if not (same and same_state):
        fail("per_leaf run's final parameters or shadows differ from the "
             "packed run's from the same seed")
    del st_pl, st_pk
    print(f"[main] smollm-135m x {NODES} nodes, adc_dgd fixed, per_leaf "
          f"int8 wire: {CODEC_STEPS} steps, launches "
          f"{ {n: per_leaf[n] for n in per_leaf_kernels} }, "
          f"wire_bytes_per_step {wire[-1]:.0f}, collectives {coll[-1]:.0f}; "
          f"final parameters and shadows bitwise equal to the packed run's")
    hist_cp, _ = counted("compressed_dgd packed", CODEC_STEPS,
                         {"quantize_payload": NODES * CODEC_STEPS},
                         "--algorithm", "compressed_dgd")
    hist_cl, _ = counted("compressed_dgd per_leaf", CODEC_STEPS,
                         {"quantize_blocks": NODES * N_LEAVES * CODEC_STEPS},
                         "--algorithm", "compressed_dgd", "--wire-packing",
                         "per_leaf")
    for step, (a, c, cl) in enumerate(zip(hist_pk, hist_cp, hist_cl)):
        print(f"[main] step {step}: loss adc_dgd {a['loss']!r}, "
              f"compressed_dgd {c['loss']!r} (per_leaf {cl['loss']!r}); "
              f"consensus_err adc_dgd {a['consensus_err']!r}, "
              f"compressed_dgd {c['consensus_err']!r}")
    return launches_total


def phase_serve(torch, serve, entries):
    """``serve.main`` on the full smollm-135m, its launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    for entry in entries.values():
        entry.launches = 0
    r = serve.main(["--arch", "smollm-135m", "--batch", str(SERVE_BATCH),
                    "--prompt-len", str(SERVE_PROMPT), "--new-tokens",
                    str(SERVE_NEW), "--keep-logits", "2", "--seed", "0",
                    "--device", "cuda"])
    launches = {name: entry.launches for name, entry in entries.items()}
    cfg = get_config("smollm-135m")
    want = {name: 0 for name in entries}
    want["gqa_decode"] = cfg.n_periods * (SERVE_NEW - 1)
    if launches != want:
        fail(f"serve launched {launches}, want {want}")
    tok = r["tokens"]
    if (tok.shape != (SERVE_BATCH, SERVE_NEW) or tok.min() < 0
            or tok.max() >= cfg.vocab_size
            or r["cache_len"] != SERVE_PROMPT + SERVE_NEW - 1):
        fail(f"serve: tokens {tok.shape} in [{tok.min()}, {tok.max()}], "
             f"cache length {r['cache_len']}")
    # the decode logits of 2 sequences against one train-mode forward over
    # the prompt and the generated tokens, from the weights main drew
    defs = TF.build_defs(cfg)
    params = init_params(defs.storage, 0, "cuda")
    import numpy as np
    seq = np.concatenate([r["prompts"][:2], tok[:2]], axis=1)
    with torch.inference_mode():
        full, _ = TF.model_apply(
            params, defs, {"tokens": torch.as_tensor(seq[:, :-1],
                                                     device="cuda")})
    want_l = full[:, SERVE_PROMPT:SERVE_PROMPT + SERVE_NEW - 1].cpu()
    got_l = torch.from_numpy(r["logits"])
    err = float((got_l - want_l).abs().max())
    if not torch.allclose(got_l, want_l, atol=SERVE_LOGIT_TOL,
                          rtol=SERVE_LOGIT_TOL):
        fail(f"serve: decode logits differ from the train-mode forward by "
             f"up to {err} (tolerance {SERVE_LOGIT_TOL})")
    del params, full
    print(f"[serve] smollm-135m, {SERVE_BATCH} x {SERVE_PROMPT} prompt + "
          f"{SERVE_NEW} tokens: gqa_decode launched "
          f"{launches['gqa_decode']} times; prefill {r['prefill_s']!r} s, "
          f"decode {r['decode_s_per_token'] * 1e3!r} ms per token for the "
          f"batch, peak memory {r['peak_gb']!r} GB; decode logits of 2 "
          f"sequences vs a train-mode forward: max |diff| {err!r}")
    return launches, r


#: steady decode steps traced by the serve profile (after 2 warm-up steps)
PROFILE_STEPS = 4


def phase_serve_profile(torch, G, compute_dtype=None):
    """Breakdown of steady serve decode steps on the full smollm-135m (32
    sequences, 1,984 prompt tokens, capacity 2,048), at ``compute_dtype``
    (compute and cache; float32 when None): ``torch.profiler``
    with CPU and CUDA activities over PROFILE_STEPS steps; the top kernels
    by device time, #9's share of the step and the device's idle share.
    Where the profiler reports no device time, #9's time per step is taken
    from CUDA events over the 30 layers' caches instead."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.params import init_params
    cfg = get_config("smollm-135m")
    cdt = compute_dtype or torch.float32
    label = "" if cdt == torch.float32 else f" {cdt}".replace("torch.", "")
    pre = serve.build_prefill_setup(cfg, device="cuda", compute_dtype=cdt)
    srv = serve.build_serve_setup(cfg, device="cuda", compute_dtype=cdt)
    params = init_params(pre.defs.storage, 0, "cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    first, cache = pre.prefill_step(
        params, {"tokens": torch.as_tensor(prompts, device="cuda")},
        SERVE_PROMPT + SERVE_NEW, srv.cache_dtype)
    state = {"params": params, "cache": cache, "tokens": first}

    def steps():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state = srv.serve_step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS

    steps()                                    # warm-up
    step_ms = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = steps()

    def self_device_us(e):
        t = getattr(e, "self_device_time_total", None)
        return getattr(e, "self_cuda_time_total", 0) if t is None else t

    kernels = sorted(((self_device_us(e) / 1e3 / PROFILE_STEPS,
                       e.count / PROFILE_STEPS, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    cpu_ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")) / PROFILE_STEPS
    print(f"[profile] serve decode{label}, smollm-135m {SERVE_BATCH} "
          f"sequences at cache position {state['cache']['len']}: step "
          f"{step_ms:.4f} ms ({traced_ms:.4f} ms traced), {PROFILE_STEPS} "
          f"steps traced, {cpu_ops:g} aten ops per step on the host")
    attn = [k for k in kernels if "gqa_decode" in k[2]]
    if busy_ms > 0 and not attn:
        fail(f"serve profile: {len(kernels)} kernels ran, none of them "
             f"gqa_decode: {[k[2][:60] for k in kernels[:10]]}")
    if busy_ms > 0:
        for ms, n, name in kernels[:10]:
            print(f"[profile]   {ms:.4f} ms per step ({ms / busy_ms:.1%} of "
                  f"device time), {n:g} launches per step: {name[:90]}")
        attn_ms = sum(k[0] for k in attn)
        print(f"[profile]{label} device busy {busy_ms:.4f} ms per step, idle share "
              f"{1 - busy_ms / traced_ms:.1%} of the traced step; gqa_decode "
              f"{attn_ms:.4f} ms per step: {attn_ms / step_ms:.1%} of the "
              f"untraced step, {attn_ms / busy_ms:.1%} of device time; "
              f"{len(kernels)} kernels by name")
    else:
        caches = state["cache"]["layers"][0]["attn"]
        valid = (torch.arange(caches["k"].shape[2], device="cuda")
                 < state["cache"]["len"])
        q = torch.randn((SERVE_BATCH, cfg.n_kv_heads,
                         cfg.n_heads // cfg.n_kv_heads,
                         cfg.resolved_head_dim), device="cuda")
        attn_ms = cfg.n_periods * time_ms(
            [lambda k=k, v=v: G.gqa_decode(q, k, v, valid)
             for k, v in zip(caches["k"], caches["v"])], 4 * cfg.n_periods)
        print(f"[profile] key_averages() shows no device time for the "
              f"kernels on this machine ({len(kernels)} device entries); "
              f"gqa_decode from CUDA events over the {cfg.n_periods} "
              f"layers' caches: {attn_ms:.4f} ms per step, "
              f"{attn_ms / step_ms:.1%} of the step")
    del state, params, cache
    torch.cuda.empty_cache()


def phase_serve_parity(torch):
    """Reduced smollm-135m serving on the card and on the CPU from the same
    weights and prompts."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tree as T
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("smollm-135m"))
    b, p, n = 2, 16, 8
    base = init_params(TF.build_defs(cfg).storage, 0, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, p),
                                                dtype=np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        params = T.tree_map(lambda a: a.to(dev), base)
        pre = serve.build_prefill_setup(cfg, device=dev)
        srv = serve.build_serve_setup(cfg, device=dev, keep_logits=b)
        first, cache = pre.prefill_step(
            params, {"tokens": torch.as_tensor(prompts, device=dev)}, p + n)
        state = {"params": params, "cache": cache, "tokens": first}
        toks, logits = [first.cpu()], []
        for _ in range(n - 1):
            state = srv.serve_step(state)
            toks.append(state["tokens"].cpu())
            logits.append(state["logits"].cpu())
        out[dev] = (torch.cat(toks, 1), torch.stack(logits, 1))
    (t_cpu, l_cpu), (t_gpu, l_gpu) = out["cpu"], out["cuda"]
    if torch.equal(t_cpu, t_gpu):
        err = float((l_cpu - l_gpu).abs().max())
        if not torch.allclose(l_gpu, l_cpu, atol=SERVE_LOGIT_TOL,
                              rtol=SERVE_LOGIT_TOL):
            fail(f"serve parity: logits differ by {err}")
        print(f"[parity] reduced smollm-135m serving, {b} x {p} prompt + "
              f"{n} tokens, card vs CPU: tokens equal, decode logits max "
              f"|diff| {err!r}")
        return
    # a flip is only allowed at a near tie, before which all agrees
    step = int((t_cpu != t_gpu).any(0).nonzero()[0])
    if step == 0:
        fail(f"serve parity: the prefill's tokens differ: {t_cpu[:, 0]} vs "
             f"{t_gpu[:, 0]}")
    a, c = l_gpu[:, step - 1], l_cpu[:, step - 1]
    top2 = torch.topk(c, 2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    if not (torch.allclose(a, c, atol=SERVE_LOGIT_TOL, rtol=SERVE_LOGIT_TOL)
            and gap <= 2 * SERVE_LOGIT_TOL):
        fail(f"serve parity: token {step} differs without a near tie (top-2 "
             f"gap {gap}, logits |diff| {float((a - c).abs().max())})")
    print(f"[parity] reduced smollm-135m serving, card vs CPU: token {step} "
          f"flipped at a near tie (top-2 gap {gap!r}); the logits before it "
          f"agree within {SERVE_LOGIT_TOL}")


#: the dense model zoo (``phase_zoo``), each run at full width on random
#: weights from seed 0: (label, arch, periods (None: the full depth),
#: long-serve, sequences, prompt tokens); every run adds ZOO_NEW tokens.
#: Depths cut for the script's time (#9's shapes are per layer): gemma2-9b
#: 5 of 21 periods, yi-9b 12 of 48 layers, qwen3-0.6b 7 of 28 and
#: chameleon-34b 3 of 48 (full depth, and 12 layers of chameleon-34b,
#: until the process ring's 5-rank group; half again when the ring ran
#: membership, hierarchy and a checkpoint)
ZOO_NEW = 64
ZOO_SERVE = (
    ("gemma2-9b, 5 of 21 periods", "gemma2-9b", 5, False, 4, 6080),
    ("gemma2-9b long-serve, 2 of 21 periods", "gemma2-9b", 2, True, 1,
     32832),
    ("yi-9b, 12 of 48 layers", "yi-9b", 12, False, 8, 1984),
    ("chameleon-34b, 3 of 48 layers", "chameleon-34b", 3, False, 4, 1984),
    ("qwen3-0.6b, 7 of 28 layers", "qwen3-0.6b", 7, False, 32, 1984),
)
#: the zoo trainer: full qwen3-0.6b on 3 nodes (4 x 512 tokens each), the
#: int8 packed wire on the fixed grid, and the reference's wire bytes per
#: node and step for its tree: 2 x 1,164,160 rows x 516
#: (``tests/test_torch_zoo.py`` holds the rows to the reference's layout);
#: 3 steps (5 until the process ring's 5-rank group, cut for time)
ZOO_TRAIN_NODES, ZOO_TRAIN_STEPS = 3, 3
#: a zoo run's decode logits against its train-mode forward (absolute and
#: relative): both are float32, but a prefill's matrix products and a
#: decode step's matrix-vector products sum in other orders, over up to 48
#: layers of width 4,096-8,192 here against smollm-135m's 30 of 576 (yi-9b
#: measured 3.3e-5 where SERVE_LOGIT_TOL allows 1e-5).  A decode step
#: through the plain flash-decode version is still held to SERVE_LOGIT_TOL
ZOO_LOGIT_TOL = 1e-4
ZOO_TRAIN_WIRE_BYTES = 1_201_413_120


class KernelVsPlain:
    """Within the block every call of #1 and #2 (``ops.quantize_payload``,
    ``ops.dequant_combine_payload``) is held, right after its launch, to
    its plain version on the same inputs, bitwise (``calls``, ``equal``).
    So a step through the plain versions is the kernels' step, bit for
    bit.  The plain version runs CHUNK rows at a time: at 3 qwen3-0.6b
    nodes a whole node's plain temporaries do not fit beside the
    trainer's buffers.  A kernel's outputs must not share storage with
    its inputs (they are the exchange's own out buffers), so the inputs
    are still as the kernel read them."""

    CHUNK = 1 << 16

    def __init__(self, torch, Q, D):
        self.torch, self.Q, self.D = torch, Q, D
        self.calls, self.equal = 0, True

    def _check(self, got, operands, row_offset, n_rows, plain):
        torch = self.torch
        outs = tuple(got) if isinstance(got, (tuple, list)) else (got,)
        ins = {a.untyped_storage().data_ptr() for a in operands}
        if any(o.untyped_storage().data_ptr() in ins for o in outs):
            fail("KernelVsPlain: a kernel wrote into the storage of one of "
                 "its inputs")
        n = self.Q.chunk_view(operands[-1].shape[0], n_rows, row_offset)
        views = [a if a.shape[0] == n else a[row_offset:row_offset + n]
                 for a in operands]
        for r0 in range(0, n, self.CHUNK):
            m = min(self.CHUNK, n - r0)
            want = plain(*(v[r0:r0 + m] for v in views))
            want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
            self.equal &= len(want) == len(outs) and all(
                torch.equal(o.reshape(n, -1)[r0:r0 + m], w.reshape(m, -1))
                for o, w in zip(outs, want))
        self.calls += 1

    def __enter__(self):
        from repro_torch.kernels import ops
        Q, D, watch = self.Q, self.D, self
        self.saved = (ops.quantize_payload, ops.dequant_combine_payload)
        real_q, real_d = self.saved

        def spy_q(y, noise, fixed_step=None, row_offset=0, n_rows=None,
                  out=None):
            got = real_q(y, noise, fixed_step, row_offset, n_rows, out=out)
            watch._check(got, (noise, y), row_offset, n_rows,
                         lambda u, yy: Q.quantize_payload_plain(
                             yy, u, fixed_step))
            return got

        def spy_d(ps, pl, pr, xt, mb, w_self, w_side, deamp, row_offset=0,
                  n_rows=None, out=None):
            got = real_d(ps, pl, pr, xt, mb, w_self, w_side, deamp,
                         row_offset, n_rows, out=out)
            watch._check(got, (ps, pl, pr, mb, xt), row_offset, n_rows,
                         lambda a, b, c, m_, x: D.dequant_combine_payload_plain(
                             a, b, c, x, m_, w_self, w_side, deamp))
            return got

        ops.quantize_payload, ops.dequant_combine_payload = spy_q, spy_d
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.kernels import ops
        ops.quantize_payload, ops.dequant_combine_payload = self.saved
        return False


def attention_layers(cfg) -> int:
    """Layers that decode through #9: every block but the Mamba2 ones."""
    return sum(c not in "MX" for c in cfg.prelude + cfg.period
               * cfg.n_periods)


def zoo_serve(torch, G, entries, label, arch, periods, long_serve, batch,
              prompt, tag="zoo", tol=None, probe64=False, compute=None,
              rel_tol=None, step_rel_tol=None):
    """One serve run of the zoo, counted (#9 once per attention layer and
    decode step, nothing else), then checked: its decode logits of 2
    sequences against a train-mode forward over prompt + generated tokens
    within ``tol`` (ZOO_LOGIT_TOL when None), and, when the model has
    attention layers, one decode step through the plain flash-decode
    version against the kernel's.  With ``probe64`` the same forward also
    runs in float64, and the distances of the decode's and the float32
    forward's logits from it are reported.  An encoder-decoder's forward
    and plain step take the served frames of their sequences, and one
    call of its encoder over all the frames is timed with CUDA events.
    With ``compute`` ("bfloat16") the run serves at that compute and cache
    dtype, the forward runs at it, and the logits are held to ``rel_tol``
    and the plain-#9 step to ``step_rel_tol`` times the largest logit.
    Returns (#9 launches, a summary dict)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    flags = ["--long-serve"] if long_serve else []
    if periods is not None:
        cfg = dataclasses.replace(cfg, n_periods=periods)
        flags += ["--periods", str(periods)]
    cdt = torch.float32
    if compute is not None:
        cdt = getattr(torch, compute)
        flags += ["--compute-dtype", compute, "--cache-dtype", compute]
    for entry in entries.values():
        entry.launches = 0
    r = serve.main(["--arch", arch, *flags, "--batch", str(batch),
                    "--prompt-len", str(prompt), "--new-tokens",
                    str(ZOO_NEW), "--keep-logits", "2", "--seed", "0",
                    "--device", "cuda"])
    launches = {name: entry.launches for name, entry in entries.items()}
    tol = ZOO_LOGIT_TOL if tol is None else tol
    n_attn = attention_layers(cfg)
    want = {name: 0 for name in entries}
    # an encoder-decoder's decoder layers decode self and cross attention
    want["gqa_decode"] = (n_attn * (2 if cfg.is_encoder_decoder else 1)
                          * (ZOO_NEW - 1))
    if launches != want:
        fail(f"{tag} {label}: serve launched {launches}, want {want}")
    tok = r["tokens"]
    if (tok.shape != (batch, ZOO_NEW) or tok.min() < 0
            or tok.max() >= cfg.vocab_size
            or r["cache_len"] != prompt + ZOO_NEW - 1
            or not np.isfinite(r["logits"]).all()):
        fail(f"{tag} {label}: tokens {tok.shape} in [{tok.min()}, "
             f"{tok.max()}], cache length {r['cache_len']}, finite logits "
             f"{np.isfinite(r['logits']).all()}")
    torch.cuda.empty_cache()
    defs = TF.build_defs(cfg, dtype=cdt)
    params = init_params(defs.storage, 0, "cuda")
    extra, encoder_ms = {}, None
    if "frames" in r:
        frames = torch.as_tensor(r["frames"], device="cuda").to(cdt)
        extra = {"enc_frames": frames[:2]}
        with torch.inference_mode():
            TF._encoder_apply(params, cfg, frames)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            TF._encoder_apply(params, cfg, frames)
            ev[1].record()
            torch.cuda.synchronize()
        encoder_ms = ev[0].elapsed_time(ev[1])
        del frames
        torch.cuda.empty_cache()
    # a causal forward over the whole sequence (prompt + 64 tokens) has the
    # same logits at the first 63 generated positions as one over all but
    # the last token, and a length with large divisors (chunked_attention's
    # blocks divide it); a model with Mamba2 blocks takes a multiple of its
    # chunk, so the sequence is padded with token 0 after them
    seq = np.concatenate([r["prompts"][:2], tok[:2]], 1)
    if n_attn < cfg.n_layers:
        seq = np.pad(seq, ((0, 0), (0, -seq.shape[1] % cfg.ssm_chunk)))
    seq = torch.as_tensor(seq, device="cuda")
    with torch.inference_mode():
        full, _ = TF.model_apply(params, defs, {"tokens": seq, **extra},
                                 compute_dtype=cdt, long_serve=long_serve,
                                 logits_from=prompt)
        full = full[:, :ZOO_NEW - 1].cpu()
        uncapped_diff = None
        if long_serve:
            free, _ = TF.model_apply(params, defs, {"tokens": seq},
                                     logits_from=prompt)
            uncapped_diff = float((free[:, :ZOO_NEW - 1].cpu()
                                   - full).abs().max())
            del free
    got = torch.from_numpy(r["logits"])
    err = float((got - full).abs().max())
    if rel_tol is not None:
        tol = rel_tol * float(full.abs().max())
    probe = None
    if probe64:
        from repro_torch.core import tree as T
        with torch.inference_mode():
            p64 = T.tree_map(lambda a: a.double(), params)
            full64 = TF.model_apply(p64, defs, {"tokens": seq, **extra},
                                    compute_dtype=torch.float64,
                                    logits_from=prompt)[0]
            full64 = full64[:, :ZOO_NEW - 1].cpu()
            del p64
        probe = (float((got.double() - full64).abs().max()),
                 float((full.double() - full64).abs().max()))
        del full64
    if not torch.allclose(got, full, atol=tol,
                          rtol=0.0 if rel_tol is not None else tol):
        fail(f"{tag} {label}: decode logits differ from the train-mode "
             f"forward by up to {err} (tolerance {tol}"
             + (f"; from a float64 forward: decode {probe[0]}, forward "
                f"{probe[1]}" if probe else "") + ")")
    if long_serve and not uncapped_diff > 10 * ZOO_LOGIT_TOL:
        fail(f"zoo {label}: the logits without the {cfg.long_context_window}"
             f"-position cap differ by only {uncapped_diff}: the cap did "
             "not bite")
    del full
    torch.cuda.empty_cache()
    seq_len = seq.shape[1]
    step_err = None
    if n_attn:
        step_err = plain_decode_step(torch, G, f"{tag} {label}", cfg, defs,
                                     params, seq[:, :prompt], long_serve,
                                     extra, compute_dtype=cdt,
                                     rel_tol=step_rel_tol)
    del params, seq
    torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "compute": str(cdt), "tol": tol,
           "prefill_s": r["prefill_s"],
           "decode_ms": r["decode_s_per_token"] * 1e3,
           "peak_gb": r["peak_gb"], "launches": launches["gqa_decode"],
           "logit_err": err, "plain_step_err": step_err}
    if long_serve:
        out["uncapped_diff"] = uncapped_diff
    if encoder_ms is not None:
        out["encoder_ms"] = encoder_ms
    if probe:
        out["decode_vs_f64"], out["forward_vs_f64"] = probe
    print(f"[{tag}] {label} ({cfg.n_layers} layers), {batch} x {prompt} "
          f"prompt + {ZOO_NEW} tokens"
          + (f", 'A' blocks capped at {cfg.long_context_window}"
             if long_serve else "")
          + (f", {r['frames'].shape[1]} frames per request"
             if encoder_ms is not None else "")
          + f": gqa_decode launched {launches['gqa_decode']} times "
          f"({n_attn} attention layers"
          + (" x 2 (self and cross)" if cfg.is_encoder_decoder else "")
          + f" x {ZOO_NEW - 1}), no other kernel; "
          f"prefill {r['prefill_s']!r} s, decode {out['decode_ms']!r} ms "
          f"per token for the batch, peak memory {r['peak_gb']!r} GB; "
          f"decode logits of {got.shape[0]} sequences vs a train-mode "
          f"forward over "
          f"{seq_len} tokens: max |diff| {err!r} (tolerance {tol:g})"
          + (f", each from the same forward in float64: decode {probe[0]!r},"
             f" float32 forward {probe[1]!r}" if probe else "")
          + (f"; one decode step through the plain gqa_decode vs the "
             f"kernel: max |diff| {step_err!r}" if n_attn else "")
          + (f"; without the cap the logits move by up to "
             f"{uncapped_diff!r}" if long_serve else "")
          + (f"; the encoder alone over all {batch} requests' frames "
             f"{encoder_ms!r} ms (CUDA events)" if encoder_ms is not None
             else ""), flush=True)
    return launches["gqa_decode"], out


def plain_decode_step(torch, G, what, cfg, defs, params, prompts,
                      long_serve=False, extra=None,
                      compute_dtype=None, rel_tol=None):
    """One decode step of ``prompts`` (a device tensor, prefilled with the
    batch entries ``extra``: an encoder-decoder's frames) through the
    kernel and through the plain flash-decode version, each from the same
    prefilled cache (the plain step's a copy: a step overwrites the Mamba2
    blocks' states in place), at ``compute_dtype`` (float32 when None;
    the cache in the same dtype).  Fails unless the logits agree within
    SERVE_LOGIT_TOL, or with ``rel_tol`` within that share of the largest
    logit; returns their max |diff|."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    cdt = compute_dtype or torch.float32
    pre = serve.build_prefill_setup(cfg, device="cuda", compute_dtype=cdt,
                                    long_serve=long_serve)
    with torch.inference_mode():
        first, cache = pre.prefill_step(params, {"tokens": prompts,
                                                 **(extra or {})},
                                        prompts.shape[1] + 1)
        twin = {k: (v if k == "len" else T.tree_map(torch.clone, v))
                for k, v in cache.items()}
        _, _, kern = TF.greedy_decode_step(params, defs, first, cache,
                                           compute_dtype=cdt,
                                           long_serve=long_serve)
        saved, ops.gqa_decode = ops.gqa_decode, G.gqa_decode_plain
        try:
            _, _, plain = TF.greedy_decode_step(params, defs, first, twin,
                                                compute_dtype=cdt,
                                                long_serve=long_serve)
        finally:
            ops.gqa_decode = saved
    err = float((kern - plain).abs().max())
    atol = rtol = SERVE_LOGIT_TOL
    if rel_tol is not None:
        atol, rtol = rel_tol * float(kern.abs().max()), 0.0
    if not torch.allclose(kern, plain, atol=atol, rtol=rtol):
        fail(f"{what}: a decode step through the plain gqa_decode differs "
             f"from the kernel's by {err}")
    del cache, twin, kern, plain
    torch.cuda.empty_cache()
    return err


def zoo_train(torch, Q, D, train, entries, arch="qwen3-0.6b", periods=None,
              nodes=ZOO_TRAIN_NODES, wire_bytes=ZOO_TRAIN_WIRE_BYTES,
              tag="zoo", node_batch=4, seq=SEQ, extra=()):
    """``arch`` at full width (cut to ``periods`` periods when given) on
    the consensus trainer, ``nodes`` nodes x ``node_batch`` x ``seq``
    tokens (with their frames for an encoder-decoder), int8 packed
    on the fixed grid for ZOO_TRAIN_STEPS steps, counted, with every call
    of #1 and #2 held to its plain version (``KernelVsPlain``) and the
    reference's ``wire_bytes`` per node and step.  Returns (launches, a
    summary dict)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import wire
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import meta_params
    cut = ["--periods", str(periods)] if periods else []
    argv = ["--arch", arch, *cut, "--algorithm", "adc_dgd", "--nodes",
            str(nodes), "--batch", str(node_batch * nodes), "--seq",
            str(seq),
            "--steps", str(ZOO_TRAIN_STEPS), "--quant-mode", "fixed", "--lr",
            "1e-2", "--device", "cuda", *NO_REMAT, *extra]
    with KernelVsPlain(torch, Q, D) as watch:
        hist, launches, peak = run_counted(torch, train, entries, argv)
    want = {name: 0 for name in entries}
    for name in CODEC_KERNELS["int8"]:
        want[name] = nodes * ZOO_TRAIN_STEPS
    if launches != want:
        fail(f"{tag} trainer: launched {launches}, want {want}")
    if not watch.equal or watch.calls != 2 * want["quantize_payload"]:
        fail(f"{tag} trainer: {watch.calls} calls of #1 and #2 held to their "
             f"plain versions, all bitwise equal: {watch.equal}")
    cfg = get_config(arch)
    if periods:
        cfg = dataclasses.replace(cfg, n_periods=periods)
    rows = wire.WireLayout.for_tree(meta_params(
        TF.build_defs(cfg).storage)).n_rows
    wires = {h["wire_bytes_per_step"] for h in hist}
    if wires != {wire_bytes} or 2 * rows * PAYLOAD != wire_bytes:
        fail(f"{tag} trainer: wire_bytes_per_step {wires}, from the "
             f"layout's {rows} rows {2 * rows * PAYLOAD}, the reference's "
             f"{wire_bytes}")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"{tag} trainer: losses {losses} (step 1 should be near "
             f"ln({cfg.vocab_size}) at random init)")
    step_s = statistics.median(h["step_s"] for h in hist[1:])
    depth = (f", {periods} of {get_config(arch).n_periods} periods"
             if periods else "")
    print(f"[{tag}] {arch} trainer{depth}, {nodes} nodes x {node_batch} x "
          f"{seq} tokens"
          + (f" with their {cfg.encoder_frames} frames"
             if cfg.is_encoder_decoder else "")
          + f", int8 packed, fixed grid, {ZOO_TRAIN_STEPS} steps: "
          f"losses {losses}; launches "
          f"{ {n: v for n, v in launches.items() if v} }; "
          f"wire_bytes_per_step {wire_bytes} (2 x {rows} rows x "
          f"{PAYLOAD}, the reference's accounting); {watch.calls} calls of "
          f"#1 and #2 bitwise equal to their plain versions on the same "
          f"inputs; median step {step_s:.4f} s; peak memory {peak:.2f} GB",
          flush=True)
    torch.cuda.empty_cache()
    return launches, {"step_s": step_s, "peak_gb": peak}


def phase_zoo(torch, Q, D, G, train, entries):
    """The dense zoo at full width (``ZOO_SERVE``, then the qwen3-0.6b
    trainer), each model freed before the next is built.  Returns (the
    launches of every kernel over the phase, summaries by run)."""
    launches = {name: 0 for name in entries}
    summary = {}
    for run in ZOO_SERVE:
        n, summary[run[0]] = zoo_serve(torch, G, entries, *run)
        launches["gqa_decode"] += n
    train_launches, summary["qwen3-0.6b trainer"] = zoo_train(
        torch, Q, D, train, entries)
    for name, n in train_launches.items():
        launches[name] += n
    return launches, summary


#: the mixture-of-experts serve runs (``phase_moe``): (label, arch, periods
#: (None: full depth), batch, prompt), each at full width with 64 new tokens
#: and freed before the next.  granite-moe-3b-a800m: 8 of its 32 layers
#: (all 32 until the process ring's 5-rank group, 16 until it ran
#: membership, hierarchy and a checkpoint, cut for time); deepseek-moe-16b: its dense 'D' prelude and
#: 27 'E' periods, 65.5 GB of weights
MOE_SERVE = (
    ("granite-moe-3b-a800m", "granite-moe-3b-a800m", 8, 32, 1984),
    ("deepseek-moe-16b", "deepseek-moe-16b", None, 2, 1984),
)
#: the MoE trainer: granite-moe-3b-a800m at full width cut to 3 of its 32
#: periods (1.81 GB of float32 per node; 4 periods ran out of the card's
#: memory at 4 nodes, 3 peak at 69.4 GB), 4 nodes x 4 x 512 tokens, int8
#: packed on the fixed grid; the reference's wire bytes per node and step
#: for this tree, 2 x 885,152 rows x 516 (``tests/test_torch_moe.py``)
#: (3 steps: 5 until the process ring's 5-rank group, cut for time)
MOE_TRAIN_PERIODS, MOE_TRAIN_NODES, MOE_TRAIN_STEPS = 3, 4, 3
MOE_TRAIN_WIRE_BYTES = 913_476_864
#: the routing oracle: one full-width MoE layer of each arch on this many
#: tokens at capacity factor 1.25; every token is a standard normal draw
#: plus one shared draw times MOE_ORACLE_SHIFT, so that the tokens agree
#: on some experts, which overflow and drop
MOE_ORACLE_TOKENS, MOE_ORACLE_SHIFT = 2048, 0.5
#: the oracle's output against moe_forward's (absolute and relative): the
#: same products, but the oracle multiplies each expert's kept rows alone
#: and the port all of its capacity slots at once, so the matrix products
#: take other blockings and sum in other orders
MOE_ORACLE_TOL = 1e-4
#: a routing decision that rounding may flip: the k-th and the next
#: probability closer than this
MOE_TIE_MARGIN = 1e-5
#: the no-drop check (``moe_no_drop``): this many prompts of
#: MOE_NO_DROP_PROMPT tokens, each prefilled alone, then decoded together.
#: Every routing decision, prompt tokens' too, may flip at a near tie and
#: end its sequence's comparison; at the served prompts' 1,984 tokens 1 of
#: 4 granite and 3 of 4 deepseek sequences flipped in their prompts (H100
#: 80GB HBM3), so the prompts are short.  At least MOE_MIN_COMPARED of the
#: decode steps in all (half) must come before the flips
MOE_NO_DROP_SEQS, MOE_NO_DROP_PROMPT = 8, 64
MOE_MIN_COMPARED = MOE_NO_DROP_SEQS * (ZOO_NEW - 1) // 2


class RouteWatch:
    """Within the block every call of ``models.moe.route`` (the routing
    ``moe_forward`` does) leaves its token count and the number of its
    assignments dropped past the capacity, as a device tensor, so that the
    watch adds no synchronisation; up to ``limit`` calls (all when None).
    ``dropped(t)`` sums them over the calls that routed ``t`` tokens:
    (assignments dropped, assignments).  With ``routes`` each call also
    leaves its tokens' chosen experts in ascending id and their margin:
    the k-th largest probability less the next one."""

    def __init__(self, limit=None, routes=False):
        self.limit, self.routes, self.calls = limit, routes, []

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = real = moe.route

        def spy(router, xf, cfg):
            r = real(router, xf, cfg)
            if self.limit is None or len(self.calls) < self.limit:
                call = (xf.shape[0], r.keep.numel(), (~r.keep).sum())
                if self.routes:
                    srt = r.probs.sort(dim=-1, descending=True).values
                    call += (r.top_e.sort(dim=1).values,
                             srt[:, cfg.top_k - 1] - srt[:, cfg.top_k])
                self.calls.append(call)
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.models import moe
        moe.route = self.saved
        return False

    def dropped(self, t: int) -> tuple[int, int]:
        picked = [(n, d) for tt, n, d in self.calls if tt == t]
        return (int(sum(int(d) for _, d in picked)),
                sum(n for n, _ in picked))


def route_flips(torch, calls, n_moe, n_seq, prompt, steps):
    """Where a no-drop serve run and the train-mode forwards after it (one
    per sequence, over prompt + generated tokens) chose other experts for
    the same token, from a ``RouteWatch(routes=True)``: the prefills of
    ``n_seq`` sequences one at a time, then ``steps`` decode steps of all
    of them, then the ``n_seq`` forwards, each ``n_moe`` calls.  Returns
    ([(sequence, step (a prompt position counts from -prompt), MoE layer,
    the smaller of the two margins)], the assignments dropped over all
    calls)."""
    dropped = sum(int(c[2]) for c in calls)
    pre = calls[:n_seq * n_moe]
    dec = calls[n_seq * n_moe:n_moe * (n_seq + steps)]
    fwd = calls[n_moe * (n_seq + steps):]
    if len(fwd) != n_seq * n_moe or any(c[0] != prompt for c in pre) \
            or any(c[0] != n_seq for c in dec):
        fail(f"route_flips: {len(calls)} routing calls, not {n_seq} "
             f"prefills, {steps} decode steps and {n_seq} forwards of "
             f"{n_moe} MoE layers")
    flips = []
    for layer in range(n_moe):
        for i in range(n_seq):
            f_e, f_m = fwd[i * n_moe + layer][3:5]
            p_e, p_m = pre[i * n_moe + layer][3:5]
            s_e = torch.stack([dec[j * n_moe + layer][3][i]
                               for j in range(steps)])
            s_m = torch.stack([dec[j * n_moe + layer][4][i]
                               for j in range(steps)])
            for ours, margin, lo in ((p_e, p_m, 0), (s_e, s_m, prompt)):
                n = ours.shape[0]
                theirs = f_e[lo:lo + n]
                differ = (ours != theirs).any(dim=1).nonzero().flatten()
                for j in differ.tolist():
                    flips.append((i, j + lo - prompt, layer,
                                  min(float(margin[j]),
                                      float(f_m[lo + j]))))
    return sorted(flips, key=lambda f: (f[0], f[1])), dropped


def _cache_row(dst, src, i):
    """Copies the one-sequence decode cache ``src`` into row ``i`` of the
    batched ``dst``: every entry, K and V or a Mamba2 block's state and
    conv windows (the periods' entries stack the periods first)."""
    from repro_torch.core import tree as T
    for part, lead in (("layers", 1), ("prelude", 0)):
        for d, t in zip(T.tree_leaves(dst.get(part, ())),
                        T.tree_leaves(src.get(part, ()))):
            d.narrow(lead, i, 1).copy_(t)
    dst["len"] = src["len"]


def moe_no_drop(torch, label, defs, params, n_moe, seed):
    """The no-drop copy's decode against a train-mode forward:
    MOE_NO_DROP_SEQS prompts of MOE_NO_DROP_PROMPT tokens drawn from
    ``seed``, each prefilled alone (the one-sequence shape of the forward)
    into its row of one cache, then decoded 63 tokens together; then one
    forward per sequence over prompt + generated tokens.  Nothing may
    drop, the first routing flip of each sequence must be a near tie, the
    logits must agree within ZOO_LOGIT_TOL up to it, and at least
    MOE_MIN_COMPARED decode steps in all must come before the flips.
    Returns a summary dict."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    nd = defs.cfg
    n_nd, p_nd, steps = MOE_NO_DROP_SEQS, MOE_NO_DROP_PROMPT, ZOO_NEW - 1
    pre = serve.build_prefill_setup(nd, device="cuda")
    srv = serve.build_serve_setup(nd, device="cuda", keep_logits=n_nd)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, nd.vocab_size, (n_nd, p_nd)), device="cuda")
    with RouteWatch(routes=True) as nd_watch, torch.inference_mode():
        cache = TF.init_cache(nd, n_nd, p_nd + ZOO_NEW, device="cuda")
        first = []
        for i in range(n_nd):
            f, c = pre.prefill_step(params, {"tokens": prompts[i:i + 1]},
                                    p_nd + ZOO_NEW)
            _cache_row(cache, c, i)
            first.append(f)
            del c
        first = torch.cat(first)
        state = {"params": params, "cache": cache, "tokens": first}
        out, logits = [first], []
        for _ in range(steps):
            state = srv.serve_step(state)
            out.append(state["tokens"])
            logits.append(state["logits"])
        del state, cache
        got = torch.stack(logits, dim=1).cpu()
        seq = torch.cat([prompts, *out], dim=1)
        # one sequence at a time: a no-drop forward gives every expert
        # capacity for all of its tokens
        full = torch.cat([TF.model_apply(
            params, defs, {"tokens": seq[i:i + 1]},
            logits_from=p_nd)[0][:, :steps].cpu()
            for i in range(n_nd)])
    flips, nd_drops = route_flips(torch, nd_watch.calls, n_moe, n_nd,
                                  p_nd, steps)
    if nd_drops:
        fail(f"moe {label}: the no-drop copy dropped {nd_drops} assignments")
    # a token routed to other experts in the forward than in prefill or
    # decode changes its own logits and, through attention, every later
    # one.  The first such token of a sequence (the earliest position, its
    # lowest layer) saw inputs that differ only by rounding, so its choice
    # must have been a near tie; the logits are compared up to it, and
    # enough decode steps must come before the flips
    firsts = [min([f for f in flips if f[0] == i],
                  key=lambda f: (f[1], f[2]), default=None)
              for i in range(n_nd)]
    upto = [steps if f is None else max(f[1], 0) for f in firsts]
    compared = sum(upto)
    err = max([float((got[i, :upto[i]] - full[i, :upto[i]]).abs().max())
               for i in range(n_nd) if upto[i]], default=0.0)
    wide = [f for f in firsts if f is not None and f[3] >= MOE_TIE_MARGIN]
    if wide or compared < MOE_MIN_COMPARED or not all(
            torch.allclose(got[i, :upto[i]], full[i, :upto[i]],
                           atol=ZOO_LOGIT_TOL, rtol=ZOO_LOGIT_TOL)
            for i in range(n_nd)):
        fail(f"moe {label}: no-drop decode logits differ from the "
             f"train-mode forward by up to {err} over the first {upto} "
             f"steps ({compared} in all, at least {MOE_MIN_COMPARED} "
             f"needed; tolerance {ZOO_LOGIT_TOL}); first routing flips "
             f"(sequence, step (< 0: prompt), layer, margin) {firsts}, "
             f"not near ties (margin >= {MOE_TIE_MARGIN}): {wide}")
    return {"logit_err": err, "steps_compared": upto, "compared": compared,
            "first_flips": firsts, "flips": len(flips),
            "logit_err_all": float((got - full).abs().max())}


def moe_serve(torch, G, entries, label, arch, periods, batch, prompt,
              tag="moe"):
    """One MoE serve run at full width, counted: #9 launched attention
    layers x 63 times and nothing else, tokens in range, and the share of
    routed
    assignments dropped at prefill and at the first decode step, from the
    port's own routing.  Then, on a copy of the config whose capacity
    factor is ``n_experts / top_k`` (capacity >= the tokens a call routes,
    so nothing drops and a token's experts do not depend on the others):
    the decode against a train-mode forward (``moe_no_drop``), and one
    decode step after 2 of the served prompts through the plain #9 within
    SERVE_LOGIT_TOL of the kernel's.  Returns (#9 launches, a
    summary dict)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    flags = []
    if periods is not None:
        cfg = dataclasses.replace(cfg, n_periods=periods)
        flags = ["--periods", str(periods)]
    n_moe = sum(c in "EX" for c in cfg.prelude + cfg.period * cfg.n_periods)
    for entry in entries.values():
        entry.launches = 0
    with RouteWatch(limit=2 * n_moe) as rw:
        r = serve.main(["--arch", arch, *flags, "--batch", str(batch),
                        "--prompt-len", str(prompt), "--new-tokens",
                        str(ZOO_NEW), "--keep-logits", "2", "--seed", "0",
                        "--device", "cuda"])
    launches = {name: entry.launches for name, entry in entries.items()}
    n_attn = attention_layers(cfg)
    want = {name: 0 for name in entries}
    want["gqa_decode"] = n_attn * (ZOO_NEW - 1)
    if launches != want:
        fail(f"{tag} {label}: serve launched {launches}, want {want}")
    tok = r["tokens"]
    if (tok.shape != (batch, ZOO_NEW) or tok.min() < 0
            or tok.max() >= cfg.vocab_size
            or r["cache_len"] != prompt + ZOO_NEW - 1
            or not np.isfinite(r["logits"]).all()):
        fail(f"{tag} {label}: tokens {tok.shape} in [{tok.min()}, "
             f"{tok.max()}], cache length {r['cache_len']}, finite logits "
             f"{np.isfinite(r['logits']).all()}")
    drops = {"prefill": rw.dropped(batch * prompt),
             "decode step": rw.dropped(batch)}
    if drops["prefill"][1] != n_moe * batch * prompt * cfg.top_k \
            or drops["decode step"][1] != n_moe * batch * cfg.top_k:
        fail(f"{tag} {label}: the route watch saw {drops} assignments, want "
             f"{n_moe} MoE layers x {cfg.top_k} per token")
    share = {k: d / n for k, (d, n) in drops.items()}
    torch.cuda.empty_cache()

    nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    defs = TF.build_defs(nd)
    params = init_params(defs.storage, 0, "cuda")
    nd_sum = moe_no_drop(torch, label, defs, params, n_moe, 1)
    # 2 of the served prompts, at their full length
    step_err = plain_decode_step(
        torch, G, f"{tag} {label}", nd, defs, params,
        torch.as_tensor(r["prompts"][:2], device="cuda"))
    del params
    torch.cuda.empty_cache()
    summary = {"layers": cfg.n_layers, "prefill_s": r["prefill_s"],
               "decode_ms": r["decode_s_per_token"] * 1e3,
               "peak_gb": r["peak_gb"], "launches": launches["gqa_decode"],
               "prefill_drop_share": share["prefill"],
               "decode_drop_share": share["decode step"],
               **{f"no_drop_{k}": v for k, v in nd_sum.items()},
               "plain_step_err": step_err}
    depth = (f"{periods} of {get_config(arch).n_periods} periods, "
             if periods is not None else "")
    print(f"[{tag}] {label} ({depth}{cfg.n_layers} layers), {batch} x "
          f"{prompt} prompt + {ZOO_NEW} tokens: gqa_decode launched "
          f"{launches['gqa_decode']} times ({n_attn} attention layers x "
          f"{ZOO_NEW - 1}), no other kernel; prefill {r['prefill_s']!r} s, "
          f"decode {summary['decode_ms']!r} ms per token for the batch, peak "
          f"memory {r['peak_gb']!r} GB; routed assignments dropped: "
          f"{drops['prefill'][0]} of {drops['prefill'][1]} at prefill "
          f"({share['prefill']!r}), {drops['decode step'][0]} of "
          f"{drops['decode step'][1]} at the first decode step "
          f"({share['decode step']!r}); capacity factor "
          f"{nd.capacity_factor:g} (no drops): decode logits of "
          f"{MOE_NO_DROP_SEQS} sequences of {MOE_NO_DROP_PROMPT}-token "
          f"prompts, each prefilled alone, vs a train-mode forward max "
          f"|diff| {nd_sum['logit_err']!r} over their first "
          f"{nd_sum['steps_compared']} steps ({nd_sum['compared']} of "
          f"{MOE_NO_DROP_SEQS * (ZOO_NEW - 1)}), before each sequence's "
          f"first routing flip (sequence, step, layer, margin) "
          f"{nd_sum['first_flips']} ({nd_sum['flips']} flips in all; "
          f"{nd_sum['logit_err_all']!r} over all steps); one 2 x "
          f"{prompt} decode step through the plain gqa_decode vs the "
          f"kernel: max |diff| {step_err!r}", flush=True)
    return launches["gqa_decode"], summary


def moe_routing_oracle(torch, arch):
    """One full-width MoE layer of ``arch`` at capacity factor 1.25 on
    MOE_ORACLE_TOKENS tokens, held to a plain per-token loop: each token's
    experts in descending probability (ties to the lower id), each kept
    while its expert has a slot left, counted in token order; then each
    expert's FFN on its kept tokens alone, the weighted outputs added per
    token in ascending expert id, and the shared experts after.  The kept
    set and the chosen experts must be equal, the output within
    MOE_ORACLE_TOL, the auxiliary loss within 1e-5.  Returns a summary."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import _act
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config(arch), capacity_factor=1.25)
    p = init_params(moe.moe_defs(cfg), 3, "cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    t, d, k = MOE_ORACLE_TOKENS, cfg.d_model, cfg.top_k
    x = (torch.randn((1, t, d), generator=g, device="cuda")
         + MOE_ORACLE_SHIFT * torch.randn((d,), generator=g, device="cuda"))
    with torch.inference_mode():
        r = moe.route(p["router"], x[0], cfg)
        out, aux = moe.moe_forward(p, x, cfg)
        probs = torch.softmax((x[0] @ p["router"]).float(), dim=-1)
    pr = probs.cpu().numpy()
    top_e = np.argsort(-pr, axis=1, kind="stable")[:, :k]
    top_p = np.take_along_axis(pr, top_e, 1)
    top_p = top_p / np.maximum(top_p.sum(1, keepdims=True), 1e-9)
    cap = max(1, int(math.ceil(t * k / cfg.n_experts
                               * cfg.capacity_factor)))
    fill = np.zeros(cfg.n_experts, np.int64)
    keep = np.zeros((t, k), bool)
    for i in range(t):
        for j in range(k):
            e = top_e[i, j]
            keep[i, j] = fill[e] < cap
            fill[e] += 1
    if not (np.array_equal(r.top_e.cpu().numpy(), top_e)
            and np.array_equal(r.keep.cpu().numpy(), keep)
            and r.capacity == cap):
        fail(f"moe routing oracle {arch}: the chosen experts or the kept "
             "set differ from the per-token loop")
    want = torch.zeros((t, d), device="cuda")
    w = torch.from_numpy(top_p.astype(np.float32)).to("cuda")
    with torch.inference_mode():
        for e in range(cfg.n_experts):
            rows, cols = np.nonzero((top_e == e) & keep)
            if not len(rows):
                continue
            toks = torch.from_numpy(rows).to("cuda")
            xe = x[0, toks]
            y = (_act(cfg.mlp_act, xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
                 ) @ p["w_down"][e]
            want[toks] = want[toks] + y * w[toks, torch.from_numpy(cols)
                                            .to("cuda")][:, None]
        if "shared" in p:
            sp = p["shared"]
            xf = x[0]
            want = want + (_act(cfg.mlp_act, xf @ sp["w_gate"])
                           * (xf @ sp["w_up"])) @ sp["w_down"]
    f_e = np.bincount(top_e.reshape(-1), minlength=cfg.n_experts) / t
    want_aux = cfg.n_experts * float(np.sum(f_e * pr.astype(np.float64)
                                            .mean(0)))
    err = float((out[0] - want).abs().max())
    dropped = int((~keep).sum())
    if not torch.allclose(out[0], want, atol=MOE_ORACLE_TOL,
                          rtol=MOE_ORACLE_TOL) \
            or abs(float(aux) - want_aux) > 1e-5 * abs(want_aux) \
            or not 0 < dropped < keep.size:
        fail(f"moe routing oracle {arch}: output max |diff| {err} "
             f"(tolerance {MOE_ORACLE_TOL}), aux {float(aux)} vs "
             f"{want_aux}, {dropped} of {keep.size} assignments dropped")
    print(f"[moe] routing oracle {arch}: {t} tokens, capacity {cap} at "
          f"factor 1.25, shared shift {MOE_ORACLE_SHIFT:g}: chosen experts "
          f"and kept set equal to the per-token loop ({dropped} of "
          f"{keep.size} assignments dropped, expert loads "
          f"{fill.min()}-{fill.max()}); output max |diff| {err!r}, aux "
          f"{float(aux)!r} vs {want_aux!r}", flush=True)
    del p, x, out, want
    torch.cuda.empty_cache()
    return {"dropped": dropped, "assignments": keep.size, "out_err": err}


def moe_train(torch, Q, D, train, entries):
    """granite-moe-3b-a800m on the consensus trainer at full width, cut to
    MOE_TRAIN_PERIODS periods, counted, with every call of #1 and #2 held
    to its plain version (``KernelVsPlain``).  Returns (launches, a summary
    dict)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import wire
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import meta_params
    arch = "granite-moe-3b-a800m"
    argv = ["--arch", arch, "--periods", str(MOE_TRAIN_PERIODS),
            "--algorithm", "adc_dgd", "--nodes", str(MOE_TRAIN_NODES),
            "--batch", str(4 * MOE_TRAIN_NODES), "--seq", str(SEQ),
            "--steps", str(MOE_TRAIN_STEPS), "--quant-mode", "fixed",
            "--lr", "1e-2", "--device", "cuda", *NO_REMAT]
    with KernelVsPlain(torch, Q, D) as watch:
        hist, launches, peak = run_counted(torch, train, entries, argv)
    want = {name: 0 for name in entries}
    for name in CODEC_KERNELS["int8"]:
        want[name] = MOE_TRAIN_NODES * MOE_TRAIN_STEPS
    if launches != want:
        fail(f"moe trainer: launched {launches}, want {want}")
    if not watch.equal or watch.calls != 2 * want["quantize_payload"]:
        fail(f"moe trainer: {watch.calls} calls of #1 and #2 held to their "
             f"plain versions, all bitwise equal: {watch.equal}")
    cfg = dataclasses.replace(get_config(arch), n_periods=MOE_TRAIN_PERIODS)
    rows = wire.WireLayout.for_tree(meta_params(
        TF.build_defs(cfg).storage)).n_rows
    wires = {h["wire_bytes_per_step"] for h in hist}
    if wires != {MOE_TRAIN_WIRE_BYTES} or 2 * rows * PAYLOAD != \
            MOE_TRAIN_WIRE_BYTES:
        fail(f"moe trainer: wire_bytes_per_step {wires}, from the layout's "
             f"{rows} rows {2 * rows * PAYLOAD}, the reference's "
             f"{MOE_TRAIN_WIRE_BYTES}")
    losses = [h["loss"] for h in hist]
    auxes = [h.get("aux", float("nan")) for h in hist]
    # the untied unembed (fan-in d) gives logits of about unit spread at
    # init, which puts the cross-entropy about 0.5 above ln(vocab)
    near = math.log(cfg.vocab_size) + cfg.router_aux_weight * auxes[0]
    if not all(math.isfinite(x) for x in losses + auxes) \
            or abs(losses[0] - near) > 1.0 \
            or not auxes[0] >= 0.9 * cfg.top_k * MOE_TRAIN_PERIODS:
        fail(f"moe trainer: losses {losses}, aux {auxes} (step 1 should be "
             f"near ln({cfg.vocab_size}) + {cfg.router_aux_weight} x aux = "
             f"{near}, aux about {cfg.top_k} per MoE layer or more)")
    step_s = statistics.median(h["step_s"] for h in hist[1:])
    print(f"[moe] {arch} trainer, {MOE_TRAIN_PERIODS} of "
          f"{get_config(arch).n_periods} periods, "
          f"{MOE_TRAIN_NODES} nodes x 4 x {SEQ} tokens, int8 packed, fixed "
          f"grid, {MOE_TRAIN_STEPS} steps: losses {losses}; aux {auxes}; "
          f"launches { {n: v for n, v in launches.items() if v} }; "
          f"wire_bytes_per_step {MOE_TRAIN_WIRE_BYTES} (2 x {rows} rows x "
          f"{PAYLOAD}, the reference's accounting); {watch.calls} calls of "
          f"#1 and #2 bitwise equal to their plain versions on the same "
          f"inputs; median step {step_s:.4f} s; peak memory {peak:.2f} GB",
          flush=True)
    torch.cuda.empty_cache()
    return launches, {"step_s": step_s, "peak_gb": peak, "aux": auxes}


def phase_moe(torch, Q, D, G, train, entries):
    """The mixture-of-experts family at full width (``MOE_SERVE``, the
    routing oracle, then the granite trainer), each model freed before the
    next is built.  Returns (the launches of every kernel over the phase,
    summaries by run)."""
    launches = {name: 0 for name in entries}
    summary = {}
    for run in MOE_SERVE:
        n, summary[run[0]] = moe_serve(torch, G, entries, *run)
        launches["gqa_decode"] += n
    for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
        summary[f"{arch} routing oracle"] = moe_routing_oracle(torch, arch)
    train_launches, summary["granite-moe-3b-a800m trainer"] = moe_train(
        torch, Q, D, train, entries)
    for name, n in train_launches.items():
        launches[name] += n
    return launches, summary


#: the state-space family (``phase_ssm``), each at full width on random
#: weights from seed 0, ZOO_NEW new tokens, freed before the next: (label,
#: arch, periods (None: full depth), long-serve, batch, prompt).  Prompts
#: are multiples of the scan's 256-token chunk (2,048, not the zoo's
#: 1,984); 32,768 is prefill_32k's length (``src/repro/models/config.py:
#: 164``), 128 chunks per layer, so the state crosses 127 chunk borders.
#: mamba2-1.3b serves 12 of its 48 layers (all 48 until the process ring's
#: 5-rank group, 24 until it ran membership, hierarchy and a checkpoint,
#: cut for the script's time)
SSM_SERVE = (
    ("mamba2-1.3b, 12 of 48 layers", "mamba2-1.3b", 12, False, 32, 2048),
    ("mamba2-1.3b, prefill_32k, 12 of 48 layers", "mamba2-1.3b", 12, False,
     1, 32768),
)
#: mamba2-1.3b's decode logits against its train-mode forward (absolute
#: and relative): the one-token recurrence and the chunked scan sum in
#: other orders, over 48 layers of width 4,096 with a 128-wide state: at
#: 32 x 2,048 they differed by up to 1.86e-4 (H100 80GB HBM3), above
#: ZOO_LOGIT_TOL, while the decode's and the forward's logits each lay
#: further from the same forward in float64 (2.09e-4 and 2.36e-4,
#: ``zoo_serve(probe64=True)``): float32 rounding over 48 layers, not
#: one algorithm off the other.  The reference's own decode-against-scan
#: test allows 2e-3
SSM_LOGIT_TOL = 5e-4
#: jamba-v0.1-52b at 1 of its 4 periods ('MXMXAXMX' once: 13,267,541,504
#: parameters, 53.07 GB of float32; 2 periods, 104 GB, do not fit), 4 x
#: 2,048 + 64 tokens at its capacity factor 1.25: (label, arch, periods,
#: batch, prompt) for ``moe_serve``
SSM_JAMBA = ("jamba-v0.1-52b", "jamba-v0.1-52b", 1, 4, 2048)
#: the mamba2-1.3b trainer: 8 of its 48 periods (604,960 payload rows per
#: node; all 48, 2,624,096 rows, do not fit 4 nodes), 4 nodes x 4 x 512
#: tokens; the reference's int8 wire bytes per node and step for that tree,
#: 2 x 604,960 x 516 (``tests/test_torch_ssm.py``)
SSM_TRAIN_PERIODS, SSM_TRAIN_NODES = 8, 4
SSM_TRAIN_WIRE_BYTES = 624_318_720


def phase_ssm(torch, Q, D, G, train, entries):
    """The state-space family at full width: mamba2-1.3b served at 24 of
    its 48 layers (``SSM_SERVE``: no kernel launched, decode against a
    forward),
    jamba-v0.1-52b at 1 of 4 periods through ``moe_serve`` (#9 on its 'A'
    layer, drop shares, the no-drop check, the plain-#9 step), then the
    mamba2-1.3b trainer, each model freed before the next is built.
    Returns (the launches of every kernel over the phase, summaries by
    run)."""
    launches = {name: 0 for name in entries}
    summary = {}
    for run in SSM_SERVE:
        n, summary[run[0]] = zoo_serve(torch, G, entries, *run, tag="ssm",
                                       tol=SSM_LOGIT_TOL, probe64=True)
        launches["gqa_decode"] += n
    n, summary[SSM_JAMBA[0]] = moe_serve(torch, G, entries, *SSM_JAMBA,
                                         tag="ssm")
    launches["gqa_decode"] += n
    train_launches, summary["mamba2-1.3b trainer"] = zoo_train(
        torch, Q, D, train, entries, "mamba2-1.3b", SSM_TRAIN_PERIODS,
        SSM_TRAIN_NODES, SSM_TRAIN_WIRE_BYTES, tag="ssm")
    for name, n in train_launches.items():
        launches[name] += n
    return launches, summary


#: whisper-small (``phase_whisper``) served at full width and depth on
#: random weights from seed 0: 32 requests of 1,504 frames each (whisper's
#: 1,500 padded to a multiple of 16) and a 384-token prompt, + ZOO_NEW
#: tokens, so the decoder's cache holds 448 positions, whisper's decoder
#: context (``n_text_ctx``, arXiv:2212.04356): (label, arch, periods,
#: long-serve, batch, prompt) for ``zoo_serve``.  1.44 GB of weights, a
#: 3.55 GB cross cache and a 1.06 GB self cache
WHISPER_SERVE = ("whisper-small", "whisper-small", None, False, 32, 384)
#: the whisper-small trainer at full width and depth: 4 nodes x 1 sequence
#: of 1,536 tokens with its 1,504 frames (the data stub draws them from the
#: first seq + 1 tokens, so seq >= 1,503); the reference's int8 wire bytes
#: per node and step for its tree, 2 x 702,528 x 516
#: (``tests/test_torch_whisper.py``)
WHISPER_TRAIN_NODES, WHISPER_TRAIN_SEQ = 4, 1536
WHISPER_TRAIN_WIRE_BYTES = 725_008_896


def phase_whisper(torch, Q, D, G, train, entries):
    """whisper-small at full width and depth: served through ``zoo_serve``
    (#9 twice per decoder layer and step, decode against a forward with
    the same frames, the plain-#9 step, the encoder timed alone), then
    trained through ``zoo_train``, the model freed in between.  Returns
    (the launches of every kernel over the phase, summaries by run)."""
    launches = {name: 0 for name in entries}
    summary = {}
    n, summary[WHISPER_SERVE[0]] = zoo_serve(torch, G, entries,
                                             *WHISPER_SERVE, tag="whisper")
    launches["gqa_decode"] += n
    train_launches, summary["whisper-small trainer"] = zoo_train(
        torch, Q, D, train, entries, "whisper-small", None,
        WHISPER_TRAIN_NODES, WHISPER_TRAIN_WIRE_BYTES, tag="whisper",
        node_batch=1, seq=WHISPER_TRAIN_SEQ)
    for name, n in train_launches.items():
        launches[name] += n
    return launches, summary


#: ``phase_precision``: the reference's production configuration,
#: bfloat16 compute (and cache).  The smollm-135m trainer of phase_main
#: (4 nodes x 4 x 512 tokens, int8 packed, fixed grid) at each ``remat``
#: choice for PREC_TRAIN_STEPS steps; then bfloat16 serving, (label, arch,
#: periods (None: full depth), long_serve, batch, prompt) + 64 new tokens:
#: smollm-135m as phase_serve serves it in float32, and chameleon-34b at
#: all 48 layers (68.59 GB of bfloat16 weights and a 1.61 GB cache, where
#: its 137 GB of float32 weights do not fit and the zoo serves 12 layers)
#: (2 steps: 3 until the process ring's 5-rank group, cut for time)
PREC_TRAIN_STEPS = 2
PREC_REMATS = ("full", "dots", "none")
PREC_SERVE = (
    ("smollm-135m", "smollm-135m", None, False, SERVE_BATCH, SERVE_PROMPT),
    ("chameleon-34b, 48 layers", "chameleon-34b", None, False, 4, 1984),
)
#: the #9 shapes timed in bfloat16: those the bfloat16 serve runs decode
#: at, then decode_32k and long_500k (one operand set: the cache outgrows
#: the 50 MB L2) and whisper-small's cross attention
PREC_DECODE_SHAPES = {name: DECODE_SHAPES[name] for name in (
    "serve", "chameleon-34b", "decode_32k", "long_500k",
    "whisper-small cross")}
#: bfloat16 decode logits against a bfloat16 train-mode forward over the
#: same tokens, as a share of the forward's largest logit: the two round in
#: other places (a decode step's matrix-vector products, the prefill's
#: matrix products), and each lies 0.01-0.02 of it from a float64 forward
#: (``tests/test_torch_precision.py``: a bfloat16 rounding is 2^-9 of a
#: value, and 30-48 layers add them up), so 2^-4
BF16_LOGIT_TOL = 2.0 ** -4
#: a bfloat16 decode step through the plain #9 against the kernel's, the
#: same share: both widen the same bfloat16 K and V to float32 and sum
#: them in other orders (the kernel is held to the plain version within
#: DECODE_TOL on its own, phase 1), and the attention output is rounded to
#: bfloat16, so now and then an element lands one bfloat16 ulp apart, and
#: the layers above carry it as far as any other rounding: at random
#: weights through chameleon-34b's 48 layers the two steps' logits were
#: 0.0854 apart (H100 80GB HBM3, 700 W), so BF16_LOGIT_TOL
BF16_STEP_TOL = BF16_LOGIT_TOL
#: the bfloat16 trainer's losses at the three remat choices, relative: the
#: first step's forward is the same operations (equal bits); later steps
#: start from parameters that the embedding's backward (atomic adds on the
#: card) may round apart by a bfloat16 ulp
PREC_REMAT_LOSS_RTOL = 1e-3


class DtypeWatch:
    """Within the block, the dtype of the K/V cache of every call of #9
    through ``ops.gqa_decode`` (the layers' entry), in ``dtypes``."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved, self.dtypes = ops.gqa_decode, []
        real = self.saved

        def spy(q, k, v, valid, softcap=None, **kw):
            self.dtypes.append(k.dtype)
            return real(q, k, v, valid, softcap, **kw)

        ops.gqa_decode = spy
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.kernels import ops
        ops.gqa_decode = self.saved
        return False


def phase_precision(torch, Q, D, G, train, entries, main_int8):
    """bfloat16, the reference's production configuration: the smollm-135m
    trainer at ``--compute-dtype bfloat16`` and each ``--remat`` choice
    (PREC_REMATS), counted, every #1 / #2 call held bitwise to its plain
    version (``KernelVsPlain``: the wire packs the bfloat16 leaves as
    float32 rows), the reference's 271,160,064 wire bytes per step,
    bfloat16 parameters and float32 shadows after the run, the remat
    choices' losses against each other, step time and peak memory beside
    phase_main's float32 run (``main_int8``: its step s, peak GB); then
    PREC_SERVE through ``zoo_serve`` at bfloat16 compute and cache: #9 once
    per layer and step on bfloat16 caches (``DtypeWatch``), decode logits
    within BF16_LOGIT_TOL of a bfloat16 train-mode forward, a plain-#9 step
    within BF16_STEP_TOL.  Returns (the launches of every kernel over the
    phase, summaries by run)."""
    from repro_torch.core import tree as T
    launches = {name: 0 for name in entries}
    summary = {}
    losses = {}
    # the timed runs, then one more run of the first choice whose every #1
    # and #2 call is held to its plain version (which the timing excludes)
    for remat, watched in [(r, False) for r in PREC_REMATS] + [
            (PREC_REMATS[0], True)]:
        argv = ["--arch", "smollm-135m", "--algorithm", "adc_dgd", "--nodes",
                str(NODES), "--batch", str(4 * NODES), "--seq", str(SEQ),
                "--steps", str(PREC_TRAIN_STEPS), "--quant-mode", "fixed",
                "--lr", "1e-2", "--device", "cuda", "--compute-dtype",
                "bfloat16", "--remat", remat]
        watch = KernelVsPlain(torch, Q, D)
        if watched:
            with watch:
                (hist, state), n, peak = run_counted(
                    torch, train, entries, argv, return_state=True)
        else:
            (hist, state), n, peak = run_counted(torch, train, entries, argv,
                                                 return_state=True)
        want = {name: 0 for name in entries}
        for name in CODEC_KERNELS["int8"]:
            want[name] = NODES * PREC_TRAIN_STEPS
        if n != want:
            fail(f"precision trainer, remat {remat}: launched {n}, want "
                 f"{want}")
        if watched and (not watch.equal
                        or watch.calls != 2 * want["quantize_payload"]):
            fail(f"precision trainer, remat {remat}: {watch.calls} calls of "
                 f"#1 and #2, all bitwise equal to their plain versions: "
                 f"{watch.equal}")
        wires = {h["wire_bytes_per_step"] for h in hist}
        if wires != {WIRE_BYTES["int8"]}:
            fail(f"precision trainer, remat {remat}: wire bytes {wires}, "
                 f"want {WIRE_BYTES['int8']}")
        dtypes = {a.dtype for a in T.tree_leaves(state["params"])}
        shadows = {state["consensus"][k].dtype for k in ("x_tilde", "m_agg")}
        if dtypes != {torch.bfloat16} or shadows != {torch.float32}:
            fail(f"precision trainer, remat {remat}: parameters {dtypes}, "
                 f"shadows {shadows}")
        got = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in got) \
                or abs(got[0] - math.log(49152)) > 0.5:
            fail(f"precision trainer, remat {remat}: losses {got}")
        if watched and not all(
                abs(a - b) <= PREC_REMAT_LOSS_RTOL * abs(b)
                for a, b in zip(got, losses[remat])):
            fail(f"precision trainer, remat {remat}: the watched run's "
                 f"losses {got}, the timed run's {losses[remat]}")
        losses[remat] = got
        step_s = statistics.median(h["step_s"] for h in hist[1:])
        for name, k in n.items():
            launches[name] += k
        if not watched:
            summary[f"trainer bf16 remat {remat}"] = {"step_s": step_s,
                                                      "peak_gb": peak}
        print(f"[precision] smollm-135m trainer, bfloat16, remat {remat}, "
              f"{NODES} nodes x 4 x {SEQ} tokens, int8 packed, "
              f"{PREC_TRAIN_STEPS} steps"
              + (" (every #1 and #2 call also through its plain version)"
                 if watched else "")
              + f": losses {got}; launches "
              f"{ {k: v for k, v in n.items() if v} }; "
              + (f"{watch.calls} calls of #1 and #2 bitwise equal to their "
                 "plain versions; " if watched else "")
              + f"wire bytes {WIRE_BYTES['int8']} per step; median step "
              f"{step_s:.4f} s, peak memory {peak:.2f} GB (float32, remat "
              f"none, phase_main: {main_int8[0]:.4f} s, "
              f"{main_int8[1]:.2f} GB)", flush=True)
        del hist, state
        torch.cuda.empty_cache()
    first = {losses[r][0] for r in PREC_REMATS}
    spread = max(abs(losses[r][k] - losses["none"][k]) / losses["none"][k]
                 for r in PREC_REMATS for k in range(PREC_TRAIN_STEPS))
    if len(first) != 1 or spread > PREC_REMAT_LOSS_RTOL:
        fail(f"precision trainer: losses by remat {losses}")
    print(f"[precision] remat full / dots / none: the same first loss "
          f"{first.pop()!r}, later losses within {spread:.3g} of each other "
          "(relative)", flush=True)
    for run in PREC_SERVE:
        with DtypeWatch() as dw:
            n, summary[run[0]] = zoo_serve(
                torch, G, entries, *run, tag="precision",
                probe64=run[1] == "smollm-135m", compute="bfloat16",
                rel_tol=BF16_LOGIT_TOL, step_rel_tol=BF16_STEP_TOL)
        if not dw.dtypes or set(dw.dtypes) != {torch.bfloat16}:
            fail(f"precision {run[0]}: #9 read caches of "
                 f"{sorted(map(str, set(dw.dtypes)))}, want bfloat16 only")
        print(f"[precision] {run[0]}: all {len(dw.dtypes)} calls of #9 read "
              "bfloat16 K and V", flush=True)
        launches["gqa_decode"] += n
    phase_serve_profile(torch, G, torch.bfloat16)
    return launches, summary


#: the dry runs ``phase_analysis`` prints: (arch, input shape), each a
#: ``python -m repro_torch.launch.dryrun`` process started with the build
#: (they need no card) and waited for in the phase
ANALYSIS_DRYRUNS = (("smollm-135m", "train_4k"), ("smollm-135m", "decode_32k"),
                    ("chameleon-34b", "decode_32k"))
#: the caching allocator's rounding, per tensor: its bytes round up to 512
#: B, and a block cut from a new segment keeps the segment's tail when that
#: is under 1 MiB (the large pool splits a segment only above it)
ALLOC_ROUND = (1 << 20) + 512
#: the examples at reduced size: serve_batched's run, decentralized_train's
#: steps and batch, quickstart's cut
EX_SERVE = ("--arch", "smollm-135m", "--batch", "4", "--prompt-len", "32",
            "--new-tokens", "16")
EX_TRAIN_STEPS = 6
EX_QUICKSTART = ("--steps", "300", "--gamma-steps", "100", "--trials", "3",
                 "--schedule-steps", "300")
#: probe calls per measurement: a warm one and the median's five
PROBE_CALLS = 6
_DRY_PROCS: list = []


def start_dryruns(out_dir: str) -> None:
    """Start ``ANALYSIS_DRYRUNS``, one process each, on the host's cores
    beside the card's work; ``phase_analysis`` waits for them (and an
    early exit kills them: ``stop_dryruns``)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for arch, shape in ANALYSIS_DRYRUNS:
        log = open(os.path.join(out_dir, f"{arch}__{shape}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out_dir, "--force"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=HERE)
        _DRY_PROCS.append((arch, shape, log, proc))


def stop_dryruns() -> None:
    for _, _, log, proc in _DRY_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zero(entries) -> None:
    for entry in entries.values():
        entry.launches = 0


def _read(entries) -> dict:
    return {name: entry.launches for name, entry in entries.items()}


def phase_analysis(torch, G, train, entries, measure, out_dir, smi):
    """The cost model against the card (``phase_analysis``): the
    smollm-135m trainer at the smoke configuration priced on ``meta`` and
    run on the card, both counted; its state bytes against the allocator;
    the step's FLOPs against the model's and the card's peak; the dry runs
    started with the build; the exchange probe on the live state; the
    trainer CLI with its probe; the three examples at reduced size."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tree as T
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.op_cost import CostCounter
    from repro_torch.models.config import InputShape
    t_phase = time.perf_counter()
    launches = {name: 0 for name in entries}
    summary = {}
    cfg = get_config("smollm-135m")
    shape = InputShape("smoke", SEQ, 4 * NODES, "train")
    kw = dict(nodes=NODES, remat="none")
    meta_cost, meta_mem = dryrun.count_step(
        dryrun.build_step(cfg, shape, "meta", **kw))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    real = dryrun.build_step(cfg, shape, "cuda", **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    want = real.state_bytes + real.input_bytes
    n_storages = len({t.untyped_storage()._cdata for t in T.tree_leaves(
        [real.state]) if torch.is_tensor(t)}) + 3      # + tokens, labels, noise
    if not want <= held <= want + ALLOC_ROUND * n_storages:
        fail(f"analysis: the real setup holds {held} B on the card; the dry "
             f"run predicts {real.state_bytes} B of state + "
             f"{real.input_bytes} B of inputs, within {ALLOC_ROUND} B of "
             f"rounding for each of {n_storages} tensors")
    _zero(entries)
    with CostCounter() as counter:
        real.run()
    torch.cuda.synchronize()
    real_cost = counter.cost
    step_launches = _read(entries)
    kern = {"quantize_payload": NODES, "dequant_combine_payload": NODES}
    if dict(real_cost.kernels) != kern or \
            {n: v for n, v in step_launches.items() if v} != kern:
        fail(f"analysis: the counted card step reported "
             f"{dict(real_cost.kernels)} and launched {step_launches}, "
             f"want {kern}")
    if meta_cost.as_dict() != real_cost.as_dict():
        diff = {k: (meta_cost.launches[k], real_cost.launches[k])
                for k in set(meta_cost.launches) | set(real_cost.launches)
                if meta_cost.launches[k] != real_cost.launches[k]}
        fail(f"analysis: the meta dry run counts {meta_cost.flops} FLOPs, "
             f"{meta_cost.hbm_bytes} B, {meta_cost.n_launches} launches; "
             f"the card's step {real_cost.flops}, {real_cost.hbm_bytes}, "
             f"{real_cost.n_launches}; launches (meta, card) differ: {diff}")
    for name, n in step_launches.items():
        launches[name] += n
    times = []
    _zero(entries)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for name, n in _read(entries).items():
        launches[name] += n
    step_s = statistics.median(times[1:])
    n_act = cfg.active_param_count()
    mflops = analysis.model_flops_per_step(n_act, shape.global_batch * SEQ)
    peak = analysis.H100.peak_flops["float32"]
    print(f"[analysis] smollm-135m trainer, {NODES} nodes x 4 x {SEQ}, int8 "
          f"packed, remat none: meta == card: {real_cost.flops / 1e12:.4f} "
          f"TFLOP counted, {real_cost.hbm_bytes / 1e9:.4f} GB, "
          f"{real_cost.n_launches} launches "
          f"({sum(real_cost.launches.values())} aten ops of "
          f"{len(real_cost.launches)} kinds + kernels "
          f"{dict(real_cost.kernels)}); model FLOPs 6ND "
          f"{mflops / 1e12:.4f} TFLOP (N {n_act}, D {shape.global_batch * SEQ})"
          f", useful ratio {mflops / real_cost.flops:.4f}; step "
          f"{step_s:.4f} s (median of steps 2-3, uncounted): MFU "
          f"{mflops / (step_s * peak):.4f} of {peak / 1e12:.0f} TFLOP/s "
          f"float32, counted FLOPs at {real_cost.flops / step_s / 1e12:.2f} "
          f"TFLOP/s; state {real.state_bytes} B predicted, {held} B held with "
          f"the inputs' {real.input_bytes} B (allocator rounding "
          f"{held - want} B over {n_storages} tensors); meta account "
          f"{ {k: v for k, v in meta_mem.items()} }; card {smi}", flush=True)
    summary["trainer"] = {"tflop": real_cost.flops / 1e12,
                          "gb": real_cost.hbm_bytes / 1e9,
                          "launches": real_cost.n_launches,
                          "model_tflop": mflops / 1e12,
                          "useful": mflops / real_cost.flops,
                          "step_s": step_s,
                          "mfu": mflops / (step_s * peak),
                          "state_bytes": real.state_bytes, "held": held}
    # the exchange probe on the live state, which must stay bitwise
    before = T.tree_map(lambda a: a.clone() if torch.is_tensor(a) else a,
                        real.state)
    _zero(entries)
    over = measure(real.setup, real.state, step_s)
    torch.cuda.synchronize()
    probe = _read(entries)
    for name, n in probe.items():
        launches[name] += n
    if {n: v for n, v in probe.items() if v} != {
            k: PROBE_CALLS * v for k, v in kern.items()}:
        fail(f"analysis: measure_consensus_overhead launched {probe}, want "
             f"{PROBE_CALLS} exchanges of {kern}")
    la, lb = T.tree_leaves(real.state), T.tree_leaves(before)
    if not all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(la, lb)):
        fail("analysis: the exchange probe changed the live train state")
    print(f"[analysis] measure_consensus_overhead: {over}; the live state "
          f"bitwise unchanged; card {smi}", flush=True)
    summary["probe"] = over
    del before, real, counter
    torch.cuda.empty_cache()
    # the trainer CLI with its probe: each printed step after the first
    # reads it, measured once (no re-tier)
    train.measure_consensus_overhead = measure
    try:
        _zero(entries)
        hist = train.main(train_argv(3))
    finally:
        train.measure_consensus_overhead = _no_probe
    cli = _read(entries)
    for name, n in cli.items():
        launches[name] += n
    want_cli = {k: (3 + PROBE_CALLS) * v for k, v in kern.items()}
    if {n: v for n, v in cli.items() if v} != want_cli or \
            not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"analysis: the trainer CLI with its probe launched {cli}, "
             f"want {want_cli} (3 steps and one probe measurement)")
    print(f"[analysis] trainer CLI, 3 steps with the exchange probe: "
          f"launches {want_cli} as counted", flush=True)
    # the examples at reduced size
    t0 = time.perf_counter()
    mod = _example("torch_serve_batched")
    _zero(entries)
    res = mod.main([*EX_SERVE, "--device", "cuda"])
    got = _read(entries)
    red = reduced(cfg)
    new = int(EX_SERVE[EX_SERVE.index("--new-tokens") + 1])
    want_serve = {"gqa_decode": red.n_layers * (new - 1)}
    if {n: v for n, v in got.items() if v} != want_serve:
        fail(f"analysis: serve_batched launched {got}, want {want_serve}")
    launches["gqa_decode"] += got["gqa_decode"]
    saved, ops.gqa_decode = ops.gqa_decode, G.gqa_decode_plain
    try:
        plain = mod.main([*EX_SERVE, "--device", "cuda"])
    finally:
        ops.gqa_decode = saved
    if not np.array_equal(res["tokens"], plain["tokens"]):
        fail(f"analysis: serve_batched's tokens through #9 "
             f"{res['tokens'].tolist()} differ from the plain #9's "
             f"{plain['tokens'].tolist()}")
    print(f"[analysis] example serve_batched (reduced smollm-135m, "
          f"{' '.join(EX_SERVE)}): #9 launched {got['gqa_decode']} = "
          f"{red.n_layers} layers x {new - 1} steps, tokens equal to the "
          f"plain #9's; decode {res['decode_s_per_token'] * 1e3:.3f} ms per "
          "token", flush=True)
    mod = _example("torch_decentralized_train")
    _zero(entries)
    res = mod.main(["--steps", str(EX_TRAIN_STEPS), "--device", "cuda"])
    got = _read(entries)
    for name, n in got.items():
        launches[name] += n
    ex_kern = {k: EX_TRAIN_STEPS * mod.NODES for k in kern}
    setup = train.build_train_setup(red, consensus_nodes=mod.NODES,
                                    device="cuda")
    from repro_torch.models.params import meta_params
    layout = setup.consensus.state_layout(T.tree_map(
        lambda a: a.expand((mod.NODES,) + a.shape),
        meta_params(setup.defs.storage)))
    wire = {"adc_dgd": 2 * layout.n_rows * PAYLOAD,
            "dgd": 2 * 4 * layout.n_elements, "allreduce": 0}
    if {n: v for n, v in got.items() if v} != ex_kern or \
            {a: r["wire"] for a, r in res.items()} != wire:
        fail(f"analysis: decentralized_train launched {got} (want "
             f"{ex_kern}), wire bytes "
             f"{ {a: r['wire'] for a, r in res.items()} } (want {wire})")
    print(f"[analysis] example decentralized_train ({EX_TRAIN_STEPS} steps "
          f"each, 2 nodes): launches {ex_kern}, wire bytes per step {wire}; "
          + ", ".join(f"{a} loss {np.mean(r['losses'][-3:]):.4f} in "
                      f"{r['dt']:.2f} s" for a, r in res.items()),
          flush=True)
    mod = _example("torch_quickstart")
    _zero(entries)
    res = mod.main([*EX_QUICKSTART, "--device", "cuda"])
    got = _read(entries)
    adc, direct = (res["compare"][k]["grad_norm"][-1] for k in (
        "ADC-DGD (paper Alg. 2)     ", "DGD + direct compression   "))
    if any(got.values()) or not adc < direct:
        fail(f"analysis: quickstart launched {got} (RandomizedRounding "
             f"reaches no kernel), ADC-DGD |grad| {adc} against direct "
             f"compression's {direct}")
    print(f"[analysis] example quickstart on the card: ADC-DGD |grad| "
          f"{adc:.3e}, direct compression {direct:.3e}; examples "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the dry runs started with the build
    t0 = time.perf_counter()
    for arch, shape_name, log, proc in _DRY_PROCS:
        code = proc.wait(timeout=600)
        log.close()
        path = os.path.join(out_dir, f"{arch}__{shape_name}__h100x1__"
                            "adc_int8__float32.json")
        if code != 0 or not os.path.exists(path):
            with open(log.name) as f:
                fail(f"analysis: dry run {arch} {shape_name} exited {code}:"
                     f"\n{f.read()[-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        print(f"[analysis] dry run {arch} {shape_name} (meta, float32, "
              f"{rec['count_s']:.1f} s to count): compute "
              f"{rec['compute_s'] * 1e3:.3f} ms, memory "
              f"{rec['memory_s'] * 1e3:.3f} ms, collective "
              f"{rec['collective_s'] * 1e3:.3f} ms, dominant "
              f"{rec['dominant']}, useful {rec['useful_flops_ratio']:.4f}, "
              f"{rec['n_launches']} launches, peak estimate "
              f"{rec['peak_bytes_estimate'] / 1e9:.2f} GB, fits "
              f"{rec['fits']}; priced for {rec['hw']}; card {smi}",
              flush=True)
        summary[f"dry {arch} {shape_name}"] = {
            k: rec[k] for k in ("compute_s", "memory_s", "collective_s",
                                "fits", "count_s")}
    wait_s = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    print(f"[analysis] phase_analysis: {phase_s:.1f} s ({wait_s:.1f} s of "
          f"it waiting for the dry runs); card {smi}", flush=True)
    summary["phase_s"] = phase_s
    return launches, summary


def _no_probe(*args, **kwargs) -> dict:
    """The trainer CLI's exchange probe set aside: the phases before
    ``phase_analysis`` hold each run's launches to its steps' exactly, and
    the probe's exchanges are counted there instead."""
    return {}


def phase_parity(torch, train):
    """The same two steps of reduced smollm-135m on the card and on the
    CPU (plain versions), from the same weights, batches and noise, for the
    int8, int4 and top-k wires, the per-leaf transport, compressed_dgd,
    plans A and B, plan A pipelined over 3 chunks, int8 async at
    staleness 1, and int8 at ring strides (1, 2) re-wired every step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.core import tree as T
    cfg = reduced(get_config("smollm-135m"))
    for codec, kw in (("int8", {}), ("int4", {"wire_codec": "int4"}),
                      ("topk", {"wire_codec": "topk"}),
                      ("int8 per_leaf", {"wire_packing": "per_leaf"}),
                      ("compressed_dgd", {"algorithm": "compressed_dgd"}),
                      ("compressed_dgd per_leaf",
                       {"algorithm": "compressed_dgd",
                        "wire_packing": "per_leaf"}),
                      ("plan A", {"wire_codec": PLAN_A}),
                      ("plan A pipelined 3",
                       {"wire_codec": PLAN_A, "wire_packing": "pipelined",
                        "pipeline_chunks": 3}),
                      ("plan B", {"wire_codec": PLAN_B}),
                      ("int8 async staleness 1",
                       {"wire_packing": "async", "staleness": 1}),
                      ("int8 strides 1,2 period 1 (step 2 a resync)",
                       {"ring_strides": (1, 2), "schedule_period": 1})):
        base = None
        results = {}
        for dev in ("cpu", "cuda"):
            setup = train.build_train_setup(cfg, consensus_nodes=NODES,
                                            lr=1e-2, device=dev, remat=False,
                                            **kw)
            state = train.init_train_state(
                setup, 0, params=None if base is None else T.tree_map(
                    lambda a: a.to(dev), base))
            base = state["params"]
            ds = SyntheticLMDataset(cfg.vocab_size, 64, 2 * NODES,
                                    n_shards=NODES)
            layout = setup.consensus.state_layout(state["params"])
            cols = setup.consensus.noise_cols_for(layout)
            losses = []
            for step in range(2):
                noise = torch.rand(
                    (NODES, layout.n_rows, cols),
                    generator=torch.Generator().manual_seed(step))
                state, m = train.train_step(setup, state,
                                            ds.global_batch_arrays(step),
                                            noise=noise.to(dev))
                losses.append(m["loss"])
            results[dev] = (losses, T.tree_map(lambda a: a.cpu(),
                                               state["params"]))
        (l_cpu, p_cpu), (l_gpu, p_gpu) = results["cpu"], results["cuda"]
        diffs = [(a - b).abs() for a, b in
                 zip(T.tree_leaves(p_cpu), T.tree_leaves(p_gpu))]
        diff = max(float(d.max()) for d in diffs)
        frac_off = (sum(int((d > FLOAT_ATOL).sum()) for d in diffs)
                    / sum(d.numel() for d in diffs))
        grid = setup.consensus.cfg.fixed_step0
        if (diff > MAX_GRID_STEPS * grid or frac_off > MAX_FRAC_OFF
                or any(abs(a - b) > LOSS_RTOL * abs(a)
                       for a, b in zip(l_cpu, l_gpu))):
            fail(f"{codec} card vs CPU: params differ by up to {diff} (limit "
                 f"{MAX_GRID_STEPS * grid}) in a share {frac_off} of the "
                 f"elements (limit {MAX_FRAC_OFF}), losses {l_cpu} vs "
                 f"{l_gpu}")
        print(f"[parity] reduced smollm-135m, {codec} wire, 2 steps card vs "
              f"CPU: max |param diff| {diff!r}, share off by more than "
              f"{FLOAT_ATOL} {frac_off!r}, losses {l_gpu} vs {l_cpu}")


def decode_bound(b, seq, n_valid, elt, kvh=KVH, grp=GROUP, hd=HEAD_DIM,
                 q_elt=4):
    """Least bytes and operations of one flash-decode call: q (``q_elt``
    bytes an element), each valid position's K and V row once, the mask,
    and m, l, acc out; per valid position and query 2 x hd for q . k, 2 x
    hd for p v and ~8 for the scale, max, exp and rescale."""
    n_bytes = (b * kvh * grp * hd * q_elt + 2 * b * n_valid * kvh * hd * elt
               + seq + b * kvh * grp * (2 + hd) * 4)
    n_ops = b * kvh * n_valid * grp * (4 * hd + 8)
    return n_bytes, n_ops


def sdpa_calls(torch, q, k, v, valid, n_valid):
    """``scaled_dot_product_attention`` computing the normalised output
    of the flash-decode inputs, each way it can take them and on each
    backend that accepts that way: the cache layout under the mask with
    ``enable_gqa``; and, the valid positions being a prefix, that prefix
    with a KV head's g queries as its query rows (no mask and no head
    expansion), as strided views of the cache and as contiguous copies
    (made once, outside the timing).  Returns {label: callable}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, kvh, grp, hd = q.shape
    seq = k.shape[1]
    if not torch.equal(valid, torch.arange(seq, device="cuda") < n_valid):
        fail("gqa_decode timing: the valid positions are not a prefix")
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    kp, vp = ks[:, :, :n_valid], vs[:, :, :n_valid]
    ways = {"masked cache layout, enable_gqa":
            (q.reshape(b, kvh * grp, 1, hd), ks, vs,
             {"attn_mask": valid[None, :], "enable_gqa": True}),
            "prefix, strided": (q, kp, vp, {}),
            "prefix, contiguous": (q, kp.contiguous(), vp.contiguous(), {})}
    calls = {}
    for way, (qq, kk, vv, kw) in ways.items():
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            def call(qq=qq, kk=kk, vv=vv, kw=kw, backend=backend):
                with sdpa_kernel(backend):
                    out = F.scaled_dot_product_attention(qq, kk, vv, **kw)
                return out.reshape(b, kvh, grp, hd)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    call()
            except RuntimeError:    # this backend does not take this way
                continue
            calls[f"{way}, {backend.name}"] = call
    torch.cuda.synchronize()
    return calls


#: distinct (q, K, V) sets the serve shape's timing rotates over: 4 x
#: 100.8 MB, so every call finds its K and V cold in the 50 MB L2, as the
#: serve loop over 30 layers' caches does (decode_32k's 6.4 GB is cold)
DECODE_TIMING_SETS = {"serve": 4, "decode_32k": 1, "long_500k": 1,
                      "qwen3-0.6b": 1, "yi-9b": 4, "chameleon-34b": 4,
                      "gemma2-9b": 1, "gemma2-9b long-serve": 1,
                      "granite-moe-3b-a800m": 1, "deepseek-moe-16b": 4,
                      "jamba-v0.1-52b": 4, "whisper-small": 4,
                      "whisper-small cross": 4}
DECODE_TIMING_REPS = {"serve": 200, "decode_32k": 20, "long_500k": 20,
                      "qwen3-0.6b": 100, "yi-9b": 200, "chameleon-34b": 200,
                      "gemma2-9b": 100, "gemma2-9b long-serve": 100,
                      "granite-moe-3b-a800m": 100, "deepseek-moe-16b": 200,
                      "jamba-v0.1-52b": 200, "whisper-small": 200,
                      "whisper-small cross": 200}
#: ranges per row the decode timing also tries (``gqa_decode(ranges=)``);
#: long_500k's rows take 16 ranges at the least
DECODE_SWEEP = {"serve": (1, 2, 3, 4, 8), "decode_32k": (1, 2, 4),
                "qwen3-0.6b": (), "yi-9b": (), "chameleon-34b": (),
                "gemma2-9b": (), "gemma2-9b long-serve": (),
                "long_500k": (), "granite-moe-3b-a800m": (),
                "deepseek-moe-16b": (), "jamba-v0.1-52b": (),
                "whisper-small": (), "whisper-small cross": ()}
#: the same for the bfloat16 kernel, whose grid (``decode_splits``: rows x
#: ranges near 3/4 of the SMs) these sweeps chose
BF16_DECODE_SWEEP = {"serve": (1, 2, 3, 4), "chameleon-34b": (2, 3, 4, 6, 8)}


def phase_decode_timing(torch, G, launches, errs, dtype=None, shapes=None):
    """The flash-decode kernel, its plain version and the library call
    that computes the normalised output (#9 plus the combine) at each of
    ``shapes`` (DECODE_SHAPES when None), K and V (and q) in ``dtype``
    (float32 when None), on the mask of a decode at the
    cache's last position but one (every position at the shapes of
    DECODE_ALL_VALID), each timed over ``DECODE_TIMING_SETS``
    operand sets in turn.  The library time is the fastest of
    ``sdpa_calls`` on the same inputs.  Returns the first shape's row."""
    dtype = dtype or torch.float32
    dname = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    sweep = DECODE_SWEEP if dtype == torch.float32 else BF16_DECODE_SWEEP
    elt = torch.empty((), dtype=dtype).element_size()
    row = None
    for shape, (b, seq, kvh, grp, hd) in (shapes or DECODE_SHAPES).items():
        sets = [decode_inputs(torch, b, seq, dtype, 11 + i, kvh, grp, hd)
                for i in range(DECODE_TIMING_SETS[shape])]
        reps = DECODE_TIMING_REPS[shape]
        valid = torch.arange(seq, device="cuda") <= (
            seq - 1 if shape in DECODE_ALL_VALID else seq - 2)
        n_valid = int(valid.sum())
        ms = kernel_time(f"gqa_decode {shape}"
                         + ("" if dtype == torch.float32 else f" {dname}"), [
            lambda q=q, k=k, v=v: G.gqa_decode(q, k, v, valid)
            for q, k, v in sets], reps)
        plain_ms = time_ms([
            lambda q=q, k=k, v=v: G.gqa_decode_plain(q, k, v, valid)
            for q, k, v in sets], max(4, reps // 20))
        chosen = G.decode_grid(*sets[0][:2])
        for ranges in sweep.get(shape, ()):
            r_ms = time_ms([
                lambda q=q, k=k, v=v: G.gqa_decode(q, k, v, valid,
                                                   ranges=ranges)
                for q, k, v in sets], reps)
            print(f"[timing] gqa_decode {shape} {dname}, {ranges} ranges per "
                  f"row (decode_splits chose {chosen[1]} of {chosen[0]} "
                  f"positions): {r_ms:.4f} ms")
        outs = [decode_invariants(torch, *G.gqa_decode(q, k, v, valid))[0]
                for q, k, v in sets]
        per_set = [sdpa_calls(torch, q, k, v, valid, n_valid)
                   for q, k, v in sets]
        if not per_set[0]:
            fail(f"gqa_decode timing {shape}: no backend of "
                 f"scaled_dot_product_attention took the inputs")
        lib = {}
        for label in per_set[0]:
            calls = [c[label] for c in per_set]
            lib_err = max(float((call() - o).abs().max())
                          for call, o in zip(calls, outs))
            lib[label] = time_ms(calls, max(4, reps // 10))
            print(f"[timing] gqa_decode {shape} {dname}: scaled_dot_product_"
                  f"attention ({label}) {lib[label]:.4f} ms, its output "
                  f"within {lib_err:.3g} of the kernel's")
        lib_label = min(lib, key=lib.get)
        lib_ms = lib[lib_label]
        del per_set, outs
        nb, no = decode_bound(b, seq, n_valid, elt, kvh, grp, hd, elt)
        b_ms, b_by = bound(nb, no)
        print(f"[timing] gqa_decode {shape} (b={b}, S={seq}, kvh={kvh}, "
              f"g={grp}, hd={hd}, {n_valid} valid, {dname}, {len(sets)} "
              f"operand sets in turn; {chosen[1]} ranges of {chosen[0]} "
              f"positions per row, {b * kvh * chosen[1]} CTAs): {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, fastest scaled_dot_product_"
              f"attention {lib_ms:.4f} ms, {lib_label}; bound {b_ms:.4f} ms "
              f"by {b_by}: {nb / 1e9:.4f} GB, {no / 1e9:.4f} GFLOP, "
              f"{ms and b_ms / ms:.1%} of it)")
        if row is None:
            row = {"name": "gqa_decode", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
                   "replaces": "src/repro/kernels/gqa_decode.py:80",
                   "launches": launches["gqa_decode"],
                   "max_abs_err": errs["gqa_decode"], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
        del sets
        torch.cuda.empty_cache()
    return row


def phase_timing(torch, Q, D, BP, launches, errs, n_rows, leaf_rows):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    y = torch.randn((n_rows, BLOCK), generator=g, device="cuda") * 0.05
    u = torch.rand((n_rows, 2 * BLOCK), generator=g, device="cuda")
    u8 = u[:, :BLOCK].contiguous()
    xt = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    mb = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    pays = [Q.quantize_payload(y * (i + 1), u8, 1e-3) for i in range(3)]
    p4 = [BP.subbyte_encode_payload(y * (i + 1), u, 4, 1e-3)
          for i in range(3)]
    p2 = [BP.subbyte_encode_payload(y * (i + 1), u, 2, 1e-3)
          for i in range(3)]
    pk = [BP.topk_encode_payload(y * (i + 1), u, 64, 1e-3) for i in range(3)]
    rows_b = n_rows * BLOCK * 4              # one fp32 (n_rows, 512) operand

    def enc_bytes(noise_cols, width):        # y + the noise read + payload
        return rows_b + n_rows * noise_cols * 4 + n_rows * width

    def comb_bytes(width):                   # 3 payloads + 2 shadows + 3 out
        return 3 * n_rows * width + 5 * rows_b

    ops_per = n_rows * BLOCK
    # (name, kernel, plain, bytes, float ops, source, TPU kernel replaced);
    # ops per element: encoders ~10 (abs/max, div, floor, sub, cmp, add,
    # clip), top-k ~25 (one logf counted as 15), combines 13-14
    cases = [
        ("quantize_payload", lambda: Q.quantize_payload(y, u8, 1e-3),
         lambda: Q.quantize_payload_plain(y, u8, 1e-3),
         enc_bytes(BLOCK, PAYLOAD), ops_per * 10,
         "src/repro_torch/kernels/csrc/quantize_payload.cu",
         "src/repro/kernels/quantize.py:246"),
        ("dequant_combine_payload",
         lambda: D.dequant_combine_payload(*pays, xt, mb, 0.5, 0.25, 1.0),
         lambda: D.dequant_combine_payload_plain(*pays, xt, mb, 0.5, 0.25,
                                                 1.0),
         comb_bytes(PAYLOAD), ops_per * 13,
         "src/repro_torch/kernels/csrc/dequant_combine_payload.cu",
         "src/repro/kernels/dequant_combine.py:113"),
        ("subbyte_encode_payload",
         lambda: BP.subbyte_encode_payload(y, u, 4, 1e-3),
         lambda: BP.subbyte_encode_plain(y, u, 4, 1e-3),
         enc_bytes(BLOCK, 258), ops_per * 10,
         "src/repro_torch/kernels/csrc/subbyte_encode.cu",
         "src/repro/kernels/bitpack.py:430"),
        ("subbyte_decode_combine",
         lambda: BP.subbyte_decode_combine(*p4, xt, mb, 0.5, 0.25, 1.0, 4),
         lambda: BP.subbyte_combine_plain(*p4, xt, mb, 0.5, 0.25, 1.0, 4),
         comb_bytes(258), ops_per * 13,
         "src/repro_torch/kernels/csrc/subbyte_combine.cu",
         "src/repro/kernels/bitpack.py:441"),
        ("topk_encode_payload",
         lambda: BP.topk_encode_payload(y, u, 64, 1e-3),
         lambda: BP.topk_encode_plain(y, u, 64, 1e-3),
         enc_bytes(BLOCK + 64, 130), ops_per * 25,
         "src/repro_torch/kernels/csrc/topk_encode.cu",
         "src/repro/kernels/bitpack.py:455"),
        ("topk_decode_combine",
         lambda: BP.topk_decode_combine(*pk, xt, mb, 0.5, 0.25, 1.0, 64),
         lambda: BP.topk_combine_plain(*pk, xt, mb, 0.5, 0.25, 1.0, 64),
         comb_bytes(130), ops_per * 14,
         "src/repro_torch/kernels/csrc/topk_combine.cu",
         "src/repro/kernels/bitpack.py:467"),
    ]
    # the per-leaf kernels over all 11 leaves' padded rows in one launch
    # (the main path launches them once per leaf: timed below as well)
    pl_rows = sum(leaf_rows)
    yb = torch.randn((pl_rows, BLOCK), generator=g, device="cuda") * 0.05
    ub = torch.rand((pl_rows, BLOCK), generator=g, device="cuda")
    xtb = torch.randn((pl_rows, BLOCK), generator=g, device="cuda")
    mbb = torch.randn((pl_rows, BLOCK), generator=g, device="cuda")
    sides = []
    for i in range(3):
        sides += Q.quantize_blocks(yb * (i + 1), ub, 1e-3)
    pl_b = pl_rows * BLOCK * 4
    cases += [
        ("quantize_blocks", lambda: Q.quantize_blocks(yb, ub, 1e-3),
         lambda: Q.quantize_blocks_plain(yb, ub, 1e-3),
         2 * pl_b + pl_rows * PAYLOAD, pl_rows * BLOCK * 10,
         "src/repro_torch/kernels/csrc/quantize_blocks.cu",
         "src/repro/kernels/quantize.py:199"),
        ("dequant_combine",
         lambda: D.dequant_combine(*sides, xtb, mbb, 0.5, 0.25, 1.0),
         lambda: D.dequant_combine_plain(*sides, xtb, mbb, 0.5, 0.25, 1.0),
         3 * pl_rows * PAYLOAD + 5 * pl_b, pl_rows * BLOCK * 13,
         "src/repro_torch/kernels/csrc/dequant_combine_blocks.cu",
         "src/repro/kernels/dequant_combine.py:48"),
    ]
    rows = []
    for name, fn, plain, nb, no, src, repl in cases:
        ms = kernel_time(name, fn)
        plain_ms = time_ms(plain)
        b_ms, b_by = bound(nb, no)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"[timing] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}: {nb / 1e9:.4f} GB, "
              f"{ms and b_ms / ms:.1%} of it)")
    spans, r0 = [], 0
    for n in leaf_rows:
        spans.append((r0, n))
        r0 += n

    def per_leaf_quantize():
        for r0, n in spans:
            Q.quantize_blocks(yb[r0:r0 + n], ub[r0:r0 + n], 1e-3)

    def per_leaf_combine():
        for r0, n in spans:
            D.dequant_combine(*(a[r0:r0 + n] for a in sides),
                              xtb[r0:r0 + n], mbb[r0:r0 + n], 0.5, 0.25,
                              1.0)

    for name, fn in (("quantize_blocks", per_leaf_quantize),
                     ("dequant_combine", per_leaf_combine)):
        print(f"[timing] {name}, one node's {len(spans)} per-leaf launches: "
              f"{time_ms(fn):.4f} ms")
    del yb, ub, xtb, mbb, sides
    # int2 runs the same two kernels as int4 (template on the code width)
    for name, fn, nb in (
            ("subbyte_encode_payload int2",
             lambda: BP.subbyte_encode_payload(y, u, 2, 1e-3),
             enc_bytes(BLOCK, 130)),
            ("subbyte_decode_combine int2",
             lambda: BP.subbyte_decode_combine(*p2, xt, mb, 0.5, 0.25, 1.0,
                                               2),
             comb_bytes(130))):
        ms = time_ms(fn)
        b_ms, _ = bound(nb, 0)
        print(f"[timing] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by bytes: "
              f"{nb / 1e9:.4f} GB, {ms and b_ms / ms:.1%} of it)")
    return rows


#: the paper's reference path on the card: Fig. 10's largest circle (n =
#: 20) at P = 2^22 coordinates per node, StepSize(0.01, eta=0.5), gamma 1;
#: 250 steps (500 until the process ring ran membership, hierarchy and a
#: checkpoint, cut for the script's time: the membership schedule's epochs
#: of 50 steps all fall inside)
PAPER_NODES, PAPER_DIM, PAPER_STEPS = 20, 1 << 22, 250
IDENTITY_STEPS, TRAJECTORY_STEPS, PAPER_STEP0 = 50, 20, 10
#: the Fig. 1 contrast the card must show: direct compression's iterate
#: stays at least this many times farther from uncompressed DGD's
FIG1_RATIO = 10.0


def paper_schedules(T) -> dict:
    """The time-varying schedules of the paper path at N 20:
    ``PeriodicSchedule`` alternating the circle and a 4 x 5 torus every 5
    steps, and ``bench_fig10_timevarying``'s Erdős-Rényi graphs (p 0.35,
    seed 11; ``benchmarks/run.py``), one per step."""
    return {"periodic ring20/torus4x5 dwell 5": T.PeriodicSchedule(
                [T.ring(PAPER_NODES), T.torus(4, 5)], dwell=5),
            "erdos_renyi p 0.35": T.ErdosRenyiSchedule(
                PAPER_NODES, p=0.35, horizon=PAPER_STEPS, seed=11)}


def paper_run(torch, K, alg, prob, n_steps, key=0):
    """One ``consensus.run`` with its per-step CUDA events and peak
    memory: (result, {step_ms, wall_s, peak_gb})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    r = K.run(alg, prob, n_steps, key=key, step_events=events)
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return r, {"step_ms": statistics.median(ms[PAPER_STEP0:]),
               "wall_s": wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_paper(torch, Q, entries):
    """The paper's reference algorithms (``repro_torch.core.consensus``)
    on ``paper_circle_problem(20, dim=2^22)`` over ``paper_circle(20)``:
    kernel #3 through ``Int8BlockQuantizer`` against its plain version;
    identity ADC-DGD against DGD; then, counted, ADC-DGD int8 fixed and
    adaptive, CompressedDGD int8 adaptive (fixed would clip x itself at
    127 x 1e-3) and DGD for PAPER_STEPS steps each; and the kernel and
    plain ADC-DGD trajectories.  Returns (launches, errs)."""
    from repro_torch.core import compression as C
    from repro_torch.core import consensus as K
    from repro_torch.core import problems as P
    from repro_torch.core import topology as T
    t0 = time.perf_counter()
    prob = P.paper_circle_problem(PAPER_NODES, seed=0, dim=PAPER_DIM,
                                  device="cuda")
    mix = T.paper_circle(PAPER_NODES)
    step = K.StepSize(0.01, eta=0.5)
    print(f"[paper] paper_circle_problem({PAPER_NODES}, dim={PAPER_DIM}) on "
          f"the card in {time.perf_counter() - t0:.2f} s; state "
          f"({PAPER_NODES}, {PAPER_DIM}) float32, "
          f"{PAPER_NODES * PAPER_DIM * 4 / 1e6:.1f} MB per buffer", flush=True)

    # kernel #3 through the compressor, against its plain version
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    z = torch.randn((PAPER_NODES, PAPER_DIM), generator=g, device="cuda")
    q_abs = 0.0
    for mode, scale in (("fixed", 0.05), ("adaptive", 1.0)):
        comp = C.Int8BlockQuantizer(mode=mode)
        u = torch.rand(comp.uniform_shape(z.shape), generator=g,
                       device="cuda")
        before = Q.quantize_blocks.launches
        codes, scales, _ = comp.encode(z * scale, u)
        rows = codes.numel() // BLOCK
        want = Q.quantize_blocks_plain((z * scale).reshape(rows, BLOCK),
                                       u.reshape(rows, BLOCK),
                                       comp.step if mode == "fixed" else None)
        torch.cuda.synchronize()
        if Q.quantize_blocks.launches != before + 1 or not (
                torch.equal(codes.reshape(rows, BLOCK), want[0])
                and torch.equal(scales.reshape(rows, 1).view(torch.int32),
                                want[1].view(torch.int32))):
            fail(f"Int8BlockQuantizer {mode} on the card: "
                 f"{Q.quantize_blocks.launches - before} launches, "
                 f"{int((codes.reshape(rows, BLOCK) != want[0]).sum())} "
                 "codes differ from quantize_blocks_plain")
        q_abs = max(q_abs, float((codes.reshape(rows, BLOCK).float()
                                  * scales.reshape(rows, 1)
                                  - want[0].float() * want[1]).abs().max()))
        print(f"[paper] Int8BlockQuantizer {mode}: one quantize_blocks "
              f"launch over {rows} rows; codes and scales equal to the "
              "plain version")
    # #3 at the paper path's rows, timed as the timing phase times it
    yr, ur = (z * 1.0).reshape(rows, BLOCK), u.reshape(rows, BLOCK)
    ms = kernel_time(f"quantize_blocks paper ({rows} rows)",
                     lambda: Q.quantize_blocks(yr, ur, None))
    b_ms, b_by = bound(2 * rows * BLOCK * 4 + rows * BLOCK + rows * 4,
                       rows * BLOCK * 10)
    print(f"[timing] quantize_blocks at the paper path's {rows} rows: "
          f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{ms and b_ms / ms:.1%} of it)")
    del z, u, codes, scales, want, yr, ur

    # identity ADC-DGD is DGD, bit for bit
    ident, _ = paper_run(torch, K, K.ADCDGD(mix, C.IdentityCompressor(),
                                            step), prob, IDENTITY_STEPS)
    dgd50, _ = paper_run(torch, K, K.DGD(mix, step), prob, IDENTITY_STEPS)
    for name in ("x_final", "obj", "grad_norm", "consensus"):
        if not np_equal(ident[name], dgd50[name]):
            fail(f"identity ADC-DGD differs from DGD in {name} after "
                 f"{IDENTITY_STEPS} steps on the card")
    print(f"[paper] identity-compressor ADC-DGD == DGD bitwise over "
          f"{IDENTITY_STEPS} steps (x_final, obj, grad_norm, consensus)")
    del ident, dgd50

    # the counted path: four algorithms on the static circle, and ADC-DGD
    # and DGD under each time-varying schedule, PAPER_STEPS steps each
    algs = {
        "adc_dgd int8 fixed": K.ADCDGD(
            mix, C.Int8BlockQuantizer(mode="fixed"), step),
        "adc_dgd int8 adaptive": K.ADCDGD(
            mix, C.Int8BlockQuantizer(mode="adaptive"), step),
        "compressed_dgd int8 adaptive": K.CompressedDGD(
            mix, C.Int8BlockQuantizer(mode="adaptive"), step),
        "dgd": K.DGD(mix, step)}
    for sname, sched in paper_schedules(T).items():
        algs[f"adc_dgd int8 fixed, {sname}"] = K.ADCDGD(
            sched, C.Int8BlockQuantizer(mode="fixed"), step)
        algs[f"dgd, {sname}"] = K.DGD(sched, step)
    for entry in entries.values():
        entry.launches = 0
    results, stats = {}, {}
    for name, alg in algs.items():
        sched = alg.mixing if isinstance(alg.mixing,
                                         T.TopologySchedule) else None
        storages = []
        if sched is not None:
            real_step = alg.step

            def spy(state, problem, u=None, w=None, real_step=real_step):
                storages.append(w.untyped_storage().data_ptr())
                return real_step(state, problem, u, w)
            object.__setattr__(alg, "step", spy)
        r, st = paper_run(torch, K, alg, prob, PAPER_STEPS)
        results[name] = r
        stats[name] = st
        finite = all(np.isfinite(r[m]).all() for m in
                     ("obj", "grad_norm", "consensus", "max_tx", "x_final"))
        if not finite or r["x_final"].shape != (PAPER_NODES, PAPER_DIM):
            fail(f"{name}: non-finite metrics or x_final "
                 f"{r['x_final'].shape}")
        if sched is not None:
            object.__delattr__(alg, "step")
            # each step billed for the messages of its own W^(k)
            per_msg = (8.0 * PAPER_DIM if isinstance(alg, K.DGD)
                       else alg.compressor.wire_bytes(PAPER_DIM))
            want = np.cumsum([sched.matrix_at(i).n_messages * per_msg
                              for i in range(PAPER_STEPS)])
            if len(storages) != PAPER_STEPS or len(set(storages)) != 1 \
                    or not np.allclose(r["bytes"], want, rtol=1e-12):
                fail(f"{name}: W^(k) from {len(set(storages))} device "
                     f"copies over {len(storages)} steps (want 1 over "
                     f"{PAPER_STEPS}); bytes {r['bytes'][-1]} vs "
                     f"{want[-1]}")
            print(f"[paper] {name}: the ({sched.period}, {PAPER_NODES}, "
                  f"{PAPER_NODES}) stack copied to the card once, every "
                  "step's W^(k) a row of it; cumulative bytes billed per "
                  f"step's messages ({r['bytes'][-1]:.0f} B after "
                  f"{PAPER_STEPS} steps)")
        print(f"[paper] {name}, {PAPER_STEPS} steps: step "
              f"{st['step_ms']:.4f} ms (CUDA events, median of steps "
              f"{PAPER_STEP0}-{PAPER_STEPS}), run {st['wall_s']:.2f} s; final "
              f"grad_norm {r['grad_norm'][-1]!r}, consensus "
              f"{r['consensus'][-1]!r}, max_tx {r['max_tx'].max()!r}; wire "
              f"{alg.bytes_per_iteration(prob):.0f} bytes per step; peak "
              f"memory {st['peak_gb']:.2f} GB", flush=True)
    launches = {name: entry.launches for name, entry in entries.items()}
    want = {name: 0 for name in entries}
    want["quantize_blocks"] = 5 * PAPER_STEPS
    if launches != want:
        fail(f"paper path launched {launches}, want {want}")
    x_dgd = results["dgd"]["x_final"]
    off = {name: float(np.linalg.norm(results[name]["x_final"] - x_dgd))
           for name in ("adc_dgd int8 adaptive",
                        "compressed_dgd int8 adaptive")}
    ratio = off["compressed_dgd int8 adaptive"] / max(
        off["adc_dgd int8 adaptive"], 1e-30)
    cons = {name: float(r["consensus"][-1]) for name, r in results.items()}
    cons_ratio = (cons["compressed_dgd int8 adaptive"]
                  / cons["adc_dgd int8 adaptive"])
    print(f"[paper] Fig. 1 contrast at N {PAPER_NODES}, P {PAPER_DIM}: "
          f"|x - x_dgd| adc_dgd {off['adc_dgd int8 adaptive']!r}, "
          f"compressed_dgd {off['compressed_dgd int8 adaptive']!r}, ratio "
          f"{ratio:.1f} (need >= {FIG1_RATIO:g}); last consensus error "
          f"compressed_dgd / adc_dgd = "
          f"{cons_ratio:.4f}"
          f" (dgd itself {cons['dgd']!r}: DGD's own error ball)")
    if ratio < FIG1_RATIO:
        fail(f"Fig. 1 contrast: compressed_dgd only {ratio:.2f}x farther "
             "from DGD than adc_dgd")
    del results

    # the kernel path and the plain path give the same ADC-DGD trajectory,
    # on the static circle and under each schedule
    for label in ["adc_dgd int8 adaptive"] + [
            f"adc_dgd int8 fixed, {sname}" for sname in paper_schedules(T)]:
        alg = algs[label]
        kern, _ = paper_run(torch, K, alg, prob, TRAJECTORY_STEPS, key=5)
        real = Q.quantize_blocks
        Q.quantize_blocks = Q.quantize_blocks_plain
        try:
            plain, _ = paper_run(torch, K, alg, prob, TRAJECTORY_STEPS,
                                 key=5)
        finally:
            Q.quantize_blocks = real
        for name in ("x_final", "obj", "grad_norm", "consensus", "max_tx",
                     "bytes"):
            if not np_equal(kern[name], plain[name]):
                fail(f"{label} through kernel #3 and through its plain "
                     f"version differ in {name} after {TRAJECTORY_STEPS} "
                     "steps")
        print(f"[paper] {label} through kernel #3 and through "
              f"quantize_blocks_plain: bitwise equal trajectories over "
              f"{TRAJECTORY_STEPS} steps from the same generator")
    del kern, plain, prob
    torch.cuda.empty_cache()
    for name, st in stats.items():
        print(f"[summary] paper path {name}: step {st['step_ms']:.4f} ms, "
              f"peak memory {st['peak_gb']:.2f} GB")
    return launches, {"quantize_blocks": q_abs}


#: on_wire_plan on the card: the two-leaf layout of the reference's equal-
#: bytes comparison (``benchmarks/consensus_step.py``: a ``proj`` and a
#: ``norm1`` leaf) at ~2^22 elements, N 20, plan A
PLAN_PROJ_ROWS, PLAN_NORM = 8192, 200
PLAN_PAPER_STEPS, PLAN_TRAJ_STEPS = 100, 10


def phase_paper_plan(torch, entries):
    """ADC-DGD and CHOCO gossiping through plan A (``on_wire_plan``) at N
    20 on ``paper_circle_problem``: PLAN_PAPER_STEPS counted steps each
    (one #5 and one #1 launch per node and step, nothing else), equal
    cumulative bytes, and the kernel trajectory bitwise equal to the plain
    one.  Returns the launches."""
    from repro_torch.core import consensus as K
    from repro_torch.core import problems as P
    from repro_torch.core import topology as T
    from repro_torch.core import wire, wireplan
    from repro_torch.kernels import bitpack as BP
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as Q
    layout = wire.WireLayout.for_tree(
        {"proj": torch.empty(PLAN_PROJ_ROWS * BLOCK, device="meta"),
         "norm1": torch.empty(PLAN_NORM, device="meta")})
    plan = wireplan.parse_spec(PLAN_A).build(layout)
    prob = P.paper_circle_problem(PAPER_NODES, seed=0,
                                  dim=layout.n_elements, device="cuda")
    mix = T.paper_circle(PAPER_NODES)
    step = K.StepSize(0.01, eta=0.5)
    algs = {"adc_dgd": K.on_wire_plan("adc_dgd", mix, plan, step),
            "choco": K.on_wire_plan("choco", mix, plan, step,
                                    consensus_lr=0.1)}
    for entry in entries.values():
        entry.launches = 0
    results = {}
    for name, alg in algs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        with CardSampler() as card:
            results[name] = r = K.run(alg, prob, PLAN_PAPER_STEPS, key=3,
                                      step_events=events)
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if not all(np.isfinite(r[m]).all() for m in ("obj", "grad_norm",
                                                     "consensus")):
            fail(f"on_wire_plan {name}: non-finite metrics")
        print(f"[paper] on_wire_plan {name}, plan A, N {PAPER_NODES}, P "
              f"{layout.n_elements}: {PLAN_PAPER_STEPS} steps, step "
              f"{statistics.median(ms[PAPER_STEP0:]):.4f} ms (CUDA events, "
              f"median of steps {PAPER_STEP0}-{PLAN_PAPER_STEPS}); "
              f"grad_norm {r['grad_norm'][0]!r} -> {r['grad_norm'][-1]!r}; "
              f"{plan.payload_bytes} bytes per message; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: "
              f"{card.summary()}", flush=True)
    launches = {name: entry.launches for name, entry in entries.items()}
    want = {name: 0 for name in entries}
    for run in plan.runs:
        want[codec_kernels(run.codec)[0]] += 2 * PLAN_PAPER_STEPS \
            * PAPER_NODES
    if launches != want:
        fail(f"on_wire_plan launched {launches}, want {want}")
    if results["adc_dgd"]["bytes"][-1] != results["choco"]["bytes"][-1]:
        fail(f"on_wire_plan: cumulative bytes differ: "
             f"{results['adc_dgd']['bytes'][-1]} vs "
             f"{results['choco']['bytes'][-1]}")
    print(f"[paper] on_wire_plan adc_dgd and choco: equal cumulative bytes "
          f"{results['adc_dgd']['bytes'][-1]:.0f}; launches "
          f"{ {n: v for n, v in launches.items() if v} }")
    kern = K.run(algs["adc_dgd"], prob, PLAN_TRAJ_STEPS, key=5)
    saved = (ops.quantize_payload, ops.subbyte_encode_payload)
    # the plain versions, taking the wrappers' ``out=`` (a plan encodes
    # each run in place into its flat payload)
    ops.quantize_payload = lambda *a, out=None, **k: Q._into(
        out, Q.quantize_payload_plain(*a, **k))
    ops.subbyte_encode_payload = lambda *a, out=None, **k: Q._into(
        out, BP.subbyte_encode_plain(*a, **k))
    try:
        plain = K.run(algs["adc_dgd"], prob, PLAN_TRAJ_STEPS, key=5)
    finally:
        ops.quantize_payload, ops.subbyte_encode_payload = saved
    for name in ("x_final", "obj", "grad_norm", "consensus", "max_tx"):
        if not np_equal(kern[name], plain[name]):
            fail(f"on_wire_plan ADC-DGD through #1/#5 and through their "
                 f"plain versions differ in {name}")
    print(f"[paper] on_wire_plan ADC-DGD through #1 and #5 and through their "
          f"plain versions: bitwise equal trajectories over "
          f"{PLAN_TRAJ_STEPS} steps")
    del prob, results, kern, plain
    torch.cuda.empty_cache()
    return launches


def np_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def phase_exchange_time(torch, train):
    """Device time of one consensus exchange of the full 4-node smollm
    state (encode + combine + packing + noise) for each codec."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    state = train.init_train_state(setup, 0)
    x_half = T.tree_map(lambda a: a + 1e-4, state["params"])
    out = {}
    for codec in ("int8", "int4", "int2", "topk"):
        rt = train.with_codec(setup, codec).consensus
        out[codec] = time_ms(lambda: rt.exchange(
            state["params"], x_half, state["consensus"], 1), reps=5)
        print(f"[timing] one 4-node {codec} exchange (pack, noise, 4+4 "
              f"launches, unpack): {out[codec]:.2f} ms")
    del state["consensus"]
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    pipelined = dict(wire_packing="pipelined",
                     pipeline_chunks=PIPELINE_CHUNKS)
    for label, kw in (("planA packed", {"wire_codec": PLAN_A}),
                      ("planA pipelined", {"wire_codec": PLAN_A,
                                           **pipelined}),
                      ("planB packed", {"wire_codec": PLAN_B}),
                      ("int8 pipelined", pipelined),
                      ("int8 async s0", {"wire_packing": "async",
                                         "staleness": 0}),
                      ("int8 async s1", {"wire_packing": "async"})):
        rt = ConsensusRuntime(ConsensusConfig(**kw), NODES)
        cons = rt.init_state(state["params"])
        with CardSampler() as card:
            out[label] = time_ms(lambda: rt.exchange(
                state["params"], x_half, cons, 2), reps=5)
        print(f"[timing] one 4-node {label} exchange: {out[label]:.2f} ms; "
              f"card: {card.summary()}")
        del cons
    out["int8 packed"] = out["int8"]
    del state, x_half
    phase_copy_time(torch)
    return out


def phase_copy_time(torch) -> None:
    """The copies an exchange could make at full width, timed apart: the
    async transport's ring transfer (two wrap rows of its ``(N + 2,
    payload_bytes)`` buffer) against a stack of the four payloads and two
    rolls of it, and the three combine outputs of every node copied into
    the state buffers after the launch against none (the kernels write
    them in place)."""
    nb = WIRE_BYTES["int8"] // 2
    rows = nb // PAYLOAD
    ring = torch.zeros((NODES + 2, nb), dtype=torch.uint8, device="cuda")
    pays = [ring[1 + i].clone() for i in range(NODES)]

    def wrap():
        ring[0].copy_(ring[NODES])
        ring[NODES + 1].copy_(ring[1])

    def stack_roll():
        fly = torch.stack(pays)
        return fly.roll(1, 0), fly.roll(-1, 0)

    ms_wrap, ms_stack = time_ms(wrap, reps=5), time_ms(stack_roll, reps=5)
    del ring, pays
    outs = torch.zeros((3, NODES, rows, BLOCK), device="cuda")
    got = torch.zeros((3, rows, BLOCK), device="cuda")

    def copy_outs():
        for i in range(NODES):
            for k in range(3):
                outs[k, i].copy_(got[k])

    ms_copy = time_ms(copy_outs, reps=5)
    del outs, got
    torch.cuda.empty_cache()
    print(f"[timing] copies at full width ({NODES} x {nb} payload bytes, "
          f"{rows} rows): async ring transfer by 2 wrap rows {ms_wrap:.4f} "
          f"ms against a stack of the payloads and 2 rolls {ms_stack:.4f} "
          f"ms; combine outputs copied into the state buffers "
          f"{ms_copy:.4f} ms per exchange (written in place: 0)")


#: the consensus ring over processes (``phase_process_ring``): gloo ranks,
#: every one on cuda:0 (NCCL refuses two ranks on one card), each training
#: one node of the full smollm-135m
RING_DEVICE = "cuda:0"
#: a rank that has not finished by then fails the phase
RING_TIMEOUT_S = 600.0
#: the ranks' caching allocator: segments that grow and shrink in place, so
#: a rank reserves little beyond what it holds (5 ranks of the full model
#: and this process share the card's 80 GB; with fixed segments each rank
#: kept blocks it had freed, and the card ran out)
RING_ALLOC_CONF = "expandable_segments:True"
_PIPELINED = ("--wire-packing", "pipelined", "--pipeline-chunks",
              str(PIPELINE_CHUNKS))
_ASYNC_S1 = ("--wire-packing", "async", "--staleness", "1")
_INT8 = {"quantize_payload": 1, "dequant_combine_payload": 1}
#: the hierarchy's inner level at pods of 2: one fp32 delta of smollm-135m's
#: 134,515,008 parameters per member and step (``HierarchySpec.
#: inner_bytes_per_step``)
HIER_INNER_BYTES = 538_060_032
#: the ring run that also saves its last step (``--checkpoint-dir``, added
#: by ``ring_rank``; the save follows the step's timing and wire counts,
#: and its bits are the run's: a separate run of the same argv until the
#: script's time was cut)
RING_CKPT = "int8 async s1"
#: the stacked checkpoint of the same state (``phase_telemetry``'s async s1
#: save: its bytes and seconds)
STACKED_CKPT = {}
#: each run of the 4-rank group: the argv of the stacked run it mirrors
#: (run by an earlier phase, whose fingerprints ``keep_stacked`` kept: the
#: plans' int8 packed, pipelined and async s1 runs, the main phase's int2,
#: the fault sweep's per-leaf and straggler runs, the elastic phase's churn
#: async s1 and pods=2 packed runs; dgd runs here), the kernels one active
#: rank launches per step, and the static wire bytes per node and step
RING_RUNS = {
    "int8 packed": (train_argv(CODEC_STEPS), _INT8, WIRE_BYTES["int8"]),
    "int8 pipelined 4": (train_argv(CODEC_STEPS, *_PIPELINED),
                         {k: PIPELINE_CHUNKS for k in _INT8},
                         WIRE_BYTES["int8"]),
    "int2 packed": (train_argv(CODEC_STEPS, "--wire-codec", "int2"),
                    {"subbyte_encode_payload": 1,
                     "subbyte_decode_combine": 1}, WIRE_BYTES["int2"]),
    # 2 x 134,515,008 float32 parameters
    "dgd": (train_argv(CODEC_STEPS, "--algorithm", "dgd"), {},
            1_076_120_064),
    "int8 async s1": (train_argv(CODEC_STEPS, *_ASYNC_S1), _INT8,
                      WIRE_BYTES["int8"]),
    # the directed push-sum ring on the adaptive grid at loss 0.2: the
    # 4-byte weight per direction (the per-leaf transport's own transfer)
    "directed loss 0.2 per-leaf": (
        train_argv(FAULT_STEPS, *FAULT_ARGV, "--link-loss", "0.2",
                   "--wire-packing", "per_leaf"),
        {"quantize_blocks": N_LEAVES, "dequant_combine": N_LEAVES},
        PER_LEAF_WIRE_BYTES + 8),
    "directed loss 0.2 async s1 straggle": (
        train_argv(FAULT_STEPS, *FAULT_ARGV, "--link-loss", "0.2",
                   *_ASYNC_S1, "--straggle", str(STRAGGLE)), _INT8,
        WIRE_BYTES["int8"] + 8),
    # elastic membership: rank 2 out for steps 5-8 (it launches and sends
    # nothing there), resyncs at steps 5 and 9
    "churn async s1": (train_argv(CHURN_STEPS, *CHURN_ARGV, *_ASYNC_S1),
                       _INT8, CHURN_WIRE_BYTES),
    # the pod ring: each member adds its pod's fp32 deltas (one to its
    # partner), then runs the outer exchange as its pod's replica
    "pods=2 packed": (train_argv(HIER_STEPS, "--hierarchy",
                                 f"pods={HIER_PODS}"), _INT8,
                      WIRE_BYTES["int8"] + HIER_INNER_BYTES),
}
#: the 5-rank group: strides (1, 2) held 2 steps each, async s1 (on 4
#: ranks stride 2 would split the ring)
RING5_RUNS = {
    "strides async s1": (stride_argv(STRIDE_STEPS, *_ASYNC_S1), _INT8,
                         STRIDE_WIRE_BYTES["packed"]),
}
#: a resync's fp32 x_tilde both ways, sent apart from the payloads
RESYNC_BYTES = 2 * 262_752 * BLOCK * 4
#: stacked runs' fingerprints by ring label (``keep_stacked``)
STACKED = {}
#: the ConsensusConfig fields of the trainer flags the ring runs use
_CFG_FLAGS = {"--algorithm": ("algorithm", str),
              "--wire-codec": ("wire_codec", str),
              "--wire-packing": ("wire_packing", str),
              "--pipeline-chunks": ("pipeline_chunks", int),
              "--staleness": ("staleness", int),
              "--quant-mode": ("quant_mode", str),
              "--topology": ("topology", str),
              "--link-loss": ("link_loss", float),
              "--loss-seed": ("loss_seed", int),
              "--straggle": ("straggle_rate", float),
              "--ring-strides": ("ring_strides", lambda v: tuple(
                  int(x) for x in v.split(","))),
              "--schedule-period": ("schedule_period", int),
              "--hierarchy": ("hierarchy", str)}
#: the fingerprint's chunk of bytes (bounds its int64 temporaries)
_FP_CHUNK = 1 << 26


def fingerprint(torch, t) -> tuple[int, int]:
    """Two 64-bit sums of ``t``'s bytes: plain, and each byte times an odd
    weight (2 x its index + 1), wrapping.  Equal tensors give equal pairs;
    any one byte that differs changes the second sum.  Integer sums on the
    card are exact, so the pair is the same wherever it is taken."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    s0 = torch.zeros((), dtype=torch.int64, device=b.device)
    s1 = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(0, b.numel(), _FP_CHUNK):
        w = b[i:i + _FP_CHUNK].to(torch.int64)
        s0 += w.sum()
        idx = torch.arange(i, i + w.numel(), device=b.device,
                           dtype=torch.int64)
        s1 += (w * (2 * idx + 1)).sum()
    return int(s0), int(s1)


def argv_value(argv, flag: str, default=None):
    """The value of ``flag``'s last occurrence in ``argv`` (argparse's
    rule), or ``default``."""
    at = [i for i, a in enumerate(argv) if a == flag]
    return argv[at[-1] + 1] if at else default


def keep_stacked(torch, label: str, hist, state) -> None:
    """A stacked run's per-step node losses, final state fingerprints per
    node, static wire bytes and median step, kept under its ring label."""
    STACKED[label] = {
        "losses": [h["node_loss"].tolist() for h in hist],
        "print": ring_state_print(torch, state, hist[0]["node_loss"].numel()),
        "wire": hist[-1]["wire_bytes_per_step"],
        "step_s": statistics.median(h["step_s"] for h in hist[1:])}


def ring_exchange_inputs(torch, train, n: int, n_local: int, first: int):
    """The fixed inputs of ``ring_exchange``: smollm-135m's x0 from seed 0
    and, for node i, ``x_half = x0 + 1e-3 * N(0, 1)`` drawn leaf by leaf
    from a generator on the card seeded ``1000 + i``; nodes ``first`` to
    ``first + n_local - 1`` of ``n``."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models.params import init_params
    defs = train.build_train_setup(get_config("smollm-135m"),
                                   consensus_nodes=n, device="cuda").defs
    x0 = init_params(defs.storage, 0, RING_DEVICE, n_nodes=n_local)
    half = T.tree_map(torch.clone, x0)
    for i in range(n_local):
        g = torch.Generator(device=RING_DEVICE)
        g.manual_seed(1000 + first + i)
        for a in T.tree_leaves(half):
            a[i].add_(torch.randn(a[i].shape, generator=g,
                                  device=RING_DEVICE).mul_(1e-3))
    return x0, half


def ring_exchange(torch, train, argv, ctx=None) -> list:
    """One exchange (step 1, noise seed 0) of the consensus of ``argv`` on
    the fixed inputs: stacked (``ctx`` None) or this rank's node.  Per
    node: the fingerprints of every payload it encoded (each unit; per
    leaf the codes and scales), its state entries (the async flight
    landed) and x_next (each leaf)."""
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    from repro_torch.kernels import ops
    from repro_torch.core.topology import MembershipSchedule
    kw = {"algorithm": "adc_dgd", "quant_mode": "fixed"}
    for flag, (field, conv) in _CFG_FLAGS.items():
        if flag in argv:
            kw[field] = conv(argv_value(argv, flag))
    n = int(argv_value(argv, "--nodes"))
    if "--node-failures" in argv:
        kw["membership"] = MembershipSchedule.from_spec(
            argv_value(argv, "--node-failures"), n).masks
    rt = ConsensusRuntime(ConsensusConfig(**kw), n, ctx=ctx)
    nl, m = rt.n_local, rt.pod_size
    x0, half = ring_exchange_inputs(torch, train, n, nl,
                                    0 if ctx is None else ctx.rank)
    pays, encode = [], rt._encode_unit
    leaves, quantize = [], ops.quantize_blocks

    def recorded(*args, **kwargs):
        out = encode(*args, **kwargs)
        pays.append([None if p is None else fingerprint(torch, p)
                     for p in out])
        return out

    def recorded_blocks(*args, **kwargs):
        out = quantize(*args, **kwargs)
        leaves.append([fingerprint(torch, t) for t in out])
        return out
    rt._encode_unit, ops.quantize_blocks = recorded, recorded_blocks
    try:
        x, state, _ = rt.exchange(x0, half, rt.init_state(x0), 1, seed=0)
        rt.land()
    finally:
        ops.quantize_blocks = quantize
    # a pod's members encode their pod's payload (stacked: once per pod)
    return [{"payloads": [u[i // m] for u in pays],
             "blocks": leaves[i::nl],
             "state": {k: fingerprint(torch, state[k][i])
                       for k in sorted(state)},
             "x_next": [fingerprint(torch, a[i]) for a in T.tree_leaves(x)]}
            for i in range(nl)]


def ring_state_print(torch, state, n_local: int) -> list:
    """Per node: the fingerprints of its final parameters (each leaf) and
    consensus state entries."""
    from repro_torch.core import tree as T
    cons = state["consensus"]
    return [{"params": [fingerprint(torch, a[i])
                        for a in T.tree_leaves(state["params"])],
             **{k: fingerprint(torch, cons[k][i]) for k in sorted(cons)}}
            for i in range(n_local)]


def ring_split(trace_path: str, hist: list) -> dict:
    """Median over steps 2 to the last of one rank's exchange, in ms: the
    window and its phases from the trace's CUDA-event spans, the staging
    copies and the wire from the ring's own clocks (``train._wire_stats``):
    the gloo transfer is what the launch and retire spans held besides the
    copies (where no phase is marked, dgd and per-leaf, and where the
    payload lands in the next step, async: the host's waits),
    the glue the window less every phase (the consensus error's node sum,
    a metric, is in it and also given apart); the wire from the first post
    to the last wait's return (0 for the async payload, which lands in the
    next step), the async flight's posted-to-landed, and the part of it
    the host waited."""
    with open(trace_path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    steps = {}
    for e in spans:
        if e["name"].startswith("exchange step"):
            steps[e["args"]["step"]] = {"window": e["dur"] / 1e3}
    for e in spans:
        ph = e["name"].split()[0]
        if ph in ("quantize", "launch", "in_flight", "retire",
                  "dequant_combine") and e["args"]["step"] in steps:
            row = steps[e["args"]["step"]]
            row[ph] = row.get(ph, 0.0) + e["dur"] / 1e3
    rows = []
    for k, h in enumerate(hist, start=1):
        if k < 2 or k not in steps:
            continue
        r = steps[k]
        d2h, h2d = h["wire_d2h_s"] * 1e3, h["wire_h2d_s"] * 1e3
        waited = h["wire_wait_s"] * 1e3
        if "launch" in r and not h["wire_flight_s"]:
            gloo = r["launch"] + r["retire"] - d2h - h2d
            spans_sum = sum(r.get(p, 0.0) for p in (
                "quantize", "launch", "retire", "dequant_combine"))
        else:
            gloo = waited
            spans_sum = d2h + gloo + h2d
        rows.append({"window": r["window"], "quantize": r.get("quantize", 0.0),
                     "d2h": d2h, "gloo": gloo, "h2d": h2d,
                     "dequant_combine": r.get("dequant_combine", 0.0),
                     "glue": r["window"] - spans_sum,
                     "in_flight": r.get("in_flight", 0.0),
                     "wire_post_to_done": h["wire_s"] * 1e3,
                     "wire_flight": h["wire_flight_s"] * 1e3,
                     "wire_waited": waited,
                     "consensus_err_wire": h["consensus_err_wire_s"] * 1e3})
    if not rows:
        return {}
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


#: the per-step wire statistics a ring run keeps (``train._wire_stats``)
RING_WIRE_KEYS = ("wire_bytes_per_step", "wire_bytes_sent",
                  "wire_resync_bytes_sent", "wire_s", "wire_wait_s",
                  "wire_flight_s", "wire_d2h_s", "wire_h2d_s",
                  "wire_inner_s", "consensus_err_wire_s")


def ring_rank(runs: dict, ckpt_dir: str | None = None) -> dict:
    """One rank of ``phase_process_ring`` (started by ``launch.mesh.
    run_ranks``, on cuda:0): the fixed-input exchange of every run (once
    per argv), then each run through ``train.main --process-ring`` with its
    launches counted, its peak memory and the card's free memory after
    it, its step lines' wire and ``active_nodes``, its trace's split, the
    transfers left in flight after it; per node losses and final state
    fingerprints.  ``RING_CKPT`` also saves its last step into
    ``ckpt_dir`` (``--checkpoint-dir``, every rank's rows in one file):
    the save's seconds, the file's bytes, and the fingerprints of this
    rank's rows loaded back from it and the load's seconds."""
    import tempfile
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import checkpoint
    from repro_torch.kernels import bitpack as BP
    from repro_torch.kernels import dequant_combine as D
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_process_context
    from repro_torch.models.sharding import drain_rings
    train.measure_consensus_overhead = _no_probe
    entries = {"quantize_payload": Q.quantize_payload,
               "dequant_combine_payload": D.dequant_combine_payload,
               "subbyte_encode_payload": BP.subbyte_encode_payload,
               "subbyte_decode_combine": BP.subbyte_decode_combine,
               "quantize_blocks": Q.quantize_blocks,
               "dequant_combine": D.dequant_combine}
    ctx = make_process_context(RING_DEVICE)
    rank = ctx.rank
    out = {"exchange": {}, "runs": {}}
    done = {}
    for label, (argv, _, _) in runs.items():
        key = tuple(argv)
        if key not in done:
            done[key] = ring_exchange(torch, train, argv, ctx)[0]
        out["exchange"][label] = done[key]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    real_save, saves = train.save_checkpoint, []

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = real_save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return path
    train.save_checkpoint = timed_save
    for label, (argv, _, _) in runs.items():
        extra = []
        if label == RING_CKPT:
            extra = ["--checkpoint-dir", ckpt_dir, "--checkpoint-every",
                     argv_value(argv, "--steps")]
        with tempfile.TemporaryDirectory() as tmp:
            _zero(entries)
            torch.cuda.reset_peak_memory_stats()
            hist, state = train.main(
                [*argv, *extra, "--process-ring", "--device", RING_DEVICE,
                 "--telemetry", "--telemetry-dir", tmp, "--run-id", "ring"],
                return_state=True)
            launches = _read(entries)
            peak = torch.cuda.max_memory_allocated() / 1e9
            reserved = torch.cuda.max_memory_reserved() / 1e9
            free = torch.cuda.mem_get_info()[0] / 1e9
            pending = drain_rings()
            split = ring_split(os.path.join(tmp, f"trace-ring-rank{rank}"
                                            ".json"), hist)
        out["runs"][label] = {
            "launches": launches, "peak_gb": peak,
            "reserved_gb": reserved, "free_gb": free,
            "pending": pending, "split": split,
            "losses": [h["node_loss"].tolist() for h in hist],
            "loss": [h["loss"] for h in hist],
            "step_s": [h["step_s"] for h in hist],
            "wire": [{k: h[k] for k in RING_WIRE_KEYS} for h in hist],
            "active_nodes": [h.get("active_nodes") for h in hist],
            "state": ring_state_print(torch, state, 1)[0]}
        if label == RING_CKPT:
            t0 = time.perf_counter()
            loaded, step = checkpoint.load_checkpoint(ckpt_dir, state,
                                                      ctx=ctx)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
            out["runs"][label]["ckpt"] = {
                "save_s": saves[-1], "load_s": load_s, "step": step,
                "bytes": os.path.getsize(path),
                "loaded": ring_state_print(torch, loaded, 1)[0]}
            del loaded
        del state, hist
        torch.cuda.empty_cache()
    train.save_checkpoint = real_save
    return out


def ring_plan(argv, wire: float, rank: int) -> list:
    """Per step of ``argv``'s run, what rank ``rank`` must do: (active,
    payload bytes sent, resync bytes sent).  Under ``--node-failures`` a
    rank whose node is out sends nothing; a resync (the stride schedule's
    at steps 3 and 5, the churn's at 5 and 9) moves the fp32 ``x_tilde``
    both ways, apart from the static wire's amortized share."""
    steps = int(argv_value(argv, "--steps"))
    resync_steps, period = (), 1
    if "--ring-strides" in argv:
        resync_steps, period = RESYNC_STEPS, STRIDE_PERIOD
    if "--node-failures" in argv:
        resync_steps, period = CHURN_RESYNCS, CHURN_PERIOD
    amortized = RESYNC_BYTES / period if resync_steps else 0.0
    rows = []
    for k in range(1, steps + 1):
        active = ("--node-failures" not in argv
                  or CHURN_HOLE[rank] or not 5 <= k <= 8)
        rows.append((active, wire - amortized if active else 0,
                     RESYNC_BYTES if active and k in resync_steps else 0))
    return rows


def ring_check(label: str, spec, ranks: list, want_ex: list) -> None:
    """Every rank of a run against the stacked one: the fixed-input
    exchange's row, the launches (per step the rank's node was active),
    the static and measured wire bytes per step (nothing where the rank's
    node was out, a resync's shadows apart, at the resync steps only), the
    per-node losses and final state bitwise, ``active_nodes`` under
    membership, nothing left in flight; for ``RING_CKPT`` the rows each
    rank loads back from the one file equal the stacked fingerprints, and
    the file is the stacked checkpoint's size."""
    argv, per_step, wire = spec
    st = STACKED[label]
    for r, rank in enumerate(ranks):
        got, want = rank["exchange"][label], want_ex[r]
        if got != want:
            fail(f"ring {label}: rank {r}'s exchange differs from the "
                 f"stacked row: {got} vs {want}")
        run = rank["runs"][label]
        plan = ring_plan(argv, wire, r)
        active = sum(a for a, _, _ in plan)
        want_l = {n: per_step.get(n, 0) * active for n in run["launches"]}
        if run["launches"] != want_l:
            fail(f"ring {label}: rank {r} launched {run['launches']}, want "
                 f"{want_l}")
        static = {w["wire_bytes_per_step"] for w in run["wire"]}
        sent = [w["wire_bytes_sent"] for w in run["wire"]]
        resent = [w["wire_resync_bytes_sent"] for w in run["wire"]]
        if (static != {st["wire"]} or st["wire"] != wire
                or sent != [b for _, b, _ in plan]
                or resent != [b for _, _, b in plan]):
            fail(f"ring {label}: rank {r} wire bytes {static} (stacked "
                 f"{st['wire']}, want {wire}), sent {sent}, resync "
                 f"{resent} (want {plan})")
        if "--node-failures" in argv and run["active_nodes"] != \
                CHURN_ACTIVE[:len(plan)]:
            fail(f"ring {label}: rank {r} active_nodes "
                 f"{run['active_nodes']}, want {CHURN_ACTIVE[:len(plan)]}")
        if run["losses"] != st["losses"] or run["state"] != st["print"][r]:
            fail(f"ring {label}: rank {r} is not the stacked run bitwise: "
                 f"losses {run['losses']} vs {st['losses']}, state "
                 f"{run['state']} vs {st['print'][r]}")
        if run["pending"]:
            fail(f"ring {label}: rank {r} left {run['pending']} transfers "
                 "in flight")
        if label == RING_CKPT:
            ck = run["ckpt"]
            if ck["loaded"] != st["print"][r] or ck["step"] != len(plan) \
                    or ck["bytes"] != STACKED_CKPT["bytes"]:
                fail(f"ring {label}: rank {r} loaded {ck['loaded']} at step "
                     f"{ck['step']} from {ck['bytes']} bytes, want "
                     f"{st['print'][r]} from the stacked checkpoint's "
                     f"{STACKED_CKPT['bytes']}")


def ring_line(label: str, spec, ranks: list) -> str:
    """The summary of one ring run over its ranks."""
    argv = spec[0]
    n = len(ranks)
    st = STACKED[label]
    lead = ranks[0]["runs"][label]
    step_s = statistics.median(lead["step_s"][1:])
    sp = {k: statistics.median(rk["runs"][label]["split"][k] for rk in ranks)
          for k in lead["split"]}
    sent = lead["wire"][-1]["wire_bytes_sent"]

    # the rate of the transfers the host posted and saw land in a step;
    # an async payload lands unobserved while the host computes
    gbps = [(w["wire_bytes_sent"] + w["wire_resync_bytes_sent"])
            / w["wire_s"] / 1e9 for rk in ranks
            for w in rk["runs"][label]["wire"][1:]
            if w["wire_s"] and not w["wire_flight_s"]]
    rate = (f"loopback {statistics.median(gbps):.3f} GB/s sent per rank"
            if gbps else "loopback rate not measured (the payload lands "
            "while the host computes)")
    peaks = [round(rk["runs"][label]["peak_gb"], 2) for rk in ranks]
    reserved = [round(rk["runs"][label]["reserved_gb"], 2) for rk in ranks]
    free = min(rk["runs"][label]["free_gb"] for rk in ranks)

    def med_ms(key):
        return 1e3 * statistics.median(w[key] for rk in ranks
                                       for w in rk["runs"][label]["wire"][1:])
    extra = ""
    if "--node-failures" in argv:
        extra += f"active_nodes {lead['active_nodes']}; "
    if label == RING_CKPT:
        ck = [rk["runs"][label]["ckpt"] for rk in ranks]
        extra += (f"checkpoint of step {ck[0]['step']}: {ck[0]['bytes']} "
                  f"bytes saved in {ck[0]['save_s']:.2f} s (the stacked "
                  f"checkpoint of the same state {STACKED_CKPT['bytes']} "
                  f"bytes in {STACKED_CKPT['save_s']:.2f} s), each rank's "
                  f"rows loaded back in "
                  f"{max(c['load_s'] for c in ck):.2f} s, the stacked "
                  "fingerprints; ")
    return (f"ring {label} ({n} ranks on {RING_DEVICE}, gloo over loopback "
            f"TCP, {argv_value(argv, '--steps')} steps): median step "
            f"{step_s:.4f} s (stacked {st['step_s']:.4f} s); inner sum "
            f"{med_ms('wire_inner_s'):.1f} ms, node sum "
            f"{med_ms('consensus_err_wire_s'):.1f} ms (medians of steps 2 "
            f"on over the ranks); {extra}exchange "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in sp.items())
            + f" (median over ranks of each rank's median of steps 2 on); "
            f"wire bytes per node and step {sent} (static {st['wire']}); "
            f"{rate}; "
            f"peak memory per rank {peaks} GB (reserved {reserved} GB), "
            f"card free after the run "
            f"{free:.2f} GB; losses {lead['loss']}; bitwise equal to the "
            "stacked run")


def phase_process_ring(torch, train, entries):
    """The consensus ring over processes on one card: gloo ranks
    (``launch.mesh.run_ranks``), all on cuda:0, each holding one node of
    the full smollm-135m (4 x 512 tokens, SGD lr 1e-2), whose payloads
    cross loopback TCP staged through pinned host memory.  4 ranks run
    ``RING_RUNS`` (int8 packed, pipelined over 4 units, int2, dgd and
    int8 async s1 for 3 steps; the directed push-sum ring on the adaptive
    grid at loss 0.2 per-leaf, and async s1 with 20% stragglers, for 3
    each; the churn schedule on async s1, rank 2 out for steps 5-8, for 9;
    pods of 2, packed, for 4; int8 async s1 also saves its last step
    into one checkpoint, which each rank loads its rows back from),
    5 ranks ``RING5_RUNS`` (strides 1,2 held 2 steps, async s1, 5 steps:
    resyncs at steps 3 and 5).  Stacked, on this process: each run's
    fixed-input exchange (once per argv), and each run's fingerprints
    where no earlier phase kept them (the phases that ran the same argv
    are deterministic: they hold transports bitwise equal to one another;
    a save does not change the bits).  On the ranks: the same exchange, whose payload bytes,
    state and x_next must equal the stacked row's (fingerprints), and each
    run through ``train.main --process-ring`` (``ring_check``).  Prints
    per run the median step, the inner sum's and the node sum's wire, the
    exchange split, the wire bytes, the loopback rate, each rank's peak
    memory and the card's free memory; per step of the async run the wait
    at the retire and the flight's posted-to-landed beside int8 packed's
    wait.  Returns (the ranks' launches, summary lines)."""
    import gc
    import shutil
    import tempfile
    from repro_torch.launch.mesh import run_ranks
    t_phase = time.perf_counter()
    groups = ((RING_RUNS, NODES), (RING5_RUNS, STRIDE_NODES))
    want_ex, done = {}, {}
    for runs, _ in groups:
        for label, (argv, _, _) in runs.items():
            if tuple(argv) not in done:
                done[tuple(argv)] = ring_exchange(torch, train, argv)
            want_ex[label] = done[tuple(argv)]
            if label not in STACKED:
                hist, state = train.main(argv, return_state=True)
                keep_stacked(torch, label, hist, state)
                del hist, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {name: 0 for name in entries}
    summary, ranks_s = [], {}
    ckpt_dir = tempfile.mkdtemp(prefix="ring-ckpt-")
    for runs, n in groups:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        line = (f"before the {n} ranks this process holds "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
                f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; card "
                f"free {torch.cuda.mem_get_info()[0] / 1e9:.2f} GB")
        print(f"[ring] {line}", flush=True)
        summary.append(line)
        t0 = time.perf_counter()
        # the ranks inherit the environment at their start
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = RING_ALLOC_CONF
        try:
            ranks = run_ranks(ring_rank, n, runs, ckpt_dir,
                              timeout_s=RING_TIMEOUT_S)
        finally:
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        ranks_s[n] = time.perf_counter() - t0
        for label, spec in runs.items():
            ring_check(label, spec, ranks, want_ex[label])
            for rank in ranks:
                for name, v in rank["runs"][label]["launches"].items():
                    launches[name] += v
            line = ring_line(label, spec, ranks)
            print(f"[ring] {line}", flush=True)
            summary.append(line)
        if n == NODES:
            line = ring_async_steps(ranks)
            print(f"[ring] {line}", flush=True)
            summary.append(line)
        del ranks
    total_s = time.perf_counter() - t_phase
    summary.append(f"phase_process_ring {total_s:.1f} s (the 4 ranks "
                   f"{ranks_s[NODES]:.1f} s, the 5 ranks "
                   f"{ranks_s[STRIDE_NODES]:.1f} s, start-up included)")
    print(f"[ring] {summary[-1]}", flush=True)
    return launches, summary


def ring_async_steps(ranks: list) -> str:
    """Per step, medians over the ranks: int8 async s1's wait at the
    retire, its flight's posted-to-landed and its step, beside int8
    packed's wait and step."""
    def med(label, key, k):
        return statistics.median(
            rk["runs"][label]["wire"][k][key] if key != "step_s"
            else rk["runs"][label]["step_s"][k] for rk in ranks)
    rows = []
    a, p = "int8 async s1", "int8 packed"
    for k in range(CODEC_STEPS):
        rows.append(
            f"step {k + 1}: async wait {med(a, 'wire_wait_s', k) * 1e3:.1f}"
            f" ms, flight {med(a, 'wire_flight_s', k) * 1e3:.1f} ms, step "
            f"{med(a, 'step_s', k):.4f} s; packed wait "
            f"{med(p, 'wire_wait_s', k) * 1e3:.1f} ms, step "
            f"{med(p, 'step_s', k):.4f} s")
    return ("int8 async s1 against int8 packed on 4 ranks (the wait is the "
            "host's time blocked at the retire; the flight is posted in the "
            "step before): " + "; ".join(rows))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, SRC)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitpack as BP
    from repro_torch.kernels import dequant_combine as D
    from repro_torch.kernels import gqa_decode as G
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import serve, train
    import atexit
    import tempfile
    measure = train.measure_consensus_overhead
    train.measure_consensus_overhead = _no_probe
    time_phases()
    t_main = t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[setup] built {sorted(report)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    dry_dir = tempfile.mkdtemp(prefix="dryrun-")
    atexit.register(stop_dryruns)
    start_dryruns(dry_dir)
    entries = {"quantize_payload": Q.quantize_payload,
               "dequant_combine_payload": D.dequant_combine_payload,
               "subbyte_encode_payload": BP.subbyte_encode_payload,
               "subbyte_decode_combine": BP.subbyte_decode_combine,
               "topk_encode_payload": BP.topk_encode_payload,
               "topk_decode_combine": BP.topk_decode_combine,
               "quantize_blocks": Q.quantize_blocks,
               "dequant_combine": D.dequant_combine,
               "gqa_decode": G.gqa_decode}
    n_rows, leaf_rows = main_path_rows(train)
    errs = phase_kernels(torch, Q, D, n_rows)
    errs.update(phase_codec_kernels(torch, BP, n_rows))
    errs.update(phase_block_kernels(torch, Q, D, leaf_rows))
    t0 = time.perf_counter()
    errs.update(phase_decode_kernel(torch, G))
    print(f"[kernels] phase_decode_kernel: {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, step_s, peak_gb, first_loss = phase_main(torch, train,
                                                       entries)
    for name, n in phase_perleaf(torch, train, entries).items():
        launches[name] += n
    plan_launches_, plan_step_s, plan_peak_gb, wide_abs = phase_plans(
        torch, Q, train, entries, n_rows)
    for name, n in plan_launches_.items():
        launches[name] += n
    errs["quantize_payload"] = max(errs["quantize_payload"], wide_abs)
    stride_launches, stride_step_s, stride_exchange_ms, stride_peak_gb = \
        phase_strides(torch, Q, D, train, entries)
    for name, n in stride_launches.items():
        launches[name] += n
    (fault_launches, fault_step_s, fault_exchange_ms, fault_exchange_gb,
     fault_peak_gb) = phase_faults(torch, Q, D, train, entries)
    for name, n in fault_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    (elastic_launches, elastic_step_s, elastic_exchange_ms,
     elastic_peak_gb) = phase_elastic(torch, Q, D, train, entries)
    print(f"[elastic] phase_elastic: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, n in elastic_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    tel_launches, tel_split, tel_summary = phase_telemetry(
        torch, train, entries, (step_s["int8"], peak_gb["int8"],
                                first_loss["int8"]))
    print(f"[telemetry] phase_telemetry: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, n in tel_launches.items():
        launches[name] += n
    ring_launches, ring_summary = phase_process_ring(torch, train, entries)
    for name, n in ring_launches.items():
        launches[name] += n
    serve_launches, _ = phase_serve(torch, serve, entries)
    launches["gqa_decode"] += serve_launches["gqa_decode"]
    phase_serve_profile(torch, G)
    phase_parity(torch, train)
    phase_serve_parity(torch)
    t0 = time.perf_counter()
    zoo_launches, zoo_summary = phase_zoo(torch, Q, D, G, train, entries)
    zoo_s = time.perf_counter() - t0
    print(f"[zoo] phase_zoo: {zoo_s:.1f} s", flush=True)
    for name, n in zoo_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    moe_launches, moe_summary = phase_moe(torch, Q, D, G, train, entries)
    moe_s = time.perf_counter() - t0
    print(f"[moe] phase_moe: {moe_s:.1f} s", flush=True)
    for name, n in moe_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    ssm_launches, ssm_summary = phase_ssm(torch, Q, D, G, train, entries)
    ssm_s = time.perf_counter() - t0
    print(f"[ssm] phase_ssm: {ssm_s:.1f} s", flush=True)
    for name, n in ssm_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    whisper_launches, whisper_summary = phase_whisper(torch, Q, D, G, train,
                                                      entries)
    whisper_s = time.perf_counter() - t0
    print(f"[whisper] phase_whisper: {whisper_s:.1f} s", flush=True)
    for name, n in whisper_launches.items():
        launches[name] += n
    t0 = time.perf_counter()
    prec_launches, prec_summary = phase_precision(
        torch, Q, D, G, train, entries, (step_s["int8"], peak_gb["int8"]))
    prec_s = time.perf_counter() - t0
    print(f"[precision] phase_precision: {prec_s:.1f} s", flush=True)
    for name, n in prec_launches.items():
        launches[name] += n
    an_launches, an_summary = phase_analysis(torch, G, train, entries,
                                             measure, dry_dir, smi)
    for name, n in an_launches.items():
        launches[name] += n
    paper_launches, paper_errs = phase_paper(torch, Q, entries)
    launches["quantize_blocks"] += paper_launches["quantize_blocks"]
    for name, n in phase_paper_plan(torch, entries).items():
        launches[name] += n
    errs["quantize_blocks"] = max(errs["quantize_blocks"],
                                  paper_errs["quantize_blocks"])
    rows = phase_timing(torch, Q, D, BP, launches, errs, n_rows, leaf_rows)
    rows.append(phase_decode_timing(torch, G, launches, errs))
    t0 = time.perf_counter()
    phase_decode_timing(torch, G, launches, errs, torch.bfloat16,
                        PREC_DECODE_SHAPES)
    bf16_s = time.perf_counter() - t0
    print(f"[timing] #9 in bfloat16 at {', '.join(PREC_DECODE_SHAPES)}, "
          f"range sweeps at {', '.join(BF16_DECODE_SWEEP)}: {bf16_s:.1f} s",
          flush=True)
    prec_s += bf16_s
    exchange_ms = phase_exchange_time(torch, train)
    for codec in step_s:
        print(f"[summary] {codec}: step {step_s[codec]:.4f} s, exchange "
              f"{exchange_ms[codec]:.2f} ms, peak memory "
              f"{peak_gb[codec]:.2f} GB, card {smi}")
    for label in plan_step_s:
        exch = (f"{exchange_ms[label]:.2f} ms" if label in exchange_ms
                else "not timed")
        print(f"[timing] {label}: step {plan_step_s[label]:.4f} s, exchange "
              f"{exch}, peak memory {plan_peak_gb[label]:.2f} GB, card "
              f"{smi}")
    for label in stride_step_s:
        print(f"[summary] strides {label} ({STRIDE_NODES} nodes, strides "
              f"1,2, period {STRIDE_PERIOD}): step {stride_step_s[label]:.4f}"
              f" s, peak memory {stride_peak_gb[label]:.2f} GB, card {smi}")
    print(f"[summary] strided {STRIDE_NODES}-node exchange: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stride_exchange_ms.items())
          + f"; the resync adds "
          f"{stride_exchange_ms['stride 2, resync'] - stride_exchange_ms['stride 2']:.2f}"
          f" ms; card {smi}")
    for label in fault_step_s:
        print(f"[summary] faults {label}: step {fault_step_s[label]:.4f} s, "
              f"peak memory {fault_peak_gb[label]:.2f} GB, card {smi}")
    sym, dirl = fault_exchange_ms["symmetric"], fault_exchange_ms["directed"]
    print(f"[summary] 4-node int8 exchange: "
          + ", ".join(f"{k} {v:.2f} ms ({fault_exchange_gb[k]:.2f} GB)"
                      for k, v in fault_exchange_ms.items())
          + f"; loss 0.2 adds "
          f"{fault_exchange_ms['symmetric loss 0.2'] - sym:.2f} ms, the "
          f"directed ring {dirl - sym:.2f} ms and "
          f"{fault_exchange_gb['directed'] - fault_exchange_gb['symmetric']:.2f}"
          f" GB of peak; card {smi}")
    for label in elastic_step_s:
        print(f"[summary] elastic {label}: step "
              f"{elastic_step_s[label]:.4f} s, peak memory "
              f"{elastic_peak_gb[label]:.2f} GB, card {smi}")
    flat = elastic_exchange_ms["flat"]
    print(f"[summary] 4-node elastic exchange: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in
                      elastic_exchange_ms.items())
          + f"; the hole epoch {elastic_exchange_ms['hole (3 active)'] / flat:.3f}"
          f" of the flat exchange, the resync at 4 nodes adds "
          f"{elastic_exchange_ms['churn step 9 (resync, 4 active)'] - flat:.2f}"
          f" ms; card {smi}")
    print("[summary] 4-node int8 packed exchange, measured split (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in tel_split.items())
          + f"; card {smi}")
    for line in tel_summary:
        print(f"[summary] {line}; card {smi}")
    for line in ring_summary:
        print(f"[summary] {line}; card {smi}")
    for label, z in zoo_summary.items():
        print(f"[summary] zoo {label}: "
              + ", ".join(f"{k} {v!r}" for k, v in z.items())
              + f"; card {smi}")
    print(f"[summary] phase_zoo {zoo_s:.1f} s; card {smi}")
    for label, z in moe_summary.items():
        print(f"[summary] moe {label}: "
              + ", ".join(f"{k} {v!r}" for k, v in z.items())
              + f"; card {smi}")
    print(f"[summary] phase_moe {moe_s:.1f} s; card {smi}")
    for label, z in ssm_summary.items():
        print(f"[summary] ssm {label}: "
              + ", ".join(f"{k} {v!r}" for k, v in z.items())
              + f"; card {smi}")
    print(f"[summary] phase_ssm {ssm_s:.1f} s; card {smi}")
    for label, z in whisper_summary.items():
        print(f"[summary] whisper {label}: "
              + ", ".join(f"{k} {v!r}" for k, v in z.items())
              + f"; card {smi}")
    print(f"[summary] phase_whisper {whisper_s:.1f} s; card {smi}")
    for label, z in prec_summary.items():
        print(f"[summary] precision {label}: "
              + ", ".join(f"{k} {v!r}" for k, v in z.items())
              + f"; card {smi}")
    print(f"[summary] phase_precision (with #9 timed in bfloat16) "
          f"{prec_s:.1f} s; card {smi}")
    for label, z in an_summary.items():
        print(f"[summary] analysis {label}: {z!r}; card {smi}")
    total = time.perf_counter() - t_main
    print(f"[time] {total:.1f} s from the build on: "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(PHASE_S.items(), key=lambda kv: -kv[1]))
          + f", outside the phases {total - sum(PHASE_S.values()):.1f}; "
          f"card {smi}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
