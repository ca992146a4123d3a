#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # the whole check, one card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card (`nvidia-smi` name and power limit) and the build of every
     kernel from `src/repro_torch/csrc` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, in bf16
     and fp32, at the shapes the four engine paths give it (llama3.2-1b,
     olmoe-1b-7b, rwkv6-3b and recurrentgemma-9b geometry), decode
     attention also over a 4096-slot cache at batch 4 (split-KV plus the
     combine kernel) and 28, the transformer family's heads in bf16
     (decode attention at batch 28 over 128 slots for qwen2-1.5b,
     qwen2.5-3b, smollm-360m, starcoder2-7b and phi-3-vision's head_dim
     96; prefill attention over 28 x 16 tokens at those heads and at
     gemma2-27b's, softcap 50, query scale 144^-1/2 and window 4096, and
     gemma2's heads over 4 x 4000 tokens, whose library call is a compiled
     `flex_attention` with a tanh score_mod where it compiles, else none;
     RMSNorm at 28 and 448 rows of 1536, 960, 3072 and 4608, and at the
     one-row admission prefill's 16 x 2048, 16 x 4096 and 256 x 128 rows),
     and the grouped GEMM also at olmoe's prefill
     down product, at batch 4's 32 rows an expert and at 300 (two row
     blocks), with its device
     time (CUDA events
     over a primed stream, median of repeats), its per-call time when the
     host launches the calls (`call_ms`: launch overhead included), the plain
     version's device time, one PyTorch library call's (`F.rms_norm`,
     `F.scaled_dot_product_attention`, `torch.bmm`; timed here only, never
     used by the port; WKV6 and the RG-LRU scan have none) and the least
     time the card could
     take (bytes over 3.35 TB/s or operations over the peak of the type
     the kernel computes in, whichever is larger).  Tolerances: 2e-2 in
     bf16, 2e-5 in fp32 (max abs error; over the 4096-slot cache, whose
     outputs are small, as |err| <= tol * max|ref|); the grouped GEMM,
     whose outputs are sums over K = 1024-2048 products, and WKV6 (y and
     the final state, sums over C·N terms and the carried state), 2e-2 /
     1e-4 as |err| <= tol * (1 + |ref|).  WKV6 runs at rwkv6-3b's prefill (B 28,
     S 64, H 40, N 64, chunk 32) and decode (S 1, chunk 1) shapes and over
     a long prompt (B 4, S 2048: 64 chunks), from a nonzero state; the
     chunked form's four products run on tensor cores in 3xTF32, so its
     operations are counted at the TF32 peak three times over (twice
     where v holds bf16 values), the rest at fp32's; the grouped GEMM's
     fp32 tile (C > 8) is 3xTF32 too, its products counted at the TF32
     peak three times over.  The RG-LRU kernel runs both front ends at
     recurrentgemma-9b's prefill (B 28, S 16, W 4096) and decode (S 1)
     shapes from a nonzero state: the plain scan from fp32 log_a and b,
     and the gated front end (the one the model runs) from bf16
     pre-activations za, zi and y, held to `rglru_gates_ref` then the
     step or the associative scan.  Both are held, on h and on the final
     state, to SUM_TOLERANCE's fp32 1e-4 as |err| <= 1e-4 * (1 + |ref|):
     the state carries every earlier step, summed in another order by
     the plain version.  Their decode rows are also timed as a captured
     CUDA graph of 10 back-to-back launches (`graph_ms`: the kernel's time
     as inside the engine's decode graph, without the host's launches,
     which the event time of phase 2's other rows includes).  Prefill
     attention also runs at recurrentgemma-9b's heads (16/1 x 256,
     window 2048), and RMSNorm at its d_model 4096, and at phi-3-vision's
     heads (32 x 96) with a 16-slot prefix before left pads of 0, 5 and
     15 slots (`prefix_len`: a row's keys [0, 16) and [16 + pads, S)).  Prefill attention (bf16: the
     tensor-core kernel; fp32: the CUDA-core one) is held row by row, each
     query row to tol * its own max|ref|, and in bf16 also runs at 4 x 4000
     tokens: llama's heads (causal; phase 6's shapes, SDPA with
     is_causal) and recurrentgemma's (window 2048, which skips key tiles;
     SDPA with a boolean mask), compared with the plain version one prompt
     at a time;
  3. model level in fp32 on narrow configs: llama3.2-1b's head geometry
     and olmoe-1b-7b's (qk-norm, untied head, 8 experts top-2 at capacity
     factor 8 so no near-tie can move a token to another expert).  The
     "flash" (kernel) and "naive" logits over a left-padded prefill and 4
     decode steps agree within 1e-4, and for olmoe the same weights run on
     the CPU (plain versions) agree with the card within 1e-4.  A narrow
     rwkv6 (head_dim 64, 2 layers, mixes, decay base and bonus filled with
     noise) on the card against the same weights on the CPU within 1e-4,
     over a 40-token prefill (two chunks of 16 and an 8-token tail) and 4
     decode steps.  A narrow fp32 recurrentgemma (3 blocks: recurrent,
     recurrent, local attention; d_model and lru_width 256, 16/1 heads x
     256, window 16; gate biases, conv bias and norm scales filled with
     noise) over a left-padded 40-token prefill into a 16-slot ring (the
     prefill rolls it) and 8 decode steps that wrap it: flash (kernels) vs
     naive on the card, and flash on the card vs on the CPU (plain
     versions), within 1e-4.  Then continuous batching on the four narrow
     models: one staggered workload (3 slots, chunks of 4, prompt bucket
     8, `step_time_s=1`, an EOS, admissions mid-decode, recurrentgemma's
     short admitted prompts rolled into its ring) on the card and on the
     CPU gives the same tokens, decode steps, prefill calls and records.
     Then the transformer family, narrow and fp32, flash (kernels) vs
     naive on the card and the card vs the CPU (plain versions), within
     1e-4, over a left-padded 40-token prefill and 8 decode steps: qwen2
     (q/k/v biases, a decode group of 6), starcoder2 (LayerNorm, dense
     GELU MLP, biases, a group of 9), gemma2 (local/global interleave, a
     ring of 8 slots the prefill rolls and the decode wraps, both
     softcaps, post-norms, the embedding and query scales), qwen2 with
     the int8 cache, phi-3 (head_dim 96, 8 prefix embeddings, prompts
     without pads) and mixtral-smoke's shape (the grouped GEMM over ring
     local layers); and the continuous workload on the gemma2 and int8
     narrow models (gemma2 at a prompt bucket of 4, so short admitted
     prompts are rolled into its ring); then the narrow phi-3 with its 8
     prefix embeddings before left pads of 0, 5, 15 and 30 slots: the
     prefill's logits, flash vs naive on the card and card vs CPU;
  4. the main paths: llama3.2-1b (4a) and olmoe-1b-7b (4b) at full width
     (16 layers, d_model 2048, bf16, attn_impl="flash", 16-token prompts)
     and rwkv6-3b (4c: 32 layers, d_model 2560, bf16, 64-token prompts in
     buckets of 32, so prefill is two chunks and no tail) and
     recurrentgemma-9b (4d: 38 blocks, d_model 4096, bf16,
     attn_impl="flash", 16-token prompts; its attention caches are plain
     128-slot caches, min(128, 2048), so the window is inert here and the
     ring is exercised by phase 3), then the transformer family at full
     width, bf16, attn_impl="flash", 16-token prompts: qwen2.5-3b (4e, the
     paper's second edge model) and qwen2-1.5b (4f) at 8 rounds,
     smollm-360m (4g), starcoder2-7b (4h) and phi-3-vision-4.2b (4i, its
     backbone on tokens) at 4, and gemma2-27b (4j, 54.5 GB of bf16
     weights, last, after every earlier engine is freed) at 4, with seeded
     random weights made on the card, behind the port's InferenceEngine
     and EngineEnvironment, each driven by CostModel + Controller + CamelTS
     for 8 rounds as `serve.py --mode engine` does, with per-pull prefill
     and decode times against the decode step's floor (the bytes it must
     read: weights, and for rwkv6 and recurrentgemma the recurrent state
     read and written, and recurrentgemma's attention caches read).  The
     fused decode replays one CUDA graph a step: before the counted run
     the engine captures its graph at every batch arm (capture time
     printed).  Energy there is the Jetson Orin analytical board model
     applied to measured wall time (modelled; phase 8 measures it);
  5. after each path, its kernel executions equal what the path implies
     (counters set to 0 just before the path and read just after, plus
     each graph's replays in the run times its per-kernel tally; every
     kernel off the path at 0; the 128-slot caches never launch decode
     attention's combine kernel; every prefill-attention launch is the
     tensor-core kernel's, `tc_launches`); then graph-replayed against
     eager-loop decode (`decode_impl="loop"`) on the same params and
     prompts at batch 4 and 28: tokens equal, decode step times in turns
     (graph, loop, loop, graph); then a torch.profiler breakdown of one
     more full-width generate (kernel time by name, device busy share;
     the decode window from the first graph launch: its busy share, the
     host's launches a step, and `kernel_in_path` per kernel inside the
     graph and in the prefill);
  6. after llama3.2-1b's path, one profiled generate on a second engine
     with the same params over a 4096-slot cache (batch 4, 4000-token
     prompts): decode attention splits the KV axis there, and the kernel
     executions of that generate (its graph's replays included) must show
     the combine kernel once a layer a decode step.  After qwen2-1.5b's,
     the int8 cache at that size (batch 4, 4096 slots, 4000-token
     prompts) against the native one on the same params: prefill and
     decode step of each, in turns, the int8 graph's tokens equal to its
     eager loop's, and its kernel executions (decode attention over the
     dequantized cache, once a layer a step, split, with the combine).

  7. after each of the first five paths (qwen2.5-3b's included), continuous
     batching on its engine at MAX_BATCH
     slots (the graph phase 4 captured at that batch, replayed a step):
     (a) every request at t=0 with equal budgets gives `generate`'s tokens
     at chunk 8 and 3; (b) E13's workload (Poisson arrivals, every 4th
     request 8x longer) through `generate_continuous` and through static
     groups of MAX_BATCH, `step_time_s=1`: makespan in step units, wall
     seconds, goodput, occupancy, queue wait, the continuous decode step
     beside the static graph step; (c) the kernel executions of (a) and
     (b), equal to their prefills (static, seed and one-row admission
     alike) times a prefill's launches plus their decode steps times a
     step's; then the one-row admission prefill alone, timed and profiled
     (`kernel_in_path window=admit`); on gemma2-27b (a) and (c) alone,
     which exercise its two cache groups in the pool;
  8. after each of the first five paths, measured energy: Camel rounds through
     `EngineEnvironment(sensor="nvml")` with the static scheduler and the
     continuous one, each pull's power the meter's average over NVML,
     failing unless the sensor is `nvml:0` on the board whose UUID is
     CUDA device 0's and every pull's watts are finite in (0, power
     limit]; then one window of >= 1 s of generates at MAX_BATCH,
     metered beside the board's energy counter
     (`nvmlDeviceGetTotalEnergyConsumption`).  Nothing falls back to a
     simulated sensor;
  9. the paper's search loop: (a) `search_mode`'s search over the modelled
     Jetson AGX Orin landscape of llama3.2-1b and qwen2.5-3b, 49 pulls,
     every policy but the fleet-only contextual one, at K 1 and 4, the
     landscape's batched pulls evaluated on the card, each run held to the
     same call on the CPU (the same arms record by record and commit,
     costs within 1e-6 relative); (b) `validate_mode` at 2500 requests on
     both models, each configuration's modelled Orin EDP and
     `edp_vs_maxf_maxb`; (c) `fleet_run` on 4 devices with camel and
     contextual: the async controller without a straggler equals the
     batch one record by record, and under a 4x straggler its simulated
     wall clock and mean staleness; (d) on llama3.2-1b's full-width engine
     (after its phases 4-8), the batch controller at K 4 and the async one
     at K 1, 8 pulls each through `EngineEnvironment`: kernel executions
     as those generates imply (added to the record's launches), every
     staleness 0, the posterior equal to the records' costs chained
     through `update`, and the controller's host time a round (select +
     update, pulls excluded).  Its seconds are printed (`phase 9
     seconds=`);
 10. fault injection (`repro_torch.faults`): (a) E14's claims with the
     4-device fleet's landscape on the card (the reference's constants:
     K 4, 64 pulls, seeds 0-2, the retry and the censored chaos specs,
     5 % commit tolerance), each run equal to the same run on the CPU
     record by record: the zero plan and an idle armed plan bit-identical
     to the bare run, the chaos runs on their exact budget (the 5 %
     commit bound printed a cell, not failed on: a claim about the
     reference's random stream), a hung device timed out and
     quarantined; (b) on
     llama3.2-1b's full-width engine (28 slots, its graph), E13's Poisson
     workload bare, under a zero plan (bit-identical) and under
     CANCEL_SPEC: some but not all requests cancelled, each within a
     scheduler iteration (MAX_BATCH admissions + a chunk) of its
     deadline, and the kernel executions of the three runs exact, refills
     included; (c) the same plan on llama3.2-1b-smoke in fp32, card
     against CPU, streams and records equal; (d) a `FlakySensor` around
     NVML (SENSOR_SPEC) over one metered continuous pull: its injected
     faults are the `Measurement`'s sample errors, the pull's power and
     energy finite; (e) `serve.py --mode engine --faults` on the card
     prints the engine mode's keys and `faults` (`phase 10 seconds=`);
 11. the encoder-decoder (`models/encdec.py`) after every path's
     weights are freed: the narrow fp32 seamless-smoke card against CPU
     (1e-4) and decode against forward (2e-3); then seamless-m4t-large-v2
     as published (24 + 24 layers, d_model 1024, 16 x 64 heads, d_ff 8192
     ReLU, vocab 256206, tied; 1.37 B parameters, bf16, seeded random
     weights) at b 4 x 512 speech frames (the AudioStub's default) and
     b 1 x 4096 (max_source_len), 16 greedy tokens: encode, prefill and
     decode-step ms (eager, and one CUDA graph replay a step, tokens
     equal; a profiled window of replays: kernels a step, busy share, the
     top kernels), the step's byte floor, peak memory, decode against the
     teacher-forced forward within ENCDEC_BF16_TOL of its largest logit,
     and no kernel launched (naive attention, as in the reference);
 12. training (`launch/train.py`, `launch/steps.py`, the models'
     `loss_fn` and remat) after phase 11 frees its weights: (a) the narrow
     fp32 llama3.2-1b-smoke and olmoe-1b-7b-smoke, the same params and
     batch on the card and on the CPU: every leaf's gradient present, per
     leaf within 1e-3 of the CPU's norm and elementwise within 5e-3
     (tests/test_flash_equiv.py), then 5 AdamW steps whose losses agree
     within 1e-4 relative; (b) llama3.2-1b as published (16 layers, d
     2048, 32/8 x 64, vocab 128256, 1,235,812,352 parameters, bf16)
     through `run_training` at B 8 x S 512 for 8 steps: step ms, tokens/s,
     model-FLOP utilization (6 N tokens / step s / 989e12), peak memory,
     the losses (finite, the last below the first) and the kernel launches
     a step, forward and backward, equal to what the config implies
     (`expected_train_launches`); then a crash at step 5 with a checkpoint
     every 2 steps and the resume (start step >= 4, losses within 1e-3
     relative of the uninterrupted run's); (c) remat "full" and "dots" at
     (b)'s shape, losses within 1e-3 relative of "none", launches exact
     (the recomputed forward relaunches the blocks' norms); (d)
     olmoe-1b-7b at full width (64 experts top-8, qk-norm) cut to 4 of its
     16 layers (the whole model's 6.92 B parameters at 12 bytes each in
     training, 83 GB, exceed the card), 8 steps with (b)'s outputs and the
     grouped GEMM's forward, dx and dw launches exact, and no transposed
     copy (bf16 dx and dw read their operands in place); after (b) and
     after (d) one profiled step (`train_profile`: busy share and the top
     kernels by device time, `train_top`); (a') as (a) for rwkv6-smoke,
     recurrentgemma-smoke and seamless-smoke (with 16 seeded speech
     frames); (e) rwkv6-3b as published (32 layers, d 2560, vocab 65536,
     3,099,688,960 parameters, 37.2 GB at 12 bytes a parameter, bf16)
     through `run_training` at (b)'s shape, remat "none" (which fits the
     80 GB card) and "full" against it, losses within 1e-3 relative;
     (f) recurrentgemma-9b at full width cut to 6 of its 38 blocks (two rec-rec-attn periods: 2.36 B parameters, 28.3 GB in
     training; the whole model's 112.8 GB exceed the card); (g)
     seamless-m4t-large-v2 as published through `make_train_step` (the
     reference's `run_training` refuses it) on one seeded batch of b 4 x
     512 speech frames and 128 target tokens; each with (b)'s outputs and
     exact launches (rwkv6: one WKV6 forward and backward a layer, one
     more forward a layer under remat; recurrentgemma: one gated RG-LRU
     forward and backward a recurrent block, 2 L + 1 RMSNorms forward and
     backward; seamless: none), and one profiled step after (e) and (f).
     Phase 2 holds the backward kernels to autograd of their plain
     versions at these shapes: RMSNorm's (dx, and dscale to
     SUM_TOLERANCE; one kernel a call, as the profiler sees it) at llama's
     4096 x 2048 rows and olmoe's 65536 x 128 qk-norm rows, the grouped
     GEMM's dx and dw at `[64,640,2048]@[64,2048,1024]` and
     `[64,640,1024]@[64,1024,2048]` (SUM_TOLERANCE; in bf16 no transposed
     copy launched), each giving the same bits on two calls, each timed
     beside its written-out plain backward and a library call (autograd's
     backward of `F.rms_norm`; `torch.bmm` on transposed views), and the
     grouped GEMM's forward at those shapes (training's capacity, 640
     rows an expert) beside `torch.bmm`; in fp32 also the transposed
     copies the fp32 dx and dw run on (beside PyTorch's own copy).  WKV6's
     backward at (e)'s shape (B 8 x S 512, 40 x 64) and the gated
     RG-LRU's at (f)'s (B 8 x S 512 x W 4096), bf16 and fp32 inputs, from
     a nonzero initial state, each held to autograd of its plain version
     to SUM_TOLERANCE, the same bits on two calls, timed beside the plain
     backward (no library call computes either).

The line before the last holds the card's name and power limit, the one
before it the kernels' JSON record (`launches` summed over the paths'
counted runs, phases 7 and 12 included; the backward kernels' rows,
`rmsnorm_bwd`, `moe_gemm_dx`, `moe_gemm_dw`, `wkv6_bwd` and `rglru_bwd`,
count phase 12's runs and are timed at llama's training rows, olmoe's
gate/up training product and rwkv6-3b's and recurrentgemma-9b's training
shapes;
times at the llama shapes for the attention and norm
kernels, at olmoe's decode gate/up product for the grouped GEMM, at
rwkv6-3b's decode step for WKV6 and at recurrentgemma-9b's decode step
for the RG-LRU kernel's gated front end, the one the path runs), and the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "tf32": 495e12,        # dense tensor-core TF32
              "float32": 67e12}      # fp32 outside the tensor cores
TOLERANCE = {"bfloat16": 2e-2, "float32": 2e-5}
#: Relative tolerance (|err| <= tol * (1 + |ref|)) of the kernels whose
#: outputs are long sums: the grouped GEMM, WKV6 and the RG-LRU scan.
SUM_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}
MAX_BATCH, MAX_SEQ_LEN, PROMPT_LEN, NEW_TOKENS = 28, 128, 16, 8
#: The main paths: (arch, prompt length, prompt bucket, Camel rounds,
#: phases 7-8: "all", "identity" (7(a) and 7(c)) or "none").  rwkv6-3b's
#: prompts are two whole chunks of 32, so its prefill runs the chunked
#: kernel once a layer and no per-token tail.  gemma2-27b runs last: its
#: weights take 54.5 GB of the card.
PATHS = (("llama3.2-1b", PROMPT_LEN, PROMPT_LEN, 8, "all"),
         ("olmoe-1b-7b", PROMPT_LEN, PROMPT_LEN, 8, "all"),
         ("rwkv6-3b", 64, 32, 8, "all"),
         ("recurrentgemma-9b", PROMPT_LEN, PROMPT_LEN, 8, "all"),
         ("qwen2.5-3b", PROMPT_LEN, PROMPT_LEN, 8, "all"),
         ("qwen2-1.5b", PROMPT_LEN, PROMPT_LEN, 8, "none"),
         ("smollm-360m", PROMPT_LEN, PROMPT_LEN, 4, "none"),
         ("starcoder2-7b", PROMPT_LEN, PROMPT_LEN, 4, "none"),
         ("phi-3-vision-4.2b", PROMPT_LEN, PROMPT_LEN, 4, "none"),
         ("gemma2-27b", PROMPT_LEN, PROMPT_LEN, 4, "identity"))

KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:19"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:32"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:38"),
    "moe_gemm": ("src/repro_torch/csrc/moe_gemm.cu",
                 "src/repro/kernels/moe_gemm/moe_gemm.py:21"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/rwkv6.py:31"),
    "rglru": ("src/repro_torch/csrc/rglru.cu",
              "src/repro/kernels/rglru/rglru.py:31"),
}
#: The training backward's kernels (phase 12), by record name: their
#: source and the Pallas kernel whose forward they differentiate.
BACKWARD_KERNELS = {
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:19"),
    "moe_gemm_dx": ("src/repro_torch/csrc/moe_gemm.cu",
                    "src/repro/kernels/moe_gemm/moe_gemm.py:21"),
    "moe_gemm_dw": ("src/repro_torch/csrc/moe_gemm.cu",
                    "src/repro/kernels/moe_gemm/moe_gemm.py:21"),
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6/rwkv6.py:31"),
    "rglru_bwd": ("src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru/rglru.py:31"),
}
BACKWARD_NOTE = ("no Pallas backward exists (the reference trains through "
                 "pure JAX); this kernel is the gradient of the port's "
                 "forward kernel that replaces the one named")
#: Substrings of the port's CUDA kernel names (csrc/*.cu).
PORT_KERNEL_NAMES = ("rmsnorm_kernel", "attention_kernel",
                     "flash_attention_wgmma", "moe_gemm_",
                     "wkv6_", "rglru_", "decode_attention_split",
                     "decode_attention_combine")
#: Phase 2's and phase 3's prefix before left pads: phi-3-vision's 16-slot
#: prefix and one row for each pad count.
PREFIX_LEN, PREFIX_PADS = 16, (0, 5, 15)
#: The long-cache generate of phase 6: llama3.2-1b at batch 4 over a
#: 4096-slot cache (4000-token prompts), where decode attention splits the
#: KV axis across CTAs and merges the partials in a second kernel.
LONG_BATCH, LONG_SEQ_LEN, LONG_PROMPT = 4, 4096, 4000
#: Phase 2's long WKV6 prompt (rwkv6 is served with long contexts): at
#: batch LONG_BATCH, 64 chunks of 32.
WKV6_LONG_PROMPT = 2048
#: CUDA runtime and driver calls by which the host puts work on the
#: device, as the profiler names them (the decode window's host launches).
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")
WKV6_LIBRARY_NOTE = ("no single PyTorch call computes the WKV6 recurrence "
                     "(no library kernel for it), so library_ms is null")
#: gemma2-27b's attention: softcap 50 and query scale (d_model / H)^-1/2.
GEMMA2_SOFTCAP, GEMMA2_SCALE = 50.0, (4608 / 32) ** -0.5
RGLRU_LIBRARY_NOTE = ("no single PyTorch call computes a first-order linear "
                      "recurrence (no library kernel for it), so library_ms "
                      "is null")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, inner: int = 10, prime: bool = True):
    """Per-call times of `fn` from CUDA events, medians over `reps` windows
    of `inner` back-to-back calls, after a warm-up.  Returns (device_ms,
    call_ms): device_ms with the stream primed by a sleep kernel long
    enough that the host enqueues the whole window before the device
    reaches it (so the window holds device time only; a window the device
    caught up with is discarded and the sleep doubled); call_ms unprimed,
    i.e. bounded by how fast the host can issue the calls.  With `prime`
    False device_ms is call_ms: for a function of thousands of launches,
    whose window overruns the launch queue, so that the host waits on the
    sleeping device and no window is ever primed."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    def window(prime_cycles):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if prime_cycles:
            torch.cuda._sleep(prime_cycles)
        start.record()
        for _ in range(inner):
            fn()
        primed = not start.query()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner, primed

    if not prime:
        call = statistics.median(window(0)[0] for _ in range(reps))
        return call, call
    cycles = int((2 * inner * host_s + 2e-4) * 2e9)   # ~2 GHz SM clock
    dev, call = [], []
    for _ in range(reps):
        ms, primed = window(cycles)
        for _ in range(8):
            if primed:
                break
            cycles *= 2
            ms, primed = window(cycles)
        dev.append(ms)
        call.append(window(0)[0])
    return statistics.median(dev), statistics.median(call)


def graph_ms(fn, inner: int = 10, reps: int = 15) -> float:
    """Per-call device time of `fn` captured `inner` times back to back in
    one CUDA graph: the median over `reps` replays timed with CUDA events,
    each replay behind a sleep kernel so the host's launch of the graph is
    off the clock.  What is left is the kernels' own time and the graph's
    gaps between them, as inside the engine's decode graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def wkv6_flops(b, s, h, n, chunk, exact_v):
    """Operations of the WKV6 kernel on these shapes, keyed by the peak
    (PEAK_FLOPS) they run at.  The step form (chunk 1): per token and
    (b, h) 7 N^2 in fp32.  The chunked form, per chunk: four products on
    tensor cores, the inter-chunk r S and the state update 2 C N^2 each,
    the intra-chunk weights and their product with v C (C - 1) N each
    (strictly lower triangle); each is computed in 3xTF32, three TF32
    products, two for the products with v where v holds bf16 values
    (`exact_v`: exact in TF32).  The bonus (4 C N) and the state decay
    (2 N^2) in fp32."""
    if chunk == 1:
        return {"float32": b * h * s * 7 * n * n}
    each = 2 * chunk * n * n + chunk * (chunk - 1) * n
    per_chunk = {"tf32": 3 * each + (2 if exact_v else 3) * each,
                 "float32": 4 * chunk * n + 2 * n * n}
    return {kind: b * h * (s // chunk) * x for kind, x in per_chunk.items()}


def wkv6_bwd_flops(b, s, h, n, chunk, exact_v):
    """Operations of the WKV6 backward on these shapes, keyed by the peak
    (PEAK_FLOPS) they run at, counted as wkv6_flops counts the forward's:
    the least the card needs for the same gradients is their chunked form,
    whose products run on tensor cores in 3xTF32.  Per chunk, from the
    chunk-start states: four products with the state, 2 C N^2 each (dr's
    dy S^T, dk's v G^T, dv's k G and G's update r^T dy), and five of the
    intra-chunk weights, C (C - 1) N each (the weights r k^T recomputed,
    their gradient dy v^T, and its products for dr, dk and dv); each is
    three TF32 products, two for the two with v where v holds bf16 values
    (`exact_v`).  The bonus terms of dr, dk, dv and du and dlogw's sums
    (12 C N) and G's decay (N^2) in fp32."""
    state, intra = 2 * chunk * n * n, chunk * (chunk - 1) * n
    with_v = 2 if exact_v else 3
    per_chunk = {"tf32": 3 * (3 * state + 4 * intra)
                 + with_v * (state + intra),
                 "float32": 12 * chunk * n + n * n}
    return {kind: b * h * -(-s // chunk) * x
            for kind, x in per_chunk.items()}


def draw(torch, gen, shape, dtype, scale=1.0):
    """scale x standard normal values of `shape` from the generator `gen`
    (on its device), cast to `dtype`."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device)
            ).to(dtype)


def rglru_lambda(torch, gen, w):
    """lambda from the reference's init: softplus^-1 of the decay
    strengths -log(u) / 8, u ~ U(0.9, 0.999)."""
    u = torch.empty((w,), device=gen.device).uniform_(0.9, 0.999,
                                                      generator=gen)
    return torch.log(torch.expm1(-torch.log(u) / 8.0))


def wkv6_inputs(torch, gen, shape, dt):
    """WKV6's inputs over [B, S, H, N] `shape`, drawn from `gen` in this
    order: r, k, v in `dt`, logw in the model's decay range clamped to
    [-4, -1e-6], the bonus u [H, N] and a nonzero initial state
    [B, H, N, N] (fp32)."""
    b, _, h, n = shape
    f32 = torch.float32
    r, k = draw(torch, gen, shape, dt, 0.5), draw(torch, gen, shape, dt, 0.5)
    v = draw(torch, gen, shape, dt)
    logw = (-torch.exp(draw(torch, gen, shape, f32) - 2.0)).clamp(-4.0,
                                                                  -1e-6)
    return (r, k, v, logw, draw(torch, gen, (h, n), f32, 0.2),
            draw(torch, gen, (b, h, n, n), f32, 0.5))


def rglru_gated_inputs(torch, gen, shape, dt):
    """The gated RG-LRU's inputs over [B, S, W] `shape`, drawn from `gen`
    in this order: za, zi, y in `dt`, b_a, b_i and lambda [W] (fp32, the
    reference's init for lambda) and a nonzero initial state h0 [B, W]."""
    b, _, w = shape
    f32 = torch.float32
    za, zi, y = (draw(torch, gen, shape, dt) for _ in range(3))
    vectors = (draw(torch, gen, (w,), f32, 0.5),
               draw(torch, gen, (w,), f32, 0.5), rglru_lambda(torch, gen, w))
    return za, zi, y, vectors, draw(torch, gen, (b, w), f32)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, ops):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import row_scaled_error
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures, main = [], {}

    def rnd(shape, dtype, scale=1.0):
        return draw(torch, gen, shape, dtype, scale)

    def own_stream(seed, fn, *args, **kw):
        """fn(*args, **kw) with its inputs drawn from a generator of its
        own, so that the rows after it draw what they drew before it was
        added."""
        nonlocal gen
        saved, gen = gen, torch.Generator(device=dev).manual_seed(seed)
        fn(*args, **kw)
        gen = saved

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def flat(out):
        """One fp32 vector of a kernel's output (a tensor or a tuple)."""
        outs = out if isinstance(out, tuple) else (out,)
        return torch.cat([t.float().flatten() for t in outs])

    def check(name, dtype_name, shape, kernel, plain, library, nbytes,
              flops, is_main, long_sums=False,
              library_note=None, to_max_ref=False, per_row=False,
              compare=None, plain_reps=15, plain_prime=True, graph=False,
              record_as=None):
        """Hold kernel() to plain() and time kernel, plain and library.
        `compare`, a (kernel, plain) pair of smaller calls, replaces the
        timed pair in the comparison where the plain version cannot run at
        the timed shape.  `graph`: also time kernel() inside a CUDA graph
        (`graph_ms`).  A main row is recorded under `record_as` (default
        `name`), the library it belongs to."""
        kernel_c, plain_c = compare or (kernel, plain)
        k_out, p_out = kernel_c(), plain_c()
        out, ref = flat(k_out), flat(p_out)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = diff.max().item()
        # Long sums are held as |err| <= tol * (1 + |ref|): one bf16
        # rounding step of a GEMM output of magnitude 4-8 is 0.03.  Small
        # outputs (attention over thousands of keys, RMS ~0.03) are held
        # as |err| <= tol * max|ref|, prefill attention row by row (each
        # query row to its own max|ref|: row 0 is a value row of magnitude
        # ~3, so the whole output's max would pass a lost tile of keys).
        if long_sums:
            scaled = (diff / (1 + ref.abs())).max().item()
        elif per_row:
            scaled = row_scaled_error(k_out, p_out)
        elif to_max_ref:
            scaled = err / ref.abs().max().item()
        else:
            scaled = err
        finite = bool(torch.isfinite(out).all().item())
        del k_out, p_out, out, ref, diff
        ms, call_ms = time_ms(kernel)
        g_ms = graph_ms(kernel) if graph else None
        plain_ms = time_ms(plain, reps=plain_reps,
                           inner=min(10, plain_reps), prime=plain_prime)[0]
        lib_ms = time_ms(library)[0] if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S
        # `flops` is a count at the input type's peak, or a dict of counts
        # keyed by the peak (PEAK_FLOPS) of each.
        if not isinstance(flops, dict):
            flops = {dtype_name: flops}
        t_ops = sum(f / PEAK_FLOPS[kind] for kind, f in flops.items())
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        tol = (SUM_TOLERANCE if long_sums else TOLERANCE)[dtype_name]
        say(f"kernel {name} dtype={dtype_name} shape={shape} "
            f"kernel_ms={ms:.5f} call_ms={call_ms:.5f} "
            + (f"graph_ms={g_ms:.6f} " if graph else "")
            + f"plain_ms={plain_ms:.5f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
            f"bytes={int(nbytes)} flops="
            + "+".join(f"{kind}:{int(f)}" for kind, f in flops.items())
            + " "
            f"max_abs_err={err:.3e}"
            + (f" err_over_1_plus_ref={scaled:.3e}" if long_sums else "")
            + (f" err_over_max_ref={scaled:.3e}" if to_max_ref else "")
            + (f" err_over_row_max_ref={scaled:.3e}" if per_row else "")
            + f" tol={tol:g} finite={finite}")
        if not finite or not scaled <= tol:
            failures.append(f"{name} {dtype_name} {shape}: err={scaled} "
                            f"finite={finite}")
        if is_main:
            key = record_as or name
            main[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms}
            if graph:
                main[key]["graph_ms"] = g_ms
            if library_note is not None:
                main[key]["library_note"] = library_note

    def decode_case(dtype_name, b, s_len, lo, hi, h, kvh, d, is_main):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        q = rnd((b, h, d), dt)
        cache = rnd((2, 2, b, s_len, kvh, d), dt)
        k, v = cache[0, 1], cache[1, 1]
        lens = ints(lo, hi, b)
        starts = ints(0, 4, b) if s_len == MAX_SEQ_LEN else ints(0, 1, b)
        keys = int((lens - starts).sum())
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        idx = torch.arange(s_len, device=dev)
        mask = ((idx[None] >= starts[:, None].long())
                & (idx[None] < lens[:, None].long()))[:, None, None]
        check("decode_attention", dtype_name, (b, s_len, kvh, h // kvh, d),
              lambda: ops["decode_attention"].decode_attention(
                  q, k, v, lens, starts),
              lambda: ops["decode_attention"].decode_attention_ref(
                  q, k, v, lens, starts),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=mask, enable_gqa=True),
              (2 * q.numel() + 2 * keys * kvh * d) * e + 8 * b,
              4 * keys * h * d, is_main, to_max_ref=s_len == LONG_SEQ_LEN)

    def prefill_case(dtype_name, h, kvh, d, is_main, window=0,
                     b=MAX_BATCH, sq=PROMPT_LEN, softcap=0.0, scale=None,
                     prefix=0):
        """Prefill attention over `b` prompts of `sq` tokens, held row by
        row to the plain version.  The engine's prompts carry left pads
        (kv_start); the long ones do not.  With `prefix` slots, row i
        keeps keys [0, prefix) valid before its PREFIX_PADS[i] left pads
        (`prefix_len`; its inputs from a generator of its own, so the
        rows after it draw what they drew before it was added).  Over long prompts the plain
        version's [B, KVH, G, Sq, Sk] fp32 scores (~33 GB at llama's 4 x
        4000) are too large to run at batch b, so there it runs one prompt
        at a time for the comparison and is timed at batch 1 (3 windows of
        3 calls); the kernel and SDPA are timed at batch b.  A softcapped
        row's library call is `flex_attention` (`flex_library`): SDPA
        has no softcap."""
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        fa = ops["flash_attention"]
        long = sq > PROMPT_LEN and not prefix
        pre = None
        if prefix:
            own = torch.Generator(device=dev).manual_seed(prefix)
            q, k, v = (torch.randn(shape, generator=own, device=dev).to(dt)
                       for shape in ((b, sq, h, d), (b, sq, kvh, d),
                                     (b, sq, kvh, d)))
            pre = torch.full((b,), prefix, dtype=torch.int32, device=dev)
            starts = torch.tensor([prefix + p for p in PREFIX_PADS],
                                  dtype=torch.int32, device=dev)
        else:
            q, k, v = rnd((b, sq, h, d), dt), rnd((b, sq, kvh, d), dt), \
                rnd((b, sq, kvh, d), dt)
            starts = None if long else ints(0, 8, b)
        pos = torch.arange(sq, device=dev)
        mask = (pos[:, None] >= pos[None, :])[None]
        if window:
            mask = mask & (pos[None, None, :] > pos[None, :, None] - window)
        if starts is not None:
            valid = pos[None, None, :] >= starts[:, None, None].long()
            if pre is not None:
                valid = valid | (pos[None, None, :] < pre[:, None, None])
            mask = mask & valid
        pairs = int(mask.sum()) * (b // mask.shape[0])
        shape = (b, sq, kvh, h // kvh, d) + ((f"window {window}",)
                                             if window else ()) + (
            (f"softcap {softcap:g} scale {scale:.6f}",) if softcap else ()) \
            + ((f"prefix {prefix} pads {PREFIX_PADS}",) if prefix else ())
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if softcap:
            library = flex_library(torch, qt, kt, vt, scale, softcap, window,
                                   starts, shape)
        elif long and not window:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)

        def kernel():
            return fa.flash_attention(q, k, v, window=window,
                                      softcap=softcap, scale=scale,
                                      kv_start=starts, prefix_len=pre)

        def plain(lo=0, hi=1 if long else b):
            return fa.attention_ref(q[lo:hi], k[lo:hi], v[lo:hi],
                                    window=window, softcap=softcap,
                                    scale=scale, kv_start=starts,
                                    prefix_len=pre)
        check("flash_attention", dtype_name, shape, kernel, plain, library,
              (2 * q.numel() + 2 * k.numel()) * e + (0 if long else 4 * b)
              + (4 * b if prefix else 0),
              4 * pairs * h * d, is_main, per_row=True,
              compare=(kernel, lambda: torch.cat(
                  [plain(i, i + 1) for i in range(b)])) if long else None,
              plain_reps=3 if long else 15)
        if long:
            say(f"  (flash_attention {shape}: compared with the plain "
                f"version one prompt at a time; plain_ms is at batch 1, "
                f"kernel_ms and library_ms at batch {b})")

    def wkv6_case(dtype_name, s_len, chunk, is_main, b=MAX_BATCH):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        wk = ops["wkv6"]
        h, n = 40, 64
        shape = (b, s_len, h, n)
        r, k, v, logw, u, st0 = wkv6_inputs(torch, gen, shape, dt)
        # Calls take turns over 4 copies of the 18.4 MB state (73 MB, more
        # than the 50 MB L2), so each finds its state cold, as a layer's
        # decode step does after the other 31 layers' weights went by.  The
        # kernel updates its copy in place; the first call of each side
        # starts from st0.
        kernel_states = itertools.cycle([st0.clone() for _ in range(4)])
        plain_states = itertools.cycle([st0.clone() for _ in range(4)])

        def kernel():
            return wk.wkv6(r, k, v, logw, u, next(kernel_states),
                           chunk=chunk)

        def plain():
            st = next(plain_states)
            if s_len == 1:
                return wk.wkv6_step_ref(r, k, v, logw, u, st)
            return wk.wkv6_chunked_ref(r, k, v, logw, u, st, chunk)
        nbytes = 3 * r.numel() * e + 2 * 4 * r.numel() + 4 * u.numel() \
            + 2 * 4 * st0.numel()
        shape_note = (b, s_len, h, n, f"chunk {chunk}")
        long = s_len > MAX_SEQ_LEN
        if chunk > 1:
            plan = wk.chunk_plan(b, h, n, e, r.stride(), True)
            shape_note += (f"{plan.ctas} CTAs of {plan.threads}",)
        check("wkv6", dtype_name, shape_note,
              kernel, plain, None, nbytes,
              wkv6_flops(b, s_len, h, n, chunk, e == 2), is_main,
              long_sums=True, library_note=WKV6_LIBRARY_NOTE,
              plain_reps=3 if long else 15, plain_prime=not long)
        if long:
            say(f"  (wkv6 {shape_note[:4]}: plain_ms is the plain "
                f"version's call time; its ~1,600 launches a call overrun "
                f"the launch queue, so no primed window holds them)")

    def rglru_case(s_len):
        """The plain front end from fp32 log_a and b."""
        rg = ops["rglru"]
        b, w = MAX_BATCH, 4096
        shape = (b, s_len, w)
        f32 = torch.float32
        # The model's decay range: log_a = -8 softplus(lambda) r with
        # lambda from the reference's init and r a sigmoid gate.
        lam = rglru_lambda(torch, gen, w)
        sets = [(-8.0 * F.softplus(lam) * torch.sigmoid(rnd(shape, f32)),
                 rnd(shape, f32), rnd((b, w), f32)) for _ in range(4)]
        # Calls take turns over 4 input sets (59 MB at the prefill shape,
        # more than the 50 MB L2), so each reads its inputs from device
        # memory, as the bound counts them.  The kernel overwrites its
        # state, so it gets copies; the first call of each side is on set
        # 0 from its h0.
        kernel_sets = itertools.cycle([(la, bb, h0.clone())
                                       for la, bb, h0 in sets])
        plain_sets = itertools.cycle(sets)
        plain = rg.rglru_step_ref if s_len == 1 else rg.rglru_assoc_ref
        n = b * s_len * w
        check("rglru", "float32", shape,
              lambda: rg.rglru(*next(kernel_sets)),
              lambda: plain(*next(plain_sets)), None,
              3 * n * 4 + 2 * b * w * 4,
              3 * n, False, long_sums=True,
              library_note=RGLRU_LIBRARY_NOTE, graph=s_len == 1)

    def rglru_gated_case(s_len, b=MAX_BATCH):
        """The gated front end, as recurrentgemma-9b's blocks run it: bf16
        za = y @ w_a, zi = y @ w_i and y, fp32 b_a, b_i and lambda, held to
        `rglru_gates_ref` then the step or the associative scan."""
        rg = ops["rglru"]
        w = 4096
        shape = (b, s_len, w)
        f32, bf16 = torch.float32, torch.bfloat16
        vectors = (0.5 * rnd((w,), f32), 0.5 * rnd((w,), f32),
                   rglru_lambda(torch, gen, w))
        # 4 input sets in turn (44 MB at the prefill shape), the kernel's
        # states copies, as in rglru_case.
        sets = [(rnd(shape, bf16), rnd(shape, bf16), rnd(shape, bf16),
                 *vectors, rnd((b, w), f32)) for _ in range(4)]
        kernel_sets = itertools.cycle([(*st[:-1], st[-1].clone())
                                       for st in sets])
        plain_sets = itertools.cycle(sets)
        step = rg.rglru_step_ref if s_len == 1 else rg.rglru_assoc_ref

        def plain():
            *inputs, h0 = next(plain_sets)
            return step(*rg.rglru_gates_ref(*inputs), h0)
        n = b * s_len * w
        # Bytes: za, zi, y (bf16) and the three [W] vectors read, h
        # written (fp32), the state read and written.  Operations: the
        # gates, a, b and the step, 18 an element, at fp32's peak.
        plan = rg.launch_plan(b, s_len, w, sets[0][0].stride(), True)
        check("rglru_gated", "float32",
              shape + (f"za/zi/y bf16, {plan.ctas} CTAs of "
                       f"{rg.CTA_THREADS}",),
              lambda: rg.rglru_gated(*next(kernel_sets)), plain, None,
              3 * n * 2 + 3 * w * 4 + n * 4 + 2 * b * w * 4,
              18 * n, s_len == 1 and b == MAX_BATCH, long_sums=True,
              library_note=RGLRU_LIBRARY_NOTE, graph=s_len == 1,
              record_as="rglru")

    def wkv6_bwd_case(dtype_name, is_main):
        """WKV6's backward kernel at rwkv6-3b's training shape (phase
        12(e): B 8 x S 512, 40 x 64 heads; the forward's chunk 32) from a
        nonzero initial state: dr, dk, dv, dlogw and dbonus held to
        autograd of the chunked plain version (`wkv6_bwd_ref`) as
        |err| <= SUM_TOLERANCE (1 + |ref|), the same bits on two calls,
        timed beside the plain backward (call time: its ~2,000 launches a
        call overrun the launch queue, so no primed window holds them).
        Bytes: r, k, v (the type), logw, dy, bonus and the state (fp32)
        read; dr, dk, dv, dlogw and dbonus written.  Operations: those of
        the same gradients in chunked form on tensor cores
        (`wkv6_bwd_flops`), not the kernel's 12 N^2 fp32 a step and head:
        the bound is the least the card could take."""
        wk = ops["wkv6"]
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        b, s, h, n = TRAIN_BATCH, TRAIN_SEQ, 40, 64
        shape = (b, s, h, n)
        r, k, v, logw, u, st0 = wkv6_inputs(torch, gen, shape, dt)
        dy = rnd(shape, torch.float32)
        m = r.numel()
        nbytes = 6 * m * e + 3 * 4 * m + 2 * 4 * u.numel() + 4 * st0.numel()
        plan = wk.bwd_plan(b, s, h, n, e, r.stride(), True)
        per_sm = wk.bwd_ctas_an_sm(dt, n, plan.staging)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        note = shape + ("forward chunk 32",
                        f"{plan.ctas} CTAs of {plan.threads}, {plan.chunks} "
                        f"chunks of {wk.BWD_CHUNK} twice, {plan.staging}, "
                        f"{per_sm} an SM by the built kernel's occupancy, "
                        f"{-(-plan.ctas // (per_sm * sms))} wave(s) on "
                        f"{sms} SMs", "nonzero initial state")
        check("wkv6_bwd", dtype_name, note,
              lambda: wk.wkv6_backward(dy, r, k, v, logw, u, st0),
              lambda: wk.wkv6_bwd_ref(dy, r, k, v, logw, u, st0, 32), None,
              nbytes, wkv6_bwd_flops(b, s, h, n, 32, e == 2), is_main,
              long_sums=True, library_note=WKV6_LIBRARY_NOTE,
              plain_reps=3, plain_prime=False)
        same_bits("wkv6_bwd", dtype_name, note,
                  lambda: wk.wkv6_backward(dy, r, k, v, logw, u, st0))
        del r, k, v, logw, dy, st0
        torch.cuda.empty_cache()

    def rglru_bwd_case(dtype_name, is_main):
        """The gated RG-LRU's backward kernel at recurrentgemma-9b's
        training shape (phase 12(f): B 8 x S 512 x W 4096) from a nonzero
        initial state and the forward kernel's h: dza, dzi, dy and the
        per-channel sums held to autograd of `rglru_gates_ref` and the
        associative scan (`rglru_gated_bwd_ref`) to SUM_TOLERANCE, the
        same bits on two calls, timed beside the plain backward (call
        time, as WKV6's).  Bytes: za, zi, y (the type), h and dh (fp32),
        h0 and the [W] vectors read; dza, dzi, dy and the three sums
        written.  Operations: ~40 fp32 an element."""
        rg = ops["rglru"]
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        b, s, w = TRAIN_BATCH, TRAIN_SEQ, 4096
        shape = (b, s, w)
        f32 = torch.float32
        za, zi, y, vectors, h0 = rglru_gated_inputs(torch, gen, shape, dt)
        h, _ = rg.rglru_gated(za, zi, y, *vectors, h0.clone())
        dh = rnd(shape, f32)
        m = b * s * w
        plan = rg.bwd_plan(b, s, w, rg.sm_count(za.device))
        note = shape + (f"za/zi/y {dtype_name}, {plan.chunks} chunks of "
                        f"{plan.chunk} steps, {plan.launches} launches, "
                        f"{plan.ctas} CTAs of {rg.CTA_THREADS}, a thread a "
                        f"channel of a chunk", "nonzero initial state")
        check("rglru_bwd", dtype_name, note,
              lambda: rg.rglru_gated_backward(dh, za, zi, y, *vectors, h0,
                                              h),
              lambda: rg.rglru_gated_bwd_ref(dh, za, zi, y, *vectors, h0),
              None, 6 * m * e + 2 * 4 * m + 4 * b * w + 6 * 4 * w,
              {"float32": 40 * m}, is_main, long_sums=True,
              library_note=RGLRU_LIBRARY_NOTE, plain_reps=3,
              plain_prime=False)
        same_bits("rglru_bwd", dtype_name, note,
                  lambda: rg.rglru_gated_backward(dh, za, zi, y, *vectors,
                                                  h0, h))
        del za, zi, y, h, dh
        torch.cuda.empty_cache()

    def sum_check(name, dtype_name, shape, out, ref):
        """A column sum (dscale) held as the long sums are: |err| <=
        SUM_TOLERANCE * (1 + |ref|)."""
        out, ref = out.float(), ref.float()
        scaled = ((out - ref).abs() / (1 + ref.abs())).max().item()
        tol = SUM_TOLERANCE[dtype_name]
        say(f"kernel {name} dtype={dtype_name} shape={shape} "
            f"err_over_1_plus_ref={scaled:.3e} tol={tol:g}")
        if not scaled <= tol:
            failures.append(f"{name} {dtype_name} {shape}: err={scaled}")

    def rmsnorm_bwd_one_launch():
        """RMSNorm's backward is one kernel a call, dx and dscale both: one
        call at each of phase 2's training rows, bf16 and fp32, in one
        profiled window before anything else of phase 2 runs (a window
        opened after the timing loops below recorded no device events on
        this machine), each call seen as one `rmsnorm_bwd_kernel`."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        rms = ops["rmsnorm"]
        calls = []
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            for shape in ((TRAIN_BATCH, TRAIN_SEQ, 2048),
                          (TRAIN_BATCH, TRAIN_SEQ, 16, 128)):
                x, s, dy = rnd(shape, dt), rnd(shape[-1:], dt, 0.1), \
                    rnd(shape, dt)
                calls.append((dtype_name, shape, x, s, dy))
                rms.rmsnorm_backward(dy, x, s)      # built and ticketed
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _, _, x, s, dy in calls:
                rms.rmsnorm_backward(dy, x, s)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and not ev.is_user_annotation]
        say(f"  (rmsnorm_bwd: {len(calls)} calls, bf16 and fp32 at "
            f"{[c[1] for c in calls[:2]]}, run {len(names)} kernels: "
            f"{[n.split('(')[0] for n in names]})")
        if len(names) != len(calls) or not all(
                "rmsnorm_bwd_kernel" in n for n in names):
            failures.append(f"rmsnorm_bwd: {len(calls)} calls ran "
                            f"{len(names)} kernels: {names}")

    def same_bits(name, dtype_name, shape, fn):
        """Two calls of `fn` on the same inputs give the same bits."""
        a, b = flat(fn()), flat(fn())
        if not torch.equal(a, b):
            failures.append(f"{name} {dtype_name} {shape}: two calls differ")

    def rmsnorm_bwd_case(dtype_name, rows_shape, is_main):
        """RMSNorm's backward kernel (dx and dscale) held to autograd of
        the plain forward; timed beside the written-out plain backward and
        autograd's backward of `F.rms_norm`."""
        rms = ops["rmsnorm"]
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        width = rows_shape[-1]
        x, s = rnd(rows_shape, dt), rnd((width,), dt, 0.1)
        dy = rnd(rows_shape, dt)

        def autograd_plain():
            xr, sr = x.detach().requires_grad_(), s.detach().requires_grad_()
            return torch.autograd.grad(rms.rmsnorm_ref(xr, sr), (xr, sr), dy)
        xl = x.detach().requires_grad_()
        wl = (1.0 + s).detach().requires_grad_()
        yl = F.rms_norm(xl, (width,), wl, 1e-6)
        n = x.numel()
        plan = rms.bwd_plan(n // width, width, e, width, width, True,
                            rms.sm_count(x.device))
        shape = rows_shape + (f"one launch: {plan.ctas} CTAs of "
                              f"{plan.threads}, {plan.lanes} lanes x "
                              f"{plan.items * plan.vec} values a row, "
                              f"groups of {plan.group}",)
        # dx is held to phase 2's tolerance, dscale (a sum over every row)
        # to SUM_TOLERANCE.  Bytes: x and dy read, dx written, scale read,
        # dscale written; ~12 fp32 operations an element.
        check("rmsnorm_bwd", dtype_name, shape,
              lambda: rms.rmsnorm_backward(dy, x, s),
              lambda: rms.rmsnorm_bwd_ref(dy, x, s),
              lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                          retain_graph=True),
              (3 * n + 2 * width) * e, {"float32": 12 * n}, is_main,
              compare=(lambda: rms.rmsnorm_backward(dy, x, s)[0],
                       lambda: autograd_plain()[0]))
        sum_check("rmsnorm_bwd dscale", dtype_name, shape,
                  rms.rmsnorm_backward(dy, x, s)[1], autograd_plain()[1])
        same_bits("rmsnorm_bwd", dtype_name, shape,
                  lambda: rms.rmsnorm_backward(dy, x, s))
        del x, dy, xl, wl, yl

    def gemm_bwd_case(dtype_name, c, k_dim, n_dim, is_main):
        """The grouped GEMM's backward, dx = dy w^T and dw = x^T dy, each
        held to autograd of `moe_gemm_ref`; timed beside the written-out
        plain backward and `torch.bmm` on transposed views.  In bf16 both
        read their operands in place (no transposed copy may be launched);
        in fp32 each runs on a transposed copy (`transpose_pad`), whose
        time is printed alone.  The forward at the same shapes too."""
        mg = ops["moe_gemm"]
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        is_bf16 = dtype_name == "bfloat16"
        x = rnd((64, c, k_dim), dt)
        wf = torch.empty((64, k_dim, n_dim), device=dev)
        torch.nn.init.trunc_normal_(wf, std=1.0, a=-2.0, b=2.0, generator=gen)
        w = (wf / k_dim ** 0.5).to(dt)
        del wf
        dy = rnd((64, c, n_dim), dt, 0.1)

        def autograd_plain(i):
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            return torch.autograd.grad(mg.moe_gemm_ref(xr, wr), (xr, wr),
                                       dy)[i]
        flops = 2 * 64 * c * k_dim * n_dim
        if not is_bf16:
            flops = {"tf32": 3 * flops}
        nbytes = (x.numel() + w.numel() + dy.numel()) * e
        note = (64, c, k_dim, n_dim)
        sms = mg.sm_count(x.device)
        dx_note = dw_note = ("transposed copy",)
        if is_bf16:
            px = mg.bwd_plan(64, c, k_dim, sms)
            pw = mg.bwd_plan(64, k_dim, n_dim, sms)
            dx_note = (f"in place, {px.tiles} tiles of {mg.BWD_ROWS} x "
                       f"{mg.BWD_COLS} on {px.ctas} CTAs",)
            dw_note = (f"in place, {pw.tiles} tiles of {mg.BWD_ROWS} x "
                       f"{mg.BWD_COLS} on {pw.ctas} CTAs",)
        copies = mg.transpose_launches
        check("moe_gemm_dx", dtype_name, note + ("dy @ w^T",) + dx_note,
              lambda: mg.grouped_gemm_dx(dy, w),
              lambda: mg.moe_gemm_dx_ref(dy, w),
              lambda: torch.bmm(dy, w.transpose(1, 2)), nbytes, flops,
              is_main, long_sums=True,
              compare=(lambda: mg.grouped_gemm_dx(dy, w),
                       lambda: autograd_plain(0)))
        check("moe_gemm_dw", dtype_name, note + ("x^T @ dy",) + dw_note,
              lambda: mg.grouped_gemm_dw(x, dy),
              lambda: mg.moe_gemm_dw_ref(x, dy),
              lambda: torch.bmm(x.transpose(1, 2), dy), nbytes, flops,
              is_main, long_sums=True,
              compare=(lambda: mg.grouped_gemm_dw(x, dy),
                       lambda: autograd_plain(1)))
        same_bits("moe_gemm_dx", dtype_name, note,
                  lambda: mg.grouped_gemm_dx(dy, w))
        same_bits("moe_gemm_dw", dtype_name, note,
                  lambda: mg.grouped_gemm_dw(x, dy))
        torch.cuda.synchronize()
        if is_bf16 and mg.transpose_launches != copies:
            failures.append(f"moe_gemm_dx/dw bf16 {note}: "
                            f"{mg.transpose_launches - copies} transposed "
                            f"copies launched")
        # The forward at training's capacity (C = 640: three 256-row
        # blocks of the bf16 prefill variant).
        check("moe_gemm", dtype_name, note + ("forward, training capacity",),
              lambda: mg.grouped_gemm(x, w), lambda: mg.moe_gemm_ref(x, w),
              lambda: torch.bmm(x, w),
              (x.numel() + w.numel() + dy.numel()) * e, flops, False,
              long_sums=True)
        if not is_bf16:
            # The fp32 route's transposed copies alone, dx's of w and dw's
            # of x (its capacity padded with zero rows to a multiple of
            # 8), each held to the same copy made by PyTorch: a read and a
            # write of the operand.
            c8 = -(-c // 8) * 8
            check("moe_gemm_transpose", dtype_name, (64, k_dim, n_dim, "w^T"),
                  lambda: mg.transpose_pad(w, k_dim),
                  lambda: w.transpose(1, 2).contiguous(), None,
                  2 * w.numel() * e, 0, False)
            check("moe_gemm_transpose", dtype_name, (64, c, k_dim, "x^T"),
                  lambda: mg.transpose_pad(x, c8),
                  lambda: F.pad(x.transpose(1, 2), (0, c8 - c)).contiguous(),
                  None, (x.numel() + 64 * k_dim * c8) * e, 0, False)
        del x, w, dy
        torch.cuda.empty_cache()

    rmsnorm_bwd_one_launch()
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        is_bf16 = dtype_name == "bfloat16"

        # RMSNorm: prefill rows (28 x 16) and decode rows (28) at llama's
        # and olmoe's d 2048 and recurrentgemma's d 4096, and olmoe's
        # qk-norm rows (28 x 16 tokens x 16 heads, 128 wide).
        for rows_shape in ((MAX_BATCH, PROMPT_LEN, 2048), (MAX_BATCH, 2048),
                           (MAX_BATCH, PROMPT_LEN, 4096), (MAX_BATCH, 4096),
                           (MAX_BATCH, PROMPT_LEN, 16, 128)):
            width = rows_shape[-1]
            x, s = rnd(rows_shape, dt), rnd((width,), dt, 0.1)
            w = 1.0 + s
            n = x.numel()
            check("rmsnorm", dtype_name, rows_shape,
                  lambda: ops["rmsnorm"].rmsnorm(x, s),
                  lambda: ops["rmsnorm"].rmsnorm_ref(x, s),
                  lambda: F.rms_norm(x, (width,), w, 1e-6),
                  (2 * n + width) * e, 4 * n,
                  is_bf16 and rows_shape == (MAX_BATCH, PROMPT_LEN, 2048))

        # RMSNorm's backward at the training rows of phase 12: llama's
        # B 8 x S 512 tokens of d_model 2048 and olmoe's qk-norm rows
        # (the same tokens x 16 heads, 128 wide).
        for rows_shape in ((TRAIN_BATCH, TRAIN_SEQ, 2048),
                           (TRAIN_BATCH, TRAIN_SEQ, 16, 128)):
            rmsnorm_bwd_case(dtype_name, rows_shape,
                             is_bf16 and rows_shape[-1] == 2048)

        # Decode attention: llama (32/8 heads x 64) at batch 4 and 28 over
        # the engine's 128-slot cache (a layer slice of the stacked cache)
        # and over a full 4096-slot cache (batch 4: 8 KV splits and the
        # combine kernel; batch 28: one split); olmoe (16/16 x 128) at
        # batch 28.
        for b, s_len, lo, hi in ((4, MAX_SEQ_LEN, 16, 25),
                                 (MAX_BATCH, MAX_SEQ_LEN, 16, 25),
                                 (4, LONG_SEQ_LEN, LONG_SEQ_LEN,
                                  LONG_SEQ_LEN + 1),
                                 (MAX_BATCH, LONG_SEQ_LEN, LONG_SEQ_LEN,
                                  LONG_SEQ_LEN + 1)):
            decode_case(dtype_name, b, s_len, lo, hi, 32, 8, 64,
                        is_bf16 and b == MAX_BATCH and s_len == MAX_SEQ_LEN)
        decode_case(dtype_name, MAX_BATCH, MAX_SEQ_LEN, 16, 25, 16, 16, 128,
                    False)

        # Prefill attention: 28 x 16 tokens with left pads, the llama and
        # olmoe geometries and recurrentgemma's (MQA at head_dim 256 under
        # its 2048 window, which 16 tokens do not reach).
        prefill_case(dtype_name, 32, 8, 64, is_bf16)
        prefill_case(dtype_name, 16, 16, 128, False)
        prefill_case(dtype_name, 16, 1, 256, False, window=2048)
        # phi-3-vision's heads with a prefix before left pads.
        prefill_case(dtype_name, 32, 32, 96, False, b=len(PREFIX_PADS),
                     sq=PREFIX_LEN + PREFIX_PADS[-1] + 17, prefix=PREFIX_LEN)
        if is_bf16:
            # Continuous batching's admission: one left-padded 16-token
            # row at a time (phase 7), at each path's heads.
            prefill_case(dtype_name, 32, 8, 64, False, b=1)
            prefill_case(dtype_name, 16, 16, 128, False, b=1)
            prefill_case(dtype_name, 16, 1, 256, False, window=2048, b=1)
            # Phase 6's long prompts (llama heads, causal, 4 x 4000) and
            # recurrentgemma's heads at that length, where its 2048 window
            # skips whole key tiles.
            prefill_case(dtype_name, 32, 8, 64, False, b=LONG_BATCH,
                         sq=LONG_PROMPT)
            prefill_case(dtype_name, 16, 1, 256, False, window=2048,
                         b=LONG_BATCH, sq=LONG_PROMPT)
            torch.cuda.empty_cache()
            family_rows(dtype_name, decode_case, prefill_case, check, rnd)

        # Grouped expert GEMM at olmoe-1b-7b's products: decode gate/up and
        # down (64 experts x capacity 8), prefill gate/up and down at batch
        # 28 (capacity 8 per row, 224 rows an expert), prefill gate/up
        # at batch 4 (32 rows) and at 300 rows an expert (a longer prompt's
        # capacity: past 256 rows the bf16 kernel takes a second row block
        # and reads w again).  Weights scaled as moe_init scales them
        # (truncated normal / sqrt(K)).
        for c, k_dim, n_dim in ((8, 2048, 1024), (8, 1024, 2048),
                                (MAX_BATCH * 8, 2048, 1024),
                                (MAX_BATCH * 8, 1024, 2048),
                                (4 * 8, 2048, 1024), (300, 2048, 1024)):
            x = rnd((64, c, k_dim), dt)
            wf = torch.empty((64, k_dim, n_dim), device=dev)
            torch.nn.init.trunc_normal_(wf, std=1.0, a=-2.0, b=2.0,
                                        generator=gen)
            w = (wf / k_dim ** 0.5).to(dt)
            del wf
            mg = ops["moe_gemm"]
            shape_note = (64, c, k_dim, n_dim)
            if is_bf16 and c <= mg.DECODE_ROWS:
                plan = mg.decode_plan(64, c, k_dim, n_dim,
                                      mg.sm_count(x.device))
                shape_note += (f"{plan.units} units of "
                               f"{mg.DECODE_COLUMNS} columns on "
                               f"{plan.ctas} CTAs",)
            # The fp32 tile (C > 8) computes on the tensor cores in
            # 3xTF32: three TF32 products for each fp32 one.
            flops = 2 * 64 * c * k_dim * n_dim
            if not is_bf16 and c > mg.DECODE_ROWS:
                flops = {"tf32": 3 * flops}
            check("moe_gemm", dtype_name, shape_note,
                  lambda: mg.grouped_gemm(x, w),
                  lambda: mg.moe_gemm_ref(x, w),
                  lambda: torch.bmm(x, w),
                  (x.numel() + w.numel() + 64 * c * n_dim) * e,
                  flops, is_bf16 and (c, k_dim) == (8, 2048), long_sums=True)
            del x, w

        # Its backward at olmoe's training shapes (phase 12(d)): B 8 x
        # S 512 at capacity ceil(1.25 x 512 x 8 / 64) = 80 a row, 640 rows
        # an expert; gate/up and down.
        train_c = TRAIN_BATCH * 80
        gemm_bwd_case(dtype_name, train_c, 2048, 1024, is_bf16)
        gemm_bwd_case(dtype_name, train_c, 1024, 2048, False)

        # WKV6 at rwkv6-3b's heads (40 x 64) from a nonzero state: the
        # chunked prefill at batch 28 (64 tokens, chunk 32), a long prompt
        # at batch 4 (2048 tokens: 64 chunks, where staging the next chunk
        # while one computes matters) and the decode step at batch 28.
        # The kernel computes in fp32 whatever the input type.
        # A one-row admission prefill (phase 7) runs the chunked form at
        # batch 1; training (phase 12(e)) at rwkv6-3b's B 8 x S 512.
        for s_len, chunk, b in ((64, 32, MAX_BATCH),
                                (WKV6_LONG_PROMPT, 32, LONG_BATCH),
                                (64, 32, 1), (1, 1, MAX_BATCH)):
            wkv6_case(dtype_name, s_len, chunk, is_bf16 and s_len == 1,
                      b=b)
        own_stream(TRAIN_SEQ, wkv6_case, dtype_name, TRAIN_SEQ, 32, False,
                   b=TRAIN_BATCH)

        # The training backward of WKV6 and of the gated RG-LRU at
        # rwkv6-3b's and recurrentgemma-9b's training shapes (phase 12(e)
        # and (f)).
        wkv6_bwd_case(dtype_name, is_bf16)
        rglru_bwd_case(dtype_name, is_bf16)

    # The RG-LRU kernel at recurrentgemma-9b's width (4096) and batch 28:
    # the prompt's scan (16 tokens) and the decode step, through the plain
    # front end (fp32) and the gated one (bf16 pre-activations), whose
    # decode row is the kernel's record: the main path runs it.
    for s_len in (PROMPT_LEN, 1):
        rglru_case(s_len)
        rglru_gated_case(s_len)
    rglru_gated_case(PROMPT_LEN, b=1)        # a one-row admission prefill
    # Training's forward (phase 12(f)): recurrentgemma-9b's B 8 x S 512.
    own_stream(TRAIN_SEQ, rglru_gated_case, TRAIN_SEQ, b=TRAIN_BATCH)
    if failures:
        fail("kernel != plain version: " + "; ".join(failures))
    return main


#: The transformer family's heads on phase 2's rows: (path, H, KVH, D).
FAMILY_HEADS = (("qwen2-1.5b", 12, 2, 128), ("qwen2.5-3b", 16, 2, 128),
                ("smollm-360m", 15, 5, 64), ("starcoder2-7b", 36, 4, 128),
                ("phi-3-vision-4.2b", 32, 32, 96))
#: The family's RMSNorm widths (starcoder2's LayerNorm has no kernel).
FAMILY_NORM_WIDTHS = (1536, 960, 3072, 4608)
#: Continuous admission's one-row prefill: RMSNorm over its 16 tokens at
#: d 2048 (llama, olmoe) and 4096 (recurrentgemma), and olmoe's qk-norm
#: over 16 tokens x 16 heads of 128.
ADMISSION_NORM_ROWS = ((1, PROMPT_LEN, 2048), (1, PROMPT_LEN, 4096),
                       (1, PROMPT_LEN, 16, 128))


def family_rows(dtype_name, decode_case, prefill_case, check, rnd):
    """Phase 2's rows of the transformer family, in bf16 (the paths' type):
    decode attention at batch 28 over the 128-slot cache and prefill
    attention over 28 x 16 tokens at each new path's heads, decode
    attention at qwen2-1.5b's heads over phase 6's 4096-slot cache at
    batch 4, gemma2-27b's prefill (softcap, query scale, window 4096) over
    28 x 16 and 4 x 4000 tokens, RMSNorm at each new width, and the
    admission's RMSNorm rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms
    for _, h, kvh, d in FAMILY_HEADS:
        decode_case(dtype_name, MAX_BATCH, MAX_SEQ_LEN, 16, 25, h, kvh, d,
                    False)
        prefill_case(dtype_name, h, kvh, d, False)
    # Phase 6's decode attention: qwen2-1.5b's heads at batch 4 over the
    # full 4096-slot cache (its split plan and the combine kernel).
    decode_case(dtype_name, LONG_BATCH, LONG_SEQ_LEN, LONG_SEQ_LEN,
                LONG_SEQ_LEN + 1, 12, 2, 128, False)
    prefill_case(dtype_name, 32, 16, 128, False, window=4096,
                 softcap=GEMMA2_SOFTCAP, scale=GEMMA2_SCALE)
    prefill_case(dtype_name, 32, 16, 128, False, window=4096,
                 softcap=GEMMA2_SOFTCAP, scale=GEMMA2_SCALE, b=LONG_BATCH,
                 sq=LONG_PROMPT)
    torch.cuda.empty_cache()
    dt = getattr(torch, dtype_name)
    e = torch.tensor([], dtype=dt).element_size()
    rows = [(MAX_BATCH, w) for w in FAMILY_NORM_WIDTHS] + \
        [(MAX_BATCH, PROMPT_LEN, w) for w in FAMILY_NORM_WIDTHS] + \
        list(ADMISSION_NORM_ROWS)
    for rows_shape in rows:
        width = rows_shape[-1]
        x, s = rnd(rows_shape, dt), rnd((width,), dt, 0.1)
        w = 1.0 + s
        n = x.numel()
        check("rmsnorm", dtype_name, rows_shape,
              lambda: rms.rmsnorm(x, s), lambda: rms.rmsnorm_ref(x, s),
              lambda: F.rms_norm(x, (width,), w, 1e-6),
              (2 * n + width) * e, 4 * n, False)


#: Compiled `flex_attention`, made once (None until the first softcapped
#: row; False where it does not compile).
_FLEX = {}


def flex_library(torch, qt, kt, vt, scale, softcap, window, starts, shape):
    """The library call of a softcapped prefill row: `flex_attention`
    (compiled) with `softcap * tanh(s / softcap)` as its score_mod and the
    causal window and left pads as its block mask, on [B, H, S, D] views.
    Returns None, and says why, where it does not compile here."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        if "fn" not in _FLEX:
            _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
        fn = _FLEX["fn"]

        def score_mod(score, b, h, qi, ki):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b, h, qi, ki):
            m = (ki <= qi) & (qi - ki < window)
            if starts is not None:
                m = m & (ki >= starts[b])
            return m
        bq, _, sq, _ = qt.shape
        mask = create_block_mask(mask_mod, bq, None, sq, kt.shape[2],
                                 device=qt.device)

        def library():
            return fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      scale=scale, enable_gqa=True)
        t0 = time.monotonic()
        library()
        torch.cuda.synchronize()
        say(f"  (flash_attention {shape}: library call flex_attention with "
            f"a tanh score_mod, compiled in {time.monotonic() - t0:.2f} s)")
        return library
    except Exception as e:      # the library call alone; the kernel is held
        say(f"  (flash_attention {shape}: library_ms null: flex_attention "
            f"did not compile here: {type(e).__name__}: {str(e)[:160]})")
        return None


# ---------------------------------------------------------------------------
# Phase 3: flash vs naive at model level, fp32
# ---------------------------------------------------------------------------

def _run_narrow(torch, rt, cfg, params, toks, mask, feed, steps, device,
                max_len=None, with_cache=False):
    """Prefill + `steps` decode steps on `device` into a cache built for
    `max_len` (default: the prompt + 16); decode feeds `feed[i]` when
    given, else appends the greedy token to `feed`.  Logits [steps+1, B, V]
    on the CPU, and the final cache too `with_cache`."""
    b, plen = toks.shape
    max_len = max_len or plen + 16
    dmask = torch.ones((b, max_len), dtype=torch.bool, device=device)
    dmask[:, :plen] = mask.to(device)
    bundle = rt.bundle_for(cfg)
    cache = bundle.init_cache(b, max_len, device)
    out, cache = bundle.prefill(params, toks.to(device), cache,
                                attn_mask=mask.to(device))
    seq = [out]
    for i in range(steps):
        if len(feed) <= i:
            feed.append(torch.argmax(seq[-1], dim=-1).cpu())
        out, cache = bundle.decode_step(params, feed[i].to(device), cache,
                                        plen + i, attn_mask=dmask)
        seq.append(out)
    logits = torch.stack(seq).cpu()
    return (logits, cache) if with_cache else logits


def model_check(torch, rt):
    """fp32 narrow models: flash (kernels) vs naive logits on the card, and
    for olmoe the same weights on the card vs on the CPU (plain
    versions)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    narrow = {k: v for k, v in narrow_configs(torch, rt).items()
              if k in ("llama", "olmoe")}
    b, plen, steps = 4, 16, 4
    pads = torch.tensor([0, 3, 7, 15])
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(1, 1024, (b, plen), generator=rng)
    mask = torch.arange(plen)[None] >= pads[:, None]
    toks = torch.where(mask, toks, torch.zeros_like(toks))
    for label, base in narrow.items():
        feed = []          # the naive run's greedy tokens, fed to every run
        logits = {}
        params = rt.bundle_for(base).init_params(0, "cuda")
        for impl in ("naive", "flash"):
            cfg = dataclasses.replace(base, attn_impl=impl)
            logits[impl] = _run_narrow(torch, rt, cfg, params, toks, mask,
                                       feed, steps, "cuda")
        diff = (logits["flash"] - logits["naive"]).abs().max().item()
        finite = bool(torch.isfinite(logits["flash"]).all().item())
        geo = (f"{base.n_layers}L, d{base.d_model}, {base.n_heads}H/"
               f"{base.n_kv_heads}KV x {base.head_dim}")
        if base.moe is not None:
            geo += f", {base.moe.n_experts} experts top-{base.moe.top_k}"
        say(f"model fp32 {label} narrow ({geo}) flash-vs-naive "
            f"prefill+{steps} decode: max_abs_diff={diff:.3e} tol=1e-4 "
            f"finite={finite}")
        if not finite or not diff <= 1e-4:
            fail(f"{label}: flash and naive logits differ by {diff}")
        if base.moe is None:
            continue
        cpu_params = _tree_to(params, "cpu")
        cfg = dataclasses.replace(base, attn_impl="flash")
        on_cpu = _run_narrow(torch, rt, cfg, cpu_params, toks, mask, feed,
                             steps, "cpu")
        diff = (logits["flash"] - on_cpu).abs().max().item()
        say(f"model fp32 {label} narrow flash on the card (kernels) vs on "
            f"the CPU (plain versions): max_abs_diff={diff:.3e} tol=1e-4")
        if not diff <= 1e-4:
            fail(f"{label}: card and CPU logits differ by {diff}")


def rwkv6_check(torch, rt):
    """A narrow fp32 rwkv6 (40-token prefill: two chunks of 16 and an
    8-token tail, then 4 decode steps) on the card (the WKV6 kernel)
    against the same weights on the CPU (plain versions)."""
    cfg = narrow_configs(torch, rt)["rwkv6"]
    params = narrow_params(torch, rt, "rwkv6", cfg)
    b, plen, steps = 4, 40, 4
    pads = torch.tensor([0, 3, 9, 30])
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (b, plen), generator=rng)
    mask = torch.arange(plen)[None] >= pads[:, None]
    toks = torch.where(mask, toks, torch.zeros_like(toks))
    feed = []
    on_card = _run_narrow(torch, rt, cfg, params, toks, mask, feed, steps,
                          "cuda")
    on_cpu = _run_narrow(torch, rt, cfg, _tree_to(params, "cpu"), toks, mask,
                         feed, steps, "cpu")
    diff = (on_card - on_cpu).abs().max().item()
    finite = bool(torch.isfinite(on_card).all().item())
    say(f"model fp32 rwkv6 narrow ({cfg.n_layers}L, d{cfg.d_model}, "
        f"{cfg.n_heads}H x {cfg.head_dim}, chunk {cfg.chunk}) on the card "
        f"(kernels) vs on the CPU (plain versions), prefill {plen} "
        f"(2 chunks + 8-token tail) + {steps} decode: "
        f"max_abs_diff={diff:.3e} tol=1e-4 finite={finite}")
    if not finite or not diff <= 1e-4:
        fail(f"rwkv6: card and CPU logits differ by {diff}")


def rglru_model_check(torch, rt):
    """A narrow fp32 recurrentgemma over a left-padded 40-token prefill
    into a 16-slot ring (the prefill rolls it) and 8 decode steps that wrap
    it: flash (kernels) vs naive on the card, and flash on the card vs the
    same weights on the CPU (plain versions)."""
    import dataclasses
    base = narrow_configs(torch, rt)["recurrentgemma"]
    params = narrow_params(torch, rt, "recurrentgemma", base)
    b, plen, steps, max_len = 4, 40, 8, 64
    pads = torch.tensor([0, 3, 9, 30])
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(1, base.vocab_size, (b, plen), generator=rng)
    mask = torch.arange(plen)[None] >= pads[:, None]
    toks = torch.where(mask, toks, torch.zeros_like(toks))
    feed, logits = [], {}
    for impl in ("naive", "flash"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        logits[impl] = _run_narrow(torch, rt, cfg, params, toks, mask, feed,
                                   steps, "cuda", max_len)
    on_cpu = _run_narrow(torch, rt, cfg, _tree_to(params, "cpu"), toks, mask,
                         feed, steps, "cpu", max_len)
    ring = min(max_len, base.sliding_window)
    geo = (f"{base.n_layers} blocks {base.block_types}, d{base.d_model}, "
           f"lru {base.width}, {base.n_heads}H/{base.n_kv_heads}KV x "
           f"{base.head_dim}, window {base.sliding_window}, ring of {ring}")
    for label, a, ref in (("flash-vs-naive on the card", logits["flash"],
                           logits["naive"]),
                          ("flash on the card (kernels) vs on the CPU "
                           "(plain versions)", logits["flash"], on_cpu)):
        diff = (a - ref).abs().max().item()
        finite = bool(torch.isfinite(a).all().item())
        say(f"model fp32 recurrentgemma narrow ({geo}) {label}, prefill "
            f"{plen} + {steps} decode: max_abs_diff={diff:.3e} tol=1e-4 "
            f"finite={finite}")
        if not finite or not diff <= 1e-4:
            fail(f"recurrentgemma: {label}: logits differ by {diff}")


def narrow_configs(torch, rt):
    """Phase 3's narrow fp32 models, by label: llama3.2-1b's head geometry
    and olmoe-1b-7b's (qk-norm, untied head, 8 experts top-2 at capacity
    factor 8, as tests/test_models_decode_equiv.py sets it), a 2-layer
    rwkv6 at head_dim 64, and a 3-block recurrentgemma with a 16-slot
    attention window (a ring once the cache is longer)."""
    return {
        "llama": rt.transformer.TransformerConfig(
            name="llama-narrow", n_layers=2, d_model=512, n_heads=32,
            n_kv_heads=8, head_dim=64, d_ff=1024, vocab_size=1024,
            rope_theta=500000.0, dtype=torch.float32),
        "olmoe": rt.transformer.TransformerConfig(
            name="olmoe-narrow", n_layers=2, d_model=256, n_heads=4,
            n_kv_heads=4, head_dim=128, d_ff=512, vocab_size=1024,
            qk_norm=True, tie_embeddings=False,
            moe=rt.MoEConfig(n_experts=8, top_k=2, d_ff=512,
                             capacity_factor=8.0),
            dtype=torch.float32),
        "rwkv6": rt.rwkv6.RWKV6Config(
            name="rwkv6-narrow", n_layers=2, d_model=256, head_dim=64,
            d_ff=512, vocab_size=1024, lora_rank_decay=16, lora_rank_mix=8,
            chunk=16, dtype=torch.float32),
        "recurrentgemma": rt.rglru.RGLRUConfig(
            name="recurrentgemma-narrow", n_layers=3, d_model=256,
            n_heads=16, n_kv_heads=1, head_dim=256, d_ff=512,
            vocab_size=1024, lru_width=256, sliding_window=16,
            dtype=torch.float32),
    }


def family_narrow_configs(torch, rt):
    """Phase 3's narrow fp32 transformer-family models, by label, each at
    head dims the kernels take: qwen2 (q/k/v biases, 12/2 heads x 128, a
    decode group of 6), starcoder2 (LayerNorm, dense GELU MLP, biases,
    18/2 x 64, a group of 9), gemma2 (4 layers local/global, window 8 in
    a 64-slot cache so its local layers ring, softcaps 50 and 30,
    post-norms, the sqrt(d) embedding scale and a query scale), qwen2 with
    the int8 cache, phi-3 (4/4 heads x 96, 8 prefix embeddings) and
    mixtral-smoke's shape (4 experts top-2 at capacity factor 8 over ring
    local layers of window 8)."""
    tc = rt.transformer.TransformerConfig
    f32 = torch.float32
    qwen2 = tc(name="qwen2-narrow", n_layers=2, d_model=256, n_heads=12,
               n_kv_heads=2, head_dim=128, d_ff=512, vocab_size=1024,
               qkv_bias=True, rope_theta=1000000.0, dtype=f32)
    return {
        "qwen2": qwen2,
        "starcoder2": tc(
            name="starcoder2-narrow", n_layers=2, d_model=256, n_heads=18,
            n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1024,
            norm="layernorm", mlp_kind="dense", act="gelu_tanh",
            use_bias=True, dtype=f32),
        "gemma2": tc(
            name="gemma2-narrow", n_layers=4, d_model=256, n_heads=8,
            n_kv_heads=4, head_dim=128, d_ff=512, vocab_size=1024,
            act="gelu_tanh", attn_softcap=50.0, final_softcap=30.0,
            query_scale=(256 / 8) ** -0.5, embed_scale=True, post_norms=True,
            sliding_window=8, layer_pattern=("local", "global"), dtype=f32),
        "qwen2-int8": rt.dataclasses.replace(qwen2, name="qwen2-int8-narrow",
                                             kv_cache_dtype="int8"),
        "phi3": tc(name="phi3-narrow", n_layers=2, d_model=256, n_heads=4,
                   n_kv_heads=4, head_dim=96, d_ff=512, vocab_size=1024,
                   num_prefix_embeddings=8, dtype=f32),
        "mixtral": tc(
            name="mixtral-narrow", n_layers=2, d_model=256, n_heads=4,
            n_kv_heads=2, head_dim=64, d_ff=256, vocab_size=1024,
            sliding_window=8, layer_pattern=("local",),
            moe=rt.MoEConfig(n_experts=4, top_k=2, d_ff=256,
                             capacity_factor=8.0),
            tie_embeddings=False, dtype=f32),
    }


#: Leaves of the family the reference initialises to zero (biases, norm
#: scales, LayerNorm biases), given noise in the narrow checks so each
#: counts.
_FAMILY_NOISE = {"bq": 0.3, "bk": 0.3, "bv": 0.3, "bo": 0.1, "b_in": 0.1,
                 "b_out": 0.1, "scale": 0.1, "bias": 0.1}


def _run_family(torch, rt, cfg, params, toks, mask, prefix, feed, steps,
                device, max_len=64):
    """`_run_narrow` with a prefix of embeddings (positions [0, P), the
    prompt after them); prompts with a prefix carry no pads.  Returns the
    logits and the final cache."""
    if prefix is None:
        return _run_narrow(torch, rt, cfg, params, toks, mask, feed, steps,
                           device, max_len, with_cache=True)
    b, plen = toks.shape
    p = prefix.shape[1]
    bundle = rt.bundle_for(cfg)
    cache = bundle.init_cache(b, max_len, device)
    out, cache = bundle.prefill(params, toks.to(device), cache,
                                prefix_embeddings=prefix.to(device))
    seq = [out]
    for i in range(steps):
        if len(feed) <= i:
            feed.append(torch.argmax(seq[-1], dim=-1).cpu())
        out, cache = bundle.decode_step(params, feed[i].to(device), cache,
                                        p + plen + i)
        seq.append(out)
    return torch.stack(seq).cpu(), cache


def family_model_check(torch, rt):
    """The transformer family, narrow and fp32: flash (kernels) vs naive on
    the card and flash on the card vs on the CPU (plain versions), within
    1e-4, over a left-padded 40-token prefill (it rolls the 8-slot rings)
    and 8 decode steps (they wrap them); phi-3 with 8 prefix embeddings
    over unpadded prompts.  For the int8 cache, the card's codes against
    the CPU's too: within one step (a code may sit one step off where a
    key lands on a rounding boundary and the two sum its projection in
    another order), the scales within 1e-5."""
    import dataclasses
    from repro_torch.models.frontends import VisionStub
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, plen, steps = 4, 40, 8
    for label, base in family_narrow_configs(torch, rt).items():
        params = narrow_params(torch, rt, label, base)
        rng = torch.Generator().manual_seed(1)
        toks = torch.randint(1, base.vocab_size, (b, plen), generator=rng)
        prefix = None
        if base.num_prefix_embeddings:
            pads = torch.zeros(b, dtype=torch.long)
            prefix = VisionStub(base.num_prefix_embeddings, base.d_model) \
                .synth(torch.Generator().manual_seed(2), b, torch.float32)
        else:
            pads = torch.tensor([0, 3, 9, 30])
        mask = torch.arange(plen)[None] >= pads[:, None]
        toks = torch.where(mask, toks, torch.zeros_like(toks))
        feed, logits = [], {}
        for impl in ("naive", "flash"):
            cfg = dataclasses.replace(base, attn_impl=impl)
            logits[impl], cache = _run_family(torch, rt, cfg, params, toks,
                                              mask, prefix, feed, steps,
                                              "cuda")
        on_cpu, cpu_cache = _run_family(torch, rt, cfg,
                                        _tree_to(params, "cpu"), toks, mask,
                                        prefix, feed, steps, "cpu")
        geo = (f"{base.n_layers}L {base.layer_pattern}, d{base.d_model}, "
               f"{base.n_heads}H/{base.n_kv_heads}KV x {base.head_dim}, "
               f"norm {base.norm}, mlp {base.mlp_kind}, kv "
               f"{base.kv_cache_dtype}")
        if base.sliding_window:
            geo += f", window {base.sliding_window} (ring)"
        if prefix is not None:
            geo += f", prefix {prefix.shape[1]}"
        for what, a, ref in (("flash-vs-naive on the card", logits["flash"],
                              logits["naive"]),
                             ("flash on the card (kernels) vs on the CPU "
                              "(plain versions)", logits["flash"], on_cpu)):
            diff = (a - ref).abs().max().item()
            finite = bool(torch.isfinite(a).all().item())
            say(f"model fp32 {label} narrow ({geo}) {what}, prefill {plen} "
                f"+ {steps} decode: max_abs_diff={diff:.3e} tol=1e-4 "
                f"finite={finite}")
            if not finite or not diff <= 1e-4:
                fail(f"{label}: {what}: logits differ by {diff}")
        if base.kv_cache_dtype == "int8":
            int8_cache_check(torch, label, cache, cpu_cache)
    prefix_pads_check(torch, rt, b, plen)


def prefix_pads_check(torch, rt, b, plen):
    """The narrow phi-3 with its prefix before left pads (the kernels'
    `prefix_len` route): the prefill's last-position logits, flash vs
    naive on the card and flash on the card vs on the CPU, within 1e-4.
    The prefill alone: decode after it reads the window the reference's
    decode reads (ROADMAP.md, known divergences), not the prefill's."""
    import dataclasses
    from repro_torch.models.frontends import VisionStub
    base = family_narrow_configs(torch, rt)["phi3"]
    params = narrow_params(torch, rt, "phi3", base)
    pads = torch.tensor(PREFIX_PADS + (30,))[:b]
    mask = torch.arange(plen)[None] >= pads[:, None]
    toks = torch.randint(1, base.vocab_size, (b, plen),
                         generator=torch.Generator().manual_seed(1))
    toks = torch.where(mask, toks, torch.zeros_like(toks))
    prefix = VisionStub(base.num_prefix_embeddings, base.d_model).synth(
        torch.Generator().manual_seed(2), b, torch.float32)
    logits = {}
    for impl, device in (("naive", "cuda"), ("flash", "cuda"),
                         ("flash", "cpu")):
        bundle = rt.bundle_for(dataclasses.replace(base, attn_impl=impl))
        p = params if device == "cuda" else _tree_to(params, "cpu")
        out, _ = bundle.prefill(p, toks.to(device),
                                bundle.init_cache(b, 64, device),
                                prefix_embeddings=prefix.to(device),
                                attn_mask=mask.to(device))
        logits[impl, device] = out.cpu()
    for what, a, ref in (("flash-vs-naive on the card",
                          logits["flash", "cuda"], logits["naive", "cuda"]),
                         ("flash on the card (kernels) vs on the CPU (plain "
                          "versions)", logits["flash", "cuda"],
                          logits["flash", "cpu"])):
        diff = (a - ref).abs().max().item()
        finite = bool(torch.isfinite(a).all().item())
        say(f"model fp32 phi3 narrow (prefix {base.num_prefix_embeddings} "
            f"before left pads {pads.tolist()}) {what}, prefill {plen}: "
            f"max_abs_diff={diff:.3e} tol=1e-4 finite={finite}")
        if not finite or not diff <= 1e-4:
            fail(f"phi3 prefix before pads: {what}: logits differ by {diff}")


def int8_cache_check(torch, label, card, cpu):
    """The int8 cache the card wrote (flash) against the CPU's: the codes
    within one step, the fp32 scales within 1e-5 of the CPU's plus 1e-7
    (tests/test_torch_cuda.py's bound)."""
    for group, leaves in card.items():
        for name, leaf in leaves.items():
            ref = cpu[group][name]
            if leaf.dtype != ref.dtype or leaf.shape != ref.shape:
                fail(f"{label}: cache {group}/{name} is {leaf.dtype} "
                     f"{tuple(leaf.shape)} on the card, {ref.dtype} "
                     f"{tuple(ref.shape)} on the CPU")
            got = leaf.cpu()
            if leaf.dtype == torch.int8:
                steps = (got.int() - ref.int()).abs()
                ok = int(steps.max()) <= 1
                what = (f"max_steps={int(steps.max())} tol=1, one step off "
                        f"{int((steps > 0).sum())} of {steps.numel()}")
            else:
                diff = (got - ref).abs()
                ok = bool((diff <= 1e-7 + 1e-5 * ref.abs()).all())
                what = (f"max_abs_diff={float(diff.max()):.3e} "
                        f"tol=1e-5 x |cpu| + 1e-7")
            say(f"model fp32 {label} narrow int8 cache {group}/{name} card "
                f"vs CPU: {what}")
            if not ok:
                fail(f"{label}: cache {group}/{name}: {what}")


def narrow_params(torch, rt, label, cfg):
    """Seeded weights of a narrow model on the card; rwkv6's,
    recurrentgemma's and the transformer family's leaves that start at
    zero or a constant get noise."""
    params = rt.bundle_for(cfg).init_params(0, "cuda")
    noise = {"rwkv6": _RWKV6_NOISE, "recurrentgemma": _RGLRU_NOISE,
             "llama": None, "olmoe": None}.get(label, _FAMILY_NOISE)
    if noise is not None:
        gen = torch.Generator(device="cuda").manual_seed(2)
        _add_noise(torch, params, gen, noise)
    return params


def mid_decode_admissions(records):
    """Records admitted while another request was live in another slot."""
    return [r for r in records if r.slot >= 0 and any(
        o.slot != r.slot and o.admit_s < r.admit_s < o.finish_s
        for o in records)]


#: Phase 3's continuous workload: (prompt length, budget, arrival in step
#: units).  Three requests seed the pool; the rest arrive while it decodes
#: and are admitted into slots the short ones free.  At a prompt bucket
#: of 8 the 3- and 5-token prompts are shorter than recurrentgemma's
#: 16-slot ring, so their admission rolls the ring into place.
NARROW_WORKLOAD = ((5, 12, 0.0), (9, 4, 0.0), (13, 6, 0.0), (3, 5, 2.5),
                   (20, 3, 3.0), (5, 7, 4.0))


#: Phase 3's continuous check: its narrow models, by label, and the
#: prompt bucket of each (gemma2's 4, below its 8-slot ring, so the 3-token
#: prompt is admitted by the short-prompt roll).
CONTINUOUS_NARROW = {"llama": 8, "olmoe": 8, "rwkv6": 8, "recurrentgemma": 8,
                     "gemma2": 4, "qwen2-int8": 8}


def continuous_narrow_check(torch, rt):
    """Continuous batching on the narrow fp32 models: the same staggered
    workload (3 slots, chunks of 4, `step_time_s=1`, an EOS, admissions
    mid-decode) on the card (kernels, replayed graph) and on the CPU
    (plain versions, eager step): the same tokens, decode steps, prefill
    calls and records."""
    import dataclasses
    import numpy as np
    narrow = dict(narrow_configs(torch, rt), **family_narrow_configs(torch,
                                                                     rt))
    for label, bucket in CONTINUOUS_NARROW.items():
        cfg = narrow[label]
        if hasattr(cfg, "attn_impl"):
            cfg = dataclasses.replace(cfg, attn_impl="flash")
        bundle = rt.bundle_for(cfg)
        params = narrow_params(torch, rt, label, cfg)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n, _, _ in NARROW_WORKLOAD]

        def serve(device, p, eos_id):
            engine = rt.InferenceEngine(bundle, p, max_batch=3,
                                        max_seq_len=64, prompt_bucket=bucket,
                                        device=device)
            reqs = [rt.EngineRequest(rid=i, prompt=q, max_new_tokens=m,
                                     arrival_s=a) for i, (q, (_, m, a))
                    in enumerate(zip(prompts, NARROW_WORKLOAD))]
            return engine.generate_continuous(reqs, n_slots=3, chunk=4,
                                              step_time_s=1.0, eos_id=eos_id)
        cpu_params = _tree_to(params, "cpu")
        free, _ = serve("cpu", cpu_params, None)
        eos = int(free[0][2])            # request 0's third token
        on_cpu, st_cpu = serve("cpu", cpu_params, eos)
        on_card, st_card = serve("cuda", params, eos)
        recs = [[(r.rid, r.slot, r.admit_s, r.finish_s, r.tokens)
                 for r in st.records] for st in (st_card, st_cpu)]
        same = on_card.keys() == on_cpu.keys() and all(
            np.array_equal(on_card[k], on_cpu[k]) for k in on_cpu)
        admitted = len(mid_decode_admissions(st_card.records))
        say(f"continuous fp32 {label} narrow on the card (graph, kernels) "
            f"vs on the CPU (plain versions), 3 slots, chunk 4, bucket "
            f"{bucket}, "
            f"{len(prompts)} requests, eos={eos}: tokens_equal={same} "
            f"records_equal={recs[0] == recs[1]} decode_steps="
            f"{st_card.decode_steps}/{st_cpu.decode_steps} prefill_calls="
            f"{st_card.prefill_calls}/{st_cpu.prefill_calls} "
            f"admitted_mid_decode={admitted} "
            f"eos_cut={len(on_card[0]) < NARROW_WORKLOAD[0][1]}")
        if not same or recs[0] != recs[1] or \
                st_card.decode_steps != st_cpu.decode_steps or \
                st_card.prefill_calls != st_cpu.prefill_calls:
            fail(f"continuous {label} narrow: the card and the CPU differ")
        if not admitted or len(on_card[0]) >= NARROW_WORKLOAD[0][1]:
            fail(f"continuous {label} narrow: the workload admitted nothing "
                 f"mid-decode or its EOS never fired")


#: rwkv6 leaves the reference initialises to zero, given noise in the
#: narrow check so that the mixes, decay base, bonus and norms all count.
_RWKV6_NOISE = {"maa_x": 0.3, "maa_rkvwg": 0.3, "maa_k": 0.3, "maa_r": 0.3,
                "decay_base": 2.5, "bonus": 0.5, "scale": 0.1, "bias": 0.1}
#: The same for recurrentgemma: gate biases, conv bias, norm scales.
_RGLRU_NOISE = {"b_a": 0.5, "b_i": 0.5, "conv_b": 0.1, "scale": 0.1}


def _add_noise(torch, tree, gen, noise, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _add_noise(torch, v, gen, noise, k)
    elif isinstance(tree, list):
        for v in tree:
            _add_noise(torch, v, gen, noise)
    elif key in noise:
        tree.add_(noise[key] * torch.randn(
            tree.shape, generator=gen, device=tree.device, dtype=tree.dtype))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phase 4: the main paths at full width
# ---------------------------------------------------------------------------

def weight_read_floor_ms(family, cfg, batch, kv_slots=PROMPT_LEN + NEW_TOKENS,
                         kv_bytes=2):
    """Least time of one decode step at `batch`: the bytes it must move
    over 3.35 TB/s.  Transformers: every weight the step reads (attention
    with its biases, the FFN -- gated 3 d d_ff, dense 2 d d_ff, with their
    biases -- the norms, the router, the LM head, and each expert whose
    capacity buffer the step computes -- all of them, since decode
    capacity is at least top_k rows an expert), and the KV cache's
    `kv_slots` valid keys a row a layer, read once at `kv_bytes` a value
    (an int8 cache: 1, plus its fp32 scale a (token, head)).  rwkv6:
    every weight but the embedding table (its B rows only) and the
    recurrent state (WKV fp32, token shifts bf16) read and written once.
    recurrentgemma: every weight (the tied unembedding reads the whole
    table), the attention caches read once, and the recurrent state
    (`lru_h` fp32, `conv_tail` bf16) read and written once."""
    d, e = cfg.d_model, 2   # bf16
    if family == "rglru":
        n_rec = cfg.n_recurrent
        kv = (cfg.n_layers - n_rec) * batch * min(
            MAX_SEQ_LEN, cfg.sliding_window) * cfg.n_kv_heads \
            * cfg.head_dim * 2 * e
        state = n_rec * batch * cfg.width * (4 + 3 * e)
        return (cfg.n_params * e + kv + 2 * state) / HBM_BYTES_PER_S * 1e3
    head = cfg.vocab_size * d * e + batch * d * e
    if family == "rwkv6":
        tables = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
        state = cfg.n_layers * batch * (
            cfg.n_heads * cfg.head_dim ** 2 * 4 + 2 * d * e)
        return ((cfg.n_params - tables) * e + head + 2 * state) \
            / HBM_BYTES_PER_S * 1e3
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = 2 * d * h * hd + 2 * d * kvh * hd
    if cfg.use_bias or cfg.qkv_bias:
        attn += (h + 2 * kvh) * hd + (d if not cfg.qkv_bias else 0)
    f = cfg.d_ff
    if cfg.moe is not None:
        m = cfg.moe
        ffn = 3 * m.n_experts * d * m.d_ff * e + d * m.n_experts * 4
    elif cfg.mlp_kind == "gated":
        ffn = (3 * d * f + (2 * f + d if cfg.use_bias else 0)) * e
    else:
        ffn = (2 * d * f + (f + d if cfg.use_bias else 0)) * e
    per_norm = d * (2 if cfg.norm == "layernorm" else 1)
    norms = (2 + 2 * cfg.post_norms) * per_norm + 2 * hd * cfg.qk_norm
    kv = batch * kv_slots * kvh * (hd * kv_bytes + (
        4 if kv_bytes == 1 else 0)) * 2
    return (cfg.n_layers * ((attn + norms) * e + ffn + kv) + head
            + per_norm * e) / HBM_BYTES_PER_S * 1e3


def describe(family, cfg):
    """One line of a full-width config's shape."""
    if family == "rglru":
        return (f"{cfg.name} {cfg.n_layers} blocks ({cfg.n_recurrent} "
                f"recurrent, {cfg.n_layers - cfg.n_recurrent} local "
                f"attention) d_model={cfg.d_model} lru_width={cfg.width} "
                f"{cfg.n_heads}H/{cfg.n_kv_heads}KV x {cfg.head_dim} "
                f"window={cfg.sliding_window} d_ff={cfg.d_ff} (GeGLU) "
                f"tied={cfg.tie_embeddings} attn_impl={cfg.attn_impl}")
    if family == "rwkv6":
        return (f"{cfg.name} {cfg.n_layers}L d_model={cfg.d_model} "
                f"{cfg.n_heads}H x {cfg.head_dim} (attention-free) "
                f"d_ff={cfg.d_ff} chunk={cfg.chunk} "
                f"tied={cfg.tie_embeddings}")
    ffn = (f"d_ff={cfg.d_ff} ({cfg.mlp_kind} {cfg.act})"
           if cfg.moe is None else
           f"moe={cfg.moe.n_experts}x top-{cfg.moe.top_k} "
           f"d_ff={cfg.moe.d_ff} qk_norm={cfg.qk_norm}")
    extra = "".join(f" {k}={v}" for k, v in (
        ("qkv_bias", cfg.qkv_bias), ("use_bias", cfg.use_bias),
        ("attn_softcap", cfg.attn_softcap),
        ("final_softcap", cfg.final_softcap),
        ("query_scale", cfg.query_scale), ("embed_scale", cfg.embed_scale),
        ("post_norms", cfg.post_norms),
        ("sliding_window", cfg.sliding_window),
        ("kv_cache_dtype", cfg.kv_cache_dtype)) if v not in (
            False, 0, 0.0, None, "native"))
    if cfg.layer_pattern != ("global",):
        extra += f" layer_pattern={cfg.layer_pattern}"
    return (f"{cfg.name} {cfg.n_layers}L d_model={cfg.d_model} "
            f"{cfg.n_heads}H/{cfg.n_kv_heads}KV x {cfg.head_dim} {ffn} "
            f"norm={cfg.norm} tied={cfg.tie_embeddings}{extra} "
            f"attn_impl={cfg.attn_impl}")


def serve_full_width(torch, rt, ops, arch, prompt_len, bucket, rounds):
    import dataclasses
    import numpy as np
    cfg = rt.configs.get(arch)
    if rt.bundle_for(cfg).family in ("transformer", "rglru"):
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    bundle = rt.bundle_for(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = bundle.init_params(0, "cuda")
    torch.cuda.synchronize()
    say(f"full width: {describe(bundle.family, cfg)} "
        f"vocab={cfg.vocab_size} params={cfg.n_params} dtype=bfloat16 "
        f"prompt_len={prompt_len} prompt_bucket={bucket} "
        f"init_s={time.monotonic() - t0:.2f}")
    engine = rt.InferenceEngine(bundle, params, max_batch=MAX_BATCH,
                                max_seq_len=MAX_SEQ_LEN,
                                prompt_bucket=bucket, device="cuda")
    env = rt.EngineEnvironment(engine, rt.energy.JETSON_AGX_ORIN,
                               rt.energy.ORIN_WORKLOADS["llama3.2-1b"],
                               prompt_len=prompt_len,
                               max_new_tokens=NEW_TOKENS, seed=0)

    # Warm-up (cuBLAS handles, kernel loading) and an output check, before
    # the counted run.
    rng = np.random.default_rng(7)
    warm = [rng.integers(1, cfg.vocab_size, prompt_len).astype(np.int32)
            for _ in range(MAX_BATCH)]
    toks, _ = engine.generate(warm, NEW_TOKENS)
    space = rt.make_space(f"engine/{arch}")
    for b in space.grid("batch"):
        if b not in engine.decode_graphs:
            engine.generate(warm[:b], NEW_TOKENS)
        g = engine.decode_graphs[b]
        say(f"graph capture {arch} b={b}: capture_s={g.capture_s:.6f} "
            f"(2 eager warm-up steps + capture) kernels_a_replay="
            f"{sum(g.tally.values())} tally={g.tally}")
    cache = bundle.init_cache(2, 32, "cuda")
    logits, _ = bundle.prefill(params, torch.from_numpy(
        np.stack(warm[:2])).long().cuda(), cache)
    if toks.shape != (MAX_BATCH, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: generate returned bad tokens {toks.shape} "
             f"[{toks.min()}, {toks.max()}]")
    if logits.shape != (2, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all().item()):
        fail(f"{arch}: full-width prefill logits are not finite")

    def drive():
        cm = rt.CostModel(alpha=0.5)
        ref_obs = env.pull(space.values(space.corner()), 0)
        cm = cm.with_reference(ref_obs.energy, ref_obs.latency)
        policy = rt.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
        return ref_obs, rt.Controller(space, policy, cm, seed=0).run(
            env, rounds)

    counts, (ref_obs, res) = counted_run(torch, ops, engine, drive)

    pulls = [("ref", space.values(space.corner()), ref_obs)] + \
        [(r.t, r.knobs, r.obs) for r in res.records]
    for t, knobs, obs in pulls:
        md = obs.metadata
        floor = weight_read_floor_ms(bundle.family, cfg, knobs["batch"])
        say(f"pull {arch} {t} freq_mhz={knobs['freq_mhz']} "
            f"batch={knobs['batch']} "
            f"prefill_s={md['prefill_s']:.6f} decode_s={md['decode_s']:.6f} "
            f"decode_step_ms={1e3 * md['decode_s'] / NEW_TOKENS:.4f} "
            f"decode_floor_ms={floor:.4f} "
            f"tokens_per_s={md['tokens_per_s']:.1f} "
            f"modelled_orin_energy_j_per_req={obs.energy:.4f} "
            f"latency_s_per_req={obs.latency:.4f}")
    say(f"controller summary {arch} (energy modelled with the Jetson Orin "
        "board model on this card's wall time): "
        + json.dumps(res.summary(), default=str))
    say(f"peak_device_memory_gb {arch}="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return counts, len(pulls), cfg, engine, warm


def reset_counts(ops):
    for m in ops.values():
        m.launches = 0
    ops["decode_attention"].combine_launches = 0
    ops["flash_attention"].tc_launches = 0
    for name in ("rmsnorm", "wkv6", "rglru"):
        ops[name].bwd_launches = 0
    for name in ("dx_launches", "dw_launches", "transpose_launches"):
        setattr(ops["moe_gemm"], name, 0)


def counted_run(torch, ops, engine, run):
    """Call `run()` with every launch counter at 0 and return (the kernel
    executions it made, its result).  A counter counts host calls that
    launched a kernel, and a graph replay makes none, so the executions
    are the counters' change plus, for each of the engine's graphs, its
    replays in the run times its per-kernel tally.  A capture inside the
    run would count calls that execute nothing, so it fails."""
    from repro_torch.kernels import launch_counts
    graphs = dict(engine.decode_graphs)
    replays = {b: g.replays for b, g in graphs.items()}
    reset_counts(ops)
    result = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    if engine.decode_graphs.keys() != graphs.keys():
        fail(f"{engine.bundle.name}: a graph was captured inside a counted "
             f"run (batches {sorted(engine.decode_graphs)})")
    for b, g in graphs.items():
        for name, n in g.tally.items():
            counts[name] += (g.replays - replays[b]) * n
    return counts, result


def expected_launches(family, cfg, n_generate, prompt_len, steps=None):
    """Launches one path must make over `n_generate` prefills of
    `prompt_len` tokens (a static generate's, a continuous seed's or a
    one-row admission's, which launch the same kernels) and `steps` decode
    steps (default: NEW_TOKENS a prefill, as generate calls make)."""
    n_layers = cfg.n_layers
    steps = n_generate * NEW_TOKENS if steps is None else steps
    counts = dict.fromkeys(KERNELS, 0)
    counts["decode_attention_combine"] = 0     # 128-slot caches: one split
    counts["flash_attention_tc"] = 0
    if family == "rwkv6":
        # A layer's prefill: one chunked call over the prompt's whole
        # chunks, one call a tail token; then one call a decode step.
        head = 1 if prompt_len >= cfg.chunk else 0
        counts["wkv6"] = n_layers * (
            n_generate * (head + prompt_len % cfg.chunk) + steps)
        return counts
    passes = n_generate + steps
    if family == "rglru":
        # One scan a recurrent block a pass; one prefill-attention launch an
        # attention block a prefill; the windowed layers decode naive, as
        # in the reference, so no decode-attention launch.
        n_rec = cfg.n_recurrent
        counts.update({"rglru": n_rec * passes,
                       "flash_attention": (n_layers - n_rec) * n_generate,
                       "rmsnorm": (2 * n_layers + 1) * passes})
    else:
        # Decode attention runs on plain causal layers only: no window, no
        # softcap (gemma2 and mixtral decode naive, as in the reference).
        plain = sum(1 for local in cfg.is_local
                    if not (local and cfg.sliding_window)
                    and not cfg.attn_softcap)
        # RMSNorms a layer: the two pre-norms, gemma2's two post-norms and
        # olmoe's q/k norms; the final norm once a pass.  starcoder2's
        # LayerNorm has no kernel.
        norms = 0 if cfg.norm != "rmsnorm" else \
            (2 + 2 * cfg.post_norms) * n_layers + 1
        norms += 2 * n_layers * cfg.qk_norm
        counts.update({"decode_attention": plain * steps,
                       "flash_attention": n_layers * n_generate,
                       "moe_gemm": 3 * n_layers * passes
                       if cfg.moe is not None else 0,
                       "rmsnorm": norms * passes})
    # Every path runs bf16, so every prefill-attention launch is the
    # tensor-core kernel's.
    counts["flash_attention_tc"] = counts["flash_attention"]
    return counts


def graph_vs_loop(rt, engine, prompts, family, cfg):
    """The fused engine (a graph replay a step) against an eager-loop
    engine on the same params and prompts, at batch 4 and MAX_BATCH:
    tokens equal, decode step times (host clock over the decode, which
    ends in a sync) in turns graph, loop, loop, graph."""
    import numpy as np
    arch = engine.bundle.name
    loop = rt.InferenceEngine(engine.bundle, engine.params,
                              max_batch=MAX_BATCH, max_seq_len=MAX_SEQ_LEN,
                              prompt_bucket=engine.prompt_bucket,
                              decode_impl="loop", device="cuda")
    for b in (4, MAX_BATCH):
        ps = prompts[:b]
        loop.generate(ps, NEW_TOKENS)                    # warm-up
        steps = {"graph": [], "loop": []}
        toks = {}
        for impl in ("graph", "loop", "loop", "graph"):
            out, st = (engine if impl == "graph" else loop).generate(
                ps, NEW_TOKENS)
            steps[impl].append(1e3 * st.decode_s / NEW_TOKENS)
            if impl in toks and not np.array_equal(toks[impl], out):
                fail(f"{arch} b={b}: {impl} decode gave other tokens on a "
                     "second run")
            toks[impl] = out
        if not np.array_equal(toks["graph"], toks["loop"]):
            fail(f"{arch} b={b}: graph-replayed tokens differ from the "
                 "eager loop's")
        g, lo = statistics.mean(steps["graph"]), statistics.mean(steps["loop"])
        say(f"decode step {arch} b={b}: graph_ms={g:.4f} loop_ms={lo:.4f} "
            f"loop_over_graph={lo / g:.2f} runs graph="
            f"{[round(t, 4) for t in steps['graph']]} loop="
            f"{[round(t, 4) for t in steps['loop']]} decode_floor_ms="
            f"{weight_read_floor_ms(family, cfg, b):.4f} tokens_equal=True")


def profile_generate(torch, engine, prompts):
    """Kernel time by name over one full-width generate at batch 28, and
    the decode window's share of it: from the first graph launch to the
    end of the last kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(prompts, NEW_TOKENS)
        wall = time.monotonic() - t0
    events = prof.key_averages()
    # Kernel rows only: operator rows repeat their kernels' device time.
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    dev_us = sum(ev.self_device_time_total for ev in kernels)
    n_launch = sum(ev.count for ev in kernels)
    say(f"profile generate {engine.bundle.name} b={len(prompts)}: "
        f"wall_s={wall:.6f} device_busy_s={dev_us / 1e6:.6f} "
        f"device_busy_share={dev_us / 1e6 / wall:.4f} "
        f"kernel_launches={n_launch} "
        f"per_forward_pass={n_launch / (1 + NEW_TOKENS):.1f}")
    say(events.table(sort_by="self_device_time_total", row_limit=15,
                     max_name_column_width=60))
    decode_window(prof, engine, len(prompts))


def decode_window(prof, engine, batch):
    """From a profiled generate: the decode window (from the host's first
    graph launch to the end of the last kernel), its device-busy share,
    the host's launches a step by call, and `kernel_in_path` for the
    port's kernels inside the graph (window=decode) and before it
    (window=prefill; caches as the path leaves them, not as a timing loop
    does)."""
    import collections
    from torch.autograd import DeviceType
    name = engine.bundle.name
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in HOST_LAUNCHES]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    starts = [e.time_range.start for e in host if e.name == "cudaGraphLaunch"]
    if not starts:
        fail(f"{name}: the profiled generate launched no CUDA graph")
    start = min(starts)
    decode = [e for e in kernels if e.time_range.start >= start]
    calls = collections.Counter(e.name for e in host
                                if e.time_range.start >= start)
    if decode:
        end = max(e.time_range.end for e in decode)
        busy = sum(e.time_range.elapsed_us() for e in decode)
        say(f"decode window {name} b={batch}: window_s="
            f"{(end - start) / 1e6:.6f} device_busy_s={busy / 1e6:.6f} "
            f"device_busy_share={busy / (end - start):.4f} kernels_a_step="
            f"{len(decode) / NEW_TOKENS:.1f} host_launches_a_step="
            f"{sum(calls.values()) / NEW_TOKENS:.3f} host_calls="
            f"{dict(calls)}")
        by_name = collections.defaultdict(list)
        for e in decode:
            by_name[e.name].append(e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
        for kname, us in top:
            say(f"decode_top {name} b={batch} {kname[:70]}: share="
                f"{sum(us) / busy:.4f} us_a_step={sum(us) / NEW_TOKENS:.1f}"
                f" launches_a_step={len(us) / NEW_TOKENS:.1f}")
    else:
        say(f"decode window {name} b={batch}: the profiler recorded no "
            f"kernel inside the graph replays (busy share not measured); "
            f"host_launches_a_step={sum(calls.values()) / NEW_TOKENS:.3f} "
            f"host_calls={dict(calls)}")
    kernel_in_path(name, "decode", decode)
    kernel_in_path(name, "prefill", [e for e in kernels
                                     if e.time_range.start < start])


def kernel_in_path(name, window, events):
    """One `kernel_in_path` line a port kernel among profiled kernel
    events: its launches and mean device time a launch."""
    import collections
    per = collections.defaultdict(list)
    for e in events:
        if any(k in e.name for k in PORT_KERNEL_NAMES):
            per[e.name].append(e.time_range.elapsed_us())
    for kname, us in sorted(per.items()):
        say(f"kernel_in_path {name} window={window} {kname[:70]}: "
            f"launches={len(us)} device_us_per_launch="
            f"{sum(us) / len(us):.3f}")


def long_cache_generate(torch, rt, ops, engine, cfg):
    """One profiled generate of the full-width llama3.2-1b (the params
    phase 4a made) on a second engine over a 4096-slot cache: LONG_BATCH
    prompts of LONG_PROMPT tokens and NEW_TOKENS decode steps.  Decode
    attention there splits the KV axis and runs the combine kernel once a
    layer a step; the launch counts of that generate must say so."""
    import numpy as np
    long_engine = rt.InferenceEngine(engine.bundle, engine.params,
                                     max_batch=LONG_BATCH,
                                     max_seq_len=LONG_SEQ_LEN,
                                     prompt_bucket=PROMPT_LEN, device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
               for _ in range(LONG_BATCH)]
    toks, st = long_engine.generate(prompts, NEW_TOKENS)  # warm-up
    if toks.shape != (LONG_BATCH, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"long cache: generate returned bad tokens {toks.shape}")
    dec = ops["decode_attention"]
    plan = dec.split_plan(LONG_BATCH, cfg.n_kv_heads, LONG_SEQ_LEN,
                          dec.sm_count(torch.device("cuda", 0)))
    say(f"long cache {cfg.name}: batch {LONG_BATCH}, prompts of "
        f"{LONG_PROMPT} tokens, cache {LONG_SEQ_LEN} slots, split plan "
        f"{plan}: prefill_s={st.prefill_s:.6f} decode_s={st.decode_s:.6f} "
        f"decode_step_ms={1e3 * st.decode_s / NEW_TOKENS:.4f}")
    counts, _ = counted_run(torch, ops, long_engine, lambda: profile_generate(
        torch, long_engine, prompts))
    expected = expected_launches("transformer", cfg, 1, LONG_PROMPT)
    expected["decode_attention_combine"] = cfg.n_layers * NEW_TOKENS
    say(f"launch counts long cache {cfg.name} over 1 generate call "
        f"({NEW_TOKENS} decode steps): {counts} expected {expected}")
    if counts != expected:
        fail(f"long cache: launch counts {counts} != expected {expected}")


def int8_long_cache(torch, rt, ops, engine, cfg):
    """Phase 6's int8 cache: the full-width qwen2-1.5b (the params phase 4f
    made) over a LONG_SEQ_LEN-slot cache at LONG_BATCH, prompts of
    LONG_PROMPT tokens, with the int8 cache and with the native one on the
    same params.  Prefill and decode step of each, in turns native, int8,
    int8, native; the int8 graph's tokens against its eager loop's; the
    int8 cache's leaves checked to be int8 codes with fp32 scales; and the
    kernel executions of one int8 generate: decode attention once a plain
    layer a step over the dequantized cache (split, with the combine), as
    the reference runs it."""
    import dataclasses
    import numpy as np
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
               for _ in range(LONG_BATCH)]
    engines, toks = {}, {}
    for kv, impl in (("native", "fused"), ("int8", "fused"),
                     ("int8", "loop")):
        bundle = rt.bundle_for(dataclasses.replace(cfg, kv_cache_dtype=kv))
        eng = rt.InferenceEngine(bundle, engine.params, max_batch=LONG_BATCH,
                                 max_seq_len=LONG_SEQ_LEN,
                                 prompt_bucket=PROMPT_LEN, decode_impl=impl,
                                 device="cuda")
        toks[kv, impl], _ = eng.generate(prompts, NEW_TOKENS)   # warm-up
        engines[kv, impl] = eng
    leaves = engines["int8", "fused"]._cache_pool[LONG_BATCH]["global"]
    kinds = {k: (str(t.dtype), tuple(t.shape)) for k, t in leaves.items()}
    if kinds.get("k", ("",))[0] != "torch.int8" or \
            kinds.get("k_scale", ("",))[0] != "torch.float32":
        fail(f"int8 cache: the pooled cache holds {kinds}, not int8 codes "
             "and fp32 scales")
    if not np.array_equal(toks["int8", "fused"], toks["int8", "loop"]):
        fail("int8 cache: graph-replayed tokens differ from the eager loop's")
    agree = float((toks["int8", "fused"] == toks["native", "fused"]).mean())
    times = {"native": [], "int8": []}
    for kv in ("native", "int8", "int8", "native"):
        _, st = engines[kv, "fused"].generate(prompts, NEW_TOKENS)
        times[kv].append((st.prefill_s, 1e3 * st.decode_s / NEW_TOKENS))
    step = {kv: statistics.mean(t[1] for t in ts) for kv, ts in times.items()}
    pre = {kv: statistics.mean(t[0] for t in ts) for kv, ts in times.items()}
    runs = {kv: [(round(p, 6), round(d, 4)) for p, d in ts]
            for kv, ts in times.items()}
    floors = {kv: weight_read_floor_ms("transformer", cfg, LONG_BATCH,
                                       LONG_PROMPT + NEW_TOKENS, nb)
              for kv, nb in (("native", 2), ("int8", 1))}
    say(f"int8 cache {cfg.name}: batch {LONG_BATCH}, prompts of {LONG_PROMPT} "
        f"tokens, cache {LONG_SEQ_LEN} slots, leaves {kinds}: "
        f"decode_step_ms native={step['native']:.4f} int8={step['int8']:.4f} "
        f"int8_over_native={step['int8'] / step['native']:.4f} prefill_s "
        f"native={pre['native']:.6f} int8={pre['int8']:.6f} decode_floor_ms "
        f"native={floors['native']:.4f} int8={floors['int8']:.4f} "
        f"runs={runs} graph_equals_loop=True "
        f"tokens_equal_to_native_share={agree:.4f}")
    int8 = engines["int8", "fused"]
    counts, _ = counted_run(torch, ops, int8, lambda: int8.generate(
        prompts, NEW_TOKENS))
    expected = expected_launches("transformer", cfg, 1, LONG_PROMPT)
    dec = ops["decode_attention"]
    n_splits, _ = dec.split_plan(LONG_BATCH, cfg.n_kv_heads, LONG_SEQ_LEN,
                                 dec.sm_count(torch.device("cuda", 0)))
    if n_splits > 1:
        expected["decode_attention_combine"] = cfg.n_layers * NEW_TOKENS
    say(f"launch counts int8 cache {cfg.name} over 1 generate call "
        f"({NEW_TOKENS} decode steps, {n_splits} KV splits): {counts} "
        f"expected {expected}")
    if counts != expected:
        fail(f"int8 cache: launch counts {counts} != expected {expected}")
    del engines, int8
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: continuous batching at full width
# ---------------------------------------------------------------------------

#: Phase 7(b), E13's workload (benchmarks/engine_continuous.py) at the
#: pool's width: Poisson arrivals at CONT_RATE requests a step unit, every
#: 4th request decoding LONG_NEW tokens and the rest SHORT_NEW, decoded in
#: chunks of CONT_CHUNK steps.  Requests: four static groups of MAX_BATCH
#: on llama3.2-1b, two on the larger models.
SHORT_NEW, LONG_NEW, CONT_RATE, CONT_CHUNK = 4, 32, 2.0, 4
CONT_GROUPS = {"llama3.2-1b": 4}
#: Where the one-row admission prefill of phase 7 is timed: at global
#: positions [ADMIT_OFFSET, ADMIT_OFFSET + bucketed prompt).
ADMIT_OFFSET = 32


def poisson_workload(rt, cfg, prompt_len, n):
    """E13's requests: Poisson arrivals (seed 11), prompts of `prompt_len`
    random tokens (seed 7), every 4th request LONG_NEW tokens long."""
    import numpy as np
    rng = np.random.default_rng(7)
    ap = rt.ArrivalProcess(interval_s=1.0 / CONT_RATE, kind="poisson",
                           seed=11)
    return [rt.EngineRequest(
        rid=r.rid, prompt=rng.integers(1, cfg.vocab_size, prompt_len)
        .astype(np.int32),
        max_new_tokens=LONG_NEW if r.rid % 4 == 3 else SHORT_NEW,
        arrival_s=r.arrival_s) for r in ap.generate(n)]


def continuous_full_width(torch, rt, ops, engine, cfg, prompts, prompt_len,
                          n_requests, poisson=True):
    """Phase 7 on one path's engine (n_slots MAX_BATCH, the graph phase 4
    captured at that batch): (a) every request at t=0 with equal budgets,
    streams equal to `generate`'s at chunk NEW_TOKENS and 3; (b) E13's
    Poisson workload through `generate_continuous` and through static
    groups of MAX_BATCH in arrival order, `step_time_s=1` (left out with
    `poisson` False); (c) the kernel executions of all of it, counted as
    in phase 5, equal to its prefills (seeds and one-row admissions alike)
    times a prefill's launches plus its decode steps times a step's.
    Returns the counts."""
    import numpy as np
    arch, family = cfg.name, engine.bundle.family
    done = {"prefills": 0, "steps": 0}
    out = {}

    def note(prefills, steps):
        done["prefills"] += prefills
        done["steps"] += steps

    def run():
        ref, _ = engine.generate(prompts, NEW_TOKENS)
        note(1, NEW_TOKENS)
        for chunk in (NEW_TOKENS, 3):
            streams, st = engine.generate_continuous(
                [rt.EngineRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                 for i, p in enumerate(prompts)],
                n_slots=MAX_BATCH, chunk=chunk)
            note(st.prefill_calls, st.decode_steps)
            equal = all(np.array_equal(streams[i], ref[i])
                        for i in range(len(prompts)))
            say(f"continuous identity {arch} n_slots={MAX_BATCH} "
                f"chunk={chunk}: tokens_equal={equal} decode_steps="
                f"{st.decode_steps} prefill_calls={st.prefill_calls}")
            if not equal or (st.decode_steps, st.prefill_calls) != \
                    (NEW_TOKENS, 1):
                fail(f"{arch}: continuous at chunk {chunk} is not the "
                     "static schedule")
        if not poisson:
            return
        reqs = poisson_workload(rt, cfg, prompt_len, n_requests)
        admits = sum(n for k, n in engine.calls.items() if k[0] == "admit")
        t0 = time.monotonic()
        streams, st = engine.generate_continuous(
            reqs, n_slots=MAX_BATCH, chunk=CONT_CHUNK, step_time_s=1.0)
        out["cont_wall"] = time.monotonic() - t0
        out["admissions"] = sum(n for k, n in engine.calls.items()
                                if k[0] == "admit") - admits
        note(st.prefill_calls, st.decode_steps)
        if st.n_requests != n_requests or any(
                len(streams[r.rid]) != r.max_new_tokens for r in reqs):
            fail(f"{arch}: the Poisson workload was not served in full")
        if not out["admissions"]:
            fail(f"{arch}: the Poisson workload admitted nothing")
        out["st"] = st
        # Static groups in arrival order, each decoding its longest
        # member's budget: model time as E13 counts it (a unit a prefill
        # and a decode step, a group starting when its last member has
        # arrived), wall time and the graph's step as measured.
        units = static_decode_s = 0.0
        static_steps = 0
        t0 = time.monotonic()
        for g in range(0, n_requests, MAX_BATCH):
            grp = reqs[g:g + MAX_BATCH]
            steps = max(r.max_new_tokens for r in grp)
            units = max(units, max(r.arrival_s for r in grp)) + 1.0 + steps
            _, gst = engine.generate([r.prompt for r in grp], steps)
            note(1, steps)
            static_decode_s += gst.decode_s
            static_steps += steps
        out.update(static_wall=time.monotonic() - t0, static_units=units,
                   static_step_ms=1e3 * static_decode_s / static_steps)

    counts, _ = counted_run(torch, ops, engine, run)
    expected = expected_launches(family, cfg, done["prefills"], prompt_len,
                                 done["steps"])
    say(f"launch counts continuous {arch} over {done['prefills']} prefills "
        f"(static generates, continuous seeds and one-row admissions) and "
        f"{done['steps']} decode steps: {counts} expected {expected}")
    if counts != expected:
        fail(f"{arch}: continuous launch counts {counts} != expected "
             f"{expected}")
    if not poisson:
        return counts
    st = out["st"]
    cont_step_ms = 1e3 * st.decode_s / st.decode_steps
    say(f"continuous poisson {arch}: requests={n_requests} rate="
        f"{CONT_RATE}/step short/long={SHORT_NEW}/{LONG_NEW} n_slots="
        f"{MAX_BATCH} chunk={CONT_CHUNK} makespan_units continuous="
        f"{st.sim_s} static={out['static_units']} static_over_continuous="
        f"{out['static_units'] / st.sim_s:.4f} goodput_per_unit "
        f"continuous={st.goodput_rps:.5f} static="
        f"{n_requests / out['static_units']:.5f} wall_s continuous="
        f"{out['cont_wall']:.6f} static={out['static_wall']:.6f} "
        f"mean_occupancy={st.mean_occupancy:.4f} mean_queue_wait_units="
        f"{st.mean_queue_wait_s:.4f} decode_steps={st.decode_steps} "
        f"prefill_calls={st.prefill_calls} admissions={out['admissions']} "
        f"continuous_step_ms={cont_step_ms:.4f} static_graph_step_ms="
        f"{out['static_step_ms']:.4f} continuous_over_static_step="
        f"{cont_step_ms / out['static_step_ms']:.4f}")
    return counts


def admission_prefill(torch, engine, cfg, prompt_len):
    """Continuous admission's one-row prefill alone, at the path's prompt
    bucket: a row of `prompt_len` - 3 tokens left-padded to the bucket, at
    global offset ADMIT_OFFSET, into a one-row cache.  Host time around it
    with syncs (median of 5 after a warm-up) and `kernel_in_path
    window=admit` from one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bucket = engine.prompt_bucket
    lb = -(-(prompt_len - 3) // bucket) * bucket
    toks = torch.randint(1, cfg.vocab_size, (1, lb), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    mask = torch.arange(lb, device="cuda")[None] >= 3
    toks = torch.where(mask, toks, torch.zeros_like(toks))
    cache = engine.bundle.init_cache(1, MAX_SEQ_LEN, "cuda")

    def call():
        with torch.inference_mode():
            engine.bundle.prefill(engine.params, toks, cache,
                                  attn_mask=mask, pos_offset=ADMIT_OFFSET)
        torch.cuda.synchronize()
    call()
    times = []
    for _ in range(5):
        t0 = time.monotonic()
        call()
        times.append(time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    say(f"admission prefill {cfg.name}: one row of {prompt_len - 3} tokens "
        f"in a bucket of {lb} at pos_offset {ADMIT_OFFSET}: ms="
        f"{1e3 * statistics.median(times):.4f} runs="
        f"{[round(1e3 * t, 4) for t in times]} kernels={len(kernels)}")
    kernel_in_path(cfg.name, "admit", kernels)


# ---------------------------------------------------------------------------
# Phase 8: measured energy through NVML
# ---------------------------------------------------------------------------

#: Phase 8's continuous pulls: ENERGY_REQUESTS Poisson arrivals at
#: ENERGY_RATE a second of the simulation clock (wall time there), so the
#: arm's pool fills; Camel rounds a scheduler: llama3.2-1b's, else 2.
ENERGY_REQUESTS, ENERGY_RATE = 32, 200.0
ENERGY_ROUNDS = {"llama3.2-1b": 4}


def nvml_energy_mj(sensor):
    """The board's energy counter since the NVIDIA driver loaded, in mJ
    (`nvmlDeviceGetTotalEnergyConsumption`, through the sensor's NVML)."""
    import ctypes
    fn = sensor.lib.nvmlDeviceGetTotalEnergyConsumption
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int
    mj = ctypes.c_ulonglong()
    rc = fn(sensor.handle, ctypes.byref(mj))
    if rc != 0:
        fail(f"nvmlDeviceGetTotalEnergyConsumption returned {rc}")
    return mj.value


def same_card(torch, sensor):
    """Fail unless the NVML board `sensor` reads is CUDA device 0."""
    nvml = sensor.uuid().lower().removeprefix("gpu-")
    cuda = str(torch.cuda.get_device_properties(0).uuid).lower() \
        .removeprefix("gpu-")
    if nvml != cuda:
        fail(f"NVML index {sensor.index} is {nvml}, CUDA device 0 is {cuda}")
    return nvml


def measured_energy(torch, rt, engine, cfg, prompt_len, prompts, limit_w):
    """Phase 8 on one path's engine: Camel rounds through
    `EngineEnvironment(sensor="nvml")` with the static scheduler and the
    continuous one, every pull's power the meter's average over NVML;
    then one window of >= 1 s of generates at MAX_BATCH metered beside
    the board's energy counter."""
    import math
    arch = cfg.name
    space = rt.make_space(f"engine/{arch}")
    rounds = ENERGY_ROUNDS.get(arch, 2)
    for scheduler in ("static", "continuous"):
        env = rt.EngineEnvironment(
            engine, rt.energy.JETSON_AGX_ORIN,
            rt.energy.ORIN_WORKLOADS["llama3.2-1b"], prompt_len=prompt_len,
            max_new_tokens=NEW_TOKENS, seed=0, sensor="nvml",
            scheduler=scheduler, requests_per_pull=ENERGY_REQUESTS,
            arrival_rate=ENERGY_RATE)
        try:
            uuid = same_card(torch, env.sensor)
            cm = rt.CostModel(alpha=0.5)
            ref_obs = env.pull(space.values(space.corner()), 0)
            cm = cm.with_reference(ref_obs.energy, ref_obs.latency)
            policy = rt.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
            res = rt.Controller(space, policy, cm, seed=0).run(env, rounds)
        finally:
            env.sensor.close()
        pulls = [("ref", space.values(space.corner()), ref_obs)] + \
            [(r.t, r.knobs, r.obs) for r in res.records]
        for t, knobs, obs in pulls:
            md = obs.metadata
            say(f"energy pull {arch} {scheduler} {t} batch={knobs['batch']} "
                f"freq_mhz={knobs['freq_mhz']} sensor={md['sensor']} "
                f"avg_watts={obs.power:.3f} sensor_joules="
                f"{md['sensor_joules']:.4f} sensor_peak_w="
                f"{md['sensor_peak_w']:.3f} sensor_samples="
                f"{md['sensor_samples']} prefill_s={md['prefill_s']:.6f} "
                f"decode_s={md['decode_s']:.6f} energy_j_per_req="
                f"{obs.energy:.5f} latency_s_per_req={obs.latency:.5f}"
                + (f" requests={md['n_requests']} decode_steps="
                   f"{md['decode_steps']} mean_occupancy="
                   f"{md['mean_occupancy']:.3f}"
                   if scheduler == "continuous" else ""))
            if md["sensor"] != "nvml:0" or not math.isfinite(obs.power) \
                    or not 0 < obs.power <= limit_w:
                fail(f"{arch} {scheduler}: pull {t} read {md['sensor']} "
                     f"at {obs.power} W (limit {limit_w} W)")
        say(f"controller summary {arch} {scheduler} (power measured through "
            f"NVML on board {uuid}): " + json.dumps(res.summary(),
                                                    default=str))
    sensor = rt.NVMLSensor()
    try:
        same_card(torch, sensor)
        meter = rt.EnergyMeter(sensor)
        n = 0
        with meter.measure() as m:
            e0, t0 = nvml_energy_mj(sensor), time.monotonic()
            while n == 0 or time.monotonic() - t0 < 1.0:
                engine.generate(prompts, NEW_TOKENS)
                n += 1
            e1, dt = nvml_energy_mj(sensor), time.monotonic() - t0
    finally:
        sensor.close()
    counter_j = (e1 - e0) / 1e3
    say(f"energy window {arch} b={len(prompts)}: generates={n} "
        f"meter_window_s={m.duration_s:.6f} meter_joules={m.joules:.4f} "
        f"meter_avg_w={m.avg_watts:.3f} meter_peak_w={m.peak_watts:.3f} "
        f"meter_samples={m.n_samples} counter_window_s={dt:.6f} "
        f"counter_joules={counter_j:.4f} counter_avg_w={counter_j / dt:.3f}"
        + (f" meter_over_counter_avg_w={m.avg_watts * dt / counter_j:.4f}"
           if counter_j > 0 else ""))
    if not (math.isfinite(m.avg_watts) and 0 < m.avg_watts <= limit_w) \
            or counter_j <= 0:
        fail(f"{arch}: the energy window read {m.avg_watts} W, the counter "
             f"{counter_j} J")


# ---------------------------------------------------------------------------
# Phase 9: the paper's search loop on the card
# ---------------------------------------------------------------------------

#: Phase 9: the pull budget of the search and fleet runs (the paper's 49
#: arms), the validation's requests (the reference's default) and the
#: fleet's devices.
SEARCH_ROUNDS, VALIDATE_REQUESTS, FLEET_SIZE = 49, 2500, 4
#: Phase 9(d): pulls of each controller on the engine.
ENGINE_PULLS = 8


def _same_records(label, a, b, rtol=1e-6, devices=False):
    """Fail unless two controller results have the same arms record by
    record (and, with `devices`, the same serving device), costs within
    `rtol` relative, and the same commit."""
    if len(a.records) != len(b.records):
        fail(f"{label}: {len(a.records)} records against {len(b.records)}")
    for ra, rb in zip(a.records, b.records):
        if (ra.t, ra.arm, ra.round, ra.slot) != (rb.t, rb.arm, rb.round,
                                                 rb.slot):
            fail(f"{label}: record {ra.t} arm {ra.arm} against {rb.arm}")
        if abs(ra.cost - rb.cost) > rtol * abs(rb.cost):
            fail(f"{label}: record {ra.t} cost {ra.cost} against {rb.cost}")
        if devices and ra.obs.metadata.get("device") != \
                rb.obs.metadata.get("device"):
            fail(f"{label}: record {ra.t} served by another device")
    if a.best_arm != b.best_arm:
        fail(f"{label}: best arm {a.best_arm} against {b.best_arm}")


def search_on_card(torch):
    """9(a)-(c): the paper's configuration search (Results 1) over the
    modelled Jetson AGX Orin landscape, its batched pulls evaluated on the
    card, for both Orin workloads, every policy but the fleet-only
    contextual one, at K 1 and 4: each run on the card against the same
    call on the CPU (the same arms record by record and commit, costs
    within 1e-6 relative).  9(b): the event-driven validation (Results 2)
    at the reference's 2500 requests.  9(c): the fleet modes on 4 devices,
    camel and contextual: the async controller without a straggler equals
    the batch one record by record, and under a 4x straggler its
    simulated wall clock and staleness are printed.  Every energy, latency
    and EDP figure here is the modelled Jetson AGX Orin, not this card's."""
    from repro_torch.core import baselines
    from repro_torch.launch import serve
    from repro_torch.serving import energy
    models = tuple(energy.ORIN_WORKLOADS)
    policies = [p for p in sorted(baselines.POLICIES) if p != "contextual"]
    for model in models:
        for policy in policies:
            for k in (1, 4):
                t0 = time.monotonic()
                out, res = serve.search_run(model, SEARCH_ROUNDS, 0.5, 0,
                                            policy, k, device="cuda")
                card_s = time.monotonic() - t0
                _, cpu = serve.search_run(model, SEARCH_ROUNDS, 0.5, 0,
                                          policy, k, device="cpu")
                _same_records(f"search {model} {policy} k={k} card vs cpu",
                              res, cpu)
                say(f"search {model} policy={policy} k={k} "
                    f"pulls={out['n_pulls']} rounds={out['n_rounds']} "
                    f"best_knobs={out['best_knobs']} "
                    f"optimal_knobs={out['optimal_knobs']} "
                    f"found_optimal={out['found_optimal']} "
                    f"cum_regret={out['cum_regret']:.6f} "
                    f"modelled_orin_edp={out['edp']:.4f} card_s={card_s:.3f} "
                    f"(card == cpu record by record)")
    for model in models:
        out = serve.validate_mode(model, VALIDATE_REQUESTS, 0.5, 0,
                                  device="cuda")
        for cname, row in out.items():
            say(f"validate {model} {cname} knobs={row['knobs']} "
                f"requests={row['n_requests']} "
                f"modelled_orin_energy_j_per_req={row['energy_per_req']:.6f} "
                f"latency_s={row['latency_per_req']:.6f} "
                f"modelled_orin_edp={row['edp']:.6f} "
                f"edp_vs_maxf_maxb={row['edp_vs_maxf_maxb']:.6f}")
        if not out["maxf_maxb"]["edp_vs_maxf_maxb"] == 0.0 or \
                not out["camel_optimal"]["edp"] > 0:
            fail(f"validate {model}: bad EDP figures")
    for policy in ("camel", "contextual"):
        sync, sres = serve.fleet_run("llama3.2-1b", SEARCH_ROUNDS, 0.5, 0,
                                     FLEET_SIZE, policy_name=policy,
                                     device="cuda")
        _, ares = serve.fleet_run("llama3.2-1b", SEARCH_ROUNDS, 0.5, 0,
                                  FLEET_SIZE, policy_name=policy,
                                  straggler=1.0, device="cuda")
        _same_records(f"fleet {policy} async vs batch", ares, sres,
                      rtol=0.0, devices=True)
        if any(r.obs.metadata["staleness"] for r in ares.records):
            fail(f"fleet {policy}: staleness without a straggler")
        slow, _ = serve.fleet_run("llama3.2-1b", SEARCH_ROUNDS, 0.5, 0,
                                  FLEET_SIZE, policy_name=policy,
                                  straggler=4.0, device="cuda")
        say(f"fleet {FLEET_SIZE}xjetson llama3.2-1b policy={policy} "
            f"batch: best_knobs={sync['best_knobs']} "
            f"found_optimal={sync['found_optimal']} rounds="
            f"{sync['n_rounds']}; async straggler 1.0 == batch record by "
            f"record; async straggler 4.0: wall_clock_sim_s="
            f"{slow['wall_clock_sim_s']:.1f} mean_staleness="
            f"{slow['mean_staleness']:.4f} max_staleness="
            f"{slow['max_staleness']} found_optimal={slow['found_optimal']}")


class HostTimed:
    """A policy whose select and update calls add their host time to
    `seconds` (signatures kept, so the controllers' keyword detection
    sees the wrapped policy's)."""

    def __init__(self, policy):
        import functools
        self.seconds = 0.0
        self.init = policy.init
        for name in ("select", "select_many", "update", "update_batch",
                     "update_stale", "update_censored"):
            fn = getattr(policy, name, None)
            if fn is None:
                continue

            def timed(*a, fn=fn, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.seconds += time.perf_counter() - t0
                return out
            setattr(self, name, functools.wraps(fn)(timed))


def controllers_on_engine(torch, rt, ops, engine, cfg, arch, prompt_len):
    """9(d): the batch controller at K 4 and the async controller at K 1,
    ENGINE_PULLS pulls each, on a path's full-width engine through
    `EngineEnvironment`: the kernel executions equal what those generates
    imply, every staleness is 0, the final posterior equals the records'
    costs chained through `update`, and the controller's host time a round
    (select + update, the pulls excluded) is printed.  Returns the
    kernel executions of both runs."""
    from repro_torch.core import bandit
    from repro_torch.core.controller import AsyncController, BatchController
    env = rt.EngineEnvironment(engine, rt.energy.JETSON_AGX_ORIN,
                               rt.energy.ORIN_WORKLOADS["llama3.2-1b"],
                               prompt_len=prompt_len,
                               max_new_tokens=NEW_TOKENS, seed=0)
    space = rt.make_space(f"engine/{arch}")
    ref = env.pull(space.values(space.corner()), 0)
    cm = rt.CostModel(alpha=0.5).with_reference(ref.energy, ref.latency)
    totals = None
    for cls, k in ((BatchController, 4), (AsyncController, 1)):
        policy = HostTimed(rt.make_policy("camel", prior_mu=1.0,
                                          prior_sigma=0.1))
        ctrl = cls(space, policy, cm, seed=0, k=k)
        counts, res = counted_run(torch, ops, engine,
                                  lambda: ctrl.run(env, ENGINE_PULLS // k))
        expected = expected_launches(engine.bundle.family, cfg,
                                     len(res.records), prompt_len)
        label = f"{cls.__name__} k={k} on {arch}"
        if counts != expected:
            fail(f"{label}: launch counts {counts} != expected {expected}")
        stale = [r.obs.metadata.get("staleness", 0) for r in res.records]
        if any(stale):
            fail(f"{label}: staleness {stale}")
        chained = bandit.init_state(space.n_arms, 1.0, 0.1)
        for r in res.records:
            chained = bandit.update(chained, r.arm, r.cost)
        for leaf in ("mu", "sigma2", "count", "sum_x", "sum_x2", "stale_n"):
            if not torch.equal(getattr(chained, leaf),
                               getattr(res.final_state, leaf)):
                fail(f"{label}: posterior {leaf} != the chained updates")
        say(f"controller {label}: pulls={len(res.records)} "
            f"rounds={res.n_rounds} arms={[r.arm for r in res.records]} "
            f"launches={counts} (expected) staleness={stale} "
            f"host_ms_per_round={1e3 * policy.seconds / res.n_rounds:.4f} "
            f"(select + update, pulls excluded) best_knobs="
            f"{res.best_knobs}")
        totals = counts if totals is None else {
            n: totals[n] + counts[n] for n in counts}
    return totals


# ---------------------------------------------------------------------------
# Phase 10: fault injection on the card
# ---------------------------------------------------------------------------

#: E14's constants (the reference's benchmarks/resilience.py:50-58): the
#: 4-device Jetson fleet, K, the exact pull budget, the seeds, the commit
#: tolerance against the fault-free commit and the two chaos specs (20 %
#: failed attempts absorbed by retries; 35 % with no retry, so failures
#: surface as censored `FailedPull`s), device 0 crashing at round 4.
E14_FLEET = "fleet/4xjetson/llama3.2-1b/landscape"
E14_K, E14_PULLS, E14_SEEDS, E14_TOL = 4, 64, (0, 1, 2), 0.05
CHAOS_SPEC = "pull_fail=0.2,crash=0@4,deadline=4,retries=3,seed=1"
CENSORED_SPEC = "pull_fail=0.35,crash=0@4,deadline=4,retries=1,seed=1"
#: A plan that arms the resilient dispatcher (a deadline, retries) and
#: never fires.
IDLE_SPEC = "deadline=1e9,retries=3"
#: 10(b)-(c): clients abandon a quarter of the requests 4 step units
#: after arrival.  10(d): the sensor drops 10 % of its reads and reads NaN
#: on 5 %.  10(e): both through `serve.py --faults`.
CANCEL_SPEC = "cancel=0.25@4.0,seed=1"
SENSOR_SPEC = "sensor_drop=0.1,sensor_nan=0.05,seed=1"
SERVE_FAULTS = "cancel=0.25@4.0,sensor_drop=0.1,sensor_nan=0.05,seed=1"
FAULT_COUNTERS = ("faults_injected_total", "retries_total",
                  "pull_faults_total", "device_faults_total")


def e14_setup(seed, device, factors=None):
    """E14's fleet on `device`: the environment's kwargs, the space, the
    cost model referenced at the (max f, max b) corner, the landscape's
    optimal cost and Camel's analytic prior."""
    from repro_torch.core import controller, cost, priors
    from repro_torch.platform import make_env, make_space
    kw = dict(noise=0.03, seed=seed, device=device)
    if factors is not None:
        kw["dispatch_factors"] = factors
    env = make_env(E14_FLEET, **kw)
    space = make_space(E14_FLEET)
    e_ref, l_ref = env.expected(space.values(space.corner()))
    cm = cost.CostModel(alpha=0.5).with_reference(e_ref, l_ref)
    _, opt_cost = controller.landscape_optimal(space, env.expected, cm)
    _, mu0, sig0 = priors.jetson_camel_policy("llama3.2-1b", space)
    return argparse.Namespace(kw=kw, env=env, space=space, cm=cm,
                              opt_cost=opt_cost, mu0=mu0, sig0=sig0)


def e14_run(setup, seed, spec=None, sink=None):
    """One AsyncController run on a fresh fleet, wrapped in `spec`'s plan
    (`wrap_env`) where one is given, inside an observing session (`sink`
    gets its trace).  Returns (result, the session's fault counters)."""
    from repro_torch import faults, obs
    from repro_torch.core import baselines, controller
    from repro_torch.platform import make_env
    env = make_env(E14_FLEET, **setup.kw)
    if spec is not None:
        env = faults.wrap_env(env, faults.parse_faults(spec))
    policy = baselines.make_policy("camel", prior_mu=setup.mu0,
                                   prior_sigma=setup.sig0)
    with obs.observing(sink) as sess:
        res = controller.AsyncController(
            setup.space, policy, setup.cm, optimal_cost=setup.opt_cost,
            seed=seed, k=E14_K).run(env, -(-E14_PULLS // E14_K),
                                    pull_budget=E14_PULLS)
    return res, {n: sess.metrics.counter(n).value for n in FAULT_COUNTERS}


def e14_stream(res):
    """A run's records as the reference's E14 compares them, bit for
    bit."""
    return [(r.t, r.arm, r.cost, r.energy, r.latency,
             r.obs.metadata["device"], r.obs.metadata["staleness"],
             r.obs.metadata["finished_at"]) for r in res.records]


def e14_on_card():
    """10(a): E14's claims with the fleet's landscape evaluated on the
    card, each run held to the same run on the CPU record by record (and
    its failed pulls and fault counters).  Seeds 0-2: the bare run, the
    zero plan and the idle armed plan bit-identical; the retry and the
    censored chaos runs spend the exact budget with faults injected
    (censored `FailedPull`s in the second).  Seed 0: a hung device (an
    infinite dispatch factor) times out on device 0, is quarantined and
    serves no record.

    The commit bound (chaos within E14_TOL of the clean commit's cost) is
    printed a cell and counted, not failed on: it is a claim about the
    reference's Thompson draws at these seeds (a `jax.random` stream),
    and the port draws from a torch generator, so its commits differ by
    design; on the port's stream seed 2's retry cell misses it (ROADMAP
    Queue 3, PERF.md §6).  Everything it depends on is held: the
    dispatcher and injectors give the reference's records under the
    deterministic grid policy (tests/test_torch_faults.py), and every run
    here equals its CPU run."""
    import dataclasses
    import io
    from repro_torch import faults
    if not faults.FaultPlan().is_zero or faults.parse_faults(
            IDLE_SPEC).is_zero:
        fail("the zero and idle plans are not what E14 needs")
    bound_met = []
    for seed in E14_SEEDS:
        runs = {}
        for device in ("cuda", "cpu"):
            setup = e14_setup(seed, device)
            bare, _ = e14_run(setup, seed)
            for spec in ("none", IDLE_SPEC):
                other, _ = e14_run(setup, seed, spec)
                if e14_stream(other) != e14_stream(bare):
                    fail(f"E14 seed {seed} on {device}: the plan {spec!r} "
                         "perturbed the run")

            def commit_cost(arm, setup=setup):
                return float(setup.cm.cost(*setup.env.expected(
                    setup.space.values(arm))))
            c_clean = commit_cost(bare.best_arm)
            runs[device] = [("clean", bare, None)]
            for label, spec in (("retry", CHAOS_SPEC),
                                ("censored", CENSORED_SPEC)):
                res, counters = e14_run(setup, seed, spec)
                n_failed = len(res.failed_pulls)
                excess = commit_cost(res.best_arm) / c_clean - 1.0
                if counters["faults_injected_total"] <= 0 or \
                        len(res.records) + n_failed != E14_PULLS or \
                        (label == "censored" and not n_failed):
                    fail(f"E14 seed {seed} {label} on {device}: injected "
                         f"{counters['faults_injected_total']}, "
                         f"{len(res.records)} ok + {n_failed} failed of "
                         f"{E14_PULLS}")
                runs[device].append((label, res, counters))
                if device == "cuda":
                    bound_met.append(excess <= E14_TOL)
                    say(f"e14 chaos seed={seed} {label} on the card: "
                        f"injected={counters['faults_injected_total']} "
                        f"retries={counters['retries_total']} "
                        f"pull_faults={counters['pull_faults_total']} "
                        f"ok_pulls={len(res.records)} failed_pulls="
                        f"{n_failed} budget={E14_PULLS} clean_commit_cost="
                        f"{c_clean:.6f} chaos_commit_cost="
                        f"{commit_cost(res.best_arm):.6f} excess="
                        f"{excess:.6f} within_tol={excess <= E14_TOL} "
                        f"(tol {E14_TOL})")
        for (label, card, cc), (_, cpu, pc) in zip(runs["cuda"],
                                                   runs["cpu"]):
            _same_records(f"E14 seed {seed} {label} card vs cpu", card, cpu,
                          devices=True)
            failed = [[dataclasses.astuple(f) for f in r.failed_pulls]
                      for r in (card, cpu)]
            if cc != pc or failed[0] != failed[1]:
                fail(f"E14 seed {seed} {label}: counters {cc} and failed "
                     f"pulls against {pc} and the CPU's")
        say(f"e14 seed={seed}: zero and idle plans == bare bit for bit; "
            f"clean, retry and censored runs card == cpu record by record")
    say(f"e14 commit bound (chaos within {E14_TOL} of the clean commit) "
        f"met in {sum(bound_met)} of {len(bound_met)} cells on the port's "
        f"Thompson stream")
    hung = {}
    for device in ("cuda", "cpu"):
        setup = e14_setup(0, device, factors=(float("inf"), 1.0, 1.0, 1.0))
        sink = io.StringIO()
        res, _ = e14_run(setup, 0, "deadline=4,retries=3", sink=sink)
        rows = [json.loads(line) for line in sink.getvalue().splitlines()]
        timeouts = [r for r in rows if r["name"] == "fault.pull"
                    and r["attrs"].get("reason") == "timeout"]
        quarantined = [r["attrs"]["worker"] for r in rows
                       if r["name"] == "fault.device"]
        served = sorted({r.obs.metadata["device"] for r in res.records})
        if len(res.records) + len(res.failed_pulls) != E14_PULLS or \
                not timeouts or any(t["attrs"]["worker"] != 0
                                    for t in timeouts) or \
                quarantined[:1] != [0] or 0 in served:
            fail(f"E14 hung device on {device}: {len(res.records)} ok, "
                 f"{len(timeouts)} timeouts, quarantined {quarantined}, "
                 f"served by {served}")
        hung[device] = res
        if device == "cuda":
            say(f"e14 hung device 0 on the card: ok_pulls="
                f"{len(res.records)}/{E14_PULLS} timeouts={len(timeouts)} "
                f"quarantined={quarantined} devices_served={served}")
    _same_records("E14 hung device card vs cpu", hung["cuda"], hung["cpu"],
                  devices=True)


def cancel_full_width(torch, rt, ops, engine, cfg, prompt_len):
    """10(b) on a path's full-width engine (MAX_BATCH slots, the graph
    phase 4 captured): E13's Poisson workload with `step_time_s=1`, bare,
    through a zero plan and under CANCEL_SPEC.  The zero plan's streams
    and records equal the bare run's bit for bit; the cancel plan cancels
    some requests but not all, each no later than the next chunk
    boundary after its deadline (deadlines are checked between chunks,
    and one scheduler iteration is at most MAX_BATCH admissions and
    CONT_CHUNK steps); the kernel executions of the three runs equal
    their prefills (seeds and one-row admissions, the refills of
    cancelled slots included) times a prefill's launches plus their
    decode steps times a step's.  Returns the counts."""
    import numpy as np
    from repro_torch import faults
    arch = cfg.name
    reqs = poisson_workload(rt, cfg, prompt_len,
                            CONT_GROUPS.get(arch, 2) * MAX_BATCH)
    stamped = faults.apply_request_faults(reqs,
                                          faults.parse_faults(CANCEL_SPEC))
    kw = dict(n_slots=MAX_BATCH, chunk=CONT_CHUNK, step_time_s=1.0)
    runs = {}

    def run():
        for label, batch in (("bare", reqs), ("zero", faults
                                              .apply_request_faults(
                                                  reqs, faults.FaultPlan())),
                             ("cancel", stamped)):
            t0 = time.monotonic()
            out, st = engine.generate_continuous(batch, **kw)
            runs[label] = (out, st, time.monotonic() - t0)

    counts, _ = counted_run(torch, ops, engine, run)
    prefills = sum(st.prefill_calls for _, st, _ in runs.values())
    steps = sum(st.decode_steps for _, st, _ in runs.values())
    expected = expected_launches(engine.bundle.family, cfg, prefills,
                                 prompt_len, steps)
    say(f"launch counts cancel {arch} over {prefills} prefills and {steps} "
        f"decode steps (bare, zero plan, {CANCEL_SPEC}): {counts} "
        f"expected {expected}")
    if counts != expected:
        fail(f"{arch}: launch counts under cancellation {counts} != "
             f"expected {expected}")

    def records(st):
        return [(r.rid, r.slot, r.admit_s, r.finish_s, r.cancelled, r.tokens)
                for r in st.records]
    (b_out, b_st, _), (z_out, z_st, _) = runs["bare"], runs["zero"]
    if b_out.keys() != z_out.keys() or any(
            not np.array_equal(b_out[k], z_out[k]) for k in b_out) or \
            records(b_st) != records(z_st):
        fail(f"{arch}: the zero plan changed the continuous run")
    out, st, wall = runs["cancel"]
    deadline = {r.rid: r.deadline_s for r in stamped}
    lags = [r.finish_s - deadline[r.rid] for r in st.records if r.cancelled]
    bound = MAX_BATCH + CONT_CHUNK
    if not 1 <= st.n_cancelled < len(reqs) or any(
            not 0 <= lag < bound for lag in lags):
        fail(f"{arch}: {st.n_cancelled} of {len(reqs)} cancelled, lags past "
             f"the deadline {lags} (bound {bound} units)")
    live = [r for r in st.records if r.cancelled and r.slot >= 0]
    say(f"cancel {arch} {CANCEL_SPEC}: requests={len(reqs)} "
        f"stamped={sum(d is not None for d in deadline.values())} "
        f"cancelled={st.n_cancelled} (live {len(live)}, queued "
        f"{st.n_cancelled - len(live)}) tokens={st.tokens_out} (bare "
        f"{b_st.tokens_out}) prefill_calls={st.prefill_calls} (bare "
        f"{b_st.prefill_calls}) decode_steps={st.decode_steps} (bare "
        f"{b_st.decode_steps}) makespan_units={st.sim_s} (bare "
        f"{b_st.sim_s}) max_lag_units={max(lags):.1f} (bound {bound}) "
        f"wall_s={wall:.4f}; zero plan == bare bit for bit")
    return counts


def cancel_smoke_card_vs_cpu(torch, rt):
    """10(c): CANCEL_SPEC on llama3.2-1b-smoke in fp32 (the engine mode's
    model, naive attention), seeded weights on the card and the same on
    the CPU: the same streams and records, cancellations included."""
    import dataclasses
    import numpy as np
    from repro_torch import faults
    cfg = dataclasses.replace(rt.configs.get_smoke("llama3.2-1b"),
                              dtype=torch.float32)
    bundle = rt.bundle_for(cfg)
    params = bundle.init_params(0, "cuda")
    reqs = faults.apply_request_faults(
        poisson_workload(rt, cfg, 12, 24), faults.parse_faults(CANCEL_SPEC))
    got = {}
    for device, p in (("cuda", params), ("cpu", _tree_to(params, "cpu"))):
        engine = rt.InferenceEngine(bundle, p, max_batch=4, max_seq_len=128,
                                    prompt_bucket=8, device=device)
        got[device] = engine.generate_continuous(reqs, n_slots=4, chunk=4,
                                                 step_time_s=1.0)
    (c_out, c_st), (h_out, h_st) = got["cuda"], got["cpu"]
    recs = [[(r.rid, r.slot, r.admit_s, r.finish_s, r.cancelled, r.tokens)
             for r in st.records] for st in (c_st, h_st)]
    same = c_out.keys() == h_out.keys() and all(
        np.array_equal(c_out[k], h_out[k]) for k in h_out)
    say(f"cancel {cfg.name} fp32 card vs CPU {CANCEL_SPEC}: requests="
        f"{len(reqs)} cancelled={c_st.n_cancelled}/{h_st.n_cancelled} "
        f"tokens_equal={same} records_equal={recs[0] == recs[1]}")
    if not same or recs[0] != recs[1] or not c_st.n_cancelled:
        fail("cancellation on the smoke model: the card and the CPU differ "
             "or nothing was cancelled")


def flaky_nvml_pull(torch, rt, engine, cfg, prompt_len, limit_w):
    """10(d): one continuous pull metered through NVML behind a
    `FlakySensor` (SENSOR_SPEC) at 200 Hz: every injected fault is one
    sample error of the pull's `Measurement`, and the pull's power and
    energy stay finite."""
    import contextlib
    import math
    from repro_torch import faults
    env = rt.EngineEnvironment(
        engine, rt.energy.JETSON_AGX_ORIN,
        rt.energy.ORIN_WORKLOADS["llama3.2-1b"], prompt_len=prompt_len,
        max_new_tokens=NEW_TOKENS, seed=0, sensor="nvml", sample_hz=200.0,
        scheduler="continuous", requests_per_pull=ENERGY_REQUESTS,
        arrival_rate=ENERGY_RATE, faults=faults.parse_faults(SENSOR_SPEC))
    measured = []
    measure = env.meter.measure

    @contextlib.contextmanager
    def keep():
        with measure() as m:
            yield m
        measured.append(m)
    env.meter.measure = keep
    try:
        if not isinstance(env.sensor, faults.FlakySensor):
            fail(f"the sensor plan did not wrap the sensor: {env.sensor}")
        same_card(torch, env.sensor._inner)
        space = rt.make_space(f"engine/{cfg.name}")
        o = env.pull(space.values(space.corner()), 0)
    finally:
        env.sensor.close()
    (m,) = measured
    injected = env.sensor.faults_injected
    say(f"flaky nvml pull {cfg.name} {SENSOR_SPEC}: sensor="
        f"{o.metadata['sensor']} reads={env.sensor._reads} injected="
        f"{injected} sample_errors={m.sample_errors} samples={m.n_samples} "
        f"avg_watts={o.power:.3f} energy_j_per_req={o.energy:.5f} "
        f"requests={o.metadata['n_requests']}")
    if m.sample_errors != injected or not injected or \
            not (math.isfinite(o.power) and 0 < o.power <= limit_w) or \
            not math.isfinite(o.energy):
        fail(f"flaky nvml pull: {m.sample_errors} sample errors for "
             f"{injected} injected faults, {o.power} W, {o.energy} J")


def serve_faults_on_card():
    """10(e): `serve.py --mode engine --scheduler continuous --faults`
    on the card prints the engine mode's keys (as without the flag) and
    `faults`."""
    import contextlib
    import io
    from repro_torch.launch import serve
    keys = {}
    for spec in (None, SERVE_FAULTS):
        argv = ["serve", "--mode", "engine", "--rounds", "2",
                "--scheduler", "continuous"]
        if spec is not None:
            argv += ["--faults", spec]
        sys.argv, buf = argv, io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main()
        out = json.loads(buf.getvalue())
        keys[spec] = set(out)
    extra = keys[SERVE_FAULTS] - keys[None]
    say(f"serve --mode engine --faults {SERVE_FAULTS!r} on the card: "
        f"faults={out.get('faults')!r} total_tokens={out['total_tokens']} "
        f"keys beyond the plain run's: {sorted(extra)}")
    if extra != {"faults"} or out["faults"] != SERVE_FAULTS or \
            keys[None] - keys[SERVE_FAULTS]:
        fail(f"serve --faults printed {sorted(keys[SERVE_FAULTS])}")


# ---------------------------------------------------------------------------
# Phase 11: the encoder-decoder at full width
# ---------------------------------------------------------------------------

#: Phase 11: the greedy tokens a run decodes, the BOS token, and the runs:
#: (batch, speech frames): the AudioStub's default 512 frames (~20 s of
#: speech) at batch 4, and the config's max_source_len at batch 1.
ENCDEC_TOKENS, ENCDEC_BOS = 16, 2
ENCDEC_RUNS = ((4, 512), (1, 4096))
#: Decode against the teacher-forced forward on the generated tokens at
#: full width in bf16: |decode - forward| <= ENCDEC_BF16_TOL * max|forward|.
#: The two round to bf16 (2^-9) in different orders at each of 48 layers'
#: products, norms and residual adds, ~1 % of the largest logit; a wrong
#: position, a stale cache slot or a dropped cross frame moves logits by
#: their own scale (PERF.md §6).
ENCDEC_BF16_TOL = 5e-2


def encdec_narrow_check(torch, rt):
    """The narrow fp32 encoder-decoder (seamless-smoke), seeded weights
    with every bias and norm given noise, on the card and on the CPU:
    forward, prefill and each decode step within 1e-4 (card vs CPU), and
    on the card each decode step against the forward within 2e-3."""
    import dataclasses
    from repro_torch.models import encdec
    from repro_torch.models.frontends import AudioStub
    cfg = dataclasses.replace(rt.configs.get_smoke("seamless-m4t-large-v2"),
                              dtype=torch.float32)
    params = encdec.init_params(cfg, 0, "cuda")
    _add_noise(torch, params, torch.Generator(device="cuda").manual_seed(2),
               _FAMILY_NOISE)
    gen = torch.Generator(device="cuda").manual_seed(4)
    speech = AudioStub(num_frames=20, d_model=cfg.d_model).synth(
        gen, 2, torch.float32) * 25.0
    tokens = torch.randint(1, cfg.vocab_size, (2, 8), device="cuda",
                           generator=gen)
    out = {}
    for device in ("cuda", "cpu"):
        p = params if device == "cuda" else _tree_to(params, "cpu")
        inputs = {"speech_embeddings": speech.to(device),
                  "tokens": tokens.to(device)}
        fwd, _ = encdec.forward(cfg, p, inputs)
        cache = encdec.init_cache(cfg, 2, 32, device)
        steps = [encdec.prefill(cfg, p, inputs, cache)[0]]
        for i in range(1, tokens.shape[1]):
            steps.append(encdec.decode_step(cfg, p, tokens[:, i].to(device),
                                            cache, i)[0])
        out[device] = (fwd.cpu(), torch.stack(steps, 1).cpu())
    card_cpu = max(float((out["cuda"][i] - out["cpu"][i]).abs().max())
                   for i in (0, 1))
    dec_fwd = float((out["cuda"][1] - out["cuda"][0]).abs().max())
    say(f"encdec fp32 {cfg.name} (2+2 layers, d_model {cfg.d_model}): "
        f"card vs CPU max_abs_diff={card_cpu:.3e} (tol 1e-4); decode vs "
        f"forward on the card max_abs_diff={dec_fwd:.3e} (tol 2e-3)")
    if not card_cpu <= 1e-4 or not dec_fwd <= 2e-3:
        fail("the narrow encoder-decoder disagrees")


def encdec_step_floor_ms(cfg, batch, frames, pos):
    """Least time of one decode step: the bytes it must read over 3.35
    TB/s.  The decoder's weights but the cross attention's K/V
    projections (the cross K/V sit in the cache), the tied embedding (the
    unembedding reads it whole), the cross cache's `frames` keys and
    values and the self cache's pos + 1, every layer, bf16."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * h * hd + 2 * d * kvh * hd + h * hd * d + 2 * h * hd \
        + 2 * kvh * hd + d
    cross = attn - 2 * d * kvh * hd - 2 * kvh * hd
    mlp = 2 * d * cfg.d_ff + cfg.d_ff + d
    weights = cfg.n_dec_layers * (attn + cross + mlp + 6 * d) + 2 * d \
        + cfg.vocab_size * d
    caches = cfg.n_dec_layers * batch * (frames + pos + 1) * kvh * hd * 2
    return (weights + caches) * 2 / HBM_BYTES_PER_S * 1e3


def encdec_step_profile(torch, name, graph, steps=4):
    """A profiled window of `steps` replays of the encoder-decoder's
    captured decode step: kernels a step, the window's device-busy share
    and the kernels that take most of its device time."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            graph.run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        say(f"encdec step window {name}: the profiler recorded no kernel "
            f"inside the replays (busy share not measured)")
        return
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    say(f"encdec step window {name}: kernels_a_step="
        f"{len(kernels) / steps:.1f} device_us_a_step={busy / steps:.1f} "
        f"device_busy_share="
        f"{busy / (end - start):.4f}")
    by_name = collections.defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    for kname, us in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        say(f"encdec_top {name} {kname[:70]}: share={sum(us) / busy:.4f} "
            f"us_a_step={sum(us) / steps:.1f} launches_a_step="
            f"{len(us) / steps:.1f}")


def encdec_full_width(torch, rt, ops, smi):
    """Phase 11: seamless-m4t-large-v2 as published, bf16, seeded random
    weights, behind the engine's `DecodeGraph`: for each ENCDEC_RUNS
    shape, AudioStub speech frames, BOS and ENCDEC_TOKENS greedy tokens
    (eager steps, then the same steps replayed as one CUDA graph a step,
    tokens equal), the encode, prefill and decode-step times (median),
    the step's byte floor, peak memory, and the decode logits against the
    teacher-forced forward on the generated tokens.  No kernel of the
    port is launched (naive attention, LayerNorm, ReLU MLP)."""
    import statistics
    from repro_torch.kernels import launch_counts
    from repro_torch.models.frontends import AudioStub
    from repro_torch.serving.engine import DecodeGraph
    cfg = rt.configs.get("seamless-m4t-large-v2")
    bundle = rt.bundle_for(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = bundle.init_params(0, "cuda")
    torch.cuda.synchronize()
    say(f"encdec full width ({smi}): {cfg.name} {cfg.n_enc_layers}+"
        f"{cfg.n_dec_layers} layers d_model={cfg.d_model} {cfg.n_heads}H x "
        f"{cfg.head_dim} d_ff={cfg.d_ff} ({cfg.act}) vocab={cfg.vocab_size} "
        f"tied={cfg.tie_embeddings} n_params={cfg.n_params} bf16_gb="
        f"{2 * cfg.n_params / 1e9:.3f} init_s={time.monotonic() - t0:.2f}")
    reset_counts(ops)

    def timed(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.monotonic()
            result = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.monotonic() - t))
        return result, statistics.median(times), times

    for batch, frames in ENCDEC_RUNS:
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(frames)
        speech = AudioStub(num_frames=frames, d_model=cfg.d_model).synth(
            gen, batch)
        bos = torch.full((batch, 1), ENCDEC_BOS, dtype=torch.long,
                         device="cuda")
        inputs = {"speech_embeddings": speech, "tokens": bos}
        engine = rt.InferenceEngine(bundle, params, max_batch=batch,
                                    max_seq_len=frames, device="cuda")
        with torch.inference_mode():
            _, enc_ms, _ = timed(lambda: bundle.module.encode(
                cfg, params, speech), 3)
            cache = bundle.init_cache(batch, frames, "cuda")
            graph = DecodeGraph(engine, batch, cache)
            (logits, _), pre_ms, _ = timed(lambda: bundle.prefill(
                params, inputs, cache), 3)
            first = torch.argmax(logits, dim=-1)
            toks, step_ms, steps = [first], [], [logits]
            for i in range(1, ENCDEC_TOKENS):
                (logits, _), ms, _ = timed(lambda: bundle.decode_step(
                    params, toks[-1], cache, i), 1)
                step_ms.append(ms)
                steps.append(logits)
                toks.append(torch.argmax(logits, dim=-1))
            eager, dec = torch.stack(toks, 1), torch.stack(steps, 1)
            # The same steps replayed: the capture's warm-up wrote self
            # slots 0-1, so prefill again, then replay from position 1.
            bundle.prefill(params, inputs, cache)
            graph.tok.copy_(first)
            graph.pos.fill_(1)
            replayed, graph_ms = [first], []
            for _ in range(1, ENCDEC_TOKENS):
                _, ms, _ = timed(graph.run, 1)
                graph_ms.append(ms)
                replayed.append(graph.tok.clone())
            replayed = torch.stack(replayed, 1)
            fwd, _ = bundle.forward(params, {
                "speech_embeddings": speech,
                "tokens": torch.cat([bos, eager[:, :-1]], 1)})
        err = float((dec - fwd).abs().max())
        ref_max = float(fwd.abs().max())
        agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        floor = encdec_step_floor_ms(cfg, batch, frames, ENCDEC_TOKENS // 2)
        say(f"encdec {cfg.name} b={batch} frames={frames} ({smi}): "
            f"encode_ms={enc_ms:.3f} prefill_ms={pre_ms:.3f} (encode, "
            f"cross K/V, BOS step) decode_step_ms eager="
            f"{statistics.median(step_ms):.3f} graph="
            f"{statistics.median(graph_ms):.3f} step_floor_ms="
            f"{floor:.4f} graph_over_floor="
            f"{statistics.median(graph_ms) / floor:.2f} "
            f"capture_s={graph.capture_s:.3f} peak_device_memory_gb="
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} "
            f"tokens={eager[0, :8].tolist()}... graph_tokens_equal="
            f"{bool(torch.equal(replayed, eager))} decode_vs_forward "
            f"max_abs_diff={err:.4e} max_abs_ref={ref_max:.4f} "
            f"rel={err / ref_max:.4e} (tol {ENCDEC_BF16_TOL}) "
            f"argmax_agree={agree:.4f}")
        if eager.shape != (batch, ENCDEC_TOKENS) or \
                not bool(torch.isfinite(dec).all()) or \
                not torch.equal(replayed, eager) or \
                not err <= ENCDEC_BF16_TOL * ref_max:
            fail(f"encdec b={batch} frames={frames}: bad tokens or logits")
        with torch.inference_mode():
            encdec_step_profile(torch, f"b={batch} frames={frames}", graph)
        del engine, graph, cache, fwd, dec
    counts = launch_counts()
    say(f"encdec launch counts (naive attention, as in the reference): "
        f"{counts}")
    if any(counts.values()):
        fail(f"the encoder-decoder launched a kernel: {counts}")
    del params


# ---------------------------------------------------------------------------
# Phase 12: training every family on the card
# ---------------------------------------------------------------------------

#: Phase 12: B sequences of S tokens a step, the steps of each run, the
#: crash step and the checkpoint period of 12(b)'s crash and resume, and
#: olmoe-1b-7b's depth in 12(d): its 16 layers hold 6.92 B parameters, 83
#: GB at the reference's 12 bytes a parameter in training (bf16 param and
#: grad, fp32 m and v), past the card's 80 GB; 4 layers hold 1.89 B.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
TRAIN_CRASH_AT, TRAIN_CKPT_EVERY = 5, 2
OLMOE_TRAIN_LAYERS = 4
#: 12(f): recurrentgemma-9b's depth, two (recurrent, recurrent, attention)
#: periods of its 38 blocks: the whole model's 9.40 B parameters take 112.8
#: GB at 12 bytes a parameter in training; 6 blocks hold 2.36 B (28.3 GB).
RGLRU_TRAIN_LAYERS = 6
#: 12(g): the encoder-decoder's batch (phase 11's b 4 x 512 speech frames)
#: and its target tokens.
ENCDEC_TRAIN = dict(batch=4, frames=512, tokens=128)
#: 12(a) and (a'): the narrow fp32 models, their batch, AdamW steps and
#: tolerances (the reference's flash-vs-naive gradient tolerance,
#: tests/test_flash_equiv.py); the encoder-decoder's speech frames.
NARROW_TRAIN_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "rwkv6-3b",
                      "recurrentgemma-9b", "seamless-m4t-large-v2")
NARROW_TRAIN = dict(batch=4, seq=32, steps=5, frames=16)
GRAD_NORM_TOL, GRAD_ELEM_TOL, NARROW_LOSS_TOL = 1e-3, 5e-3, 1e-4
#: Attention's key biases (leaves named "bk") have a zero gradient in exact
#: arithmetic: a bias on the keys moves every score of a query by the same
#: amount, which the softmax cancels.  Their gradient norm must be rounding
#: noise, at most this share of the largest leaf's (fp32 keeps ~1e-7 of a
#: sum), on both sides.
ZERO_GRAD_REL = 1e-6
#: 12(b)-(c): resumed and remat losses against the uninterrupted run's.
TRAIN_LOSS_TOL = 1e-3
#: The counters a training step moves, by name.
TRAIN_COUNTERS = ("rmsnorm", "rmsnorm_bwd", "moe_gemm",
                  "moe_gemm_dx", "moe_gemm_dw", "moe_gemm_transpose",
                  "flash_attention", "decode_attention", "wkv6", "rglru",
                  "wkv6_bwd", "rglru_bwd")


def train_counts():
    from repro_torch.kernels import backward_launch_counts, launch_counts
    counts = {**launch_counts(), **backward_launch_counts()}
    return {k: counts[k] for k in TRAIN_COUNTERS}


def expected_train_launches(cfg, steps):
    """Kernel launches of `steps` training steps of a config from the
    config alone.  The transformer: a block's RMSNorms (two, the
    post-norms and the qk-norm's two where it has them) and the final norm
    run forward and backward once a step, the backward in one launch (its
    rows and dscale's column sum); remat recomputes the blocks' forward in
    the backward, relaunching their norms, and under "full" their grouped
    GEMMs (under "dots" the products' outputs are kept).  A MoE layer runs
    three grouped products, each with a dx and a dw in the backward: in
    bf16 with their operands in place, in fp32 each on one transposed
    copy.  rwkv6: one WKV6 forward and one backward a layer, and under any
    remat but "none" one more forward a layer (the layer recomputed).
    recurrentgemma: one gated RG-LRU forward a recurrent block and its
    backward, `bwd_plan`'s launches at B TRAIN_BATCH x S TRAIN_SEQ (two:
    the chunk-local walk, then the walk from the carries), 2 L + 1
    RMSNorms forward and backward (remat recomputes nothing, as in the
    reference).  The encoder-decoder: none."""
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.models.registry import bundle_for
    family = bundle_for(cfg).family
    per_step = {}
    if family == "transformer":
        per_layer = 0
        if cfg.norm == "rmsnorm":
            per_layer = 2 + (2 if cfg.post_norms else 0)
        per_layer += 2 if cfg.qk_norm else 0
        norms = cfg.n_layers * per_layer + (cfg.norm == "rmsnorm")
        gemms = 3 * cfg.n_layers if cfg.moe is not None else 0
        rec_norms = cfg.n_layers * per_layer if cfg.remat != "none" else 0
        rec_gemms = gemms if cfg.remat == "full" else 0
        copies = 2 * gemms if cfg.dtype == torch.float32 else 0
        per_step = {"rmsnorm": norms + rec_norms, "rmsnorm_bwd": norms,
                    "moe_gemm": gemms + rec_gemms, "moe_gemm_dx": gemms,
                    "moe_gemm_dw": gemms, "moe_gemm_transpose": copies}
    elif family == "rwkv6":
        per_step = {"wkv6": cfg.n_layers * (1 + (cfg.remat != "none")),
                    "wkv6_bwd": cfg.n_layers}
    elif family == "rglru":
        norms = 2 * cfg.n_layers + 1
        bwd = rg_ops.bwd_plan(TRAIN_BATCH, TRAIN_SEQ, cfg.width,
                              rg_ops.sm_count(torch.device("cuda")))
        per_step = {"rglru": cfg.n_recurrent,
                    "rglru_bwd": cfg.n_recurrent * bwd.launches,
                    "rmsnorm": norms, "rmsnorm_bwd": norms}
    return {k: steps * per_step.get(k, 0) for k in TRAIN_COUNTERS}


def hold_train_launches(label, counts, cfg, steps, totals):
    """Fail unless a run's launch counts are what `steps` steps of `cfg`
    imply; add them to `totals`."""
    want = expected_train_launches(cfg, steps)
    say(f"train {label} launch counts {counts} expected {want}")
    if counts != want:
        fail(f"train {label}: launch counts {counts} != {want}")
    for k in totals:
        totals[k] += counts[k]


def narrow_train_check(torch, rt, card="cuda"):
    """12(a) and (a'): the smoke configs of NARROW_TRAIN_ARCHS in fp32
    (llama3.2-1b and olmoe-1b-7b, then rwkv6, recurrentgemma and
    seamless), the same params and batch on the card and on the CPU
    (plain versions): every leaf's gradient present, per leaf
    |g_card - g_cpu| <= 1e-3 |g_cpu| and elementwise within 5e-3, then
    NARROW_TRAIN["steps"] AdamW steps (`make_train_step`) whose losses
    agree within 1e-4 relative.  The encoder-decoder's batches add
    NARROW_TRAIN["frames"] seeded speech frames."""
    import dataclasses

    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import tree
    from repro_torch.training.data import DataConfig, SyntheticLM
    for arch in NARROW_TRAIN_ARCHS:
        cfg = dataclasses.replace(rt.configs.get_smoke(arch),
                                  dtype=torch.float32)
        bundle = rt.bundle_for(cfg)
        params = bundle.init_params(0, "cpu")
        data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=NARROW_TRAIN["seq"],
            global_batch=NARROW_TRAIN["batch"], seed=1))

        def batch_at(i, device, bundle=bundle, data=data, cfg=cfg):
            b = dict(data.batch(i))
            if bundle.family == "encdec":
                gen = torch.Generator().manual_seed(i)
                b["speech_embeddings"] = torch.randn(
                    (NARROW_TRAIN["batch"], NARROW_TRAIN["frames"],
                     cfg.d_model), generator=gen)
            return {k: v.to(device) for k, v in b.items()}
        grads = {}
        for side, device in (("card", card), ("cpu", "cpu")):
            p = tree.tree_map(
                lambda t: t.to(device, copy=True).requires_grad_(True),
                params)
            loss = bundle.loss_fn(p, batch_at(0, device))
            grads[side] = (loss.item(), [
                g.cpu() for g in torch.autograd.grad(loss, tree.leaves(p))])
        worst_norm = worst_elem = 0.0
        # A key bias's gradient is rounding noise on both sides, which no
        # relative norm compares: both norms must be at rounding level
        # (ZERO_GRAD_REL), and the elementwise test holds it as any other.
        scale = max(g.norm().item() for g in grads["cpu"][1])
        zero = []
        for (path, _), gc, gh in zip(tree.flatten_with_paths(params),
                                     grads["card"][1], grads["cpu"][1]):
            rel = ((gc - gh).norm() / gh.norm()).item()
            elem = ((gc - gh).abs() - GRAD_ELEM_TOL * gh.abs()).max().item()
            if path.rsplit("/", 1)[-1] == "bk":
                zero.append(path)
                rel = 0.0 if max(gc.norm().item(), gh.norm().item()) \
                    <= ZERO_GRAD_REL * scale else math.inf
            worst_norm, worst_elem = max(worst_norm, rel), max(worst_elem,
                                                               elem)
            if not (torch.isfinite(gc).all() and rel <= GRAD_NORM_TOL
                    and elem <= GRAD_ELEM_TOL):
                fail(f"train narrow {arch}: gradient of {path} on the card "
                     f"off the CPU's: |dg|/|g| {rel:.3e}, elementwise "
                     f"excess {elem:.3e}")
        losses = {}
        opt_cfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=NARROW_TRAIN["steps"])
        step = make_train_step(bundle, opt_cfg)
        for side, device in (("card", card), ("cpu", "cpu")):
            # A copy: the update is in place.
            p = tree.tree_map(lambda t: t.to(device, copy=True), params)
            state, out = opt_mod.init(p), []
            for i in range(NARROW_TRAIN["steps"]):
                p, state, metrics = step(p, state, batch_at(i, device))
                out.append(metrics["loss"].item())
            losses[side] = out
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                       losses["cpu"]))
        say(f"train narrow {arch} fp32: {len(grads['cpu'][1])} leaves "
            f"({len(zero)} key biases, a zero gradient at rounding level "
            f"on both sides: {zero}), "
            f"loss card {grads['card'][0]:.7f} cpu {grads['cpu'][0]:.7f}, "
            f"worst leaf |dg|/|g| {worst_norm:.3e} (tol {GRAD_NORM_TOL:g}), "
            f"worst elementwise excess {worst_elem:.3e} (tol "
            f"{GRAD_ELEM_TOL:g} + {GRAD_ELEM_TOL:g} |g|); AdamW losses card "
            f"{[round(x, 6) for x in losses['card']]} cpu "
            f"{[round(x, 6) for x in losses['cpu']]} worst rel {rel:.3e} "
            f"(tol {NARROW_LOSS_TOL:g})")
        if not rel <= NARROW_LOSS_TOL:
            fail(f"train narrow {arch}: AdamW losses on the card off the "
                 f"CPU's by {rel:.3e} relative")


def counted_train_run(torch, ops, label, smi, run, tokens):
    """Call `run()` on the card with every counter at 0 just before and
    read just after.  `run` returns a summary as `run_training` does
    (start_step, steps_run, step_s, losses), or None where it raised the
    failure it was asked to inject.  Prints the median step time (the
    first step left out), tokens/s at `tokens` a step, the run's own peak
    memory (the peak less what was allocated before it), the losses and
    the counts, and fails on a loss that is not finite.  Returns the
    summary, the counts and the peak."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    reset_counts(ops)
    t0 = time.monotonic()
    out = run()
    torch.cuda.synchronize()
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 - held
    wall = time.monotonic() - t0
    if out is None:
        say(f"train {label}: the injected failure raised, wall_s="
            f"{wall:.2f} peak_gb={peak:.2f} counts={counts}")
        return None, counts, peak
    step_s = statistics.median(out["step_s"][1:] or out["step_s"])
    say(f"train {label} ({smi}): steps {out['start_step']}.."
        f"{out['start_step'] + out['steps_run'] - 1} step_ms="
        f"{step_s * 1e3:.2f} first_step_ms={out['step_s'][0] * 1e3:.2f} "
        f"tokens_per_s={tokens / step_s:.0f} peak_gb={peak:.2f} "
        f"held_before_gb={held:.2f} wall_s={wall:.2f} "
        f"losses={[round(x, 5) for x in out['losses']]} counts={counts}")
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"train {label}: a loss is not finite: {out['losses']}")
    return out, counts, peak


def train_run(torch, ops, label, arch, smi, expect=True, **kw):
    """One `run_training` call at B TRAIN_BATCH x S TRAIN_SEQ on the card,
    counted (`counted_train_run`).  `expect` False: the run must raise the
    injected failure."""
    from repro_torch.launch.train import run_training

    def run():
        try:
            return run_training(arch, smoke=False, global_batch=TRAIN_BATCH,
                                seq_len=TRAIN_SEQ, device="cuda",
                                log_every=1, **kw)
        except RuntimeError as e:
            if expect or "injected failure" not in str(e):
                raise
            return None
    return counted_train_run(torch, ops, label, smi, run,
                             TRAIN_BATCH * TRAIN_SEQ)


#: `train_top` lines a profiled step prints.
TRAIN_TOP = 12


def train_profile(torch, rt, label, cfg, smi):
    """Where a training step's device time goes: one step of `cfg` at B
    TRAIN_BATCH x S TRAIN_SEQ through `make_train_step` (seeded weights,
    the synthetic stream, AdamW), profiled after two warm-up steps.  Prints
    the step's wall time under the profiler, the device's busy time and
    share of it, and the TRAIN_TOP kernels by device time (`train_top`:
    share of the busy time, ms and launches a step), like `decode_top`."""
    import collections
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.data import DataConfig, SyntheticLM
    gc.collect()
    torch.cuda.empty_cache()
    bundle = rt.bundle_for(cfg)
    params = bundle.init_params(0, torch.device("cuda"))
    state = opt_mod.init(params)
    step = make_train_step(bundle, opt_mod.AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=4))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=0))
    batches = [{k: v.to("cuda") for k, v in data.batch(i).items()}
               for i in range(3)]
    for batch in batches[:2]:
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        params, state, metrics = step(params, state, batches[2])
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        fail(f"train profile {label}: the profiler recorded no kernel")
    by_name = collections.defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    busy = sum(sum(us) for us in by_name.values())
    say(f"train profile {label} ({smi}): step_ms_profiled={wall * 1e3:.3f} "
        f"device_busy_ms={busy / 1e3:.3f} device_busy_share="
        f"{busy / 1e3 / (wall * 1e3):.4f} kernels={len(kernels)} "
        f"distinct={len(by_name)} loss={loss:.5f}")
    for kname, us in sorted(by_name.items(),
                            key=lambda kv: -sum(kv[1]))[:TRAIN_TOP]:
        say(f"train_top {label} {kname[:90]}: share={sum(us) / busy:.4f} "
            f"ms_a_step={sum(us) / 1e3:.4f} launches={len(us)}")
    del params, state, metrics, batches, prof
    gc.collect()
    torch.cuda.empty_cache()


def train_on_card(torch, rt, ops, smi):
    """Phase 12(b)-(d): llama3.2-1b as published through `run_training`,
    its crash and resume, its remat modes, and olmoe-1b-7b at full width
    cut to OLMOE_TRAIN_LAYERS layers.  Returns the launch totals of the
    counted runs."""
    import dataclasses
    import shutil
    totals = dict.fromkeys(TRAIN_COUNTERS, 0)

    def held(label, counts, cfg, steps):
        hold_train_launches(label, counts, cfg, steps, totals)

    llama = rt.configs.get("llama3.2-1b")
    n_tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"train llama3.2-1b: {llama.n_layers} layers d_model "
        f"{llama.d_model} {llama.n_heads}/{llama.n_kv_heads} x "
        f"{llama.head_dim} vocab {llama.vocab_size} n_params "
        f"{llama.n_params} bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps, attn_impl {llama.attn_impl}")
    base, counts, _ = train_run(torch, ops, "llama3.2-1b", "llama3.2-1b",
                                smi, steps=TRAIN_STEPS)
    held("llama3.2-1b", counts, llama, TRAIN_STEPS)
    train_report("llama3.2-1b", base, 6 * llama.n_params * n_tokens,
                 f"6 N tokens, N {llama.n_params}", smi)
    train_profile(torch, rt, "llama3.2-1b", llama, smi)

    # 12(b): a crash at TRAIN_CRASH_AT with a checkpoint every
    # TRAIN_CKPT_EVERY steps, then the resume (one checkpoint kept: 12.4
    # GB of bf16 params and fp32 moments each).
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(steps=TRAIN_STEPS, ckpt_dir=str(ckpt),
              ckpt_every=TRAIN_CKPT_EVERY, ckpt_keep=1)
    _, counts, _ = train_run(torch, ops, f"llama3.2-1b crash at step "
                             f"{TRAIN_CRASH_AT}", "llama3.2-1b",
                             smi, expect=False, fail_at_step=TRAIN_CRASH_AT,
                             **kw)
    held("llama3.2-1b crash", counts, llama, TRAIN_CRASH_AT)
    resumed, counts, _ = train_run(torch, ops, "llama3.2-1b resume",
                                   "llama3.2-1b", smi, **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    start = resumed["start_step"]
    held("llama3.2-1b resume", counts, llama, TRAIN_STEPS - start)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(resumed["losses"], base["losses"][start:]))
    say(f"train llama3.2-1b resume: start_step {start} losses "
        f"{[round(x, 5) for x in resumed['losses']]} uninterrupted "
        f"{[round(x, 5) for x in base['losses'][start:]]} worst rel "
        f"{rel:.3e} (tol {TRAIN_LOSS_TOL:g})")
    if start < TRAIN_CRASH_AT - 1 or \
            start + resumed["steps_run"] != TRAIN_STEPS \
            or not rel <= TRAIN_LOSS_TOL:
        fail(f"train llama3.2-1b: resume from step {start} off the "
             f"uninterrupted run (worst rel {rel:.3e})")

    # 12(c): remat "full" and "dots" against "none".
    for remat in ("full", "dots"):
        out, counts, _ = train_run(torch, ops, f"llama3.2-1b remat={remat}",
                                   "llama3.2-1b", smi, steps=TRAIN_STEPS,
                                   overrides={"remat": remat})
        held(f"llama3.2-1b remat={remat}", counts,
             dataclasses.replace(llama, remat=remat), TRAIN_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(out["losses"], base["losses"]))
        say(f"train llama3.2-1b remat={remat}: worst rel loss vs none "
            f"{rel:.3e} (tol {TRAIN_LOSS_TOL:g})")
        if not rel <= TRAIN_LOSS_TOL:
            fail(f"train llama3.2-1b remat={remat}: losses off remat=none "
                 f"by {rel:.3e}")

    # 12(d): olmoe-1b-7b at full width, cut in depth.
    olmoe = dataclasses.replace(rt.configs.get("olmoe-1b-7b"),
                                n_layers=OLMOE_TRAIN_LAYERS)
    full = rt.configs.get("olmoe-1b-7b")
    say(f"train olmoe-1b-7b: d_model {olmoe.d_model}, "
        f"{olmoe.moe.n_experts} experts top-{olmoe.moe.top_k} d_ff "
        f"{olmoe.moe.d_ff}, {olmoe.n_heads}/{olmoe.n_kv_heads} x "
        f"{olmoe.head_dim}, qk-norm, vocab {olmoe.vocab_size}; cut to "
        f"{OLMOE_TRAIN_LAYERS} of its {full.n_layers} layers: "
        f"{full.n_params} parameters x 12 bytes (bf16 param and grad, "
        f"fp32 m and v) = {12 * full.n_params / 1e9:.1f} GB > the card's "
        f"80; {olmoe.n_params} parameters at {OLMOE_TRAIN_LAYERS} layers; "
        f"capacity {olmoe.moe.capacity(TRAIN_SEQ)} a row, "
        f"{TRAIN_BATCH * olmoe.moe.capacity(TRAIN_SEQ)} rows an expert")
    out, counts, _ = train_run(torch, ops, "olmoe-1b-7b", "olmoe-1b-7b", smi,
                               steps=TRAIN_STEPS,
                               overrides={"n_layers": OLMOE_TRAIN_LAYERS})
    held("olmoe-1b-7b", counts, olmoe, TRAIN_STEPS)
    train_report("olmoe-1b-7b", out, 6 * olmoe.n_active_params * n_tokens,
                 f"6 N_active tokens, N_active {olmoe.n_active_params}", smi)
    train_profile(torch, rt, f"olmoe-1b-7b ({OLMOE_TRAIN_LAYERS} layers)",
                  olmoe, smi)
    return totals


def train_report(label, out, flops, basis, smi):
    """A run's model-FLOP utilization (`flops` a step, counted as `basis`
    says, / step s / 989e12) and the check that its last loss is below its
    first."""
    step_s = statistics.median(out["step_s"][1:])
    say(f"train {label} model_flop_utilization="
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} ({basis} / step_s "
        f"/ 989e12; {smi})")
    if not out["losses"][-1] < out["losses"][0]:
        fail(f"train {label}: the last loss is not below the first: "
             f"{out['losses']}")


def train_recurrent_on_card(torch, rt, ops, smi):
    """Phase 12(e)-(f): rwkv6-3b as published through `run_training`
    (remat "none", which fits the 80 GB card, and "full" against it),
    and recurrentgemma-9b at full width cut to RGLRU_TRAIN_LAYERS blocks,
    each at B TRAIN_BATCH x S TRAIN_SEQ for TRAIN_STEPS steps with its
    launches exact, then one profiled step.  Returns the launch totals of
    the counted runs."""
    import dataclasses
    totals = dict.fromkeys(TRAIN_COUNTERS, 0)

    # 12(e): rwkv6-3b as published.
    rw = rt.configs.get("rwkv6-3b")
    say(f"train rwkv6-3b: {rw.n_layers} layers d_model {rw.d_model} "
        f"{rw.n_heads} x {rw.head_dim} d_ff {rw.d_ff} vocab "
        f"{rw.vocab_size} n_params {rw.n_params} "
        f"({12 * rw.n_params / 1e9:.1f} GB at 12 bytes a parameter: bf16 "
        f"param and grad, fp32 m and v), bf16, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, chunk {rw.chunk}")
    runs = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(rw, remat=remat)
        out, counts, peak = train_run(
            torch, ops, f"rwkv6-3b remat={remat}", "rwkv6-3b", smi,
            steps=TRAIN_STEPS, overrides={"remat": remat})
        hold_train_launches(f"rwkv6-3b remat={remat}", counts, cfg,
                            TRAIN_STEPS, totals)
        train_report(f"rwkv6-3b remat={remat}", out,
                     6 * rw.n_params * TRAIN_BATCH * TRAIN_SEQ,
                     f"6 N tokens, N {rw.n_params}", smi)
        card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
        say(f"train rwkv6-3b remat={remat}: peak {peak:.2f} GB of the "
            f"card's {card_gb:.1f}")
        runs[remat] = out
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["full"]["losses"], runs["none"]["losses"]))
    say(f"train rwkv6-3b remat=full: worst rel loss vs none {rel:.3e} "
        f"(tol {TRAIN_LOSS_TOL:g})")
    if not rel <= TRAIN_LOSS_TOL:
        fail(f"train rwkv6-3b remat=full: losses off remat=none by "
             f"{rel:.3e}")
    train_profile(torch, rt, "rwkv6-3b", rw, smi)

    # 12(f): recurrentgemma-9b at full width, cut in depth.
    full = rt.configs.get("recurrentgemma-9b")
    rg = dataclasses.replace(full, n_layers=RGLRU_TRAIN_LAYERS)
    say(f"train recurrentgemma-9b: d_model {rg.d_model}, lru_width "
        f"{rg.width}, {rg.n_heads}/{rg.n_kv_heads} x {rg.head_dim} local "
        f"attention (window {rg.sliding_window}, naive as the reference "
        f"trains), d_ff {rg.d_ff}, vocab {rg.vocab_size} (tied); cut to "
        f"{RGLRU_TRAIN_LAYERS} of its {full.n_layers} blocks "
        f"({rg.block_types}): {full.n_params} parameters x 12 bytes = "
        f"{12 * full.n_params / 1e9:.1f} GB > the card's 80; "
        f"{rg.n_params} parameters ({12 * rg.n_params / 1e9:.1f} GB) at "
        f"{RGLRU_TRAIN_LAYERS} blocks, {rg.n_recurrent} of them recurrent")
    out, counts, peak = train_run(
        torch, ops, "recurrentgemma-9b", "recurrentgemma-9b", smi,
        steps=TRAIN_STEPS, overrides={"n_layers": RGLRU_TRAIN_LAYERS})
    hold_train_launches("recurrentgemma-9b", counts, rg, TRAIN_STEPS, totals)
    train_report("recurrentgemma-9b", out,
                 6 * rg.n_params * TRAIN_BATCH * TRAIN_SEQ,
                 f"6 N tokens, N {rg.n_params}", smi)
    say(f"train recurrentgemma-9b: depth {RGLRU_TRAIN_LAYERS} of "
        f"{full.n_layers} blocks, measured peak {peak:.2f} GB")
    train_profile(torch, rt, f"recurrentgemma-9b ({RGLRU_TRAIN_LAYERS} "
                  f"blocks)", rg, smi)
    return totals


def train_encdec_on_card(torch, rt, ops, smi):
    """Phase 12(g): seamless-m4t-large-v2 as published (bf16, seeded
    weights) through `make_train_step` (the reference's `run_training`
    refuses the encoder-decoder), TRAIN_STEPS steps on one seeded batch of
    ENCDEC_TRAIN's AudioStub speech frames and target tokens, counted
    (`counted_train_run`, tokens/s of target tokens): model-FLOP utilization
    (6 x (encoder parameters x frames + the rest x target tokens)), the
    losses falling, and no kernel launched (naive attention, LayerNorm,
    ReLU MLP, as in the reference)."""
    import gc

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.frontends import AudioStub
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.tree import leaves
    cfg = rt.configs.get("seamless-m4t-large-v2")
    bundle = rt.bundle_for(cfg)
    b, frames, n_tok = (ENCDEC_TRAIN[k] for k in ("batch", "frames",
                                                  "tokens"))
    n_enc = sum(t.numel() for t in leaves(
        [bundle.abstract_params()[k] for k in ("enc_layers",
                                               "enc_final_norm")]))
    say(f"train seamless-m4t-large-v2: {cfg.n_enc_layers}+"
        f"{cfg.n_dec_layers} layers d_model {cfg.d_model} {cfg.n_heads} x "
        f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} (tied) "
        f"n_params {cfg.n_params} ({n_enc} in the encoder), bf16, "
        f"b {b} x {frames} speech frames, {n_tok} target tokens, "
        f"{TRAIN_STEPS} steps of make_train_step on one seeded batch")

    def run():
        params = bundle.init_params(0, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.randint(1, cfg.vocab_size, (b, n_tok + 1),
                             generator=gen, device="cuda")
        batch = {"speech_embeddings": AudioStub(
                     num_frames=frames, d_model=cfg.d_model).synth(gen, b),
                 "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state = opt_mod.init(params)
        step = make_train_step(bundle, opt_mod.AdamWConfig(
            lr=3e-4, warmup_steps=min(10, TRAIN_STEPS),
            total_steps=TRAIN_STEPS))
        losses, step_s = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.monotonic()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.monotonic() - t0)
        return {"start_step": 0, "steps_run": TRAIN_STEPS,
                "step_s": step_s, "losses": losses}
    out, counts, _ = counted_train_run(torch, ops, "seamless-m4t-large-v2",
                                       smi, run, b * n_tok)
    train_report("seamless-m4t-large-v2", out,
                 6 * (n_enc * b * frames + (cfg.n_params - n_enc) * b * n_tok),
                 "6 x (encoder N x frames + the rest x target tokens)", smi)
    hold_train_launches("seamless-m4t-large-v2", counts, cfg, TRAIN_STEPS,
                        dict.fromkeys(TRAIN_COUNTERS, 0))
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    t_start = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this check needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ModuleNotFoundError as e:
        fail(f"the port is not beside this script ({e})")
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv6 import ops as wk_ops
    ops = {"rmsnorm": rms_ops, "decode_attention": dec_ops,
           "flash_attention": fl_ops, "moe_gemm": mg_ops, "wkv6": wk_ops,
           "rglru": rg_ops}

    # Phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    libs = _build.build_all()
    say(f"built {len(libs)} kernel libraries in "
        f"{time.monotonic() - t0:.2f} s: {[p.name for p in libs]}")

    # Phase 2
    main_rows = kernel_checks(torch, ops)

    # Phase 3
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.controller import Controller
    from repro_torch.core.cost import CostModel
    from repro_torch.models import rglru, rwkv6, transformer
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.registry import bundle_for
    from repro_torch.obs import EnergyMeter, NVMLSensor
    from repro_torch.platform import make_space
    from repro_torch.serving import energy
    from repro_torch.serving.engine import EngineEnvironment, InferenceEngine
    from repro_torch.serving.requests import ArrivalProcess
    from repro_torch.serving.scheduler import EngineRequest
    rt = argparse.Namespace(
        dataclasses=dataclasses, configs=configs, make_policy=make_policy,
        Controller=Controller, CostModel=CostModel, transformer=transformer,
        rwkv6=rwkv6, rglru=rglru, bundle_for=bundle_for,
        make_space=make_space, energy=energy, MoEConfig=MoEConfig,
        EngineEnvironment=EngineEnvironment, InferenceEngine=InferenceEngine,
        EngineRequest=EngineRequest, ArrivalProcess=ArrivalProcess,
        NVMLSensor=NVMLSensor, EnergyMeter=EnergyMeter)
    model_check(torch, rt)
    rwkv6_check(torch, rt)
    rglru_model_check(torch, rt)
    family_model_check(torch, rt)
    continuous_narrow_check(torch, rt)
    limit_w = float(smi.split(",")[-1].split()[0])

    # Phases 4 and 5, once per main path
    import gc
    totals = dict.fromkeys(ops, 0)
    phase9_s = phase10_s = 0.0
    for arch, prompt_len, bucket, rounds, continuous in PATHS:
        counts, n_generate, cfg, engine, prompts = serve_full_width(
            torch, rt, ops, arch, prompt_len, bucket, rounds)
        expected = expected_launches(engine.bundle.family, cfg, n_generate,
                                     prompt_len)
        say(f"launch counts {arch} over {n_generate} generate calls "
            f"({n_generate * NEW_TOKENS} decode steps): {counts} "
            f"expected {expected}")
        if counts != expected:
            fail(f"{arch}: launch counts {counts} != expected {expected}")
        for name in totals:
            totals[name] += counts[name]
        graph_vs_loop(rt, engine, prompts, engine.bundle.family, cfg)
        profile_generate(torch, engine, prompts)
        # Phase 6
        if arch == "llama3.2-1b":
            long_cache_generate(torch, rt, ops, engine, cfg)
        if arch == "qwen2-1.5b":
            int8_long_cache(torch, rt, ops, engine, cfg)
        # Phases 7 and 8
        if continuous != "none":
            counts = continuous_full_width(
                torch, rt, ops, engine, cfg, prompts, prompt_len,
                CONT_GROUPS.get(arch, 2) * MAX_BATCH,
                poisson=continuous == "all")
            for name in totals:
                totals[name] += counts[name]
        if continuous == "all":
            admission_prefill(torch, engine, cfg, prompt_len)
            measured_energy(torch, rt, engine, cfg, prompt_len, prompts,
                            limit_w)
        # Phases 9(d), 10(b) and 10(d)
        if arch == "llama3.2-1b":
            t9 = time.monotonic()
            counts = controllers_on_engine(torch, rt, ops, engine, cfg,
                                           arch, prompt_len)
            for name in totals:
                totals[name] += counts[name]
            phase9_s += time.monotonic() - t9
            t10 = time.monotonic()
            counts = cancel_full_width(torch, rt, ops, engine, cfg,
                                       prompt_len)
            for name in totals:
                totals[name] += counts[name]
            flaky_nvml_pull(torch, rt, engine, cfg, prompt_len, limit_w)
            phase10_s += time.monotonic() - t10
        del engine, prompts
        gc.collect()
        torch.cuda.empty_cache()

    # Phase 9(a)-(c)
    t9 = time.monotonic()
    search_on_card(torch)
    phase9_s += time.monotonic() - t9
    say(f"phase 9 seconds={phase9_s:.1f}")

    # Phase 10(a), (c) and (e)
    t10 = time.monotonic()
    e14_on_card()
    cancel_smoke_card_vs_cpu(torch, rt)
    serve_faults_on_card()
    phase10_s += time.monotonic() - t10
    say(f"phase 10 seconds={phase10_s:.1f}")

    # Phase 11, after every path's weights are freed
    t11 = time.monotonic()
    encdec_narrow_check(torch, rt)
    encdec_full_width(torch, rt, ops, smi)
    say(f"phase 11 seconds={time.monotonic() - t11:.1f}")

    # Phase 12, after phase 11 frees its weights
    t12 = time.monotonic()
    narrow_train_check(torch, rt)
    train_totals = train_on_card(torch, rt, ops, smi)
    for name, n in train_recurrent_on_card(torch, rt, ops, smi).items():
        train_totals[name] += n
    train_encdec_on_card(torch, rt, ops, smi)
    for name in ("rmsnorm", "moe_gemm", "wkv6", "rglru"):
        totals[name] += train_totals[name]
    say(f"phase 12 seconds={time.monotonic() - t12:.1f}")

    say(f"chip_smoke total_s={time.monotonic() - t_start:.1f}")
    record = []
    for name, (source, replaces) in KERNELS.items():
        row = main_rows[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": totals[name],
                       **row})
    for name, (source, replaces) in BACKWARD_KERNELS.items():
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces,
                       "replaces_note": BACKWARD_NOTE,
                       "launches": train_totals[name], **main_rows[name]})
    say(json.dumps({"kernels": record}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
