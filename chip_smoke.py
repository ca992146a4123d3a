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
     combine kernel) and 28, and the grouped GEMM also at olmoe's prefill
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
     S 64, H 40, N 64, chunk 32) and decode (S 1, chunk 1) shapes, from a
     nonzero state.  The RG-LRU scan (fp32 only: the recurrence's inputs
     and state are fp32 in the model) runs at recurrentgemma-9b's prefill
     (B 28, S 16, W 4096) and decode (S 1) shapes from a nonzero state and
     is held, on h and on the final state, to SUM_TOLERANCE's 1e-4 as
     |err| <= 1e-4 * (1 + |ref|): the state carries every earlier step,
     summed in another order by the plain version.  Prefill attention also
     runs at recurrentgemma-9b's heads (16/1 x 256, window 2048), and
     RMSNorm at its d_model 4096;
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
     versions), within 1e-4;
  4. the main paths: llama3.2-1b (4a) and olmoe-1b-7b (4b) at full width
     (16 layers, d_model 2048, bf16, attn_impl="flash", 16-token prompts)
     and rwkv6-3b (4c: 32 layers, d_model 2560, bf16, 64-token prompts in
     buckets of 32, so prefill is two chunks and no tail) and
     recurrentgemma-9b (4d: 38 blocks, d_model 4096, bf16,
     attn_impl="flash", 16-token prompts; its attention caches are plain
     128-slot caches, min(128, 2048), so the window is inert here and the
     ring is exercised by phase 3), with seeded
     random weights made on the card, behind the port's InferenceEngine
     and EngineEnvironment, each driven by CostModel + Controller + CamelTS
     for 8 rounds as `serve.py --mode engine` does, with per-pull prefill
     and decode times against the decode step's floor (the bytes it must
     read: weights, and for rwkv6 and recurrentgemma the recurrent state
     read and written, and recurrentgemma's attention caches read).
     Energy is the Jetson Orin analytical board model applied to measured
     wall time: modelled, not measured on this card;
  5. after each path, its launch counters equal what the path implies
     (counters set to 0 just before the path and read just after; every
     kernel off the path at 0; the 128-slot caches never launch decode
     attention's combine kernel), then a torch.profiler breakdown of one
     more full-width generate (kernel time by name, device busy share);
  6. after llama3.2-1b's path, one profiled generate on a second engine
     with the same params over a 4096-slot cache (batch 4, 4000-token
     prompts): decode attention splits the KV axis there, and the launch
     counts of that generate must show the combine kernel once a layer a
     decode step.

The line before the last holds the card's name and power limit, the one
before it the kernels' JSON record (`launches` summed over the four
paths' counted runs; times at the llama shapes for the attention and norm
kernels, at olmoe's decode gate/up product for the grouped GEMM, at
rwkv6-3b's decode step for WKV6 and at recurrentgemma-9b's decode step
for the RG-LRU scan), and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # fp32 outside the tensor cores
TOLERANCE = {"bfloat16": 2e-2, "float32": 2e-5}
#: Relative tolerance (|err| <= tol * (1 + |ref|)) of the kernels whose
#: outputs are long sums: the grouped GEMM, WKV6 and the RG-LRU scan.
SUM_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}
ROUNDS = 8
MAX_BATCH, MAX_SEQ_LEN, PROMPT_LEN, NEW_TOKENS = 28, 128, 16, 8
#: The main paths: (arch, prompt length, prompt bucket).  rwkv6-3b's
#: prompts are two whole chunks of 32, so its prefill runs the chunked
#: kernel once a layer and no per-token tail.
PATHS = (("llama3.2-1b", PROMPT_LEN, PROMPT_LEN),
         ("olmoe-1b-7b", PROMPT_LEN, PROMPT_LEN),
         ("rwkv6-3b", 64, 32),
         ("recurrentgemma-9b", PROMPT_LEN, PROMPT_LEN))

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
#: Substrings of the port's CUDA kernel names (csrc/*.cu).
PORT_KERNEL_NAMES = ("rmsnorm_kernel", "attention_kernel", "moe_gemm_",
                     "wkv6_", "rglru_", "decode_attention_split",
                     "decode_attention_combine")
#: The long-cache generate of phase 6: llama3.2-1b at batch 4 over a
#: 4096-slot cache (4000-token prompts), where decode attention splits the
#: KV axis across CTAs and merges the partials in a second kernel.
LONG_BATCH, LONG_SEQ_LEN, LONG_PROMPT = 4, 4096, 4000
WKV6_LIBRARY_NOTE = ("no single PyTorch call computes the WKV6 recurrence "
                     "(no library kernel for it), so library_ms is null")
RGLRU_LIBRARY_NOTE = ("no single PyTorch call computes a first-order linear "
                      "recurrence (no library kernel for it), so library_ms "
                      "is null")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, inner: int = 10):
    """Per-call times of `fn` from CUDA events, medians over `reps` windows
    of `inner` back-to-back calls, after a warm-up.  Returns (device_ms,
    call_ms): device_ms with the stream primed by a sleep kernel long
    enough that the host enqueues the whole window before the device
    reaches it (so the window holds device time only; a window the device
    caught up with is discarded and the sleep doubled); call_ms unprimed,
    i.e. bounded by how fast the host can issue the calls."""
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


def wkv6_flops(b, s, h, n, chunk):
    """Operations of the WKV6 kernel on these shapes: per token and (b, h)
    7 N^2 in the step form (chunk 1); per chunk 4 C N^2 (inter-chunk
    product and state update) + 2 C (C - 1) N (intra-chunk weights and
    their product with v, strictly lower triangle) + 4 C N (bonus) + 2 N^2
    (state decay) in the chunked form."""
    if chunk == 1:
        return b * h * s * 7 * n * n
    per_chunk = 4 * chunk * n * n + 2 * chunk * (chunk - 1) * n \
        + 4 * chunk * n + 2 * n * n
    return b * h * (s // chunk) * per_chunk


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, ops):
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures, main = [], {}

    def rnd(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def flat(out):
        """One fp32 vector of a kernel's output (a tensor or a tuple)."""
        outs = out if isinstance(out, tuple) else (out,)
        return torch.cat([t.float().flatten() for t in outs])

    def check(name, dtype_name, shape, kernel, plain, library, nbytes,
              flops, is_main, long_sums=False, compute_dtype=None,
              library_note=None, to_max_ref=False):
        out, ref = flat(kernel()), flat(plain())
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = diff.max().item()
        # Long sums are held as |err| <= tol * (1 + |ref|): one bf16
        # rounding step of a GEMM output of magnitude 4-8 is 0.03.  Small
        # outputs (attention over thousands of keys, RMS ~0.03) are held
        # as |err| <= tol * max|ref|.
        if long_sums:
            scaled = (diff / (1 + ref.abs())).max().item()
        elif to_max_ref:
            scaled = err / ref.abs().max().item()
        else:
            scaled = err
        finite = bool(torch.isfinite(out).all().item())
        (ms, call_ms), (plain_ms, _) = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library)[0] if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[compute_dtype or dtype_name]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        tol = (SUM_TOLERANCE if long_sums else TOLERANCE)[dtype_name]
        say(f"kernel {name} dtype={dtype_name} shape={shape} "
            f"kernel_ms={ms:.5f} call_ms={call_ms:.5f} "
            f"plain_ms={plain_ms:.5f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
            f"bytes={int(nbytes)} flops={int(flops)} "
            f"max_abs_err={err:.3e}"
            + (f" err_over_1_plus_ref={scaled:.3e}" if long_sums else "")
            + (f" err_over_max_ref={scaled:.3e}" if to_max_ref else "")
            + f" tol={tol:g} finite={finite}")
        if not finite or not scaled <= tol:
            failures.append(f"{name} {dtype_name} {shape}: err={scaled} "
                            f"finite={finite}")
        if is_main:
            main[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}
            if library_note is not None:
                main[name]["library_note"] = library_note

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

    def prefill_case(dtype_name, h, kvh, d, is_main, window=0):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        b, sq = MAX_BATCH, PROMPT_LEN
        q, k, v = rnd((b, sq, h, d), dt), rnd((b, sq, kvh, d), dt), \
            rnd((b, sq, kvh, d), dt)
        starts = ints(0, 8, b)
        pos = torch.arange(sq, device=dev)
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] >= starts[:, None, None].long()))
        if window:
            mask = mask & (pos[None, None, :] > pos[None, :, None] - window)
        pairs = int(mask.sum())
        shape = (b, sq, kvh, h // kvh, d) + ((f"window {window}",)
                                             if window else ())
        check("flash_attention", dtype_name, shape,
              lambda: ops["flash_attention"].flash_attention(
                  q, k, v, window=window, kv_start=starts),
              lambda: ops["flash_attention"].attention_ref(
                  q, k, v, window=window, kv_start=starts),
              lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  attn_mask=mask[:, None], enable_gqa=True),
              (2 * q.numel() + 2 * k.numel()) * e + 4 * b,
              4 * pairs * h * d, is_main)

    def wkv6_case(dtype_name, s_len, chunk, is_main):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        wk = ops["wkv6"]
        b, h, n = MAX_BATCH, 40, 64
        shape = (b, s_len, h, n)
        r, k, v = rnd(shape, dt, 0.5), rnd(shape, dt, 0.5), rnd(shape, dt)
        logw = (-torch.exp(rnd(shape, torch.float32) - 2.0)).clamp(-4.0,
                                                                   -1e-6)
        u = rnd((h, n), torch.float32, 0.2)
        st0 = rnd((b, h, n, n), torch.float32, 0.5)
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
        check("wkv6", dtype_name, (b, s_len, h, n, f"chunk {chunk}"),
              kernel, plain, None, nbytes,
              wkv6_flops(b, s_len, h, n, chunk), is_main, long_sums=True,
              compute_dtype="float32", library_note=WKV6_LIBRARY_NOTE)

    def rglru_case(s_len, is_main):
        rg = ops["rglru"]
        b, w = MAX_BATCH, 4096
        shape = (b, s_len, w)
        f32 = torch.float32
        # The model's decay range: log_a = -8 softplus(lambda) r with
        # lambda from the reference's init and r a sigmoid gate.
        u = torch.empty((w,), device=dev).uniform_(0.9, 0.999, generator=gen)
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
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
              3 * n, is_main, long_sums=True,
              library_note=RGLRU_LIBRARY_NOTE)

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
            check("moe_gemm", dtype_name, (64, c, k_dim, n_dim),
                  lambda: ops["moe_gemm"].grouped_gemm(x, w),
                  lambda: ops["moe_gemm"].moe_gemm_ref(x, w),
                  lambda: torch.bmm(x, w),
                  (x.numel() + w.numel() + 64 * c * n_dim) * e,
                  2 * 64 * c * k_dim * n_dim,
                  is_bf16 and (c, k_dim) == (8, 2048), long_sums=True)
            del x, w

        # WKV6 at rwkv6-3b's heads (40 x 64), batch 28, from a nonzero
        # state: the chunked prefill (64 tokens, chunk 32) and the decode
        # step.  The kernel computes in fp32 whatever the input type.
        for s_len, chunk in ((64, 32), (1, 1)):
            wkv6_case(dtype_name, s_len, chunk, is_bf16 and s_len == 1)

    # The RG-LRU scan at recurrentgemma-9b's width (4096) and batch 28: the
    # prompt's scan (16 tokens) and the decode step, in fp32.
    for s_len in (PROMPT_LEN, 1):
        rglru_case(s_len, s_len == 1)
    if failures:
        fail("kernel != plain version: " + "; ".join(failures))
    return main


# ---------------------------------------------------------------------------
# Phase 3: flash vs naive at model level, fp32
# ---------------------------------------------------------------------------

def _run_narrow(torch, rt, cfg, params, toks, mask, feed, steps, device,
                max_len=None):
    """Prefill + `steps` decode steps on `device` into a cache built for
    `max_len` (default: the prompt + 16); decode feeds `feed[i]` when
    given, else appends the greedy token to `feed`.  Logits [steps+1, B, V]
    on the CPU."""
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
    return torch.stack(seq).cpu()


def model_check(torch, rt):
    """fp32 narrow models: flash (kernels) vs naive logits on the card, and
    for olmoe the same weights on the card vs on the CPU (plain
    versions)."""
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    narrow = {
        "llama": rt.transformer.TransformerConfig(
            name="llama-narrow", n_layers=2, d_model=512, n_heads=32,
            n_kv_heads=8, head_dim=64, d_ff=1024, vocab_size=1024,
            rope_theta=500000.0, dtype=torch.float32),
        # olmoe's head geometry, qk-norm, untied head and MoE FFN; capacity
        # factor 8 as tests/test_models_decode_equiv.py sets it.
        "olmoe": rt.transformer.TransformerConfig(
            name="olmoe-narrow", n_layers=2, d_model=256, n_heads=4,
            n_kv_heads=4, head_dim=128, d_ff=512, vocab_size=1024,
            qk_norm=True, tie_embeddings=False,
            moe=rt.MoEConfig(n_experts=8, top_k=2, d_ff=512,
                             capacity_factor=8.0),
            dtype=torch.float32),
    }
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
    cfg = rt.rwkv6.RWKV6Config(
        name="rwkv6-narrow", n_layers=2, d_model=256, head_dim=64, d_ff=512,
        vocab_size=1024, lora_rank_decay=16, lora_rank_mix=8, chunk=16,
        dtype=torch.float32)
    params = rt.bundle_for(cfg).init_params(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _add_noise(torch, params, gen, _RWKV6_NOISE)
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
    base = rt.rglru.RGLRUConfig(
        name="recurrentgemma-narrow", n_layers=3, d_model=256, n_heads=16,
        n_kv_heads=1, head_dim=256, d_ff=512, vocab_size=1024,
        lru_width=256, sliding_window=16, dtype=torch.float32)
    params = rt.bundle_for(base).init_params(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _add_noise(torch, params, gen, _RGLRU_NOISE)
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

def weight_read_floor_ms(family, cfg, batch):
    """Least time of one decode step at `batch`: the bytes it must move
    over 3.35 TB/s.  Transformers: every weight the step reads (attention,
    the router, the LM head, and each expert whose capacity buffer the
    step computes -- all of them, since decode capacity is at least top_k
    rows an expert).  rwkv6: every weight but the embedding table (its B
    rows only) and the recurrent state (WKV fp32, token shifts bf16) read
    and written once.  recurrentgemma: every weight (the tied unembedding
    reads the whole table), the attention caches read once, and the
    recurrent state (`lru_h` fp32, `conv_tail` bf16) read and written
    once."""
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
    attn = 2 * d * cfg.n_heads * cfg.head_dim + \
        2 * d * cfg.n_kv_heads * cfg.head_dim
    if cfg.moe is None:
        ffn = 3 * d * cfg.d_ff * e
    else:
        m = cfg.moe
        ffn = 3 * m.n_experts * d * m.d_ff * e + d * m.n_experts * 4
    return (cfg.n_layers * (attn * e + ffn) + head) / HBM_BYTES_PER_S * 1e3


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
    ffn = (f"d_ff={cfg.d_ff}" if cfg.moe is None else
           f"moe={cfg.moe.n_experts}x top-{cfg.moe.top_k} "
           f"d_ff={cfg.moe.d_ff} qk_norm={cfg.qk_norm} "
           f"tied={cfg.tie_embeddings}")
    return (f"{cfg.name} {cfg.n_layers}L d_model={cfg.d_model} "
            f"{cfg.n_heads}H/{cfg.n_kv_heads}KV x {cfg.head_dim} {ffn} "
            f"attn_impl={cfg.attn_impl}")


def serve_full_width(torch, rt, ops, arch, prompt_len, bucket):
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

    reset_counts(ops)
    space = rt.make_space(f"engine/{arch}")
    cm = rt.CostModel(alpha=0.5)
    ref_obs = env.pull(space.values(space.corner()), 0)
    cm = cm.with_reference(ref_obs.energy, ref_obs.latency)
    policy = rt.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
    res = rt.Controller(space, policy, cm, seed=0).run(env, ROUNDS)
    torch.cuda.synchronize()
    counts = read_counts(ops)

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


def read_counts(ops):
    """Each kernel's launches, and decode attention's combine launches."""
    counts = {name: m.launches for name, m in ops.items()}
    counts["decode_attention_combine"] = \
        ops["decode_attention"].combine_launches
    return counts


def expected_launches(family, cfg, n_generate, prompt_len):
    """Launches one path must make over `n_generate` generate calls (one
    prefill of `prompt_len` tokens and NEW_TOKENS decode steps each)."""
    n_layers = cfg.n_layers
    steps = n_generate * NEW_TOKENS
    counts = dict.fromkeys(KERNELS, 0)
    counts["decode_attention_combine"] = 0     # 128-slot caches: one split
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
        return counts
    norms = 4 * n_layers + 1 if cfg.qk_norm else 2 * n_layers + 1
    counts.update({"decode_attention": n_layers * steps,
                   "flash_attention": n_layers * n_generate,
                   "moe_gemm": 3 * n_layers * passes
                   if cfg.moe is not None else 0,
                   "rmsnorm": norms * passes})
    return counts


def profile_generate(torch, engine, prompts):
    """Kernel time by name over one full-width generate at batch 28."""
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
    # The port's own kernels as the path runs them (caches as they are
    # there, not as a timing loop leaves them).
    for ev in kernels:
        if any(k in ev.key for k in PORT_KERNEL_NAMES):
            say(f"kernel_in_path {engine.bundle.name} {ev.key[:70]}: "
                f"launches={ev.count} device_us_per_launch="
                f"{ev.self_device_time_total / ev.count:.3f}")


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
    reset_counts(ops)
    profile_generate(torch, long_engine, prompts)
    counts = read_counts(ops)
    expected = expected_launches("transformer", cfg, 1, LONG_PROMPT)
    expected["decode_attention_combine"] = cfg.n_layers * NEW_TOKENS
    say(f"launch counts long cache {cfg.name} over 1 generate call "
        f"({NEW_TOKENS} decode steps): {counts} expected {expected}")
    if counts != expected:
        fail(f"long cache: launch counts {counts} != expected {expected}")


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
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
    import repro_torch.configs as configs
    from repro_torch.core.baselines import make_policy
    from repro_torch.core.controller import Controller
    from repro_torch.core.cost import CostModel
    from repro_torch.models import rglru, rwkv6, transformer
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.registry import bundle_for
    from repro_torch.platform import make_space
    from repro_torch.serving import energy
    from repro_torch.serving.engine import EngineEnvironment, InferenceEngine
    rt = argparse.Namespace(
        configs=configs, make_policy=make_policy, Controller=Controller,
        CostModel=CostModel, transformer=transformer, rwkv6=rwkv6,
        rglru=rglru, bundle_for=bundle_for,
        make_space=make_space, energy=energy, MoEConfig=MoEConfig,
        EngineEnvironment=EngineEnvironment, InferenceEngine=InferenceEngine)
    model_check(torch, rt)
    rwkv6_check(torch, rt)
    rglru_model_check(torch, rt)

    # Phases 4 and 5, once per main path
    totals = dict.fromkeys(ops, 0)
    for arch, prompt_len, bucket in PATHS:
        counts, n_generate, cfg, engine, prompts = serve_full_width(
            torch, rt, ops, arch, prompt_len, bucket)
        expected = expected_launches(engine.bundle.family, cfg, n_generate,
                                     prompt_len)
        say(f"launch counts {arch} over {n_generate} generate calls "
            f"({n_generate * NEW_TOKENS} decode steps): {counts} "
            f"expected {expected}")
        if counts != expected:
            fail(f"{arch}: launch counts {counts} != expected {expected}")
        for name in totals:
            totals[name] += counts[name]
        profile_generate(torch, engine, prompts)
        if arch == "llama3.2-1b":
            long_cache_generate(torch, rt, ops, engine, cfg)
        del engine
        torch.cuda.empty_cache()

    record = []
    for name, (source, replaces) in KERNELS.items():
        row = main_rows[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": totals[name],
                       **row})
    say(json.dumps({"kernels": record}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
