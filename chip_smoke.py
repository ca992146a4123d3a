#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # the whole check, one card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card (`nvidia-smi` name and power limit) and the build of every
     kernel from `src/repro_torch/csrc` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, in bf16
     and fp32, at the shapes the two engine paths give it (llama3.2-1b and
     olmoe-1b-7b geometry), with its device time (CUDA events over a
     primed stream, median of repeats), its per-call time when the host
     issues the calls (`call_ms`: launch overhead included), the plain
     version's device time, one PyTorch library call's (`F.rms_norm`,
     `F.scaled_dot_product_attention`, `torch.bmm`; timed here only, never
     used by the port) and the least time the card could take (bytes over
     3.35 TB/s or operations over the dtype's peak, whichever is larger).
     Tolerances: 2e-2 in bf16, 2e-5 in fp32 (max abs error); the grouped
     GEMM, whose outputs are sums over K = 1024-2048 products, 2e-2 / 1e-4
     as |err| <= tol * (1 + |ref|);
  3. model level in fp32 on narrow configs: llama3.2-1b's head geometry
     and olmoe-1b-7b's (qk-norm, untied head, 8 experts top-2 at capacity
     factor 8 so no near-tie can move a token to another expert).  The
     "flash" (kernel) and "naive" logits over a left-padded prefill and 4
     decode steps agree within 1e-4, and for olmoe the same weights run on
     the CPU (plain versions) agree with the card within 1e-4;
  4. the main paths: llama3.2-1b (4a) and olmoe-1b-7b (4b) at full width
     (16 layers, d_model 2048, bf16, attn_impl="flash", seeded random
     weights made on the card) behind the port's InferenceEngine and
     EngineEnvironment, each driven by CostModel + Controller + CamelTS for
     8 rounds as `serve.py --mode engine` does, with per-pull prefill and
     decode times against the decode step's weight-read floor.  Energy is
     the Jetson Orin analytical board model applied to measured wall time:
     modelled, not measured on this card;
  5. after each path, its launch counters equal what the path implies
     (counters set to 0 just before the path and read just after), then a
     torch.profiler breakdown of one more full-width generate (kernel time
     by name, device busy share).

The line before the last holds the card's name and power limit, the one
before it the kernels' JSON record (`launches` summed over both paths'
counted runs; times at the llama shapes for the attention and norm
kernels, as in the previous slice, and at olmoe's decode gate/up product
for the grouped GEMM), and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
GEMM_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}
ROUNDS = 8
MAX_BATCH, MAX_SEQ_LEN, PROMPT_LEN, NEW_TOKENS = 28, 128, 16, 8

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
}


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

    def check(name, dtype_name, shape, kernel, plain, library, nbytes,
              flops, is_main, gemm=False):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        # The grouped GEMM is held as |err| <= tol * (1 + |ref|): one bf16
        # rounding step of an output of magnitude 4-8 is 0.03.
        scaled = (diff / (1 + ref.float().abs())).max().item() if gemm \
            else err
        finite = bool(torch.isfinite(out).all().item())
        (ms, call_ms), (plain_ms, _) = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library)[0] if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype_name]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        tol = (GEMM_TOLERANCE if gemm else TOLERANCE)[dtype_name]
        say(f"kernel {name} dtype={dtype_name} shape={shape} "
            f"kernel_ms={ms:.5f} call_ms={call_ms:.5f} "
            f"plain_ms={plain_ms:.5f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
            f"bytes={int(nbytes)} flops={int(flops)} "
            f"max_abs_err={err:.3e}"
            + (f" err_over_1_plus_ref={scaled:.3e}" if gemm else "")
            + f" tol={tol:g} finite={finite}")
        if not finite or not scaled <= tol:
            failures.append(f"{name} {dtype_name} {shape}: err={scaled} "
                            f"finite={finite}")
        if is_main:
            main[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}

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
              4 * keys * h * d, is_main)

    def prefill_case(dtype_name, h, kvh, d, is_main):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        b, sq = MAX_BATCH, PROMPT_LEN
        q, k, v = rnd((b, sq, h, d), dt), rnd((b, sq, kvh, d), dt), \
            rnd((b, sq, kvh, d), dt)
        starts = ints(0, 8, b)
        pos = torch.arange(sq, device=dev)
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] >= starts[:, None, None].long()))
        pairs = int(mask.sum())
        check("flash_attention", dtype_name, (b, sq, kvh, h // kvh, d),
              lambda: ops["flash_attention"].flash_attention(
                  q, k, v, kv_start=starts),
              lambda: ops["flash_attention"].attention_ref(
                  q, k, v, kv_start=starts),
              lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  attn_mask=mask[:, None], enable_gqa=True),
              (2 * q.numel() + 2 * k.numel()) * e + 4 * b,
              4 * pairs * h * d, is_main)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        is_bf16 = dtype_name == "bfloat16"

        # RMSNorm: prefill rows (28 x 16) and decode rows (28), d 2048, and
        # olmoe's qk-norm rows (28 x 16 tokens x 16 heads, 128 wide).
        for rows_shape in ((MAX_BATCH, PROMPT_LEN, 2048), (MAX_BATCH, 2048),
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
        # and one long cache; olmoe (16/16 x 128) at batch 28.
        for b, s_len, lo, hi in ((4, MAX_SEQ_LEN, 16, 25),
                                 (MAX_BATCH, MAX_SEQ_LEN, 16, 25),
                                 (4, 4096, 4096, 4097)):
            decode_case(dtype_name, b, s_len, lo, hi, 32, 8, 64,
                        is_bf16 and b == MAX_BATCH and s_len == MAX_SEQ_LEN)
        decode_case(dtype_name, MAX_BATCH, MAX_SEQ_LEN, 16, 25, 16, 16, 128,
                    False)

        # Prefill attention: 28 x 16 tokens with left pads, both geometries.
        prefill_case(dtype_name, 32, 8, 64, is_bf16)
        prefill_case(dtype_name, 16, 16, 128, False)

        # Grouped expert GEMM at olmoe-1b-7b's products: decode gate/up and
        # down (64 experts x capacity 8) and prefill gate/up at batch 28
        # (capacity 8 per row, 224 rows an expert).  Weights scaled as
        # moe_init scales them (truncated normal / sqrt(K)).
        for c, k_dim, n_dim in ((8, 2048, 1024), (8, 1024, 2048),
                                (MAX_BATCH * 8, 2048, 1024)):
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
                  is_bf16 and (c, k_dim) == (8, 2048), gemm=True)
            del x, w
    if failures:
        fail("kernel != plain version: " + "; ".join(failures))
    return main


# ---------------------------------------------------------------------------
# Phase 3: flash vs naive at model level, fp32
# ---------------------------------------------------------------------------

def _run_narrow(torch, rt, cfg, params, toks, mask, feed, steps, device):
    """Prefill + `steps` decode steps on `device`; decode feeds `feed[i]`
    when given, else appends the greedy token to `feed`.  Logits [steps+1,
    B, V] on the CPU."""
    b, plen = toks.shape
    max_len = plen + 16
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phase 4: the main paths at full width
# ---------------------------------------------------------------------------

def weight_read_floor_ms(cfg, batch):
    """Least time of one decode step at `batch`: the bytes of every weight
    the step must read (attention, the router, the LM head, and each expert
    whose capacity buffer the step computes -- all of them, since decode
    capacity is at least top_k rows an expert) over 3.35 TB/s."""
    d, e = cfg.d_model, 2   # bf16
    attn = 2 * d * cfg.n_heads * cfg.head_dim + \
        2 * d * cfg.n_kv_heads * cfg.head_dim
    if cfg.moe is None:
        ffn = 3 * d * cfg.d_ff * e
    else:
        m = cfg.moe
        ffn = 3 * m.n_experts * d * m.d_ff * e + d * m.n_experts * 4
    head = cfg.vocab_size * d * e + batch * d * e
    return (cfg.n_layers * (attn * e + ffn) + head) / HBM_BYTES_PER_S * 1e3


def serve_full_width(torch, rt, ops, arch):
    import dataclasses
    import numpy as np
    cfg = dataclasses.replace(rt.configs.get(arch), attn_impl="flash")
    bundle = rt.bundle_for(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = bundle.init_params(0, "cuda")
    torch.cuda.synchronize()
    ffn = (f"d_ff={cfg.d_ff}" if cfg.moe is None else
           f"moe={cfg.moe.n_experts}x top-{cfg.moe.top_k} "
           f"d_ff={cfg.moe.d_ff} qk_norm={cfg.qk_norm} "
           f"tied={cfg.tie_embeddings}")
    say(f"full width: {cfg.name} {cfg.n_layers}L d_model={cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv_heads}KV x {cfg.head_dim} {ffn} "
        f"vocab={cfg.vocab_size} params={cfg.n_params} dtype=bfloat16 "
        f"attn_impl=flash init_s={time.monotonic() - t0:.2f}")
    engine = rt.InferenceEngine(bundle, params, max_batch=MAX_BATCH,
                                max_seq_len=MAX_SEQ_LEN,
                                prompt_bucket=PROMPT_LEN, device="cuda")
    env = rt.EngineEnvironment(engine, rt.energy.JETSON_AGX_ORIN,
                               rt.energy.ORIN_WORKLOADS["llama3.2-1b"],
                               prompt_len=PROMPT_LEN,
                               max_new_tokens=NEW_TOKENS, seed=0)

    # Warm-up (cuBLAS handles, kernel loading) and an output check, before
    # the counted run.
    rng = np.random.default_rng(7)
    warm = [rng.integers(1, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
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

    for m in ops.values():
        m.launches = 0
    space = rt.make_space(f"engine/{arch}")
    cm = rt.CostModel(alpha=0.5)
    ref_obs = env.pull(space.values(space.corner()), 0)
    cm = cm.with_reference(ref_obs.energy, ref_obs.latency)
    policy = rt.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
    res = rt.Controller(space, policy, cm, seed=0).run(env, ROUNDS)
    torch.cuda.synchronize()
    counts = {name: m.launches for name, m in ops.items()}

    pulls = [("ref", space.values(space.corner()), ref_obs)] + \
        [(r.t, r.knobs, r.obs) for r in res.records]
    for t, knobs, obs in pulls:
        md = obs.metadata
        floor = weight_read_floor_ms(cfg, knobs["batch"])
        say(f"pull {arch} {t} freq_mhz={knobs['freq_mhz']} "
            f"batch={knobs['batch']} "
            f"prefill_s={md['prefill_s']:.6f} decode_s={md['decode_s']:.6f} "
            f"decode_step_ms={1e3 * md['decode_s'] / NEW_TOKENS:.4f} "
            f"weight_read_floor_ms={floor:.4f} "
            f"tokens_per_s={md['tokens_per_s']:.1f} "
            f"modelled_orin_energy_j_per_req={obs.energy:.4f} "
            f"latency_s_per_req={obs.latency:.4f}")
    say(f"controller summary {arch} (energy modelled with the Jetson Orin "
        "board model on this card's wall time): "
        + json.dumps(res.summary(), default=str))
    say(f"peak_device_memory_gb {arch}="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return counts, len(pulls), cfg, engine, warm


def expected_launches(cfg, n_generate):
    """Launches one path must make over `n_generate` generate calls (one
    prefill and NEW_TOKENS decode steps each)."""
    n_layers = cfg.n_layers
    steps = n_generate * NEW_TOKENS
    passes = n_generate + steps
    norms = 4 * n_layers + 1 if cfg.qk_norm else 2 * n_layers + 1
    return {"decode_attention": n_layers * steps,
            "flash_attention": n_layers * n_generate,
            "moe_gemm": 3 * n_layers * passes if cfg.moe is not None else 0,
            "rmsnorm": norms * passes}


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
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    ops = {"rmsnorm": rms_ops, "decode_attention": dec_ops,
           "flash_attention": fl_ops, "moe_gemm": mg_ops}

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
    from repro_torch.models import transformer
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.registry import bundle_for
    from repro_torch.platform import make_space
    from repro_torch.serving import energy
    from repro_torch.serving.engine import EngineEnvironment, InferenceEngine
    rt = argparse.Namespace(
        configs=configs, make_policy=make_policy, Controller=Controller,
        CostModel=CostModel, transformer=transformer, bundle_for=bundle_for,
        make_space=make_space, energy=energy, MoEConfig=MoEConfig,
        EngineEnvironment=EngineEnvironment, InferenceEngine=InferenceEngine)
    model_check(torch, rt)

    # Phases 4 and 5, once per main path
    totals = dict.fromkeys(ops, 0)
    for arch in ("llama3.2-1b", "olmoe-1b-7b"):
        counts, n_generate, cfg, engine, prompts = serve_full_width(
            torch, rt, ops, arch)
        expected = expected_launches(cfg, n_generate)
        say(f"launch counts {arch} over {n_generate} generate calls "
            f"({n_generate * NEW_TOKENS} decode steps): {counts} "
            f"expected {expected}")
        if counts != expected:
            fail(f"{arch}: launch counts {counts} != expected {expected}")
        for name in totals:
            totals[name] += counts[name]
        profile_generate(torch, engine, prompts)
        del engine
        torch.cuda.empty_cache()

    record = []
    for name, (source, replaces) in KERNELS.items():
        row = main_rows[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": totals[name],
                       "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                       "plain_ms": row["plain_ms"],
                       "bound_ms": row["bound_ms"],
                       "bound_by": row["bound_by"],
                       "library_ms": row["library_ms"]})
    say(json.dumps({"kernels": record}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
