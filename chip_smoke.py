#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # the whole check, one card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card (`nvidia-smi` name and power limit) and the build of every
     kernel from `src/repro_torch/csrc` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, in bf16
     (tolerance 2e-2) and fp32 (2e-5), at the shapes the engine's main path
     gives it, with its device time (CUDA events over a primed stream,
     median of repeats), its per-call time when the host issues the calls
     (`call_ms`: launch overhead included), the plain version's device
     time, one PyTorch library call's (`F.rms_norm`,
     `F.scaled_dot_product_attention`; timed here only, never used by the
     port) and the least time the card could take (bytes over 3.35 TB/s or
     operations over the dtype's peak, whichever is larger);
  3. model level in fp32 on a narrow config with llama3.2-1b's head
     geometry: the "flash" (kernel) and "naive" logits over a left-padded
     prefill and 4 decode steps agree within 1e-4;
  4. the main path: llama3.2-1b at full width (16 layers, d_model 2048, bf16,
     attn_impl="flash", seeded random weights) behind the port's
     InferenceEngine and EngineEnvironment, driven by CostModel +
     Controller + CamelTS for 8 rounds as `serve.py --mode engine` does.
     Energy is the Jetson Orin analytical board model applied to measured
     wall time: modelled, not measured on this card;
  5. the launch counters of that run equal what the path implies, then
     a torch.profiler breakdown of one more full-width generate (kernel
     time by name, device busy share).

The line before the last holds the card's name and power limit, the one
before it the kernels' JSON record, and the last line is
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
              flops, is_main):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all().item())
        (ms, call_ms), (plain_ms, _) = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library)[0] if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype_name]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        tol = TOLERANCE[dtype_name]
        say(f"kernel {name} dtype={dtype_name} shape={shape} "
            f"kernel_ms={ms:.5f} call_ms={call_ms:.5f} "
            f"plain_ms={plain_ms:.5f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={bound_ms:.6f} bound_by={bound_by} "
            f"bytes={int(nbytes)} flops={int(flops)} "
            f"max_abs_err={err:.3e} tol={tol:g} finite={finite}")
        if not finite or not err <= tol:
            failures.append(f"{name} {dtype_name} {shape}: err={err} "
                            f"finite={finite}")
        if is_main:
            main[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        e = torch.tensor([], dtype=dt).element_size()
        is_bf16 = dtype_name == "bfloat16"

        # RMSNorm: prefill rows (28 x 16) and decode rows (28), d 2048.
        for rows_shape in ((MAX_BATCH, PROMPT_LEN, 2048), (MAX_BATCH, 2048)):
            x, s = rnd(rows_shape, dt), rnd((2048,), dt, 0.1)
            w = 1.0 + s
            n = x.numel()
            check("rmsnorm", dtype_name, rows_shape,
                  lambda: ops["rmsnorm"].rmsnorm(x, s),
                  lambda: ops["rmsnorm"].rmsnorm_ref(x, s),
                  lambda: F.rms_norm(x, (2048,), w, 1e-6),
                  (2 * n + 2048) * e, 4 * n,
                  is_bf16 and len(rows_shape) == 3)

        # Decode attention: batch 4 and 28 over the engine's 128-slot
        # cache (a layer slice of the stacked cache), and one long cache.
        for b, s_len, lo, hi in ((4, MAX_SEQ_LEN, 16, 25),
                                 (MAX_BATCH, MAX_SEQ_LEN, 16, 25),
                                 (4, 4096, 4096, 4097)):
            q = rnd((b, 32, 64), dt)
            cache = rnd((2, 2, b, s_len, 8, 64), dt)
            k, v = cache[0, 1], cache[1, 1]
            lens = ints(lo, hi, b)
            starts = ints(0, 4, b) if s_len == MAX_SEQ_LEN else ints(0, 1, b)
            keys = int((lens - starts).sum())
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            idx = torch.arange(s_len, device=dev)
            mask = ((idx[None] >= starts[:, None].long())
                    & (idx[None] < lens[:, None].long()))[:, None, None]
            check("decode_attention", dtype_name, (b, s_len, 8, 4, 64),
                  lambda: ops["decode_attention"].decode_attention(
                      q, k, v, lens, starts),
                  lambda: ops["decode_attention"].decode_attention_ref(
                      q, k, v, lens, starts),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mask, enable_gqa=True),
                  (2 * q.numel() + 2 * keys * 8 * 64) * e + 8 * b,
                  4 * keys * 32 * 64,
                  is_bf16 and b == MAX_BATCH and s_len == MAX_SEQ_LEN)

        # Prefill attention: 28 x 16 tokens with left pads.
        b, sq = MAX_BATCH, PROMPT_LEN
        q, k, v = rnd((b, sq, 32, 64), dt), rnd((b, sq, 8, 64), dt), \
            rnd((b, sq, 8, 64), dt)
        starts = ints(0, 8, b)
        pos = torch.arange(sq, device=dev)
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] >= starts[:, None, None].long()))
        pairs = int(mask.sum())
        check("flash_attention", dtype_name, (b, sq, 8, 4, 64),
              lambda: ops["flash_attention"].flash_attention(
                  q, k, v, kv_start=starts),
              lambda: ops["flash_attention"].attention_ref(
                  q, k, v, kv_start=starts),
              lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  attn_mask=mask[:, None], enable_gqa=True),
              (2 * q.numel() + 2 * k.numel()) * e + 4 * b,
              4 * pairs * 32 * 64, is_bf16)
    if failures:
        fail("kernel != plain version: " + "; ".join(failures))
    return main


# ---------------------------------------------------------------------------
# Phase 3: flash vs naive at model level, fp32
# ---------------------------------------------------------------------------

def model_check(torch, rt):
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = rt.transformer.TransformerConfig(
        name="llama-narrow", n_layers=2, d_model=512, n_heads=32,
        n_kv_heads=8, head_dim=64, d_ff=1024, vocab_size=1024,
        rope_theta=500000.0, dtype=torch.float32)
    b, plen, steps, max_len = 4, 16, 4, 32
    pads = torch.tensor([0, 3, 7, 15])
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(1, 1024, (b, plen), generator=rng)
    mask = torch.arange(plen)[None] >= pads[:, None]
    toks = torch.where(mask, toks, torch.zeros_like(toks)).cuda()
    mask = mask.cuda()
    dmask = torch.ones((b, max_len), dtype=torch.bool, device="cuda")
    dmask[:, :plen] = mask
    feed = []          # the naive run's greedy tokens, fed to both runs
    logits = {}
    for impl in ("naive", "flash"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        bundle = rt.bundle_for(cfg)
        params = bundle.init_params(0, "cuda")
        cache = bundle.init_cache(b, max_len, "cuda")
        out, cache = bundle.prefill(params, toks, cache, attn_mask=mask)
        seq = [out]
        for i in range(steps):
            if impl == "naive":
                feed.append(torch.argmax(seq[-1], dim=-1))
            out, cache = bundle.decode_step(params, feed[i], cache, plen + i,
                                            attn_mask=dmask)
            seq.append(out)
        logits[impl] = torch.stack(seq)
    torch.cuda.synchronize()
    diff = (logits["flash"] - logits["naive"]).abs().max().item()
    finite = bool(torch.isfinite(logits["flash"]).all().item())
    say(f"model fp32 narrow (2L, d512, 32H/8KV x 64) flash-vs-naive "
        f"prefill+{steps} decode: max_abs_diff={diff:.3e} tol=1e-4 "
        f"finite={finite}")
    if not finite or not diff <= 1e-4:
        fail(f"flash and naive logits differ by {diff}")


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def serve_full_width(torch, rt, ops):
    import dataclasses
    import numpy as np
    cfg = dataclasses.replace(rt.configs.get("llama3.2-1b"),
                              attn_impl="flash")
    bundle = rt.bundle_for(cfg)
    t0 = time.monotonic()
    params = bundle.init_params(0, "cuda")
    torch.cuda.synchronize()
    say(f"full width: {cfg.name} {cfg.n_layers}L d_model={cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv_heads}KV x {cfg.head_dim} d_ff={cfg.d_ff} "
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
        fail(f"generate returned bad tokens {toks.shape} "
             f"[{toks.min()}, {toks.max()}]")
    if logits.shape != (2, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all().item()):
        fail("full-width prefill logits are not finite")

    for m in ops.values():
        m.launches = 0
    space = rt.make_space("engine/llama3.2-1b")
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
        say(f"pull {t} freq_mhz={knobs['freq_mhz']} batch={knobs['batch']} "
            f"prefill_s={md['prefill_s']:.6f} decode_s={md['decode_s']:.6f} "
            f"decode_step_ms={1e3 * md['decode_s'] / NEW_TOKENS:.4f} "
            f"tokens_per_s={md['tokens_per_s']:.1f} "
            f"modelled_orin_energy_j_per_req={obs.energy:.4f} "
            f"latency_s_per_req={obs.latency:.4f}")
    say("controller summary (energy modelled with the Jetson Orin board "
        "model on this card's wall time): "
        + json.dumps(res.summary(), default=str))
    say(f"peak_device_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return counts, len(pulls), cfg.n_layers, engine, warm


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
    dev_us = sum(ev.self_device_time_total for ev in events
                 if ev.device_type == DeviceType.CUDA
                 and not ev.is_user_annotation)
    say(f"profile generate b={len(prompts)}: wall_s={wall:.6f} "
        f"device_busy_s={dev_us / 1e6:.6f} "
        f"device_busy_share={dev_us / 1e6 / wall:.4f}")
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
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    ops = {"rmsnorm": rms_ops, "decode_attention": dec_ops,
           "flash_attention": fl_ops}

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
    from repro_torch.models.registry import bundle_for
    from repro_torch.platform import make_space
    from repro_torch.serving import energy
    from repro_torch.serving.engine import EngineEnvironment, InferenceEngine
    rt = argparse.Namespace(
        configs=configs, make_policy=make_policy, Controller=Controller,
        CostModel=CostModel, transformer=transformer, bundle_for=bundle_for,
        make_space=make_space, energy=energy,
        EngineEnvironment=EngineEnvironment, InferenceEngine=InferenceEngine)
    model_check(torch, rt)

    # Phase 4
    counts, n_generate, n_layers, engine, prompts = serve_full_width(
        torch, rt, ops)

    # Phase 5
    steps = n_generate * NEW_TOKENS
    expected = {"decode_attention": n_layers * steps,
                "flash_attention": n_layers * n_generate,
                "rmsnorm": (2 * n_layers + 1) * (n_generate + steps)}
    say(f"launch counts over {n_generate} generate calls "
        f"({steps} decode steps): {counts} expected {expected}")
    if counts != expected:
        fail(f"launch counts {counts} != expected {expected}")
    profile_generate(torch, engine, prompts)

    record = []
    for name, (source, replaces) in KERNELS.items():
        row = main_rows[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": counts[name],
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
