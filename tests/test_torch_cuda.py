"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need a CUDA device and nvcc (the kernels are built from
`src/repro_torch/csrc` at first use) and skip without one.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in fp32, 2e-2 in bf16 (tests/test_kernels.py); the
grouped GEMM, a sum of 1024-2048 products an output, 1e-4 in fp32; WKV6,
whose outputs are sums over C·N terms and over the carried state, 1e-4 in
fp32 (its kernel computes in fp32 from bf16 inputs too, so bf16 is held to
2e-2); the RG-LRU scan (fp32 only), whose state carries every earlier step
at another rounding order than the plain versions', 1e-4, and its gated
front end (fp32 or bf16 pre-activations, fp32 arithmetic) 1e-4 of
1 + |ref|.  The backward kernels (RMSNorm, the grouped GEMM, WKV6, the
gated RG-LRU) are held to autograd of their plain versions as 1e-4 (fp32)
and 2e-2 (bf16) of 1 + |ref|, and give the same bits on a second call.  Prefill
attention over long prompts, whose late rows are small (RMS ~0.03), is
held row by row to tol times each row's max |ref| (`row_scaled_error`).

The engine's fused decode replays a CUDA graph a step; on each family's
smoke config (bf16, attention through the kernels at head_dim 32, which
they take) its tokens equal the eager loop's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as torch_configs
from repro_torch.kernels import backward_launch_counts, launch_counts
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.flash_attention.ref import row_scaled_error
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.models import moe
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine

CUDA_MISSING_REASON = "needs a CUDA device; the kernel has no CPU mode"

DTYPES = {"float32": (torch.float32, 2e-5),
          "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def rnd():
    if not torch.cuda.is_available():
        pytest.skip(CUDA_MISSING_REASON)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)
    return make


def _i32(values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    before = rms_ops.launches
    for shape in ((28, 16, 2048), (3, 96)):
        x, s = rnd(shape, dt), rnd(shape[-1:], dt, 0.1)
        torch.testing.assert_close(rms_ops.rmsnorm(x, s),
                                   rms_ops.rmsnorm_ref(x, s), rtol=tol,
                                   atol=tol)
    assert rms_ops.launches == before + 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_plans_on_the_card(rnd, dtype):
    """Each of the kernel's plans: olmoe's qk-norm rows [28, 16, 16, 128]
    (several rows a CTA, 16-byte loads), a row view whose stride is not D
    (vector loads at stride D + 8, scalar ones at D + 1), D = 100 (scalar
    in bf16, a row across two warps; 16-byte loads in fp32), a single row,
    a base one element past a 16-byte boundary (scalar) and d_model 4096
    (one row a CTA); one launch a call."""
    dt, tol = DTYPES[dtype]
    vec = 16 // torch.tensor([], dtype=dt).element_size()
    wide = rnd((300, 136), dt)
    flat = rnd((7 * 2048 + 1,), dt)
    cases = [(rnd((28, 16, 16, 128), dt), vec),
             (wide[:, :128], vec),
             (rnd((299, 129), dt)[:, :128], 1),
             (rnd((40, 100), dt), 1 if 100 % vec else vec),
             (rnd((1, 2048), dt), vec),
             (flat[1:].view(7, 2048), 1),
             (rnd((28, 4096), dt), vec)]
    for x, want_vec in cases:
        d = x.shape[-1]
        s = rnd((d,), dt, 0.1)
        x2 = rms_ops.rows_view(x)
        plan = rms_ops.launch_plan(d, x.element_size(), x2.stride(0),
                                   x2.data_ptr() % 16 == 0)
        assert plan.vec == want_vec, (tuple(x.shape), x.stride(), plan)
        before = rms_ops.launches
        out = rms_ops.rmsnorm(x, s)
        assert rms_ops.launches == before + 1
        torch.testing.assert_close(out, rms_ops.rmsnorm_ref(x, s), rtol=tol,
                                   atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    q, cache = rnd((4, 32, 64), dt), rnd((2, 3, 4, 128, 8, 64), dt)
    k, v = cache[0, 1], cache[1, 1]          # layer slices, in place
    lens, starts = _i32([128, 90, 17, 64]), _i32([0, 7, 16, 3])
    torch.testing.assert_close(
        dec_ops.decode_attention(q, k, v, lens, starts),
        dec_ops.decode_attention_ref(q, k, v, lens, starts),
        rtol=tol, atol=tol)
    q, kv = rnd((2, 6, 128), dt), rnd((2, 2, 40, 2, 128), dt)
    torch.testing.assert_close(
        dec_ops.decode_attention(q, kv[0], kv[1], 33),
        dec_ops.decode_attention_ref(q, kv[0], kv[1], 33),
        rtol=tol, atol=tol)
    # Head dims 96 (lanes past a key row's vectors idle) and 32, groups of
    # 3 (a CTA's head slot idle) and 12 (two CTAs a KV head), two splits.
    for h, d in ((6, 96), (24, 32)):
        q, kv = rnd((2, h, d), dt), rnd((2, 2, 600, 2, d), dt)
        lens, starts = _i32([600, 431]), _i32([0, 290])
        assert dec_ops.split_plan(
            2, 2, 600, dec_ops.sm_count(q.device))[0] == 2
        torch.testing.assert_close(
            dec_ops.decode_attention(q, kv[0], kv[1], lens, starts),
            dec_ops.decode_attention_ref(q, kv[0], kv[1], lens, starts),
            rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_split_kernel_on_a_long_cache(rnd, dtype):
    """Batch 6 and 28 over 4096 slots (5 splits, and one: 224 CTAs fill
    the card) with ragged windows: a window inside one split, kv_start
    past the first split, lengths 1 and S, and an empty window (which gets
    0).  The calls make no host sync, so they can be captured in a CUDA
    graph."""
    dt, tol = DTYPES[dtype]
    for b in (6, 28):
        q, cache = rnd((b, 32, 64), dt), rnd((2, 2, b, 4096, 8, 64), dt)
        k, v = cache[0, 1], cache[1, 1]
        fixed = [(4096, 0), (1, 0), (4096, 2500), (3000, 1000), (600, 500),
                 (9, 9)]
        gen = torch.Generator().manual_seed(b)
        rand = torch.randint(0, 4096, (b - len(fixed), 2), generator=gen)
        rows = fixed + [(int(max(x)) + 1, int(min(x))) for x in rand]
        lens, starts = _i32([r[0] for r in rows]), _i32([r[1] for r in rows])
        n_splits, _ = dec_ops.split_plan(b, 8, 4096,
                                         dec_ops.sm_count(q.device))
        assert (n_splits > 1) == (b == 6)
        before = (dec_ops.launches, dec_ops.combine_launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dec_ops.decode_attention(q, k, v, lens, starts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (dec_ops.launches, dec_ops.combine_launches) == (
            before[0] + 1, before[1] + (n_splits > 1))
        ref = dec_ops.decode_attention_ref(q, k, v, lens, starts).float()
        # Over thousands of keys a row's outputs are small (RMS ~0.03), so
        # each row is held to tol times its largest |value|: an absolute
        # 2e-2 would pass a split that dropped a 64-key chunk.
        limit = tol * ref.abs().amax(dim=(1, 2), keepdim=True)
        err = (out.float() - ref).abs()
        assert bool((err <= limit).all()), float((err - limit).max())
        assert bool((out[5] == 0).all())          # the empty window


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    q, k, v = rnd((28, 16, 32, 64), dt), rnd((28, 16, 8, 64), dt), \
        rnd((28, 16, 8, 64), dt)
    starts = torch.arange(28, device="cuda", dtype=torch.int32) % 16
    out = fl_ops.flash_attention(q, k, v, kv_start=starts)
    torch.testing.assert_close(
        out, fl_ops.attention_ref(q, k, v, kv_start=starts), rtol=tol,
        atol=tol)
    assert bool(torch.isfinite(out).all())
    q, k, v = rnd((2, 130, 6, 32), dt), rnd((2, 130, 2, 32), dt), \
        rnd((2, 130, 2, 32), dt)
    torch.testing.assert_close(
        fl_ops.flash_attention(q, k, v, window=33, softcap=20.0),
        fl_ops.attention_ref(q, k, v, window=33, softcap=20.0),
        rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", [
    # (H, KVH, D, window, softcap, kv_start)
    (32, 8, 64, 0, 0.0, None),
    (32, 8, 64, 0, 0.0, 700),
    (16, 16, 128, 0, 20.0, None),
    (16, 1, 256, 2048, 0.0, None),
    (16, 1, 256, 512, 0.0, 300),
])
def test_flash_attention_tc_kernel_over_2048_tokens(rnd, case):
    """The bf16 (tensor-core) kernel over one 2048-token prompt, held row by
    row to tol times that row's max |ref| (late rows average ~2000 keys and
    are ~0.03 RMS, so an absolute 2e-2 would pass a lost key tile): llama's,
    olmoe's (with a softcap) and recurrentgemma's heads, causal, under its
    2048 window and under a 512 window that skips tiles, and with left
    pads (rows before kv_start have no key and are 0)."""
    h, kvh, d, window, softcap, start = case
    dt, tol = DTYPES["bfloat16"]
    q, k, v = rnd((1, 2048, h, d), dt), rnd((1, 2048, kvh, d), dt), \
        rnd((1, 2048, kvh, d), dt)
    starts = None if start is None else _i32([start])
    before = (fl_ops.launches, fl_ops.tc_launches)
    out = fl_ops.flash_attention(q, k, v, window=window, softcap=softcap,
                                 kv_start=starts)
    assert (fl_ops.launches, fl_ops.tc_launches) == (before[0] + 1,
                                                     before[1] + 1)
    ref = fl_ops.attention_ref(q, k, v, window=window, softcap=softcap,
                               kv_start=starts)
    assert bool(torch.isfinite(out).all())
    assert row_scaled_error(out, ref) <= tol
    if start is not None:
        assert bool((out[:, :start] == 0).all())


#: The transformer family's attention heads: (label, H, KVH, D), decode
#: groups 3 (smollm), 6 (qwen2), 8 (qwen2.5), 9 (starcoder2) and phi-3's
#: MHA at head_dim 96.
FAMILY_HEADS = [("smollm", 15, 5, 64), ("qwen2", 12, 2, 128),
                ("qwen2.5", 16, 2, 128), ("starcoder2", 36, 4, 128),
                ("phi3", 32, 32, 96)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads", FAMILY_HEADS, ids=lambda c: c[0])
def test_decode_attention_at_the_family_heads(rnd, heads, dtype):
    """Decode attention at each new path's heads: batch 28 over a 128-slot
    layer slice with ragged windows, and batch 4 over 4096 slots (split
    KV and the combine kernel), held to tol times each row's max |ref|
    there, as the long-cache rows are."""
    _, h, kvh, d = heads
    dt, tol = DTYPES[dtype]
    q, cache = rnd((28, h, d), dt), rnd((2, 2, 28, 128, kvh, d), dt)
    gen = torch.Generator().manual_seed(h)
    lens = torch.randint(16, 129, (28,), generator=gen)
    starts = torch.minimum(torch.randint(0, 8, (28,), generator=gen),
                           lens - 1)
    lens, starts = _i32(lens.tolist()), _i32(starts.tolist())
    torch.testing.assert_close(
        dec_ops.decode_attention(q, cache[0, 1], cache[1, 1], lens, starts),
        dec_ops.decode_attention_ref(q, cache[0, 1], cache[1, 1], lens,
                                     starts), rtol=tol, atol=tol)
    q, kv = rnd((4, h, d), dt), rnd((2, 4, 4096, kvh, d), dt)
    lens, starts = _i32([4096, 4001, 2500, 700]), _i32([0, 0, 96, 3])
    before = dec_ops.combine_launches
    out = dec_ops.decode_attention(q, kv[0], kv[1], lens, starts)
    n_splits, _ = dec_ops.split_plan(4, kvh, 4096, dec_ops.sm_count(q.device))
    assert dec_ops.combine_launches == before + (n_splits > 1)
    ref = dec_ops.decode_attention_ref(q, kv[0], kv[1], lens, starts).float()
    limit = tol * ref.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((out.float() - ref).abs() <= limit).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads", FAMILY_HEADS, ids=lambda c: c[0])
def test_flash_attention_at_the_family_heads(rnd, heads, dtype):
    """Prefill attention over the engine's 28 left-padded 16-token
    prompts at each new path's heads (head_dim 96 included)."""
    _, h, kvh, d = heads
    dt, tol = DTYPES[dtype]
    q, k, v = rnd((28, 16, h, d), dt), rnd((28, 16, kvh, d), dt), \
        rnd((28, 16, kvh, d), dt)
    starts = torch.arange(28, device="cuda", dtype=torch.int32) % 16
    out = fl_ops.flash_attention(q, k, v, kv_start=starts)
    assert row_scaled_error(out, fl_ops.attention_ref(
        q, k, v, kv_start=starts)) <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seq", [16 + 15 + 17, 16 + 300 + 200])
def test_flash_attention_with_a_prefix_before_pads(rnd, dtype, seq):
    """phi-3-vision's heads (32 x 96) with a 16-slot prefix before left
    pads of 0, 5 and 15 slots (and 300 at the longer length, whose gap
    spans whole key tiles that the kernel skips): a row's valid keys are
    [0, 16) and [16 + pads, S).  Held row by row to tol times each row's
    max |ref|; the same call without `prefix_len` gives another result."""
    dt, tol = DTYPES[dtype]
    pads = [0, 5, 15] + ([300] if seq > 100 else [])
    b = len(pads)
    q, k, v = rnd((b, seq, 32, 96), dt), rnd((b, seq, 32, 96), dt), \
        rnd((b, seq, 32, 96), dt)
    prefix, starts = _i32([16] * b), _i32([16 + p for p in pads])
    before = fl_ops.launches
    out = fl_ops.flash_attention(q, k, v, kv_start=starts, prefix_len=prefix)
    assert fl_ops.launches == before + 1
    ref = fl_ops.attention_ref(q, k, v, kv_start=starts, prefix_len=prefix)
    assert bool(torch.isfinite(out).all())
    assert row_scaled_error(out, ref) <= tol
    assert row_scaled_error(fl_ops.flash_attention(q, k, v, kv_start=starts),
                            ref) > tol


@pytest.mark.requires_cuda
def test_landscape_pull_many_on_the_card_is_the_cpu_path():
    """The Orin landscape's batched pull evaluated on the card gives the
    CPU path's observations (fp32 closed form on both: the same arms'
    values within 1e-6 relative, the same noise stream and metadata)."""
    from repro_torch.platform import make_env, make_space
    if not torch.cuda.is_available():
        pytest.skip(CUDA_MISSING_REASON)
    for model in ("llama3.2-1b", "qwen2.5-3b"):
        name = f"jetson/{model}/landscape"
        space = make_space(name)
        knobs = [space.values(a) for a in range(space.n_arms)]
        card = make_env(name, seed=1, device="cuda").pull_many(knobs, 0)
        cpu = make_env(name, seed=1, device="cpu").pull_many(knobs, 0)
        for o, c in zip(card, cpu, strict=True):
            for f in ("energy", "latency", "batch_time", "queue_wait",
                      "backlog", "power"):
                np.testing.assert_allclose(getattr(o, f), getattr(c, f),
                                           rtol=1e-6, err_msg=f)
            assert o.metadata == c.metadata


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", [
    # (dtype, B, S, window, kv_start)
    ("bfloat16", 28, 16, 4096, "pads"),
    ("float32", 28, 16, 4096, "pads"),
    ("bfloat16", 1, 4200, 4096, None),
    ("bfloat16", 2, 600, 100, None),
    ("float32", 2, 600, 100, None),
])
def test_flash_attention_at_gemma2_heads(rnd, case):
    """gemma2-27b's attention: 32/16 heads x 128 under its softcap 50 and
    query scale 144^-1/2, on local layers' window: the engine's prompts
    (the window inert), one 4200-token prompt (the 4096 window drops the
    first keys of the last rows; bf16, the type the engine's long
    prefills run in) and a 100-token window over 600 tokens."""
    dtype, b, s, window, pads = case
    dt, tol = DTYPES[dtype]
    scale = (4608 / 32) ** -0.5
    # q scaled by 3, so the logits reach where the softcap bends them.
    q, k, v = rnd((b, s, 32, 128), dt, 3.0), rnd((b, s, 16, 128), dt), \
        rnd((b, s, 16, 128), dt)
    starts = None if pads is None else \
        torch.arange(b, device="cuda", dtype=torch.int32) % s
    kw = dict(scale=scale, window=window, softcap=50.0, kv_start=starts)
    out = fl_ops.flash_attention(q, k, v, **kw)
    ref = fl_ops.attention_ref(q, k, v, **kw)
    assert bool(torch.isfinite(out).all())
    assert row_scaled_error(out, ref) <= tol
    # The cap and the scale are honoured, not dropped: without them the
    # output is another.
    plain = fl_ops.attention_ref(q, k, v, window=window, kv_start=starts)
    assert row_scaled_error(plain, ref) > tol


@pytest.mark.requires_cuda
def test_flash_attention_routes_by_dtype(rnd):
    """bf16 launches the tensor-core kernel (tc_launches advances), fp32
    the CUDA-core kernel, unchanged and held to 2e-5; a dtype neither takes
    raises, and so do q/k/v the bf16 kernel's TMA cannot read."""
    q, k, v = rnd((2, 96, 12, 64), torch.float32), \
        rnd((2, 96, 4, 64), torch.float32), rnd((2, 96, 4, 64), torch.float32)
    starts = _i32([0, 40])
    before = (fl_ops.launches, fl_ops.tc_launches)
    out = fl_ops.flash_attention(q, k, v, window=50, kv_start=starts)
    assert (fl_ops.launches, fl_ops.tc_launches) == (before[0] + 1,
                                                     before[1])
    torch.testing.assert_close(
        out, fl_ops.attention_ref(q, k, v, window=50, kv_start=starts),
        rtol=2e-5, atol=2e-5)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = fl_ops.flash_attention(qb, kb, vb, window=50, kv_start=starts)
    assert (fl_ops.launches, fl_ops.tc_launches) == (before[0] + 2,
                                                     before[1] + 1)
    assert row_scaled_error(out, fl_ops.attention_ref(
        qb, kb, vb, window=50, kv_start=starts)) <= 2e-2
    with pytest.raises(TypeError):
        fl_ops.flash_attention(q.half(), k.half(), v.half())
    ragged = rnd((2, 96, 12, 66), torch.bfloat16)[..., :64]  # 132-B heads
    with pytest.raises(ValueError, match="16-byte"):
        fl_ops.flash_attention(ragged, kb, vb)
    assert (fl_ops.launches, fl_ops.tc_launches) == (before[0] + 2,
                                                     before[1] + 1)


@pytest.mark.requires_cuda
def test_wrappers_reject_what_the_kernels_cannot_take(rnd):
    x = rnd((4, 64), torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, rnd((64,), torch.float16))
    q, kv = rnd((2, 8, 48), torch.float32), rnd((2, 16, 2, 48),
                                                torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        dec_ops.decode_attention(q, kv, kv, 8)
    kv = rnd((2, 16, 2, 66), torch.float32)[..., :64]  # rows of 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        dec_ops.decode_attention(rnd((2, 8, 64), torch.float32), kv, kv, 8)


GEMM_DTYPES = {"float32": (torch.float32, 1e-4),
               "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(GEMM_DTYPES))
def test_moe_gemm_kernel_matches_plain(rnd, dtype):
    """Every variant (decode / skinny C <= 8, tile C > 8) with ragged C, K
    and N edges, and olmoe-1b-7b's decode and prefill products.  The bf16
    decode variant at every C from 1 to 8 with N off its 64-column unit
    (136, 200) and K off its 64-deep stage (40, 2056), at E = 1 (3 or 4
    units) and E = 130 (more units than SMs).  The bf16 tile (TMA
    + wgmma) at one to four m64 tiles and two row blocks (C = 300), with N
    off its 128-column tile and K off its 64-deep stage; the fp32 tile
    (3xTF32) at C 9, 33, 224 and 300 with K off its 32-deep stage."""
    dt, tol = GEMM_DTYPES[dtype]
    before = mg_ops.launches
    shapes = ((3, 5, 40, 48), (2, 33, 32, 48), (4, 96, 64, 64),
              (2, 9, 2056, 136), (1, 1, 8, 8), (5, 70, 24, 200),
              (64, 8, 2048, 1024), (64, 8, 1024, 2048), (64, 224, 2048, 1024),
              (64, 224, 1024, 2048)) + tuple(
                  (3, c, k, n) for c in (9, 32, 40, 224, 300)
                  for k, n in ((2048, 200), (40, 136))) + tuple(
                  (e, c, k, n) for c in range(1, 9)
                  for e, k, n in ((1, 40, 136), (130, 2056, 200))) + tuple(
                  (2, c, 2056, 136) for c in (9, 33, 224, 300))
    for e, c, k, n in shapes:
        x, w = rnd((e, c, k), dt), rnd((e, k, n), dt, k ** -0.5)
        torch.testing.assert_close(mg_ops.grouped_gemm(x, w),
                                   mg_ops.moe_gemm_ref(x, w), rtol=tol,
                                   atol=tol)
    assert mg_ops.launches == before + len(shapes)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(GEMM_DTYPES))
def test_moe_gemm_gives_the_same_bits_twice(rnd, dtype):
    """No variant sums in an order that varies from call to call: the bf16
    decode variant (persistent units), the fp32 skinny one, and both tiles
    at C > 8."""
    dt, _ = GEMM_DTYPES[dtype]
    before = mg_ops.launches
    shapes = ((64, 8, 2048, 1024), (130, 3, 2056, 200), (64, 224, 2048, 1024),
              (3, 300, 40, 136))
    for e, c, k, n in shapes:
        x, w = rnd((e, c, k), dt), rnd((e, k, n), dt, k ** -0.5)
        first = mg_ops.grouped_gemm(x, w)
        assert torch.equal(first, mg_ops.grouped_gemm(x, w)), (e, c, k, n)
    assert mg_ops.launches == before + 2 * len(shapes)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernels_at_olmoe_geometry(rnd, dtype):
    """16 query heads over 16 KV heads (G = 1) at head_dim 128."""
    dt, tol = DTYPES[dtype]
    q, cache = rnd((28, 16, 128), dt), rnd((2, 28, 128, 16, 128), dt)
    lens = torch.arange(16, 44, device="cuda", dtype=torch.int32)
    starts = torch.arange(28, device="cuda", dtype=torch.int32) % 8
    torch.testing.assert_close(
        dec_ops.decode_attention(q, cache[0], cache[1], lens, starts),
        dec_ops.decode_attention_ref(q, cache[0], cache[1], lens, starts),
        rtol=tol, atol=tol)
    q, k, v = (rnd((28, 16, 16, 128), dt) for _ in range(3))
    torch.testing.assert_close(
        fl_ops.flash_attention(q, k, v, kv_start=starts),
        fl_ops.attention_ref(q, k, v, kv_start=starts), rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_moe_apply_on_card_matches_cpu(rnd):
    """The dispatch, the kernel products and the combine on the card give
    the CPU's plain result in fp32 (ample capacity, so no near-tie moves a
    token to another expert)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=256, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = moe.moe_init(gen, 128, cfg, torch.float32, "cuda")
    for shape in ((4, 16, 128), (28, 1, 128)):
        x = rnd(shape, torch.float32)
        out, aux = moe.moe_apply(params, cfg, x)
        ref, ref_aux = moe.moe_apply({k: v.cpu() for k, v in params.items()},
                                     cfg, x.cpu())
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux.cpu(), ref_aux, rtol=0, atol=1e-6)


@pytest.mark.requires_cuda
def test_grouped_gemm_rejects_what_the_kernel_cannot_take(rnd):
    x, w = rnd((2, 4, 12), torch.float32), rnd((2, 12, 16), torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg_ops.grouped_gemm(x, w)
    x, w = rnd((2, 4, 16), torch.float32), rnd((2, 16, 16), torch.bfloat16)
    with pytest.raises(TypeError):
        mg_ops.grouped_gemm(x, w)
    with pytest.raises(ValueError, match="contiguous"):
        mg_ops.grouped_gemm(x, rnd((2, 16, 16), torch.float32).transpose(1, 2))


WKV_DTYPES = {"float32": (torch.float32, 1e-4),
              "bfloat16": (torch.bfloat16, 2e-2)}


def _wkv_inputs(rnd, b, s, h, n, dt, width=None):
    """r, k, v, logw in [B, S, H, N] (views of [B, S, H, width] tensors
    when `width` is given, so the kernel reads them through strides),
    bonus and a nonzero initial state."""
    shape = (b, s, h, width or n)
    r, k = rnd(shape, dt, 0.5), rnd(shape, dt, 0.5)
    v = rnd(shape, dt)
    logw = (-torch.exp(rnd(shape, torch.float32) - 2.0)).clamp(-4.0, -1e-6)
    r, k, v, logw = (a[..., :n] for a in (r, k, v, logw))
    return (r, k, v, logw, rnd((h, n), torch.float32, 0.2),
            rnd((b, h, n, n), torch.float32, 0.5))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dtype", list(WKV_DTYPES))
def test_wkv6_kernel_matches_plain(rnd, dtype, n):
    """Chunk 1 (the step kernel), 8 and 32 over 64 tokens, and one token,
    each from a nonzero state, with strided inputs; the final state is
    written in place."""
    dt, tol = WKV_DTYPES[dtype]
    before = wk_ops.launches
    cases = ((64, 1), (64, 8), (64, 32), (1, 1))
    for s, chunk in cases:
        r, k, v, logw, u, st = _wkv_inputs(rnd, 3, s, 5, n, dt, width=n + 8)
        assert not r.is_contiguous()
        plain = wk_ops.wkv6_step_ref if s == 1 else (
            lambda *a: wk_ops.wkv6_chunked_ref(*a, chunk))
        y_ref, st_ref = plain(r, k, v, logw, u, st)
        y, out = wk_ops.wkv6(r, k, v, logw, u, st, chunk=chunk)
        torch.cuda.synchronize()
        assert out is st
        torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
        torch.testing.assert_close(st, st_ref, rtol=tol, atol=tol)
    assert wk_ops.launches == before + len(cases)


@pytest.mark.requires_cuda
def test_wkv6_kernel_matches_the_sequential_oracle_at_full_width(rnd):
    """rwkv6-3b's heads (40 x 64) at batch 28: the chunked prefill (64
    tokens, chunk 32) against the token-by-token recurrence."""
    r, k, v, logw, u, st = _wkv_inputs(rnd, 28, 64, 40, 64, torch.bfloat16)
    y_ref, st_ref = wk_ops.wkv6_sequential(r, k, v, logw, u, st)
    y, _ = wk_ops.wkv6(r, k, v, logw, u, st, chunk=32)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_wkv6_chunked_kernel_over_a_long_prompt(rnd):
    """rwkv6-3b's heads at B 2 over 2048 tokens (64 chunks of 32, staged
    by cp.async) from a nonzero state, against the token-by-token
    recurrence."""
    r, k, v, logw, u, st = _wkv_inputs(rnd, 2, 2048, 40, 64, torch.bfloat16)
    plan = wk_ops.chunk_plan(2, 40, 64, 2, r.stride(), True)
    assert plan.staging == "cp.async" and plan.ctas == 2 * 40
    y_ref, st_ref = wk_ops.wkv6_sequential(r, k, v, logw, u, st)
    before = wk_ops.launches
    y, _ = wk_ops.wkv6(r, k, v, logw, u, st, chunk=32)
    assert wk_ops.launches == before + 1
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(WKV_DTYPES))
def test_wkv6_chunked_kernel_at_each_head_dim(rnd, dtype):
    """Every head dim the kernel is built for (a warp a 16-column value
    slice; N 32 and 16 split the keys among warps too), at chunks 32, 8,
    24 and 16 (24 leaves 8 of the 32 padded positions empty), against the
    chunked plain version."""
    dt, _ = WKV_DTYPES[dtype]
    for n, s, chunk in ((64, 64, 32), (64, 64, 8), (32, 48, 24),
                        (16, 48, 16)):
        r, k, v, logw, u, st = _wkv_inputs(rnd, 3, s, 5, n, dt)
        y_ref, st_ref = wk_ops.wkv6_chunked_ref(r, k, v, logw, u, st, chunk)
        y, _ = wk_ops.wkv6(r, k, v, logw, u, st, chunk=chunk)
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(WKV_DTYPES))
def test_wkv6_inputs_off_a_16_byte_boundary(rnd, dtype):
    """r, k, v and logw one element past a 16-byte boundary: the chunked
    variant stages them with plain loads instead of cp.async, and agrees
    with the plain version."""
    dt, _ = WKV_DTYPES[dtype]
    b, s, h, n = 2, 64, 3, 64
    shape = (b, s, h, n)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(shape)
        out.copy_(t)
        return out
    r, k, v, logw, u, st = _wkv_inputs(rnd, b, s, h, n, dt)
    r, k, v, logw = (shifted(a) for a in (r, k, v, logw))
    plan = wk_ops.chunk_plan(b, h, n, r.element_size(), r.stride(),
                             r.data_ptr() % 16 == 0)
    assert plan.staging == "loads"
    y_ref, st_ref = wk_ops.wkv6_chunked_ref(r, k, v, logw, u, st, 32)
    y, _ = wk_ops.wkv6(r, k, v, logw, u, st, chunk=32)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_wkv6_rejects_what_the_kernel_cannot_take(rnd):
    f32 = torch.float32
    args = _wkv_inputs(rnd, 2, 64, 3, 48, f32)
    with pytest.raises(ValueError, match="head dim"):
        wk_ops.wkv6(*args, chunk=8)
    args = _wkv_inputs(rnd, 2, 64, 3, 16, f32)
    with pytest.raises(ValueError, match="chunk"):
        wk_ops.wkv6(*args, chunk=24)          # does not divide S
    with pytest.raises(ValueError, match="chunk"):
        wk_ops.wkv6(*args, chunk=64)          # longer than 32
    r, k, v, logw, u, st = args
    with pytest.raises(ValueError, match="one CUDA device"):
        wk_ops.wkv6(r, k, v, logw, u, st.cpu(), chunk=8)
    with pytest.raises(TypeError):
        wk_ops.wkv6(r, k.bfloat16(), v, logw, u, st, chunk=8)
    with pytest.raises(TypeError):
        wk_ops.wkv6(r, k, v, logw.bfloat16(), u, st, chunk=8)
    with pytest.raises(ValueError, match="strides"):
        wk_ops.wkv6(r, k, v, logw.transpose(1, 2).contiguous()
                    .transpose(1, 2), u, st, chunk=8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernels_at_recurrentgemma_geometry(rnd, dtype):
    """16 query heads over 1 KV head (MQA) at head_dim 256: prefill with
    left pads under recurrentgemma's window (inert at 16 tokens) and under
    a window of 5 that bites over 40 tokens."""
    dt, tol = DTYPES[dtype]
    before = fl_ops.launches
    for b, sq, window in ((28, 16, 2048), (3, 40, 5)):
        q = rnd((b, sq, 16, 256), dt)
        k, v = rnd((b, sq, 1, 256), dt), rnd((b, sq, 1, 256), dt)
        starts = torch.arange(b, device="cuda", dtype=torch.int32) % 8
        out = fl_ops.flash_attention(q, k, v, window=window, kv_start=starts)
        torch.testing.assert_close(
            out, fl_ops.attention_ref(q, k, v, window=window,
                                      kv_start=starts), rtol=tol, atol=tol)
        assert bool(torch.isfinite(out).all())
    assert fl_ops.launches == before + 2


def _rglru_inputs(rnd, b, s, w, width=None):
    """log_a (the model's range: -8 softplus(lambda) sigmoid(.)) and b as
    views of [B, S, width] tensors when `width` is given, and a nonzero
    state."""
    shape = (b, s, width or w)
    log_a = -0.1 * torch.sigmoid(rnd(shape, torch.float32)) \
        - 1e-3 * rnd(shape, torch.float32).abs()
    bb = rnd(shape, torch.float32)
    return log_a[..., :w], bb[..., :w], rnd((b, w), torch.float32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("s", [16, 1, 37])
def test_rglru_kernel_matches_plain(rnd, s):
    """recurrentgemma-9b's prefill (S 16) and decode (S 1) shapes at batch
    28 and an odd length, from a nonzero state: against the sequential
    oracle and the form the CPU path runs; strided inputs at the odd
    length; the state is written in place."""
    tol = dict(rtol=1e-4, atol=1e-4)
    b, w = (28, 4096) if s != 37 else (3, 200)
    log_a, bb, h0 = _rglru_inputs(rnd, b, s, w,
                                  width=None if s != 37 else 232)
    seq_h, seq_last = rg_ops.rglru_scan_ref(log_a, bb, h0)
    plain = rg_ops.rglru_step_ref if s == 1 else rg_ops.rglru_assoc_ref
    pl_h, pl_last = plain(log_a, bb, h0)
    state = h0.clone()
    before = rg_ops.launches
    h, out = rg_ops.rglru(log_a, bb, state)
    torch.cuda.synchronize()
    assert out is state and rg_ops.launches == before + 1
    for ref_h, ref_last in ((seq_h, seq_last), (pl_h, pl_last)):
        torch.testing.assert_close(h, ref_h, **tol)
        torch.testing.assert_close(state, ref_last, **tol)


@pytest.mark.requires_cuda
def test_rglru_kernel_takes_a_ragged_width(rnd):
    """W 203 (not a multiple of the 4 channels a thread owns) as views of
    rows of 235: the kernel's scalar accesses and each row's tail, at the
    prompt's scan and the decode step."""
    tol = dict(rtol=1e-4, atol=1e-4)
    for s in (37, 1):
        log_a, bb, h0 = _rglru_inputs(rnd, 3, s, 203, width=235)
        assert not rg_ops.launch_plan(3, s, 203, log_a.stride(), True).vec
        seq_h, seq_last = rg_ops.rglru_scan_ref(log_a, bb, h0)
        state = h0.clone()
        h, _ = rg_ops.rglru(log_a, bb, state)
        torch.cuda.synchronize()
        torch.testing.assert_close(h, seq_h, **tol)
        torch.testing.assert_close(state, seq_last, **tol)


def _gated_inputs(rnd, b, s, w, dt, width=None):
    """za, zi and y of type `dt` (views of [B, S, width] tensors when
    `width` is given), fp32 b_a, b_i and lambda (the model's init range,
    every 97th channel past softplus's threshold of 20) and a nonzero
    state."""
    f32 = torch.float32
    shape = (b, s, width or w)
    za, zi, y = (rnd(shape, dt)[..., :w] for _ in range(3))
    u = 0.9 + 0.099 * torch.sigmoid(rnd((w,), f32))
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    lam[::97] = 25.0
    return (za, zi, y, 0.5 * rnd((w,), f32), 0.5 * rnd((w,), f32), lam,
            rnd((b, w), f32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,w,width", [(28, 1, 4096, None),
                                         (28, 16, 4096, None),
                                         (3, 37, 203, 235)])
def test_rglru_gated_kernel_matches_plain(rnd, b, s, w, width, dtype):
    """The gated front end at recurrentgemma-9b's decode (S 1) and prefill
    (S 16) shapes, 16-byte accesses, and at a ragged W of strided views
    (scalar accesses and the tail), from a nonzero state: against
    `rglru_gates_ref` then the step or the associative scan, as
    |err| <= 1e-4 (1 + |ref|); the state written in place, one launch a
    call, the same bits twice."""
    za, zi, y, b_a, b_i, lam, h0 = _gated_inputs(rnd, b, s, w,
                                                 getattr(torch, dtype), width)
    assert rg_ops.launch_plan(b, s, w, za.stride(), True).vec == \
        (width is None)
    log_a, bb = rg_ops.rglru_gates_ref(za, zi, y, b_a, b_i, lam)
    plain = rg_ops.rglru_step_ref if s == 1 else rg_ops.rglru_assoc_ref
    ref_h, ref_last = plain(log_a, bb, h0)
    runs = []
    for _ in range(2):
        state = h0.clone()
        before = rg_ops.launches
        h, out = rg_ops.rglru_gated(za, zi, y, b_a, b_i, lam, state)
        torch.cuda.synchronize()
        assert out is state and rg_ops.launches == before + 1
        assert h.dtype == torch.float32 and h.shape == (b, s, w)
        runs.append((h, state))
    for got, ref in ((h, ref_h), (state, ref_last)):
        assert bool(torch.isfinite(got).all())
        assert ((got - ref).abs() / (1 + ref.abs())).max().item() <= 1e-4
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.requires_cuda
def test_rglru_rejects_what_the_kernel_cannot_take(rnd):
    log_a, bb, h0 = _rglru_inputs(rnd, 2, 8, 64)
    with pytest.raises(TypeError):
        rg_ops.rglru(log_a, bb.bfloat16(), h0)
    with pytest.raises(ValueError, match="one CUDA device"):
        rg_ops.rglru(log_a, bb, h0.cpu())
    with pytest.raises(ValueError, match="state"):
        rg_ops.rglru(log_a, bb, rnd((2, 65), torch.float32)[:, :64])
    with pytest.raises(ValueError, match="strides"):
        rg_ops.rglru(log_a, bb.transpose(1, 2).contiguous().transpose(1, 2),
                     h0)
    za, zi, y, b_a, b_i, lam, h0 = _gated_inputs(rnd, 2, 8, 64,
                                                 torch.bfloat16)
    vectors = (b_a, b_i, lam)
    # Types: fp16 inputs, mixed input types, a bf16 gate vector.
    with pytest.raises(TypeError):
        rg_ops.rglru_gated(za.half(), zi.half(), y.half(), *vectors, h0)
    with pytest.raises(TypeError):
        rg_ops.rglru_gated(za, zi, y.float(), *vectors, h0)
    with pytest.raises(TypeError):
        rg_ops.rglru_gated(za, zi, y, b_a.bfloat16(), b_i, lam, h0)
    # Devices.
    with pytest.raises(ValueError, match="one CUDA device"):
        rg_ops.rglru_gated(za, zi, y, *vectors, h0.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        rg_ops.rglru_gated(za, zi, y, b_a, b_i, lam.cpu(), h0)
    # Shapes and strides.
    with pytest.raises(ValueError, match="shape"):
        rg_ops.rglru_gated(za, zi[:, :4], y, *vectors, h0)
    with pytest.raises(ValueError, match="lru_lambda"):
        rg_ops.rglru_gated(za, zi, y, b_a, b_i, lam[:32], h0)
    with pytest.raises(ValueError, match="state"):
        rg_ops.rglru_gated(za, zi, y, *vectors,
                           rnd((2, 65), torch.float32)[:, :64])
    with pytest.raises(ValueError, match="strides"):
        rg_ops.rglru_gated(za, zi.transpose(1, 2).contiguous()
                           .transpose(1, 2), y, *vectors, h0)


# ---------------------------------------------------------------------------
# The fused decode as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-9b",
               "qwen2-1.5b", "starcoder2-7b", "gemma2-27b", "mixtral-8x22b")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip(CUDA_MISSING_REASON)


def _smoke_bundle(arch, **over):
    """The arch's smoke config in bf16 with its attention on the kernels
    (head_dim 32: the smoke's 16 is below what they take), with the fields
    `over` set."""
    cfg = torch_configs.get_smoke(arch)
    if hasattr(cfg, "attn_impl"):
        cfg = dataclasses.replace(cfg, attn_impl="flash", head_dim=32)
    bundle = bundle_for(dataclasses.replace(cfg, **over))
    return bundle, bundle.init_params(0, "cuda")


def _card_engine(bundle, params, decode_impl="fused"):
    return InferenceEngine(bundle, params, max_batch=4, max_seq_len=48,
                           prompt_bucket=8, decode_impl=decode_impl,
                           device="cuda")


def _card_prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lengths]


def _delta(before):
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_decode_equals_eager_loop(card, arch):
    """Two generates at batch 3 in prompt buckets 8 and 16 replay one
    graph, each equal to the eager loop's tokens bit for bit.  The kernel
    counters move by the prefill over a replayed generate (and, on the
    first, by the capture's warm-up steps and its one recorded step):
    with replays x tally they equal the loop's, whose steps are eager."""
    bundle, params = _smoke_bundle(arch)
    fused = _card_engine(bundle, params)
    loop = _card_engine(bundle, params, "loop")
    steps = 6
    for i, lengths in enumerate(([5, 8, 2], [13, 9, 16])):
        prompts = _card_prompts(lengths, seed=i)
        before = launch_counts()
        out_f, _ = fused.generate(prompts, steps)
        torch.cuda.synchronize()
        d_fused = _delta(before)
        before = launch_counts()
        out_l, _ = loop.generate(prompts, steps)
        torch.cuda.synchronize()
        d_loop = _delta(before)
        np.testing.assert_array_equal(out_f, out_l)
        (graph,) = fused.decode_graphs.values()
        assert graph.graph is not None and graph.replays == steps * (i + 1)
        assert any(graph.tally.values())
        captured = graph.WARMUP_STEPS + 1 if i == 0 else 0
        assert {k: d_fused[k] + (steps - captured) * graph.tally[k]
                for k in d_fused} == d_loop
    assert fused.compile_counts["decode_fused"] == 1
    assert loop.compile_counts["decode_fused"] == 0
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.requires_cuda
def test_int8_cache_on_the_card_matches_the_cpu(card):
    """qwen2-smoke (head_dim 32) in fp32 with the int8 cache: a ragged
    prefill and 6 decode steps on the card (the kernels, decode attention
    over the dequantized cache) against the same weights on the CPU (plain
    versions) within 1e-4, the cache's codes within one step and its
    scales within 1e-5 of the CPU's; then the bf16 engine's graph-replayed
    tokens equal its eager loop's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bundle, params = _smoke_bundle("qwen2-1.5b", kv_cache_dtype="int8",
                                   dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for lp in params["layers"]:
        for name in ("bq", "bk", "bv"):
            lp["attn"][name].add_(0.3 * torch.randn(
                lp["attn"][name].shape, generator=gen, device="cuda"))
    cpu_params = {k: ([{a: ({b: t.cpu() for b, t in v.items()}
                            if isinstance(v, dict) else v.cpu())
                        for a, v in lp.items()} for lp in p]
                      if k == "layers" else
                      ({a: t.cpu() for a, t in p.items()}
                       if isinstance(p, dict) else p.cpu()))
                  for k, p in params.items()}
    toks = torch.from_numpy(np.stack([np.pad(p, (9 - len(p), 0))
                                      for p in _card_prompts([9, 5, 2], 6)]))
    mask = toks != 0
    outs, caches = {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        cache = bundle.init_cache(3, 32, dev)
        assert cache["global"]["k"].dtype == torch.int8
        dmask = torch.ones((3, 32), dtype=torch.bool, device=dev)
        dmask[:, :9] = mask.to(dev)
        logits, cache = bundle.prefill(p, toks.to(dev), cache,
                                       attn_mask=mask.to(dev))
        seq = [logits.cpu()]
        for i in range(6):
            tok = torch.argmax(seq[-1] if dev == "cuda" else outs["cuda"][i],
                               dim=-1)
            logits, cache = bundle.decode_step(p, tok.to(dev), cache, 9 + i,
                                               attn_mask=dmask)
            seq.append(logits.cpu())
        outs[dev], caches[dev] = torch.stack(seq), cache
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)
    for name, leaf in caches["cuda"]["global"].items():
        ref = caches["cpu"]["global"][name]
        if leaf.dtype == torch.int8:
            assert int((leaf.cpu().int() - ref.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(leaf.cpu(), ref, rtol=1e-5, atol=1e-7)

    bundle, params = _smoke_bundle("qwen2-1.5b", kv_cache_dtype="int8")
    prompts = _card_prompts([5, 8, 2], seed=7)
    before = dec_ops.launches
    out_f, _ = _card_engine(bundle, params).generate(prompts, 6)
    out_l, _ = _card_engine(bundle, params, "loop").generate(prompts, 6)
    np.testing.assert_array_equal(out_f, out_l)
    assert dec_ops.launches > before


class _HostSyncStep:
    """A bundle whose decode step reads the position on the host: a sync
    (`.item()`) when the position is a device tensor."""

    def __init__(self, bundle):
        self._bundle = bundle

    def __getattr__(self, name):
        return getattr(self._bundle, name)

    def decode_step(self, params, token, cache, pos, **kw):
        int(pos)
        return self._bundle.decode_step(params, token, cache, pos, **kw)


@pytest.mark.requires_cuda
def test_a_failed_capture_raises_and_nothing_decodes_eagerly(card):
    """The capture runs under `set_sync_debug_mode("error")`: a step that
    syncs raises from `generate`, stores no graph and raises again on the
    next call; the loop (a caller's choice) still runs the same step."""
    bundle, params = _smoke_bundle("llama3.2-1b")
    syncing = _HostSyncStep(bundle)
    fused = _card_engine(syncing, params)
    prompts = _card_prompts([4, 6], seed=3)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="synchroniz"):
            fused.generate(prompts, 3)
        assert fused.decode_graphs == {}
        assert torch.cuda.get_sync_debug_mode() == 0
    out, _ = _card_engine(syncing, params, "loop").generate(prompts, 3)
    ref, _ = _card_engine(bundle, params, "loop").generate(prompts, 3)
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# Continuous batching over the graph, and the board's power through NVML
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_continuous_identity_graph_equals_eager_loop(card, arch):
    """Every request at t=0, equal budgets, no EOS: `generate_continuous`
    (a replay of the pool's graph a step, chunks of 8 and of 3) gives the
    eager loop's `generate` tokens bit for bit, and replays the one graph
    the static path captured at that batch once a decode step."""
    from repro_torch.serving.scheduler import EngineRequest
    bundle, params = _smoke_bundle(arch)
    fused = _card_engine(bundle, params)
    prompts = _card_prompts([5, 8, 2], seed=5)
    ref, _ = _card_engine(bundle, params, "loop").generate(prompts, 6)
    out, _ = fused.generate(prompts, 6)
    np.testing.assert_array_equal(out, ref)
    (graph,) = fused.decode_graphs.values()
    for chunk in (8, 3):
        replays = graph.replays
        reqs = [EngineRequest(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        streams, st = fused.generate_continuous(reqs, n_slots=3,
                                                chunk=chunk)
        assert st.decode_steps == 6 and st.prefill_calls == 1
        assert graph.replays - replays == 6
        for i in range(3):
            np.testing.assert_array_equal(streams[i], ref[i])
    assert fused.compile_counts["decode_fused"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.requires_cuda
def test_nvml_reads_finite_watts_within_the_power_limit(card):
    """The ctypes NVML sensor reads the board: finite watts in (0, power
    limit], on the board whose UUID is CUDA device 0's."""
    import math
    import subprocess

    from repro_torch.obs import NVMLSensor
    limit = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits", "--id=0"], capture_output=True,
        text=True, check=True).stdout.split()[0])
    sensor = NVMLSensor()
    try:
        watts = [sensor.read_watts() for _ in range(5)]
        uuid = sensor.uuid()
    finally:
        sensor.close()
    assert sensor.name == "nvml:0"
    assert all(math.isfinite(w) and 0 < w <= limit for w in watts), watts
    cuda_uuid = str(torch.cuda.get_device_properties(0).uuid)
    assert uuid.lower().removeprefix("gpu-") == \
        cuda_uuid.lower().removeprefix("gpu-")


# --- training: the backward kernels and gradients on the card ----------------

#: dscale is a sum over every row: held as the grouped GEMM's sums are,
#: |err| <= tol * (1 + |ref|).
SUM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _sum_close(out, ref, tol):
    out, ref = out.float(), ref.float()
    err = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert err <= tol, err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_backward_kernel_matches_plain(rnd, dtype):
    """dx and dscale of the backward kernel against `rmsnorm_bwd_ref`:
    llama's d_model rows, olmoe's 128-wide qk-norm rows (16 or 32 lanes a
    row), rows past one slot's share of the grid (9000 x 64), a width off
    every power of two (96), one off a 16-byte vector (100: scalar loads),
    and a dy sliced along the sequence (a row stride the kernel takes).
    Each call is one launch, and the same inputs give the same bits
    twice."""
    dt, tol = DTYPES[dtype]
    before = rms_ops.bwd_launches
    cases = ((8, 64, 2048), (7, 5, 16, 128), (9000, 64), (3, 96), (5, 100))
    for shape in cases:
        x, s = rnd(shape, dt), rnd(shape[-1:], dt, 0.1)
        dy = rnd(shape, dt)
        dx, ds = rms_ops.rmsnorm_backward(dy, x, s)
        rdx, rds = rms_ops.rmsnorm_bwd_ref(dy, x, s)
        torch.testing.assert_close(dx, rdx, rtol=tol, atol=tol)
        _sum_close(ds, rds, SUM_TOL[dtype])
        dx2, ds2 = rms_ops.rmsnorm_backward(dy, x, s)
        assert torch.equal(dx, dx2) and torch.equal(ds, ds2), shape
    x, s = rnd((4, 40, 256), dt), rnd((256,), dt, 0.1)
    dy = rnd((4, 48, 256), dt)[:, 8:]          # not viewable as rows
    dx, ds = rms_ops.rmsnorm_backward(dy, x, s)
    rdx, rds = rms_ops.rmsnorm_bwd_ref(dy, x, s)
    torch.testing.assert_close(dx, rdx, rtol=tol, atol=tol)
    _sum_close(ds, rds, SUM_TOL[dtype])
    assert rms_ops.bwd_launches == before + 2 * len(cases) + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_backward_is_one_launch_with_a_strided_dy(rnd, dtype):
    """A dy that is a strided slice of a wider tensor (rows 2048 apart in
    a [.., 4096] buffer: every row a view, no copy) goes through the
    backward in one kernel launch, as the profiler sees it, and matches
    the plain backward on the same slice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dt, tol = DTYPES[dtype]
    x, s = rnd((4, 64, 2048), dt), rnd((2048,), dt, 0.1)
    dy = rnd((4, 64, 4096), dt)[..., 1024:3072]
    assert dy.stride(-2) == 4096
    rms_ops.rmsnorm_backward(dy, x, s)           # built and ticketed
    torch.cuda.synchronize()
    before = rms_ops.bwd_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dx, ds = rms_ops.rmsnorm_backward(dy, x, s)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    assert len(kernels) == 1 and "rmsnorm_bwd" in kernels[0], kernels
    assert rms_ops.bwd_launches == before + 1
    rdx, rds = rms_ops.rmsnorm_bwd_ref(dy, x, s)
    torch.testing.assert_close(dx, rdx, rtol=tol, atol=tol)
    _sum_close(ds, rds, SUM_TOL[dtype])


@pytest.mark.requires_cuda
def test_rmsnorm_is_differentiable_on_the_card(rnd):
    """Autograd through `rmsnorm` on CUDA tensors reaches x and scale
    through the backward kernel, and a call without grad launches the
    forward alone."""
    x = rnd((6, 10, 512), torch.float32).requires_grad_(True)
    s = rnd((512,), torch.float32, 0.1).requires_grad_(True)
    fwd, bwd = rms_ops.launches, rms_ops.bwd_launches
    y = rms_ops.rmsnorm(x, s)
    dy = torch.randn_like(y)
    y.backward(dy)
    rdx, rds = rms_ops.rmsnorm_bwd_ref(dy, x.detach(), s.detach())
    torch.testing.assert_close(x.grad, rdx, rtol=2e-5, atol=2e-5)
    _sum_close(s.grad, rds, 1e-4)
    assert (rms_ops.launches, rms_ops.bwd_launches) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        rms_ops.rmsnorm(x, s)
    assert (rms_ops.launches, rms_ops.bwd_launches) == (fwd + 2, bwd + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(GEMM_DTYPES))
def test_grouped_gemm_backward_matches_plain(rnd, dtype):
    """dx and dw through the kernel's variants against the plain
    backward: a capacity off a multiple of 8 and of 64 (37, and 20 at
    olmoe's 64 experts), C <= 8 (rows past C zero-filled for dx, a one-step
    contraction for dw), K and N off multiples of 64
    (40 x 48, 296 x 136, 64 x 96), and olmoe's training capacity of 640
    rows at narrow K and N; each twice, bit for bit.  A bf16 product
    launches no transposed copy, an fp32 one one; autograd through
    `grouped_gemm` (the custom op) gives the same."""
    dt, tol = GEMM_DTYPES[dtype]
    shapes = ((3, 37, 64, 96), (4, 5, 40, 48), (2, 24, 296, 136),
              (64, 20, 256, 128), (2, 1, 64, 72), (3, 640, 256, 384))
    d0, w0, t0 = mg_ops.dx_launches, mg_ops.dw_launches, \
        mg_ops.transpose_launches
    for e, c, k, n in shapes:
        x, w = rnd((e, c, k), dt), rnd((e, k, n), dt, k ** -0.5)
        dy = rnd((e, c, n), dt)
        dx, dw = mg_ops.grouped_gemm_dx(dy, w), mg_ops.grouped_gemm_dw(x, dy)
        _sum_close(dx, mg_ops.moe_gemm_dx_ref(dy, w), tol)
        _sum_close(dw, mg_ops.moe_gemm_dw_ref(x, dy), tol)
        assert torch.equal(dx, mg_ops.grouped_gemm_dx(dy, w)), (e, c, k, n)
        assert torch.equal(dw, mg_ops.grouped_gemm_dw(x, dy)), (e, c, k, n)
    n_calls = 2 * len(shapes)
    copies = 2 * n_calls if dtype == "float32" else 0
    assert (mg_ops.dx_launches, mg_ops.dw_launches,
            mg_ops.transpose_launches) == (d0 + n_calls, w0 + n_calls,
                                           t0 + copies)
    x = rnd((3, 37, 64), dt).requires_grad_(True)
    w = rnd((3, 64, 96), dt, 0.125).requires_grad_(True)
    y = mg_ops.grouped_gemm(x, w)
    dy = torch.randn_like(y)
    y.backward(dy)
    assert torch.equal(x.grad, mg_ops.grouped_gemm_dx(dy, w.detach()))
    assert torch.equal(w.grad, mg_ops.grouped_gemm_dw(x.detach(), dy))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(SUM_TOL))
def test_wkv6_backward_kernel_matches_plain(rnd, dtype):
    """The WKV6 backward kernel (dr, dk, dv, dlogw, dbonus) against
    autograd of the chunked plain version from a nonzero initial state, at
    every head dim, S not a multiple of the kernel's chunk of 16 (one past
    one, 17), S 1, strided inputs (16-byte aligned, staged by cp.async, and
    a width of 66, by plain loads), rwkv6-3b's heads and a 2048-step walk
    (dlogw's fp64 suffix sums over 128 chunks), as |err| <= tol (1 +
    |ref|); one launch a call, the same bits twice; and autograd through
    `wkv6` (the forward and backward kernels) gives the same."""
    dt = getattr(torch, dtype)
    tol = SUM_TOL[dtype]
    cases = ((2, 37, 3, 64, 72, 1), (3, 16, 5, 16, None, 8),
             (1, 50, 2, 32, 40, 5), (2, 96, 40, 64, None, 32),
             (2, 1, 3, 64, None, 1), (2, 17, 3, 32, None, 1),
             (1, 20, 2, 64, 66, 4),
             (1, 2048, 4, 64, None, 32))
    for b, s, h, n, width, chunk in cases:
        r, k, v, logw, u, st = _wkv_inputs(rnd, b, s, h, n, dt, width=width)
        dy = rnd((b, s, h, n), torch.float32)
        want = wk_ops.wkv6_bwd_ref(dy, r, k, v, logw, u, st, chunk)
        before = wk_ops.bwd_launches
        got = wk_ops.wkv6_backward(dy, r, k, v, logw, u, st)
        again = wk_ops.wkv6_backward(dy, r, k, v, logw, u, st)
        torch.cuda.synchronize()
        assert wk_ops.bwd_launches == before + 2
        for name, g, w, g2 in zip(("dr", "dk", "dv", "dlogw", "dbonus"),
                                  got, want, again):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert bool(torch.isfinite(g).all()), name
            _sum_close(g, w, tol)
            assert torch.equal(g, g2), (name, b, s, h, n)
    # Autograd through the forward and backward kernels.
    r, k, v, logw, u, st = _wkv_inputs(rnd, 2, 64, 4, 64, dt)
    dy = rnd((2, 64, 4, 64), torch.float32)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (r, k, v, logw, u)]
    state = st.clone()
    fwd, bwd = wk_ops.launches, wk_ops.bwd_launches
    y, out = wk_ops.wkv6(*leaves, state, chunk=32)
    grads = torch.autograd.grad(y, leaves, dy)
    assert out is state and not out.requires_grad
    assert (wk_ops.launches, wk_ops.bwd_launches) == (fwd + 1, bwd + 1)
    for g, w in zip(grads, wk_ops.wkv6_backward(dy, r, k, v, logw, u, st)):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_wkv6_backward_kernel_fills_the_card():
    """The built backward kernel's occupancy (registers, shared memory and
    launch bound, as the card reports it): at rwkv6-3b's training shape in
    bf16 every one of the 320 CTAs is resident at once, three an SM on
    the H100; every head dim and staging of both types launches."""
    if not torch.cuda.is_available():
        pytest.skip(CUDA_MISSING_REASON)
    plan = wk_ops.bwd_plan(8, 512, 40, 64, 2, (512 * 40 * 64, 40 * 64, 64,
                                               1), True)
    per_sm = wk_ops.bwd_ctas_an_sm(torch.bfloat16, 64, plan.staging)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert per_sm * sms >= plan.ctas
    for dt in (torch.float32, torch.bfloat16):
        for n in wk_ops.HEAD_DIMS:
            for staging in ("cp.async", "loads"):
                assert wk_ops.bwd_ctas_an_sm(dt, n, staging) >= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(SUM_TOL))
def test_rglru_backward_kernel_matches_plain(rnd, dtype):
    """The gated RG-LRU backward kernels (dza, dzi, dy and the per-channel
    sums) against autograd of `rglru_gates_ref` and the scan from a nonzero
    initial state, at recurrentgemma-9b's width, a ragged W of strided
    views (the tail), one step, one batch row, and S one past a multiple of
    `bwd_plan`'s chunk (8 and, at the training batch, 64), as |err| <= tol
    (1 + |ref|); the plan's launches a call (two where S spans more than a
    chunk), the same bits twice; and autograd through `rglru_gated` gives
    the same."""
    dt = getattr(torch, dtype)
    tol = SUM_TOL[dtype]
    for b, s, w, width in ((3, 37, 4096, None), (3, 21, 203, 235),
                           (2, 1, 64, None), (1, 70, 1030, None),
                           (2, 65, 4096, None), (8, 513, 4096, None)):
        za, zi, y, b_a, b_i, lam, h0 = _gated_inputs(rnd, b, s, w, dt,
                                                     width)
        inputs = (za, zi, y, b_a, b_i, lam)
        h, _ = rg_ops.rglru_gated(*inputs, h0.clone())
        dh = rnd((b, s, w), torch.float32)
        want = rg_ops.rglru_gated_bwd_ref(dh, *inputs, h0)
        plan = rg_ops.bwd_plan(b, s, w, rg_ops.sm_count(za.device))
        before = rg_ops.bwd_launches
        got = rg_ops.rglru_gated_backward(dh, *inputs, h0, h)
        again = rg_ops.rglru_gated_backward(dh, *inputs, h0, h)
        torch.cuda.synchronize()
        assert rg_ops.bwd_launches == before + 2 * plan.launches
        for name, g, ref, g2 in zip(("dza", "dzi", "dy", "b_a", "b_i",
                                     "lambda"), got, want, again):
            assert g.dtype == ref.dtype and g.shape == ref.shape, name
            assert bool(torch.isfinite(g).all()), name
            _sum_close(g, ref, tol)
            assert torch.equal(g, g2), (name, b, s, w)
    # Autograd through the forward and backward kernels.
    za, zi, y, b_a, b_i, lam, h0 = _gated_inputs(rnd, 2, 40, 512, dt)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (za, zi, y, b_a, b_i, lam)]
    state = h0.clone()
    fwd, bwd = rg_ops.launches, rg_ops.bwd_launches
    h, out = rg_ops.rglru_gated(*leaves, state)
    dh = rnd((2, 40, 512), torch.float32)
    grads = torch.autograd.grad(h, leaves, dh)
    assert out is state and not out.requires_grad
    assert (rg_ops.launches, rg_ops.bwd_launches) == (
        fwd + 1, bwd + rg_ops.bwd_plan(2, 40, 512,
                                       rg_ops.sm_count(za.device)).launches)
    want = rg_ops.rglru_gated_backward(dh, za, zi, y, b_a, b_i, lam, h0,
                                       h.detach())
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_gradient_reaches_every_leaf_on_the_card(card, arch):
    """The smoke model's loss and gradients in fp32, card against CPU
    (plain versions), on the same params and batch: every leaf has a
    gradient within 1e-3 of the CPU's norm (a gradient cut at a kernel
    fails that), and the kernels' backward ran (RMSNorm's where the model
    has RMSNorms, the grouped GEMM's, WKV6's, the gated RG-LRU's)."""
    from repro_torch.training import tree
    cfg = dataclasses.replace(torch_configs.get_smoke(arch),
                              dtype=torch.float32)
    bundle = bundle_for(cfg)
    params = bundle.init_params(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads(device):
        p = tree.tree_map(
            lambda t: t.to(device, copy=True).requires_grad_(True), params)
        b = {k: v.to(device) for k, v in batch.items()}
        loss = bundle.loss_fn(p, b)
        return loss, torch.autograd.grad(loss, tree.leaves(p))
    before = {**launch_counts(), **backward_launch_counts()}
    loss_c, g_card = grads("cuda")
    loss_h, g_cpu = grads("cpu")
    after = {**launch_counts(), **backward_launch_counts()}
    ran = {k for k in after if after[k] > before[k]}
    want = {"rwkv6": {"wkv6", "wkv6_bwd"},
            "rglru": {"rglru", "rglru_bwd", "rmsnorm", "rmsnorm_bwd"}}.get(
                bundle.family, {"rmsnorm", "rmsnorm_bwd"})
    if getattr(cfg, "moe", None) is not None:
        want |= {"moe_gemm", "moe_gemm_dx", "moe_gemm_dw"}
    assert want <= ran, (want, ran)
    assert abs(loss_c.item() - loss_h.item()) <= 1e-4 * abs(loss_h.item())
    for (path, _), gc, gh in zip(tree.flatten_with_paths(params), g_card,
                                 g_cpu):
        gc = gc.cpu()
        assert (gc - gh).norm() <= 1e-3 * gh.norm(), path
