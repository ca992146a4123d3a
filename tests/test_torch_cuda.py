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
at another rounding order than the plain versions', 1e-4.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.models import moe

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
    """Every variant (skinny C <= 8, tile C > 8) with ragged C, K and N
    edges, and olmoe-1b-7b's decode and prefill products.  The bf16 tile
    (TMA + wgmma) at one to four m64 tiles and two row blocks (C = 300),
    with N off its 128-column tile and K off its 64-deep stage."""
    dt, tol = GEMM_DTYPES[dtype]
    before = mg_ops.launches
    shapes = ((3, 5, 40, 48), (2, 33, 32, 48), (4, 96, 64, 64),
              (2, 9, 2056, 136), (1, 1, 8, 8), (5, 70, 24, 200),
              (64, 8, 2048, 1024), (64, 8, 1024, 2048), (64, 224, 2048, 1024),
              (64, 224, 1024, 2048)) + tuple(
                  (3, c, k, n) for c in (9, 32, 40, 224, 300)
                  for k, n in ((2048, 200), (40, 136)))
    for e, c, k, n in shapes:
        x, w = rnd((e, c, k), dt), rnd((e, k, n), dt, k ** -0.5)
        torch.testing.assert_close(mg_ops.grouped_gemm(x, w),
                                   mg_ops.moe_gemm_ref(x, w), rtol=tol,
                                   atol=tol)
    assert mg_ops.launches == before + len(shapes)


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
