"""The launch plans of the port's CUDA kernels, as pure functions of
shapes, strides and alignment.  The kernels themselves run only on the
card (tests/test_torch_cuda.py); what a plan picks, and what it refuses,
is decided here in Python and tested on the CPU."""

import pytest

from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops

# --- RMSNorm ----------------------------------------------------------------

RMSNORM_PLANS = [
    # (D, itemsize, row stride, aligned) -> (vec, lanes, items, rows a CTA)
    ((128, 2, 128, True), (8, 16, 1, 8)),     # olmoe's qk-norm rows, bf16
    ((128, 4, 128, True), (4, 32, 1, 4)),     # the same in fp32
    ((2048, 2, 2048, True), (8, 128, 2, 1)),  # llama / olmoe d_model
    ((4096, 2, 4096, True), (8, 256, 2, 1)),  # recurrentgemma d_model
    ((4096, 4, 4096, True), (4, 512, 2, 1)),
    ((96, 2, 96, True), (8, 16, 1, 8)),       # lanes past D idle
    ((128, 2, 136, True), (8, 16, 1, 8)),     # a row view, stride D + 8
    ((128, 2, 129, True), (1, 64, 2, 2)),     # stride D + 1: scalar
    ((100, 2, 100, True), (1, 64, 2, 2)),     # D not a multiple of 8
    ((2048, 2, 2048, False), (1, 1024, 2, 1)),  # base off a 16-byte line
    ((4096, 2, 4096, False), (1, 1024, 4, 1)),
    ((1, 4, 1, True), (1, 1, 1, 128)),
]


@pytest.mark.parametrize("args,want", RMSNORM_PLANS)
def test_rmsnorm_launch_plan(args, want):
    plan = rms_ops.launch_plan(*args)
    assert (plan.vec, plan.lanes, plan.items, plan.rows_per_cta) == want
    assert plan.threads == plan.lanes * plan.rows_per_cta
    assert plan.threads in (128, 256, 512, 1024)
    assert plan.lanes * plan.items * plan.vec >= args[0]
    assert plan.items * plan.vec <= rms_ops.MAX_VALUES


@pytest.mark.parametrize("args", [(8193, 2, 8193, True),
                                  (40000, 4, 40000, True), (0, 2, 0, True)])
def test_rmsnorm_launch_plan_refuses(args):
    with pytest.raises(ValueError, match="rmsnorm"):
        rms_ops.launch_plan(*args)


# --- RMSNorm backward ----------------------------------------------------------

RMSNORM_BWD_PLANS = [
    # (rows, D, itemsize, x stride, dy stride, aligned)
    #   -> (vec, lanes, items, threads, CTAs, group)
    ((4096, 2048, 2, 2048, 2048, True), (8, 128, 2, 1024, 132, 12)),  # llama
    ((65536, 128, 2, 128, 128, True), (8, 16, 1, 1024, 132, 12)),  # qk-norm
    ((4096, 2048, 4, 2048, 2048, True), (4, 256, 2, 1024, 132, 12)),
    ((65536, 128, 4, 128, 128, True), (4, 32, 1, 1024, 132, 12)),
    ((4096, 2048, 2, 2048, 4096, True), (8, 128, 2, 1024, 132, 12)),  # dy view
    ((4096, 2048, 2, 2048, 2049, True), (1, 1024, 2, 1024, 132, 12)),
    ((4096, 2048, 2, 2048, 2048, False), (1, 1024, 2, 1024, 132, 12)),
    ((5, 100, 2, 100, 100, True), (1, 64, 2, 960, 1, 1)),   # D off a vector
    ((9000, 64, 4, 64, 64, True), (4, 16, 1, 1024, 132, 12)),
    ((3, 96, 2, 96, 96, True), (8, 16, 1, 1024, 1, 1)),
    ((512, 1024, 2, 1024, 1024, True), (8, 64, 2, 960, 35, 6)),  # 15 slots
    ((512, 4608, 2, 4608, 4608, True), (8, 512, 2, 1024, 132, 12)),  # gemma2
    ((512, 6144, 4, 6144, 6144, True), (4, 1024, 2, 1024, 132, 12)),
    ((64, 16384, 2, 16384, 16384, True), (8, 1024, 2, 1024, 64, 8)),
]


@pytest.mark.parametrize("args,want", RMSNORM_BWD_PLANS)
def test_rmsnorm_bwd_plan(args, want):
    plan = rms_ops.bwd_plan(*args)
    assert (plan.vec, plan.lanes, plan.items, plan.threads, plan.ctas,
            plan.group) == want
    assert plan.slots == plan.threads // plan.lanes
    assert plan.groups * plan.group >= plan.ctas > (plan.groups - 1) \
        * plan.group


@pytest.mark.parametrize("args", [a for a, _ in RMSNORM_BWD_PLANS])
def test_rmsnorm_bwd_plan_covers_each_column_once(args):
    """The lanes' vectors cover each column of a row once, as the kernel
    reads them: lane l's item i is vector i * lanes + l of the row."""
    d = args[1]
    plan = rms_ops.bwd_plan(*args)
    cols = [c for lane in range(plan.lanes) for it in range(plan.items)
            for vi in [it * plan.lanes + lane] if vi < d // plan.vec
            for c in range(vi * plan.vec, (vi + 1) * plan.vec)]
    assert sorted(cols) == list(range(d))
    assert plan.items * plan.vec * args[2] <= rms_ops.BWD_MAX_BYTES


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_rmsnorm_bwd_plan_holds_at_most_two_ctas_an_sm(sms):
    """No more CTAs than SMs (one 1024-thread CTA an SM at 64 registers a
    thread, under the two an SM allowed), at most 15 rows a CTA where a row
    spans warps (the named barriers 1-15), and no CTA without rows."""
    for rows, d, itemsize in ((4096, 2048, 2), (65536, 128, 2),
                              (4096, 6144, 4), (7, 2048, 2), (512, 1024, 2),
                              (300, 4096, 2)):
        plan = rms_ops.bwd_plan(rows, d, itemsize, d, d, True, sms)
        assert plan.ctas <= sms and plan.threads <= 1024
        assert plan.threads % 32 == 0 and plan.threads % plan.lanes == 0
        if plan.lanes > 32:
            assert plan.slots <= 15
        assert (plan.ctas - 1) * plan.slots < rows


def test_rmsnorm_bwd_plan_loads_scalars_off_alignment():
    """16-byte loads only where x's and dy's strides and every base allow
    them; otherwise one element at a time, the rows' layout unchanged in
    width."""
    vec = rms_ops.bwd_plan(64, 2048, 2, 2048, 2048, True).vec
    assert vec == 8
    for args in ((64, 2048, 2, 2052, 2048, True),
                 (64, 2048, 2, 2048, 2052, True),
                 (64, 2048, 2, 2048, 2048, False),
                 (64, 2050, 2, 2050, 2050, True)):
        assert rms_ops.bwd_plan(*args).vec == 1, args


@pytest.mark.parametrize("args", [(64, 16400, 2, 16400, 16400, True),
                                  (64, 8200, 4, 8200, 8200, True),
                                  (64, 9000, 2, 9000, 9000, False),
                                  (0, 2048, 2, 2048, 2048, True),
                                  (64, 0, 2, 0, 0, True)])
def test_rmsnorm_bwd_plan_refuses(args):
    """Rows wider than 32 bytes a lane of each input (16 values in bf16,
    8 in fp32), and empty shapes."""
    with pytest.raises(ValueError, match="rmsnorm"):
        rms_ops.bwd_plan(*args)


# --- WKV6, chunked variant ----------------------------------------------------

def _strides(s, h, width):
    """Element strides of a [B, S, H, width] tensor viewed as [..., :N]."""
    return (s * h * width, h * width, width, 1)


WKV6_PLANS = [
    # (B, H, N, itemsize, strides, aligned) -> (staging, CTAs, threads)
    ((28, 40, 64, 2, _strides(64, 40, 64), True),
     ("cp.async", 1120, 128)),                # rwkv6-3b's prefill
    ((28, 40, 64, 4, _strides(64, 40, 64), True),
     ("cp.async", 1120, 128)),
    ((4, 40, 64, 2, _strides(2048, 40, 64), True),
     ("cp.async", 160, 128)),                 # the long prompt, B 4
    ((2, 40, 64, 2, _strides(2048, 40, 64), True),
     ("cp.async", 80, 128)),
    ((3, 5, 16, 2, _strides(64, 5, 24), True),
     ("cp.async", 15, 64)),                   # N 16: two warps, keys halved
    ((3, 5, 32, 4, _strides(64, 5, 32), True),
     ("cp.async", 15, 128)),                  # N 32: keys halved too
    ((2, 3, 64, 2, _strides(64, 3, 64), False),
     ("loads", 6, 128)),                      # a base off a 16-byte line
    ((2, 3, 64, 2, _strides(64, 3, 65), True),
     ("loads", 6, 128)),                      # rows of 65 bf16
    ((2, 3, 64, 4, _strides(64, 3, 66), True),
     ("loads", 6, 128)),                      # rows of 66 fp32
    ((2, 3, 64, 2, _strides(64, 3, 72), True),
     ("cp.async", 6, 128)),                   # rows of 72 bf16: 144 bytes
]


@pytest.mark.parametrize("args,want", WKV6_PLANS)
def test_wkv6_chunk_plan(args, want):
    plan = wk_ops.chunk_plan(*args)
    assert tuple(plan) == want


def test_wkv6_chunk_plan_owns_whole_heads():
    """A CTA a (b, h) at every batch, with a warp a 16-column value slice
    and at least two warps a CTA."""
    for n in wk_ops.HEAD_DIMS:
        for b in (1, 2, 4, 7, 28, 64):
            plan = wk_ops.chunk_plan(b, 40, n, 2, _strides(64, 40, n), True)
            assert plan.ctas == b * 40
            assert plan.threads % (32 * (n // 16)) == 0
            assert 64 <= plan.threads <= 128


@pytest.mark.parametrize("n", [48, 8, 128, 0])
def test_wkv6_chunk_plan_refuses(n):
    with pytest.raises(ValueError, match="wkv6"):
        wk_ops.chunk_plan(2, 3, n, 2, _strides(64, 3, max(n, 1)), True)


# --- grouped GEMM, bf16 decode variant -----------------------------------------

# (E, C, K, N): olmoe-1b-7b's decode gate/up and down, one expert, ragged N
# (off the 64-column unit), more units than SMs, one row.
DECODE_SHAPES = [(64, 8, 2048, 1024), (64, 8, 1024, 2048), (1, 8, 2048, 1024),
                 (3, 5, 40, 136), (2, 8, 2056, 200), (130, 3, 40, 136),
                 (1, 1, 8, 8)]


def _columns_a_cta(plan, n):
    """Columns of w (each K deep) that each CTA of the plan reads."""
    per_cta = [0] * plan.ctas
    for cta, _, _, cols in mg_ops.decode_units(plan, n):
        per_cta[cta] += cols
    return per_cta


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_moe_gemm_decode_plan_covers_every_column_once(shape):
    e, c, k, n = shape
    plan = mg_ops.decode_plan(e, c, k, n)
    assert plan.units == e * -(-n // mg_ops.DECODE_COLUMNS)
    assert plan.ctas == min(plan.units, mg_ops.SM_COUNT)
    seen = {}
    for cta, ex, n0, cols in mg_ops.decode_units(plan, n):
        assert 0 <= cta < plan.ctas and 0 <= ex < e
        assert 0 < cols <= mg_ops.DECODE_COLUMNS
        for col in range(n0, n0 + cols):
            seen[(ex, col)] = seen.get((ex, col), 0) + 1
    assert seen == {(ex, col): 1 for ex in range(e) for col in range(n)}


@pytest.mark.parametrize("n", [1024, 2048])
def test_moe_gemm_decode_plan_balances_olmoe(n):
    """At olmoe-1b-7b's decode products on 132 SMs, every SM holds one
    CTA and the busiest reads within 4 % of the mean bytes an SM."""
    plan = mg_ops.decode_plan(64, 8, 3072 - n, n, 132)
    assert plan == (64 * n // 64, 132)
    per_cta = _columns_a_cta(plan, n)
    assert max(per_cta) <= 1.04 * sum(per_cta) / len(per_cta)


def test_moe_gemm_decode_plan_takes_the_cards_sm_count():
    """The grid is one CTA an SM of the card it is given, and no more CTAs
    than units."""
    assert mg_ops.decode_plan(64, 8, 2048, 1024, 114) == (1024, 114)
    assert mg_ops.decode_plan(1, 8, 2048, 1024) == (16, 16)
    assert mg_ops.decode_plan(1, 1, 8, 8, 1) == (1, 1)


@pytest.mark.parametrize("shape", [(64, 9, 2048, 1024), (64, 0, 2048, 1024),
                                   (0, 8, 2048, 1024), (64, 8, 2044, 1024),
                                   (64, 8, 2048, 1020), (65536, 8, 64, 64),
                                   (64, 8, 0, 1024)])
def test_moe_gemm_decode_plan_refuses(shape):
    with pytest.raises(ValueError, match="moe_gemm decode"):
        mg_ops.decode_plan(*shape)


# --- grouped GEMM, bf16 backward variant ----------------------------------------

# (E, M, Nn): olmoe-1b-7b's training dx (M = C = 640, Nn = K) and dw (M =
# K, Nn = N) for gate/up and down; ragged M and Nn; one tile; more tiles
# than CTAs.
BWD_SHAPES = [(64, 640, 2048), (64, 640, 1024), (64, 2048, 1024),
              (64, 1024, 2048), (3, 37, 296), (1, 1, 8), (2, 300, 136),
              (5, 128, 256)]


def _bwd_tiles(plan):
    """(cta, expert, first row, first column) of every tile, in the order
    each CTA takes them: `tile_of` of `moe_gemm_bwd_bf16` (csrc/moe_gemm.cu)
    on a grid of `plan.ctas` CTAs."""
    per_expert = plan.m_tiles * plan.n_tiles
    for cta in range(plan.ctas):
        for t in range(cta, plan.tiles, plan.ctas):
            r = t % per_expert
            yield (cta, t // per_expert,
                   (r // plan.n_tiles) * mg_ops.BWD_ROWS,
                   (r % plan.n_tiles) * mg_ops.BWD_COLS)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_moe_gemm_bwd_plan_covers_every_tile_once(shape):
    e, m, nn = shape
    plan = mg_ops.bwd_plan(e, m, nn)
    assert plan.tiles == e * -(-m // 128) * -(-nn // 256)
    assert plan.ctas == min(plan.tiles, mg_ops.SM_COUNT)
    seen = {}
    for cta, ex, m0, n0 in _bwd_tiles(plan):
        assert 0 <= cta < plan.ctas and 0 <= ex < e
        assert 0 <= m0 < m and 0 <= n0 < nn
        seen[(ex, m0, n0)] = seen.get((ex, m0, n0), 0) + 1
    assert seen == {(ex, m0, n0): 1 for ex in range(e)
                    for m0 in range(0, m, 128) for n0 in range(0, nn, 256)}


def test_moe_gemm_bwd_plan_splits_olmoe_training_shapes_into_whole_tiles():
    """C = 640 rows an expert (B 8 x S 512 at capacity factor 1.25) is five
    whole 128-row tiles and K, N whole 256-column ones: no tile of dx or
    dw holds a row or column past the edge, and the busiest CTA takes
    within 4 % of the mean tiles on 132 SMs."""
    for m, nn in ((640, 2048), (640, 1024), (2048, 1024), (1024, 2048)):
        plan = mg_ops.bwd_plan(64, m, nn, 132)
        assert plan.m_tiles * 128 == m and plan.n_tiles * 256 == nn
        counts = [0] * plan.ctas
        for cta, *_ in _bwd_tiles(plan):
            counts[cta] += 1
        assert max(counts) <= 1.04 * plan.tiles / plan.ctas


@pytest.mark.parametrize("shape", [(0, 640, 2048), (64, 0, 2048),
                                   (64, 640, 0), (65536, 8, 8)])
def test_moe_gemm_bwd_plan_refuses(shape):
    with pytest.raises(ValueError, match="moe_gemm backward"):
        mg_ops.bwd_plan(*shape)


# --- RG-LRU ------------------------------------------------------------------

RGLRU_PLANS = [
    # (B, S, W, (batch, step) strides, aligned) -> (vec, CTAs)
    ((28, 1, 4096, (4096, 4096), True), (True, 112)),   # the decode step
    ((28, 16, 4096, (16 * 4096, 4096), True), (True, 112)),  # the prompt
    ((4, 1, 4096, (4096, 4096), True), (True, 16)),
    ((3, 37, 200, (37 * 232, 232), True), (True, 3)),  # row views of 232
    ((28, 1, 4096, (4096, 4097), True), (True, 112)),  # S 1: no step stride
    ((3, 37, 203, (37 * 203, 203), True), (False, 3)),  # W 203: the tail
    ((2, 8, 64, (8 * 65, 65), True), (False, 2)),      # rows of 65
    ((2, 1, 4100, (4100, 4100), True), (True, 10)),    # 1025 threads a row
    ((28, 1, 4096, (4096, 4096), False), (False, 112)),  # a base off line
]


@pytest.mark.parametrize("args,want", RGLRU_PLANS)
def test_rglru_launch_plan(args, want):
    plan = rg_ops.launch_plan(*args)
    assert (plan.vec, plan.ctas) == want
    b, _, w = args[:3]
    assert plan.ctas % b == 0
    assert plan.ctas // b * rg_ops.CTA_THREADS * rg_ops.LANES >= w


def test_rglru_launch_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="rglru"):
        rg_ops.launch_plan(0, 1, 4096, (4096, 4096), True)
