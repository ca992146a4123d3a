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


# --- WKV6 backward -------------------------------------------------------------

WKV6_BWD_PLANS = [
    # (B, S, H, N, itemsize, strides, aligned)
    #   -> (staging, CTAs, threads, chunks)
    ((8, 512, 40, 64, 2, _strides(512, 40, 64), True),
     ("cp.async", 320, 128, 32)),             # rwkv6-3b's training, bf16
    ((8, 512, 40, 64, 4, _strides(512, 40, 64), True),
     ("cp.async", 320, 128, 32)),             # fp32
    ((2, 37, 3, 64, 2, _strides(37, 3, 72), True),
     ("cp.async", 6, 128, 3)),                # S one past two chunks, + 5
    ((1, 1, 3, 32, 4, _strides(1, 3, 32), True),
     ("cp.async", 3, 64, 1)),                 # S 1
    ((1, 2048, 4, 16, 2, _strides(2048, 4, 16), True),
     ("cp.async", 4, 32, 128)),               # N 16: one warp
    ((1, 20, 2, 64, 2, _strides(20, 2, 66), True),
     ("loads", 2, 128, 2)),                   # rows of 66 bf16
    ((1, 20, 2, 64, 2, _strides(20, 2, 64), False),
     ("loads", 2, 128, 2)),                   # a base off a 16-byte line
    ((3, 16, 5, 32, 4, _strides(16, 5, 34), True),
     ("loads", 15, 64, 1)),                   # fp32 rows of 34: 8-byte lines
    ((3, 16, 5, 32, 4, _strides(16, 5, 36), True),
     ("cp.async", 15, 64, 1)),                # fp32 rows of 36: 16-byte lines
]


@pytest.mark.parametrize("args,want", WKV6_BWD_PLANS)
def test_wkv6_bwd_plan(args, want):
    plan = wk_ops.bwd_plan(*args)
    assert (plan.staging, plan.ctas, plan.threads, plan.chunks) == want


@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 32, 512, 513, 2048])
def test_wkv6_bwd_plan_covers_the_sequence_once(s):
    """The chunks of BWD_CHUNK positions cover S exactly once: every
    position in one chunk, the last chunk holding at least one."""
    plan = wk_ops.bwd_plan(2, s, 3, 64, 2, _strides(s, 3, 64), True)
    covered = [t for c in range(plan.chunks)
               for t in range(c * wk_ops.BWD_CHUNK,
                              min(s, (c + 1) * wk_ops.BWD_CHUNK))]
    assert covered == list(range(s))
    assert (plan.chunks - 1) * wk_ops.BWD_CHUNK < s


def test_wkv6_bwd_plan_fills_the_card_at_rwkv6_training():
    """At rwkv6-3b's training shape the grid is one CTA a (b, h), 320 of
    4 warps, more than twice the H100's 132 SMs (how many an SM holds at
    once is the built kernel's occupancy, which the card test pins)."""
    plan = wk_ops.bwd_plan(8, 512, 40, 64, 2, _strides(512, 40, 64), True)
    assert plan.ctas == 8 * 40 and plan.threads == 4 * 32
    assert plan.ctas > 2 * 132


@pytest.mark.parametrize("n", [48, 8, 128, 0])
def test_wkv6_bwd_plan_refuses(n):
    with pytest.raises(ValueError, match="wkv6 backward"):
        wk_ops.bwd_plan(2, 16, 3, n, 2, _strides(16, 3, max(n, 1)), True)


def test_wkv6_bwd_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="wkv6 backward"):
        wk_ops.bwd_plan(2, 0, 3, 64, 2, _strides(1, 3, 64), True)


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


# --- RG-LRU backward -----------------------------------------------------------

RGLRU_BWD_PLANS = [
    # (B, S, W, SMs) -> (chunk, chunks, CTAs, launches)
    ((8, 512, 4096, 132), (64, 8, 1024, 2)),   # recurrentgemma-9b training
    ((8, 513, 4096, 132), (64, 9, 1152, 2)),   # one past a chunk multiple
    ((8, 512, 4096, 300), (32, 16, 2048, 2)),  # a card of 300 SMs
    ((2, 65, 4096, 132), (8, 9, 288, 2)),      # a short batch: chunks of 8
    ((3, 37, 4096, 132), (8, 5, 240, 2)),
    ((2, 1, 64, 132), (1, 1, 2, 1)),           # S 1: one chunk, one launch
    ((2, 5, 9, 132), (5, 1, 2, 1)),            # S below a chunk
    ((1, 70, 1030, 132), (8, 9, 45, 2)),       # W 1030: a ragged column
]


@pytest.mark.parametrize("args,want", RGLRU_BWD_PLANS)
def test_rglru_bwd_plan(args, want):
    assert tuple(rg_ops.bwd_plan(*args)) == want


@pytest.mark.parametrize("b,s,w", [(8, 512, 4096), (8, 513, 4096),
                                   (2, 65, 4096), (3, 37, 4096), (2, 1, 64),
                                   (1, 70, 1030), (1, 200000, 8)])
def test_rglru_bwd_plan_covers_the_sequence_once(b, s, w):
    """The chunks cover S exactly once, the last holding at least one step;
    B x chunks fits a grid's rows; CTAs a column of W times B x chunks."""
    plan = rg_ops.bwd_plan(b, s, w)
    covered = [t for c in range(plan.chunks)
               for t in range(c * plan.chunk, min(s, (c + 1) * plan.chunk))]
    assert covered == list(range(s))
    assert (plan.chunks - 1) * plan.chunk < s
    assert b * plan.chunks <= rg_ops.MAX_GRID_Y
    assert plan.ctas == -(-w // rg_ops.CTA_THREADS) * b * plan.chunks
    assert plan.launches == 1 + (plan.chunks > 1)


def test_rglru_bwd_plan_fills_the_card_at_recurrentgemma_training():
    """At recurrentgemma-9b's training shape the walk has 1,024 CTAs of 256
    on 132 SMs, BWD_FILL (4) an SM and more, against the 128 of a thread a
    channel walking all of S; the chunk-local walk first, then the walk
    from the carries."""
    plan = rg_ops.bwd_plan(8, 512, 4096, 132)
    assert plan.ctas >= rg_ops.BWD_FILL * 132
    assert plan.ctas == 8 * plan.chunks * 16
    assert plan.launches == 2


def test_rglru_bwd_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="rglru backward"):
        rg_ops.bwd_plan(0, 1, 4096)
