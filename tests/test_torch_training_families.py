"""Training of rwkv6, recurrentgemma and the encoder-decoder in the port
against the JAX package's, on the CPU (fp32 smoke configs, TOL 1e-4 as in
tests/test_torch_training.py).

- `loss_fn` and every leaf's gradient against `jax.value_and_grad` of the
  reference's `loss_fn`, with the reference's weights (`params_from_jax`;
  leaves that init leaves at zero filled with seeded noise), every
  gradient nonzero but the key biases' (zero but for rounding: the
  softmax cancels them): rwkv6-smoke, recurrentgemma-smoke (naive and
  flash attention) and seamless-smoke.
- The plain backwards against `jax.vjp` from a nonzero initial state:
  WKV6 (`wkv6_bwd_ref`) against `repro.models.rwkv6.wkv6_chunked`, the
  gated RG-LRU (`rglru_gated_bwd_ref`, chained through the gate products)
  against `repro.models.rglru.rglru_scan`.
- The backward kernels' algorithms, written out in float64 as the CUDA
  kernels run them (WKV6: the chunked form, a forward sweep of chunks for
  dr and a backward one for dk, dv and dlogw as a difference of two fp64
  suffix sums; the RG-LRU: chunk-local walks, their carries, the walks
  again), against the plain backwards, at S not a multiple of the chunk,
  below it and of one step, logw at -4 over a whole chunk, and a W not a
  multiple of 4; the WKV6 kernel's operand split to TF32 for fp32 inputs
  (rounded to nearest: products unbiased); and the two autograd Functions' plumbing
  (the initial state kept before the forward overwrites it, the final
  state without a gradient) with their launches replaced by the plain
  forwards.
- rwkv6's remat "dots" and "full" against "none"; AdamW's weight-decay set
  of every family's tree against the reference's; five train steps of
  rwkv6 and recurrentgemma against JAX's; `run_training` with a crash and
  resume; the encoder-decoder refused by `run_training` in the reference's
  words.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.launch import steps as jax_steps
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv6
from repro.models.registry import bundle_for as jax_bundle_for
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticLM as JaxSyntheticLM
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.launch import steps, train
from repro_torch.models import encdec
from repro_torch.models.registry import bundle_for
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree

TOL = dict(rtol=1e-4, atol=1e-4)
F64 = torch.float64

#: One arch of each family.
ARCHS = ("llama3.2-1b", "rwkv6-3b", "recurrentgemma-9b",
         "seamless-m4t-large-v2")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _noised(jparams, seed: int = 0):
    """The reference's params as numpy, every leaf that init leaves at zero
    (mixes, decay base, bonus, biases, norm scales) filled with noise."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a, np.float32)
        if not a.any():
            a = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree.map(fill, jparams)


@functools.lru_cache(maxsize=None)
def _models(arch: str, attn_impl: str = "naive"):
    """(reference bundle, its params as numpy, port bundle, port params)
    of the arch's smoke config in fp32."""
    extra = {} if arch != "recurrentgemma-9b" else {"attn_impl": attn_impl}
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch), dtype=jnp.float32,
                               **extra)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32, **extra)
    jb = jax_bundle_for(jcfg)
    jparams = _noised(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, bundle_for(tcfg), _port_tree(tcfg, jparams)


def _port_tree(tcfg, jtree):
    """A reference tree of the config's params structure as the port's."""
    return bundle_for(tcfg).module.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jtree), device="cpu")


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if isinstance(cfg, encdec.EncDecConfig):
        batch["speech_embeddings"] = rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _torch_grads(bundle, params, batch):
    flat = tree.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = bundle.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss, tree.unflatten(params, list(grads))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str, attn_impl: str = "naive"):
    jb, jparams, tb, _ = _models(arch, attn_impl)
    batch = _batch(tb.cfg)
    loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn))(jparams, batch)
    return float(loss), _port_tree(tb.cfg, grads)


# ---------------------------------------------------------------------------
# loss_fn and every gradient against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,attn_impl", [
    ("rwkv6-3b", "naive"), ("recurrentgemma-9b", "naive"),
    ("recurrentgemma-9b", "flash"), ("seamless-m4t-large-v2", "naive")])
def test_loss_and_every_grad_match_jax(arch, attn_impl):
    _, _, tb, tparams = _models(arch, attn_impl)
    jloss, ref = _jax_value_and_grad(arch, attn_impl)
    loss, grads = _torch_grads(tb, tparams, _torch_batch(_batch(tb.cfg)))
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    got, want = tree.flatten_with_paths(grads), tree.flatten_with_paths(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    scale = max(float(r.abs().max()) for _, r in want)
    for (path, g), (_, r) in zip(got, want):
        if path.endswith("/bk"):
            # A key bias moves every score of a query by the same amount,
            # which the softmax cancels: its gradient is zero but for
            # rounding, in both packages.
            assert float(r.abs().max()) <= 1e-6 * scale, path
            assert float(g.abs().max()) <= 1e-6 * scale, path
        else:
            assert float(r.abs().max()) > 0 and float(g.abs().max()) > 0, \
                path
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_abstract_params_match_init_and_the_reference(arch):
    tcfg = torch_configs.get_smoke(arch)
    abstract = bundle_for(tcfg).abstract_params()
    real = bundle_for(tcfg).init_params(0, "cpu")
    a, r = tree.flatten_with_paths(abstract), tree.flatten_with_paths(real)
    assert [k for k, _ in a] == [k for k, _ in r]
    for (path, x), (_, y) in zip(a, r):
        assert x.device.type == "meta", path
        assert (x.shape, x.dtype) == (y.shape, y.dtype), path
    jp = jax_bundle_for(jax_configs.get_smoke(arch)).abstract_params()
    ref = _port_tree(tcfg, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jp))
    assert [(k, tuple(x.shape)) for k, x in a] == \
        [(k, tuple(x.shape)) for k, x in tree.flatten_with_paths(ref)]


def test_remat_modes_match_none():
    """rwkv6 recomputes each layer in the backward under "dots" and "full"
    (the reference's jax.checkpoint of the layer body): the loss equal, the
    gradients within 1e-6; an unknown policy is refused."""
    _, _, tb, tparams = _models("rwkv6-3b")
    batch = _torch_batch(_batch(tb.cfg, seed=1))
    loss, grads = _torch_grads(tb, tparams, batch)
    for remat in ("dots", "full"):
        rb = bundle_for(dataclasses.replace(tb.cfg, remat=remat))
        rloss, rgrads = _torch_grads(rb, tparams, batch)
        assert rloss.item() == loss.item()
        for a, b in zip(tree.leaves(rgrads), tree.leaves(grads)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for arch in ARCHS:
        with pytest.raises(ValueError, match="remat"):
            dataclasses.replace(torch_configs.get_smoke(arch), remat="some")


# ---------------------------------------------------------------------------
# The plain backwards against jax.vjp
# ---------------------------------------------------------------------------

def _wkv6_inputs(b, s, h, n, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, n)) for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((b, s, h, n)) - 2.0), -4.0,
                   -1e-6)
    u = 0.3 * rng.standard_normal((h, n))
    s0 = 0.5 * rng.standard_normal((b, h, n, n))
    dy = rng.standard_normal((b, s, h, n))
    return [np.asarray(a, np.float32) for a in (r, k, v, logw, u, s0, dy)]


def test_wkv6_plain_backward_matches_jax_vjp():
    """dr, dk, dv, dlogw and dbonus of `wkv6_bwd_ref` against jax.vjp of
    the reference's `wkv6_chunked`, from a nonzero state."""
    r, k, v, logw, u, s0, dy = _wkv6_inputs(2, 32, 3, 16)
    _, vjp = jax.vjp(
        lambda *a: jax_rwkv6.wkv6_chunked(*a, jnp.asarray(s0), 8)[0],
        *(jnp.asarray(a) for a in (r, k, v, logw, u)))
    want = vjp(jnp.asarray(dy))
    got = wk_ops.wkv6_backward(*(_t(a) for a in (dy, r, k, v, logw, u, s0)),
                               chunk=8)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "dbonus"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def _rglru_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, s, w))
    wa, wi = (0.3 * rng.standard_normal((w, w)) for _ in range(2))
    ba, bi = (0.5 * rng.standard_normal(w) for _ in range(2))
    u = rng.uniform(0.9, 0.999, w)
    lam = np.log(np.expm1(-np.log(u) / 8.0))
    h0 = rng.standard_normal((b, w))
    dh = rng.standard_normal((b, s, w))
    return [np.asarray(a, np.float32)
            for a in (y, wa, wi, ba, bi, lam, h0, dh)]


def test_rglru_plain_backward_matches_jax_vjp():
    """`rglru_gated_bwd_ref` chained through the gate products (za = y w_a,
    zi = y w_i) against jax.vjp of the reference's `rglru_scan` in y, w_a,
    w_i, b_a, b_i and lru_lambda, from a nonzero h0."""
    y, wa, wi, ba, bi, lam, h0, dh = _rglru_inputs(2, 13, 10)

    def scan(y_, wa_, wi_, ba_, bi_, lam_):
        bp = {"w_a": wa_, "w_i": wi_, "b_a": ba_, "b_i": bi_,
              "lru_lambda": lam_}
        return jax_rglru.rglru_scan(bp, y_, jnp.asarray(h0))[0]
    _, vjp = jax.vjp(scan, *(jnp.asarray(a) for a in (y, wa, wi, ba, bi,
                                                       lam)))
    want = vjp(jnp.asarray(dh))
    yt, wat, wit = _t(y), _t(wa), _t(wi)
    dza, dzi, dy, dba, dbi, dlam = rg_ops.rglru_gated_backward(
        _t(dh), yt @ wat, yt @ wit, yt, _t(ba), _t(bi), _t(lam), _t(h0),
        None)
    got = (dy + dza @ wat.T + dzi @ wit.T,
           torch.einsum("bsw,bsu->wu", yt, dza),
           torch.einsum("bsw,bsu->wu", yt, dzi), dba, dbi, dlam)
    for name, g, w in zip(("y", "w_a", "w_i", "b_a", "b_i", "lru_lambda"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# The kernels' algorithms, written out, against the plain backwards
# ---------------------------------------------------------------------------

def wkv6_bwd_chunked(dy, r, k, v, logw, u, s0, dtype=F64):
    """`wkv6_bwd_kernel`'s chunked form in `dtype` (float64 unless
    asked): chunks of BWD_CHUNK positions, the last padded with zeros; the
    decays formed about the chunk's middle (cum at position C / 2 - 1); a
    forward sweep with the state for dr^s = e^ce (dy S_c^T) + e^(ce - mid)
    (B (k e^(mid - cum))), B_ij = dy_i . v_j (j < i), parking r dr^s; a
    backward one with G at the chunk's end for dk^s and dv^s; and dlogw_t =
    sum_{i>t} r_i dr^s_i - sum_{j>=t} k_j dk^s_j as fp64 suffix sums taken a
    chunk at a time, each chunk in two halves (the kernel's two threads of
    a key), the later half's sums first."""
    c = wk_ops.BWD_CHUNK
    s = r.shape[1]
    pad = -s % c
    r, k, v, logw, dy = (torch.nn.functional.pad(t.to(dtype),
                                                 (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw, dy))
    u, s0 = u.to(dtype), s0.to(dtype)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool), diagonal=-1)
    vdy, ruk = (v * dy).sum(-1, keepdim=True), (r * u * k).sum(-1,
                                                              keepdim=True)

    def chunk_of(ci):
        sl = slice(ci * c, (ci + 1) * c)
        rc, kc, vc, dyc = r[:, sl], k[:, sl], v[:, sl], dy[:, sl]
        cum = logw[:, sl].cumsum(1)
        ce = cum - logw[:, sl]
        mid, tot = cum[:, c // 2 - 1:c // 2], cum[:, -1:]
        kn, rn = kc * (mid - cum).exp(), rc * (ce - mid).exp()
        bm = torch.einsum("bihm,bjhm->bhij", dyc, vc) * mask
        return sl, rc, kc, vc, dyc, cum, ce, mid, tot, kn, rn, bm

    dr, dk, dv, dlogw, parked = (torch.empty_like(r) for _ in range(5))
    state = s0.clone()
    for ci in range(r.shape[1] // c):
        sl, rc, kc, vc, dyc, cum, ce, mid, tot, kn, rn, bm = chunk_of(ci)
        drs = ce.exp() * torch.einsum("bhnm,bihm->bihn", state, dyc) \
            + (ce - mid).exp() * torch.einsum("bhij,bjhn->bihn", bm, kn)
        dr[:, sl] = drs + u * kc * vdy[:, sl]
        parked[:, sl] = rc * drs
        state = tot.exp()[:, 0, ..., None] * state + torch.einsum(
            "bjhn,bjhm->bhnm", kn * (tot - mid).exp(), vc)
    grad = torch.zeros_like(s0)
    suf_r = suf_k = torch.zeros_like(r[:, 0], dtype=F64)
    parts = 2
    for ci in reversed(range(r.shape[1] // c)):
        sl, rc, kc, vc, dyc, cum, ce, mid, tot, kn, rn, bm = chunk_of(ci)
        am = torch.einsum("bihn,bjhn->bhij", rn, kn) * mask
        dks = (tot - cum).exp() * torch.einsum("bhnm,bjhm->bjhn", grad, vc) \
            + (mid - cum).exp() * torch.einsum("bhij,bihn->bjhn", bm, rn)
        dk[:, sl] = dks + u * rc * vdy[:, sl]
        dv[:, sl] = torch.einsum("bjhn,bhnm->bjhm", kn * (tot - mid).exp(),
                                 grad) \
            + torch.einsum("bhij,bihm->bjhm", am, dyc) + ruk[:, sl] * dyc
        p, q = parked[:, sl].to(F64), (kc * dks).to(F64)
        seg = c // parts
        p_q = [p[:, x * seg:(x + 1) * seg].sum(1) for x in range(parts)]
        q_q = [q[:, x * seg:(x + 1) * seg].sum(1) for x in range(parts)]
        for x in range(parts):
            sr, sk = suf_r, suf_k
            for y in reversed(range(x + 1, parts)):
                sr, sk = sr + p_q[y], sk + q_q[y]
            for j in reversed(range(x * seg, (x + 1) * seg)):
                sk = sk + q[:, j]
                dlogw[:, ci * c + j] = (sr - sk).to(dtype)
                sr = sr + p[:, j]
        for y in reversed(range(parts)):
            suf_r, suf_k = suf_r + p_q[y], suf_k + q_q[y]
        grad = tot.exp()[:, 0, ..., None] * grad + torch.einsum(
            "bihn,bihm->bhnm", rn * mid.exp(), dyc)
    du = (r * k * vdy).sum((0, 1))
    return dr[:, :s], dk[:, :s], dv[:, :s], dlogw[:, :s], du


def rglru_bwd_chunked(dh, za, zi, y, ba, bi, lam, h0, chunk):
    """`rglru_gated_bwd_local` and `rglru_gated_bwd_kernel` in float64:
    the gates made again; the sequence in chunks of `chunk` steps, each of
    chunks 1 .. n - 1 walked backward from a zero carry for the carry it
    passes on (L = a_t0 g^_t0) and its product of a (P); each chunk's true
    carry C = L' + P' C from the last chunk down; each chunk walked again
    from it, g_t = dh_t + a_{t+1} g_{t+1}, the clamp passing no gradient;
    the sums taken a (row, chunk) at a time, then added in that order."""
    za, zi, y, ba, bi, lam, h0, dh = (t.to(F64) for t in (za, zi, y, ba,
                                                           bi, lam, h0, dh))
    r, i = torch.sigmoid(za + ba), torch.sigmoid(zi + bi)
    neg_c = -8.0 * torch.nn.functional.softplus(lam)
    a = torch.exp(neg_c * r)
    q = 1.0 - a * a
    s = q.clamp_min(1e-9).sqrt()
    h, hc = torch.empty_like(za), h0
    for t in range(za.shape[1]):
        hc = a[:, t] * hc + s[:, t] * i[:, t] * y[:, t]
        h[:, t] = hc
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    steps = za.shape[1]
    bounds = [(t0, min(steps, t0 + chunk)) for t0 in range(0, steps, chunk)]
    records = {}
    for ci, (t0, t1) in enumerate(bounds[1:], start=1):
        carry, prod = torch.zeros_like(h0), torch.ones_like(h0)
        for t in reversed(range(t0, t1)):
            carry = a[:, t] * (dh[:, t] + carry)
            prod = prod * a[:, t]
        records[ci] = (carry, prod)
    dza, dzi, dy = (torch.empty_like(za) for _ in range(3))
    parts = []
    for ci, (t0, t1) in enumerate(bounds):
        carry = torch.zeros_like(h0)
        for cc in reversed(range(ci + 1, len(bounds))):
            carry = records[cc][0] + records[cc][1] * carry
        sums = [torch.zeros_like(h0) for _ in range(3)]
        for t in reversed(range(t0, t1)):
            g = dh[:, t] + carry
            dla = g * h_prev[:, t] * a[:, t] - torch.where(
                q[:, t] > 1e-9, g * i[:, t] * y[:, t] * a[:, t] ** 2
                / s[:, t], 0.0)
            dza[:, t] = dla * neg_c * r[:, t] * (1 - r[:, t])
            dzi[:, t] = g * s[:, t] * y[:, t] * i[:, t] * (1 - i[:, t])
            dy[:, t] = g * s[:, t] * i[:, t]
            sums = [sums[0] + dza[:, t], sums[1] + dzi[:, t],
                    sums[2] + dla * r[:, t]]
            carry = a[:, t] * g
        parts.append(sums)
    # The slots in (row, chunk) order.
    total = [sum(parts[ci][k][row] for row in range(za.shape[0])
                 for ci in range(len(bounds))) for k in range(3)]
    return (dza, dzi, dy, total[0], total[1],
            total[2] * -8.0 * torch.sigmoid(lam))


def _hold_wkv6_chunked(s, chunk, logw_floor_at=None):
    """The chunked form against `wkv6_bwd_ref` (chunked at `chunk`) at 1e-5
    in float64; with `logw_floor_at`, logw at its floor (-4) over the whole
    chunk of BWD_CHUNK positions starting there (the overflow trap: e^(4 x
    16) outside the renormalisation), held in fp32 too, as the kernel
    computes, every factor finite."""
    arrays = _wkv6_inputs(2, s, 3, 16, seed=s)
    if logw_floor_at is not None:
        arrays[3][:, logw_floor_at:logw_floor_at + wk_ops.BWD_CHUNK] = -4.0
    r, k, v, logw, u, s0, dy = (_t(a) for a in arrays)
    want = wk_ops.wkv6_bwd_ref(dy, r, k, v, logw, u, s0, chunk)
    dtypes = (F64,) if logw_floor_at is None else (F64, torch.float32)
    for dtype in dtypes:
        got = wkv6_bwd_chunked(dy, r, k, v, logw, u, s0, dtype=dtype)
        tol = 1e-5 if dtype == F64 else 1e-4
        for name, g, w in zip(("dr", "dk", "dv", "dlogw", "dbonus"), got,
                              want):
            assert bool(torch.isfinite(g).all()), (name, dtype)
            np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                       err_msg=f"{name} {dtype}", rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 5), (7, 7)])
def test_wkv6_kernel_walks_match_the_plain_backward(s, chunk):
    """S not a multiple of the kernel's chunk (16), one whole chunk and a
    ragged one."""
    _hold_wkv6_chunked(s, chunk)


@pytest.mark.parametrize("s,chunk,floor_at", [
    (5, 5, None),           # S below a chunk
    (1, 1, None),           # one position
    (48, 16, 16),           # logw -4 over the second chunk
])
def test_wkv6_kernel_chunked_form_short_and_slow(s, chunk, floor_at):
    _hold_wkv6_chunked(s, chunk, floor_at)


def _hold_rglru_chunked(b, s, w, chunk):
    y, wa, wi, ba, bi, lam, h0, dh = (_t(a) for a in
                                      _rglru_inputs(b, s, w, seed=s))
    inputs = (y @ wa, y @ wi, y, ba, bi, lam)
    want = rg_ops.rglru_gated_bwd_ref(dh, *inputs, h0)
    got = rglru_bwd_chunked(dh, *inputs, h0, chunk)
    for name, g, w_ in zip(("dza", "dzi", "dy", "b_a", "b_i", "lambda"),
                           got, want):
        np.testing.assert_allclose(g.float().numpy(), w_.numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,w", [(2, 13, 10), (3, 1, 8), (1, 40, 7)])
def test_rglru_kernel_walk_matches_the_plain_backward(b, s, w):
    """In the chunks `bwd_plan` gives these shapes (8 steps: 2, 1 and 5
    chunks)."""
    _hold_rglru_chunked(b, s, w, rg_ops.bwd_plan(b, s, w).chunk)


@pytest.mark.parametrize("b,s,w,chunk", [
    (2, 21, 6, 8),          # S not a multiple of Lc
    (2, 5, 9, 8),           # S below Lc
    (1, 33, 5, 4),          # nine chunks, the last of one step
])
def test_rglru_kernel_chunked_walks_ragged(b, s, w, chunk):
    _hold_rglru_chunked(b, s, w, chunk)


def _tf32_parts(x, nearest):
    """fp32 x = big + small as the WKV6 backward kernel gives them to the
    tensor core, in float64: fp32 inputs' `split_rn` (nearest: both parts
    rounded to the nearest TF32 value, the magnitude's half up) or
    tf32.cuh's `split` (big truncated, small read with its low 13 bits
    dropped)."""
    add = 0x1000 if nearest else 0
    big = ((x.view(torch.int32) + add) & -0x2000).view(torch.float32)
    small = ((x - big).view(torch.int32) + add) & -0x2000
    return big.double(), small.view(torch.float32).double()


def test_wkv6_bwd_operand_split_rounds_to_nearest():
    """Why the WKV6 backward rounds fp32 inputs' operands to nearest: the
    four TF32 products big*big + big*small + small*big + small*small of
    fp32 a and b (exact on the tensor core, emulated in float64) err by at
    most 2^-22 of a b and lean neither way, where truncated parts err by
    up to ~2^-20 and lean toward zero by ~2.5 x 2^-24 on average, a bias
    dlogw's suffix sums over the sequence add up."""
    gen = torch.Generator().manual_seed(0)
    n = 1 << 18
    a = torch.randn(n, generator=gen) * torch.exp(
        2 * torch.randn(n, generator=gen))
    b = torch.randn(n, generator=gen)
    exact = a.double() * b.double()
    lean = {}
    for nearest in (True, False):
        (ba, sa), (bb, sb) = _tf32_parts(a, nearest), _tf32_parts(b, nearest)
        err = (ba * bb + ba * sb + sa * bb + sa * sb) - exact
        rel = err * exact.sign() / exact.abs()     # > 0: away from zero
        lean[nearest] = float(rel.mean()) * 2 ** 24
        if nearest:
            assert float(rel.abs().max()) <= 2.0 ** -22
    assert abs(lean[True]) < 0.05
    assert lean[False] < -1.0


def test_wkv6_function_keeps_the_initial_state(monkeypatch):
    """`_WKV6Fn` with its launch replaced by the plain forward (which
    overwrites the state, as the kernel does): the gradients are the plain
    backward's from the initial state, the state holds the final one and
    carries no gradient, and a state that requires grad is refused."""
    r, k, v, logw, u, s0, dy = (_t(a) for a in _wkv6_inputs(2, 16, 2, 16))

    def plain_forward(r_, k_, v_, logw_, u_, state, chunk):
        y, new = wk_ops.wkv6_chunked_ref(r_, k_, v_, logw_, u_, state, chunk)
        state.copy_(new)
        return y
    monkeypatch.setattr(wk_ops, "_forward", plain_forward)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    state = s0.clone()
    y, out = wk_ops._WKV6Fn.apply(*leaves, state, 8)
    assert out is state and not out.requires_grad
    torch.testing.assert_close(
        state, wk_ops.wkv6_chunked_ref(r, k, v, logw, u, s0, 8)[1])
    got = torch.autograd.grad(y, leaves, dy)
    want = wk_ops.wkv6_bwd_ref(dy, r, k, v, logw, u, s0, 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    with pytest.raises(ValueError, match="initial state"):
        wk_ops.wkv6(*leaves, s0.clone().requires_grad_(True), chunk=8)


def test_rglru_function_keeps_the_initial_state(monkeypatch):
    y, wa, wi, ba, bi, lam, h0, dh = (_t(a) for a in
                                      _rglru_inputs(2, 9, 12))

    def plain_forward(za, zi, y_, ba_, bi_, lam_, state, vec):
        h, last = rg_ops.rglru_assoc_ref(
            *rg_ops.rglru_gates_ref(za, zi, y_, ba_, bi_, lam_), state)
        state.copy_(last)
        return h
    monkeypatch.setattr(rg_ops, "_gated_forward", plain_forward)
    leaves = [t.clone().requires_grad_(True)
              for t in (y @ wa, y @ wi, y, ba, bi, lam)]
    state = h0.clone()
    h, out = rg_ops._RGLRUGatedFn.apply(*leaves, state, True)
    assert out is state and not out.requires_grad
    torch.testing.assert_close(state, h[:, -1].detach())
    got = torch.autograd.grad(h, leaves, dh)
    want = rg_ops.rglru_gated_bwd_ref(dh, *leaves, h0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    with pytest.raises(ValueError, match="initial state"):
        rg_ops.rglru_gated(*leaves, h0.clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# AdamW's decay set, the train step, run_training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_decays_the_reference_leaves(arch):
    """One AdamW step with zero gradients and nonzero params moves exactly
    the leaves the reference decays (its stacked per-layer and per-block
    1-D leaves included): the updated trees agree leaf for leaf."""
    jb = jax_bundle_for(dataclasses.replace(jax_configs.get_smoke(arch),
                                            dtype=jnp.float32))
    rng = np.random.default_rng(2)
    jparams = jax.tree.map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32),
        jb.init_params(jax.random.PRNGKey(0)))
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32)
    tparams = _port_tree(tcfg, jparams)
    cfg = opt_mod.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1,
                              total_steps=2)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    jnew, _, _ = jax_opt.apply(jcfg, jparams,
                               jax.tree.map(np.zeros_like, jparams),
                               jax_opt.init(jparams))
    before = tree.tree_map(torch.clone, tparams)
    tnew, _, _ = opt_mod.apply(cfg, tparams,
                               tree.tree_map(torch.zeros_like, tparams),
                               opt_mod.init(tparams))
    want = _port_tree(tcfg, jnew)
    moved = 0
    for (path, got), (_, ref), old in zip(tree.flatten_with_paths(tnew),
                                          tree.flatten_with_paths(want),
                                          tree.leaves(before)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=path,
                                   rtol=1e-6, atol=1e-6)
        moved += not torch.equal(got, old)
    assert 0 < moved < len(tree.leaves(tnew))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_train_step_matches_jax_over_five_steps(arch):
    """Five steps of `make_train_step` against JAX's on the reference's
    SyntheticLM batches: losses and params at 1e-4."""
    jb, jparams, tb, _ = _models(arch)
    tparams = _port_tree(tb.cfg, jparams)
    cfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    data = JaxSyntheticLM(JaxDataConfig(vocab_size=tb.cfg.vocab_size,
                                        seq_len=16, global_batch=2, seed=3))
    jstep = jax.jit(jax_steps.make_train_step(jb, jcfg))
    tstep = steps.make_train_step(tb, cfg)
    jp, jstate, tstate = jparams, jax_opt.init(jparams), opt_mod.init(tparams)
    for i in range(5):
        batch = jax.tree.map(np.asarray, data.batch(i))
        jp, jstate, jm = jstep(jp, jstate, batch)
        tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL)
    for (path, got), (_, ref) in zip(
            tree.flatten_with_paths(tparams),
            tree.flatten_with_paths(_port_tree(tb.cfg, jp))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_run_training_crash_and_resume(tmp_path, arch):
    """`run_training` on the CPU: the loss falls, a crash at step 5 with a
    checkpoint every 2 steps resumes from step 4, and the resumed losses
    follow the uninterrupted run's."""
    kw = dict(steps=8, global_batch=2, seq_len=16, device="cpu", lr=1e-2)
    base = train.run_training(arch, **kw)
    assert base["steps_run"] == 8 and base["final_loss"] < base["first_loss"]
    ck = dict(kw, ckpt_dir=str(tmp_path / arch), ckpt_every=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        train.run_training(arch, fail_at_step=5, **ck)
    out = train.run_training(arch, **ck)
    assert out["start_step"] == 4 and out["steps_run"] == 4
    np.testing.assert_allclose(out["losses"], base["losses"][4:], rtol=1e-5)


def test_run_training_refuses_the_encoder_decoder():
    with pytest.raises(NotImplementedError,
                       match="train.py drives LM-family archs"):
        train.run_training("seamless-m4t-large-v2", steps=1, device="cpu")


def test_encdec_train_step_lowers_the_loss():
    """The encoder-decoder trains through `make_train_step` (as the
    reference's does through its own): eight steps on a fixed batch lower
    the loss, and every leaf has a gradient."""
    _, _, tb, _ = _models("seamless-m4t-large-v2")
    params = tb.init_params(0, "cpu")
    step = steps.make_train_step(tb, opt_mod.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=10))
    batch = _torch_batch(_batch(tb.cfg, seed=4))
    state, losses = opt_mod.init(params), []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] - 0.05, losses
