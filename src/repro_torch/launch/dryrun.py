"""One-card dry run of the port, the counterpart of `repro.launch.dryrun`:
for every (arch x shape) cell, a record of what the step needs on one
H100 — parameter counts, model FLOPs, weights, optimizer state and cache
bytes, a roofline at the card's peaks, whether it fits the card's 80 GB —
and, for a training cell, a training-step memory estimate.  Nothing is
allocated on any device: inputs, parameters and caches are tensors on the
meta device.

The training-step memory estimate (`train_step_memory`) runs the port's
own train step (`launch/steps.py`: forward, backward, gradient clip,
AdamW) on the meta device and follows every tensor it makes: the kernels
take their card route there without launching (`kernels/_build.dry_run`),
so what the forward keeps for its backward is what the card keeps, under
each remat policy.  Its peak is the most bytes alive at once, each tensor
rounded up to the card allocator's 512-byte blocks; the run that measures
the card's own (`torch.cuda.max_memory_allocated`) is `chip_smoke.py`'s
training phase.

No counterpart: the reference lowers and compiles each cell for a TPU pod
mesh (`--mesh single|multi`), reads XLA's `memory_analysis` and
`cost_analysis` and parses the compiled HLO for collectives
(`distributed/hlo_analysis.py`).  The card is one device and PyTorch runs
eagerly, so no program is lowered: the FLOPs are the model's (6 N D to
train, 2 N a token otherwise, as the reference counts `useful`) and the
bytes are counted from the tensors.
The reference's `--moe-shard` has none either: the expert sharding mode
decides only how `distributed/sharding.py` places the expert leaves over a
mesh, and changes nothing on one card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --train-memory \\
        llama3.2-1b --batch 8 --seq-len 512 [--remat full]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

import repro_torch.configs as configs_mod
from repro_torch.configs.specs import SHAPES, DryRunSpec
from repro_torch.kernels import _build
from repro_torch.launch import steps as steps_mod
from repro_torch.models.registry import bundle_for
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree as tree_mod

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: H100 SXM roofline denominators: dense bf16 tensor-core FLOP/s and HBM3
#: bytes/s (data sheet), and the card's memory.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
#: The CUDA caching allocator's block: every allocation is rounded up to
#: a multiple of it.
ALLOC_BLOCK = 512
#: AdamW's state a parameter: m and v in fp32 (`training/optimizer.py`).
ADAMW_BYTES = 8
#: AdamW's element-wise traffic a parameter in a step (the reference's
#: figure): m, v fp32 read and written, the param read and written, the
#: gradient read.
ADAMW_TRAFFIC = 24.0

SKIP_REASON = "long_500k requires sub-quadratic attention"


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_mod.leaves(tree)
               if isinstance(t, torch.Tensor))


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of every tensor storage made under it while they
    live, and the most alive at once (`peak`): each storage once, however
    many views share it, rounded up to ALLOC_BLOCK, freed when its last
    tensor goes."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


class _LossProbe:
    """A model module whose `loss_fn` also notes the bytes alive once the
    loss is computed: what the forward keeps for its backward."""

    def __init__(self, module, meter: LiveBytes):
        self._module, self._meter = module, meter
        self.after_forward = 0

    def __getattr__(self, name):
        return getattr(self._module, name)

    def loss_fn(self, cfg, params, batch):
        loss = self._module.loss_fn(cfg, params, batch)
        self.after_forward = self._meter.live
        return loss


def _train_inputs(cfg, batch: int, seq_len: int, frames: int
                  ) -> Dict[str, torch.Tensor]:
    """A training batch on the meta device: tokens and labels [B, S]
    int32, as `SyntheticLM` gives them, and for the encoder-decoder
    `frames` speech frames [B, T, D] (default: min(S, max_source_len), as
    its input specs cap them)."""
    out = {"tokens": torch.empty((batch, seq_len), dtype=torch.int32,
                                 device="meta"),
           "labels": torch.empty((batch, seq_len), dtype=torch.int32,
                                 device="meta")}
    if hasattr(cfg, "max_source_len"):
        t = frames or min(seq_len, cfg.max_source_len)
        out["speech_embeddings"] = torch.empty((batch, t, cfg.d_model),
                                               dtype=cfg.dtype,
                                               device="meta")
    return out


def train_step_memory(cfg, batch: int, seq_len: int, *,
                      remat: Optional[str] = None, frames: int = 0,
                      inputs: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, Any]:
    """Bytes of one training step of `cfg` at B `batch` x S `seq_len` on
    the card, from the port's train step run on the meta device: weights,
    gradients (one a parameter, in its dtype), AdamW's m and v, the bytes
    the forward keeps for its backward (alive once the loss is computed,
    less weights, optimizer state and batch), and the step's peak — all
    of it at once, the parameters, optimizer state and batch included, as
    a training run holds them.  `remat` replaces the config's policy;
    `inputs` (meta tensors, a dry-run spec's) replaces the batch that
    `batch`, `seq_len` and `frames` describe."""
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    base = bundle_for(cfg)
    meter = LiveBytes()
    probe = _LossProbe(base.module, meter)
    bundle = dataclasses.replace(base, module=probe)
    step = steps_mod.make_train_step(bundle, opt_mod.AdamWConfig())
    data = inputs or _train_inputs(cfg, batch, seq_len, frames)
    with _build.dry_run(), meter:
        for t in data.values():
            meter.track(t)
        params = bundle.init_params(0, "meta")
        state = opt_mod.init(params)
        held = meter.live
        step(params, state, data)
    weights, adamw = _nbytes(params), _nbytes((state.m, state.v))
    return {"batch": batch, "seq_len": seq_len,
            "remat": getattr(cfg, "remat", "none"),
            "weights": weights, "grads": weights, "adamw": adamw,
            "activations": probe.after_forward - held,
            "peak": meter.peak}


def _cache_bytes(bundle, spec: DryRunSpec, cache_len: int) -> int:
    return _nbytes(bundle.init_cache(spec.batch, cache_len, "meta"))


def useful_flops(bundle, spec: DryRunSpec) -> float:
    """The model's FLOPs of the cell's step (the reference's `useful`): 6
    N_active tokens to train, 2 N_active a token otherwise; the
    encoder-decoder's prefill encodes its capped source and decodes one
    token."""
    n_active = bundle.n_active_params
    eff_seq = spec.seq_len
    if bundle.family == "encdec" and spec.kind == "prefill":
        eff_seq = min(spec.seq_len, bundle.cfg.max_source_len) + 1
    if spec.kind == "train":
        return 6.0 * n_active * spec.batch * eff_seq
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.batch * eff_seq
    return 2.0 * n_active * spec.batch


def cell(arch: str, shape: str, *, remat: str = "none",
         attn_impl: Optional[str] = None,
         kv_cache: Optional[str] = None, train_memory: bool = True,
         extra_tag: str = "") -> Dict[str, Any]:
    """One cell's record.  `train_memory` False leaves a training cell's
    step estimate out (the rest takes milliseconds; the estimate runs the
    step on the meta device)."""
    spec: Optional[DryRunSpec] = configs_mod.input_specs(arch, shape)
    if spec is None:
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": SKIP_REASON}

    cfg = configs_mod.get(arch)
    if remat != "none" and hasattr(cfg, "remat"):
        cfg = dataclasses.replace(cfg, remat=remat)
    if attn_impl and hasattr(cfg, "attn_impl"):
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if kv_cache and hasattr(cfg, "kv_cache_dtype"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache)
    bundle = bundle_for(cfg)
    n_params = bundle.n_params
    n_active = bundle.n_active_params
    abstract = bundle.abstract_params()
    param_bytes = _nbytes(abstract)

    useful = useful_flops(bundle, spec)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape, "kind": spec.kind, "status": "ok",
        "tag": extra_tag, "remat": remat, "attn_impl": attn_impl,
        "n_chips": 1, "batch": spec.batch, "seq_len": spec.seq_len,
        "note": spec.note, "n_params": n_params, "n_active_params": n_active,
    }
    t0 = time.monotonic()
    if spec.kind == "train":
        opt_bytes = ADAMW_BYTES * sum(t.numel()
                                      for t in tree_mod.leaves(abstract))
        cache_bytes = 0
        # Weights read forward and backward, AdamW's element-wise traffic.
        hbm_bytes = 2.0 * param_bytes + ADAMW_TRAFFIC * n_params
        need = 2 * param_bytes + opt_bytes
        if train_memory:
            record["train_memory"] = train_step_memory(
                cfg, spec.batch, spec.seq_len, inputs=spec.inputs)
            need = record["train_memory"]["peak"]
    else:
        opt_bytes = 0
        prefix = getattr(cfg, "num_prefix_embeddings", 0)
        clen = spec.seq_len + prefix if spec.kind == "prefill" \
            else spec.seq_len
        cache_bytes = _cache_bytes(bundle, spec, clen)
        # Active weights read once; the cache written (prefill) or read.
        hbm_bytes = 2.0 * n_active + cache_bytes
        need = param_bytes + cache_bytes
    record["estimate_s"] = round(time.monotonic() - t0, 3)

    compute_s = useful / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    record["cost"] = {"flops": useful, "hbm_bytes": hbm_bytes,
                      "wire_bytes": 0.0}
    record["roofline"] = {
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": 0.0,
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "model_flops_per_device": useful,
    }
    record["hbm_analytic"] = {
        "param_bytes_per_dev": param_bytes,
        "opt_bytes_per_dev": opt_bytes,
        "cache_bytes_per_dev": cache_bytes,
        "need_bytes": need,
        "fits_80g": bool(need < HBM_BYTES),
    }
    return record


def save(record: dict, out_dir: Path = RESULTS_DIR) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"_{record['tag']}" if record.get("tag") else ""
    name = f"{record['arch']}__{record['shape']}{tag}.json"
    path = out_dir / name.replace("/", "_")
    path.write_text(json.dumps(record, indent=2))
    return path


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f} GB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One-card dry run of the port: a record for each (arch "
        "x shape) cell on the meta device, nothing allocated.  The "
        "reference's --mesh, --moe-shard, XLA lowering, memory_analysis, "
        "cost_analysis and HLO collective parse have no counterpart: the "
        "card is one device and PyTorch lowers no program.")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch of ARCHS and EDGE_MODELS x SHAPES")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--kv-cache", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-train-memory", action="store_true",
                    help="leave training cells' step estimate out")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    ap.add_argument("--train-memory", metavar="ARCH", default=None,
                    help="print one training-step memory estimate of ARCH "
                    "at --batch x --seq-len (and --remat, --layers) alone")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--layers", type=int, default=0,
                    help="with --train-memory: cut the config to this depth")
    args = ap.parse_args(argv)

    if args.train_memory:
        cfg = configs_mod.get(args.train_memory)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        est = train_step_memory(cfg, args.batch, args.seq_len,
                                remat=args.remat)
        print(json.dumps({"arch": args.train_memory, "layers":
                          cfg.n_layers, **est}))
        return 0

    archs = args.arch or (configs_mod.ARCHS + configs_mod.EDGE_MODELS
                          if args.all else [])
    shapes = args.shape or (list(SHAPES) if args.all else [])
    if not archs or not shapes:
        ap.error("need --arch/--shape or --all")
    out_dir = Path(args.out_dir)

    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"_{args.tag}" if args.tag else ""
            out = out_dir / f"{arch}__{shape}{tag}.json"
            if args.skip_existing and out.exists():
                print(f"[skip] {out.name}")
                continue
            t0 = time.monotonic()
            try:
                rec = cell(arch, shape, remat=args.remat,
                           attn_impl=args.attn_impl, kv_cache=args.kv_cache,
                           train_memory=not args.no_train_memory,
                           extra_tag=args.tag)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "tag": args.tag,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            save(rec, out_dir)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r, h = rec["roofline"], rec["hbm_analytic"]
                extra = (f" dom={r['dominant']} comp={r['compute_s']:.3e}s"
                         f" mem={r['memory_s']:.3e}s need="
                         f"{_gb(h['need_bytes'])} fits_80g={h['fits_80g']}")
            elif status == "error":
                extra = " " + rec["error"][:160]
            print(f"[{status}] {arch} x {shape} "
                  f"({time.monotonic() - t0:.1f}s){extra}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
