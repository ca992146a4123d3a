#!/usr/bin/env python3
"""A/B of the two recurrent families' training kernels of several source
trees on one card: WKV6's backward and forward at rwkv6-3b's training
shape (B 8 x S 512, 40 x 64 heads, the forward's chunk 32) and the gated
RG-LRU's at recurrentgemma-9b's (B 8 x S 512 x W 4096), bf16 and fp32;
then WKV6's backward in bf16 at B 1, 2, 3, 4, 6 and 8 (40 to 320 CTAs);
then, with --seeds K, WKV6's backward at the card test's longest case (B
1, S 2048, 4 x 64 heads) on seeds 0 .. K-1, each output's error.

    python3 scripts/ab_recurrent_bwd.py [--seeds K] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (unpack an earlier
commit with `git archive <commit> | tar -x -C <dir>`, in a directory
.gitignore lists).  The trees run in the order given, each in a process
of its own that imports that tree's `repro_torch` (its kernels built from
its own `csrc` into its own `build/`), so give them in turns (old new new
old) to compare them on one card.  Each row's device time is
chip_smoke.time_ms's (CUDA events over a primed stream, median of 15
windows of 10 calls), on the same seeded inputs in every tree, with the
kernels' launch counts a call, a checksum of the outputs (equal
across trees only where the arithmetic is) and, for the backward rows,
the error against the plain version as chip_smoke holds it: max |err| /
(1 + |ref|).  The inputs are chip_smoke's (`wkv6_inputs`,
`rglru_gated_inputs`).  The card's name and power
limit come first.  Needs one CUDA card and nvcc; exits non-zero
without them.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (kernel, dtype) rows timed in each tree.
ROWS = tuple((kernel, dtype) for kernel in ("wkv6_bwd", "wkv6", "rglru_bwd",
                                            "rglru_gated")
             for dtype in ("bfloat16", "float32"))
B, S, H, N, W = 8, 512, 40, 64, 4096


def err_over_1_plus_ref(torch, got, want):
    """max |got - want| / (1 + |want|) over every output (chip_smoke's
    SUM_TOLERANCE measure)."""
    return max(float(((g.float() - w.float()).abs()
                      / (1 + w.float().abs())).max())
               for g, w in zip(got, want))


def rows(seeds: int) -> None:
    """Time every row with the `repro_torch` on sys.path (one tree), then
    the WKV6 backward's error at the card test's S 2048 case over `seeds`
    seeds."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (draw, rglru_gated_inputs, time_ms,
                            wkv6_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.rwkv6 import ops as wk
    if not torch.cuda.is_available():
        sys.exit("ab_recurrent_bwd: no CUDA device")
    _build.build_all(["wkv6", "rglru"])
    dev = torch.device("cuda")
    f32 = torch.float32
    for kernel, dtype_name in ROWS:
        gen = torch.Generator(device=dev).manual_seed(0)
        dt = getattr(torch, dtype_name)
        plain = None
        if kernel.startswith("wkv6"):
            shape = (B, S, H, N)
            r, k, v, logw, u, st0 = wkv6_inputs(torch, gen, shape, dt)
            dy = draw(torch, gen, shape, f32)
            if kernel == "wkv6_bwd":
                def fn():
                    return wk.wkv6_backward(dy, r, k, v, logw, u, st0)

                def plain():
                    return wk.wkv6_bwd_ref(dy, r, k, v, logw, u, st0, 32)
                counter = "bwd_launches"
            else:
                states = [st0.clone() for _ in range(4)]

                def fn(states=states):
                    states.append(states.pop(0))
                    return wk.wkv6(r, k, v, logw, u, states[0], chunk=32)[0]
                counter = "launches"
            mod = wk
        else:
            shape = (B, S, W)
            za, zi, y, vectors, h0 = rglru_gated_inputs(torch, gen, shape,
                                                        dt)
            h, _ = rg.rglru_gated(za, zi, y, *vectors, h0.clone())
            dh = draw(torch, gen, shape, f32)
            if kernel == "rglru_bwd":
                def fn():
                    return rg.rglru_gated_backward(dh, za, zi, y, *vectors,
                                                   h0, h)

                def plain():
                    return rg.rglru_gated_bwd_ref(dh, za, zi, y, *vectors,
                                                  h0)
                counter = "bwd_launches"
            else:
                state = h0.clone()

                def fn():
                    return rg.rglru_gated(za, zi, y, *vectors, state)[0]
                counter = "launches"
            mod = rg
        before = getattr(mod, counter)
        out = fn()
        torch.cuda.synchronize()
        per_call = getattr(mod, counter) - before
        outs = out if isinstance(out, tuple) else (out,)
        checksum = sum(float(t.double().abs().sum()) for t in outs)
        err = "" if plain is None else (
            " err_over_1_plus_ref="
            f"{err_over_1_plus_ref(torch, outs, plain()):.4e}")
        ms = time_ms(fn)[0]
        print(f"row {kernel} dtype={dtype_name} kernel_ms={ms:.5f} "
              f"launches_a_call={per_call} checksum={checksum:.9e}{err}",
              flush=True)
        del out, outs
        torch.cuda.empty_cache()
    # WKV6's backward at rwkv6-3b's heads and S 512 over B 1 .. 8 (40 to
    # 320 CTAs, one a (b, h), on the card's SMs): where one CTA alone
    # takes nearly as long as a full card, the serial chain of chunks, not
    # the card's throughput, sets the time.
    for b in (1, 2, 3, 4, 6, 8):
        gen = torch.Generator(device=dev).manual_seed(0)
        shape = (b, S, H, N)
        r, k, v, logw, u, st0 = wkv6_inputs(torch, gen, shape,
                                            torch.bfloat16)
        dy = draw(torch, gen, shape, f32)
        ms = time_ms(lambda: wk.wkv6_backward(dy, r, k, v, logw, u, st0))[0]
        print(f"row wkv6_bwd_batch B={b} ctas={b * H} dtype=bfloat16 "
              f"kernel_ms={ms:.5f}", flush=True)
        del r, k, v, logw, u, st0, dy
        torch.cuda.empty_cache()
    # The card test's longest case (B 1, S 2048, 4 x 64 heads: dlogw's
    # suffix sums over 2048 steps) on `seeds` seeds: each output's error,
    # dlogw's apart.
    for dtype_name in ("float32", "bfloat16"):
        for seed in range(seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            shape = (1, 2048, 4, 64)
            inputs = wkv6_inputs(torch, gen, shape, getattr(torch,
                                                            dtype_name))
            dy = draw(torch, gen, shape, f32)
            got = wk.wkv6_backward(dy, *inputs)
            want = wk.wkv6_bwd_ref(dy, *inputs, 32)
            errs = [err_over_1_plus_ref(torch, (g,), (w,))
                    for g, w in zip(got, want)]
            print(f"row wkv6_bwd_s2048 dtype={dtype_name} seed={seed} "
                  + " ".join(f"{name}={e:.4e}" for name, e in zip(
                      ("dr", "dk", "dv", "dlogw", "dbonus"), errs)),
                  flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--rows"]:
        rows(int(sys.argv[2]))
        return
    args = sys.argv[1:]
    seeds = 0
    if args[:1] == ["--seeds"]:
        seeds, args = int(args[1]), args[2:]
    if not args:
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        sys.exit("ab_recurrent_bwd: nvidia-smi failed")
    print(f"card {smi.stdout.strip()}", flush=True)
    for tree in args:
        src = Path(tree).resolve() / "src"
        env = dict(os.environ, PYTHONPATH=str(src))
        print(f"tree {tree}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--rows",
                               str(seeds)], env=env)
        if proc.returncode != 0:
            sys.exit(f"ab_recurrent_bwd: tree {tree} failed")


if __name__ == "__main__":
    main()
