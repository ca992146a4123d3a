#!/usr/bin/env python3
"""A/B of the prefill-attention kernels (`flash_attention.cu`) of two
kernel source trees on one card, without a prefix.

    python3 scripts/ab_flash_attention.py OLD_CSRC [NEW_CSRC]

OLD_CSRC is a `csrc` directory of an earlier tree (unpack one with
`git archive <commit> src/repro_torch/csrc | tar -x -C <dir>`, in a
directory .gitignore lists); NEW_CSRC defaults to this tree's.  Both
libraries are built with the port's nvcc flags (the ptxas report of each
tensor-core instantiation is printed: registers and spills), then each
row of chip_smoke.py's phase 2 shapes is run through both: the outputs
must be equal bit for bit, and the device time of each (CUDA events,
chip_smoke.time_ms) is taken in turns old, new, new, old.  The new
library's entry points take `prefix_len` after `kv_start` and are called
with a null pointer, as `ops.flash_attention(prefix_len=None)` calls
them.  Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: (label, dtype, B, S, H, KVH, D, window, softcap, left pads)
ROWS = (
    ("llama 28x16", "bfloat16", 28, 16, 32, 8, 64, 0, 0.0, True),
    ("llama 28x16", "float32", 28, 16, 32, 8, 64, 0, 0.0, True),
    ("qwen2.5 28x16", "bfloat16", 28, 16, 16, 2, 128, 0, 0.0, True),
    ("phi3 28x16", "bfloat16", 28, 16, 32, 32, 96, 0, 0.0, True),
    ("rgemma 28x16 w2048", "bfloat16", 28, 16, 16, 1, 256, 2048, 0.0, True),
    ("llama 4x4000", "bfloat16", 4, 4000, 32, 8, 64, 0, 0.0, False),
    ("rgemma 4x4000 w2048", "bfloat16", 4, 4000, 16, 1, 256, 2048, 0.0,
     False),
    ("gemma2 4x4000 w4096 cap50", "bfloat16", 4, 4000, 32, 16, 128, 4096,
     50.0, False),
)


def build(csrc: Path, out: Path) -> subprocess.Popen:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
         str(csrc / "flash_attention.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def entry(lib, name: str, with_prefix: bool):
    from repro_torch.kernels import _build
    fn = getattr(lib, name)
    sig = list(_build.SIGNATURES[name])
    if not with_prefix:
        del sig[5]
    fn.argtypes, fn.restype = sig, ctypes.c_int
    return fn


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_flash_attention: needs a CUDA card")
    from chip_smoke import time_ms
    from repro_torch.kernels import _build
    old_csrc = Path(sys.argv[1]).resolve()
    new_csrc = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 \
        else _build.CSRC
    libs = {tag: ROOT / "build" / "ab" / tag / "flash_attention.so"
            for tag in ("old", "new")}
    procs = {tag: build(src, libs[tag])
             for tag, src in (("old", old_csrc), ("new", new_csrc))}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {tag}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "wgmma" in line:
                inst = line.split("flash_attention_wgmmaILi")[1].split("EE")[0]
                props = [x.strip() for x in lines[i + 2:i + 4]]
                print(f"ptxas {tag} wgmma<{inst.replace('ELi', ',')}>: "
                      + "; ".join(props))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    fns = {}
    for tag in ("old", "new"):
        lib = ctypes.CDLL(str(libs[tag]))
        fns[tag] = {dt: entry(lib, name, tag == "new") for dt, name in (
            (torch.bfloat16, "flash_attention_tc_launch"),
            (torch.float32, "flash_attention_launch"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, dtype, b, s, h, kvh, d, window, softcap, pads in ROWS:
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dt)
        starts = (torch.arange(b, device="cuda", dtype=torch.int32) % 8) \
            if pads else None
        outs = {tag: torch.empty_like(q) for tag in fns}

        def call(tag):
            args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    outs[tag].data_ptr(),
                    None if starts is None else starts.data_ptr()]
            if tag == "new":
                args.append(None)
            err = fns[tag][dt](
                *args, b, s, s, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1, window, softcap, 1.0 / math.sqrt(d),
                _build.stream())
            if err:
                raise RuntimeError(f"{tag} launch failed: cudaError {err}")
        call("old")
        call("new")
        torch.cuda.synchronize()
        same = torch.equal(outs["old"], outs["new"])
        times = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            times[tag].append(time_ms(lambda: call(tag))[0])
        old_ms, new_ms = (statistics.mean(times[t]) for t in ("old", "new"))
        print(f"ab flash_attention {label} {dtype}: old_ms={old_ms:.5f} "
              f"new_ms={new_ms:.5f} new/old={new_ms / old_ms:.4f} "
              f"turns={times} bitwise_equal={same}")
        if not same:
            sys.exit(f"{label} {dtype}: outputs differ")


if __name__ == "__main__":
    main()
