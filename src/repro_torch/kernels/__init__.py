"""Hand-written Hopper kernels of the port, one package per TPU kernel of
`repro.kernels` on the engine path.  Each package holds the plain PyTorch
version (`ref.py`, the CPU path and the on-card oracle) and `ops.py`, the
entry point: a CPU tensor goes to the plain version, a CUDA tensor to the
CUDA kernel under `repro_torch/csrc/` (built by `_build`), never the other
way round.  Each `ops` module counts its kernel launches in `launches`."""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.flash_attention import ops as fl
from repro_torch.kernels.moe_gemm import ops as mg
from repro_torch.kernels.rglru import ops as rg
from repro_torch.kernels.rmsnorm import ops as rms
from repro_torch.kernels.rwkv6 import ops as wk


def launch_counts() -> Dict[str, int]:
    """Every launch counter of the port's kernels at this moment: each
    kernel's `launches` by library name, decode attention's
    `combine_launches` as "decode_attention_combine" and prefill
    attention's `tc_launches` as "flash_attention_tc".  A counter counts
    host calls that launched its kernel, so a CUDA graph's capture counts
    once and its replays never (the engine keeps each graph's tally)."""
    return {"rmsnorm": rms.launches, "decode_attention": dec.launches,
            "flash_attention": fl.launches, "moe_gemm": mg.launches,
            "wkv6": wk.launches, "rglru": rg.launches,
            "decode_attention_combine": dec.combine_launches,
            "flash_attention_tc": fl.tc_launches}


def backward_launch_counts() -> Dict[str, int]:
    """The training backward's launch counters: RMSNorm's backward, WKV6's
    and the gated RG-LRU's (one launch a call each), the grouped GEMM's dx
    and dw products and the transposed copies the fp32 ones run on."""
    return {"rmsnorm_bwd": rms.bwd_launches,
            "moe_gemm_dx": mg.dx_launches,
            "moe_gemm_dw": mg.dw_launches,
            "moe_gemm_transpose": mg.transpose_launches,
            "wkv6_bwd": wk.bwd_launches,
            "rglru_bwd": rg.bwd_launches}
