"""Modality frontend stubs of the port (`repro.models.frontends`).

The `[vlm]`/`[audio]` architectures specify the transformer backbone only;
the modality frontend is a stub whose outputs, patch or frame embeddings,
arrive as precomputed inputs (`prefix_embeddings` of the transformer's
`forward` and `prefill`).  These helpers give the stub shapes and draw
synthetic embeddings from an explicit torch generator.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def _synth(gen: torch.Generator, shape: Tuple[int, ...], dtype) -> torch.Tensor:
    """0.02 * N(0, 1) drawn in fp32 on the generator's device, cast to
    `dtype`."""
    return (0.02 * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)).to(dtype)


@dataclasses.dataclass(frozen=True)
class VisionStub:
    """CLIP-style patch embedding stub (phi-3-vision)."""

    num_patches: int = 576          # 336px / 14 -> 24x24 patches
    d_model: int = 3072

    def shape(self, batch: int) -> Tuple[int, int, int]:
        return (batch, self.num_patches, self.d_model)

    def synth(self, gen: torch.Generator, batch: int,
              dtype=torch.bfloat16) -> torch.Tensor:
        return _synth(gen, self.shape(batch), dtype)


@dataclasses.dataclass(frozen=True)
class AudioStub:
    """Speech frame-embedding stub (seamless conformer frontend output;
    ~1 frame / 40 ms after subsampling)."""

    num_frames: int = 512
    d_model: int = 1024

    def shape(self, batch: int) -> Tuple[int, int, int]:
        return (batch, self.num_frames, self.d_model)

    def synth(self, gen: torch.Generator, batch: int,
              dtype=torch.bfloat16) -> torch.Tensor:
        return _synth(gen, self.shape(batch), dtype)
