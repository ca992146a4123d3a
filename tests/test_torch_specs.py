"""The port's dry-run input specs (`repro_torch.configs.specs`,
`configs.input_specs`) against the reference's, for every arch x shape."""

from __future__ import annotations

import pytest
import torch

import repro.configs as jax_configs
from repro.configs import specs as jax_specs
import repro_torch.configs as torch_configs
from repro_torch.configs import specs as torch_specs

ALL_ARCHS = jax_configs.ARCHS + jax_configs.EDGE_MODELS


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _same_spec(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.kind, got.batch, got.seq_len, got.note) == \
        (want.kind, want.batch, want.seq_len, want.note)
    assert list(got.inputs) == list(want.inputs)
    for name, t in got.inputs.items():
        w = want.inputs[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(w.shape), name
        assert _dtype_name(t.dtype) == _dtype_name(w.dtype), name


def test_archs_shapes_and_long_cells_follow_the_reference():
    assert torch_configs.ARCHS == jax_configs.ARCHS
    assert torch_configs.EDGE_MODELS == jax_configs.EDGE_MODELS
    assert torch_specs.SHAPES == jax_specs.SHAPES
    assert torch_specs.LONG_OK == jax_specs.LONG_OK


@pytest.mark.parametrize("shape", list(jax_specs.SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    _same_spec(torch_configs.input_specs(arch, shape),
               jax_configs.input_specs(arch, shape))


@pytest.mark.parametrize("shape", list(jax_specs.SHAPES))
def test_prefix_embeddings_ride_along(shape):
    """`prefix_len` adds prefix_embeddings [B, P, D] to the train and
    prefill shapes, in the dtype asked for, and not to decode's."""
    import jax.numpy as jnp
    tcfg = torch_configs.get("qwen2-1.5b")
    jcfg = jax_configs.get("qwen2-1.5b")
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = torch_specs.lm_input_specs(tcfg, shape, prefix_len=7,
                                         dtype=tdt)
        want = jax_specs.lm_input_specs(jcfg, shape, prefix_len=7, dtype=jdt)
        _same_spec(got, want)
        assert ("prefix_embeddings" in (got.inputs if got else {})) == \
            (shape in ("train_4k", "prefill_32k"))


def test_unknown_shape_raises_and_seamless_caps_its_source():
    with pytest.raises(KeyError):
        torch_specs.lm_input_specs(torch_configs.get("llama3.2-1b"), "x")
    spec = torch_configs.input_specs("seamless-m4t-large-v2", "prefill_32k")
    cap = torch_configs.get("seamless-m4t-large-v2").max_source_len
    assert spec.inputs["speech_embeddings"].shape[1] == cap
    assert spec.note == f"encoder memory capped at {cap} frames"
