"""The flash forward profiler (youku_mplug_tpu_torch/cli/profile_flash.py)
on the CPU: it refuses to run without a card, and its shapes are the
paths' (the forward's head dims, the splits kv_splits gives them)."""

import pytest
import torch

from youku_mplug_tpu_torch.cli import profile_flash
from youku_mplug_tpu_torch.ops import flash_attention as fa


def test_profile_flash_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_flash.main([])


@pytest.mark.parametrize("shape", profile_flash.SHAPES,
                         ids=[s[0] for s in profile_flash.SHAPES])
def test_profile_flash_shapes_are_kernel_shapes(shape):
    name, b, h, sq, sk, d, causal, layout = shape
    assert d in fa.HEAD_DIMS and layout in ("qkv", "heads")
    assert not causal or sq == sk
    assert name.startswith(("K1-", "K4-")) and f"d{d}" in name
    splits = fa.kv_splits(b, h, sq, sk, head_dim=d, causal=causal)
    assert splits == 1 or not causal
