"""The flash profiler (youku_mplug_tpu_torch/cli/profile_flash.py) on the
CPU: it refuses to run without a card, forward or backward, and its
shapes are the paths' (the kernels' head dims, the splits kv_splits gives
them, square causal calls); nvcc's resource report parses into each
build's registers and spills."""

import pytest
import torch

from youku_mplug_tpu_torch.cli import profile_flash
from youku_mplug_tpu_torch.ops import _native
from youku_mplug_tpu_torch.ops import flash_attention as fa


def test_profile_flash_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_flash.main([])


def test_profile_flash_backward_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_flash.main(["--backward"])


@pytest.mark.parametrize("shape", profile_flash.SHAPES,
                         ids=[s[0] for s in profile_flash.SHAPES])
def test_profile_flash_shapes_are_kernel_shapes(shape):
    name, b, h, sq, sk, d, causal, layout = shape
    assert d in fa.HEAD_DIMS and layout in ("qkv", "heads")
    assert not causal or sq == sk
    assert name.startswith(("K1-", "K4-")) and f"d{d}" in name
    splits = fa.kv_splits(b, h, sq, sk, head_dim=d, causal=causal)
    assert splits == 1 or not causal


@pytest.mark.parametrize("shape", profile_flash.BWD_SHAPES,
                         ids=[s[0] for s in profile_flash.BWD_SHAPES])
def test_profile_flash_backward_shapes_are_kernel_shapes(shape):
    name, b, h, sq, sk, d, causal, layout, alibi = shape
    assert d in fa.HEAD_DIMS and layout in ("qkv", "heads")
    assert not causal or sq == sk
    assert not alibi or (causal and d in fa.ALIBI_HEAD_DIMS
                         and "ALiBi" in name)
    assert name.startswith(("K4b-", "K2/K3-")) and f"d{d}" in name
    assert d in fa.BWD_BLOCKS_PER_SM


def test_profile_flash_backward_covers_the_redesigned_widths():
    """Every K4b row of the 80/96 redesign is timed: the three clip-b16
    train steps at d 96 and the 2.7B decoder's causal pass at d 80."""
    rows = {(s[5], s[3], s[4], s[6]) for s in profile_flash.BWD_SHAPES
            if not s[8]}
    assert {(96, 128, 1570, False), (96, 128, 786, False),
            (96, 128, 3138, False), (80, 208, 208, True)} <= rows


def test_ptxas_report_parses_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi96ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi96ELb0EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 0 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114decode_attn_kernelILi64ELb1ELb1EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114decode_attn_kernelILi64ELb1ELb1EEEvPK13__nv_bfloat16
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_merge_kernelILi80EEEvPKfS2_P13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_merge_kernelILi80EEEvPKfS2_P13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_bwd_delta_kernelILi96EEEvPK13__nv_bfloat16S3_Pfiixxxxxx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_bwd_delta_kernelILi96EEEvPK13__nv_bfloat16S3_Pfiixxxxxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126flash_bwd_dkv_short_kernelILi96ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126flash_bwd_dkv_short_kernelILi96ELb0EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 203 registers, used 1 barriers, 600 bytes cmem[0]
"""
    assert _native.ptxas_report(log) == {
        "flash_bwd_dq<96,plain>": {"registers": 166, "spill_stores": 0,
                                   "spill_loads": 0},
        "decode_attn<64,alibi,int8>": {"registers": 64, "spill_stores": 4,
                                       "spill_loads": 8},
        "flash_fwd_merge<80>": {"registers": 30, "spill_stores": 0,
                                "spill_loads": 0},
        "flash_bwd_delta<96>": {"registers": 40, "spill_stores": 0,
                                "spill_loads": 0},
        "flash_bwd_dkv_short<96,plain>": {"registers": 203,
                                          "spill_stores": 0,
                                          "spill_loads": 0}}
