"""The flash kernels' fp32-output builds (ring attention's block partials)
and the head dim 128 launch counter, on the CPU where they can be checked
without the card, plus their kernel-against-plain checks on the card
(``cuda``, skipped here).

- ``flash_fwd_cuda``, ``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda``
  take fp32 output tensors at ``F32_OUT_HEAD_DIMS`` without ALiBi; at
  another head dim, or with ALiBi, they raise a ValueError that names
  the head dim before any library call, and mixed bf16 / fp32 outputs
  raise a TypeError (never a bf16 launch in their place);
- the plain versions' ``out_dtype`` keeps P in the inputs' dtype before
  P V and leaves the sums unrounded;
- nvcc's report names the fp32 builds apart from the bf16 ones;
- the packed kernel's route at head dim 128 without ALiBi (the GPT-3
  13B decoder's 40 heads of 128) counts in ``d128_launches``.
"""

import numpy as np
import pytest
import torch

from youku_mplug_tpu_torch.ops import _native
from youku_mplug_tpu_torch.ops import flash_attention as fa


def _bf16(rng, *shape, device="cpu"):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)


def _operands(rng, d, device="cpu", s=70):
    q, k, v, do = (_bf16(rng, 2, 3, s, d, device=device) for _ in range(4))
    lse = torch.zeros(2, 3, s, device=device)
    return q, k, v, do, lse, torch.zeros_like(lse)


@pytest.mark.parametrize("d", [80, 96, 128])
def test_fp32_outputs_at_an_unbuilt_head_dim_raise_naming_it(d):
    rng = np.random.default_rng(0)
    q, k, v, do, lse, delta = _operands(rng, d)
    f32 = [torch.empty(q.shape, dtype=torch.float32) for _ in range(3)]
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa.flash_fwd_cuda(q, k, v, f32[0], scale=0.1)
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, f32[0], scale=0.1)
    with pytest.raises(ValueError, match=f"head dim {d}"):
        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, f32[1], f32[2],
                              scale=0.1)


def test_fp32_outputs_with_alibi_or_mixed_dtypes_raise():
    rng = np.random.default_rng(1)
    q, k, v, do, lse, delta = _operands(rng, 64)
    f32 = torch.empty(q.shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="head dim 64 with ALiBi"):
        fa.flash_fwd_cuda(q, k, v, f32, scale=0.1, causal=True,
                          alibi_slopes=torch.ones(3))
    with pytest.raises(TypeError, match="mix"):
        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, f32,
                              torch.empty_like(q), scale=0.1)
    with pytest.raises(TypeError, match="must be bf16"):
        fa.flash_fwd_cuda(q, k, v, f32.half(), scale=0.1)
    assert fa._f32_out((f32,), 64, None, "forward")
    assert not fa._f32_out((q,), 128, None, "forward")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_out_dtype_keeps_p_rounded_and_the_sum_unrounded(causal):
    rng = np.random.default_rng(2)
    q, k, v, do, _, _ = _operands(rng, 64)
    o32, lse = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=causal,
                                  out_dtype=torch.float32)
    o16, lse16 = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=causal)
    assert torch.equal(lse, lse16)
    # P V on P rounded to bf16, summed in fp32, not rounded after
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * 0.125
    allowed = fa._allowed(70, 70, causal=causal, period=0, kv_len=None,
                          device="cpu")
    p = torch.exp(s.masked_fill(~allowed, float("-inf")) - lse[..., None])
    want = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                        v.float())
    torch.testing.assert_close(o32, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o16.float(), o32, rtol=2.0 ** -8, atol=1e-6)
    grads32 = fa.flash_bwd_plain(q, k, v, o16, lse, do, scale=0.125,
                                 causal=causal, out_dtype=torch.float32)
    grads16 = fa.flash_bwd_plain(q, k, v, o16, lse, do, scale=0.125,
                                 causal=causal)
    for g32, g16 in zip(grads32, grads16):
        assert g32.dtype == torch.float32
        assert torch.equal(g32.to(torch.bfloat16), g16)


def test_ptxas_report_names_the_fp32_builds():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb0ELb1EEEvPK13__nv_bfloat16S3_S3_Pff' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb0ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_Pf' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128ELb1ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_merge_kernelILi64ELb1EEEvPKfS2_Pf' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114decode_attn_kernelILi128ELb0ELb1EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 512 bytes cmem[0]
"""
    got = _native.ptxas_report(log)
    assert set(got) == {"decode_attn<128,plain,int8>",
                        "flash_bwd_dq<128,alibi>", "flash_fwd<64,plain>",
                        "flash_fwd<64,plain,f32>", "flash_fwd_merge<64,f32>"}
    assert got["flash_fwd<64,plain,f32>"]["registers"] == 120
    assert got["flash_fwd<64,plain>"]["registers"] == 118


def test_d128_without_alibi_has_its_own_counter():
    """``_count`` puts a head dim 128 launch without ALiBi in
    ``d128_launches`` (the 13B decoder's), d 64 in ``launches`` and
    ALiBi anywhere in ``alibi_launches``."""

    def fn():
        pass

    for attr in ("launches", "d80_launches", "d88_launches", "d96_launches",
                 "d128_launches", "alibi_launches"):
        setattr(fn, attr, 0)
    fa._count(fn, None, 128)
    fa._count(fn, None, 64)
    fa._count(fn, torch.ones(2), 128)
    assert (fn.d128_launches, fn.launches, fn.alibi_launches) == (1, 1, 1)
    for wrapper in (fa.flash_attention_packed, fa.flash_attention,
                    fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        assert hasattr(wrapper, "d128_launches")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _unrounded_share(x32, x16):
    """(share of x32's elements that differ from their bf16 rounding,
    share whose bf16 rounding is the bf16 build's x16)."""
    r = x32.to(torch.bfloat16)
    return (float((r.float() != x32).float().mean()),
            float((r == x16).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_fp32_builds_match_plain(cuda_device, causal):
    """The fp32-output forward, dq and dk/dv kernels against the plain
    versions' fp32 outputs on the same inputs (forward elementwise 2^-6
    x (1 + |plain|), gradients 2^-12 relative L2: a bf16 rounding of
    them reads ~2^-9), and within a bf16 rounding of the bf16 builds';
    each output unrounded (at least 99% of its elements differ from
    their bf16 rounding) and rounding to the bf16 build's output on the
    same inputs in at least 99% of them."""
    rng = np.random.default_rng(3)
    q, k, v, do, _, _ = _operands(rng, 64, cuda_device, s=200)
    o = torch.empty(q.shape, dtype=torch.float32, device=cuda_device)
    lse = fa.flash_fwd_cuda(q, k, v, o, scale=0.125, causal=causal)
    want, want_lse = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=causal,
                                        out_dtype=torch.float32)
    assert ((o - want).abs() <= 2.0 ** -6 * (1 + want.abs())).all()
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    o16 = torch.empty_like(q)
    fa.flash_fwd_cuda(q, k, v, o16, scale=0.125, causal=causal)
    torch.testing.assert_close(o16.float(), o, atol=1e-6, rtol=2.0 ** -8)
    delta = fa.flash_bwd_delta_cuda(o16, do)
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32,
                              device=cuda_device) for _ in range(3))
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, scale=0.125,
                         causal=causal)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, scale=0.125,
                          causal=causal)
    dq16, dk16, dv16 = (torch.empty_like(q) for _ in range(3))
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq16, scale=0.125,
                         causal=causal)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk16, dv16, scale=0.125,
                          causal=causal)
    want = fa.flash_bwd_plain(q, k, v, o16, lse, do, scale=0.125,
                              causal=causal, out_dtype=torch.float32)
    for g, w in zip((dq, dk, dv), want):
        assert float((g - w).norm() / w.norm()) <= 2.0 ** -12
    for x32, x16 in ((o, o16), (dq, dq16), (dk, dk16), (dv, dv16)):
        unrounded, same = _unrounded_share(x32, x16)
        assert unrounded >= 0.99 and same >= 0.99, (unrounded, same)
