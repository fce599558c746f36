"""The port's ops (youku_mplug_tpu_torch.ops) against the JAX package.

The kernels' plain PyTorch versions are held against the Pallas kernels
run in interpret mode on the CPU (the JAX tests' own route), on the same
numpy inputs, at the Pallas tests' tolerance (2e-3).  Tests marked
``cuda`` run each hand-written kernel against its plain version on the
card and skip where there is none.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from youku_mplug_tpu.ops import decode_attention as jdec
from youku_mplug_tpu.ops import flash_attention as jfa
from youku_mplug_tpu.ops import kv_cache as jkv
from youku_mplug_tpu.ops.attention import mha_reference as jmha
from youku_mplug_tpu.ops.layernorm import layer_norm as jln
from youku_mplug_tpu.ops.preprocess import normalize_clip as jnorm
from youku_mplug_tpu_torch.ops import kv_cache as tkv
from youku_mplug_tpu_torch.ops.attention import mha_reference as tmha
from youku_mplug_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from youku_mplug_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_plain,
    flash_fwd_cuda,
    flash_fwd_plain,
)
from youku_mplug_tpu_torch.ops.layernorm import layer_norm as tln
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip as tnorm

torch.set_num_threads(1)
TOL = 2e-3  # the Pallas interpret-mode tolerance of tests/test_ops.py


def _interpret():
    return mock.patch.object(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("s,period", [(37, 0), (56, 8)])
def test_flash_packed_plain_matches_pallas_interpret(s, period):
    """K1 (_fwd_kernel_packed): mask modes none and period; n*d = 128 as
    packed_supported requires."""
    rng = np.random.default_rng(s)
    b, n, d = 2, 2, 64
    q, k, v = (rng.normal(size=(b, s, n * d)).astype(np.float32)
               for _ in range(3))
    with _interpret():
        want = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), n, period=period)
    got = flash_attention_packed(_t(q), _t(k), _t(v), n, period=period)
    _close(got, want)


@pytest.mark.parametrize("kv_len", [None, 131])
def test_flash_head_major_plain_matches_pallas_interpret(kv_len):
    """K4 (_fwd_kernel via flash_attention): AttentionPool's no-pad path
    and the padded static-kv_len path."""
    rng = np.random.default_rng(4)
    b, h, sq, sk, d = 2, 2, 128, 150, 64
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    with _interpret():
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=kv_len)
    got = flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    _close(got, want)


def test_flash_plain_lse_is_logsumexp():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 16, 8))
                                .astype(np.float32)) for _ in range(3))
    o, lse = flash_fwd_plain(q, k, v, scale=0.5, period=4)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.5
    g = torch.arange(16) // 4
    s = s.masked_fill(g[:, None] != g[None, :], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ v)


def test_decode_plain_matches_pallas_interpret():
    """K5 (decode_attention._kernel): per-sample cache_len/valid_from,
    inclusive bounds, a single live key, and a slot with none (zeros)."""
    rng = np.random.default_rng(6)
    L, B, n, M, d = 2, 5, 2, 128, 64
    q = rng.normal(size=(B, n * d)).astype(np.float32)
    ckv = rng.normal(size=(L, B, M, 2 * n * d)).astype(np.float32)
    clen = np.array([5, 100, 127, 40, 3], np.int32)
    vfrom = np.array([0, 7, 64, 40, 9], np.int32)  # slot 4: no live key
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(ckv), n,
                                 jnp.int32(1), jnp.asarray(clen),
                                 jnp.asarray(vfrom), interpret=True)
    got = decode_attention(_t(q), _t(ckv), n, 1, _t(clen), _t(vfrom))
    _close(got, want)
    assert not got[4].any()
    _close(got[3], ckv[1, 3, 40, n * d:], 1e-6)  # one live key: its V row


def test_layer_norm_and_normalize_clip_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 4 + 1
    sc, bi = (rng.normal(size=(32,)).astype(np.float32) for _ in range(2))
    _close(tln(_t(x), _t(sc), _t(bi), eps=1e-6),
           jln(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), eps=1e-6),
           1e-5)
    clips = rng.integers(0, 256, size=(2, 3, 8, 8, 3), dtype=np.uint8)
    got = tnorm(_t(clips), dtype=torch.float32)
    assert got.shape == (2, 3, 3, 8, 8)
    _close(got, jnorm(jnp.asarray(clips), dtype=jnp.float32), 1e-6)


def test_mha_reference_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
            for _ in range(2))
    bias = rng.normal(size=(2, 1, 5, 7)).astype(np.float32)
    kv_len = np.array([4, 7], np.int32)
    for kw in ({"causal": True}, {"bias": bias}, {"kv_len": kv_len}):
        want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    **{a: jnp.asarray(b) if isinstance(b, np.ndarray) else b
                       for a, b in kw.items()})
        got = tmha(_t(q), _t(k), _t(v),
                   **{a: _t(b) if isinstance(b, np.ndarray) else b
                      for a, b in kw.items()})
        _close(got, want, 1e-5)


@pytest.mark.parametrize("sq,bias,flash", [(128, False, True),
                                            (127, False, False),
                                            (128, True, False)])
def test_dot_product_attention_dispatch(sq, bias, flash):
    """Unbiased attention with >= 128 queries goes to the flash wrapper
    (AttentionPool: 128 queries), everything else to mha_reference; both
    equal the JAX reference."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(10)
    q = rng.normal(size=(1, 2, sq, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    b = rng.normal(size=(1, 1, sq, 40)).astype(np.float32) if bias else None
    with mock.patch.object(fa, "flash_attention",
                           wraps=fa.flash_attention) as spy:
        got = dot_product_attention(_t(q), _t(k), _t(v),
                                    bias=None if b is None else _t(b))
    assert spy.called == flash
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                bias=None if b is None else jnp.asarray(b))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("per_sample", [False, True])
def test_cache_write_in_place_matches_jax(per_sample):
    rng = np.random.default_rng(9)
    L, B, M, W, S = 2, 3, 16, 8, 1 if per_sample else 4
    cache = rng.normal(size=(L, B, M, W)).astype(np.float32)
    kvp = rng.normal(size=(B, S, W)).astype(np.float32)
    idx = np.array([0, 5, 15], np.int32) if per_sample else 3
    want = jkv.cache_write(jnp.asarray(cache),
                           jnp.asarray(kvp), 1,
                           jnp.asarray(idx) if per_sample else idx, lidx=1)
    tc = _t(cache.copy())
    out = tkv.cache_write(tc, _t(kvp), _t(idx) if per_sample else idx, 1)
    assert out.data_ptr() == tc.data_ptr()  # updated in place
    _close(tc, want, 0)
    assert tkv.layer_slice(tc, 1).data_ptr() == tc[1].data_ptr()  # a view


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, in bf16
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)


def _bf16_close(got, want):
    """Four bf16 ulps, elementwise: the kernel and its plain version round
    the output and the PV probabilities at different points."""
    torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -6,
                               rtol=2.0 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s,n,period", [
    (4, 197, 2, 0),    # vision spatial: ragged 197 = 3 x 64 + 5
    (4, 112, 2, 8),    # grouped temporal: 14 patches x 8 frames
    (3, 100, 1, 3),    # period that does not divide the 64-row tiles
    (2, 1, 2, 0),      # one token
])
def test_cuda_flash_packed_matches_plain(cuda_device, rows, s, n, period):
    rng = np.random.default_rng(s)
    nd = n * 64
    qkv = _bf16(rng, rows, s, 3 * nd, device=cuda_device)
    q, k, v = qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:]
    got = flash_attention_packed(q, k, v, n, period=period)
    want = flash_attention_packed_plain(q, k, v, n, period=period)
    _bf16_close(got, want)
    views = [t.unflatten(-1, (n, 64)).transpose(1, 2) for t in (q, k, v)]
    lse = flash_fwd_cuda(*views, torch.empty_like(views[0]), scale=0.125,
                         period=period)
    _, want_lse = flash_fwd_plain(*views, scale=0.125, period=period)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,kv_len", [(128, 1570, None), (128, 1570, 1500),
                                          (65, 130, 64), (7, 1, None)])
def test_cuda_flash_head_major_matches_plain(cuda_device, sq, sk, kv_len):
    rng = np.random.default_rng(sk)
    # head views of [B, S, H*D] projections, as AttentionPool makes them
    q = _bf16(rng, 2, sq, 3 * 64, device=cuda_device).unflatten(
        -1, (3, 64)).transpose(1, 2)
    k, v = (_bf16(rng, 2, sk, 3 * 64, device=cuda_device).unflatten(
        -1, (3, 64)).transpose(1, 2) for _ in range(2))
    got = flash_attention(q, k, v, kv_len=kv_len)
    _bf16_close(got, flash_attention_plain(q, k, v, kv_len=kv_len))


@pytest.mark.cuda
def test_cuda_decode_matches_plain(cuda_device):
    rng = np.random.default_rng(12)
    qkv = _bf16(rng, 5, 3 * 4 * 64, device=cuda_device)
    q = qkv[:, :4 * 64]  # a row-strided view, as the decoder passes it
    ckv = _bf16(rng, 3, 5, 256, 2 * 4 * 64, device=cuda_device)
    clen = torch.tensor([0, 100, 255, 3, 40], dtype=torch.int32,
                        device=cuda_device)
    vfrom = torch.tensor([0, 7, 130, 9, 40], dtype=torch.int32,
                         device=cuda_device)  # slot 3: no live key
    got = decode_attention(q, ckv, 4, 2, clen, vfrom)
    _bf16_close(got, decode_attention_plain(q, ckv, 4, 2, clen, vfrom))
    assert not got[3].any()
    torch.testing.assert_close(got[4], ckv[2, 4, 40, 4 * 64:])


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 16, 2 * 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_packed(x, x, x, 2)  # d = 32
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_packed(x.float(), x.float(), x.float(), 1)
