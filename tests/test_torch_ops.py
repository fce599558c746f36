"""The port's ops (youku_mplug_tpu_torch.ops) against the JAX package.

The kernels' plain PyTorch versions are held against the Pallas kernels
run in interpret mode on the CPU (the JAX tests' own route), on the same
numpy inputs, at the Pallas tests' tolerance (2e-3).  Tests marked
``cuda`` run each hand-written kernel against its plain version on the
card and skip where there is none.
"""

import functools
import unittest.mock as mock

import jax
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
    alibi_slopes,
    decode_attention_plain,
    write_decode_attention,
    write_decode_attention_plain,
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
    got = decode_attention_plain(_t(q), _t(ckv), n, 1, _t(clen), _t(vfrom))
    _close(got, want)
    assert not got[4].any()
    _close(got[3], ckv[1, 3, 40, n * d:], 1e-6)  # one live key: its V row


@pytest.mark.parametrize("d,n", [(64, 4), (128, 4), (128, 6)])
def test_decode_alibi_plain_matches_pallas_interpret(d, n):
    """K5 with the ALiBi ladder (the Bloom decoder): head dim 64 and 128,
    a power-of-two head count and one past it (the half-step ladder);
    the bias slope_h * j at absolute key positions over a cache long
    enough (M 128) that it reaches tens; per-sample bounds and a slot
    with no live key."""
    rng = np.random.default_rng(d + n)
    L, B, M = 2, 4, 128
    q = rng.normal(size=(B, n * d)).astype(np.float32)
    ckv = rng.normal(size=(L, B, M, 2 * n * d)).astype(np.float32)
    clen = np.array([5, 100, 127, 3], np.int32)
    vfrom = np.array([0, 7, 64, 9], np.int32)  # slot 3: no live key
    slopes = alibi_slopes(n)
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(ckv), n,
                                 jnp.int32(1), jnp.asarray(clen),
                                 jnp.asarray(vfrom), alibi_slopes=slopes,
                                 interpret=True)
    got = decode_attention_plain(_t(q), _t(ckv), n, 1, _t(clen), _t(vfrom),
                                 alibi_slopes=slopes)
    _close(got, want)
    assert not got[3].any()
    # the bias moves the answer: without it the same call differs
    unbiased = decode_attention_plain(_t(q), _t(ckv), n, 1, _t(clen),
                                      _t(vfrom))
    assert (unbiased - got).abs().max() > 10 * TOL
    # a head-strided q (the head-major fused row [B, n, 3, d]) reads the
    # same as its contiguous copy
    fused = np.stack([q.reshape(B, n, d)] * 3, axis=2)
    view = _t(fused)[:, :, 0, :]
    torch.testing.assert_close(
        decode_attention_plain(view, _t(ckv), n, 1, _t(clen), _t(vfrom),
                               alibi_slopes=slopes), got)


@pytest.mark.parametrize("n", [2, 3])
def test_decode_d80_plain_matches_pallas_interpret(n):
    """K5 at head dim 80 (the GPT-3 2.7B decoder): per-sample cache_len /
    valid_from, a single live key and a slot with none (zeros)."""
    rng = np.random.default_rng(80 + n)
    L, B, M, d = 2, 5, 128, 80
    q = rng.normal(size=(B, n * d)).astype(np.float32)
    ckv = rng.normal(size=(L, B, M, 2 * n * d)).astype(np.float32)
    clen = np.array([5, 100, 127, 40, 3], np.int32)
    vfrom = np.array([0, 7, 64, 40, 9], np.int32)  # slot 4: no live key
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(ckv), n,
                                 jnp.int32(1), jnp.asarray(clen),
                                 jnp.asarray(vfrom), interpret=True)
    got = decode_attention_plain(_t(q), _t(ckv), n, 1, _t(clen), _t(vfrom))
    _close(got, want)
    assert not got[4].any()
    _close(got[3], ckv[1, 3, 40, n * d:], 1e-6)  # one live key: its V row


def test_decode_rejects_slopes_off_the_ladder():
    """The kernel generates the slopes from the head index, so the wrapper
    takes the standard ladder only (the JAX wrapper's check), on every
    device."""
    q = torch.zeros(1, 4 * 64)
    ckv = torch.zeros(1, 1, 64, 2 * 4 * 64)
    with pytest.raises(ValueError, match="ladder"):
        write_decode_attention(q, q, q, ckv, 4, 0, 3,
                               alibi_slopes=alibi_slopes(4) * 2)
    with pytest.raises(ValueError, match="ladder"):
        write_decode_attention(q, q, q, ckv, 4, 0, 3,
                               alibi_slopes=alibi_slopes(8))
    assert not ckv.any()  # nothing written


def _step_views(qkv, n, d, layout):
    """q, k, v of one decode step as the decoders hand them over: slices
    of GPT-3's packed row [B, 3*n*d], or head views of Bloom's head-major
    row [B, n, 3, d]."""
    if layout == "packed":
        nd = n * d
        return qkv[:, :nd], qkv[:, nd:2 * nd], qkv[:, 2 * nd:]
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# write rows: 0 (the sample's only live key), 100 past a valid_from > 0,
# M-1, >= M (the port writes nothing there and reads rows up to M-1), and
# one whose valid_from lies past it (no live key: zeros, the row still
# written)
STEP_CLEN = np.array([0, 100, 127, 130, 40], np.int32)
STEP_VFROM = np.array([0, 7, 64, 9, 60], np.int32)


@pytest.mark.parametrize("d,n,alibi,layout", [
    (64, 2, False, "packed"), (64, 4, True, "head-major"),
    (128, 4, True, "head-major"), (128, 3, False, "packed"),
    (128, 6, True, "packed"), (80, 4, False, "packed")])
def test_write_decode_plain_matches_jax_write_then_pallas(d, n, alibi,
                                                           layout):
    """K5 with K6 folded in, plain (CPU): the cache equals JAX's
    ``cache_write`` of the step's [K | V] rows exactly, but for the row
    past the cache (below), and the output equals the Pallas
    decode_attention (interpret mode) on that cache."""
    rng = np.random.default_rng(d + n + alibi)
    L, B, M = 2, 5, 128
    base = rng.normal(size=(L, B, M, 2 * n * d)).astype(np.float32)
    shape = (B, 3 * n * d) if layout == "packed" else (B, n, 3, d)
    qkv = rng.normal(size=shape).astype(np.float32)
    q, k, v = (np.ascontiguousarray(x).reshape(B, n * d)
               for x in _step_views(qkv, n, d, layout))
    want_cache = jkv.cache_write(
        jnp.asarray(base), jnp.asarray(np.concatenate([k, v], -1))[:, None],
        n, jnp.asarray(STEP_CLEN), lidx=1)
    # Sample 3 writes row 130 >= M.  The port writes nothing there; JAX
    # does not define this write: XLA's dynamic_update_slice clamps it to
    # row M-1 and the Pallas scatter kernel (interpret mode) lands it in
    # the last aligned window.  The engine never sends it (a request stops
    # at max_len - 1), so the reference keeps sample 3's rows as they were.
    want_cache = want_cache.at[1, 3].set(base[1, 3])
    slopes = alibi_slopes(n) if alibi else None
    want = jdec.decode_attention(jnp.asarray(q), want_cache, n, jnp.int32(1),
                                 jnp.asarray(STEP_CLEN),
                                 jnp.asarray(STEP_VFROM),
                                 alibi_slopes=slopes, interpret=True)
    cache = _t(base.copy())
    got = write_decode_attention(*_step_views(_t(qkv), n, d, layout), cache,
                                 n, 1, _t(STEP_CLEN), _t(STEP_VFROM),
                                 alibi_slopes=slopes)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want_cache))
    _close(got, want)
    assert not got[4].any()
    _close(got[0], v[0], 1e-6)  # one live key: the row it just wrote


@pytest.mark.parametrize("int8", [False, True])
def test_write_decode_plain_writes_nothing_outside_the_cache(int8):
    """A write row outside [0, M) (negative, M, past M) touches neither
    cache leaf, and the step attends over the unchanged cache: rows up to
    M-1 past the end, no live key (zeros) below 0.  The kernel does the
    same (``write = 0 <= idx < M``)."""
    rng = np.random.default_rng(21 + int8)
    L, B, M, n, d = 2, 3, 64, 2, 64
    rows = _t(rng.normal(size=(L, B, M, 2 * n * d)).astype(np.float32))
    if int8:
        kv8, scales = tkv.quantize_rows(rows, n)
        base = {"kv": kv8, "scale": scales}
        cache = {"kv": kv8.clone(), "scale": scales.clone()}
    else:
        base, cache = rows, rows.clone()
    q, k, v = _t(rng.normal(size=(3, B, n * d)).astype(np.float32))
    clen = _t(np.array([-1, M, M + 6], np.int32))
    got = write_decode_attention(q, k, v, cache, n, 1, clen, 0)
    for g, b0 in zip(tkv.leaves(cache), tkv.leaves(base)):
        if b0 is not None:
            assert torch.equal(g, b0)
    ckv, scales = tkv.leaves(base)
    torch.testing.assert_close(
        got, decode_attention_plain(q, ckv, n, 1, M - 1, 0, kv_scales=scales)
        * torch.tensor([0.0, 1.0, 1.0])[:, None])


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


@pytest.mark.parametrize("causal,sq", [(True, 128), (True, 64)])
def test_dot_product_attention_sends_causal_to_flash(causal, sq):
    """Causal attention follows JAX's dispatch rule: the flash kernel from
    one 128-row query block on (it used to stay on mha_reference)."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(19)
    q, k, v = (rng.normal(size=(1, 2, sq, 16)).astype(np.float32)
               for _ in range(3))
    with mock.patch.object(fa, "flash_attention",
                           wraps=fa.flash_attention) as spy:
        got = dot_product_attention(_t(q), _t(k), _t(v), causal=causal)
    assert spy.called == (sq >= 128)
    if spy.called:
        assert spy.call_args.kwargs["causal"] is True
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal)
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


def _packed_to_heads(a, n):
    b, s, nd = a.shape
    return _t(a).unflatten(-1, (n, nd // n)).transpose(1, 2)


def _heads_to_packed(t):
    b, n, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, n * d)


def test_flash_causal_plain_matches_pallas_interpret():
    """K1 (_fwd_kernel_packed), causal mode at the decoder's ragged
    length (no-pad whole-sequence block)."""
    rng = np.random.default_rng(11)
    b, s, n, d = 2, 40, 2, 64
    q, k, v = (rng.normal(size=(b, s, n * d)).astype(np.float32)
               for _ in range(3))
    with _interpret():
        want = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), n, causal=True)
    got = flash_attention_packed(_t(q), _t(k), _t(v), n, causal=True)
    _close(got, want)


@pytest.mark.parametrize("causal,period", [(False, 0), (False, 8),
                                           (True, 0)])
def test_flash_bwd_plain_matches_pallas_vjp_packed(causal, period):
    """K2/K3 (_bwd_dq_kernel_packed / _bwd_dkv_kernel_packed): jax.vjp of
    the Pallas packed kernel in interpret mode against flash_bwd_plain
    on the same q, k, v, dO (n*d = 128)."""
    from youku_mplug_tpu_torch.ops.flash_attention import flash_bwd_plain

    rng = np.random.default_rng(12 + period + causal)
    b, s, n, d = 2, 48, 2, 64
    q, k, v, do = (rng.normal(size=(b, s, n * d)).astype(np.float32)
                   for _ in range(4))
    with _interpret():
        out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention_packed(
            q_, k_, v_, n, causal=causal, period=period),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    q4, k4, v4, do4 = (_packed_to_heads(a, n) for a in (q, k, v, do))
    kw = dict(scale=d ** -0.5, causal=causal, period=period)
    o4, lse = flash_fwd_plain(q4, k4, v4, **kw)
    _close(_heads_to_packed(o4), out)
    got = flash_bwd_plain(q4, k4, v4, o4, lse, do4, **kw)
    for g, w in zip(got, want):
        _close(_heads_to_packed(g), w)


@pytest.mark.parametrize("kv_len", [None, 131])
def test_flash_bwd_plain_matches_pallas_vjp_head_major(kv_len):
    """K4b (_bwd_dq_kernel / _bwd_dkv_kernel via flash_attention's VJP),
    AttentionPool's unpadded path and the padded static-kv_len path; keys
    at or past kv_len get exactly zero dk and dv."""
    from youku_mplug_tpu_torch.ops.flash_attention import flash_bwd_plain

    rng = np.random.default_rng(13)
    b, h, sq, sk, d = 2, 2, 128, 150, 64
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    with _interpret():
        _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
            q_, k_, v_, kv_len=kv_len), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    kw = dict(scale=d ** -0.5, kv_len=kv_len)
    o, lse = flash_fwd_plain(_t(q), _t(k), _t(v), **kw)
    got = flash_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("sq,sk,causal,kv_len", [
    pytest.param(128, 1571, False, None, id="1571-None"),
    pytest.param(128, 150, False, 131, id="150-131"),
    # the edges of the backward kernels' D-wide tiles: a ragged key tail
    # (1570 = 24 x 64 + 34), a ragged query tail, kv_len < Sk over the
    # ragged keys, causal at the 2.7B decoder's 208 positions
    pytest.param(128, 1570, False, None, id="ragged-keys-1570"),
    pytest.param(100, 300, False, None, id="ragged-queries-100"),
    pytest.param(128, 1570, False, 1500, id="kv_len-1500-of-1570"),
    pytest.param(208, 208, True, None, id="causal-208"),
])
def test_flash_d96_plain_matches_pallas_interpret(sq, sk, causal, kv_len):
    """K4 and K4b at head dim 96 (clip-b16's AttentionPool, 8 heads of 96;
    here 2 heads): the forward and jax.vjp of the Pallas head-major kernel
    in interpret mode against flash_fwd_plain and flash_bwd_plain on the
    same q, k, v, dO, at AttentionPool's 128 queries over 1 + 8 x 196
    keys and the bias key, over a padded static kv_len, and at the edge
    shapes of the backward's tiles; keys at or past kv_len get exactly
    zero dk and dv."""
    from youku_mplug_tpu_torch.ops.flash_attention import flash_bwd_plain

    rng = np.random.default_rng(15 + sk + (sq != 128) + causal)
    b, h, d = 2, 2, 96
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    with _interpret():
        out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
            q_, k_, v_, causal=causal, kv_len=kv_len), jnp.asarray(q),
            jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv_len)
    o, lse = flash_fwd_plain(_t(q), _t(k), _t(v), **kw)
    _close(o, out)
    _close(flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=kv_len), out)
    got = flash_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("sq,sk,causal,kv_len", [
    (208, 208, True, None),   # the 2.7B decoder: 128 queries + 80 tokens
    (256, 256, True, None),   # causal over whole 128-row blocks
    (128, 150, False, 131),   # a padded static kv_len
    # the edges of the backward kernels' D-wide tiles: a ragged key tail
    # (1570 = 24 x 64 + 34), a ragged query tail, kv_len < Sk over the
    # ragged keys
    (128, 1570, False, None),
    (100, 300, False, None),
    (128, 1570, False, 1500),
])
def test_flash_d80_plain_matches_pallas_interpret(sq, sk, causal, kv_len):
    """K4 and K4b at head dim 80 (the GPT-3 2.7B decoder's 32 heads of 80;
    here 2 heads): the forward and jax.vjp of the Pallas head-major kernel
    in interpret mode against flash_fwd_plain and flash_bwd_plain, and the
    port's ``flash_attention``, on the same q, k, v, dO; keys at or past
    kv_len get exactly zero dk and dv."""
    from youku_mplug_tpu_torch.ops.flash_attention import flash_bwd_plain

    rng = np.random.default_rng(sq + sk + causal)
    b, h, d = 2, 2, 80
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    with _interpret():
        out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
            q_, k_, v_, causal=causal, kv_len=kv_len), jnp.asarray(q),
            jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv_len)
    o, lse = flash_fwd_plain(_t(q), _t(k), _t(v), **kw)
    _close(o, out)
    _close(flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=kv_len), out)
    got = flash_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None),
                                           (False, 9)])
def test_flash_bwd_plain_matches_autograd_of_mha_reference(causal, kv_len):
    from youku_mplug_tpu_torch.ops.flash_attention import flash_bwd_plain

    rng = np.random.default_rng(14)
    q, k, v, do = (_t(rng.normal(size=(2, 3, 16, 8)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kl = None if kv_len is None else torch.full((2,), kv_len)
    tmha(*leaves, causal=causal, kv_len=kl, scale=0.3).backward(do)
    o, lse = flash_fwd_plain(q, k, v, scale=0.3, causal=causal,
                             kv_len=kv_len)
    got = flash_bwd_plain(q, k, v, o, lse, do, scale=0.3, causal=causal,
                          kv_len=kv_len)
    for g, leaf in zip(got, leaves):
        _close(g, leaf.grad, 1e-5)


@pytest.mark.parametrize("d,n,s,ladder", [
    (64, 4, 100, True),     # d = 64, two heads per Pallas strip
    (64, 6, 72, True),      # the half-step ladder past 4 heads
    (128, 4, 100, True),    # Bloom's head dim
    (128, 3, 40, True),     # half-step ladder at d = 128
    (128, 2, 70, False),    # any per-head slopes, not a ladder
])
def test_flash_alibi_plain_matches_pallas_interpret(d, n, s, ladder):
    """K1 / K2 / K3 with ALiBi (Bloom's training attention): the packed
    causal forward and its jax.vjp in interpret mode against the port's
    wrapper (the plain forward and flash_bwd_plain through the autograd
    Function) on the same numpy inputs; S not a multiple of 64."""
    rng = np.random.default_rng(100 * d + s)
    b = 2
    q, k, v, do = (rng.normal(size=(b, s, n * d)).astype(np.float32)
                   for _ in range(4))
    slopes = alibi_slopes(n) if ladder else rng.uniform(
        0.05, 1.0, size=n).astype(np.float32)
    with _interpret():
        out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention_packed(
            q_, k_, v_, n, causal=True, alibi_slopes=slopes),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention_packed(*leaves, n, causal=True,
                                 alibi_slopes=torch.from_numpy(slopes))
    _close(got.detach(), out)
    got.backward(_t(do))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)
    # the bias matters at these shapes: without it the output differs
    assert not np.allclose(flash_attention_packed_plain(
        *map(_t, (q, k, v)), n, causal=True).numpy(), np.asarray(out),
        atol=1e-2)


def test_lora_delta_matches_jax():
    """(x @ a) @ b * alpha / r in the compute dtype; None without a
    pair."""
    from youku_mplug_tpu.ops.lora import lora_delta as j_delta
    from youku_mplug_tpu_torch.ops.lora import lora_delta

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    a = rng.normal(size=(12, 3)).astype(np.float32)
    b = rng.normal(size=(3, 20)).astype(np.float32)
    want = j_delta((jnp.asarray(a), jnp.asarray(b)), jnp.asarray(x), 3, 16.0,
                   jnp.float32)
    _close(lora_delta((_t(a), _t(b)), _t(x), 3, 16.0, torch.float32), want,
           1e-5)
    assert lora_delta(None, _t(x), 3, 16.0, torch.float32) is None


def test_flash_alibi_requires_causal_and_one_slope_per_head():
    x = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention_packed(x, x, x, 1, alibi_slopes=[0.5])
    with pytest.raises(ValueError, match="1 values"):
        flash_attention_packed(x, x, x, 1, causal=True,
                               alibi_slopes=[0.5, 0.25])


def test_flash_autograd_function_uses_plain_backward_on_cpu():
    """The wrappers' autograd Function: gradients equal autograd of the
    plain forward, and nothing launches on the CPU."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(15)
    x = _t(rng.normal(size=(2, 24, 3 * 128)).astype(np.float32))
    g = _t(rng.normal(size=(2, 24, 128)).astype(np.float32))
    grads = []
    for fn in (flash_attention_packed, flash_attention_packed_plain):
        leaf = x.clone().requires_grad_()
        fn(leaf[..., :128], leaf[..., 128:256], leaf[..., 256:], 2,
           causal=True).backward(g)
        grads.append(leaf.grad)
    _close(grads[0], grads[1], 1e-5)
    q4 = x[..., :128].unflatten(-1, (2, 64)).transpose(1, 2)
    leaf = q4.clone().requires_grad_()
    flash_attention(leaf, leaf, leaf, kv_len=20).sum().backward()
    assert leaf.grad.shape == q4.shape
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) \
        == (0, 0)


def test_layer_norm_backward_matches_jax_vjp():
    """The custom backward (saves x, mean, rstd) against the JAX custom
    VJP, fp32 and bf16 inputs."""
    from youku_mplug_tpu.ops.layernorm import layer_norm as jln_

    rng = np.random.default_rng(16)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    sc, bi = (rng.normal(size=(32,)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jln_(*a, eps=1e-6), jnp.asarray(x),
                     jnp.asarray(sc), jnp.asarray(bi))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (x, sc, bi)]
    tln(*leaves, eps=1e-6).backward(_t(g))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w, 1e-4)
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    y = tln(xb, _t(sc), _t(bi), eps=1e-6)
    assert y.dtype == torch.bfloat16
    y.float().backward(_t(g))
    assert xb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    from youku_mplug_tpu.ops.cross_entropy import (
        cross_entropy_with_logits as jce,
    )
    from youku_mplug_tpu_torch.ops.cross_entropy import (
        cross_entropy_with_logits,
    )

    rng = np.random.default_rng(17)
    logits = rng.normal(size=(4, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(4, 6)).astype(np.int32)
    _close(cross_entropy_with_logits(_t(logits), _t(labels), smoothing),
           jce(jnp.asarray(logits), jnp.asarray(labels), smoothing), 1e-5)


def test_lm_cross_entropy_chunked_and_dense_match_jax():
    """Dense (the flagship's S = 208 with chunk 32: 208 % 32 != 0) and
    chunked under checkpoint: values and hidden-state gradients."""
    from youku_mplug_tpu.ops.cross_entropy import (
        lm_cross_entropy as jlm,
        masked_mean_loss as jmm,
    )
    from youku_mplug_tpu_torch.ops.cross_entropy import (
        lm_cross_entropy,
        masked_mean_loss,
    )

    rng = np.random.default_rng(18)
    hid = rng.normal(size=(2, 16, 8)).astype(np.float32)
    emb = rng.normal(size=(30, 8)).astype(np.float32)
    lab = rng.integers(0, 30, size=(2, 16)).astype(np.int32)
    mask = (rng.random(size=(2, 16)) > 0.3).astype(np.int32)
    for chunk in (0, 4, 5):
        fn = lambda h_: jmm(jlm(h_, jnp.asarray(emb), jnp.asarray(lab),
                                chunk=chunk), jnp.asarray(mask))
        want, want_g = jax.value_and_grad(fn)(jnp.asarray(hid))
        leaf = _t(hid).requires_grad_()
        got = masked_mean_loss(lm_cross_entropy(leaf, _t(emb), _t(lab),
                                                chunk=chunk), _t(mask))
        got.backward()
        _close(got.detach(), want, 1e-5)
        _close(leaf.grad, want_g, 1e-5)


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


def _out(like, gapped):
    """The forward's output for q-shaped ``like`` [B, n, S, D]: heads of a
    [B, S, n*D] buffer, or (``gapped``) the even heads of a NaN-filled
    packed [B, S, 2n*D] buffer, whose odd heads flank every written head.
    Returns (o, the odd heads' view, or None)."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    if not gapped:
        return fa._head_major_empty(like), None
    b, n, s, d = like.shape
    buf = torch.full((b, s, 2 * n, d), float("nan"), dtype=like.dtype,
                     device=like.device)
    return buf[:, :, 0::2].transpose(1, 2), buf[:, :, 1::2]


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


def _check_fused_on_card(rng, device, n, d, layout, clen, vfrom, *,
                         alibi=False, int8=False):
    """The fused kernel against write_decode_attention_plain on copies of
    one cache whose rows are preset: both cache leaves bitwise equal, no
    row but (lidx, b, clen[b]) touched, the output within four bf16 ulps,
    the variant's launch counter up by one and no other.  Returns the
    kernel's output."""
    L, B, M = 3, len(clen), 256
    qkv = _bf16(rng, *((B, 3 * n * d) if layout == "packed"
                       else (B, n, 3, d)), device=device)
    rows = _bf16(rng, L, B, M, 2 * n * d, device=device)
    base = tkv.quantize_rows(rows, n) if int8 else (rows, None)
    base = ({"kv": base[0], "scale": base[1]} if int8 else rows)
    got_c, want_c = (({k: t.clone() for k, t in base.items()} if int8
                      else base.clone()) for _ in range(2))
    clen, vfrom = (torch.tensor(x, dtype=torch.int32, device=device)
                   for x in (clen, vfrom))
    kw = dict(alibi_slopes=alibi_slopes(n) if alibi else None)
    names = ("launches", "alibi_launches", "int8_launches",
             "int8_alibi_launches", "d80_launches", "int8_d80_launches")
    before = [getattr(write_decode_attention, c) for c in names]
    got = write_decode_attention(*_step_views(qkv, n, d, layout), got_c, n,
                                 2, clen, vfrom, **kw)
    torch.cuda.synchronize()
    counter = ("int8_" if int8 else "") + ("alibi_" if alibi else "") \
        + ("d80_" if d == 80 else "") + "launches"
    assert [getattr(write_decode_attention, c) - b0
            for c, b0 in zip(names, before)] == [int(c == counter)
                                                 for c in names]
    want = write_decode_attention_plain(*_step_views(qkv, n, d, layout),
                                        want_c, n, 2, clen, vfrom, **kw)
    for g, w, b0 in zip(tkv.leaves(got_c), tkv.leaves(want_c),
                        tkv.leaves(base)):
        if b0 is None:  # a bf16 cache has one leaf
            continue
        assert torch.equal(g, w)
        touched = {tuple(x) for x in (g != b0).reshape(L, B, M, -1).any(-1)
                   .nonzero().tolist()}
        assert touched <= {(2, i, int(clen[i])) for i in range(B)}
    _bf16_close(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("alibi,int8", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_cuda_decode_matches_plain(cuda_device, alibi, int8):
    """K5 with the write folded in at d 64, bf16 and int8 caches, with and
    without the ALiBi ladder, q/k/v views of GPT-3's packed row: a slot
    with no live key, two whose only live key is the row they write, one
    reading a single row from the cache (a live range shorter than the
    cluster's two blocks), one reading two, rows 0, M-1 and >= M."""
    rng = np.random.default_rng(12 + int8 + 2 * alibi)
    got = _check_fused_on_card(rng, cuda_device, 4, 64, "packed",
                               [0, 100, 255, 3, 40, 300, 3, 2],
                               [0, 7, 130, 9, 40, 200, 1, 1],
                               alibi=alibi, int8=int8)
    assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,alibi,int8", [(4, False, False),
                                          (4, True, False),
                                          (12, True, False),
                                          (4, True, True), (12, False, True),
                                          (12, True, True)])
def test_cuda_decode_d128_matches_plain(cuda_device, n, alibi, int8):
    """K5 with the write folded in at head dim 128 (Bloom), with and
    without the ALiBi ladder (12 heads: the half-step ladder past 8), bf16
    and int8 caches; q/k/v head views of the head-major fused row
    [B, n, 3, d], as the Bloom decoder passes them."""
    rng = np.random.default_rng(n + alibi + int8)
    got = _check_fused_on_card(rng, cuda_device, n, 128, "head-major",
                               [0, 100, 255, 3, 40], [0, 7, 130, 9, 40],
                               alibi=alibi, int8=int8)
    assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,int8", [(4, False), (4, True), (32, False),
                                    (32, True)])
def test_cuda_decode_d80_matches_plain(cuda_device, n, int8):
    """K5 with the write folded in at head dim 80 (the GPT-3 2.7B decoder:
    teams of 10 lanes, three a warp), bf16 and int8 caches, q/k/v views of
    GPT-3's packed row, at 4 heads and at the decoder's 32; the same slots
    as at d 64.  ALiBi is not built at 80 and raises."""
    rng = np.random.default_rng(80 + n + int8)
    got = _check_fused_on_card(rng, cuda_device, n, 80, "packed",
                               [0, 100, 255, 3, 40, 300, 3, 2],
                               [0, 7, 130, 9, 40, 200, 1, 1], int8=int8)
    assert not got[3].any()
    if n == 4 and not int8:
        x = torch.zeros(2, n * 80, device=cuda_device, dtype=torch.bfloat16)
        cache = torch.zeros(1, 2, 64, 2 * n * 80, device=cuda_device,
                            dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="ALiBi"):
            write_decode_attention(x, x, x, cache, n, 0, 3,
                                   alibi_slopes=alibi_slopes(n))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 16, 2 * 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_packed(x, x, x, 2)  # d = 32
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_packed(x.float(), x.float(), x.float(), 1)
    # the decode kernel: head dim 32, an fp32 cache, a non-contiguous one
    q = x[:, 0]
    for cache, n in ((torch.zeros(1, 2, 8, 2 * 64, device=cuda_device,
                                  dtype=torch.bfloat16), 2),
                     (torch.zeros(1, 2, 8, 2 * 64, device=cuda_device), 1),
                     (torch.zeros(1, 4, 8, 2 * 64, device=cuda_device,
                                  dtype=torch.bfloat16)[:, ::2], 1)):
        with pytest.raises((TypeError, ValueError)):
            write_decode_attention(q, q, q, cache, n, 0, 3)


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s,n", [(2, 208, 4),   # decoder training
                                      (3, 100, 1),   # ragged, one head
                                      (2, 1, 2)])    # one token
def test_cuda_flash_causal_matches_plain(cuda_device, rows, s, n):
    """K1 causal: query tile i walks key tiles 0..i only."""
    rng = np.random.default_rng(s + n)
    nd = n * 64
    qkv = _bf16(rng, rows, s, 3 * nd, device=cuda_device)
    q, k, v = qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:]
    got = flash_attention_packed(q, k, v, n, causal=True)
    _bf16_close(got, flash_attention_packed_plain(q, k, v, n, causal=True))
    views = [t.unflatten(-1, (n, 64)).transpose(1, 2) for t in (q, k, v)]
    lse = flash_fwd_cuda(*views, torch.empty_like(views[0]), scale=0.125,
                         causal=True)
    _, want_lse = flash_fwd_plain(*views, scale=0.125, causal=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


# (q rows, Sq, Sk, heads, causal, period, kv_len, layout): the four
# training shapes at a reduced batch, plus edge cases
BWD_CASES = [
    (2, 197, 197, 2, False, 0, None, "packed"),   # vision spatial
    (2, 112, 112, 2, False, 8, None, "packed"),   # grouped temporal
    (2, 208, 208, 4, True, 0, None, "packed"),    # decoder
    (2, 128, 1571, 2, False, 0, None, "heads"),   # AttentionPool
    (2, 65, 130, 1, False, 0, 70, "heads"),       # static kv_len
    (2, 100, 100, 1, False, 3, None, "packed"),   # period off the tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,n,causal,period,kv_len,layout", BWD_CASES)
def test_cuda_flash_bwd_matches_plain(cuda_device, b, sq, sk, n, causal,
                                      period, kv_len, layout):
    """dq and dk/dv kernels against flash_bwd_plain on the same (q, k, v,
    o, lse, dO): relative L2 within 2^-7 (bf16 p and dS rounded at
    slightly different fp32 values, bf16 outputs), keys past kv_len
    exactly zero."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(sq + sk)
    nd = n * 64
    qp = _bf16(rng, b, sq, 3 * nd, device=cuda_device)
    kvp = qp if sq == sk else _bf16(rng, b, sk, 3 * nd, device=cuda_device)
    q, k, v = (_t.unflatten(-1, (n, 64)).transpose(1, 2) for _t in
               (qp[..., :nd], kvp[..., nd:2 * nd], kvp[..., 2 * nd:]))
    kw = dict(scale=0.125, causal=causal, period=period, kv_len=kv_len)
    o = torch.empty(b, sq, n, 64, dtype=torch.bfloat16,
                    device=cuda_device).transpose(1, 2)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    do = _bf16(rng, b, n, sq, 64, device=cuda_device)
    before = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2.0 ** -7, (name, _rel_l2(g, w))
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,alibi", [(64, False), (128, True)])
def test_cuda_flash_bwd_causal_keys_without_later_queries(cuda_device, d,
                                                          alibi):
    """Causal: dk and dv of key j take only queries i >= j, so with dO
    zero from query 150 on, keys 150.. get exactly zero gradient (with
    the ALiBi bias too)."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(21)
    q, k, v = (_bf16(rng, 2, 2, 208, d, device=cuda_device)
               for _ in range(3))
    kw = dict(scale=d ** -0.5, causal=True, alibi_slopes=torch.tensor(
        [0.5, 0.25], device=cuda_device) if alibi else None)
    o = torch.empty_like(q)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    do = _bf16(rng, 2, 2, 208, d, device=cuda_device)
    do[:, :, 150:] = 0
    _, dk, dv = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert not dk[:, :, 150:].any() and not dv[:, :, 150:].any()
    assert dk[:, :, :150].abs().sum() > 0


# (rows, S, heads, head dim, ALiBi): Bloom training [8, 105, 32x128]
# (reduced batch) with a ragged tail tile, the max_length 768 of
# configs/instruct (many causal tiles, biases to ~645), 40 heads (the
# half-step ladder), ALiBi at d = 64, d = 128 without ALiBi, and a
# three-row sequence (one tile, mostly masked; at S = 1 dq and dk are
# exactly zero and a relative error means nothing)
ALIBI_CASES = [(2, 105, 32, 128, True), (1, 768, 4, 128, True),
               (1, 256, 40, 128, True), (2, 208, 4, 64, True),
               (2, 256, 4, 128, False), (2, 3, 2, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s,n,d,alibi", ALIBI_CASES)
def test_cuda_flash_alibi_and_d128_match_plain(cuda_device, rows, s, n, d,
                                               alibi):
    """K1, dq and dk/dv at head dim 128 and with ALiBi, on packed views
    of one head-major qkv projection: forward o and lse, then the
    backward kernels against flash_bwd_plain on the same (q, k, v, o,
    lse, dO); each variant's launch counter rises."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(s + n + d)
    qkv5 = _bf16(rng, rows, s, n, 3, d, device=cuda_device)
    q, k, v = (qkv5[..., i, :].transpose(1, 2) for i in range(3))
    slopes = (torch.from_numpy(alibi_slopes(n)).to(cuda_device) if alibi
              else None)
    kw = dict(scale=d ** -0.5, causal=True, alibi_slopes=slopes)
    counter = "alibi_launches" if alibi else "launches"
    wrappers = (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [getattr(f, counter) for f in wrappers]
    o = fa._head_major_empty(q)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = flash_fwd_plain(q, k, v, **kw)
    _bf16_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    do = _bf16(rng, rows, n, s, d, device=cuda_device)
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [getattr(f, counter) for f in wrappers] == [x + 1 for x in before]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2.0 ** -7, (name, _rel_l2(g, w))


@pytest.mark.cuda
def test_cuda_flash_alibi_autograd_counts_its_launches(cuda_device):
    """The packed wrapper with ALiBi: forward and backward launch the ALiBi
    builds (alibi_launches), never the plain-mask ones."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(23)
    x = _bf16(rng, 2, 105, 3 * 256, device=cuda_device).requires_grad_()
    slopes = torch.from_numpy(alibi_slopes(2)).to(cuda_device)
    fns = (fa.flash_attention_packed, fa.flash_bwd_dq_cuda,
           fa.flash_bwd_dkv_cuda)
    plain_before = [f.launches for f in fns]
    alibi_before = [f.alibi_launches for f in fns]
    out = flash_attention_packed(x[..., :256], x[..., 256:512], x[..., 512:],
                                 2, causal=True, alibi_slopes=slopes)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == plain_before
    assert [f.alibi_launches for f in fns] == [a + 1 for a in alibi_before]
    want = flash_attention_packed_plain(x[..., :256], x[..., 256:512],
                                        x[..., 512:], 2, causal=True,
                                        alibi_slopes=slopes)
    _bf16_close(out, want)


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_plain_autograd(cuda_device):
    """The autograd Function (kernels both ways) against autograd of the
    plain forward, through a packed causal call."""
    rng = np.random.default_rng(22)
    qkv = _bf16(rng, 2, 208, 3 * 128, device=cuda_device)
    g_out = _bf16(rng, 2, 208, 128, device=cuda_device)
    grads = []
    for fn in (flash_attention_packed, flash_attention_packed_plain):
        x = qkv.clone().requires_grad_()
        out = fn(x[..., :128], x[..., 128:256], x[..., 256:], 2, causal=True)
        out.backward(g_out)
        grads.append(x.grad)
    assert _rel_l2(grads[0], grads[1]) <= 2.0 ** -6


# (rows, Sq, Sk, heads, causal, period, kv_len, gapped output): head dim
# 96, the clip-b16 AttentionPool's q [B, 8, 128, 96] over 1 + 8 x 196 keys
# and the bias key at a reduced batch and at one sample (split-KV, the
# merge at 96 columns), then a static kv_len, the causal and period masks
# and a three-query sequence over five keys (one tile, mostly
# zero-filled); then, each into the even heads of a packed buffer: a
# ragged query tail (208 = 3 x 64 + 16) over ragged keys, split six ways;
# the 16-frame 3138 keys, split; kv_len < Sk at an evaluation call's 4
# clips, split; the cls train step's 32 clips, one split
D96_CASES = [(2, 128, 1570, 8, False, 0, None, False),
             (1, 128, 1570, 2, False, 0, None, False),
             (2, 65, 130, 1, False, 0, 70, False),
             (2, 208, 208, 2, True, 0, None, False),
             (2, 112, 112, 2, False, 8, None, False),
             (2, 3, 5, 2, False, 0, None, False),
             (2, 208, 1570, 8, False, 0, None, True),
             (1, 128, 3138, 8, False, 0, None, True),
             (4, 128, 1570, 8, False, 0, 1400, True),
             (32, 128, 1570, 8, False, 0, None, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,sq,sk,n,causal,period,kv_len,gapped",
                         D96_CASES)
def test_cuda_flash_d96_matches_plain(cuda_device, rows, sq, sk, n, causal,
                                      period, kv_len, gapped):
    """K4 and K4b at head dim 96 on head views of [B, S, n*96]
    projections: the forward's o and lse (written, if ``gapped``, into
    every other head of a packed buffer whose other heads stay
    untouched), then the dq and dk/dv kernels against flash_bwd_plain on
    the same (q, k, v, o, lse, dO); only the head-dim-96 counters rise,
    and keys past kv_len get exactly zero."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(sq + sk + n)
    d = 96
    q = _bf16(rng, rows, sq, n * d, device=cuda_device).unflatten(
        -1, (n, d)).transpose(1, 2)
    k, v = (_bf16(rng, rows, sk, n * d, device=cuda_device).unflatten(
        -1, (n, d)).transpose(1, 2) for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal, period=period, kv_len=kv_len)
    wrappers = (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [(f.launches, f.d96_launches) for f in wrappers]
    o, others = _out(q, gapped)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = flash_fwd_plain(q, k, v, **kw)
    _bf16_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    assert others is None or torch.isnan(others).all()
    do = _bf16(rng, rows, n, sq, d, device=cuda_device)
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [(f.launches, f.d96_launches) for f in wrappers] == [
        (a, b + 1) for a, b in before]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2.0 ** -7, (name, _rel_l2(g, w))
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


@pytest.mark.cuda
def test_cuda_flash_d96_autograd_counts_and_refuses_alibi(cuda_device):
    """AttentionPool's call through the autograd Function at head dim 96:
    one forward, dq and dk/dv launch each on the d96 counters, gradients
    against autograd of the plain forward; ALiBi is not built at 96."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(23)
    q0 = _bf16(rng, 2, 128, 8 * 96, device=cuda_device)
    kv0 = _bf16(rng, 2, 300, 2 * 8 * 96, device=cuda_device)
    g_out = _bf16(rng, 2, 8, 128, 96, device=cuda_device)
    fns = (fa.flash_attention, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        before = [(f.launches, f.d96_launches) for f in fns]
        x, y = q0.clone().requires_grad_(), kv0.clone().requires_grad_()
        heads = [t.unflatten(-1, (8, 96)).transpose(1, 2)
                 for t in (x, y[..., :768], y[..., 768:])]
        fn(*heads).backward(g_out)
        torch.cuda.synchronize()
        after = [(f.launches, f.d96_launches) for f in fns]
        assert after == ([(a, b + 1) for a, b in before]
                         if fn is fa.flash_attention else before)
        grads.append((x.grad, y.grad))
    for got, want in zip(*grads):
        assert _rel_l2(got, want) <= 2.0 ** -6
    x = q0[..., :2 * 96].unflatten(-1, (2, 96))
    with pytest.raises(ValueError, match="ALiBi"):
        fa.flash_attention_packed(x, x, x, 2, causal=True,
                                  alibi_slopes=[0.5, 0.25])


# head dim 80 (the GPT-3 2.7B decoder, 32 heads of 80): its causal
# 208-token passes (128 queries + 80 tokens), a ragged causal length, a
# head-major kv_len case, a few rows in one tile, and AttentionPool-like
# keys (split six ways); then, each into the even heads of a packed
# buffer: the causal 208-token pass (a ragged query tail), 208 queries
# over 1570 keys (split), 3138 keys (split twelve ways), and kv_len < Sk
# over ragged keys
D80_CASES = [(2, 208, 208, 32, True, None, False),
             (3, 100, 100, 2, True, None, False),
             (2, 65, 130, 1, False, 70, False),
             (2, 7, 7, 2, True, None, False),
             (1, 128, 1570, 4, False, None, False),
             (2, 208, 208, 32, True, None, True),
             (2, 208, 1570, 4, False, None, True),
             (1, 128, 3138, 2, False, None, True),
             (2, 100, 1570, 2, False, 1500, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,sq,sk,n,causal,kv_len,gapped", D80_CASES)
def test_cuda_flash_d80_matches_plain(cuda_device, rows, sq, sk, n, causal,
                                      kv_len, gapped):
    """K4 and K4b at head dim 80 on head views of [B, S, 3 x n*80] fused
    projections, as the 2.7B decoder hands them over: the forward's o and
    lse (written, if ``gapped``, into every other head of a packed buffer
    whose other heads stay untouched), then the dq and dk/dv kernels
    against flash_bwd_plain on the same (q, k, v, o, lse, dO); only the
    head-dim-80 counters rise, and keys past kv_len get exactly zero."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(sq + sk + n)
    d = 80
    qkv = _bf16(rng, rows, sk, 3 * n * d, device=cuda_device)
    q, k, v = (qkv[:, :sq, i * n * d:(i + 1) * n * d].unflatten(
        -1, (n, d)).transpose(1, 2) for i in range(3))
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv_len)
    wrappers = (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [(f.launches, f.d96_launches, f.d80_launches) for f in wrappers]
    o, others = _out(q, gapped)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = flash_fwd_plain(q, k, v, **kw)
    _bf16_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    assert others is None or torch.isnan(others).all()
    do = _bf16(rng, rows, n, sq, d, device=cuda_device)
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [(f.launches, f.d96_launches, f.d80_launches)
            for f in wrappers] == [(a, b, c + 1) for a, b, c in before]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2.0 ** -7, (name, _rel_l2(g, w))
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()


# the edges of the backward's D-wide tiles at head dims 80 and 96: (Sq,
# Sk, causal, kv_len) for a ragged key tail (1570 = 24 x 64 + 34), a
# ragged query tail, kv_len < Sk over the ragged keys, causal at 208, and
# 256 queries over the ragged keys.  At d 96 the first three take the
# short-query dk/dv kernel and the last two the key-tile one, as
# dkv_short_splits picks; at d 80 all take the key-tile one
WIDE_BWD_EDGES = [(128, 1570, False, None), (100, 300, False, None),
                  (128, 1570, False, 1500), (208, 208, True, None),
                  (256, 1570, False, 1500)]
WIDE_BWD_CASES = [(d, *edge) for d in (80, 96) for edge in WIDE_BWD_EDGES]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,sk,causal,kv_len", WIDE_BWD_CASES)
def test_cuda_flash_bwd_wide_edges_match_plain(cuda_device, d, sq, sk,
                                               causal, kv_len):
    """The dq and dk/dv kernels at head dims 80 and 96 against
    flash_bwd_plain at relative L2 2^-7, on strided head views as the
    models hand them over (d 80: the 2.7B decoder's fused [B, S, 3 n d]
    qkv row; d 96: AttentionPool's separate [B, S, n d] projections), each
    gradient written into the even heads of a NaN-filled packed buffer
    whose other heads stay untouched; keys at or past kv_len get exactly
    zero; the short-query launch counter rises exactly when that kernel
    runs."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(sq + sk + d)
    n, b = 4, 3
    if d == 80:
        qkv = _bf16(rng, b, sk, 3 * n * d, device=cuda_device)
        q, k, v = (qkv[:, :sq, i * n * d:(i + 1) * n * d].unflatten(
            -1, (n, d)).transpose(1, 2) for i in range(3))
    else:
        q, k, v = (_bf16(rng, b, s, n * d, device=cuda_device).unflatten(
            -1, (n, d)).transpose(1, 2) for s in (sq, sk, sk))
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv_len)
    o = fa._head_major_empty(q)
    lse = flash_fwd_cuda(q, k, v, o, **kw)
    do = _bf16(rng, b, n, sq, d, device=cuda_device)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    (dq, dq_odd), (dk, dk_odd), (dv, dv_odd) = (
        _out(t, True) for t in (q, k, v))
    before = fa.flash_bwd_dkv_cuda.d96_short_launches
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, **kw)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, **kw)
    torch.cuda.synchronize()
    short = fa.dkv_short_splits(b, n, sq, sk, head_dim=d, causal=causal)
    assert bool(short) == (d == 96 and sq <= 128 and not causal)
    assert fa.flash_bwd_dkv_cuda.d96_short_launches - before == bool(short)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2.0 ** -7, (name, _rel_l2(g, w))
    assert all(torch.isnan(t).all() for t in (dq_odd, dk_odd, dv_odd))
    if kv_len is not None:
        assert not dk[:, :, kv_len:].any() and not dv[:, :, kv_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_flash_bwd_delta_matches_plain(cuda_device, d):
    """The backward's delta kernel (rowsum(dO * O) in fp32) against its
    plain version on head views of a fused [B, S, 3 n d] row (O) and of
    a [B, S, n d] projection (dO), a ragged 197 rows; one launch counted."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(d)
    n = 3
    o = _bf16(rng, 2, 197, 3 * n * d, device=cuda_device)[
        ..., n * d:2 * n * d].unflatten(-1, (n, d)).transpose(1, 2)
    do = _bf16(rng, 2, 197, n * d, device=cuda_device).unflatten(
        -1, (n, d)).transpose(1, 2)
    before = fa.flash_bwd_delta_cuda.launches
    got = fa.flash_bwd_delta_cuda(o, do)
    torch.cuda.synchronize()
    assert fa.flash_bwd_delta_cuda.launches == before + 1
    want = fa.flash_bwd_delta_plain(o, do)
    assert got.shape == (2, n, 197) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_bwd_blocks_per_sm_match_the_table(cuda_device):
    """The card's resident blocks an SM of each backward build (dq, dk/dv,
    short-query dk/dv at 96) equal BWD_BLOCKS_PER_SM at every head
    dim, and the ALiBi builds (64 and 128) keep at least one (they have
    no short-query kernel)."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    for d in fa.HEAD_DIMS:
        assert fa.bwd_blocks_per_sm(d) == fa.BWD_BLOCKS_PER_SM[d], d
    for d in fa.ALIBI_HEAD_DIMS:
        dq, dkv, short = fa.bwd_blocks_per_sm(d, alibi=True)
        assert dq >= 1 and dkv >= 1 and short is None, d


@pytest.mark.cuda
def test_cuda_gpt3_d80_attention_dispatch_counts(cuda_device):
    """The 2.7B decoder's attention on the card, at 4 heads of 80: a
    cacheless forward of 208 tokens launches K4 at head dim 80 once and
    no packed kernel, a 100-token one none (plain attention below 128
    rows), and a decode step the decode kernel at head dim 80 once; the
    outputs match the same layer with every wrapper plain."""
    from youku_mplug_tpu_torch.models import gpt3
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    cfg = gpt3.GPT3Config(vocab_size=64, hidden_size=320,
                          num_hidden_layers=1, num_attention_heads=4,
                          max_position_embeddings=256)
    attn = gpt3.GPT3Attention(cfg, 1, torch.bfloat16).to(cuda_device)
    gen = torch.Generator().manual_seed(3)
    for p in attn.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    rng = np.random.default_rng(5)
    counts = (lambda: (fa.flash_attention.d80_launches,
                       fa.flash_attention_packed.launches,
                       write_decode_attention.d80_launches))
    for s, want in ((208, (1, 0, 0)), (100, (0, 0, 0))):
        x = _bf16(rng, 2, s, 320, device=cuda_device)
        before = counts()
        got = attn(x, 0)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        with mock.patch.object(fa, "_on_cpu", lambda t: True):
            plain = attn(x, 0)
        _bf16_close(got, plain)
    cache = torch.zeros(1, 2, 128, 2 * 320, device=cuda_device,
                        dtype=torch.bfloat16)
    before = counts()
    attn(x[:, :1], 0, cache=cache, cache_len=5)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1)
