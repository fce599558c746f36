"""The Python side of the split-KV flash forward (csrc/flash_fwd.cu)
against the JAX package.

``kv_splits`` (how many ways the forward kernel splits a block's key
tiles) and ``dkv_short_splits`` (how many ways the backward's short-query
dk/dv kernel splits a (head, batch)'s key tiles, 0 for the key-tile
kernel) at the paths' shapes; ``split_ranges`` (each split's keys, the
kernel's arithmetic, mirrored here) covering every visible key once; the
fp32 scratch shapes; and a plain split-and-merge (``split_plain`` with
``merge_plain``, written here after the split launch and its merge
kernel) held against ``flash_fwd_plain`` (1e-5: the same fp32 math
regrouped) and against the Pallas forward in interpret mode (``_fwd`` for
head-major, ``_fwd_packed`` for the packed and ALiBi cases) at the Pallas
tests' 2e-3, on the same numpy inputs: ragged Sk, kv_len < Sk, causal,
period 8, head dim 64 and 128, ALiBi.  Tests marked ``cuda`` run the
kernels against their plain versions at those shapes on the card, which
is what ties the kernel's own arithmetic to these results.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from youku_mplug_tpu.ops import flash_attention as jfa
from youku_mplug_tpu_torch.ops import flash_attention as fa
from youku_mplug_tpu_torch.ops.decode_attention import alibi_slopes

torch.set_num_threads(1)
TOL = 2e-3  # the Pallas interpret-mode tolerance of tests/test_ops.py
MERGE_TOL = 1e-5  # the same fp32 sums regrouped by split


def _interpret():
    return mock.patch.object(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def split_ranges(sq, sk, splits, *, causal=False, period=0, kv_len=None):
    """For each 64-row query tile, the key range [lo, hi) each split walks
    (flash_fwd.cu's arithmetic: the tile's visible key tiles, cut into
    ``splits`` contiguous shares of whole tiles; a share may be empty)."""
    tile = fa.TILE
    kv = fa._kv(kv_len, sk)
    out = []
    for q0 in range(0, sq, tile):
        q_last = min(q0 + tile, sq) - 1
        k_lo, k_hi = 0, kv
        if causal:
            k_hi = min(k_hi, q_last + 1)
        if period > 0:
            k_lo = (q0 // period) * period
            k_hi = min(k_hi, (q_last // period + 1) * period)
        t_lo = k_lo // tile
        t_hi = -(-k_hi // tile) if k_hi > k_lo else t_lo
        per = -(-(t_hi - t_lo) // splits)
        shares = []
        for split in range(splits):
            j0 = min(t_lo + split * per, t_hi)
            j1 = min(j0 + per, t_hi)
            shares.append((min(j0 * tile, sk), min(j1 * tile, sk)))
        out.append(shares)
    return out


def merge_plain(o_part, lse_part):
    """The split merge: shares o_s (fp32, normalised, [splits, B, H, Sq,
    D]) and lse_s ([splits, B, H, Sq]) -> (o, lse) with lse = log(sum_s
    exp(lse_s)) and o = sum_s exp(lse_s - lse) o_s; rows whose every share
    is empty give o = 0, lse = -inf."""
    lse = torch.logsumexp(lse_part, dim=0)
    w = torch.exp(lse_part - lse).nan_to_num(0.0)  # -inf - -inf
    return (w[..., None] * o_part).sum(0), lse


def split_plain(q, k, v, splits, *, scale, causal=False, period=0,
                kv_len=None, alibi_slopes=None):
    """The split forward in plain torch: each split's share of each query
    tile's keys (``split_ranges``) gives its own (o_s, lse_s), as the
    kernel writes them to scratch, and ``merge_plain`` merges them.
    Returns (o in q.dtype, lse fp32) like ``flash_fwd_plain``."""
    sq, sk = q.shape[2], k.shape[2]
    s = fa._scores(q, k, scale, alibi_slopes)
    allowed = fa._allowed(sq, sk, causal=causal, period=period,
                          kv_len=kv_len, device=q.device)
    ki = torch.arange(sk, device=q.device)
    o_part, lse_part = [], []
    for split in range(splits):
        share = torch.zeros(sq, sk, dtype=torch.bool, device=q.device)
        for t, shares in enumerate(split_ranges(
                sq, sk, splits, causal=causal, period=period,
                kv_len=kv_len)):
            lo, hi = shares[split]
            share[t * fa.TILE:(t + 1) * fa.TILE] = (ki >= lo) & (ki < hi)
        x = s.masked_fill(~(allowed & share), float("-inf"))
        lse_s = torch.logsumexp(x, dim=-1)
        p = torch.exp(x - lse_s[..., None]).nan_to_num(0.0)
        o_part.append(torch.einsum("bhqk,bhkd->bhqd", p, v.float()))
        lse_part.append(lse_s)
    o, lse = merge_plain(torch.stack(o_part), torch.stack(lse_part))
    return o.to(q.dtype), lse


@pytest.mark.parametrize("shape,kw,want", [
    # K4, AttentionPool while serving: 2 x 12 x 8 = 192 blocks of 25 key
    # tiles; two splits keep 384 blocks within one wave of 528
    ((8, 12, 128, 1570), {}, 2),
    # K4 in the pretrain step: 384 blocks already fill a wave
    ((16, 12, 128, 1570), {}, 1),
    # K1, vision spatial: 6144 blocks
    ((128, 12, 197, 197), {}, 1),
    # Bloom's ALiBi training attention: causal, never split
    ((8, 32, 105, 105), {"causal": True}, 1),
    ((2, 32, 768, 768), {"causal": True}, 1),
    # the grouped temporal attention: period, never split
    ((224, 12, 112, 112), {"period": 8}, 1),
    # chip_smoke's split case: 96 blocks, 15 live key tiles of kv_len 900
    ((4, 12, 100, 1000), {"kv_len": 900}, 3),
    # few blocks and few tiles: shares of at least four tiles
    ((2, 1, 65, 130), {"kv_len": 70}, 1),
    ((1, 1, 64, 4096), {}, 16),
    # head dim 128: two resident blocks a multiprocessor, so a wave of 264
    ((8, 12, 128, 1570), {"head_dim": 128}, 1),
    ((1, 12, 128, 1570), {"head_dim": 128}, 6),
    # a card with fewer multiprocessors: a smaller wave
    ((8, 12, 128, 1570), {"sms": 78}, 1),
    ((4, 12, 128, 1570), {"sms": 78}, 3),
    # head dim 80, the 2.7B decoder: its causal calls never split; a
    # head-major call with few blocks does (four resident blocks on the
    # D-wide tiles, so a wave of 528; the share floor holds it at 3)
    ((180, 32, 208, 208), {"causal": True, "head_dim": 80}, 1),
    ((1, 32, 100, 1000), {"kv_len": 900, "head_dim": 80}, 3),
    ((4, 8, 128, 1570), {"head_dim": 80}, 6),
    # head dim 96, clip-b16's AttentionPool: three resident blocks, a wave
    # of 396; the cls evaluation call's 64 blocks of 25 key tiles split 6
    # ways, the ITM call's (13 tiles) 3; the train steps fill a wave
    ((4, 8, 128, 1570), {"head_dim": 96}, 6),
    ((4, 8, 128, 786), {"head_dim": 96}, 3),
    ((32, 8, 128, 1570), {"head_dim": 96}, 1),
    ((24, 8, 128, 3138), {"head_dim": 96}, 1),
])
def test_kv_splits_at_the_paths_shapes(shape, kw, want):
    assert fa.kv_splits(*shape, **kw) == want
    b, h, sq, _ = shape
    blocks = -(-sq // fa.TILE) * h * b
    wave = (fa.FWD_BLOCKS_PER_SM[kw.get("head_dim", 64)]
            * kw.get("sms", fa.SMS))
    assert want == 1 or blocks * want <= wave


@pytest.mark.parametrize("shape,kw,want", [
    # clip-b16's AttentionPool at head dim 96: the short-query dk/dv
    # kernel, each (head, batch)'s key tiles in shares of at most
    # SHORT_TILES_PER_BLOCK (3): the cls train step's 1570 keys (25
    # tiles), ITM's 786 (13), the 2.7B caption recipe's 3138 (50)
    ((32, 8, 128, 1570), {"head_dim": 96}, 9),
    ((32, 8, 128, 786), {"head_dim": 96}, 5),
    ((24, 8, 128, 3138), {"head_dim": 96}, 17),
    # a ragged query tail; one tile each way
    ((3, 4, 100, 300), {"head_dim": 96}, 2),
    ((2, 1, 3, 5), {"head_dim": 96}, 1),
    # the key-tile kernel: more than 128 queries, a causal or period mask,
    # ALiBi, head dims 64, 80 and 128
    ((2, 8, 129, 1570), {"head_dim": 96}, 0),
    ((2, 8, 112, 112), {"head_dim": 96, "period": 8}, 0),
    ((2, 8, 128, 128), {"head_dim": 96, "causal": True}, 0),
    ((32, 32, 208, 208), {"head_dim": 80, "causal": True}, 0),
    ((8, 32, 128, 1570), {"head_dim": 80}, 0),
    ((16, 12, 128, 1570), {"head_dim": 64}, 0),
    ((8, 32, 105, 105), {"head_dim": 128, "causal": True, "alibi": True},
     0),
    ((2, 8, 128, 1570), {"head_dim": 128}, 0),
])
def test_dkv_short_splits_at_the_paths_shapes(shape, kw, want):
    """How the backward's dk/dv runs (``dkv_short_splits``): 0 for the
    key-tile kernel, else the short-query kernel's split of the keys."""
    assert fa.dkv_short_splits(*shape, **kw) == want


@pytest.mark.parametrize("sq,sk,splits,kw", [
    (128, 1570, 2, {}), (100, 1000, 3, {"kv_len": 900}),
    (70, 200, 4, {"kv_len": 150}), (150, 150, 3, {"causal": True}),
    (112, 112, 2, {"period": 8}), (64, 300, 7, {})])
def test_split_ranges_cover_each_visible_key_once(sq, sk, splits, kw):
    allowed = fa._allowed(sq, sk, causal=kw.get("causal", False),
                          period=kw.get("period", 0),
                          kv_len=kw.get("kv_len"), device="cpu")
    for t, shares in enumerate(split_ranges(sq, sk, splits, **kw)):
        assert len(shares) == splits
        seen = torch.zeros(sk, dtype=torch.int64)
        for lo, hi in shares:
            assert (lo % fa.TILE == 0 or lo == sk) and lo <= hi <= sk
            seen[lo:hi] += 1
        assert seen.max() <= 1
        rows = allowed[t * fa.TILE:(t + 1) * fa.TILE].any(0)
        assert bool((seen[rows] == 1).all())  # every visible key, once


def test_split_scratch_shapes():
    """The forward's o partials are fp32 [splits, B, H, Sq, D], its lse
    partials [splits, B, H, Sq]; one split needs no scratch (the kernel
    writes its output).  The backward takes no split, so its dq path
    never allocates scratch: kv_splits is one at K4b's pretrain shape."""
    assert fa.split_scratch_shapes(8, 12, 128, 64, 2) == (
        (2, 8, 12, 128, 64), (2, 8, 12, 128))
    assert fa.split_scratch_shapes(16, 12, 128, 64, 1) is None
    shapes = fa.split_scratch_shapes(4, 12, 100, 128, 3)
    assert 4 * np.prod(shapes[0]) == 3 * 4 * 12 * 100 * 128 * 4
    assert fa.split_scratch_shapes(
        16, 12, 128, 64, fa.kv_splits(16, 12, 128, 1570)) is None


def test_merge_of_empty_shares_gives_zero_and_minus_inf():
    o_part = torch.randn(3, 1, 1, 2, 4)
    lse_part = torch.full((3, 1, 1, 2), float("-inf"))
    lse_part[1, ..., 0] = 0.5  # row 0 has one live share, row 1 none
    o, lse = merge_plain(o_part, lse_part)
    torch.testing.assert_close(o[..., 0, :], o_part[1, ..., 0, :])
    assert lse[..., 0].item() == 0.5 and lse[..., 1].item() == float("-inf")
    assert not o[..., 1, :].any()


@pytest.mark.parametrize("sq,sk,d,kv_len,splits", [
    (70, 200, 64, 150, 3),     # ragged Sk, kv_len < Sk, empty last share
    (128, 330, 64, None, 2),   # ragged Sk
    (64, 300, 128, 260, 2),    # head dim 128
    (100, 330, 80, 300, 3),    # head dim 80 (the 2.7B decoder's heads)
])
def test_split_merge_matches_plain_and_pallas_head_major(sq, sk, d, kv_len,
                                                         splits):
    rng = np.random.default_rng(sq + sk)
    b, h = 2, 2
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_o, got_lse = split_plain(tq, tk, tv, splits, scale=scale,
                                 kv_len=kv_len)
    want_o, want_lse = fa.flash_fwd_plain(tq, tk, tv, scale=scale,
                                          kv_len=kv_len)
    _close(got_o, want_o, MERGE_TOL)
    _close(got_lse, want_lse, MERGE_TOL)
    with _interpret():
        jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale=scale, causal=False, kv_len=kv_len,
                            block_q=sq, block_k=sk)
    _close(got_o, jo, TOL)
    _close(got_lse, np.asarray(jlse)[..., 0], TOL)


def _packed_lse(jlse, n):
    """Pallas packed lse [B, n/g, Sq, g] -> [B, n, Sq]."""
    b, strips, sq, g = jlse.shape
    return np.asarray(jlse).transpose(0, 1, 3, 2).reshape(b, n, sq)


@pytest.mark.parametrize("s,n,d,causal,period,alibi,splits", [
    (150, 2, 64, True, 0, False, 3),     # causal, ragged
    (112, 2, 64, False, 8, False, 2),    # grouped temporal, period 8
    (100, 2, 128, True, 0, True, 2),     # Bloom: ALiBi, head dim 128
    (197, 2, 64, False, 0, False, 4),    # vision spatial, ragged
])
def test_split_merge_matches_plain_and_pallas_packed(s, n, d, causal, period,
                                                     alibi, splits):
    rng = np.random.default_rng(s + d)
    b = 2
    q, k, v = (rng.normal(size=(b, s, n * d)).astype(np.float32)
               for _ in range(3))
    slopes = alibi_slopes(n) if alibi else None
    scale = d ** -0.5
    heads = [torch.from_numpy(a).unflatten(-1, (n, d)).transpose(1, 2)
             for a in (q, k, v)]
    kw = dict(scale=scale, causal=causal, period=period,
              alibi_slopes=None if slopes is None
              else torch.from_numpy(slopes))
    got_o, got_lse = split_plain(*heads, splits, **kw)
    want_o, want_lse = fa.flash_fwd_plain(*heads, **kw)
    _close(got_o, want_o, MERGE_TOL)
    _close(got_lse, want_lse, MERGE_TOL)
    with _interpret():
        jo, jlse = jfa._fwd_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n, scale=scale,
            causal=causal, period=period, block_q=s, block_k=s,
            alibi_slopes=None if slopes is None
            else tuple(float(x) for x in slopes))
    _close(got_o.transpose(1, 2).reshape(b, s, n * d), jo, TOL)
    _close(got_lse, _packed_lse(jlse, n), TOL)


# ---------------------------------------------------------------------------
# on the card: the split kernels against their plain versions, in bf16
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,kv_len", [
    (8, 128, 1570, None),    # K4 while serving: two splits
    (4, 100, 1000, 900),     # ragged Sq, kv_len < Sk: three splits
    (1, 64, 4096, 4000),     # fifteen splits (63 live key tiles)
    (16, 128, 1570, None),   # K4 / K4b in the pretrain step: one split
])
def test_cuda_split_kernels_match_plain(cuda_device, b, sq, sk, kv_len):
    """The split forward (o elementwise within four bf16 ulps, lse within
    1e-3) and the backward after it (relative L2 2^-7) on head views of
    [B, S, 12x64] projections, as AttentionPool makes them."""
    g = torch.Generator(device=cuda_device).manual_seed(sk)

    def heads(s):
        return torch.randn(b, s, 12 * 64, generator=g, device=cuda_device
                           ).to(torch.bfloat16).unflatten(-1, (12, 64)
                                                          ).transpose(1, 2)

    q, k, v = heads(sq), heads(sk), heads(sk)
    kw = dict(scale=0.125, kv_len=kv_len)
    assert fa.kv_splits(b, 12, sq, sk, kv_len=kv_len) == (
        {8: 2, 4: 3, 1: 15, 16: 1}[b])
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2.0 ** -6,
                               rtol=2.0 ** -6)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    do = heads(sq)
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        rel = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert rel <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,kv_len,gapped", [
    (1, 32, 100, 1000, 900, False),  # three splits at the 2.7B's heads
    (4, 8, 128, 1570, None, False),  # AttentionPool-like keys, six splits
    (2, 8, 208, 1570, None, True),   # a ragged query tail, six splits
    (1, 8, 128, 3138, None, True),   # 3138 keys, twelve splits
    (2, 4, 100, 1570, 1400, True),   # kv_len < Sk over ragged keys
])
def test_cuda_split_kernels_d80_match_plain(cuda_device, b, h, sq, sk,
                                            kv_len, gapped):
    """The split forward at head dim 80 (the merge kernel's lanes take
    columns l, l + 32 and, for lanes 0-15, l + 64): o within four bf16
    ulps, lse within 1e-3, and the d80 forward counter up by one; with
    ``gapped`` the merge writes the even heads of a NaN-filled packed
    [B, S, 2h*80] buffer and leaves the odd heads untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(sk + 80)

    def heads(s):
        return torch.randn(b, s, h * 80, generator=g, device=cuda_device
                           ).to(torch.bfloat16).unflatten(-1, (h, 80)
                                                          ).transpose(1, 2)

    q, k, v = heads(sq), heads(sk), heads(sk)
    assert fa.kv_splits(b, h, sq, sk, head_dim=80, kv_len=kv_len,
                        sms=fa._device_sms(q.device.index)) >= 2
    before = fa.flash_attention.d80_launches
    got = fa.flash_attention(q, k, v, kv_len=kv_len)
    buf = torch.full((b, sq, 2 * h, 80), float("nan"), dtype=q.dtype,
                     device=cuda_device)
    o = buf[:, :, 0::2].transpose(1, 2) if gapped else torch.empty_like(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, scale=80 ** -0.5, kv_len=kv_len)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, scale=80 ** -0.5,
                                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention.d80_launches == before + 1
    for out in (got, o):
        torch.testing.assert_close(out.float(), want_o.float(),
                                   atol=2.0 ** -6, rtol=2.0 ** -6)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    assert not gapped or torch.isnan(buf[:, :, 1::2]).all()


@pytest.mark.cuda
def test_cuda_fwd_blocks_per_sm_match_the_wave_table(cuda_device):
    """kv_splits sizes its wave from FWD_BLOCKS_PER_SM: the card's own
    count of resident forward blocks (cudaOccupancyMaxActiveBlocksPer
    Multiprocessor at each build's threads and shared memory) agrees, with
    and without ALiBi where both are built."""
    for d, want in fa.FWD_BLOCKS_PER_SM.items():
        assert fa.fwd_blocks_per_sm(d) == want, d
        if d in fa.ALIBI_HEAD_DIMS:
            assert fa.fwd_blocks_per_sm(d, alibi=True) >= 1
