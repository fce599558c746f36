"""The port's int8 KV cache (youku_mplug_tpu_torch.ops.kv_cache) and the
int8 form of decode attention against the JAX package.

Quantization must equal the JAX package's bit for bit (round half to
even, an IEEE division); the decode step's cache write (K6, folded into
the decode kernel K5), in its plain version, must equal JAX's cache_write
and the Pallas scatter kernel run in interpret mode exactly; the plain
int8 decode attention is held against the Pallas kernel in interpret
mode with ``kv_scales`` at 1e-4 (fp32 on both sides; the kernel
dequantizes per block, the plain version first).  The fused kernel's
tests on the card are in test_torch_ops.py.
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
from youku_mplug_tpu.ops import kv_cache as jkv
from youku_mplug_tpu_torch.ops import kv_cache as tkv
from youku_mplug_tpu_torch.ops.decode_attention import (
    alibi_slopes,
    decode_attention_plain,
    write_decode_attention,
)

torch.set_num_threads(1)
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,ties", [(4, 32, False), (2, 64, True),
                                      (32, 128, False), (3, 8, True)])
def test_quantize_rows_equal_jax(n, d, ties):
    """int8 rows and scales bit for bit, over magnitudes from 1e-3 to 1e2
    and (``ties``) values on a quarter grid, where x / scale lands on
    .5 for some heads; and the dequant."""
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(3, 5, 2 * n * d)) * 10.0 ** rng.uniform(
        -3, 2, size=(3, 5, 1))
    if ties:
        x = np.round(x * 4) / 4
        x[0, 0, :d] = np.arange(d) - d / 2  # amax d/2: many exact halves
    x = x.astype(np.float32)
    jq, js = jkv.quantize_rows(jnp.asarray(x), n)
    tq, ts = tkv.quantize_rows(_t(x), n)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_rows(tq, ts, n, torch.float32).numpy(),
        np.asarray(jkv.dequantize_rows(jq, js, n, jnp.float32)))


def test_make_cache_int8_layout_matches_jax():
    want = jkv.make_cache(3, 2, 128, 64, 4, jnp.float32, quantized=True)
    got = tkv.make_cache(3, 2, 128, 64, torch.float32, num_heads=4,
                         quantized=True)
    assert tkv.is_quantized(got) and jkv.is_quantized(want)
    for k in ("kv", "scale"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert not got[k].any()
    assert tkv.cache_width(got) == jkv.cache_width(want) == 128
    assert tkv.nbytes(got) == 3 * 2 * 128 * (128 + 4 * 8)
    with pytest.raises(ValueError, match="head count"):
        tkv.make_cache(1, 1, 8, 64, torch.float32, quantized=True)


@pytest.mark.parametrize("per_sample", [False, True])
def test_int8_cache_write_matches_jax(per_sample):
    """A chunk at a scalar index (prefill) and one row per sample at its
    own index (decode; the plain version of the fused kernel): both leaves
    equal JAX's cache_write, in place, the other rows untouched."""
    rng = np.random.default_rng(3 + per_sample)
    L, B, M, n, d, S = 3, 4, 16, 2, 8, 1 if per_sample else 5
    base = jkv.make_cache(L, B, M, n * d, n, jnp.float32, quantized=True)
    base = {"kv": jnp.asarray(rng.integers(-9, 9, (L, B, M, 2 * n * d)),
                              jnp.int8),
            "scale": jnp.asarray(rng.uniform(0.1, 1, (L, B, M, 2 * n)),
                                 jnp.float32)}
    kvp = (rng.normal(size=(B, S, 2 * n * d)) * 2).astype(np.float32)
    idx = np.array([0, 3, 15, 9], np.int32) if per_sample else 4
    want = jkv.cache_write(base, jnp.asarray(kvp), n,
                           jnp.asarray(idx) if per_sample else idx, lidx=1)
    got = {k: _t(v) for k, v in base.items()}
    ptrs = {k: v.data_ptr() for k, v in got.items()}
    out = tkv.cache_write(got, _t(kvp), _t(idx) if per_sample else idx, 1)
    assert out is got and {k: v.data_ptr() for k, v in got.items()} == ptrs
    for k in ("kv", "scale"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    layer = tkv.layer_dequant(tkv.layer_slice(got, 1), n, torch.float32)
    rows = layer[torch.arange(B)[:, None],
                 torch.as_tensor(idx).reshape(-1, 1) + torch.arange(S)]
    _close(rows, kvp, np.abs(kvp).max() / 254 + 1e-6)


def test_plain_scatter_write_equals_pallas_interpret():
    """K6: the write half of write_decode_attention on the CPU (its plain
    version) on float rows equals JAX's quantize_rows followed by the
    Pallas cache_scatter_write kernel in interpret mode, on both leaves,
    rows 0 and M-1 included; no kernel launch is counted."""
    rng = np.random.default_rng(7)
    L, B, M, n, d = 3, 4, 64, 4, 16
    W = 2 * n * d
    idx = np.array([0, 17, 63, 40], np.int32)
    rows = (rng.normal(size=(B, W)) * 3).astype(np.float32)
    bkv = rng.integers(-5, 5, (L, B, M, W)).astype(np.int8)
    bsc = rng.uniform(0.5, 2, (L, B, M, 2 * n)).astype(np.float32)
    rk, rs = jkv.quantize_rows(jnp.asarray(rows)[:, None], n)
    wk, ws = jkv.cache_scatter_write(
        jnp.asarray(bkv), rk[:, 0], jnp.asarray(idx), jnp.int32(2),
        csc=jnp.asarray(bsc), rows_sc=rs[:, 0], interpret=True)
    got = {"kv": _t(bkv), "scale": _t(bsc)}
    names = ("launches", "alibi_launches", "int8_launches",
             "int8_alibi_launches")
    before = [getattr(write_decode_attention, c) for c in names]
    q = torch.from_numpy(rng.normal(size=(B, n * d)).astype(np.float32))
    write_decode_attention(q, _t(rows[:, :n * d]), _t(rows[:, n * d:]), got,
                           n, 2, _t(idx))
    assert [getattr(write_decode_attention, c) for c in names] == before
    np.testing.assert_array_equal(got["kv"].numpy(), np.asarray(wk))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ws))
    changed = (got["kv"].numpy() != bkv).any(-1)
    assert set(zip(*np.nonzero(changed))) <= {(2, b, int(idx[b]))
                                              for b in range(B)}


def test_layer_and_slot_views_share_storage():
    cache = tkv.make_cache(2, 3, 8, 16, torch.float32, num_heads=2,
                           quantized=True)
    view = tkv.slot_view(cache, 1)
    assert tuple(view["kv"].shape) == (2, 1, 8, 32)
    tkv.cache_write(view, torch.ones(1, 2, 32), 3, 1)
    assert (cache["kv"][1, 1, 3:5] == 127).all()
    assert (cache["scale"][1, 1, 3:5] == np.float32(1 / 127)).all()
    assert cache["kv"][:, [0, 2]].abs().sum() == 0
    assert tkv.layer_slice(cache, 1)["kv"].data_ptr() == \
        cache["kv"][1].data_ptr()
    flat = torch.zeros(2, 3, 8, 32)
    assert tkv.slot_view(flat, 2).data_ptr() == flat[:, 2:3].data_ptr()
    layer = tkv.layer_slice(flat, 0)
    assert tkv.layer_dequant(layer, 2, torch.float32) is layer


def _int8_cache(rng, L, B, M, n, d):
    rows = (rng.normal(size=(L * B * M, 1, 2 * n * d)) * rng.uniform(
        0.1, 3, size=(L * B * M, 1, 1))).astype(np.float32)
    q, s = tkv.quantize_rows(_t(rows), n)  # JAX's bit for bit (above)
    return (q.numpy().reshape(L, B, M, 2 * n * d),
            s.numpy().reshape(L, B, M, 2 * n))


@pytest.mark.parametrize("d,alibi", [(32, False), (32, True), (64, False),
                                     (64, True), (128, False), (128, True),
                                     (80, False)])
def test_int8_decode_plain_matches_pallas_interpret(d, alibi):
    """K5 int8 (quantized=True): per-sample cache_len / valid_from, a
    single live key, and a slot with none (zeros); with and without the
    ALiBi ladder."""
    rng = np.random.default_rng(d + alibi)
    L, B, M, n = 2, 5, 128, 4
    ckv, scales = _int8_cache(rng, L, B, M, n, d)
    q = rng.normal(size=(B, n * d)).astype(np.float32)
    clen = np.array([5, 100, 127, 40, 3], np.int32)
    vfrom = np.array([0, 7, 64, 40, 9], np.int32)  # slot 4: no live key
    slopes = alibi_slopes(n) if alibi else None
    with mock.patch.object(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True)):
        want = jdec.decode_attention(
            jnp.asarray(q), jnp.asarray(ckv), n, jnp.int32(1),
            jnp.asarray(clen), jnp.asarray(vfrom), alibi_slopes=slopes,
            kv_scales=jnp.asarray(scales), interpret=True)
    kw = dict(alibi_slopes=slopes, kv_scales=_t(scales))
    got = decode_attention_plain(_t(q), _t(ckv), n, 1, _t(clen), _t(vfrom),
                                 **kw)
    _close(got, want)
    assert not got[4].any()
    # one live key: its dequantized V row
    v = ckv[1, 3, 40, n * d:].reshape(n, d) * scales[1, 3, 40, n:, None]
    _close(got[3], v.reshape(-1), 1e-6)
    # one step written through the plain write and read back: the new
    # key is sample 2's row 127 (M-1), dequantized on the way
    step = {"kv": _t(ckv.copy()), "scale": _t(scales.copy())}
    kv_new = rng.normal(size=(B, 2 * n * d)).astype(np.float32)
    write_decode_attention(_t(q), _t(kv_new[:, :n * d]),
                           _t(kv_new[:, n * d:]), step, n, 1, _t(clen),
                           _t(vfrom), alibi_slopes=slopes)
    rq, rs = tkv.quantize_rows(_t(kv_new)[:, None], n)
    assert torch.equal(step["kv"][1, 2, 127], rq[2, 0])
    assert torch.equal(step["scale"][1, 2, 127], rs[2, 0])


def test_int8_decode_rejects_a_mismatched_cache():
    q = torch.zeros(2, 4 * 64)
    ckv = torch.zeros(1, 2, 8, 2 * 4 * 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        write_decode_attention(q, q, q, {"kv": ckv,
                                         "scale": torch.zeros(1, 2, 8, 4)},
                               4, 0, 3)
    with pytest.raises(ValueError, match="int8 cache"):
        write_decode_attention(q, q, q, {"kv": ckv.float(),
                                         "scale": torch.zeros(1, 2, 8, 8)},
                               4, 0, 3)


@pytest.mark.parametrize("d,alibi,layout", [(64, False, "packed"),
                                            (64, True, "head-major"),
                                            (128, True, "head-major"),
                                            (128, False, "packed"),
                                            (80, False, "packed")])
def test_int8_write_decode_plain_matches_jax_write_then_pallas(d, alibi,
                                                                layout):
    """K5 int8 with K6 folded in, plain (CPU): both cache leaves equal
    JAX's cache_write (quantize_rows, then the rows at cache_len[b]) but
    for the row past the cache (below), and the output equals the Pallas
    decode_attention (interpret mode, ``kv_scales``) on that cache; rows
    0, M-1 and >= M, a valid_from > 0 and a slot with no live key."""
    rng = np.random.default_rng(d + alibi)
    L, B, M, n = 2, 5, 128, 4
    ckv, scales = _int8_cache(rng, L, B, M, n, d)
    shape = (B, 3 * n * d) if layout == "packed" else (B, n, 3, d)
    qkv = (rng.normal(size=shape) * 2).astype(np.float32)
    views = ((qkv[:, :n * d], qkv[:, n * d:2 * n * d], qkv[:, 2 * n * d:])
             if layout == "packed"
             else (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))
    q, k, v = (np.ascontiguousarray(x).reshape(B, n * d) for x in views)
    clen = np.array([0, 100, 127, 130, 40], np.int32)
    vfrom = np.array([0, 7, 64, 9, 60], np.int32)  # slot 4: no live key
    base = {"kv": jnp.asarray(ckv), "scale": jnp.asarray(scales)}
    want_cache = jkv.cache_write(
        base, jnp.asarray(np.concatenate([k, v], -1))[:, None], n,
        jnp.asarray(clen), lidx=1)
    # Sample 3 writes row 130 >= M.  The port writes nothing there; JAX
    # does not define this write: XLA's dynamic_update_slice clamps it to
    # row M-1 and the Pallas scatter kernel (interpret mode) lands it in
    # the last aligned window.  The engine never sends it (a request stops
    # at max_len - 1), so the reference keeps sample 3's rows as they were.
    want_cache = {key: c.at[1, 3].set(base[key][1, 3])
                  for key, c in want_cache.items()}
    slopes = alibi_slopes(n) if alibi else None
    with mock.patch.object(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True)):
        want = jdec.decode_attention(
            jnp.asarray(q), want_cache["kv"], n, jnp.int32(1),
            jnp.asarray(clen), jnp.asarray(vfrom), alibi_slopes=slopes,
            kv_scales=want_cache["scale"], interpret=True)
    cache = {"kv": _t(ckv.copy()), "scale": _t(scales.copy())}
    tq = _t(qkv)
    tviews = ((tq[:, :n * d], tq[:, n * d:2 * n * d], tq[:, 2 * n * d:])
              if layout == "packed" else (tq[:, :, 0], tq[:, :, 1],
                                          tq[:, :, 2]))
    got = write_decode_attention(*tviews, cache, n, 1, _t(clen), _t(vfrom),
                                 alibi_slopes=slopes)
    for key in ("kv", "scale"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(want_cache[key]))
    _close(got, want)
    assert not got[4].any()


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, *shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
def test_cuda_int8_tied_logits_in_vocab_chunks(cuda_device):
    """The int8 tied logits on the card: bf16 x bf16 products of the
    table converted a vocab chunk at a time (three chunks, the last
    ragged), fp32 output, times each row's scale; equal to the fp32
    product of the same values up to the order of the sums."""
    from youku_mplug_tpu_torch.models.gpt3 import TiedEmbedding
    from youku_mplug_tpu_torch.ops import quant

    rng = np.random.default_rng(21)
    te = TiedEmbedding(70000, 64, torch.bfloat16).to(cuda_device)
    te.embedding.data.copy_(_bf16(rng, 70000, 64, device=cuda_device))
    quant.quantize_decoder_(te, include_embedding=True)
    hidden = _bf16(rng, 3, 64, device=cuda_device)
    got = te.attend(hidden)
    want = (hidden.float() @ te.embedding.float().t()) \
        * te.embedding_qscale.reshape(-1)
    assert got.dtype == torch.float32 and got.shape == (3, 70000)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
