"""The GPT-3 decoder's attention dispatch in the port against the JAX
package's rule, and a head-dim-80 decoder (the 2.7B's head width) against
the JAX ``GPT3LM`` at fp32.

The rule (JAX ``models/gpt3.py:245-247``, :281-284, :328-337 and
``ops/attention.py:99-103``): a cacheless pass without attention dropout
takes the packed flash kernel (K1) where ``packed_supported(n, d)``
holds, else ``dot_product_attention``, which takes the head-major flash
kernel (K4) at S >= 128 and ``mha_reference`` below; under attention
dropout it takes ``mha_reference``.  With a cache, a chunk (prefill)
runs plain attention over the layer, one token the decode kernel (K5,
with its row write) where the cache width is a multiple of 64.  The
expected route is derived from the JAX package's own
``packed_supported`` and ``decode_attention_supported``; the port's
route is read by spies on its functions, which call through.

The tiny decoder (4 heads of 80, 2 layers) takes the same numpy weights
as JAX through ``bridge.py``: the cacheless forward at S = 208 (the
port's K4 route, its plain version on the CPU; JAX's ``mha_reference``
on the CPU), prefill plus 3 decode steps, and a beam-3 generation.
Tolerance 1e-4 at fp32, as in tests/test_torch_gpt3.py.
"""

import contextlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import generation as jgen
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.ops import decode_attention as jdec
from youku_mplug_tpu.ops import flash_attention as jfa
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import generation as tgen
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.ops import attention as tatt
from youku_mplug_tpu_torch.ops import flash_attention as tfa
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
EOS = 2
FLASH_MIN_ROWS = 128  # JAX ops/attention.py:103: one 128-row query block


def jax_route(n, d, s, dropout, cache):
    """The attention JAX runs for one GPT3Attention call: cacheless with
    S tokens (``cache`` None), or with a cache of width ``cache`` fed S
    tokens."""
    if cache is not None:
        return ("decode" if s == 1 and jdec.decode_attention_supported(cache)
                else "prefill")
    if dropout:
        return "reference+dropout"
    if jfa.packed_supported(n, d):
        return "packed"
    return "flash" if s >= FLASH_MIN_ROWS else "reference"


@contextlib.contextmanager
def spied_routes():
    """Record each attention route the port's GPT3Attention takes, calling
    the real functions."""
    routes = []

    def spy(fn, name):
        def call(*a, **kw):
            rate = kw.get("dropout_rate", 0.0)
            routes.append(name + ("+dropout" if rate > 0 else ""))
            return fn(*a, **kw)
        return call

    patches = (
        mock.patch.object(tgpt3, "flash_attention_packed",
                          spy(tgpt3.flash_attention_packed, "packed")),
        mock.patch.object(tfa, "flash_attention",
                          spy(tfa.flash_attention, "flash")),
        # dot_product_attention's plain route
        mock.patch.object(tatt, "mha_reference",
                          spy(tatt.mha_reference, "reference")),
        # the cache branch: prefill's plain attention, the decode kernel
        mock.patch.object(tgpt3, "mha_reference",
                          spy(tgpt3.mha_reference, "prefill")),
        mock.patch.object(tgpt3, "write_decode_attention",
                          spy(tgpt3.write_decode_attention, "decode")))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield routes


HEADS = [(4, 16), (32, 64), (32, 80), (8, 96), (32, 128)]


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("s", [80, 128, 208])
@pytest.mark.parametrize("n,d", HEADS)
def test_attention_route_follows_jax(n, d, s, dropout, cache):
    """GPT3Attention's route for every (n, d, S, dropout, cache) against
    the JAX rule; with a cache, a prefill of S tokens then one decode
    step (the decoder draws no dropout with a cache; ``drop`` is passed
    all the same and changes nothing)."""
    cfg = tgpt3.GPT3Config(vocab_size=64, hidden_size=n * d,
                           num_hidden_layers=1, num_attention_heads=n,
                           max_position_embeddings=512)
    attn = tgpt3.GPT3Attention(cfg, 1, torch.float32)
    for p in attn.parameters():
        p.data.normal_(0, 0.02, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, s, n * d, generator=torch.Generator().manual_seed(1))
    drop = (tgpt3.Dropout(torch.Generator().manual_seed(2), 0.1, 0.1)
            if dropout else None)
    if not cache:
        with spied_routes() as routes:
            out = attn(x, 0, drop=drop)
        assert routes == [jax_route(n, d, s, dropout, None)]
        assert out.shape == x.shape and torch.isfinite(out).all()
        return
    kv = torch.zeros(1, 1, 384, 2 * n * d)
    with spied_routes() as routes:
        attn(x, 0, cache=kv, cache_len=0, drop=drop)
        out = attn(x[:, :1], 0, cache=kv, cache_len=s, drop=drop)
    assert routes == [jax_route(n, d, s, dropout, kv.shape[2]),
                      jax_route(n, d, 1, dropout, kv.shape[2])]
    assert routes == ["prefill", "decode"]
    assert torch.isfinite(out).all()


def test_route_rule_at_the_decoders_geometries():
    """The rule's answers at the shipped decoders: the 1.3B (32 x 64)
    stays packed, the 2.7B (32 x 80) takes K4 at its 208-position passes
    and plain attention at the retrieval text tower's 80 tokens."""
    assert jax_route(32, 64, 208, False, None) == "packed"
    assert jax_route(32, 80, 208, False, None) == "flash"
    assert jax_route(32, 80, 80, False, None) == "reference"
    assert tfa.packed_supported(32, 80) == jfa.packed_supported(32, 80)
    for n, d in HEADS:
        assert tfa.packed_supported(n, d) == jfa.packed_supported(n, d)


# ---------------------------------------------------------------------------
# a head-dim-80 decoder against the JAX GPT3LM
# ---------------------------------------------------------------------------


def _d80_models(seed):
    """JAX and port GPT-3 decoders of 2 layers, 4 heads of 80, on the same
    numpy weights (redrawn at std 0.2, layernorm scales near 1)."""
    kw = dict(vocab_size=256, hidden_size=320, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=512,
              hidden_dropout=0.0, attention_dropout=0.0)
    jlm = jgpt3.GPT3LM(jgpt3.GPT3Config(**kw), policy=J_FP32)
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else 0.2 * z
    params = jax.tree.map(np.asarray,
                          jax.tree_util.tree_map_with_path(leaf, shapes))
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(tgpt3.GPT3Config(**kw), FP32_POLICY), params)
    return jlm, params, tlm.eval()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_d80_forward_at_208_matches_jax():
    """The cacheless forward at S = 208: the port through K4's wrapper (its
    plain version here), JAX through mha_reference."""
    jlm, params, tlm = _d80_models(0)
    tokens = np.random.default_rng(1).integers(3, 256, size=(2, 208))
    want = jlm.apply({"params": params}, jnp.asarray(tokens, jnp.int32),
                     return_logits=True)
    with spied_routes() as routes:
        got = tlm(tokens=torch.from_numpy(tokens))
    assert routes == ["flash"] * 2
    _close(got["last_hidden_state"], want["last_hidden_state"])
    _close(tlm.logits(got["last_hidden_state"]), want["logits"])


def test_d80_prefill_then_decode_matches_jax():
    """Prefill of 208 positions at row 0, then 3 decode steps at
    per-sample positions, teacher-forced with JAX's tokens: logits and
    the cache after each step."""
    jlm, params, tlm = _d80_models(1)
    rng = np.random.default_rng(2)
    b, s = 2, 208
    embeds = rng.normal(size=(b, s, 320)).astype(np.float32)
    vf = np.array([0, 5], np.int32)
    step = jax.jit(lambda p_, e, c, cl, v: jlm.apply(
        {"params": p_}, e, c, cl, v, method=jgpt3.GPT3LM.decode_step))
    jcache = jlm.apply({"params": params}, b, s + 4,
                       method=jgpt3.GPT3LM.init_cache)
    tcache = tlm.init_cache(b, s + 4)
    assert tuple(tcache.shape) == jcache.shape == (2, b, 256, 640)
    jl, jcache = step(params, jnp.asarray(embeds), jcache, jnp.int32(0),
                      jnp.asarray(vf))
    with spied_routes() as routes:
        tl, tcache = tlm.decode_step(torch.from_numpy(embeds), tcache, 0,
                                     torch.from_numpy(vf))
    assert routes == ["prefill"] * 2
    _close(tl, jl)
    _close(tcache, jcache)
    cache_len = np.array([s, s], np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        emb = jlm.apply({"params": params}, jnp.asarray(tok)[:, None],
                        method=jgpt3.GPT3LM.embed)
        jl, jcache = step(params, emb, jcache, jnp.asarray(cache_len),
                          jnp.asarray(vf))
        with spied_routes() as routes:
            tl, tcache = tlm.decode_step(
                tlm.embed(torch.from_numpy(tok)[:, None].long()), tcache,
                torch.from_numpy(cache_len), torch.from_numpy(vf))
        assert routes == ["decode"] * 2
        _close(tl, jl)
        _close(tcache, jcache)
        cache_len += 1
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_d80_beam_search_matches_jax():
    """A beam-3 generation of 6 new tokens after ragged prompts and 4
    query embeddings: sequences equal, beam scores within 1e-4."""
    jlm, params, tlm = _d80_models(3)
    rng = np.random.default_rng(4)
    b, p = 3, 6
    ids = rng.integers(3, 256, size=(b, p)).astype(np.int32)
    plen = np.array([p, 3, 1], np.int32)
    ids = np.where(np.arange(p)[None] < plen[:, None], ids, EOS)
    qe = rng.normal(size=(b, 4, 320)).astype(np.float32)
    cfg = jgen.GenerationConfig(max_new_tokens=6, eos_id=EOS, pad_id=EOS,
                                beam_size=3)
    want = jgen.generate(jlm, params, jnp.asarray(ids), jnp.asarray(plen),
                         query_embeds=jnp.asarray(qe), config=cfg)
    got = tgen.generate(tlm, torch.from_numpy(ids), torch.from_numpy(plen),
                        query_embeds=torch.from_numpy(qe), config=cfg)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    _close(got["scores"].numpy(), np.asarray(want["scores"]))
    assert got["decode_steps"] == 5
