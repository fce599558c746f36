"""The port's GPT-3 decode path (youku_mplug_tpu_torch.models.gpt3)
against the JAX package at fp32 on the tiny flagship config, weights
through the bridge.

Covers prefill (front-padded [pad | queries | prompt] chunk written at
row 0, valid_from and the clamped position offset) and decode (per-sample
cache_len, new row written before attention, inclusive mask bounds), the
cache contents ([K | V] rows straight from the qkv projection) and the
fp32 logits.  Tolerance 1e-4 (fp32; parameters redrawn at std 0.2 so
every bias and layer matters).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models.generation import _build_prefix as j_prefix
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models.generation import _build_prefix as t_prefix
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
PAD = 2


def redraw(tree, rng, std=0.2):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _models(rng):
    cfg = _flagship_cfg(tiny=True).text
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    params = redraw(shapes, rng)
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), params)
    return jlm, params, tlm


def test_prefill_then_decode_matches_jax():
    rng = np.random.default_rng(0)
    jlm, params, tlm = _models(rng)
    b, p, nq, h = 3, 8, 4, 64
    prompt = rng.integers(3, 256, size=(b, p)).astype(np.int32)
    plen = np.array([8, 5, 1], np.int32)
    qe = rng.normal(size=(b, nq, h)).astype(np.float32)

    variables = {"params": params}
    embeds, vf, po = j_prefix(jlm, params, jnp.asarray(prompt),
                              jnp.asarray(plen), jnp.asarray(qe), PAD)
    t_embeds, t_vf, t_po = t_prefix(tlm, _t(prompt).long(), _t(plen),
                                    _t(qe), PAD)
    _close(t_embeds, embeds, 0)
    assert t_vf.tolist() == list(np.asarray(vf)) == [0, 3, 7]

    step = jax.jit(lambda p_, e, c, cl, v, o: jlm.apply(
        {"params": p_}, e, c, cl, v, o, method=jgpt3.GPT3LM.decode_step))
    jcache = jlm.apply(variables, b, 20, method=jgpt3.GPT3LM.init_cache)
    tcache = tlm.init_cache(b, 20)
    assert tuple(tcache.shape) == jcache.shape == (2, b, 128, 128)

    # prefill: scalar cache_len 0 (rows 0 .. nq+p-1 of every sample)
    jl, jcache = step(params, embeds, jcache, jnp.int32(0), vf, po)
    tl, tcache = tlm.decode_step(t_embeds, tcache, 0, t_vf, t_po)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    _close(tcache, jcache)

    # decode: per-sample cache_len; teacher-forced with JAX's choices
    cache_len = np.full((b,), nq + p, np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        emb = jlm.apply(variables, jnp.asarray(tok)[:, None],
                        method=jgpt3.GPT3LM.embed)
        jl, jcache = step(params, emb, jcache, jnp.asarray(cache_len), vf, po)
        t_emb = tlm.embed(_t(tok)[:, None].long())
        tl, tcache = tlm.decode_step(t_emb, tcache, _t(cache_len), t_vf,
                                     t_po)
        _close(tl, jl)
        _close(tcache, jcache)
        cache_len += 1
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_layer_with_cache_matches_jax():
    """One GPT3Layer (attention + MLP) with its cache: a prefill chunk at
    row 0, then a decode row at per-sample positions."""
    rng = np.random.default_rng(1)
    cfg = _flagship_cfg(tiny=True).text
    jlayer = jgpt3.GPT3Layer(cfg, policy=J_FP32)
    b, m, s, h = 2, 16, 5, cfg.hidden_size
    x = rng.normal(size=(b, s, h)).astype(np.float32)
    cache = np.zeros((b, m, 2 * h), np.float32)
    vf = np.array([0, 2], np.int32)
    shapes = jax.eval_shape(lambda: jlayer.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(cache), 0,
        jnp.asarray(vf)))["params"]
    params = redraw(shapes, rng)
    stacked = jax.tree.map(lambda a: a[None], params)
    tlayer = bridge.load_jax_params(
        tgpt3.GPT3Layer(flagship_config(tiny=True).text, 1, torch.float32),
        stacked)
    tcache = _t(cache)[None]

    run = jax.jit(lambda p_, x_, c, cl, v: jlayer.apply(
        {"params": p_}, x_, c, cl, v))
    jy, jc = run(params, jnp.asarray(x), jnp.asarray(cache), 0,
                 jnp.asarray(vf))
    ty = tlayer(_t(x), 0, tcache, 0, _t(vf))
    _close(ty, jy)
    _close(tcache[0], jc)
    # the cache row is the [K | V] half of the qkv projection
    x1 = rng.normal(size=(b, 1, h)).astype(np.float32)
    cl = np.array([5, 9], np.int32)
    jy, jc = run(params, jnp.asarray(x1), jc, jnp.asarray(cl),
                 jnp.asarray(vf))
    ty = tlayer(_t(x1), 0, tcache, _t(cl), _t(vf))
    _close(ty, jy)
    _close(tcache[0], jc)


def test_tied_logits_are_fp32_of_bf16_products():
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    hid = rng.normal(size=(3, 16)).astype(np.float32)
    te = tgpt3.TiedEmbedding(50, 16, torch.float32)
    te.embedding.data.copy_(_t(emb))
    got = te.attend(_t(hid).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want = jnp.einsum("bh,vh->bv", jnp.asarray(hid, jnp.bfloat16),
                      jnp.asarray(emb, jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    _close(got, want, 1e-5)


def test_config_from_json_matches_jax():
    path = "configs/models/config_gpt3_1.3B.json"
    j, t = jgpt3.GPT3Config.from_json_file(path), \
        tgpt3.GPT3Config.from_json_file(path)
    for f in ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers",
              "num_attention_heads", "max_position_embeddings",
              "layernorm_epsilon", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f


def test_config_keeps_dropout_from_json():
    """The JSON's hidden/attention dropout (0.1 for 1.3B) and init std are
    read as the JAX package reads them, not dropped."""
    path = "configs/models/config_gpt3_1.3B.json"
    j, t = jgpt3.GPT3Config.from_json_file(path), \
        tgpt3.GPT3Config.from_json_file(path)
    for f in ("hidden_dropout", "attention_dropout", "init_method_std",
              "remat", "ce_chunk"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.hidden_dropout, t.attention_dropout) == (0.1, 0.1)


def test_training_with_dropout_raises_until_it_is_ported():
    """Dropout is ported (tests/test_torch_dropout.py holds its law): a
    training forward at the 0.1 default draws masks from the generator it
    is given and differs from the eval forward; without a generator, or
    in eval mode, it draws nothing and equals the eval forward."""
    cfg = tgpt3.GPT3Config(vocab_size=32, hidden_size=16,
                           num_hidden_layers=1, num_attention_heads=2,
                           max_position_embeddings=16)
    lm = bridge.seeded_init(tgpt3.GPT3LM(cfg, FP32_POLICY), 0)
    tokens = torch.zeros(1, 4, dtype=torch.long)
    want = lm.eval()(tokens=tokens)["last_hidden_state"]
    assert want.shape == (1, 4, 16)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert torch.equal(lm.eval()(tokens=tokens, generator=gen)[
        "last_hidden_state"], want)
    assert torch.equal(lm.train()(tokens=tokens)["last_hidden_state"], want)
    assert torch.equal(gen.get_state(), state)  # nothing drawn
    got = lm.train()(tokens=tokens, generator=gen)["last_hidden_state"]
    assert not torch.equal(got, want)
    assert not torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("remat,ce_chunk", [(False, 0), (True, 4)])
def test_lm_forward_loss_and_input_grads_match_jax(remat, ce_chunk):
    """The no-cache training forward: hidden states, per-position losses,
    the masked mean over losses[:, :-1], and the gradient that flows
    through the frozen decoder to the input embeddings.  Padded positions
    stay keys (only the loss mask drops them)."""
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(_flagship_cfg(tiny=True).text, remat=remat,
                              ce_chunk=ce_chunk)
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    params = redraw(shapes, rng)
    tcfg = dataclasses.replace(flagship_config(tiny=True).text, remat=remat,
                               ce_chunk=ce_chunk)
    tlm = bridge.load_jax_params(tgpt3.GPT3LM(tcfg, FP32_POLICY), params)
    b, s, h = 2, 12, cfg.hidden_size
    emb = rng.normal(size=(b, s, h)).astype(np.float32)
    labels = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s - 1), np.int32)
    mask[1, 6:] = 0

    def jfn(e):
        out = jlm.apply({"params": params}, input_embeds=e,
                        labels=jnp.asarray(labels),
                        loss_mask=jnp.asarray(mask))
        return out["loss"], out
    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(emb))
    leaf = _t(emb).requires_grad_()
    out = tlm(input_embeds=leaf, labels=_t(labels).long(),
              loss_mask=_t(mask))
    out["loss"].backward()
    for key in ("last_hidden_state", "losses", "loss"):
        _close(out[key].detach(), jout[key])
    _close(leaf.grad, jgrad)
    assert all(p.grad is None for p in tlm.parameters())  # frozen
    # a padded position still changes later positions' hidden states
    emb2 = emb.copy()
    emb2[1, 8] += 1.0
    out2 = tlm(input_embeds=_t(emb2))["last_hidden_state"]
    assert not torch.allclose(out2[1, 9:], out["last_hidden_state"][1, 9:])


# ---------------------------------------------------------------------------
# int8 serving: int8 decoder weights and an int8 cache
# ---------------------------------------------------------------------------


def _int8_models(rng, include_embedding=True):
    """The tiny decoder with kv_cache_dtype int8, its tree quantized by the
    JAX function and loaded with its qscales."""
    from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder

    cfg = dataclasses.replace(_flagship_cfg(tiny=True).text,
                              kv_cache_dtype="int8")
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    q, scales = quantize_gpt3_decoder(redraw(shapes, rng), include_embedding)
    tcfg = dataclasses.replace(flagship_config(tiny=True).text,
                               kv_cache_dtype="int8")
    tlm = bridge.load_jax_params(tgpt3.GPT3LM(tcfg, FP32_POLICY),
                                 jax.device_get(q),
                                 qscales=jax.device_get(scales))
    return jlm, {"params": q, "qscales": scales}, tlm


def _dequant_cache(cache, n):
    """Both forms of an int8 cache as fp32 [L, B, M, 2*hidden] rows."""
    if isinstance(cache, dict) and isinstance(cache["kv"], torch.Tensor):
        from youku_mplug_tpu_torch.ops import kv_cache as tkv

        return tkv.dequantize_rows(cache["kv"], cache["scale"], n,
                                   torch.float32).numpy()
    from youku_mplug_tpu.ops import kv_cache as jkv

    return np.asarray(jkv.dequantize_rows(cache["kv"], cache["scale"], n,
                                          jnp.float32))


def test_int8_prefill_then_decode_matches_jax():
    """int8 kernels, int8 tied embedding and an int8 cache: prefill (the
    layer read back dequantized) and three decode steps (per-sample rows
    through the plain fused write, the plain int8 decode attention)
    against JAX's decode_step with the qscales collection."""
    rng = np.random.default_rng(4)
    jlm, jvars, tlm = _int8_models(rng)
    assert tlm.decoder.layers.attn.qkv_kernel.dtype == torch.int8
    assert tlm.word_embeddings.embedding.dtype == torch.int8
    n = tlm.cfg.num_attention_heads
    b, p, nq, h = 3, 8, 4, 64
    prompt = rng.integers(3, 256, size=(b, p)).astype(np.int32)
    plen = np.array([8, 5, 1], np.int32)
    qe = rng.normal(size=(b, nq, h)).astype(np.float32)
    embeds, vf, po = j_prefix(jlm, jvars, jnp.asarray(prompt),
                              jnp.asarray(plen), jnp.asarray(qe), PAD)
    t_embeds, t_vf, t_po = t_prefix(tlm, _t(prompt).long(), _t(plen),
                                    _t(qe), PAD)
    _close(t_embeds, embeds)  # int8 rows dequantized on lookup

    step = jax.jit(lambda v_, e, c, cl, vf_, o: jlm.apply(
        v_, e, c, cl, vf_, o, method=jgpt3.GPT3LM.decode_step))
    jcache = jlm.apply(jvars, b, 20, method=jgpt3.GPT3LM.init_cache)
    tcache = tlm.init_cache(b, 20)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jl, jcache = step(jvars, embeds, jcache, jnp.int32(0), vf, po)
    tl, tcache = tlm.decode_step(t_embeds, tcache, 0, t_vf, t_po)
    _close(tl, jl)
    _close(_dequant_cache(tcache, n), _dequant_cache(jcache, n))
    cache_len = np.full((b,), nq + p, np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        emb = jlm.apply(jvars, jnp.asarray(tok)[:, None],
                        method=jgpt3.GPT3LM.embed)
        jl, jcache = step(jvars, emb, jcache, jnp.asarray(cache_len), vf, po)
        t_emb = tlm.embed(_t(tok)[:, None].long())
        tl, tcache = tlm.decode_step(t_emb, tcache, _t(cache_len), t_vf,
                                     t_po)
        _close(tl, jl)
        _close(_dequant_cache(tcache, n), _dequant_cache(jcache, n))
        cache_len += 1
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("include_embedding", [False, True])
def test_quantize_gpt3_decoder_tree_and_module_match_jax(include_embedding):
    """The tree function equals JAX's (int8 leaves exact, scales in JAX's
    shapes); quantizing the loaded float module in place gives the same
    int8 parameters and scale buffers, and decoder_bytes counts both."""
    from youku_mplug_tpu.ops import quant as jquant
    from youku_mplug_tpu_torch.ops import quant as tquant

    rng = np.random.default_rng(5)
    _, params, tlm = _models(rng)
    jq, js = jquant.quantize_gpt3_decoder(params, include_embedding)
    tq, ts = tquant.quantize_gpt3_decoder(params, include_embedding)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jq))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tq))
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v))
        assert str(tflat[k].dtype).removeprefix("torch.") == str(v.dtype)
    sflat = dict(jax.tree_util.tree_leaves_with_path(ts))
    assert set(sflat) == set(dict(jax.tree_util.tree_leaves_with_path(js)))
    for k, v in jax.tree_util.tree_leaves_with_path(js):
        np.testing.assert_array_equal(sflat[k].numpy(), np.asarray(v))

    float_bytes = tquant.decoder_bytes(tlm)
    tquant.quantize_decoder_(tlm, include_embedding)
    params_t = dict(tlm.named_parameters())
    for k, v in jax.tree_util.tree_leaves_with_path(jq):
        name = bridge.port_name("/".join(p.key for p in k))
        np.testing.assert_array_equal(params_t[name].detach().numpy(),
                                      np.asarray(v))
    owner_scales = {n.removesuffix(tquant.SCALE_SUFFIX): b
                    for n, b in tlm.named_buffers()
                    if n.endswith(tquant.SCALE_SUFFIX)}
    assert len(owner_scales) == len(sflat) == 4 + include_embedding
    for k, v in jax.tree_util.tree_leaves_with_path(js):
        name = bridge.port_name("/".join(p.key for p in k))
        np.testing.assert_array_equal(owner_scales[name].numpy(),
                                      np.asarray(v))
    assert tquant.decoder_bytes(tlm) == jquant.decoder_bytes(jq) \
        + jquant.decoder_bytes(js)
    assert tquant.decoder_bytes(tlm) < (0.4 if include_embedding else 0.5) \
        * float_bytes  # fp32 position embeddings and biases stay
    with pytest.raises(TypeError, match="quantize after"):
        bridge.seeded_init(tlm, 0)
    with pytest.raises(ValueError, match="int8 already"):
        tquant.quantize_decoder_(tlm, include_embedding)


def test_int8_bridge_is_strict():
    """An int8 leaf without its scale, a scale for a float leaf or of the
    wrong shape, and a scale naming no parameter all raise."""
    from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder

    rng = np.random.default_rng(6)
    _, params, _ = _models(rng)
    q, scales = jax.device_get(quantize_gpt3_decoder(params))

    def fresh():
        return tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY)

    with pytest.raises(TypeError, match="without qscales"):
        bridge.load_jax_params(fresh(), q)
    bad = jax.tree.map(lambda a: a, scales)
    bad["word_embeddings"] = {"embedding": np.ones((256, 1), np.float32)}
    with pytest.raises(TypeError, match="not int8"):
        bridge.load_jax_params(fresh(), q, qscales=bad)
    bad = jax.tree.map(lambda a: a, scales)
    bad["decoder"]["layers"]["mlp"]["fc1_kernel"] = np.ones((2, 64, 1),
                                                           np.float32)
    with pytest.raises(ValueError, match="scale shape"):
        bridge.load_jax_params(fresh(), q, qscales=bad)
    bad = jax.tree.map(lambda a: a, scales)
    bad["decoder"]["nowhere"] = np.ones((1,), np.float32)
    with pytest.raises(KeyError, match="no port parameter"):
        bridge.load_jax_params(fresh(), q, qscales=bad)


def test_int8_tied_embedding_matches_jax():
    """Per-row int8 table: lookups dequantize the gathered rows, the tied
    logits scale each vocab row's product, the training table
    dequantizes; all against JAX's TiedEmbedding with the qscales
    collection."""
    from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder
    from youku_mplug_tpu_torch.ops import quant

    rng = np.random.default_rng(7)
    emb = (rng.normal(size=(97, 32)) * np.linspace(0.1, 3.0, 97)[:, None]
           ).astype(np.float32)
    q, s = jax.device_get(quantize_gpt3_decoder(
        {"word_embeddings": {"embedding": emb}}, include_embedding=True))
    qe, se = q["word_embeddings"]["embedding"], s["word_embeddings"][
        "embedding"]
    jmod = jgpt3.TiedEmbedding(97, 32)
    jvars = {"params": {"embedding": qe}, "qscales": {"embedding": se}}
    tmod = tgpt3.TiedEmbedding(97, 32, torch.float32)
    tmod.embedding.data.copy_(_t(emb))
    quant.quantize_decoder_(tmod, include_embedding=True)
    assert tmod.embedding.dtype == torch.int8
    tokens = rng.integers(0, 97, (2, 5))
    hidden = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(tmod.encode(_t(tokens), torch.float32),
           jmod.apply(jvars, jnp.asarray(tokens), jnp.float32,
                      method=jgpt3.TiedEmbedding.encode), 1e-6)
    _close(tmod.attend(_t(hidden)),
           jmod.apply(jvars, jnp.asarray(hidden),
                      method=jgpt3.TiedEmbedding.attend), 1e-5)
    _close(tmod.table(torch.float32),
           jmod.apply(jvars, jnp.float32, method=jgpt3.TiedEmbedding.table),
           1e-6)
