"""The port's Bloom decoder (youku_mplug_tpu_torch.models.bloom) against
the JAX package at fp32 on the CPU, weights carried over by the bridge:
the ALiBi ladder, the config's JSON aliases, prefill + decode logits and
cache rows of ``BloomLM.decode_step`` (a power-of-two and a
non-power-of-two head count, whose slopes take the half-step ladder),
the serving engine's greedy tokens for requests submitted as pre-built
prompt embeddings, the no-cache training forward (hidden states, per-
position losses and the masked loss, with and without rank-2 LoRA on
all four projections) and ``merge_lora``.

Parameters are redrawn from numpy (std 0.2, LayerNorm scales near one)
so every bias and layer matters.  Tolerance 1e-4 (fp32, sums taken in
another order).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import bloom as jbloom
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.models.generation import _build_prefix as j_prefix
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import bloom as tbloom
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.generation import _build_prefix as t_prefix
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(1)
TOL = 1e-4
V, H, L = 97, 48, 2
EOS, PAD = 2, 3


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


def _models(rng, n_heads, lora_rank=0):
    """JAX and port Bloom LMs with the same redrawn weights (LoRA ``b``
    non-zero too)."""
    jcfg = jbloom.BloomConfig(vocab_size=V, hidden_size=H,
                              num_hidden_layers=L,
                              num_attention_heads=n_heads, attn_impl="xla",
                              decode_attn_impl="gather", lora_rank=lora_rank)
    jlm = jbloom.BloomLM(jcfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), tokens=jnp.zeros((1, 4), jnp.int32)))["params"],
        rng)
    tcfg = tbloom.BloomConfig(vocab_size=V, hidden_size=H,
                              num_hidden_layers=L,
                              num_attention_heads=n_heads,
                              lora_rank=lora_rank)
    tlm = bridge.load_jax_params(tbloom.BloomLM(tcfg, FP32_POLICY), params)
    return jlm, params, tlm


@pytest.mark.parametrize("n", [1, 4, 6, 8, 12, 32, 40])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_array_equal(tbloom.alibi_slopes(n),
                                  jbloom.alibi_slopes(n))


def test_config_reads_the_json_aliases_as_jax(tmp_path):
    raw = {"vocab_size": 300, "n_embed": 64, "n_layer": 3, "n_head": 8,
           "layer_norm_epsilon": 1e-6, "initializer_range": 0.01,
           "apply_residual_connection_post_layernorm": True,
           "eos_token_id": 5, "pad_token_id": 6}
    path = tmp_path / "bloom.json"
    path.write_text(json.dumps(raw))
    for p in (str(path), "configs/models/config_bloom_7b1.json"):
        got = tbloom.BloomConfig.from_json_file(p)
        want = jbloom.BloomConfig.from_json_file(p)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (p, f.name)
    assert tbloom.BloomConfig.from_json_file(str(path)).hidden_size == 64


@pytest.mark.parametrize("n_heads", [4, 6])
def test_prefill_then_decode_matches_jax(n_heads):
    """Front-padded prefill from pre-built prompt embeddings (written at
    row 0, ALiBi plus the valid_from mask), then decode steps at
    per-sample positions; logits and cache rows against JAX."""
    rng = np.random.default_rng(n_heads)
    jlm, params, tlm = _models(rng, n_heads)
    b, p = 3, 8
    prompt = rng.integers(4, V, size=(b, p)).astype(np.int32)
    plen = np.array([8, 5, 1], np.int32)
    pe = rng.normal(size=(b, p, H)).astype(np.float32)
    embeds, vf, po = j_prefix(jlm, params, jnp.asarray(prompt),
                              jnp.asarray(plen), None, PAD,
                              prompt_embeds=jnp.asarray(pe))
    t_embeds, t_vf, t_po = t_prefix(tlm, _t(prompt).long(), _t(plen), None,
                                    PAD, prompt_embeds=_t(pe))
    _close(t_embeds, embeds, 0)
    assert t_vf.tolist() == np.asarray(vf).tolist() == [0, 3, 7]

    variables = {"params": params}
    cache = jlm.apply(variables, b, 20, method=jbloom.BloomLM.init_cache)
    step = jax.jit(lambda e, c, cl, v: jlm.apply(
        variables, e, c, cl, v, method=jbloom.BloomLM.decode_step))
    want, cache = step(embeds, cache, jnp.int32(0), vf)
    t_cache = tlm.init_cache(b, 20)
    assert tuple(t_cache.shape) == cache.shape == (L, b, 128, 2 * H)
    got, _ = tlm.decode_step(t_embeds, t_cache, 0, t_vf, t_po)
    _close(got, want)
    _close(t_cache[:, :, :p], np.asarray(cache)[:, :, :p])

    cache_len = np.full((b,), p, np.int32)
    for _ in range(3):
        tok = rng.integers(4, V, size=(b, 1)).astype(np.int32)
        emb = jlm.apply(variables, jnp.asarray(tok),
                        method=jbloom.BloomLM.embed)
        want, cache = step(emb, cache, jnp.asarray(cache_len), vf)
        got, _ = tlm.decode_step(tlm.embed(_t(tok).long()), t_cache,
                                 _t(cache_len), t_vf, t_po)
        _close(got, want)
        cache_len += 1
    _close(t_cache, np.asarray(cache))


def _drive(engine, requests):
    """Two requests, two steps, then the rest: later requests join a
    batch already in flight."""
    fin = []
    for ids, pe in requests[:2]:
        engine.submit(ids, prompt_embeds=pe)
    for _ in range(2):
        fin.extend(engine.step())
    for ids, pe in requests[2:]:
        engine.submit(ids, prompt_embeds=pe)
    fin.extend(engine.run_to_completion())
    return {f.rid: f.tokens for f in fin}


def test_engine_tokens_with_prompt_embeds_match_jax_engine():
    rng = np.random.default_rng(7)
    jlm, params, tlm = _models(rng, 6)
    requests = [(list(rng.integers(4, V, size=n)),
                 rng.normal(size=(n, H)).astype(np.float32))
                for n in (3, 8, 1, 5)]
    kw = dict(num_slots=2, max_len=30, prefill_buckets=(8,))
    jeng = JEngine(jlm, jax.tree.map(jnp.asarray, params),
                   config=JGen(max_new_tokens=7, eos_id=EOS, pad_id=PAD,
                               beam_size=1), **kw)
    teng = ServingEngine(tlm, config=GenerationConfig(
        max_new_tokens=7, eos_id=EOS, pad_id=PAD), **kw)
    want = _drive(jeng, requests)
    got = _drive(teng, [(ids, _t(pe)) for ids, pe in requests])
    assert got == want
    assert len(got) == len(requests)
    assert len({tuple(t) for t in got.values()}) > 1  # not degenerate
    assert teng.nonfinite_logits == 0
    with pytest.raises(ValueError, match="rows"):
        teng.submit([5, 6], prompt_embeds=torch.zeros(3, H))


def test_lora_and_the_no_cache_forward_raise():
    """What raises: a LoRA target Bloom does not have and a remat policy
    JAX does not know.  Training the no-cache forward with dropout is
    ported: without a generator it draws nothing (the deterministic
    forward), with one it drops (test_torch_train_knobs.py holds the
    law)."""
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tbloom.BloomConfig(lora_rank=8, lora_targets=("qkv", "proj"))
    with pytest.raises(ValueError, match="remat_policy"):
        tbloom.BloomConfig(remat_policy="dots")
    assert tbloom.BloomConfig(lora_targets=["out"]).lora_targets == ("out",)
    lm = tbloom.BloomLM(tbloom.BloomConfig(
        vocab_size=V, hidden_size=H, num_hidden_layers=1,
        num_attention_heads=4, hidden_dropout=0.1), FP32_POLICY)
    bridge.seeded_init(lm, 0)
    tokens = torch.zeros(1, 4, dtype=torch.long)
    plain = lm.eval()(tokens)["last_hidden_state"]
    assert torch.equal(lm.train()(tokens)["last_hidden_state"], plain)
    dropped = lm.train()(tokens, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(dropped["last_hidden_state"], plain)


def _train_inputs(rng, b=3, s=70):
    """Tokens, shifted labels and a ragged loss mask; S spans two 64-row
    tiles of the flash kernels."""
    tokens = rng.integers(4, V, size=(b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    mask = (rng.random((b, s - 1)) < 0.6).astype(np.int32)
    return tokens, labels, mask


@pytest.mark.parametrize("n_heads,lora_rank", [(4, 0), (4, 2), (6, 2)])
def test_no_cache_forward_and_loss_match_jax(n_heads, lora_rank):
    """BloomLM.forward (the flash path with ALiBi, LoRA deltas on qkv,
    out, fc1 and fc2) against BloomLM.__call__ at fp32: hidden states,
    per-position losses and the masked mean loss; LoRA moves the loss."""
    rng = np.random.default_rng(10 * n_heads + lora_rank)
    jlm, params, tlm = _models(rng, n_heads, lora_rank)
    tokens, labels, mask = _train_inputs(rng)
    want = jlm.apply({"params": params}, tokens=jnp.asarray(tokens),
                     labels=jnp.asarray(labels),
                     loss_mask=jnp.asarray(mask))
    got = tlm(tokens=_t(tokens).long(), labels=_t(labels).long(),
              loss_mask=_t(mask))
    for key in ("last_hidden_state", "losses", "loss"):
        _close(got[key].detach(), want[key])
    if lora_rank:
        names = dict(tlm.named_parameters())
        assert names["decoder.layers.mlp.lora_fc2_b"].shape == (L, 2, H)
        assert names["decoder.layers.attn.lora_qkv_a"].shape == (L, H, 2)
        no_b = jax.tree_util.tree_map_with_path(
            lambda p, x: np.zeros_like(x) if str(p[-1].key).startswith(
                "lora_") and str(p[-1].key).endswith("_b") else x, params)
        no_lora = jlm.apply({"params": no_b}, tokens=jnp.asarray(tokens),
                            labels=jnp.asarray(labels),
                            loss_mask=jnp.asarray(mask))
        assert abs(float(no_lora["loss"]) - float(want["loss"])) > 1e-3


def test_merge_lora_matches_jax_and_the_unmerged_model():
    """merge_lora folds each adapter into its kernel as JAX's does, and a
    rank-0 model on the merged tree gives the adapted model's logits."""
    from youku_mplug_tpu.ops.lora import merge_lora as j_merge
    from youku_mplug_tpu_torch.ops.lora import merge_lora

    rng = np.random.default_rng(5)
    jlm, params, tlm = _models(rng, 4, lora_rank=2)
    want = j_merge(params, 2, 16.0)
    got = merge_lora(bridge.to_jax_tree(tlm), 2, 16.0)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(map(jax.tree_util.keystr, flat_w)) == \
        set(map(jax.tree_util.keystr, flat_g))
    assert not any("lora_" in jax.tree_util.keystr(k) for k in flat_g)
    for k, w in flat_w.items():
        _close(np.asarray(flat_g[k]), w)
    rank0 = bridge.load_jax_params(tbloom.BloomLM(tbloom.BloomConfig(
        vocab_size=V, hidden_size=H, num_hidden_layers=L,
        num_attention_heads=4), FP32_POLICY), got)
    tokens, _, _ = _train_inputs(rng)
    hidden = tlm(tokens=_t(tokens).long())["last_hidden_state"]
    merged_hidden = rank0(tokens=_t(tokens).long())["last_hidden_state"]
    _close(rank0.logits(merged_hidden).detach(),
           tlm.logits(hidden).detach())
    assert merge_lora(got, 0) is got
    bad = {"attn": {"lora_proj2_a": np.zeros((2, 2)),
                    "lora_proj2_b": np.zeros((2, 2))}}
    with pytest.raises(ValueError, match="no merge target"):
        merge_lora(bad, 2)


def test_seeded_init_zeroes_lora_b_and_draws_a_at_the_init_std():
    """A fresh adapter is a no-op (b = 0, as JAX's lora_pair inits it);
    a draws at the decoder's init_method_std."""
    lm = tbloom.BloomLM(tbloom.BloomConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, lora_rank=4, init_method_std=0.5),
        FP32_POLICY)
    bridge.seeded_init(lm, 0)
    names = dict(lm.named_parameters())
    lora = {k: p for k, p in names.items() if ".lora_" in k}
    assert len(lora) == 8
    for k, p in lora.items():
        if k.endswith("_b"):
            assert not p.any(), k
        else:
            assert 0.4 < float(p.std()) < 0.6, k
    assert 0.015 < float(names["decoder.layers.attn.qkv_kernel"].std()) < 0.025


# ---------------------------------------------------------------------------
# int8 serving: int8 decoder weights and an int8 cache
# ---------------------------------------------------------------------------


def _int8_models(rng, n_heads, lora_rank=0):
    """Bloom LMs with kv_cache_dtype int8 and the kernels and tied
    embedding quantized by the JAX function (LoRA adapters stay float)."""
    from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder

    jcfg = jbloom.BloomConfig(vocab_size=V, hidden_size=H,
                              num_hidden_layers=L,
                              num_attention_heads=n_heads, attn_impl="xla",
                              decode_attn_impl="gather", lora_rank=lora_rank,
                              kv_cache_dtype="int8")
    jlm = jbloom.BloomLM(jcfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), tokens=jnp.zeros((1, 4), jnp.int32)))["params"],
        rng)
    q, scales = quantize_gpt3_decoder(params, include_embedding=True)
    tcfg = tbloom.BloomConfig(vocab_size=V, hidden_size=H,
                              num_hidden_layers=L,
                              num_attention_heads=n_heads,
                              lora_rank=lora_rank, kv_cache_dtype="int8")
    tlm = bridge.load_jax_params(tbloom.BloomLM(tcfg, FP32_POLICY),
                                 jax.device_get(q),
                                 qscales=jax.device_get(scales))
    return jlm, {"params": q, "qscales": scales}, tlm


@pytest.mark.parametrize("n_heads,lora_rank", [(4, 0), (6, 2)])
def test_int8_prefill_then_decode_matches_jax(n_heads, lora_rank):
    """int8 kernels (scales on the head-major qkv lanes, LoRA deltas
    added before the biases), an int8 tied embedding and an int8 cache:
    prefill from prompt embeddings, then decode steps at per-sample
    positions (the plain fused write and the plain int8 ALiBi decode
    attention); logits and the dequantized cache against JAX."""
    from youku_mplug_tpu.ops import kv_cache as jkv
    from youku_mplug_tpu_torch.ops import kv_cache as tkv

    rng = np.random.default_rng(10 + n_heads)
    jlm, jvars, tlm = _int8_models(rng, n_heads, lora_rank)
    b, p = 3, 8
    prompt = rng.integers(4, V, size=(b, p)).astype(np.int32)
    plen = np.array([8, 5, 1], np.int32)
    pe = rng.normal(size=(b, p, H)).astype(np.float32)
    embeds, vf, po = j_prefix(jlm, jvars, jnp.asarray(prompt),
                              jnp.asarray(plen), None, PAD,
                              prompt_embeds=jnp.asarray(pe))
    t_embeds, t_vf, t_po = t_prefix(tlm, _t(prompt).long(), _t(plen), None,
                                    PAD, prompt_embeds=_t(pe))

    def dq_j(c):
        return np.asarray(jkv.dequantize_rows(c["kv"], c["scale"], n_heads,
                                              jnp.float32))

    def dq_t(c):
        return tkv.dequantize_rows(c["kv"], c["scale"], n_heads,
                                   torch.float32).numpy()

    cache = jlm.apply(jvars, b, 20, method=jbloom.BloomLM.init_cache)
    step = jax.jit(lambda e, c, cl, v: jlm.apply(
        jvars, e, c, cl, v, method=jbloom.BloomLM.decode_step))
    want, cache = step(embeds, cache, jnp.int32(0), vf)
    t_cache = tlm.init_cache(b, 20)
    assert t_cache["kv"].dtype == torch.int8
    got, _ = tlm.decode_step(t_embeds, t_cache, 0, t_vf, t_po)
    _close(got, want)
    _close(dq_t(t_cache), dq_j(cache))
    cache_len = np.full((b,), p, np.int32)
    for _ in range(3):
        tok = rng.integers(4, V, size=(b, 1)).astype(np.int32)
        emb = jlm.apply(jvars, jnp.asarray(tok), method=jbloom.BloomLM.embed)
        want, cache = step(emb, cache, jnp.asarray(cache_len), vf)
        got, _ = tlm.decode_step(tlm.embed(_t(tok).long()), t_cache,
                                 _t(cache_len), t_vf, t_po)
        _close(got, want)
        cache_len += 1
    _close(dq_t(t_cache), dq_j(cache))


@pytest.mark.parametrize("include_embedding", [False, True])
def test_quantize_bloom_decoder_tree_and_module_match_jax(include_embedding):
    """Bloom's head-major qkv [L, H, n, 3, d] and the other kernels: the
    tree function and the in-place module quantizer both equal JAX's."""
    from youku_mplug_tpu.ops import quant as jquant
    from youku_mplug_tpu_torch.ops import quant as tquant

    rng = np.random.default_rng(11)
    _, params, tlm = _models(rng, 4, lora_rank=2)
    jq, js = jquant.quantize_gpt3_decoder(params, include_embedding)
    tq, ts = tquant.quantize_gpt3_decoder(params, include_embedding)
    for want_tree, got_tree in ((jq, tq), (js, ts)):
        want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
        got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    assert js["decoder"]["layers"]["attn"]["qkv_kernel"].shape == \
        (L, 1, 4, 3, H // 4)
    tquant.quantize_decoder_(tlm, include_embedding)
    named = dict(tlm.named_parameters()) | dict(tlm.named_buffers())
    for tree, suffix in ((jq, ""), (js, tquant.SCALE_SUFFIX)):
        for k, v in jax.tree_util.tree_leaves_with_path(tree):
            name = bridge.port_name("/".join(p.key for p in k)) + suffix
            np.testing.assert_array_equal(named[name].detach().numpy(),
                                          np.asarray(v))
    assert named["decoder.layers.attn.lora_qkv_a"].dtype == torch.float32


def test_int8_engine_tokens_with_prompt_embeds_match_jax_engine():
    """The engine over int8 weights and an int8 cache: prefill through a
    slot view of both cache leaves, decode through the plain fused write
    and the plain int8 ALiBi decode attention; JAX's greedy tokens."""
    rng = np.random.default_rng(12)
    jlm, jvars, tlm = _int8_models(rng, 6)
    requests = [(list(rng.integers(4, V, size=n)),
                 rng.normal(size=(n, H)).astype(np.float32))
                for n in (3, 8, 1, 5)]
    kw = dict(num_slots=2, max_len=30, prefill_buckets=(8,))
    jeng = JEngine(jlm, jax.tree.map(jnp.asarray, jvars),
                   config=JGen(max_new_tokens=7, eos_id=EOS, pad_id=PAD,
                               beam_size=1), **kw)
    teng = ServingEngine(tlm, config=GenerationConfig(
        max_new_tokens=7, eos_id=EOS, pad_id=PAD), **kw)
    want = _drive(jeng, requests)
    got = _drive(teng, [(ids, _t(pe)) for ids, pe in requests])
    assert got == want
    assert len({tuple(t) for t in got.values()}) > 1  # not degenerate
    assert teng.nonfinite_logits == 0
