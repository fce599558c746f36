"""The port's batched generation (youku_mplug_tpu_torch.models.generation:
greedy and beam search over the stacked cache, the in-place beam
reorder) against the JAX package at fp32, on the tiny flagship decoder
with the same weights (redrawn at std 0.2 through the bridge).

Sequences must be equal; beam scores agree within 1e-4 (fp32 sums of up
to eight log-probs computed in another order).  Ties are built where the
order of top-k matters: two vocabulary rows made identical give exactly
equal logits in both packages, and the lower index must win, as
``lax.top_k`` has it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import generation as jgen
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import generation as tgen
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
EOS = 2


def redraw(tree, rng, std=0.2):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _models(seed, edit=None):
    """JAX and port decoders with the same redrawn weights; ``edit``
    changes the numpy tree (the tied embedding) before both load it."""
    cfg = _flagship_cfg(tiny=True).text
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    params = jax.tree.map(np.asarray, redraw(shapes, np.random.default_rng(
        seed)))
    if edit is not None:
        edit(params)
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), params)
    return jlm, params, tlm.eval()


def _prompts(rng, b=3, p=6, nq=4, h=64):
    ids = rng.integers(3, 256, size=(b, p)).astype(np.int32)
    plen = np.array([p, 3, 1][:b], np.int32)
    ids = np.where(np.arange(p)[None] < plen[:, None], ids, EOS)
    qe = rng.normal(size=(b, nq, h)).astype(np.float32)
    return ids, plen, qe


def _both(jlm, params, tlm, ids, plen, qe, cfg):
    want = jgen.generate(jlm, params, jnp.asarray(ids), jnp.asarray(plen),
                         query_embeds=None if qe is None else jnp.asarray(qe),
                         config=cfg)
    got = tgen.generate(tlm, torch.from_numpy(ids), torch.from_numpy(plen),
                        query_embeds=None if qe is None
                        else torch.from_numpy(qe), config=cfg)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("with_queries", [True, False])
def test_greedy_matches_jax_with_ragged_prompts(with_queries):
    rng = np.random.default_rng(0)
    jlm, params, tlm = _models(0)
    ids, plen, qe = _prompts(rng)
    cfg = jgen.GenerationConfig(max_new_tokens=7, eos_id=EOS, pad_id=EOS,
                                beam_size=1)
    got, want = _both(jlm, params, tlm, ids, plen,
                      qe if with_queries else None, cfg)
    assert got["sequences"].dtype == torch.int32
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  want["sequences"])
    assert 1 <= got["decode_steps"] <= 6


@pytest.mark.parametrize("beam", [2, 3])
@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_beam_search_matches_jax(beam, length_penalty):
    rng = np.random.default_rng(beam)
    jlm, params, tlm = _models(beam)
    ids, plen, qe = _prompts(rng)
    cfg = jgen.GenerationConfig(max_new_tokens=6, eos_id=EOS, pad_id=EOS,
                                beam_size=beam,
                                length_penalty=length_penalty)
    got, want = _both(jlm, params, tlm, ids, plen, qe, cfg)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  want["sequences"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=TOL, atol=TOL)
    assert got["decode_steps"] == 5  # eos is improbable: every step runs


def test_beam_search_stops_at_eos_as_jax_does():
    """eos made likely (its tied embedding row a copy of a frequent
    token's, a little longer): finished hypotheses fill the pool and the
    stop rule ends the loop early; the sequence ends in eos then pads, as
    in JAX."""
    def louder_eos(params):
        emb = params["word_embeddings"]["embedding"]
        emb[EOS] = 1.05 * emb[40]

    jlm, params, tlm = _models(5, louder_eos)
    ids = np.array([[1, 5, 9, 2], [1, 7, 2, 2]], np.int32)
    plen = np.array([3, 2], np.int32)
    cfg = jgen.GenerationConfig(max_new_tokens=8, eos_id=EOS, pad_id=EOS,
                                beam_size=3)
    got, want = _both(jlm, params, tlm, ids, plen, None, cfg)
    seqs = got["sequences"].numpy()
    np.testing.assert_array_equal(seqs, want["sequences"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=TOL, atol=TOL)
    assert (seqs == EOS).any()
    for row in seqs:
        if EOS in row:
            assert (row[list(row).index(EOS):] == EOS).all()
    assert got["decode_steps"] < 7


def test_top_k_breaks_ties_by_index_as_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, -1e7, 2.0, 3.0, -1e7, -1e7],
                  [-1e7] * 8, [0.5, 0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.5]],
                 np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tgen._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_beam_search_with_exactly_tied_tokens_matches_jax():
    """Token 250 gets the embedding row of token 218, which these weights
    pick often, so every logit of the two is equal in both packages: each
    top-k must keep the lower index first for the beams (and the returned
    sequence) to agree."""
    def tie(params):
        emb = params["word_embeddings"]["embedding"]
        emb[250] = emb[218]

    jlm, params, tlm = _models(7, tie)
    rng = np.random.default_rng(7)
    ids, plen, qe = _prompts(rng)
    cfg = jgen.GenerationConfig(max_new_tokens=5, eos_id=EOS, pad_id=EOS,
                                beam_size=3)
    got, want = _both(jlm, params, tlm, ids, plen, qe, cfg)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  want["sequences"])
    assert (got["sequences"].numpy() == 218).any()
    assert not (got["sequences"].numpy() == 250).any()


def _cache_pair(rng, quantized, l=2, b=3, k=2, m=16, n=2, d=4):
    rows = torch.from_numpy(rng.normal(size=(l, b * k, m, 2 * n * d))
                            .astype(np.float32)).to(torch.bfloat16)
    if not quantized:
        return rows, jnp.asarray(rows.float().numpy(), dtype=jnp.bfloat16)
    kv, scale = kvc.quantize_rows(rows.float(), n)
    cache = {"kv": kv, "scale": scale}
    return cache, {key: jnp.asarray(t.numpy()) for key, t in cache.items()}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("prefix_len", [0, 10])
def test_gather_beams_matches_jax(quantized, prefix_len):
    """The in-place reorder of every B*K leaf (the bf16 tensor, or both
    leaves of the int8 dict), all rows or the tail past prefix_len alone,
    equal to JAX's gather (which returns new arrays)."""
    rng = np.random.default_rng(int(quantized) * 10 + prefix_len)
    b, k = 3, 2
    cache, jcache = _cache_pair(rng, quantized, b=b, k=k)
    beam_idx = rng.integers(0, k, (b, k))
    want = jgen._gather_beams(jcache, jnp.asarray(beam_idx), b, k,
                              prefix_len=prefix_len)
    before = [t.clone() for t in kvc.leaves(cache) if t is not None]
    out = tgen._gather_beams(cache, torch.from_numpy(beam_idx), b, k,
                             prefix_len=prefix_len)
    assert out is cache
    got_leaves = [t for t in kvc.leaves(cache) if t is not None]
    want_leaves = [want] if not quantized else [want["kv"], want["scale"]]
    for got, w, b0 in zip(got_leaves, want_leaves, before):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w).astype(np.float32))
        # the prefix rows stay as they were
        assert torch.equal(got[:, :, :prefix_len], b0[:, :, :prefix_len])


def test_sampling_with_top_k_1_is_greedy():
    rng = np.random.default_rng(3)
    _, _, tlm = _models(3)
    ids, plen, qe = _prompts(rng)
    args = (tlm, torch.from_numpy(ids), torch.from_numpy(plen))
    greedy = tgen.generate(*args, query_embeds=torch.from_numpy(qe),
                           config=tgen.GenerationConfig(
                               max_new_tokens=5, eos_id=EOS, pad_id=EOS,
                               beam_size=1))
    sampled = tgen.generate(*args, query_embeds=torch.from_numpy(qe),
                            config=tgen.GenerationConfig(
                                max_new_tokens=5, eos_id=EOS, pad_id=EOS,
                                do_sample=True, top_k=1, top_p=0.0),
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(greedy["sequences"], sampled["sequences"])
    assert dataclasses.asdict(tgen.GenerationConfig()) == \
        dataclasses.asdict(jgen.GenerationConfig())
