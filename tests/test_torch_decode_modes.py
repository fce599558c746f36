"""The serving engine's decode modes on the port against the JAX package,
at fp32 on the CPU, weights carried over by the bridge: the sampling
filter (exactly JAX's), sampling by its distribution (JAX's random bits
cannot be reproduced), ``decode_step(..., return_all=True)`` on a chunk
with per-sample lengths (GPT-3 and Bloom, float and int8 caches),
multi-step dispatch (``step_many`` / ``run_to_completion(
steps_per_dispatch=...)``) and prompt-lookup speculation (``step_lookup``)
token for token against JAX's engine and the port's own ``step``, and the
host-side lookup proposal.  The CUDA graphs of the decode step are held
against the eager step on the card in test_torch_graphs.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs
from scipy import stats

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import bloom as jbloom
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.models.generation import _build_prefix as j_prefix
from youku_mplug_tpu.models.generation import (
    top_k_top_p_filter as j_filter,
)
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import bloom as tbloom
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models.generation import (
    NEG_INF,
    GenerationConfig,
    top_k_top_p_filter,
)
from youku_mplug_tpu_torch.models.generation import _build_prefix as t_prefix
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(1)
TOL = 1e-4   # fp32 logits, sums taken in another order
NQ = 4       # visual query rows of a caption request


def redraw(tree, rng, std=0.3):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _gpt3(seed, kv_cache_dtype="auto"):
    """JAX and port tiny GPT-3 LMs with the same redrawn weights."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(_flagship_cfg(tiny=True).text,
                              kv_cache_dtype=kv_cache_dtype)
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"], rng)
    tcfg = dataclasses.replace(flagship_config(tiny=True).text,
                               kv_cache_dtype=kv_cache_dtype)
    tlm = bridge.load_jax_params(tgpt3.GPT3LM(tcfg, FP32_POLICY), params)
    return jlm, jax.tree.map(jnp.asarray, params), tlm


def _bloom(seed, kv_cache_dtype="auto"):
    rng = np.random.default_rng(seed)
    kw = dict(vocab_size=97, hidden_size=48, num_hidden_layers=2,
              num_attention_heads=6, kv_cache_dtype=kv_cache_dtype)
    jlm = jbloom.BloomLM(jbloom.BloomConfig(**kw, attn_impl="xla",
                                            decode_attn_impl="gather"),
                         policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), tokens=jnp.zeros((1, 4), jnp.int32)))["params"],
        rng, std=0.2)
    tlm = bridge.load_jax_params(
        tbloom.BloomLM(tbloom.BloomConfig(**kw), FP32_POLICY), params)
    return jlm, jax.tree.map(jnp.asarray, params), tlm


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the sampling filter and sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1.0])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    want = np.asarray(j_filter(jnp.asarray(logits), top_k, top_p))
    got = top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got == NEG_INF, want == NEG_INF)
    np.testing.assert_array_equal(got, want)
    kept = (got != NEG_INF).sum(-1)
    assert (kept >= 1).all()
    if top_k:
        assert (kept <= top_k).all()
    if top_k == 0 and top_p in (0.0, 1.0):
        assert (kept == 40).all()


def _tiny_engine(config, seed=0):
    lm = bridge.seeded_init(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), 0)
    return ServingEngine(lm, num_slots=2, max_len=32, prefill_buckets=(8,),
                         config=config,
                         generator=torch.Generator().manual_seed(seed))


def test_sampling_stays_in_the_support_and_follows_the_filtered_softmax():
    """The engine's ``_pick`` with do_sample: 2*10^4 draws over a vocab of
    16 from top_k 5 / top_p 0.9: none outside the filtered support, a
    chi-square test against the filtered softmax (over the temperature)
    passes, and the same seed gives the same draws."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.5)
    n = 20000
    cfg = GenerationConfig(do_sample=True, top_k=5, top_p=0.9,
                           temperature=0.8)
    draws = _tiny_engine(cfg)._pick(logits.expand(n, 16)).numpy()
    kept = top_k_top_p_filter(logits[None] / 0.8, 5, 0.9)[0]
    support = np.flatnonzero(kept.numpy() != NEG_INF)
    assert 1 < len(support) <= 5
    assert np.isin(draws, support).all()
    p = torch.softmax(kept, -1).double().numpy()[support]
    seen = np.bincount(draws, minlength=16)[support]
    assert stats.chisquare(seen, p / p.sum() * n).pvalue > 1e-3
    again = _tiny_engine(cfg)._pick(logits.expand(n, 16)).numpy()
    np.testing.assert_array_equal(again, draws)
    other = _tiny_engine(cfg, seed=1)._pick(logits.expand(n, 16)).numpy()
    assert (other != draws).any()


def test_sampled_engine_is_reproducible_by_seed():
    """Sampled serving on the CPU: every token inside the vocab, the same
    generator seed gives the same tokens, another seed other tokens."""
    def serve(seed):
        eng = _tiny_engine(GenerationConfig(
            max_new_tokens=8, eos_id=-1, pad_id=0, do_sample=True, top_k=0,
            top_p=1.0), seed)
        for ids in ([5, 6, 7], [9, 1]):
            eng.submit(ids, query_embeds=np.zeros((NQ, 64), np.float32))
        fin = {f.rid: f.tokens for f in eng.run_to_completion(
            steps_per_dispatch=3)}
        assert eng.nonfinite_logits == 0
        return fin
    first = serve(0)
    assert all(len(t) == 8 and all(0 <= x < 256 for x in t)
               for t in first.values())
    assert serve(0) == first
    assert serve(1) != first


# ---------------------------------------------------------------------------
# decode_step over a chunk with per-sample lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt3", "bloom"])
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_chunk_decode_step_return_all_matches_jax(family, kv):
    """A front-padded prefill, then a 4-token chunk at per-sample lengths
    [B] with return_all: fp32 logits of every position and the cache,
    against JAX."""
    jlm, params, tlm = (_gpt3 if family == "gpt3" else _bloom)(
        {"auto": 5, "int8": 6}[kv], kv)
    rng = np.random.default_rng(9)
    b, p, s = 3, 8, 4
    vocab = tlm.cfg.vocab_size
    jcls = type(jlm)
    prompt = rng.integers(3, vocab, size=(b, p)).astype(np.int32)
    plen = np.array([8, 5, 2], np.int32)
    embeds, vf, po = j_prefix(jlm, params, jnp.asarray(prompt),
                              jnp.asarray(plen), None, 0)
    cache = jlm.apply({"params": params}, b, 24, method=jcls.init_cache)
    _, cache = jlm.apply({"params": params}, embeds, cache, jnp.int32(0), vf,
                         po, method=jcls.decode_step)
    t_embeds, t_vf, t_po = t_prefix(tlm, torch.from_numpy(prompt).long(),
                                    torch.from_numpy(plen), None, 0)
    t_cache = tlm.init_cache(b, 24)
    with torch.inference_mode():
        tlm.decode_step(t_embeds, t_cache, 0, t_vf, t_po)
    cache_len = np.array([p, p + 2, p + 1], np.int32)
    chunk = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    emb = jlm.apply({"params": params}, jnp.asarray(chunk),
                    method=jcls.embed)
    want, cache = jlm.apply({"params": params}, emb, cache,
                            jnp.asarray(cache_len), vf, po, True,
                            method=jcls.decode_step)
    with torch.inference_mode():
        got, _ = tlm.decode_step(tlm.embed(torch.from_numpy(chunk).long()),
                                 t_cache, torch.from_numpy(cache_len), t_vf,
                                 t_po, return_all=True)
    assert got.shape == (b, s, vocab) and got.dtype == torch.float32
    _close(got, want)
    leaves = t_cache.values() if kv == "int8" else [t_cache]
    jleaves = [cache[k] for k in t_cache] if kv == "int8" else [cache]
    for t_leaf, j_leaf in zip(leaves, jleaves):
        _close(t_leaf.float(), np.asarray(j_leaf, np.float32), 1e-3)


# ---------------------------------------------------------------------------
# multi-step dispatch and prompt-lookup speculation
# ---------------------------------------------------------------------------

def _requests(rng, h, sizes):
    return [(list(rng.integers(3, 256, size=n)),
             rng.normal(size=(NQ, h)).astype(np.float32)) for n in sizes]


def _serve(engine, requests, first, drain):
    """Submit two requests, run ``first`` on the engine, then submit the
    rest (late admission) and ``drain``; returns {rid: tokens}."""
    fin = []
    for ids, qe in requests[:2]:
        engine.submit(ids, query_embeds=qe, max_new_tokens=len(ids) + 4)
    fin.extend(first(engine))
    for ids, qe in requests[2:]:
        engine.submit(ids, query_embeds=qe, max_new_tokens=len(ids) + 4)
    fin.extend(drain(engine))
    return {f.rid: f.tokens for f in fin}


def _eos_mid_run(tokens_by_rid):
    """A token that, as the EOS, ends some request in the middle of its
    output and none in its first two tokens: of those, the one that keeps
    the most tokens."""
    runs = list(tokens_by_rid.values())

    def ends(t):  # where each request would stop
        return [r.index(t) if t in r else len(r) for r in runs]
    cands = [t for t in {t for r in runs for t in r[2:-2]}
             if min(ends(t)) >= 2
             and any(2 <= e < len(r) - 2 for e, r in zip(ends(t), runs))]
    assert cands, "no token to serve as a mid-run EOS"
    return max(cands, key=lambda t: (sum(ends(t)), -t))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_step_many_matches_jax_and_step(kv):
    """step_many(4), then run_to_completion(steps_per_dispatch=8): the
    same tokens as JAX's engine on the same schedule and as the port's
    single steps — with an EOS and per-request max_new ending requests in
    the middle of a dispatch, requests admitted between dispatches, and
    the k clamp near max_len (max_len 24: a request ends at row 23, 11
    rows after its prefill)."""
    jlm, params, tlm = _gpt3(11, kv)
    rng = np.random.default_rng(12)
    reqs = _requests(rng, 64, (3, 8, 1, 5, 6))
    kw = dict(num_slots=3, max_len=24, prefill_buckets=(8,))

    def engines(eos):
        jcfg = JGen(max_new_tokens=20, eos_id=eos, pad_id=0)
        tcfg = GenerationConfig(max_new_tokens=20, eos_id=eos, pad_id=0)
        return JEngine(jlm, params, config=jcfg, **kw), \
            ServingEngine(tlm, config=tcfg, **kw)

    def one_by_one(e):
        return e.run_to_completion()

    eos = _eos_mid_run(_serve(engines(-1)[1], reqs,
                              lambda e: e.step_many(4), one_by_one))
    jeng, teng = engines(eos)
    first = lambda e: e.step_many(4) + e.step_many(4)  # noqa: E731
    drain = lambda e: e.run_to_completion(steps_per_dispatch=8)  # noqa
    want = _serve(jeng, reqs, first, drain)
    got = _serve(teng, reqs, first, drain)
    assert got == want and len(got) == len(reqs)
    assert any(len(t) < len(reqs[i][0]) + 4 for i, t in got.items())  # eos
    assert teng.graph_replays == 0 and teng.nonfinite_logits == 0
    single = _serve(engines(eos)[1], reqs,
                    lambda e: e.step() + e.step(), one_by_one)
    assert single == got
    assert teng.decode_steps > 0


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_step_lookup_matches_jax_and_step(kv):
    """step_lookup(3) then run_to_completion(lookup_k=3): JAX's engine's
    tokens and the greedy single steps', with late admission."""
    jlm, params, tlm = _gpt3(21, kv)
    reqs = _requests(np.random.default_rng(22), 64, (6, 2, 4, 7))
    kw = dict(num_slots=2, max_len=40, prefill_buckets=(8,))
    jcfg = JGen(max_new_tokens=12, eos_id=2, pad_id=0)
    tcfg = GenerationConfig(max_new_tokens=12, eos_id=2, pad_id=0)
    first = lambda e: e.step_lookup(3)  # noqa: E731
    drain = lambda e: e.run_to_completion(lookup_k=3, ngram=2)  # noqa
    want = _serve(JEngine(jlm, params, config=jcfg, **kw), reqs, first,
                  drain)
    got = _serve(ServingEngine(tlm, config=tcfg, **kw), reqs, first, drain)
    assert got == want and len(got) == len(reqs)
    single = _serve(ServingEngine(tlm, config=tcfg, **kw), reqs,
                    lambda e: e.step(), lambda e: e.run_to_completion())
    assert single == got


def test_step_lookup_commits_several_tokens_a_dispatch():
    """A periodic prompt whose greedy continuation the lookup draft
    predicts: fewer dispatches than tokens, and the tokens are greedy."""
    _, _, tlm = _gpt3(31)
    cfg = GenerationConfig(max_new_tokens=12, eos_id=-1, pad_id=0)
    kw = dict(num_slots=1, max_len=64, prefill_buckets=(8, 16))
    greedy = ServingEngine(tlm, config=cfg, **kw)
    greedy.submit([3, 8, 3, 8, 3, 8])
    want = greedy.run_to_completion()[0].tokens
    # a history that repeats the greedy output: the lookup proposes it
    eng = ServingEngine(tlm, config=cfg, **kw)
    eng.submit([3, 8, 3, 8, 3, 8])
    fin, dispatches = [], 0
    while not eng.idle:
        fin.extend(eng.step_lookup(4))
        dispatches += 1
        assert dispatches < 50
    assert fin[0].tokens == want
    assert dispatches <= 12
    # the engine's own history, seeded with the answer, commits in bulk
    eng = ServingEngine(tlm, config=cfg, **kw)
    prompt = want[:6] + [3, 8, 3, 8, 3, 8]
    greedy = ServingEngine(tlm, config=cfg, **kw)
    greedy.submit(prompt)
    want2 = greedy.run_to_completion()[0].tokens
    eng.submit(prompt)
    eng._admit()
    eng._hist[0] = prompt + want2 + prompt + [want2[0]]
    fin, dispatches = [], 0
    while not eng.idle:
        fin.extend(eng.step_lookup(4))
        dispatches += 1
    assert fin[0].tokens == want2 and dispatches <= 4


@pytest.mark.parametrize("mode", ["lookup", "many"])
def test_a_stale_inactive_slot_cannot_corrupt_a_live_one(mode):
    """An inactive slot whose stale cache_len sits at the cache's last
    rows: its chunk (or steps) run past M, whose rows the port drops (JAX
    clamps the write), and the live slot's tokens stay the greedy ones."""
    _, _, tlm = _gpt3(41)
    cfg = GenerationConfig(max_new_tokens=10, eos_id=-1, pad_id=0)
    kw = dict(num_slots=2, max_len=40, prefill_buckets=(8,))
    qe = np.random.default_rng(42).normal(size=(NQ, 64)).astype(np.float32)
    alone = ServingEngine(tlm, config=cfg, **kw)
    alone.submit([5, 9, 4], query_embeds=qe)
    want = alone.run_to_completion()[0].tokens
    eng = ServingEngine(tlm, config=cfg, **kw)
    eng.submit([7], max_new_tokens=1)            # slot 0, done at prefill
    eng.submit([5, 9, 4], query_embeds=qe)       # slot 1
    eng._admit()
    m = kvc.cache_width(eng.cache)
    eng.cache_len[0] = m - 2                     # rows m-2 .. past m
    fin = eng.run_to_completion(lookup_k=4) if mode == "lookup" \
        else eng.run_to_completion(steps_per_dispatch=4)
    assert {f.rid: f.tokens for f in fin}[1] == want


@settings(max_examples=60, deadline=None)
@given(hist=hs.lists(hs.integers(0, 4), min_size=0, max_size=14),
       n=hs.integers(1, 3), k=hs.integers(1, 5))
def test_lookup_propose_matches_jax(hist, n, k):
    assert ServingEngine._lookup_propose(list(hist), n, k) == \
        JEngine._lookup_propose(list(hist), n, k)
