"""Dropout in the port: ``ops/attention.py`` (``dropout``, attention
dropout in ``mha_reference``), the GPT-3 decoder's three kinds (the
embeddings, the attention and MLP outputs, the attention probabilities)
and the train step's per-step generator.

JAX's bits cannot be reproduced from a torch.Generator, so dropout is
held to its law and to the deterministic path: rate 0 equals no dropout
exactly (against the JAX package too); the zeroed share is within six
standard errors of the rate and every kept value is scaled by exactly
1 / (1 - rate); the same (seed, step) gives the same masks and another
step other ones; eval mode and a forward without a generator draw
nothing; a checkpointed (remat) layer replays its masks; the memory-lean
attention-dropout backward equals autograd of the plain formula on the
same mask.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.ops.attention import (
    _masked_scores,
    dot_product_attention,
    dropout,
    mha_reference,
)
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.trainer import (
    dropout_generator,
    make_train_step,
)

torch.set_num_threads(1)
SIGMAS = 6.0


def _share_ok(zeroed: int, n: int, rate: float) -> bool:
    return abs(zeroed / n - rate) <= SIGMAS * (rate * (1 - rate) / n) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_zeroes_its_share_and_scales_the_rest(rate):
    x = torch.full((400_000,), 3.0)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert _share_ok(int((~kept).sum()), x.numel(), rate)
    assert torch.equal(y[kept], torch.full_like(y[kept], 3.0) / (1 - rate))
    assert dropout(x, 0.0, None) is x  # rate 0: no draw, no generator
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, rate, None)


def test_attention_dropout_law_and_rate_zero():
    """q = 0 makes every probability 1 / Sk; with V the identity, the
    output is the dropped probability matrix itself: its zeroed share is
    the rate and every kept entry (1 / Sk) / (1 - rate).  Rate 0 equals
    the plain attention bitwise; dropout never takes the flash kernel."""
    b, h, s, rate = 4, 8, 64, 0.1
    q = torch.zeros(b, h, s, s)
    v = torch.eye(s).expand(b, h, s, s).contiguous()
    gen = torch.Generator().manual_seed(1)
    o = mha_reference(q, v, v, dropout_rate=rate, generator=gen)
    kept = o != 0
    assert _share_ok(int((~kept).sum()), o.numel(), rate)
    torch.testing.assert_close(o[kept], torch.full_like(
        o[kept], 1 / s / (1 - rate)), rtol=1e-6, atol=0)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 128, 8)).astype(
        np.float32)) for _ in range(3))
    assert torch.equal(mha_reference(q, k, v, causal=True, dropout_rate=0.0,
                                     generator=gen),
                       mha_reference(q, k, v, causal=True))
    import youku_mplug_tpu_torch.ops.flash_attention as fa

    with mock.patch.object(fa, "flash_attention") as flash:
        out = dot_product_attention(q, k, v, dropout_rate=rate,
                                    generator=gen)
        dot_product_attention(q, k, v)
    assert out.shape == q.shape and flash.call_count == 1


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_backward_equals_autograd_on_the_same_mask(causal):
    """The recompute-from-lse backward against autograd of the plain
    formula (softmax, where(keep, p / (1 - r), 0), PV) on the mask the
    same generator draws, fp32."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 3, 17, 8)).astype(
        np.float32)) for _ in range(4))
    rate, scale = 0.3, 8 ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    mha_reference(*leaves, causal=causal, dropout_rate=rate,
                  generator=torch.Generator().manual_seed(4)).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(_masked_scores(ref[0], ref[1], causal=causal,
                                     kv_len=None, bias=None, scale=scale),
                      -1)
    keep = torch.rand(p.shape, generator=torch.Generator().manual_seed(4)
                      ) < 1 - rate
    torch.einsum("bhqk,bhkd->bhqd", torch.where(keep, p / (1 - rate), 0.0),
                 ref[2]).backward(do)
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5,
                                   atol=1e-5)


def _lm(hidden=0.1, attention=0.1, remat=False):
    cfg = tgpt3.GPT3Config(vocab_size=64, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=4,
                           max_position_embeddings=32, hidden_dropout=hidden,
                           attention_dropout=attention, remat=remat)
    return bridge.seeded_init(tgpt3.GPT3LM(cfg, FP32_POLICY), 0)


def _tokens():
    return torch.from_numpy(np.random.default_rng(5).integers(
        3, 64, size=(3, 20)))


def test_decoder_rate_zero_equals_the_deterministic_path_and_jax():
    """Rates 0 in training mode with a generator: the eval forward
    exactly, nothing drawn, and the JAX decoder's forward at fp32."""
    lm = _lm(0.0, 0.0)
    ids = _tokens()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got = lm.train()(tokens=ids, generator=gen)["last_hidden_state"]
    assert torch.equal(got, lm.eval()(tokens=ids)["last_hidden_state"])
    assert torch.equal(gen.get_state(), state)
    jcfg = jgpt3.GPT3Config(vocab_size=64, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=4,
                            max_position_embeddings=32, hidden_dropout=0.0,
                            attention_dropout=0.0)
    want = jgpt3.GPT3LM(jcfg, policy=J_FP32).apply(
        {"params": bridge.to_jax_tree(lm)}, jnp.asarray(ids.numpy()),
        deterministic=False, rngs={"dropout": jax.random.key(0)})[
            "last_hidden_state"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_decoder_dropout_takes_every_kind_and_its_share():
    """At hidden 0.1 the embeddings' dropped share is the rate (read off
    the first layer's input through a hook), attention dropout sends the
    training attention to mha_reference (through dot_product_attention,
    no flash call), and the output differs from eval's.  Eval takes the
    route of the JAX package's rule: 4 heads of 8 are not a packed
    geometry (``packed_supported``), so dot_product_attention without
    dropout, one call a layer."""
    lm = _lm(0.1, 0.1)
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        3, 64, size=(16, 32)))
    seen = []
    lm.decoder.layers.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
    with mock.patch.object(tgpt3, "flash_attention_packed",
                           wraps=tgpt3.flash_attention_packed) as flash, \
            mock.patch.object(tgpt3, "dot_product_attention",
                              wraps=tgpt3.dot_product_attention) as dpa:
        out = lm.train()(tokens=ids,
                         generator=torch.Generator().manual_seed(7))
        assert flash.call_count == 0
        assert [c.kwargs["dropout_rate"] for c in dpa.call_args_list] \
            == [0.1, 0.1]
        lm.eval()(tokens=ids)
        assert flash.call_count == 0
        assert [c.kwargs["dropout_rate"] for c in dpa.call_args_list[2:]] \
            == [0.0, 0.0]  # one per layer without dropout
    x = seen[0]
    assert _share_ok(int((x == 0).sum()), x.numel(), 0.1)
    assert not torch.equal(out["last_hidden_state"],
                           lm.eval()(tokens=ids)["last_hidden_state"])


def test_same_seed_and_step_give_the_same_masks():
    lm = _lm().train()
    ids = _tokens()

    def run(seed, step):
        return lm(tokens=ids, generator=dropout_generator(seed, step, "cpu")
                  )["last_hidden_state"]

    assert torch.equal(run(1, 5), run(1, 5))
    assert not torch.equal(run(1, 5), run(1, 6))
    assert not torch.equal(run(1, 5), run(2, 5))


def test_remat_layers_replay_their_masks():
    """A checkpointed layer sets its generator back to the state it began
    with before the backward's recompute: the output and the input
    gradient equal the layer-by-layer run's on the same generator."""
    ids = _tokens()
    grads, outs = [], []
    for remat in (False, True):
        lm = _lm(remat=remat).train()
        emb = lm.embed(ids).detach().requires_grad_()
        out = lm(input_embeds=emb, generator=torch.Generator().manual_seed(
            8))["last_hidden_state"]
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(emb.grad)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)


def test_train_step_passes_a_generator_of_seed_and_step():
    """make_train_step with a dropout_seed hands loss_fn the step's
    generator: two states at the same step draw the same numbers, the
    next step others; without a seed loss_fn takes the batch alone."""
    from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
    from youku_mplug_tpu_torch.train.state import create_train_state

    lin = torch.nn.Linear(2, 1)
    state, _, _ = create_train_state(lin, OptimizerConfig(warmup_steps=0))
    draws = []

    def loss_fn(batch, generator):
        draws.append(torch.rand(3, generator=generator))
        return {"loss": lin(batch["x"]).sum()}

    step = make_train_step(loss_fn, dropout_seed=4)
    batch = {"x": torch.ones(2, 2)}
    step(state, batch)
    state.step = 0
    step(state, batch)
    step(state, batch)
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])
    plain = make_train_step(lambda b: {"loss": lin(b["x"]).sum()})
    assert plain(state, batch)["skipped_nonfinite"] == 0.0


def test_task_losses_draw_only_in_training_mode():
    """cls_train_loss with a generator: eval mode draws nothing and equals
    the generator-less loss; training mode draws and differs."""
    from youku_mplug_tpu_torch.models import tasks, vision

    cfg = tasks.MPLUGVideoConfig(
        vision=vision.VisionConfig(img_size=32, patch_size=16, embed_dim=192,
                                   depth=1, num_heads=2, num_frames=2,
                                   mlp_ratio=2.0, clip_model=True),
        text=_lm().cfg, num_learnable_token=4, use_cls=True, num_classes=3)
    model = bridge.seeded_init(tasks.MPLUGVideo(cfg, FP32_POLICY), 0)
    rng = np.random.default_rng(9)
    video = torch.from_numpy(rng.normal(size=(2, 3, 2, 32, 32)).astype(
        np.float32))
    ids = _tokens()[:2, :10]
    mask = torch.ones_like(ids)
    args = (video, ids, mask, torch.tensor([2, 3]))
    kw = dict(prompt_ids=ids, prompt_mask=mask, labels=torch.tensor([0, 2]))
    gen = torch.Generator().manual_seed(10)
    state = gen.get_state()
    with torch.no_grad():
        want = model.eval().cls_train_loss(*args, **kw)["loss"]
        got = model.eval().cls_train_loss(*args, **kw, generator=gen)["loss"]
        assert torch.equal(got, want) and torch.equal(gen.get_state(), state)
        train = model.train().cls_train_loss(*args, **kw,
                                             generator=gen)["loss"]
    assert not torch.equal(train, want)
    assert not torch.equal(gen.get_state(), state)
