"""The port's optimizer zoo (youku_mplug_tpu_torch.optim.zoo, through
optim.factory.ZooOptimizer) against the JAX package's create_optimizer on
the same numpy-seeded parameters and gradients: every zoo name, 5 updates
(7 with the lookahead prefix, past its first sync at k = 6) on a tiny tree
of rank-1 to rank-4 leaves with decay and no-decay leaves, an
lr_scale_rules match, layer decay, warmup from lr 0, one leaf that
adafactor factors and one whose gradient is orthogonal to its rows (the
AdamP / SGDP projection); fp32 on both sides, rtol 1e-5 / atol 1e-7.
Also: adahessian and hutchinson_hessian_diag against JAX's on a
separable quadratic (its Hessian is diagonal, so every Rademacher probe
gives it exactly), the layer-decay and lr-scale trees against JAX's on
the tiny flagship tree, the names that raise, and a Hutchinson probe
through a once-differentiable op raising."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.optim import factory as jf
from youku_mplug_tpu.optim import zoo as jzoo
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.optim import factory as tf
from youku_mplug_tpu_torch.optim import zoo as tzoo
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)

SHAPES = {
    "visual_encoder/pos_embed": (1, 5, 8),
    "visual_encoder/blocks_0/attn/qkv_kernel": (8, 3, 2, 4),
    "visual_encoder/blocks_0/attn/proj_bias": (8,),
    "visual_encoder/blocks_1/mlp/fc1_kernel": (8, 16),
    "visual_encoder/blocks_1/norm1/scale": (8,),
    "attn_pool/bias_k": (1, 1, 8),
    # adafactor factors its two largest dims (128 and 160)
    "visual_fc/kernel": (128, 3, 2, 160),
    # the gradient is orthogonal to each row: AdamP / SGDP project
    "text_decoder/decoder/layers/attn/lora_qkv_a": (6, 12),
    "temp": (),
}
ORTHOGONAL = "text_decoder/decoder/layers/attn/lora_qkv_a"
RULES = (("pos_embed", 0.5), ("attn_pool", 2.0))
ZOO = tzoo.ZOO_NAMES + ("lookahead_adam", "lookahead_sgd",
                        "lookahead_adamp", "lookahead_lamb")


def _nest(flat):
    tree = {}
    for path, leaf in flat.items():
        *parents, key = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = leaf
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _problem(steps, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.5
              for k, s in SHAPES.items()}
    grads = []
    for _ in range(steps):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in
             SHAPES.items()}
        p = params[ORTHOGONAL]
        g[ORTHOGONAL] = (g[ORTHOGONAL] - p * (g[ORTHOGONAL] * p).sum(
            1, keepdims=True) / (p * p).sum(1, keepdims=True)
        ).astype(np.float32)
        grads.append(g)
    return params, grads


def _configs(opt, **kw):
    common = dict(opt=opt, lr=1e-2, min_lr=1e-4, weight_decay=0.05,
                  opt_betas=(0.9, 0.98), opt_eps=1e-8, clip_grad=None,
                  warmup_steps=2, epochs=1, niter_per_ep=10,
                  lr_scale_rules=RULES, layer_decay=0.9,
                  layer_decay_num_layers=2, momentum=0.9,
                  freeze_text_decoder=False)
    common.update(kw)
    return jf.OptimizerConfig(**common), tf.OptimizerConfig(**common)


def _jax_run(jcfg, params, grads):
    jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
    tx, _ = jf.create_optimizer(jp, jcfg)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(_nest({k: jnp.asarray(v)
                                      for k, v in g.items()}), state, jp)
        jp = optax.apply_updates(jp, upd)
    return {k: np.asarray(v) for k, v in _flat(jp).items()}


def _port_run(tcfg, params, grads):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt, _ = tf.create_optimizer(tp, tcfg)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in tp.items()}, opt


@pytest.mark.parametrize("opt", ZOO)
def test_zoo_updates_match_jax(opt):
    steps = 7 if opt.startswith("lookahead_") else 5
    params, grads = _problem(steps, seed=len(opt))
    jcfg, tcfg = _configs(opt)
    want = _jax_run(jcfg, params, grads)
    got, optimizer = _port_run(tcfg, params, grads)
    # adam / adamw take the main path (torch AdamW), as in JAX; their
    # zoo rules run under the fused* and lookahead_ names
    assert isinstance(optimizer, tf.AdamW if opt in ("adam", "adamw")
                      else tf.ZooOptimizer)
    assert optimizer.count == steps
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{opt} {k}")
    # every leaf moved (warmup's lr 0 first) and stays finite
    assert all(np.isfinite(got[k]).all() for k in got)


@pytest.mark.parametrize("opt", ["fusedadam", "nadam", "radam", "adamp",
                                 "novograd", "lamb"])
def test_zoo_updates_match_jax_at_the_default_betas(opt):
    """The loaders' default opt_betas (0.9, 0.999): the bias correction
    1 - 0.999^t, taken in float32 as JAX takes it."""
    params, grads = _problem(5, seed=2)
    jcfg, tcfg = _configs(opt, opt_betas=(0.9, 0.999))
    want = _jax_run(jcfg, params, grads)
    got, _ = _port_run(tcfg, params, grads)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{opt} {k}")


def test_factored_dims_and_projection_reach_their_branches():
    """The fixture's leaves reach adafactor's factored branch and the
    projection's channel branch; a random gradient takes neither."""
    assert tzoo.factored_dims(SHAPES["visual_fc/kernel"]) == (0, 3)
    assert tzoo.factored_dims((8, 3, 2, 4)) is None
    params, grads = _problem(1)
    p, g = (torch.tensor(x[ORTHOGONAL]) for x in (params, grads[0]))
    out, wd_s = tzoo.projection(p, g, g.clone(), 0.1, 0.1, 1e-8)
    assert float(wd_s) == pytest.approx(0.1)
    # the projected step has no radial part left in any row
    assert (out * p).sum(1).abs().max() < 1e-5
    rnd = torch.randn(6, 12, generator=torch.Generator().manual_seed(0))
    _, wd_s = tzoo.projection(p, rnd, rnd, 0.1, 0.1, 1e-8)
    assert float(wd_s) == 1.0


@pytest.mark.parametrize("amsgrad", [False, True])
def test_nvnovograd_amsgrad_matches_jax(amsgrad):
    params, grads = _problem(5, seed=3)
    jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
    jtx = optax.chain(jzoo.scale_by_nvnovograd(
        b1=0.95, b2=0.98, weight_decay=0.01, amsgrad=amsgrad),
        optax.scale_by_learning_rate(0.05))
    state = jtx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    rule = tzoo.NvNovoGrad(0.95, 0.98, 1e-8, amsgrad=amsgrad)
    st = {k: rule.init(p) for k, p in tp.items()}
    for i, g in enumerate(grads):
        upd, state = jtx.update(_nest({k: jnp.asarray(v)
                                       for k, v in g.items()}), state, jp)
        jp = optax.apply_updates(jp, upd)
        ctx = rule.begin(i)
        tp = {k: p + rule.update(torch.tensor(g[k]), p, st[k], ctx, 0.05,
                                 0.01) for k, p in tp.items()}
    want = _flat(jp)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7)


def test_adahessian_matches_jax_on_a_quadratic():
    """loss = sum(c * x^2) / 2 + sum(b * x) over two leaves: its Hessian
    is diag(c), so the Hutchinson estimate is exact for every probe and
    the port's and JAX's draws need not agree."""
    rng = np.random.default_rng(7)
    x0 = [rng.normal(size=(3, 4)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    c = [rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32) for x in x0]
    b = [rng.normal(size=x.shape).astype(np.float32) for x in x0]

    def jloss(params):
        return sum(jnp.sum(ci * p * p) / 2 + jnp.sum(bi * p)
                   for p, ci, bi in zip(params, c, b))

    jtx = jzoo.adahessian(0.1, weight_decay=0.01)
    jp = [jnp.asarray(x) for x in x0]
    jstate = jtx.init(jp)
    tx = tzoo.adahessian(0.1, weight_decay=0.01)
    tp = [torch.tensor(x, requires_grad=True) for x in x0]
    tstate = tx.init(tp)
    gen = torch.Generator().manual_seed(0)
    for i in range(4):
        jg = jax.grad(jloss)(jp)
        jh = jzoo.hutchinson_hessian_diag(jloss, jp, jax.random.key(i), 2)
        upd, jstate = jtx.update(jg, jstate, jp, hessian_diag=jh)
        jp = optax.apply_updates(jp, upd)

        def tloss():
            return sum((torch.tensor(ci) * p * p).sum() / 2
                       + (torch.tensor(bi) * p).sum()
                       for p, ci, bi in zip(tp, c, b))

        th = tzoo.hutchinson_hessian_diag(tloss, tp, gen, n_samples=2)
        for h, ci in zip(th, c):
            np.testing.assert_allclose(h.detach().numpy(), ci, rtol=1e-6)
        tg = torch.autograd.grad(tloss(), tp)
        upd_t, tstate = tx.update(tg, tstate, [p.detach() for p in tp],
                                  [h.detach() for h in th])
        with torch.no_grad():
            for p, u in zip(tp, upd_t):
                p.add_(u)
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


def _layer_norm(x):
    from youku_mplug_tpu_torch.ops.layernorm import layer_norm

    return layer_norm(x, torch.ones(64), torch.zeros(64), eps=1e-6)


def _flash(x):
    from youku_mplug_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
    )

    return flash_attention_packed(x, x * 0.5, x * 2.0, 1, causal=True)


def _dropout_attention(x):
    from youku_mplug_tpu_torch.ops.attention import mha_reference

    q = x[:, None]
    return mha_reference(q, q * 0.5, q * 2.0, causal=True, dropout_rate=0.1,
                         generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("op", [_layer_norm, _flash, _dropout_attention])
def test_hutchinson_through_a_once_differentiable_op_raises(op):
    """A Hessian probe through the fp32 LayerNorm, the flash attention
    Function (its plain version here, the kernels on the card) or dropout
    attention, each once differentiable, raises instead of dropping that
    path from the product; beside a twice-differentiable path too."""
    x = torch.randn(2, 8, 64, requires_grad=True)

    def loss():
        return (op(x).float() ** 3).sum() + (x ** 3).sum()

    with pytest.raises(RuntimeError, match="once_differentiable"):
        tzoo.hutchinson_hessian_diag(loss, [x], torch.Generator())
    # the twice-differentiable path alone probes fine
    h = tzoo.hutchinson_hessian_diag(lambda: (x ** 3).sum(), [x],
                                     torch.Generator())[0]
    torch.testing.assert_close(h, 6 * x.detach())


def test_names_that_raise_as_in_jax():
    params, _ = _problem(1)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    for name, err in (("adahessian", NotImplementedError),
                      ("nosuchopt", ValueError)):
        with pytest.raises(err):
            jf.create_optimizer(_nest({k: jnp.asarray(v) for k, v in
                                       params.items()}),
                                _configs(name)[0])
        with pytest.raises(err):
            tf.create_optimizer(tp, _configs(name)[1])


@pytest.fixture(scope="module")
def flagship_tree():
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), use_contrastive=True)
    v = cfg.vision
    shapes = jax.eval_shape(lambda: jtasks.MPLUGVideo(cfg).init(
        jax.random.key(0),
        jnp.zeros((2, 3, v.num_frames, v.img_size, v.img_size)),
        jnp.zeros((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32)))["params"]
    tm = MPLUGVideo(dataclasses.replace(flagship_config(tiny=True),
                                        use_contrastive=True), FP32_POLICY)
    named = {bridge.jax_path(n): p for n, p in tm.named_parameters()}
    return shapes, named


@pytest.mark.parametrize("kind", ["layer_decay", "lr_scale_rules",
                                  "backbone_and_rules", "product"])
def test_scale_trees_match_jax_on_the_tiny_tree(flagship_tree, kind):
    shapes, named = flagship_tree
    rules = (("blocks_1", 0.3), ("attn_pool/.*kernel", 2.0))
    if kind == "layer_decay":
        want = jf.layer_decay_scale_tree(shapes, 0.75, 2)
        got = tf.layer_decay_scale_tree(named, 0.75, 2)
    elif kind == "lr_scale_rules":
        want = jf.lr_scale_tree(shapes, False, rules)
        got = tf.lr_scale_tree(named, False, rules)
    elif kind == "backbone_and_rules":
        want = jf.lr_scale_tree(shapes, True, rules)
        got = tf.lr_scale_tree(named, True, rules)
    else:
        jcfg, tcfg = _configs("adamw", lr_scale_rules=rules,
                              visual_backbone_scale=True, layer_decay=0.8)
        a = _flat(jf.lr_scale_tree(shapes, True, rules))
        b = _flat(jf.layer_decay_scale_tree(shapes, 0.8, 2))
        assert tf.leaf_scales(named, tcfg) == {k: a[k] * b[k] for k in a}
        return
    assert got == _flat(want)
    assert len(set(got.values())) > 1


def test_layer_decay_past_its_layer_count_raises_as_in_jax():
    """A block deeper than layer_decay_num_layers: JAX's lookup raises
    IndexError, the port a ValueError naming the leaf."""
    shapes = {"visual_encoder/blocks_13/attn/qkv_kernel": (4, 4),
              "visual_encoder/blocks_2/mlp/fc1_kernel": (4, 4)}
    with pytest.raises(IndexError):
        jf.layer_decay_scale_tree(_nest({k: np.zeros(s) for k, s in
                                         shapes.items()}), 0.9, 12)
    with pytest.raises(ValueError, match="blocks_13"):
        tf.layer_decay_scale_tree({k: torch.zeros(s) for k, s in
                                   shapes.items()}, 0.9, 12)
    assert tf.layer_decay_scale_tree({k: torch.zeros(s) for k, s in
                                      shapes.items()}, 0.9, 14) == _flat(
        jf.layer_decay_scale_tree(_nest({k: np.zeros(s) for k, s in
                                         shapes.items()}), 0.9, 14))


def test_adamw_takes_layer_decay_and_rules_like_jax():
    """The adam / adamw path (torch AdamW groups) under lr_scale_rules and
    layer decay: 4 updates against JAX's chain."""
    params, grads = _problem(4, seed=11)
    jcfg, tcfg = _configs("adamw")
    want = _jax_run(jcfg, params, grads)
    got, opt = _port_run(tcfg, params, grads)
    assert isinstance(opt, tf.AdamW)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
