"""The port's mPLUG (``models/mplug.py``) against the JAX package's at
fp32, on the tiny BERT and a one-block TimeSformer: the bridge's round
trip of ``MPLUG.full_init``, every method at batch 2 (where the -1e9 mask
leaves each hard-negative draw one choice, so the whole loss compares;
JAX's ``mlm_mask_tokens`` output feeds both), two AdamW steps of
``pretrain_loss`` with the momentum features, ``update_momentum`` and the
queues against JAX's ``make_train_step`` (a batch-3 case over a size-8
queue runs three steps, the third of which writes at the clamped start),
greedy and beam-3 generation tokens; and the port's own laws: MLM
masking, the hard-negative draw, BERT dropout in training and
evaluation.  Tolerance 1e-4; 2e-5 on parameters after AdamW steps."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_bert_family import (
    PARAM_TOL,
    bert_cfgs,
    close,
    flat,
    redraw,
    t,
    tokens,
    video,
    vision_cfgs,
)
from youku_mplug_tpu.models import mplug as jmplug
from youku_mplug_tpu.optim import factory as jfactory
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import mplug as tmplug
from youku_mplug_tpu_torch.optim import factory as tfactory
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)
EMBED, CLASSES = 8, 3


def cfgs(queue_size=16, **bert_over):
    jb, tb = bert_cfgs(**bert_over)
    jv, tv = vision_cfgs()
    kw = dict(embed_dim=EMBED, queue_size=queue_size, num_classes=CLASSES)
    return (jmplug.MPLUGConfig(vision=jv, bert=jb, **kw),
            tmplug.MPLUGConfig(vision=tv, bert=tb, **kw))


def build(rng, b=2, **cfg_over):
    """(JAX model, redrawn full_init params, port model in eval mode)."""
    jcfg, tcfg = cfgs(**cfg_over)
    jm = jmplug.MPLUG(jcfg, policy=J_FP32)
    ids, mask = tokens(rng, rows=b)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video(rng, b)), jnp.asarray(ids),
        jnp.asarray(mask), method=jmplug.MPLUG.full_init))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(tmplug.MPLUG(tcfg, FP32_POLICY), params)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def models():
    return build(np.random.default_rng(0))


def _japply(jm, params, method, *args, **kw):
    return jm.apply({"params": params}, *args, method=method, **kw)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_bridge_round_trip_of_full_init(models):
    """Every JAX leaf has its port parameter and back (no leftovers: the
    bridge raises on one); the fusion layer, decoder and heads are
    there."""
    _, params, tm = models
    names = {bridge.jax_path(n) for n, _ in tm.named_parameters()}
    assert names == set(flat(params))
    assert {"fusion_encoder/fusion_encoder/layer_1/crossattention/key/"
            "kernel", "text_decoder/cls/decoder/kernel", "mlm_head/bias",
            "itm_head/kernel", "cls_fc2/kernel", "temp"} <= names
    back = flat(bridge.to_jax_tree(tm))
    for k, v in flat(params).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_encoders_and_momentum_features_match_jax(models):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    v = video(rng)
    ids, mask = tokens(rng)
    want = _japply(jm, params, jmplug.MPLUG.momentum_features,
                   jnp.asarray(v), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tm.momentum_features(t(v), t(ids), t(mask))
    for k in ("image_feat", "text_feat", "image_embeds"):
        close(got[k], want[k])
    close(got["image_feat"].norm(dim=-1), np.ones(2))


def _queues(rng, e=EMBED, q=16):
    out = []
    for _ in range(2):
        a = rng.normal(size=(e, q)).astype(np.float32)
        out.append(a / np.linalg.norm(a, axis=0, keepdims=True))
    return out


@pytest.mark.parametrize("queues", [False, True])
def test_pretrain_loss_matches_jax(models, queues):
    """ITC (with the twin's features and the queues, alpha 0.4, or
    in-batch alone), ITM on the forced negatives, MLM on JAX's masks."""
    jm, params, tm = models
    rng = np.random.default_rng(2)
    v = video(rng)
    ids, mask = tokens(rng)
    mlm_ids, mlm_labels = jmplug.mlm_mask_tokens(
        jax.random.key(5), jnp.asarray(ids), jnp.asarray(mask), 256,
        mlm_probability=0.5)
    assert (np.asarray(mlm_labels) != -100).any()
    kw, tkw = {}, {}
    if queues:
        ema = redraw(params, rng)
        feats_m = _japply(jm, ema, jmplug.MPLUG.momentum_features,
                          jnp.asarray(v), jnp.asarray(ids),
                          jnp.asarray(mask))
        iq, tq = _queues(rng)
        kw = dict(feats_m=feats_m, image_queue=jnp.asarray(iq),
                  text_queue=jnp.asarray(tq), alpha=0.4)
        tkw = dict(feats_m={k: t(np.asarray(x)) for k, x in
                            feats_m.items()},
                   image_queue=t(iq), text_queue=t(tq), alpha=0.4)
    want = _japply(jm, params, jmplug.MPLUG.pretrain_loss, jnp.asarray(v),
                   jnp.asarray(ids), jnp.asarray(mask), mlm_ids, mlm_labels,
                   rng=jax.random.key(3), **kw)
    with torch.no_grad():
        got = tm.pretrain_loss(t(v), t(ids), t(mask),
                               t(np.asarray(mlm_ids)),
                               t(np.asarray(mlm_labels)).long(),
                               generator=_gen(), **tkw)
    for k in ("loss", "loss_ita", "loss_itm", "loss_mlm", "image_feat",
              "text_feat"):
        close(got[k], want[k])
    assert got["neg_img_idx"].tolist() == [1, 0]


def test_cls_caption_rerank_match_jax(models):
    jm, params, tm = models
    rng = np.random.default_rng(3)
    v = video(rng)
    ids, mask = tokens(rng)
    cap, cap_mask = tokens(rng)
    labels = np.array([2, 0], np.int32)
    j = [jnp.asarray(a) for a in (v, ids, mask)]
    with torch.no_grad():
        got = tm.cls_forward(t(v), t(ids), t(mask), labels=t(labels).long())
        want = _japply(jm, params, jmplug.MPLUG.cls_forward, *j,
                       labels=jnp.asarray(labels))
        assert got["logits"].shape == (2, CLASSES)
        for k in ("logits", "loss"):
            close(got[k], want[k])
        for fused in (False, True):
            extra = dict(input_ids=j[1], attention_mask=j[2]) if fused \
                else {}
            want = _japply(jm, params, jmplug.MPLUG.caption_loss, j[0],
                           jnp.asarray(cap), jnp.asarray(cap_mask), **extra)
            textra = dict(input_ids=t(ids), attention_mask=t(mask)) \
                if fused else {}
            got = tm.caption_loss(t(v), t(cap), t(cap_mask), **textra)
            close(got["loss"], want["loss"])
        want = _japply(jm, params, jmplug.MPLUG.itm_rerank_score, *j)
        close(tm.itm_rerank_score(t(v), t(ids), t(mask)), want)


@pytest.mark.parametrize("queues", [False, True])
def test_retrieval_loss_matches_jax(models, queues):
    """idx-matched ITC (a queue id equal to a batch id is a positive too)
    and ITM."""
    jm, params, tm = models
    rng = np.random.default_rng(4)
    v = video(rng)
    ids, mask = tokens(rng)
    idx = np.array([7, 9], np.int32)
    kw, tkw = {}, {}
    if queues:
        iq, tq = _queues(rng)
        idq = np.full((1, 16), -100, np.int32)
        idq[0, 3] = 9
        kw = dict(image_queue=jnp.asarray(iq), text_queue=jnp.asarray(tq),
                  idx_queue=jnp.asarray(idq), alpha=0.4)
        tkw = dict(image_queue=t(iq), text_queue=t(tq), idx_queue=t(idq),
                   alpha=0.4)
    want = _japply(jm, params, jmplug.MPLUG.retrieval_loss, jnp.asarray(v),
                   jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(idx),
                   rng=jax.random.key(4), **kw)
    with torch.no_grad():
        got = tm.retrieval_loss(t(v), t(ids), t(mask), t(idx),
                                generator=_gen(), **tkw)
    for k in ("loss", "loss_ita", "loss_itm"):
        close(got[k], want[k])


def _jax_negatives(jm, params, v, ids, mask, feats_m, rng, fold=17):
    """The hard negatives JAX's pretrain_loss draws from ``rng``."""
    def feats(m, v, ids, mask):
        emb = m.encode_image(v)
        i = m.vision_proj(emb[:, 0])
        i = i / jnp.linalg.norm(i, axis=-1, keepdims=True)
        tx = m.text_proj(m.encode_text(ids, mask)[:, 0])
        tx = tx / jnp.linalg.norm(tx, axis=-1, keepdims=True)
        return i, tx, jnp.clip(m.temp, 0.001, 0.5)
    i, tx, temp = jm.apply({"params": params}, v, ids, mask, method=feats)
    b = i.shape[0]
    sim_i2t = i @ feats_m["text_feat"].T / temp
    sim_t2i = tx @ feats_m["image_feat"].T / temp
    diag = jnp.where(jnp.eye(b, dtype=bool), -1e9, 0.0)
    k1, k2 = jax.random.split(jax.random.fold_in(rng, fold))
    return (np.asarray(jax.random.categorical(k1, sim_t2i + diag, axis=1)),
            np.asarray(jax.random.categorical(k2, sim_i2t + diag, axis=1)))


@pytest.mark.parametrize("b,queue_size,steps", [(2, 16, 2), (3, 8, 3)])
def test_pretrain_trajectory_with_momentum_matches_jax(b, queue_size, steps):
    """AdamW steps of pretrain_loss (alpha 0.4, the twin's features, the
    queues) each followed by update_momentum: losses, grad norms, every
    parameter, the twin, both queues and the pointer against JAX's
    make_train_step and update_momentum (JAX's negatives passed to the
    port at batch 3, where the draw has two choices).  Batch 3 over a
    size-8 queue: pointer 0, 3, 6, then a write clamped to start 5 and
    the pointer at 1."""
    rng = np.random.default_rng(5)
    jm, params, tm = build(rng, b=b, queue_size=queue_size)
    # evaluation mode, as JAX's deterministic loss: the generator draws
    # the negatives alone
    opt = dict(lr=1e-3, min_lr=1e-5, weight_decay=0.05,
               opt_betas=(0.9, 0.999), opt_eps=1e-6, clip_grad=3.0,
               epochs=1, niter_per_ep=steps, freeze_text_decoder=False)
    jst, tx, _ = j_state(params, jfactory.OptimizerConfig(**opt))
    jms = jmplug.init_momentum_state(params, EMBED, queue_size)
    tst, _, _ = create_train_state(tm, tfactory.OptimizerConfig(**opt))
    tms = tmplug.init_momentum_state(tm, EMBED, queue_size)
    bridge.load_momentum_state(tms, jms)

    def jloss(p, batch, rng_, step):
        return jm.apply({"params": p}, batch["video"], batch["ids"],
                        batch["mask"], batch["mlm_ids"], batch["mlm_labels"],
                        feats_m=batch["feats_m"],
                        image_queue=batch["image_queue"],
                        text_queue=batch["text_queue"], alpha=0.4, rng=rng_,
                        method=jmplug.MPLUG.pretrain_loss)

    jtrain = jax.jit(j_step(jloss, tx))

    def tloss(batch):
        return tm.pretrain_loss(
            batch["video"], batch["ids"], batch["mask"], batch["mlm_ids"],
            batch["mlm_labels"], feats_m=batch["feats_m"],
            image_queue=tms.image_queue, text_queue=tms.text_queue,
            alpha=0.4, generator=_gen(), neg_idx=batch["neg"])

    ttrain = make_train_step(tloss)
    for step in range(steps):
        v = video(rng, b)
        ids, mask = tokens(rng, rows=b)
        mlm_ids, mlm_labels = jmplug.mlm_mask_tokens(
            jax.random.key(step), jnp.asarray(ids), jnp.asarray(mask), 256)
        jv = [jnp.asarray(a) for a in (v, ids, mask)]
        feats_m = _japply(jm, jms.ema_params,
                          jmplug.MPLUG.momentum_features, *jv)
        key = jax.random.key(100 + step)
        neg = _jax_negatives(jm, jst.params, *jv, feats_m, key)
        jst, jmet = jtrain(jst, {
            "video": jv[0], "ids": jv[1], "mask": jv[2], "mlm_ids": mlm_ids,
            "mlm_labels": mlm_labels, "feats_m": feats_m,
            "image_queue": jms.image_queue, "text_queue": jms.text_queue},
            key)
        jms = jmplug.update_momentum(jms, jst.params, feats_m["image_feat"],
                                     feats_m["text_feat"])
        with torch.no_grad():
            tfeats = tms.ema.momentum_features(t(v), t(ids), t(mask))
        met = ttrain(tst, {"video": t(v), "ids": t(ids), "mask": t(mask),
                           "mlm_ids": t(np.asarray(mlm_ids)),
                           "mlm_labels": t(np.asarray(mlm_labels)).long(),
                           "feats_m": tfeats,
                           "neg": [t(n) for n in neg]})
        tmplug.update_momentum(tms, tm, tfeats["image_feat"],
                               tfeats["text_feat"])
        for k in ("loss", "loss_ita", "loss_itm", "loss_mlm", "grad_norm"):
            close(met[k], jmet[k])
        jflat = flat(jax.device_get(jst.trainable))
        assert set(jflat) == set(tst.trainable) and not tst.frozen
        for path, p in tst.trainable.items():
            close(p, jflat[path], PARAM_TOL)
        jema = flat(jax.device_get(jms.ema_params))
        for path, p in tms.ema_params.items():
            close(p, jema[path], PARAM_TOL)
        for name in ("image_queue", "text_queue"):
            close(getattr(tms, name), getattr(jms, name))
        assert tms.ptr == int(jms.ptr)
    assert tms.ptr == (steps * b) % queue_size
    if b == 3:  # the third write started at Q - B = 5: column 0 of step 1
        assert tms.ptr == 1
        np.testing.assert_array_equal(tms.idx_queue.numpy(),
                                      np.asarray(jms.idx_queue))


def test_update_momentum_clamps_the_write_as_jax():
    """ptr 6 of 8, batch 3: JAX's dynamic_update_slice writes columns
    5-7 (not 6, 7, 0) and the pointer becomes 1; ids too."""
    rng = np.random.default_rng(6)
    _, tcfg = cfgs(queue_size=8)
    tm = tmplug.MPLUG(tcfg, FP32_POLICY)
    bridge.seeded_init(tm, 0)
    tms = tmplug.init_momentum_state(tm, EMBED, 8)
    jms = jmplug.MomentumState(
        ema_params={}, image_queue=jnp.asarray(tms.image_queue.numpy()),
        text_queue=jnp.asarray(tms.text_queue.numpy()),
        idx_queue=jnp.asarray(tms.idx_queue.numpy()),
        ptr=jnp.asarray(6, jnp.int32))
    tms.ptr = 6
    fi, ft = (rng.normal(size=(3, EMBED)).astype(np.float32)
              for _ in range(2))
    idx = np.array([4, 5, 6])
    jms = jmplug.update_momentum(jms, {}, jnp.asarray(fi), jnp.asarray(ft),
                                 idx=jnp.asarray(idx))
    tmplug.update_momentum(tms, tm, t(fi), t(ft), idx=t(idx))
    for name in ("image_queue", "text_queue", "idx_queue"):
        np.testing.assert_array_equal(getattr(tms, name).numpy(),
                                      np.asarray(getattr(jms, name)))
    assert tms.ptr == int(jms.ptr) == 1
    assert tms.idx_queue[0, 5:].tolist() == [4, 5, 6]


@pytest.mark.parametrize("beam,fused", [(1, False), (3, False), (3, True)])
def test_generation_tokens_match_jax(models, beam, fused):
    """Greedy and beam-3 (min_length 2) tokens, from the image tokens or
    the fused [image; text] states."""
    jm, params, tm = models
    rng = np.random.default_rng(7)
    v = video(rng)
    ids, mask = tokens(rng)
    kw = dict(bos_id=101, eos_id=102, max_new_tokens=6, beam_size=beam,
              min_length=2 if beam > 1 else 0)
    jkw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(
        mask)) if fused else {}
    tkw = dict(input_ids=t(ids), attention_mask=t(mask)) if fused else {}
    want = jmplug.mplug_generate(jm, params, jnp.asarray(v), **kw, **jkw)
    got = tmplug.mplug_generate(tm, t(v), **kw, **tkw)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlm_mask_law():
    """Over many seeded draws: ~15% of the eligible positions picked,
    80/10/10 among them, [PAD] / [CLS] / [SEP] and unattended positions
    never, labels the original ids exactly where picked."""
    rng = np.random.default_rng(8)
    ids, mask = tokens(rng, rows=64, s=32)
    mask[:, -3:] = 0  # attended-off ids that are not [PAD]
    ids_t, mask_t = t(ids).long(), t(mask)
    gen = _gen(3)
    eligible = (mask == 1) & ~np.isin(ids, (0, 101, 102))
    picked = to_mask = to_rand = kept = total = 0
    for _ in range(20):
        out, labels = tmplug.mlm_mask_tokens(ids_t, mask_t, 256, gen)
        out, labels = out.numpy(), labels.numpy()
        sel = labels != -100
        assert not (sel & ~eligible).any()
        np.testing.assert_array_equal(labels[sel], ids[sel])
        np.testing.assert_array_equal(out[~sel], ids[~sel])
        picked += sel.sum()
        total += eligible.sum()
        to_mask += (out[sel] == 103).sum()
        kept += (out[sel] == ids[sel]).sum()
        to_rand += ((out[sel] != 103) & (out[sel] != ids[sel])).sum()
    assert abs(picked / total - 0.15) < 0.01
    assert abs(to_mask / picked - 0.8) < 0.02
    assert abs(kept / picked - 0.1) < 0.02  # a random id may equal it
    assert abs(to_rand / picked - 0.1) < 0.02


def test_hard_negative_law():
    """Never the positive (the diagonal, or every same-idx pair); the
    picks' frequencies follow softmax over the others."""
    sim = torch.tensor([[0.0, 1.0, 0.5, -1.0],
                        [2.0, 0.0, 0.0, 1.0],
                        [0.3, 0.3, 0.0, 0.3],
                        [1.0, -0.5, 0.2, 0.0]])
    same = torch.eye(4, dtype=torch.bool)
    same[0, 2] = same[2, 0] = True  # clips 0 and 2 share an idx
    gen = _gen(11)
    counts = np.zeros((4, 4))
    n = 4000
    for _ in range(n):
        img, txt = tmplug.draw_negatives(sim, sim.T, same, gen)
        counts[np.arange(4), img.numpy()] += 1
    assert (counts[same.numpy()] == 0).all()
    want = torch.softmax(sim.masked_fill(same, -1e9), -1).numpy()
    np.testing.assert_allclose(counts / n, want, atol=0.03)
    with pytest.raises(ValueError, match="Generator"):
        tmplug.draw_negatives(sim, sim, same, None)


def test_bert_dropout_in_training_not_in_evaluation(models):
    """In training mode a generator's masks drop the BERT's hidden states
    (the same seed the same masks); in evaluation mode the generator
    changes nothing."""
    _, _, tm = models
    rng = np.random.default_rng(9)
    ids, mask = tokens(rng)
    with torch.no_grad():
        base = tm.encode_text(t(ids), t(mask))
        tm.train()
        try:
            a = tm.encode_text(t(ids), t(mask), _gen(1))
            b = tm.encode_text(t(ids), t(mask), _gen(1))
            c = tm.encode_text(t(ids), t(mask), _gen(2))
        finally:
            tm.eval()
        d = tm.encode_text(t(ids), t(mask), _gen(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, base, atol=1e-3)
    assert torch.equal(d, base)


@pytest.mark.parametrize("opt", [
    dict(freeze_text_decoder=False),
    dict(freeze_text_decoder=True, freeze_vit=True),
    dict(freeze_text_decoder=False, layer_decay=0.9,
         layer_decay_num_layers=1,
         lr_scale_rules=(("fusion_encoder", 0.5), ("mlm_head", 2.0)))])
def test_optimizer_masks_classify_every_leaf_as_jax(models, opt):
    """decay, freeze and lr-scale (rules, layer decay) masks over the
    whole mPLUG tree against JAX's on the same leaves."""
    _, params, tm = models
    named = {bridge.jax_path(n): p for n, p in tm.named_parameters()}
    cfg = tfactory.OptimizerConfig(**opt)
    jcfg = jfactory.OptimizerConfig(**opt)
    want_decay = flat(jfactory.decay_mask(params))
    want_freeze = flat(jfactory.freeze_mask(params, cfg.freeze_text_decoder,
                                            cfg.freeze_vit))
    want_scale = flat(jfactory.lr_scale_tree(params, False,
                                             cfg.lr_scale_rules))
    if cfg.layer_decay is not None:
        ld = flat(jfactory.layer_decay_scale_tree(
            params, jcfg.layer_decay, jcfg.layer_decay_num_layers))
        want_scale = {k: v * ld[k] for k, v in want_scale.items()}
    assert tfactory.decay_mask(named) == want_decay
    assert tfactory.freeze_mask(named, cfg.freeze_text_decoder,
                                cfg.freeze_vit) == want_freeze
    got_scale = tfactory.leaf_scales(named, cfg)
    assert set(got_scale) == set(want_scale)
    for k, v in want_scale.items():
        assert got_scale[k] == pytest.approx(float(v), rel=1e-6), k
    assert not want_decay["text_encoder/encoder/layer_0/attention/out/bias"]
    assert want_decay["fusion_encoder/fusion_encoder/layer_1/ffn/output/"
                      "kernel"]
