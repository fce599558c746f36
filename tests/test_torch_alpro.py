"""The port's ALPRO (``models/alpro.py``) against the JAX package's at
fp32: the bridge's round trip of ``ALPRO.full_init`` (one BERT parameter
set for the text and fusion halves), ``encode_image`` (the frame mean of
the patch tokens), ``encode_text`` / ``fuse`` (the two ``layer_range``
halves), ``pretrain_loss``, ``retrieval_loss`` and ``cls_forward`` at
batch 2 (the hard negatives forced), on a vision tower narrower than the
BERT (``visn_fc`` and ``visn_layer_norm`` run) and one as wide.
Tolerance 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_bert_family import (
    VISION_KW,
    bert_cfgs,
    close,
    flat,
    redraw,
    t,
    tokens,
    video,
    vision_cfgs,
)
from youku_mplug_tpu.models import alpro as jalpro
from youku_mplug_tpu.models import mplug as jmplug
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import alpro as talpro
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
EMBED, CLASSES = 8, 3


@pytest.fixture(scope="module", params=[24, 32], ids=["visn_fc", "same"])
def models(request):
    rng = np.random.default_rng(request.param)
    jb, tb = bert_cfgs()
    vkw = dict(VISION_KW, embed_dim=request.param)
    jv, tv = vision_cfgs(embed_dim=request.param)
    kw = dict(embed_dim=EMBED, num_classes=CLASSES)
    jm = jalpro.ALPRO(jalpro.ALPROConfig(vision=jv, bert=jb, **kw),
                      policy=J_FP32)
    ids, mask = tokens(rng)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video(rng, v=vkw)), jnp.asarray(ids),
        jnp.asarray(mask), method=jalpro.ALPRO.full_init))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        talpro.ALPRO(talpro.ALPROConfig(vision=tv, bert=tb, **kw),
                     FP32_POLICY), params)
    return jm, params, tm.eval(), vkw


def _japply(jm, params, method, *args, **kw):
    return jm.apply({"params": params}, *args, method=method, **kw)


def test_bridge_round_trip_of_full_init(models):
    jm, params, tm, vkw = models
    names = {bridge.jax_path(n) for n, _ in tm.named_parameters()}
    assert names == set(flat(params))
    assert sorted(params["text_encoder"]["encoder"]) == ["layer_0",
                                                         "layer_1"]
    assert ("visn_fc/kernel" in names) == (vkw["embed_dim"] != 32)


def test_encoders_match_jax(models):
    """The frame-mean image embeds [B, 1 + N, 32], the text half and the
    fusion half over [text; image]."""
    jm, params, tm, vkw = models
    rng = np.random.default_rng(1)
    v = video(rng, v=vkw)
    ids, mask = tokens(rng)
    img = _japply(jm, params, jalpro.ALPRO.encode_image, jnp.asarray(v))
    txt = _japply(jm, params, jalpro.ALPRO.encode_text, jnp.asarray(ids),
                  jnp.asarray(mask))
    img_mask = jnp.ones(img.shape[:2], jnp.int32)
    fused = _japply(jm, params, jalpro.ALPRO.fuse, txt, jnp.asarray(mask),
                    img, img_mask)
    with torch.no_grad():
        got_img = tm.encode_image(t(v))
        got_txt = tm.encode_text(t(ids), t(mask))
        got_fused = tm.fuse(t(np.asarray(txt)), t(mask),
                            t(np.asarray(img)), t(np.asarray(img_mask)))
    assert tuple(got_img.shape) == (2, 1 + 4, 32)
    close(got_img, img)
    close(got_txt, txt)
    close(got_fused, fused)


def test_losses_match_jax(models):
    """pretrain_loss (JAX's MLM masks), retrieval_loss with two clips of
    distinct ids, and cls_forward with labels."""
    jm, params, tm, vkw = models
    rng = np.random.default_rng(2)
    v = video(rng, v=vkw)
    ids, mask = tokens(rng)
    mlm_ids, mlm_labels = jmplug.mlm_mask_tokens(
        jax.random.key(5), jnp.asarray(ids), jnp.asarray(mask), 256,
        mlm_probability=0.5)
    j = [jnp.asarray(a) for a in (v, ids, mask)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        want = _japply(jm, params, jalpro.ALPRO.pretrain_loss, *j, mlm_ids,
                       mlm_labels, rng=jax.random.key(3))
        got = tm.pretrain_loss(t(v), t(ids), t(mask), t(np.asarray(mlm_ids)),
                               t(np.asarray(mlm_labels)).long(),
                               generator=gen)
        for k in ("loss", "loss_ita", "loss_itm", "loss_mlm"):
            close(got[k], want[k])
        idx = np.array([4, 1], np.int32)
        want = _japply(jm, params, jalpro.ALPRO.retrieval_loss, *j,
                       jnp.asarray(idx), rng=jax.random.key(4))
        got = tm.retrieval_loss(t(v), t(ids), t(mask), t(idx),
                                generator=gen)
        for k in ("loss", "loss_ita", "loss_itm", "image_feat",
                  "text_feat"):
            close(got[k], want[k])
        labels = np.array([1, 2], np.int32)
        want = _japply(jm, params, jalpro.ALPRO.cls_forward, *j,
                       labels=jnp.asarray(labels))
        got = tm.cls_forward(t(v), t(ids), t(mask), labels=t(labels).long())
        assert got["logits"].shape == (2, CLASSES)
        for k in ("logits", "loss"):
            close(got[k], want[k])
