"""The port's BERT stack (``models/bert.py``) against the JAX package's
``models/bert.py`` at fp32: ``BertModel`` (padded text, a cross-attending
decoder with prefix, a ``layer_range`` slice), ``FusionModel`` (the
shipped stride, and stride 1, where the connected layer runs),
``BertPrefixModel`` with labels, ``BertLMHead`` tied, ``extend_mask``
and ``BertConfig.from_json_file`` on both shipped JSONs.  Each JAX leaf
is redrawn from numpy and carried over by the bridge, which must consume
the whole tree.  Tolerance 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_bert_family import bert_cfgs, close, redraw, t, tokens
from youku_mplug_tpu.models import bert as jbert
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import bert as tbert

torch.set_num_threads(1)


def _carry(jmod, tmod, *args, **kw):
    params = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *args,
                                              **kw))["params"]
    params = redraw(params, np.random.default_rng(7))
    return params, bridge.load_jax_params(tmod, params).eval()


@pytest.mark.parametrize("path", ["configs/models/config_bert_zh_mplug.json",
                                  "configs/models/config_bert_zh_alpro.json",
                                  "configs/models/config_bert_mplug.json"])
def test_from_json_file_matches_jax(path):
    want = dataclasses.asdict(jbert.BertConfig.from_json_file(path))
    got = dataclasses.asdict(tbert.BertConfig.from_json_file(path))
    assert got == want
    if "zh_mplug" in path:  # the plural spelling read as fusion_layer
        assert got["fusion_layer"] == 6 and got["stride_layer"] == 6


@pytest.mark.parametrize("kind", ["plain", "causal", "prefix"])
def test_extend_mask_matches_jax(kind):
    rng = np.random.default_rng(1)
    _, mask = tokens(rng, rows=3)
    prefix = np.array([2, 0, 5], np.int32) if kind == "prefix" else None
    causal = kind != "plain"
    want = jbert.extend_mask(jnp.asarray(mask), causal=causal,
                             prefix_len=None if prefix is None
                             else jnp.asarray(prefix))
    got = tbert.extend_mask(t(mask), causal=causal,
                            prefix_len=None if prefix is None else t(prefix))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() == -10000.0


@pytest.mark.parametrize("case", ["encoder", "decoder_cross_prefix",
                                  "layer_range", "num_layers"])
def test_bert_model_matches_jax(case):
    """Padded text; the decoder form (causal, a per-row prefix, cross
    attention to 24-wide states with a padded mask); one layer of two by
    ``layer_range`` and by ``num_layers``."""
    rng = np.random.default_rng(2)
    cross = case == "decoder_cross_prefix"
    jcfg, tcfg = bert_cfgs(add_cross_attention=cross, encoder_width=24)
    ids, mask = tokens(rng)
    enc = rng.normal(size=(2, 5, 24)).astype(np.float32)
    enc_mask = np.array([[1] * 5, [1, 1, 1, 0, 0]], np.int32)
    kw = {}
    if cross:
        kw = dict(encoder_hidden_states=enc, encoder_attention_mask=enc_mask,
                  is_decoder=True, prefix_len=np.array([3, 1], np.int32))
    if case == "layer_range":
        kw = dict(layer_range=(1, 2))
    if case == "num_layers":
        kw = dict(num_layers=1)
    jm = jbert.BertModel(jcfg)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    params, tm = _carry(jm, tbert.BertModel(tcfg), jnp.asarray(ids),
                        jnp.asarray(mask), **dict(jkw, layer_range=None,
                                                  num_layers=None))
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                    **jkw)
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    with torch.no_grad():
        got = tm(t(ids), t(mask), **tkw)
    close(got, want)


@pytest.mark.parametrize("stride", [100, 1])
def test_fusion_model_matches_jax(stride):
    """Text cross-attending to a padded image stream; at stride 1 every
    layer but the first self-attends over [image; text] and updates the
    image stream (both streams compared)."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = bert_cfgs(stride_layer=stride, num_hidden_layers=3,
                           fusion_layer=3)
    ids, mask = tokens(rng)
    text = rng.normal(size=(2, ids.shape[1], 32)).astype(np.float32)
    image = rng.normal(size=(2, 6, 32)).astype(np.float32)
    image_mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    args = [jnp.asarray(a) for a in (text, mask, image, image_mask)]
    jm = jbert.FusionModel(jcfg)
    params, tm = _carry(jm, tbert.FusionModel(tcfg), *args)
    want = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = tm(t(text), t(mask), t(image), t(image_mask))
    for g, w in zip(got, want):
        close(g, w)
    connected = [tm.fusion_encoder.connected(i) for i in range(3)]
    assert connected == ([False, True, True] if stride == 1 else [False] * 3)
    assert (tm.fusion_encoder.layer_1.crossattention is None) == (stride == 1)


def test_prefix_model_with_labels_matches_jax():
    """The caption decoder: logits and HF's shifted loss with -100
    labels."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = bert_cfgs()
    ids, mask = tokens(rng)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    enc = rng.normal(size=(2, 5, 32)).astype(np.float32)
    enc_mask = np.ones((2, 5), np.int32)
    jm = jbert.BertPrefixModel(jcfg)
    args = [jnp.asarray(a) for a in (ids, mask)]
    kw = dict(encoder_hidden_states=jnp.asarray(enc),
              encoder_attention_mask=jnp.asarray(enc_mask),
              labels=jnp.asarray(labels))
    params, tm = _carry(jm, tbert.BertPrefixModel(tcfg), *args, **kw)
    want = jm.apply({"params": params}, *args, **kw)
    with torch.no_grad():
        got = tm(t(ids), t(mask), encoder_hidden_states=t(enc),
                 encoder_attention_mask=t(enc_mask), labels=t(labels).long())
    for k in ("last_hidden_state", "logits", "loss"):
        close(got[k], want[k])
    assert sorted(params["bert"]["encoder"]) == ["layer_0", "layer_1"]


def test_tied_lm_head_matches_jax():
    rng = np.random.default_rng(5)
    jcfg, tcfg = bert_cfgs()
    hidden = rng.normal(size=(2, 3, 32)).astype(np.float32)
    emb = rng.normal(size=(256, 32)).astype(np.float32)
    jm = jbert.BertLMHead(jcfg)
    params, tm = _carry(jm, tbert.BertLMHead(tcfg, tied=True),
                        jnp.asarray(hidden), jnp.asarray(emb))
    want = jm.apply({"params": params}, jnp.asarray(hidden),
                    jnp.asarray(emb))
    with torch.no_grad():
        got = tm(t(hidden), t(emb))
    close(got, want)
    assert tm.decoder is None
