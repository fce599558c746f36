"""What the port's BERT-family tests share: the tiny configs (the JAX e2e
tests' ``bert_overrides``: hidden 32, 4 heads, 2 layers, vocab 256; a
one-block TimeSformer of 2 frames at 32 px), the redraw of a JAX tree
from numpy, inputs, and the comparison at the stated tolerance."""

import dataclasses

import jax
import numpy as np
import torch

from youku_mplug_tpu.models import bert as jbert
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu_torch.models import bert as tbert
from youku_mplug_tpu_torch.models import vision as tvision

TOL = 1e-4           # fp32, sums in another order
PARAM_TOL = 2e-5     # parameters after AdamW steps of lr 1e-3
B, S, VOCAB = 2, 8, 256
BERT_KW = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=64, encoder_width=32, fusion_layer=1,
               text_encoder_layers=1, text_decoder_layers=2,
               hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
VISION_KW = dict(img_size=32, patch_size=16, embed_dim=32, depth=1,
                 num_heads=2, num_frames=2, mlp_ratio=2.0)


def bert_cfgs(**over):
    """(JAX BertConfig, port BertConfig) of the tiny BERT."""
    kw = dict(BERT_KW, **over)
    return jbert.BertConfig(**kw), tbert.BertConfig(**kw)


def vision_cfgs(**over):
    kw = dict(VISION_KW, **over)
    return jvision.VisionConfig(**kw), tvision.VisionConfig(**kw)


def redraw(tree, rng, std=0.2):
    """Every leaf drawn from numpy: LayerNorm scales 1 + N(0, 0.1),
    ``temp`` 0.07, a matrix N(0, min(std, 1.6 / sqrt(fan_in))), else
    N(0, std) (no leaf zero, activations of order one)."""
    def leaf(path, x):
        name = str(path[-1].key)
        z = rng.normal(size=x.shape).astype(np.float32)
        if name == "temp":
            return np.float32(0.07)
        if name.endswith("scale"):
            return 1.0 + 0.1 * z
        if len(x.shape) >= 2:
            fan_in = int(np.prod(x.shape)) // x.shape[-1]
            return min(std, 1.6 / fan_in ** 0.5) * z
        return std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def tokens(rng, rows=B, s=S, vocab=VOCAB):
    """BERT-style ids [rows, s]: [CLS] 101, words from 104, [SEP] 102,
    [PAD] 0 past a random length (row 0 full), with the mask."""
    ids = rng.integers(104, vocab, size=(rows, s))
    lengths = rng.integers(4, s + 1, size=(rows,))
    lengths[0] = s
    pos = np.arange(s)[None]
    ids = np.where(pos == 0, 101, ids)
    ids = np.where(pos == lengths[:, None] - 1, 102, ids)
    mask = (pos < lengths[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def video(rng, b=B, v=None):
    v = v or VISION_KW
    return rng.normal(size=(b, 3, v["num_frames"], v["img_size"],
                            v["img_size"])).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
