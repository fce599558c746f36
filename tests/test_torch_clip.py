"""The port's CLIP, XCLIP / VideoFormer, ``inflate_clip_to_videoformer``
and ``clip_params_from_torch`` against the JAX package
(``models/clip.py``, ``models/clip_video.py``) at fp32 on the CPU, at the
config of JAX's ``tests/test_clip.py`` (32 px, two blocks a tower),
weights carried by the bridge: features and logits at 1e-4, the
converted and inflated trees exactly, and the inflate contract (MHRA's
zero ``expand``: a repeated frame gives equal per-frame tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import clip as jclip
from youku_mplug_tpu.models import clip_video as jcv
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import clip as tclip
from youku_mplug_tpu_torch.models import clip_video as tcv
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
CFG_KW = dict(image_resolution=32, vision_width=64, vision_layers=2,
              vision_patch_size=16, embed_dim=16, context_length=12,
              vocab_size=99, transformer_width=32, transformer_heads=4,
              transformer_layers=2)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _redraw(tree, rng):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        name = str(path[-1].key)
        if name == "logit_scale":
            return np.float32(np.log(1 / 0.07))
        return 1.0 + 0.1 * z if name == "scale" else 0.2 * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _text():
    text = np.zeros((2, 12), np.int64)
    text[0, :5] = [1, 40, 41, 42, 98]   # the EOT (max id) at 4
    text[1, :7] = [1, 50, 51, 52, 53, 54, 98]
    return text


def test_clip_matches_jax():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    text = _text()
    jm = jclip.CLIP(jclip.CLIPConfig(**CFG_KW), policy=J_FP32)
    params = _redraw(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(images), jnp.asarray(text)))[
        "params"], rng)
    tm = bridge.load_jax_params(tclip.CLIP(tclip.CLIPConfig(**CFG_KW),
                                           FP32_POLICY), params)
    ti, tt = torch.from_numpy(images), torch.from_numpy(text)
    want_img, want_txt, want_logits = jax.jit(lambda p: (
        jm.apply({"params": p}, jnp.asarray(images),
                 method=jclip.CLIP.encode_image),
        jm.apply({"params": p}, jnp.asarray(text),
                 method=jclip.CLIP.encode_text),
        jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(text))))(
        params)
    with torch.no_grad():
        _close(tm.encode_image(ti), want_img)
        _close(tm.encode_text(tt), want_txt)
        for got, want in zip(tm(ti, tt), want_logits):
            _close(got, want)


def _openai_state_dict(rng, cfg):
    """An OpenAI-named CLIP state dict of random numpy values."""
    w, tw, p = cfg.vision_width, cfg.transformer_width, \
        cfg.vision_patch_size
    sd = {"visual.conv1.weight": (w, 3, p, p),
          "visual.class_embedding": (w,),
          "visual.positional_embedding": ((cfg.image_resolution // p) ** 2
                                          + 1, w),
          "visual.ln_pre.weight": (w,), "visual.ln_pre.bias": (w,),
          "visual.ln_post.weight": (w,), "visual.ln_post.bias": (w,),
          "visual.proj": (w, cfg.embed_dim),
          "token_embedding.weight": (cfg.vocab_size, tw),
          "positional_embedding": (cfg.context_length, tw),
          "ln_final.weight": (tw,), "ln_final.bias": (tw,),
          "text_projection": (tw, cfg.embed_dim), "logit_scale": ()}
    for prefix, width, n in (("visual.transformer", w, cfg.vision_layers),
                             ("transformer", tw, cfg.transformer_layers)):
        for i in range(n):
            b = f"{prefix}.resblocks.{i}"
            sd.update({f"{b}.ln_1.weight": (width,),
                       f"{b}.ln_1.bias": (width,),
                       f"{b}.ln_2.weight": (width,),
                       f"{b}.ln_2.bias": (width,),
                       f"{b}.attn.in_proj_weight": (3 * width, width),
                       f"{b}.attn.in_proj_bias": (3 * width,),
                       f"{b}.attn.out_proj.weight": (width, width),
                       f"{b}.attn.out_proj.bias": (width,),
                       f"{b}.mlp.c_fc.weight": (4 * width, width),
                       f"{b}.mlp.c_fc.bias": (4 * width,),
                       f"{b}.mlp.c_proj.weight": (width, 4 * width),
                       f"{b}.mlp.c_proj.bias": (width,)})
    return {k: np.asarray(0.2 * rng.normal(size=s), np.float32)
            for k, s in sd.items()}


def test_clip_params_from_torch_matches_jax_and_loads():
    """The converted tree equals JAX's leaf for leaf (numpy and tensor
    values alike), loads into the port's CLIP with nothing left over,
    and the loaded model's features match JAX's on that tree."""
    rng = np.random.default_rng(1)
    cfg = tclip.CLIPConfig(**CFG_KW)
    sd = _openai_state_dict(rng, cfg)
    want = _flat(jax.tree.map(np.asarray, jclip.clip_params_from_torch(
        sd, jclip.CLIPConfig(**CFG_KW))))
    for source in (sd, {k: torch.tensor(v) for k, v in sd.items()}):
        got = _flat(tclip.clip_params_from_torch(source, cfg))
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), want[k]), k
    tm = bridge.load_jax_params(tclip.CLIP(cfg, FP32_POLICY),
                                tclip.clip_params_from_torch(sd, cfg))
    images = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jclip.CLIP(jclip.CLIPConfig(**CFG_KW), policy=J_FP32)
    with torch.no_grad():
        _close(tm.encode_image(torch.from_numpy(images)), jm.apply(
            {"params": jclip.clip_params_from_torch(
                sd, jclip.CLIPConfig(**CFG_KW))}, jnp.asarray(images),
            method=jclip.CLIP.encode_image))


@pytest.mark.parametrize("down,double", [(False, False), (True, True)])
def test_xclip_matches_jax(down, double):
    rng = np.random.default_rng(2 + down)
    kw = dict(num_frames=4, temporal_downsampling=down, double_lmhra=double)
    jcfg = jcv.VideoFormerConfig(clip=jclip.CLIPConfig(**CFG_KW), **kw)
    tcfg = tcv.VideoFormerConfig(clip=tclip.CLIPConfig(**CFG_KW), **kw)
    video = rng.normal(size=(2, 3, 4, 32, 32)).astype(np.float32)
    text = _text()
    jm = jcv.XCLIP(jcfg, policy=J_FP32)
    params = _redraw(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(text)))[
        "params"], rng)
    tm = bridge.load_jax_params(tcv.XCLIP(tcfg, FP32_POLICY), params)
    tv, tt = torch.from_numpy(video), torch.from_numpy(text)
    with torch.no_grad():
        tokens = tm.visual(tv)
        assert tokens.shape == ((2 * 2 if down else 2 * 4), 5, 64)
        _close(tokens, jcv.VideoFormer(jcfg, policy=J_FP32).apply(
            {"params": params["visual"]}, jnp.asarray(video)))
        _close(tm.encode_video(tv), jm.apply(
            {"params": params}, jnp.asarray(video),
            method=jcv.XCLIP.encode_video))
        for got, want in zip(tm(tv, tt), jm.apply(
                {"params": params}, jnp.asarray(video), jnp.asarray(text))):
            _close(got, want)


@pytest.mark.parametrize("down", [False, True])
def test_inflate_matches_jax_and_keeps_the_contract(down):
    """The inflated leaves equal JAX's exactly; merged into a VideoFormer
    tree whose MHRA ``expand`` is zero (the reference's init), the port's
    tower gives a clip of one repeated frame equal tokens for every
    frame (per-frame CLIP) and JAX's tokens."""
    rng = np.random.default_rng(5)
    kw = dict(num_frames=2, temporal_downsampling=down)
    jcfg = jcv.VideoFormerConfig(clip=jclip.CLIPConfig(**CFG_KW), **kw)
    tcfg = tcv.VideoFormerConfig(clip=tclip.CLIPConfig(**CFG_KW), **kw)
    images = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    clip_params = _redraw(jax.eval_shape(lambda: jclip.CLIP(
        jclip.CLIPConfig(**CFG_KW), policy=J_FP32).init(
        jax.random.key(1), jnp.asarray(images),
        jnp.asarray(_text()[:1])))["params"], rng)
    want = _flat(jax.tree.map(np.asarray, jcv.inflate_clip_to_videoformer(
        clip_params, jcfg)))
    got = _flat(tcv.inflate_clip_to_videoformer(
        jax.tree.map(np.asarray, clip_params), tcfg))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), k
    vf = jcv.VideoFormer(jcfg, policy=J_FP32)
    frames = 4 if down else 2
    video = np.broadcast_to(images[:, :, None],
                            (1, 3, frames, 32, 32)).copy()
    tree = _flat(jax.tree.map(np.asarray, vf.init(
        jax.random.key(2), jnp.asarray(video))["params"]))
    assert not any(np.any(v) for k, v in tree.items()
                   if k.endswith("expand/kernel"))
    tree.update(got)
    tree = bridge.unflatten(tree)
    tm = bridge.load_jax_params(tcv.VideoFormer(tcfg, FP32_POLICY), tree)
    with torch.no_grad():
        toks = tm(torch.from_numpy(video))
    _close(toks, vf.apply({"params": tree}, jnp.asarray(video)))
    if down:  # the zero padding makes the first and last taps differ
        assert toks.shape[0] == 2
    else:
        _close(toks[0], toks[1], 1e-5)
        # and per-frame CLIP: the tower's tokens before ln_post
        cm = bridge.load_jax_params(tclip.CLIP(tclip.CLIPConfig(**CFG_KW),
                                               FP32_POLICY),
                                    jax.tree.map(np.asarray, clip_params))
        with torch.no_grad():
            _, raw = cm.visual(torch.from_numpy(images))
            _close(toks[0], cm.visual.ln_post(raw)[0], 1e-5)


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(tclip.quick_gelu(torch.from_numpy(x)),
           jclip.quick_gelu(jnp.asarray(x)), 1e-6)
