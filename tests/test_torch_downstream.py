"""The port's downstream slice against the JAX package: the clip_model
TimeSformer (clip-b16's form: ``norm_pre``, no patch bias, heads of 96 on
einsum attention), the classification, retrieval and ITM methods of
``models/tasks.py``, ``lr_scale_tree`` and an AdamW trajectory of
``cls_train_loss``, the three CLIs and the reference downstream YAMLs.

The models are the JAX e2e test's tiny config (``TINY_TEXT``) with a head
dim 96 vision tower (``embed_dim`` 192, 2 heads, clip_model) and 128
learnable queries, so AttentionPool reaches the head-major flash wrapper
at d = 96 as clip-b16's does.  The JAX side is ``MPLUGVideo.full_init``
with ``use_cls``; its every leaf is redrawn from numpy (``redraw``: no
weight zero, activations of order one) and carried over by the bridge,
which must consume the whole tree.  The decoder keeps its 0.1 dropouts
and every method runs deterministic (JAX ``deterministic=True``, no
generator in the port; ``tests/test_torch_dropout.py`` holds dropout).
Tolerance 1e-4 (fp32, sums in another order), 2e-5 on parameters after
Adam steps of lr 1e-3.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu.optim import factory as jfactory
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.models import vision as tvision
from youku_mplug_tpu_torch.optim import factory as tfactory
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)
TOL = 1e-4
TINY_TEXT = {
    "vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 1,
    "num_attention_heads": 4, "max_position_embeddings": 192,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "layernorm_epsilon": 1e-5,
}
# head dim 96, as clip-b16's 8 heads of 96
TINY_VISION = {
    "img_size": 32, "patch_size": 16, "embed_dim": 192, "depth": 2,
    "num_heads": 2, "num_frames": 2, "mlp_ratio": 2, "clip_model": True,
}
QUERIES, CLASSES, EMBED = 128, 3, 8
B, S = 2, 12
REFERENCE_YAMLS = [
    f"configs/{task}_gpt3_{size}_youku_v0{suffix}.yaml"
    for size in ("1.3B", "2.7B")
    for task, suffix in (("cls/cls", "_sharp_2"),
                         ("retrieval/retrieval", ""),
                         ("retrieval/retrieval_itm", ""),
                         ("caption/caption", ""))]


def _text_kw():
    return dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, max_position_embeddings=192,
                layernorm_epsilon=1e-5, hidden_dropout=0.1,
                attention_dropout=0.1)


def _vision_kw(**over):
    kw = {k: v for k, v in TINY_VISION.items()}
    kw.update(over)
    return kw


def _cfgs(num_classes=CLASSES, **vision_over):
    jcfg = jtasks.MPLUGVideoConfig(
        vision=jvision.VisionConfig(**_vision_kw(**vision_over)),
        text=jgpt3.GPT3Config(**_text_kw()), num_learnable_token=QUERIES,
        contrastive_embed_dim=EMBED, use_cls=True, num_classes=num_classes)
    tcfg = ttasks.MPLUGVideoConfig(
        vision=tvision.VisionConfig(**_vision_kw(**vision_over)),
        text=tgpt3.GPT3Config(**_text_kw()), num_learnable_token=QUERIES,
        contrastive_embed_dim=EMBED, use_cls=True, num_classes=num_classes)
    return jcfg, tcfg


def redraw(tree, rng, std=0.2):
    """Every leaf drawn: LayerNorm scales 1 + N(0, 0.1), ``temp`` 0.07, a
    matrix N(0, min(std, 1.6 / sqrt(fan_in))) with fan_in its size over
    its last axis (activations stay O(1) through the 192-wide tower, so
    the fp32 tolerance is not spent on their magnitude), else N(0, std)."""
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tokens(rng, rows, s=S):
    """Padded ids [rows, s] (pad 2) with their mask, and prompt lengths."""
    ids = rng.integers(3, 128, size=(rows, s)).astype(np.int32)
    lengths = rng.integers(4, s + 1, size=(rows,))
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    plens = np.minimum(rng.integers(1, 4, size=(rows,)), lengths - 2)
    return ids, mask, plens.astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its redrawn full_init params, the port model, the
    video) on the tiny d = 96 config."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = _cfgs()
    v = jcfg.vision
    video = rng.normal(size=(B, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    ids, mask, _ = _tokens(rng, B)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(mask), method=jtasks.MPLUGVideo.full_init))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        ttasks.MPLUGVideo(tcfg, FP32_POLICY, proj_heads=True), params)
    return jm, params, tm.eval(), video


def _japply(jm, params, method, *args, **kw):
    return jm.apply({"params": params}, *args, method=method, **kw)


def test_bridge_takes_the_full_init_tree_with_cls_and_clip(models):
    """norm_pre, a bias-free patch embedding, cls_fc1/2 (3 outputs),
    vision_proj and text_proj: every JAX leaf has its port parameter."""
    _, params, tm, _ = models
    names = {bridge.jax_path(n) for n, _ in tm.named_parameters()}
    assert names == set(_flat(params))
    assert "visual_encoder/norm_pre/scale" in names
    assert "visual_encoder/patch_embed/bias" not in names
    assert tm.cls_fc2.kernel.shape == (32, CLASSES)
    assert {"vision_proj/kernel", "text_proj/kernel",
            "cls_fc1/kernel"} <= names


def test_clip_timesformer_matches_jax(models):
    """The clip_model TimeSformer (norm_pre over [cls; tokens], heads of
    96 on einsum attention with the period-2 mask) and the whole
    encode_video: pooled cls, query features, AttentionPool's output (128
    queries at d = 96 through the head-major flash wrapper)."""
    jm, params, tm, video = models
    want = _japply(jm, params, jtasks.MPLUGVideo.encode_video,
                   jnp.asarray(video))
    with torch.no_grad():
        got = tm.encode_video(_t(video))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    from youku_mplug_tpu_torch.ops.flash_attention import packed_supported
    assert not packed_supported(2, 96) and not packed_supported(8, 96)
    assert packed_supported(12, 64) and packed_supported(32, 128)


def test_last_token_index_matches_jax():
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.int32)
    for nq in (0, 5):
        want = jtasks.last_token_index(jnp.asarray(mask), n_query=nq)
        got = ttasks.last_token_index(_t(mask), n_query=nq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cls_inputs(rng):
    ids, mask, plens = _tokens(rng, B)
    pids, pmask, _ = _tokens(rng, B)
    labels = rng.integers(0, CLASSES, size=(B,)).astype(np.int32)
    return ids, mask, plens, pids, pmask, labels


def test_cls_methods_match_jax(models):
    """cls_logits_from_prompt, cls_train_loss (its three losses) and
    cls_eval_scores (each clip against 3 class pairs)."""
    jm, params, tm, video = models
    rng = np.random.default_rng(1)
    ids, mask, plens, pids, pmask, labels = _cls_inputs(rng)
    with torch.no_grad():
        qf = tm.encode_video(_t(video))[1]
        got = tm.cls_logits_from_prompt(qf, _t(pids).long(), _t(pmask))
    jqf = _japply(jm, params, jtasks.MPLUGVideo.encode_queries,
                  jnp.asarray(video))
    want = _japply(jm, params, jtasks.MPLUGVideo.cls_logits_from_prompt,
                   jqf, jnp.asarray(pids), jnp.asarray(pmask))
    assert got.shape == (B, CLASSES) and got.dtype == torch.float32
    _close(got, want)

    jargs = [jnp.asarray(a) for a in (video, ids, mask, plens)]
    want = _japply(jm, params, jtasks.MPLUGVideo.cls_train_loss, *jargs,
                   prompt_ids=jnp.asarray(pids),
                   prompt_mask=jnp.asarray(pmask),
                   labels=jnp.asarray(labels))
    with torch.no_grad():
        got = tm.cls_train_loss(_t(video), _t(ids).long(), _t(mask),
                                _t(plens), prompt_ids=_t(pids).long(),
                                prompt_mask=_t(pmask), labels=_t(labels))
    for k in ("loss", "loss_caption", "loss_cls"):
        _close(got[k], want[k])
    assert float(got["loss_cls"]) > 0

    rows = B * CLASSES
    eids, emask, eplens = _tokens(rng, rows)
    want = _japply(jm, params, jtasks.MPLUGVideo.cls_eval_scores,
                   jnp.asarray(video), jnp.asarray(eids),
                   jnp.asarray(emask), jnp.asarray(eplens),
                   prompt_ids=jnp.asarray(pids),
                   prompt_mask=jnp.asarray(pmask), num_cls=CLASSES)
    with torch.no_grad():
        got = tm.cls_eval_scores(_t(video), _t(eids).long(), _t(emask),
                                 _t(eplens), prompt_ids=_t(pids).long(),
                                 prompt_mask=_t(pmask), num_cls=CLASSES)
    assert got["generation_logits"].shape == (B, CLASSES)
    for k in ("generation_logits", "cls_logits"):
        _close(got[k], want[k])


def test_retrieval_methods_match_jax(models):
    """extract_vision_feature (the tower's pooled cls, projected and
    normalized), extract_text_feature and retrieval_loss with a repeated
    clip id (soft targets over two positives)."""
    jm, params, tm, video = models
    rng = np.random.default_rng(2)
    ids, mask, _ = _tokens(rng, B)
    idx = np.array([5, 5], np.int32)
    want_v = _japply(jm, params, jtasks.MPLUGVideo.extract_vision_feature,
                     jnp.asarray(video))
    want_t = _japply(jm, params, jtasks.MPLUGVideo.extract_text_feature,
                     jnp.asarray(ids), jnp.asarray(mask))
    for i in (idx, np.array([3, 4], np.int32)):
        want = _japply(jm, params, jtasks.MPLUGVideo.retrieval_loss,
                       jnp.asarray(video), jnp.asarray(ids),
                       jnp.asarray(mask), jnp.asarray(i))
        with torch.no_grad():
            got = tm.retrieval_loss(_t(video), _t(ids).long(), _t(mask),
                                    _t(i))
        _close(got["loss"], want["loss"])
    with torch.no_grad():
        got_v = tm.extract_vision_feature(_t(video))
        got_t = tm.extract_text_feature(_t(ids).long(), _t(mask))
    assert got_v.shape == (B, EMBED) and got_t.shape == (B, EMBED)
    _close(got_v, want_v)
    _close(got_t, want_t)
    _close(got_v.norm(dim=-1), np.ones(B))


def test_itm_methods_match_jax(models):
    """itm_train_loss on 3B rows (B positives, then the 2B rows of two
    derangements, whose query features are the clips they index) and
    itm_eval_scores on a 2 x 3 block (P(match) = column 1 of a 2-way
    head's softmax)."""
    jm2, tm2 = _itm_models()
    jm, params = jm2
    rng = np.random.default_rng(3)
    video = rng.normal(size=(B, 3, 2, 32, 32)).astype(np.float32)
    ids, mask, plens = _tokens(rng, 3 * B)
    pids, pmask, _ = _tokens(rng, 3 * B)
    neg = np.array([1, 0, 1, 0], np.int32)
    labels = np.array([1, 1, 0, 0, 1, 0], np.int32)
    want = _japply(jm, params, jtasks.MPLUGVideo.itm_train_loss,
                   *[jnp.asarray(a) for a in (video, ids, mask, plens,
                                              neg)],
                   prompt_ids=jnp.asarray(pids),
                   prompt_mask=jnp.asarray(pmask),
                   labels=jnp.asarray(labels))
    with torch.no_grad():
        got = tm2.itm_train_loss(_t(video), _t(ids).long(), _t(mask),
                                 _t(plens), _t(neg),
                                 prompt_ids=_t(pids).long(),
                                 prompt_mask=_t(pmask), labels=_t(labels))
    for k in ("loss", "loss_caption", "loss_cls"):
        _close(got[k], want[k])

    nt = 3
    eids, emask, eplens = _tokens(rng, B * nt)
    epids, epmask, _ = _tokens(rng, B * nt)
    want = _japply(jm, params, jtasks.MPLUGVideo.itm_eval_scores,
                   *[jnp.asarray(a) for a in (video, eids, emask, eplens)],
                   prompt_ids=jnp.asarray(epids),
                   prompt_mask=jnp.asarray(epmask), num_text=nt)
    with torch.no_grad():
        got = tm2.itm_eval_scores(_t(video), _t(eids).long(), _t(emask),
                                  _t(eplens), prompt_ids=_t(epids).long(),
                                  prompt_mask=_t(epmask), num_text=nt)
    for k in ("generation_logits", "cls_logits"):
        assert got[k].shape == (B, nt)
        _close(got[k], want[k])


def _itm_models():
    """The ITM pair: the tiny d = 96 config with a 2-way match head and
    16 queries."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = _cfgs(num_classes=2)
    jcfg = dataclasses.replace(jcfg, num_learnable_token=16)
    tcfg = dataclasses.replace(tcfg, num_learnable_token=16)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    ids, mask, _ = _tokens(rng, B)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((B, 3, 2, 32, 32)), jnp.asarray(ids),
        jnp.asarray(mask), method=jtasks.MPLUGVideo.full_init))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        ttasks.MPLUGVideo(tcfg, FP32_POLICY, proj_heads=True), params)
    return (jm, params), tm.eval()


def test_lr_scale_tree_matches_jax(models):
    """0.1 on the CLIP tower's non-temporal leaves (its temporal_attn,
    temporal_fc and temporal_embed stay 1), 1 elsewhere; and all 1
    without visual_backbone_scale."""
    _, params, tm, _ = models
    named = {bridge.jax_path(n): p for n, p in tm.named_parameters()}
    for scale in (True, False):
        want = _flat(jfactory.lr_scale_tree(params, scale))
        got = tfactory.lr_scale_tree(named, scale)
        assert got == {k: float(v) for k, v in want.items()}
    got = tfactory.lr_scale_tree(named, True)
    assert got["visual_encoder/norm_pre/scale"] == 0.1
    assert got["visual_encoder/temporal_embed"] == 1.0
    assert got["visual_encoder/blocks_0/temporal_attn/qkv_kernel"] == 1.0
    assert got["attn_pool/q_kernel"] == 1.0


def _opt_kwargs():
    return dict(lr=1e-3, min_lr=1e-5, weight_decay=0.05,
                opt_betas=(0.9, 0.999), opt_eps=1e-6, clip_grad=3.0,
                warmup_steps=1, epochs=1, niter_per_ep=10,
                visual_backbone_scale=True)


def test_cls_adamw_trajectory_matches_jax():
    """Three AdamW steps of cls_train_loss (deterministic) with the CLIP
    tower's 0.1 lr scale: losses, grad norms and every trainable leaf
    after each step against JAX's create_train_state + make_train_step;
    the frozen decoder stays bitwise, and a CLIP leaf moves a tenth as
    far as it would at scale 1 on the first update."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, num_learnable_token=8)
    tcfg = dataclasses.replace(tcfg, num_learnable_token=8)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    batches = []
    for _ in range(3):
        video = rng.normal(size=(B, 3, 2, 32, 32)).astype(np.float32)
        ids, mask, plens, pids, pmask, labels = _cls_inputs(rng)
        batches.append(dict(video=video, input_ids=ids, attention_mask=mask,
                            prompt_lengths=plens, prompt_ids=pids,
                            prompt_mask=pmask, labels=labels))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(batches[0]["video"]),
        jnp.asarray(batches[0]["input_ids"]),
        jnp.asarray(batches[0]["attention_mask"]),
        method=jtasks.MPLUGVideo.full_init))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        ttasks.MPLUGVideo(tcfg, FP32_POLICY, proj_heads=True),
        params).train()

    def jloss(p, batch, rng_=None, step=None):
        return jm.apply({"params": p}, batch["video"], batch["input_ids"],
                        batch["attention_mask"], batch["prompt_lengths"],
                        prompt_ids=batch["prompt_ids"],
                        prompt_mask=batch["prompt_mask"],
                        labels=batch["labels"],
                        method=jtasks.MPLUGVideo.cls_train_loss)

    def tloss(batch):
        b = {k: _t(v) for k, v in batch.items()}
        return tm.cls_train_loss(b["video"], b["input_ids"].long(),
                                 b["attention_mask"], b["prompt_lengths"],
                                 prompt_ids=b["prompt_ids"].long(),
                                 prompt_mask=b["prompt_mask"],
                                 labels=b["labels"])

    jst, tx, _ = j_state(params, jfactory.OptimizerConfig(**_opt_kwargs()))
    jtrain = jax.jit(j_step(jloss, tx))
    state, opt, _ = create_train_state(
        tm, tfactory.OptimizerConfig(**_opt_kwargs()))
    ttrain = make_train_step(tloss)
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    assert {g["lr_scale"] for g in opt.torch_optimizer.param_groups} == \
        {0.1, 1.0}
    for batch in batches:
        jst, jmet = jtrain(jst, jax.tree.map(jnp.asarray, batch),
                           jax.random.key(0))
        met = ttrain(state, batch)
        for k in ("loss", "loss_cls", "grad_norm"):
            _close(met[k], jmet[k])
        jflat = _flat(jax.device_get(jst.trainable))
        for path, p in state.trainable.items():
            _close(p.detach(), jflat[path], 2e-5)
    for k, p in state.frozen.items():
        assert torch.equal(p, frozen0[k]), k


@pytest.mark.parametrize("path", REFERENCE_YAMLS)
def test_reference_downstream_yamls_load(path):
    """The reference's downstream recipes build: clip-b16 (clip_model, 8
    heads of 96) with the 0.1 CLIP lr scale, the decoder's 0.1 dropouts,
    and use_cls / num_classes as each YAML sets them."""
    cfg = load_config(path)
    m = cfg.model
    assert m.vision.clip_model and m.vision.num_heads == 8
    assert m.vision.embed_dim // m.vision.num_heads == 96
    assert cfg.optimizer.visual_backbone_scale
    assert (m.text.hidden_dropout, m.text.attention_dropout) == (0.1, 0.1)
    raw = yaml.safe_load(open(path))
    assert m.use_cls == bool(raw.get("use_cls", False))
    assert m.num_classes == int(raw.get("num_classes", 0))
    assert cfg.num_frames == raw.get("num_frames", 4)


def test_jax_loader_reads_the_same_model_from_the_reference_yamls():
    from youku_mplug_tpu import config as jconfig

    for path in REFERENCE_YAMLS[:4]:
        j, t = jconfig.load_config(path), load_config(path)
        for f in ("use_cls", "num_classes", "num_learnable_token",
                  "contrastive_embed_dim", "temp", "freeze_vit"):
            assert getattr(t.model, f) == getattr(j.model, f), (path, f)
        assert t.optimizer.visual_backbone_scale == \
            j.optimizer.visual_backbone_scale
        assert t.model.vision.num_frames == j.model.vision.num_frames


# ---------------------------------------------------------------------------
# the CLIs on tiny YAMLs (the JAX e2e test's, with the d = 96 tower)
# ---------------------------------------------------------------------------


def write_cfg(d, name, **extra):
    json.dump(TINY_TEXT, open(d / "text.json", "w"))
    json.dump(dict(TINY_VISION, depth=1), open(d / "vision.json", "w"))
    cfg = {
        "text_cfg": str(d / "text.json"),
        "visual_cfg": str(d / "vision.json"),
        "batch_size": 4, "max_length": 12, "num_frames": 2,
        "image_res": 32, "num_learnable_token": 4, "embed_dim": 8,
        "freeze_text_decoder": True, "synthetic_length": 8,
        "optimizer": {"lr": 1e-3, "opt": "AdamW", "weight_decay": 0.01,
                      "clip_grad": 3.0},
        "schedular": {"epochs": 1, "min_lr": 1e-5, "warmup_steps": 1,
                      "lr_sched_type": "cosine"},
    }
    cfg.update(extra)
    path = d / f"{name}.yaml"
    yaml.safe_dump(cfg, open(path, "w"))
    return str(path)


def _run(module, cfg, out, *extra):
    args = module.parser().parse_args([
        "--config", cfg, "--output_dir", str(out), "--fp32",
        "--synthetic_data", "--max_steps", "2", "--seed", "0", "--device",
        "cpu", *extra])
    return module.main(args)


def _log(out):
    return [json.loads(line) for line in (out / "log.txt").read_text()
            .splitlines()]


def test_run_cls_cli_trains_evaluates_and_resumes(tmp_path):
    """2 steps (dropout on), a validation line, the test line; then
    --evaluate_only --resume from the run and from a fresh directory
    restores the trained state and evaluates only."""
    from youku_mplug_tpu_torch.cli import run_cls

    cfg = write_cfg(tmp_path, "cls", use_cls=True, num_classes=3)
    out = tmp_path / "out"
    runner = _run(run_cls, cfg, out)
    log = _log(out)
    assert np.isfinite(log[0]["loss"]) and log[0]["loss_cls"] > 0
    assert "val_gen_top1_accuracy" in log[0] and "val_cls_top1_accuracy" \
        in log[0]
    test = log[-1]["test"]
    assert 0 <= test["gen_top1_accuracy"] <= 100
    assert 0 <= test["cls_top5_accuracy"] <= 100
    assert runner.state.step == 2
    # the synthetic labels index the first num_classes names of
    # classname.json (45 names)
    assert run_cls.load_classnames(runner.cfg)[:3] == \
        ["翻唱", "电视剧剪辑", "电视剧周边（预告/杂谈）"]
    runner = _run(run_cls, cfg, out, "--evaluate_only", "--resume",
                  str(out))
    assert runner.state.step == 2
    tests = [e for e in _log(out) if "test" in e]
    assert len(tests) == 2 and tests[0] == tests[1]
    fresh = tmp_path / "fresh"
    runner = _run(run_cls, cfg, fresh, "--evaluate_only", "--resume",
                  str(out))
    assert runner.state.step == 2 and _log(fresh) == [tests[0]]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _run(run_cls, cfg, tmp_path / "none", "--evaluate_only")


def test_run_cls_eval_video_batch_gives_the_same_scores(tmp_path):
    """The port's memory cut: scoring a test batch 1 clip a call gives the
    whole batch's scores."""
    from youku_mplug_tpu_torch.cli import common, run_cls

    cfg = write_cfg(tmp_path, "cls", use_cls=True, num_classes=3)
    args = run_cls.parser().parse_args([
        "--config", cfg, "--output_dir", str(tmp_path / "o"), "--fp32",
        "--synthetic_data", "--device", "cpu"])
    runner, _, test_loader, names = run_cls.prepare(args)
    raw = next(iter(test_loader))
    runner.model.eval()
    with torch.no_grad():
        whole = run_cls.score_batch(runner, raw, names)
        runner.cfg.raw["eval_video_batch"] = 1
        split = run_cls.score_batch(runner, raw, names)
    assert set(whole) == set(split) == {"generation_logits", "cls_logits"}
    for k in whole:
        _close(split[k], whole[k], 1e-5)
    assert whole["generation_logits"].shape == (4, 3)
    assert isinstance(common.to_device(runner, {"x": np.zeros(2)})["x"],
                      torch.Tensor)


def test_run_retrieval_cli(tmp_path):
    from youku_mplug_tpu_torch.cli import run_retrieval

    cfg = write_cfg(tmp_path, "ret")
    out = tmp_path / "out"
    runner = _run(run_retrieval, cfg, out)
    log = _log(out)
    assert np.isfinite(log[0]["loss"]) and "val_r_mean" in log[0]
    assert 0 <= log[-1]["test"]["r_mean"] <= 100
    assert runner.state.step == 2
    # the temperature and the projections train; the decoder is frozen
    assert {"temp", "vision_proj/kernel", "text_proj/kernel"} <= set(
        runner.state.trainable)
    v, t = run_retrieval.features(runner, run_retrieval.build_datasets(
        runner.args, runner.cfg)[2], batch_size=3)
    assert v.shape == t.shape == (8, 8)  # 8 clips in batches of 3


def test_run_retrieval_itm_cli_and_its_two_way_head(tmp_path):
    from youku_mplug_tpu_torch.cli import run_retrieval_itm

    cfg = write_cfg(tmp_path, "itm", use_cls=True, num_classes=2,
                    eval_video_batch=4)
    out = tmp_path / "out"
    _run(run_retrieval_itm, cfg, out)
    log = _log(out)
    assert np.isfinite(log[0]["loss"]) and log[0]["loss_cls"] > 0
    assert 0 <= log[-1]["test"]["gen_r_mean"] <= 100
    assert 0 <= log[-1]["test"]["cls_r_mean"] <= 100
    # the reference YAML's 1-way head (num_classes unset): refused
    bad = write_cfg(tmp_path, "itm1", use_cls=True)
    with pytest.raises(ValueError, match="num_classes: 2"):
        _run(run_retrieval_itm, bad, tmp_path / "bad")


def test_itm_batch_matches_jax_make_batch():
    """The derangement negatives, their labels and the 3B (prompt,
    yes / no) rows, against the JAX runner's make_batch on the same raw
    batch (both toy tokenizers)."""
    from youku_mplug_tpu.cli import run_retrieval_itm as jitm
    from youku_mplug_tpu.models.tokenizer import BatchTokenizer as JBT
    from youku_mplug_tpu.models.tokenizer import ToyTokenizer as JToy
    from youku_mplug_tpu_torch.cli import run_retrieval_itm as titm
    from youku_mplug_tpu_torch.models.tokenizer import (
        BatchTokenizer,
        ToyTokenizer,
    )

    raw = {"video": np.zeros((4, 2, 8, 8, 3), np.uint8),
           "text": [f"clip {i}" for i in range(4)],
           "match_id": np.array([0, 1, 1, 3]), "index": np.arange(4) + 9}

    class R:
        pass

    jr, tr = R(), R()
    jr.cfg = tr.cfg = type("C", (), {"max_length": 24})()
    jr.tokenizer = JBT(JToy(128), max_length=24)
    tr.tokenizer = BatchTokenizer(ToyTokenizer(128), max_length=24)
    tr.device = torch.device("cpu")
    want = jitm.make_batch(jr, raw)
    got = titm.make_batch(tr, raw)
    for k in want:
        if k != "video":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(
                want[k]), err_msg=k)
    for n in (1, 2, 5):
        p = titm.random_derangement(n, np.random.default_rng(n))
        np.testing.assert_array_equal(
            p, jitm.random_derangement(n, np.random.default_rng(n)))


@pytest.mark.parametrize("module", ["run_cls", "run_retrieval",
                                    "run_retrieval_itm"])
def test_clis_need_the_card_by_default(tmp_path, module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{module}")
    cfg = write_cfg(tmp_path, "c", use_cls=True, num_classes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = mod.parser().parse_args(["--config", cfg, "--synthetic_data",
                                    "--output_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
