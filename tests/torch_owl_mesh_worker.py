"""One gloo rank of the Owl mesh tests (``tests/test_torch_owl_mesh.py``,
``tests/test_torch_owl_train_mesh.py``, the split LayerNorm of
``tests/test_torch_ops.py``), and the helpers the tests share with it.
Run as

    python tests/torch_owl_mesh_worker.py <mode> <rank> <world>
        <rendezvous file> <output dir> <JSON of the mode's arguments>

``mode`` ``serve``: for each split of the JSON, ``run_instruct.build``
and ``serve_built`` of every serving variant (``VARIANTS``: the batched
path and the engine; greedy, beam, sampled; an int8 cache; int8 weights;
the engine with prompt-lookup speculation)
on its YAML, the files under ``<output>/<split>/<variant>``; on the
greedy variant's model also the media features and the prefill and
first decode step's logits of every request (``forced``, written as
``rank<r>.npz`` beside them) and the leaves of its ``unshard`` that
differ from the JAX tree of an unsharded twin (``roundtrip_rank<r>
.json``).  ``mode`` ``train``: for each split,
``run_instruct --train`` (rank-2 LoRA on Bloom and the ViT, the weights
``redraw``-n) on a schedule of ``EPOCHS`` epochs of one step, stopped
after ``epochs`` of them, ``--resume`` from another run where the JSON
says so; each rank writes its history as ``history_rank<r>.json``.  ``mode`` ``units``: the split LayerNorm's
value and gradients (``layernorm_rank<r>.npz``) and, for each split of
the JSON, the loss of the dp == tp check's Owl (``dptp_<split>_rank<r>
.json``).  The process group comes from ``init_method=file://`` with an
explicit timeout.  Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import sys
import unittest.mock as mock

import numpy as np
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from youku_mplug_tpu_torch import bridge  # noqa: E402
from youku_mplug_tpu_torch.cli import common, run_instruct  # noqa: E402
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY  # noqa: E402

TIMEOUT_S = 120   # every collective's limit: a lost rank fails the run
STD = 0.3         # the serving weights' std: varied greedy tokens
SEED = 3
SLOTS = 2
# Bloom 12 heads of 8: the ALiBi ladder's half-step branch starts at head
# 8, so a model rank of (1,2) (heads 6-11) and of (1,4) (heads 6-8) holds
# heads on both sides of it; the vocab, the ViT's and the abstractor's
# heads and its intermediate width divide by 4
TINY = dict(
    text_overrides=dict(vocab_size=512, hidden_size=96,
                        num_hidden_layers=2, num_attention_heads=12),
    vision_overrides=dict(img_size=16, patch_size=8, embed_dim=32, depth=1,
                          num_heads=4, clip_model=True),
    abstractor=dict(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, num_queries=4, max_frames=8),
    num_frames=2, image_res=16, do_sample=False, beam_size=1,
    max_new_tokens=6)
QUESTIONS = ("what is in the video ?", "what happens next in the clip ?",
             "who is there", "describe the scene please",
             "is it raining ?")
SAMPLE = dict(do_sample=True, top_k=40, top_p=0.95)
# variant -> (YAML keys, extra argv)
VARIANTS = {
    "greedy": ({}, []),
    "engine": ({}, ["--engine"]),
    "beam": ({"beam_size": 3}, []),
    "sample": (SAMPLE, []),
    "sample_engine": (SAMPLE, ["--engine"]),
    "int8kv": ({"kv_cache_dtype": "int8"}, []),
    "int8kv_engine": ({"kv_cache_dtype": "int8"}, ["--engine"]),
    "int8": ({}, ["--engine", "--int8"]),
    # prompt-lookup speculation through the engine (greedy tokens)
    "lookup_engine": ({}, ["--engine", "--lookup_k", "3"]),
}
EPOCHS = 3  # the schedule's
# Adam's eps at 1e-3: the abstractor's k_bias shifts every score of a
# query alike, so its gradient is zero but for fp32 rounding, which a
# small eps would blow up into lr-sized steps of either sign
TRAIN = dict(batch_size=4, synthetic_length=8, max_length=0,
             optimizer=dict(lr=1e-3, min_lr=1e-5, weight_decay=0.01,
                            warmup_steps=0, clip_grad=1.0, opt_eps=1e-3))


def write_yaml(path, tag, **keys):
    """TINY with the split ``tag`` ("DxM") as its ``mesh:`` block and
    ``keys`` over it (``kv_cache_dtype`` and ``lora_rank`` go into the
    text overrides, ``vision_lora_rank`` into the vision ones)."""
    data, model = map(int, tag.split("x"))
    raw = json.loads(json.dumps(TINY))
    for k in ("kv_cache_dtype", "lora_rank"):
        if k in keys:
            raw["text_overrides"][k] = keys.pop(k)
    if "vision_lora_rank" in keys:
        raw["vision_overrides"]["lora_rank"] = keys.pop("vision_lora_rank")
    raw.update(keys, mesh={"data": data, "model": model})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # every rank writes the same file: whole, by a rename, so that no
    # rank reads another's half-written copy
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        yaml.safe_dump(raw, f)
    os.replace(tmp, path)
    return path


def write_inputs(d):
    """(the requests' jsonl, the tokenizer directory) under ``d``: the
    tokenizer is trained here, so every rank's prompt ids agree (the
    whitespace tokenizer's follow each process's string hash)."""
    from tests.hf_tokenizer_files import write_tokenizer_dir

    tok, jsonl = os.path.join(d, "tok"), os.path.join(d, "rows.jsonl")
    if not os.path.exists(jsonl):  # the test writes them before the ranks
        write_tokenizer_dir(tok, 500, byte_level=False)
        with open(jsonl, "w") as f:
            for i, q in enumerate(QUESTIONS):
                f.write(json.dumps({"video": f"v{i}.mp4", "question": q})
                        + "\n")
    return jsonl, tok


def serve_argv(yaml_path, out, jsonl, tok, extra=()):
    return run_instruct.parser().parse_args([
        "--config", yaml_path, "--output_dir", out, "--synthetic_data",
        "--input_jsonl", jsonl, "--tokenizer", tok, "--device", "cpu",
        "--fp32", "--seed", str(SEED), "--num_slots", str(SLOTS),
        *extra])


@torch.inference_mode()
def forced(args, cfg, raw, model):
    """Media features [B, NM, H], and for every request the fp32 logits
    of its prefill over the cache (the last prompt position) and of one
    decode step fed its greedy token: {"qf", "first", "second", "tok"}."""
    lm = model.text_decoder
    _, batch, clips = run_instruct.prepare(
        args, cfg, raw, torch.device("cpu"), torch.float32,
        run_instruct.build_tokenizer(args, cfg))
    qf = model.encode_video(clips)
    emb = model.spliced_embeds(torch.as_tensor(batch["input_ids"]).long(),
                               torch.as_tensor(batch["media_mask"]), qf)
    first, second, toks = [], [], []
    for i, n in enumerate(batch["prompt_len"]):
        n = int(n)
        cache = lm.init_cache(1, n + 4)
        lg, cache = lm.decode_step(emb[i:i + 1, :n], cache, 0)
        tok = lg.argmax(-1)
        lg2, _ = lm.decode_step(lm.embed(tok[:, None]), cache, n)
        first.append(lg[0])
        second.append(lg2[0])
        toks.append(int(tok))
    return {"qf": qf.numpy(), "first": torch.stack(first).numpy(),
            "second": torch.stack(second).numpy(), "tok": np.array(toks)}


def serve_split(tag, out, std=STD):
    """Every variant of ``VARIANTS`` at split ``tag`` on this rank (see
    the module docstring)."""
    jsonl, tok = write_inputs(out)
    seeded = functools.partial(bridge.seeded_init, std=std)
    for variant, (keys, extra) in VARIANTS.items():
        d = os.path.join(out, tag, variant)
        args = serve_argv(write_yaml(os.path.join(d, "owl.yaml"), tag,
                                     **keys), d, jsonl, tok, extra)
        with mock.patch.object(run_instruct, "seeded_init", seeded):
            cfg, raw, model, device = run_instruct.build(args)
        run_instruct.serve_built(args, cfg, raw, model, device)
        if variant == "greedy":
            rank = model.mesh.rank if model.mesh.distributed else 0
            np.savez(os.path.join(d, f"rank{rank}.npz"),
                     **forced(args, cfg, raw, model))
            with open(os.path.join(d, f"roundtrip_rank{rank}.json"),
                      "w") as f:
                json.dump(roundtrip(cfg, model, seeded), f)


def roundtrip(cfg, model, seeded):
    """``unshard`` of the (sharded) served model against the JAX tree of
    an unsharded twin seeded alike: {"leaves": how many, "differ": the
    JAX paths not bitwise equal}."""
    from youku_mplug_tpu_torch.models.owl import MPLUGOwlVideo
    from youku_mplug_tpu_torch.parallel import sharding

    back = sharding.unshard(model, model.mesh)
    want = bridge.to_jax_tree(seeded(MPLUGOwlVideo(cfg, FP32_POLICY), SEED))
    got = bridge.unflatten({bridge.jax_path(n): t.numpy()
                            for n, t in back.items()})
    differ = []

    def walk(a, b, prefix):
        for k in sorted(set(a) | set(b)):
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(b.get(k), dict) and isinstance(a.get(k), dict):
                walk(a[k], b[k], path)
            elif k not in a or k not in b or not np.array_equal(a[k], b[k]):
                differ.append(path)
    walk(got, want, "")
    return {"leaves": len(back), "differ": differ}


def redraw(tree, rng, std=0.2):
    """A nested dict of arrays redrawn from ``rng``: LayerNorm scales near
    one, every other leaf (``lora_*_b`` too) normal(0, std)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = redraw(v, rng, std)
        else:
            z = rng.normal(size=v.shape).astype(np.float32)
            out[k] = 1.0 + 0.1 * z if k.endswith("scale") else std * z
    return out


def redrawn_init(model, seed):
    """``run_instruct``'s ``jax_init`` replaced: the unsharded model's
    tree ``redraw``-n from ``seed`` (the same on every rank)."""
    return bridge.load_jax_params(model, redraw(
        bridge.to_jax_tree(model), np.random.default_rng(seed)))


def train_argv(yaml_path, out, tok, resume=""):
    return run_instruct.parser().parse_args([
        "--config", yaml_path, "--output_dir", out, "--train",
        "--synthetic_data", "--tokenizer", tok, "--device", "cpu",
        "--seed", str(SEED), "--max_steps", "1"]
        + (["--resume", resume] if resume else []))


def train_split(tag, out, epochs, resume="", name=""):
    """``run_instruct --train`` at split ``tag`` in fp32, the first
    ``epochs`` of the ``EPOCHS`` epochs of one step of its schedule (see
    the module docstring), under ``out/train_<name or tag>``.  Returns
    the runner."""
    _, tok = write_inputs(out)
    d = os.path.join(out, f"train_{name or tag}")
    path = write_yaml(os.path.join(d, "train.yaml"), tag, lora_rank=2,
                      vision_lora_rank=2, epochs=EPOCHS, **TRAIN)
    with mock.patch.object(run_instruct, "DEFAULT_POLICY", FP32_POLICY), \
            mock.patch.object(run_instruct, "jax_init", redrawn_init):
        runner = run_instruct.train_setup(train_argv(path, d, tok, resume))
        runner.cfg = dataclasses.replace(runner.cfg, epochs=epochs)
        common.train_epochs(runner, run_instruct.build_train_step(runner),
                            run_instruct.make_instruct_batch)
    mesh = runner.mesh
    with open(os.path.join(d, f"history_rank{mesh.rank}.json"), "w") as f:
        json.dump({"coord": list(mesh.coord), "history": runner.history,
                   "start_epoch": runner.start_epoch,
                   "partial": list(runner.state.partial),
                   "split": sorted(runner.state.split)}, f)
    return runner


# ----- the units: the split LayerNorm and the dp == tp check -----

def layernorm_draws(world, dtype=torch.float32):
    """x [3, 5, 8 * world], scale, bias and the loss weights, from a
    seeded generator."""
    g = torch.Generator().manual_seed(1)
    w = 8 * world
    x = torch.randn(3, 5, w, generator=g, dtype=dtype) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn(w, generator=g, dtype=dtype)
    bias = 0.1 * torch.randn(w, generator=g, dtype=dtype)
    weights = torch.randn(3, 5, w, generator=g, dtype=dtype)
    return x, scale, bias, weights


def layernorm_unit(out, mesh):
    """The split LayerNorm over a (1, world) mesh: this rank's slice of
    the value and of x's, the scale's and the bias's gradients under a
    weighted-sum loss of the whole output."""
    from youku_mplug_tpu_torch.ops.layernorm import split_layer_norm
    from youku_mplug_tpu_torch.parallel.tensor_parallel import ModelGroup

    x, scale, bias, weights = layernorm_draws(mesh.model)
    tp = ModelGroup(mesh.model_group, mesh.model_index, mesh.model)
    w = x.shape[-1] // mesh.model
    sl = slice(mesh.model_index * w, (mesh.model_index + 1) * w)
    xs, ss, bs = (t[..., sl].clone().requires_grad_(True)
                  for t in (x, scale, bias))
    y = split_layer_norm(xs, ss, bs, tp, width=x.shape[-1], eps=1e-5)
    (y * weights[..., sl]).sum().backward()
    np.savez(os.path.join(out, f"layernorm_rank{mesh.rank}.npz"),
             y=y.detach().numpy(), dx=xs.grad.numpy(),
             dscale=ss.grad.numpy(), dbias=bs.grad.numpy())


def dptp_config():
    """The Owl of ``__graft_entry__``'s dp == tp check (its tiny ViT,
    abstractor and Bloom), as the port's config."""
    from youku_mplug_tpu_torch.models.bloom import BloomConfig
    from youku_mplug_tpu_torch.models.owl import (
        MPLUGOwlVideoConfig,
        OwlAbstractorConfig,
    )
    from youku_mplug_tpu_torch.models.vision import VisionConfig

    return MPLUGOwlVideoConfig(
        vision=VisionConfig(img_size=16, patch_size=8, embed_dim=32,
                            depth=1, num_heads=4, num_frames=2,
                            clip_model=True),
        abstractor=OwlAbstractorConfig(hidden_size=32, num_layers=1,
                                       num_heads=4, intermediate_size=64,
                                       num_queries=4),
        text=BloomConfig(vocab_size=256, hidden_size=32,
                         num_hidden_layers=2, num_attention_heads=4))


def dptp_loss(tag, inputs, mesh=None):
    """The check's loss of its Owl at split ``tag`` (this rank's model
    shard, its data block of the batch), summed over the data ranks: the
    global batch's loss.  ``inputs``: the npz of JAX's tree (flattened
    paths) and the batch."""
    import torch.distributed as dist

    from youku_mplug_tpu_torch.models.owl import MPLUGOwlVideo
    from youku_mplug_tpu_torch.parallel import sharding
    from youku_mplug_tpu_torch.runtime import mesh as mesh_lib

    data, model_par = map(int, tag.split("x"))
    if mesh is None:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=data,
                                                      model=model_par))
    raw = dict(np.load(inputs))
    tree = {}
    for k, v in raw.items():
        if k.startswith("params/"):
            node = tree
            *parts, leaf = k[len("params/"):].split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = v
    model = bridge.load_jax_params(MPLUGOwlVideo(dptp_config(),
                                                 FP32_POLICY), tree)
    sharding.shard_params(model, mesh, sharding.BLOOM_SHARDING_RULES)
    batch = sharding.data_shard({k: raw[k] for k in (
        "video", "input_ids", "attention_mask", "media_mask",
        "prompt_mask")}, mesh)
    with torch.no_grad():
        loss = model.train().instruct_loss(*(
            torch.from_numpy(batch[k]).long() if k == "input_ids"
            else torch.from_numpy(batch[k]) for k in (
                "video", "input_ids", "attention_mask", "media_mask",
                "prompt_mask")))["loss"]
    if mesh.data > 1:
        dist.all_reduce(loss, group=mesh.group("data"))
    return float(loss)


def units(out, spec):
    from youku_mplug_tpu_torch.runtime import mesh as mesh_lib

    world = torch.distributed.get_world_size()
    layernorm_unit(out, mesh_lib.make_mesh(mesh_lib.MeshConfig(
        data=1, model=world)))
    for tag in spec["dptp"]:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
            data=int(tag[0]), model=int(tag[2])))
        loss = dptp_loss(tag, spec["inputs"], mesh)
        with open(os.path.join(out, f"dptp_{tag}_rank{mesh.rank}.json"),
                  "w") as f:
            json.dump({"coord": list(mesh.coord), "loss": loss}, f)


def main(argv):
    mode, rank, world, rdv, out, spec = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    spec = json.loads(spec)
    try:
        if mode == "serve":
            for tag in spec["splits"]:
                serve_split(tag, out)
        elif mode == "train":
            for run in spec["runs"]:
                train_split(run["tag"], out, run["epochs"],
                            run.get("resume", ""), run.get("name", ""))
        else:
            units(out, spec)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
