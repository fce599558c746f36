"""One gloo rank of the downstream mesh tests
(``tests/test_torch_downstream_mesh.py``, ``tests/test_torch_dropout_mesh
.py``), and the helpers the tests share with it.  Run as

    python tests/torch_downstream_mesh_worker.py <mode> <rank> <world>
        <rendezvous file> <output dir> <JSON of the mode's arguments>

``mode`` ``step``: for each case of the JSON (``{"tag", "data", "model",
"case"}``, the case an ``.npz`` the test wrote: the JAX parameter tree
under ``p:<path>``, the global batch, and a ``meta`` JSON of the model's
widths, the loss (``cls``, ``retrieval`` or ``itm``), the optimizer's
keywords and the dropout seed) one train step (``one_step``) on its
(data, model) split, every dropout mask recorded: rank 0 writes the
metrics and every trainable leaf unsharded as ``<output>/<tag>.npz``,
every rank its masks and the rows its decoder passes took as
``<output>/<tag>_rank<r>.npz``.  ``mode`` ``runner``: each entry
``{"cli", "argv"}`` run through the CLI's ``main`` (rank 0 writes the
run's step metrics as ``<output dir of the run>/history.json``), or
``{"prune", "keep"}``: the checkpoint steps after ``keep`` removed from
a run's directory, or ``{"instruct", "tag", "out"}``: ``run_instruct
--train`` with every dropout on (``instruct_split``).  The process
group comes from ``init_method=file://`` with an explicit timeout;
``start`` and ``finish`` run a world (the tests run theirs at once, and
their (1,1) references meanwhile).  Imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import shutil
import sys
import unittest.mock as mock

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from youku_mplug_tpu_torch import bridge  # noqa: E402
from youku_mplug_tpu_torch.models import gpt3 as tgpt3  # noqa: E402
from youku_mplug_tpu_torch.models import tasks as ttasks  # noqa: E402
from youku_mplug_tpu_torch.models import vision as tvision  # noqa: E402
from youku_mplug_tpu_torch.ops import attention  # noqa: E402
from youku_mplug_tpu_torch.optim.factory import (  # noqa: E402
    OptimizerConfig,
)
from youku_mplug_tpu_torch.parallel import sharding  # noqa: E402
from youku_mplug_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402
from youku_mplug_tpu_torch.runtime.precision import (  # noqa: E402
    FP32_POLICY,
)
from youku_mplug_tpu_torch.train.state import (  # noqa: E402
    create_train_state,
)
from youku_mplug_tpu_torch.train.trainer import (  # noqa: E402
    make_train_step,
)

TIMEOUT_S = 120  # every collective's limit: a lost rank fails the run
CLIP_KEYS = ("video",)  # the ITM batch's B-row field; the rest are 3B
BATCH_KEYS = {
    "cls": ("video", "input_ids", "attention_mask", "prompt_lengths",
            "prompt_ids", "prompt_mask", "labels"),
    "retrieval": ("video", "input_ids", "attention_mask", "idx"),
    "itm": ("video", "input_ids", "attention_mask", "prompt_lengths",
            "prompt_ids", "prompt_mask", "labels", "negative_indices"),
}


def model_config(meta) -> ttasks.MPLUGVideoConfig:
    """The case's tiny downstream model: clip_model vision, GPT-3 text,
    the cls / match head and the projections."""
    return ttasks.MPLUGVideoConfig(
        vision=tvision.VisionConfig(**meta["vision"]),
        text=tgpt3.GPT3Config(**meta["text"]),
        num_learnable_token=meta["queries"],
        contrastive_embed_dim=meta["embed"], use_cls=True,
        num_classes=meta["num_classes"])


def redraw(flat, rng, std=0.2):
    """{JAX path: array} redrawn from ``rng`` (``test_torch_downstream.
    redraw``'s law): LayerNorm scales 1 + N(0, 0.1), ``temp`` 0.07, a
    matrix N(0, min(std, 1.6 / sqrt(fan_in))), else N(0, std)."""
    out = {}
    for path, x in flat.items():
        shape = np.shape(x)
        z = rng.normal(size=shape).astype(np.float32)
        name = path.rsplit("/", 1)[-1]
        if name == "temp":
            out[path] = np.float32(0.07)
        elif name.endswith("scale"):
            out[path] = 1.0 + 0.1 * z
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape)) // shape[-1]
            out[path] = min(std, 1.6 / fan_in ** 0.5) * z
        else:
            out[path] = std * z
    return out


def port_params(meta, seed):
    """The case model's tree {JAX path: array} drawn by ``redraw`` (the
    dropout tests' weights: no JAX init needed)."""
    with torch.device("meta"):
        model = ttasks.MPLUGVideo(model_config(meta), FP32_POLICY,
                                  proj_heads=True)
    flat = {bridge.jax_path(n): np.zeros(tuple(p.shape), np.float32)
            for n, p in model.named_parameters()}
    return redraw(flat, np.random.default_rng(seed))


def tokens(rng, rows, s, vocab):
    """Padded ids [rows, s] (pad 2) with their mask (lengths differ across
    every block of rows), and prompt lengths."""
    ids = rng.integers(3, vocab, size=(rows, s)).astype(np.int32)
    lengths = np.linspace(4, s, rows).round().astype(int)[
        rng.permutation(rows)]
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    plens = np.minimum(rng.integers(1, 4, size=(rows,)), lengths - 2)
    return ids, mask, plens.astype(np.int32)


# clip ids of the retrieval and ITM batches of 8: ids 0 and 2 repeat
# across the halves (the data ranks' blocks at data = 2)
MATCH_IDS = np.array([0, 1, 2, 3, 0, 5, 2, 7])


def global_batch(meta, seed, b=8, s=12):
    """The case's global batch of ``b`` clips (numpy): the cls rows, the
    retrieval pairs with MATCH_IDS, or the ITM batch of JAX's
    ``make_batch`` (two seeded derangements, 3B pair rows, labels from
    the match ids)."""
    rng = np.random.default_rng(seed)
    v, vocab = meta["vision"], meta["text"]["vocab_size"]
    video = rng.normal(size=(b, 3, v["num_frames"], v["img_size"],
                             v["img_size"])).astype(np.float32)
    kind = meta["loss"]
    if kind == "retrieval":
        ids, mask, _ = tokens(rng, b, s, vocab)
        return {"video": video, "input_ids": ids, "attention_mask": mask,
                "idx": MATCH_IDS[:b].astype(np.int64)}
    rows = b if kind == "cls" else 3 * b
    ids, mask, plens = tokens(rng, rows, s, vocab)
    pids, pmask, _ = tokens(rng, rows, s, vocab)
    out = {"video": video, "input_ids": ids, "attention_mask": mask,
           "prompt_lengths": plens, "prompt_ids": pids,
           "prompt_mask": pmask}
    if kind == "cls":
        out["labels"] = rng.integers(0, meta["num_classes"], size=(b,))
        return out
    from youku_mplug_tpu_torch.cli.run_retrieval_itm import (
        random_derangement,
    )
    neg = np.concatenate([random_derangement(b, rng),
                          random_derangement(b, rng)])
    idx = MATCH_IDS[:b]
    labels = np.concatenate([np.ones(b, np.int64), (
        idx[np.arange(2 * b) % b] == idx[neg]).astype(np.int64)])
    return {**out, "negative_indices": neg.astype(np.int64),
            "labels": labels}


def write_case(d, name, meta, params, batch):
    """The case file the ranks read; returns its path."""
    path = os.path.join(d, f"case_{name}.npz")
    np.savez(path, meta=json.dumps(meta), **batch,
             **{f"p:{k}": np.asarray(v) for k, v in params.items()})
    return path


def loss_fn(model, kind):
    """The task's training loss on a batch of tensors (float clips
    [B, 3, T, H, W], as the methods take them)."""
    def cls(b, generator=None):
        return model.cls_train_loss(
            b["video"], b["input_ids"], b["attention_mask"],
            b["prompt_lengths"], prompt_ids=b["prompt_ids"],
            prompt_mask=b["prompt_mask"], labels=b["labels"],
            generator=generator)

    def retrieval(b):
        return model.retrieval_loss(b["video"], b["input_ids"],
                                    b["attention_mask"], b["idx"])

    def itm(b, generator=None):
        return model.itm_train_loss(
            b["video"], b["input_ids"], b["attention_mask"],
            b["prompt_lengths"], b["negative_indices"],
            prompt_ids=b["prompt_ids"], prompt_mask=b["prompt_mask"],
            labels=b["labels"], generator=generator)
    return {"cls": cls, "retrieval": retrieval, "itm": itm}[kind]


def local_batch(raw, kind, mesh):
    """This data rank's share of the case's global batch: its block of
    every row field (ITM: of the B clips and of the 3B pair rows apart;
    ``negative_indices`` whole), as tensors."""
    keys = BATCH_KEYS[kind]
    if kind == "itm":
        batch = {**sharding.data_shard({"video": raw["video"]}, mesh),
                 **sharding.data_shard(
                     {k: raw[k] for k in keys
                      if k not in CLIP_KEYS + ("negative_indices",)}, mesh),
                 "negative_indices": raw["negative_indices"]}
    else:
        batch = sharding.data_shard({k: raw[k] for k in keys}, mesh)
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    for k in ("input_ids", "prompt_ids", "labels", "idx",
              "negative_indices"):
        if k in out:
            out[k] = out[k].long()
    return out


class MaskRecorder:
    """Every keep mask ``ops/attention._keep_mask`` hands out, in order:
    (the block spec, the mask); and the rows of each decoder pass."""

    def __init__(self):
        self.masks, self.blocks, self.decoder_rows = [], [], []
        self._keep = attention._keep_mask

    def __call__(self, shape, rate, generator, device, blocks=()):
        keep = self._keep(shape, rate, generator, device, blocks)
        self.masks.append(keep.cpu().numpy())
        self.blocks.append([list(b) for b in blocks])
        return keep

    def watch(self, model):
        forward = model.text_decoder.forward

        def rows(*a, **k):
            x = k.get("input_embeds")
            if x is None:
                x = k.get("tokens", a[0] if a else None)
            self.decoder_rows.append(int(x.shape[0]))
            return forward(*a, **k)
        model.text_decoder.forward = rows

    def save(self, path, **extra):
        np.savez(path, blocks=json.dumps(self.blocks),
                 decoder_rows=np.asarray(self.decoder_rows),
                 **{f"m{i}": m for i, m in enumerate(self.masks)}, **extra)


def one_step(case, mesh):
    """One train step of the case at ``mesh`` (a ``Mesh``; (1,1) in one
    process without a group): returns (metrics, {JAX path: trainable
    leaf after the step, unsharded}, the recorder)."""
    raw = dict(np.load(case))
    meta = json.loads(str(raw.pop("meta")))
    tree = bridge.unflatten({k[2:]: v for k, v in raw.items()
                             if k.startswith("p:")})
    model = bridge.load_jax_params(
        ttasks.MPLUGVideo(model_config(meta), FP32_POLICY, proj_heads=True),
        tree)
    sharding.shard_params(model, mesh)
    model.train()
    state, _, _ = create_train_state(model, OptimizerConfig(**meta["opt"]))
    rec = MaskRecorder()
    rec.watch(model)
    step = make_train_step(loss_fn(model, meta["loss"]),
                           dropout_seed=meta.get("dropout_seed"))
    with mock.patch.object(attention, "_keep_mask", rec):
        metrics = step(state, local_batch(raw, meta["loss"], mesh))
    full = (sharding.unshard(model, mesh) if mesh.distributed else
            {n: p.detach().clone() for n, p in model.named_parameters()})
    leaves = {bridge.jax_path(n): t.numpy() for n, t in full.items()
              if bridge.jax_path(n) in state.trainable}
    return metrics, leaves, rec


def step_case(tag, data, model_deg, case, out):
    """See the module docstring (``mode`` ``step``)."""
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=data,
                                                  model=model_deg))
    metrics, leaves, rec = one_step(case, mesh)
    if mesh.rank == 0:
        np.savez(os.path.join(out, f"{tag}.npz"),
                 **{f"p:{k}": v for k, v in leaves.items()},
                 metrics=json.dumps(metrics))
    rec.save(os.path.join(out, f"{tag}_rank{mesh.rank}.npz"),
             coord=np.asarray(mesh.coord), metrics=json.dumps(metrics))


def run_cli(cli, argv):
    """The CLI's ``main`` on ``argv`` (in a process group, or alone);
    rank 0 writes its step metrics and, for the retrieval CLIs, each
    merged matrix the evaluation scores (``itm_eval``'s first argument)
    as ``sims_<n>.npy``, in order."""
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{cli}")
    parser = mod.base_parser() if cli == "run_pretrain" else mod.parser()
    args = parser.parse_args(argv)
    main = not dist.is_initialized() or dist.get_rank() == 0
    sims = []
    score = getattr(mod, "itm_eval", None)

    def recording(matrix, *a, **k):
        sims.append(np.asarray(matrix))
        return score(matrix, *a, **k)
    with mock.patch.object(mod, "itm_eval", recording) if score else \
            contextlib.nullcontext():
        runner = mod.main(args)
    if main:
        with open(os.path.join(args.output_dir, "history.json"), "w") as f:
            json.dump(runner.history, f)
        for i, m in enumerate(sims):
            np.save(os.path.join(args.output_dir, f"sims_{i}.npy"), m)
    return runner


# every dropout of the tiny Owl on: Bloom's hidden and attention
# dropout, the ViT's attention dropout and drop-path
INSTRUCT_DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)
INSTRUCT_VISION_DROPOUT = dict(attn_drop_rate=0.1, drop_path=0.1)


def instruct_split(tag, out):
    """``run_instruct --train`` of the Owl mesh tests' tiny Owl (rank-2
    LoRA on Bloom and the ViT, the weights redrawn) at split ``tag``
    with every dropout on, two steps of one epoch, in fp32; writes its
    history as ``<out>/history.json`` (rank 0).  Returns the runner."""
    import yaml

    import torch_owl_mesh_worker as owl
    from youku_mplug_tpu_torch.cli import common, run_instruct

    _, tok = owl.write_inputs(out)
    data, model = map(int, tag.split("x"))
    raw = json.loads(json.dumps(owl.TINY))
    raw["text_overrides"].update(lora_rank=2, **INSTRUCT_DROPOUT)
    raw["vision_overrides"].update(lora_rank=2, **INSTRUCT_VISION_DROPOUT)
    raw.update(owl.TRAIN, epochs=1, mesh={"data": data, "model": model})
    d = os.path.join(out, f"instruct_{tag}")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"train.yaml.{os.getpid()}")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    args = run_instruct.parser().parse_args([
        "--config", path, "--output_dir", d, "--train", "--synthetic_data",
        "--tokenizer", tok, "--device", "cpu", "--seed", str(owl.SEED),
        "--max_steps", "2"])
    with mock.patch.object(run_instruct, "DEFAULT_POLICY", FP32_POLICY), \
            mock.patch.object(run_instruct, "jax_init", owl.redrawn_init):
        runner = run_instruct.train_setup(args)
        common.train_epochs(runner, run_instruct.build_train_step(runner),
                            run_instruct.make_instruct_batch)
    if runner.mesh is None or runner.mesh.rank == 0:
        with open(os.path.join(d, "history.json"), "w") as f:
            json.dump(runner.history, f)
    runner.ckpt.close()
    return runner


DEADLINE_S = 300  # a world's processes, all its entries


def start(mode, world, out, spec):
    """``world`` gloo ranks of this worker on ``spec``, started (several
    worlds run at once: their rendezvous files differ by world size)."""
    import subprocess

    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("WORLD_SIZE", None)
    rdv = os.path.join(out, f"rendezvous_{mode}_{world}")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(world), rdv, out, json.dumps(spec)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(procs, deadline=DEADLINE_S):
    """Wait for a started world; fails (after killing every rank) on a
    rank's error or past ``deadline``."""
    import subprocess

    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=deadline)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"a {len(procs)}-rank world outlived "
                             f"{deadline} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad


def main(argv):
    mode, rank, world, rdv, out, spec = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for item in json.loads(spec):
            if mode == "step":
                step_case(item["tag"], item["data"], item["model"],
                          item["case"], out)
            elif "prune" in item:  # keep the checkpoints up to a step
                if rank == 0:
                    for step in os.listdir(item["prune"]):
                        if step.isdigit() and int(step) > item["keep"]:
                            shutil.rmtree(os.path.join(item["prune"], step))
                dist.barrier()
            elif "instruct" in item:
                instruct_split(item["tag"], item["out"])
            else:
                run_cli(item["cli"], item["argv"])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
