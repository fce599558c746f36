"""One gloo rank of the port's training-mesh tests
(``tests/test_torch_train_mesh.py``).  Run as

    python tests/torch_train_mesh_worker.py <mode> <rank> <world>
        <rendezvous file> <output dir> <JSON of the mode's arguments>

``mode`` ``step``: for each case of the JSON (``{"tag", "data", "model",
"case"}``, the case an ``.npz`` the test wrote: the JAX parameter tree
under ``p:<path>``, the global batch, and a ``meta`` JSON of the model
config's overrides and the optimizer's keywords) one train step of the
tiny flagship on its (data, model) split: ``shard_params``,
``create_train_state``, ``make_train_step`` on this data rank's block of
the batch (of each micro-batch, under the meta's ``update_freq``); rank 0 writes the metrics and every trainable leaf unsharded
as ``<output>/<tag>.npz``.  ``mode`` ``units``: the collectives against
their one-process twins (``units``), written as
``<output>/units_rank<r>.npz``.  ``mode`` ``runner``: the training CLIs
on YAMLs with a ``mesh:`` block, each entry ``{"cli", "argv"}`` run
through its ``main`` (rank 0 writes each run's step metrics as
``<output dir of the run>/history.json``), or ``{"prune", "keep"}``: the
checkpoint steps after ``keep`` removed from a run's directory.  The
process group comes from
``init_method=file://`` with an explicit timeout; ``spawn`` starts a
world of them for the tests.  Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from youku_mplug_tpu_torch import bridge  # noqa: E402
from youku_mplug_tpu_torch.config import flagship_config  # noqa: E402
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo  # noqa: E402
from youku_mplug_tpu_torch.ops import cross_entropy as ce  # noqa: E402
from youku_mplug_tpu_torch.optim.factory import (  # noqa: E402
    OptimizerConfig,
)
from youku_mplug_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
    sharding,
    tensor_parallel,
)
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
DEADLINE_S = 300  # a world's processes, all its entries


def spawn(mode, world, out, spec, deadline=DEADLINE_S, script=__file__):
    """``world`` gloo ranks of the worker (or of another worker
    ``script`` with the same arguments); fails (after killing every
    rank) on a rank's error or past ``deadline``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("WORLD_SIZE", None)
    rdv = os.path.join(out, f"rendezvous_{mode}_{world}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), mode, str(r),
         str(world), rdv, out, json.dumps(spec)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=deadline)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        import pytest

        pytest.fail(f"a {world}-rank {mode} world outlived {deadline} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad


def model_config(meta):
    """The tiny flagship config with the case's overrides."""
    cfg = flagship_config(tiny=True)
    return dataclasses.replace(
        cfg, use_contrastive=bool(meta.get("contrastive", False)),
        vision=dataclasses.replace(cfg.vision, **meta.get("vision", {})),
        text=dataclasses.replace(cfg.text, **meta.get("text", {})))


def pretrain_loss_fn(model):
    def loss_fn(batch):
        return model.pretrain_loss(batch["video"], batch["input_ids"],
                                   batch["attention_mask"])
    return loss_fn


def one_step(tag, data, model_deg, case, out, nan_rank=-1):
    """See the module docstring (``mode`` ``step``)."""
    raw = dict(np.load(case))
    meta = json.loads(str(raw.pop("meta")))
    tree = bridge.unflatten({k[2:]: v for k, v in raw.items()
                             if k.startswith("p:")})
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=data,
                                                  model=model_deg))
    model = bridge.load_jax_params(
        MPLUGVideo(model_config(meta), FP32_POLICY), tree)
    sharding.shard_params(model, mesh)
    state, _, _ = create_train_state(model, OptimizerConfig(**meta["opt"]))
    update_freq = int(meta.get("update_freq", 1))
    batch = sharding.data_shard({k: raw[k] for k in
                                 ("video", "input_ids", "attention_mask")},
                                mesh, micro=update_freq)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    batch["input_ids"] = batch["input_ids"].long()
    if mesh.rank == nan_rank:
        batch["video"][0, 0, 0, 0, 0] = float("nan")
    metrics = make_train_step(pretrain_loss_fn(model),
                              update_freq=update_freq)(state, batch)
    full = sharding.unshard(model, mesh)
    local = {n: list(p.shape) for n, p in model.named_parameters()}
    if mesh.rank == 0:
        trainable = {bridge.jax_path(n): t.numpy() for n, t in full.items()
                     if bridge.jax_path(n) in state.trainable}
        np.savez(os.path.join(out, f"{tag}.npz"),
                 **{f"p:{k}": v for k, v in trainable.items()},
                 metrics=json.dumps(metrics), local=json.dumps(local),
                 split=json.dumps(state.split))
    with open(os.path.join(out, f"{tag}_rank{mesh.rank}.json"), "w") as f:
        json.dump(metrics, f)


def units(out):
    """The collectives on a (1, world) mesh against their one-process
    twins, on inputs every rank draws from one seed: f and g around a
    column- and row-parallel product pair (values and gradients), the
    vocab-parallel CE against its plain version (loss and gradient,
    label smoothing 0 and 0.1, dense and in chunks of 4), and the
    data-axis row gather under autograd on a (world, 1) mesh."""
    world = dist.get_world_size()
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1, model=world))
    tp = tensor_parallel.ModelGroup(mesh.model_group, mesh.model_index,
                                    mesh.model)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 4 * world, generator=g, dtype=torch.float64)
    w2 = torch.randn(4 * world, 8, generator=g, dtype=torch.float64)
    res = {}
    i, n = mesh.model_index, 4
    xl = x.clone().requires_grad_(True)
    w1l = w1[:, i * n:(i + 1) * n].clone().requires_grad_(True)
    w2l = w2[i * n:(i + 1) * n].clone().requires_grad_(True)
    h = torch.tanh(tensor_parallel.copy_to_model(xl, tp) @ w1l)
    y = tensor_parallel.reduce_from_model(h @ w2l, tp)
    (y.sin().sum()).backward()
    res.update(fg_y=y.detach().numpy(), fg_dx=xl.grad.numpy(),
               fg_dw1=w1l.grad.numpy(), fg_dw2=w2l.grad.numpy())
    # the vocab-parallel CE: hidden [2, 8, 16], table [V, 16], V = 12 m
    v = 12 * world
    hid = torch.randn(2, 8, 16, generator=g, dtype=torch.float64)
    table = torch.randn(v, 16, generator=g, dtype=torch.float64)
    labels = torch.randint(0, v, (2, 8), generator=g)
    rows = table[i * 12:(i + 1) * 12]
    for ls in (0.0, 0.1):
        for chunk in (0, 4):
            for name, fn in (("par", ce.vocab_parallel_cross_entropy),
                             ("plain", ce.gathered_cross_entropy)):
                h = hid.clone().requires_grad_(True)
                t = rows.clone().requires_grad_(True)
                loss = ce.lm_cross_entropy(
                    h, t, labels, chunk=chunk, tp=tp,
                    ce=lambda lg, lab, tp_, fn=fn, ls=ls: fn(lg, lab, tp_,
                                                             ls))
                (loss * torch.linspace(0.5, 1.5, 8, dtype=loss.dtype)
                 ).sum().backward()
                key = f"ce_{name}_{ls}_{chunk}"
                res.update({f"{key}_loss": loss.detach().numpy(),
                            f"{key}_dh": h.grad.numpy(),
                            f"{key}_dt": t.grad.numpy()})
    # the vocab-parallel lookup of a trainable table: each rank's rows
    # take the gradient of its own ids
    emb = torch.randn(v, 16, generator=g, dtype=torch.float64)
    ids = torch.randint(0, v, (3, 7), generator=g)
    el = emb[i * 12:(i + 1) * 12].clone().requires_grad_(True)
    rows_out = tensor_parallel.vocab_parallel_embedding(
        ids, 12, lambda j: torch.nn.functional.embedding(j, el), tp)
    (rows_out * torch.linspace(-1, 1, 16, dtype=torch.float64)
     ).square().sum().backward()
    res.update(emb_out=rows_out.detach().numpy(), emb_dt=el.grad.numpy())
    # the data axis: rows gathered under autograd, the loss a share
    dmesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=world, model=1))
    dp = data_parallel.data_group(dmesh)
    a = torch.randn(world * 3, 4, generator=g, dtype=torch.float64)
    j = dmesh.data_index
    al = a[j * 3:(j + 1) * 3].clone().requires_grad_(True)
    full = data_parallel.gather_rows(al, dp)
    share = (al @ full.t()).logsumexp(-1).sum() / (3 * world)
    share.backward()
    res.update(dp_full=full.detach().numpy(), dp_da=al.grad.numpy(),
               dp_loss=data_parallel.sum_over_data(share, dp).numpy())
    np.savez(os.path.join(out, f"units_rank{dist.get_rank()}.npz"), **res)


def run_cli(cli, argv):
    """The CLI's ``main`` on ``argv``; rank 0 writes its step metrics
    (and, for run_caption, nothing more: the CLI writes its results)."""
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{cli}")
    parser = mod.parser() if cli == "run_caption" else mod.base_parser()
    args = parser.parse_args(argv)
    runner = mod.main(args)
    if dist.get_rank() == 0:
        with open(os.path.join(args.output_dir, "history.json"), "w") as f:
            json.dump(runner.history, f)


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
                one_step(item["tag"], item["data"], item["model"],
                         item["case"], out, item.get("nan_rank", -1))
            elif mode == "units":
                units(out)
            elif "prune" in item:  # keep the checkpoints up to a step
                if rank == 0:
                    for step in os.listdir(item["prune"]):
                        if step.isdigit() and int(step) > item["keep"]:
                            import shutil

                            shutil.rmtree(os.path.join(item["prune"], step))
                dist.barrier()
            else:
                run_cli(item["cli"], item["argv"])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
