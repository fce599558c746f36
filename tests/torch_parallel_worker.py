"""One gloo rank of the port's context, pipeline and expert parallelism
tests (``tests/test_torch_ring_attention.py``, ``test_torch_pipeline.py``,
``test_torch_moe.py``).  Run as

    python tests/torch_parallel_worker.py cases <rank> <world>
        <rendezvous file> <output dir> <JSON list of cases>

Each case is ``{"kind", "tag", "case"}``, the case an ``.npz`` the test
wrote (the global inputs, drawn with numpy from a seed, and a ``meta``
JSON).  Every rank runs the port's function on its share of the inputs,
then a loss (the sum of the output times the case's weights ``w_out``,
plus ``aux_weight`` times MoE's aux) backward, and writes its outputs
and gradients as ``<output dir>/<tag>_rank<r>.npz``:

- ``ring`` / ``ulysses``: ``ring_attention`` / ``ulysses_attention`` on
  this rank's sequence block of q, k, v over an ``sp`` axis of the world
  (in bf16 where the meta says ``bf16``); its block of the output and of
  dq, dk, dv (as fp32).  ``ulysses_heads``: the
  ``ValueError`` of heads that do not divide (``raised``);
- ``gpipe_linear`` / ``gpipe_transformer``: ``gpipe`` over a ``(data,
  pipe)`` mesh of the meta's sizes, the stage the JAX test's tanh layer
  or transformer layer; the output (this data rank's rows), this
  stage's slice of the parameters' gradients and the microbatches'
  gradient (its rows);
- ``moe``: ``MoEMLP`` with its experts cut over the model axis of a
  ``(data, model)`` mesh by ``shard_params`` and the MoE rules; y, aux,
  the router's gradient, this rank's slices of the experts' gradients
  and of their parameters' shapes, and the same module whole in this
  process (no group): its y, aux and router gradient.

The process group comes from ``init_method=file://`` with an explicit
timeout on every collective; ``spawn`` starts a world of them with a
deadline (``torch_train_mesh_worker.spawn``).  Imports torch and the
port only.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from youku_mplug_tpu_torch import bridge  # noqa: E402
from youku_mplug_tpu_torch.parallel import (  # noqa: E402
    moe,
    pipeline,
    ring_attention,
    sharding,
)
from youku_mplug_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402

TIMEOUT_S = 60  # every collective's limit: a lost rank fails the run
DEADLINE_S = 240  # a world's processes, all its cases


def spawn(world, out, cases):
    """``world`` ranks of this worker on ``cases``."""
    import torch_train_mesh_worker

    torch_train_mesh_worker.spawn("cases", world, out, cases,
                                  DEADLINE_S, __file__)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().numpy()


def attention(kind, raw, meta):
    """Ring or Ulysses attention on this rank's sequence block."""
    world = dist.get_world_size()
    sp = mesh_lib.named_axes([("sp", world)])["sp"]
    fn = (ring_attention.ring_attention if kind == "ring"
          else ring_attention.ulysses_attention)
    if kind == "ulysses_heads":
        q = torch.ones(1, 3, 16 // world, 8)
        try:
            ring_attention.ulysses_attention(q, q, q, axis=sp)
        except ValueError:
            return {"raised": np.array(True)}
        return {"raised": np.array(False)}
    n = raw["q"].shape[2] // world
    cut = slice(sp.index * n, (sp.index + 1) * n)
    dt = torch.bfloat16 if meta.get("bf16") else torch.float32
    q, k, v = (_t(raw[x][:, :, cut]).to(dt).requires_grad_()
               for x in ("q", "k", "v"))
    out = fn(q, k, v, axis=sp, causal=meta["causal"])
    (out.float() * _t(raw["w_out"][:, :, cut])).sum().backward()
    return {"out": _np(out.float()), "dq": _np(q.grad.float()),
            "dk": _np(k.grad.float()), "dv": _np(v.grad.float())}


def _linear_stage(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _transformer_layer(p, x):
    """The JAX test's transformer layer (its ``layer``)."""
    hd = p["qkv"].shape[-1]
    qkv = torch.einsum("bsh,hcnd->bcsnd", x, p["qkv"])
    q, k, v = (qkv[:, i].movedim(2, 1) for i in range(3))
    a = torch.softmax(torch.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(hd),
                      dim=-1)
    o = torch.einsum("bnqk,bnkd->bnqd", a, v)
    x = x + torch.einsum("bnsd,ndh->bsh", o, p["out"])
    h = F.gelu(torch.einsum("bsh,hf->bsf", x, p["fc1"]), approximate="tanh")
    return x + torch.einsum("bsf,fh->bsh", h, p["fc2"])


def _transformer_stage(params, x):
    for i in range(params["qkv"].shape[0]):
        x = _transformer_layer({k: v[i] for k, v in params.items()}, x)
    return x


def gpipe(kind, raw, meta):
    """GPipe over a (data, pipe) mesh of the meta's sizes."""
    axes = mesh_lib.named_axes([("data", meta["data"]),
                                ("pipe", meta["pipe"])])
    pipe, data = axes["pipe"], axes["data"]
    names = meta["params"]
    stacked = {k: _t(raw[f"p:{k}"]) for k in names}
    local = {k: v.requires_grad_(True) for k, v in
             pipeline.stack_to_stages(stacked, pipe).items()}
    mb = raw["xs"].shape[1] // data.size
    rows = slice(data.index * mb, (data.index + 1) * mb)
    xs = _t(raw["xs"][:, rows], grad=True)
    if kind == "gpipe_linear":
        def stage(p, x):
            return _linear_stage(p["w"], x)
    else:
        stage = _transformer_stage
    out = pipeline.gpipe(stage, local, xs, axis=pipe,
                         data_axis=data if data.size > 1 else None)
    (out * _t(raw["w_out"][:, rows])).sum().backward()
    return {"out": _np(out), "dxs": _np(xs.grad),
            **{f"d:{k}": _np(v.grad) for k, v in local.items()}}


class _Holder(torch.nn.Module):
    """The MoE under a ``moe`` path, as JAX's test shards ``{"moe": ...}``."""

    def __init__(self, meta):
        super().__init__()
        self.moe = moe.MoEMLP(meta["m"], meta["e"], meta["f"], k=meta["k"],
                              capacity_factor=meta["cf"])


def _moe_run(model, raw, meta):
    x = _t(raw["x"], grad=True)
    y, aux = model.moe(x)
    ((y * _t(raw["w_out"])).sum() + meta["aux_weight"] * aux).backward()
    return y, aux, x


def moe_case(raw, meta):
    """The experts cut over the model axis, and the whole module."""
    tree = {"moe": {k[2:]: raw[k] for k in raw if k.startswith("p:")}}
    whole = bridge.load_jax_params(_Holder(meta), tree)
    y1, aux1, x1 = _moe_run(whole, raw, meta)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=meta["data"],
                                                  model=meta["model"]))
    model = bridge.load_jax_params(_Holder(meta), tree)
    sharding.shard_params(model, mesh,
                          sharding.MOE_SHARDING_RULES + ((r".*", ()),))
    y, aux, x = _moe_run(model, raw, meta)
    res = {"y": _np(y), "aux": _np(aux), "dx": _np(x.grad),
           "whole_y": _np(y1), "whole_aux": _np(aux1),
           "whole_dx": _np(x1.grad),
           "whole_d:router": _np(whole.moe.router.grad),
           "split": np.array(sorted(model.tp_split))}
    for name, p in model.moe.named_parameters():
        res[f"d:{name}"] = _np(p.grad)
        res[f"shape:{name}"] = np.array(p.shape)
    return res


def main(argv):
    _, rank, world, rdv, out, spec = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for item in json.loads(spec):
            raw = dict(np.load(item["case"]))
            meta = json.loads(str(raw.pop("meta")))
            kind = item["kind"]
            if kind in ("ring", "ulysses", "ulysses_heads"):
                res = attention(kind, raw, meta)
            elif kind.startswith("gpipe"):
                res = gpipe(kind, raw, meta)
            else:
                res = moe_case(raw, meta)
            np.savez(os.path.join(out, f"{item['tag']}_rank{rank}.npz"),
                     **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
