"""The port's mesh, PRNG folding and sharding rules against the JAX
package: ``runtime/mesh.py``, ``runtime/prng.py``,
``parallel/sharding.py`` and ``parallel/tensor_parallel.py``.

- ``sharding_for_params`` gives, leaf by leaf, the spec of JAX's on the
  tiny flagship tree and the tiny Owl tree, for the GPT-3 and the Bloom
  rules, on meshes (1,2), (2,1), (2,2), (1,4), (4,1), (1,8), (2,4) (the
  JAX side on conftest's 8 virtual CPU devices);
- ``MeshConfig.resolve`` resolves and raises where JAX's does, with its
  message; a model > 1 YAML in one process raises it from ``serve``;
- on 2 and 4 gloo processes (``tests/torch_mesh_worker.py``, one world a
  size): ``shard_params`` then ``unshard`` round-trips every leaf
  bitwise, the local shapes are JAX's split, a model shard builds for
  ``--speculative`` and takes a prompt-lookup step (no refusal), and
  unmerged LoRA adapters shard with their model.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from youku_mplug_tpu.parallel import sharding as jsharding
from youku_mplug_tpu.runtime import mesh as jmesh
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import load_owl_config
from youku_mplug_tpu_torch.models.owl import MPLUGOwlVideo
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.parallel import sharding, tensor_parallel
from youku_mplug_tpu_torch.runtime import mesh, prng
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_serve_mesh as serve_mesh  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (1, 8), (2, 4)]
RULES = {"gpt3": (sharding.GPT3_SHARDING_RULES,
                  jsharding.GPT3_SHARDING_RULES),
         "bloom": (sharding.BLOOM_SHARDING_RULES,
                   jsharding.BLOOM_SHARDING_RULES)}


@pytest.fixture(scope="module")
def trees():
    """{name: (port module, its tree under JAX's paths)}: the tiny
    flagship and the tiny Owl (the one of configs/instruct/
    serve_owl_tiny.yaml)."""
    from youku_mplug_tpu_torch.config import flagship_config

    flag = MPLUGVideo(flagship_config(tiny=True), FP32_POLICY,
                      proj_heads=True)
    owl = MPLUGOwlVideo(load_owl_config(
        "configs/instruct/serve_owl_tiny.yaml")[0], FP32_POLICY)
    return {name: (m, bridge.to_jax_tree(bridge.seeded_init(m, 0)))
            for name, m in (("flagship", flag), ("owl", owl))}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("tree", ["flagship", "owl"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_specs_equal_jax_leaf_by_leaf(trees, tree, rules, shape):
    module, jtree = trees[tree]
    port_rules, jax_rules = RULES[rules]
    data, model = shape
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model),
                         devices=jax.devices()[:data * model])
    want = {bridge.port_name(jsharding._path_str(path)): tuple(s.spec)
            for path, s in
            jax.tree_util.tree_flatten_with_path(
                jsharding.sharding_for_params(jtree, jm, jax_rules))[0]}
    got = sharding.sharding_for_params(
        module.named_parameters(), {"data": data, "model": model},
        port_rules)
    assert set(got) == set(want)
    assert {n: s for n, s in got.items() if s != want[n]} == {}
    if model > 1 and rules == "gpt3":  # the decoder is split somewhere
        assert any("model" in s for s in got.values())


def test_sharding_rules_are_jax_verbatim():
    for port_rules, jax_rules in RULES.values():
        assert [(p, tuple(s)) for p, s in port_rules] == \
            [(p, tuple(s)) for p, s in jax_rules]


@pytest.mark.parametrize("cfg,n", [((-1, 1), 1), ((-1, 2), 4), ((-1, 3), 4),
                                   ((2, 2), 4), ((2, 2), 8), ((0, 0), 3),
                                   ((4, 1), 2), ((-1, 4), 2), ((1, 8), 8)])
def test_mesh_config_resolves_and_raises_as_jax(cfg, n):
    def resolve(cls):
        try:
            r = cls(data=cfg[0], model=cfg[1]).resolve(n)
            return (r.data, r.model)
        except ValueError as e:
            return str(e)
    assert resolve(mesh.MeshConfig) == resolve(jmesh.MeshConfig)


def test_one_process_mesh_and_a_model_yaml_raise_jax_text(tmp_path):
    from youku_mplug_tpu_torch.cli import serve

    one = mesh.make_mesh()
    assert (one.data, one.model, one.coord, one.distributed) == \
        (1, 1, (0, 0), False)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        mesh.make_mesh(mesh.MeshConfig(model=2))
    with pytest.raises(ValueError, match=r"mesh 2x1 != n_devices 1"):
        mesh.make_mesh(mesh.MeshConfig(data=2))
    import yaml

    path = serve_mesh._yaml(str(tmp_path), "1x2")
    with pytest.raises(ValueError, match="mesh 1x2 != n_devices 1"):
        serve.build(worker.serve_args(path, str(tmp_path)))
    path = tmp_path / "any_data.yaml"
    path.write_text(yaml.safe_dump({**serve_mesh.TINY,
                                    "mesh": {"data": -1, "model": 2}}))
    with pytest.raises(ValueError, match="n_devices=1 not divisible by "
                                         "model=2"):
        serve.build(worker.serve_args(str(path), str(tmp_path)))


def test_config_mesh_block_and_megatron_degree_as_jax(tmp_path):
    from youku_mplug_tpu.config import load_config as j_load
    from youku_mplug_tpu_torch.config import load_config

    import yaml

    for extra in ({"mesh": {"data": 2, "model": 4}},
                  {"megatron_cfg": {"tensor_model_parallel_size": 2}},
                  {"megatron_cfg": {"model_parallel_size": 8}}, {}):
        path = tmp_path / "c.yaml"
        path.write_text(yaml.safe_dump({**serve_mesh.TINY, **extra}))
        got, want = load_config(str(path)).mesh, j_load(str(path)).mesh
        assert (got.data, got.model) == (want.data, want.model)


def test_device_peak_flops_knows_the_h100_and_raises_elsewhere(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert mesh.device_peak_flops() == 989e12
    assert mesh.mfu(989e12, 2.0) == 0.5
    # the PCIe and NVL parts say "H100" too, at a lower peak: not assumed
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe",
                  "NVIDIA H100 NVL"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, other=other: other)
        with pytest.raises(ValueError, match="no bf16 peak"):
            mesh.device_peak_flops()


def test_local_batch_size_contract():
    assert mesh.local_batch_size(32, mesh.Mesh()) == 32  # JAX's, 1 process
    assert mesh.local_batch_size(32, {"data": 4, "model": 2}) == 8
    with pytest.raises(ValueError, match="not divisible by data=4"):
        mesh.local_batch_size(30, {"data": 4, "model": 2})


def test_prng_folds_only_the_named_axes():
    a = mesh.Mesh(2, 2, rank=1)   # (0, 1)
    b = mesh.Mesh(2, 2, rank=0)   # (0, 0)
    c = mesh.Mesh(2, 2, rank=2)   # (1, 0)
    assert prng.fold_in_axes(7, a, "data") == prng.fold_in_axes(7, b, "data")
    assert prng.fold_in_axes(7, a, "model") != prng.fold_in_axes(7, b,
                                                                 "model")
    assert prng.fold_in_axes(7, c, "data") != prng.fold_in_axes(7, b, "data")
    assert prng.fold_in(7, 1) != prng.fold_in(7, 2) != prng.fold_in(8, 1)
    assert prng.fold_in(7, 1) == prng.fold_in(7, 1) < 2 ** 63

    def draws(**kw):
        g = prng.make_rngs(5, 3, ("dropout", "sample"), **kw)
        return {k: torch.rand(4, generator=v) for k, v in g.items()}
    one, two = draws(), draws()
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["dropout"], one["sample"])
    assert all(torch.equal(draws(mesh=a, axes=("data",))[k],
                           draws(mesh=b, axes=("data",))[k]) for k in one)
    assert not torch.equal(draws(mesh=c, axes=("data",))["sample"],
                           draws(mesh=b, axes=("data",))["sample"])


def test_tensor_parallel_is_the_identity_without_a_model_group():
    x = torch.randn(3, 5)
    assert tensor_parallel.reduce_from_model(x, None) is x
    assert tensor_parallel.gather_vocab_logits(x, None) is x
    table = torch.randn(10, 4)
    ids = torch.tensor([[1, 9], [0, 3]])
    out = tensor_parallel.vocab_parallel_embedding(
        ids, 10, lambda i: torch.nn.functional.embedding(i, table), None)
    assert torch.equal(out, table[ids])
    tp = tensor_parallel.ModelGroup(None, 0, 1)
    assert tensor_parallel.reduce_from_model(x, tp) is x


def test_shard_params_refuses_what_it_cannot_split():
    from youku_mplug_tpu_torch.config import flagship_config

    m = MPLUGVideo(flagship_config(tiny=True), FP32_POLICY)
    with pytest.raises(ValueError, match="without process groups"):
        sharding.shard_params(m, mesh.Mesh(1, 2))
    assert sharding.shard_params(m, mesh.Mesh()).tp_split == {}
    assert not tensor_parallel.model_parallel(m)


SHARD_SPLITS = {2: ["1x2", "2x1"], 4: ["1x4", "2x2"]}


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """{tag: {rank: the worker's shards record}}, one world a size."""
    import json

    d = str(tmp_path_factory.mktemp("shards"))
    for world, tags in SHARD_SPLITS.items():
        serve_mesh.spawn("shards", world, d, [
            {"tag": t, "yaml": serve_mesh._yaml(d, t)} for t in tags])
    out = {}
    for tags in SHARD_SPLITS.values():
        for t in tags:
            ranks = int(t[0]) * int(t[2])
            out[t] = {}
            for r in range(ranks):
                with open(os.path.join(d, t, f"shards_rank{r}.json")) as f:
                    out[t][r] = json.load(f)
    return d, out


@pytest.mark.parametrize("tag", ["1x2", "2x1", "1x4", "2x2"])
def test_shard_then_unshard_round_trips_bitwise(shard_runs, tag):
    from youku_mplug_tpu_torch.config import load_config

    d, runs = shard_runs
    model = int(tag[2])
    cfg = load_config(serve_mesh._yaml(d, tag))
    full = dict(MPLUGVideo(cfg.model, FP32_POLICY).named_parameters())
    specs = sharding.sharding_for_params(full, {"data": int(tag[0]),
                                                "model": model})
    for rec in runs[tag].values():
        assert rec["roundtrip"] == []  # every leaf bitwise
        for name, p in full.items():
            want = list(p.shape)
            if model > 1 and "model" in specs[name]:
                want[specs[name].index("model")] //= model
            assert rec["local"][name] == want, name
        assert bool(rec["split"]) == (model > 1)
        assert rec["eager"] == (model > 1)
        # speculative serving and prompt lookup run on a model shard
        for what in ("speculative", "lookup"):
            assert rec["refusals"][what] is None
        assert rec["refusals"]["lora"] is None  # adapters shard too
        # and give the unsharded twin's query features and logits, the
        # vision tower's and the decoder's adapters on split products
        assert max(rec["lora_err"]) < 1e-4, rec["lora_err"]


@pytest.mark.parametrize("tag", ["1x2", "2x1", "1x4", "2x2"])
def test_shard_state_is_what_a_mirror_of_a_shard_copies(shard_runs, tag):
    """``shard_params`` sets no attribute on a module (of a model with
    LoRA adapters or without) that ``sharding.SHARD_STATE`` leaves out,
    so ``copy_shard_state`` (the twin draft's) carries all of a shard's
    state; a model shard sets every one of them."""
    _, runs = shard_runs
    for rec in runs[tag].values():
        got = set(rec["shard_state"])
        assert got <= set(sharding.SHARD_STATE), got
        if int(tag[2]) > 1:
            assert got == set(sharding.SHARD_STATE)


def test_vision_route_on_local_heads():
    """At model = 4 the tiny tower's 4 heads of 64 leave one a rank: the
    packed kernel's route (global geometry) on the head-major kernel."""
    import unittest.mock as mock

    from youku_mplug_tpu_torch.models import vision
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    att = bridge.seeded_init(vision.VisionAttention(256, 4), 0)
    x = torch.randn(2, 128, 256)
    want = att(x, period=2)
    for p, dim in (("qkv_kernel", 2), ("q_bias", 0), ("v_bias", 0),
                   ("proj_kernel", 0)):
        t = getattr(att, p)
        t.data = t.data.narrow(dim, 0, t.shape[dim] // 4).clone()
    calls = []
    with mock.patch.object(vision, "flash_attention",
                           lambda *a, **k: calls.append(k)
                           or fa.flash_attention(*a, **k)), \
            mock.patch.object(vision, "flash_attention_packed",
                              side_effect=AssertionError("packed")):
        part = att(x, period=2)
    assert att.num_heads == 1 and calls == [{"period": 2}]
    assert part.shape == want.shape


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_data_shard_is_jax_data_sharding(shape):
    """Each rank's block of a global batch is the rows JAX's
    ``data_sharding`` places on that rank's device."""
    data, model = shape
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model),
                         devices=jax.devices()[:data * model])
    batch = {"video": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "video_id": [str(i) for i in range(8)], "step": 5}
    placed = jax.device_put(batch["video"], jsharding.data_sharding(jm))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    for rank in range(data * model):
        got = sharding.data_shard(batch, mesh.Mesh(data, model, rank))
        d, m = divmod(rank, model)
        np.testing.assert_array_equal(got["video"],
                                      by_device[jm.devices[d, m]])
        assert got["video_id"] == [str(i) for i in range(
            d * 8 // data, (d + 1) * 8 // data)]
        assert got["step"] == 5
    with pytest.raises(ValueError, match="not divisible by data=3"):
        sharding.data_shard({"video": np.zeros((8, 2))}, mesh.Mesh(3, 1))

