"""GPipe in the port against the JAX package's, on gloo CPU processes:
the cases of ``tests/test_pipeline.py`` at their shapes and tolerances
(the tanh stack at 2e-5, now at pipe 2 and 4; the transformer stack over
pipe 4 x data 2 at 2e-4), each against JAX's ``gpipe`` on a mesh of as
many CPU devices and against the sequential stack, plus the gradients of
the sum of the output times fixed weights with respect to every stage
parameter and the microbatches, against ``jax.grad`` of JAX's ``gpipe``
within 1e-4.

Each world size is spawned once (``tests/torch_parallel_worker.py``).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from youku_mplug_tpu.parallel.pipeline import gpipe, stack_to_stages
from youku_mplug_tpu_torch.parallel import pipeline
from youku_mplug_tpu_torch.runtime import mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

GRAD_TOL = 1e-4
# (tag, kind, pipe, data, tolerance)
CASES = [("linear_p2", "gpipe_linear", 2, 1, 2e-5),
         ("linear_p4", "gpipe_linear", 4, 1, 2e-5),
         ("transformer_p4_d2", "gpipe_transformer", 4, 2, 2e-4)]


def _linear():
    """The JAX test's tanh stack: (params, layer, xs)."""
    n_layers, d, mb, m = 8, 16, 4, 6
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(n_layers, d, d)).astype(np.float32) * 0.2)
    xs = rng.normal(size=(m, mb, d)).astype(np.float32)

    def layer(p, x):
        return jnp.tanh(x @ p["w"])
    return {"w": w}, layer, xs


def _transformer():
    """The JAX test's transformer stack: (params, layer, xs)."""
    n_layers, d, heads, mb, m = 4, 32, 4, 2, 3
    hd = d // heads
    rng = np.random.default_rng(1)

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    params = {"qkv": mk(n_layers, d, 3, heads, hd),
              "out": mk(n_layers, heads, hd, d),
              "fc1": mk(n_layers, d, 2 * d), "fc2": mk(n_layers, 2 * d, d)}
    xs = rng.normal(size=(m, mb, 6, d)).astype(np.float32)

    def layer(p, x):
        qkv = jnp.einsum("bsh,hcnd->bcsnd", x, p["qkv"])
        q, k, v = (jnp.moveaxis(qkv[:, i], 2, 1) for i in range(3))
        a = jax.nn.softmax(
            jnp.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(hd), axis=-1)
        o = jnp.einsum("bnqk,bnkd->bnqd", a, v)
        o = jnp.einsum("bnsd,ndh->bsh", o, p["out"])
        x = x + o
        h = jax.nn.gelu(jnp.einsum("bsh,hf->bsf", x, p["fc1"]))
        return x + jnp.einsum("bsf,fh->bsh", h, p["fc2"])
    return params, layer, xs


def _seq(params, layer, x):
    for i in range(next(iter(params.values())).shape[0]):
        x = layer({k: v[i] for k, v in params.items()}, x)
    return x


def _jax(kind, pipe, data, params, layer, xs, w_out):
    """(sequential output, JAX gpipe's output, its grads {name: ...} and
    of the microbatches)."""
    want = jax.vmap(lambda x: _seq(params, layer, x))(jnp.asarray(xs))

    devs = np.asarray(jax.devices()[:pipe * data]).reshape(data, pipe)
    mesh = Mesh(devs, ("data", "pipe"))

    def stage_fn(p_local, x):
        x, _ = jax.lax.scan(lambda x, pi: (layer(pi, x), None), x, p_local)
        return x

    def loss(ps, xs_):
        out = gpipe(stage_fn, ps, xs_, mesh=mesh, axis="pipe",
                    data_axis="data" if data > 1 else None)
        return jnp.sum(out * w_out), out
    with jax.set_mesh(mesh):
        ps = stack_to_stages(jax.tree.map(jnp.asarray, params), mesh, "pipe")
        (_, out), (dp, dxs) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(ps, jnp.asarray(xs))
    return (np.asarray(want), np.asarray(out),
            {k: np.asarray(v) for k, v in dp.items()}, np.asarray(dxs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: (JAX's results, [each rank's record])}."""
    d = str(tmp_path_factory.mktemp("gpipe"))
    ref, worlds = {}, {}
    for tag, kind, pipe, data, _ in CASES:
        params, layer, xs = (_linear if kind == "gpipe_linear"
                             else _transformer)()
        w_out = np.random.default_rng(9).normal(size=xs.shape).astype(
            np.float32)
        ref[tag] = _jax(kind, pipe, data, params, layer, xs, w_out)
        path = os.path.join(d, f"{tag}.npz")
        np.savez(path, meta=json.dumps({"pipe": pipe, "data": data,
                                        "params": sorted(params)}),
                 xs=xs, w_out=w_out,
                 **{f"p:{k}": v for k, v in params.items()})
        worlds.setdefault(pipe * data, []).append(
            {"kind": kind, "tag": tag, "case": path})
    for world, cases in sorted(worlds.items()):
        worker.spawn(world, d, cases)
    out = {}
    for tag, _, pipe, data, _ in CASES:
        out[tag] = (ref[tag], [dict(np.load(os.path.join(
            d, f"{tag}_rank{r}.npz"))) for r in range(pipe * data)])
    return out


def _rows(ranks, pipe, data, key):
    """Data rank j's rows (from its pipe-0 rank) joined on axis 1."""
    return np.concatenate([ranks[j * pipe][key] for j in range(data)], 1)


@pytest.mark.parametrize("tag,kind,pipe,data,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_sequential_and_jax(runs, tag, kind, pipe, data, tol):
    (want, jout, _, _), ranks = runs[tag]
    got = _rows(ranks, pipe, data, "out")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, jout, rtol=tol, atol=tol)
    # every pipe rank of a data rank holds the same outputs
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["out"],
                                      ranks[r - r % pipe]["out"])


@pytest.mark.parametrize("tag,kind,pipe,data,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_gradients_match_jax_grad(runs, tag, kind, pipe, data, tol):
    (_, _, dp, dxs), ranks = runs[tag]
    for name, want in dp.items():
        # pipe rank i holds layers [i L/P, (i+1) L/P); the data ranks'
        # copies are equal (summed over the data axis)
        for j in range(data):
            got = np.concatenate([ranks[j * pipe + i][f"d:{name}"]
                                  for i in range(pipe)])
            np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)
    for i in range(pipe):
        got = np.concatenate([ranks[j * pipe + i]["dxs"]
                              for j in range(data)], 1)
        np.testing.assert_allclose(got, dxs, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_named_axes_without_a_process_group():
    """One process: every named axis has one rank and no group; a mesh
    that does not cover the world, or with ``model`` not last, raises."""
    axes = mesh.named_axes([("data", 1), ("pipe", 1)])
    assert axes == {"data": mesh.AxisGroup(None, 0, 1),
                    "pipe": mesh.AxisGroup(None, 0, 1)}
    with pytest.raises(ValueError, match="rank"):
        mesh.named_axes([("pipe", 2)])
    with pytest.raises(ValueError, match="fastest"):
        mesh.named_axes([("model", 1), ("sp", 1)])


def test_one_stage_gpipe_is_the_stack_on_each_microbatch():
    """Without a pipe axis: every microbatch through the whole stack,
    and ``stack_to_stages`` keeps every layer."""
    params, layer, xs = _linear()
    w = torch.from_numpy(params["w"])
    assert torch.equal(pipeline.stack_to_stages({"w": w}, None)["w"], w)

    def stage(p, x):
        for i in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][i])
        return x
    got = pipeline.gpipe(stage, {"w": w}, torch.from_numpy(xs), axis=None)
    want = jax.vmap(lambda x: _seq(params, layer, x))(jnp.asarray(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
