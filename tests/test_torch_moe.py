"""The MoE FFN in the port against the JAX package's: the routing cases
of ``tests/test_moe.py`` (top-1 is the arg-max expert's FFN times its
gate, top-2 adds a second expert, capacity drops the overflow) in one
process, and the expert-sharded module over a (data 2, model 4) mesh of
gloo CPU processes (``tests/torch_parallel_worker.py``) against the
replicated JAX module at 2e-4 (JAX's gate), with the gradients of every
leaf, the router's included, of the sum of y times fixed weights plus
half the aux loss against ``jax.grad`` of the JAX module within 1e-4,
and the router's gradient at ep = 4 against the whole module's in the
same process.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.parallel.moe import MoEMLP as JMoE
from youku_mplug_tpu.parallel.moe import moe_rules as j_rules
from youku_mplug_tpu.parallel.moe import top_k_routing as j_routing
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.parallel import moe, sharding

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

TOL = 2e-4
GRAD_TOL = 1e-4
LEAVES = ("router", "w1", "b1", "w2", "b2")


def _pair(x, e, f, k, cf, seed=0):
    """JAX's module and params at x's shape, and the port's module with
    those params loaded."""
    jm = JMoE(num_experts=e, ffn_dim=f, k=k, capacity_factor=cf)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))["params"]
    tm = bridge.load_jax_params(
        moe.MoEMLP(x.shape[-1], e, f, k=k, capacity_factor=cf),
        jax.device_get(params))
    return jm, params, tm


def test_top1_routing_equals_argmax_expert():
    rng = np.random.default_rng(0)
    g, s, m, e, f = 2, 8, 16, 4, 32
    x = rng.normal(size=(g, s, m)).astype(np.float32)
    jm, params, tm = _pair(x, e, f, 1, 8.0)
    with torch.no_grad():
        y, aux = tm(torch.from_numpy(x))
    jy, jaux = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    p = {k: getattr(tm, k).detach().numpy() for k in LEAVES}
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p["router"]), -1).numpy()
    for gi in range(g):
        for si in range(s):
            ei = gates[gi, si].argmax()
            h = jax.nn.gelu(x[gi, si] @ p["w1"][ei] + p["b1"][ei])
            want = (np.asarray(h) @ p["w2"][ei] + p["b2"][ei]) * \
                gates[gi, si, ei]
            np.testing.assert_allclose(y[gi, si].numpy(), want, rtol=TOL,
                                       atol=TOL)
    assert float(aux) > 0


def test_top2_combines_two_experts():
    rng = np.random.default_rng(1)
    g, s, m, e, f = 1, 6, 8, 4, 16
    x = rng.normal(size=(g, s, m)).astype(np.float32)
    jm, params, tm = _pair(x, e, f, 2, 8.0)
    with torch.no_grad():
        y2, _ = tm(torch.from_numpy(x))
        tm.k = 1
        y1, _ = tm(torch.from_numpy(x))
    jy2, _ = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=TOL,
                               atol=TOL)
    assert not np.allclose(y1.numpy(), y2.numpy())


def test_capacity_drops_overflow():
    s = 4
    gates = torch.softmax(torch.tensor([[5.0, 0.0]]).repeat(s, 1), -1)[None]
    dispatch, combine, _ = moe.top_k_routing(gates, k=1, capacity=1)
    assert int(dispatch.sum()) == 1
    assert float(combine[0, 0].sum()) > 0
    assert float(combine[0, 1:].sum()) == 0


@pytest.mark.parametrize("k,capacity", [(1, 1), (2, 2), (2, 5), (3, 3)])
def test_routing_equals_jax(k, capacity):
    """dispatch, combine and aux equal JAX's for the same gates, with
    ties and overflow (capacities below and above the load)."""
    rng = np.random.default_rng(k * 10 + capacity)
    logits = rng.normal(size=(3, 12, 5)).astype(np.float32)
    logits[0, :4] = logits[0, 0]  # equal rows: the same choices
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    jd, jc, jaux = j_routing(jnp.asarray(gates), k, capacity)
    d, c, aux = moe.top_k_routing(torch.tensor(gates), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_rules_are_jax_verbatim():
    assert [(p, tuple(s)) for p, s in sharding.MOE_SHARDING_RULES] == \
        [(p, tuple(s)) for p, s in j_rules()]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX references and the (2, 4) world's records."""
    d = str(tmp_path_factory.mktemp("moe"))
    rng = np.random.default_rng(2)
    g, s, m, e, f = 4, 8, 16, 4, 32
    x = rng.normal(size=(g, s, m)).astype(np.float32)
    w_out = rng.normal(size=(g, s, m)).astype(np.float32)
    jm = JMoE(num_experts=e, ffn_dim=f, k=2, capacity_factor=4.0)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    aux_weight = 0.5

    def loss(p, x_):
        y, aux = jm.apply({"params": p}, x_)
        return jnp.sum(y * w_out) + aux_weight * aux, (y, aux)
    (_, (y, aux)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    path = os.path.join(d, "moe.npz")
    np.savez(path, meta=json.dumps({"m": m, "e": e, "f": f, "k": 2,
                                    "cf": 4.0, "data": 2, "model": 4,
                                    "aux_weight": aux_weight}),
             x=x, w_out=w_out,
             **{f"p:{k}": np.asarray(v) for k, v in params.items()})
    worker.spawn(8, d, [{"kind": "moe", "tag": "moe", "case": path}])
    ranks = [dict(np.load(os.path.join(d, f"moe_rank{r}.npz")))
             for r in range(8)]
    return (np.asarray(y), float(aux), {k: np.asarray(v) for k, v in
                                        dp.items()}, np.asarray(dx)), ranks


def test_moe_expert_sharded_matches_replicated(sharded):
    (y, aux, _, _), ranks = sharded
    for rec in ranks:
        assert "moe.w1" in rec["split"] and "moe.router" not in rec["split"]
        assert tuple(rec["shape:w1"]) == (1, 16, 32)
        np.testing.assert_allclose(rec["y"], y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rec["aux"], aux, rtol=1e-6)


@pytest.mark.parametrize("leaf", LEAVES + ("x",))
def test_moe_sharded_gradients_match_jax_grad(sharded, leaf):
    """Each expert leaf's slices joined over the model ranks (experts
    [i, i + 1) on model rank i; both data ranks alike), the router and x
    whole on every rank."""
    (_, _, dp, dx), ranks = sharded
    for j in range(2):
        line = ranks[4 * j:4 * (j + 1)]
        if leaf == "x":
            got, want = line[0]["dx"], dx
        elif leaf == "router":
            got, want = line[0]["d:router"], dp["router"]
        else:
            got = np.concatenate([r[f"d:{leaf}"] for r in line])
            want = dp[leaf]
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)
    for rec in ranks:
        np.testing.assert_array_equal(rec["d:router"], ranks[0]["d:router"])


def test_router_gradient_at_ep4_equals_one_rank(sharded):
    """The router's gradient is whole on every rank of the split (the
    combine's share summed, the aux loss's not), as the unsplit module's
    in the same process."""
    _, ranks = sharded
    for rec in ranks:
        np.testing.assert_allclose(rec["d:router"], rec["whole_d:router"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rec["dx"], rec["whole_dx"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rec["y"], rec["whole_y"], rtol=1e-5,
                                   atol=1e-6)
