"""Ring and Ulysses attention in the port against the JAX package's, on
gloo CPU processes: every case of ``tests/test_ring_attention.py`` at its
shapes and tolerance (2e-5), ring at sp 4 and 8 and Ulysses at 4, causal
and not, the long-context case and Ulysses' refusal of heads that do not
divide, plus the gradients (dq, dk, dv of the sum of the output times
fixed weights) against ``jax.grad`` of the JAX function within 1e-4.
A bf16 ring at sp 8 (the kernels' dtype; its block partials and block
gradients leave the kernels' fp32-output builds, and their plain
versions, in fp32, merged and summed before one rounding) is held
against JAX in fp32 on the same bf16 values within the chip check's
backward gate, 2^-7 relative L2, and its error against the one-rank bf16
form's: at most RING_RATIO_BOUND times it for each of out, dq, dk and dv
(bf16 partials, rounded once a block, read 1.09-1.15 there).

Each world size is spawned once (``tests/torch_parallel_worker.py``) and
runs every case of its size; JAX runs on the same numpy inputs over a mesh
of as many CPU devices.
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

from youku_mplug_tpu.ops.attention import mha_reference
from youku_mplug_tpu.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from youku_mplug_tpu_torch.parallel import ring_attention as tra

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

TOL = 2e-5       # JAX's own gate on the outputs
GRAD_TOL = 1e-4
BF16_TOL = 2.0 ** -7  # chip_smoke.py's BWD_TOL, relative L2
# (tag, kind, sp, causal, seed, (b, h, s, d)): the JAX test's cases
CASES = [(f"{kind}_sp{sp}_{'causal' if causal else 'full'}", kind, sp,
          causal, seed, shape)
         for kind, sps, seed, shape in (
             ("ring", (4, 8), 0, (2, 3, 64, 16)),
             ("ulysses", (4,), 3, (2, 8, 64, 16)))
         for sp in sps for causal in (False, True)]
# the bf16 ring: 64 tokens a rank over sp 8
BF16_SHAPE = (2, 4, 512, 32)
BF16_CASES = [f"ring_sp8_bf16_{'causal' if c else 'full'}"
              for c in (False, True)]
# the sp 8 ring's error against JAX fp32 over the one-rank form's: read
# 1.0000-1.0017 with fp32 partials (bf16 partials: 1.09-1.15)
RING_RATIO_BOUND = 1.02


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_fn(kind, sp, causal):
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    fn = ring_attention if kind == "ring" else ulysses_attention

    def loss(q, k, v, w):
        out = fn(q, k, v, mesh=mesh, axis="sp", causal=causal)
        return jnp.sum(out * w), out
    return mesh, jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True))


def _write(d, tag, meta, **arrays):
    path = os.path.join(d, f"{tag}.npz")
    np.savez(path, meta=json.dumps(meta), **arrays)
    return path


def _gather(d, tag, sp, key):
    """The ranks' sequence blocks of ``key`` joined in rank order."""
    return np.concatenate([np.load(os.path.join(d, f"{tag}_rank{r}.npz"))[key]
                           for r in range(sp)], axis=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: (the JAX output, JAX's grads, the case's directory)}."""
    d = str(tmp_path_factory.mktemp("ring"))
    ref, worlds = {}, {4: [], 8: []}
    for tag, kind, sp, causal, seed, shape in CASES:
        rng = np.random.default_rng(seed)
        q, k, v, w = (rng.normal(size=shape).astype(np.float32)
                      for _ in range(4))
        mesh, fn = _jax_fn(kind, sp, causal)
        with jax.set_mesh(mesh):
            (_, out), grads = fn(*map(jnp.asarray, (q, k, v, w)))
        ref[tag] = (np.asarray(out), [np.asarray(g) for g in grads])
        worlds[sp].append({"kind": kind, "tag": tag, "case": _write(
            d, tag, {"causal": causal}, q=q, k=k, v=v, w_out=w)})
    rng = np.random.default_rng(7)
    q, k, v, w = (_bf16(rng.normal(size=BF16_SHAPE).astype(np.float32))
                  for _ in range(4))
    for tag in BF16_CASES:
        causal = tag.endswith("causal")
        mesh, fn = _jax_fn("ring", 8, causal)
        with jax.set_mesh(mesh):
            (_, out), grads = fn(*map(jnp.asarray, (q, k, v, w)))
        ref[tag] = (np.asarray(out), [np.asarray(g) for g in grads])
        worlds[8].append({"kind": "ring", "tag": tag, "case": _write(
            d, tag, {"causal": causal, "bf16": True}, q=q, k=k, v=v,
            w_out=w)})
    # the long-context case: uniform values at 8 x 256 tokens
    ones = np.ones((1, 2, 8 * 256, 32), np.float32)
    worlds[8].append({"kind": "ring", "tag": "long", "case": _write(
        d, "long", {"causal": True}, q=ones, k=ones, v=ones, w_out=ones)})
    worlds[4].append({"kind": "ulysses_heads", "tag": "heads",
                      "case": _write(d, "heads", {})})
    for world, cases in worlds.items():
        worker.spawn(world, d, cases)
    return ref, d


@pytest.mark.parametrize("tag,kind,sp,causal,seed,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax(runs, tag, kind, sp, causal, seed, shape):
    ref, d = runs
    np.testing.assert_allclose(_gather(d, tag, sp, "out"), ref[tag][0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tag,kind,sp,causal,seed,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_gradients_match_jax_grad(runs, tag, kind, sp, causal, seed, shape):
    ref, d = runs
    for name, want in zip(("dq", "dk", "dv"), ref[tag][1]):
        np.testing.assert_allclose(_gather(d, tag, sp, name), want,
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def _bf16_errors(runs, tag):
    """({name: relative L2 of the sp 8 ring against JAX fp32}, {name: the
    one-rank bf16 form's on the same values}) for out, dq, dk, dv."""
    ref, d = runs
    raw = np.load(os.path.join(d, f"{tag}.npz"))
    leaves = [torch.tensor(raw[x]).bfloat16().requires_grad_()
              for x in ("q", "k", "v")]
    out = tra.ring_attention(*leaves, axis=None,
                             causal=tag.endswith("causal"))
    (out.float() * torch.from_numpy(raw["w_out"])).sum().backward()
    one = [out.detach().float().numpy()] + [t.grad.float().numpy()
                                            for t in leaves]
    want = [ref[tag][0], *ref[tag][1]]
    names = ("out", "dq", "dk", "dv")
    errs = {n: _rel_l2(_gather(d, tag, 8, n), w)
            for n, w in zip(names, want)}
    return errs, dict(zip(names, map(_rel_l2, one, want)))


@pytest.mark.parametrize("tag", BF16_CASES)
def test_bf16_ring_at_sp8_within_the_chip_gate(runs, tag):
    """The bf16 ring's output and gradients at sp 8 against JAX's fp32
    ones, within 2^-7 relative L2; the one-rank bf16 form's error on
    the same values printed beside them."""
    errs, one = _bf16_errors(runs, tag)
    print(f"{tag}: relative L2 against JAX fp32 at sp 8 {errs}, at one "
          f"rank {one}")
    assert max(errs.values()) <= BF16_TOL, errs


@pytest.mark.parametrize("tag", BF16_CASES)
def test_fp32_partials_keep_the_sp8_ring_at_the_one_rank_error(runs, tag):
    """With the blocks' partials and gradients in fp32 the sp 8 ring's
    error against JAX fp32 is the one-rank form's, within
    RING_RATIO_BOUND, for each of out, dq, dk and dv: one rounding, not
    one a block (bf16 partials: 1.09-1.15)."""
    errs, one = _bf16_errors(runs, tag)
    ratios = {n: errs[n] / one[n] for n in errs}
    print(f"{tag}: sp 8 / one rank {ratios}")
    assert max(ratios.values()) <= RING_RATIO_BOUND, ratios


@pytest.mark.parametrize("causal", [False, True])
def test_block_partials_leave_in_fp32(causal):
    """``_block_fwd`` and ``_block_bwd`` hand the ring fp32 partials from
    bf16 inputs: unrounded sums, within a bf16 rounding (2^-8 relative)
    of the bf16 outputs' on the same inputs."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 3, 70, 64)).astype(
        np.float32)).bfloat16() for _ in range(4))
    o, lse = tra._block_fwd(q, k, v, 0.125, causal)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    o16, lse16 = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=causal)
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o, o16.float(), rtol=2.0 ** -8, atol=1e-6)
    assert torch.equal(lse, lse16)
    assert not torch.equal(o, o.to(torch.bfloat16).float())  # not rounded
    delta = fa.flash_bwd_delta_plain(o16, do)
    grads = tra._block_bwd(q, k, v, o16, lse, do, delta, 0.125, causal)
    want = fa.flash_bwd_plain(q, k, v, o16, lse, do, scale=0.125,
                              causal=causal)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and w.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.float(), rtol=2.0 ** -8, atol=1e-6)
        assert not torch.equal(g, g.to(torch.bfloat16).float())


def test_ring_long_context_shape_and_uniform_output(runs):
    """JAX's long-context case: 256 of 2048 keys a rank, the output
    sharded on the sequence, equal to v where every value is one."""
    _, d = runs
    out = _gather(d, "long", 8, "out")
    assert out.shape == (1, 2, 8 * 256, 32)
    assert np.load(os.path.join(d, "long_rank3.npz"))["out"].shape[2] == 256
    np.testing.assert_allclose(out[0, 0, -1], np.ones(32), rtol=1e-5)
    np.testing.assert_allclose(out, 1.0, rtol=1e-5)


def test_ulysses_rejects_indivisible_heads(runs):
    _, d = runs
    for r in range(4):
        assert np.load(os.path.join(d, f"heads_rank{r}.npz"))["raised"]


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_forms_are_full_attention(causal):
    """Without an sp axis both are attention over the whole sequence
    (JAX's ``mha_reference``), and the ring's backward its gradient."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(size=(2, 4, 40, 16)).astype(np.float32)
                  for _ in range(4))
    want = np.asarray(mha_reference(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    grads = jax.grad(lambda *a: jnp.sum(mha_reference(
        *a, causal=causal) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for fn in (tra.ring_attention, tra.ulysses_attention):
        leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
        out = fn(*leaves, axis=None, causal=causal)
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL,
                                   atol=TOL)
        (out * torch.from_numpy(w)).sum().backward()
        for t, g in zip(leaves, grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
