"""Dropout under a (data, model) split: every mask drawn at the global
array's shape, each rank keeping its block, so a split's step is the
(1,1) step on the global batch, dropout included.

- ``ops/attention``: the keep mask of a block (rows, heads, columns, or
  several at once) is the (1,1) mask's slice bitwise, and ``dropout``,
  ``drop_path`` and ``mha_reference``'s attention dropout on a block
  equal the global call's slice; the generator is left where the global
  draw leaves it.
- One train step of ``cls_train_loss`` and of ``itm_train_loss`` on the
  tiny downstream model (clip_model tower of 2 blocks with ``drop_rate``,
  ``attn_drop_rate`` and ``drop_path`` at 0.1 under ``grad_ckpt``; a
  2-layer decoder with hidden and attention dropout at 0.1 under
  ``remat``), fp32, on gloo CPU processes at (2,1), (1,2) and (2,2),
  against the port's (1,1) step in this process: the loss within rtol
  1e-5 and every trainable leaf within 1e-6 (the masks are (1,1)'s, only
  the reduction order differs); every mask each rank kept, in order (the
  checkpointed blocks' and layers' replays included), the (1,1) mask's
  block bitwise; ITM's decoder passes take 3B / data rows on each rank.
- ``run_pretrain`` (dropout in both towers, the remat decoder),
  ``run_caption`` and ``run_instruct --train`` (Bloom's hidden and
  attention dropout, the ViT's attention dropout and drop-path) under a
  split with dropout: their step losses are the (1,1) run's.

The workers are ``tests/torch_downstream_mesh_worker.py``'s.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu_torch.ops import attention
from youku_mplug_tpu_torch.runtime.mesh import AxisGroup, Mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_caption as caption_tests  # noqa: E402
import torch_downstream_mesh_worker as worker  # noqa: E402
import torch_owl_mesh_worker as owl_worker  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-6


# ----- the masks of one block against the global draw -----

def _gen(seed=11):
    return torch.Generator().manual_seed(seed)


BLOCK_CASES = {
    "rows": [(0, 1, 2)],
    "heads": [(1, 2, 4)],
    "columns": [(2, 0, 3)],
    "rows_and_heads": [(0, 1, 2), (1, 1, 2)],
}


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_keep_mask_of_a_block_is_the_global_masks_slice(name):
    """A block's mask is the global draw's slice bitwise, and both
    leave the generator in the same state (the next draw agrees)."""
    blocks = tuple(tuple(b) for b in BLOCK_CASES[name])
    full = (4, 8, 6, 5)
    local = list(full)
    for dim, _, count in blocks:
        local[dim] //= count
    g1, g2 = _gen(), _gen()
    want = attention._keep_mask(full, 0.3, g1, "cpu")
    got = attention._keep_mask(tuple(local), 0.3, g2, "cpu", blocks)
    sl = want
    for dim, index, _ in blocks:
        sl = sl.narrow(dim, index * local[dim], local[dim])
    assert got.is_contiguous() and got.shape == sl.shape
    assert torch.equal(got, sl)
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


def test_block_of_reads_an_axis_group():
    assert attention.block_of(0, None) == ()
    assert attention.block_of(1, AxisGroup(None, 0, 1)) == ()
    assert attention.block_of(1, AxisGroup(None, 1, 4)) == ((1, 1, 4),)


@pytest.mark.parametrize("rank", [0, 1])
def test_dropout_and_drop_path_of_a_block_equal_the_global_slice(rank):
    x = torch.randn(6, 5, 8, generator=_gen(1))
    rows = ((0, rank, 2),)
    want = attention.dropout(x, 0.25, _gen())[3 * rank:3 * rank + 3]
    got = attention.dropout(x[3 * rank:3 * rank + 3], 0.25, _gen(), rows)
    assert torch.equal(got, want)
    cols = ((2, rank, 2),)
    want = attention.dropout(x, 0.25, _gen())[..., 4 * rank:4 * rank + 4]
    got = attention.dropout(x[..., 4 * rank:4 * rank + 4], 0.25, _gen(),
                            cols)
    assert torch.equal(got, want)
    want = attention.drop_path(x, 0.5, _gen())[3 * rank:3 * rank + 3]
    got = attention.drop_path(x[3 * rank:3 * rank + 3], 0.5, _gen(), rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_attention_dropout_on_a_block_equals_the_global_slice(data, model):
    """Each (data, model) block of rows and heads: output and gradients
    the global call's slice (fp32: each row and head is its own
    product, only the batching differs)."""
    g = _gen(3)
    q, k, v = (torch.randn(4, 4, 6, 8, generator=g, dtype=torch.float64)
               for _ in range(3))
    w = torch.randn(4, 4, 6, 8, generator=g, dtype=torch.float64)
    full = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention.mha_reference(*full, causal=True, dropout_rate=0.2,
                                  generator=_gen())
    (out * w).sum().backward()
    b, n = 4 // data, 4 // model
    for i in range(data):
        for j in range(model):
            sl = (slice(i * b, (i + 1) * b), slice(j * n, (j + 1) * n))
            part = [t[sl].clone().requires_grad_(True) for t in (q, k, v)]
            got = attention.mha_reference(
                *part, causal=True, dropout_rate=0.2, generator=_gen(),
                dropout_blocks=attention.block_of(
                    0, AxisGroup(None, i, data)) + attention.block_of(
                    1, AxisGroup(None, j, model)))
            (got * w[sl]).sum().backward()
            np.testing.assert_allclose(got.detach(), out.detach()[sl],
                                       rtol=1e-12, atol=1e-12)
            for p, f in zip(part, full):
                np.testing.assert_allclose(p.grad, f.grad[sl], rtol=1e-12,
                                           atol=1e-12)


# ----- a train step at each split against (1,1) -----

TEXT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=192,
            layernorm_epsilon=1e-5, hidden_dropout=0.1,
            attention_dropout=0.1, remat=True)
# clip-b16's form (norm_pre, no patch bias, heads of 96 on einsum
# attention), 2 blocks, every block checkpointed
VISION = dict(img_size=32, patch_size=16, embed_dim=192, depth=2,
              num_heads=2, num_frames=2, mlp_ratio=2, clip_model=True,
              grad_ckpt=True, drop_rate=0.1, attn_drop_rate=0.1,
              drop_path=0.1)
# Adam's eps at 1e-3 (the Owl mesh tests'): its first update is
# g / (|g| + eps), which at the flagship's 1e-6 turns the fp32 noise of
# another summation order on a near-zero gradient element into a move of
# 1e-6 (seen once in 73,728 elements of a vision MLP at (1,2))
OPT = dict(lr=1e-4, epochs=1, niter_per_ep=10, warmup_steps=0,
           opt_eps=1e-3, weight_decay=0.05, clip_grad=3.0)
CASES = {"cls": 3, "itm": 2}  # the loss and its head's outputs
WORLDS = {2: ["2x1", "1x2"], 4: ["2x2"]}
SPLITS = [(tag, case) for tags in WORLDS.values() for tag in tags
          for case in CASES]
B = 8


def _meta(kind):
    return dict(text=TEXT, vision=VISION, queries=8, embed=8,
                num_classes=CASES[kind], loss=kind, opt=OPT,
                dropout_seed=5)


@pytest.fixture(scope="module")
def drops(tmp_path_factory):
    """{case: (1,1) metrics, leaves, recorder}, {(tag, case): rank 0's
    file, [each rank's record]}."""
    d = str(tmp_path_factory.mktemp("dropout_mesh"))
    paths = {}
    for kind in CASES:
        meta = _meta(kind)
        paths[kind] = worker.write_case(d, kind, meta,
                                        worker.port_params(meta, 1),
                                        worker.global_batch(meta, 2, B))
    worlds = [worker.start("step", world, d, [
        {"tag": f"{t}_{c}", "data": int(t[0]), "model": int(t[2]),
         "case": paths[c]} for t in tags for c in CASES])
        for world, tags in WORLDS.items()]
    ref = {kind: worker.one_step(paths[kind], Mesh()) for kind in CASES}
    for procs in worlds:
        worker.finish(procs)
    out = {}
    for tag, case in SPLITS:
        name = f"{tag}_{case}"
        ranks = [dict(np.load(os.path.join(d, f"{name}_rank{r}.npz")))
                 for r in range(int(tag[0]) * int(tag[2]))]
        out[tag, case] = (dict(np.load(os.path.join(d, f"{name}.npz"))),
                          ranks)
    return ref, out


@pytest.mark.parametrize("tag,case", SPLITS)
def test_split_step_with_dropout_equals_the_unsplit_step(drops, tag, case):
    ref, out = drops
    want_met, want_leaves, _ = ref[case]
    rec, ranks = out[tag, case]
    met = json.loads(str(rec["metrics"]))
    for k in ("loss", "loss_caption", "loss_cls", "grad_norm"):
        np.testing.assert_allclose(met[k], want_met[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert met["skipped_nonfinite"] == 0.0
    for r in ranks:
        assert json.loads(str(r["metrics"]))["loss"] == met["loss"]
    got = {k[2:]: v for k, v in rec.items() if k.startswith("p:")}
    assert set(got) == set(want_leaves)
    for path, want in want_leaves.items():
        np.testing.assert_allclose(got[path], want, rtol=LEAF_TOL,
                                   atol=LEAF_TOL, err_msg=path)


@pytest.mark.parametrize("tag,case", SPLITS)
def test_every_rank_keeps_the_unsplit_masks_block(drops, tag, case):
    """Every site's mask (the patch tokens', each attention's on the
    rank's heads, each drop-path's, the decoder's hidden and attention
    masks, the checkpointed replays), in order, is (1,1)'s block."""
    ref, out = drops
    want = ref[case][2]
    data, model = int(tag[0]), int(tag[2])
    _, ranks = out[tag, case]
    # the vision tower's 7 masks and the 2 decoder passes' 7 each, then
    # their replays (6 and 2 x 6)
    assert len(want.masks) == 39
    kinds = set()
    for r in ranks:
        i, j = (int(c) for c in r["coord"])
        blocks = json.loads(str(r["blocks"]))
        assert len(blocks) == len(want.masks)
        for n, (blk, full) in enumerate(zip(blocks, want.masks)):
            got = r[f"m{n}"]
            assert {(dim, count) for dim, _, count in blk} <= {
                (0, data), (1, model)}
            sl = torch.from_numpy(full)
            for dim, index, count in blk:
                assert index == (i if dim == 0 else j)
                size = full.shape[dim] // count
                sl = sl.narrow(dim, index * size, size)
                kinds.add(dim)
            assert np.array_equal(got, sl.numpy()), n
    assert kinds == ({0} if data > 1 else set()) | (
        {1} if model > 1 else set())


@pytest.mark.parametrize("tag", [t for tags in WORLDS.values()
                                 for t in tags])
def test_itm_decoder_passes_take_a_data_ranks_share_of_the_pairs(drops,
                                                                 tag):
    """3B = 24 pair rows: each decoder pass (the prefix LM and the match
    head's prompt) takes 3B / data on every rank, as (1,1) takes 3B."""
    ref, out = drops
    assert list(ref["itm"][2].decoder_rows) == [3 * B, 3 * B]
    for r in out[tag, "itm"][1]:
        assert list(r["decoder_rows"]) == [3 * B // int(tag[0])] * 2


# ----- the other training CLIs under a split with dropout -----

CLI_SPLITS = {"pretrain": "1x2", "caption": "2x1", "instruct": "2x1"}
# the Owl's second step within the Owl mesh tests' 1e-4: its first update
# (lr 1e-3) already differs by rounding (the abstractor's k_bias has a
# zero gradient but for fp32 rounding, which Adam turns into lr-sized
# moves whose sign is rounding's), so the second step's grad_norm reads
# 1.25e-5 off (1,1)'s at (2,1) without dropout and 7e-5 with it
CLI_RTOL = {"pretrain": LOSS_RTOL, "caption": LOSS_RTOL, "instruct": 1e-4}
DROPOUT = {"hidden_dropout": 0.1, "attention_dropout": 0.1}
VISION_DROPOUT = {"drop_rate": 0.1, "attn_drop_rate": 0.1,
                  "drop_path": 0.1}


def _pretrain_yaml(d, tag):
    """configs/pretrain/pretrain_tiny_no_dropout.yaml (the remat decoder,
    the checkpointed vision blocks, the contrastive branch) with every
    dropout of both towers on."""
    with open(os.path.join(worker.REPO, "configs", "pretrain",
                           "pretrain_tiny_no_dropout.yaml")) as f:
        raw = yaml.safe_load(f)
    data, model = map(int, tag.split("x"))
    raw["text_overrides"].update(DROPOUT)
    raw.setdefault("visual_overrides", {}).update(VISION_DROPOUT)
    raw["optimizer"].update(opt_eps=1e-6)
    raw.update(mesh={"data": data, "model": model}, synthetic_length=16,
               num_workers=0)
    path = os.path.join(d, f"pretrain_{tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _caption_yaml(d, tag):
    data, model = map(int, tag.split("x"))
    sub = Path(d) / f"cap_{tag}"
    sub.mkdir(exist_ok=True)
    return caption_tests.tiny_caption_yaml(
        sub, mesh={"data": data, "model": model}, text_overrides=DROPOUT,
        visual_overrides=VISION_DROPOUT)


def _argv(yaml_path, out):
    return ["--config", yaml_path, "--output_dir", out, "--fp32",
            "--synthetic_data", "--seed", "0", "--device", "cpu",
            "--max_steps", "2"]


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Each CLI's step metrics at (1,1) here and at its split in one
    2-rank world."""
    from youku_mplug_tpu_torch.cli import run_caption, run_pretrain

    d = str(tmp_path_factory.mktemp("dropout_mesh_clis"))
    yamls = {"pretrain": _pretrain_yaml, "caption": _caption_yaml}
    spec = [{"cli": f"run_{cli}", "argv": _argv(
        make(d, CLI_SPLITS[cli]), os.path.join(d, f"{cli}_split"))}
        for cli, make in yamls.items()]
    spec.append({"instruct": True, "tag": CLI_SPLITS["instruct"], "out": d})
    owl_worker.write_inputs(d)  # the Owl's tokenizer, before any rank
    world = worker.start("runner", 2, d, spec)
    out = {}
    for cli, make in yamls.items():
        mod = run_pretrain if cli == "pretrain" else run_caption
        parser = (mod.base_parser() if cli == "pretrain" else mod.parser())
        out[cli, "1x1"] = mod.main(parser.parse_args(_argv(
            make(d, "1x1"), os.path.join(d, f"{cli}_1x1")))).history
    out["instruct", "1x1"] = worker.instruct_split("1x1", d).history
    worker.finish(world)
    for cli in yamls:
        with open(os.path.join(d, f"{cli}_split", "history.json")) as f:
            out[cli, "split"] = json.load(f)
    with open(os.path.join(d, f"instruct_{CLI_SPLITS['instruct']}",
                           "history.json")) as f:
        out["instruct", "split"] = json.load(f)
    return out


@pytest.mark.parametrize("cli", list(CLI_SPLITS))
def test_training_cli_under_a_split_with_dropout_takes_the_unsplit_steps(
        clis, cli):
    want, got = clis[cli, "1x1"], clis[cli, "split"]
    assert len(got) == len(want) == 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in got],
                                   [h[k] for h in want], rtol=CLI_RTOL[cli],
                                   err_msg=k)
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"],
                               rtol=LOSS_RTOL)
    assert all(h["skipped_nonfinite"] == 0.0 for h in got)
