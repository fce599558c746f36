"""Training under a (data, model) split on CPU processes over gloo: the
collectives against their one-process twins, the training CLIs against
their unsplit runs, and the refusals that stand.

- Megatron's f / g around a column / row product pair, the vocab-parallel
  CE against its gathered plain version (loss and both gradients, label
  smoothing 0 and 0.1, dense and in chunks), the data axis' row gather
  under autograd.
- ``run_pretrain`` and ``run_caption`` (train, then the beam search) at
  (2,1) and (1,2) against (1,1): the same step losses and captions; a
  pretrain run saved at (1,2) resumes at (2,1) with the losses of an
  unbroken (1,1) run.
- The refusals that stand: the BERT family's training mesh (ROADMAP
  Queue 1 item 8), a zoo optimizer on model-split leaves (item 10).
  ``run_instruct --train`` under a split:
  ``tests/test_torch_owl_train_mesh.py``; ``run_cls``, ``run_retrieval``
  and ``run_retrieval_itm``: ``tests/test_torch_downstream_mesh.py``;
  dropout under a split: ``tests/test_torch_dropout_mesh.py``.

The train steps against JAX are ``tests/test_torch_train_mesh.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu_torch.ops import cross_entropy as ce

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_caption as caption_tests  # noqa: E402
import torch_train_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
spawn = worker.spawn


# ----- the collectives against their one-process twins -----

@pytest.fixture(scope="module")
def units(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_mesh_units"))
    spawn("units", 2, d, [{}])
    return [dict(np.load(os.path.join(d, f"units_rank{r}.npz")))
            for r in range(2)]


def _twin(world=2):
    """The worker's draws in the worker's order, computed unsplit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 4 * world, generator=g, dtype=torch.float64)
    w2 = torch.randn(4 * world, 8, generator=g, dtype=torch.float64)
    x.requires_grad_(True)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    y = torch.tanh(x @ w1) @ w2
    y.sin().sum().backward()
    out = {"fg_y": y.detach().numpy(), "fg_dx": x.grad.numpy(),
           "fg_dw1": w1.grad.numpy(), "fg_dw2": w2.grad.numpy()}
    v = 12 * world
    hid = torch.randn(2, 8, 16, generator=g, dtype=torch.float64)
    table = torch.randn(v, 16, generator=g, dtype=torch.float64)
    labels = torch.randint(0, v, (2, 8), generator=g)
    for ls in (0.0, 0.1):
        h = hid.clone().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        loss = ce.lm_cross_entropy(
            h, t, labels,
            ce=lambda lg, lab, tp, ls=ls: ce.cross_entropy_with_logits(
                lg, lab, ls))
        (loss * torch.linspace(0.5, 1.5, 8, dtype=loss.dtype)
         ).sum().backward()
        out[f"ce_{ls}"] = (loss.detach().numpy(), h.grad.numpy(),
                           t.grad.numpy())
    emb = torch.randn(v, 16, generator=g, dtype=torch.float64)
    ids = torch.randint(0, v, (3, 7), generator=g)
    emb.requires_grad_(True)
    out_rows = torch.nn.functional.embedding(ids, emb)
    (out_rows * torch.linspace(-1, 1, 16, dtype=torch.float64)
     ).square().sum().backward()
    out.update(emb_out=out_rows.detach().numpy(), emb_dt=emb.grad.numpy())
    a = torch.randn(world * 3, 4, generator=g, dtype=torch.float64)
    a.requires_grad_(True)
    loss = (a @ a.t()).logsumexp(-1).sum() / (3 * world)
    loss.backward()
    out.update(dp_full=a.detach().numpy(), dp_da=a.grad.numpy(),
               dp_loss=loss.detach().numpy())
    return out


@pytest.mark.parametrize("key", ["fg_y", "fg_dx", "fg_dw1", "fg_dw2"])
def test_f_and_g_values_and_gradients_equal_the_unsplit_product(units,
                                                                key):
    """g sums the row-parallel partial products (its gradient passes
    through), f sums the input's gradient over the model ranks: the
    output and dx whole on every rank, each rank's weight gradients its
    own slices of the unsplit ones."""
    twin = _twin()[key]
    for r, rec in enumerate(units):
        got = rec[key]
        if key == "fg_dw1":
            twin_r = twin[:, r * 4:(r + 1) * 4]
        elif key == "fg_dw2":
            twin_r = twin[r * 4:(r + 1) * 4]
        else:
            twin_r = twin
        np.testing.assert_allclose(got, twin_r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_vocab_parallel_ce_equals_its_plain_version_and_the_dense_ce(
        units, ls, chunk):
    """Loss, hidden and table gradients of the vocab-parallel CE equal
    the gathered plain version's and the unsplit dense CE's (the table
    gradient on each rank its own rows); fp32 logits on both sides."""
    want_loss, want_dh, want_dt = _twin()[f"ce_{ls}"]
    for r, rec in enumerate(units):
        for name in ("par", "plain"):
            key = f"ce_{name}_{ls}_{chunk}"
            np.testing.assert_allclose(rec[f"{key}_loss"], want_loss,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(rec[f"{key}_dh"], want_dh,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(rec[f"{key}_dt"],
                                       want_dt[r * 12:(r + 1) * 12],
                                       rtol=1e-5, atol=1e-5)


def test_vocab_parallel_lookup_and_its_gradient_equal_the_unsplit(units):
    """Every rank looks up every id (the sum of each rank's rows and
    zeros), and each rank's table slice takes the gradient of its own
    ids' rows alone."""
    twin = _twin()
    for r, rec in enumerate(units):
        np.testing.assert_allclose(rec["emb_out"], twin["emb_out"],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(rec["emb_dt"],
                                   twin["emb_dt"][r * 12:(r + 1) * 12],
                                   rtol=1e-12, atol=1e-12)


def test_data_row_gather_and_loss_shares_equal_the_global_batch(units):
    twin = _twin()
    for r, rec in enumerate(units):
        np.testing.assert_allclose(rec["dp_full"], twin["dp_full"])
        np.testing.assert_allclose(rec["dp_loss"], twin["dp_loss"],
                                   rtol=1e-12)
        np.testing.assert_allclose(rec["dp_da"],
                                   twin["dp_da"][r * 3:(r + 1) * 3],
                                   rtol=1e-12, atol=1e-12)


def test_the_collectives_are_identities_without_a_group():
    from youku_mplug_tpu_torch.parallel import data_parallel, tensor_parallel

    x = torch.randn(4, 3, requires_grad=True)
    assert tensor_parallel.copy_to_model(x, None) is x
    assert data_parallel.gather_rows(x, None) is x
    assert data_parallel.sum_over_data(x, None) is x
    logits = torch.randn(5, 7)
    labels = torch.randint(0, 7, (5,))
    assert torch.equal(ce.vocab_parallel_cross_entropy(logits, labels, None,
                                                       0.1),
                       ce.cross_entropy_with_logits(logits, labels, 0.1))


# ----- the training CLIs under a split -----

def _pretrain_yaml(d, tag):
    """configs/pretrain/pretrain_tiny_no_dropout.yaml (the remat decoder,
    the checkpointed vision blocks, the contrastive branch) with the LM
    loss in chunks of 8 of its 24 positions, two epochs, the flagship's
    Adam eps (1e-6: Adam's first updates g / (|g| + eps) then carry fp32
    noise far below the tolerances) and the split: every checkpointed
    block and CE chunk reruns its collectives in the backward."""
    with open(os.path.join(worker.REPO, "configs", "pretrain",
                           "pretrain_tiny_no_dropout.yaml")) as f:
        raw = yaml.safe_load(f)
    data, model = map(int, tag.split("x"))
    raw["text_overrides"].update(ce_chunk=8)
    raw["schedular"].update(epochs=2)
    raw["optimizer"].update(opt_eps=1e-6)
    raw.update(mesh={"data": data, "model": model}, synthetic_length=16,
               num_workers=0)
    path = os.path.join(d, f"pretrain_{tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _caption_yaml(d, tag):
    data, model = map(int, tag.split("x"))
    sub = os.path.join(d, f"cap_{tag}")
    os.makedirs(sub, exist_ok=True)
    from pathlib import Path

    return caption_tests.tiny_caption_yaml(
        Path(sub), mesh={"data": data, "model": model},
        async_checkpointing=True)


def _pretrain_argv(yaml_path, out, *extra):
    return ["--config", yaml_path, "--output_dir", out, "--fp32",
            "--synthetic_data", "--seed", "0", "--device", "cpu",
            "--save_ckpt_freq", "1", "--max_steps", "2", *extra]


def _caption_argv(yaml_path, out):
    return ["--config", yaml_path, "--output_dir", out, "--fp32",
            "--synthetic_data", "--max_steps", "2", "--seed", "0",
            "--device", "cpu"]


RUNNER_SPLITS = ["2x1", "1x2"]


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(1,1) here, (2,1) and (1,2) in one 2-rank world: run_pretrain (2
    epochs of 2 steps, saved each epoch) and run_caption (2 steps and the
    beam search over 8 clips); then the (1,2) pretrain run cut back to
    its step-2 checkpoint resumes at (2,1), and run_caption evaluates the
    (1,2) caption run's checkpoint at (2,1)."""
    from youku_mplug_tpu_torch.cli import run_caption, run_pretrain

    d = str(tmp_path_factory.mktemp("train_mesh_runners"))
    out = {}
    base = os.path.join(d, "pretrain_1x1")
    out["pretrain", "1x1"] = run_pretrain.main(run_pretrain.base_parser(
    ).parse_args(_pretrain_argv(_pretrain_yaml(d, "1x1"), base))).history
    cap = os.path.join(d, "caption_1x1")
    out["caption", "1x1"] = run_caption.main(run_caption.parser(
    ).parse_args(_caption_argv(_caption_yaml(d, "1x1"), cap))).history
    spec = []
    for tag in RUNNER_SPLITS:
        spec.append({"cli": "run_pretrain", "argv": _pretrain_argv(
            _pretrain_yaml(d, tag), os.path.join(d, f"pretrain_{tag}"))})
        spec.append({"cli": "run_caption", "argv": _caption_argv(
            _caption_yaml(d, tag), os.path.join(d, f"caption_{tag}"))})
    spec.append({"prune": os.path.join(d, "pretrain_1x2", "checkpoints"),
                 "keep": 2})
    spec.append({"cli": "run_pretrain", "argv": _pretrain_argv(
        _pretrain_yaml(d, "2x1"), os.path.join(d, "resumed_2x1"),
        "--resume", os.path.join(d, "pretrain_1x2"))})
    spec.append({"cli": "run_caption", "argv": _caption_argv(
        _caption_yaml(d, "2x1"), os.path.join(d, "caption_eval_2x1"))
        + ["--evaluate_only", "--resume", os.path.join(d, "caption_1x2")]})
    spawn("runner", 2, d, spec)
    for tag in RUNNER_SPLITS:
        for cli in ("pretrain", "caption"):
            with open(os.path.join(d, f"{cli}_{tag}", "history.json")) as f:
                out[cli, tag] = json.load(f)
    with open(os.path.join(d, "resumed_2x1", "history.json")) as f:
        out["resumed"] = json.load(f)
    out["dir"] = d
    return out


# the Adam moments of a split's checkpoint against (1,1)'s, per leaf:
# |got - want| over max(|want|, MOMENT_FLOOR x the whole moment's norm)
# (L2 norms; the floor holds a leaf whose gradient vanishes in exact
# arithmetic, AttentionPool's k_bias, to the tree's scale); fp32 sums in
# another order read 1.5e-5 (exp_avg) and 3e-5 (exp_avg_sq) here, a
# moment dropped or cut from the wrong rows reads about 1
MOMENT_TOL, MOMENT_FLOOR = 1e-3, 1e-3


def _moment_errors(got, want):
    """[(gated error, leaf)] worst first."""
    whole = torch.stack([w.double().norm() for w in want.values()]).norm()
    return sorted(((float((got[k].double() - w.double()).norm()
                          / max(w.double().norm(), MOMENT_FLOOR * whole)),
                    k) for k, w in want.items()), reverse=True)


def _losses(history, keys=("loss", "grad_norm")):
    return np.array([[h[k] for k in keys] for h in history])


@pytest.mark.parametrize("cli", ["pretrain", "caption"])
@pytest.mark.parametrize("tag", RUNNER_SPLITS)
def test_runner_split_takes_the_unsplit_steps(runners, cli, tag):
    want, got = runners[cli, "1x1"], runners[cli, tag]
    assert len(got) == len(want) == (4 if cli == "pretrain" else 2)
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    assert all(h["skipped_nonfinite"] == 0.0 for h in got)
    if cli == "pretrain":  # the contrastive loss rides along
        np.testing.assert_allclose(_losses(got, ("loss_contrastive",)),
                                   _losses(want, ("loss_contrastive",)),
                                   rtol=1e-4)


@pytest.mark.parametrize("tag", RUNNER_SPLITS + ["eval_2x1"])
def test_caption_split_beam_search_gives_the_unsplit_captions(runners, tag):
    """Each split's captions are (1,1)'s; so are those of the (1,2) run's
    checkpoint evaluated at (2,1) (``--evaluate_only --resume``)."""
    def results(t):  # merged in data order: compared clip by clip
        with open(os.path.join(runners["dir"], f"caption_{t}",
                               "caption_results.json")) as f:
            return sorted(json.load(f), key=lambda r: int(r["video_id"]))
    want, got = results("1x1"), results(tag)
    assert len(got) == len(want) == 8
    assert [r["video_id"] for r in got] == [r["video_id"] for r in want]
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=1e-4)


def test_split_checkpoint_is_the_unsharded_one_and_resumes_elsewhere(
        runners):
    """(1,2)'s checkpoint holds the unsharded leaves and moments: the
    step-2 checkpoints of the (1,1) and (1,2) runs agree leaf by leaf
    (Adam's exp_avg and exp_avg_sq too),
    and the run resumed from it at (2,1) takes (1,1)'s steps 3-4."""
    d = runners["dir"]
    a = torch.load(os.path.join(d, "pretrain_1x1", "checkpoints", "2",
                                "state.pt"), weights_only=True)
    b = torch.load(os.path.join(d, "pretrain_1x2", "checkpoints", "2",
                                "state.pt"), weights_only=True)
    for part in ("trainable", "frozen"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert a[part][k].shape == b[part][k].shape, k
            np.testing.assert_allclose(b[part][k].float().numpy(),
                                       a[part][k].float().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    assert set(a["optim"]) == set(b["optim"])
    for moment in ("exp_avg", "exp_avg_sq"):
        want = {k: leaf[moment] for k, leaf in a["optim"].items()}
        got = {k: leaf[moment] for k, leaf in b["optim"].items()}
        for k in want:
            assert got[k].shape == want[k].shape, (moment, k)
        worst = _moment_errors(got, want)[0]
        assert worst[0] <= MOMENT_TOL, (moment, worst)
    assert (a["count"], a["step"]) == (b["count"], b["step"]) == (2, 2)
    # run_caption saves in the background (async_checkpointing): rank 0
    # writes the gathered tree after the step, every rank waits for it
    for tag in RUNNER_SPLITS:
        cap = torch.load(os.path.join(d, f"caption_{tag}", "checkpoints",
                                      "2", "state.pt"), weights_only=True)
        ref = torch.load(os.path.join(d, "caption_1x1", "checkpoints", "2",
                                      "state.pt"), weights_only=True)
        assert {k: v.shape for k, v in cap["frozen"].items()} == \
            {k: v.shape for k, v in ref["frozen"].items()}
        for k, v in ref["trainable"].items():
            np.testing.assert_allclose(cap["trainable"][k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    resumed = runners["resumed"]
    assert len(resumed) == 2
    np.testing.assert_allclose(_losses(resumed),
                               _losses(runners["pretrain", "1x1"][2:]),
                               rtol=1e-4)


# ----- the refusals that stand -----

REFUSING = [
    ("run_mplug_downstream", "prepare", "configs/mplug/mplug_vitb16_zh.yaml",
     8),
    ("run_mplug_pretrain", "setup", "configs/mplug/mplug_vitb16_zh.yaml", 8),
    ("run_alpro", "prepare", "configs/alpro/alpro_vitb16_zh.yaml", 8),
]


@pytest.mark.parametrize("cli,fn,config,item", REFUSING,
                         ids=[c[0] for c in REFUSING])
def test_other_runners_refuse_a_training_mesh(tmp_path, monkeypatch, cli,
                                              fn, config, item):
    """Launched as one of two ranks, every BERT-family training CLI
    raises before it builds a model, naming its ROADMAP item."""
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{cli}")
    argv = ["--config", config, "--synthetic_data", "--device", "cpu",
            "--output_dir", str(tmp_path / "out")]
    args = mod.parser().parse_args(argv)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue 1 item {item}\)"):
        getattr(mod, fn)(args)


def test_zoo_optimizer_on_model_split_leaves_raises_item_10():
    from youku_mplug_tpu_torch.config import flagship_config
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
    from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
    from youku_mplug_tpu_torch.train.state import create_train_state

    def model(split):
        m = MPLUGVideo(flagship_config(tiny=True), FP32_POLICY)
        m.tp_split = split
        return m
    split = {"visual_encoder.blocks.0.mlp.fc1_kernel": 1}
    state, _, _ = create_train_state(model(split), OptimizerConfig())
    assert state.split == {"visual_encoder/blocks_0/mlp/fc1_kernel": 1}
    create_train_state(model({}), OptimizerConfig(opt="lamb"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        create_train_state(model(split), OptimizerConfig(opt="lamb"))


def test_the_full_table_of_a_vocab_shard_is_refused():
    from youku_mplug_tpu_torch.models.gpt3 import TiedEmbedding
    from youku_mplug_tpu_torch.parallel.tensor_parallel import ModelGroup

    emb = TiedEmbedding(8, 4, torch.float32)
    torch.nn.init.normal_(emb.embedding)
    assert emb.table(torch.float32).shape == (8, 4)
    emb.tp = ModelGroup(None, 0, 2)
    with pytest.raises(ValueError, match="loss()"):
        emb.table(torch.float32)


class _Rows:
    """37 samples, each its index."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return {"idx": i, "x": np.full(3, i, np.float32)}


@pytest.mark.parametrize("data", [2, 4])
def test_train_loader_blocks_are_the_global_batch_in_data_order(data):
    """The train loader's block of data rank i at step k is rows
    [i B / D, (i + 1) B / D) of the unsplit loader's batch k
    (``data_shard``'s contract, JAX's put_batch): the blocks together are
    the global batch, in order."""
    from youku_mplug_tpu_torch.data.loader import Loader
    from youku_mplug_tpu_torch.parallel.sharding import data_shard
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    DS = _Rows
    whole = list(Loader(DS(), 8, seed=5))
    blocks = [list(Loader(DS(), 8, seed=5, block_index=i, block_count=data))
              for i in range(data)]
    assert all(len(b) == len(whole) == 4 for b in blocks)
    for k, batch in enumerate(whole):
        for i in range(data):
            want = data_shard(batch, Mesh(data, 1, rank=i))
            np.testing.assert_array_equal(blocks[i][k]["idx"], want["idx"])
            np.testing.assert_array_equal(blocks[i][k]["x"], want["x"])
    with pytest.raises(ValueError, match="block 0 of 3"):
        Loader(DS(), 8, block_index=0, block_count=3)


@pytest.mark.parametrize("data", [2, 4])
def test_train_loader_blocks_follow_the_micro_batches(data):
    """Under ``update_freq`` U = 2 (JAX's step splits the global batch
    into micro-batches of rows [u B / U, (u + 1) B / U)) data rank i's
    rows at step k are its block of each micro-batch in order
    (``data_shard(micro=2)``), so its u-th micro-batch is its block of
    the unsplit step's u-th; ``make_loader`` passes the YAML's
    ``update_freq`` under a data split only."""
    from types import SimpleNamespace

    from youku_mplug_tpu_torch.cli import common
    from youku_mplug_tpu_torch.data.loader import Loader
    from youku_mplug_tpu_torch.parallel.sharding import data_shard
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    whole = list(Loader(_Rows(), 8, seed=5))
    for i in range(data):
        mesh = Mesh(data, 1, rank=i)
        got = list(Loader(_Rows(), 8, seed=5, block_index=i,
                          block_count=data, micro_count=2))
        assert len(got) == len(whole) == 4
        for k, batch in enumerate(whole):
            rows = got[k]["idx"]
            np.testing.assert_array_equal(
                rows, data_shard(batch, mesh, micro=2)["idx"])
            half = len(rows) // 2
            for u in range(2):
                micro = {"idx": batch["idx"][u * 4:(u + 1) * 4]}
                np.testing.assert_array_equal(
                    rows[u * half:(u + 1) * half],
                    data_shard(micro, mesh)["idx"])
    with pytest.raises(ValueError, match="of 3 micro-batches"):
        Loader(_Rows(), 8, block_index=0, block_count=data, micro_count=3)
    args = SimpleNamespace(seed=5, synthetic_data=True)
    cfg = SimpleNamespace(batch_size=8, num_workers=0, update_freq=2,
                          get=lambda k, d=None: d)
    assert common.make_loader(args, cfg, _Rows(),
                              block=Mesh(data, 1, rank=0)).micro_count == 2
    assert common.make_loader(args, cfg, _Rows(),
                              block=Mesh(1, 2, rank=0)).micro_count == 1


def test_put_batch_takes_a_data_ranks_block_and_refuses_other_sizes():
    from types import SimpleNamespace

    from youku_mplug_tpu_torch.cli import common
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    runner = SimpleNamespace(mesh=Mesh(2, 1, rank=1), device=torch.device(
        "cpu"), cfg=SimpleNamespace(batch_size=8))
    ids = np.arange(16).reshape(8, 2)
    got = common.put_batch(runner, {"input_ids": ids[4:]})
    assert got["input_ids"].dtype == torch.int64
    np.testing.assert_array_equal(got["input_ids"].numpy(), ids[4:])
    for rows in (ids, ids[:3]):  # the global batch, or a stray size
        with pytest.raises(ValueError, match=f"a batch of {len(rows)} rows"):
            common.put_batch(runner, {"input_ids": rows})
    runner.mesh = None  # one process: the batch as it is
    assert common.put_batch(runner, {"input_ids": ids})["input_ids"
                                                        ].shape == (8, 2)
