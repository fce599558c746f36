"""The port imports without jax (the checkpoint importers, the serving
export, the optimizer zoo and the schedulers, the mesh, its PRNG folding
and the sharding rules included, which also read safetensors files with the safetensors
package blocked; the image-era modules with ``regex``, ``ftfy`` and
``oss2`` absent too), and its kernel wrappers take their plain versions
only for CPU tensors (never a silent fallback)."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from youku_mplug_tpu_torch.ops import decode_attention as dec
from youku_mplug_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

_NO_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None       # any import of jax now raises
    sys.modules["flax"] = None
    sys.modules["regex"] = None     # nor the CLIP tokenizer's regex / ftfy
    sys.modules["ftfy"] = None
    import youku_mplug_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("cli.serve", "cli.run_pretrain", "cli.profile_train",
                 "cli.run_instruct", "models.bloom", "models.owl",
                 "data.instruct", "optim.factory", "ops.lora", "config",
                 "train.state", "train.trainer", "ops.cross_entropy",
                 "data.loader", "ops.kv_cache", "ops.quant",
                 "serving.engine", "serving.speculative", "cli.common",
                 "cli.run_caption", "train.checkpoint", "train.metrics",
                 "evals.metrics", "evals.meteor", "models.importers",
                 "models.generation", "cli.export_serving",
                 "data.samplers", "data.video_decode", "data.transforms",
                 "data.datasets", "models.tokenizer", "cli.run_cls",
                 "cli.run_retrieval", "cli.run_retrieval_itm",
                 "models.hf_tokenizer", "optim.zoo", "optim.schedulers",
                 "models.bert", "models.mplug", "models.alpro",
                 "cli.run_mplug_pretrain", "cli.run_mplug_downstream",
                 "cli.run_alpro", "models.gpt2_multimodal", "models.clip",
                 "models.clip_video", "models.clip_tokenizer",
                 "data.image_datasets", "data.pretrain_transforms",
                 "data.vg_transforms", "data.refer", "data.remote_io",
                 "evals.grounding", "evals.vqa", "runtime.mesh",
                 "runtime.prng", "parallel.sharding",
                 "parallel.tensor_parallel", "parallel.collectives",
                 "parallel.ring_attention", "parallel.pipeline",
                 "parallel.moe"):
        assert "youku_mplug_tpu_torch." + name in names, name
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "youku_mplug_tpu", "regex",
                                           "ftfy", "oss2")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print(len(names))
""")


def test_package_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 27


_NO_JAX_IMPORT = textwrap.dedent("""
    import json, struct, sys, tempfile, os
    for blocked in ("jax", "flax", "safetensors", "youku_mplug_tpu"):
        sys.modules[blocked] = None  # any import of these now raises
    import torch
    from youku_mplug_tpu_torch.cli import export_serving
    from youku_mplug_tpu_torch.models import importers
    data = torch.arange(6, dtype=torch.float32).bfloat16()
    raw = data.view(torch.int16).numpy().tobytes()
    header = json.dumps({"__metadata__": {"format": "pt"}, "w": {
        "dtype": "BF16", "shape": [2, 3],
        "data_offsets": [0, len(raw)]}}).encode()
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + raw)
    got = importers.load_hf_torch_state(d)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(
        got, data.reshape(2, 3)), got
    assert export_serving.parser().parse_args(
        ["--run_dir", d, "--config", "c", "--dest", d]).device == "cuda"
    print("ok")
""")


def test_importers_and_export_run_without_jax_or_safetensors():
    out = subprocess.run([sys.executable, "-c", _NO_JAX_IMPORT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_NO_JAX_FILES = textwrap.dedent("""
    import json, os, sys, tempfile
    for blocked in ("jax", "flax", "youku_mplug_tpu"):
        sys.modules[blocked] = None  # any import of these now raises
    import cv2
    import numpy as np
    from youku_mplug_tpu_torch.data import datasets, instruct, loader
    from youku_mplug_tpu_torch.data import transforms, video_decode
    d = tempfile.mkdtemp()
    w = cv2.VideoWriter(os.path.join(d, "a.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    for i in range(10):
        w.write(np.full((24, 32, 3), 20 * i, np.uint8))
    w.release()
    with open(os.path.join(d, "ann.csv"), "w") as f:
        f.write("video_id:FILE,video_title,category_id\\na.mp4,t,2\\n"
                "a.mp4,u,1\\n")
    ds = datasets.ClsVideoDataset(os.path.join(d, "ann.csv"), d,
                                  transforms.train_transform(16),
                                  num_frames=3)
    (batch,) = list(loader.Loader(ds, 2, num_workers=2))
    assert batch["video"].shape == (2, 3, 16, 16, 3), batch["video"].shape
    assert sorted(batch["label"].tolist()) == [1, 2]
    with open(os.path.join(d, "q.jsonl"), "w") as f:
        f.write(json.dumps({"video": "a.mp4", "question": "q",
                            "answer": "a"}) + "\\n")
    item = instruct.InstructJsonlDataset(os.path.join(d, "q.jsonl"), d,
                                         num_frames=2)[0]
    assert item["video"].shape == (2, 24, 32, 3)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "youku_mplug_tpu")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ok")
""")


def test_file_backed_data_runs_without_jax_or_the_jax_package():
    """The datasets, cv2 decoding, transforms and the threaded loader
    read files with jax and youku_mplug_tpu blocked."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX_FILES],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_NO_JAX_TOKENIZER = textwrap.dedent("""
    import sys, tempfile
    for blocked in ("jax", "flax", "transformers", "youku_mplug_tpu"):
        sys.modules[blocked] = None  # any import of these now raises
    from tests.hf_tokenizer_files import write_tokenizer_dir
    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.models.hf_tokenizer import HFTokenizer
    d = write_tokenizer_dir(tempfile.mkdtemp(), 400, added=["<|x|>"],
                            extra_specials=["<mask>"])
    tok = HFTokenizer(d)
    ids = tok.encode("Human: What is in the video? <|x|> 一只猫")
    assert tok.decode(ids) == "Human: What is in the video? <|x|> 一只猫"
    assert tok.decode(ids + [tok.eos_id, 10 ** 6]) == tok.decode(ids)
    args = run_instruct.parser().parse_args(["--config", "c",
                                             "--tokenizer", d])
    assert isinstance(run_instruct.build_tokenizer(args, None), HFTokenizer)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "transformers",
                                           "youku_mplug_tpu")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ok")
""")


def test_hf_tokenizer_runs_without_jax_or_transformers():
    """The HF tokenizer files load, encode and decode through
    ``tokenizers`` alone, with jax, transformers and the JAX package
    blocked (transformers is not on the card's machine)."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX_TOKENIZER],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrappers_use_plain_versions_on_cpu_without_launching():
    rng = np.random.default_rng(0)
    counters = (fa.flash_attention_packed, fa.flash_attention,
                dec.write_decode_attention, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    before = [f.launches for f in counters]
    x = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    out = fa.flash_attention_packed(x, x, x, 2, period=4)
    assert out.shape == x.shape and out.device.type == "cpu"
    q4 = x.unflatten(-1, (2, 64)).transpose(1, 2)
    assert fa.flash_attention(q4, q4, q4, kv_len=9).shape == q4.shape
    ckv = torch.from_numpy(rng.normal(size=(1, 2, 8, 256)).astype(
        np.float32))
    q = x[:, 0]
    assert dec.write_decode_attention(q, q, q, ckv, 2, 0,
                                      torch.tensor([3, 7])).shape == (2, 128)
    assert torch.equal(ckv[0, 1, 7], torch.cat([q[1], q[1]]))  # written
    alibi_before = dec.write_decode_attention.alibi_launches
    assert dec.write_decode_attention(
        q, q, q, ckv, 2, 0, torch.tensor([3, 7]),
        alibi_slopes=dec.alibi_slopes(2)).shape == (2, 128)
    leaf = q4.clone().requires_grad_()
    fa.flash_attention(leaf, leaf, leaf, causal=True).sum().backward()
    assert leaf.grad.shape == q4.shape
    assert [f.launches for f in counters] == before == [0] * 5
    assert dec.write_decode_attention.alibi_launches == alibi_before == 0


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(2, 16, 128, device="meta")
    with pytest.raises(RuntimeError, match="no attention kernel"):
        fa.flash_attention_packed(x, x, x, 2)
    with pytest.raises(RuntimeError, match="no decode attention kernel"):
        q = x[:, 0]
        dec.write_decode_attention(q, q, q, torch.empty(
            1, 2, 8, 256, device="meta"), 2, 0, 3)


def test_int8_wrappers_use_plain_versions_on_cpu_and_refuse_others():
    """K5 int8 with the cache write (K6) folded in: plain on CPU tensors,
    no launch counted; a device without a kernel raises."""
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    rng = np.random.default_rng(1)
    names = ("int8_launches", "int8_alibi_launches", "launches",
             "alibi_launches")
    before = [getattr(dec.write_decode_attention, c) for c in names]
    cache = kvc.make_cache(1, 2, 8, 128, torch.float32, num_heads=2,
                           quantized=True)
    rows = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    q = rows[:, :128]
    for slopes in (None, dec.alibi_slopes(2)):
        out = dec.write_decode_attention(
            q, rows[:, :128], rows[:, 128:], cache, 2, 0,
            torch.tensor([3, 7]), alibi_slopes=slopes)
        assert out.shape == (2, 128) and out.device.type == "cpu"
    assert cache["kv"][0, :, [3, 7]].any()
    assert int(cache["scale"].count_nonzero()) == 2 * 4  # 2 rows x 2n
    assert [getattr(dec.write_decode_attention, c)
            for c in names] == before == [0] * 4
    meta = {k: v.to("meta") for k, v in cache.items()}
    with pytest.raises(RuntimeError, match="no decode attention kernel"):
        q = q.to("meta")
        dec.write_decode_attention(q, q, q, meta, 2, 0, 3)


def test_serve_cli_refuses_cuda_without_a_card():
    from youku_mplug_tpu_torch.cli import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = serve.serve_parser().parse_args([
        "--config", "configs/pretrain_tiny.yaml", "--synthetic_data",
        "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build(args)


def test_instruct_cli_refuses_cuda_without_a_card():
    from youku_mplug_tpu_torch.cli import run_instruct

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = run_instruct.parser().parse_args([
        "--config", "configs/instruct/serve_owl_tiny.yaml",
        "--synthetic_data", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_instruct.build(args)


_CLIS = {  # module -> (parser, build, a tiny config)
    "serve": ("serve_parser", "build", "configs/pretrain_tiny.yaml"),
    "run_pretrain": ("base_parser", "setup",
                     "configs/pretrain/pretrain_tiny_no_dropout.yaml"),
    "run_instruct": ("parser", "build",
                     "configs/instruct/serve_owl_tiny.yaml"),
    "run_caption": ("parser", "prepare",
                    "configs/pretrain/pretrain_tiny_no_dropout.yaml"),
}


@pytest.mark.parametrize("cli", sorted(_CLIS))
def test_cli_default_device_is_cuda_and_a_missing_card_raises(cli):
    """The port's entry points run on the card unless the caller asks for
    the CPU; without a card, building raises (no fallback)."""
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{cli}")
    parser, build, config = _CLIS[cli]
    argv = ["--config", config, "--synthetic_data"]
    args = getattr(mod, parser)().parse_args(argv)
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(mod, build)(args)
    if cli == "run_instruct":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.train_setup(mod.parser().parse_args(argv + ["--train"]))
