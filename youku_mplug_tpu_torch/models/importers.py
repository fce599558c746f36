"""Checkpoint importers: external PyTorch checkpoints into the port's
modules.

Counterpart of ``youku_mplug_tpu/models/importers.py``.  Each mapper
turns a state dict of one external naming into a tree of the JAX
package's names and shapes (nested dicts of tensors; the port keeps
those names, ``bridge.port_name``), and the merges write that tree into
a module's parameters:

- ModelScope / Megatron GPT-3: ``load_torch_gpt3_state`` reads
  ``model/mp_rank_XX_model_states.pt`` shards, concatenated along each
  name's partition dim (``_PARTITION_DIMS``), or one
  ``pytorch_model.bin``; ``gpt3_params_from_torch`` maps them onto the
  scanned ``[L]`` decoder.  Megatron's fused QKV rows are head-major
  ``[(n, 3, d), H]``, the non-distributed twin's ``[(3, n, d), H]``
  (``megatron_qkv``).
- timm / CLIP / TimeSformer vision: ``vision_params_from_torch`` splits
  the fused ``qkv.bias`` into q / v biases (k's is zero), interpolates
  the position and temporal embeddings to the configured grid and
  frames, and leaves out what the checkpoint lacks (an image ViT has no
  temporal parts: those keep their init).
- HF checkpoints: ``load_hf_torch_state`` reads one ``pytorch_model.bin``,
  ``pytorch_model-XXXXX-of-YYYYY.bin`` shards that split by key, or
  ``*.safetensors`` files through the port's own reader
  (``read_safetensors``); ``bloom_params_from_torch`` maps HF Bloom, and
  ``owl_vision_params_from_torch`` / ``owl_abstractor_params_from_torch``
  the mPLUG-Owl vision tower and abstractor, both fail-loud on any
  tensor they cannot place.
- ``merge_into`` (partial: names the model lacks are skipped),
  ``merge_exact`` (every imported name must exist) and ``check_covered``
  (every model leaf must be imported) work on ``param_tree(module)``, the
  module's parameters under their JAX names; both merges shape-check and
  copy each leaf once into its parameter, cast to the parameter's dtype
  on its device.  ``import_all`` (the ``import_torch_weights`` config
  key) and ``import_owl`` (``run_instruct --hf_checkpoint``) import into
  a model in place.

Tensors stay in the file's dtype until that copy, so the one rounding is
the one into the parameter's dtype (fp16 and bf16 widen to fp32
exactly), and a 7B checkpoint is never widened to fp32 on the host.
Only the embedding resizes compute, in fp32 / fp64 numpy as the JAX
functions do.  ``torch.load`` reads Megatron and vision files with
``weights_only=False`` (they pickle non-tensor objects) and HF shards
with ``weights_only=True``, as the JAX loaders do.

The embedding resizes (``resize_pos_embed``, ``resize_temporal_embed``)
also serve resuming at another image size or frame count
(``cli/common.restore_with_resize``).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Iterable

import numpy as np
import torch
from torch import nn

from youku_mplug_tpu_torch.bridge import jax_path, unflatten


def _interp_linear_axis(x: np.ndarray, new_len: int,
                        axis: int) -> np.ndarray:
    """1-D linear interpolation along ``axis`` with half-pixel
    sampling."""
    old = x.shape[axis]
    if old == new_len:
        return x
    src = (np.arange(new_len) + 0.5) * old / new_len - 0.5
    lo = np.clip(np.floor(src).astype(int), 0, old - 1)
    hi = np.clip(lo + 1, 0, old - 1)
    w = np.clip(src - lo, 0.0, 1.0)
    shape = [1] * x.ndim
    shape[axis] = new_len
    w = w.reshape(shape)
    return (np.take(x, lo, axis=axis) * (1 - w)
            + np.take(x, hi, axis=axis) * w)


def resize_pos_embed(posemb: np.ndarray, num_patches_new: int) -> np.ndarray:
    """[1, 1 + N_old, D] -> [1, 1 + N_new, D]: the cls row kept, the
    patch grid resized bilinearly (two separable half-pixel passes)."""
    tok, grid = posemb[:, :1], posemb[0, 1:]
    gs_old = int(np.sqrt(len(grid)))
    gs_new = int(np.sqrt(num_patches_new))
    if gs_old == gs_new:
        return posemb
    grid = grid.reshape(gs_old, gs_old, -1).astype(np.float32)
    grid = _interp_linear_axis(grid, gs_new, axis=0)
    grid = _interp_linear_axis(grid, gs_new, axis=1)
    return np.concatenate(
        [tok, grid.reshape(1, gs_new * gs_new, -1)], axis=1)


def resize_temporal_embed(temb: np.ndarray, t_new: int) -> np.ndarray:
    """[1, T_old, D] -> [1, T_new, D], linear over the frames."""
    return _interp_linear_axis(temb, t_new, axis=1)


def _tensor(v) -> torch.Tensor:
    """A state-dict value as a CPU tensor in its own dtype."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


def _pos_embed(v, num_patches: int) -> torch.Tensor:
    """``resize_pos_embed`` on a tensor: unchanged at the same grid, else
    resized in numpy from fp32, as the JAX loader does."""
    v = _tensor(v)
    if int(np.sqrt(v.shape[1] - 1)) == int(np.sqrt(num_patches)):
        return v
    return torch.from_numpy(resize_pos_embed(v.float().numpy(), num_patches))


def _temporal_embed(v, t_new: int) -> torch.Tensor:
    """``resize_temporal_embed`` on a [1, T, D] tensor (see _pos_embed)."""
    v = _tensor(v)
    if v.shape[1] == t_new:
        return v
    return torch.from_numpy(resize_temporal_embed(v.float().numpy(), t_new))


def _stack(layers: list) -> dict:
    """Per-layer trees -> one tree of [L, ...] tensors."""
    return {k: _stack([layer[k] for layer in layers])
            if isinstance(v, dict) else torch.stack([layer[k]
                                                     for layer in layers])
            for k, v in layers[0].items()}


def _pad_vocab(emb: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The word embedding zero-padded up to, then cut to, vocab_size."""
    if emb.shape[0] < vocab_size:
        emb = torch.cat([emb, emb.new_zeros(vocab_size - emb.shape[0],
                                            emb.shape[1])])
    return emb[:vocab_size]


# ----------------------------------------------------------------- GPT-3

# Megatron partition dim per parameter-name suffix (stride 1 in every
# GPT-3 config): column-parallel weights split dim 0, row-parallel dim 1,
# the vocab dim 0; the rest is replicated
_PARTITION_DIMS = (
    (r"query_key_value\.weight$", 0),
    (r"query_key_value\.bias$", 0),
    (r"attention\.dense\.weight$", 1),
    (r"dense_h_to_4h\.weight$", 0),
    (r"dense_h_to_4h\.bias$", 0),
    (r"dense_4h_to_h\.weight$", 1),
    (r"word_embeddings\.weight$", 0),
)


def _partition_dim(name: str):
    for pat, dim in _PARTITION_DIMS:
        if re.search(pat, name):
            return dim
    return None


def load_torch_gpt3_state(model_dir: str) -> Dict[str, torch.Tensor]:
    """Megatron ``model/mp_rank_XX_model_states.pt`` shards (concatenated
    along each name's partition dim, replicated names from the first
    shard), else one ``pytorch_model.bin``, as one state dict of CPU
    tensors in the file's dtype.  The ``module`` / ``model`` /
    ``state_dict`` nesting is unwrapped and ``model.language_model``
    renamed ``language_model``."""
    model_sub = os.path.join(model_dir, "model")
    shard_files = []
    if os.path.isdir(model_sub):
        shard_files = sorted(
            os.path.join(model_sub, f) for f in os.listdir(model_sub)
            if re.match(r"mp_rank_\d+_model_states\.pt", f))
    if not shard_files:
        single = os.path.join(model_dir, "pytorch_model.bin")
        if os.path.exists(single):
            shard_files = [single]
    if not shard_files:
        raise FileNotFoundError(f"no GPT-3 checkpoint under {model_dir}")

    shards = []
    for f in shard_files:
        sd = torch.load(f, map_location="cpu", weights_only=False)
        for key in ("module", "model", "state_dict"):
            if key in sd:
                sd = sd[key]
        shards.append({k.replace("model.language_model", "language_model"):
                       v for k, v in sd.items()})

    merged = {}
    for name, first in list(shards[0].items()):
        if not isinstance(first, torch.Tensor):
            continue
        parts = [s.pop(name) for s in shards]  # each shard drops it
        dim = _partition_dim(name)
        merged[name] = parts[0] if len(parts) == 1 or dim is None \
            else torch.cat(parts, dim=dim)
    return merged


def gpt3_params_from_torch(sd: Dict[str, Any], text_cfg,
                           megatron_qkv: bool = True) -> dict:
    """A Megatron (or twin) GPT-3 state dict -> the decoder's tree
    ``{"word_embeddings", "decoder"}`` with the layers stacked [L].
    ``megatron_qkv``: fused QKV rows head-major (n, 3, d), the
    distributed checkpoints'; False: the twin's (3, n, d).  Position and
    word embeddings are read under either key variant; the word
    embedding is zero-padded up to, then cut to, ``vocab_size``."""
    h = text_cfg.hidden_size
    n = text_cfg.num_attention_heads
    d = text_cfg.head_dim
    lm = "language_model."
    t = lm + "transformer.layers.{}."

    def get(key):
        return _tensor(sd[key])

    def qkv_kernel(w):  # [3H, H] -> [H, 3, n, d]
        if megatron_qkv:
            return w.t().reshape(h, n, 3, d).permute(0, 2, 1, 3)
        return w.t().reshape(h, 3, n, d)

    def qkv_bias(b):  # [3H] -> [3, n, d]
        if megatron_qkv:
            return b.reshape(n, 3, d).permute(1, 0, 2)
        return b.reshape(3, n, d)

    def layer(i):
        p = t.format(i)
        return {
            "ln1_scale": get(p + "input_layernorm.weight"),
            "ln1_bias": get(p + "input_layernorm.bias"),
            "ln2_scale": get(p + "post_attention_layernorm.weight"),
            "ln2_bias": get(p + "post_attention_layernorm.bias"),
            "attn": {
                "qkv_kernel": qkv_kernel(
                    get(p + "attention.query_key_value.weight")),
                "qkv_bias": qkv_bias(
                    get(p + "attention.query_key_value.bias")),
                "out_kernel": get(p + "attention.dense.weight"
                                  ).t().reshape(n, d, h),
                "out_bias": get(p + "attention.dense.bias"),
            },
            "mlp": {
                "fc1_kernel": get(p + "mlp.dense_h_to_4h.weight").t(),
                "fc1_bias": get(p + "mlp.dense_h_to_4h.bias"),
                "fc2_kernel": get(p + "mlp.dense_4h_to_h.weight").t(),
                "fc2_bias": get(p + "mlp.dense_4h_to_h.bias"),
            },
        }

    pos_key = lm + "embedding.position_embeddings.weight"
    word_key = lm + "embedding.word_embeddings.weight"
    decoder = {
        "position_embeddings": get(pos_key if pos_key in sd
                                   else lm + "position_embeddings.weight"),
        "ln_f_scale": get(lm + "transformer.final_layernorm.weight"),
        "ln_f_bias": get(lm + "transformer.final_layernorm.bias"),
        "layers": _stack([layer(i)
                          for i in range(text_cfg.num_hidden_layers)]),
    }
    emb = get(word_key if word_key in sd else lm + "word_embeddings.weight")
    return {"word_embeddings": {"embedding": _pad_vocab(
        emb, text_cfg.vocab_size)}, "decoder": decoder}


# ------------------------------------------------------------------- HF

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file as a CPU tensor in its
    dtype: an 8-byte little-endian header length, a JSON header of
    ``dtype`` / ``shape`` / ``data_offsets`` per name (``__metadata__``
    skipped), then the little-endian data, offsets counted from the end
    of the header."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, info in header.items():
            if info["dtype"] not in _SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: {name} has dtype "
                                 f"{info['dtype']}, which is not read")
            dtype = _SAFETENSORS_DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            if end == start:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            f.seek(base + start)
            buf = bytearray(f.read(end - start))
            if len(buf) != end - start:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(
                info["shape"])
    return out


def load_hf_torch_state(model_dir: str,
                        prefix_strip: str = "") -> Dict[str, torch.Tensor]:
    """An HF checkpoint directory as one state dict of CPU tensors in the
    file's dtype: ``pytorch_model.bin`` or ``pytorch_model-XXXXX-of-
    YYYYY.bin`` shards (a union of keys: HF shards split by key), and only
    where there are none, ``*.safetensors`` files.  ``prefix_strip`` is
    taken off the names that start with it."""
    files = sorted(os.listdir(model_dir))
    shard_files = [f for f in files
                   if re.match(r"pytorch_model(-\d+-of-\d+)?\.bin$", f)]
    st_files = [f for f in files if f.endswith(".safetensors")]
    merged: Dict[str, torch.Tensor] = {}
    if shard_files:
        for f in shard_files:
            sd = torch.load(os.path.join(model_dir, f), map_location="cpu",
                            weights_only=True)
            merged.update((k, v) for k, v in sd.items()
                          if isinstance(v, torch.Tensor))
    elif st_files:
        for f in st_files:
            merged.update(read_safetensors(os.path.join(model_dir, f)))
    else:
        raise FileNotFoundError(f"no HF checkpoint under {model_dir}")
    if prefix_strip:
        merged = {(k[len(prefix_strip):] if k.startswith(prefix_strip)
                   else k): v for k, v in merged.items()}
    return merged


def bloom_params_from_torch(sd: Dict[str, Any], cfg) -> dict:
    """An HF Bloom state dict (with or without the ``transformer.``
    prefix) -> the decoder's tree with the layers stacked [L].  HF's fused
    QKV rows are head-major [n, 3, d], which is the port's ``qkv_kernel
    [H, n, 3, d]`` after a transpose."""
    h = cfg.hidden_size
    n = cfg.num_attention_heads
    d = cfg.head_dim
    if "transformer.word_embeddings.weight" in sd:
        sd = {k[len("transformer."):] if k.startswith("transformer.")
              else k: v for k, v in sd.items()}

    def get(key):
        return _tensor(sd[key])

    def layer(i):
        t = f"h.{i}."
        return {
            "ln1_scale": get(t + "input_layernorm.weight"),
            "ln1_bias": get(t + "input_layernorm.bias"),
            "ln2_scale": get(t + "post_attention_layernorm.weight"),
            "ln2_bias": get(t + "post_attention_layernorm.bias"),
            "attn": {
                "qkv_kernel": get(t + "self_attention.query_key_value."
                                  "weight").t().reshape(h, n, 3, d),
                "qkv_bias": get(t + "self_attention.query_key_value.bias"
                                ).reshape(n, 3, d),
                "out_kernel": get(t + "self_attention.dense.weight"
                                  ).t().reshape(n, d, h),
                "out_bias": get(t + "self_attention.dense.bias"),
            },
            "mlp": {
                "fc1_kernel": get(t + "mlp.dense_h_to_4h.weight").t(),
                "fc1_bias": get(t + "mlp.dense_h_to_4h.bias"),
                "fc2_kernel": get(t + "mlp.dense_4h_to_h.weight").t(),
                "fc2_bias": get(t + "mlp.dense_4h_to_h.bias"),
            },
        }

    decoder = {
        "emb_ln_scale": get("word_embeddings_layernorm.weight"),
        "emb_ln_bias": get("word_embeddings_layernorm.bias"),
        "ln_f_scale": get("ln_f.weight"),
        "ln_f_bias": get("ln_f.bias"),
        "layers": _stack([layer(i) for i in range(cfg.num_hidden_layers)]),
    }
    return {"word_embeddings": {"embedding": _pad_vocab(
        get("word_embeddings.weight"), cfg.vocab_size)}, "decoder": decoder}


# ---------------------------------------------------------------- vision

def vision_params_from_torch(sd: Dict[str, Any], vision_cfg) -> dict:
    """A timm / CLIP / TimeSformer state dict -> the vision tower's tree:
    the fused ``qkv.bias`` split into ``q_bias`` / ``v_bias`` (k's is
    zero; a checkpoint without it gives zero biases unless it names
    ``q_bias`` / ``v_bias``), the position embedding resized to the
    configured grid and the temporal one to the configured frames,
    classifier heads dropped, and whatever the checkpoint lacks (an image
    ViT's temporal parts) left out for the caller to keep at init."""
    dim = vision_cfg.embed_dim
    n = vision_cfg.num_heads
    d = dim // n

    def get(key):
        return _tensor(sd[key])

    def attn(prefix):
        if prefix + "qkv.weight" not in sd:
            return None
        out = {"qkv_kernel": get(prefix + "qkv.weight").t().reshape(
            dim, 3, n, d)}
        if prefix + "qkv.bias" in sd:
            b = get(prefix + "qkv.bias")
            out["q_bias"] = b[:dim].reshape(n, d)
            out["v_bias"] = b[2 * dim:].reshape(n, d)
        else:
            for k in ("q_bias", "v_bias"):
                out[k] = (get(prefix + k) if prefix + k in sd
                          else torch.zeros(dim)).reshape(n, d)
        out["proj_kernel"] = get(prefix + "proj.weight").t().reshape(
            n, d, dim)
        out["proj_bias"] = get(prefix + "proj.bias")
        return out

    def ln(prefix):
        if prefix + "weight" not in sd:
            return None
        return {"scale": get(prefix + "weight"), "bias": get(prefix + "bias")}

    def mlp(prefix):
        if prefix + "fc1.weight" not in sd:
            return None
        return {"fc1_kernel": get(prefix + "fc1.weight").t(),
                "fc1_bias": get(prefix + "fc1.bias"),
                "fc2_kernel": get(prefix + "fc2.weight").t(),
                "fc2_bias": get(prefix + "fc2.bias")}

    params: dict = {}
    if "patch_embed.proj.weight" in sd:
        w = get("patch_embed.proj.weight")
        params["patch_embed"] = {"kernel": w.reshape(w.shape[0], -1).t()}
        if "patch_embed.proj.bias" in sd:
            params["patch_embed"]["bias"] = get("patch_embed.proj.bias")
    if "cls_token" in sd:
        params["cls_token"] = get("cls_token")
    if "pos_embed" in sd:
        params["pos_embed"] = _pos_embed(sd["pos_embed"],
                                         vision_cfg.num_patches)
    if "temporal_embed" in sd:
        params["temporal_embed"] = _temporal_embed(sd["temporal_embed"],
                                                   vision_cfg.num_frames)
    for name in ("norm", "norm_pre"):
        block = ln(name + ".")
        if block:
            params[name] = block

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b = f"blocks.{i}."
        entry = {}
        for sub, fn in (("norm1", ln), ("norm2", ln), ("temporal_ln", ln),
                        ("mlp", mlp), ("attn", attn),
                        ("temporal_attn", attn)):
            got = fn(b + sub + ".")
            if got:
                entry[sub] = got
        if b + "temporal_fc.weight" in sd:
            entry["temporal_fc_kernel"] = get(b + "temporal_fc.weight").t()
            entry["temporal_fc_bias"] = get(b + "temporal_fc.bias")
        params[f"blocks_{i}"] = entry
        i += 1
    return params


# ------------------------------------------------------------------ Owl

# the published abstractor naming (the MplugOwlVisualAbstractor module
# tree): per-layer suffix -> (path under abstractor/layers_<i>, a linear
# layer whose weight transposes?)
_OWL_LAYER_MAP = {
    "crossattention.norm1": ("norm_q", False),
    "crossattention.normk": ("norm_kv", False),
    "crossattention.attention.query": ("q", True),
    "crossattention.attention.key": ("k", True),
    "crossattention.attention.value": ("v", True),
    "crossattention.output.out_proj": ("out", True),
    "crossattention.output.norm2": ("norm_mlp", False),
    "crossattention.output.mlp.w1": ("mlp/w1", True),
    "crossattention.output.mlp.w2": ("mlp/w2", True),
    "crossattention.output.mlp.w3": ("mlp/w3", True),
    "crossattention.output.mlp.ffn_ln": ("mlp/ffn_ln", False),
}

# names that drifted between releases, matched in order against the
# suffix's '.'/'_'-split tokens (so 'normk' wins over 'k'): (keywords,
# target, linear?)
_OWL_FALLBACK = (
    ({"norm1"}, "norm_q", False),
    ({"normk"}, "norm_kv", False),
    ({"norm_k"}, "norm_kv", False),
    ({"norm2"}, "norm_mlp", False),
    ({"ffn_ln"}, "mlp/ffn_ln", False),
    ({"w1"}, "mlp/w1", True),
    ({"w2"}, "mlp/w2", True),
    ({"w3"}, "mlp/w3", True),
    ({"fc1"}, "mlp/w1", True),
    ({"fc2"}, "mlp/w2", True),
    ({"query"}, "q", True),
    ({"q_proj"}, "q", True),
    ({"key"}, "k", True),
    ({"k_proj"}, "k", True),
    ({"value"}, "v", True),
    ({"v_proj"}, "v", True),
    ({"out_proj"}, "out", True),
    ({"o_proj"}, "out", True),
    ({"dense"}, "out", True),
)

_OWL_LAYER_RE = re.compile(r"(?:^|\.)layers?[._](\d+)\.")


def _owl_assign(tree: dict, path: str, value: torch.Tensor, *, linear: bool,
                is_weight: bool):
    """Place one external tensor at ``path`` ('a/b/c') in ``tree``: a
    linear layer's weight transposed [out, in] -> [in, out] at
    '<path>_kernel', its bias at '<path>_bias'; a LayerNorm's at
    '<path>/scale' and '<path>/bias'."""
    parts = path.split("/")
    if linear:
        leaf = parts[-1] + ("_kernel" if is_weight else "_bias")
        value = value.t() if is_weight else value
        parts = parts[:-1] + [leaf]
    else:
        parts = parts + ["scale" if is_weight else "bias"]
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def owl_abstractor_params_from_torch(sd: Dict[str, Any], abst_cfg) -> dict:
    """External mPLUG-Owl abstractor tensors (names without the
    ``abstractor.`` prefix) -> ``{"abstractor", "visual_fc", "vit_eos"}``
    trees.  Each per-layer tensor goes through ``_OWL_LAYER_MAP``, else
    ``_OWL_FALLBACK``; ``query_tokens`` [1, nq, d] (or [nq, d]),
    ``visual_fc``, ``vit_eos`` and a ``*temporal*`` embedding ([T, d] or
    [1, T, d], resized to ``max_frames``) are placed by name.  Any tensor
    left unplaced raises ValueError naming it, as does a layer index past
    ``num_layers`` and query tokens of another shape."""
    out: dict = {"abstractor": {}}
    unconsumed = []
    for name, v in sorted(sd.items()):
        v = _tensor(v)
        base = name[:-len(".weight")] if name.endswith(".weight") else (
            name[:-len(".bias")] if name.endswith(".bias") else name)
        is_weight = name.endswith(".weight")

        tokens = set(re.split(r"[._]", name))
        if "query_tokens" in name or "query_embeds" in name:
            q = v[None] if v.dim() == 2 else v
            want = (1, abst_cfg.num_queries, abst_cfg.hidden_size)
            if tuple(q.shape) != want:
                raise ValueError(f"{name}: query tokens shape "
                                 f"{tuple(q.shape)} != {want}")
            out["abstractor"]["query_embeds"] = q
            continue
        if "visual_fc" in name:
            node = out.setdefault("visual_fc", {})
            if is_weight:
                node["kernel"] = v.t()
            else:
                node["bias"] = v
            continue
        if "vit_eos" in name:
            out["vit_eos"] = v.reshape(1, 1, -1)
            continue
        if "temporal" in tokens or "temporal" in name:
            t = v[None] if v.dim() == 2 else v
            out["abstractor"]["temporal_embed"] = _temporal_embed(
                t, abst_cfg.max_frames)[0]
            continue

        m = _OWL_LAYER_RE.search(base)
        if m is None:
            unconsumed.append(name)
            continue
        li = int(m.group(1))
        if li >= abst_cfg.num_layers:
            raise ValueError(
                f"{name}: layer {li} >= num_layers {abst_cfg.num_layers}")
        suffix = base[m.end():]
        layer_tree = out["abstractor"].setdefault(f"layers_{li}", {})
        hit = _OWL_LAYER_MAP.get(suffix)
        if hit is None:
            toks = set(re.split(r"[._]", suffix)) | {suffix.split(".")[-1]}
            hit = next(((target, linear) for kws, target, linear
                        in _OWL_FALLBACK if kws & toks), None)
        if hit is None:
            unconsumed.append(name)
            continue
        target, linear = hit
        _owl_assign(layer_tree, target, v, linear=linear,
                    is_weight=is_weight)

    if unconsumed:
        raise ValueError(
            "abstractor import: %d tensor(s) have no mapping; refusing a "
            "partly imported abstractor. Unconsumed: %s"
            % (len(unconsumed), ", ".join(sorted(unconsumed))))
    return out


def owl_vision_params_from_torch(sd: Dict[str, Any], vision_cfg) -> dict:
    """External MplugOwlVisionModel tensors -> the vision tower's tree.
    The external tower is named Megatron-style: a fused
    ``self_attn.query_key_value`` with head-major rows [n, 3, d],
    ``self_attn.dense``, ``input_layernorm`` / ``post_attention_layernorm``
    per layer, ``embeddings.{cls_token, patch_embed, position_embedding,
    pre_layernorm}`` and a final ``post_layernorm``.  The fused k bias is
    dropped: a constant key offset shifts every logit of a row equally,
    so softmax ignores it.  Any tensor left unplaced raises ValueError,
    as does a layer index past ``depth``."""
    dim = vision_cfg.embed_dim
    n = vision_cfg.num_heads
    d = dim // n
    params: dict = {}
    unconsumed = []

    def ln_assign(tree, key, v, is_weight):
        tree.setdefault(key, {})["scale" if is_weight else "bias"] = v

    layer_re = re.compile(r"encoder\.layers\.(\d+)\.")
    for name, v in sorted(sd.items()):
        v = _tensor(v)
        is_weight = name.endswith(".weight")
        m = layer_re.search(name)
        if m is None:
            if "cls_token" in name:
                params["cls_token"] = v.reshape(1, 1, dim)
            elif "position_embedding" in name or "pos_embed" in name:
                params["pos_embed"] = _pos_embed(
                    v if v.dim() == 3 else v[None], vision_cfg.num_patches)
            elif "patch_embed" in name and is_weight:
                params.setdefault("patch_embed", {})[
                    "kernel"] = v.reshape(v.shape[0], -1).t()
            elif "patch_embed" in name and name.endswith(".bias"):
                params.setdefault("patch_embed", {})["bias"] = v
            elif "pre_layernorm" in name or "pre_layrnorm" in name:
                ln_assign(params, "norm_pre", v, is_weight)
            elif "post_layernorm" in name:
                ln_assign(params, "norm", v, is_weight)
            else:
                unconsumed.append(name)
            continue

        li = int(m.group(1))
        if li >= vision_cfg.depth:
            raise ValueError(
                f"{name}: layer {li} >= depth {vision_cfg.depth}")
        suffix = name[m.end():]
        blk = params.setdefault(f"blocks_{li}", {})
        if suffix.startswith(("input_layernorm", "layer_norm1")):
            ln_assign(blk, "norm1", v, is_weight)
        elif suffix.startswith(("post_attention_layernorm", "layer_norm2")):
            ln_assign(blk, "norm2", v, is_weight)
        elif "query_key_value" in suffix:
            attn = blk.setdefault("attn", {})
            if is_weight:  # [3D, D] head-major rows -> [D, 3, n, d]
                attn["qkv_kernel"] = v.t().reshape(dim, n, 3, d).permute(
                    0, 2, 1, 3)
            else:  # [3D] head-major -> the q and v biases per head
                b = v.reshape(n, 3, d)
                attn["q_bias"] = b[:, 0]
                attn["v_bias"] = b[:, 2]
        elif "self_attn.dense" in suffix or suffix.startswith(
                ("self_attn.out_proj", "self_attn.proj")):
            attn = blk.setdefault("attn", {})
            if is_weight:
                attn["proj_kernel"] = v.t().reshape(n, d, dim)
            else:
                attn["proj_bias"] = v
        elif "mlp.fc1" in suffix or "mlp.fc2" in suffix:
            fc = "fc1" if "mlp.fc1" in suffix else "fc2"
            blk.setdefault("mlp", {})[
                f"{fc}_kernel" if is_weight else f"{fc}_bias"] = (
                v.t() if is_weight else v)
        else:
            unconsumed.append(name)

    if unconsumed:
        raise ValueError(
            "owl vision import: %d tensor(s) have no mapping; refusing a "
            "partial vision import. Unconsumed: %s"
            % (len(unconsumed), ", ".join(sorted(unconsumed))))
    return params


# ---------------------------------------------------------------- merges

def param_tree(module: nn.Module) -> dict:
    """The module's parameters (the tensors themselves, not copies) as a
    nested dict under their JAX names."""
    return unflatten({jax_path(name): p
                      for name, p in module.named_parameters()})


def _copy_leaf(tgt: torch.Tensor, v, path: str) -> None:
    v = _tensor(v)
    if tuple(v.shape) != tuple(tgt.shape):
        raise ValueError(f"shape mismatch at {path}: {tuple(v.shape)} vs "
                         f"{tuple(tgt.shape)}")
    with torch.no_grad():
        tgt.copy_(v)  # cast to the parameter's dtype, on its device


def merge_into(params: dict, imported: dict, prefix: str = "") -> int:
    """Copy each leaf of ``imported`` into the parameter of ``params`` (a
    ``param_tree``) at the same path, shape-checked; names ``params``
    lacks are skipped.  Returns the number of leaves copied."""
    count = 0
    for k, v in imported.items():
        if k not in params:
            continue
        if isinstance(v, dict):
            count += merge_into(params[k], v, prefix + k + "/")
        else:
            _copy_leaf(params[k], v, prefix + k)
            count += 1
    return count


def merge_exact(params: dict, imported: dict, prefix: str = "") -> int:
    """``merge_into`` that raises ValueError on an imported name with no
    parameter."""
    count = 0
    for k, v in imported.items():
        if k not in params:
            raise ValueError(f"no target param at {prefix}{k} "
                             f"(model tree has: {sorted(params)})")
        if isinstance(v, dict):
            count += merge_exact(params[k], v, prefix + k + "/")
        else:
            _copy_leaf(params[k], v, prefix + k)
            count += 1
    return count


def _leaf_paths(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        p = prefix + "/" + k if prefix else k
        out += _leaf_paths(v, p) if isinstance(v, dict) else [p]
    return out


def check_covered(expected_tree: dict, provided_tree: dict, what: str,
                  optional: Iterable[str] = ()):
    """Raise ValueError unless every leaf of ``expected_tree`` has a value
    in ``provided_tree``; ``optional`` substrings mark paths that may be
    absent."""
    expected = set(_leaf_paths(expected_tree))
    provided = set(_leaf_paths(provided_tree))
    missing = sorted(p for p in expected - provided
                     if not any(o in p for o in optional))
    if missing:
        raise ValueError(
            "%s import: checkpoint provides no tensor for %d model "
            "param(s); refusing a partial import. Missing: %s"
            % (what, len(missing), ", ".join(missing)))


def import_owl(model: nn.Module, cfg, model_dir: str) -> nn.Module:
    """Import an HF mPLUG-Owl checkpoint directory into an
    ``MPLUGOwlVideo`` in place, as the JAX ``import_owl`` does:
    ``language_model.transformer.*`` (HF Bloom) merged partially;
    ``vision_model.*`` through the timm mapper when its layers are named
    ``blocks.<i>`` (partial merge) and else through the external tower's
    mapper (exact merge), either way held to cover every vision parameter
    but the patch bias and LoRA adapters; ``abstractor.*`` and
    ``query_tokens`` through the fail-loud abstractor mapper, held to
    cover the abstractor, ``visual_fc`` and ``vit_eos`` (temporal
    embedding, ``in_proj`` and adapters may be absent) and merged
    exactly.  A ``vit_eos`` for a model without one raises; tensors
    outside these prefixes are named in a warning.  Each source tensor is
    dropped once merged.  Returns ``model``."""
    sd = load_hf_torch_state(model_dir)
    params = param_tree(model)

    def take(prefix):
        return {k[len(prefix):]: sd.pop(k) for k in sorted(sd)
                if k.startswith(prefix)}

    lm = take("language_model.")
    if lm:
        dec = bloom_params_from_torch(lm, cfg.text)
        del lm
        n = merge_into(params["text_decoder"], dec)
        del dec
        print(f"imported {n} Bloom decoder tensors from {model_dir}",
              flush=True)

    vis = take("vision_model.")
    if vis:
        optional = ("patch_embed/bias", "lora_")
        if any(k.startswith("blocks.") for k in vis):
            vp = vision_params_from_torch(vis, cfg.vision)
            check_covered(params["visual_encoder"], vp, "owl vision",
                          optional=optional)
            n = merge_into(params["visual_encoder"], vp)
            print(f"imported {n} vision tensors", flush=True)
        else:
            vp = owl_vision_params_from_torch(vis, cfg.vision)
            check_covered(params["visual_encoder"], vp, "owl vision",
                          optional=optional)
            n = merge_exact(params["visual_encoder"], vp)
            print(f"imported {n} vision tensors (exact, fail-loud)",
                  flush=True)
        del vis, vp

    abst = take("abstractor.")
    # the queries are named under the external model, prefix and all
    abst.update((k, sd.pop(k)) for k in sorted(sd)
                if k.startswith("query_tokens"))
    if abst:
        ap = owl_abstractor_params_from_torch(abst, cfg.abstractor)
        use_vit_eos = getattr(cfg, "use_vit_eos", True)
        if "vit_eos" in ap and not use_vit_eos:
            raise ValueError(
                "checkpoint carries vit_eos but cfg.use_vit_eos=False")
        expected = {"abstractor": params["abstractor"],
                    "visual_fc": params["visual_fc"]}
        if use_vit_eos:
            expected["vit_eos"] = params["vit_eos"]
        check_covered(expected, ap, "abstractor",
                      optional=("temporal_embed", "/in_proj/", "lora_"))
        n = merge_exact(params, ap)
        print(f"imported {n} abstractor tensors (exact, fail-loud)",
              flush=True)

    if sd:
        # not fatal (checkpoints carry tied lm_head copies, rotary buffers
        # and the like) but never silent
        left = sorted(sd)
        print(f"WARNING: {len(left)} checkpoint tensor(s) outside the "
              f"known module prefixes were ignored: {left[:6]}"
              f"{'...' if len(left) > 6 else ''}", flush=True)
    return model


def import_all(model: nn.Module, cfg, src_spec) -> nn.Module:
    """The ``import_torch_weights`` config key: ``{"gpt3": model_dir,
    "vision": file}`` (either may be absent) or a bare string, the GPT-3
    directory.  The decoder and the vision tower of ``model`` (an
    ``MPLUGVideo``; ``cfg`` its ``RunConfig``) take what the checkpoints
    hold (``merge_into``: partial); the rest keeps its values.  Returns
    ``model``."""
    params = param_tree(model)
    if isinstance(src_spec, str):
        src_spec = {"gpt3": src_spec}
    if src_spec.get("gpt3"):
        sd = load_torch_gpt3_state(src_spec["gpt3"])
        dec = gpt3_params_from_torch(sd, cfg.model.text)
        del sd
        n = merge_into(params["text_decoder"], dec)
        del dec
        print(f"imported {n} decoder tensors from {src_spec['gpt3']}",
              flush=True)
    if src_spec.get("vision"):
        sd = torch.load(src_spec["vision"], map_location="cpu",
                        weights_only=False)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
        vis = vision_params_from_torch(sd, cfg.model.vision)
        del sd
        n = merge_into(params["visual_encoder"], vis)
        print(f"imported {n} vision tensors from {src_spec['vision']}",
              flush=True)
    return model
