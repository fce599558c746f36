"""Times the flash forward kernel at the paths' shapes, beside SDPA.

For each shape of ``SHAPES`` (K4 at head dims 80 and 96, as the GPT-3
2.7B decoder and clip-b16's AttentionPool call it, and K1 / K4 at head
dims 64 and 128 for reference) it checks ``flash_fwd_cuda`` against
``flash_fwd_plain`` and times, with CUDA events over ``--iters`` calls
after a warm-up, the kernel and ``F.scaled_dot_product_attention`` on the
same inputs and mask (the yardstick; the port never calls it), in turns
(SDPA, kernel, kernel, SDPA: the median of each pair's means is kept).
It prints one JSON line: the card's name and power limit
(``nvidia-smi``), the forward's resident blocks an SM where the tree
reports them, and per shape the split count, both times, the bound (max
of bytes at 3.35 TB/s and operations at 989 TFLOP/s bf16, over the
(query, key) pairs the mask leaves) and the error.

It needs a card.  To compare two trees on one card, run it from each
tree's root with ``PYTHONPATH=$PWD python <this file>``: the kernels it
times are the tree's own.

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.profile_flash [--iters 50]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from youku_mplug_tpu_torch.ops import flash_attention as fa

PEAK_BF16_FLOPS = 989e12  # the H100 SXM's dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # its HBM3 bandwidth
SPIN_CYCLES = 200_000_000  # holds the card while the host enqueues
# (name, batch, heads, Sq, Sk, head dim, causal, layout): "qkv" = head
# views of one fused [B, S, 3 n d] projection, "heads" = q, k, v head
# views of their own [B, S, n d] projections
SHAPES = [
    ("K4-d80 cls27_eval", 180, 32, 208, 208, 80, True, "qkv"),
    ("K4-d96 cls_train", 32, 8, 128, 1570, 96, False, "heads"),
    ("K4-d96 itm_train", 32, 8, 128, 786, 96, False, "heads"),
    ("K4-d96 caption27_train", 24, 8, 128, 3138, 96, False, "heads"),
    ("K4-d96 cls_eval", 4, 8, 128, 1570, 96, False, "heads"),
    ("K4-d96 itm_eval", 4, 8, 128, 786, 96, False, "heads"),
    ("K1-d64 cls_eval", 180, 32, 208, 208, 64, True, "qkv"),
    ("K4-d64 serve", 8, 12, 128, 1570, 64, False, "heads"),
    ("K1-d64 spatial serve", 64, 12, 197, 197, 64, False, "qkv"),
    ("K1-d128 causal", 2, 32, 256, 256, 128, True, "qkv"),
]


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(gen, b, h, sq, sk, d, layout):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    if layout == "qkv":
        qkv = rand(b, sq, 3 * h * d)
        parts = qkv.unflatten(-1, (3, h, d)).unbind(2)
    else:
        parts = [rand(b, s, h * d).unflatten(-1, (h, d))
                 for s in (sq, sk, sk)]
    return [t.transpose(1, 2) for t in parts]


def profile(name, b, h, sq, sk, d, causal, layout, iters, gen) -> dict:
    import torch.nn.functional as F

    q, k, v = _inputs(gen, b, h, sq, sk, d, layout)
    kw = dict(scale=d ** -0.5, causal=causal)
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    pairs = b * h * int(fa._allowed(sq, sk, causal=causal, period=0,
                                    kv_len=None, device="cpu").sum())
    nbytes = 2 * d * b * h * (2 * sq + 2 * sk) + 4 * b * h * sq
    kernel = lambda: fa.flash_fwd_cuda(q, k, v, o, **kw)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal)
    sdpa_ms = [_ms(sdpa, iters)]
    kernel_ms = [_ms(kernel, iters), _ms(kernel, iters)]
    sdpa_ms.append(_ms(sdpa, iters))
    return {"shape": name, "b": b, "h": h, "sq": sq, "sk": sk, "d": d,
            "causal": causal,
            "splits": fa.kv_splits(b, h, sq, sk, head_dim=d, causal=causal,
                                   sms=fa._device_sms(q.device.index)),
            "ms": statistics.median(kernel_ms), "ms_runs": kernel_ms,
            "sdpa_ms": statistics.median(sdpa_ms), "sdpa_ms_runs": sdpa_ms,
            "bound_ms": max(4 * pairs * d / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES) * 1e3,
            "max_abs_err": (o.float() - want_o.float()).abs().max().item(),
            "lse_err": (lse - want_lse).abs().max().item()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = getattr(fa, "fwd_blocks_per_sm", None)
    summary = {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "blocks_per_sm": None if blocks is None
        else {d: blocks(d) for d in fa.HEAD_DIMS},
        "shapes": [profile(*shape, args.iters, gen) for shape in SHAPES]}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
