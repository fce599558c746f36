"""Times the flash kernels at the paths' shapes, beside SDPA.

Forward (the default): for each shape of ``SHAPES`` (K4 at head dims 80
and 96, as the GPT-3 2.7B decoder and clip-b16's AttentionPool call it,
and K1 / K4 at head dims 64 and 128 for reference) it checks
``flash_fwd_cuda`` against ``flash_fwd_plain`` and times, with CUDA
events over ``--iters`` calls after a warm-up, the kernel and
``F.scaled_dot_product_attention`` on the same inputs and mask (the
yardstick; the port never calls it), in turns (SDPA, kernel, kernel,
SDPA: the median of each pair's means is kept).

Backward (``--backward``): for each shape of ``BWD_SHAPES`` (K4b at head
dims 96 and 80 on the clip-b16 train steps and the 2.7B decoder's
dropout-free pass, K4b and K2/K3 at 64 and 128, with and without ALiBi,
for reference) it checks ``flash_bwd_cuda`` against ``flash_bwd_plain``
(relative L2 per gradient) and times, in turns (SDPA, kernels, kernels,
SDPA), SDPA's backward alone (``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` on the same inputs, mask and dO, the
graph kept between calls), the delta, dq and dk/dv kernels one by one
(where the short-query dk/dv kernel runs, the key-tile one beside it)
and the whole ``flash_bwd_cuda`` as the autograd Function runs it.

It prints one JSON line: the card's name and power limit
(``nvidia-smi``), the resident blocks an SM of the forward's or the
backward's builds where the tree reports them, their registers and spill
bytes from nvcc's report, and per shape the times, the bound (max of
bytes at 3.35 TB/s and operations at 989 TFLOP/s bf16, over the (query,
key) pairs the mask leaves) and the error.

It needs a card.  To compare two trees on one card, run it from each
tree's root with ``PYTHONPATH=$PWD python <this file>``: the kernels it
times are the tree's own (a tree without ``bwd_blocks_per_sm`` prints
``null`` blocks for the backward).

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.profile_flash [--iters 50]
        [--backward]
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
# the backward's shapes, in SHAPES' form plus ALiBi: K4b at d 96 on the
# cls, ITM and 2.7B caption train steps, K4b at d 80 on a dropout-free
# 2.7B training pass (no shipped YAML), then the d 64 and 128 builds for
# reference (the pretrain step's AttentionPool, vision spatial and
# decoder calls, Bloom's ALiBi training attention, a causal d 128 call)
BWD_SHAPES = [
    ("K4b-d96 cls_train", 32, 8, 128, 1570, 96, False, "heads", False),
    ("K4b-d96 itm_train", 32, 8, 128, 786, 96, False, "heads", False),
    ("K4b-d96 caption27_train", 24, 8, 128, 3138, 96, False, "heads",
     False),
    ("K4b-d80 dropout-free train", 32, 32, 208, 208, 80, True, "qkv",
     False),
    ("K4b-d64 pretrain", 16, 12, 128, 1570, 64, False, "heads", False),
    ("K2/K3-d64 spatial pretrain", 128, 12, 197, 197, 64, False, "qkv",
     False),
    ("K2/K3-d64 causal pretrain", 16, 32, 208, 208, 64, True, "qkv", False),
    ("K2/K3-d128 ALiBi instruct_train", 8, 32, 105, 105, 128, True, "qkv",
     True),
    ("K2/K3-d128 causal", 2, 32, 256, 256, 128, True, "qkv", False),
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


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).norm()
            / want.norm().clamp_min(1e-30)).item()


def profile_backward(name, b, h, sq, sk, d, causal, layout, alibi, iters,
                     gen) -> dict:
    import torch.nn.functional as F

    from youku_mplug_tpu_torch.ops.decode_attention import alibi_slopes

    q, k, v = _inputs(gen, b, h, sq, sk, d, layout)
    slopes = (torch.from_numpy(alibi_slopes(h)).cuda() if alibi else None)
    kw = dict(scale=d ** -0.5, causal=causal, alibi_slopes=slopes)
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    do = fa._head_major_empty(q).copy_(torch.randn(
        b, h, sq, d, generator=gen, device="cuda"))
    delta = (do.float() * o.float()).sum(-1).contiguous()
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    dq, dk, dv = (fa._head_major_empty(t) for t in (q, k, v))
    dq_fn = lambda: fa.flash_bwd_dq_cuda(  # noqa: E731
        q, k, v, do, lse, delta, dq, **kw)
    dkv_fn = lambda: fa.flash_bwd_dkv_cuda(  # noqa: E731
        q, k, v, do, lse, delta, dk, dv, **kw)
    # where the short-query dk/dv kernel runs, the key-tile one beside it
    short = getattr(fa, "dkv_short_splits", lambda *a, **k: 0)(
        b, h, sq, sk, head_dim=d, causal=causal, alibi=alibi)
    tiles_fn = lambda: fa._launch_dkv(  # noqa: E731
        q, k, v, do, lse, delta, dk, dv, period=0, kv_len=None, splits=0,
        **kw)
    # SDPA's mask: is_causal, or with ALiBi the float bias with -inf above
    # the diagonal, in q's dtype
    mask_kw = {"is_causal": causal}
    if alibi:
        bias = slopes[:, None, None] * torch.arange(
            sk, device="cuda", dtype=torch.float32)
        allowed = fa._allowed(sq, sk, causal=causal, period=0, kv_len=None,
                              device="cuda")
        mask_kw = {"attn_mask": bias.masked_fill(~allowed, float("-inf"))
                   [None].to(q.dtype)}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, **mask_kw)
    sdpa = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, do, retain_graph=True)
    # the whole backward as the autograd Function runs it (delta, then dq
    # and dk/dv, concurrent where the tree runs them so)
    bwd_fn = lambda: fa.flash_bwd_cuda(  # noqa: E731
        q, k, v, o, lse, do, **kw)
    delta_fn = getattr(fa, "flash_bwd_delta_cuda", None)
    sdpa_ms, dq_ms, dkv_ms, tiles_ms = [_ms(sdpa, iters)], [], [], []
    bwd_ms, delta_ms = [], []
    for _ in range(2):
        if delta_fn is not None:
            delta_ms.append(_ms(lambda: delta_fn(o, do), iters))
        dq_ms.append(_ms(dq_fn, iters))
        dkv_ms.append(_ms(dkv_fn, iters))
        if short:
            tiles_ms.append(_ms(tiles_fn, iters))
        bwd_ms.append(_ms(bwd_fn, iters))
    sdpa_ms.append(_ms(sdpa, iters))
    pairs = b * h * int(fa._allowed(sq, sk, causal=causal, period=0,
                                    kv_len=None, device="cpu").sum())
    row, stat = 2 * d * b * h, 4 * b * h * sq
    bound = {kind: max(ops * pairs * d / PEAK_BF16_FLOPS,
                       nbytes / PEAK_HBM_BYTES) * 1e3
             for kind, ops, nbytes in (
                 ("dq", 6, row * (3 * sq + 2 * sk) + 2 * stat),
                 ("dkv", 8, row * (2 * sq + 4 * sk) + 2 * stat))}
    return {"shape": name, "b": b, "h": h, "sq": sq, "sk": sk, "d": d,
            "causal": causal, "alibi": alibi,
            "delta_ms": statistics.median(delta_ms) if delta_ms else None,
            "dq_ms": statistics.median(dq_ms), "dq_ms_runs": dq_ms,
            "dkv_ms": statistics.median(dkv_ms), "dkv_ms_runs": dkv_ms,
            "dkv_short_splits": short,
            "dkv_key_tiles_ms": statistics.median(tiles_ms) if short
            else None,
            "ms": statistics.median(dq_ms) + statistics.median(dkv_ms),
            "bwd_ms": statistics.median(bwd_ms),
            "sdpa_bwd_ms": statistics.median(sdpa_ms),
            "sdpa_bwd_ms_runs": sdpa_ms,
            "dq_bound_ms": bound["dq"], "dkv_bound_ms": bound["dkv"],
            "rel_l2": {n: _rel_l2(g, w) for n, g, w in zip(
                ("dq", "dk", "dv"), got, want)}}


def _builds(backward: bool) -> dict:
    """Registers, spills and blocks an SM of the timed direction's builds
    at each head dim (what the tree reports; null where it reports
    nothing)."""
    from youku_mplug_tpu_torch.ops import _native

    report = getattr(_native, "ptxas_report", None)
    regs = {} if report is None else report(_native.build()[2])
    kinds = (("bwd_dq", "bwd_dkv", "bwd_dkv_short") if backward
             else ("fwd",))
    blocks = getattr(fa, "bwd_blocks_per_sm" if backward
                     else "fwd_blocks_per_sm", None)
    out = {}
    for d in fa.HEAD_DIMS:
        counts = (None,) * len(kinds) if blocks is None else blocks(d)
        counts = counts if isinstance(counts, tuple) else (counts,)
        for kind, n in zip(kinds, counts):
            name = f"flash_{kind}<{d},plain>"
            if n is not None or name in regs:
                out[f"{kind}<{d}>"] = {**regs.get(name, {}),
                                       "blocks_per_sm": n}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--backward", action="store_true",
                        help="time the dq and dk/dv kernels at BWD_SHAPES "
                             "against SDPA's backward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    run, shapes = ((profile_backward, BWD_SHAPES) if args.backward
                   else (profile, SHAPES))
    summary = {
        "card": _card(), "device": torch.cuda.get_device_name(0),
        "builds": _builds(args.backward),
        "shapes": [run(*shape, args.iters, gen) for shape in shapes]}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
