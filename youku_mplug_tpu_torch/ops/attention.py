"""Scaled-dot-product attention with an fp32 softmax island, and dropout.

Counterpart of ``youku_mplug_tpu/ops/attention.py``: ``mha_reference`` is
the plain attention (the decoder's prefill path, its training attention
under attention dropout, and the oracle of every attention kernel), and
``dot_product_attention`` dispatches to the flash kernel where the JAX
package does on its accelerator.

Dropout is inverted, as flax's ``nn.Dropout`` and the JAX
``mha_reference`` apply it: each value is kept with probability
``1 - rate`` and then divided by ``1 - rate``.  The masks come from an
explicit ``torch.Generator`` (JAX's bits cannot be reproduced; the tests
compare distributions, and rate 0 with the deterministic path).  With
attention dropout, ``mha_reference`` saves for its backward only q, k, v,
the fp32 log-sum-exp and the bool keep mask, and rebuilds the
probabilities there (``_DropoutAttention``): autograd of the plain
formula would hold the fp32 scores, probabilities and dropped
probabilities of every decoder layer, ~1.5 GB a layer at 96 rows of 208
tokens and 32 heads.

Under a (data, model) split each mask is drawn at the global array's
shape and the rank keeps its block (``blocks``: ``block_of``'s rows of a
data rank, a model shard's heads or columns), so every rank consumes the
step's generator as the (1,1) run does and keeps the (1,1) run's masks
bitwise (JAX draws each mask on the global array too).  The draw costs
data x model times what a rank keeps: the whole mask is drawn on every
rank, then cut (a per-block counter scheme would draw only the block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = torch.finfo(torch.float32).min

# where a rank's tensor lies in the global array of a split: for each
# (dim, index, count), block ``index`` of ``count`` equal blocks along dim
Blocks = Tuple[Tuple[int, int, int], ...]


def block_of(dim: int, group) -> Blocks:
    """The block along ``dim`` that ``group`` (an ``AxisGroup``: the data
    group's rows, a model group's heads or columns) holds; () without a
    group or with one rank on it."""
    if group is None or group.size <= 1:
        return ()
    return ((dim, group.index, group.size),)


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Dropout of one training forward: the generator its masks come from,
    the hidden (or token) and attention-probability rates, and ``rows``,
    the block of the global batch this rank's rows are (a data rank's:
    ``block_of(0, data group)``).  The decoders and the vision towers pass
    it down to every site."""

    generator: torch.Generator
    hidden: float = 0.0
    attention: float = 0.0
    rows: Blocks = ()


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            blocks: Blocks = ()) -> torch.Tensor:
    """Inverted dropout: ``x / (1 - rate)`` where a uniform draw from
    ``generator`` falls below ``1 - rate``, else 0; ``x`` itself at rate
    0.  ``blocks``: ``x`` is that block of the global array, whose mask
    is drawn (module docstring)."""
    if rate <= 0.0:
        return x
    keep = _keep_mask(x.shape, rate, generator, x.device, blocks)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              blocks: Blocks = ()) -> torch.Tensor:
    """Stochastic depth: each sample (leading dim) kept whole with
    probability ``1 - rate`` and divided by it, else zeroed; ``x`` itself
    at rate 0.  ``blocks``: as ``dropout``'s (the samples' one counts)."""
    if rate <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = _keep_mask(shape, rate, generator, x.device,
                      tuple(b for b in blocks if b[0] == 0))
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def checkpoint_replaying(fn, generator: Optional[torch.Generator], *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``; with a dropout
    ``generator`` the recompute first sets it to the state the forward
    started from, so it draws the forward's masks again."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    state = generator.get_state()

    def replay(*a):
        generator.set_state(state)
        return fn(*a)
    return checkpoint(replay, *args, use_reentrant=False)


def _keep_mask(shape, rate: float, generator, device,
               blocks: Blocks = ()) -> torch.Tensor:
    """The bool keep mask of a tensor of ``shape``: drawn at the global
    shape of ``blocks`` and cut to this block (a copy: the global mask
    is not held)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator")
    full = list(shape)
    for dim, _, count in blocks:
        full[dim] *= count
    keep = torch.rand(full, generator=generator, device=device) < 1.0 - rate
    if not blocks:
        return keep
    for dim, index, _ in blocks:
        keep = keep.narrow(dim, index * shape[dim], shape[dim])
    return keep.clone(memory_format=torch.contiguous_format)


def _masked_scores(q, k, *, causal, kv_len, bias, scale) -> torch.Tensor:
    """fp32 [B, H, Sq, Sk] scaled scores plus ``bias``, NEG_INF where the
    causal or kv_len mask drops a key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~(qi >= ki), NEG_INF)
    if kv_len is not None:
        ki = torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(~(ki[None, None, None, :]
                            < kv_len[:, None, None, None]), NEG_INF)
    return s


class _DropoutAttention(torch.autograd.Function):
    """``mha_reference`` with attention-probability dropout: p =
    softmax(s), o = (where(keep, p / (1 - rate), 0) cast to q.dtype) V.
    Saves (q, k, v, lse, keep) and rebuilds p from them in the backward
    (see the module docstring); the backward is the same formula's
    gradient in fp32, cast to each input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kw, scale, rate, generator, blocks):
        s = _masked_scores(q, k, scale=scale, **mask_kw)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        keep = _keep_mask(s.shape, rate, generator, s.device, blocks)
        pd = torch.where(keep, torch.exp(s - lse) / (1.0 - rate), 0.0)
        del s
        ctx.save_for_backward(q, k, v, lse, keep)
        ctx.mask_kw, ctx.scale, ctx.rate = mask_kw, scale, rate
        return torch.einsum("bhqk,bhkd->bhqd", pd.to(q.dtype), v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, lse, keep = ctx.saved_tensors
        p = torch.exp(_masked_scores(q, k, scale=ctx.scale, **ctx.mask_kw)
                      - lse)
        kept = torch.where(keep, 1.0 / (1.0 - ctx.rate), 0.0)
        pd = (p * kept).to(q.dtype)
        dv = torch.einsum("bhqk,bhqd->bhkd", pd, do.to(q.dtype))
        del pd
        dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()) * kept
        del kept
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * ctx.scale
        del p, dp
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  kv_len: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  dropout_blocks: Blocks = ()) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, S, D]. fp32 scores and softmax,
    probabilities cast back to q.dtype for PV; returns q.dtype.

    kv_len: optional [B] int tensor — keys at positions >= kv_len are
    masked.  bias: optional additive score bias broadcastable to
    [B, H, Sq, Sk] (a mask: it takes no gradient under dropout).
    dropout_rate > 0: the probabilities' inverted dropout, the keep mask
    drawn from ``generator`` (required then), at the global shape of
    ``dropout_blocks`` (a data rank's rows, a model shard's heads)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask_kw = dict(causal=causal, kv_len=kv_len, bias=bias)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 requires a generator")
        return _DropoutAttention.apply(q, k, v, mask_kw, scale,
                                       float(dropout_rate), generator,
                                       tuple(dropout_blocks))
    p = torch.softmax(_masked_scores(q, k, scale=scale, **mask_kw), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          kv_len: Union[None, int, torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          dropout_blocks: Blocks = ()) -> torch.Tensor:
    """Dispatched attention. q, k, v: [B, H, S, D].

    Unbiased attention without dropout, causal or not, with at least one
    128-row query block and at most a static ``kv_len`` goes to the flash
    kernel (``flash_attention``; the same rule under which the JAX
    package uses its Pallas kernel, which also requires Sq == Sk when
    causal).  Everything else, attention dropout included, runs
    ``mha_reference``."""
    use_flash = (bias is None and dropout_rate == 0.0 and q.shape[2] >= 128
                 and not isinstance(kv_len, torch.Tensor))
    if use_flash:
        from youku_mplug_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               scale=scale)
    if isinstance(kv_len, int):
        kv_len = torch.full((q.shape[0],), kv_len, device=q.device)
    return mha_reference(q, k, v, causal=causal, kv_len=kv_len, bias=bias,
                         scale=scale, dropout_rate=dropout_rate,
                         generator=generator, dropout_blocks=dropout_blocks)
