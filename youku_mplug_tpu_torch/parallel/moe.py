"""Mixture-of-Experts FFN with expert parallelism (the GShard pattern).

Counterpart of ``youku_mplug_tpu/parallel/moe.py``: top-k routing with
capacity, dense dispatch / combine einsums, expert-stacked weights
(``router [M, E]``, ``w1 [E, M, F]``, ``b1 [E, F]``, ``w2 [E, F, M]``,
``b2 [E, M]``: JAX's names and shapes, so ``bridge.load_jax_params``
loads them).  Shapes: tokens [G, S, M] (G groups = batch), E experts,
capacity ``C = max(1, int(k * S * capacity_factor / E))``.

Expert parallelism: ``MOE_SHARDING_RULES`` (``parallel/sharding.py``,
JAX's ``moe_rules``) cut the leading E dim over the model axis, so that
``shard_params`` leaves each model rank E/P experts and hands the module
its ``ModelGroup``.  The tokens are replicated over the model group:
every rank routes them all (the router is whole everywhere), runs its own
experts on its slice of the dispatch and combine, and the partial
outputs are summed (g).  The router's gradient comes two ways: through
the combine of the local experts, a rank's share that must be summed,
and through the load-balance loss, whole on every rank, that must not;
so f goes on the combine and on ``x`` where they enter the local experts
and nowhere else.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)


def top_k_routing(gates: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates [G, S, E] -> (dispatch [G, S, E, C] bool, combine [G, S, E, C]
    in gates.dtype, aux scalar), JAX's ``top_k_routing``: for each of the
    k choices in turn the tokens claim expert slots in sequence order
    (cumsum), and a token past an expert's capacity gets combine weight 0
    for that choice; aux is the load-balance loss (mean gate times the
    top-1 dispatch fraction, scaled by E^2)."""
    g, s, e = gates.shape
    top1 = gates.argmax(-1)
    me = gates.mean(1)
    ce = F.one_hot(top1, e).to(gates.dtype).mean(1)
    aux = (me * ce).sum(-1).mean() * e * e

    dispatch = torch.zeros(g, s, e, capacity, dtype=torch.bool,
                           device=gates.device)
    combine = torch.zeros(g, s, e, capacity, dtype=gates.dtype,
                          device=gates.device)
    remaining = gates
    used = torch.zeros(g, e, dtype=torch.long, device=gates.device)
    for _ in range(k):
        choice = remaining.argmax(-1)                      # [G, S]
        onehot = F.one_hot(choice, e)                      # [G, S, E]
        pos_in_expert = onehot.cumsum(1) - onehot
        slot = (pos_in_expert * onehot).sum(-1) + used.gather(1, choice)
        fits = slot < capacity
        gate_val = remaining.gather(-1, choice[..., None])[..., 0]
        # a slot past capacity is one-hot nowhere (JAX's one_hot of an
        # index out of range)
        slot_oh = F.one_hot(torch.where(fits, slot, capacity),
                            capacity + 1)[..., :capacity].to(gates.dtype)
        sel = onehot.to(gates.dtype)[..., None] * slot_oh[:, :, None]
        dispatch = dispatch | (sel > 0)
        combine = combine + sel * torch.where(
            fits, gate_val, torch.zeros_like(gate_val))[..., None, None]
        used = used + (onehot * fits[..., None]).sum(1)
        remaining = remaining * (1.0 - onehot.to(gates.dtype))
    return dispatch, combine, aux


class MoEMLP(nn.Module):
    """Top-k routed expert MLPs in place of an FFN (JAX's ``MoEMLP``):
    ``forward(x [G, S, M]) -> (y [G, S, M] in x.dtype, aux)``.  The
    parameters are made empty (``bridge.load_jax_params`` or
    ``bridge.seeded_init`` fills them); on a model shard (``tp``) w1, b1,
    w2 and b2 hold this rank's contiguous E/P experts."""

    TP_PARAM = "w2"  # the expert stack a model shard must split
    tp = None

    def __init__(self, hidden: int, num_experts: int, ffn_dim: int,
                 k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        e, m, f = num_experts, hidden, ffn_dim

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.router = param(m, e)
        self.w1 = param(e, m, f)
        self.b1 = param(e, f)
        self.w2 = param(e, f, m)
        self.b2 = param(e, m)

    def forward(self, x: torch.Tensor):
        g, s, m = x.shape
        e = self.num_experts
        capacity = max(1, int(self.k * s * self.capacity_factor / e))
        gates = torch.softmax(torch.einsum("gsm,me->gse", x.float(),
                                           self.router.float()), dim=-1)
        dispatch, combine, aux = top_k_routing(gates, self.k, capacity)

        dt = x.dtype
        local = self.w1.shape[0]
        lo = 0 if self.tp is None else self.tp.index * local
        x = copy_to_model(x, self.tp)
        combine = copy_to_model(combine, self.tp)[:, :, lo:lo + local]
        dispatch = dispatch[:, :, lo:lo + local]
        expert_in = torch.einsum("gsec,gsm->egcm", dispatch.to(dt), x)
        h = F.gelu(torch.einsum("egcm,emf->egcf", expert_in,
                                self.w1.to(dt))
                   + self.b1.to(dt)[:, None, None], approximate="tanh")
        expert_out = (torch.einsum("egcf,efm->egcm", h, self.w2.to(dt))
                      + self.b2.to(dt)[:, None, None])
        y = torch.einsum("gsec,egcm->gsm", combine.to(dt), expert_out)
        return reduce_from_model(y, self.tp), aux

