"""Expert parallelism: a Switch-style top-1 MoE MLP with its experts
sharded over a process group.

Counterpart of ``apex_tpu/transformer/expert_parallel.py``, in the same
steps:

1. router: ``gates = softmax(x @ Wg.T)`` in fp32, the top-1 expert of
   each token (``argmax``: the first index on a tie, as in JAX) and the
   Switch load-balancing loss ``E * sum_e frac_e * mean_prob_e``;
2. capacity ``C = ceil(tokens_local * capacity_factor / E)``; a token's
   place in its expert's queue is a cumulative sum, and a token past
   ``C`` is dropped: its one-hot place row is all zeros (built by
   comparison, as ``jax.nn.one_hot`` gives it; ``F.one_hot`` would
   raise), so its output is 0;
3. the dispatch einsum builds ``(E, C, h)`` slots, and a tiled all-to-all
   (:func:`apex_tpu_torch.parallel._p2p.all_to_all`) sends each rank the
   slots of its own experts from every rank;
4. the local experts' FFNs (dense, tanh-gelu, dense) as batched matmuls;
5. the reverse all-to-all, and the combine einsum scales each expert
   output by its gate and puts it back at its token.

The parameters of :meth:`ExpertParallelMLP.init` are stacked over all
``E`` experts; a rank passes the router whole and its ``E / ep`` experts
(rows ``rank * E / ep`` onwards) to ``__call__``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel._p2p import all_to_all
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    init_method_normal)
from apex_tpu_torch.transformer.tensor_parallel.mappings import tensor_group

__all__ = ["ExpertParallelMLP"]


class ExpertParallelMLP:
    """Switch-style top-1 MoE MLP with experts sharded over ``axis_name``
    (a mesh axis name or a ``ProcessGroup``).

    ``__call__(params, x)`` with ``x`` ``(tokens_local, hidden)`` returns
    ``(out, aux_loss)``; the mean of ``aux_loss`` over the ranks is up to
    the caller. ``num_experts`` must divide by the group's size."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_experts: int, capacity_factor: float = 1.25,
                 axis_name=TENSOR_AXIS, init_method=None,
                 params_dtype=torch.float32):
        self.hidden_size = hidden_size
        self.ffn = ffn_hidden_size
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.init_method = init_method or init_method_normal(0.02)
        self.params_dtype = params_dtype

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Every expert's parameters, stacked ``(E, ...)``, and the router
        ``(E, h)``, drawn from the CPU ``generator`` (router, then ``wi``,
        then ``wo``) and placed on ``device`` (the card unless the caller
        passes ``device="cpu"``; a CUDA device with no card raises)."""
        E, h, f = self.num_experts, self.hidden_size, self.ffn
        device = resolve_device(device)

        def draw(*shape):
            t = self.init_method(torch.empty(shape), generator)
            return t.to(device=device, dtype=self.params_dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.params_dtype, device=device)

        return {"router": {"weight": draw(E, h)},
                "experts": {"wi": draw(E, f, h), "bi": zeros(E, f),
                            "wo": draw(E, h, f), "bo": zeros(E, h)}}

    # -- pieces -----------------------------------------------------------
    def _route(self, params, x):
        """Top-1 gates and the dispatch and combine tensors ``(n, E, C)``
        (GShard's einsum form), the aux loss and ``C``."""
        E = self.num_experts
        n = x.shape[0]
        C = max(1, math.ceil(n * self.capacity_factor / E))
        logits = x.float() @ params["router"]["weight"].float().T
        gates = torch.softmax(logits, dim=-1)                 # (n, E)
        expert = gates.argmax(dim=-1)                         # first on ties
        gate = gates.max(dim=-1).values                       # (n,)
        onehot = (expert[:, None] == torch.arange(
            E, device=x.device)).float()
        # each token's place in its expert's queue
        pos = torch.cumsum(onehot, dim=0) * onehot            # 1-based
        pos = pos.sum(dim=-1) - 1.0                           # (n,)
        keep = (pos < C).float()
        gate = gate * keep
        # a place at or past C matches no column: a zero row
        pos_oh = (pos.long()[:, None] == torch.arange(
            C, device=x.device)).float()                      # (n, C)
        dispatch = onehot[:, :, None] * pos_oh[:, None, :] \
            * keep[:, None, None]
        combine = dispatch * gate[:, None, None]
        frac = onehot.mean(dim=0)
        prob = gates.mean(dim=0)
        aux = E * torch.sum(frac * prob)
        return dispatch, combine, aux, C

    def _expert_ffn(self, ep_params, slots):
        """``slots (E_local, S, h)`` through each local expert."""
        dt = slots.dtype
        wi, bi = ep_params["wi"].to(dt), ep_params["bi"].to(dt)
        wo, bo = ep_params["wo"].to(dt), ep_params["bo"].to(dt)
        h1 = F.gelu(torch.bmm(slots, wi.transpose(1, 2)) + bi[:, None, :],
                    approximate="tanh")
        return torch.bmm(h1, wo.transpose(1, 2)) + bo[:, None, :]

    # -- forward ----------------------------------------------------------
    def __call__(self, params: dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        E = self.num_experts
        group = tensor_group(self.axis_name)
        ep = dist.get_world_size(group)
        if E % ep:
            raise ValueError(f"num_experts {E} not divisible by ep={ep}")
        dispatch, combine, aux, C = self._route(params, x)
        dt = x.dtype
        # (n, E, C) x (n, h) -> (E, C, h) slots on this rank
        slots = torch.einsum("nec,nh->ech", dispatch, x.float()).to(dt)
        # token-sharded -> expert-sharded: split E, gather the peers'
        # slots for this rank's experts along the capacity axis
        slots = all_to_all(slots, group, 0, 1)
        out_slots = self._expert_ffn(params["experts"], slots)
        out_slots = all_to_all(out_slots, group, 1, 0)
        out = torch.einsum("nec,ech->nh", combine, out_slots.float())
        return out.to(dt), aux
