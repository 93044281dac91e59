"""Mixture-of-Experts FFN: shared experts + routed top-k with capacity
dispatch (counterpart of ``repro.models.moe``).

Dispatch is the reference's gather/scatter formulation: every (token,
choice) pair takes the next free slot of its expert's capacity, counted
by a token-major cumsum over the T*k choices in top-k rank order; choices
past capacity are dropped. Experts run as batched products over their
stacked weights ``(E, d, f)``, outside any hand-written kernel, as the
reference computes them outside any Pallas kernel.

The combine differs from the reference's in its order, not in what it
sums: the reference scatter-adds each slot's gated output into ``(T, d)``
(``index_add_`` on the card would add them in an order that varies from
run to run), the port gathers each token's k slot outputs and adds them in
rank order in fp32, then casts, so equal inputs give equal bits. In fp32
the two agree to summation order; in bf16 the port rounds once where the
reference rounds after each add.

The dispatch gather's gradient is built the same way (``_Dispatch``):
autograd's own for ``index_select`` is an ``index_add_`` over tokens, where
each token meets up to k slots and token 0 every unused one, so on the
card its atomics would add in an order that varies from run to run. Its
backward gathers each token's k slots in rank order (a dropped choice
reads the spare slot's zero row) and adds them in fp32. The rest of the
backward already sums in a fixed order: the combine's per-rank
``index_select`` repeats only the spare slot, whose gradient is dropped
with it; the router's ``torch.gather`` takes k distinct experts a token;
and a remat recompute of ``route`` sees the same logits, so it picks the
same slots.

The reference pins the combined output to the token sharding
(``repro.sharding.act.constrain_tokens``); on one card that is a no-op and
is left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Params, dense, init_linear,
                                       init_swiglu, normal_init, swiglu)


def init_moe(gen: torch.Generator, d_model: int, *, n_experts: int,
             moe_d_ff: int, top_k: int, n_shared: int = 0,
             shared_d_ff: Optional[int] = None, dtype=torch.float32,
             device="cpu", lora_rank: int = 0) -> Params:
    """The reference's tree: an fp32 ``router`` (d, E), the experts'
    stacked ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and
    the shared experts as one SwiGLU of ``n_shared * shared_d_ff`` (with
    LoRA when ``lora_rank``)."""
    p: Params = {
        "router": init_linear(gen, d_model, n_experts, dtype=torch.float32,
                              device=device),
        "w_gate": normal_init(gen, (n_experts, d_model, moe_d_ff),
                              d_model ** -0.5, dtype, device),
        "w_up": normal_init(gen, (n_experts, d_model, moe_d_ff),
                            d_model ** -0.5, dtype, device),
        "w_down": normal_init(gen, (n_experts, moe_d_ff, d_model),
                              moe_d_ff ** -0.5, dtype, device),
    }
    if n_shared > 0:
        p["shared"] = init_swiglu(gen, d_model,
                                  n_shared * (shared_d_ff or moe_d_ff),
                                  dtype=dtype, device=device,
                                  lora_rank=lora_rank)
    return p


def _topk_gates(logits: torch.Tensor, top_k: int, norm_topk: bool):
    """(T, E) fp32 -> gates (T, k), expert ids (T, k)."""
    gates, ids = torch.topk(logits, top_k, dim=-1)
    if norm_topk:
        return torch.softmax(gates, dim=-1), ids
    return torch.gather(torch.softmax(logits, dim=-1), -1, ids), ids


def capacity(n_tokens: int, *, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert for ``n_tokens`` tokens (all B*S of a call, pad
    tokens included), as the reference counts them."""
    return max(1, int(capacity_factor * n_tokens * top_k / n_experts))


def route(p: Params, xt: torch.Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float, norm_topk: bool):
    """Router logits (T, E) in fp32, gates and expert ids (T, k), each
    choice's slot within its expert (T*k,) and whether it is kept (within
    capacity), and the capacity."""
    t = xt.shape[0]
    logits = dense(p["router"], xt.float())
    gates, ids = _topk_gates(logits, top_k, norm_topk)
    cap = capacity(t, n_experts=n_experts, top_k=top_k,
                   capacity_factor=capacity_factor)
    # each choice's slot: its rank among the earlier choices of its expert
    # (token-major, top-k rank order), the reference's cumsum over the
    # (T*k, E) one-hot. Here the one-hot runs expert-major and is summed
    # as one flat array: on the card a scan down the outer dimension of
    # the (T*k, E) tensor took most of a prefill call's device time.
    eid = ids.reshape(-1)
    n = eid.numel()
    onehot = F.one_hot(eid, n_experts).t().reshape(-1)          # (E*T*k,)
    seen = torch.cumsum(onehot, dim=0).reshape(n_experts, n)
    before = torch.cat([seen.new_zeros(1), seen[:-1, -1]])     # (E,)
    pos = seen[eid, torch.arange(n, device=eid.device)] - before[eid] - 1
    return logits, gates, ids, pos, pos < cap, cap


class _Dispatch(torch.autograd.Function):
    """The experts' input rows, ``xt`` by ``token_of_slot``; the gradient
    of token t is the sum, in rank order and in fp32, of the gradients of
    its slots ``slot[t]`` (the spare slot ``n_slots``, where a dropped
    choice points, adds a zero row). No scatter: equal inputs give equal
    bits."""

    @staticmethod
    def forward(ctx, xt, token_of_slot, slot):
        ctx.save_for_backward(slot)
        return xt.index_select(0, token_of_slot)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors                       # (T, k)
        g = torch.cat([g, g.new_zeros(1, g.shape[1])])
        acc = torch.zeros(slot.shape[0], g.shape[1], dtype=torch.float32,
                          device=g.device)
        for j in range(slot.shape[1]):
            acc = acc + g.index_select(0, slot[:, j]).float()
        return acc.to(g.dtype), None, None


def moe_ffn(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_topk: bool = True,
            aux_loss_coef: float = 0.001):
    """x: (B, S, d) -> (out (B, S, d), aux_loss fp32 scalar)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits, gates, ids, pos, keep, cap = route(
        p, xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, norm_topk=norm_topk)

    # ---- capacity slots: each kept choice owns one slot; a dropped one
    # points at a spare slot past the experts' (which holds zeros)
    n_slots = n_experts * cap
    slot = torch.where(keep, ids.reshape(-1) * cap + pos, n_slots)
    token = torch.arange(t, device=x.device).repeat_interleave(top_k)
    token_of_slot = torch.zeros(n_slots + 1, dtype=torch.long,
                                device=x.device).scatter_(0, slot, token)
    used = torch.zeros(n_slots + 1, dtype=torch.bool,
                       device=x.device).scatter_(0, slot, keep)
    token_of_slot, used = token_of_slot[:-1], used[:-1]

    # ---- experts: batched products over the stacked weights
    xe = _Dispatch.apply(xt, token_of_slot, slot.reshape(t, top_k)
                         ).reshape(n_experts, cap, d)
    xe = xe * used.reshape(n_experts, cap, 1).to(xe.dtype)
    h_g = F.silu(torch.bmm(xe, p["w_gate"]))
    h_u = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h_g * h_u, p["w_down"]).reshape(n_slots, d)

    # ---- combine: each token's k gated slot outputs, in rank order, fp32
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    gate = (gates * keep.reshape(t, top_k)).to(ye.dtype)
    slot = slot.reshape(t, top_k)
    acc = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        acc = acc + (ye.index_select(0, slot[:, j]) * gate[:, j:j + 1]).float()
    out = acc.to(ye.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], xt)

    # ---- load-balance auxiliary loss (Switch, arXiv:2101.03961)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.bincount(ids.reshape(-1), minlength=n_experts
                                 ).float() / (t * top_k)
    aux = aux_loss_coef * n_experts * torch.sum(frac_tokens * probs.mean(0))
    return out.reshape(b, s, d), aux


__all__ = ["init_moe", "moe_ffn", "capacity", "route"]
