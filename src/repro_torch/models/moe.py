"""Mixture-of-Experts FFN: shared + routed experts, top-k routing with
GShard-style grouped capacity dispatch, as in the JAX package.

Tokens are routed within a group: prefill passes one group per sequence
([batch, seq, D]), decode one group of the batch's tokens ([1, batch, D]).
Each group has a local expert capacity C = max(int(cf * S * K / E), 4);
assignments past it are dropped (Switch/GShard behaviour). Dispatch and
combine are 0/1 tensors [G, S, E, C] contracted with einsums, and every
expert runs on its C slots of every group, used or not: the JAX package's
formulation, kept as it is so the two compute the same function.

Three spellings keep the port's routing equal to JAX's:
  * ties: ``jax.lax.top_k`` puts the lower index first among equal values,
    and ``torch.topk`` promises no order, so the top K come from a stable
    descending sort;
  * overflow: ``jax.nn.one_hot(slot, C)`` gives a zero row for a slot past
    the capacity (a dropped assignment) where ``F.one_hot`` raises, so the
    one-hots are comparisons with ``arange``;
  * grouping: capacity depends on the group, so callers keep JAX's groups.

Experts' sharding modes (``shard_mode`` "ep" / "tp") only label the
logical axes of the parameter specs; on one card nothing reads them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int  # FFN hidden dim of each routed expert
    n_experts: int
    top_k: int
    n_shared: int = 0  # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    shard_mode: str = "ep"  # "ep" | "tp"


def moe_param_specs(cfg: MoEConfig):
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_expert
    if cfg.shard_mode == "ep":
        e_axes = ("tp", "fsdp", None)
        e_axes_out = ("tp", None, "fsdp")
    else:  # tp-inside-expert
        e_axes = (None, "fsdp", "tp")
        e_axes_out = (None, "tp", "fsdp")
    specs = {
        "router": ParamSpec((D, E), ("fsdp", None), scale=0.1),
        "w_gate": ParamSpec((E, D, F_), e_axes),
        "w_up": ParamSpec((E, D, F_), e_axes),
        "w_down": ParamSpec((E, F_, D), e_axes_out),
    }
    if cfg.n_shared:
        specs["shared_gate"] = ParamSpec((cfg.n_shared, D, F_), (None, "fsdp", "tp"))
        specs["shared_up"] = ParamSpec((cfg.n_shared, D, F_), (None, "fsdp", "tp"))
        specs["shared_down"] = ParamSpec((cfg.n_shared, F_, D), (None, "tp", "fsdp"))
    return specs


def capacity(cfg: MoEConfig, group_size: int) -> int:
    """Slots per expert in a group of ``group_size`` tokens."""
    return max(int(cfg.capacity_factor * group_size * cfg.top_k / cfg.n_experts), 4)


class Routing(NamedTuple):
    """One group-batch's routing: ``probs`` f32 [G, S, E]; ``top_p`` (the
    top K renormalized) and ``top_e`` int64 [G, S, K], best first;
    ``onehot`` [G, S, K, E] every assignment, ``in_cap`` the kept ones;
    ``dispatch`` / ``combine`` [G, S, E, C]."""

    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    onehot: torch.Tensor
    in_cap: torch.Tensor
    dispatch: torch.Tensor
    combine: torch.Tensor


def route(params, cfg: MoEConfig, x: torch.Tensor) -> Routing:
    """Router, softmax, top-k and the choice-major capacity queue of x
    [G, S, D] (all k = 0 choices first: Switch prioritization)."""
    G, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    logits = torch.einsum("gsd,de->gse", x, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = sorted_p[..., :K], order[..., :K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    experts = torch.arange(E, device=x.device)
    onehot = (top_e[..., None] == experts).float()  # [G, S, K, E]
    # queue position of each assignment in its expert, choice-major order
    flat = onehot.transpose(1, 2).reshape(G, K * S, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, K, S, E).transpose(1, 2)
    in_cap = (pos < C).float() * onehot
    slot = torch.einsum("gske,gske->gsk", pos, onehot).long()
    slot_oh = (slot[..., None] == torch.arange(C, device=x.device)).float()  # [G, S, K, C]
    dispatch = torch.einsum("gske,gskc->gsec", in_cap, slot_oh).to(x.dtype)
    combine = torch.einsum("gsk,gske,gskc->gsec", top_p, in_cap, slot_oh).to(x.dtype)
    return Routing(probs, top_p, top_e, onehot, in_cap, dispatch, combine)


def moe_ffn(params, cfg: MoEConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, S, D] -> (y [G, S, D], aux_loss). Groups are dispatch-local:
    callers pass [batch, seq, D] for prefill and [1, batch, D] for decode."""
    G, S, D = x.shape
    E = cfg.n_experts
    r = route(params, cfg, x)
    C = r.dispatch.shape[-1]
    xe = torch.einsum("gsec,gsd->egcd", r.dispatch, x)  # [E, G, C, D]
    he = _swiglu_experts(xe.reshape(E, G * C, D), params).reshape(E, G, C, D)
    y = torch.einsum("gsec,egcd->gsd", r.combine, he)
    for i in range(cfg.n_shared):
        y = y + swiglu(x, params["shared_gate"][i], params["shared_up"][i],
                       params["shared_down"][i])
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    f_e = r.onehot[:, :, 0, :].mean(dim=(0, 1))  # top-1 routing fraction
    p_e = r.probs.mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(f_e * p_e)
    return y, aux.float()


def _swiglu_experts(xe: torch.Tensor, params) -> torch.Tensor:
    """Per-expert SwiGLU: xe [E, T, D] with stacked weights [E, D, F]."""
    g = F.silu(torch.bmm(xe, params["w_gate"]))
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(g * u, params["w_down"])
