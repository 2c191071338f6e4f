"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), as
in the JAX package.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    a_t = a^(c * r_t)      a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in Griffin's recurrent block: two linear branches (width d_rnn),
one gated by GeLU (the tanh form, ``jax.nn.gelu``'s default), the other
passed through a short causal conv1d (width 4) and the RG-LRU; merged
multiplicatively and projected out. The recurrence is diagonal: an O(S)
loop over time with O(d_rnn) state.

``a`` is rounded once from a float64 exp (``_decay``): where ``a`` lies
within a few ulps of 1 (every channel whose gate r is small, with the
JAX init's lambda), ``1 - a^2`` is a multiple of 2^-24 and
``sqrt(max(1 - a^2, 1e-12))`` moves by up to 2^-12 with ``a``'s last bit.
The card's float32 exp and the host's round that bit differently (the
logits of recurrentgemma-2b's first layers then differ by 1.4% of their
largest); rounded from float64, they agree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec

_C = 8.0
_LOG_A_INIT = -8.0  # softplus-param of Lambda; a ~ sigmoid(8) ~ 0.9997


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int  # recurrent width (RecurrentGemma: lru_width = d_model)
    conv_width: int = 4


def rglru_param_specs(cfg: RGLRUConfig):
    D, R = cfg.d_model, cfg.d_rnn
    return {
        "w_in_gate": ParamSpec((D, R), ("fsdp", "tp")),
        "w_in_rnn": ParamSpec((D, R), ("fsdp", "tp")),
        "conv_w": ParamSpec((cfg.conv_width, R), (None, "tp"), scale=0.5),
        "conv_b": ParamSpec((R,), ("tp",), init="zeros"),
        "gate_a": ParamSpec((R, R), ("tp", None), scale=0.5),
        "gate_x": ParamSpec((R, R), ("tp", None), scale=0.5),
        "lambda_p": ParamSpec((R,), ("tp",), init="ones", scale=1.0),
        "w_out": ParamSpec((R, D), ("tp", "fsdp")),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            prev: Optional[torch.Tensor]):
    """Causal depthwise conv of width K, its taps summed left to right.
    x [B, S, R]; prev [B, K-1, R] carries the decode state. Returns (out,
    the last K-1 inputs)."""
    K = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)  # [B, S+K-1, R]
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return out + b, xp[:, -(K - 1):]


def _decay(log_a: torch.Tensor) -> torch.Tensor:
    """a = exp(log_a) in float32, correctly rounded (see the module
    docstring); log_a is first taken to float32, as in JAX."""
    return torch.exp(log_a.float().double()).float()


def rglru_block(params, cfg: RGLRUConfig, x, *, conv_prev=None, h_prev=None):
    """x: [B, S, D] -> (y, (conv_state, h_state)); h is float32."""
    B, S, _ = x.shape
    gate_branch = F.gelu(x @ params["w_in_gate"], approximate="tanh")
    rnn_in = x @ params["w_in_rnn"]
    rnn_in, conv_state = _conv1d(rnn_in, params["conv_w"], params["conv_b"], conv_prev)

    r = torch.sigmoid(rnn_in @ params["gate_a"])
    i = torch.sigmoid(rnn_in @ params["gate_x"])
    log_a = -_C * r * F.softplus(_LOG_A_INIT * params["lambda_p"]).to(r.dtype)
    a = _decay(log_a)
    gated = (i * rnn_in).float()
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    u = mult * gated

    h = h_prev if h_prev is not None else torch.zeros(
        (B, cfg.d_rnn), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)  # [B, S, R]
    y = (hs * gate_branch) @ params["w_out"]
    return y, (conv_state, h)
