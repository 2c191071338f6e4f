"""RWKV6 "Finch": attention-free time-mix with data-dependent decay
[arXiv:2404.05892], plus the squared-ReLU channel-mix, as in the JAX
package.

Per head (head_dim Dh), the wkv recurrence over time t:

    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (state: [Dh, Dh])
    o_t   = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

with r, k, v, g projections of token-shift mixes of x, and the decay
w_t = exp(-exp(dd_t)) data-dependent via a low-rank MLP on the shifted
input. The output is gated by silu(g) and RMS-normed per channel.

Two WKV paths, chosen by JAX's rule (``time_mix``): a per-token loop and
the chunked form, whose within-chunk contractions are matmuls. Decode
carries (shift, S) state per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, rms_norm


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    n_heads: int  # head_dim = d_model // n_heads
    d_ff: int
    decay_lora: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rwkv_param_specs(cfg: RWKVConfig):
    D, F_, R = cfg.d_model, cfg.d_ff, cfg.decay_lora
    return {
        "time_mix": {
            # token-shift interpolation factors for r/k/v/g/w
            "mu": ParamSpec((5, D), (None, "fsdp"), init="ones", scale=0.5),
            "wr": ParamSpec((D, D), ("fsdp", "tp")),
            "wk": ParamSpec((D, D), ("fsdp", "tp")),
            "wv": ParamSpec((D, D), ("fsdp", "tp")),
            "wg": ParamSpec((D, D), ("fsdp", "tp")),
            "wo": ParamSpec((D, D), ("tp", "fsdp")),
            # data-dependent decay: low-rank MLP
            "decay_a": ParamSpec((D, R), ("fsdp", None), scale=0.1),
            "decay_b": ParamSpec((R, D), (None, "tp"), scale=0.1),
            "decay_bias": ParamSpec((D,), ("tp",), init="zeros"),
            "bonus_u": ParamSpec((D,), ("tp",), init="zeros"),
            "ln_g": ParamSpec((D,), (None,), init="ones"),
        },
        "channel_mix": {
            "mu": ParamSpec((2, D), (None, "fsdp"), init="ones", scale=0.5),
            "wk": ParamSpec((D, F_), ("fsdp", "tp")),
            "wv": ParamSpec((F_, D), ("tp", "fsdp")),
            "wr": ParamSpec((D, D), ("fsdp", "tp")),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one; ``prev`` [B, 1, D] seeds decode."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix(params, cfg: RWKVConfig, x, *, shift_prev=None, state=None,
             chunk: Optional[int] = None):
    """x: [B, S, D]. Returns (y, (last_x, new_state)); ``state`` [B, H, Dh,
    Dh] float32 is the wkv state (decode carries it; prefill starts at 0).
    ``chunk``: block of the chunked path, taken when ``S % chunk == 0`` and
    ``S > 1`` (JAX's rule); otherwise the per-token loop."""
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, shift_prev)
    mu = params["mu"]

    def mix(i):
        return x + (xs - x) * mu[i][None, None, :]

    r = (mix(0) @ params["wr"]).reshape(B, S, H, Dh)
    k = (mix(1) @ params["wk"]).reshape(B, S, H, Dh)
    v = (mix(2) @ params["wv"]).reshape(B, S, H, Dh)
    g = mix(3) @ params["wg"]
    # one three-operand einsum, as in the JAX package: both pick the
    # contraction order by opt_einsum's rule for these shapes
    dd = torch.einsum("bsd,dr,re->bse", mix(4), params["decay_a"],
                      params["decay_b"]) + params["decay_bias"]
    log_w = -torch.exp(dd.float()).reshape(B, S, H, Dh)
    u = params["bonus_u"].reshape(H, Dh)

    if state is None:
        state = torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=x.device)

    if chunk and S % chunk == 0 and S > 1:
        state, o = _wkv_chunked(r, k, v, log_w, u, state, chunk)
    else:
        state, o = _wkv_sequential(r, k, v, torch.exp(log_w), u, state)
    o = o.reshape(B, S, D).to(x.dtype)
    o = rms_norm(o, params["ln_g"])  # group-norm stand-in (per channel), eps 1e-6
    y = (o * F.silu(g)) @ params["wo"]
    return y, (x[:, -1:], state)


def _wkv_sequential(r, k, v, w, u, state):
    """Per-token loop (the paper's dataflow). Shapes [B, S, H, Dh]."""
    S_prev = state
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))  # [B, H, Dh]
        kv = k_t[..., :, None] * v_t[..., None, :]  # [B, H, Dh, Dh]
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, S_prev + u[None, :, :, None] * kv))
        S_prev = w_t[..., None] * S_prev + kv
    return S_prev, torch.stack(outs, dim=1)


def _wkv_chunked(r, k, v, log_w, u, state, chunk: int):
    """Chunked WKV, the same function as the loop:

      o_t = (r_t * exp(A_{t-1})) @ S_0
          + sum_{i<t} (r_t . (k_i * exp(A_{t-1} - A_i))) v_i
          + (r_t * u) . k_t * v_t                       (bonus diagonal)
      S_C = exp(A_C) * S_0 + sum_i (k_i * exp(A_C - A_i)) v_i^T

    with A the within-chunk cumulative log-decay (<= 0, per key channel).
    Every exponent used is a difference A_x - A_i with x >= i, hence <= 0,
    taken from an explicit per-channel pairwise decay tensor [C, C, Dh].
    Above the diagonal those differences are positive and ``exp`` may
    overflow to inf; the select drops them (a product would give NaN)."""
    B, S, H, Dh = r.shape
    n_chunks = S // chunk

    def cf(a):  # [B, S, H, Dh] -> [N, B, C, H, Dh]
        return a.float().reshape(B, n_chunks, chunk, H, Dh).transpose(0, 1)

    rc, kc, vc, lw = cf(r), cf(k), cf(v), cf(log_w)
    # strict causal mask over (t, i)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    S0 = state
    outs = []
    for n in range(n_chunks):
        rb, kb, vb, lwb = rc[n], kc[n], vc[n], lw[n]  # [B, C, H, Dh]
        A = torch.cumsum(lwb, dim=1)  # inclusive
        A_prev = A - lwb  # exclusive
        # pairwise per-channel decay exp(A_{t-1} - A_i), i < t
        diff = A_prev[:, :, None] - A[:, None]  # [B, t, i, H, Dh]
        factor = torch.where(mask[None, :, :, None, None], torch.exp(diff), zero)
        scores = torch.einsum("bthd,bihd,btihd->bhti", rb, kb, factor)
        diag = torch.einsum("bthd,bthd->bth", rb, kb * u[None, None])
        o = (
            torch.einsum("bhti,bihd->bthd", scores, vb)
            + diag[..., None] * vb
            + torch.einsum("bthd,bhdv->bthv", rb * torch.exp(A_prev), S0)
        )
        A_C = A[:, -1:]  # [B, 1, H, Dh]
        k_tail = kb * torch.exp(A_C - A)  # exponents <= 0
        S0 = (torch.exp(A_C[:, 0])[..., None] * S0
              + torch.einsum("bihd,bihv->bhdv", k_tail, vb))
        outs.append(o)
    # [N, B, C, H, Dh] -> [B, S, H, Dh]
    o = torch.stack(outs, dim=0).transpose(0, 1).reshape(B, S, H, Dh)
    return S0, o


def channel_mix(params, cfg: RWKVConfig, x, *, shift_prev=None):
    """Squared-ReLU channel mix; returns (y, last_x)."""
    xs = _token_shift(x, shift_prev)
    mu = params["mu"]
    xk = x + (xs - x) * mu[0][None, None, :]
    xr = x + (xs - x) * mu[1][None, None, :]
    kk = torch.square(torch.relu(xk @ params["wk"]))
    vv = kk @ params["wv"]
    rr = torch.sigmoid(xr @ params["wr"])
    return rr * vv, x[:, -1:]
