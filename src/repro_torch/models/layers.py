"""Shared building blocks over plain param dicts (counterpart of
``repro.models.layers``).

Weights keep the reference's layout so the bridge copies them as they
are: a linear layer's ``w`` is ``(d_in, d_out)`` and is applied as
``x @ w``; LoRA adds ``(x @ lora_a) @ lora_b * lora_scale``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: Optional[float] = None,
                dtype=torch.float32, device="cpu", lora_rank: int = 0,
                lora_alpha: float = 16.0) -> Params:
    """A linear layer, optionally with a LoRA adapter (A: d_in x r, B: r x
    d_out; W_eff = W + (alpha / r) A @ B, B zero so training starts at W)."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p: Params = {"w": normal_init(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    if lora_rank > 0:
        p["lora_a"] = normal_init(gen, (d_in, lora_rank),
                                  1.0 / math.sqrt(d_in), dtype, device)
        p["lora_b"] = torch.zeros((lora_rank, d_out), dtype=dtype,
                                  device=device)
        p["lora_scale"] = torch.tensor(lora_alpha / lora_rank, dtype=dtype,
                                       device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Apply a (possibly LoRA-augmented) linear layer."""
    y = x @ p["w"]
    if "lora_a" in p:
        y = y + (x @ p["lora_a"]) @ p["lora_b"] * p["lora_scale"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, *,
                dtype=torch.float32, device="cpu", lora_rank: int = 0) -> Params:
    kw = dict(dtype=dtype, device=device, lora_rank=lora_rank)
    return {"gate": init_linear(gen, d_model, d_ff, **kw),
            "up": init_linear(gen, d_model, d_ff, **kw),
            "down": init_linear(gen, d_ff, d_model, **kw)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(key: tuple, device, make) -> torch.Tensor:
    """A small constant tensor, made once per device and kept. Making it
    anew on the card copies a host scalar or list per call, and each such
    copy waits for the stream: a host sync in every layer of every step.
    Callers must not modify the tensor."""
    k = key + (str(torch.device(device)),)
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = make(device)
    return t


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    """Inverse frequencies for RoPE (arXiv:2104.09864), fp32."""
    def make(dev):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=dev) / head_dim
        return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=dev), exps)
    return _const(("rope", head_dim, float(theta)), device, make)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by ``positions`` [..., S].

    Half-split (x1, x2) convention, angles in fp32 as the reference
    computes them: positions reach 1e4-1e5 at rope_theta 5e5, where a
    bf16 angle would be wrong in its first digit.
    """
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., :, None].float() * inv                # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(n_heads: int, device="cpu") -> torch.Tensor:
    """Standard geometric ALiBi slopes (arXiv:2108.12409), fp32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2_slopes(closest)
        s = s + pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return _const(("alibi", n_heads), device,
                  lambda dev: torch.tensor(s, dtype=torch.float32, device=dev))


__all__ = ["Params", "normal_init", "init_linear", "dense", "init_rmsnorm",
           "rmsnorm", "init_swiglu", "swiglu", "rope_freqs", "apply_rope",
           "alibi_slopes"]
