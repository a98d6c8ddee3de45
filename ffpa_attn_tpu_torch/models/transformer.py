"""FFPA transformer LM: a decoder-only model whose attention layers use the
large-head-dim kernels.

``Transformer`` holds the weights as an ``nn.Module``; the serving path
(``generate.py``) runs its layers. The training path is ``forward`` ->
``loss_fn`` -> ``make_train_step``, whose attention backward runs the
backward kernels under ``torch.autograd``. The single-card branch only: the
mesh / sequence- and tensor-parallel branches wait for ``parallel/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..env import resolve_device
from ..functional import CudaBackend
from ..interface import ffpa_attn_func


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 512  # large head dim: the FFPA regime
    mlp_ratio: int = 4
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    # The attention backward's S residency (``CudaBackend.save_scores``):
    # False, the default as in the JAX model, takes the dS-handoff backward
    # (every layer's N^2 residual would stay live from forward to backward);
    # True keeps every head's S residual and takes the S-resident backward;
    # None lets the auto policy pick per call (a port extension; the JAX
    # model's flag is a bool).
    attn_save_scores: Optional[bool] = False
    # sliding_window = causal left-window width in tokens (0 = full
    # attention); attn_softcap = logit cap (0 = off); attn_sinks = learnable
    # per-head sink logits.
    sliding_window: int = 0
    attn_softcap: float = 0.0
    attn_sinks: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def mistral_like(cls, sliding_window: int = 4096, **kw) -> "ModelConfig":
        """Causal sliding-window attention (Mistral-7B-style)."""
        return cls(sliding_window=sliding_window, **kw)

    @classmethod
    def gemma2_like(cls, sliding_window: int = 4096,
                    attn_softcap: float = 50.0, **kw) -> "ModelConfig":
        """Logit soft-capping + sliding window (Gemma-2-style)."""
        return cls(
            sliding_window=sliding_window, attn_softcap=attn_softcap, **kw
        )

    @classmethod
    def gpt_oss_like(cls, sliding_window: int = 128, **kw) -> "ModelConfig":
        """Learnable attention sinks + sliding window (gpt-oss-style)."""
        return cls(sliding_window=sliding_window, attn_sinks=True, **kw)


class Block(nn.Module):
    """One decoder layer's weights. Projections are ``nn.Linear`` (weight
    [out, in]); the model computes ``x @ weight.T``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dm, dh, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
        kw = dict(bias=False, device=device, dtype=dt)
        self.attn_norm = nn.Parameter(torch.ones(dm, device=device, dtype=dt))
        self.wq = nn.Linear(dm, cfg.n_heads * dh, **kw)
        self.wk = nn.Linear(dm, cfg.n_kv_heads * dh, **kw)
        self.wv = nn.Linear(dm, cfg.n_kv_heads * dh, **kw)
        self.wo = nn.Linear(cfg.n_heads * dh, dm, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(dm, device=device, dtype=dt))
        self.w_up = nn.Linear(dm, cfg.mlp_ratio * dm, **kw)
        self.w_gate = nn.Linear(dm, cfg.mlp_ratio * dm, **kw)
        self.w_down = nn.Linear(cfg.mlp_ratio * dm, dm, **kw)
        self.attn_sinks = (
            nn.Parameter(torch.zeros(cfg.n_heads, device=device, dtype=torch.float32))
            if cfg.attn_sinks else None
        )


class Transformer(nn.Module):
    """The model's weights: token embedding (tied with the output head),
    ``n_layers`` blocks and the final norm. Built on ``device`` (CUDA
    unless the caller asks for another)."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device, None] = None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.d_model, device=dev).mul_(0.02).to(cfg.torch_dtype)
        )
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=dev, dtype=cfg.torch_dtype))
        self.layers = nn.ModuleList(Block(cfg, device=dev) for _ in range(cfg.n_layers))


def _rmsnorm(x, w, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope(x, positions, base=10000.0):
    """Rotary embedding over the last dim (applied per head)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        base ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., None].float() * freqs  # [..., N, half]
    cos = torch.cos(angles)[None, None]
    sin = torch.sin(angles)[None, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def _mlp(layer: Block, x):
    up = layer.w_up(x)
    gate = F.silu(layer.w_gate(x))
    return layer.w_down(up * gate)


def _feature_kwargs(cfg: ModelConfig, layer: Block, *, window: bool = True) -> dict:
    """ffpa_attn_func extras for the model's attention features.

    ``window=False`` omits window_size where the window is realized through
    the validity bias instead (decode over a cache longer than the current
    position)."""
    extra = {}
    if window and cfg.sliding_window > 0:
        extra["window_size"] = (cfg.sliding_window, -1)
    if cfg.attn_softcap > 0.0:
        extra["softcap"] = cfg.attn_softcap
    if cfg.attn_sinks:
        extra["sinks"] = layer.attn_sinks
    return extra


def _project_qkv(layer: Block, x, cfg: ModelConfig, positions):
    b, n, _ = x.shape
    dh = cfg.head_dim
    q = layer.wq(x).reshape(b, n, cfg.n_heads, dh).transpose(1, 2)
    k = layer.wk(x).reshape(b, n, cfg.n_kv_heads, dh).transpose(1, 2)
    v = layer.wv(x).reshape(b, n, cfg.n_kv_heads, dh).transpose(1, 2)
    return _rope(q, positions), _rope(k, positions), v


def _attention(layer: Block, x, cfg: ModelConfig):
    """One layer's causal self-attention on the normed input [B, N, dm]."""
    b, n, _ = x.shape
    q, k, v = _project_qkv(layer, x, cfg, torch.arange(n, device=x.device))
    o = ffpa_attn_func(
        q, k, v, is_causal=True, enable_gqa=cfg.n_heads != cfg.n_kv_heads,
        backward_backend=CudaBackend(save_scores=cfg.attn_save_scores),
        **_feature_kwargs(cfg, layer),
    )
    return layer.wo(o.transpose(1, 2).reshape(b, n, cfg.n_heads * cfg.head_dim))


def forward(model: Transformer, tokens):
    """LM forward: tokens [B, N] int -> logits [B, N, vocab]."""
    x = model.embed[tokens]
    for layer in model.layers:
        x = x + _attention(layer, _rmsnorm(x, layer.attn_norm), model.cfg)
        x = x + _mlp(layer, _rmsnorm(x, layer.mlp_norm))
    return _rmsnorm(x, model.final_norm) @ model.embed.T


def loss_fn(model: Transformer, tokens):
    """Mean next-token cross entropy of tokens [B, N + 1], in fp32."""
    logits = forward(model, tokens[:, :-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None])[..., 0].mean()


class _AdamW:
    """``optax.adamw`` as a pair of functions over a list of tensors:
    ``init(params)`` -> state; ``update(grads, state, params)`` -> (fp32
    updates, state), with ``u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
    The moments are kept in fp32 (optax keeps them in the params' dtype)."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = learning_rate, b1, b2, eps, weight_decay

    def init(self, params) -> dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        }

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        updates = []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            g = g.float()
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / c1) / ((nu / c2).sqrt_().add_(self.eps))
            updates.append(u.add_(p.float(), alpha=self.wd).mul_(-self.lr))
        return updates, dict(state, count=count)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> _AdamW:
    """AdamW with ``optax.adamw``'s defaults (weight decay 1e-4, where
    ``torch.optim.AdamW`` has 0.01)."""
    return _AdamW(learning_rate, b1, b2, eps, weight_decay)


def make_train_step(cfg: ModelConfig, optimizer: _AdamW, device=None) -> Callable:
    """A train step on ``device`` (CUDA unless asked otherwise):
    ``step(model, opt_state, tokens) -> (opt_state, loss)``. The loss and
    gradients come from ``loss_fn`` under ``torch.autograd``; each
    parameter is updated in place as ``(p.float() + u).to(p.dtype)``, as
    the JAX step updates its bf16 params. ``opt_state`` is
    ``optimizer.init(list(model.parameters()))``."""
    dev = resolve_device(device)

    def step(model: Transformer, opt_state: dict, tokens):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        params = list(model.parameters())
        if params[0].device.type != dev.type:
            raise ValueError(f"the model is on {params[0].device}, the step on {dev}")
        tokens = torch.as_tensor(tokens, device=params[0].device)
        for p in params:
            p.grad = None
        loss = loss_fn(model, tokens)
        loss.backward()
        updates, opt_state = optimizer.update([p.grad for p in params], opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.copy_((p.float() + u).to(p.dtype))
        return opt_state, loss.detach()

    return step


__all__ = [
    "ModelConfig",
    "Block",
    "Transformer",
    "forward",
    "loss_fn",
    "adamw",
    "make_train_step",
]
