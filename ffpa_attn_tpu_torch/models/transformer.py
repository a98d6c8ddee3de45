"""FFPA transformer LM: a decoder-only model whose attention layers use the
large-head-dim kernels.

``Transformer`` holds the weights as an ``nn.Module``; the serving path
(``generate.py``) runs its layers. The training forward and loss come with
the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from ..env import resolve_device


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
    # Used by the training slice's backward; kept so configs carry across.
    attn_save_scores: bool = False
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


__all__ = ["ModelConfig", "Block", "Transformer"]
