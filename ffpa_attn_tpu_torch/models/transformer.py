"""FFPA transformer LM: a decoder-only model whose attention layers use the
large-head-dim kernels.

``Transformer`` holds the weights as an ``nn.Module``; the serving path
(``generate.py``) runs its layers. The training path is ``forward`` ->
``loss_fn`` -> ``make_train_step``, whose attention backward runs the
backward kernels under ``torch.autograd``.

With a mesh (``parallel.make_mesh``) the same step runs on every rank:

* **dp** splits the batch;
* **tp** is Megatron-style: ``shard_params`` keeps each rank's heads of
  ``wq`` / ``wk`` / ``wv`` and its columns of ``w_up`` / ``w_gate`` (weight
  dim 0) and the matching rows of ``wo`` / ``w_down`` (weight dim 1); the
  column-parallel projections take an identity-forward, all-reduce-backward
  op on their input and the row-parallel ones an all-reduce on their
  output;
* **sp** keeps the rank's tokens through the whole layer (norms, MLP and
  logits are per token); only attention talks to the other ranks: the
  zigzag ring where N % (2 sp) == 0 (the step lays the tokens, their
  positions and targets out in zigzag order), the causal ring over
  contiguous shards otherwise, and the halo exchange for a sliding-window
  model.

The loss is the global mean (each rank's summed negative log-likelihood
all-reduced over dp x sp, over the global token count), every gradient is
all-reduced over dp x sp (the per-head sinks' also over tp, from each tp
rank's zero-padded part), and AdamW updates each rank's shard as the
single-card step does. With no mesh, or every axis of size 1, the
single-card code runs unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..env import resolve_device
from ..functional import CudaBackend
from ..interface import ffpa_attn_func
from ..parallel._collectives import copy_to, reduce_from
from ..parallel.mesh import axis_group, axis_rank, axis_size


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


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The JAX package's ``init_params``: a JAX-layout parameter pytree in
    ``cfg.dtype`` (sinks fp32) on ``generator``'s device, normal weights
    scaled by 1/sqrt(fan_in) (the embedding by 0.02), norms at one, sinks
    at zero, drawn from ``generator`` (the values are not JAX's: the two
    generators differ). ``params_from_jax`` loads it into a
    ``Transformer``."""
    dev, dt = generator.device, cfg.torch_dtype

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dt)

    dm, dh = cfg.d_model, cfg.head_dim
    hidden = cfg.mlp_ratio * dm
    params = {"embed": dense((cfg.vocab_size, dm), scale=0.02),
              "final_norm": torch.ones(dm, device=dev, dtype=dt), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones(dm, device=dev, dtype=dt),
            "wq": dense((dm, cfg.n_heads * dh)),
            "wk": dense((dm, cfg.n_kv_heads * dh)),
            "wv": dense((dm, cfg.n_kv_heads * dh)),
            "wo": dense((cfg.n_heads * dh, dm)),
            "mlp_norm": torch.ones(dm, device=dev, dtype=dt),
            "w_up": dense((dm, hidden)),
            "w_gate": dense((dm, hidden)),
            "w_down": dense((hidden, dm)),
        }
        if cfg.attn_sinks:
            layer["attn_sinks"] = torch.zeros(cfg.n_heads, device=dev, dtype=torch.float32)
        params["layers"].append(layer)
    return params


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
    # -1 heads: all of them, or a tp rank's (``shard_params``).
    q = layer.wq(x).reshape(b, n, -1, dh).transpose(1, 2)
    k = layer.wk(x).reshape(b, n, -1, dh).transpose(1, 2)
    v = layer.wv(x).reshape(b, n, -1, dh).transpose(1, 2)
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


@dataclass(frozen=True)
class _Shards:
    """A mesh step's process groups (None for an axis of size 1) and this
    rank's index along each axis."""

    dp: object
    tp: object
    sp: object
    dp_size: int
    tp_size: int
    sp_size: int
    dp_rank: int
    tp_rank: int
    sp_rank: int


def _shards(mesh, sp_axis, tp_axis, dp_axis) -> Optional[_Shards]:
    """The step's groups, or None where the single-card code runs (no
    mesh, or every axis of size 1)."""
    names = (dp_axis, tp_axis, sp_axis)
    sizes = [axis_size(mesh, a) for a in names]
    if mesh is None or all(s == 1 for s in sizes):
        return None
    return _Shards(*(axis_group(mesh, a) for a in names), *sizes,
                   *(axis_rank(mesh, a) for a in names))


def _sp_layout(cfg: ModelConfig, n: int, sp: int) -> str:
    """How sp shards a sequence of n tokens: "window" (halo exchange over
    contiguous shards), "zigzag" (chunk pairs, n % (2 sp) == 0) or "ring"
    (the causal ring over contiguous shards)."""
    if cfg.sliding_window > 0:
        return "window"
    return "zigzag" if n % (2 * sp) == 0 else "ring"


def _sharded_attention(layer: Block, x, cfg: ModelConfig, sh: _Shards, positions):
    """One layer's attention on this rank's tokens [B, Nl, dm] and heads."""
    from ..parallel.ring import ring_attention
    from ..parallel.window import window_attention
    from ..parallel.zigzag import zigzag_ring_attention

    b, nl, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads // sh.tp_size, cfg.n_kv_heads // sh.tp_size
    if layer.wq.weight.shape[0] != hq * dh or layer.wk.weight.shape[0] != hkv * dh:
        raise ValueError("the model's projections are not this mesh's tp shards: "
                         "call shard_params(model, mesh, cfg) first")
    q, k, v = _project_qkv(layer, copy_to(x, sh.tp), cfg, positions)
    sinks = None
    if cfg.attn_sinks:
        sinks = layer.attn_sinks[sh.tp_rank * hq:(sh.tp_rank + 1) * hq]
    if sh.sp_size > 1:
        layout = _sp_layout(cfg, nl * sh.sp_size, sh.sp_size)
        if layout == "window":
            o = window_attention(q, k, v, group=sh.sp, window_left=cfg.sliding_window,
                                 softcap=cfg.attn_softcap, sinks=sinks)
        elif cfg.attn_softcap > 0.0 or cfg.attn_sinks:
            raise NotImplementedError(
                "attn_softcap/attn_sinks without a sliding window are not "
                "wired through the sequence-parallel ring (its per-step "
                "partial softmaxes cannot host them); set sliding_window "
                "or run without sp"
            )
        elif layout == "zigzag":
            o = zigzag_ring_attention(q, k, v, group=sh.sp)
        else:
            o = ring_attention(q, k, v, group=sh.sp, causal=True)
    else:
        extra = _feature_kwargs(cfg, layer)
        if sinks is not None:
            extra["sinks"] = sinks
        o = ffpa_attn_func(
            q, k, v, is_causal=True, enable_gqa=cfg.n_heads != cfg.n_kv_heads,
            backward_backend=CudaBackend(save_scores=cfg.attn_save_scores), **extra,
        )
    return reduce_from(layer.wo(o.transpose(1, 2).reshape(b, nl, hq * dh)), sh.tp)


def forward(model: Transformer, tokens, mesh=None, sp_axis: Optional[str] = None,
            tp_axis: str = "tp", positions=None):
    """LM forward: tokens [B, N] int -> logits [B, N, vocab].

    Under a mesh with an axis above 1, ``tokens`` are this rank's
    [B / dp, N / sp] in the step's layout (``_local_tokens``) and
    ``positions`` their global positions; the logits are this rank's."""
    sh = _shards(mesh, sp_axis, tp_axis, None)
    if sh is None:
        def attend(layer, h):
            return _attention(layer, h, model.cfg)
        mlp = _mlp
    else:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)

        def attend(layer, h):
            return _sharded_attention(layer, h, model.cfg, sh, positions)

        def mlp(layer, h):  # column-parallel up / gate, row-parallel down
            return reduce_from(_mlp(layer, copy_to(h, sh.tp)), sh.tp)
    x = model.embed[tokens]
    for layer in model.layers:
        x = x + attend(layer, _rmsnorm(x, layer.attn_norm))
        x = x + mlp(layer, _rmsnorm(x, layer.mlp_norm))
    return _rmsnorm(x, model.final_norm) @ model.embed.T


def _local_tokens(tokens, cfg: ModelConfig, sh: _Shards):
    """This rank's (inputs, targets, positions) of the global tokens
    [B, N + 1]: its B / dp rows, and its N / sp tokens of the sp layout (the
    zigzag order where ``_sp_layout`` says so, contiguous otherwise)."""
    from ..parallel.zigzag import zigzag_shuffle

    b, n = tokens.shape[0], tokens.shape[1] - 1
    if b % sh.dp_size or n % sh.sp_size:
        raise ValueError(f"tokens [{b}, {n + 1}] do not split over dp={sh.dp_size}, "
                         f"sp={sh.sp_size} (B % dp and N % sp must be 0)")
    rows = tokens[sh.dp_rank * (b // sh.dp_size):(sh.dp_rank + 1) * (b // sh.dp_size)]
    inputs, targets = rows[:, :-1], rows[:, 1:]
    positions = torch.arange(n, device=tokens.device)
    if sh.sp_size > 1:
        if _sp_layout(cfg, n, sh.sp_size) == "zigzag":
            inputs, targets, positions = (zigzag_shuffle(t, sh.sp_size, axis=t.dim() - 1)
                                          for t in (inputs, targets, positions))
        nl = n // sh.sp_size
        cut = slice(sh.sp_rank * nl, (sh.sp_rank + 1) * nl)
        inputs, targets, positions = inputs[:, cut], targets[:, cut], positions[cut]
    return inputs, targets, positions


def loss_fn(model: Transformer, tokens, mesh=None, sp_axis: Optional[str] = None,
            dp_axis: Optional[str] = "dp"):
    """Mean next-token cross entropy of tokens [B, N + 1], in fp32.

    Under a mesh every rank passes the same global tokens and gets the
    global mean; its gradient reaches only this rank's share (the step sums
    the gradients over dp x sp)."""
    sh = _shards(mesh, sp_axis, "tp", dp_axis)
    if sh is None:
        logits = forward(model, tokens[:, :-1])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, tokens[:, 1:, None])[..., 0].mean()
    inputs, targets, positions = _local_tokens(tokens, model.cfg, sh)
    logits = forward(model, inputs, mesh, sp_axis, positions=positions)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0].sum()
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    return reduce_from(reduce_from(nll, sh.dp), sh.sp) / count


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


def _all_reduce_grads(model: Transformer, sh: _Shards) -> None:
    """Sum every gradient over dp x sp (in fp32), the sinks' also over tp."""
    sinks = {id(layer.attn_sinks) for layer in model.layers if layer.attn_sinks is not None}
    for p in model.parameters():
        groups = [sh.dp, sh.sp] + ([sh.tp] if id(p) in sinks else [])
        groups = [g for g in groups if g is not None]
        if groups:
            g32 = p.grad.float()
            for g in groups:
                dist.all_reduce(g32, group=g)
            p.grad = g32.to(p.grad.dtype)


def make_train_step(cfg: ModelConfig, optimizer: _AdamW, device=None, mesh=None,
                    sp_axis: Optional[str] = None, dp_axis: Optional[str] = "dp") -> Callable:
    """A train step on ``device`` (CUDA unless asked otherwise):
    ``step(model, opt_state, tokens) -> (opt_state, loss)``. The loss and
    gradients come from ``loss_fn`` under ``torch.autograd``; each
    parameter is updated in place as ``(p.float() + u).to(p.dtype)``, as
    the JAX step updates its bf16 params. ``opt_state`` is
    ``optimizer.init(list(model.parameters()))``.

    With ``mesh`` (axes ``dp_axis``, ``"tp"`` and ``sp_axis``; any may be
    absent) every rank calls the step with the same global tokens and its
    ``shard_params`` model (the optimizer state initialised after the
    sharding); dp on the batch, tp inside the projections, sp inside
    attention, the gradients summed as the module docstring says."""
    dev = resolve_device(device)
    sh = _shards(mesh, sp_axis, "tp", dp_axis)

    def step(model: Transformer, opt_state: dict, tokens):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        params = list(model.parameters())
        if params[0].device.type != dev.type:
            raise ValueError(f"the model is on {params[0].device}, the step on {dev}")
        tokens = torch.as_tensor(tokens, device=params[0].device)
        for p in params:
            p.grad = None
        if sh is None:
            loss = loss_fn(model, tokens)
            loss.backward()
        else:
            loss = loss_fn(model, tokens, mesh, sp_axis, dp_axis)
            loss.backward()
            _all_reduce_grads(model, sh)
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
    "init_params",
    "forward",
    "loss_fn",
    "adamw",
    "make_train_step",
]
