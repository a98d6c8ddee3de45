"""Plain reference of absorbed multi-head latent attention at decode
(DeepSeek-V3, Kimi-K2): float32 PyTorch, one request at a time, no kernel,
no cache and no batching. Imports nothing but torch.

Each token caches one latent row per layer: ``c_kv`` (``kv_lora_rank``
columns) followed by the shared RoPE key (``qk_rope_head_dim``). With
``W_UK`` absorbed into the query and ``W_UV`` left for after attention,
every query head attends the rows as multi-query attention: K is the whole
row (D = rank + rope), V its first ``rank`` columns (Dv). The query is
q_nope absorbed through ``W_UK`` (rank columns) followed by q_rope.
"""

from __future__ import annotations

import torch


def gather_rows(pool: torch.Tensor, table_row: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` cached rows of one request, [n, D], read from a pool
    of pages ([pages, 1, page, D]) through the request's page table row."""
    page = pool.shape[2]
    ids = table_row[: -(-n // page)].long()
    return pool[ids, 0].reshape(-1, pool.shape[-1])[:n]


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x in float32, first rounded through ``precision``'s storage type."""
    if precision == "fp32":
        return x.float()
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


def decode_request(q: torch.Tensor, rows: torch.Tensor, *, dv: int, scale: float,
                   precision: str = "fp32") -> torch.Tensor:
    """Attention output of one request's decode step, [Hq, nq, Dv] float32.

    ``q`` [Hq, nq, D]: the step's nq query tokens; ``rows`` [n, D]: every
    latent row cached for the request, the step's nq new rows last. Token t
    attends rows [0, n - nq + 1 + t). ``precision`` "fp8" rounds q and the
    rows through float8 e4m3 first (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        hq, nq, _ = q.shape
        n = rows.shape[0]
        k = _round(rows, precision)
        s = torch.einsum("htd,kd->htk", _round(q, precision), k) * scale
        limit = n - nq + 1 + torch.arange(nq, device=q.device)
        keep = torch.arange(n, device=q.device)[None, :] < limit[:, None]
        s = s.masked_fill(~keep[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("htk,kd->htd", p, k[:, :dv])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
