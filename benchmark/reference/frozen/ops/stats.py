"""Approximate quantiles via histogram counting (sort-free).

The port of ``bhr_tpu/ops/stats.py``. The normalization stats of the
dynamic disk texture are defined by this counting algorithm (error <=
(hi - lo) / bins), not by an exact percentile, so the port counts the
same way instead of calling ``torch.quantile``. Thresholds are compared
in chunks, so no (N, bins) tensor is materialized.
"""

from __future__ import annotations

import torch

_CHUNK = 16


def _edges(lo, hi, bins: int) -> torch.Tensor:
    """Bin upper edges lo + (hi - lo) * k / bins, k = 1..bins, in f32."""
    k = torch.arange(1, bins + 1, dtype=torch.float32, device=hi.device)
    return lo + (hi - lo) * k / bins


def approx_quantile(
    x: torch.Tensor,
    q: float,
    bins: int = 512,
    lo: float = 0.0,
    hi=None,
    mask=None,
) -> torch.Tensor:
    """Approximate q-quantile of ``x`` (optionally masked), sort-free."""
    flat = x.reshape(-1)
    if hi is None:
        hi = torch.max(flat)
    hi = torch.clamp(torch.as_tensor(hi, dtype=torch.float32, device=x.device),
                     min=lo + 1e-9)
    edges = _edges(lo, hi, bins)

    if mask is not None:
        mflat = mask.reshape(-1)
        n = torch.sum(mflat)
    else:
        mflat = None
        n = flat.shape[0]

    counts = []
    for c0 in range(0, bins, _CHUNK):
        e = edges[c0: c0 + _CHUNK]
        le = flat[:, None] <= e[None, :]
        if mflat is not None:
            le = le & mflat[:, None]
        counts.append(torch.sum(le, dim=0, dtype=torch.int32))
    counts = torch.cat(counts)

    target = q * n
    reached = counts >= target
    idx = torch.argmax(reached.to(torch.int32))
    return torch.where(torch.any(reached), edges[idx], hi)


def approx_quantile_rows(
    x: torch.Tensor, q: float, bins: int = 64, lo: float = 0.0, hi=None
) -> torch.Tensor:
    """Row-wise approximate q-quantiles of an (R, C) array -> (R,)."""
    if hi is None:
        hi = torch.max(x)
    hi = torch.clamp(torch.as_tensor(hi, dtype=torch.float32, device=x.device),
                     min=lo + 1e-9)
    edges = _edges(lo, hi, bins)
    counts = []
    for c0 in range(0, bins, _CHUNK):
        e = edges[c0: c0 + _CHUNK]
        counts.append(torch.sum(x[:, :, None] <= e[None, None, :], dim=1,
                                dtype=torch.int32))
    counts = torch.cat(counts, dim=1)  # (R, B)
    target = q * x.shape[1]
    reached = counts >= target
    idx = torch.argmax(reached.to(torch.int32), dim=1)
    vals = edges[idx]
    return torch.where(torch.any(reached, dim=1), vals, hi)
