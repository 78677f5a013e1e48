"""KV aggregation strategies (eq. 20 full concat; eq. 37-38 sparse exchange).

Port of ``contribution_mask`` from the JAX package's ``core/aggregation.py``.
At a sync layer each participant contributes (a subset of) its local KV
rows; in the single-device semantics the exchange is a visibility mask:
query ``i`` may attend key ``j`` iff they share a participant or ``j`` was
contributed this round.

Selection strategies: ``strided``, ``recency``, ``sink_recency``,
``keynorm`` and ``attnmass`` reproduce the JAX masks exactly. ``random``
draws i.i.d. Bernoulli(ratio) bits from a ``torch.Generator`` — JAX's
threefry bits have no torch counterpart, so only the keep ratio and
seed-determinism carry over. ``attnmass`` keeps the rows with the most
accumulated decode-step softmax mass (the paged decode's ``return_mass``
by-product); with no stats yet (prefill admission) it falls back to
recency, and the pooled decode derives its per-step masks from the live
accumulator through :func:`decode_exchange_mask`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.partition import Partition


def contribution_mask(
    partition: Partition,
    ratio: float,
    selection: str,
    *,
    generator: Optional[torch.Generator] = None,
    round_index: int = 0,
    keys: Optional[torch.Tensor] = None,
    attn_mass: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(L,) bool — which global token positions are contributed (eq. 38).

    Args:
      partition: the participant partition.
      ratio: kv_exchange_ratio in (0, 1]. 1.0 → all True.
      selection: strategy name (see module docstring).
      generator: source of the Bernoulli bits for 'random'; required there.
        Each call draws a fresh round from it, so rounds resample
        independently.
      round_index: communication round t (decorrelates 'strided' rounds).
      keys: (L, n_kv, d_head) or (L, d) Key rows for 'keynorm'.
      attn_mass: accumulated per-position attention mass for 'attnmass'
        (None before any decode step: recency).
    """
    seg = partition.segment_ids
    L = partition.seq_len
    if ratio >= 1.0:
        return torch.ones((L,), dtype=torch.bool, device=seg.device)

    if selection == "random":
        if generator is None:
            raise ValueError("selection='random' requires a generator")
        u = torch.rand((L,), generator=generator, device=generator.device)
        return (u < ratio).to(seg.device)

    local_pos = _local_positions(seg, partition.n_participants)
    my_size = partition.sizes().to(torch.int32)[seg.long()]  # (L,)
    keep_n = torch.clamp(
        torch.ceil(my_size.to(torch.float32) * ratio).to(torch.int32), min=1
    )

    if selection == "strided":
        stride = torch.clamp((my_size + keep_n - 1) // keep_n, min=1)
        phase = round_index % 7  # decorrelate rounds
        return (local_pos + phase) % stride == 0
    if selection == "recency":
        return local_pos >= (my_size - keep_n)
    if selection == "sink_recency":
        n_sink = torch.clamp(keep_n // 4, min=1)
        n_rec = keep_n - n_sink
        return (local_pos < n_sink) | (local_pos >= (my_size - n_rec))
    if selection == "keynorm":
        if keys is None:
            raise ValueError("selection='keynorm' requires keys")
        norms = torch.linalg.vector_norm(
            keys.reshape(L, -1).to(torch.float32), dim=-1
        )  # (L,)
        # per-participant top-k by rank: count same-segment tokens with a
        # strictly larger norm; keep if rank < keep_n
        same = seg[:, None] == seg[None, :]
        larger = (norms[None, :] > norms[:, None]) & same
        rank = larger.sum(dim=1)
        return rank < keep_n
    if selection == "attnmass":
        if attn_mass is None:
            return local_pos >= (my_size - keep_n)
        mass = attn_mass.to(torch.float32).reshape(-1)[:L]
        same = seg[:, None] == seg[None, :]
        larger = (mass[None, :] > mass[:, None]) & same
        return larger.sum(dim=1) < keep_n
    raise ValueError(f"unknown kv_selection {selection!r}")


def decode_exchange_mask(attn_mass: torch.Tensor, exchange_ratio: float) -> torch.Tensor:
    """Per-slot sparse-exchange mask from accumulated decode attention mass
    (B, C): keep the ``max(1, round(ratio * C))`` columns each slot's
    queries used most, as a (B, C) bool ``contributed`` mask. Ties keep the
    lower column first (the JAX package's ``lax.top_k`` order), so columns
    that never received mass (holes, padding) rank last and drop first."""
    B, C = attn_mass.shape
    n_keep = max(1, int(round(exchange_ratio * C)))
    order = torch.sort(attn_mass.to(torch.float32), dim=1, descending=True, stable=True).indices
    keep = torch.zeros((B, C), dtype=torch.bool, device=attn_mass.device)
    return keep.scatter_(1, order[:, :n_keep], True)


def _local_positions(segment_ids: torch.Tensor, n_participants: int) -> torch.Tensor:
    """Offset of each token within its participant's segment, shape (L,)."""
    onehot = torch.nn.functional.one_hot(segment_ids.long(), n_participants).to(torch.int32)
    cum = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive count
    return torch.gather(cum, 1, segment_ids.long()[:, None])[:, 0]


def exchange_bytes_per_row(
    n_kv_heads: int,
    head_dim: int,
    kv_quant: str = "none",
    bytes_per_el: int = 4,
) -> float:
    """Wire bytes for ONE contributed KV row (its K row AND its V row).

    Unquantized, a row is ``2 * nkv * dh`` elements of the compute dtype;
    with ``kv_quant`` ('int8'/'fp8') it crosses as 1-byte codes plus one
    f32 scale per kv head per tensor — ``2 * nkv * (dh + 4)`` bytes."""
    if kv_quant in (None, "none"):
        return float(2 * n_kv_heads * head_dim * bytes_per_el)
    if kv_quant not in ("int8", "fp8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return float(2 * n_kv_heads * (head_dim + 4))
