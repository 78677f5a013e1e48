"""The FedAttn protocol (Algorithm 1, eq. 16-21) as per-layer visibility.

Port of :class:`FedAttnContext` from the JAX package's ``core/fedattn.py``.
Participants hold disjoint positions of one global sequence, so the whole
protocol is attention visibility:

  local layer  (Phase I):   vis(i, j) = causal(i, j) AND seg(i) == seg(j)
  sync  layer  (Phase II):  vis(i, j) = causal(i, j) AND
                                        (seg(i) == seg(j) OR contributed_t(j))

:class:`FedAttnContext` carries what a layer needs for that: the partition,
the sync schedule, per-round contribution masks, and position/segment
vectors for prefill and decode, on the compute device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.core.aggregation import contribution_mask, exchange_bytes_per_row
from repro_torch.core.partition import Partition
from repro_torch.core.schedule import SyncSchedule
from repro_torch.types import FedAttnConfig


@dataclass(frozen=True)
class FedAttnContext:
    """Per-inference-task FedAttn state handed to every attention layer.

    Construction: :meth:`FedAttnContext.build` from (config, schedule,
    partition). During decode, :meth:`for_decode_step` produces the context
    of the new tokens.
    """

    config: FedAttnConfig
    schedule: SyncSchedule
    partition: Partition  # host-side
    positions: torch.Tensor  # (L,) global positions of the current q tokens
    segments: torch.Tensor  # (L,) participant ids of the current q tokens
    # (T, L) bool per-round contribution masks, or None for full exchange;
    # row t applies to the t-th sync layer
    contributed: Optional[torch.Tensor] = None
    # decode-time KV-side vectors (prefill: same as positions/segments)
    kv_positions: Optional[torch.Tensor] = None
    kv_segments: Optional[torch.Tensor] = None

    @staticmethod
    def build(
        config: FedAttnConfig,
        n_layers: int,
        seq_len: int,
        *,
        partition: Optional[Partition] = None,
        schedule: Optional[SyncSchedule] = None,
        generator: Optional[torch.Generator] = None,
        device: torch.device | str = "cpu",
    ) -> "FedAttnContext":
        if partition is None:
            partition = Partition.contiguous(seq_len, config.n_participants)
        if schedule is None:
            schedule = SyncSchedule.by_name(
                config.schedule, n_layers, interval=config.sync_interval
            )
        contributed = None
        if config.kv_exchange_ratio < 1.0:
            rounds = max(schedule.n_syncs, 1)
            contributed = torch.stack([
                contribution_mask(
                    partition, config.kv_exchange_ratio, config.kv_selection,
                    generator=generator, round_index=t,
                )
                for t in range(rounds)
            ]).to(device)
        return FedAttnContext(
            config=config,
            schedule=schedule,
            partition=partition,
            positions=torch.arange(seq_len, dtype=torch.int32, device=device),
            segments=partition.segment_ids.to(device),
            contributed=contributed,
        )

    def _round_of_layer(self, layer: int) -> int:
        """Communication-round index t of the sync at ``layer`` (0-based)."""
        return sum(1 for m in range(layer) if self.schedule.mask[m])

    # -- decode -----------------------------------------------------------------

    def for_decode_step(
        self, cache_len: int, step: int, n_new: int = 1
    ) -> "FedAttnContext":
        """Context for decoding ``n_new`` tokens after ``cache_len`` cached
        positions at decode step ``step``.

        The new tokens belong to the publisher (generated text is owned by
        the task publisher, §IV-C); the KV-side vectors describe the cache.
        With a fixed-capacity cache (``cache_len = capacity``) the KV-side
        vectors are step-invariant: slots past the write frontier carry
        positions in the causal future of every query."""
        dev = self.positions.device
        pub = self.partition.publisher(self.config.publisher_index)
        L0 = self.partition.seq_len
        return replace(
            self,
            positions=torch.arange(n_new, dtype=torch.int32, device=dev) + (L0 + step),
            segments=torch.full((n_new,), pub, dtype=torch.int32, device=dev),
            kv_positions=torch.arange(cache_len, dtype=torch.int32, device=dev),
            kv_segments=self.decode_kv_segments(cache_len),
        )

    def decode_kv_segments(self, capacity: int) -> torch.Tensor:
        """Step-invariant KV-side segment vector of a fixed-capacity cache:
        prompt slots keep their participant ids; every slot past the prompt
        belongs to the publisher."""
        pub = self.partition.publisher(self.config.publisher_index)
        L0 = self.partition.seq_len
        n_gen = max(capacity - L0, 0)
        seg = torch.cat([
            self.partition.segment_ids,
            torch.full((n_gen,), pub, dtype=torch.int32),
        ])[:capacity]
        return seg.to(self.positions.device)

    def decode_template(self, capacity: int) -> "FedAttnContext":
        """Step-0 single-token decode context over a fixed-capacity cache;
        a decode loop advances it with ``positions + step`` (every other
        vector is step-invariant)."""
        return self.for_decode_step(capacity, 0)

    # -- bookkeeping -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def comm_bytes_per_participant(
        self, n_kv_heads: int, head_dim: int, bytes_per_el: int = 2
    ) -> float:
        """Bytes each participant uploads for KV exchange during prefill
        (paper §VII-A3): ratio·L_n rows of (K, V) per sync round."""
        L = self.partition.seq_len
        n = self.partition.n_participants
        if n <= 1:
            return 0.0
        rows_per_round = self.config.kv_exchange_ratio * (L / n)
        per_row = exchange_bytes_per_row(
            n_kv_heads, head_dim, self.config.kv_quant, bytes_per_el=bytes_per_el,
        )
        return self.schedule.n_syncs * rows_per_round * per_row
