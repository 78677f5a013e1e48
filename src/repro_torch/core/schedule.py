"""FedAttn sync schedules — which Transformer blocks perform global attention.

A copy of the JAX package's ``core/schedule.py``, which is numpy-only; the
port keeps its own so that it never imports the reference package.

The paper's uniform schedule syncs every H-th block (eq. 20-21). Figure 7
compares four alternatives with the *same total number of syncs*:

  * shallow_half  — all syncs concentrated in the shallow half,
  * deep_half     — all syncs concentrated in the deep half,
  * progressive   — sync gaps increase with depth (dense early),
  * regressive    — sync gaps decrease with depth (dense late).

A schedule is a boolean mask over the M blocks; ``mask[m]`` is True iff
block m is a sync (global-attention / KV-exchange) layer. Theorem 2's
error-reduction weights Γ_m (eq. 48) motivate schedule *optimization*:
:func:`SyncSchedule.from_error_weights` places syncs greedily at the blocks
with the largest measured Γ_m — the paper's "where to perform global
attention" question answered adaptively (beyond-paper feature, grounded in
Remark 6).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyncSchedule:
    """Immutable per-block sync mask."""

    mask: tuple[bool, ...]

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def uniform(n_layers: int, interval: int) -> "SyncSchedule":
        """Sync every ``interval``-th block (blocks interval-1, 2*interval-1, ...).
        interval == 1 → CenAttn; interval >= n_layers → single final sync."""
        mask = [((m + 1) % interval == 0) for m in range(n_layers)]
        return SyncSchedule(tuple(mask))

    @staticmethod
    def none(n_layers: int) -> "SyncSchedule":
        """LocAttn — never synchronize (H = M)."""
        return SyncSchedule(tuple(False for _ in range(n_layers)))

    @staticmethod
    def all(n_layers: int) -> "SyncSchedule":
        """CenAttn — synchronize at every block (H = 1)."""
        return SyncSchedule(tuple(True for _ in range(n_layers)))

    @staticmethod
    def shallow_half(n_layers: int, n_syncs: int) -> "SyncSchedule":
        """Concentrate ``n_syncs`` uniformly in blocks [0, n_layers/2)."""
        half = n_layers // 2
        return SyncSchedule._spread(n_layers, n_syncs, 0, half)

    @staticmethod
    def deep_half(n_layers: int, n_syncs: int) -> "SyncSchedule":
        """Concentrate ``n_syncs`` uniformly in blocks [n_layers/2, n_layers)."""
        half = n_layers // 2
        return SyncSchedule._spread(n_layers, n_syncs, half, n_layers)

    @staticmethod
    def progressive(n_layers: int, n_syncs: int) -> "SyncSchedule":
        """Sync gaps increase with depth: sync positions follow a quadratic
        ramp so shallow blocks sync frequently, deep blocks rarely."""
        # positions ~ n_layers * (k/n_syncs)^2
        pos = sorted(
            {max(0, min(n_layers - 1,
                        int(round(n_layers * ((k + 1) / n_syncs) ** 2)) - 1))
             for k in range(n_syncs)}
        )
        return SyncSchedule._from_positions(n_layers, pos)

    @staticmethod
    def regressive(n_layers: int, n_syncs: int) -> "SyncSchedule":
        """Sync gaps decrease with depth (mirror of progressive)."""
        prog = SyncSchedule.progressive(n_layers, n_syncs).mask
        return SyncSchedule(tuple(reversed(prog)))

    @staticmethod
    def custom(positions: list[int], n_layers: int) -> "SyncSchedule":
        return SyncSchedule._from_positions(n_layers, sorted(set(positions)))

    @staticmethod
    def from_error_weights(
        error_weights: np.ndarray, n_syncs: int
    ) -> "SyncSchedule":
        """Adaptive schedule (Remark 6): place syncs at the ``n_syncs``
        blocks with the largest error-reduction weight Γ_m."""
        n_layers = len(error_weights)
        pos = list(np.argsort(-np.asarray(error_weights))[:n_syncs])
        return SyncSchedule._from_positions(n_layers, sorted(int(p) for p in pos))

    @staticmethod
    def by_name(
        name: str, n_layers: int, interval: int = 1, n_syncs: int | None = None
    ) -> "SyncSchedule":
        """Factory by schedule name (see FedAttnConfig.schedule)."""
        if n_syncs is None:
            n_syncs = max(1, n_layers // max(interval, 1))
        makers = {
            "uniform": lambda: SyncSchedule.uniform(n_layers, interval),
            "none": lambda: SyncSchedule.none(n_layers),
            "all": lambda: SyncSchedule.all(n_layers),
            "shallow_half": lambda: SyncSchedule.shallow_half(n_layers, n_syncs),
            "deep_half": lambda: SyncSchedule.deep_half(n_layers, n_syncs),
            "progressive": lambda: SyncSchedule.progressive(n_layers, n_syncs),
            "regressive": lambda: SyncSchedule.regressive(n_layers, n_syncs),
        }
        if name not in makers:
            raise ValueError(f"unknown schedule {name!r}; options: {sorted(makers)}")
        return makers[name]()

    # -- helpers ---------------------------------------------------------------

    @staticmethod
    def _spread(n_layers: int, n_syncs: int, lo: int, hi: int) -> "SyncSchedule":
        n_syncs = min(n_syncs, hi - lo)
        pos = [lo + int(round((k + 1) * (hi - lo) / n_syncs)) - 1 for k in range(n_syncs)]
        return SyncSchedule._from_positions(n_layers, sorted(set(pos)))

    @staticmethod
    def _from_positions(n_layers: int, positions: list[int]) -> "SyncSchedule":
        mask = [False] * n_layers
        for p in positions:
            if not (0 <= p < n_layers):
                raise ValueError(f"sync position {p} out of range [0, {n_layers})")
            mask[p] = True
        return SyncSchedule(tuple(mask))

    # -- queries ---------------------------------------------------------------

    @property
    def n_layers(self) -> int:
        return len(self.mask)

    @property
    def n_syncs(self) -> int:
        return sum(self.mask)

    def positions(self) -> list[int]:
        return [m for m, s in enumerate(self.mask) if s]

    def is_sync(self, layer: int) -> bool:
        return self.mask[layer]

    def segments(self) -> list[tuple[int, bool]]:
        """Decompose into (run_length, ends_with_sync) segments — the
        (local-forwards, sync) structure used by scan-over-layers lowering.
        A trailing run without sync is returned as (len, False)."""
        segs: list[tuple[int, bool]] = []
        run = 0
        for s in self.mask:
            run += 1
            if s:
                segs.append((run, True))
                run = 0
        if run:
            segs.append((run, False))
        return segs

    def comm_rounds(self) -> int:
        """T — number of communication rounds."""
        return self.n_syncs

    def comm_cost_factor(self) -> float:
        """Fraction of layers that exchange KV — communication relative to
        CenAttn (per-layer exchange). This is the paper's comm-savings dial."""
        return self.n_syncs / max(self.n_layers, 1)

    def periodic_pattern(self, period: int) -> list[bool]:
        """If the schedule is periodic with ``period``, return one period;
        raise otherwise (scan-over-layers requires periodicity)."""
        if self.n_layers % period != 0:
            raise ValueError("n_layers not a multiple of period")
        base = list(self.mask[:period])
        for start in range(0, self.n_layers, period):
            if list(self.mask[start : start + period]) != base:
                raise ValueError("schedule is not periodic with this period")
        return base
