"""Token → participant partitions (the paper's Π_n machinery, eq. 11-15).

Port of the JAX package's ``core/partition.py`` for the main path: a
:class:`Partition` assigns every global token index to exactly one of N
participants. The serving engine uses contiguous shards (participant ``n``
holds the ``n``-th slice of the prompt) with the publisher last.

``segment_ids`` is a host-side int32 tensor; :class:`FedAttnContext` moves
the vectors it derives from it onto the compute device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class Partition:
    """A disjoint partition of ``seq_len`` tokens over ``n_participants``.

    Attributes:
      segment_ids: int32 tensor of shape (seq_len,) — participant id per
        global token position.
      n_participants: N.
    """

    segment_ids: torch.Tensor
    n_participants: int

    @staticmethod
    def contiguous(seq_len: int, n_participants: int) -> "Partition":
        """Contiguous equal shards. seq_len % N may be != 0; the remainder
        goes to the last participants."""
        base = seq_len // n_participants
        rem = seq_len % n_participants
        sizes = [base + (1 if i >= n_participants - rem else 0) for i in range(n_participants)]
        return Partition.from_sizes(sizes)

    @staticmethod
    def from_sizes(sizes: Sequence[int]) -> "Partition":
        ids = torch.repeat_interleave(
            torch.arange(len(sizes), dtype=torch.int32),
            torch.as_tensor(list(sizes), dtype=torch.int64),
        )
        return Partition(ids, len(sizes))

    @property
    def seq_len(self) -> int:
        return int(self.segment_ids.shape[0])

    def sizes(self) -> torch.Tensor:
        """L_n for every participant, shape (N,)."""
        return torch.bincount(self.segment_ids.long(), minlength=self.n_participants)

    def publisher(self, publisher_index: int = -1) -> int:
        return publisher_index % self.n_participants

    def publisher_start(self, publisher_index: int = -1) -> int:
        """First global position owned by the publisher."""
        pub = self.publisher(publisher_index)
        idx = torch.nonzero(self.segment_ids == pub).flatten()
        return int(idx[0]) if idx.numel() else 0

    def extend(self, n_new: int, participant: int) -> "Partition":
        """Append ``n_new`` generated tokens owned by ``participant``
        (decode: generated tokens belong to the publisher)."""
        tail = torch.full((n_new,), participant, dtype=torch.int32)
        return Partition(torch.cat([self.segment_ids, tail]), self.n_participants)
