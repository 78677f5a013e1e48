"""The port's FedAttn protocol vectors equal the JAX package's: context
construction, decode contexts, and the deterministic contribution-mask
policies; the torch-only 'random' policy keeps its ratio per seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import contribution_mask as j_mask
from repro.core.fedattn import FedAttnContext as JCtx
from repro.core.partition import Partition as JPartition
from repro.core.schedule import SyncSchedule as JSchedule
from repro.types import FedAttnConfig as JFed
from repro_torch.core.aggregation import contribution_mask as t_mask
from repro_torch.core.fedattn import FedAttnContext as TCtx
from repro_torch.core.partition import Partition as TPartition
from repro_torch.core.schedule import SyncSchedule as TSchedule
from repro_torch.types import FedAttnConfig as TFed

DETERMINISTIC = ["strided", "recency", "sink_recency", "keynorm"]


def _eq(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _partitions(sizes):
    return TPartition.from_sizes(sizes), JPartition.from_sizes(sizes)


@pytest.mark.parametrize("selection", DETERMINISTIC)
@pytest.mark.parametrize("sizes", [[9, 9, 9, 10], [1, 6, 17, 3], [40]])
@pytest.mark.parametrize("ratio", [0.25, 0.5, 1.0])
def test_contribution_mask_deterministic_policies_exact(selection, sizes, ratio):
    tp, jp = _partitions(sizes)
    keys = np.random.default_rng(0).standard_normal((tp.seq_len, 2, 8)).astype(np.float32)
    for t in range(3):
        got = t_mask(tp, ratio, selection, round_index=t, keys=torch.from_numpy(keys))
        want = j_mask(jp, ratio, selection, round_index=t, keys=jnp.asarray(keys))
        _eq(got, want)


def test_contribution_mask_random_ratio_and_seed():
    tp = TPartition.contiguous(4096, 4)
    draw = lambda seed: [
        t_mask(tp, 0.3, "random", generator=g, round_index=t)
        for g in [torch.Generator().manual_seed(seed)] for t in range(2)
    ]
    a, b, c = draw(7), draw(7), draw(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # seed-deterministic
    assert not torch.equal(a[0], a[1])  # rounds resample
    assert not torch.equal(a[0], c[0])
    assert abs(a[0].float().mean().item() - 0.3) < 0.03
    with pytest.raises(ValueError):
        t_mask(tp, 0.3, "random")


@pytest.mark.parametrize(
    "n,H,ratio,selection,L",
    [(4, 2, 1.0, "strided", 37), (4, 1, 0.5, "strided", 64), (2, 3, 0.5, "recency", 23),
     (1, 1, 1.0, "strided", 16), (3, 2, 0.4, "sink_recency", 30)],
)
def test_context_build_and_decode_vectors(n, H, ratio, selection, L):
    n_layers = 6
    tf = TFed(n_participants=n, sync_interval=H, kv_exchange_ratio=ratio, kv_selection=selection)
    jf = JFed(n_participants=n, sync_interval=H, kv_exchange_ratio=ratio, kv_selection=selection)
    tc = TCtx.build(tf, n_layers, L)
    jc = JCtx.build(jf, n_layers, L)
    _eq(tc.positions, jc.positions)
    _eq(tc.segments, jc.segments)
    assert tc.schedule.mask == jc.schedule.mask
    assert (tc.contributed is None) == (jc.contributed is None)
    if tc.contributed is not None:
        _eq(tc.contributed, jc.contributed)
    for m in range(n_layers):
        assert tc._round_of_layer(m) == jc._round_of_layer(m)
    capacity = L + 8
    for step, n_new in [(0, 1), (3, 1), (0, 4)]:
        td, jd = tc.for_decode_step(capacity, step, n_new), jc.for_decode_step(capacity, step, n_new)
        for a in ("positions", "segments", "kv_positions", "kv_segments"):
            _eq(getattr(td, a), getattr(jd, a))
    _eq(tc.decode_kv_segments(L - 3), jc.decode_kv_segments(L - 3))
    tt, jt = tc.decode_template(capacity), jc.decode_template(capacity)
    for a in ("positions", "segments", "kv_positions", "kv_segments"):
        _eq(getattr(tt, a), getattr(jt, a))
    assert tc.comm_bytes_per_participant(4, 64) == jc.comm_bytes_per_participant(4, 64)


def test_context_with_explicit_schedule_and_partition():
    sizes = [5, 2, 9]
    tp, jp = _partitions(sizes)
    tf = TFed(n_participants=3, kv_exchange_ratio=0.5, kv_selection="strided")
    jf = JFed(n_participants=3, kv_exchange_ratio=0.5, kv_selection="strided")
    tc = TCtx.build(tf, 5, 16, partition=tp, schedule=TSchedule.custom([1, 4], 5))
    jc = JCtx.build(jf, 5, 16, partition=jp, schedule=JSchedule.custom([1, 4], 5))
    _eq(tc.contributed, jc.contributed)
    _eq(tc.for_decode_step(20, 2).kv_segments, jc.for_decode_step(20, 2).kv_segments)
