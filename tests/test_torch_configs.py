"""Host-side protocol types of the port equal the JAX package's: config
registry entries field for field, sync schedules and partitions."""
import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
from repro.core.partition import Partition as JPartition
from repro.core.schedule import SyncSchedule as JSchedule
from repro_torch import configs as tconfigs
from repro_torch.core.partition import Partition as TPartition
from repro_torch.core.schedule import SyncSchedule as TSchedule

PORTED = ["qwen2-7b", "llama3-8b", "qwen2.5-0.5b", "qwen2.5-1.5b", "qwen2.5-3b", "qwen2.5-7b"]


@pytest.mark.parametrize("name", PORTED)
def test_config_field_for_field(name):
    assert dataclasses.asdict(tconfigs.get_config(name)) == dataclasses.asdict(jconfigs.get_config(name))
    assert dataclasses.asdict(tconfigs.get_reduced_config(name)) == dataclasses.asdict(
        jconfigs.get_reduced_config(name)
    )
    tc, jc = tconfigs.get_config(name), jconfigs.get_config(name)
    assert (tc.padded_vocab, tc.head_dim, tc.param_count()) == (jc.padded_vocab, jc.head_dim, jc.param_count())
    assert tconfigs.schedule_from_config(tc).mask == jconfigs.schedule_from_config(jc).mask


def test_unported_arch_raises():
    with pytest.raises(KeyError):
        tconfigs.get_config("rwkv6-7b")
    assert sorted(tconfigs.list_configs()) == sorted(PORTED)


@pytest.mark.parametrize("name", ["uniform", "none", "all", "shallow_half", "deep_half", "progressive", "regressive"])
@pytest.mark.parametrize("n_layers,interval", [(4, 1), (8, 2), (28, 4), (13, 3)])
def test_sync_schedule_equal(name, n_layers, interval):
    t = TSchedule.by_name(name, n_layers, interval=interval)
    j = JSchedule.by_name(name, n_layers, interval=interval)
    assert t.mask == j.mask
    assert t.segments() == j.segments() and t.comm_rounds() == j.comm_rounds()


@pytest.mark.parametrize("seq_len,n", [(37, 4), (64, 4), (5, 1), (1000, 4), (9, 7)])
def test_partition_equal(seq_len, n):
    t, j = TPartition.contiguous(seq_len, n), JPartition.contiguous(seq_len, n)
    np.testing.assert_array_equal(t.segment_ids.numpy(), np.asarray(j.segment_ids))
    np.testing.assert_array_equal(t.sizes().numpy(), np.asarray(j.sizes()))
    assert (t.seq_len, t.n_participants) == (j.seq_len, j.n_participants)
    for pub in (-1, 0):
        assert t.publisher(pub) == j.publisher(pub)
        assert t.publisher_start(pub) == j.publisher_start(pub)
    te, je = t.extend(3, t.publisher()), j.extend(3, j.publisher())
    np.testing.assert_array_equal(te.segment_ids.numpy(), np.asarray(je.segment_ids))


def test_partition_from_sizes_equal():
    sizes = [3, 0, 5, 2]
    t, j = TPartition.from_sizes(sizes), JPartition.from_sizes(sizes)
    np.testing.assert_array_equal(t.segment_ids.numpy(), np.asarray(j.segment_ids))
    assert t.publisher_start(1) == j.publisher_start(1)
