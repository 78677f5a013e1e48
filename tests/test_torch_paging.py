"""The port's page bookkeeping (``repro_torch.serving.paging``) and n-gram
drafter (``repro_torch.serving.spec``) against the JAX package's copies:
the page arithmetic on a grid of values, and ``PageAllocator`` /
``PrefixCache`` / ``NGramDrafter`` driven through the same seeded random
operation sequences, compared after every operation. Pure Python on both
sides, so everything must be equal exactly."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import paging as jpg
from repro.serving import spec as jspec
from repro_torch.serving import paging as tpg
from repro_torch.serving import spec as tspec


@settings(deadline=None, max_examples=60)
@given(n=st.integers(0, 500), ps=st.integers(1, 40), n_new=st.integers(1, 50), k=st.integers(0, 6))
def test_page_arithmetic_equal(n, ps, n_new, k):
    assert tpg.pages_for(n, ps) == jpg.pages_for(n, ps)
    assert tpg.page_split(n, ps) == jpg.page_split(n, ps)
    assert tpg.linear_pos(n, n % ps, ps) == jpg.linear_pos(n, n % ps, ps)
    assert tpg.padded_capacity(n + 2, ps) == jpg.padded_capacity(n + 2, ps)
    assert tpg.pages_for_request(n, n_new, ps, spec_k=k) == jpg.pages_for_request(n, n_new, ps, spec_k=k)


def _outcome(fn):
    """(result, None) or (None, exception type name) of one call."""
    try:
        return fn(), None
    except ValueError as e:
        return None, type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_allocator_same_op_sequence(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    a, b = tpg.PageAllocator(n), jpg.PageAllocator(n)
    for _ in range(120):
        op = rng.choice(["alloc", "free", "incref", "fork"])
        page = int(rng.integers(0, n))
        if op == "alloc":
            k = int(rng.integers(0, 4))
            got, want = _outcome(lambda: a.alloc(k)), _outcome(lambda: b.alloc(k))
        else:
            got = _outcome(lambda: getattr(a, op)(page))
            want = _outcome(lambda: getattr(b, op)(page))
        assert got == want, op
        assert (a.free_pages, a.used_pages) == (b.free_pages, b.used_pages)
        assert [a.refcount(p) for p in range(n)] == [b.refcount(p) for p in range(n)]
    with pytest.raises(ValueError):
        tpg.PageAllocator(0)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_same_op_sequence(seed):
    """Inserts of prompts drawn from a few shared stems, lookups, LRU
    evictions: hits, reused tokens, returned page runs and refcounts all
    equal."""
    rng = np.random.default_rng(seed)
    ps, n = int(rng.integers(2, 6)), 40
    ta, ja = tpg.PageAllocator(n), jpg.PageAllocator(n)
    tc, jc = tpg.PrefixCache(ta, ps), jpg.PrefixCache(ja, ps)
    stems = [rng.integers(0, 5, 30) for _ in range(3)]

    def key_of(toks):
        return lambda d: bytes([d]) + toks[:d].astype(np.int8).tobytes()

    for _ in range(40):
        toks = np.concatenate([stems[rng.integers(0, 3)][: rng.integers(3, 30)], rng.integers(0, 5, 4)])
        L = len(toks)
        op = rng.choice(["lookup", "insert", "evict"], p=[0.45, 0.4, 0.15])
        if op == "lookup":
            assert tc.lookup(key_of(toks), L) == jc.lookup(key_of(toks), L)
        elif op == "insert":
            pages = ta.alloc(tpg.pages_for(L, ps))
            assert pages == ja.alloc(jpg.pages_for(L, ps))
            if pages is None:
                continue
            tc.insert(key_of(toks), L, pages)
            jc.insert(key_of(toks), L, pages)
            for p in pages:  # the admitting slot retires; the cache keeps its refs
                ta.free(p)
                ja.free(p)
        else:
            assert tc.evict_lru() == jc.evict_lru()
        assert (len(tc), tc.hits, tc.misses, tc.evictions, tc.tokens_reused) == (
            len(jc), jc.hits, jc.misses, jc.evictions, jc.tokens_reused)
        assert [ta.refcount(p) for p in range(n)] == [ja.refcount(p) for p in range(n)]
    tc.release_all()
    jc.release_all()
    assert ta.free_pages == ja.free_pages == n


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_equal(seed):
    rng = np.random.default_rng(seed)
    hist = list(rng.integers(0, 4, int(rng.integers(1, 30))))
    t, j = tspec.NGramDrafter(), jspec.NGramDrafter()
    ts, js = t.begin(hist), j.begin(hist)
    for _ in range(10):
        k = int(rng.integers(1, 6))
        np.testing.assert_array_equal(t.draft(ts, k), j.draft(js, k))
        new = rng.integers(0, 4, int(rng.integers(1, 4)))
        t.update(ts, new)
        j.update(js, new)
    assert tspec.resolve_drafter("ngram").max_ngram == 3
    with pytest.raises(ValueError, match="begin/draft/update"):
        tspec.resolve_drafter(object())
