"""The port's ``core/kv_pager.py`` (a copy, not an import) against the JAX
package's ``repro.core.kv_pager``, on the same operation sequences.

The unit cases follow tests/test_paged.py's allocator and prefix-cache
tests, run on both modules side by side; a seeded random walk of
alloc / register / match / release then checks that both pagers return
the same pages, raise at the same step and report the same stats
throughout.
"""

import numpy as np
import pytest

from repro.core import kv_pager as jpager
from repro_torch.core import kv_pager as tpager

MODULES = [jpager, tpager]


def test_allocator_refcounts_and_reuse():
    got = []
    for m in MODULES:
        a = m.BlockAllocator(8)
        assert a.free_pages == 7                  # page 0 pinned forever
        pgs = a.alloc(3)
        assert m.DUMP_PAGE not in pgs and a.used_pages == 3
        a.incref(pgs[:1])
        assert a.decref(pgs) == 2                 # pgs[0] still referenced
        assert a.decref(pgs[:1]) == 1
        assert a.free_pages == 7
        again = a.alloc(7)                        # freed pages are reusable
        assert sorted(again) == list(range(1, 8))
        got.append((pgs, again, a.refcount.tolist()))
    assert got[0] == got[1]


def test_allocator_oom_is_atomic():
    for m in MODULES:
        a = m.BlockAllocator(4)
        a.alloc(2)
        with pytest.raises(m.PagerOOM):
            a.alloc(2)                            # only 1 free
        assert a.free_pages == 1                  # failed alloc took nothing
    with pytest.raises(ValueError):
        tpager.BlockAllocator(1)


def test_allocator_rejects_bad_refops():
    a = tpager.BlockAllocator(4)
    with pytest.raises(AssertionError):
        a.incref([2])                             # never allocated
    with pytest.raises(AssertionError):
        a.decref([tpager.DUMP_PAGE])


@pytest.mark.parametrize("tokens,ps,n", [
    ([1, 2, 3, 4], 2, 2), ([1, 2, 3, 5], 2, 2), ([9, 2, 3, 4], 2, 2),
    (list(range(100)), 16, 6), ([7] * 33, 16, 2), ([], 16, 0)])
def test_chain_keys_match_jax(tokens, ps, n):
    assert tpager._chain_keys(tokens, ps, n) == \
        jpager._chain_keys(tokens, ps, n)


def test_chain_keys_commit_to_whole_prefix():
    k1 = tpager._chain_keys([1, 2, 3, 4], 2, 2)
    k2 = tpager._chain_keys([1, 2, 3, 5], 2, 2)
    k3 = tpager._chain_keys([9, 2, 3, 4], 2, 2)
    assert k1[0] == k2[0] and k1[1] != k2[1]  # same first page, split after
    assert k1[0] != k3[0] and k1[1] != k3[1]  # early divergence poisons all


def test_match_prefix_always_leaves_suffix():
    got = []
    for m in MODULES:
        p = m.KVPager(num_pages=8, page_size=2)
        pgs = p.alloc(2)
        p.register_prefix([1, 2, 3, 4], pgs)
        m1 = p.match_prefix([1, 2, 3, 4])      # exact replay: cap at 1 page
        assert m1.ctx_tokens == 2 and len(m1.pages) == 1
        m2 = p.match_prefix([1, 2, 3, 4, 9])   # 1 suffix token: both pages
        assert m2.ctx_tokens == 4 and m2.pages == list(pgs)
        m3 = p.match_prefix([1, 2, 9, 9, 9])   # diverges inside page 2
        assert m3.ctx_tokens == 2 and m3.pages == [pgs[0]]
        p.release(m1.pages + m2.pages + m3.pages)
        got.append(p.stats())
    assert got[0] == got[1]


def test_pager_eviction_spares_referenced_pages():
    got = []
    for m in MODULES:
        p = m.KVPager(num_pages=5, page_size=2)     # 4 usable pages
        a = p.alloc(2)
        p.register_prefix([1, 2, 3, 4], a)
        p.release(a)                              # now held only by the cache
        b = p.alloc(2)
        p.register_prefix([7, 8, 9, 10], b)       # still held by "request" b
        p.alloc(2)                                # evicts a's pages
        assert p.prefix.evictions == 2
        assert p.match_prefix([7, 8, 9, 10, 0]).ctx_tokens == 4
        with pytest.raises(m.PagerOOM):
            p.alloc(1)                            # b + c pinned: nothing left
        got.append(p.stats())
    assert got[0] == got[1]


def _walk(m, seed, steps=200, num_pages=24, ps=4):
    """A seeded random walk of pager operations; returns its trace."""
    rng = np.random.default_rng(seed)
    pager = m.KVPager(num_pages, ps)
    held = []                 # page lists this walk owns references to
    trace = []
    stems = [rng.integers(0, 5, 12).tolist() for _ in range(3)]
    for _ in range(steps):
        op = int(rng.integers(0, 4))
        if op == 0:                                   # alloc
            n = int(rng.integers(1, 5))
            try:
                pages = pager.alloc(n)
                held.append(pages)
                trace.append(("alloc", pages))
            except m.PagerOOM:
                trace.append(("oom", n))
        elif op == 1 and held:                        # register a prefix
            pages = held[int(rng.integers(0, len(held)))]
            stem = stems[int(rng.integers(0, 3))]
            toks = stem[:len(pages) * ps] + rng.integers(
                0, 5, int(rng.integers(0, 3))).tolist()
            pager.register_prefix(toks, pages)
            trace.append(("register", len(toks)))
        elif op == 2:                                 # match a prompt
            stem = stems[int(rng.integers(0, 3))]
            toks = stem[:int(rng.integers(1, 13))] + [int(rng.integers(5))]
            match = pager.match_prefix(toks)
            held.append(match.pages)
            trace.append(("match", match.pages, match.ctx_tokens))
        elif held:                                    # release
            pages = held.pop(int(rng.integers(0, len(held))))
            trace.append(("release", pager.release(pages)))
        trace.append(pager.stats())
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_random_walk_matches_jax(seed):
    assert _walk(tpager, seed) == _walk(jpager, seed)


@pytest.mark.parametrize("budget,page_bytes", [
    (10**9, 1572864), (100, 1000), (0, 7), (64 * 2**20, 2**20)])
def test_pages_for_budget_matches_jax(budget, page_bytes):
    assert tpager.pages_for_budget(budget, page_bytes) == \
        jpager.pages_for_budget(budget, page_bytes)
