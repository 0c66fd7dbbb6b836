"""The port's host-side KV-cache bookkeeping (``serve2/kvcache.py``,
``serve2/prefix.py``) against the JAX package's, with no model: one
seeded random sequence of alloc, incref, free, register, lookup and evict
drives both, and every step must give the same page ids, refcounts,
errors, cache keys and statistics. Also the flags, the chain-hash keys
(byte-equal) and the metrics owner tokens the engines rely on.
"""
import numpy as np
import pytest

from mxnet_tpu import config as jconfig
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.serve2 import kvcache as jkv
from mxnet_tpu.serve2 import prefix as jpre
from mxnet_tpu.serve2.decode import decode_rungs_for as j_rungs
from mxnet_tpu_torch import MXNetError, config
from mxnet_tpu_torch.serve2 import kvcache as tkv
from mxnet_tpu_torch.serve2 import prefix as tpre
from mxnet_tpu_torch.serve2.decode import decode_rungs_for
from mxnet_tpu_torch.telemetry import metrics

PAGE = 4


def _both(fn_j, fn_t):
    """Run one operation in both packages: the same result or the same
    error class (PagePoolExhausted / MXNetError)."""
    try:
        rj = ("ok", fn_j())
    except jkv.PagePoolExhausted:
        rj = ("exhausted", None)
    except JaxMXNetError:
        rj = ("error", None)
    try:
        rt = ("ok", fn_t())
    except tkv.PagePoolExhausted:
        rt = ("exhausted", None)
    except MXNetError:
        rt = ("error", None)
    assert rj == rt
    return rt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interleavings_match_jax(seed):
    rs = np.random.RandomState(seed)
    ja = jkv.PageAllocator(12, PAGE, name=f"jkv{seed}")
    ta = tkv.PageAllocator(12, PAGE, name=f"tkv{seed}")
    jc = jpre.PrefixCache(ja, capacity_pages=int(rs.choice([0, 5])))
    tc = tpre.PrefixCache(ta, capacity_pages=jc.capacity_pages)
    held = []          # references this test holds (one entry each)
    templates = [rs.randint(0, 9, size=(3 * PAGE,)).tolist()
                 for _ in range(3)]
    for _ in range(300):
        op = rs.randint(7)
        if op == 0:
            n = int(rs.randint(0, 5))
            status, pages = _both(lambda: ja.alloc(n), lambda: ta.alloc(n))
            if status == "ok":
                held.extend(pages)
        elif op == 1 and held:
            pick = [held[i] for i in rs.choice(len(held), 2)]
            if _both(lambda: ja.incref(pick),
                     lambda: ta.incref(pick))[0] == "ok":
                held.extend(pick)
        elif op == 2 and held:
            idx = sorted(set(rs.choice(len(held), rs.randint(1, 3))),
                         reverse=True)
            drop = [held[i] for i in idx]
            if _both(lambda: ja.free(drop),
                     lambda: ta.free(drop))[0] == "ok":
                for i in idx:
                    held.pop(i)
        elif op == 3:
            toks = templates[rs.randint(3)][:PAGE * rs.randint(1, 4)]
            keys = tpre.page_keys(toks, PAGE)
            assert keys == jpre.page_keys(toks, PAGE)
            if held:
                pages = [held[i] for i in rs.choice(len(held), len(keys))]
                _both(lambda: jc.register(keys, pages),
                      lambda: tc.register(keys, pages))
        elif op == 4:
            toks = templates[rs.randint(3)]
            keys = tpre.page_keys(toks, PAGE)
            status, hit = _both(lambda: jc.lookup(keys),
                                lambda: tc.lookup(keys))
            held.extend(hit)
            n = int(rs.randint(0, 3))
            _both(lambda: jc.record_admission(n),
                  lambda: tc.record_admission(n))
        elif op == 5:
            n = int(rs.randint(0, 3))
            _both(lambda: jc.evict(n), lambda: tc.evict(n))
        elif op == 6:
            # an invalid id (or the null page) after valid ones: both
            # refuse the whole list
            bad = held[:1] + [int(rs.choice([-1, 0, 12]))]
            assert _both(lambda: ja.free(bad),
                         lambda: ta.free(bad))[0] == "error"
        assert ta.refcounts() == ja.refcounts()
        assert ta.stats() == ja.stats()
        assert tc.stats() == jc.stats()
        assert tc.cached_pages() == jc.cached_pages()
        assert ta.free_pages == ja.free_pages
    tc.release_all()
    jc.release_all()
    assert ta.refcounts() == ja.refcounts()
    # the per-engine gauges, retired the same way
    assert sorted(ta.gauge_names()) == sorted(
        n.replace("jkv", "tkv") for n in ja.gauge_names())
    ta.retire_gauges()
    assert not set(ta.gauge_names()) & set(metrics.all_metrics())
    ja.retire_gauges()


def test_block_table_pages_needed_and_rungs_match_jax():
    for n in range(0, 13):
        assert tkv.pages_needed(n, PAGE) == jkv.pages_needed(n, PAGE)
    for m in (1, 2, 3, 6, 8, 9):
        assert decode_rungs_for(m) == j_rungs(m)
    with pytest.raises(MXNetError):
        decode_rungs_for(0)
    jt, tt = jkv.BlockTable(PAGE), tkv.BlockTable(PAGE)
    for bt in (jt, tt):
        bt.pages = [3, 7]
        bt.length = 7
    assert tt.capacity() == jt.capacity()
    for extra in (1, 2):
        assert tt.needs_page(extra) == jt.needs_page(extra)
    assert np.array_equal(tt.row(4), jt.row(4))
    out = np.full((4,), 9, "int32")
    assert tt.row(4, out=out) is out and out.tolist() == [3, 7, 0, 0]
    with pytest.raises(MXNetError):
        tt.row(1)
    with pytest.raises(MXNetError):
        tkv.PageAllocator(1, PAGE)


def test_page_keys_are_byte_equal_to_jax():
    rs = np.random.RandomState(7)
    toks = rs.randint(0, 50257, size=(37,)).tolist()
    for page in (1, 4, 16):
        for salt in (b"mxserve3", b"other"):
            assert tpre.page_keys(toks, page, salt=salt) == \
                jpre.page_keys(toks, page, salt=salt)


def test_serve_flags_equal_jax():
    names = ["MXSERVE2_PAGE_SIZE", "MXSERVE2_NUM_PAGES",
             "MXSERVE2_MAX_INFLIGHT", "MXSERVE2_REPLICAS",
             "MXSERVE2_RELOAD_DRAIN_TIMEOUT_S", "MXSERVE2_DECODE_STEPS",
             "MXSERVE2_PREFILL_BUCKETS", "MXSERVE3_PREFIX_CACHE",
             "MXSERVE3_PREFIX_CACHE_PAGES", "MXSERVE3_SPEC_TOKENS",
             "MXSERVE3_KV_DTYPE", "MXRESIL_BREAKER_FAILURES",
             "MXRESIL_BREAKER_COOLDOWN_S"]
    for name in names:
        assert config.get(name) == jconfig.get(name), name
        assert type(config.get(name)) is type(jconfig.get(name)), name
    with pytest.raises(ValueError):
        config.set_flag("MXSERVE3_KV_DTYPE", "fp8")
    config.set_flag("MXSERVE3_KV_DTYPE", "int8")
    try:
        assert config.get("MXSERVE3_KV_DTYPE") == "int8"
    finally:
        config.unset_flag("MXSERVE3_KV_DTYPE")


def test_owner_tokens_and_unregister():
    g = metrics.gauge("test_kvcache_owner_gauge", "a gauge")
    c = metrics.counter("test_kvcache_owner_counter")
    tok = metrics.owner("owner-under-test").adopt(g, c.name)
    assert tok.leaked() == []          # open: nothing to report yet
    tok.close()
    assert tok.leaked() == ["test_kvcache_owner_counter",
                            "test_kvcache_owner_gauge"]
    assert metrics.unregister(g.name) and metrics.unregister(c.name)
    assert not metrics.unregister(g.name)
    assert tok.leaked() == []
    assert "test_kvcache_owner_gauge" not in metrics.to_prometheus()
