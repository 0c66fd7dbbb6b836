"""The port's ``DecodeEngine`` (``serve2/scheduler.py``) on the CPU against
the JAX package's greedy oracles, token for token.

The f32 oracle is the JAX package's ``dense_lm_logits``, one sequence at a
time, jitted once for this file at one padded length (positions past a
prompt do not reach earlier ones: the model is causal). The quantized
engines' oracle is the JAX package's ``PagedLM`` with the same pool type,
one sequence at a time (built once per type). Runs cover admission,
finish, preemption, EOS, a ``predict`` deadline, prefix hits with
copy-on-write, speculative decoding (self, unrelated and truncated
drafts), bf16 and int8 pools, and the signature record (0 after warmup).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel.pipeline_lm import dense_lm_logits as jdense
from mxnet_tpu.parallel.pipeline_lm import init_pipeline_lm as jinit
from mxnet_tpu.serve2 import DecodeEngine as JDecodeEngine
from mxnet_tpu.serve2 import PagedLM as JPagedLM
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import pipeline_lm_from_mxnet_tpu
from mxnet_tpu_torch.parallel.pipeline_lm import truncate_pipeline_lm
from mxnet_tpu_torch.passes.servelint import (lint_page_audit,
                                              lint_serve_report)
from mxnet_tpu_torch.serve import DeadlineExceededError
from mxnet_tpu_torch.serve2 import DecodeEngine
from mxnet_tpu_torch.telemetry import metrics

VOCAB, PAD = 32, 32
WIDTHS = dict(vocab=VOCAB, d_model=16, n_heads=2, d_head=8, d_ff=32,
              n_experts=2)
SMALL = dict(page_size=4, max_inflight=4, prefill_buckets=[8],
             max_seq_len=24, device="cpu")


def _tree(seed=0, n_layers=2):
    jp = jinit(seed, n_layers=n_layers, **WIDTHS)
    return jp, pipeline_lm_from_mxnet_tpu(jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def model():
    return _tree()


@pytest.fixture(scope="module")
def oracle(model):
    """Greedy tokens of one prompt by the JAX dense forward."""
    dense = jax.jit(jdense)
    cache = {}

    def greedy(prompt, n_new):
        key = tuple(prompt)
        have = cache.get(key, [])
        toks = list(prompt) + have
        while len(have) < n_new:
            padded = np.zeros((1, PAD), "int32")
            padded[0, :len(toks)] = toks
            lg = np.asarray(dense(model[0], jnp.asarray(padded)))
            have.append(int(lg[0, len(toks) - 1].argmax()))
            toks.append(have[-1])
        cache[key] = have
        return have[:n_new]
    return greedy


@pytest.fixture(scope="module")
def quant_oracle(model):
    """Greedy tokens of one prompt by the JAX PagedLM with a bf16/int8
    pool, one sequence at a time."""
    lms = {}

    def greedy(kv_dtype, prompt, n_new):
        if kv_dtype not in lms:
            lms[kv_dtype] = JPagedLM(model[0], page_size=4, num_pages=8,
                                     max_pages_per_seq=6, kv_dtype=kv_dtype,
                                     name=f"oracle-{kv_dtype}")
        lm = lms[kv_dtype]
        row = np.arange(1, 7, dtype="int32")
        padded = np.zeros((8,), "int32")
        padded[:len(prompt)] = prompt
        nxt, _ = lm.prefill(padded, len(prompt), row)
        out, length = [int(nxt)], len(prompt)
        while len(out) < n_new:
            o, _ = lm.decode(row[None], np.array([length], "int32"),
                             np.array([out[-1]], "int32"),
                             np.ones((1,), "int32"))
            out.append(int(o[0, 0]))
            length += 1
        return out
    return greedy


def _engine(params, **kw):
    args = dict(SMALL, num_pages=32, max_new_default=6)
    args.update(kw)
    eng = DecodeEngine(params, **args)
    eng.warmup()
    return eng


def _audit_errors(eng):
    return [f for f in lint_page_audit(eng.page_audit())
            if f.severity == "error"]


def test_batched_decode_with_preemption_matches_oracle(model, oracle):
    # 5 usable pages; 3 prompts of 6 need 2 pages each at admission and 4
    # by their final length: growth must preempt, and the preempted
    # sequence finishes by recompute
    eng = _engine(model[1], num_pages=6, max_new_default=10, name="pre")
    try:
        rs = np.random.RandomState(5)
        prompts = [rs.randint(0, VOCAB, size=(6,)).tolist()
                   for _ in range(3)]
        handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
        assert eng.run_until_idle(60.0)
        st = eng.stats()
        assert st["preemptions"] >= 1
        assert st["pages"]["pages_used"] == 0
        assert st["recompiles_after_warmup"] == 0
        for p, h in zip(prompts, handles):
            assert h.result.tolist() == oracle(p, 10)
            assert h.t_submit <= h.t_first_token <= h.t_done
    finally:
        eng.close()


def test_scheduler_smoke_rejections_and_stats_keys(model, oracle):
    eng = _engine(model[1], max_new_default=5, name="smoke")
    try:
        rs = np.random.RandomState(1)
        prompts = [rs.randint(0, VOCAB, size=(1 + i % 6,)).tolist()
                   for i in range(6)]
        handles = [eng.submit(p) for p in prompts]
        assert eng.run_until_idle(60.0)
        for p, h in zip(prompts, handles):
            assert h.error is None and h.result.dtype == np.int32
            assert h.result.tolist() == oracle(p, 5)
        st = eng.stats()
        assert st["finished"] == 6 and st["tokens_generated"] == 30
        assert st["ticks"] >= 2
        with pytest.raises(MXNetError):
            eng.submit(np.zeros((25,), "int32"))
        with pytest.raises(MXNetError):
            eng.submit([1, 2], max_new_tokens=100)
        # the stats keys are the JAX engine's (built, never run)
        for kw in ({}, {"prefix_cache": True, "draft_params": model[0],
                        "spec_tokens": 2}):
            jeng = JDecodeEngine(model[0], num_pages=32, name="keys",
                                 **{k: v for k, v in SMALL.items()
                                    if k != "device"}, **kw)
            teng = DecodeEngine(
                model[1], num_pages=32, name="keys-t",
                **SMALL, **{k: (model[1] if k == "draft_params" else v)
                            for k, v in kw.items()})
            try:
                js, ts = jeng.stats(), teng.stats()
                assert set(ts) == set(js)
                for sub in ("pages", "prefix_cache", "spec"):
                    if sub in js:
                        assert set(ts[sub]) == set(js[sub])
            finally:
                jeng.close()
                teng.close()
    finally:
        eng.close()


def test_eos_and_predict_deadline(model):
    eng = _engine(model[1], max_inflight=2, max_seq_len=16, name="eos")
    try:
        first = int(eng.predict(np.asarray([3, 9, 1], "int32"),
                                timeout_ms=60000.0)[0])
        eng.eos_id = first
        out = eng.predict(np.asarray([[3, 9, 1]], "int32"),
                          timeout_ms=60000.0)
        assert out.tolist() == [first]
        eng.eos_id = None
        with pytest.raises(DeadlineExceededError):
            eng.predict(np.asarray([1, 2, 3], "int32"), timeout_ms=0.0)
        with pytest.raises(MXNetError):
            eng.predict(np.zeros((2, 3), "int32"))
    finally:
        eng.close()


def test_prefix_hits_copy_on_write_and_read_only_pages(model, oracle):
    eng = _engine(model[1], prefix_cache=True, name="pfx")
    try:
        prompt = [3, 9, 1, 4, 7]                 # a full page + a tail
        for _ in range(2):
            assert eng.predict(prompt).tolist() == oracle(prompt, 6)
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 1
        assert st["prefill_tokens_avoided"] == 4
        full = [3, 9, 1, 4, 7, 2, 8, 5]          # exactly two pages
        for _ in range(2):
            assert eng.predict(full).tolist() == oracle(full, 6)
        assert eng.stats()["prefix_cache"]["cow_copies"] >= 1
        # another continuation over the shared first page leaves it
        # bit-unchanged
        shared = eng.prefix.cached_pages()
        page = eng.page_size
        slots = np.concatenate([np.arange(p * page, (p + 1) * page)
                                for p in shared])
        before = eng.lm.pools["k"][:, slots].clone()
        other = [3, 9, 1, 4, 6, 2]
        assert eng.predict(other).tolist() == oracle(other, 6)
        assert eng.lm.pools["k"][:, slots].equal(before)
        assert eng.stats()["recompiles_after_warmup"] == 0
        assert _audit_errors(eng) == []
        assert eng.stats()["pages"]["pages_used"] == \
            len(eng.prefix.cached_pages())
    finally:
        eng.close()
    assert eng.alloc.stats()["pages_used"] == 0


def test_preempted_sequence_reuses_its_cached_prefix(model, oracle):
    eng = _engine(model[1], num_pages=7, max_new_default=10,
                  prefix_cache=True, name="pre3")
    try:
        rs = np.random.RandomState(5)
        prompts = [rs.randint(0, VOCAB, size=(6,)).tolist()
                   for _ in range(3)]
        handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
        assert eng.run_until_idle(60.0)
        assert eng.stats()["preemptions"] >= 1
        for p, h in zip(prompts, handles):
            assert h.result.tolist() == oracle(p, 10)
        assert _audit_errors(eng) == []
    finally:
        eng.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interleavings_leave_clean_accounts(model, seed):
    rs = np.random.RandomState(seed)
    template = rs.randint(0, VOCAB, size=(4,)).tolist()
    eng = _engine(model[1], num_pages=9, max_inflight=3, max_new_default=4,
                  max_seq_len=16, prefix_cache=True, name=f"prop{seed}")
    try:
        for _ in range(12):
            if rs.rand() < 0.6:
                prompt = template + rs.randint(
                    0, VOCAB, size=(rs.randint(1, 4),)).tolist()
            else:
                prompt = rs.randint(0, VOCAB,
                                    size=(rs.randint(1, 8),)).tolist()
            h = eng.submit(prompt, max_new_tokens=int(rs.randint(1, 5)))
            if rs.rand() < 0.2:
                h.cancelled = True
        assert eng.run_until_idle(60.0)
        assert _audit_errors(eng) == []
        assert eng.stats()["pages"]["pages_used"] == \
            len(eng.prefix.cached_pages())
    finally:
        eng.close()
    assert eng.alloc.stats()["pages_used"] == 0


def test_speculative_decoding_is_exact(model, oracle):
    prompt = [3, 9, 1, 4, 7]
    # the target as its own draft: nearly every draft accepted
    eng = _engine(model[1], max_new_default=9, draft_params=model[1],
                  spec_tokens=3, name="spec-self")
    try:
        assert eng.predict(prompt).tolist() == oracle(prompt, 9)
        st = eng.stats()
        assert st["ticks"] <= 3 and st["spec"]["acceptance_rate"] > 0.7
        assert st["recompiles_after_warmup"] == 0
    finally:
        eng.close()
    # an unrelated draft (other seed, one layer): ~nothing accepted
    eng = _engine(model[1], draft_params=_tree(7, 1)[1], spec_tokens=3,
                  name="spec-bad")
    try:
        for seed in (1, 2):
            p = np.random.RandomState(seed).randint(0, VOCAB, 5).tolist()
            assert eng.predict(p).tolist() == oracle(p, 6)
        assert eng.stats()["spec"]["acceptance_rate"] < 0.7
    finally:
        eng.close()
    # a truncated draft, K = 1, max_new below the window, EOS mid-window
    eng = _engine(model[1], draft_params=truncate_pipeline_lm(model[1], 1),
                  spec_tokens=1, name="spec-trunc")
    try:
        short = [3, 9, 1]
        want = oracle(short, 6)
        assert eng.predict(short).tolist() == want
        h = eng.submit(short, max_new_tokens=1)
        assert eng.run_until_idle(60.0)
        assert h.result.tolist() == want[:1]
        eng.eos_id = want[2]
        assert eng.predict(short).tolist() == \
            want[:want.index(eng.eos_id) + 1]
    finally:
        eng.close()
    # with the prefix cache
    eng = _engine(model[1], draft_params=model[1], spec_tokens=2,
                  prefix_cache=True, name="spec-pfx")
    try:
        for _ in range(2):
            assert eng.predict(prompt).tolist() == oracle(prompt, 6)
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 1 and st["spec"]["proposed"]
        assert _audit_errors(eng) == []
        rep = eng.lint_report()
        assert [f for f in lint_serve_report(rep)
                + lint_serve_report(rep["draft"])
                if f.severity != "info"] == []
    finally:
        eng.close()
    with pytest.raises(MXNetError):
        DecodeEngine(model[1], num_pages=8, draft_params=model[1],
                     spec_tokens=0, **SMALL)
    other_vocab = pipeline_lm_from_mxnet_tpu(jax.tree.map(
        np.asarray, jinit(0, vocab=16, d_model=16, n_layers=1, n_heads=2,
                          d_head=8, d_ff=32, n_experts=2)), "cpu")
    with pytest.raises(MXNetError):
        DecodeEngine(model[1], num_pages=8, draft_params=other_vocab,
                     spec_tokens=2, **SMALL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_quantized_engine_matches_jax_quantized(model, quant_oracle,
                                                kv_dtype):
    eng = _engine(model[1], max_new_default=5, kv_dtype=kv_dtype,
                  prefix_cache=kv_dtype == "int8", name=f"q-{kv_dtype}")
    try:
        rs = np.random.RandomState(3)
        prompts = [rs.randint(0, VOCAB, size=(5,)).tolist()
                   for _ in range(4)]
        handles = [eng.submit(p) for p in prompts]
        assert eng.run_until_idle(60.0)
        for p, h in zip(prompts, handles):
            assert h.result.tolist() == quant_oracle(kv_dtype, p, 5)
        st = eng.stats()
        assert st["kv_dtype"] == kv_dtype
        assert st["recompiles_after_warmup"] == 0
        assert _audit_errors(eng) == []
        assert eng.lm.pools["k"].dtype == {"bf16": torch.bfloat16,
                                           "int8": torch.int8}[kv_dtype]
    finally:
        eng.close()


def test_pools_stay_in_place_and_gauges_retire(model):
    eng = _engine(model[1], prefix_cache=True, draft_params=model[1],
                  spec_tokens=2, name="gauges")
    names = [f"mxserve3_{n}_gauges" for n in (
        "prefix_hits", "prefix_pages_shared", "cow_copies",
        "prefill_tokens_avoided", "spec_proposed", "spec_accepted",
        "accept_rate")] + ["mxserve2_inflight_seqs_gauges",
                           "mxserve2_pages_free_gauges"]
    ptrs = {k: v.data_ptr() for k, v in eng.lm.pools.items()}
    eng.predict([1, 2, 3, 4, 5])
    eng.predict([1, 2, 3, 4, 5, 6])
    assert ptrs == {k: v.data_ptr() for k, v in eng.lm.pools.items()}
    have = metrics.all_metrics()
    assert all(n in have for n in names)
    eng.close()
    have = metrics.all_metrics()
    assert not [n for n in names if n in have]
    assert eng._owner.closed and eng._owner.leaked() == []
