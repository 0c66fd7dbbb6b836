"""Iteration-level (continuous-batching) scheduler over a PagedLM.

Counterpart of ``mxnet_tpu/serve2/scheduler.py``.
:class:`~mxnet_tpu_torch.serve.engine.ServingEngine` coalesces whole
*requests*; an autoregressive LM needs coalescing at the *iteration*
level — every scheduler tick:

1. **admit** — pop waiting prompts while a batch slot and enough pages
   for the (re)prefill exist; one prefill program run per admit (padded
   to the prompt rung ladder), which also emits the first token. With
   **prefix caching** on (serve3), the effective prompt's full pages
   are content-hashed first: cached pages are SHARED (refcounted,
   read-only) and only the uncovered suffix runs through
   ``prefill_ext`` — identical templated prompts across requests pay
   prefill once. A fully-covered prompt copy-on-writes its final page
   (``mxserve3_cow_copies``) and recomputes just the last position's
   logits;
2. **grow** — give every running sequence the page its next window
   needs; a write that would land in a still-shared page goes through
   copy-on-write first (structurally rare — shared pages are full by
   construction — but the contract servelint audits). On pool
   exhaustion, **evict** idle prefix-cache pages, then **preempt** the
   youngest running sequence (free its pages, requeue it at the FRONT
   with its progress folded into an effective prompt —
   recompute-style preemption, so a preempted sequence's greedy
   trajectory is unchanged);
3. **step** — pack all running sequences into the smallest decode
   batch rung and make ONE decode call for everyone. Plain mode:
   the n-step decode program. **Speculative mode** (serve3, a draft
   model was given): the draft proposes K tokens per row in one small
   dispatch, then the target verifies all candidates in ONE batched
   forward (``PagedLM.verify``) — greedy acceptance is exact, so the
   emitted trajectory is token-for-token the target's own; the
   acceptance rate rides ``mxserve3_accept_rate_<engine>``. Append the
   accepted tokens, then finish (free pages, resolve handles)
   sequences that hit ``max_new_tokens`` / EOS / cancellation.

Because admit/finish/preempt only edit host-side block tables, the
device programs never see a new shape: the set of signatures stays
closed under any arrival pattern, as the serve/ bucket ladder's does.
Every device call is issued by the scheduler thread.

The engine runs its scheduler on one background thread; ``submit``
returns a :class:`GenerationHandle`, and ``predict`` (the router/
endpoint-facing call, same duck type as ``ServingEngine.predict``)
submits and waits. Telemetry: ``mxserve2_inflight_seqs_<engine>`` /
``mxserve2_waiting_seqs_<engine>`` gauges, ``mxserve2_preemptions_total`` /
``mxserve2_ticks_total`` / ``mxserve2_tokens_total`` counters, page
occupancy via :mod:`~mxnet_tpu_torch.serve2.kvcache`. Each
:class:`GenerationHandle` carries its host timestamps (submit, first
token, done), from which time to first token and time per output token
are read.

Left out here, each with its ROADMAP Queue A item: the tuning database's
knob consult (8), the fault-injection site at submit (7), and the trace
spans and crash dump (8). Knob resolution is kwarg > flag.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import config
from ..base import MXNetError
from ..context import resolve_device
from ..telemetry import metrics as _metrics
from ..serve.batcher import (BatcherStoppedError, DeadlineExceededError,
                             InvalidRequestError)
from ..serve.buckets import BucketOverflowError
from .decode import PagedLM, decode_rungs_for
from .kvcache import (BlockTable, PageAllocator, PagePoolExhausted,
                      _gauge_tag, pages_needed)
from .prefix import PrefixCache, page_keys

__all__ = ["DecodeEngine", "EngineCrashedError", "GenerationHandle"]


class EngineCrashedError(BatcherStoppedError):
    """The engine's scheduler thread died. Unlike a draining/stopped
    engine (plain :class:`BatcherStoppedError`, a transient load
    signal), a crashed engine is DEAD: the router records a breaker
    failure so traffic routes around the replica."""


class GenerationHandle:
    """One in-flight generation. ``wait()`` blocks for the result
    (an int32 numpy array of generated token ids, EOS included).
    ``t_submit``, ``t_first_token`` and ``t_done`` are host
    ``time.perf_counter()`` stamps (the first token is the prefill's;
    a preempted sequence keeps its first stamp)."""

    __slots__ = ("event", "result", "error", "sid", "cancelled",
                 "t_submit", "t_first_token", "t_done")

    def __init__(self, sid: int):
        self.event = threading.Event()
        self.result: Optional[onp.ndarray] = None
        self.error: Optional[BaseException] = None
        self.sid = sid
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)

    def done(self) -> bool:
        return self.event.is_set()


class _Seq:
    __slots__ = ("sid", "prompt", "generated", "max_new", "bt",
                 "handle", "admit_idx", "_keys", "_keys_len",
                 "t_submit_ns", "t_admit_ns")

    def __init__(self, sid: int, prompt: List[int], max_new: int):
        self.sid = sid
        self.prompt = prompt
        self.generated: List[int] = []
        self.max_new = max_new
        self.bt: Optional[BlockTable] = None
        self.handle = GenerationHandle(sid)
        self.admit_idx = -1  # monotone per (re)admission: preemption age
        self.t_submit_ns = time.perf_counter_ns()
        self.t_admit_ns: Optional[int] = None
        # memoized prefix-cache chain keys for the effective prompt of
        # this length: a pool-pressure requeue retries admission every
        # tick, and re-hashing the whole prompt each time would burn
        # O(prompt) host work during exactly the overloaded periods
        self._keys: List[bytes] = []
        self._keys_len = -1

    def effective_prompt(self) -> List[int]:
        """Prompt for (re)prefill: original prompt plus progress — a
        preempted sequence recomputes its cache AND its next token from
        this, so greedy decoding continues exactly where it stopped."""
        return self.prompt + self.generated


class DecodeEngine:
    """Continuous-batching LM serving engine. See module docstring.

    ``params`` is an :func:`init_pipeline_lm` tree; flags supply the
    pool geometry and concurrency defaults (``MXSERVE2_*``). The model
    and pools live on ``device`` (default ``"cuda"``; a host without a
    GPU raises unless the caller passes ``device="cpu"``).
    """

    def __init__(self, params: Dict, *, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_new_default: int = 16, eos_id: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 decode_steps: Optional[int] = None,
                 attention: str = "auto",
                 draft_params: Optional[Dict] = None,
                 spec_tokens: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_pages: Optional[int] = None,
                 name: str = "lm", pagewire_chunk: int = 0,
                 device="cuda"):
        self.name = name
        self.device = resolve_device(device)

        def _knob(kwarg, flag):
            return kwarg if kwarg is not None else config.get(flag)

        # fleet page streaming (pagewire) waits for ROADMAP item 8
        if pagewire_chunk:
            raise MXNetError("pagewire_chunk > 0 (fleet page streaming) "
                             "waits for ROADMAP Queue A item 8")
        self.decode_steps = int(
            _knob(decode_steps, "MXSERVE2_DECODE_STEPS"))
        # serve3 legs, each independently gated (flags or kwargs)
        self.kv_dtype = str(_knob(kv_dtype, "MXSERVE3_KV_DTYPE"))
        self.spec_tokens = int(
            spec_tokens if spec_tokens is not None
            else config.get("MXSERVE3_SPEC_TOKENS"))
        if draft_params is not None and self.spec_tokens < 1:
            raise MXNetError(
                "a draft model was given but spec_tokens resolves to "
                f"{self.spec_tokens} — pass spec_tokens>=1 or set "
                "MXSERVE3_SPEC_TOKENS")
        self.spec = draft_params is not None and self.spec_tokens >= 1
        self.prefix_enabled = bool(
            prefix_cache if prefix_cache is not None
            else config.get("MXSERVE3_PREFIX_CACHE"))
        self.page_size = int(_knob(page_size, "MXSERVE2_PAGE_SIZE"))
        self.num_pages = int(_knob(num_pages, "MXSERVE2_NUM_PAGES"))
        self.max_inflight = int(
            _knob(max_inflight, "MXSERVE2_MAX_INFLIGHT"))
        if prefill_buckets is None:
            prefill_buckets = [
                int(t) for t in
                str(config.get("MXSERVE2_PREFILL_BUCKETS")).split(",")
                if t.strip()]
        self.max_new_default = int(max_new_default)
        self.eos_id = eos_id
        top_prefill = max(int(b) for b in prefill_buckets)
        self._configured_prefill_top = top_prefill
        if max_seq_len is None:
            max_seq_len = top_prefill + 4 * self.max_new_default
        self.max_seq_len = int(max_seq_len)
        self.max_pages_per_seq = pages_needed(self.max_seq_len,
                                              self.page_size)
        # re-prefill after preemption may carry prompt+progress past the
        # configured rungs; one extra rung at max_seq_len keeps that
        # path inside the closed cache too
        self.prefill_rungs: Tuple[int, ...] = tuple(sorted(
            {int(b) for b in prefill_buckets} | {self.max_seq_len}))
        self.decode_rungs: Tuple[int, ...] = \
            decode_rungs_for(self.max_inflight)
        self.lm = PagedLM(params, page_size=self.page_size,
                          num_pages=self.num_pages,
                          max_pages_per_seq=self.max_pages_per_seq,
                          name=name, device=self.device,
                          # speculative mode replaces the n-step decode
                          # dispatch with propose/verify: the target's
                          # decode program stays at 1 step (fallback
                          # only, warmed but unused in steady state)
                          decode_steps=(1 if self.spec
                                        else self.decode_steps),
                          attention=attention, kv_dtype=self.kv_dtype)
        self.draft: Optional[PagedLM] = None
        if self.spec:
            dv = draft_params["head"].shape[1]
            if int(dv) != int(self.lm.vocab):
                raise MXNetError(
                    f"draft vocab {dv} != target vocab {self.lm.vocab}")
            # the draft shares the TARGET's block tables and page ids —
            # its own (small) pools are indexed by the same slots, so
            # one allocator runs both. decode_steps = K+1: the extra
            # iteration exists to append the K-th draft token's own
            # draft-KV, which the next tick's proposal run attends to
            # when all K drafts get accepted. Draft pools stay f32 —
            # they are ~(draft_layers/target_layers) of an already
            # small pool, and draft quality is the acceptance rate.
            self.draft = PagedLM(
                draft_params, page_size=self.page_size,
                num_pages=self.num_pages,
                max_pages_per_seq=self.max_pages_per_seq,
                name=f"{name}-draft", device=self.device,
                decode_steps=self.spec_tokens + 1,
                attention=attention, kv_dtype="f32")
        self.alloc = PageAllocator(self.num_pages, self.page_size,
                                   name=name)
        self.prefix: Optional[PrefixCache] = None
        if self.prefix_enabled:
            cap = int(_knob(prefix_cache_pages,
                            "MXSERVE3_PREFIX_CACHE_PAGES"))
            self.prefix = PrefixCache(self.alloc, capacity_pages=cap)
        from ..serve.engine import InputSpec
        self.input_specs = [InputSpec((top_prefill,), "int32",
                                      name="tokens")]
        self._cv = threading.Condition()
        self._waiting: "deque[_Seq]" = deque()
        self._running: List[_Seq] = []
        self._sid = itertools.count()
        self._admit_counter = itertools.count()
        self._stopping = False
        self._draining = False
        self._crashed: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # sequences popped from _waiting whose prefill is in flight
        # with the lock released — still live work (idle/depth checks
        # must count them or a mid-admission engine looks idle)
        self._admitting = 0
        self._n_preempt = 0
        self._n_ticks = 0
        self._n_tokens = 0
        self._n_finished = 0
        self._n_cow = 0
        self._n_prefix_hits = 0
        self._n_tokens_avoided = 0
        self._n_spec_proposed = 0
        self._n_spec_accepted = 0
        tag = _gauge_tag(name)
        self._m_inflight = _metrics.gauge(
            f"mxserve2_inflight_seqs_{tag}",
            f"sequences currently decoding in engine {name!r}")
        self._m_waiting = _metrics.gauge(
            f"mxserve2_waiting_seqs_{tag}",
            f"sequences queued for admission in engine {name!r}")
        self._m_preempt = _metrics.counter(
            "mxserve2_preemptions_total",
            "sequences preempted on KV page-pool exhaustion")
        self._m_ticks = _metrics.counter(
            "mxserve2_ticks_total", "scheduler decode ticks")
        self._m_tokens = _metrics.counter(
            "mxserve2_tokens_total", "tokens generated by serve2")
        # per-engine instruments, keyed by engine name so sibling
        # replicas never overwrite each other's; all retired on close()
        self._m_prefix_hits = _metrics.counter(
            f"mxserve3_prefix_hits_{tag}",
            f"admissions that reused >=1 cached prefix page in engine "
            f"{name!r}")
        self._m_pages_shared = _metrics.gauge(
            f"mxserve3_prefix_pages_shared_{tag}",
            f"live pages with more than one holder in engine {name!r}")
        self._m_cow = _metrics.counter(
            f"mxserve3_cow_copies_{tag}",
            f"copy-on-write page copies in engine {name!r}")
        self._m_tokens_avoided = _metrics.counter(
            f"mxserve3_prefill_tokens_avoided_{tag}",
            f"prompt positions served from the prefix cache instead of "
            f"prefill compute in engine {name!r}")
        self._m_spec_proposed = _metrics.counter(
            f"mxserve3_spec_proposed_{tag}",
            f"draft tokens proposed in engine {name!r}")
        self._m_spec_accepted = _metrics.counter(
            f"mxserve3_spec_accepted_{tag}",
            f"draft tokens accepted by target verify in engine "
            f"{name!r}")
        self._m_accept_rate = _metrics.gauge(
            f"mxserve3_accept_rate_{tag}",
            f"cumulative draft-acceptance rate in engine {name!r}")
        # owner token: every per-engine instrument above is adopted here
        # and unregistered before close() closes the token
        self._owner = _metrics.owner(f"DecodeEngine:{name}")
        self._owner.adopt(
            self._m_inflight, self._m_waiting, self._m_prefix_hits,
            self._m_pages_shared, self._m_cow, self._m_tokens_avoided,
            self._m_spec_proposed, self._m_spec_accepted,
            self._m_accept_rate, *self.alloc.gauge_names())
        # per-request phase decomposition (global histograms: p50/p99
        # over the registry's reservoir)
        self._h_queue = _metrics.histogram(
            "mxtrace_phase_queue_seconds",
            "serve2 request phase: submit to scheduler admission pop")
        self._h_admit = _metrics.histogram(
            "mxtrace_phase_admission_seconds",
            "serve2 request phase: page alloc + prefix lookup + "
            "prefill dispatch")
        self._h_prefill = _metrics.histogram(
            "mxtrace_phase_prefill_seconds",
            "serve2 prefill/prefill_ext dispatch within admission")
        self._h_decode = _metrics.histogram(
            "mxtrace_phase_decode_seconds",
            "serve2 request phase: admission end to sequence finish")

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def warmup(self, input_specs=None) -> List[dict]:
        """Run every decode batch rung and prefill length rung once
        (the ``ServingEngine.warmup`` contract; ``input_specs`` is
        accepted for duck-type compatibility and ignored). The prefix
        and speculative legs run their extra programs only when on."""
        report = self.lm.warmup(
            self.decode_rungs, self.prefill_rungs,
            verify_width=(self.spec_tokens + 1 if self.spec else 0),
            prefill_ext=self.prefix is not None,
            copy_page=self.prefix is not None)
        if self.draft is not None:
            for row in self.draft.warmup(
                    self.decode_rungs, self.prefill_rungs,
                    prefill_ext=self.prefix is not None,
                    copy_page=self.prefix is not None):
                report.append(dict(row, program=f"draft-{row['program']}"))
        return report

    @property
    def warmed(self) -> bool:
        return self.lm.warmed and (self.draft is None
                                   or self.draft.warmed)

    def submit(self, prompt, max_new_tokens: Optional[int] = None
               ) -> GenerationHandle:
        """Enqueue one prompt (1-D int sequence); non-blocking."""
        prompt = [int(t) for t in onp.asarray(prompt).reshape(-1)]
        if not prompt:
            raise InvalidRequestError("empty prompt")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_default)
        if max_new < 1:
            raise InvalidRequestError("max_new_tokens must be >= 1")
        # cap on the CONFIGURED buckets, not the internal max_seq_len
        # rung that only exists for post-preemption re-prefills — the
        # MXSERVE2_PREFILL_BUCKETS doc promises rejection past its top
        top = self._configured_prefill_top
        if len(prompt) > min(top, self.max_seq_len):
            raise BucketOverflowError(
                f"prompt of {len(prompt)} tokens exceeds the prefill "
                f"ladder top {top} / max_seq_len {self.max_seq_len}")
        if len(prompt) + max_new > self.max_seq_len:
            raise BucketOverflowError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_seq_len {self.max_seq_len}")
        if pages_needed(len(prompt) + max_new, self.page_size) \
                > self.num_pages - 1:
            raise PagePoolExhausted(
                f"request needs more pages than the whole pool "
                f"({self.num_pages - 1}) holds")
        seq = _Seq(next(self._sid), prompt, max_new)
        with self._cv:
            if self._crashed is not None:
                raise EngineCrashedError(
                    f"engine {self.name!r} scheduler crashed: "
                    f"{self._crashed!r}") from self._crashed
            if self._stopping or self._draining:
                raise BatcherStoppedError(
                    f"engine {self.name!r} is "
                    + ("draining" if self._draining else "stopped"))
            self._waiting.append(seq)
            self._m_waiting.set(len(self._waiting))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name=f"{self.name}-decode",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return seq.handle

    def predict(self, data, timeout_ms: Optional[float] = None):
        """Router/endpoint-facing call: submit one prompt, wait for the
        generated ids. ``data`` is a 1-D token sequence (a single-row
        2-D array is flattened). Same error surface as
        ``ServingEngine.predict``."""
        arr = onp.asarray(data)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1:
            raise InvalidRequestError(
                f"DecodeEngine.predict takes one prompt (1-D token "
                f"ids), got shape {arr.shape}")
        handle = self.submit(arr)
        budget = timeout_ms / 1000.0 if timeout_ms is not None else None
        if not handle.wait(budget):
            handle.cancelled = True
            with self._cv:
                self._cv.notify_all()
            raise DeadlineExceededError(
                f"generation exceeded {timeout_ms} ms "
                f"(engine {self.name!r})")
        if handle.error is not None:
            raise handle.error
        return handle.result

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def _loop(self):
        try:
            while True:
                with self._cv:
                    while not (self._waiting or self._running
                               or self._stopping):
                        self._cv.wait()
                    if self._stopping and not (self._waiting
                                               or self._running):
                        return
                self.tick()
                with self._cv:
                    # wake run_until_idle/drain waiters — they re-check
                    # the queues themselves
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — fail fast, loudly
            self._crash(e)

    def _crash(self, exc: BaseException):
        with self._cv:
            self._crashed = exc
            self._stopping = True
            pending = list(self._waiting) + list(self._running)
            self._waiting.clear()
            self._running = []
            self._cv.notify_all()
        err = EngineCrashedError(
            f"engine {self.name!r} scheduler crashed: {exc!r}")
        err.__cause__ = exc
        for s in pending:
            if s.bt is not None and s.bt.pages:
                try:
                    self.alloc.free(s.bt.pages)
                except MXNetError:
                    pass
            s.handle.error = err
            s.handle.t_done = time.perf_counter()
            s.handle.event.set()

    def tick(self):
        """One scheduler iteration: admit, grow/preempt, decode-window,
        finish. Callers must NOT hold ``_cv`` — the tick takes it for
        host-side bookkeeping only and releases it around the device
        calls, so ``submit``/``queue_depth`` (the
        router's depth-aware pick) stay responsive during a window.
        Sequence state (``bt``/``generated``) is mutated by the
        scheduler thread only, so reading it between lock windows is
        safe."""
        # -- admit ------------------------------------------------------
        while True:
            with self._cv:
                seq = None
                while self._waiting and \
                        len(self._running) < self.max_inflight:
                    cand = self._waiting[0]
                    if cand.handle.cancelled:
                        self._waiting.popleft()
                        self._resolve(cand)
                        continue
                    self._waiting.popleft()
                    self._admitting += 1
                    seq = cand
                    break
            if seq is None:
                break
            t_pop = time.perf_counter_ns()
            self._h_queue.observe((t_pop - seq.t_submit_ns) / 1e9)
            try:
                # prefix-cache lookup + page alloc + (suffix) prefill;
                # device calls inside, lock released
                admitted = self._admit_one(seq)
            except BaseException:
                # put the seq back where _crash (via the caller's
                # except) can see and fail it — never strand a handle
                with self._cv:
                    self._admitting -= 1
                    self._waiting.appendleft(seq)
                raise
            if not admitted:
                # the pool cannot host this request right now, even
                # after evicting idle prefix-cache pages: requeue at
                # the FRONT (arrival order preserved) and stop
                # admitting until decode progress frees pages. The
                # queue stamp re-arms so the next queue phase covers
                # the requeue wait.
                seq.t_submit_ns = time.perf_counter_ns()
                with self._cv:
                    self._admitting -= 1
                    self._waiting.appendleft(seq)
                break
            seq.t_admit_ns = time.perf_counter_ns()
            self._h_admit.observe((seq.t_admit_ns - t_pop) / 1e9)
            with self._cv:
                self._admitting -= 1
                self._n_tokens += 1
                self._m_tokens.inc()
                seq.admit_idx = next(self._admit_counter)
                self._running.append(seq)
                self._finish_if_done(seq)
        # -- grow / preempt --------------------------------------------
        # each running sequence needs page capacity for its next
        # dispatch WINDOW: decode_steps tokens plain, or the K drafts +
        # 1 corrected token of a speculative propose/verify
        win = (self.spec_tokens + 1) if self.spec else self.decode_steps
        with self._cv:
            for seq in list(self._running):
                if seq not in self._running:
                    continue  # preempted below while growing another
                want = min(win, seq.max_new - len(seq.generated))
                while seq in self._running and seq.bt.needs_page(want):
                    try:
                        seq.bt.pages.extend(self._grow_page())
                    except PagePoolExhausted:
                        victim = max(self._running,
                                     key=lambda s: s.admit_idx)
                        self._preempt(victim)
                if self.prefix is not None and seq in self._running:
                    # shared pages are read-only: CoW anything the
                    # coming window would write into
                    self._cow_guard(seq, want)
            seqs = sorted(self._running, key=lambda s: s.admit_idx)
        # -- decode window ----------------------------------------------
        if seqs:
            n = len(seqs)
            rung = min(r for r in self.decode_rungs if r >= n)
            N = self.max_pages_per_seq
            bt = onp.zeros((rung, N), "int32")
            lengths = onp.zeros((rung,), "int32")
            tokens = onp.zeros((rung,), "int32")
            remaining = onp.zeros((rung,), "int32")
            for i, s in enumerate(seqs):
                s.bt.row(N, out=bt[i])
                lengths[i] = s.bt.length
                tokens[i] = s.generated[-1]
                remaining[i] = min(win, s.max_new - len(s.generated))
            # device calls, lock released
            if self.spec:
                # propose: one draft call of K+1 steps (the extra one
                # appends the K-th draft token's own draft K/V for the
                # next tick), its tokens left on the device
                W = self.spec_tokens + 1
                d_out, _ = self.draft.decode_device(bt, lengths, tokens,
                                                    remaining)
                first, = self.lm.to_device(tokens)
                cands = torch.cat([first[:, None], d_out[:, :W - 1]],
                                  dim=1)
                # verify: one batched target forward over all W
                # candidates of every row, one copy to the host
                out, acc, _ = self.lm.verify(bt, lengths, cands,
                                             remaining)
            else:
                out, _ = self.lm.decode(bt, lengths, tokens, remaining)
                acc = remaining
            with self._cv:
                for i, s in enumerate(seqs):
                    taken = int(acc[i])
                    new_toks = [int(t) for t in out[i, :taken]]
                    if self.eos_id is not None \
                            and self.eos_id in new_toks:
                        new_toks = new_toks[
                            :new_toks.index(self.eos_id) + 1]
                    s.bt.length += taken
                    s.generated.extend(new_toks)
                    self._n_tokens += len(new_toks)
                    self._m_tokens.inc(len(new_toks))
                if self.spec:
                    # acceptance telemetry: drafts offered vs drafts
                    # that survived verify (the corrected token is not
                    # a draft, so budget-clamped rows may undercount
                    # by one — telemetry, not accounting)
                    proposed = int(onp.sum(onp.minimum(
                        self.spec_tokens, remaining[:n])))
                    accepted = int(onp.sum(onp.maximum(
                        acc[:n].astype("int64") - 1, 0)))
                    self._n_spec_proposed += proposed
                    self._n_spec_accepted += accepted
                    self._m_spec_proposed.inc(proposed)
                    self._m_spec_accepted.inc(accepted)
                    if self._n_spec_proposed:
                        self._m_accept_rate.set(
                            self._n_spec_accepted
                            / self._n_spec_proposed)
                for s in seqs:
                    self._finish_if_done(s)
        with self._cv:
            self._n_ticks += 1
            self._m_ticks.inc()
            self._m_inflight.set(len(self._running))
            self._m_waiting.set(len(self._waiting))
            if self.prefix is not None:
                self._m_pages_shared.set(self.alloc.shared_pages())

    # ------------------------------------------------------------------
    # admission / page management (serve3 prefix caching + CoW)
    # ------------------------------------------------------------------
    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting idle prefix-cache pages under
        pressure; None when the pool genuinely cannot host them."""
        try:
            return self.alloc.alloc(n)
        except PagePoolExhausted:
            if self.prefix is None:
                return None
            missing = n - self.alloc.free_pages
            if self.prefix.evict(max(1, missing)) <= 0:
                return None
            try:
                return self.alloc.alloc(n)
            except PagePoolExhausted:
                return None

    def _grow_page(self) -> List[int]:
        """One more page for a running sequence; cache-evicting like
        :meth:`_alloc_pages` but raising (the grow loop's preemption
        path handles exhaustion)."""
        got = self._alloc_pages(1)
        if got is None:
            raise PagePoolExhausted(
                f"pool {self.name!r} exhausted (cache empty)")
        return got

    def _admit_one(self, seq: _Seq) -> bool:
        """Allocate pages for ``seq`` — reusing cached prefix pages
        when the prefix cache covers leading full pages of the
        effective prompt — then run the (suffix) prefill and emit the
        first token. Called with ``_cv`` RELEASED (device calls
        inside). Returns False when the pool cannot host the request
        even after evicting idle cache pages (caller requeues)."""
        page = self.page_size
        eff = seq.effective_prompt()
        total = pages_needed(len(eff), page)
        keys: List[bytes] = []
        shared: List[int] = []
        if self.prefix is not None:
            if seq._keys_len != len(eff):
                # effective prompt only changes across preemptions —
                # retried admissions reuse the memoized chain keys
                seq._keys = page_keys(eff, page)
                seq._keys_len = len(eff)
            keys = seq._keys
            shared = self.prefix.lookup(keys)   # increfed for us
        cow_src: Optional[int] = None
        if shared and len(shared) * page == len(eff):
            # FULL coverage: every position is cached, but the next
            # token still needs the final position's logits — and its
            # K/V write would land inside the last shared page. Pop it
            # for copy-on-write and recompute just that one position
            # into the private copy.
            cow_src = shared.pop()
        start = len(shared) * page
        new_pages = self._alloc_pages(total - len(shared))
        if new_pages is None:
            undo = shared + ([cow_src] if cow_src is not None else [])
            if undo:
                self.alloc.free(undo)
            return False
        held = shared + new_pages \
            + ([cow_src] if cow_src is not None else [])
        try:
            bt = BlockTable(page)
            if cow_src is not None:
                dst = new_pages[0]
                self.lm.copy_page(cow_src, dst)
                if self.draft is not None:
                    self.draft.copy_page(cow_src, dst)
                self.alloc.free([cow_src])      # drop our lookup ref
                held.remove(cow_src)
                bt.pages = shared + [dst] + new_pages[1:]
                start = len(eff) - 1
                self._n_cow += 1    # only the loop thread admits
                self._m_cow.inc()
            else:
                bt.pages = shared + new_pages
            # from here cleanup ownership moves to the block table
            # (the crash path frees seq.bt.pages)
            seq.bt = bt
            bt_row = bt.row(self.max_pages_per_seq)
            t_pf = time.perf_counter_ns()
            if start > 0:
                suffix = eff[start:]
                rung = min(r for r in self.prefill_rungs
                           if r >= len(suffix))
                padded = onp.zeros((rung,), "int32")
                padded[:len(suffix)] = suffix
                nxt, _ = self.lm.prefill_ext(padded, start, len(suffix),
                                             bt_row)
                if self.draft is not None:
                    self.draft.prefill_ext(padded, start, len(suffix),
                                           bt_row)
                self._n_prefix_hits += 1
                self._m_prefix_hits.inc()
                self._n_tokens_avoided += start
                self._m_tokens_avoided.inc(start)
            else:
                rung = min(r for r in self.prefill_rungs
                           if r >= len(eff))
                padded = onp.zeros((rung,), "int32")
                padded[:len(eff)] = eff
                nxt, _ = self.lm.prefill(padded, len(eff), bt_row)
                if self.draft is not None:
                    self.draft.prefill(padded, len(eff), bt_row)
            self._h_prefill.observe(
                (time.perf_counter_ns() - t_pf) / 1e9)
        except BaseException:
            if seq.bt is None and held:
                self.alloc.free(held)           # never leak references
            raise
        bt.length = len(eff)
        seq.generated.append(int(nxt))
        if seq.handle.t_first_token is None:
            seq.handle.t_first_token = time.perf_counter()
        if self.prefix is not None:
            # hit statistics land only when the admission LANDS — a
            # pool-pressure requeue retries the lookup every tick, and
            # counting those would report phantom hits forever.
            # `start` is the EXACT positions saved (a CoW admission
            # recomputes one), so both tokens_avoided surfaces agree
            self.prefix.record_admission(
                len(shared) + (1 if cow_src is not None else 0),
                tokens_avoided=start)
            if keys:
                # index this admission's full pages for future sharing
                # — their content was produced by prefill just now (or
                # is the already-indexed shared prefix; register skips
                # those)
                self.prefix.register(keys, bt.pages[:len(keys)])
            self._m_pages_shared.set(self.alloc.shared_pages())
        return True

    def _cow_guard(self, seq: _Seq, want: int) -> None:
        """Copy-on-write anything the coming window would write into
        that another holder shares. Structurally unreachable through
        this scheduler (shared pages are always-FULL prefix pages and
        writes land at ``pos >= length``), but the audited contract —
        and the safety net for beam-style callers sharing mid-table
        pages. Runs under ``_cv`` (holders cannot change mid-check);
        the copy dispatch is tiny and fires ~never in steady state."""
        page = self.page_size
        want = max(1, int(want))
        lo = seq.bt.length // page
        hi = min((seq.bt.length + want - 1) // page,
                 len(seq.bt.pages) - 1)
        for idx in range(lo, hi + 1):
            src = seq.bt.pages[idx]
            if self.alloc.refcount(src) <= 1:
                continue
            got = self._alloc_pages(1)
            if got is None:
                victim = max(self._running, key=lambda s: s.admit_idx)
                self._preempt(victim)
                if victim is seq:
                    return
                got = self._alloc_pages(1)
                if got is None:
                    self._preempt(seq)
                    return
            dst = got[0]
            self.lm.copy_page(src, dst)
            if self.draft is not None:
                self.draft.copy_page(src, dst)
            seq.bt.pages[idx] = dst
            self.alloc.free([src])
            self._n_cow += 1
            self._m_cow.inc()

    def _preempt(self, seq: _Seq):
        """Recompute-preemption: drop the cache, requeue at the front.
        The generated-so-far tokens fold into the effective prompt, so
        the continuation is greedy-identical to an uninterrupted run."""
        self.alloc.free(seq.bt.pages)
        seq.bt = None
        self._running.remove(seq)
        self._waiting.appendleft(seq)
        self._n_preempt += 1
        self._m_preempt.inc()
        self._m_waiting.set(len(self._waiting))
        # close the preempted decode phase (it lands in the decode
        # histogram: preemption storms must not flatter decode p99) and
        # re-arm the queue stamp
        now = time.perf_counter_ns()
        if seq.t_admit_ns is not None:
            self._h_decode.observe((now - seq.t_admit_ns) / 1e9)
        seq.t_admit_ns = None
        seq.t_submit_ns = now

    def _finish_if_done(self, seq: _Seq):
        done = (len(seq.generated) >= seq.max_new
                or (self.eos_id is not None
                    and seq.generated[-1] == self.eos_id)
                or seq.handle.cancelled)
        if not done:
            return
        if seq.bt is not None:
            self.alloc.free(seq.bt.pages)
            seq.bt = None
        self._running.remove(seq)
        self._resolve(seq)

    def _resolve(self, seq: _Seq):
        self._n_finished += 1
        if seq.t_admit_ns is not None:
            now = time.perf_counter_ns()
            self._h_decode.observe((now - seq.t_admit_ns) / 1e9)
            seq.t_admit_ns = None
        seq.handle.result = onp.asarray(seq.generated, "int32")
        seq.handle.t_done = time.perf_counter()
        seq.handle.event.set()

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------
    def run_until_idle(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until no work remains (tests / drain)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            with self._cv:
                self._cv.notify_all()
                if not (self._waiting or self._running
                        or self._admitting):
                    return True
                # work implies a live scheduler thread: submit() starts
                # it under this lock before enqueueing ever returns
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None
                              else 0.1)

    def queue_depth(self) -> int:
        with self._cv:
            return (len(self._waiting) + len(self._running)
                    + self._admitting)

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        return self.run_until_idle(timeout)

    def close(self):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10.0)
        # drop the prefix cache's page references so the pool accounts
        # clean (shared pages a crashed cleanup already released would
        # otherwise look leaked)
        if self.prefix is not None:
            try:
                self.prefix.release_all()
            except MXNetError:
                pass
        # retire the per-engine-name gauges: after a rolling reload the
        # old version's pool must not linger in /metrics as a live one
        self.alloc.retire_gauges()
        _metrics.unregister(self._m_inflight.name)
        _metrics.unregister(self._m_waiting.name)
        for m in (self._m_prefix_hits, self._m_pages_shared,
                  self._m_cow, self._m_tokens_avoided,
                  self._m_spec_proposed, self._m_spec_accepted,
                  self._m_accept_rate):
            _metrics.unregister(m.name)
        # every adopted instrument is retired: close the owner
        self._owner.close()

    def stats(self) -> dict:
        with self._cv:
            waiting, running = len(self._waiting), len(self._running)
        out = {
            "name": self.name,
            "kind": "decode",
            "warmed": self.warmed,
            "inflight": running,
            "waiting": waiting,
            "max_inflight": self.max_inflight,
            "decode_rungs": list(self.decode_rungs),
            "prefill_rungs": list(self.prefill_rungs),
            "max_seq_len": self.max_seq_len,
            "pages": self.alloc.stats(),
            "preemptions": self._n_preempt,
            "ticks": self._n_ticks,
            "tokens_generated": self._n_tokens,
            "finished": self._n_finished,
            "draining": self._draining,
            "kv_dtype": self.kv_dtype,
            "pool_bytes": self.lm.pool_bytes,
        }
        if self.prefix is not None:
            pc = self.prefix.stats()
            pc["cow_copies"] = self._n_cow
            pc["pages_shared"] = self.alloc.shared_pages()
            out["prefix_cache"] = pc
            out["prefill_tokens_avoided"] = self._n_tokens_avoided
        if self.spec:
            out["spec"] = {
                "spec_tokens": self.spec_tokens,
                "proposed": self._n_spec_proposed,
                "accepted": self._n_spec_accepted,
                "acceptance_rate": (
                    self._n_spec_accepted / self._n_spec_proposed
                    if self._n_spec_proposed else None),
            }
        rep = self.lm.lint_report()
        after = rep["recompiles_after_warmup"]
        n_prog = len(rep["compiled"])
        if self.draft is not None:
            drep = self.draft.lint_report()
            after += drep["recompiles_after_warmup"]
            n_prog += len(drep["compiled"])
        out["recompiles_after_warmup"] = after
        out["programs_compiled"] = n_prog
        return out

    def page_audit(self) -> dict:
        """Page-accounting snapshot for the servelint audit: live
        refcounts cross-checked against every reachable holder (the
        running block tables and the prefix cache). ``admitting`` > 0
        means an admission holds references not yet threaded into a
        block table — the audit downgrades attribution mismatches to
        info in that window."""
        with self._cv:
            # refcounts and cache pages are read INSIDE the same _cv
            # window as the block tables: a tick finishing a sequence
            # between the two reads would otherwise tear the snapshot
            # and surface a phantom use-after-free (lock order
            # _cv -> alloc/cache lock matches the scheduler's own)
            seqs = {s.sid: {"pages": list(s.bt.pages),
                            "length": int(s.bt.length)}
                    for s in self._running if s.bt is not None}
            admitting = self._admitting
            refcounts = self.alloc.refcounts()
            cache_pages = (self.prefix.cached_pages()
                           if self.prefix is not None else [])
        return {
            "name": self.name,
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "admitting": admitting,
            "refcounts": refcounts,
            "sequences": seqs,
            "cache_pages": cache_pages,
        }

    def lint_report(self) -> dict:
        """servelint's view: the PagedLM compile report plus the
        scheduler's declared ladders (draft report nested when
        speculating)."""
        rep = self.lm.lint_report()
        rep["max_inflight"] = self.max_inflight
        rep["declared_decode_rungs"] = self.decode_rungs
        rep["declared_prefill_rungs"] = self.prefill_rungs
        if self.draft is not None:
            rep["draft"] = self.draft.lint_report()
        return rep

    def __repr__(self):
        return (f"DecodeEngine({self.name!r}, rungs="
                f"{self.decode_rungs}, pages={self.num_pages}x"
                f"{self.page_size}, warmed={self.warmed})")
