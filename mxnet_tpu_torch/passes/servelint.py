"""servelint: the serving tier's closed-signature and page-accounting
contracts.

Counterpart of ``lint_serve_report`` and ``lint_page_audit`` in
``mxnet_tpu/passes/servelint.py`` (:68, :159); the same report dicts give
the same findings. Three invariants the types cannot enforce:

1. **rung-exact shapes** — every decode program's batch size and every
   prefill program's prompt length must be a declared ladder rung (one
   off the ladder means a caller passed a live count instead of padding);
2. **pools updated in place** — on an accelerator the pools must not be
   double-buffered (the JAX package donates them to XLA; the port writes
   them in place and reports ``donate_pages`` true);
3. **page accounting** — a refcount that disagrees with the reachable
   holders (running block tables and the prefix cache) is a leak or a
   use-after-free; no null or duplicate page in a table, and no write
   into a shared page.

The pass manager that runs it over engines waits for ROADMAP Queue A
item 8; callers run the two functions on ``lint_report()`` and
``page_audit()``.
"""
from __future__ import annotations

from collections import Counter
from typing import List

from . import Finding

__all__ = ["lint_serve_report", "lint_page_audit"]


class _Lint:
    name = "servelint"

    def finding(self, check, obj, severity, message, loc=None):
        return Finding(self.name, check, obj, severity, message, loc)


def lint_serve_report(rep: dict) -> List[Finding]:
    """Audit one engine's ``lint_report()`` dict. See module docstring
    for the checks."""
    p = _Lint()
    obj = str(rep.get("name", "<engine>"))
    out: List[Finding] = []
    decode_rungs = set(rep.get("decode_rungs") or ())
    prefill_rungs = set(rep.get("prefill_rungs") or ())
    warmed = bool(rep.get("warmed"))
    compiled = [tuple(c) for c in rep.get("compiled", ())]

    if not warmed:
        out.append(p.finding(
            "not-warmed", obj, "warn",
            "engine was never warmed — the jit cache is open and every "
            "first-arrival shape will compile in the serving path"))

    prefill_ext_rungs = set(rep.get("prefill_ext_rungs") or ())
    rung_sets = {"decode": decode_rungs, "prefill": prefill_rungs,
                 # serve3 programs: the speculative verify compiles per
                 # decode batch rung, the suffix prefill per prompt
                 # rung, the CoW page copy once (size 0, warmed with
                 # the prefix-cache leg)
                 "verify": set(rep.get("verify_rungs") or ()),
                 "prefill_ext": prefill_ext_rungs,
                 "copy_page": {0} if prefill_ext_rungs else set(),
                 # mxfleet pagewire: export/import compile per
                 # streaming chunk size, warmed alongside the rungs
                 "export_pages": set(rep.get("pagewire_rungs") or ()),
                 "import_pages": set(rep.get("pagewire_rungs") or ())}
    for kind, size in compiled:
        rungs = rung_sets.get(kind)
        if rungs is None:
            out.append(p.finding(
                "unknown-program", obj, "warn",
                f"compiled program kind {kind!r} (size {size}) is not "
                "a decode or prefill rung program"))
            continue
        if warmed and size not in rungs:
            out.append(p.finding(
                "off-rung-shape", obj, "error",
                f"{kind} program compiled at size {size}, which is not "
                f"a declared rung {sorted(rungs)} — the silent "
                "per-sequence-length retrace class (some caller passed "
                "a live count instead of padding to the ladder)"))

    if warmed:
        seen = {k: {s for kk, s in compiled if kk == k}
                for k in rung_sets}
        for kind, rungs in rung_sets.items():
            missing = rungs - seen.get(kind, set())
            if missing:
                out.append(p.finding(
                    "warmup-gap", obj, "warn",
                    f"declared {kind} rungs {sorted(missing)} were "
                    "never compiled by warmup — the first live request "
                    "on those rungs will compile in the serving path"))

    after = int(rep.get("recompiles_after_warmup", 0))
    if after:
        out.append(p.finding(
            "recompile-after-warmup", obj, "error",
            f"{after} program(s) compiled after warmup declared the "
            "cache closed (see the recompile auditor's serving2 "
            "entries for the triggering signatures)"))

    backend = rep.get("backend", "cpu")
    donate_mode = rep.get("donate_mode", "auto")
    donated = bool(rep.get("donate_pages"))
    if backend != "cpu" and not donated:
        out.append(p.finding(
            "pool-not-donated", obj, "error",
            f"page pools are NOT donated on backend {backend!r} "
            f"(donate={donate_mode!r}): XLA must keep input and output "
            "pools live simultaneously — double the KV-cache HBM "
            "footprint"))
    elif backend == "cpu" and donate_mode == "off":
        out.append(p.finding(
            "pool-donate-off", obj, "warn",
            "donation explicitly disabled — fine on CPU, but this "
            "config doubles KV HBM the moment it runs on an "
            "accelerator"))
    elif backend == "cpu" and not donated:
        out.append(p.finding(
            "pool-donate-cpu", obj, "info",
            "pools not donated because XLA:CPU does not support "
            "donation; the same engine donates automatically on "
            "TPU/GPU (donate='auto')"))
    return out


def lint_page_audit(audit: dict) -> List[Finding]:
    """Page-accounting audit over a
    :meth:`~mxnet_tpu_torch.serve2.scheduler.DecodeEngine.page_audit`
    snapshot (see module docstring). An in-flight admission
    (``admitting`` > 0) legitimately holds references no block table
    shows yet, so attribution mismatches downgrade to info in that
    window; structural violations (reachable-but-freed page, null or
    duplicate page in a table, shared write target) are errors
    regardless."""
    p = _Lint()
    obj = str(audit.get("name", "<engine>"))
    out: List[Finding] = []
    page_size = int(audit.get("page_size", 1))
    refs = {int(k): int(v)
            for k, v in (audit.get("refcounts") or {}).items()}
    seqs = audit.get("sequences") or {}
    cache_pages = [int(c) for c in (audit.get("cache_pages") or ())]
    admitting = int(audit.get("admitting", 0))

    holders = Counter(cache_pages)
    for sid, s in seqs.items():
        pages = [int(q) for q in s.get("pages", ())]
        if 0 in pages:
            out.append(p.finding(
                "null-page-in-table", obj, "error",
                f"sequence {sid} holds the reserved null page 0 — "
                "masked/dead writes would corrupt every sequence "
                "sharing that scratch space"))
        dup = [q for q, n in Counter(pages).items() if n > 1 and q != 0]
        if dup:
            out.append(p.finding(
                "dup-page-in-table", obj, "error",
                f"sequence {sid} references page(s) {sorted(dup)} more "
                "than once — one position's write would clobber "
                "another's history"))
        for q in pages:
            if q != 0 and refs.get(q, 0) < 1:
                out.append(p.finding(
                    "freed-page-reachable", obj, "error",
                    f"sequence {sid} reaches page {q} whose refcount "
                    "is 0 — use-after-free: the allocator may hand "
                    "that page to another sequence"))
        holders.update(q for q in pages if q != 0)
        # CoW contract: the page the NEXT token write lands in must
        # not be shared (copy-on-write should have privatized it)
        length = int(s.get("length", 0))
        widx = length // page_size
        if 0 <= widx < len(pages):
            wp = pages[widx]
            if refs.get(wp, 0) > 1:
                out.append(p.finding(
                    "shared-write-target", obj, "error",
                    f"sequence {sid}'s next write (position {length}) "
                    f"lands in page {wp} with refcount "
                    f"{refs.get(wp, 0)} — shared pages are read-only; "
                    "copy-on-write must run before the write"))
    for q in cache_pages:
        if refs.get(q, 0) < 1:
            out.append(p.finding(
                "freed-page-reachable", obj, "error",
                f"prefix cache indexes page {q} whose refcount is 0 — "
                "a lookup would hand out a page the allocator already "
                "recycled"))
    for q, r in sorted(refs.items()):
        h = holders.get(q, 0)
        if h == r:
            continue
        sev = "info" if admitting > 0 else "error"
        what = ("leaked reference(s): nothing reachable holds them"
                if r > h else
                "more holders than references: a free raced a share")
        out.append(p.finding(
            "refcount-mismatch", obj, sev,
            f"page {q}: refcount {r} vs {h} reachable holder(s) — "
            f"{what}"
            + (" (an admission is in flight; re-audit at idle)"
               if admitting > 0 else "")))
    return out
