"""steplint: flag optimizers that silently downgrade the fused step.

Counterpart of ``mxnet_tpu/passes/steplint.py``. The fused train step
(:mod:`mxnet_tpu_torch.step`) and the aggregated eager update
(``Optimizer.update_multi``) both need a pure functional ``fused_apply``
on the optimizer. An Optimizer subclass that overrides ``update``
without one still trains, but only through the per-parameter loop: a
``StepFunction`` refuses it and a ``Trainer`` makes O(params) updates a
step. This pass audits the optimizer registry for that. Optimizers that
are eager-only by design are listed in ``KNOWN_EAGER_OPTIMIZERS`` and
reported at info severity; anything else is a warn.
"""
from __future__ import annotations

from typing import List

from . import Finding, Pass

__all__ = ["OptimizerFusionAudit", "KNOWN_EAGER_OPTIMIZERS"]

# registry names whose eager-only update is by design, with the reason
KNOWN_EAGER_OPTIMIZERS = {
    "adadelta": "niche; fused_apply pending demand",
    "adagrad": "sparse lazy-update semantics dominate its use",
    "adamax": "python-side max recursion; niche",
    "dcasgd": "delay-compensation state snapshots weights host-side",
    "ftml": "per-step t enters kernel python arithmetic",
    "ftrl": "proximal shrinkage path; niche",
    "nadam": "host-side m_schedule recurrence is stateful",
    "sgld": "draws host-side Langevin noise per update",
    "signsgd": "sign updates are bandwidth-trivial; eager is fine",
    "signum": "sign updates are bandwidth-trivial; eager is fine",
    "test": "mock optimizer for tests",
}


class OptimizerFusionAudit(Pass):
    """For every registered Optimizer class: if it (or an ancestor below
    the base) overrides ``update``, it should also provide a
    ``fused_apply``, or carry a documented exemption. ``target`` is a
    ``{name: class}`` registry (default: the port's)."""

    name = "steplint"

    def run(self, target=None) -> List[Finding]:
        from ..optimizer import _REGISTRY, Optimizer
        entries = target if target is not None else _REGISTRY
        findings: List[Finding] = []
        seen = set()
        for reg_name in sorted(entries):
            klass = entries[reg_name]
            if not (isinstance(klass, type)
                    and issubclass(klass, Optimizer)):
                continue
            if klass in seen:  # alias registrations
                continue
            seen.add(klass)
            overrides_update = any(
                "update" in c.__dict__ for c in klass.__mro__
                if c is not Optimizer and c is not object)
            if not overrides_update:
                continue
            if klass.fused_apply is not Optimizer.fused_apply:
                continue  # fused path available
            if reg_name in KNOWN_EAGER_OPTIMIZERS:
                findings.append(self.finding(
                    "known-eager-optimizer", klass.__name__, "info",
                    f"{klass.__name__} is eager-only by design: "
                    f"{KNOWN_EAGER_OPTIMIZERS[reg_name]}"))
                continue
            findings.append(self.finding(
                "no-fused-apply", klass.__name__, "warn",
                f"{klass.__name__} overrides update() without a "
                "functional fused_apply — StepFunction refuses it and "
                "Trainer downgrades to the per-param eager loop "
                "(O(params) dispatches per step); implement "
                "fused_apply or add a documented "
                "KNOWN_EAGER_OPTIMIZERS exemption"))
        return findings
