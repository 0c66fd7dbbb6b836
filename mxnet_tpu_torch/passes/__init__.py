"""Analysis passes of the port: the structured :class:`Finding` record,
the :class:`Pass` base, ``servelint`` and ``steplint``. Counterpart of
``mxnet_tpu/passes/``; the pass manager and the other passes wait for
ROADMAP Queue A item 8."""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["Finding", "Pass", "SEVERITIES"]

# ordered weakest -> strongest
SEVERITIES = ("info", "warn", "error")


class Finding:
    """One structured lint result: the pass, the check, the object it is
    about, a severity and a message (flat fields, one JSON object)."""

    __slots__ = ("pass_name", "check", "obj", "severity", "message", "loc")

    def __init__(self, pass_name: str, check: str, obj: str, severity: str,
                 message: str, loc: Optional[str] = None):
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}; "
                             f"choose from {SEVERITIES}")
        self.pass_name = pass_name
        self.check = check
        self.obj = obj
        self.severity = severity
        self.message = message
        self.loc = loc

    def to_dict(self) -> Dict[str, object]:
        d = {"pass": self.pass_name, "check": self.check, "obj": self.obj,
             "severity": self.severity, "message": self.message}
        if self.loc:
            d["loc"] = self.loc
        return d

    def __repr__(self):
        return (f"[{self.severity.upper()}] {self.pass_name}/{self.check} "
                f"{self.obj}: {self.message}")


class Pass:
    """Base of an analysis pass: a ``name`` and ``run(target) ->
    [Finding]``, which reads its target and changes nothing."""

    name = "pass"

    def run(self, target) -> List[Finding]:
        raise NotImplementedError

    def finding(self, check: str, obj: str, severity: str, message: str,
                loc: Optional[str] = None) -> Finding:
        return Finding(self.name, check, obj, severity, message, loc)
