"""Structured diagnostics: `Diagnostic`, `Report`, `Severity`.

The port's copy of the part of the JAX package's
`analysis/diagnostics.py` that the runtime sanitizers report through
(the graph validator's `CODE_CATALOG` and `GraphValidationError` belong
to passes the port does not have). Every finding has one shape: a
`Diagnostic` with a stable code, a severity, a human message and a short
stable `detail` (the dedup key), collected into a `Report` that renders
for humans and serializes for tooling.
"""
from __future__ import annotations

import dataclasses
import enum
import json

__all__ = ["Severity", "Diagnostic", "Report"]


class Severity(enum.IntEnum):
    """Ordered so max() over a report gives the report's overall level."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding, with optional graph provenance (`node` / `op` /
    `inputs`); `detail` is a short stable discriminator (used for dedup
    and baseline keys), `message` the full human text."""

    code: str
    severity: Severity
    message: str
    node: str | None = None
    op: str | None = None
    inputs: tuple = ()  # ((input_name, shape_or_None, dtype_or_None), ...)
    detail: str = ""

    def __str__(self):
        loc = f" [node {self.node}" + (f" ({self.op})]" if self.op else "]") \
            if self.node else ""
        return f"{self.code} {self.severity}:{loc} {self.message}"

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["severity"] = str(self.severity)
        d["inputs"] = [list(i) for i in self.inputs]
        return d


class Report:
    """An ordered collection of diagnostics with severity filters."""

    def __init__(self, diagnostics=(), graph_name=None):
        self.diagnostics = list(diagnostics)
        self.graph_name = graph_name

    def append(self, diag):
        self.diagnostics.append(diag)

    def extend(self, diags):
        self.diagnostics.extend(diags)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def __bool__(self):
        # truthiness = "has findings"; use .ok for the inverse reading
        return bool(self.diagnostics)

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    @property
    def warnings(self):
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def ok(self):
        """True when nothing error-severity was found."""
        return not self.errors

    def by_code(self, code):
        return [d for d in self.diagnostics if d.code == code]

    def __str__(self):
        name = f" for {self.graph_name}" if self.graph_name else ""
        if not self.diagnostics:
            return f"graph validation{name}: clean"
        lines = [f"graph validation{name}: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        for d in sorted(self.diagnostics, key=lambda d: -int(d.severity)):
            lines.append(f"  {d}")
        return "\n".join(lines)

    def to_json(self, indent=2):
        return json.dumps(
            {"graph": self.graph_name,
             "findings": [d.to_dict() for d in self.diagnostics]},
            indent=indent)
