"""Finding records, severity, and the grandfathered-findings baseline.

A finding is one discipline violation with a stable identity: the rule,
the repo-relative file (or the kernel's owning module for graph-layer
findings), and a *context* string — the stripped source line for AST
findings, the kernel/detail pair for graph findings.  Line numbers are
reported for navigation but excluded from the identity, so unrelated
edits moving code around don't churn the baseline.

The baseline file is a checked-in JSON list of finding keys, in the
same format as the JAX package's analyzer, so a baseline written by
either loads in the other.  The lint
CLI fails only on findings whose key is not baselined — new violations
fail CI immediately, grandfathered ones are visible (reported as
``baselined``) but don't block until someone burns them down.
"""

from __future__ import annotations

import dataclasses
import json
import os

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str        # "error" | "warning"
    path: str            # repo-relative file, or dotted module for kernels
    line: int            # 1-based; 0 = whole-module / registry finding
    message: str
    context: str = ""    # stripped source line / kernel detail (identity)

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.severity}: [{self.rule}] {self.message}"


def relpath(path: str, root: "str | None" = None) -> str:
    """Repo-relative POSIX-style path when ``path`` is under ``root``;
    the (normalized) input otherwise — keeps baseline keys stable across
    checkouts."""
    p = os.path.abspath(path)
    if root:
        r = os.path.abspath(root)
        if p == r or p.startswith(r + os.sep):
            p = os.path.relpath(p, r)
    return p.replace(os.sep, "/")


def load_baseline(path: "str | None") -> set[tuple[str, str, str]]:
    """The baselined finding keys; an absent/None file is an empty
    baseline (nothing grandfathered)."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        raw = json.load(f)
    out: set[tuple[str, str, str]] = set()
    for entry in raw:
        out.add((entry["rule"], entry["path"], entry.get("context", "")))
    return out


def write_baseline(path: str, findings: "list[Finding]") -> None:
    entries = sorted(
        {f.key() for f in findings}
    )
    with open(path, "w") as f:
        json.dump(
            [
                dict(rule=r, path=p, context=c)
                for r, p, c in entries
            ],
            f,
            indent=1,
        )
        f.write("\n")


def split_baselined(
    findings: "list[Finding]", baseline: set[tuple[str, str, str]]
) -> "tuple[list[Finding], list[Finding]]":
    """(new, grandfathered) partition of ``findings`` against a baseline."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old
