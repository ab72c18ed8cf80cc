"""CLI: ``python -m repro_torch.analysis.lint [paths...]``.

Runs both analyzer layers — the graph lint over the registered kernels
on ``--device`` and the AST lint over the given paths (default
``src/repro_torch``) — diffs the findings against the checked-in
baseline, and exits non-zero iff any *new* (non-grandfathered) finding
exists.

Flags:
  ``--format text|json``   output format (json includes counts + findings)
  ``--baseline PATH``      baseline file (default
                           ``src/repro_torch/analysis/baseline.json``;
                           ``--baseline ""`` disables baselining)
  ``--write-baseline``     rewrite the baseline to grandfather the
                           current findings instead of failing
  ``--no-graph``           skip the graph layer (no kernel imports or runs)
  ``--no-ast``             skip the AST layer
  ``--kernels-from M``     kernel module (dotted name or ``.py`` path)
    to lint instead of the default registry modules; repeatable
  ``--device D``           where the graph layer runs the kernels
                           (default ``cuda``, raising without a card;
                           ``cpu`` runs the plain versions)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .findings import load_baseline, split_baselined, write_baseline

_DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def _repo_root() -> str:
    # src/repro_torch/analysis/lint.py -> the repo root is above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="device-discipline static analyzer (graph + AST layers)",
    )
    ap.add_argument(
        "paths", nargs="*", help="files/directories for the AST layer (default: src/repro_torch)"
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=_DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--no-graph", action="store_true")
    ap.add_argument("--no-ast", action="store_true")
    ap.add_argument(
        "--kernels-from",
        action="append",
        default=None,
        metavar="MODULE",
        help="kernel module (dotted or .py path) for the graph layer",
    )
    ap.add_argument("--device", default="cuda", help="torch device for the graph layer")
    args = ap.parse_args(argv)

    root = _repo_root()
    findings = []

    if not args.no_ast:
        from .ast_lint import lint_paths

        paths = args.paths or [os.path.join(root, "src", "repro_torch")]
        findings.extend(lint_paths(paths, root=root))

    if not args.no_graph:
        from .graph_lint import lint_kernels

        findings.extend(lint_kernels(args.kernels_from, device=args.device))

    baseline_path = args.baseline or None
    if args.write_baseline:
        if not baseline_path:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 2
        write_baseline(baseline_path, findings)
        print(f"baseline written: {len(findings)} finding(s) grandfathered -> {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, grandfathered = split_baselined(findings, baseline)

    if args.format == "json":
        print(
            json.dumps(
                {
                    "new": [f.as_dict() for f in new],
                    "baselined": [f.as_dict() for f in grandfathered],
                    "counts": {
                        "new": len(new),
                        "baselined": len(grandfathered),
                        "total": len(findings),
                    },
                },
                indent=1,
            )
        )
    else:
        for f in new:
            print(f.format())
        for f in grandfathered:
            print(f"{f.format()} [baselined]")
        print(f"{len(new)} new finding(s), {len(grandfathered)} baselined, {len(findings)} total")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
