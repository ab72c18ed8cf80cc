"""Deterministic, seed-keyed fault injection for the exploration runtime.

The long-running layers (the sweep runner, the characterization pool,
the exploration service, the caches and the shard journal) carry *named
injection points* — single calls into this module at the places where
real deployments crash, hang, or corrupt state.  A chaos run arms a
`FaultPlan` (programmatically or through the ``REPRO_FAULTS`` env var,
which spawned pool workers and subprocess sweeps inherit) and every
matching hit then raises, sleeps, hard-exits the process, or truncates a
payload — deterministically, so a failing chaos scenario replays
exactly.

Contract, pinned by tests/test_faults.py and the CI chaos profile:

  * **disabled means invisible** — with no plan armed, `inject` returns
    immediately, `corrupt` returns its payload unchanged, and
    `corrupt_file` leaves the file alone.  The fast path is one module
    attribute read; production behavior is bit-identical with the
    module imported or not.
  * **deterministic** — firing is a pure function of (plan, seed,
    point, hit index).  Probabilistic rules (``prob < 1``) key their
    coin flips on the plan seed + hit index, never on global RNG state.
  * **named points only** — arming a plan validates every rule against
    the `POINTS` registry, so a typo'd point name fails loudly instead
    of silently never firing.

Env format (rules separated by ``;``, fields by ``:``)::

    REPRO_FAULTS="point:action[:match[:after[:count[:hang_s]]]]"
    REPRO_FAULTS_SEED=0

e.g. ``REPRO_FAULTS="pool.task:exit::1:1"`` hard-exits the pool worker
on the second matching task, once.  ``count`` of ``inf`` fires forever.

Cross-process budgets: rule state (hit counters) is per process, but a
chaos run over a spawn pool wants "fail exactly N times *globally*" —
otherwise a retried task landing on a fresh worker re-fires forever.
Setting ``REPRO_FAULTS_ONCE_DIR=<dir>`` coordinates ``count`` through
exclusive-create claim files in that directory: a rule only fires while
it can claim one of its ``count`` slots, no matter which process hits
it.  (``count=inf`` rules ignore the claim dir.)
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter
from contextlib import contextmanager
from random import Random
from typing import Iterable, Sequence

#: The injection-point registry: every call site names one of these.
#: (Also the source of the ARCHITECTURE.md table and the chaos matrix.)
POINTS: dict[str, str] = {
    "pool.task": (
        "characterization pool worker, around one transform application "
        "(detail: 'circuit:transform')"
    ),
    "cha.backend": (
        "characterize_suite front half, per circuit, before the transform "
        "DAG runs (detail: resolved backend name)"
    ),
    "cache.store": (
        "CharacterizationCache JSON writes — stats, application index, "
        "persisted AIGs (detail: target path; corrupt truncates the payload)"
    ),
    "sweep.shard": (
        "sweep runner, before a shard is evaluated (detail: shard circuit "
        "names)"
    ),
    "journal.write": (
        "shard journal publish in ckpt.CheckpointManager (detail: journal "
        "step path; corrupt truncates the on-disk arrays)"
    ),
    "service.process": (
        "exploration service worker, at batch pickup (detail: batch size)"
    ),
}

ACTIONS = ("raise", "hang", "exit", "corrupt")


class FaultError(RuntimeError):
    """The exception an armed ``raise`` rule throws at its point."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One armed fault: fire ``action`` at ``point`` on matching hits.

    ``match`` is a substring filter on the call site's ``detail`` string
    ("" matches every hit).  ``after`` skips that many matching hits
    first; ``count`` bounds how many times the rule fires (None =
    forever).  ``prob`` keeps a seed-keyed coin flip per hit.
    """

    point: str
    action: str
    match: str = ""
    after: int = 0
    count: int | None = 1
    hang_s: float = 3600.0
    prob: float = 1.0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} "
                f"(known: {', '.join(sorted(POINTS))})"
            )
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} (known: {ACTIONS})"
            )


@dataclasses.dataclass
class FaultPlan:
    rules: tuple[FaultRule, ...]
    seed: int = 0
    #: matching hits per rule index (drives after/count accounting)
    hits: Counter = dataclasses.field(default_factory=Counter)
    #: times each point actually fired (observability for tests)
    fired: Counter = dataclasses.field(default_factory=Counter)


_PLAN: FaultPlan | None = None
_ENV_CHECKED = False


def parse_rules(spec: str) -> list[FaultRule]:
    """Parse the ``REPRO_FAULTS`` rule syntax (see module docstring)."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"bad fault rule {part!r} (need point:action)")
        point, action = fields[0], fields[1]
        match = fields[2] if len(fields) > 2 else ""
        after = int(fields[3]) if len(fields) > 3 and fields[3] else 0
        count: int | None = 1
        if len(fields) > 4 and fields[4]:
            count = None if fields[4] == "inf" else int(fields[4])
        hang_s = float(fields[5]) if len(fields) > 5 and fields[5] else 3600.0
        rules.append(
            FaultRule(point, action, match=match, after=after, count=count,
                      hang_s=hang_s)
        )
    return rules


def _load_env() -> None:
    """Arm a plan from ``REPRO_FAULTS`` once (spawned workers inherit the
    env, so a chaos run reaches into pool subprocesses too)."""
    global _ENV_CHECKED, _PLAN
    if _ENV_CHECKED:
        return
    _ENV_CHECKED = True
    spec = os.environ.get("REPRO_FAULTS", "")
    if spec:
        _PLAN = FaultPlan(
            rules=tuple(parse_rules(spec)),
            seed=int(os.environ.get("REPRO_FAULTS_SEED", "0") or "0"),
        )


def configure(rules: "Iterable[FaultRule] | Sequence[FaultRule]",
              seed: int = 0) -> FaultPlan:
    """Arm a plan programmatically (replaces any previous plan)."""
    global _PLAN, _ENV_CHECKED
    _ENV_CHECKED = True  # explicit configuration wins over the env
    _PLAN = FaultPlan(rules=tuple(rules), seed=seed)
    return _PLAN


def disable() -> None:
    """Disarm: every injection point becomes a strict no-op again."""
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = True


def enabled() -> bool:
    _load_env()
    return _PLAN is not None


def active_plan() -> FaultPlan | None:
    _load_env()
    return _PLAN


@contextmanager
def injected(*rules: FaultRule, seed: int = 0):
    """Scoped arming for in-process tests; restores the previous plan."""
    global _PLAN
    _load_env()
    prev = _PLAN
    plan = configure(rules, seed=seed)
    try:
        yield plan
    finally:
        _PLAN = prev


def _claim_slot(rule: FaultRule, i: int) -> bool:
    """Global fire-budget coordination (``REPRO_FAULTS_ONCE_DIR``):
    atomically claim one of the rule's ``count`` slots via exclusive
    file creation; False once every slot is taken by any process."""
    once_dir = os.environ.get("REPRO_FAULTS_ONCE_DIR")
    if not once_dir or rule.count is None:
        return True
    os.makedirs(once_dir, exist_ok=True)
    stem = f"{rule.point}.{rule.action}.{i}".replace("/", "_")
    for k in range(rule.count):
        try:
            fd = os.open(
                os.path.join(once_dir, f"{stem}.{k}"),
                os.O_CREAT | os.O_EXCL | os.O_WRONLY,
            )
        except FileExistsError:
            continue
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return True
    return False


def _matching_rule(point: str, detail: str,
                   actions: tuple[str, ...]) -> FaultRule | None:
    """First armed rule due to fire at this hit, advancing hit counters."""
    plan = _PLAN
    assert plan is not None
    fire = None
    for i, rule in enumerate(plan.rules):
        if rule.point != point or rule.action not in actions:
            continue
        if rule.match and rule.match not in detail:
            continue
        n = plan.hits[i]
        plan.hits[i] = n + 1
        if n < rule.after:
            continue
        if rule.count is not None and n - rule.after >= rule.count:
            continue
        if rule.prob < 1.0:
            if Random(f"{plan.seed}:{point}:{n}").random() >= rule.prob:
                continue
        if fire is None and _claim_slot(rule, i):
            fire = rule
    if fire is not None:
        plan.fired[point] += 1
    return fire


def inject(point: str, detail: str = "") -> None:
    """The crash/hang injection point: a strict no-op unless a plan is
    armed and a ``raise``/``hang``/``exit`` rule matches this hit."""
    if _PLAN is None:
        if _ENV_CHECKED:
            return
        _load_env()
        if _PLAN is None:
            return
    rule = _matching_rule(point, detail, ("raise", "hang", "exit"))
    if rule is None:
        return
    if rule.action == "raise":
        raise FaultError(f"injected fault at {point} ({detail})")
    if rule.action == "hang":
        time.sleep(rule.hang_s)
        return
    # "exit": a hard crash — the pool-worker / kill-9 simulation.  Flush
    # nothing, run no handlers: exactly what SIGKILL looks like from the
    # parent's side.
    os._exit(42)


def corrupt(point: str, data: bytes, detail: str = "") -> bytes:
    """The corruption injection point for in-memory payloads: returns
    ``data`` unchanged unless an armed ``corrupt`` rule matches, in which
    case a seed-keyed truncated prefix is returned."""
    if _PLAN is None:
        if _ENV_CHECKED:
            return data
        _load_env()
        if _PLAN is None:
            return data
    rule = _matching_rule(point, detail, ("corrupt",))
    if rule is None:
        return data
    plan = _PLAN
    frac = 0.1 + 0.8 * Random(f"{plan.seed}:{point}:truncate").random()
    return data[: max(1, int(len(data) * frac))]


def corrupt_file(point: str, path: "str | os.PathLike",
                 detail: str = "") -> None:
    """Truncate an on-disk file in place when an armed ``corrupt`` rule
    matches (the torn-write / bad-sector simulation); no-op otherwise."""
    if _PLAN is None:
        if _ENV_CHECKED:
            return
        _load_env()
        if _PLAN is None:
            return
    rule = _matching_rule(point, str(detail) or str(path), ("corrupt",))
    if rule is None:
        return
    plan = _PLAN
    size = os.path.getsize(path)
    frac = 0.1 + 0.8 * Random(f"{plan.seed}:{point}:truncate").random()
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * frac)))
