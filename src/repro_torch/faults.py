"""Deterministic fault injection for the durability and serving stack,
the port's own copy of ``repro/faults.py``.

Named sites threaded through the checkpoint writer, the summary store,
the resumable runtime's lock and GC transitions, the registry loader and
the query server can each be made to crash, tear a write, flip a bit,
raise a transient ``OSError`` or stall, at an exact, reproducible
occurrence count.  The chaos benchmark (``benchmarks/torch_chaos.py``)
sweeps the site x kind matrix and asserts bitwise recovery; the
hardening it exercises (checksums, quarantine, retry) lives next to each
site.

Configuration is one env var, parsed once per process::

    REPRO_TORCH_FAULTS=ckpt.write:torn:1,store.commit:crash_after:1

The port reads its own variables (``REPRO_TORCH_FAULTS``,
``REPRO_TORCH_FAULTS_CRASH``, ``REPRO_TORCH_FAULTS_LATENCY_S``), never
the reference's ``REPRO_FAULTS``, so a rule aimed at one package cannot
fire in the other when a process or a shell holds both.

Each rule is ``site:kind[:nth]`` (``nth`` defaults to 1, 1-based): the
rule fires on exactly the ``nth`` occurrence of its site in this
process, once.  Hyphens and underscores in kinds are interchangeable
(``crash-before`` == ``crash_before``).  Unknown sites or kinds raise at
parse time naming ``REPRO_TORCH_FAULTS``: a typo'd rule must never
silently inject nothing.

Kinds and where in a site's scope they fire::

    crash_before   on scope entry, before the guarded operation
    crash_after    on scope exit, after the operation completed
    torn           scope.mangle(path): truncate the file to half
    flip           scope.mangle(path): flip one deterministic bit
    oserror        on scope entry: raise TransientFault (an OSError)
    latency        on scope entry: sleep REPRO_TORCH_FAULTS_LATENCY_S
                   (0.05 s)

Crashes default to ``os._exit(CRASH_EXIT)``, a hard process death that
skips ``finally`` blocks, atexit handlers and the checkpoint writer's
queue drain, exactly like a kill, so crash cells run in subprocesses
(the chaos benchmark's child mode).  ``REPRO_TORCH_FAULTS_CRASH=raise``
(or ``install(..., crash_mode="raise")``) raises ``FaultInjected``
instead, for in-process tests; it derives from ``BaseException`` so no
library ``except Exception`` can swallow a simulated crash.

This module is stdlib only (never imports torch): the serving half
(store, registry, serve_sweeps) threads its sites through it too.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import os
import sys
import threading
import time
from typing import Iterable, Optional

ENV_VAR = "REPRO_TORCH_FAULTS"
ENV_CRASH = "REPRO_TORCH_FAULTS_CRASH"
ENV_LATENCY = "REPRO_TORCH_FAULTS_LATENCY_S"

#: exit code of an injected crash — what the chaos harness asserts on to
#: tell "died as injected" from a genuine failure
CRASH_EXIT = 43

KINDS = ("crash_before", "crash_after", "torn", "flip", "oserror", "latency")

#: every fault site threaded through the stack; parse-time validation
#: keys off this so a typo'd rule cannot silently inject nothing
SITES = (
    "ckpt.write",       # chunk npz write (checkpoint/store.save)
    "ckpt.rename",      # atomic publish: temp -> final rename
    "ckpt.fsync",       # durable=True directory fsync after rename
    "store.commit",     # SweepStore.put arrays+meta commit
    "store.merge",      # SweepStore.merge λ-axis union
    "runtime.lock",     # INCOMPLETE resume-lock creation
    "runtime.unlock",   # resume-lock release on completion
    "runtime.gc",       # gc_finished chunk deletion
    "registry.load",    # StoreRegistry entry resolution (array I/O)
    "serve.request",    # serve_sweeps per-request handling
)


class FaultInjected(BaseException):
    """An injected crash in ``raise`` mode.

    Derives from ``BaseException`` so library ``except Exception``
    handlers cannot accidentally absorb a simulated process death.
    """


class TransientFault(OSError):
    """An injected transient I/O error (retry-worthy by contract)."""

    def __init__(self, site: str):
        super().__init__(errno.EIO, f"injected transient fault at {site}")
        self.site = site


@dataclasses.dataclass
class FaultRule:
    site: str
    kind: str
    nth: int = 1
    fired: bool = False


class FaultPlan:
    """A parsed set of rules plus per-site occurrence counters."""

    def __init__(self, rules: Iterable[FaultRule], crash_mode: str = "exit",
                 latency_s: float = 0.05):
        if crash_mode not in ("exit", "raise"):
            raise ValueError(f"crash_mode must be 'exit' or 'raise', "
                             f"got {crash_mode!r}")
        self.rules = list(rules)
        self.crash_mode = crash_mode
        self.latency_s = float(latency_s)
        self.counts: dict[str, int] = {}
        self.fired: list[dict] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- firing --

    def _take(self, site: str, n: int, kinds: tuple[str, ...]
              ) -> Optional[FaultRule]:
        """The first unfired rule matching (site, nth==n, kind in kinds)."""
        for rule in self.rules:
            if (not rule.fired and rule.site == site and rule.nth == n
                    and rule.kind in kinds):
                rule.fired = True
                self.fired.append({"site": site, "kind": rule.kind, "n": n})
                print(f"[faults] injecting {rule.kind} at {site} "
                      f"(occurrence {n})", file=sys.stderr, flush=True)
                return rule
        return None

    def _crash(self, site: str, kind: str) -> None:
        if self.crash_mode == "raise":
            raise FaultInjected(f"injected {kind} at {site}")
        os._exit(CRASH_EXIT)

    def enter(self, site: str) -> int:
        """One occurrence of ``site``: fires entry-phase kinds; returns n."""
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
        rule = self._take(site, n, ("crash_before", "oserror", "latency"))
        if rule is None:
            return n
        if rule.kind == "crash_before":
            self._crash(site, rule.kind)
        elif rule.kind == "oserror":
            raise TransientFault(site)
        else:                                              # latency
            time.sleep(self.latency_s)
        return n

    def leave(self, site: str, n: int) -> None:
        rule = self._take(site, n, ("crash_after",))
        if rule is not None:
            self._crash(site, rule.kind)

    def mangle(self, site: str, n: int, path: str) -> Optional[str]:
        """Apply a pending torn/flip rule to ``path``; returns the kind."""
        rule = self._take(site, n, ("torn", "flip"))
        if rule is None:
            return None
        (truncate_half if rule.kind == "torn" else flip_bit)(path)
        return rule.kind


# --------------------------------------------------------------- parsing ----


def parse_rules(spec: str) -> list[FaultRule]:
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(
                f"{ENV_VAR}: rule {part!r} is not site:kind[:nth]")
        site, kind = fields[0].strip(), fields[1].strip().replace("-", "_")
        if site not in SITES:
            raise ValueError(f"{ENV_VAR}: unknown site {site!r} "
                             f"(one of {', '.join(SITES)})")
        if kind not in KINDS:
            raise ValueError(f"{ENV_VAR}: unknown kind {kind!r} "
                             f"(one of {', '.join(KINDS)})")
        nth = 1
        if len(fields) == 3:
            try:
                nth = int(fields[2])
            except ValueError:
                raise ValueError(f"{ENV_VAR}: nth in rule {part!r} is not "
                                 "an integer") from None
            if nth < 1:
                raise ValueError(f"{ENV_VAR}: nth must be >= 1 in {part!r}")
        rules.append(FaultRule(site=site, kind=kind, nth=nth))
    return rules


_PLAN: Optional[FaultPlan] = None
_PARSED = False
_PLAN_LOCK = threading.Lock()


def active() -> Optional[FaultPlan]:
    """The process-wide plan (parsed from ``REPRO_TORCH_FAULTS`` once), or
    None.

    The no-faults path is one cached None check — the sites cost nothing
    in production.
    """
    global _PLAN, _PARSED
    if _PARSED:
        return _PLAN
    with _PLAN_LOCK:
        if not _PARSED:
            spec = os.environ.get(ENV_VAR, "")
            if spec.strip():
                _PLAN = FaultPlan(
                    parse_rules(spec),
                    crash_mode=os.environ.get(ENV_CRASH, "exit"),
                    latency_s=float(os.environ.get(ENV_LATENCY, "0.05")))
            _PARSED = True
    return _PLAN


def install(rules, crash_mode: str = "raise") -> FaultPlan:
    """Install a plan programmatically (tests); returns it."""
    global _PLAN, _PARSED
    if isinstance(rules, str):
        rules = parse_rules(rules)
    _PLAN = FaultPlan(rules, crash_mode=crash_mode)
    _PARSED = True
    return _PLAN


def reset() -> None:
    """Drop any installed/parsed plan (tests re-read the env next use)."""
    global _PLAN, _PARSED
    _PLAN = None
    _PARSED = False


# ----------------------------------------------------------------- sites ----


class scope:
    """One guarded occurrence of a fault site::

        with faults.scope("ckpt.write") as fs:
            ...write tmp...
            fs.mangle(tmp)          # torn/flip land on the temp file
            os.replace(tmp, path)
        # crash_after fires here, after the operation completed

    With no active plan every call is a no-op.  ``crash_before`` /
    ``oserror`` / ``latency`` fire on ``__enter__``; ``crash_after``
    fires on clean ``__exit__`` (a scope that raised does not also
    crash).
    """

    def __init__(self, site: str):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        self.site = site
        self._plan = None
        self._n = 0

    def __enter__(self) -> "scope":
        self._plan = active()
        if self._plan is not None:
            self._n = self._plan.enter(self.site)
        return self

    def mangle(self, path: str) -> Optional[str]:
        if self._plan is None:
            return None
        return self._plan.mangle(self.site, self._n, path)

    def __exit__(self, exc_type, *exc) -> None:
        if self._plan is not None and exc_type is None:
            self._plan.leave(self.site, self._n)


def event(site: str) -> None:
    """A point site with no mangle surface (lock/GC transitions)."""
    with scope(site):
        pass


# ----------------------------------------------- corruption / quarantine ----


def truncate_half(path: str) -> None:
    """Tear a file: keep the first half of its bytes (>= 1)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))


def flip_bit(path: str, offset: Optional[int] = None) -> int:
    """Flip one bit at a deterministic offset; returns the byte offset.

    The offset derives from the file *name* (not its bytes), so repeated
    chaos runs corrupt the same position — deterministic replay.  The
    first 64 bytes are skipped when the file allows: flipping inside the
    zip local-header magic makes every reader fail identically, which
    tests nothing; deeper flips exercise the checksum path.
    """
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a bit in empty file {path}")
    if offset is None:
        h = int(hashlib.sha256(os.path.basename(path).encode()).hexdigest(),
                16)
        lo = 64 if size > 128 else 0
        offset = lo + h % (size - lo)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ (1 << (offset % 8))]))
    return offset


def quarantine_path(path: str, reason: str) -> str:
    """Rename a corrupt file or directory aside (never reuse or delete it).

    The new name is ``<name>.quarantined-<k>`` with the first free ``k``,
    so a later incident never overwrites earlier evidence.  Logged to
    stderr; returns the new path.
    """
    k = 0
    while os.path.exists(f"{path}.quarantined-{k}"):
        k += 1
    target = f"{path}.quarantined-{k}"
    os.replace(path, target)
    print(f"[quarantine] {path} -> {os.path.basename(target)}: {reason}",
          file=sys.stderr, flush=True)
    return target
