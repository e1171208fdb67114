"""Setting corrupt files aside, ported from ``repro/faults.py``.

Only ``quarantine_path`` is here: the port's store and runtime call it to
set a corrupt chunk or store entry aside before recomputing it.  The
reference's fault-injection sites (``scope`` / ``event``, ``REPRO_FAULTS``)
are ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import os
import sys


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
