"""Named sync points for deterministic concurrency/crash tests.

A copy of ``risingwave_tpu/utils_sync_point.py`` with its imports rewritten
(host only: the port imports nothing of the reference).

Reference: src/utils/sync-point/src/lib.rs — instrumented sites call
``sync_point!("name")``; tests attach actions (wait, signal, panic) to
drive exact interleavings. Here: ``hit(name)`` is a no-op unless a test
activated an action for that name — zero overhead in production paths
(one dict lookup against an empty dict).

Instrumented sites (grow this list as tests need them):
- ``before_manifest_commit``   — SSTs uploaded, manifest not yet written
- ``after_manifest_commit``    — epoch just became durable
- ``before_compaction_gc``     — compaction about to delete merged SSTs
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_ACTIONS: Dict[str, Callable[[], None]] = {}
_LOCK = threading.Lock()


def activate(name: str, action: Callable[[], None]) -> None:
    """Attach an action to a sync point (test-side)."""
    with _LOCK:
        _ACTIONS[name] = action


def deactivate(name: str) -> None:
    with _LOCK:
        _ACTIONS.pop(name, None)


def reset() -> None:
    with _LOCK:
        _ACTIONS.clear()


def hit(name: str) -> None:
    """Called at instrumented sites; runs the test's action if any.
    Actions may raise (crash injection), block on events (interleaving
    control), or record (tracing)."""
    action = _ACTIONS.get(name)
    if action is not None:
        action()
