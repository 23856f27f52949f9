"""Process-level stall watchdog.

Counterpart of ``kgwas_tpu/engine/watchdog.py``. In-process recovery
(``engine/resilience.py``, ``KGWAS.train(max_restarts=...)``) handles
failures that RAISE and leave the process usable. A wedged card (a hang
that never raises) or a sticky CUDA error (the context is lost, every
later CUDA call fails) needs a new process. This watchdog gives it one:

  * the training process touches a HEARTBEAT file as it makes progress
    (``KGWAS.train(heartbeat_path=...)`` touches it after every step and
    around the epoch-end forward);
  * ``run_with_watchdog()`` launches the training command in its own
    process group, polls the heartbeat's mtime, and on a stall kills
    exactly that process group (by pgid, never by name or pattern) and
    relaunches it, up to ``max_restarts`` times;
  * with ``KGWAS.train(checkpoint_every=N, resume=True)`` each relaunch
    resumes from the newest train state (``engine/checkpoint.py``).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence


def touch_heartbeat(path: Optional[str]) -> None:
    """Cheap progress marker; no-op when path is None."""
    if path:
        Path(path).touch()


class WatchdogStall(RuntimeError):
    """Training stalled past the timeout on every allowed attempt."""


def run_with_watchdog(
    argv: Sequence[str],
    heartbeat: str,
    stall_timeout_s: float = 600.0,
    max_restarts: int = 2,
    poll_s: float = 5.0,
    env: Optional[dict] = None,
    grace_s: Optional[float] = None,
) -> int:
    """Run `argv` under stall supervision; returns the exit code (0).

    A process is considered stalled when the heartbeat file has not been
    touched for stall_timeout_s (the clock starts at process launch, so a
    hang before the FIRST heartbeat is also caught: start-up, data loading
    and the first step must fit inside the timeout). Stalled or crashed
    processes are killed by process group and relaunched, max_restarts
    times; the final failure
    raises (WatchdogStall for stalls, CalledProcessError for crashes).
    grace_s: SIGTERM-to-SIGKILL escalation delay (default poll_s).
    """
    hb = Path(heartbeat)
    if grace_s is None:
        grace_s = poll_s
    last_failure: Optional[BaseException] = None
    for attempt in range(max_restarts + 1):
        if hb.exists():
            hb.unlink()
        t_launch = time.monotonic()
        proc = subprocess.Popen(list(argv), env=env, start_new_session=True)
        pgid = os.getpgid(proc.pid)
        stalled = False
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc == 0:
                    return 0
                last_failure = subprocess.CalledProcessError(rc, list(argv))
                break
            try:
                beat = hb.stat().st_mtime
                # mtime is wall-clock; age via wall-clock now
                age = time.time() - beat
            except FileNotFoundError:
                age = time.monotonic() - t_launch
            if age > stall_timeout_s:
                stalled = True
                # kill EXACTLY the process group we created (never by
                # name or pattern — patterns can match foreign processes).
                # The child may exit between poll() and killpg: treat
                # ProcessLookupError as "already gone" and honor its rc.
                try:
                    os.killpg(pgid, signal.SIGTERM)
                    try:
                        proc.wait(timeout=grace_s)
                    except subprocess.TimeoutExpired:
                        os.killpg(pgid, signal.SIGKILL)
                        proc.wait()
                except ProcessLookupError:
                    rc = proc.wait()
                    if rc == 0:
                        return 0
                last_failure = WatchdogStall(
                    f"no heartbeat for {age:.0f}s (limit "
                    f"{stall_timeout_s:.0f}s), attempt {attempt + 1}"
                )
                break
            time.sleep(poll_s)
        print(
            f"[watchdog] attempt {attempt + 1} "
            f"{'stalled' if stalled else 'crashed'}; "
            f"{'restarting' if attempt < max_restarts else 'giving up'}",
            file=sys.stderr,
            flush=True,
        )
    raise last_failure  # type: ignore[misc]
