"""Failure classification and the retry policy of a long training run.

Counterpart of ``kgwas_tpu/engine/resilience.py``. ``KGWAS.train(
max_restarts=N)`` snapshots the train state on the host at each epoch end;
on a failure that ``is_transient_backend_error`` calls transient it
restores the snapshot, uploads the graph again and replays from the next
epoch, up to N times. Everything else raises.

Classification is conservative: programming errors (shape, type), out of
memory and errors that poison the CUDA context are fatal. A *sticky* CUDA
error (an illegal address, a device-side assert, a launch failure, an ECC
error) leaves the context unusable: every later CUDA call of the process
fails, so an in-process restart cannot recover it. Only the process-level
watchdog (``engine/watchdog.run_with_watchdog``) with
``train(checkpoint_every=..., resume=True)`` can, in a new process.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

# The JAX package's markers of a backend (not program) failure: runtime
# INTERNAL errors, transport failures (UNAVAILABLE, DEADLINE_EXCEEDED,
# ABORTED, CANCELLED, closed or reset sockets) and relay hiccups.
# cudaErrorDevicesUnavailable ("busy or unavailable") is transient too: the
# card is held by another process or in exclusive mode, and a later attempt
# can get it.
_TRANSIENT_MARKERS = (
    "INTERNAL",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "claim",
    "relay",
    "tunnel",
    "remote_compile",
    "Socket closed",
    "connection reset",
    "busy or unavailable",
)

# Markers that force FATAL even when a transient marker also matches. The
# JAX package's (out of memory, bad arguments), then the sticky CUDA errors,
# after which every CUDA call of the process fails: "illegal memory access"
# (cudaErrorIllegalAddress), "device-side assert" (cudaErrorAssert),
# "unspecified launch failure" (cudaErrorLaunchFailure), "ECC error" (an
# uncorrectable memory error), and cuBLAS's status codes, which a poisoned
# context returns; CUBLAS_STATUS_INTERNAL_ERROR holds "INTERNAL", which the
# transient list would otherwise match.
_FATAL_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "INVALID_ARGUMENT",
    "out of memory",
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "ECC error",
    "CUBLAS_STATUS_",
)

# exception types whose message is classified (the JAX runtime's, and the
# RuntimeError / OSError that torch raises for CUDA and transport failures)
_CLASSIFIED = ("JaxRuntimeError", "XlaRuntimeError", "RuntimeError",
               "OSError")


def is_transient_backend_error(exc: BaseException) -> bool:
    """True when retrying the work has a chance of succeeding. Out of
    memory is fatal; so is torch's AcceleratorError, the error of a failed
    CUDA call (sticky: the context is lost), but for a card that is busy or
    unavailable, which a later attempt can get."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, BrokenPipeError)):
        return True
    msg = str(exc).lower()
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return "busy or unavailable" in msg
    if type(exc).__name__ not in _CLASSIFIED:
        return False
    if any(m.lower() in msg for m in _FATAL_MARKERS):
        return False
    return any(m.lower() in msg for m in _TRANSIENT_MARKERS)


@dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 5.0
    backoff_mult: float = 2.0
    max_backoff_s: float = 120.0

    def wait(self, restart_idx: int) -> float:
        """Backoff before restart number ``restart_idx`` (1-based)."""
        return min(self.backoff_s * self.backoff_mult ** (restart_idx - 1),
                   self.max_backoff_s)


def sleep_backoff(policy: RetryPolicy, restart_idx: int, sleep=time.sleep):
    sleep(policy.wait(restart_idx))
