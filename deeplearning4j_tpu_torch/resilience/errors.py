"""Exception types of the serving path — copies of
``deeplearning4j_tpu/resilience/errors.py``.  ``TransientError`` (and the
stdlib transients) is what a retry policy retries; ``OverloadedError`` and
``CircuitOpenError`` map to HTTP 503 with ``Retry-After`` at the gateway
(shed, don't queue); ``DeadlineExceededError`` maps to 504 (the client's
budget is gone)."""

from __future__ import annotations


class DeadlineExceededError(TimeoutError):
    """The request's deadline budget expired before the work ran."""


class OverloadedError(RuntimeError):
    """Admission control rejected the request: queue depth is past the
    limit.  ``retry_after_s`` is the backoff hint the gateway surfaces
    as an HTTP ``Retry-After`` header."""

    def __init__(self, message: str = "server overloaded",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class TransientError(RuntimeError):
    """A failure worth retrying: the operation may succeed if repeated
    (flaky reader, hiccuping filesystem, injected chaos, a decode session
    in the middle of a migration)."""


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open: calls are short-circuited until the
    cooldown elapses.  ``retry_after_s`` is the remaining cooldown."""

    def __init__(self, message: str = "circuit open",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class CorruptCheckpointError(RuntimeError):
    """A checkpoint zip failed validation (truncated write, bad CRC,
    unparsable configuration): resume skips it for the previous one."""
