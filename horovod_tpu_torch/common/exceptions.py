"""Exception types for horovod_tpu_torch.

A copy of ``horovod_tpu/common/exceptions.py`` (the reference Horovod's
``horovod/common/exceptions.py`` surface): ``HorovodInternalError`` is
raised when a collective fails mid-flight (elastic mode catches it and
restores committed state), ``HostsUpdatedInterrupt`` is raised when
cluster membership changes under elastic training.
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails.

    Elastic training catches this, restores the last committed state,
    re-initializes the process set, and retries.
    """


class HostsUpdatedInterrupt(RuntimeError):
    """Raised when cluster membership changed during an elastic run.

    ``skip_sync`` mirrors the reference semantics: when the update was
    graceful (no failure), state does not need to be restored from the last
    commit.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class TensorShapeMismatchError(ValueError):
    """Cross-rank shape mismatch detected during negotiation.

    The reference controller constructs an ERROR response when ranks submit
    the same tensor name with inconsistent shapes; the port raises eagerly
    at enqueue/validation time instead.
    """


class TensorDtypeMismatchError(ValueError):
    """Cross-rank dtype mismatch."""


class DuplicateNameError(ValueError):
    """A tensor with the same name is already in flight (the reference's
    DUPLICATE_NAME_ERROR)."""


class StalledTensorError(RuntimeError):
    """Raised when stalled tensors force a shutdown (the reference's
    stall-inspector shutdown path, ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``).
    """


class FaultInjectedError(RuntimeError):
    """A chaos fault fired at a ``HOROVOD_FAULT_SPEC`` fault point. Only
    ever raised when fault injection is explicitly configured; production
    code paths never see it.
    """


class RetriesExhaustedError(RuntimeError):
    """A retry policy ran out of budget (attempts or deadline) with no
    attempt ever classified retryable. When attempts *were* made, the
    policy re-raises the last real exception instead, so callers keep
    their existing except clauses.
    """

    def __init__(self, site: str, attempts: int, elapsed_s: float):
        super().__init__(
            f"retry budget exhausted at {site!r}: {attempts} attempt(s) "
            f"over {elapsed_s:.1f}s")
        self.site = site
        self.attempts = attempts
        self.elapsed_s = elapsed_s
