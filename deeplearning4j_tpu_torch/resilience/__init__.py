"""The resilience layer of the serving path: the error types (copies of
the JAX package's ``resilience/errors.py``) and deterministic fault
injection (``faults``, a copy of its ``resilience/faults.py``).  Retry
policies and circuit breakers (``resilience/policy.py``) are not ported
yet."""

from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CircuitOpenError, CorruptCheckpointError, DeadlineExceededError,
    OverloadedError, TransientError)
from deeplearning4j_tpu_torch.resilience import faults  # noqa: F401
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan, ThreadKill)
