"""Observability of the port: the process-wide metrics registry, the
structured event journal (``events``: request-scoped trace context, a
bounded ring of typed events, the Chrome trace export) and the flight
recorder (``flight``: crash handlers dump the journal tail and a registry
snapshot to a JSON file) — copies of the JAX package's modules.  Its
tracing spans, exposition and SLOs are not ported yet."""

from deeplearning4j_tpu_torch.monitor import events, flight  # noqa: F401
from deeplearning4j_tpu_torch.monitor.events import (  # noqa: F401
    EventJournal, chrome_trace, chrome_trace_fleet, get_journal,
    new_request_id, request_scope)
from deeplearning4j_tpu_torch.monitor.registry import (  # noqa: F401
    Counter, Gauge, Histogram, LatencyHistogram, MetricsRegistry,
    get_registry)
