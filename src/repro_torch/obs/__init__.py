"""repro_torch.obs — span tracing, Perfetto timelines, trace-derived attribution.

A copy of ``repro.obs``, which uses only the standard library: the same
spans and counters serialize to byte-identical JSON in both packages (the
default title stays ``"repro"``).  One observability vocabulary across all
three layers (README §repro.obs):

  * ``trace``  — nestable ``Span``s on per-worker/link/slot lanes, kind
    taxonomy ``compute | comm.exposed | comm.overlapped | queue.contention
    | barrier | checkpoint | prefill | decode``, byte counters; clock modes
    ``sim`` (deterministic, caller-supplied times) and ``wall``; one
    wall tracer may be active process-wide, and the program's modules
    record into it through ``span``/``count`` (free when none is).
  * ``export`` — Chrome/Perfetto ``trace_event`` JSON, deterministically
    serialized (same spec seed ⇒ byte-identical artifact) and
    round-trippable (``spans_from_events``).
  * ``report`` — per-kind/per-lane time + byte attribution with the
    exposed-comm / queue-wait headline fractions, computable from the
    exported JSON alone.

The spans are derived from the same events the pricing uses (the sim's
event loop, the traffic replay's clock, the CommLedger's bytes) — never a
second bookkeeping path.
"""
from repro_torch.obs.export import (  # noqa: F401
    dumps,
    load_trace_events,
    spans_from_events,
    trace_events,
    validate_trace_events,
    write_trace,
)
from repro_torch.obs.report import (  # noqa: F401
    attribution,
    attribution_from_file,
    format_report,
)
from repro_torch.obs.trace import (  # noqa: F401
    CLOCKS,
    KINDS,
    NO_SPAN,
    Span,
    Tracer,
    activate,
    active,
    count,
    deactivate,
    interval,
    slot_lane,
    span,
    tracing,
    worker_lane,
)
