"""Runtime telemetry of the port (counterpart of bigdl_tpu/obs), wired
through ``LocalOptimizer``, ``DistriOptimizer`` and ``ContinuousDecoder``:

- ``taps``: training-health scalars (grad norm, param norm, update
  ratio, non-finite count) from the step itself — on the SGD path sums
  the ``fused_sgd`` kernel accumulates as it updates — read by the host
  only every ``BIGDL_OBS_TAPS_CADENCE`` steps;
- ``events``: schema-versioned JSONL event stream a process
  (``BIGDL_OBS_DIR``) and an in-memory ring, the JAX schema;
- ``spans``: nested wall-clock phase spans over ``optim.Metrics``, each
  under a ``torch.profiler.record_function`` range;
- ``diagnostics``: crash bundles (ring tail, device memory, config,
  thread stacks) on a non-finite abort;
- ``summary``: TensorBoard scalar export (``TrainSummary`` /
  ``ValidationSummary``), no TensorFlow;
- ``metrics``: counters, gauges and fixed-bucket histograms whose
  snapshots merge exactly across processes and with the JAX package's;
- ``trace``: sampled per-request trace contexts
  (``BIGDL_OBS_TRACE_SAMPLE``);
- ``recorder``: the per-request flight recorder and its tail-based
  classification;
- ``ledger``: step flops counted once a step program, live
  ``train_mfu`` / ``decode_model_flops_util`` against an NVIDIA card's
  data-sheet peak, memory tenants and the memory sampler.

Master switch: ``BIGDL_OBS=0`` turns the events and diagnostics off;
``BIGDL_OBS_TAPS=0`` removes the taps from the step.  The JAX package's
alert rules and exporter (``alerts``, ``export``) come with the serving
fleet.
"""
from bigdl_tpu_torch.obs import (  # noqa: F401
    diagnostics, events, ledger, metrics, recorder, spans, taps, trace,
)
from bigdl_tpu_torch.obs.diagnostics import dump_crash_bundle  # noqa: F401
from bigdl_tpu_torch.obs.events import (  # noqa: F401
    SCHEMA_VERSION, EventLog, read_events, validate_event,
)
from bigdl_tpu_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS, Registry, parse_prometheus, render_prometheus,
)
from bigdl_tpu_torch.obs.trace import Sampler, Trace  # noqa: F401
from bigdl_tpu_torch.obs.spans import PHASES, SpanTracker  # noqa: F401
from bigdl_tpu_torch.obs.summary import (  # noqa: F401
    ScalarWriter, TrainSummary, ValidationSummary, read_scalars,
)
from bigdl_tpu_torch.obs.taps import TAP_NAMES, TapsMonitor  # noqa: F401
