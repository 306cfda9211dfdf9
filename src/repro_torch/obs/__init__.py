"""Unified observability layer (the port of ``repro.obs``).

One bundle — :class:`Observability` — carries the three tools every
subsystem threads through:

- ``metrics``  (:mod:`repro_torch.obs.metrics`): counters/gauges + exponential
  p50/p95/p99 histograms on the host; ONE device-resident accumulator in
  the slot arrays for per-token quantities, flushed only at the window
  syncs the engine already performs.
- ``tracer``   (:mod:`repro_torch.obs.trace`): Chrome-trace-event spans
  (Perfetto-loadable) over admission / prefill / decode windows /
  preempt / spec / gang steps / graduation / resilience, in a bounded
  ring buffer.
- ``sentinel`` (:mod:`repro_torch.obs.sentinel`): a retrace monitor. The
  port compiles no hot-path function yet, so the engine registers no
  watch; a captured CUDA graph of the decode step will be its first.

Design rule the whole layer obeys: observability must add ZERO host syncs
per token — device-side instrumentation is therefore unconditional (the
steps launch the same kernels with or without a bundle attached), and
host-side work happens only at sync/flush boundaries.
Engines take ``obs=None`` and fall back to :data:`NULL_OBS`, a disabled
bundle whose every call is a cheap no-op, so call sites stay unguarded.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (ExpHistogram, MetricsRegistry, StepWatchdog,
                               OBS_ACTIVE_STEPS, OBS_COLS, OBS_STRANDED_STEPS,
                               OBS_TOKENS, device_acc_init, device_acc_update)
from repro_torch.obs.sentinel import RetraceError, RetraceSentinel
from repro_torch.obs.trace import SpanTracer, validate_chrome_trace

__all__ = ["Observability", "NULL_OBS", "get", "MetricsRegistry",
           "ExpHistogram", "StepWatchdog", "SpanTracer", "RetraceSentinel",
           "RetraceError", "validate_chrome_trace", "device_acc_init",
           "device_acc_update", "OBS_TOKENS", "OBS_ACTIVE_STEPS",
           "OBS_STRANDED_STEPS", "OBS_COLS", "add_cli_args",
           "from_cli_args"]


class Observability:
    def __init__(self, *, enabled: bool = True, trace: bool = True,
                 trace_capacity: int = 65536, sentinel_mode: str = "log"):
        self.enabled = enabled
        self.metrics = MetricsRegistry(enabled=enabled)
        self.tracer = SpanTracer(capacity=trace_capacity,
                                 enabled=enabled and trace)
        self.sentinel = RetraceSentinel(
            mode=sentinel_mode if enabled else "off")

    def export(self, metrics_path=None, trace_path=None) -> None:
        if metrics_path:
            self.metrics.export(metrics_path)
        if trace_path:
            self.tracer.export(trace_path)

    def summary(self) -> dict:
        """Everything at once — what launchers print / dump at exit."""
        return {"metrics": self.metrics.snapshot(),
                "trace_categories": self.tracer.category_counts(),
                "trace_dropped": self.tracer.dropped,
                "retrace_watches": self.sentinel.counts()}


#: Shared disabled bundle: `obs or NULL_OBS` is the whole integration
#: contract — no call site ever branches on obs being attached.
NULL_OBS = Observability(enabled=False)


def get(obs) -> Observability:
    return obs if obs is not None else NULL_OBS


# ---------------------------------------------------------------- launchers
def add_cli_args(ap) -> None:
    """Attach the shared observability flags to an argparse parser (the
    serving launcher exposes them; the training launcher refuses them
    until the Trainer is ported)."""
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="write counters + p50/p95/p99 histogram snapshots "
                    "as JSON at exit (enables the obs bundle)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome-trace-event JSON at exit — open "
                    "in Perfetto (ui.perfetto.dev) or chrome://tracing "
                    "(enables the obs bundle)")


def from_cli_args(args):
    """Build the bundle the flags ask for, or None (engines then run on
    NULL_OBS — zero host-side obs work)."""
    if not (args.metrics_json or args.trace):
        return None
    return Observability(trace=bool(args.trace))
