"""Telemetry of the port: the metrics registry, the program record and the
step-boundary hook."""
from . import metrics, recompile  # noqa: F401

__all__ = ["metrics", "recompile", "record_step"]


def record_step(batch_size: int, seconds: float, prefix: str = "trainer"):
    """The step-boundary hook, called by ``gluon.Trainer.step`` once per
    optimization step: step and sample counters, the step-latency
    histogram and the throughput gauge. ``seconds`` is the caller's host
    time for the step (on CUDA, the time to enqueue it)."""
    metrics.counter(f"{prefix}_step_total", "optimization steps").inc()
    metrics.counter(f"{prefix}_samples_total",
                    "samples consumed by steps").inc(batch_size)
    metrics.histogram(f"{prefix}_step_seconds",
                      "wall-clock step latency").observe(seconds)
    if seconds > 0:
        metrics.gauge(f"{prefix}_throughput_samples_per_sec",
                      "instantaneous step throughput"
                      ).set(batch_size / seconds)
