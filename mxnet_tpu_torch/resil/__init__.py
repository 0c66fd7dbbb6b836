"""Resilience of the port: the circuit breaker the serving router uses.
The rest of ``mxnet_tpu/resil/`` (retry policies, fault plans, the
control plane) waits for ROADMAP Queue A item 7."""
from .policy import CircuitBreaker, CircuitOpenError  # noqa: F401

__all__ = ["CircuitBreaker", "CircuitOpenError"]
