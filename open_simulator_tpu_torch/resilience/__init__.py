"""Resilience layer: retry/backoff policies, circuit breakers, and
deterministic fault injection for the external-I/O paths the port has
(scheduler extenders, the apiserver client, chart rendering)."""
