"""Copies of the JAX package's pure-Python serving core (scheduler,
telemetry, KV transfer, workload, fault detection)."""
