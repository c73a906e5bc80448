"""Copies of the JAX package's pure-Python serving core (scheduler,
telemetry, KV transfer, workload, fault detection, hardware constants,
latency model, simulator, goodput, placement search, replanning), and
`h100`, the card the port runs on as a `hw.Chip`."""
