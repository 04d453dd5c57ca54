"""Traffic mixes: one module a kind, found by the name in a workload file."""
