"""The trainer: step builders, the instrumented loop, and the live
trainer workload."""
