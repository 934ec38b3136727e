"""Host-side tracer and the PerfTracker attachment for the trainer."""
