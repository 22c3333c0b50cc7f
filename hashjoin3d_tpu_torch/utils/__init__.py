"""Data generation, CSV writer, repetition protocol, checkpoints, tracing
and the small helpers of the port."""
