"""Gradient collectives of the port (counterpart of ``repro/collectives``):
the two-tier hierarchical schedule, its bucketed form, int8 compression
with error feedback, the deterministic reduce and the analytic transport
model."""
