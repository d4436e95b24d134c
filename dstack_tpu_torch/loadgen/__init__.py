"""Seeded workload generators of the port (own copies of the pieces of
``dstack_tpu.loadgen`` that the serving bench uses)."""
