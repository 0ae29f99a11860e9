"""The port's control plane (counterpart of ``repro/core``): MIG profiles,
leaves and GPU state, jobs, the Flex-MIG placement policy, the scheduler,
the JCT model and the traces.  The simulator side (``simulator``,
``modes``, ``metrics``, ``registry``, ``executor``, ``aggregation``) is
still to port (ROADMAP.md queue 1 item 11)."""
