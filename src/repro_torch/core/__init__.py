"""The port's share of ``repro/core`` so far: ``leaves.TpuLeaf``, which
the elastic remesh plans over (ROADMAP.md queue 1 item 11 ports the rest
of the control plane)."""
