"""PyTorch/CUDA port of the EROICA reproduction (DESIGN.md §1).

Beside the JAX reference package ``repro``, which it never imports.  This
slice runs the PerfTracker diagnosis path in fleet mode: simulated or
converted worker profiles -> packing -> Algorithm 1 (kernel K1 on the card,
``repro_torch.kernels.pattern_summary``) -> critical path -> aggregation ->
differential localization -> report and mitigation plans.
"""
