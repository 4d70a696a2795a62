"""PyTorch/CUDA port of the data-layout planner and its kernels for NVIDIA
Hopper.  Counterpart of the JAX package ``repro``; imports nothing of it.

Subpackages: ``core`` (conflict model, analytic skews, Hopper layout
planner, segmented container), ``api`` (registry, PlanContext,
``launch``), ``kernels`` (STREAM, vector triad, Jacobi, D3Q19 LBM: CUDA C++
kernels with plain PyTorch versions) and ``interop`` (numpy arrays and
reference plans in).
"""
