"""qmg_tpu: a JAX 2D lattice multigrid framework.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C++ research stack weinbe2/quantum-mg (Schwinger-model gauge
fields, stencil operators, aggregation-based transfer, Galerkin coarse
operators, recursive K-cycle multigrid around Krylov solvers).

Layer map (mirrors SURVEY.md section 1):

    lattice   - eo-index algebra, field layouts         (L1)
    cshift    - periodic shifts; the communication layer (L2)
    stencil   - distance-1 stencil engine, 9 matvec variants (L3)
    operators - Laplace / staggered / Wilson / DWF / coarse   (L4)
    transfer  - prolong/restrict, block (bi-)ortho       (L5)
    multigrid - level stack                              (L6)
    stateful  - K-cycle driver, solve configs, trackers  (L7)
    u1        - gauge toolkit: I/O, heatbath, observables (L8)
    solvers   - Krylov suite (quantum-linalg equivalent) (L0)
    linalg    - vector/batched-matrix primitives         (L0)
    eig       - eigensolvers (ARPACK-interface equivalent)
    reductions- timeslice reductions, wall sources
    parallel  - device-mesh sharding (halo exchange)
    refine    - mixed-precision iterative refinement (fp64 contract)

Double precision requires ``jax.config.update("jax_enable_x64", True)``
before first use (numerics parity with the reference is at fp64).
"""

from . import (lattice, cshift, linalg, stencil, solvers, u1, rng,
               transfer, multigrid, stateful, eig, reductions, measure,
               storage, parallel, tpu_compat, refine)

__version__ = "0.1.0"
