"""Solvers: Krylov methods and mixed-precision refinement."""
