"""Power method for estimating the largest eigenvalue of a linear operator.

Used only at model init for spectral normalization of the initial dictionary
(reference model/solvers.py:3-22, called from model/net.py:43-57).

Implementation note: the iteration runs as a host loop around a jitted
single step rather than one big lax.while_loop — compiling a 200-iteration
while_loop whose body contains large 3D conv pairs was pathologically slow
on some toolchains, while the step compiles once and the host-side
convergence check matches the reference's per-iteration |e_new - e_old| < tol
early stop exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def power_method(A, b: jnp.ndarray, num_iter: int = 1000, tol: float = 1e-6):
    """Estimate the max eigenvalue of linear operator A from initial vector b.

    A: callable array -> array (same shape).
    Returns (eig_max, b_final, tol_reached).
    """

    @jax.jit
    def step(b):
        b_new = A(b)
        b_new = b_new / jnp.sqrt(jnp.sum(b_new * b_new))
        eig = jnp.sum(b_new * A(b_new))
        return b_new, eig

    eig_old = 0.0
    eig = jnp.asarray(0.0, b.dtype)
    tol_reached = False
    for _ in range(num_iter):
        b, eig = step(b)
        e = float(eig)
        if abs(e - eig_old) < tol:
            tol_reached = True
            break
        eig_old = e
    return eig, b, tol_reached
