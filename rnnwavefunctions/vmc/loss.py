"""VMC surrogate ("fake cost") loss, complex-free.

One formula covers both reference losses.  With Ec = stop_grad(E_loc - <E>)
and log psi = a + i b:

    cost = 2 * mean( Re( conj(log psi) * Ec ) )
         = 2 * mean( a * Ec_re + b * Ec_im )

* Positive ansatze (b = 0, Ec_im = 0): log psi = 0.5 log p, so
  ``cost = mean(log p * Ec) = mean(log p * Eloc) - mean(Eloc) * mean(log p)``
  — exactly ``/root/reference/1DTFIM/TrainingRNN_1DTFIM.py:156`` (and the
  2D variants at ``Training1DRNN_2DTFIM.py:150``,
  ``Training2DRNN_2DTFIM.py:164``).
* Complex ansatz:
  ``cost = 2 Re( mean(conj(log psi) sg(E)) - conj(mean(log psi)) mean(sg(E)) )``
  — exactly ``J1J2/TrainingRNN_J1J2.py:197``, expanded into real arithmetic
  (no complex dtype on the hot path).

The ``stop_gradient`` on E_loc is mandatory here (the reference gets it for
free in 1DTFIM because ``Eloc`` is a placeholder; SURVEY.md §2.2 quirk 3).
The *caller* supplies the global means of E_loc so the baseline is correct
under data-parallel sharding (psum'd mean over the mesh).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def surrogate_loss(
    la_re: jax.Array,
    la_im: Optional[jax.Array],
    e_re: jax.Array,
    e_im: Optional[jax.Array],
    e_mean_re: jax.Array,
    e_mean_im: Optional[jax.Array],
) -> jax.Array:
    """Scalar surrogate whose gradient is the VMC energy gradient.

    Args:
      la_re, la_im: (S,) real/imag parts of log psi (im None when real).
      e_re, e_im:   (S,) local energies (constants; im None when real).
      e_mean_re/_im: global mean of E_loc (variance-reducing baseline).
    """
    ec_re = jax.lax.stop_gradient(e_re - e_mean_re)
    cost = jnp.mean(la_re * ec_re)
    if la_im is not None and e_im is not None:
        ec_im = jax.lax.stop_gradient(e_im - e_mean_im)
        cost = cost + jnp.mean(la_im * ec_im)
    return 2.0 * cost
