"""Nonsymmetric spectra: convection-diffusion via FFT shift-invert.

The periodic convection-diffusion circulant is genuinely nonsymmetric —
central-difference convection gives complex-conjugate eigenvalue pairs —
yet normal, so its eigenproblem stays well-conditioned at any n.  The
:LM edge of its spectrum clusters quadratically, which interval filters
cannot separate once convection tilts the spectrum into an ellipse
(docs/transforms.md "nonsymmetric spectra"); the recipe is a circulant
shift-invert whose two FFT passes run entirely on device
(`CirculantShiftInvertOperator`): Krylov-Schur on (A - sigma I)^{-1}
magnifies the cluster gaps by 1/|lambda - sigma|^2.

This is the n=65,536 version of the bench `conv1m` phase and of
`chip_smoke.py`'s `nonsym` phase (n=1,048,576).

Reference framing: the reference is spectrum-agnostic at any n its
memory holds (/root/reference/src/run.jl:269-371) but has no
acceleration story; this recipe is how the same nonsymmetric problem
runs at production scale on the GPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from arnoldimethod_jax import (
    CirculantShiftInvertOperator,
    partial_schur,
    power_bound,
    rayleigh_ritz,
)
from arnoldimethod_jax.models import convection_diffusion_periodic_2d

N, s, cx, cy = 256, 0.13, 0.15, 0.08
op = convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s)

# sigma just outside the top edge: a cheap power bound is enough at this
# size (bench.py's conv1m phase shows the staged refinement for 1M rows).
sigma = float(power_bound(op))
si = CirculantShiftInvertOperator.build(op, sigma)

decomp, history = partial_schur(si, nev=12, which="LM", tol=1e-7,
                                mindim=18, maxdim=36)
print(history)

# Rayleigh-Ritz against the ORIGINAL operator maps back to lambda(A).
w, _, res = rayleigh_ritz(op, decomp.Q)
w = np.asarray(w)
print(f"conjugate pairs found : {int(np.sum(w.imag > 1e-9))}")
print(f"max residual          : {np.max(res):.3e}")

# Exact oracle: the 2-D DFT symbol of the circulant.
th = 2 * np.pi * np.arange(N) / N
sym = s * (
    (2 - 2 * np.cos(th))[:, None]
    + (2 - 2 * np.cos(th))[None, :]
    + 2j * (cx * np.sin(th)[:, None] + cy * np.sin(th)[None, :])
)
se = sym.ravel()
acc = max(np.abs(se - l).min() for l in w)
print(f"max eigenvalue error  : {acc:.3e}")
