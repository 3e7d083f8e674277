#!/usr/bin/env python3
"""On-device smoke test of the solver's main path on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded solves and
                                     # the one-card solves they match

Drives `partial_schur` -> `partial_eigen` through the public entry points
at the sizes this repo's users run (BASELINE.json config 2, the 1M-row
2-D Laplacian; the 10.24M-row north star; the bench.py configs) and
checks every answer against an analytic or independent reference.  A
failed check raises, so the exit code is non-zero and no result line is
printed.  There is no CPU fallback: on any platform but "gpu" the script
exits non-zero and names the platform it found.

Output: a header naming the card (`nvidia-smi` name and power limit),
then one line per phase, `phase <name>: {json}`, holding the phase's
numbers, the tolerance each was held to, and `wall_s` — one run on that
card, compilation included.  The last line is exactly
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.

The phase functions take their sizes as arguments, so the tests can run
them at tiny sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)
# 5-point Laplacian coefficients (center, west, east, north, south).
LAPLACE = (4.0, -1.0, -1.0, -1.0, -1.0)
# bench.py's scaled stencil: spectral radius ~1, so iterated matvecs and
# high-degree Chebyshev filters stay in float32 range.
SCALE = 0.130


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _emit(name, t0, fields):
    """Print the phase line and return its fields."""
    fields["wall_s"] = time.perf_counter() - t0
    print(f"phase {name}: {json.dumps(fields)}", flush=True)
    return fields


def _stencil(grid, scale=1.0):
    import jax.numpy as jnp

    from arnoldimethod_jax.models.operators import Stencil5Operator

    return Stencil5Operator(
        tuple(scale * c for c in LAPLACE), (grid, grid), dtype=jnp.float32
    )


def _laplace_spectrum(grid, scale=1.0):
    """Sorted eigenvalues of the Dirichlet 5-point Laplacian on a
    grid x grid mesh: scale * (4 - 2 cos(pi i/(g+1)) - 2 cos(pi j/(g+1)))."""
    mu = scale * (2 - 2 * np.cos(np.pi * np.arange(1, grid + 1) / (grid + 1)))
    return np.sort(np.add.outer(mu, mu).ravel())


def _spectrum_error(w, spec):
    """(max distance of each computed eigenvalue to the analytic spectrum,
    max amount by which the k-th smallest computed value undercuts the
    k-th smallest analytic one).  A Krylov method may miss copies of a
    repeated eigenvalue, so the k-th computed value may sit above the
    k-th analytic one, never below."""
    w = np.sort(np.real(np.asarray(w)))
    idx = np.clip(np.searchsorted(spec, w), 1, len(spec) - 1)
    dist = np.minimum(np.abs(spec[idx] - w), np.abs(spec[idx - 1] - w))
    return float(dist.max()), float(np.max(spec[: len(w)] - w))


def _set_distance(a, b):
    """Hausdorff distance between two eigenvalue sets (complex plane):
    every value of each set lies within it of some value of the other."""
    a, b = np.asarray(a, complex), np.asarray(b, complex)
    d = np.abs(a[:, None] - b[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _matvec(op, x):
    """op @ x, with the operator's arrays passed to jit as arguments (a
    bound method would embed them in the program as constants)."""
    import jax

    return jax.jit(lambda op, x: op.matvec(x))(op, x)


def _apply_rows(op, X):
    """op applied to every row of X, one jitted vmap."""
    import jax

    return jax.jit(lambda op, X: jax.vmap(op.matvec)(X))(op, X)


def _schur_residual_rows(op, decomp):
    """||A Q - Q R||_F from device matvecs, rows layout (no dense A):
    (A Q)^T = R^T Q^T, contracted at HIGHEST precision (no TF32)."""
    import jax
    import jax.numpy as jnp

    Qr = decomp.Q_rows
    AQ = _apply_rows(op, Qr)
    R = jnp.asarray(np.asarray(decomp.R), Qr.dtype)
    RtQ = jnp.matmul(R.T, Qr, precision=jax.lax.Precision.HIGHEST)
    return float(jnp.linalg.norm(AQ - RtQ))


def _per_iter(run, x, n):
    """Device seconds per loop iteration of `run(x, steps)`: min over 3
    reps of the n-vs-n/5 difference, each run ended by block_until_ready
    (the difference cancels dispatch and readiness overhead)."""
    import jax

    jax.block_until_ready(run(x, 2))  # compile
    n1 = max(1, n // 5)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x, n1))
        t1 = time.perf_counter()
        jax.block_until_ready(run(x, n))
        t2 = time.perf_counter()
        best = min(best, ((t2 - t1) - (t1 - t0)) / (n - n1))
    return max(best, 1e-12)


def _copy_rate(nbytes, n=50):
    """Device copy bandwidth (bytes read + written per second) of a
    chained scale pass over an array of `nbytes` float32 bytes."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def scale_loop(y, steps):
        return jax.lax.fori_loop(0, steps, lambda i, y: y * 1.0000001, y)

    x = jnp.ones(nbytes // 4, jnp.float32)
    return 2 * nbytes / _per_iter(scale_loop, x, n)


# --- phases ---------------------------------------------------------------


def phase_readme(n=100):
    """The reference README config, host and fused-device dense layers,
    then the same config natively in float64."""
    import jax

    from arnoldimethod_jax import partial_eigen, partial_schur
    from arnoldimethod_jax.models.problems import laplacian_1d

    t0 = time.perf_counter()
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    out = {"n": n, "nev": 10, "tol": 1e-6, "matvecs_max": 200,
           "schur_resid_f64_max": 5e-6}
    for method in ("host", "device"):
        decomp, hist = partial_schur(
            laplacian_1d(n, dtype=np.float32), nev=10, which="SR", tol=1e-6,
            method=method,
        )
        Q = np.asarray(decomp.Q, np.float64)
        res = float(np.linalg.norm(A @ Q - Q @ np.asarray(decomp.R)))
        out[f"{method}_matvecs"] = hist.mvproducts
        out[f"{method}_nconverged"] = hist.nconverged
        out[f"{method}_schur_resid_f64"] = res
        _check(hist.nconverged >= 10, f"readme {method}: converged")
        _check(hist.mvproducts <= 200, f"readme {method}: matvecs <= 200")
        _check(res <= 5e-6, f"readme {method}: schur residual {res}")

    # The float32 solves above run with JAX's default (x64 off), as a
    # user's would; float64 needs 64-bit types on for this solve only.
    with jax.enable_x64(True):
        decomp, hist = partial_schur(
            laplacian_1d(n, dtype=np.float64), nev=10, which="SR", tol=1e-12
        )
        Q = np.asarray(decomp.Q)
        vals, X = partial_eigen(decomp)
        X = np.asarray(X)
    _check(Q.dtype == np.float64, "readme f64: basis stays float64")
    res = float(np.linalg.norm(A @ Q - Q @ np.asarray(decomp.R)))
    eig_res = float(np.linalg.norm(A @ X - X * np.real(vals)))
    out.update(f64_matvecs=hist.mvproducts, f64_schur_resid=res,
               f64_eigvec_resid=eig_res, f64_resid_max=1e-11)
    _check(hist.nconverged >= 10, "readme f64: converged")
    _check(res <= 1e-11, f"readme f64: schur residual {res}")
    _check(eig_res <= 1e-11, f"readme f64: eigenvector residual {eig_res}")
    return _emit("readme", t0, out)


def phase_config2(grid=1024, sharding=None, method=None, lowsync=False,
                  name="config2"):
    """BASELINE.json config 2: nev=20 smallest of the grid x grid 2-D
    Laplacian in float32.  Returns (fields, eigenvalues)."""
    import jax

    from arnoldimethod_jax import partial_eigen, partial_schur

    t0 = time.perf_counter()
    op = _stencil(grid)
    nev, maxdim = 20, 80
    decomp, hist = partial_schur(
        op, nev=nev, which="SR", tol=1e-6, mindim=40, maxdim=maxdim,
        restarts=400, sharding=sharding, method=method, lowsync=lowsync,
    )
    jax.block_until_ready(decomp.Q_rows)
    _check(hist.nconverged >= nev, f"{name}: {hist.nconverged} of {nev}")
    # Convergence floor eps_f32 * ||H||_F with ||H||_F <= sqrt(maxdim) *
    # ||A||_2 and ||A||_2 <= 8: ~8.5e-6 per eigenvalue, so 1e-5.
    eig_tol = 1e-5
    dist, under = _spectrum_error(decomp.eigenvalues, _laplace_spectrum(grid))
    res = _schur_residual_rows(op, decomp)
    res_max = 2 * np.sqrt(nev) * EPS32 * 8 * np.sqrt(maxdim)
    vals, X = partial_eigen(decomp)
    out = {
        "n": grid * grid, "nev": nev, "maxdim": maxdim,
        "matvecs": hist.mvproducts, "restarts": hist.restarts,
        "host_device_s": hist.timings.get("device"),
        "host_dense_s": hist.timings.get("dense"),
        "eig_dist": dist, "eig_undercut": under, "eig_tol": eig_tol,
        "schur_resid": res, "schur_resid_max": res_max,
        "eigvec_shape": list(X.shape),
    }
    if sharding is not None:
        out["basis_devices"] = len(decomp.Q_rows.sharding.device_set)
        _check(out["basis_devices"] == len(sharding.device_set),
               f"{name}: basis spans every mesh device")
    _check(dist <= eig_tol and under <= eig_tol, f"{name}: spectrum")
    _check(res <= res_max, f"{name}: schur residual {res} > {res_max}")
    _check(X.shape == (grid * grid, nev), f"{name}: partial_eigen shape")
    return _emit(name, t0, out), decomp.eigenvalues


def phase_fused65k(grid=256, sharding=None, methods=("device", "host"),
                   name="fused65k"):
    """256 x 256 Laplacian, nev=10 smallest through the fused on-device
    restart loop, checked against the analytic spectrum and against the
    host-method eigenvalues of the same process.  Returns (fields,
    {method: eigenvalues})."""
    from arnoldimethod_jax import partial_schur

    t0 = time.perf_counter()
    spec = _laplace_spectrum(grid)
    # f32 floor eps_f32 * sqrt(maxdim) * ||A||_2 ~ 6e-6 per eigenvalue.
    tol = 1e-5
    out = {"n": grid * grid, "nev": 10, "eig_tol": tol}
    lams = {}
    for method in methods:
        decomp, hist = partial_schur(
            _stencil(grid), nev=10, which="SR", tol=1e-6, mindim=20,
            maxdim=40, restarts=600, method=method, sharding=sharding,
        )
        _check(hist.nconverged >= 10, f"{name} {method}: converged")
        dist, under = _spectrum_error(decomp.eigenvalues, spec)
        _check(dist <= tol and under <= tol, f"{name} {method}: spectrum")
        out[f"{method}_matvecs"] = hist.mvproducts
        out[f"{method}_eig_dist"] = dist
        lams[method] = decomp.eigenvalues
    if len(lams) == 2:
        # Both within tol of the spectrum, so within 2 tol of each other.
        out["device_vs_host"] = _set_distance(lams["device"], lams["host"])
        out["agree_tol"] = 2 * tol
        _check(out["device_vs_host"] <= 2 * tol, f"{name}: device vs host")
    return _emit(name, t0, out), lams


def phase_northstar(grid=3200, nev=100, degree=1000, maxdim=200,
                    schedule=(100, 200, 400, 400), sharding=None,
                    check_tiled=True, name="northstar"):
    """The e2e10m recipe: estimate_interval, then a Chebyshev-filtered
    Krylov-Schur solve of the grid x grid Laplacian (n = 10,240,000 at
    grid=3200), mapped back by rayleigh_ritz.  Returns (fields,
    eigenvalues)."""
    import jax
    import jax.numpy as jnp

    from arnoldimethod_jax import (
        ChebyshevFilterOperator,
        estimate_interval,
        partial_schur,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.ops.expansion import (
        apply_basis_change,
        apply_basis_change_tiled,
        pick_tiles,
        tiled_threshold_bytes,
    )

    t0 = time.perf_counter()
    op = _stencil(grid, SCALE)
    n = grid * grid
    exact = _laplace_spectrum(grid, SCALE)[:nev]
    iv = estimate_interval(op, nev=nev, refine_degree=schedule)
    t_interval = time.perf_counter() - t0
    fop = ChebyshevFilterOperator(op, iv.a, iv.b, degree, scale_point=iv.lo)
    t1 = time.perf_counter()
    decomp, hist = partial_schur(
        fop, nev=nev, which="LM", tol=1e-7, mindim=nev, maxdim=maxdim,
        sharding=sharding,
    )
    jax.block_until_ready(decomp.Q_rows)
    t_solve = time.perf_counter() - t1
    w, _, res = rayleigh_ritz(op, decomp.Q_rows, rows_layout=True,
                              return_vectors=False)
    w = np.sort(np.real(np.asarray(w)))
    err = float(np.max(np.abs(w[:nev] - exact)))
    # Rayleigh quotients of f32 Ritz vectors: eps_f32 * ||A||_2 (~1.2e-7)
    # plus the tol=1e-7 solve, with a 5x margin.
    tol = 1e-6
    out = {
        "n": n, "nev": nev, "degree": degree, "maxdim": maxdim,
        "interval_s": t_interval, "solve_s": t_solve,
        "restarts": hist.restarts, "filtered_matvecs": hist.mvproducts,
        "A_matvecs": hist.mvproducts * degree,
        "nconverged": hist.nconverged,
        "max_ritz_resid": float(np.max(np.asarray(res)[:nev])),
        "eig_err": err, "eig_tol": tol,
        "basis_bytes": (maxdim + 1) * n * 4,
    }
    _check(hist.nconverged >= nev, f"{name}: {hist.nconverged} of {nev}")
    _check(err <= tol, f"{name}: eigenvalue error {err}")
    if sharding is not None:
        out["basis_devices"] = len(decomp.Q_rows.sharding.device_set)
        _check(out["basis_devices"] == len(sharding.device_set),
               f"{name}: basis spans every mesh device")
    else:
        # The process's peak so far (no reset exists; the solve is the
        # largest work before it), read before the tiling check below.
        stats = jax.devices()[0].memory_stats() or {}
        out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    if check_tiled:
        # The tiled in-place basis change at the solve's basis width
        # (maxdim+1 rows of n), against the one-GEMM change: the threshold
        # decides which one a solve takes, and both must agree wherever it
        # falls.
        dev = next(iter(decomp.Q_rows.sharding.device_set))
        del decomp, fop
        m1 = maxdim + 1
        V = jax.random.normal(jax.random.PRNGKey(1), (m1, n), jnp.float32)
        Qb, _ = np.linalg.qr(np.random.default_rng(0).standard_normal(
            (m1, m1)))
        Qb = jnp.asarray(Qb, jnp.float32)
        tiles = pick_tiles(n, m1 * 4)
        # Both donate their input: the one-GEMM change gets a copy.
        ref = apply_basis_change(jnp.array(V), Qb)
        got = apply_basis_change_tiled(V, Qb, tiles=tiles)
        diff = float(jax.jit(
            lambda a, b: jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b))
        )(got, ref))
        del ref, got
        out.update(tiled_rows=m1, tiled_tiles=tiles, tiled_rel_diff=diff,
                   tiled_rel_tol=1e-5,
                   tiled_threshold_bytes=tiled_threshold_bytes(dev),
                   solve_basis_tiled=m1 * n * 4 > tiled_threshold_bytes(dev))
        _check(diff <= 1e-5, f"{name}: tiled basis change {diff}")
    return _emit(name, t0, out), w[:nev]


def phase_nonsym(grid=1024, nev=12):
    """bench.py conv1m: periodic convection-diffusion (a normal,
    nonsymmetric circulant) through CirculantShiftInvertOperator, :LM,
    checked against the exact DFT symbol."""
    import jax
    import jax.numpy as jnp

    from arnoldimethod_jax import (
        CirculantShiftInvertOperator,
        partial_schur,
        power_bound,
        rayleigh_ritz,
    )
    from arnoldimethod_jax.models import convection_diffusion_periodic_2d

    t0 = time.perf_counter()
    s, cx, cy = SCALE, 0.15, 0.08
    op = convection_diffusion_periodic_2d(grid, cx=cx, cy=cy, scale=s)
    sigma = float(power_bound(op))
    v = jax.random.normal(jax.random.PRNGKey(0), (grid * grid,), jnp.float32)

    @jax.jit
    def si_power(si, v, steps):
        def body(i, v):
            w = si.matvec(v)
            return w / jnp.linalg.norm(w)

        return jax.lax.fori_loop(0, steps, body, v)

    # Walk sigma to the top edge by staged inverse power iterations.
    for _ in range(4):
        si = CirculantShiftInvertOperator.build(op, sigma)
        v = si_power(si, v, 30)
        Av = op.matvec(v)
        lam = float(jnp.vdot(v, Av, precision=jax.lax.Precision.HIGHEST))
        r = float(jnp.linalg.norm(Av - lam * v))
        sigma = lam + max(4 * r, 0.05 * (sigma - lam), 1e-7)
    si = CirculantShiftInvertOperator.build(op, sigma)
    maxdim, tol = 36, 1e-7
    decomp, hist = partial_schur(si, nev=nev, which="LM", tol=tol,
                                 mindim=18, maxdim=maxdim, restarts=300)
    _check(hist.nconverged >= nev, f"nonsym: {hist.nconverged} of {nev}")
    w, _, res = rayleigh_ritz(op, decomp.Q)
    w = np.asarray(w)
    th = 2 * np.pi * np.arange(grid) / grid
    sym = s * ((2 - 2 * np.cos(th))[:, None] + (2 - 2 * np.cos(th))[None, :]
               + 2j * (cx * np.sin(th)[:, None] + cy * np.sin(th)[None, :]))
    se = sym.ravel()

    def dist(lams):
        return np.array([np.abs(se - t).min() for t in lams])

    # Per-eigenvalue bound from the convergence criterion on S = (A -
    # sigma I)^{-1} (normal): |d theta_i| <= max(eps_f32 ||H||_F, tol
    # |theta_i|) with ||H||_F <= sqrt(maxdim + 1) max|theta|, mapped back
    # through lambda = sigma + 1/theta as |d lambda_i| = |d theta_i| /
    # |theta_i|^2, plus 1e-6 for the float32 operator and Ritz vectors.
    # The f32 floor scales with the DOMINANT theta, so eigenvalues farther
    # from sigma carry a wider bound.
    theta = np.asarray(decomp.eigenvalues)
    dtheta = np.maximum(EPS32 * np.sqrt(maxdim + 1) * np.abs(theta).max(),
                        tol * np.abs(theta))
    bound = dtheta / np.abs(theta) ** 2 + 1e-6
    lam = si.eigenvalues_back(theta)
    err = dist(lam)
    # rayleigh_ritz maps back through float32 contractions over n terms:
    # |d lambda| <~ eps_f32 sqrt(n) ||A||_2, with ||A||_2 <= 8 s + 2 s (cx +
    # cy) for this stencil.
    acc = float(dist(w).max())
    rr_tol = EPS32 * grid * s * (8 + 2 * (cx + cy)) + float(bound.max())
    # Completeness: the 8 symbol values nearest sigma (the ones a :LM
    # solve of (A - sigma I)^{-1} must find) each have a computed match.
    near8 = se[np.argsort(np.abs(se - sigma))][:8]
    nearest = [int(np.argmin(np.abs(lam - t))) for t in near8]
    cov = np.array([np.abs(lam[i] - t) for i, t in zip(nearest, near8)])
    out = {"n": grid * grid, "nev": nev, "sigma": sigma,
           "matvecs": hist.mvproducts, "restarts": hist.restarts,
           "max_ritz_resid": float(np.max(np.asarray(res))),
           "eig_err_max": float(err.max()),
           "eig_err_over_bound_max": float((err / bound).max()),
           "bound_min": float(bound.min()), "bound_max": float(bound.max()),
           "rr_eig_acc": acc, "rr_eig_tol": rr_tol,
           "near8_coverage_over_bound_max": float(
               (cov / bound[nearest]).max()),
           "complex_pairs": int(np.sum(w.imag > 1e-9))}
    _check(np.all(err <= bound), f"nonsym: eigenvalue errors {err}")
    _check(np.all(cov <= bound[nearest]), f"nonsym: near-8 coverage {cov}")
    _check(acc <= rr_tol, f"nonsym: Rayleigh-Ritz accuracy {acc}")
    return _emit("nonsym", t0, out)


def phase_complex(n=1 << 20):
    """bench.py complexscsparse: a complex tridiagonal matrix with 10
    planted eigenvalues, :LI nev=8, natively in complex64 and again
    through split_complex=True."""
    from arnoldimethod_jax import partial_schur
    from arnoldimethod_jax.models.operators import dia_from_diagonals

    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    z = rng.uniform(-1.0, 1.0, n) + 1j * rng.uniform(0.0, 1.0, n)
    planted = np.linspace(2.0, 2.9, 10)
    idx = rng.choice(n, size=10, replace=False)
    z[idx] = 0.3 * rng.standard_normal(10) + 1j * planted
    beta = 0.01
    op = dia_from_diagonals(
        {0: z.astype(np.complex64), 1: beta, -1: 1j * beta}, (n, n),
        dtype=np.complex64,
    )
    kw = dict(nev=8, which="LI", tol=1e-5, mindim=16, maxdim=32,
              restarts=500)
    # Gershgorin: the coupling moves each eigenvalue <= 2 beta off its
    # diagonal seed.  Criterion: ||r_i|| <= 1e-5 |lambda_i| (~2.9e-5), so
    # ||AQ - QR||_F <= sqrt(8) * 2.9e-5 ~ 8e-5 -> 2e-4 with room for the
    # f32 basis, and two near-normal solves agree to ~2 * 2.9e-5 -> 1e-4.
    out = {"n": n, "nev": 8, "planted_tol": 2 * beta + 1e-3,
           "schur_resid_max": 2e-4, "agree_tol": 1e-4}
    lams = {}
    for label, sc in (("native", False), ("split", True)):
        decomp, hist = partial_schur(op, split_complex=sc, **kw)
        _check(hist.nconverged >= 8, f"complex {label}: converged")
        Q = np.asarray(decomp.Q).astype(np.complex128)
        if label == "native":
            _check(np.asarray(decomp.Q_rows).dtype == np.complex64,
                   "complex native: complex64 device basis")
        AQ = z[:, None] * Q
        AQ[:-1] += beta * Q[1:]
        AQ[1:] += 1j * beta * Q[:-1]
        res = float(np.linalg.norm(AQ - Q @ np.asarray(decomp.R)))
        err = float(np.max(np.abs(
            np.sort(decomp.eigenvalues.imag)[-8:] - planted[-8:])))
        out.update({f"{label}_matvecs": hist.mvproducts,
                    f"{label}_schur_resid": res,
                    f"{label}_planted_err": err})
        _check(res <= 2e-4, f"complex {label}: schur residual {res}")
        _check(err <= 2 * beta + 1e-3, f"complex {label}: planted {err}")
        lams[label] = decomp.eigenvalues
    out["native_vs_split"] = _set_distance(lams["native"], lams["split"])
    _check(out["native_vs_split"] <= 1e-4, "complex: native vs split")
    return _emit("complex", t0, out)


def phase_extended(n=100):
    """Double-word float32 on the device: the error-free transforms must
    survive the GPU compiler (no FMA contraction through `_pin`), and the
    README config must converge to tol=1e-12 with extended=True."""
    import jax
    import jax.numpy as jnp

    from arnoldimethod_jax import partial_schur
    from arnoldimethod_jax.models.problems import laplacian_1d
    from arnoldimethod_jax.ops import df32

    t0 = time.perf_counter()
    s, e = jax.jit(df32.two_sum)(jnp.float32(3.0), jnp.float32(1e-9))
    e = float(e)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    y = rng.standard_normal(4096).astype(np.float32)
    dh, dl = jax.jit(df32.df_dot)(jnp.asarray(x), jnp.asarray(y))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    dot_err = abs(float(dh) + float(dl) - exact) / float(np.sum(np.abs(x * y)))
    _check(e != 0.0, "extended: two_sum error word is zero (FMA/reassoc)")
    _check(dot_err < 1e-12, f"extended: df_dot relative error {dot_err}")

    decomp, hist = partial_schur(laplacian_1d(n, dtype=np.float32), nev=10,
                                 which="SR", tol=1e-12, extended=True)
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    Q = np.asarray(decomp.Q, np.float64)
    res = float(np.linalg.norm(A @ Q - Q @ np.asarray(decomp.R)))
    _check(hist.nconverged >= 10, "extended: converged")
    _check(res <= 1e-11, f"extended: schur residual {res}")
    return _emit("extended", t0, {"two_sum_err": e, "df_dot_rel_err": dot_err,
                           "df_dot_tol": 1e-12, "matvecs": hist.mvproducts,
                           "schur_resid_f64": res, "schur_resid_max": 1e-11})


def phase_spmv(grid=4096, nbr=512, kb=8, bsize=128, iters=200):
    """The solver's two streaming sparse formats as XLA compiles them —
    the 5-point stencil on a grid x grid mesh and the BSR einsum — each
    checked against an independent product, timed (min of 3, ended by
    block_until_ready) and set against a device copy of the same bytes
    measured in this process."""
    import jax
    import jax.numpy as jnp

    from arnoldimethod_jax.models.operators import BsrOperator
    from arnoldimethod_jax.models.problems import _grid_2d

    t0 = time.perf_counter()
    coeffs = tuple(SCALE * c for c in LAPLACE)
    st = _stencil(grid, SCALE)
    dia = _grid_2d(grid, grid, *coeffs, np.float32, "dia")
    n = grid * grid
    x = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)
    y_st, y_dia = _matvec(st, x), _matvec(dia, x)
    st_err = float(jnp.max(jnp.abs(y_st - y_dia)) / jnp.max(jnp.abs(y_dia)))
    _check(st_err <= 1e-6, f"spmv: stencil vs DIA {st_err}")

    @jax.jit
    def mv_loop(op, y, steps):
        return jax.lax.fori_loop(0, steps, lambda i, y: op.matvec(y), y)

    dt_st = _per_iter(lambda y, k: mv_loop(st, y, k), x, iters)
    st_bytes = 2 * 4 * n  # x in, y out
    copy_st = _copy_rate(4 * n)

    rng = np.random.default_rng(7)
    cols = np.sort(np.stack(
        [rng.choice(nbr, size=kb, replace=False) for _ in range(nbr)]),
        axis=1).astype(np.int32)
    data = (rng.standard_normal((nbr, kb, bsize, bsize)) * 0.01).astype(
        np.float32)
    bsr = BsrOperator(cols, data, (nbr * bsize, nbr * bsize))
    xb = rng.standard_normal(nbr * bsize).astype(np.float32)
    yb = np.asarray(_matvec(bsr, jnp.asarray(xb)), np.float64)
    xr = xb.astype(np.float64).reshape(nbr, bsize)
    ref = np.einsum("rkij,rkj->ri", data.astype(np.float64), xr[cols])
    ref = ref.reshape(-1)
    bsr_err = float(np.linalg.norm(yb - ref) / np.linalg.norm(ref))
    _check(bsr_err <= 1e-5, f"spmv: BSR vs float64 block product {bsr_err}")
    dt_bsr = _per_iter(lambda y, k: mv_loop(bsr, y, k),
                       jnp.asarray(xb), iters)
    bsr_bytes = data.nbytes + 2 * xb.nbytes
    copy_bsr = _copy_rate(data.nbytes // 2)  # reads + writes data.nbytes

    st_frac = st_bytes / dt_st / copy_st
    bsr_frac = bsr_bytes / dt_bsr / copy_bsr
    return _emit("spmv", t0, {
        "stencil_n": n, "stencil_us": dt_st * 1e6,
        "stencil_gbs": st_bytes / dt_st / 1e9,
        "stencil_copy_gbs": copy_st / 1e9, "stencil_frac_of_copy": st_frac,
        "stencil_vs_dia_rel_err": st_err,
        "bsr_blocks": [nbr, kb, bsize], "bsr_data_bytes": data.nbytes,
        "bsr_us": dt_bsr * 1e6, "bsr_gbs": bsr_bytes / dt_bsr / 1e9,
        "bsr_copy_gbs": copy_bsr / 1e9, "bsr_frac_of_copy": bsr_frac,
        "bsr_rel_err": bsr_err, "bsr_rel_tol": 1e-5,
    })


def phase_sharded_csr(mesh, n=1 << 20, nev=6):
    """ShardedCsrOperator (the shard_map path) at n rows: a symmetric
    sparse matrix with planted top eigenvalues, :LR, against the
    one-device CsrOperator solve of the same matrix."""
    import scipy.sparse as sp

    from arnoldimethod_jax import partial_schur
    from arnoldimethod_jax.models.operators import (
        CsrOperator,
        ShardedCsrOperator,
    )
    from arnoldimethod_jax.parallel import basis_sharding

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    d = rng.uniform(0.0, 1.0, n)
    planted = np.linspace(2.0, 2.9, 10)
    d[rng.choice(n, size=10, replace=False)] = planted
    # Two random couplings per row (values in [0, 0.005)), symmetrized.
    rows = np.repeat(np.arange(n), 2)
    cols = rng.integers(0, n, 2 * n)
    R = sp.coo_matrix((rng.uniform(0.0, 0.005, 2 * n), (rows, cols)),
                      shape=(n, n))
    S = (sp.diags(d) + R + R.T).tocsr().astype(np.float32)
    S.sort_indices()
    kw = dict(nev=nev, which="LR", tol=1e-6, mindim=16, maxdim=32)
    sop = ShardedCsrOperator.build(S.indptr, S.indices, S.data, S.shape,
                                   mesh)
    d_sh, h_sh = partial_schur(sop, sharding=basis_sharding(mesh), **kw)
    d_one, h_one = partial_schur(
        CsrOperator(S.indptr, S.indices, S.data, S.shape), **kw)
    _check(h_sh.nconverged >= nev and h_one.nconverged >= nev,
           "sharded_csr: converged")
    # Gershgorin: the coupling (row sums <= ~0.02 here) bounds each
    # eigenvalue's distance to its planted seed; the two solves reach
    # residuals <= 1e-6 |lambda| of a symmetric matrix, so they agree to
    # well within 1e-5.
    err = float(np.max(np.abs(np.sort(d_sh.eigenvalues.real)
                              - planted[-nev:])))
    agree = _set_distance(d_sh.eigenvalues, d_one.eigenvalues)
    out = {"n": n, "nnz": int(S.nnz), "mode": sop.mode, "nev": nev,
           "matvecs": h_sh.mvproducts, "planted_err": err,
           "planted_tol": 0.05, "sharded_vs_one": agree, "agree_tol": 1e-5,
           "basis_devices": len(d_sh.Q_rows.sharding.device_set)}
    _check(err <= 0.05, f"sharded_csr: planted error {err}")
    _check(agree <= 1e-5, f"sharded_csr: sharded vs one-device {agree}")
    _check(out["basis_devices"] == mesh.devices.size,
           "sharded_csr: basis spans every mesh device")
    return _emit("sharded_csr", t0, out)


# --- drivers ---------------------------------------------------------------


def run_one_card():
    from arnoldimethod_jax.dense import native

    if not native.available():
        raise RuntimeError(
            f"native dense layer did not build: {native.build_error()}"
        )
    print("dense restart layer: native C++", flush=True)
    phase_readme()
    phase_config2()
    phase_fused65k()
    phase_northstar()
    phase_nonsym()
    phase_complex()
    phase_extended()
    phase_spmv()


def _compare(name, value, tol):
    print(f"compare {name} vs one card: "
          f"{json.dumps({'distance': value, 'tol': tol})}", flush=True)
    _check(value <= tol, f"{name}: mesh vs one card {value}")


FULL_SIZES = {
    "grid": 1024, "grid65k": 256, "csr_n": 1 << 20,
    "northstar": {"grid": 3200, "nev": 100, "degree": 1000, "maxdim": 200,
                  "schedule": (100, 200, 400, 400)},
}


def run_four_cards(ncards, sizes=FULL_SIZES):
    """The sharded path on an ncards-device mesh, each problem beside its
    one-card solve in the same process."""
    import jax

    from arnoldimethod_jax.parallel import basis_sharding, make_mesh

    if len(jax.devices()) < ncards:
        raise RuntimeError(
            f"--cards {ncards} needs {ncards} devices, found "
            f"{len(jax.devices())}"
        )
    mesh = make_mesh(ncards)
    sh = basis_sharding(mesh)
    t0 = time.perf_counter()
    # Each solve is within its phase tolerance of the analytic spectrum,
    # so a mesh solve and its one-card twin agree to twice that.
    _, one = phase_config2(grid=sizes["grid"], name="config2_one_card")
    for label, kw in (("host", {"method": "host"}),
                      ("lowsync", {"lowsync": True})):
        _, lam = phase_config2(grid=sizes["grid"], sharding=sh,
                            name=f"config2_mesh_{label}", **kw)
        _compare(f"config2_mesh_{label}", _set_distance(lam, one), 2e-5)
    _, fused_one = phase_fused65k(grid=sizes["grid65k"], methods=("device",),
                               name="fused65k_one_card")
    _, fused_mesh = phase_fused65k(grid=sizes["grid65k"], sharding=sh,
                                methods=("device",),
                                name="fused65k_mesh_device")
    _compare("fused65k_mesh_device",
             _set_distance(fused_mesh["device"], fused_one["device"]), 2e-5)
    _, ns_one = phase_northstar(**sizes["northstar"], check_tiled=False,
                             name="northstar_one_card")
    _, ns_mesh = phase_northstar(**sizes["northstar"], sharding=sh,
                              check_tiled=False, name="northstar_mesh")
    _compare("northstar_mesh", float(np.max(np.abs(ns_mesh - ns_one))), 2e-6)
    phase_sharded_csr(mesh, n=sizes["csr_n"])
    print(f"four-card phases: {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs an NVIDIA GPU; JAX found platform "
            f"{dev.platform!r} ({dev.device_kind})"
        )

    from arnoldimethod_jax.compile_cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    for line in smi:
        print(f"nvidia-smi: {line}")
    print(f"compile cache: {enable_compile_cache()}")
    print(f"key: wall_s = one run on {dev.device_kind} ({smi[0]}), "
          "compilation included; *_tol / *_max are the bounds each value "
          "is held to", flush=True)

    if args.cards == 1:
        run_one_card()
    else:
        run_four_cards(args.cards)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
