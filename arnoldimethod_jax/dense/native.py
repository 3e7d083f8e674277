"""ctypes bindings for the native (C++) dense restart kernels.

The shared library (built from native/arnoldi_dense.cpp) implements the
same LAPACK-free kernels as the numpy modules in this package; the numpy
layer is the tested behavioral reference, the native layer is the
production fast path for the host-side restart work.  `available()`
reports whether the library loaded; the driver picks the native functions
when present unless ARNOLDI_NATIVE=0.

The library is built from the source at first import, into this package
directory under a name keyed by the source's SHA-256
(`libarnoldi_dense-<hash>.so`): a library built from another version of
the source is never loaded.  A failed build is logged and kept in
`build_error()`; the solver then runs on the numpy layer.

All wrappers operate in place on C-contiguous float64/complex128 arrays
with the same conventions as the numpy layer (0-based, half-open windows).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

_LOG = logging.getLogger("arnoldimethod_jax")
_HERE = os.path.dirname(__file__)
# Source lives in native/ in the repo layout; installed wheels bundle a
# copy next to this module (setup.py) so the auto-build works post-install.
_SRC_PATH = next(
    (
        p
        for p in (
            os.path.join(_HERE, "arnoldi_dense.cpp"),
            os.path.join(
                os.path.dirname(os.path.dirname(_HERE)),
                "native",
                "arnoldi_dense.cpp",
            ),
        )
        if os.path.exists(p)
    ),
    "",
)


def library_path(src, out_dir=_HERE):
    """Path of the library built from `src`: keyed by the source hash."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(out_dir, f"libarnoldi_dense-{digest}.so")


def build(src, out_dir=_HERE):
    """Return (path, error): the library for `src`, compiled now unless
    a library of the same source hash exists.  `error` is None on success
    and the compiler's message otherwise.  Concurrent builders each
    compile to a private file and rename it into place."""
    path = library_path(src, out_dir)
    if os.path.exists(path):
        return path, None
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", None) or str(exc)
        return None, f"{' '.join(cmd)}: {detail.strip()[-2000:]}"
    os.replace(tmp, path)
    return path, None


_lib = None
_build_error = None
if os.environ.get("ARNOLDI_NATIVE", "1") != "0":
    if not _SRC_PATH:
        _build_error = "native/arnoldi_dense.cpp not found"
    else:
        _path, _build_error = build(_SRC_PATH)
        if _path is not None:
            try:
                _lib = ctypes.CDLL(_path)
            except OSError as exc:
                _build_error = f"loading {_path}: {exc}"
    if _build_error:
        _LOG.warning(
            "native dense layer unavailable, using numpy: %s", _build_error
        )

_c_long = ctypes.c_long
_c_int = ctypes.c_int
_c_double = ctypes.c_double
_p = ctypes.c_void_p

if _lib is not None:
    _lib.am_local_schur_d.restype = _c_int
    _lib.am_local_schur_d.argtypes = [_p, _c_long, _c_long, _c_long, _c_long,
                                      _c_long, _p, _c_long, _c_long, _c_double,
                                      _c_long]
    _lib.am_local_schur_z.restype = _c_int
    _lib.am_local_schur_z.argtypes = _lib.am_local_schur_d.argtypes
    _lib.am_partition_d.argtypes = [_p, _c_long, _c_long, _p, _c_long, _c_long, _p]
    _lib.am_partition_z.argtypes = _lib.am_partition_d.argtypes
    _lib.am_sort_schur_d.argtypes = [_p, _c_long, _c_long, _p, _c_long, _c_long,
                                     _c_long, _c_int]
    _lib.am_sort_schur_z.argtypes = _lib.am_sort_schur_d.argtypes
    _lib.am_restore_d.argtypes = [_p, _c_long, _c_long, _c_long, _p, _c_long,
                                  _c_long, _c_long, _c_long]
    _lib.am_restore_z.argtypes = _lib.am_restore_d.argtypes
    _lib.am_eigvals_d.argtypes = [_p, _c_long, _c_long, _c_long, _c_double, _p, _p]
    _lib.am_eigvals_z.argtypes = _lib.am_eigvals_d.argtypes
    _lib.am_residuals_d.argtypes = [_p, _c_long, _c_long, _p, _c_long,
                                    _c_double, _c_long, _c_long, _p]
    _lib.am_residuals_z.argtypes = [_p, _c_long, _c_long, _p, _c_long,
                                    _p, _c_long, _c_long, _p]

# Ordering codes shared with the C++ side.
ORDER_CODES = {"LM": 0, "LR": 1, "SR": 2, "LI": 3, "SI": 4}

# The C++ kernels use fixed stack buffers of this size for eigenvector /
# eigenvalue scratch.
MAX_DIM = 512


def available():
    return _lib is not None


def build_error():
    """Why the native library is not available (None when it loaded or
    ARNOLDI_NATIVE=0 disabled it)."""
    return _build_error


def _is_c(a):
    return a.flags["C_CONTIGUOUS"]


def _ptr(a):
    return a.ctypes.data_as(_p)


def _complex(H):
    return np.iscomplexobj(H)


def local_schur(H, lo, hi, Q=None, tol=None, maxiter=None):
    """Native drop-in for dense.schur.local_schur (in place)."""
    assert _is_c(H) and (Q is None or _is_c(Q))
    if tol is None:
        tol = float(np.finfo(H.real.dtype).eps)
    if maxiter is None:
        maxiter = 100 * H.shape[0]
    m_rows, n = H.shape
    qld = Q.shape[1] if Q is not None else 0
    qrows = Q.shape[0] if Q is not None else 0
    fn = _lib.am_local_schur_z if _complex(H) else _lib.am_local_schur_d
    ok = fn(_ptr(H), H.shape[1], m_rows, n, lo, hi,
            _ptr(Q) if Q is not None else None, qld, qrows, tol, maxiter)
    if not ok and not _complex(H):
        raise RuntimeError("QR algorithm did not converge")
    return bool(ok)


def partition_three_way(R, Q, groups):
    assert _is_c(R) and _is_c(Q)
    g = np.ascontiguousarray(groups, dtype=np.int64)
    fn = _lib.am_partition_z if _complex(R) else _lib.am_partition_d
    fn(_ptr(R), R.shape[1], R.shape[1], _ptr(Q), Q.shape[1], Q.shape[0], _ptr(g))


def sort_schur(R, Q, count, which):
    assert _is_c(R) and _is_c(Q)
    code = ORDER_CODES[which]
    fn = _lib.am_sort_schur_z if _complex(R) else _lib.am_sort_schur_d
    fn(_ptr(R), R.shape[1], R.shape[1], _ptr(Q), Q.shape[1], Q.shape[0],
       count, code)


def restore_arnoldi(H, lo, hi, Q):
    assert _is_c(H) and _is_c(Q)
    rows, cols = H.shape
    fn = _lib.am_restore_z if _complex(H) else _lib.am_restore_d
    fn(_ptr(H), H.shape[1], rows, cols, _ptr(Q), Q.shape[1], Q.shape[0], lo, hi)


def copy_eigenvalues(lams, R, lo=0, hi=None, tol=None):
    assert _is_c(R)
    if hi is None:
        hi = R.shape[1]
    if tol is None:
        tol = float(np.finfo(R.real.dtype).eps)
    out_re = np.zeros(R.shape[1], dtype=np.float64)
    out_im = np.zeros(R.shape[1], dtype=np.float64)
    fn = _lib.am_eigvals_z if _complex(R) else _lib.am_eigvals_d
    fn(_ptr(R), R.shape[1], lo, hi, tol, _ptr(out_re), _ptr(out_im))
    lams[lo:hi] = out_re[lo:hi] + 1j * out_im[lo:hi]
    return lams


def copy_residuals(rs, H, Q, h_last, lo, hi):
    assert _is_c(H) and _is_c(Q)
    m = H.shape[1]
    if _complex(H):
        hl = np.array([h_last], dtype=np.complex128)
        _lib.am_residuals_z(_ptr(H), H.shape[1], m, _ptr(Q), Q.shape[1],
                            _ptr(hl), lo, hi, _ptr(rs))
    else:
        _lib.am_residuals_d(_ptr(H), H.shape[1], m, _ptr(Q), Q.shape[1],
                            float(h_last), lo, hi, _ptr(rs))
    return rs
