"""arnoldimethod_jax: a partial eigensolver framework in JAX.

Computes partial Schur decompositions A Q = Q R and partial
eigendecompositions of large square matrices and matrix-free operators for
eigenvalues nearest a target (LM/LR/SR/LI/SI), via the restarted Arnoldi
method with Krylov-Schur restarts — built on JAX/XLA, with the
capabilities of ArnoldiMethod.jl (see SURVEY.md for the behavioral spec).

Public API (mirroring the reference's four exports, ArnoldiMethod.jl:8):

    partial_schur(A, nev=..., which=..., tol=...)  -> (PartialSchur, History)
    partial_eigen(decomp)                          -> (values, vectors)
    ArnoldiWorkspace                               -- resume/warm-start state
    LM, LR, SR, LI, SI                             -- eigenvalue targets

plus the operator types (DenseOperator, EllOperator, FunctionOperator,
ShiftInvertDenseOperator) and model problems under .models.
"""

from .driver import History, PartialSchur, partial_schur
from .eigen import partial_eigen
from .targets import LI, LM, LR, SI, SR, Target
from .transforms import (
    BInnerProductOperator,
    ChebyshevFilterOperator,
    estimate_interval,
    CirculantShiftInvertOperator,
    GeneralizedShiftInvertOperator,
    power_bound,
    rayleigh_ritz,
)
from .workspace import ArnoldiWorkspace
from .models.operators import (
    CsrOperator,
    SellOperator,
    SplitComplexOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    FunctionOperator,
    LinearOperator,
    ShardedCsrOperator,
    ShiftInvertDenseOperator,
    TridiagonalShiftInvertOperator,
    as_operator,
    csr_to_ell,
    dia_from_diagonals,
)

__version__ = "0.2.0"

__all__ = [
    "partial_schur",
    "partial_eigen",
    "ArnoldiWorkspace",
    "PartialSchur",
    "History",
    "Target",
    "LM",
    "LR",
    "SR",
    "LI",
    "SI",
    "LinearOperator",
    "DenseOperator",
    "DiaOperator",
    "dia_from_diagonals",
    "EllOperator",
    "CsrOperator",
    "SellOperator",
    "SplitComplexOperator",
    "ShardedCsrOperator",
    "FunctionOperator",
    "ShiftInvertDenseOperator",
    "TridiagonalShiftInvertOperator",
    "CirculantShiftInvertOperator",
    "GeneralizedShiftInvertOperator",
    "BInnerProductOperator",
    "ChebyshevFilterOperator",
    "estimate_interval",
    "power_bound",
    "rayleigh_ritz",
    "as_operator",
    "csr_to_ell",
]
