"""Linear-algebra ops of the port: the products, ``einsum``, the
decompositions and the long-tail surface of ``paddle_tpu.ops.linalg``
(``inv``, ``lu`` / ``lu_unpack``, ``cond``, ``matrix_exp``, the vector and
matrix norms, ``ormqr``, ``cholesky_inverse``, the randomized
``svd_lowrank`` / ``pca_lowrank`` of Halko, Martinsson and Tropp, and
``fp8_fp8_half_gemm_fused``, which upcasts its fp8 operands to bf16 and
multiplies them, as the JAX function does; no fp8 kernel is written).
The decompositions are ``torch.linalg``'s (cuSOLVER on the card, LAPACK
on the CPU); ``paddle_tpu_torch.linalg`` re-exports this module.

``matmul`` is ``torch.matmul`` (the JAX package computes it outside
any Pallas kernel); bf16 inputs reduce in f32 on the card.
"""
from __future__ import annotations

import torch

from ..core.autograd import apply_op
from ..core.tensor import Tensor, as_torch

__all__ = ["matmul", "mm", "bmm", "dot", "inner", "outer", "cross", "t",
           "norm", "dist", "einsum", "transpose", "cholesky",
           "cholesky_solve", "inverse", "pinv", "solve", "triangular_solve",
           "lstsq", "qr", "svd", "eig", "eigh", "eigvals", "eigvalsh", "det",
           "slogdet", "matrix_rank", "matrix_power", "multi_dot", "trace",
           "diagonal", "kron", "mv", "corrcoef", "cov",
           "householder_product", "inv", "cholesky_inverse",
           "vector_norm", "matrix_norm", "cond", "matrix_exp", "lu",
           "lu_unpack", "ormqr", "svd_lowrank", "pca_lowrank",
           "fp8_fp8_half_gemm_fused"]


def _matmul(a, b, transpose_x=False, transpose_y=False):
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return apply_op(_matmul, x, y, transpose_x=transpose_x,
                    transpose_y=transpose_y, op_name="matmul")


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return apply_op(lambda a, b: torch.sum(a * b, dim=-1), x, y)


def inner(x, y, name=None):
    return apply_op(torch.inner, x, y)


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                    x, y)


def cross(x, y, axis=9, name=None):
    """``axis=9`` (paddle's default) is the first axis of size 3."""
    def f(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply_op(f, x, y)


def t(input, name=None):
    return apply_op(lambda a: a.permute(*range(a.dim() - 1, -1, -1)), input)


def _ax(axis):
    return tuple(axis) if isinstance(axis, list) else axis


def _ord(p):
    if p == "inf":
        return float("inf")
    if p == "-inf":
        return -float("inf")
    return p


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius / 2-norm by default; a numeric ``p`` is a vector norm
    over one axis (or all, flattened) and a matrix norm over two."""
    def f(a):
        ax = _ax(axis)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(a * a))
            return torch.linalg.norm(a, None, dim=ax, keepdim=keepdim)
        o = _ord(p)
        if ax is None:
            return torch.linalg.vector_norm(a.reshape(-1), o)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(a, o, dim=ax, keepdim=keepdim)
        return torch.linalg.vector_norm(a, o, dim=ax, keepdim=keepdim)
    return apply_op(f, x)


def dist(x, y, p=2, name=None):
    return apply_op(lambda a, b: torch.linalg.vector_norm(
        (a - b).reshape(-1), _ord(p)), x, y)


def einsum(equation, *operands):
    return apply_op(lambda *ops: torch.einsum(equation, *ops), *operands,
                    op_name="einsum")


def transpose(x, perm, name=None):
    return apply_op(lambda a: a.permute(*perm), x)


def cholesky(x, upper=False, name=None):
    def f(a):
        L = torch.linalg.cholesky(a)
        return L.transpose(-1, -2) if upper else L
    return apply_op(f, x)


def cholesky_solve(x, y, upper=False, name=None):
    """Solves ``A X = x`` with ``y`` the Cholesky factor of ``A``."""
    return apply_op(lambda b, L: torch.cholesky_solve(b, L, upper=upper),
                    x, y)


def inverse(x, name=None):
    return apply_op(torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x)


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        up = upper
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply_op(f, x, y)


def _tt(x):
    return x if isinstance(x, Tensor) else Tensor(as_torch(x))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), as numpy's."""
    def f(a, b):
        r = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver or (
            "gelsd" if a.device.type == "cpu" else None))
        return r.solution, r.residuals, r.rank, r.singular_values
    return apply_op(f, _tt(x), _tt(y))


def qr(x, mode="reduced", name=None):
    def f(a):
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)
    return apply_op(f, x)


def svd(x, full_matrices=False, name=None):
    """(U, S, VH); VH is V's conjugate transpose."""
    return apply_op(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


def _real_if_real(z):
    """numpy's rule for ``eig``: a real result when every imaginary
    part is zero."""
    return z.real if bool((z.imag == 0).all()) else z


def eig(x, name=None):
    def f(a):
        w, v = torch.linalg.eig(a)
        if bool((w.imag == 0).all()):
            return w.real, _real_if_real(v)
        return w, v
    return apply_op(f, _tt(x))


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvals(x, name=None):
    return apply_op(lambda a: _real_if_real(torch.linalg.eigvals(a)), _tt(x))


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def det(x, name=None):
    return apply_op(torch.linalg.det, x)


def slogdet(x, name=None):
    return apply_op(lambda a: torch.stack(tuple(torch.linalg.slogdet(a))), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian), x)


def matrix_power(x, n, name=None):
    return apply_op(lambda a: torch.linalg.matrix_power(a, n), x)


def multi_dot(x, name=None):
    return apply_op(lambda *ops: torch.linalg.multi_dot(ops), *x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                    x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2), x)


def kron(x, y, name=None):
    return apply_op(torch.kron, x, y)


def mv(x, vec, name=None):
    return apply_op(lambda a, v: a @ v, x, vec)


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda a: torch.corrcoef(a if rowvar else a.T), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw = None if fweights is None else as_torch(fweights)
    aw = None if aweights is None else as_torch(aweights)
    return apply_op(lambda a: torch.cov(a if rowvar else a.T,
                                        correction=1 if ddof else 0,
                                        fweights=fw, aweights=aw), x)


def householder_product(x, tau, name=None):
    return apply_op(torch.linalg.householder_product, x, tau)


# -- the long-tail linalg surface ---------------------------------------------

def inv(x, name=None):
    """Alias of :func:`inverse`."""
    return inverse(x, name=name)


def cholesky_inverse(x, upper=False, name=None):
    """``A⁻¹`` from A's Cholesky factor."""
    return apply_op(lambda L: torch.cholesky_inverse(L, upper=upper), x,
                    op_name="cholesky_inverse")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The p-norm of the input (or of the given axes taken together as
    one vector), in f32."""
    dims = tuple(axis) if isinstance(axis, (list, tuple)) \
        else None if axis is None else (int(axis),)
    return apply_op(lambda a: torch.linalg.vector_norm(
        a.float(), ord=p, dim=dims, keepdim=keepdim), x,
        op_name="vector_norm")


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """fro / nuc / ±1 / ±2 / ±inf over the two matrix axes, in f32."""
    return apply_op(lambda a: torch.linalg.matrix_norm(
        a.float(), ord=p, dim=tuple(axis), keepdim=keepdim), x,
        op_name="matrix_norm")


def cond(x, p=None, name=None):
    """The condition number, in f32."""
    return apply_op(lambda a: torch.linalg.cond(a.float(), p=p), x,
                    op_name="cond")


def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, x, op_name="matrix_exp")


def lu(x, pivot=True, get_infos=False, name=None):
    """Compact LU in f32: ``(LU, pivots[, infos])``, L unit lower and U
    packed in one matrix, pivots 1-based row swaps (LAPACK's)."""
    if not pivot:
        raise NotImplementedError(
            "lu(pivot=False) is unsupported, as in the JAX package")

    def f(a):
        lu_mat, piv, info = torch.linalg.lu_factor_ex(a.float())
        piv = piv.to(torch.int32)
        return (lu_mat, piv, info.to(torch.int32)) if get_infos \
            else (lu_mat, piv)
    return apply_op(f, x, op_name="lu")


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """:func:`lu`'s compact result as ``(P, L, U)``, ``A = P L U``
    (``None`` for a part not asked for)."""
    def f(lu_mat, piv):
        P, L, U = torch.lu_unpack(lu_mat, piv.to(torch.int32),
                                  unpack_data=unpack_ludata,
                                  unpack_pivots=unpack_pivots)
        return P, L, U
    P, L, U = apply_op(f, x, y, op_name="lu_unpack")
    return (P if unpack_pivots else None,
            L if unpack_ludata else None,
            U if unpack_ludata else None)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """``op(Q) y`` (or ``y op(Q)``) for the full Q of the Householder
    factorization ``(x, tau)``."""
    return apply_op(lambda h, t, m: torch.ormqr(h, t, m, left=left,
                                                transpose=transpose),
                    x, tau, y, op_name="ormqr")


def _lowrank_q(a, q_size: int, niter: int, omega):
    """Randomized range finder: Q spans about the top ``q_size``
    columns of ``a`` after ``niter`` power iterations."""
    q, _ = torch.linalg.qr(a @ omega)
    for _ in range(niter):
        z, _ = torch.linalg.qr(a.transpose(-1, -2) @ q)
        q, _ = torch.linalg.qr(a @ z)
    return q


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized truncated SVD of ``x`` (less ``M``): ``(U, S, V)``,
    with V (not Vᵀ). The Gaussian test matrix comes from a key of the
    port's key stream on ``x``'s device."""
    from ..core import random as random_mod
    a0 = as_torch(x)
    k = min(q, *a0.shape[-2:])
    omega = random_mod.normal(a0.shape[:-2] + (a0.shape[-1], k),
                              device=a0.device)

    def f(a, *rest):
        a = a.float()
        if rest:
            a = a - rest[0]
        qmat = _lowrank_q(a, k, niter, omega)
        u_b, s, vh = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                      full_matrices=False)
        return qmat @ u_b, s, vh.transpose(-1, -2)

    args = [x] + ([M] if M is not None else [])
    return apply_op(f, *args, op_name="svd_lowrank")


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA: :func:`svd_lowrank` of the (centred) data."""
    m, n = as_torch(x).shape[-2:]
    q = min(6, m, n) if q is None else q
    if center:
        x = apply_op(lambda a: a.float() - a.float().mean(-2, keepdim=True),
                     x, op_name="pca_center")
    return svd_lowrank(x, q=q, niter=niter)


def fp8_fp8_half_gemm_fused(x, y, transpose_x=False, transpose_y=False,
                            bias=None, scale=1.0, output_dtype="bfloat16",
                            act="identity", name=None):
    """``act(x y · scale + bias)`` with x and y (fp8 or any float)
    upcast to bf16, in ``output_dtype``: the JAX function's contract.
    It launches no fp8 kernel."""
    from ..core.dtype import convert_dtype
    if act not in ("identity", "gelu", "relu"):
        raise ValueError(f"unknown act {act!r}")

    def f(a, b, *maybe_bias):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if transpose_x:
            a16 = a16.transpose(-1, -2)
        if transpose_y:
            b16 = b16.transpose(-1, -2)
        out = torch.matmul(a16, b16) * torch.tensor(
            scale, dtype=torch.bfloat16, device=a16.device)
        if maybe_bias:
            out = out + maybe_bias[0].to(out.dtype)
        if act == "gelu":
            out = torch.nn.functional.gelu(out)
        elif act == "relu":
            out = torch.relu(out)
        return out.to(convert_dtype(output_dtype))
    args = (x, y) + ((bias,) if bias is not None else ())
    return apply_op(f, *args, op_name="fp8_gemm")
