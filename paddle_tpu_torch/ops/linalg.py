"""Linear-algebra ops of the port: the products, ``einsum`` and the
decompositions of ``paddle_tpu.ops.linalg`` up to its long-tail
section (``inv``, ``vector_norm`` and the rest wait).

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
           "householder_product"]


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
