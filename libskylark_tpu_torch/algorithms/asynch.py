"""Randomized block solvers: randomized block Gauss–Seidel sweeps on an
SPD system, alone or as the inner preconditioner of flexible CG (the
port of libskylark_tpu/algorithms/asynch.py, the synchronous analog of
libSkylark's AsyRGS and AsyFCG).

Each sweep visits the blocks in the order ``randgen.permutation(
fold_in(key, sweep), nblocks)``, made on the host, and solves each
diagonal block exactly. The diagonal blocks are LU-factored once per
system (the arithmetic of a dense solve, split in its two halves); a
sweep is then a host loop of per-block launches on the operand's device
with no device read inside it. The Gauss–Seidel driver reads the
residual once per ``sweeps`` sweeps, its stopping test.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from libskylark_tpu_torch.algorithms import krylov
from libskylark_tpu_torch.base import randgen
from libskylark_tpu_torch.base.context import Context, fold_in
from libskylark_tpu_torch.base.device import as_tensor
from libskylark_tpu_torch.base.params import Params
from libskylark_tpu_torch.base.precision import with_solver_precision


@dataclasses.dataclass
class RandBlockParams(Params):
    """``sweeps`` sweeps between convergence checks, at most
    ``max_outer`` checks."""

    block_size: int = 64
    sweeps: int = 4
    tolerance: float = 1e-6
    max_outer: int = 20


class _BlockSystem:
    """An SPD system padded to whole blocks (identity on the padded rows),
    with the randomized sweep that both entry points share."""

    def __init__(self, A, block_size: int, device=None):
        A = as_tensor(A, device)
        n = A.shape[0]
        bs = min(int(block_size), n)
        nblocks = -(-n // bs)
        pad = nblocks * bs - n
        if pad:
            A_p = torch.zeros((n + pad, n + pad), dtype=A.dtype,
                              device=A.device)
            A_p[:n, :n] = A
            idx = torch.arange(n, n + pad, device=A.device)
            A_p[idx, idx] = 1.0
        else:
            A_p = A
        self.A_p = A_p
        self.n, self.bs, self.nblocks, self.pad = n, bs, nblocks, pad
        diag = A_p.reshape(nblocks, bs, nblocks, bs).diagonal(
            dim1=0, dim2=2).permute(2, 0, 1)
        self._lu, self._piv = torch.linalg.lu_factor(diag)

    def pad_cols(self, X: torch.Tensor) -> torch.Tensor:
        if not self.pad:
            return X
        return torch.cat([X, X.new_zeros((self.pad, X.shape[1]))], dim=0)

    def order(self, skey) -> torch.Tensor:
        """The sweep's block order (host int64)."""
        return randgen.permutation(skey, self.nblocks)

    def sweep(self, X: torch.Tensor, B_p: torch.Tensor, skey) -> torch.Tensor:
        """One randomized block Gauss–Seidel sweep over the padded system
        under the (2,) uint32 key data ``skey``: block J of the order
        solves A_JJ·x_J = b_J − A_J·x + A_JJ·x_J."""
        X = X.clone()
        bs = self.bs
        for b in self.order(skey).tolist():
            r0, r1 = b * bs, (b + 1) * bs
            A_JJ = self.A_p[r0:r1, r0:r1]
            resid = B_p[r0:r1] - self.A_p[r0:r1] @ X + A_JJ @ X[r0:r1]
            X[r0:r1] = torch.linalg.lu_solve(self._lu[b], self._piv[b],
                                             resid)
        return X


@with_solver_precision
def rand_block_gauss_seidel(A, B, context: Context,
                            params: Optional[RandBlockParams] = None,
                            X0=None, device=None):
    """Randomized block Gauss–Seidel on SPD A: ``sweeps`` sweeps, each in
    a fresh random block order, then a residual check, at most
    ``max_outer`` times. Returns (X, sweeps_done)."""
    params = params or RandBlockParams()
    B = as_tensor(B, device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    n, k = B.shape
    sys = _BlockSystem(A, params.block_size, B.device)
    key = context.allocate().key

    B_p = sys.pad_cols(B)
    X = sys.pad_cols(torch.zeros((n, k), dtype=B.dtype, device=B.device)
                     if X0 is None
                     else as_tensor(X0, B.device).reshape(n, k))
    nrm_b = torch.clamp_min(torch.linalg.norm(B_p),
                            torch.finfo(B.dtype).eps)

    sweeps_done = 0
    for _outer in range(params.max_outer):
        for _s in range(params.sweeps):
            X = sys.sweep(X, B_p, fold_in(key, sweeps_done))
            sweeps_done += 1
        res = torch.linalg.norm(B_p - sys.A_p @ X) / nrm_b
        if float(res) <= params.tolerance:
            break

    X = X[:n, :]
    return (X[:, 0] if squeeze else X), sweeps_done


def rand_block_fcg(A, B, context: Context,
                   params: Optional[RandBlockParams] = None,
                   krylov_params: Optional[krylov.KrylovParams] = None,
                   device=None):
    """Flexible CG with one randomized block Gauss–Seidel sweep as its
    (varying) preconditioner, sweep ``it`` under fold_in(key, it).
    Returns (X, iterations)."""
    params = params or RandBlockParams()
    A = as_tensor(A, device)
    sys = _BlockSystem(A, params.block_size, A.device)
    key = context.allocate().key
    n = sys.n

    def apply_gs(R, it):
        Rp = sys.pad_cols(R)
        return sys.sweep(torch.zeros_like(Rp), Rp, fold_in(key, it))[:n, :]

    return krylov.flexible_cg(A, B, params=krylov_params, precond=apply_gs,
                              device=A.device)
