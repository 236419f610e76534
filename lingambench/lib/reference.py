"""The plain reference: DirectLiNGAM and VAR least squares in plain
PyTorch and NumPy, written from the papers (Shimizu et al. 2011,
Hyvarinen 1998, Hyvarinen et al. 2010), independent of the code under
test. It imports neither the port nor the JAX package, and it takes
nothing the port made but the outputs it judges.

Three precisions (``mode``):

* ``"reference"`` -- the judge: working data, every product
  (correlations, covariances, the regression Gram), the entropy
  integrands and every sample sum in float64. It is more precise than
  the configurations state (float32, TF32 off), so that its own rounding
  lies below the program's.
* ``"lower"`` -- the control: every float32 operation one step below
  the configurations' float32 with TF32 off, products as float32 matmuls
  in TF32 and the integrands (elementwise, where TF32 does not exist) in
  bfloat16; float32 working data, float64 sample sums.
* ``"bfloat16"`` -- products and integrands in bfloat16 (float32
  accumulation): the control's stand-in on a CPU, which has no TF32.

:func:`walk` either replays a given causal order, recording at every step
how far the chosen variable's score lies below the best score of that
step (the *gap*; 0 when the chosen variable is the best), or picks the
best variable itself (the control in the program's place).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

# Hyvarinen's (1998) maximum-entropy approximation, as DirectLiNGAM uses it.
K1 = 79.047
K2 = 7.4129
GAMMA = 0.37457
H_GAUSS = 0.5 * (1.0 + math.log(2.0 * math.pi))
LOG2 = math.log(2.0)
MODES = ("reference", "lower", "bfloat16")
_BLOCK_ELEMS = 1 << 27


@contextlib.contextmanager
def precision(mode: str):
    """Float32 matmuls in TF32 for ``"lower"``, in full float32 otherwise."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(
        "high" if mode == "lower" else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _work_dtype(mode):
    return torch.float64 if mode == "reference" else torch.float32


def _elem_dtype(mode):
    if mode == "reference":
        return torch.float64
    return torch.bfloat16


def _product(a, b, mode):
    """a @ b in the mode's product precision, returned as float64."""
    if mode == "reference":
        return a.double() @ b.double()
    if mode == "bfloat16":
        return (a.bfloat16() @ b.bfloat16()).double()
    return (a.float() @ b.float()).double()


def entropy(m1, m2):
    return H_GAUSS - K1 * (m1 - GAMMA) ** 2 - K2 * m2 ** 2


def _terms_sums(u):
    """float64 sums over the last axis of log cosh u + log 2 and of
    u exp(-u^2 / 2)."""
    s1 = torch.logaddexp(u, -u).sum(-1, dtype=torch.float64)
    s2 = u.square().mul_(-0.5).exp_().mul_(u).sum(-1, dtype=torch.float64)
    return s1, s2


def pair_moments(xs_t, c, mode):
    """M1[i, j], M2[i, j]: the sample means of log cosh u_ij and of
    u_ij exp(-u_ij^2 / 2), u_ij = (x_i - c_ij x_j) / sqrt(1 - c_ij^2), over
    the standardized rows ``xs_t`` (w, m); float64 (w, w)."""
    w, m = xs_t.shape
    dt = _elem_dtype(mode)
    xt = xs_t.to(dt)
    inv = torch.rsqrt(torch.clamp(1.0 - c * c, min=1e-12))
    s1 = torch.zeros((w, w), dtype=torch.float64, device=xs_t.device)
    s2 = torch.zeros_like(s1)
    ms = max(1, min(m, _BLOCK_ELEMS // (w * w)))
    rows = max(1, min(w, _BLOCK_ELEMS // (w * ms)))
    for r0 in range(0, w, rows):
        r1 = min(w, r0 + rows)
        cb = c[r0:r1].to(dt)[:, :, None]
        ib = inv[r0:r1].to(dt)[:, :, None]
        for k0 in range(0, m, ms):
            xj = xt[:, k0:k0 + ms]
            u = torch.addcmul(xj[r0:r1, None, :], cb, xj[None, :, :],
                              value=-1.0).mul_(ib)
            a, b = _terms_sums(u)
            s1[r0:r1] += a
            s2[r0:r1] += b
    return s1 / m - LOG2, s2 / m


def col_moments(xs_t, mode):
    a, b = _terms_sums(xs_t.to(_elem_dtype(mode)).clone())
    m = xs_t.shape[1]
    return a / m - LOG2, b / m


def step_scores(xw, mode):
    """DirectLiNGAM's k-list scores (float64) of the columns of the working
    data ``xw`` (m, w), and the column means and variances."""
    m = xw.shape[0]
    mu = xw.sum(0, dtype=torch.float64) / m
    xc = xw.double() - mu
    var = torch.clamp((xc * xc).sum(0) / m, min=1e-300)
    xs = xc * torch.rsqrt(var)
    xs_t = xs.T.to(_work_dtype(mode)).contiguous()
    del xc, xs
    c = _product(xs_t, xs_t.T, mode) / m
    m1, m2 = pair_moments(xs_t, c, mode)
    cm1, cm2 = col_moments(xs_t, mode)
    h_col = entropy(cm1, cm2)
    h_res = entropy(m1, m2)
    diff = (h_col[None, :] + h_res) - (h_col[:, None] + h_res.T)
    diff.fill_diagonal_(0.0)
    return -(torch.clamp(diff, max=0.0) ** 2).sum(1), mu, var


def walk(x, mode="reference", order=None):
    """The DirectLiNGAM ordering of ``x`` (m, d).

    With ``order`` given, replay it: at every step regress the remaining
    variables on the given one and record the gap between that step's
    best score and the given variable's. Without, pick the best variable
    at every step. Returns (order as an int64 array, gaps as a float64
    array; zeros when the walk picks)."""
    d = x.shape[1]
    with torch.no_grad(), precision(mode):
        xw = x.to(_work_dtype(mode))
        active = list(range(d))
        picked, gaps = [], []
        for k in range(d):
            scores, mu, var = step_scores(xw, mode)
            best = int(torch.argmax(scores))
            if order is None:
                pos = best
            else:
                pos = active.index(int(order[k]))
            gaps.append(float(scores[best] - scores[pos]))
            picked.append(active[pos])
            # Regress every other active variable on the chosen one.
            keep = [p for p in range(len(active)) if p != pos]
            xr = xw[:, pos:pos + 1]
            rest = xw[:, keep]
            m = xw.shape[0]
            cov = (_product((rest.double() - mu[keep]).T,
                            xr.double() - mu[pos], mode) / m).squeeze(1)
            coef = (cov / var[pos]).to(xw.dtype)
            xw = (rest - xr * coef).contiguous()
            active = [active[p] for p in keep]
    return np.asarray(picked, dtype=np.int64), np.asarray(gaps)


def covariance(x, mode="reference"):
    """ddof=0 covariance of ``x`` (m, d), float64."""
    with torch.no_grad(), precision(mode):
        m = x.shape[0]
        xc = x.to(_work_dtype(mode))
        xc = xc - xc.sum(0, dtype=torch.float64).to(xc.dtype) / m
        return _product(xc.T, xc, mode) / m


def ols_adjacency(cov, order, mode="reference"):
    """B[i, j], the coefficient of x_j in the least-squares regression of
    x_i on the variables before it in ``order``, from the covariance.

    The reference factors the covariance in causal order as G G^T
    (Cholesky, float64): I - B = diag(G) G^-1 in that order. A control
    solves each variable's normal equations (float32, LU), which needs no
    positive definite covariance from its lower-precision products."""
    order = torch.as_tensor(np.asarray(order), device=cov.device)
    d = cov.shape[0]
    if mode != "reference":
        pos = torch.empty_like(order)
        pos[order] = torch.arange(d, device=cov.device)
        mask = pos[None, :] < pos[:, None]      # j comes before i
        c = cov.float()
        a = torch.where(mask[:, :, None] & mask[:, None, :], c[None], 0.0)
        a = a + torch.diag_embed(torch.where(mask, 0.0, 1.0))
        rhs = torch.where(mask, c, 0.0)
        return torch.linalg.solve(a, rhs[..., None])[..., 0].double()
    cp = cov[order][:, order].double()
    g = torch.linalg.cholesky(cp)
    eye = torch.eye(d, dtype=cp.dtype, device=cov.device)
    ginv = torch.linalg.solve_triangular(g, eye, upper=False)
    bp = eye - torch.diagonal(g)[:, None] * ginv
    b = torch.empty_like(bp)
    b[order[:, None], order[None, :]] = bp
    return b


def resid_var(cov, b) -> np.ndarray:
    """Residual variances diag((I - B) cov (I - B)^T), float64, on the
    host."""
    r = torch.eye(cov.shape[0], dtype=torch.float64,
                  device=cov.device) - b.double()
    return torch.einsum("ij,jk,ik->i", r, cov.double(), r).cpu().numpy()


def resid_var_from_data(x, b, mode):
    """The residual variances as a fit computes them in ``mode``: the
    mean of (x_c - x_c B^T)^2 over the centered samples, the product in
    the mode's precision."""
    with torch.no_grad(), precision(mode):
        m = x.shape[0]
        xc = x.to(_work_dtype(mode))
        xc = xc - xc.sum(0, dtype=torch.float64).to(xc.dtype) / m
        r = xc.double() - _product(xc, b.T.to(xc.dtype), mode)
        return ((r * r).sum(0) / m).cpu().numpy()


def var_lstsq(x, lags: int = 1, mode: str = "reference"):
    """VAR(k) by least squares with an intercept on host data ``x`` (m, d):
    returns (coefficient matrices [k, d, d], intercept (d,), residuals
    (m - k, d)), float64. The reference solves by QR in float64; the
    controls solve the normal equations from products in their
    precision."""
    x = np.asarray(x, dtype=np.float64)
    m, d = x.shape
    y = x[lags:]
    z = np.concatenate([np.ones((m - lags, 1))]
                       + [x[lags - t - 1:m - t - 1] for t in range(lags)],
                       axis=1)
    if mode == "reference":
        coef = np.linalg.lstsq(z, y, rcond=None)[0]
    else:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        with precision(mode):
            zt = torch.as_tensor(z, dtype=torch.float32, device=dev)
            yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
            gram = _product(zt.T, zt, mode)
            rhs = _product(zt.T, yt, mode)
            coef = torch.linalg.solve(gram.float(), rhs.float()).double()
            coef = coef.cpu().numpy()
    mats = coef[1:].T.reshape(d, lags, d).transpose(1, 0, 2)
    return mats, coef[0], y - z @ coef


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300))
