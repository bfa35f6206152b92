"""Low-rank mass-matrix estimation from a window of draws and gradients.

Port of ``nuts_rs_tpu/adapt/low_rank.py`` (whole), batched over chains
(nuts-rs ``src/transform/adapt/low_rank.rs``): a fixed-capacity window of
draws and gradients per chain with absolute write positions, and the
refit (per-coordinate rescale -> the Gram matrices' eigenvectors -> QR of
the joint subspace -> regularized covariances -> SPD geometric mean ->
eigendecomposition -> eigenvalue cutoff) as batched ``torch.linalg`` calls
in the state's dtype, with IEEE products (``ops.ieee_matmul``, the
counterpart of JAX's ``"highest"`` precision), at the schedule's update
draws.

Masked slots are absent slots: they add nothing to the Gram matrices,
which the reference never normalizes by the count (``low_rank.rs:205-235``).
Data-free subspace directions get eigenvalue exactly 1 after the
``gamma`` regularization and drop out at the cutoff (``lam > cutoff`` or
``lam < 1/cutoff``, ``low_rank.rs:93-99``); the fixed-rank transform pads
the unselected directions with lam = 1, which makes them no-ops.

Two departures from the JAX code, both on inputs it cannot take:
``push`` writes with a select, so an excluded non-finite draw leaves the
slot as it was (the JAX ``sel * draw + (1 - sel) * old`` writes NaN there);
and an eigendecomposition is never asked of a matrix with a non-finite
entry (``torch.linalg.eigh`` may raise where JAX returns NaN): such a
chain's refit is NaN, which leaves its transform unchanged, as in JAX.
Eigenvector signs and the order of equal eigenvalues are the linear
algebra library's; the transform they give is not.  A float32 window's
eigendecompositions run on the host's LAPACK also where the state lies on
the card (``_eigh``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops import ieee_matmul
from ..transform.affine import (
    AffineTransform,
    identity_transform,
    init_diag_from_grad,
    set_low_rank,
)
from ..transform.ops import AFFINE_OPS


@dataclasses.dataclass(frozen=True)
class LowRankSettings:
    """nuts-rs ``LowRankSettings`` (src/transform/low_rank.rs:193-208) with
    the JAX package's static rank cap and window capacity."""

    gamma: float = 1e-5
    eigval_cutoff: float = 2.0
    store_mass_matrix: bool = False
    max_rank: Optional[int] = None         # static transform rank; default d
    window_capacity: Optional[int] = None  # default num_tune


class LowRankWindow(NamedTuple):
    """Every chain's draw / gradient window."""

    draws: torch.Tensor      # [C, cap, d]
    grads: torch.Tensor      # [C, cap, d]
    write_pos: torch.Tensor  # [C] int32 accepted samples (absolute)
    start: torch.Tensor      # [C] int32 first sample of the foreground
    bg_start: torch.Tensor   # [C] int32 first sample of the background


def new_window(num_chains: int, cap: int, dim: int, dtype,
               device) -> LowRankWindow:
    def zeros():
        return torch.zeros(num_chains, dtype=torch.int32, device=device)

    return LowRankWindow(
        draws=torch.zeros(num_chains, cap, dim, dtype=dtype, device=device),
        grads=torch.zeros(num_chains, cap, dim, dtype=dtype, device=device),
        write_pos=zeros(), start=zeros(), bg_start=zeros())


def push(w: LowRankWindow, draw, grad, include) -> LowRankWindow:
    """Append each chain's (draw, grad) where ``include`` (bool or [C]) and
    capacity remains."""
    C, cap = w.draws.shape[:2]
    if cap == 0:
        return w
    include = torch.as_tensor(include, device=draw.device).expand(C)
    ok = include & (w.write_pos < cap)
    slot = torch.clamp(w.write_pos, max=cap - 1).long()
    rows = torch.arange(C, device=draw.device)

    def put(buf, x):
        new = torch.where(ok[:, None], x.to(buf.dtype), buf[rows, slot])
        return buf.index_put((rows, slot), new)

    return w._replace(draws=put(w.draws, draw), grads=put(w.grads, grad),
                      write_pos=w.write_pos + ok.to(torch.int32))


def switch(w: LowRankWindow) -> LowRankWindow:
    """Foreground <- everything since the last switch (low_rank.rs:315-322)."""
    return w._replace(start=w.bg_start, bg_start=w.write_pos)


def foreground_count(w: LowRankWindow):
    return w.write_pos - w.start


def background_count(w: LowRankWindow):
    return w.write_pos - w.bg_start


def _finite(x, dims):
    return torch.isfinite(x).all(dims) if dims else torch.isfinite(x)


def _eigh(a):
    """Batched ``eigh`` of [C, n, n]; a chain whose matrix holds a
    non-finite entry gets NaN values and vectors (JAX's result) without
    the library seeing its matrix.

    A float32 matrix on the card is decomposed by the host's LAPACK, as
    the JAX package's is on the CPU.  At float32 the refit's matrices are
    so ill-conditioned that the sign of their smallest eigenvalues is
    rounding, and a negative one is what rejects a refit whose window
    cannot support it; the card's float32 solver (cuSOLVER, as PyTorch
    picks it) leaves those eigenvalues positive far more often, so that
    most chains take a refit hundreds of per cent off the float64 one at
    the first window as large as d, where LAPACK rejects nearly all
    (PERF.md section 7)."""
    ok = _finite(a, (-2, -1))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a = torch.where(ok[:, None, None], a, eye)
    if a.is_cuda and a.dtype == torch.float32:
        vals, vecs = (x.to(a.device) for x in torch.linalg.eigh(a.cpu()))
    else:
        vals, vecs = torch.linalg.eigh(a)
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=a.device)
    return (torch.where(ok[:, None], vals, nan),
            torch.where(ok[:, None, None], vecs, nan))


def _spd_mean(cov_draws, cov_grads):
    """The SPD geometric mean C with C cov_grads C = cov_draws (nuts-rs
    ``spd_mean``, low_rank.rs:237-262), by two symmetric
    eigendecompositions.  No clamping: a negative eigenvalue gives NaN,
    which skips the update, as faer's sqrt does in the reference."""
    eg_vals, eg_vecs = _eigh(cov_grads)
    vt = eg_vecs.transpose(-1, -2)
    sqrt_g = (eg_vecs * torch.sqrt(eg_vals)[:, None, :]) @ vt
    inv_sqrt_g = (eg_vecs * (1.0 / torch.sqrt(eg_vals))[:, None, :]) @ vt
    m = sqrt_g @ cov_draws @ sqrt_g
    m_vals, m_vecs = _eigh(m)
    m_sqrt = (m_vecs * torch.sqrt(m_vals)[:, None, :]) @ m_vecs.transpose(
        -1, -2)
    return inv_sqrt_g @ m_sqrt @ inv_sqrt_g


def _window_moments(w: LowRankWindow) -> dict:
    """Masked first and second moments, the rescaled and centered window
    and its Gram matrices, every chain (steps 1-2a of ``compute_update``,
    low_rank.rs:144-203)."""
    C, cap, d = w.draws.shape
    dtype = w.draws.dtype
    idx = torch.arange(cap, dtype=torch.int32, device=w.draws.device)
    mask = (idx[None, :] >= w.start[:, None]) & (
        idx[None, :] < w.write_pos[:, None])
    mf = mask.to(dtype)[..., None]                       # [C, cap, 1]
    n = mf.sum((1, 2))                                   # [C]
    ns = torch.clamp(n, min=1.0)[:, None]

    draws = w.draws * mf
    grads = w.grads * mf
    # step 1: the per-coordinate rescale
    draw_mean = draws.sum(1) / ns
    grad_mean = grads.sum(1) / ns
    draw_var = (torch.square(draws - draw_mean[:, None]) * mf).sum(1) / ns
    grad_var = (torch.square(grads - grad_mean[:, None]) * mf).sum(1) / ns
    sigma = torch.sqrt(torch.sqrt(draw_var / grad_var))
    mu = draw_mean + sigma * sigma * grad_mean

    x = (w.draws - mu[:, None]) / sigma[:, None] * mf  # rescaled draws
    g = w.grads * sigma[:, None] * mf                   # rescaled grads
    x_mean = x.sum(1) / ns
    g_mean = g.sum(1) / ns
    x = (x - x_mean[:, None]) * mf
    g = (g - g_mean[:, None]) * mf
    # the Gram matrices over the sample axis carry the samples' column
    # space and covariance (x^T x = U S^2 U^T)
    gram_x = x.transpose(1, 2) @ x
    gram_g = g.transpose(1, 2) @ g
    return dict(n=n, sigma=sigma, mu=mu, x_mean=x_mean, g_mean=g_mean,
                gram_x=gram_x, gram_g=gram_g)


def _refit_from_moments(m: dict, transform: AffineTransform, gamma: float,
                        eigval_cutoff: float) -> AffineTransform:
    """Steps 2b-5 of ``compute_update`` from moments with a leading chain
    axis (each chain's own, or the pooled ones on an axis of one)."""
    sigma, mu = m["sigma"], m["mu"]
    x_mean, g_mean = m["x_mean"], m["g_mean"]
    gram_x, gram_g = m["gram_x"], m["gram_g"]
    C, d = sigma.shape
    dtype, device = sigma.dtype, sigma.device

    # step 2: the joint subspace (low_rank.rs:80-87): eigh of the Grams
    # gives the samples' left singular vectors, QR of both the joint span
    _, u_draws = _eigh(gram_x)
    _, u_grads = _eigh(gram_g)
    subspace = torch.cat([u_draws, u_grads], -1)               # [C, d, 2d]
    ok = _finite(subspace, (-2, -1))
    basis, _ = torch.linalg.qr(torch.where(
        ok[:, None, None], subspace, torch.zeros_like(subspace)))
    basis = torch.where(ok[:, None, None], basis,
                        torch.full_like(basis, float("nan")))  # [C, d, d]
    r0 = basis.shape[-1]

    # step 3: the regularized covariances and their SPD mean
    # (low_rank.rs:205-262)
    bt = basis.transpose(-1, -2)
    eye = torch.eye(r0, dtype=dtype, device=device)
    cov_draws = bt @ gram_x @ basis / gamma + eye
    cov_grads = bt @ gram_g @ basis / gamma + eye
    vals, vecs = _eigh(_spd_mean(cov_draws, cov_grads))

    # step 4: the eigenvalue cutoff, lam = 1 for the rest
    selected = (vals > eigval_cutoff) | (vals < 1.0 / eigval_cutoff)
    vals_f = torch.where(selected, vals, torch.ones_like(vals))
    vecs_full = basis @ vecs                                   # [C, d, r0]

    # step 5: the inner translation mu_lr (low_rank.rs:112-123)
    proj = (vecs_full.transpose(-1, -2) @ g_mean[..., None])[..., 0]
    b = (vecs_full @ ((vals_f - 1.0) * proj)[..., None])[..., 0]
    mu_lr = x_mean + g_mean + b

    # pad or cut to the transform's static rank
    r_static = transform.vecs.shape[-1]
    if r0 < r_static:
        pad = r_static - r0
        vecs_full = torch.cat([vecs_full, torch.zeros(
            C, d, pad, dtype=dtype, device=device)], -1)
        vals_f = torch.cat([vals_f, torch.ones(C, pad, dtype=dtype,
                                               device=device)], -1)
    elif r0 > r_static:
        # keep the most informative directions (largest |log lam|)
        order = torch.argsort(-torch.abs(torch.log(vals_f)), -1)[:, :r_static]
        vecs_full = torch.gather(vecs_full, 2,
                                 order[:, None, :].expand(C, d, r_static))
        vals_f = torch.gather(vals_f, 1, order)

    finite = (_finite(sigma, (-1,)) & _finite(mu, (-1,))
              & _finite(vals_f, (-1,)) & _finite(vecs_full, (-2, -1))
              & _finite(mu_lr, (-1,)))
    # degenerate windows (fewer samples than informative directions) can
    # give non-positive eigenvalue estimates: no update then
    positive = (vals_f > 0.0).all(-1) & (sigma > 0.0).all(-1)
    changed = finite & positive & (m["n"] >= 3)
    return set_low_rank(transform, sigma, mu, vals_f, vecs_full, mu_lr,
                        changed=changed)


def compute_update(w: LowRankWindow, transform: AffineTransform,
                   gamma: float, eigval_cutoff: float) -> AffineTransform:
    """One full low-rank refit from each chain's foreground window
    (``LowRankMassMatrixStrategy::compute_update``, low_rank.rs:73-124);
    an invalid result (non-finite, or fewer than 3 samples) leaves that
    chain's transform unchanged."""
    with ieee_matmul():
        return _refit_from_moments(_window_moments(w), transform, gamma,
                                   eigval_cutoff)


def pooled_compute_update(windows: LowRankWindow,
                          transforms: AffineTransform, gamma: float,
                          eigval_cutoff: float) -> AffineTransform:
    """The cross-chain pooled refit (the JAX package's, without a nuts-rs
    counterpart): every chain's window is one sample set, the moments and
    Gram matrices sum over the chain axis, one refit of chain 0's transform
    runs, and every chain gets the result.  The sums run over the local chains only; pooling
    over a mesh of cards is ROADMAP.md item 17b."""
    with ieee_matmul():
        C, cap, d = windows.draws.shape
        dtype = windows.draws.dtype
        idx = torch.arange(cap, dtype=torch.int32,
                           device=windows.draws.device)
        mask = ((idx[None, :] >= windows.start[:, None])
                & (idx[None, :] < windows.write_pos[:, None]))
        mf = mask.to(dtype)[..., None]                   # [C, cap, 1]
        n = mf.sum()
        ns = torch.clamp(n, min=1.0)

        def total(v):  # [C, cap, d] -> [d]
            return v.sum(1).sum(0)

        draw_mean = total(windows.draws * mf) / ns
        grad_mean = total(windows.grads * mf) / ns
        draw_var = total(torch.square(windows.draws - draw_mean) * mf) / ns
        grad_var = total(torch.square(windows.grads - grad_mean) * mf) / ns
        sigma = torch.sqrt(torch.sqrt(draw_var / grad_var))
        mu = draw_mean + sigma * sigma * grad_mean

        x = (windows.draws - mu) / sigma * mf
        g = windows.grads * sigma * mf
        x_mean = total(x) / ns
        g_mean = total(g) / ns
        x = ((x - x_mean) * mf).reshape(C * cap, d)
        g = ((g - g_mean) * mf).reshape(C * cap, d)

        pooled = dict(n=n[None], sigma=sigma[None], mu=mu[None],
                      x_mean=x_mean[None], g_mean=g_mean[None],
                      gram_x=(x.T @ x)[None], gram_g=(g.T @ g)[None])
        # one refit of chain 0's transform, which every chain then takes
        t0 = AffineTransform(*(None if v is None else v[:1]
                               for v in transforms))
        t_new = _refit_from_moments(pooled, t0, gamma, eigval_cutoff)
        return AffineTransform(*(
            None if v is None else v.expand((C,) + v.shape[1:]).contiguous()
            for v in t_new))


class LowRankStrategy:
    """Low-rank mass-matrix adaptation (nuts-rs
    ``LowRankMassMatrixStrategy``), with the protocol of
    ``chain.DiagStrategy``; its own per-chain state is the window, in
    ``ChainState.extra``.  With ``cross_chain_adaptation`` the refits pool
    every chain's window (:func:`pooled_compute_update`)."""

    ops = AFFINE_OPS

    def __init__(self, config, settings):
        self.config = config
        self.lr: LowRankSettings = getattr(settings, "low_rank",
                                           LowRankSettings())
        self.cross_chain = getattr(settings, "cross_chain_adaptation", False)

    def _rank(self, dim):
        return min(self.lr.max_rank or dim, dim)

    def make_transform(self, num_chains, dim, dtype, device):
        return identity_transform(num_chains, dim, dtype, device,
                                  rank=self._rank(dim))

    def init_extra(self, dim, num_tune, dtype, num_chains, device):
        cap = self.lr.window_capacity or num_tune
        return new_window(num_chains, cap, dim, dtype, device)

    def init_mass_matrix(self, state):
        """add_draw(init) and the diagonal init from the gradient
        (low_rank.rs:280-297)."""
        window = push(state.extra, state.pt.q, state.pt.g, True)
        transform = init_diag_from_grad(state.transform, state.pt.q,
                                        state.pt.g)
        return state._replace(extra=window, transform=transform)

    def update_estimators(self, state, draw_q, draw_g, is_good, logp=None,
                          energy_error=None):
        return state._replace(extra=push(state.extra, draw_q, draw_g,
                                         is_good))

    def switch(self, state):
        return state._replace(extra=switch(state.extra))

    def adapt_update(self, state):
        refit = pooled_compute_update if self.cross_chain else compute_update
        return state._replace(transform=refit(
            state.extra, state.transform, gamma=self.lr.gamma,
            eigval_cutoff=self.lr.eigval_cutoff))
