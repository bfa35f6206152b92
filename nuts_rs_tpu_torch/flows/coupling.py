"""Built-in normalizing flows for transform adaptation.

Port of ``nuts_rs_tpu/flows/coupling.py``:

* :func:`diag_affine_flow`: the trainable diagonal affine map
  q = sigma z + mu with closed-form refits from draw and gradient variances.
* :func:`coupling_flow`: RealNVP-style affine coupling layers over a
  diagonal base layer, trained by minimizing the Fisher divergence of the
  pushforward to N(0, I), loss = E_x |z(x) + grad_z log pi_z(z(x))|^2, from
  the stored warmup draws and gradients (no extra logp evaluations), by Adam
  (``torch.optim.Adam`` where the JAX package uses optax).

Both return a :class:`~nuts_rs_tpu_torch.transform.ops.FlowSpec`.  A flow's
parameters are a dict of tensors: with a leading chain axis in a
:class:`~nuts_rs_tpu_torch.transform.ops.FlowTransform`, without one as
``update`` and ``kernel_pack`` take them.  ``forward`` and ``inverse`` take
either.

Convention: ``forward(params, z) -> (q, logdet)`` and
``inverse(params, q) -> (z, logdet)`` both return log|det dF/dz| (the forward
Jacobian's log-determinant), so that E = KE - (logp + logdet) equals
-log pi_z(z) + KE up to a constant.

Randomness comes from the counter hash (``kernels/rng.py``) under the
caller's seed: the first layer weights of ``init`` and the training subset of
``update``.  The JAX package draws both from threefry, which no port can
replay; ``convert.py`` carries JAX parameters across for the tests.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.rng import host_normals, host_uniform
from ..ops import ieee_matmul
from ..ops import tanh as kernel_tanh
from ..transform.ops import FlowSpec, flow_vjp


# ---------------------------------------------------------------------------
# Diagonal affine flow
# ---------------------------------------------------------------------------

def _row_sum(x, like):
    """sum over the last axis of ``x``, one value per row of ``like``."""
    return torch.sum(x, -1).expand(like.shape[:-1])


def diag_affine_flow() -> FlowSpec:
    """q = exp(log_sigma) z + mu with closed-form refits."""

    def forward(params, z):
        log_sigma, mu = params["log_sigma"], params["mu"]
        return torch.exp(log_sigma) * z + mu, _row_sum(log_sigma, z)

    def inverse(params, q):
        log_sigma, mu = params["log_sigma"], params["mu"]
        return (q - mu) * torch.exp(-log_sigma), _row_sum(log_sigma, q)

    def init(seed, dim, q0, g0):
        var = 1.0 / torch.clamp(torch.abs(g0), 1e-20, 1e20)
        return {"log_sigma": 0.5 * torch.log(var), "mu": q0 + var * g0}

    def update(seed, params, draws, grads, logps, mask):
        m = mask.to(draws.dtype)[:, None]
        n = torch.clamp(torch.sum(m), min=1.0)
        dm = torch.sum(draws * m, 0) / n
        gm = torch.sum(grads * m, 0) / n
        dv = torch.sum(torch.square(draws - dm) * m, 0) / n
        gv = torch.sum(torch.square(grads - gm) * m, 0) / n
        var = torch.sqrt(dv / gv)
        ok = torch.isfinite(var) & (var > 0)
        var = torch.where(ok, var, torch.exp(2.0 * params["log_sigma"]))
        enough = torch.sum(m) >= 3
        return {"log_sigma": torch.where(enough, 0.5 * torch.log(var),
                                         params["log_sigma"]),
                "mu": torch.where(enough, dm + var * gm, params["mu"])}

    return FlowSpec(forward=forward, inverse=inverse, init=init,
                    update=update)


# ---------------------------------------------------------------------------
# RealNVP-style coupling flow
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CouplingFlowConfig:
    """The JAX package's ``CouplingFlowConfig`` (``coupling.py:78-96``),
    with its defaults and meanings: ``max_train_points`` caps a refit's
    training set by a uniform subset of the valid points, the plateau stop
    halts training once the best loss has not improved by a relative
    ``early_stop_tol`` within ``early_stop_patience`` steps (patience <= 0:
    always ``train_steps``), and the two tanh clamps bound every layer."""

    num_layers: int = 4
    hidden: int = 32
    train_steps: int = 200
    learning_rate: float = 1e-3
    max_scale: float = 4.0   # tanh clamp on log-scales
    max_shift: float = 30.0  # tanh clamp on shifts
    max_train_points: int = 4096
    early_stop_patience: int = 40
    early_stop_tol: float = 1e-3


class PackedFlow(NamedTuple):
    """One set of coupling-flow parameters in the layout of kernel K1-flow
    (``pallas_pack``, ``coupling.py:146-156``): per layer ``mask [d, 1]``,
    ``w1T [H, d]``, ``b1 [H, 1]``, ``w2sT [d, H]``, ``b2s [d, 1]``,
    ``w2tT [d, H]``, ``b2t [d, 1]`` (the second layer split by head), then
    ``log_sigma [d, 1]`` and ``mu [d, 1]``; and the two clamps."""

    arrays: list
    max_scale: float
    max_shift: float

    @property
    def num_layers(self) -> int:
        return (len(self.arrays) - 2) // 7

    @property
    def hidden(self) -> int:
        return int(self.arrays[1].shape[0]) if self.num_layers else 0


def _mv(x, w):
    """x [n, a] times w [a, b] shared or [n, a, b] per row -> [n, b]."""
    if w.dim() == 2:
        return x @ w
    return torch.bmm(x[:, None, :], w)[:, 0]


def _clamp(x, bound):
    return bound * torch.tanh(x / bound)


def _layer_forward(layer, cfg, z):
    """One affine coupling step; even/odd masks alternate per layer.  The
    mask is structure, not a parameter (``coupling.py:108-115``): no
    gradient reaches it."""
    mask = layer["mask"].detach()
    net = layer["net"]
    z_pass = z * mask
    raw = _mv(torch.tanh(_mv(z_pass, net["w1"]) + net["b1"]),
              net["w2"]) + net["b2"]
    d = z.shape[-1]
    s = _clamp(raw[..., :d], cfg.max_scale) * (1.0 - mask)
    t = _clamp(raw[..., d:], cfg.max_shift) * (1.0 - mask)
    return z_pass + (1.0 - mask) * (z * torch.exp(s) + t), torch.sum(s, -1)


def _layer_inverse(layer, cfg, q):
    mask = layer["mask"].detach()
    net = layer["net"]
    q_pass = q * mask
    raw = _mv(torch.tanh(_mv(q_pass, net["w1"]) + net["b1"]),
              net["w2"]) + net["b2"]
    d = q.shape[-1]
    s = _clamp(raw[..., :d], cfg.max_scale) * (1.0 - mask)
    t = _clamp(raw[..., d:], cfg.max_shift) * (1.0 - mask)
    return q_pass + (1.0 - mask) * ((q - t) * torch.exp(-s)), torch.sum(s, -1)


def tree_leaves(params):
    """The tensors of a parameter dict, masks included, in a fixed order."""
    out = []
    for layer in params.get("layers", ()):
        out.append(layer["mask"])
        out += [layer["net"][k] for k in ("w1", "b1", "w2", "b2")]
    return out + [params["log_sigma"], params["mu"]]


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf to parameter dicts of one structure."""
    first = trees[0]
    out = {}
    if "layers" in first:
        out["layers"] = [
            {"mask": fn(*(t["layers"][i]["mask"] for t in trees)),
             "net": {k: fn(*(t["layers"][i]["net"][k] for t in trees))
                     for k in ("w1", "b1", "w2", "b2")}}
            for i in range(len(first["layers"]))]
    for k in ("log_sigma", "mu"):
        out[k] = fn(*(t[k] for t in trees))
    return out


def _trainable(params):
    """The leaves Adam trains: every one but the masks."""
    out = []
    for layer in params["layers"]:
        out += [layer["net"][k] for k in ("w1", "b1", "w2", "b2")]
    return out + [params["log_sigma"], params["mu"]]


def train_subset(seed, mask, max_points):
    """Indices of a refit's training set out of a window whose valid rows
    ``mask`` marks: a uniform random subset of ``max_points`` of them, by
    the top scores of hash uniforms under ``seed``, where an invalid row
    scores -1 (``coupling.py:205-213``); with fewer valid rows than
    ``max_points`` all of them and some invalid ones, still masked."""
    u = host_uniform(seed, 0, 1, mask.shape, mask.device)
    score = torch.where(mask, u, torch.full_like(u, -1.0))
    return torch.topk(score, max_points).indices


def fisher_loss(spec: FlowSpec, params, draws, grads, mask,
                create_graph=False):
    """Mean |z + grad_z log pi_z(z)|^2 over the masked window
    (``coupling.py:180-196``); with ``create_graph`` differentiable in
    ``params`` (a double backward: the score is itself a vector-Jacobian
    product)."""
    with torch.enable_grad(), ieee_matmul():
        z, _ = spec.inverse(params, draws)
        # score of the pushforward: (dq/dz)^T g + grad_z log|det dF/dz|
        _, _, zg = flow_vjp(spec, params, z, grads, create_graph)
        losses = torch.sum(torch.square(z + zg), -1)
        m = mask.to(draws.dtype)
        return torch.sum(losses * m) / torch.clamp(torch.sum(m), min=1.0)


def coupling_flow(cfg: CouplingFlowConfig = CouplingFlowConfig()) -> FlowSpec:
    """Diagonal base layer + ``cfg.num_layers`` affine coupling layers."""

    def forward(params, z):
        logdet = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for layer in params["layers"]:
            z, ld = _layer_forward(layer, cfg, z)
            logdet = logdet + ld
        q = torch.exp(params["log_sigma"]) * z + params["mu"]
        return q, logdet + torch.sum(params["log_sigma"], -1)

    def inverse(params, q):
        z = (q - params["mu"]) * torch.exp(-params["log_sigma"])
        logdet = _row_sum(params["log_sigma"], q)
        for layer in reversed(params["layers"]):
            z, ld = _layer_inverse(layer, cfg, z)
            logdet = logdet + ld
        return z, logdet

    def init(seed, dim, q0, g0):
        """Per-chain parameters from [C, d] positions and gradients: an
        identity-initialised coupling stack (zero output layers; first layer
        weights N(0, 1 / dim) from the counter hash under ``seed``, layer i at
        tree iteration i) over the diagonal base sigma^2 = 1 / |g0|."""
        C = q0.shape[0]
        dtype, dev = q0.dtype, q0.device
        layers = []
        for i in range(cfg.num_layers):
            mask = (torch.arange(dim, device=dev) % 2 == i % 2).to(dtype)
            w1 = host_normals(seed, i, 1, 2, (C, dim, cfg.hidden), dev).to(
                dtype) / torch.sqrt(torch.tensor(float(dim), dtype=dtype))
            layers.append({
                "mask": mask.expand(C, dim).clone(),
                "net": {
                    "w1": w1,
                    "b1": torch.zeros(C, cfg.hidden, dtype=dtype, device=dev),
                    "w2": torch.zeros(C, cfg.hidden, 2 * dim, dtype=dtype,
                                      device=dev),
                    "b2": torch.zeros(C, 2 * dim, dtype=dtype, device=dev),
                }})
        var = 1.0 / torch.clamp(torch.abs(g0), 1e-20, 1e20)
        return {"layers": layers, "log_sigma": 0.5 * torch.log(var),
                "mu": q0 + var * g0}

    def update(seed, params, draws, grads, logps, mask):
        """Refit one set of parameters (``coupling.py:198-265``): a uniform
        subset of the valid points above ``max_train_points`` (hash uniforms
        under ``seed``; invalid slots score -1, so the top ones are valid
        ones), Adam with the plateau stop, and monotone acceptance: the refit
        is kept only if it is finite, the window held at least 10 points and
        the Fisher loss fell."""
        if draws.shape[0] > cfg.max_train_points:
            idx = train_subset(seed, mask, cfg.max_train_points)
            draws, grads, mask = draws[idx], grads[idx], mask[idx]

        new = tree_map(lambda x: x.detach().clone(), params)
        leaves = _trainable(new)
        for x in leaves:
            x.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=cfg.learning_rate)

        def step():
            opt.zero_grad()
            loss = fisher_loss(spec, new, draws, grads, mask,
                               create_graph=True)
            loss.backward()
            opt.step()
            return loss.detach()

        if cfg.early_stop_patience > 0:
            best = torch.tensor(float("inf"), dtype=draws.dtype,
                                device=draws.device)
            i, best_i = 0, 0
            while (i < cfg.train_steps
                   and i - best_i < cfg.early_stop_patience):
                loss = step()
                if bool(loss < best * (1.0 - cfg.early_stop_tol)):
                    best_i = i
                best = torch.minimum(loss, best)
                i += 1
        else:
            for _ in range(cfg.train_steps):
                step()
        new = tree_map(lambda x: x.detach(), new)

        old_loss = fisher_loss(spec, params, draws, grads, mask).detach()
        new_loss = fisher_loss(spec, new, draws, grads, mask).detach()
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(new))
        enough = bool(torch.sum(mask) >= 10)
        improved = bool(torch.isfinite(new_loss) & (new_loss < old_loss))
        return new if (finite and enough and improved) else params

    def kernel_pack(params):
        """One set of parameters (no chain axis) in K1-flow's layout."""
        arrs = []
        for layer in params["layers"]:
            m, w = layer["mask"], layer["net"]
            d = m.shape[0]
            arrs += [m[:, None], w["w1"].T, w["b1"][:, None],
                     w["w2"][:, :d].T, w["b2"][:d][:, None],
                     w["w2"][:, d:].T, w["b2"][d:][:, None]]
        arrs += [params["log_sigma"][:, None], params["mu"][:, None]]
        return PackedFlow([a.contiguous() for a in arrs],
                          cfg.max_scale, cfg.max_shift)

    spec = FlowSpec(forward=forward, inverse=inverse, init=init,
                    update=update, kernel_pack=kernel_pack)
    return spec


# ---------------------------------------------------------------------------
# The packed flow as kernel K1-flow evaluates it
# ---------------------------------------------------------------------------

def _dot_cols(w, x):
    """out[c, r] = sum_j w[r, j] x[c, j] over j ascending, the first term
    starting the sum: the order of a kernel thread that owns row r."""
    out = w[None, :, 0] * x[:, 0:1]
    for j in range(1, w.shape[1]):
        out = out + w[None, :, j] * x[:, j:j + 1]
    return out


def _dot_rows(w, x):
    """out[c, r] = sum_j w[j, r] x[c, j] over j ascending (a column of
    ``w``: the backward pass through a transposed weight)."""
    out = w[None, 0, :] * x[:, 0:1]
    for j in range(1, w.shape[0]):
        out = out + w[None, j, :] * x[:, j:j + 1]
    return out


def _layer_arrays(arrs, layer):
    """(mask, w1T, b1, w2sT, b2s, w2tT, b2t) of a packed layer, the column
    arrays as vectors."""
    m, w1T, b1, w2sT, b2s, w2tT, b2t = arrs[7 * layer:7 * layer + 7]
    return (m[:, 0], w1T, b1[:, 0], w2sT, b2s[:, 0], w2tT, b2t[:, 0])


def _div(x, c):
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the kernel
    return x / torch.full_like(x, c)


def packed_forward(packed: PackedFlow, z):
    """The forward pass of K1-flow (csrc/coupling_flow.cuh) on z [C, d]:
    returns (q [C, d], sacc [C, d], acts), where ``sacc`` is each
    coordinate's s summed over the layers in order and then its log sigma
    (logdet is ``tsum(sacc)``, the kernel's sum over coordinates) and
    ``acts`` the per-layer activations the backward pass reads.

    Per layer, as the kernel's threads order it: h_k = tanh(sum_i w1T[k, i]
    (z m)_i + b1_k) with the sum over i ascending; rs_i = sum_k w2sT[i, k]
    h_k + b2s_i and rt_i likewise over k ascending; s = (S tanh(rs / S))
    (1 - m), t = (T tanh(rt / T)) (1 - m); z' = z m + (1 - m) (z e^s + t).
    tanh is ``ops.tanh``; nothing goes through ``torch.matmul`` or
    ``torch.sum``."""
    arrs = packed.arrays
    S, T = packed.max_scale, packed.max_shift
    acts = []
    sacc = None
    for layer in range(packed.num_layers):
        m, w1T, b1, w2sT, b2s, w2tT, b2t = _layer_arrays(arrs, layer)
        omm = 1.0 - m
        zp = z * m
        h = kernel_tanh(_dot_cols(w1T, zp) + b1)
        a_s = kernel_tanh(_div(_dot_cols(w2sT, h) + b2s, S))
        a_t = kernel_tanh(_div(_dot_cols(w2tT, h) + b2t, T))
        s = (S * a_s) * omm
        t = (T * a_t) * omm
        es = torch.exp(s)
        acts.append((z, h, es, a_s, a_t))
        z = zp + omm * (z * es + t)
        sacc = s if sacc is None else sacc + s
    ls, mu = arrs[-2][:, 0], arrs[-1][:, 0]
    q = torch.exp(ls) * z + mu
    sacc = ls.expand_as(z) if sacc is None else sacc + ls
    return q, sacc, acts


def packed_backward(packed: PackedFlow, acts, g):
    """K1-flow's backward pass: zg = (dq/dz)^T g + d logdet / dz from the
    model's gradient g [C, d] at q and the forward's activations, layer by
    layer in reverse from gbar = e^{log sigma} g:
    gs = ((gbar z e^s) + 1) (1 - m) (1 - tanh_s^2),
    gt = (gbar (1 - m)) (1 - tanh_t^2),
    gh_k = sum_i w2sT[i, k] gs_i + sum_i w2tT[i, k] gt_i (each over i
    ascending), gpre = gh (1 - h^2),
    gbar <- gbar (m + (1 - m) e^s) + m sum_k w1T[k, i] gpre_k (k ascending).
    """
    arrs = packed.arrays
    gb = torch.exp(arrs[-2][:, 0]) * g
    for layer in reversed(range(packed.num_layers)):
        m, w1T, _, w2sT, _, w2tT, _ = _layer_arrays(arrs, layer)
        z, h, es, a_s, a_t = acts[layer]
        omm = 1.0 - m
        gs = ((gb * z * es) + 1.0) * omm * (1.0 - a_s * a_s)
        gt = (gb * omm) * (1.0 - a_t * a_t)
        gpre = (_dot_rows(w2sT, gs) + _dot_rows(w2tT, gt)) * (1.0 - h * h)
        gb = gb * (m + omm * es) + m * _dot_rows(w1T, gpre)
    return gb


def kernel_forward(packed: PackedFlow, z, csum=None):
    """The plain batched forward in K1-flow's layout and order (the
    counterpart of ``pallas_forward``): (q [C, d], logdet [C]).  ``csum``
    sums over the coordinates (default ``ops.tsum``, the kernel's)."""
    from ..ops import tsum

    q, sacc, _ = packed_forward(packed, z)
    return q, (csum or tsum)(sacc)
