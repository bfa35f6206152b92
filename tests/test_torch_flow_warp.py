"""Kernel K1-flow's warp form, and the rule that chooses a form, on the CPU.

The warp form (csrc/coupling_flow.cuh::eval_warp) runs both passes of the
frozen coupling flow on one warp: lane j on coordinate j, lane k on hidden
unit k, every dot product a loop of compile-time length (32 over H; 16 or 32
over d, by d) whose terms past d or H are masked, over a layout of the
parameters that setup() makes once a launch (weight rows at a stride of
``_build.FLOW_ROW`` floats, vectors of ``_build.FLOW_VEC``).  No CUDA kernel
runs here: this file emulates the warp form lane by lane in float32 scalar
steps, reading every weight through the layout's own index, and holds it bit
for bit (``torch.equal``) against the plain version the kernel is tested
against on the card (``flows/coupling.py::packed_forward`` /
``packed_backward``), on parameters of the JAX package's coupling flow moved
off the identity and carried across by ``convert.flow_params_from_numpy``.
The exponentials are ``torch.exp`` on tensors of the plain version's shapes
(PyTorch's CPU exp may round a lane of a vector and a scalar tail apart), so
what is held is the layout, the masks and every sum's order.  With the
layout's padding and the vectors' unused lanes set to NaN, the results stay
the same: no masked term enters a sum.

Beside it: ``_build.flow_form`` on both sides of each of its boundaries,
``_build.flow_smem_bytes`` of each form against the layout it mirrors, and a
form that fits a block for every shape ``chain.flow_cl_fits`` accepts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.flows.coupling import CouplingFlowConfig as JaxCfg
from nuts_rs_tpu.flows.coupling import coupling_flow as jax_coupling_flow
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.convert import flow_params_from_numpy
from nuts_rs_tpu_torch.flows.coupling import (
    CouplingFlowConfig,
    coupling_flow,
    packed_backward,
    packed_forward,
)
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.models import gaussian as tg

F = np.float32
ONE = F(1.0)
VEC, ROW, MAXW = _build.FLOW_VEC, _build.FLOW_ROW, _build.FLOW_WARP_MAX
CHAINS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def perturbed_packed(d, layers, hidden, seed, scale=0.3):
    """The JAX coupling flow's init at a random start, its nets moved off
    the identity by N(0, scale^2), packed for K1-flow by the port."""
    spec = jax_coupling_flow(JaxCfg(num_layers=layers, hidden=hidden))
    q0 = jax.random.normal(jax.random.key(seed), (d,), jnp.float64)
    params = spec.init(jax.random.key(seed + 1), d, q0, -q0)
    key = jax.random.key(seed + 2)
    out = []
    for layer in params["layers"]:
        key, k = jax.random.split(key)
        net = jax.tree.map(
            lambda x: x + scale * jax.random.normal(k, x.shape, x.dtype),
            layer["net"])
        out.append({"mask": layer["mask"], "net": net})
    tspec = coupling_flow(CouplingFlowConfig(num_layers=layers,
                                             hidden=hidden))
    return tspec.kernel_pack(flow_params_from_numpy({**params,
                                                     "layers": out}))


def warp_layout(packed, pad=0.0):
    """The parameters in the warp form's layout, as setup() writes it
    (``pad`` in every float it writes no parameter to: 0 as setup() does,
    NaN to show that no masked term is read into a sum): per layer mask,
    b1, b2s, b2t [VEC] each, then the rows of w1T [H], w2sT [d] and w2tT [d]
    at a stride of ROW; after the layers log sigma and mu [VEC] each and
    MAXW rows of slack, which a lane's row or column past d or H reads."""
    arrs = [a.numpy().astype(F) for a in packed.arrays]
    L, H = packed.num_layers, packed.hidden
    d = arrs[-1].shape[0]
    lf = 4 * VEC + ROW * (H + 2 * d)
    out = np.full(L * lf + 2 * VEC + MAXW * ROW, pad, F)
    for l in range(L):
        m, w1T, b1, w2sT, b2s, w2tT, b2t = arrs[7 * l:7 * l + 7]
        base = l * lf
        for part, (v, n) in enumerate(((m, d), (b1, H), (b2s, d),
                                       (b2t, d))):
            out[base + part * VEC:base + part * VEC + n] = v[:, 0]
        rows = base + 4 * VEC
        for k in range(H):
            out[rows + k * ROW:rows + k * ROW + d] = w1T[k]
        for j in range(d):
            out[rows + (H + j) * ROW:rows + (H + j) * ROW + H] = w2sT[j]
            out[rows + (H + d + j) * ROW:
                rows + (H + d + j) * ROW + H] = w2tT[j]
    out[L * lf:L * lf + d] = arrs[-2][:, 0]
    out[L * lf + VEC:L * lf + VEC + d] = arrs[-1][:, 0]
    return out, lf


def dot_row(P, off, x, n, N):
    """A lane's sum over i < n of P[off + i] x[i], as flow_dot_row runs it:
    every one of the N terms loaded and multiplied, in chunks of 4, i
    ascending, the first term starting the sum, the terms past n masked."""
    acc = None
    for c in range(0, N, 4):
        u = P[off + c:off + c + 4]
        p = [u[t] * x[c + t] for t in range(4)]
        for t in range(4):
            if c + t == 0:
                acc = p[0]
            elif c + t < n:
                acc = acc + p[t]
    return acc


def dot_col(P, off, x, n, N):
    """A lane's sum over i < n of P[off + i ROW] x[i], as flow_dot_col runs
    it (a column of a block of rows, every one of the N rows loaded, the
    terms past n masked)."""
    acc = None
    for i in range(N):
        u = P[off + i * ROW]
        if i == 0:
            acc = u * x[0]
        elif i < n:
            acc = acc + u * x[i]
    return acc


def ftanh(x):
    """csrc/coupling_flow.cuh::ftanh on a [C, n] array: the exponential by
    torch.exp on the plain version's shape, the rest in float32 scalars."""
    e = torch.exp(-2.0 * torch.abs(torch.from_numpy(x))).numpy()
    out = np.empty_like(x)
    for idx in np.ndindex(x.shape):
        out[idx] = np.copysign((ONE - e[idx]) / (ONE + e[idx]), x[idx])
    return out


def vec(values, n, fill):
    """A warp's vector of VEC floats: lanes below n hold ``values``, the
    others ``fill``."""
    out = np.full(VEC, fill, F)
    out[:n] = values
    return out


def emulate_warp(packed, z, g, pad):
    """The warp form's forward pass of z [C, d] and backward pass of the
    model's gradient g [C, d], lane by lane: returns (q, sacc, zg)."""
    P, lf = warp_layout(packed, pad)
    L, H = packed.num_layers, packed.hidden
    S, T = F(packed.max_scale), F(packed.max_shift)
    C, d = z.shape
    DN = 16 if d <= 16 else MAXW
    ls = P[L * lf:L * lf + d]
    mu = P[L * lf + VEC:L * lf + VEC + d]
    exp_ls = torch.exp(torch.from_numpy(ls.copy())).numpy()
    zj = z.copy()
    sacc = np.zeros((C, d), F)
    acts = []
    for l in range(L):
        base = l * lf
        m = P[base:base + d]
        b1 = P[base + VEC:base + VEC + H]
        b2s = P[base + 2 * VEC:base + 2 * VEC + d]
        b2t = P[base + 3 * VEC:base + 3 * VEC + d]
        rows = base + 4 * VEC
        zp = zj * m
        x = np.empty((C, H), F)
        for c in range(C):
            zpv = vec(zp[c], d, pad)
            for k in range(H):
                x[c, k] = dot_row(P, rows + k * ROW, zpv, d, DN) + b1[k]
        h = ftanh(x)
        xs, xt = np.empty((C, d), F), np.empty((C, d), F)
        for c in range(C):
            hv = vec(h[c], H, pad)
            for j in range(d):
                rs = dot_row(P, rows + (H + j) * ROW, hv, H, MAXW)
                rt = dot_row(P, rows + (H + d + j) * ROW, hv, H, MAXW)
                xs[c, j] = (rs + b2s[j]) / S
                xt[c, j] = (rt + b2t[j]) / T
        a_s, a_t = ftanh(xs), ftanh(xt)
        omm = ONE - m
        s = (S * a_s) * omm
        t = (T * a_t) * omm
        e = torch.exp(torch.from_numpy(s)).numpy()
        acts.append((zj, e, a_s, a_t, h))
        zj = zp + omm * (zj * e + t)
        sacc = s if l == 0 else sacc + s
    q = exp_ls * zj + mu
    sacc = np.broadcast_to(ls, (C, d)).copy() if L == 0 else sacc + ls

    gb = exp_ls * g
    for l in reversed(range(L)):
        base = l * lf
        m = P[base:base + d]
        rows = base + 4 * VEC
        zl, e, a_s, a_t, h = acts[l]
        omm = ONE - m
        gs = ((gb * zl * e) + ONE) * omm * (ONE - a_s * a_s)
        gt = (gb * omm) * (ONE - a_t * a_t)
        w = np.empty((C, d), F)
        for c in range(C):
            gsv, gtv = vec(gs[c], d, pad), vec(gt[c], d, pad)
            gpre = np.empty(H, F)
            for k in range(H):
                a = dot_col(P, rows + H * ROW + k, gsv, d, DN)
                b = dot_col(P, rows + (H + d) * ROW + k, gtv, d, DN)
                gpre[k] = (a + b) * (ONE - h[c, k] * h[c, k])
            gpv = vec(gpre, H, pad)
            for j in range(d):
                w[c, j] = dot_col(P, rows + j, gpv, H, MAXW)
        gb = gb * (m + omm * e) + m * w
    return q, sacc, gb


@pytest.mark.parametrize("pad", [0.0, np.nan])
@pytest.mark.parametrize("d,layers,hidden", [
    (10, 4, 32), (4, 2, 8), (32, 1, 32), (7, 3, 5), (21, 2, 12)])
def test_warp_form_matches_the_plain_version_bit_for_bit(d, layers, hidden,
                                                         pad):
    packed = perturbed_packed(d, layers, hidden, seed=d + layers)
    rng = np.random.default_rng(d * 100 + hidden)
    z = (0.8 * rng.normal(size=(CHAINS, d))).astype(F)
    g = rng.normal(size=(CHAINS, d)).astype(F)
    q_w, sacc_w, zg_w = emulate_warp(packed, z, g, pad)
    q, sacc, acts = packed_forward(packed, torch.from_numpy(z))
    zg = packed_backward(packed, acts, torch.from_numpy(g))
    assert torch.equal(torch.from_numpy(q_w), q)
    assert torch.equal(torch.from_numpy(sacc_w), sacc)
    assert torch.equal(torch.from_numpy(zg_w), zg)
    # the nets are off the identity: the flow moves z
    assert not np.allclose(q_w, z, atol=1e-3)


def test_warp_form_sums_run_past_d_up_to_their_length():
    """The emulation's sums take the kernel's lengths: 16 over d up to
    d = 16, 32 above, and 32 over H, the terms past n masked."""
    x = np.arange(1, VEC + 1, dtype=F)
    P = np.arange(2, 2 + VEC * ROW, dtype=F)
    want = F(0.0)
    for i in range(5):
        want = P[i] * x[i] if i == 0 else want + P[i] * x[i]
    assert dot_row(P, 0, x, 5, 16) == want
    assert dot_row(P, 0, x, 5, 32) == want
    col = F(0.0)
    for i in range(2):
        col = P[i * ROW] * x[i] if i == 0 else col + P[i * ROW] * x[i]
    assert dot_col(P, 0, x, 2, 16) == col


def _funnel_bytes(d, layers, hidden, form, in_smem=True):
    return _build.flow_smem_bytes(d, 10, tg.funnel(d), layers, hidden,
                                  in_smem, form)


@pytest.mark.parametrize("d,layers,hidden,want", [
    (10, 4, 32, "warp"), (32, 4, 32, "warp"), (33, 4, 32, "today"),
    (10, 4, 33, "today"), (1, 1, 1, "warp"), (32, 14, 32, "warp"),
    (32, 15, 32, "today"), (10, 26, 32, "warp"), (10, 27, 32, "today"),
    (4, 60, 8, "warp"), (160, 4, 32, "today")])
def test_flow_form_on_both_sides_of_its_boundaries(d, layers, hidden, want):
    """Warp where d <= 32 and H <= 32 and its layout fits a block's shared
    memory: at d = H = 32 that is 14 layers, not 15; at d = 10 and H = 32,
    26 layers, not 27."""
    model = tg.funnel(d)
    assert _build.flow_form(d, 10, model, layers, hidden) == want
    fits = _funnel_bytes(d, layers, hidden, "warp") \
        <= _build.SMEM_OPT_IN_BYTES
    assert want == ("warp" if d <= 32 and hidden <= 32 and fits else "today")


def test_flow_form_ablation_macro_takes_todays_form(monkeypatch):
    monkeypatch.setattr(_build, "NVCC_DEFINES", ["NRT_FLOW_TODAY"])
    assert _build.flow_form(10, 10, tg.funnel(10), 4, 32) == "today"


@pytest.mark.parametrize("d,layers,hidden", [(10, 4, 32), (7, 3, 5),
                                             (32, 1, 32), (40, 2, 64)])
def test_flow_smem_bytes_mirror_each_forms_layout(d, layers, hidden):
    model = tg.funnel(d)
    chain = _build.mid_smem_bytes("posterior", d, 10, model)
    packed = perturbed_packed(d, layers, hidden, seed=1)
    if d <= MAXW and hidden <= MAXW:
        # the warp form: 3 floats of alignment, the work space (five vectors
        # a layer and five more), the layout warp_layout writes
        params, _ = warp_layout(packed)
        work = 5 * VEC * layers + 5 * VEC
        assert _build.flow_warp_floats(d, hidden, layers) == \
            3 + work + params.size
        assert _funnel_bytes(d, layers, hidden, "warp") == \
            chain + 4 * (3 + work + params.size)
    # today's: L (4 d + H) activations, four d-vectors and an H-vector, then
    # the packed arrays where they lie in shared memory
    today = layers * (4 * d + hidden) + 4 * d + hidden
    packed_floats = sum(int(a.numel()) for a in packed.arrays)
    assert _build.flow_packed_floats(d, hidden, layers) == packed_floats
    assert _funnel_bytes(d, layers, hidden, "today", False) == \
        chain + 4 * today
    assert _funnel_bytes(d, layers, hidden, "today", True) == \
        chain + 4 * (today + packed_floats)


def _cl_fits(d, layers, hidden):
    spec = coupling_flow(CouplingFlowConfig(num_layers=layers,
                                            hidden=hidden))
    one = spec.init(0, d, torch.zeros(1, d), torch.ones(1, d))
    first = {"layers": [{"mask": lay["mask"][0],
                         "net": {k: v[0] for k, v in lay["net"].items()}}
                        for lay in one["layers"]],
             "log_sigma": one["log_sigma"][0], "mu": one["mu"][0]}
    return tchain.flow_cl_fits(d, 10, spec.kernel_pack(first).arrays, 0)


def test_every_shape_the_runner_takes_has_a_form_that_fits():
    """On a grid of (d, L, H) around the warp form's limits and the JAX
    runner's: where ``flow_cl_fits`` accepts, the form ``flow_form`` picks
    fits a block's shared memory (today's with the parameters through L2
    where they do not fit)."""
    taken = 0
    for d in (2, 3, 10, 16, 17, 31, 32, 33, 64, 100, 154, 155):
        for layers in (1, 4, 8, 14, 15, 16, 32, 60):
            for hidden in (1, 5, 32, 33, 64, 256):
                if not _cl_fits(d, layers, hidden):
                    continue
                taken += 1
                form = _build.flow_form(d, 10, tg.funnel(d), layers, hidden)
                need = _funnel_bytes(d, layers, hidden, form, False)
                assert need <= _build.SMEM_OPT_IN_BYTES, (d, layers, hidden)
                if form == "warp":
                    assert d <= 32 and hidden <= 32
    assert taken > 100
