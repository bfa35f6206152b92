"""The per-draw diagonal adaptation that the fused warmup kernels run.

Plain PyTorch version of ``csrc/diag_adapt.cuh``, shared by the NUTS (K2)
and MCLMC (K4) warmup plain versions.  It is the in-kernel form of
``adapt/mass_matrix.py`` (``update_estimators``, ``switch``, ``adapt_diag``
with ``set_diag``), as the Pallas warmup bodies inline it
(``nuts_rs_tpu/kernels/nuts_pallas.py:1399-1450``,
``mclmc_pallas.py:785-842``), with the same order of floating-point
operations as the CUDA header.
"""

from __future__ import annotations

import torch

from ..ops import dsum

# estimator planes: fg draw mean/var, fg grad mean/var, bg x4
NEST = 8


def adapt_draw(est, cnt_fg, cnt_bg, tid, stds, mean, q, g, inc, do_switch,
               do_update, use_grad_based, csum=dsum):
    """One draw of the fg/bg Welford estimators, the window switch and the
    diagonal mass-matrix rule.

    ``est`` is the list of the 8 [C, d] planes; ``cnt_fg``, ``cnt_bg`` and
    ``tid`` are [C]; ``q``, ``g`` the draw fed to the estimators where
    ``inc`` [C] holds; ``do_switch`` and ``do_update`` are the schedule's
    host flags; ``csum`` is the layout's sum over the parameter axis
    (``ops.tsum`` for the dim-on-lanes kernel).  Returns ``(est, cnt_fg, cnt_bg, stds, mean, logdet, tid)``
    after the draw."""
    zf = torch.zeros_like(cnt_fg)
    zd = torch.zeros_like(q)

    def add2(mean_p, var_p, cnt_old, value):
        cnt = cnt_old + inc.to(torch.float32)
        first1 = (cnt == 1.0)[:, None]
        diffv = value - mean_p
        meann = torch.where(first1, value,
                            mean_p + diffv / torch.clamp(cnt, min=1.0)[:, None])
        varn = var_p + torch.where(first1, 0.0, diffv * diffv)
        return (torch.where(inc[:, None], meann, mean_p),
                torch.where(inc[:, None], varn, var_p))

    fg_dm, fg_dv = add2(est[0], est[1], cnt_fg, q)
    fg_gm, fg_gv = add2(est[2], est[3], cnt_fg, g)
    bg_dm, bg_dv = add2(est[4], est[5], cnt_bg, q)
    bg_gm, bg_gv = add2(est[6], est[7], cnt_bg, g)
    cnt_fg = cnt_fg + torch.where(inc, 1.0, 0.0)
    cnt_bg = cnt_bg + torch.where(inc, 1.0, 0.0)
    if do_switch:
        fg_dm, fg_dv, fg_gm, fg_gv = bg_dm, bg_dv, bg_gm, bg_gv
        bg_dm, bg_dv, bg_gm, bg_gv = zd, zd, zd, zd
        cnt_fg, cnt_bg = cnt_bg, zf

    enough = (cnt_fg >= 3.0) & do_update
    if use_grad_based:
        val = torch.sqrt(fg_dv / fg_gv)
    else:
        val = fg_dv * (1.0 / torch.clamp(cnt_fg, min=1.0))[:, None]
    invalid = ~torch.isfinite(val) | (val == 0.0)
    var = torch.clamp(val, 1e-20, 1e20)
    var = torch.where(invalid, torch.square(stds), var)
    new_stds = torch.sqrt(var)
    new_mean = fg_dm + var * fg_gm if use_grad_based else fg_dm
    stds_n = torch.where(enough[:, None], new_stds, stds)
    mean_n = torch.where(enough[:, None], new_mean, mean)
    logdet_n = -csum(torch.log(stds_n))
    tid_n = tid + torch.where(enough, 1.0, 0.0)
    est = [fg_dm, fg_dv, fg_gm, fg_gv, bg_dm, bg_dv, bg_gm, bg_gv]
    return est, cnt_fg, cnt_bg, stds_n, mean_n, logdet_n, tid_n
