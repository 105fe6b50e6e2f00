"""Shared by the anatomy tests (CPU and card): the float64 pre-log value
that decides which log outputs are compared. The tolerances themselves
and the comparison are ``tpufeat_torch.experiments._common``'s, which
``chip_smoke.py`` uses too.
"""

import torch

from tpufeat_torch.kernels import anatomy


def _dot64(x, mats, prec):
    """x @ M in float64 on the same bf16-rounded operands as the port."""
    if prec == "f32":
        return x.double() @ mats[2].double()
    hi, lo = (t.double() for t in anatomy.split_bf16(x))
    out = hi @ mats[0].double()
    if prec != "bf16x1":
        out = out + hi @ mats[1].double()
    if prec == "bf16x3":
        out = out + lo @ mats[0].double()
    return out


def pre_log_f64(main, bnd, consts, dft, mel):
    """float64 m (the mel before the tail) of every output entry,
    [B, R * H, NM], with the splits of the f32 pipeline (z*z is rounded to
    f32 before its split, as in the kernel)."""
    main, bnd = main.cpu(), bnd.cpu()
    B, R, W = main.shape
    nblk = bnd.shape[1]
    TR = R // nblk
    ext = torch.cat([main.reshape(B, nblk, TR, W), bnd], dim=2)
    d = [None if t is None else t.cpu()
         for t in (consts.d_hi, consts.d_lo, consts.d_f32)]
    fb = [None if t is None else t.cpu()
          for t in (consts.fb_hi, consts.fb_lo, consts.fb_f32)]
    outs = []
    for phase in consts.table:
        z = 0
        for s, a, k, row in phase:
            dm = [None if t is None else t[row: row + k] for t in d]
            z = z + _dot64(ext[:, :, s: s + TR, a: a + k], dm, dft)
        sq = (z * z).float()
        outs.append(_dot64(sq, fb, mel))
    return torch.stack(outs, dim=3).reshape(B, R * len(outs), -1)
