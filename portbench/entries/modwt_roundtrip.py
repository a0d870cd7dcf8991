"""``modwt_multilevel`` then ``imodwt_multilevel`` on one batch.

The traffic's ``precision`` picks the tier (``float32`` or ``exact``); the
comparison covers every analysis plane (``planes``: the J details and the
approximation; an exact plane read as hi + lo) and the reconstruction
(``recon``).
"""

from __future__ import annotations

import torch
import vectorwave_tpu_torch as vt

from portbench.reference import modwt as ref


def _roundtrip(x, cfg, precision):
    planes = vt.modwt_multilevel(x, cfg["wavelet"], levels=cfg["levels"],
                                 boundary=cfg["boundary"], precision=precision)
    recon = vt.imodwt_multilevel(planes, cfg["wavelet"], boundary=cfg["boundary"],
                                 precision=precision)
    return planes, recon


def call(x, cfg, mix):
    return _roundtrip(x, cfg, mix["precision"])


def control(x, cfg, mix):
    """The same call one precision lower: bfloat16 input for the float32
    tier, whose bf16 tiers run the float32 kernels; the float32 tier for
    the exact one."""
    if mix["precision"] == "exact":
        return _roundtrip(x, cfg, "float32")
    return _roundtrip(x.to(torch.bfloat16), cfg, mix["precision"])


def outputs(result):
    planes, recon = result
    items = list(planes.details) + [planes.approx]
    if hasattr(planes, "details_lo"):
        items = list(zip(items, list(planes.details_lo) + [planes.approx_lo]))
    return {"planes": items, "recon": [recon]}


def reference(x64, cfg, mix):
    details, approx = ref.analysis(x64, cfg["wavelet"], cfg["levels"], cfg["boundary"])
    recon = ref.synthesis(details, approx, cfg["wavelet"], cfg["boundary"])
    return {"planes": details + [approx], "recon": [recon]}


def work(cfg, mix):
    """Each input read once and each output written once: x (4 B a
    sample), the J + 1 planes (4 B, or 8 B as an exact hi, lo pair) and the
    reconstruction (4 B); 2 L J multiply-adds a sample each way, 2 FLOPs
    each, in float32 or, for the exact tier, float64."""
    samples = cfg["rows"] * cfg["n"]
    taps, levels = len(ref.filters(cfg["wavelet"])[0]), cfg["levels"]
    exact = mix["precision"] == "exact"
    plane_bytes = 8 if exact else 4
    return {"bytes": samples * (4 + (levels + 1) * plane_bytes + 4),
            "flops": samples * 2 * (2 * 2 * taps * levels),
            "dtype": "float64" if exact else "float32"}
