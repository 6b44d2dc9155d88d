"""The freezing point of seawater (twin of mom6_tpu/eos/tfreeze.py).

Forms: LINEAR (TFREEZE_S0_P0 + dTFr_dS S + dTFr_dp p), MILLERO_78 and
TEOS_POLY (the TEOS-10 polynomial of the conservative freezing
temperature in absolute salinity and pressure); :func:`get_tfreeze`
dispatches on TFREEZE_FORM.  ``p`` is pressure in Pa.
"""

from __future__ import annotations

import torch

from mom6_tpu_torch.framework.arith import cpow, csqrt

__all__ = ["tfreeze_linear", "tfreeze_millero", "tfreeze_teos_poly",
           "get_tfreeze"]


def tfreeze_linear(S, p, tf_s0_p0: float = 0.0, dtfr_ds: float = -0.054,
                   dtfr_dp: float = -7.75e-8):
    """The linear freezing point [degC]."""
    return tf_s0_p0 + dtfr_ds * S + dtfr_dp * p


def tfreeze_millero(S, p):
    """Millero (1978) [degC] of the practical salinity S."""
    return (-0.0575 * S + 1.710523e-3 * cpow(S, 1.5) - 2.154996e-4 * S * S
            - 7.75e-8 * p)


# the TEOS-10 coefficients TFab of S**(a/2) p**b
_TF = dict(
    TF00=0.017947064327968736, TF20=-6.076099099929818e-2,
    TF30=4.883198653547851e-3, TF40=-1.188081601230542e-3,
    TF50=1.334658511480257e-4, TF60=-8.722761043208607e-6,
    TF70=2.082038908808201e-7, TF01=-7.389420998107497e-8,
    TF21=-9.891538123307282e-11, TF31=-8.987150128406496e-13,
    TF41=1.054318231187074e-12, TF51=3.850133554097069e-14,
    TF61=-2.079022768390933e-14, TF71=1.242891021876471e-15,
    TF02=-2.110913185058476e-16, TF22=3.831132432071728e-19,
    TF32=1.065556599652796e-19, TF42=-2.078616693017569e-20,
    TF52=1.596435439942262e-21, TF03=2.295491578006229e-25,
    TF23=-7.997496801694032e-27, TF33=8.756340772729538e-28,
    TF43=1.338002171109174e-29)


def tfreeze_teos_poly(S, p):
    """The TEOS-10 conservative freezing temperature [degC] of the
    absolute salinity S [g kg-1] (calculate_TFreeze_TEOS_poly)."""
    c = _TF
    rs = csqrt(torch.clamp(S, min=0.0))
    return ((c["TF00"] + S * (c["TF20"] + rs * (c["TF30"] + rs * (
        c["TF40"] + rs * (c["TF50"] + rs * (c["TF60"] + rs * c["TF70"]))))))
        + p * ((c["TF01"] + S * (c["TF21"] + rs * (c["TF31"] + rs * (
            c["TF41"] + rs * (c["TF51"] + rs * (c["TF61"]
                                                + rs * c["TF71"]))))))
               + p * ((c["TF02"] + S * (c["TF22"] + rs * (c["TF32"] + rs * (
                   c["TF42"] + rs * c["TF52"]))))
                      + p * (c["TF03"] + S * (c["TF23"] + rs * (
                          c["TF33"] + rs * c["TF43"]))))))


def get_tfreeze(form: str):
    """The freezing point function of TFREEZE_FORM."""
    key = form.upper()
    if key == "LINEAR":
        return tfreeze_linear
    if key == "MILLERO_78":
        return tfreeze_millero
    if key in ("TEOS_POLY", "TEOS10"):
        return tfreeze_teos_poly
    raise ValueError(f"unknown TFREEZE_FORM {form}")
