"""Modified Bessel function of the second kind K_nu, pure JAX.

Needed by the Matérn covariance families with continuously varying
smoothness (reference: GpGp's C++ matern_* covariance functions, registry at
mcmc_nngp_initialize.R:62-69).  jax.scipy does not ship K_nu, so it is
implemented here from the classical algorithms:

- x <= 2 : Temme's series (Temme 1975, J.Comp.Phys 19), with the auxiliary
  Gamma-ratio functions evaluated by Chebyshev expansion.
- x >  2 : Steed's continued fraction CF2 (Thompson & Barnett 1987).

Both branches compute K_mu and K_{mu+1} for |mu| <= 1/2, then recur upward
to nu = mu + l.  Fixed iteration counts (no data-dependent control flow)
keep the whole thing a straight-line vectorized computation that XLA maps
onto the VPU.  Supports nu in (0, 3.5]; covers the sampler's smoothness
transform nu = 0.5 + 0.5*sigmoid(s) (mcmc_nngp_update_Gaussian.R:70) and the
reporting transform 1.5*sigmoid(s) (mcmc_nngp_estimate.R:38) with margin.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_SERIES_ITERS = 20
_CF2_ITERS = 40

# Chebyshev coefficients (Numerical-Recipes "beschb" fits) for
#   gam1(mu) = [1/Gamma(1-mu) - 1/Gamma(1+mu)] / (2 mu)
#   gam2(mu) = [1/Gamma(1-mu) + 1/Gamma(1+mu)] / 2
# as functions of xx = 8 mu^2 - 1 on [-1, 1], valid for |mu| <= 1/2.
_C1 = (
    -1.142022680371168e0, 6.5165112670737e-3, 3.087090173086e-4,
    -3.4706269649e-6, 6.9437664e-9, 3.67795e-11, -1.356e-13,
)
_C2 = (
    1.843740587300905e0, -7.68528408447867e-2, 1.2719271366546e-3,
    -4.9717367042e-6, -3.31261198e-8, 2.423096e-10, -1.702e-13, -1.49e-15,
)


def _chebev(coeffs, x):
    """Clenshaw evaluation of a Chebyshev series on [-1, 1]."""
    d = jnp.zeros_like(x)
    dd = jnp.zeros_like(x)
    for c in coeffs[:0:-1]:
        d, dd = 2.0 * x * d - dd + c, d
    return x * d - dd + 0.5 * coeffs[0]


def _beschb(mu):
    xx = 8.0 * mu * mu - 1.0
    gam1 = _chebev(_C1, xx)
    gam2 = _chebev(_C2, xx)
    gampl = gam2 - mu * gam1   # = 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1   # = 1/Gamma(1-mu)
    return gam1, gam2, gampl, gammi


def _temme_small_x(x, mu):
    """K_mu(x), K_{mu+1}(x) for x <= 2 via Temme's series."""
    eps = jnp.asarray(1e-12, x.dtype)
    x2 = 0.5 * x
    pimu = jnp.pi * mu
    fact = jnp.where(jnp.abs(pimu) < eps, 1.0, pimu / jnp.sin(pimu))
    d = -jnp.log(x2)
    e = mu * d
    fact2 = jnp.where(jnp.abs(e) < eps, 1.0, jnp.sinh(e) / e)
    gam1, gam2, gampl, gammi = _beschb(mu)
    ff = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d)
    total = ff
    e = jnp.exp(e)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    c = jnp.ones_like(x)
    d2 = x2 * x2
    total1 = p
    for i in range(1, _SERIES_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        total = total + c * ff
        total1 = total1 + c * (p - fi * ff)
    k_mu = total
    k_mu1 = total1 * (2.0 / x)
    return k_mu, k_mu1


def _cf2_large_x(x, mu):
    """K_mu(x), K_{mu+1}(x) for x > 2 via Steed's continued fraction.

    Runs a fixed iteration count (straight-line vectorized code); the
    unnormalized 3-term recurrence (q1, q2) is renormalized every step so
    fixed-length execution cannot overflow after convergence.
    """
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = jnp.zeros_like(x)
    q2 = jnp.ones_like(x)
    a1 = 0.25 - mu * mu
    q = a1 * jnp.ones_like(x)
    c = a1 * jnp.ones_like(x)
    a = -a1
    s = 1.0 + q * delh
    eps = jnp.asarray(1e-10 if x.dtype == jnp.float64 else 1e-8, x.dtype)
    done = jnp.zeros_like(x, dtype=bool)
    for i in range(2, _CF2_ITERS + 2):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1 = jnp.where(done, q1, q2)
        q2 = jnp.where(done, q2, qnew)
        q = jnp.where(done, q, q + c * qnew)
        # renormalize: keep |c| ~ 1, folding its magnitude into (q1, q2);
        # qnew is linear in (q1, q2) so c*qnew — the series increment — is
        # invariant, and fixed-length f32 execution cannot overflow.
        r = jnp.maximum(jnp.abs(c), 1e-30)
        c = c / r
        q1 = q1 * r
        q2 = q2 * r
        b = b + 2.0
        denom = b + a * d
        denom = jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        d = jnp.where(done, d, 1.0 / denom)
        delh_new = (b * d - 1.0) * delh
        dels = q * delh_new
        delh = jnp.where(done, delh, delh_new)
        h = jnp.where(done, h, h + delh_new)
        s_new = s + dels
        # freeze each lane once its series increment is negligible —
        # running the CF past convergence revives rounding noise
        done_new = done | (jnp.abs(dels) < eps * jnp.abs(s_new))
        s = jnp.where(done, s, s_new)
        done = done_new
    h = a1 * h
    k_mu = jnp.sqrt(jnp.pi / (2.0 * x)) * jnp.exp(-x) / s
    k_mu1 = k_mu * (mu + x + 0.5 - h) / x
    return k_mu, k_mu1


def kv(nu, x):
    """K_nu(x) for nu in (0, 3.5], x > 0, elementwise/broadcasting.

    nu and x may be any broadcast-compatible shapes; the result follows
    jnp broadcasting.  x == 0 returns +inf (the Matérn kernels guard the
    zero-distance case separately).
    """
    nu = jnp.asarray(nu)
    x = jnp.asarray(x)
    nu, x = jnp.broadcast_arrays(nu, x)
    dtype = jnp.result_type(nu, x, jnp.float32)
    nu = nu.astype(dtype)
    x = x.astype(dtype)
    # split nu = mu + l with |mu| <= 1/2
    l = jnp.floor(nu + 0.5)
    mu = nu - l
    x_small = jnp.minimum(x, 2.0)
    x_big = jnp.maximum(x, 2.0)
    ks_mu, ks_mu1 = _temme_small_x(jnp.maximum(x_small, 1e-30), mu)
    kb_mu, kb_mu1 = _cf2_large_x(x_big, mu)
    small = x <= 2.0
    k0 = jnp.where(small, ks_mu, kb_mu)
    k1 = jnp.where(small, ks_mu1, kb_mu1)
    # upward recurrence K_{m+1} = K_{m-1} + 2 m / x * K_m, applied l times
    # (l in {0,1,2,3}); compute all and select elementwise.
    ks = [k0, k1]
    for j in range(1, 4):
        ks.append(ks[-2] + 2.0 * (mu + j) / x * ks[-1])
    out = ks[0]
    for j in range(1, 4):
        out = jnp.where(l == j, ks[j], out)
    out = jnp.where(x <= 0.0, jnp.inf, out)
    return out
