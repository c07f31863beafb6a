"""Stationary covariance families + shape-parameter transform registry.

JAX equivalents of GpGp's C++ covariance functions (reference
registry: mcmc_nngp_initialize.R:62-69; kernels invoked through
GpGp::vecchia_Linv with covparms = c(variance=1, shape..., nugget=0),
mcmc_nngp_update_Gaussian.R:72).  All families return *correlation*
matrices: during sampling the variance is handled by log_scale outside the
kernel and the nugget by log_noise_variance.

Families (same names as the reference):
  exponential_isotropic   exp(-d / range)
  exponential_sphere      exp(-d / range), d = chordal distance on the unit
                          sphere (lon/lat degrees embedded in R^3 — the GpGp
                          *_sphere convention; great-circle ~ chordal at the
                          ranges of interest, reported ranges scale by the
                          Earth radius as in Heavy_metals/Results_analysis.R:139)
  exponential_scaledim    exp(-||Delta x / ranges||)
  exponential_spacetime   exp(-||(Delta s / r1, Delta t / r2)||)
  matern_isotropic        2^(1-nu)/Gamma(nu) (d/r)^nu K_nu(d/r)
  matern_sphere           same, chordal sphere distance
  matern_scaledim         matern on ||Delta x / ranges||, r = 1
  matern_spacetime        matern on ||(Delta s/r1, Delta t/r2)||, r = 1

Shape transforms: "log_*" parameters enter through exp(); the Matérn
"qlogis_smoothness" enters through nu = 0.5 + 0.5*sigmoid(s) — the
*sampling-time* transform of the reference (mcmc_nngp_update_Gaussian.R:70).
The reference is internally inconsistent (init uses .4+.7*sigmoid at
mcmc_nngp_initialize.R:199, estimate/predict use 1.5*sigmoid at
mcmc_nngp_estimate.R:38 / mcmc_nngp_predict.R:37); this implementation uses
the sampling transform for *all* internal computation (init, sampling,
prediction) and keeps the reference's reporting-only transforms in
``estimate`` for output parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nngp_tpu.ops.bessel import kv

COVFUN_FAMILIES = (
    "exponential_isotropic",
    "exponential_sphere",
    "exponential_scaledim",
    "exponential_spacetime",
    "matern_isotropic",
    "matern_sphere",
    "matern_scaledim",
    "matern_spacetime",
)


def shape_param_names(covfun: str, n_dims: int) -> list[str]:
    """Sampled-scale shape parameter names (mcmc_nngp_initialize.R:62-69).

    ``n_dims`` is the dimension of the *raw* location array (before any
    sphere embedding).
    """
    if covfun in ("exponential_isotropic", "exponential_sphere"):
        return ["log_range"]
    if covfun == "exponential_scaledim":
        return [f"log_range_{j+1}" for j in range(n_dims)]
    if covfun == "exponential_spacetime":
        return ["log_range_1", "log_range_2"]
    if covfun in ("matern_isotropic", "matern_sphere"):
        return ["log_range", "qlogis_smoothness"]
    if covfun == "matern_scaledim":
        return [f"log_range_{j+1}" for j in range(n_dims)] + ["qlogis_smoothness"]
    if covfun == "matern_spacetime":
        return ["log_range_1", "log_range_2", "qlogis_smoothness"]
    raise ValueError(f"unknown covariance family {covfun!r}")


def shape_transform(names: list[str], sampled: jax.Array) -> jax.Array:
    """Sampled (unconstrained) shape params -> natural scale.

    log_* -> exp; qlogis_smoothness -> 0.5 + 0.5*sigmoid
    (mcmc_nngp_update_Gaussian.R:67-71).
    """
    out = []
    for j, name in enumerate(names):
        if name.startswith("log"):
            # exp_acc: the builtin's ~1e-6 relative error is a *rugged*
            # reparametrization of theta that the n-term log-det amplifies
            # to O(0.05) ratio noise at n=58k
            out.append(exp_acc(sampled[j]))
        elif name.startswith("qlogis"):
            out.append(0.5 + 0.5 * jax.nn.sigmoid(sampled[j]))
        else:  # pragma: no cover
            raise ValueError(name)
    return jnp.stack(out)


def _pairwise_sqdist(x: jax.Array) -> jax.Array:
    """[..., k, d] -> squared distances [..., k, k]."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def n_range_groups(covfun: str, n_dims_embed: int) -> int:
    """Number of independently-ranged distance groups for ``covfun``.

    isotropic/sphere: 1 (one shared range); scaledim: one per coordinate
    dimension; spacetime: 2 (space dims pooled, time separate).
    ``n_dims_embed`` is the dimension of the kernel coordinates (after any
    sphere embedding)."""
    kind = covfun.split("_", 1)[1]
    if kind in ("isotropic", "sphere"):
        return 1
    if kind == "scaledim":
        return n_dims_embed
    if kind == "spacetime":
        return 2
    raise ValueError(kind)


def group_sqdist(coords, covfun: str):
    """Per-range-group squared distances [..., k, k, G] from coords
    [..., k, d'].  Works for NumPy (host f64 precompute) and JAX inputs.

    Motivation (precision): nearby locations differ in O(1) coordinates by
    O(1e-3..1e-5), so computing distances from *f32-stored coordinates*
    loses 3-5 digits to cancellation — an error that is then amplified by
    ~1/d_i through the conditional variance of the Vecchia factor and ends
    up as O(0.1-1) noise in the MH log-ratios (experiments/ratio_audit_*).
    The distances themselves are theta-independent, so the graph
    precomputes them once in float64 on the host and stores them f32; this
    function defines the (shared) grouping layout."""
    xp = jnp if isinstance(coords, jax.Array) else __import__("numpy")
    kind = covfun.split("_", 1)[1]
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    d2 = diff * diff                                   # [..., k, k, d']
    if kind in ("isotropic", "sphere"):
        return xp.sum(d2, axis=-1)[..., None]
    if kind == "scaledim":
        return d2
    if kind == "spacetime":
        return xp.concatenate(
            [xp.sum(d2[..., :-1], axis=-1)[..., None], d2[..., -1:]], axis=-1
        )
    raise ValueError(kind)


def correlation_from_sqdist(covfun: str, d2g: jax.Array,
                            shape: jax.Array) -> jax.Array:
    """Correlation [..., k, k] from precomputed per-group squared distances
    d2g [..., k, k, G] (see :func:`group_sqdist`) and natural-scale shape
    params — the precision-preserving path used by the sampler's factor
    build (no coordinate cancellation at all)."""
    if covfun not in COVFUN_FAMILIES:
        raise ValueError(f"unknown covariance family {covfun!r}")
    is_matern = covfun.startswith("matern")
    G = d2g.shape[-1]
    ranges = shape[:G]
    nu = shape[G] if is_matern else None
    d2 = jnp.sum(d2g / (ranges * ranges), axis=-1)
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    if is_matern:
        return _matern(d, nu)
    return exp_neg(d)


# ~1-ulp f32 exp(-t): a builtin exp that is a few ulps off (backends
# differ) has its error amplified by the Vecchia conditional-variance
# cancellation by 1/d_i (1e2-1e5x at Heavy-metals geometry), straight into
# the sufficient MH log-ratio.  Cody-Waite argument reduction + an
# (e^r - 1) polynomial keeps every rounding term small relative to the
# result, so the factor build is limited only by f32 storage of K, the
# same on every backend.
_LOG2E = 1.4426950408889634
_LN2_HI = 0.693145751953125       # ln2 rounded to 2^-21: k*_LN2_HI exact
_LN2_LO = 1.42860676533018e-06    # ln2 - _LN2_HI
# (e^r - 1 - r) / r^2 Taylor coefficients, r in [-0.3466, 0.3466]
_EXP_C = (1.0 / 5040, 1.0 / 720, 1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5)


def exp_acc(x: jax.Array) -> jax.Array:
    """Accurate e^x (f32, ~1 ulp on every backend), any sign.

    Saturation-safe: the 2^k scaling is applied in two ldexp stages each
    within +-127 (a single ldexp with |k| > ~150 can wrap the exponent on
    some backends instead of under/overflowing), and arguments beyond the
    f32-representable range return exact 0 / inf."""
    k = jnp.round(x * _LOG2E)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = jnp.asarray(_EXP_C[0], dtype=x.dtype)
    for c in _EXP_C[1:]:
        p = p * r + c
    q = r + (r * r) * p            # e^r - 1, rounding ~eps*|r|
    k1 = jnp.clip(k, -127.0, 127.0)
    k2 = jnp.clip(k - k1, -127.0, 127.0)
    out = jnp.ldexp(jnp.ldexp(1.0 + q, k1.astype(jnp.int32)),
                    k2.astype(jnp.int32))
    out = jnp.where(x < -103.0, jnp.zeros((), dtype=out.dtype), out)
    return jnp.where(x > 88.7, jnp.asarray(jnp.inf, dtype=out.dtype), out)


def exp_neg(t: jax.Array) -> jax.Array:
    """Accurate e^{-t} for t >= 0 (f32, ~1 ulp on every backend)."""
    return exp_acc(-t)


# log(1+u) Taylor tail coefficients: (log1p(u) - u + u^2/2) / u^3 series
_LOG1P_C = (-1.0 / 10, 1.0 / 9, -1.0 / 8, 1.0 / 7, -1.0 / 6, 1.0 / 5,
            -1.0 / 4, 1.0 / 3)


def log1p_acc(u: jax.Array) -> jax.Array:
    """Accurate log(1+u) for |u| <~ 0.25 (falls back to the builtin
    outside, where a builtin's few-ulp error is negligible against the
    O(1)+ result).  The MH log-det ratio sums ~n of these, so any
    systematic bias of a builtin near 0 would accumulate n-fold (n=58k at
    Heavy-metals scale)."""
    u2 = u * u
    p = jnp.asarray(_LOG1P_C[0], dtype=u.dtype)
    for c in _LOG1P_C[1:]:
        p = p * u + c
    small = u - 0.5 * u2 + (u2 * u) * p     # rounding ~eps*|u|
    return jnp.where(jnp.abs(u) <= 0.25, small, jnp.log1p(u))


_MATERN_SMALL_X = 0.29
_MATERN_SERIES_K = 6


def _matern_comp_small(x: jax.Array, nu) -> jax.Array:
    """1 - C(x) for the Matérn correlation at small scaled distance x,
    by the ascending power series — accurate RELATIVE to its own (small)
    size, unlike the generic x^nu K_nu(x) product whose ~1-ulp absolute
    error is an O(eps/(1-C)) relative error of the complement.  That
    relative error is what the Vecchia conditional variance amplifies:
    at HM geometry the product path left (1-C) wrong by up to ~6% on
    near-duplicate pairs and O(1) systematic noise in the MH log-det
    ratios (experiments/matern_probe_cpu.json).

    From K_nu = pi/(2 sin(pi nu)) [I_{-nu} - I_nu]:
      1 - C(x) = g (x/2)^{2 nu} S2(x) - S1(x),
      g = Gamma(1-nu)/Gamma(1+nu),
      S2 = sum_{k>=0} t2_k,  t2_0 = 1,      t2_k = t2_{k-1} x^2/(4 k (k+nu))
      S1 = sum_{k>=1} t1_k,  t1_1 = x^2/(4 (1-nu)),
                             t1_k = t1_{k-1} x^2/(4 k (k-nu))
    g is evaluated through the same Chebyshev auxiliary functions as the
    Bessel Temme series (1/Gamma(1 +- mu) with mu = 1-nu in (0, 0.5]), so
    no lgamma cancellation enters.  The t2-vs-t1 cancellation as nu -> 1
    is mild (both diverge like 1/(1-nu) while the difference stays
    O(x^2 ln x); amplification ~ 1/((1-nu) 2 ln(2/x)) < ~10 for nu <=
    0.99 at x <= 0.3).  Valid for nu in (0.5, 1) — the sampler's
    smoothness band (mcmc_nngp_update_Gaussian.R:70).
    """
    from nngp_tpu.ops.bessel import _beschb

    mu = 1.0 - nu                       # in (0, 0.5)
    _, _, gampl, gammi = _beschb(mu)    # 1/Gamma(1+mu), 1/Gamma(1-mu)
    g = gammi / (mu * (1.0 - mu) * gampl)
    q = 0.25 * x * x
    t2 = jnp.ones_like(x)
    S2 = t2
    t1 = q / (1.0 - nu)
    S1 = t1
    for k in range(1, _MATERN_SERIES_K):
        t2 = t2 * q / (k * (k + nu))
        S2 = S2 + t2
        if k >= 2:
            t1 = t1 * q / (k * (k - nu))
            S1 = S1 + t1
    xh = jnp.maximum(0.5 * x, 1e-30)
    pow_term = exp_acc(2.0 * nu * jnp.log(xh))
    return g * pow_term * S2 - S1


def _matern(d: jax.Array, nu) -> jax.Array:
    """Matérn correlation at scaled distance d (range already applied).

    Small scaled distances (d <= 0.29) go through the complementary
    series (see :func:`_matern_comp_small`); larger ones through the
    2^{1-nu}/Gamma(nu) d^nu K_nu(d) product, where (1-C) is O(1) and the
    product's ~1-ulp absolute error is harmless."""
    # guard d == 0 (diagonal): value is 1 there
    safe_d = jnp.maximum(d, 1e-8)
    lognorm = (1.0 - nu) * jnp.log(2.0) - jax.lax.lgamma(nu)
    val_big = jnp.exp(lognorm + nu * jnp.log(safe_d)) * kv(nu, safe_d)
    x_small = jnp.minimum(safe_d, _MATERN_SMALL_X)  # keep series args tame
    val_small = 1.0 - _matern_comp_small(x_small, nu)
    val = jnp.where(safe_d <= _MATERN_SMALL_X, val_small, val_big)
    return jnp.where(d <= 1e-8, 1.0, val)


def correlation_fn(covfun: str):
    """Return corr(coords [..., k, d'], natural_shape [n_shape]) -> [..., k, k].

    ``coords`` for *_sphere families are the precomputed 3-D unit-sphere
    embedding (VecchiaGraph.kernel_coords).
    """
    if covfun not in COVFUN_FAMILIES:
        raise ValueError(f"unknown covariance family {covfun!r}")
    is_matern = covfun.startswith("matern")
    kind = covfun.split("_", 1)[1]

    def corr(coords: jax.Array, shape: jax.Array) -> jax.Array:
        if kind in ("isotropic", "sphere"):
            rng = shape[0]
            d2 = _pairwise_sqdist(coords) / (rng * rng)
            nu = shape[1] if is_matern else None
        elif kind == "scaledim":
            nd = coords.shape[-1]
            ranges = shape[:nd]
            d2 = _pairwise_sqdist(coords / ranges)
            nu = shape[nd] if is_matern else None
        elif kind == "spacetime":
            r_space, r_time = shape[0], shape[1]
            scale = jnp.concatenate(
                [jnp.full((coords.shape[-1] - 1,), r_space), jnp.full((1,), r_time)]
            )
            d2 = _pairwise_sqdist(coords / scale)
            nu = shape[2] if is_matern else None
        else:  # pragma: no cover
            raise ValueError(kind)
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        if is_matern:
            return _matern(d, nu)
        return exp_neg(d)

    return corr
