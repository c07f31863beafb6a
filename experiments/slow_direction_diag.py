"""Diagnose the Heavy-metals MPSRF slow direction (round-5, VERDICT item 1).

Questions, answered from the committed r4 fit records (experiments/
hm_fit_r4.pkl, iterations 1..5200 incl. the r4 extension):

1. What is the integrated autocorrelation time (IACT) of the diffuse
   combination (hm_mpsrf.json principal direction) vs. log_range and the
   worst single beta?  -> is it mixing (long ACF) or bias (chains at
   different levels)?
2. How ill-conditioned is the interweaved-beta precision P_iw = (LX)'(LX)
   at posterior-typical parameters?  -> is f32 Cholesky of P_iw accurate
   enough in the diffuse direction (error ~ eps * cond)?
3. Do per-chain means of the combo separate by more than the within-chain
   spread predicts (stochastic-bias signature) or is the between-spread
   consistent with the measured IACT (pure slow-mixing signature)?

Reference: slow direction measured in experiments/hm_mpsrf.json; MPSRF
semantics mcmc_nngp_diagnose.R:12-23.
"""

import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PKL = "experiments/hm_fit_r4.pkl"
OUT = "experiments/slow_direction_diag.json"


def iact(x, max_lag=None):
    """Integrated autocorrelation time via initial-positive-sequence sum."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    x = x - x.mean()
    if max_lag is None:
        max_lag = n // 2
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:max_lag] / n
    rho = acov / acov[0]
    tau = 1.0
    for k in range(1, max_lag):
        if rho[k] <= 0.05:
            break
        tau += 2.0 * rho[k]
    return float(tau), rho[: min(200, max_lag)]


def main():
    with open(PKL, "rb") as f:
        host = pickle.load(f)
    records = host["records"]
    n_chains = len(records)
    T = records[0]["log_scale"].shape[0]
    burn = T // 2
    print(f"records: {n_chains} chains x {T} iters, burn-in {burn}")

    names = []
    cols = []
    for rec in records:
        mat = [rec["beta_0"][:, None], rec["beta"], rec["log_scale"][:, None],
               rec["log_noise_variance"][:, None], rec["shape"]]
        cols.append(np.concatenate(mat, axis=1))
    if not names:
        names = (["beta_0"] + list(records[0]["beta_names"]) +
                 ["log_scale", "log_noise_variance"] +
                 list(records[0]["shape_names"]))
    A = np.stack(cols)              # [chains, T, p]
    Ab = A[:, burn:, :]
    p = Ab.shape[2]

    # principal slow direction: recompute exactly as hm_mpsrf.py / the
    # reference (W^-1 B largest eigenvector)
    W = np.mean([np.cov(Ab[c].T) for c in range(n_chains)], axis=0)
    mu = Ab.mean(axis=1)
    B = np.cov(mu.T) * Ab.shape[1]
    evals, evecs = np.linalg.eig(np.linalg.solve(W, B / Ab.shape[1]))
    k = np.argmax(evals.real)
    v = evecs[:, k].real
    v = v / np.linalg.norm(v)
    lam = evals.real[k]
    m = n_chains
    nn = Ab.shape[1]
    mpsrf = (nn - 1) / nn + (m + 1) / m * lam
    print(f"MPSRF over 2nd half of {T}: {mpsrf:.3f}")

    combo = Ab @ v                  # [chains, T-burn]
    out = {"T": int(T), "burn": int(burn), "mpsrf_2nd_half": float(mpsrf)}

    rows = []
    idx_range = names.index("log_range")
    for label, series in (
        ("combo", combo),
        ("log_range", Ab[:, :, idx_range]),
        ("log_scale", Ab[:, :, names.index("log_scale")]),
        ("twi", Ab[:, :, names.index("twi")]),
        ("globedem", Ab[:, :, names.index("globedem")]),
        ("beta_0", Ab[:, :, names.index("beta_0")]),
    ):
        taus = [iact(series[c])[0] for c in range(n_chains)]
        within_sd = float(np.mean([series[c].std() for c in range(n_chains)]))
        between_sd = float(series.mean(axis=1).std(ddof=1))
        # expected between-sd if stationary + mixing at measured tau:
        # sd(chain mean) ~ within_sd * sqrt(tau / n)
        exp_between = within_sd * np.sqrt(np.mean(taus) / nn)
        rows.append({
            "param": label,
            "iact": [round(t, 1) for t in taus],
            "within_sd": round(within_sd, 5),
            "between_sd_of_means": round(between_sd, 5),
            "expected_between_sd_if_mixing": round(float(exp_between), 5),
            "ratio_actual_over_expected": round(
                between_sd / max(exp_between, 1e-12), 2),
        })
        print(rows[-1])
    out["series"] = rows

    # chain-mean trajectory of the combo in 500-iter windows (drift check)
    win = 500
    traj = []
    for lo in range(0, Ab.shape[1] - win + 1, win):
        traj.append([round(float(combo[c, lo:lo + win].mean()), 4)
                     for c in range(n_chains)])
    out["combo_running_means_500"] = traj
    print("combo running means (500-iter windows):")
    for t in traj:
        print("  ", t)

    # ---- P_iw conditioning at posterior-typical parameters ----
    from nngp_tpu.ops.numpy_ref import np_vecchia_linv, np_shape_transform
    from nngp_tpu.utils.datasets import load_heavy_metals
    from nngp_tpu.preprocess.dedupe import dedupe_and_match
    from nngp_tpu.preprocess.graph import build_graph
    from nngp_tpu.preprocess.ordering import reorder_locations
    from nngp_tpu.preprocess.design import build_design

    locs, y, X = load_heavy_metals()
    rng = np.random.default_rng(1)
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=True,
                                                  rng=rng))
    graph, NN = build_graph(maps, m=5, covfun="exponential_sphere")
    design = build_design(X_locs=X)
    h1 = np.asarray(graph.hctam_scol_1)
    X_locs_u = design.X[h1]
    coords = np.asarray(graph.kernel_coords, dtype=np.float64)

    post_range = float(np.exp(np.median(Ab[:, :, idx_range])))
    shape_names = list(records[0]["shape_names"])
    natural = np_shape_transform(shape_names,
                                 np.array([np.log(post_range)]))
    linv = np_vecchia_linv(coords, NN, "exponential_sphere", natural)
    # L @ [1 X] via compressed rows
    nloc = graph.n
    X1 = np.concatenate([np.ones((nloc, 1)), X_locs_u], axis=1)
    safe = np.maximum(NN, 0)
    mask = (NN >= 0)
    LX = np.einsum("nm,nmp->np", linv * mask, X1[safe])
    P_iw = LX.T @ LX
    ev = np.linalg.eigvalsh(P_iw)
    cond_piw = float(ev[-1] / ev[0])
    print(f"posterior-median range {post_range:.4f}; cond(P_iw) = "
          f"{cond_piw:.3e}  (f32 rel err ~ {cond_piw * 6e-8:.2e})")
    out["cond_P_iw"] = cond_piw
    out["posterior_median_range"] = post_range
    out["cond_XtX"] = float(np.linalg.cond(design.X.T @ design.X))

    # f32 solve error probe: random rhs with the conditional-draw structure
    rhs = LX.T @ rng.normal(size=nloc)
    mean64 = np.linalg.solve(P_iw, rhs)
    cL32 = np.linalg.cholesky(P_iw.astype(np.float32))
    from scipy.linalg import solve_triangular
    y32 = solve_triangular(cL32, rhs.astype(np.float32), lower=True)
    mean32 = solve_triangular(cL32, y32, trans=1, lower=True)
    err = mean32.astype(np.float64) - mean64
    # error measured against the conditional sd in each eigendirection:
    # cond draw has sd ~ sqrt(scale) * 1/sqrt(eig)
    Vp = np.linalg.eigh(P_iw)[1]
    err_eig = Vp.T @ err
    sd_eig = 1.0 / np.sqrt(ev)
    rel = np.abs(err_eig) / (np.abs(Vp.T @ mean64) + 1e-300)
    out["f32_mean_err_over_cond_sd"] = [
        round(float(a), 4) for a in (np.abs(err_eig) / sd_eig)
    ]
    print("f32 conditional-mean error / conditional sd per eigdir "
          "(small->large eig):")
    print(np.round(np.abs(err_eig) / sd_eig, 4))

    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
