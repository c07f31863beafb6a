"""Post-fit analysis of the Heavy-metals workload.

Mirrors the analysis outputs of the reference's Heavy_metals/Results_analysis.R:
- Gelman-Rubin-Brooks R-hat trajectories vs iteration (:17-60)
- covariance estimates with ranges scaled by the Earth radius (:133-142)
- a gridded US prediction map of the latent field (:150-197; matplotlib
  replaces the reference's sp/maps/rgdal stack — engine-external plotting,
  SURVEY.md §2b N12)
- fixed-effect (pollution covariate) surfaces (:200-226)

The reference's 5-km covariate grids (Heavy_metals/usgrids5km/*.asc,
Results_analysis.R:155-162) are not shipped in the reference repo, so the
fixed-effect surfaces are evaluated at the 64,274 observation sites (where
the fitted covariate values exist) instead of on the unavailable grid.

Run after examples/heavy_metals.py with --save fit.pkl:
  PYTHONPATH=. python examples/heavy_metals_analysis.py fit.pkl [grid_deg] [outdir]
"""

import os
import sys
import time

import numpy as np

import nngp_tpu

EARTH_RADIUS_KM = 6371.0


def main(path, grid_deg=0.25, outdir="."):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)

    def savefig(fig, name):
        p = os.path.join(outdir, name)
        fig.savefig(p, dpi=120)
        print(f"wrote {p}", flush=True)

    mc = nngp_tpu.load(path)

    # --- R-hat vs iteration (Results_analysis.R:17-60) ---
    grbs = mc.diagnostics["Gelman_Rubin_Brooks"]
    if grbs:
        names = grbs[0]["names"]
        iters = np.linspace(
            mc.iterations / len(grbs), mc.iterations, len(grbs)
        )
        fig, ax = plt.subplots(figsize=(7, 4))
        for j, nm in enumerate(names):
            ax.plot(iters, [g["R_hat"][j] for g in grbs], label=nm, lw=1)
        ax.axhline(1.05, color="k", ls="--", lw=0.8)
        ax.set_xlabel("iteration")
        ax.set_ylabel("R-hat")
        ax.set_yscale("log")
        ax.legend(fontsize=7)
        fig.tight_layout()
        savefig(fig, "hm_grb_trajectories.png")

    # --- estimates (Results_analysis.R:133-142) ---
    est = nngp_tpu.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    print("covariance estimates (range scaled to km):")
    for nm, row in zip(gp["names"], gp["table"]):
        s = EARTH_RADIUS_KM if nm == "range" else 1.0
        print(f"  {nm:16s} {row[0]*s:10.3f}  [{row[1]*s:10.3f}, {row[3]*s:10.3f}]")

    # --- gridded prediction map (Results_analysis.R:150-197): posterior
    # mean and sd of the latent field on a regular lon/lat grid clipped to
    # cells near an observation (the reference clips to the US polygon;
    # without the geo stack, "within ~1 deg of a site" is the same effect)
    lon = np.arange(-125, -66, grid_deg)
    lat = np.arange(25, 50, grid_deg)
    grid = np.stack(
        [np.meshgrid(lon, lat)[0].ravel(), np.meshgrid(lon, lat)[1].ravel()],
        axis=-1,
    )
    obs = mc.observed_locs
    cell = np.round(obs / 1.0).astype(np.int64)
    occupied = set(map(tuple, cell))
    near = np.array(
        [tuple(c) in occupied for c in np.round(grid / 1.0).astype(np.int64)]
    )
    grid_us = grid[near]
    print(f"predicting latent field at {len(grid_us)} grid sites "
          f"({grid_deg} deg spacing) from "
          f"{int((mc.records[0]['saved_field'] > 0.5 * mc.iterations).sum())}"
          f" retained samples x {mc.n_chains} chains ...")
    t0 = time.time()
    pred = nngp_tpu.predict_field(mc, grid_us, burn_in=0.5, m=8)
    print(f"predict_field: {time.time() - t0:.1f}s")
    tab = pred["predicted_field_summary"]["table"]
    for stat, col, cmap in (("mean", 0, "viridis"), ("sd", 4, "magma")):
        full = np.full(len(grid), np.nan)
        full[near] = tab[:, col]
        img = full.reshape(len(lat), len(lon))
        fig, ax = plt.subplots(figsize=(9, 5))
        im = ax.pcolormesh(lon, lat, img, shading="auto", cmap=cmap)
        ax.scatter(obs[::100, 0], obs[::100, 1], s=0.3, c="k", alpha=0.25)
        fig.colorbar(im, label=f"posterior {stat} latent field")
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        fig.tight_layout()
        savefig(fig, f"hm_prediction_{stat}.png")

    # --- pollution fixed-effect surfaces (Results_analysis.R:200-226):
    # dairp + dTRI joint contribution, evaluated at the observation sites
    # (the reference's 5-km covariate grids are not shipped)
    from nngp_tpu.utils.datasets import load_heavy_metals

    _, _, X = load_heavy_metals()
    pol_names = [nm for nm in ("dairp", "dTRI") if nm in X]
    if pol_names:
        Xp = {nm: np.asarray(X[nm]) for nm in pol_names}
        pfe = nngp_tpu.predict_fixed_effects(
            mc, Xp, burn_in=0.5, add_intercept=False
        )
        ptab = pfe["predicted_fixed_effects_summary"]["table"]
        for stat, col, cmap in (("mean", 0, "coolwarm"), ("sd", 4, "magma")):
            fig, ax = plt.subplots(figsize=(9, 5))
            sc = ax.scatter(obs[:, 0], obs[:, 1], c=ptab[:, col], s=1.2,
                            cmap=cmap, linewidths=0)
            fig.colorbar(
                sc, label=f"pollution effect ({'+'.join(pol_names)}) {stat}"
            )
            ax.set_xlabel("longitude")
            ax.set_ylabel("latitude")
            fig.tight_layout()
            savefig(fig, f"hm_pollution_effect_{stat}.png")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "hm_fit.pkl",
         float(sys.argv[2]) if len(sys.argv) > 2 else 0.25,
         sys.argv[3] if len(sys.argv) > 3 else ".")
