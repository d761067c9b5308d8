"""Photometric-BA value curve: an init-degradation ladder.

The flagship capability's accuracy claim rested on one favorable case
(round 3: a 2.75 cm geometric init pulled to 1.69 cm).  This script
characterizes WHERE photometric refinement helps and by how much: the
round-5 geometric map's poses are perturbed with increasing noise
(0 / 2 / 5 / 10 / 20 cm translation + proportional rotation), the
photometric stage refines each rung, and both trajectories are scored
against the reference binary's own trajectory
(refbaseline/artifacts/run_v1_trajectory.txt), plus the stereo-baseline
consistency metric (calibrated 0.1100 m).

Usage:
    python scripts/pba_value_curve.py [--map runs/map_r5_run12.pkl]
        [--rungs 0,0.02,0.05,0.10,0.20] [--out runs/value_curve.json]
"""

import argparse
import json
import pickle
import subprocess
import sys

import numpy as np


def perturb_cameras(cameras: dict, sigma_t: float, seed: int = 0):
    """Gaussian pose noise: sigma_t meters of translation and
    (sigma_t * 10) rad of axis-angle rotation per meter scale (e.g. 5 cm
    -> ~0.5 deg) on every non-gauge camera."""
    from photometric_bundle_adjustment_tpu.core import se3
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    out = {}
    sigma_r = sigma_t * 0.1745  # ~10 deg per meter of translation noise
    for f, T in cameras.items():
        T = np.asarray(T, np.float64)
        if f in [(0, 0), (0, 1)] or sigma_t == 0.0:
            out[f] = T
            continue
        d = np.concatenate([
            rng.normal(0, sigma_t, 3), rng.normal(0, sigma_r, 3)
        ])
        out[f] = np.asarray(se3.right_plus(jnp.asarray(T), jnp.asarray(d)))
    return out


def stereo_baseline_stats(cameras: dict):
    from photometric_bundle_adjustment_tpu.apps.evaluate import (
        _stereo_baselines,
    )

    bl = _stereo_baselines(cameras)
    if not len(bl):
        return None
    return float(np.median(bl)), float(np.std(bl))


def score_ate(map_path: str):
    out = subprocess.run(
        [sys.executable, "scripts/compare_to_reference.py",
         "--ref-dump", "refbaseline/artifacts/run_v1_trajectory.txt",
         "--our-map", map_path],
        capture_output=True, text=True, timeout=600,
    )
    import re

    se3_m = re.search(r"SE3 align\):\s+([0-9.]+) cm", out.stdout)
    sim3_m = re.search(r"Sim3 align\):\s+([0-9.]+) cm", out.stdout)
    return (float(se3_m.group(1)) if se3_m else float("nan"),
            float(sim3_m.group(1)) if sim3_m else float("nan"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="runs/map_r5_run12.pkl")
    ap.add_argument("--dataset-path", default="/root/reference/data/euroc_V1")
    ap.add_argument("--cam-calib",
                    default="refbaseline/artifacts/ref_opt_calib.json")
    ap.add_argument("--rungs", default="0,0.02,0.05,0.10,0.20")
    ap.add_argument("--out", default="runs/value_curve.json")
    ap.add_argument("--cache-dir", default="runs/cache_r5")
    args = ap.parse_args()

    from photometric_bundle_adjustment_tpu.utils.runtime import (
        configure_runtime,
    )

    configure_runtime()

    from photometric_bundle_adjustment_tpu.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        Landmark, SfmPipeline,
    )

    images, timestamps = dataset.load_images(args.dataset_path, 0)
    calib = calib_io.load_calibration(args.cam_calib)
    with open(args.map, "rb") as f:
        m = pickle.load(f)

    rungs = [float(x) for x in args.rungs.split(",")]
    rows = []
    for sigma in rungs:
        pipe = SfmPipeline(images, calib, SfmConfig(),
                           cache_dir=args.cache_dir)
        if not pipe._load_cache("corners"):
            pipe.detect_keypoints()
        pipe.cameras = perturb_cameras(dict(m["cameras"]), sigma)
        pipe.tracks = dict(m.get("tracks", {}))
        pipe.landmarks = {
            t: Landmark(d["inv_depth"], dict(d["obs"]),
                        dict(d.get("outlier_obs", {})))
            if isinstance(d, dict) else d
            for t, d in m["landmarks"].items()
        }

        # score the degraded init
        init_path = f"runs/vc_init_{int(sigma * 1000)}mm.pkl"
        with open(init_path, "wb") as f:
            pickle.dump({"cameras": pipe.cameras, "landmarks": {
                t: {"inv_depth": l.inv_depth, "obs": l.obs,
                    "outlier_obs": l.outlier_obs}
                for t, l in pipe.landmarks.items()
            }, "timestamps": timestamps}, f)
        ate0 = score_ate(init_path)
        bl0 = stereo_baseline_stats(pipe.cameras)

        res = pba_refine.refine_photometric(
            pipe, max_iterations=20, huber_delta=9.0,
        )
        ref_path = f"runs/vc_pba_{int(sigma * 1000)}mm.pkl"
        with open(ref_path, "wb") as f:
            pickle.dump({"cameras": pipe.cameras, "landmarks": {
                t: {"inv_depth": l.inv_depth, "obs": l.obs,
                    "outlier_obs": l.outlier_obs}
                for t, l in pipe.landmarks.items()
            }, "timestamps": timestamps}, f)
        ate1 = score_ate(ref_path)
        bl1 = stereo_baseline_stats(pipe.cameras)
        row = {
            "sigma_cm": sigma * 100,
            "ate_init_se3_cm": ate0[0], "ate_init_sim3_cm": ate0[1],
            "ate_pba_se3_cm": ate1[0], "ate_pba_sim3_cm": ate1[1],
            "baseline_init_m": bl0, "baseline_pba_m": bl1,
            "cost": float(res.cost), "initial_cost": float(res.initial_cost),
            "iterations": int(res.iterations),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    with open(args.out, "w") as f:
        json.dump({"map": args.map, "rows": rows}, f,
                  indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
