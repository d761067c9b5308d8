"""Compare our SfM map against the reference binary's map.

The reference baseline is produced by refbaseline/ (the UNMODIFIED
reference sfm compiled headless) and dumped to text by
refbaseline/bin/dump_map.  This script aligns the two trajectories with
the Umeyama closed form and reports ATE-RMSE plus the map-statistics
table.

Usage:
  python scripts/compare_to_reference.py \
      --ref-dump refbaseline/run_v1/map_dump.txt \
      --our-map  refbaseline/run_v1_ours/map.pkl
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from photometric_bundle_adjustment_tpu.io import map_io
from photometric_bundle_adjustment_tpu.utils import evaluation


def parse_ref_dump(path: str):
    cams = {}
    landmarks = 0
    obs = 0
    out_obs = 0
    for line in open(path):
        f = line.split()
        if f[0] == "CAMERA":
            fcid = (int(f[1]), int(f[2]))
            cams[fcid] = np.array([float(x) for x in f[3:10]])
        elif f[0] == "LANDMARK":
            landmarks += 1
            obs += int(f[5])
            out_obs += int(f[6])
    return cams, {"cameras": len(cams), "landmarks": landmarks,
                  "observations": obs, "outlier_obs": out_obs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-dump", required=True)
    ap.add_argument("--our-map", required=True)
    args = ap.parse_args(argv)

    ref_cams, ref_stats = parse_ref_dump(args.ref_dump)
    if args.our_map.endswith(".pkl"):
        import pickle

        with open(args.our_map, "rb") as f:
            blob = pickle.load(f)
        cameras = {f: np.asarray(p) for f, p in blob["cameras"].items()}
        landmarks = blob["landmarks"]
    else:
        cameras, landmarks, tracks, outliers = map_io.load_map(args.our_map)
    our_stats = {
        "cameras": len(cameras),
        "landmarks": len(landmarks),
        "observations": sum(len(lm["obs"]) for lm in landmarks.values()),
        "outlier_obs": sum(
            len(lm["outlier_obs"]) for lm in landmarks.values()
        ),
    }

    shared = sorted(set(ref_cams) & set(cameras))
    ours = np.stack([np.asarray(cameras[f])[:3] for f in shared])
    ref = np.stack([ref_cams[f][:3] for f in shared])
    ate = evaluation.ate_rmse(ours, ref, with_scale=False)
    ate_s = evaluation.ate_rmse(ours, ref, with_scale=True)

    print(f"{'':>16} {'reference':>10} {'ours':>10}")
    for k in ("cameras", "landmarks", "observations", "outlier_obs"):
        print(f"{k:>16} {ref_stats[k]:>10} {our_stats[k]:>10}")
    print(f"shared cameras: {len(shared)}")
    print(f"ATE-RMSE (SE3 align):  {ate * 100:.2f} cm")
    print(f"ATE-RMSE (Sim3 align): {ate_s * 100:.2f} cm")
    extent = ref.max(0) - ref.min(0)
    print(f"trajectory extent (ref): {extent[0]:.1f} x {extent[1]:.1f} x "
          f"{extent[2]:.1f} m")


if __name__ == "__main__":
    main()
