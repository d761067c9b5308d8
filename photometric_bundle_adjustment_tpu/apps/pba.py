"""Photometric bundle adjustment app (the pba2 capability): run geometric
SfM, then refine the map photometrically with direct intensity-patch
residuals.

    python -m photometric_bundle_adjustment_tpu.apps.pba \
        --dataset-path synthetic:0 \
        --cam-calib refbaseline/artifacts/ref_opt_calib.json
"""

from __future__ import annotations

import argparse
import pickle
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Photometric bundle adjustment")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--cam-calib", default="opt_calib.json")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--show-gui", default="false")
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--map-out", default="map_pba.pkl")
    parser.add_argument(
        "--map-in", default=None,
        help="geometric map pickle (from apps.sfm) to refine directly, "
             "skipping the geometric SfM run (keypoints are re-detected "
             "deterministically to recover the anchor patches)",
    )
    parser.add_argument("--pba-iterations", type=int, default=20)
    parser.add_argument("--huber-intensity", type=float, default=9.0)
    parser.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    parser.add_argument(
        "--distributed", type=int, default=0, metavar="D",
        help="run the photometric solve landmark-sharded over a mesh of D "
             "devices of the backend (parallel/dist_fused.py); an error "
             "when fewer are present.  With --device cpu the mesh is D "
             "virtual host devices.  Runs ONE full-resolution distributed "
             "solve, cross-checks it against the single-device solver, "
             "and writes the distributed solution to --map-out.",
    )
    args = parser.parse_args(argv)

    import os

    if args.device == "cpu" and args.distributed:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.distributed}"
        ).strip()

    import jax

    if args.device:
        jax.config.update("jax_platforms", args.device)

    from photometric_bundle_adjustment_tpu.utils.runtime import (
        configure_runtime,
    )

    configure_runtime()
    if args.distributed > len(jax.devices()):
        parser.error(
            f"--distributed {args.distributed} needs {args.distributed} "
            f"devices; the {jax.default_backend()} backend has "
            f"{len(jax.devices())}"
        )

    from photometric_bundle_adjustment_tpu.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import SfmPipeline

    if not os.path.exists(args.cam_calib):
        parser.error(f"could not load camera calibration {args.cam_calib}")
    images, timestamps = dataset.load_images(args.dataset_path, args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")
    calib = calib_io.load_calibration(args.cam_calib)

    pipe = SfmPipeline(images, calib, SfmConfig(), cache_dir=args.cache_dir)
    t0 = time.time()
    if args.map_in:
        with open(args.map_in, "rb") as f:
            m = pickle.load(f)
        # detection is deterministic, so recomputed corners carry the same
        # feature ids the saved observations reference
        if not pipe._load_cache("corners"):
            pipe.detect_keypoints()
        pipe.load_map(m)
        print(f"Loaded geometric map from {args.map_in}: {pipe.summary()}")
    else:
        pipe.run()
        print(
            f"Geometric SfM done in {time.time() - t0:.1f}s: {pipe.summary()}"
        )
        print("Timings: " + ", ".join(
            f"{k}={v:.2f}" for k, v in sorted(pipe.timings.items())))

    parity = None
    t1 = time.time()
    if args.distributed:
        res, parity = pba_refine.refine_photometric_distributed(
            pipe, n_devices=args.distributed,
            max_iterations=args.pba_iterations,
            huber_delta=args.huber_intensity,
        )
        if parity is not None:
            print(f"Distributed-vs-single parity: {parity}")
    else:
        res = pba_refine.refine_photometric(
            pipe, max_iterations=args.pba_iterations,
            huber_delta=args.huber_intensity,
        )
    print(f"Photometric refinement took {time.time() - t1:.2f}s")

    with open(args.map_out, "wb") as f:
        pickle.dump(
            {
                "cameras": pipe.cameras,
                "affine": getattr(pipe, "photometric_affine", {}),
                "photometric_levels": getattr(pipe, "photometric_levels", []),
                "distributed_parity": parity,
                "landmarks": {
                    t: {"inv_depth": l.inv_depth, "obs": l.obs,
                        "outlier_obs": l.outlier_obs}
                    for t, l in pipe.landmarks.items()
                },
                "timestamps": timestamps,
            },
            f,
        )
    print(f"Saved photometric map as {args.map_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
