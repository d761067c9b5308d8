"""Incremental stereo SfM app (reference: src/sfm.cpp, headless mode).

    python -m photometric_bundle_adjustment_tpu.apps.sfm \
        --dataset-path synthetic:0 \
        --cam-calib refbaseline/artifacts/ref_opt_calib.json --show-gui false

Runs the staged pipeline to completion (next_step loop, sfm.cpp:472-478),
prints the same progress counters the reference emits, and saves the map.
"""

from __future__ import annotations

import argparse
import pickle
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Incremental stereo SfM")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--voc-path", default="")
    parser.add_argument("--cam-calib", default="opt_calib.json")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--show-gui", default="false",
                        help="Accepted for CLI parity; this app is headless.")
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--map-out", default="map.pkl")
    parser.add_argument(
        "--stats-out", default="runs/last_run_stats.json",
        help="write a JSON record of wall time, per-stage timings and "
             "kernel-invocation counters ('' disables); bench.py uses it "
             "to cross-check its frozen workload constants",
    )
    parser.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--optimize-intrinsics", action="store_true",
        help="Refine shared camera intrinsics during BA "
             "(the reference's optimize_intrinsics option)",
    )
    parser.add_argument(
        "--params-file", default=None,
        help="JSON file of SfmConfig overrides, re-read before every "
             "pipeline step — the headless analog of the reference's "
             "live-tunable Pangolin parameter panel (sfm.cpp:197-261)",
    )
    parser.add_argument(
        "--global-init", action="store_true",
        help="Bootstrap all cameras at once by rotation/translation "
             "averaging over the match graph before the incremental loop",
    )
    args = parser.parse_args(argv)

    if str(args.show_gui).lower() in ("true", "1", "yes"):
        print(
            "[sfm] --show-gui requested but this app is headless; ignoring. "
            "Use utils.visualize / apps.evaluate for PNG overlays instead.",
        )

    import jax

    if args.device:
        jax.config.update("jax_platforms", args.device)

    from photometric_bundle_adjustment_tpu.utils.runtime import (
        configure_runtime,
    )

    configure_runtime()

    from photometric_bundle_adjustment_tpu.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import SfmPipeline

    import os

    if not os.path.exists(args.cam_calib):
        parser.error(
            f"could not load camera calibration {args.cam_calib}"
        )
    images, timestamps = dataset.load_images(args.dataset_path, args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")
    calib = calib_io.load_calibration(args.cam_calib)
    print(
        f"Loaded camera from {args.cam_calib} with models "
        + " ".join(calib.cam_types)
    )

    cfg = SfmConfig(
        use_match_bow=bool(args.voc_path),
        ba_optimize_intrinsics=args.optimize_intrinsics,
    )
    pipe = SfmPipeline(images, calib, cfg, cache_dir=args.cache_dir,
                       seed=args.seed, params_file=args.params_file)
    if args.voc_path:
        from photometric_bundle_adjustment_tpu.features import bow

        pipe.bow_voc = bow.BowVocabulary.load(args.voc_path)

    t0 = time.time()
    if args.global_init:
        from photometric_bundle_adjustment_tpu.pipeline import global_init
        from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import Stage

        # detect/match/tracks first, then averaging bootstrap
        while not pipe.tracks and pipe.next_step():
            pass
        global_init.global_initialize(pipe)
        pipe.stage = Stage.OPTIMIZE
    pipe.run()
    wall = time.time() - t0
    print(pipe.summary())
    print(
        "Timings: "
        + ", ".join(f"{k}={v:.2f}" for k, v in sorted(pipe.timings.items()))
        + f", total={wall:.2f}s"
    )

    if args.stats_out:
        # machine-readable run record: bench.py reads it to (a) assert its
        # frozen EUROC_WORKLOAD constants against the real run's kernel
        # counters and (b) emit a keyframes/s estimate that includes the
        # measured host bookkeeping (the device composite alone hides
        # host time)
        import json

        stats = {
            "n_images": len(timestamps) * 2,
            "wall_s": round(wall, 3),
            # device dispatch+fetch wall vs host
            # bookkeeping (everything else: union-find, candidate sorting,
            # Python chunking, outlier removal)
            "device_s": round(pipe.device_seconds, 3),
            "host_s": round(wall - pipe.device_seconds, 3),
            "backend": jax.default_backend(),
            "timings_s": {k: round(v, 3)
                          for k, v in sorted(pipe.timings.items())},
            # same stage keys, wall spent inside device dispatch+fetch
            # blocks only: stage host bookkeeping = timings_s[k] -
            # timings_dev_s[k]
            "timings_dev_s": {k: round(v, 3)
                              for k, v in sorted(pipe.timings_dev.items())},
            "counters": dict(sorted(pipe.counters.items())),
            "summary": pipe.summary(),
        }
        os.makedirs(os.path.dirname(args.stats_out) or ".", exist_ok=True)
        with open(args.stats_out, "w") as f:
            json.dump(stats, f, indent=1)
        print(f"Saved run stats as {args.stats_out}")

    if args.map_out.endswith(".cereal"):
        # reference-native binary map the unmodified reference binary can
        # load (map_utils.h:88-116); byte-format cross-validated against
        # the reference's own serialize adapters (refbaseline/
        # test_cereal_io.cpp)
        from photometric_bundle_adjustment_tpu.io import cereal_io

        cereal_io.export_pipeline_map(pipe, args.map_out)
        n_obs = sum(len(l.obs) for l in pipe.landmarks.values())
        print(
            f"Saved map as {args.map_out} ({len(pipe.cameras)} cameras, "
            f"{len(pipe.landmarks)} landmarks, {n_obs} observations)"
        )
        return 0

    with open(args.map_out, "wb") as f:
        pickle.dump(
            {
                "cameras": pipe.cameras,
                "landmarks": {
                    t: {"inv_depth": l.inv_depth, "obs": l.obs,
                        "outlier_obs": l.outlier_obs}
                    for t, l in pipe.landmarks.items()
                },
                "tracks": pipe.tracks,
                "outlier_tracks": pipe.outlier_tracks,
                "timestamps": timestamps,
            },
            f,
        )
    n_obs = sum(len(l.obs) for l in pipe.landmarks.values())
    print(
        f"Saved map as {args.map_out} ({len(pipe.cameras)} cameras, "
        f"{len(pipe.landmarks)} landmarks, {n_obs} observations)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
