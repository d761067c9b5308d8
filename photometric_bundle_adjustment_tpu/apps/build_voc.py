"""Build a BoW vocabulary from a dataset's images.

The reference only *loads* a prebuilt vocabulary (sfm.cpp:337-340); this
utility closes the loop so the ``--voc-path`` matching mode is usable
without external files:

    python -m photometric_bundle_adjustment_tpu.apps.build_voc \
        --dataset-path data/euroc_V1 --output voc.pkl --max-frames 20
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build BoW vocabulary")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--output", default="voc.pkl")
    parser.add_argument("--max-frames", type=int, default=20)
    parser.add_argument("--branching", type=int, default=10)
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--num-features", type=int, default=1500)
    parser.add_argument("--device", default="cpu", choices=["cpu", "gpu"])
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", args.device)

    from photometric_bundle_adjustment_tpu.utils.runtime import (
        configure_runtime,
    )

    configure_runtime()
    import jax.numpy as jnp
    import numpy as np

    from photometric_bundle_adjustment_tpu.features import bow, describe
    from photometric_bundle_adjustment_tpu.io import dataset

    images, timestamps = dataset.load_images(args.dataset_path, args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")

    descs = []
    for fcid in sorted(images):
        _, valid, _, desc = describe.detect_and_describe(
            jnp.asarray(images[fcid]), num_features=args.num_features
        )
        descs.append(np.asarray(desc)[np.asarray(valid)])
    all_desc = np.concatenate(descs)
    print(f"Collected {len(all_desc)} descriptors from {len(images)} images")

    voc = bow.build_vocabulary(
        all_desc, k=args.branching, levels=args.levels, seed=0
    )
    voc.save(args.output)
    print(f"Built vocabulary with {voc.num_words} words -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
