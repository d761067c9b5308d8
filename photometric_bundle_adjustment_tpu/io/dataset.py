"""EuRoC-style dataset loading (timestamps.txt + <timestamp>_<cam>.jpg),
mirroring load_data (src/sfm.cpp:889-931): frame ids are consecutive
integers in timestamp order, images are grayscale uint8 arrays.

A dataset path of the form ``synthetic:<seed>`` loads the seeded
EuRoC-shaped stereo sequence of ``models.synthetic.render_stereo_sequence``
instead of a directory.
"""

from __future__ import annotations

import os

import numpy as np

SYNTHETIC_PREFIX = "synthetic:"


def load_timestamps(dataset_path: str, max_frames: int = 0) -> list[int]:
    out = []
    with open(os.path.join(dataset_path, "timestamps.txt")) as f:
        for line in f:
            tok = line.strip()
            if not tok:
                continue
            try:
                out.append(int(tok))
            except ValueError:
                print(f"Skipping '{tok}' while reading times.")
                continue
            if max_frames > 0 and len(out) >= max_frames:
                break
    return out


def load_images(
    dataset_path: str, max_frames: int = 0, num_cams: int = 2
) -> tuple[dict, list[int]]:
    """Returns ({(frame_id, cam_id): (H, W) uint8 array}, timestamps)."""
    if dataset_path.startswith(SYNTHETIC_PREFIX):
        from photometric_bundle_adjustment_tpu.models import synthetic

        seed = int(dataset_path[len(SYNTHETIC_PREFIX):])
        kwargs = {"n_frames": max_frames} if max_frames > 0 else {}
        images, timestamps, _ = synthetic.render_stereo_sequence(seed, **kwargs)
        return images, timestamps
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading an image directory needs the 'Pillow' package (PIL); "
            "use --dataset-path synthetic:<seed> without it"
        ) from e

    timestamps = load_timestamps(dataset_path, max_frames)
    images = {}
    for fid, ts in enumerate(timestamps):
        for cam in range(num_cams):
            path = os.path.join(dataset_path, f"{ts}_{cam}.jpg")
            with Image.open(path) as im:
                images[(fid, cam)] = np.asarray(im.convert("L"), np.uint8)
    return images, timestamps
