"""photometric_bundle_adjustment_tpu — an SfM + photometric bundle adjustment engine in JAX.

A JAX/XLA framework with the capabilities of the reference
C++/Ceres/OpenGV stereo SfM + photometric-BA pipeline
(burakcuhadar/Photometric-Bundle-Adjustment), re-designed around batched
device computation:

- ``core``      batched SE3/SO3 Lie groups and the four camera models
                (pinhole / eucm / ds / kb4) on uniform (8,) parameter vectors.
- ``optim``     damped Levenberg-Marquardt on manifolds + the Schur-complement
                bundle-adjustment solver (scalar inverse-depth landmark blocks).
- ``ops``       the plane-layout geometric BA build (``geo_mega``).
- ``features``  feature detection / description / matching / RANSAC /
                triangulation / BoW place recognition.
- ``models``    the optimisation problem families: calibration NLLS, geometric
                (reprojection) BA, photometric BA, pose-graph averaging.
- ``pipeline``  the host-side incremental SfM state machine (tracks,
                candidates, outlier policy) mirroring the reference driver.
- ``parallel``  mesh/sharding layer: landmark-sharded distributed BA over
                device collectives, ring all-pairs matching.
- ``io``        dataset loading, calibration JSON (reference-compatible field
                names), stage caches.
"""

__version__ = "0.1.0"

from photometric_bundle_adjustment_tpu.core import se3, cameras  # noqa: F401
