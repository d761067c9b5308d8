"""Binary-cereal interop: schema round-trips and descriptor bit order.

Byte-level cross-validation against the ACTUAL reference headers (a C++
harness that links cereal/Eigen/Sophus and calls the reference's own
serialize() adapters) lives in refbaseline/test_cereal_io.cpp and is run
out-of-band — the CI suite covers the
pure-Python round trip and the bit-layout invariants.
"""

import numpy as np
import pytest

from photometric_bundle_adjustment_tpu.io import cereal_io as cio


def _rand_map(rng):
    corners = {}
    for fcid in [(0, 0), (0, 1), (3, 0)]:
        n = int(rng.integers(1, 6))
        corners[fcid] = {
            "uv": rng.uniform(0, 700, (n, 2)),
            "angles": rng.uniform(-3, 3, n),
            "descriptors": rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        }
    matches = {
        ((0, 0), (0, 1)): {
            "T_i_j": np.array([0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0]),
            "inliers": rng.integers(0, 5, (3, 2)).astype(np.int32),
            "matches": rng.integers(0, 5, (4, 2)).astype(np.int32),
        },
    }
    tracks = {7: {(0, 0): 1, (0, 1): 2}, 9: {(3, 0): 0}}
    outliers = {11: {(0, 0): 3}}
    cameras = {fcid: np.array([0.0, 0.1, 0.2, 0.0, 0.0, 0.0, 1.0])
               for fcid in corners}
    landmarks = {
        7: {"inv_depth": 0.25, "obs": {(0, 0): 1, (0, 1): 2},
            "outlier_obs": {}},
        9: {"inv_depth": 1.5, "obs": {(3, 0): 0}, "outlier_obs": {(0, 0): 4}},
    }
    return corners, matches, tracks, outliers, cameras, landmarks


def test_map_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    parts = _rand_map(rng)
    path = str(tmp_path / "map.cereal")
    cio.save_map_cereal(path, *parts)
    out = cio.load_map_cereal(path)
    corners, matches, tracks, outliers, cameras, landmarks = parts
    for fcid, kp in corners.items():
        np.testing.assert_allclose(out["corners"][fcid]["uv"], kp["uv"])
        np.testing.assert_allclose(out["corners"][fcid]["angles"],
                                   kp["angles"])
        np.testing.assert_array_equal(
            out["corners"][fcid]["descriptors"], kp["descriptors"])
    key = ((0, 0), (0, 1))
    np.testing.assert_allclose(out["matches"][key]["T_i_j"],
                               matches[key]["T_i_j"])
    np.testing.assert_array_equal(out["matches"][key]["inliers"],
                                  matches[key]["inliers"])
    assert out["feature_tracks"] == tracks
    assert out["outlier_tracks"] == outliers
    for fcid in cameras:
        np.testing.assert_allclose(out["cameras"][fcid], cameras[fcid])
    assert out["landmarks"][9]["outlier_obs"] == {(0, 0): 4}
    assert out["landmarks"][7]["inv_depth"] == 0.25


def test_corners_and_matches_caches_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    corners, matches, *_ = _rand_map(rng)
    p1 = str(tmp_path / "corners.cereal")
    cio.save_corners_cereal(p1, corners)
    out = cio.load_corners_cereal(p1)
    assert set(out) == set(corners)
    p2 = str(tmp_path / "matches.cereal")
    cio.save_matches_cereal(p2, matches)
    out2 = cio.load_matches_cereal(p2)
    assert set(out2) == set(matches)


def test_bitset_bit_order():
    """bit i of the bitset must be bit (7 - i%8) of byte i//8, and our
    packed words store bit 32*w + d at (word[w] >> d) & 1."""
    words = np.zeros(8, np.uint32)
    words[0] = 1          # bitset bit 0 -> byte 0, mask 0x80
    b = cio._words_to_bitset_bytes(words)
    assert b[0] == 0x80 and all(x == 0 for x in b[1:])
    words = np.zeros(8, np.uint32)
    words[1] = 1 << 5     # bitset bit 37 -> byte 4, bit (7 - 5) -> 0x04
    b = cio._words_to_bitset_bytes(words)
    assert b[4] == 0x04
    # round trip is the identity permutation
    rng = np.random.default_rng(2)
    for _ in range(5):
        w = rng.integers(0, 2**32, 8, dtype=np.uint32)
        assert np.array_equal(
            cio._bitset_bytes_to_words(cio._words_to_bitset_bytes(w)), w)


def test_bow_vocabulary_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    nodes = []
    for i in range(5):
        nodes.append({
            "id": i, "weight": float(rng.uniform()),
            "children": [int(c) for c in rng.integers(0, 5, i % 3)],
            "parent": max(0, i - 1),
            "descriptor": rng.integers(0, 2**32, 8, dtype=np.uint32),
            "word_id": i,
        })
    path = str(tmp_path / "voc.cereal")
    cio.save_bow_vocabulary_cereal(path, 2, 3, nodes)
    k, L, out = cio.load_bow_vocabulary_cereal(path)
    assert (k, L) == (2, 3)
    assert len(out) == 5
    for a, b in zip(nodes, out):
        assert a["id"] == b["id"] and a["children"] == b["children"]
        np.testing.assert_array_equal(a["descriptor"], b["descriptor"])
        assert a["weight"] == pytest.approx(b["weight"])


def test_bow_vocabulary_cereal_load_matches_native(tmp_path):
    """A vocabulary exported in the reference's cereal schema loads back
    through BowVocabulary.load_cereal with identical word assignments."""
    from photometric_bundle_adjustment_tpu.features import bow

    rng = np.random.default_rng(4)
    desc = rng.integers(0, 2**32, (200, 8), dtype=np.uint32)
    voc = bow.build_vocabulary(desc, k=3, levels=3, seed=0)
    # export in reference node schema: node order preserved
    nodes = []
    for i in range(voc.centroids.shape[0]):
        nodes.append({
            "id": i, "weight": 1.0, "children": list(voc.children[i]),
            "parent": 0, "descriptor": voc.centroids[i],
            "word_id": max(int(voc.leaf_word[i]), 0),
        })
    path = str(tmp_path / "voc.cereal")
    cio.save_bow_vocabulary_cereal(path, 3, 3, nodes)
    voc2 = bow.BowVocabulary.load(path)
    np.testing.assert_array_equal(voc.centroids, voc2.centroids)
    q = rng.integers(0, 2**32, (50, 8), dtype=np.uint32)
    np.testing.assert_array_equal(voc.word_ids(q), voc2.word_ids(q))


def test_export_pipeline_map(tmp_path):
    """export_pipeline_map trims padded corner slots and writes a map the
    reader round-trips (the apps.sfm --map-out map.cereal path)."""

    class _LM:
        def __init__(self, rho, obs, out):
            self.inv_depth, self.obs, self.outlier_obs = rho, obs, out

    class _Pipe:
        pass

    rng = np.random.default_rng(5)
    pipe = _Pipe()
    pipe.corners = {
        (0, 0): {
            "uv": rng.uniform(0, 700, (6, 2)).astype(np.float32),
            "valid": np.array([1, 1, 1, 0, 0, 0], bool),
            "angles": rng.uniform(-3, 3, 6).astype(np.float32),
            "desc": rng.integers(0, 2**32, (6, 8), dtype=np.uint32),
        },
    }
    pipe.matches = {((0, 0), (0, 1)): {
        "T_i_j": np.array([0, 0, 0, 0, 0, 0, 1.0]),
        "matches": np.array([[0, 1]], np.int32),
        "inliers": np.array([[0, 1]], np.int32),
    }}
    pipe.tracks = {3: {(0, 0): 1}}
    pipe.outlier_tracks = {}
    pipe.cameras = {(0, 0): np.array([1, 2, 3, 0, 0, 0, 1.0])}
    pipe.landmarks = {3: _LM(0.5, {(0, 0): 1}, {})}

    path = str(tmp_path / "map.cereal")
    cio.export_pipeline_map(pipe, path)
    out = cio.load_map_cereal(path)
    assert out["corners"][(0, 0)]["uv"].shape == (3, 2)  # padded slots cut
    assert out["landmarks"][3]["inv_depth"] == 0.5
    assert out["cameras"][(0, 0)][0] == 1.0


def test_bow_db_json_golden_and_round_trip(tmp_path):
    """The BowDatabase inverted-index JSON format (bow_db.h:99-124):
    load the golden file written by the reference's own
    cereal::JSONOutputArchive (refbaseline/bow_db_golden.cpp), check the
    exact postings, and verify our writer round-trips through both our
    reader and structural JSON equality."""
    import json
    import os

    from photometric_bundle_adjustment_tpu.features.bow import BowDatabase
    from photometric_bundle_adjustment_tpu.io import cereal_io

    golden = os.path.join(
        os.path.dirname(__file__), "..", "refbaseline", "artifacts",
        "bow_db_golden.json",
    )
    idx = cereal_io.load_bow_db_json(golden)
    assert idx[3] == [((0, 0), 0.25), ((1, 1), 0.125)]
    assert idx[17] == [((2, 0), 0.0625)]
    assert idx[123456] == [((41, 0), 0.5), ((41, 1), 0.03125),
                           ((7, 0), 1.0)]

    # writer round-trip through BowDatabase.save/load
    db = BowDatabase(200000)
    db.index = idx
    out = tmp_path / "db.json"
    db.save(str(out))
    db2 = BowDatabase(200000)
    db2.load(str(out))
    assert db2.index == idx

    # structural equality with the reference's own bytes (item order in
    # the unordered_map is container-dependent, so compare as sets)
    ours = json.load(open(out))
    ref = json.load(open(golden))
    key = lambda item: item["key"]
    assert sorted(ours["value0"], key=key) == sorted(ref["value0"], key=key)

    # a loaded database must keep scoring: query for an inserted vector
    res = db2.query({3: 0.25}, 5)
    assert res and res[0][0] == (0, 0)
