"""The port's feature detector (backend/features.py) against OpenCV's
ORB, and its numpy vocabulary and database against the JAX package's.

The detector is the port's own PyTorch ORB; OpenCV is the reference it
follows (cv2 is installed here, not on the card's machine):
- rgb_to_gray equals cv2.cvtColor(COLOR_RGB2GRAY) bit for bit;
- the level-0 FAST corners (threshold 12, non-maximum suppression) have
  a Jaccard index >= 0.95 against cv2.FastFeatureDetector_create(12, True);
- >= 70 % of cv2 ORB's octave-0 keypoints have a port keypoint within
  1 px whose angle is within 5 degrees;
- on a pair 2 cm / 2 degrees apart, the port's ratio-test matches that
  agree with the known motion to 3 px number >= 0.7 times cv2's.
The BRIEF pattern is the port's own, so descriptors are compared only
through what they match. The numpy copies (hamming_dist, match_ratio,
Vocabulary, BowDatabase) are exact against the JAX package's."""

import cv2
import numpy as np
import pytest
import torch

import kintinuous_tpu.backend.features as J
import kintinuous_tpu_torch.backend.features as F
from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.io import synth as S

torch.set_num_threads(2)


def cam_at(w, h):
    f = 528.0 * w / 640
    return CameraIntrinsics(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)


LAP = S.lap_trajectory(length=3.2, depth=2.4, step=0.055, turn_frames=26, warmup_frames=10)
SCENE = S.lap_scene(3.2, 2.4)


def lap_frame(i, w=320, h=240, T=None):
    return S.render_frame(SCENE, cam_at(w, h), LAP[i] if T is None else T, 6.0,
                          np.random.default_rng(7))


def rot_y(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def test_rgb_to_gray_is_opencv_bit_for_bit():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for img in (rgb, lap_frame(30, 160, 128)[1]):
        g = F.rgb_to_gray(torch.from_numpy(img))
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    # all 2^24 colours
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    np.testing.assert_array_equal(F.rgb_to_gray(img).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("frame", [20, 150, 250, 380])
def test_fast_corners_match_opencv(frame):
    """Jaccard index of the level-0 FAST set >= 0.95 (measured: 1.0 on
    these frames, with equal scores)."""
    gray = cv2.cvtColor(lap_frame(frame)[1], cv2.COLOR_RGB2GRAY)
    ref = {(int(k.pt[0]), int(k.pt[1])): k.response
           for k in cv2.FastFeatureDetector_create(12, True).detect(gray)}
    mine = {tuple(p) for p in F.fast_detect(torch.from_numpy(gray)).tolist()}
    a, b = set(ref), mine
    assert len(a) > 10
    assert len(a & b) / len(a | b) >= 0.95
    score = F.fast_scores(torch.from_numpy(gray))
    same = sum(score[y, x].item() == ref[(x, y)] for x, y in a & b)
    assert same >= 0.95 * len(a & b)


@pytest.mark.parametrize("frame,size", [(20, (640, 480)), (60, (320, 240)),
                                        (150, (320, 240)), (250, (160, 128))])
def test_orb_octave0_keypoints_match_opencv(frame, size):
    """>= 70 % of cv2's octave-0 keypoints within 1 px of a port keypoint
    with the angle within 5 degrees (measured: 100 % on these frames)."""
    gray = cv2.cvtColor(lap_frame(frame, *size)[1], cv2.COLOR_RGB2GRAY)
    ck = [k for k in cv2.ORB_create(nfeatures=500, fastThreshold=12).detect(gray)
          if k.octave == 0]
    kp = F.orb_keypoints(torch.from_numpy(gray))
    pts = kp["pts"].numpy()[kp["octave"].numpy() == 0]
    ang = kp["angle"].numpy()[kp["octave"].numpy() == 0]
    assert len(ck) >= 5
    ok = 0
    for k in ck:
        d = np.linalg.norm(pts - np.array(k.pt), axis=1)
        j = int(d.argmin())
        ok += d[j] <= 1.0 and abs((ang[j] - k.angle + 180.0) % 360.0 - 180.0) <= 5.0
    assert ok >= 0.7 * len(ck)
    # the whole detector's output: <= 500 keypoints in level-0 pixels
    p, desc = F.detect_orb(torch.from_numpy(gray))
    assert p.dtype == np.float32 and p.shape[1] == 2 and desc.dtype == np.uint8
    assert desc.shape == (len(p), 32) and 0 < len(p) <= 500
    assert (p[:, 0] < size[0]).all() and (p[:, 1] < size[1]).all()


def test_level_layout_shares_features_like_opencv():
    """Level sizes and feature counts: a textured image gives cv2's
    per-level counts, which its geometric series sets."""
    lay = F.level_layout(640, 480, 500)
    assert [(w, h) for _, w, h, _ in lay][:3] == [(640, 480), (533, 400), (444, 333)]
    assert [n for *_, n in lay] == [109, 90, 75, 63, 52, 44, 36, 31]
    gray = cv2.cvtColor(lap_frame(20, 640, 480)[1], cv2.COLOR_RGB2GRAY)
    ref = np.bincount([k.octave for k in cv2.ORB_create(
        nfeatures=500, fastThreshold=12).detect(gray)], minlength=8)
    mine = np.bincount(F.orb_keypoints(torch.from_numpy(gray))["octave"].numpy(), minlength=8)
    np.testing.assert_array_equal(mine, ref)


def _motion_inliers(cam, depth_a, Ta, Tb, ka, kb, pairs):
    n = 0
    for i, j in pairs:
        u, v = ka[i]
        z = depth_a[int(round(v)), int(round(u))] / 1000.0
        if z <= 0:
            continue
        p = np.array([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z, 1.0])
        q = np.linalg.inv(Tb) @ Ta @ p
        n += np.hypot(q[0] / q[2] * cam.fx + cam.cx - kb[j][0],
                      q[1] / q[2] * cam.fy + cam.cy - kb[j][1]) <= 3.0
    return n


@pytest.mark.parametrize("frame", [20, 150, 250])
def test_matches_on_a_close_pair_rival_opencv(frame):
    """A pair 2 cm / 2 degrees apart: the port's ratio-test matches that
    agree with the known motion to 3 px number >= 0.7 x cv2's
    (measured: 0.86-1.05 at 160x128 to 640x480)."""
    cam = cam_at(320, 240)
    Ta = LAP[frame]
    Tb = Ta.copy()
    Tb[:3, :3] = Ta[:3, :3] @ rot_y(np.deg2rad(2.0))
    Tb[:3, 3] += Ta[:3, :3] @ np.array([0.02, 0.0, 0.0])
    da, ra = S.render_frame(SCENE, cam, Ta)
    _, rb = S.render_frame(SCENE, cam, Tb)
    orb = cv2.ORB_create(nfeatures=500, fastThreshold=12)
    ca, dA = orb.detectAndCompute(cv2.cvtColor(ra, cv2.COLOR_RGB2GRAY), None)
    cb, dB = orb.detectAndCompute(cv2.cvtColor(rb, cv2.COLOR_RGB2GRAY), None)
    n_cv = _motion_inliers(cam, da, Ta, Tb, [k.pt for k in ca], [k.pt for k in cb],
                           F.match_ratio(dA, dB))
    pa, qa = F.detect_orb(F.rgb_to_gray(ra))
    pb, qb = F.detect_orb(F.rgb_to_gray(rb))
    n_port = _motion_inliers(cam, da, Ta, Tb, pa, pb, F.match_ratio(qa, qb))
    assert n_cv > 10
    assert n_port >= 0.7 * n_cv


def test_descriptors_self_match_and_pattern():
    pat = np.array(F._BRIEF_PATTERN).reshape(-1, 2)
    assert pat.shape == (512, 2) and np.abs(pat).max() <= 13
    _, rgb = lap_frame(20, 160, 128)
    kps, desc = F.detect_orb(F.rgb_to_gray(rgb))
    assert len(kps) > 50
    pairs = F.match_ratio(desc, desc)
    assert (pairs[:, 0] == pairs[:, 1]).mean() > 0.9


def _descs(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


def test_hamming_and_ratio_matching_are_the_jax_functions():
    a, b = _descs(0, 70), _descs(1, 90)
    b[:30] = a[:30] ^ (_descs(2, 30) & 1)  # near copies
    np.testing.assert_array_equal(F.hamming_dist(a, b), J.hamming_dist(a, b))
    for r in (0.7, 0.9):
        np.testing.assert_array_equal(F.match_ratio(a, b, r), J.match_ratio(a, b, r))
    assert F.match_ratio(a[:0], b).shape == (0, 2)
    np.testing.assert_array_equal(F.match_ratio(a, b[:1]), J.match_ratio(a, b[:1]))


@pytest.mark.parametrize("k,iters,seed", [(32, 4, 0), (64, 8, 3), (600, 2, 1)])
def test_vocabulary_training_is_the_jax_training(k, iters, seed, tmp_path):
    desc = _descs(5, 400)
    v, w = F.Vocabulary.train(desc, k, iters, seed), J.Vocabulary.train(desc, k, iters, seed)
    np.testing.assert_array_equal(v.centroids, w.centroids)
    np.testing.assert_array_equal(v.quantise(desc), w.quantise(desc))
    v.save(str(tmp_path / "v.npy"))
    u = J.Vocabulary.load(str(tmp_path / "v.npy"))
    np.testing.assert_array_equal(u.centroids, v.centroids)
    assert F.Vocabulary.train(desc[:0]).k == 1


def test_bow_database_is_the_jax_database():
    base = _descs(1, 600)
    vocab = F.Vocabulary.train(base, k=64, iters=4)
    dbs = (F.BowDatabase(vocab), J.BowDatabase(J.Vocabulary(vocab.centroids)))
    rng = np.random.default_rng(9)
    places = [base[i * 100:(i + 1) * 100] for i in range(6)]
    for p in places:
        q = p.copy()
        q[:15] = rng.integers(0, 256, (15, 32), dtype=np.uint8)
        words = vocab.quantise(q)
        res = [db.query(words, exclude_after=len(db.vectors)) for db in dbs]
        assert res[0] == res[1]
        for db in dbs:
            db.add(vocab.quantise(p))
    assert dbs[0].vectors == dbs[1].vectors
    np.testing.assert_array_equal(dbs[0].doc_freq, dbs[1].doc_freq)
    assert dbs[0].query(vocab.quantise(places[0]), exclude_after=6)[0] == 0


def test_train_vocab_from_klg(tmp_path):
    """The vocabulary-training mode on a small log with colour, the
    detector on the CPU."""
    cam = cam_at(160, 128)
    log = str(tmp_path / "v.klg")
    S.generate_klg(log, cam, LAP[:40:4], scene=SCENE, color=True)
    v = F.train_vocab_from_klg(log, str(tmp_path / "vocab.npy"), k=32, frame_stride=2,
                               width=160, height=128, device="cpu")
    assert v.k == 32 and v.centroids.dtype == np.uint8
    np.testing.assert_array_equal(np.load(tmp_path / "vocab.npy"), v.centroids)
