"""A cell's frames: its traffic's trajectory rendered through the sensor
model on the card from the run's seed, each unique frame encoded once as
a `.klg` frame is (depth zlib level 1, colour JPEG quality 90, as
kintinuous_tpu_torch/io/live.py sends them), and decoded again for the
reference exactly as the program's reader decodes them (zlib, OpenCV)."""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from slambench.scenes import render
from slambench.scenes.trajectories import TRAJECTORIES

ENCODE_THREADS = 6


def camera_of(config: dict) -> render.Camera:
    c = config["settings"]["camera"]
    return render.Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]),
                         int(c["width"]), int(c["height"]))


def _cv2():
    import cv2  # the card machine's JPEG codec, as the program's reader's

    return cv2


def encode(depth: np.ndarray, rgb: np.ndarray) -> Tuple[bytes, bytes]:
    cv2 = _cv2()
    ok, jpg = cv2.imencode(".jpg", np.ascontiguousarray(rgb[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    if not ok:
        raise RuntimeError("JPEG encoding failed")
    return zlib.compress(depth.astype("<u2").tobytes(), 1), jpg.tobytes()


def decode(dbuf: bytes, cbuf: bytes, width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    cv2 = _cv2()
    depth = np.frombuffer(zlib.decompress(dbuf), dtype="<u2").reshape(height, width)
    bgr = cv2.imdecode(np.frombuffer(cbuf, dtype=np.uint8), cv2.IMREAD_COLOR)
    return depth, np.ascontiguousarray(bgr[:, :, ::-1])


@dataclass
class FrameSet:
    """The unique frames of a traffic mix; the stream repeats them."""

    encoded: List[Tuple[bytes, bytes]]  # (zlib depth, JPEG colour) a frame
    poses: List[np.ndarray]  # ground truth, camera to world
    width: int
    height: int

    def __len__(self) -> int:
        return len(self.encoded)

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stream frame i (depth uint16 mm, rgb uint8), decoded."""
        return decode(*self.encoded[i % len(self.encoded)], self.width, self.height)

    def stream_bytes(self, n: int) -> int:
        """Bytes of a `.klg` log of the first n stream frames: the 4-byte
        count, and each frame with its 16-byte header."""
        sizes = [len(d) + len(c) + 16 for d, c in self.encoded]
        whole, part = divmod(n, len(sizes))
        return 4 + whole * sum(sizes) + sum(sizes[:part])


def make_frames(traffic: dict, cam: render.Camera, seed: int, device) -> FrameSet:
    traj = traffic["trajectory"]
    poses = TRAJECTORIES[traj["kind"]](**traj.get("args", {}))
    scene = render.load_scene(traffic["scene"], device)
    model = render.SensorModel.from_dict(traffic.get("sensor", {}))
    depth, rgb = render.render_frames(scene, cam, poses, model, seed, device)
    with ThreadPoolExecutor(ENCODE_THREADS) as pool:  # zlib and OpenCV release the GIL
        encoded = list(pool.map(encode, depth, rgb))
    return FrameSet(encoded, poses, cam.width, cam.height)
