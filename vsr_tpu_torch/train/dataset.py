"""Training data pipeline for STTN GAN training: a copy of
``vsr_tpu/train/dataset.py`` (tests/test_torch_host.py holds it bit for bit).

Capability parity with the reference dataset stack
(backend/tools/train/dataset_sttn.py:12-84 + utils_sttn.py mask generation):
* video clips read from zip archives of frames (YouTube-VOS layout) or plain
  frame directories;
* ``sample_length`` frames per example, consecutive or randomly-spread
  (50/50, ref get_ref_index :75);
* random free-form occlusion masks — a random star polygon, static for half
  the samples and moving with random-accelerated velocity for the rest
  (ref create_random_shape_with_random_motion :104-131). The reference draws
  bezier blobs with matplotlib; here cv2.fillPoly rasterizes a perturbed
  polygon — same coverage statistics without the matplotlib dependency.

Output batches are channels-last: frames [B, T, H, W, 3] in [-1, 1] RGB and
masks [B, T, H, W, 1] in {0, 1}.
"""

from __future__ import annotations

import os
import random
import zipfile
from typing import Iterator, List, Optional, Sequence, Tuple

import cv2
import numpy as np


# ---------------------------------------------------------------- masks

def random_shape_mask(
    rng: np.random.Generator, height: int, width: int
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Random filled polygon patch; returns (patch uint8 {0,1}, (ph, pw))."""
    ph = int(rng.integers(height // 3, max(height // 3 + 1, height - 1)))
    pw = int(rng.integers(width // 3, max(width // 3 + 1, width - 1)))
    edge_num = int(rng.integers(6, 9))
    ratio = rng.integers(6, 9) / 10.0
    angles = np.linspace(0, 2 * np.pi, edge_num, endpoint=False)
    radii = (2 * ratio * rng.random(edge_num) + 1 - ratio) / (1 + ratio)
    xs = (np.cos(angles) * radii * 0.5 + 0.5) * (pw - 1)
    ys = (np.sin(angles) * radii * 0.5 + 0.5) * (ph - 1)
    patch = np.zeros((ph, pw), np.uint8)
    pts = np.stack([xs, ys], axis=-1).astype(np.int32)
    cv2.fillPoly(patch, [pts], 1)
    return patch, (ph, pw)


def create_random_moving_masks(
    rng: np.random.Generator,
    video_length: int,
    height: int = 240,
    width: int = 432,
    max_speed: float = 3.0,
    max_acceleration: Tuple[float, float] = (3.0, 0.5),
) -> np.ndarray:
    """[T, H, W] uint8 {0,1} masks; static 50% of the time, else the patch
    random-walks with accelerated velocity, clamped inside the frame."""
    patch, (ph, pw) = random_shape_mask(rng, height, width)
    y = int(rng.integers(0, max(1, height - ph)))
    x = int(rng.integers(0, max(1, width - pw)))
    speed = rng.uniform(0, max_speed)
    angle = rng.uniform(0, 2 * np.pi)
    vy, vx = speed * np.sin(angle), speed * np.cos(angle)

    def render(y, x):
        m = np.zeros((height, width), np.uint8)
        y0, x0 = int(round(y)), int(round(x))
        m[y0 : y0 + ph, x0 : x0 + pw] = patch[: height - y0, : width - x0]
        return m

    masks = [render(y, x)]
    if rng.random() > 0.5:
        return np.stack(masks * video_length)
    for _ in range(video_length - 1):
        speed_acc = rng.uniform(-max_acceleration[0], max_acceleration[0])
        angle_acc = rng.uniform(-max_acceleration[1], max_acceleration[1])
        speed = abs(np.hypot(vy, vx) + speed_acc)
        angle = np.arctan2(vy, vx) + angle_acc
        vy, vx = speed * np.sin(angle), speed * np.cos(angle)
        y = float(np.clip(y + vy, 0, max(0, height - ph)))
        x = float(np.clip(x + vx, 0, max(0, width - pw)))
        masks.append(render(y, x))
    return np.stack(masks)


# ---------------------------------------------------------------- frames

class FrameSequenceDataset:
    """Clips from zip archives of frames or frame directories.

    root layout (YouTube-VOS style): <root>/<video>.zip with image entries, or
    <root>/<video>/ with image files.
    """

    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(
        self,
        root: str,
        frame_w: int = 432,
        frame_h: int = 240,
        sample_length: int = 5,
        mask_w: Optional[int] = None,
        mask_h: Optional[int] = None,
        seed: int = 2020,
    ):
        self.root = root
        self.frame_w = frame_w
        self.frame_h = frame_h
        self.sample_length = sample_length
        self.mask_w = mask_w or frame_w
        self.mask_h = mask_h or frame_h
        self.rng = np.random.default_rng(seed)
        self.videos = self._index_videos(root)
        if not self.videos:
            raise FileNotFoundError(f"no videos under {root}")

    def _index_videos(self, root: str) -> List[str]:
        entries = []
        if not os.path.isdir(root):
            return entries
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if name.endswith(".zip") or os.path.isdir(path):
                entries.append(path)
        return entries

    def _read_video_frames(self, path: str) -> List[np.ndarray]:
        frames = []
        if path.endswith(".zip"):
            with zipfile.ZipFile(path) as zf:
                names = sorted(
                    n for n in zf.namelist()
                    if n.lower().endswith(self.IMAGE_EXTS))
                for n in names:
                    buf = np.frombuffer(zf.read(n), np.uint8)
                    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                    if img is not None:
                        frames.append(img)
        else:
            for n in sorted(os.listdir(path)):
                if n.lower().endswith(self.IMAGE_EXTS):
                    img = cv2.imread(os.path.join(path, n))
                    if img is not None:
                        frames.append(img)
        return frames

    def _sample_indices(self, total: int) -> List[int]:
        """Consecutive run or random spread, 50/50 (ref dataset_sttn.py:75)."""
        n = self.sample_length
        if total <= n:
            return list(range(total)) + [total - 1] * (n - total)
        if self.rng.random() > 0.5:
            start = int(self.rng.integers(0, total - n + 1))
            return list(range(start, start + n))
        return sorted(self.rng.choice(total, size=n, replace=False).tolist())

    def __len__(self) -> int:
        return len(self.videos)

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """One example: (frames [T, H, W, 3] float32 RGB in [-1, 1],
        masks [T, H, W, 1] float32 {0, 1})."""
        video = self.videos[int(self.rng.integers(0, len(self.videos)))]
        raw = self._read_video_frames(video)
        idx = self._sample_indices(len(raw))
        frames = []
        for i in idx:
            img = cv2.resize(raw[i], (self.frame_w, self.frame_h))
            frames.append(img[..., ::-1])  # BGR -> RGB (ref trains in RGB)
        frames = np.stack(frames).astype(np.float32) / 255.0 * 2.0 - 1.0
        masks = create_random_moving_masks(
            self.rng, len(idx), self.frame_h, self.frame_w
        ).astype(np.float32)[..., None]
        return frames, masks

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite iterator of (frames [B,T,H,W,3], masks [B,T,H,W,1])."""
        while True:
            samples = [self.sample() for _ in range(batch_size)]
            yield (np.stack([s[0] for s in samples]),
                   np.stack([s[1] for s in samples]))
