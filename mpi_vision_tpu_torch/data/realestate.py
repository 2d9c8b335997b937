"""RealEstate10K data pipeline: camera parsing, triplet sampling, PSV input.

PyTorch counterpart of ``mpi_vision_tpu/data/realestate.py``. Layout on
disk (the reference's reduced dataset):

    <root>/RealEstate10K/{train,test}/<scene>.txt   camera files
    <root>/transcode/<youtube_id>/<timestamp>.jpg   frames

A camera file's first line is the YouTube URL; each further line is
``timestamp fx fy px py k1 k2 row0(4) row1(4) row2(4)``: normalized
intrinsics and a 3x4 world-to-camera pose (k1 = k2 = 0 asserted, as in the
reference).

The host side stays numpy/PIL (PIL is imported inside the functions that
read or write frames); the per-example plane-sweep volume runs on the
dataset's device through ``core.sweep``. Examples are dicts of tensors on
that device, NHWC, with ``net_input [H, W, 3 + 3P]`` (reference image ++
PSV of the source image in the reference frame) and the keys the losses
read (``train/loss.py``). ``synthesize_dataset`` writes a small procedural
scene set in the same layout, so tests and the chip smoke test need no
download.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from mpi_vision_tpu_torch.core.camera import inv_depths
from mpi_vision_tpu_torch.core.sweep import plane_sweep_one
from mpi_vision_tpu_torch.device import resolve_device


def read_file_lines(path: str) -> list[str]:
  """Non-empty lines of a text file, ``#`` comment lines dropped."""
  with open(path) as f:
    return [ln.rstrip("\n") for ln in f
            if ln.strip() and not ln.lstrip().startswith("#")]


def open_image(path: str, size: tuple[int, int] | None = None,
               scale: bool = True) -> np.ndarray:
  """Open an image file -> RGB float32 array ``[H, W, 3]`` (host).

  ``size`` is (width, height) as PIL takes it; ``scale`` divides by 255
  into [0, 1].
  """
  from PIL import Image

  img = Image.open(path).convert("RGB")
  if size is not None:
    img = img.resize(size)
  arr = np.asarray(img, np.float32)
  return arr / 255.0 if scale else arr


def resize_with_intrinsics(path: str, intrinsics, height: int,
                           width: int) -> tuple[np.ndarray, np.ndarray]:
  """Open + resize an image and scale its pixel-space intrinsics to match
  (host numpy, as the JAX package's).

  Returns ``(image [height, width, 3] in [-1, 1], intrinsics [3, 3])``: K
  scaled elementwise by the size ratios (``camera.scale_intrinsics``'s
  pattern).
  """
  from PIL import Image

  with Image.open(path) as img:
    w0, h0 = img.size
  image = open_image(path, size=(width, height)) * 2.0 - 1.0
  sy, sx = height / h0, width / w0
  scale = np.array([[sx, 1.0, sx], [0.0, sy, sy], [0.0, 0.0, 1.0]],
                   np.float32)
  return image, np.asarray(intrinsics, np.float32) * scale


@dataclass
class Scene:
  """One RealEstate10K view sequence (cameras only, images on disk)."""

  youtube_id: str
  timestamps: list[int]
  intrinsics: np.ndarray  # [N, 4] normalized (fx, fy, cx, cy)
  poses: np.ndarray       # [N, 4, 4] world-to-camera


def parse_camera_lines(lines: Sequence[str]) -> Scene:
  """Parse a camera file. Raises on non-zero radial distortion."""
  url = lines[0]
  youtube_id = url[url.find("/watch?v=") + len("/watch?v="):]
  data = [[int(f) if i == 0 else float(f)
           for i, f in enumerate(ln.split(" "))] for ln in lines[1:]]
  if any(row[5] != 0.0 or row[6] != 0.0 for row in data):
    raise ValueError("non-zero radial distortion (k1/k2) not supported "
                     "(the reference asserts the same)")
  poses = np.array(
      [[row[7:11], row[11:15], row[15:19], [0.0, 0.0, 0.0, 1.0]]
       for row in data], np.float32)
  return Scene(
      youtube_id=youtube_id,
      timestamps=[row[0] for row in data],
      intrinsics=np.array([row[1:5] for row in data], np.float32),
      poses=poses,
  )


def load_scenes(dataset_path: str, split: str = "train") -> list[Scene]:
  """All scenes of a split (``RealEstate10K/{train,test}`` camera files)."""
  base = os.path.join(dataset_path, "RealEstate10K", split)
  return [parse_camera_lines(read_file_lines(os.path.join(base, name)))
          for name in sorted(os.listdir(base))]


def draw_triplet(scene: Scene, rng: np.random.Generator,
                 min_dist: float = 16e3, max_dist: float = 500e3) -> list[int]:
  """(ref, src, tgt) frame indices with timestamp distance in
  [min_dist, max_dist] from the reference."""
  n = len(scene.timestamps)
  ref = int(rng.integers(n))
  base = scene.timestamps[ref]
  near = [i for i in range(n)
          if min_dist <= abs(base - scene.timestamps[i]) <= max_dist]
  if len(near) < 2:
    raise ValueError(
        f"scene {scene.youtube_id}: <2 frames within timestamp window of "
        f"frame {ref} (the reference asserts the same)")
  src = int(rng.choice(near))
  tgt = int(rng.choice([i for i in near if i != src]))
  return [ref, src, tgt]


def _load_frame(dataset_path: str, scene: Scene, index: int,
                img_size: int) -> dict[str, np.ndarray]:
  """One frame, decoded and resized on the host: image in [-1, 1], pixel
  intrinsics, world-to-camera pose."""
  from PIL import Image

  fx, fy, cx, cy = (img_size * scene.intrinsics[index]).tolist()
  path = os.path.join(dataset_path, "transcode", scene.youtube_id,
                      f"{scene.timestamps[index]}.jpg")
  img = Image.open(path).convert("RGB").resize((img_size, img_size))
  image = (np.asarray(img, np.float32) / 255.0) * 2.0 - 1.0
  return {
      "image": image,                                        # [S, S, 3]
      "intrinsics": np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                             np.float32),
      "pose": scene.poses[index],
  }


def make_example(dataset_path: str, scene: Scene, indexes: Sequence[int],
                 img_size: int = 224, num_planes: int = 10,
                 depths: tuple[float, float] = (1.0, 100.0),
                 device: "str | torch.device | None" = None
                 ) -> dict[str, Any]:
  """One training example from a (ref, src, tgt) triplet, its plane-sweep
  volume built on ``device`` (default the card; raises without one unless
  ``"cpu"``)."""
  device = resolve_device(device)
  ref, src, tgt = (_load_frame(dataset_path, scene, i, img_size)
                   for i in indexes)

  def dev(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)

  planes = inv_depths(*depths, num_planes, device=device)
  rel = src["pose"] @ np.linalg.inv(ref["pose"])
  psv = plane_sweep_one(dev(src["image"]), planes, dev(rel),
                        dev(src["intrinsics"]))
  net_input = torch.cat([dev(ref["image"])[None], psv], dim=-1)[0]
  return {
      "net_input": net_input,                                # [S, S, 3+3P]
      "tgt_img_cfw": dev(tgt["pose"]),
      "tgt_img": dev(tgt["image"]),
      "ref_img": dev(ref["image"]),
      "ref_img_wfc": dev(np.linalg.inv(ref["pose"])),
      "intrinsics": dev(src["intrinsics"]),
      "mpi_planes": planes,
  }


@dataclass
class RealEstateDataset:
  """The reference dataset: one example per scene per epoch.

  ``is_valid`` uses the fixed triplet [0, 1, 2]; training draws one per
  access from ``rng``. Examples are built on ``device`` (default the card;
  raises without one unless ``"cpu"``).
  """

  dataset_path: str
  is_valid: bool = False
  min_dist: float = 16e3
  max_dist: float = 500e3
  img_size: int = 224
  num_planes: int = 10
  rng: np.random.Generator = field(default_factory=np.random.default_rng)
  # A pre-walked scene list skips the ``load_scenes`` directory walk.
  scenes: list[Scene] | None = None
  device: "str | torch.device | None" = None

  def __post_init__(self):
    self.device = resolve_device(self.device)
    if self.scenes is None:
      self.scenes = load_scenes(self.dataset_path,
                                "test" if self.is_valid else "train")

  def __len__(self) -> int:
    return len(self.scenes)

  def __getitem__(self, i: int) -> dict[str, Any]:
    scene = self.scenes[i]
    indexes = ([0, 1, 2] if self.is_valid
               else draw_triplet(scene, self.rng, self.min_dist, self.max_dist))
    return make_example(self.dataset_path, scene, indexes, self.img_size,
                        self.num_planes, device=self.device)

  def skip_example(self, i: int) -> None:
    """Consume example ``i``'s randomness without loading its frames, so a
    stream that skips ahead draws exactly what iterating would."""
    if not self.is_valid:
      draw_triplet(self.scenes[i], self.rng, self.min_dist, self.max_dist)


def iterate_batches(dataset: RealEstateDataset, batch_size: int = 1,
                    shuffle: bool = True,
                    rng: np.random.Generator | None = None,
                    skip: int = 0) -> Iterator[Mapping[str, torch.Tensor]]:
  """Collate examples into batch dicts (reference batch size 1).

  ``mpi_planes`` stacks to [B, P] as a torch dataloader would; the losses
  use row 0. ``skip`` starts the stream at batch ``skip`` without loading
  the skipped batches' frames: the shuffle order is drawn identically and
  ``skip_example`` consumes each skipped example's randomness, so the
  yielded stream is the one iterating past them gives.
  """
  if skip < 0:
    raise ValueError(f"skip must be >= 0, got {skip}")
  order = np.arange(len(dataset))
  if shuffle:
    (rng or np.random.default_rng()).shuffle(order)
  n_batches = max((len(order) - batch_size) // batch_size + 1, 0)
  if skip:
    consume = getattr(dataset, "skip_example", None)
    for i in order[:min(skip, n_batches) * batch_size]:
      if consume is not None:
        consume(int(i))
      else:
        dataset[int(i)]
  for start in range(skip * batch_size, len(order) - batch_size + 1,
                     batch_size):
    examples = [dataset[int(i)] for i in order[start:start + batch_size]]
    yield {k: torch.stack([e[k] for e in examples]) for k in examples[0]}


def prefetch_batches(batches: Iterator, size: int = 2) -> Iterator:
  """Wrap a batch iterator with a daemon-thread prefetcher: the worker keeps
  up to ``size`` batches ready while the device trains; worker exceptions
  re-raise at the consuming end."""
  q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
  end = object()
  stop = threading.Event()

  def put(item) -> bool:
    """Put unless the consumer stopped; returns False to abort."""
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def worker():
    try:
      for item in batches:
        if not put(item):
          return                 # consumer abandoned the iterator
      put(end)
    except BaseException as e:   # noqa: BLE001 - re-raised on the consumer
      put(e)

  threading.Thread(target=worker, daemon=True).start()
  try:
    while True:
      item = q.get()
      if item is end:
        return
      if isinstance(item, BaseException):
        raise item
      yield item
  finally:
    stop.set()


def synthesize_dataset(root: str, num_scenes: int = 3, frames: int = 4,
                       img_size: int = 64, seed: int = 0,
                       rot_deg: float = 0.0) -> str:
  """Write a small procedural dataset in the RealEstate10K layout.

  Scenes are textured gradients with drifting blobs viewed by a camera
  trucking sideways; timestamps are spaced so the reference window
  (min_dist 16e3) admits triplets. ``rot_deg`` > 0 adds per-frame camera
  rotation jitter (uniform yaw / pitch / roll up to that many degrees).
  The same recipe, seed for seed, as the JAX package's.
  """
  from PIL import Image

  rng = np.random.default_rng(seed)
  for s in range(num_scenes):
    vid = f"synth{s:03d}"
    for split in ("train", "test"):
      os.makedirs(os.path.join(root, "RealEstate10K", split), exist_ok=True)
    os.makedirs(os.path.join(root, "transcode", vid), exist_ok=True)

    lines = [f"https://www.youtube.com/watch?v={vid}"]
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    blobs = rng.uniform(0.15, 0.85, (6, 2)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (6, 3)).astype(np.float32)
    for f in range(frames):
      ts = 16000 * (f + 1)
      shift = 0.04 * f
      img = np.stack([0.6 * xx, 0.5 * yy, 0.4 * (xx + yy) / 2], -1)
      for (bx, by), col in zip(blobs, colors):
        d2 = (xx - bx + shift) ** 2 + (yy - by) ** 2
        img = img + col * np.exp(-d2 / 0.004)[..., None] * 0.5
      img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
      Image.fromarray(img8).save(
          os.path.join(root, "transcode", vid, f"{ts}.jpg"))

      pose = np.eye(4, dtype=np.float32)
      pose[0, 3] = -0.1 * f  # camera trucking right in world space
      if rot_deg > 0.0:
        rx, ry, rz = np.radians(rng.uniform(-rot_deg, rot_deg, 3))
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        pose[:3, :3] = (rot_z @ rot_y @ rot_x).astype(np.float32)
      row = ([str(ts), "0.9", "0.9", "0.5", "0.5", "0", "0"]
             + [f"{v:.6f}" for v in pose[:3].reshape(-1)])
      lines.append(" ".join(row))

    for split in ("train", "test"):
      with open(os.path.join(root, "RealEstate10K", split,
                             f"{vid}.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
  return root
