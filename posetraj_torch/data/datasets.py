"""Dataset loaders: PoseTraj-10k (Blender) and VIPSeg+CoTracker real videos
(port of posetraj_tpu/data/datasets.py).

Host-side numpy loaders mirroring the reference's torch Datasets
(utils/dataset.py: Trajectory_blender_Data :249-445, Trajectory_VIPSeg_Data
:659-862): each __getitem__ returns a dict of channels-last float32 arrays
ready for the trainer (posetraj_torch/train/trainer.py batch contract; its
Trainer moves a numpy batch to the device). A shuffling batch iterator and
a thread-pool PrefetchLoader stand in for DataLoader.

The loader's worker threads make no CUDA call: their work is file decoding
(PIL, imageio), numpy, cv2 or the host rasterizer library. A CUDA call from
another thread while the trainer captures its CUDA graph would break the
capture. PIL and imageio are imported inside the functions that read.

Shared behaviors reproduced:
  * random 14-frame window per sample, `repeat_times` epochs-per-video
  * normalization /255 then (x-0.5)/0.5 -> [-1,1]; resize only, no crop/flip
  * final control frame is black padding
  * missing/short videos filtered at scan time; missing camera npy -> zeros;
    NaN camera translation -> zeros; random camera zero-mask at
    cam_mask_ratio; optional first-frame normalization
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from posetraj_torch.data.trajectories import load_cotracker_json
from posetraj_torch.ops.rasterize import rasterize_host, scale_trajectories


def _load_image(path: str, size_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size_hw is not None:
        img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32)


def _normalize(x: np.ndarray) -> np.ndarray:
    """uint8-range -> [-1,1] (dataset.py:727-732 Normalize(0.5, 0.5))."""
    return x / 255.0 * 2.0 - 1.0


def _sample_rng(seed: int, epoch: int, index: int) -> random.Random:
    """Per-(seed, epoch, index) RNG.

    The reference draws its random frame window from DataLoader-worker-local
    torch RNG state, so sample content depends on worker scheduling; here
    every sample's randomness is a pure function of (seed, epoch, index) —
    thread-pool loading (PrefetchLoader) and resume fast-forward reproduce an
    uninterrupted run byte-for-byte at any worker count. Mixing constants are
    arbitrary odd primes; hash() is avoided (PYTHONHASHSEED-dependent for
    some types)."""
    return random.Random((seed * 1_000_003 + epoch) * 1_000_033 + index)


class TrajectoryBlenderDataset:
    """PoseTraj-10k loader (stage-1 pretrain data).

    Layout per video folder: images/ (or images_bbox/, depth_maps/),
    traj_vid_enhanced/ (pre-rendered trajectory frames), optional bbox/,
    bbox.npy, traj.npy (reference dataset.py:249-445; produced by
    posetraj_torch/data/blender_contract.py-described renders).
    """

    def __init__(
        self,
        path: str,
        sample_size: Tuple[int, int] = (320, 576),
        repeat_times: int = 2,
        frame_length: int = 14,
        images_bbox: bool = False,
        depth_mode: bool = False,
        depth_bbox: bool = False,
        return_rot: bool = False,
        return_bbox: bool = False,
        mask_initial: bool = False,
        filter_num: int = -1,
        cut_num: int = -1,
        seed: Optional[int] = None,
    ):
        self.path = path
        if images_bbox:
            self.images_folder = "images_bbox"
        elif depth_mode:
            self.images_folder = "depth_maps_bbox" if depth_bbox else "depth_maps"
        else:
            self.images_folder = "images"
        self.sample_size = sample_size
        self.repeat_times = repeat_times
        self.frame_length = frame_length
        self.return_rot = return_rot
        self.return_bbox = return_bbox
        self.mask_initial = mask_initial
        self.seed = 0 if seed is None else seed
        self._epoch = 0

        vids = sorted(os.listdir(path))
        if filter_num != -1:
            vids = [v for v in vids if int(v.split("_")[-2]) < filter_num]
        self.vids: List[str] = []
        self.vid_lengths: List[int] = []
        for v in vids:
            traj_dir = os.path.join(path, v, "traj_vid_enhanced")
            if not os.path.isdir(traj_dir):
                continue
            # last rendered frame is reserved (reference counts len-1, :300-303)
            n = len(os.listdir(traj_dir)) - 1
            if n >= frame_length:
                self.vids.append(v)
                self.vid_lengths.append(n)
        if cut_num > 0:
            self.vids = self.vids[:cut_num]
            self.vid_lengths = self.vid_lengths[:cut_num]

    def __len__(self) -> int:
        return len(self.vids) * self.repeat_times

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-sample RNG stream (new window draws each epoch)."""
        self._epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        vid_idx = index // self.repeat_times
        name = self.vids[vid_idx]
        rng = _sample_rng(self.seed, self._epoch, index)
        start = rng.randint(0, self.vid_lengths[vid_idx] - self.frame_length)
        vdir = os.path.join(self.path, name)

        frames_list = sorted(os.listdir(os.path.join(vdir, self.images_folder)))
        traj_list = sorted(os.listdir(os.path.join(vdir, "traj_vid_enhanced")))

        frames = np.stack(
            [
                _load_image(os.path.join(vdir, self.images_folder, frames_list[i]), self.sample_size)
                for i in range(start, start + self.frame_length)
            ]
        )
        # frame_length-1 rendered control frames + black pad (:365-384)
        trajs = [
            _load_image(os.path.join(vdir, "traj_vid_enhanced", traj_list[i]), self.sample_size)
            for i in range(start, start + self.frame_length - 1)
        ]
        trajs.append(np.zeros_like(trajs[0]))
        trajs = np.stack(trajs)

        sample = {
            "pixel_values": _normalize(frames),
            "trajectories": _normalize(trajs),
            "motion_values": np.float32(128.0),
            "img_key": f"{name}_{vid_idx}_{start}",
        }
        if self.return_rot:
            # rotation class from the trajectory-type folder suffix (:335-341)
            sample["rot_id"] = np.int32(0 if name.split("_")[-1] == "line" else 1)
        if self.return_bbox:
            bbox = _load_image(os.path.join(vdir, "bbox", traj_list[start]), self.sample_size)
            sample["bbox_trajectories"] = np.broadcast_to(
                _normalize(bbox)[None], trajs.shape
            ).copy()
        if self.mask_initial:
            # First control frame masked to the object's 2D bbox (reference
            # dataset.py:374-379): mask built at NATIVE resolution from
            # `bbox_2d.py` (an .npy despite the extension), rows indexed by
            # the bbox x coords exactly as written there, applied before the
            # resize like the reference's pixel_transforms ordering.
            from PIL import Image

            raw0 = _load_image(os.path.join(vdir, "traj_vid_enhanced", traj_list[start]))
            bbox_2d = np.load(os.path.join(vdir, "bbox_2d.py"))
            x0, x1 = int(bbox_2d[0][0]), int(bbox_2d[1][0])
            y0, y1 = int(bbox_2d[0][1]), int(bbox_2d[1][1])
            mask = np.zeros(raw0.shape, raw0.dtype)
            mask[x0:x1, y0:y1] = 1.0
            masked = Image.fromarray((raw0 * mask).astype(np.uint8)).resize(
                (self.sample_size[1], self.sample_size[0]), Image.BILINEAR
            )
            sample["initial_mask"] = _normalize(np.asarray(masked, np.float32))
        return sample


class TrajectoryVIPSegDataset:
    """VIPSeg real-video loader with on-the-fly CoTracker rasterization
    (dataset.py:659-862) and optional per-frame camera extrinsics."""

    def __init__(
        self,
        path: str,
        split_file: str,
        sample_size: Tuple[int, int] = (320, 576),
        repeat_times: int = 4,
        frame_length: int = 14,
        return_cam: bool = False,
        camera_path: Optional[str] = None,
        cam_mask_ratio: float = 0.0,
        cam_norm: bool = False,
        fidelity_bgr_swap: bool = True,
        rasterizer: str = "cv2",
        seed: Optional[int] = None,
    ):
        self.path = path
        self.traj_dir = os.path.join(path, "trajectory_CoTracker_all")
        self.images_dir = os.path.join(path, "imgs")
        self.sample_size = sample_size
        self.repeat_times = repeat_times
        self.frame_length = frame_length
        self.return_cam = return_cam
        self.camera_path = camera_path
        self.cam_mask_ratio = cam_mask_ratio
        self.cam_norm = cam_norm
        self.fidelity_bgr_swap = fidelity_bgr_swap
        self.rasterizer = rasterizer
        self.seed = 0 if seed is None else seed
        self._epoch = 0

        with open(split_file) as f:
            wanted = {line.strip() for line in f if line.strip()}
        self.vids: List[str] = []
        self.vid_lengths: List[int] = []
        for v in sorted(os.listdir(self.images_dir)) if os.path.isdir(self.images_dir) else []:
            if v not in wanted:
                continue
            anno = os.path.join(self.traj_dir, f"{v}.json")
            if not os.path.exists(anno):
                continue
            traj = load_cotracker_json(anno)
            n = len(next(iter(traj.values()))) if traj else 0
            if n >= frame_length:
                self.vids.append(v)
                self.vid_lengths.append(n)

    def __len__(self) -> int:
        return len(self.vids) * self.repeat_times

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _camera(self, name: str, start: int, rng: random.Random) -> np.ndarray:
        f = self.frame_length
        cam = np.zeros((f, 12), np.float32)
        if self.camera_path:
            npy = os.path.join(self.camera_path, name, "camera.npy")
            if os.path.exists(npy):
                d = np.load(npy, allow_pickle=True).item()
                r = np.asarray(d["pred_cam_R"], np.float32).reshape(len(d["pred_cam_R"]), -1)
                t = np.asarray(d["pred_cam_T"], np.float32)
                if np.isnan(t).any():  # NaN translation -> zeros (:809-810)
                    t = np.zeros_like(t)
                cam = np.concatenate([r, t], axis=-1)[start : start + f].astype(np.float32)
        if rng.random() < self.cam_mask_ratio:  # random zero-mask (:813-814)
            cam = np.zeros((f, 12), np.float32)
        if self.cam_norm:  # first-frame normalization (:818-819)
            cam = cam - cam[0]
        return cam

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        vid_idx = index // self.repeat_times
        name = self.vids[vid_idx]
        rng = _sample_rng(self.seed, self._epoch, index)
        start = rng.randint(0, self.vid_lengths[vid_idx] - self.frame_length)

        frame_files = sorted(os.listdir(os.path.join(self.images_dir, name)))
        first = _load_image(os.path.join(self.images_dir, name, frame_files[start]))
        src_hw = first.shape[:2]
        frames = np.stack(
            [first]
            + [
                _load_image(os.path.join(self.images_dir, name, frame_files[i]))
                for i in range(start + 1, start + self.frame_length)
            ]
        )
        # Resize after load (reference resizes the tensor, :729)
        from PIL import Image

        frames = np.stack(
            [
                np.asarray(
                    Image.fromarray(fr.astype(np.uint8)).resize(
                        (self.sample_size[1], self.sample_size[0]), Image.BILINEAR
                    ),
                    np.float32,
                )
                for fr in frames
            ]
        )

        traj = load_cotracker_json(os.path.join(self.traj_dir, f"{name}.json"))
        pts = np.stack([np.asarray(v, np.float32) for v in traj.values()])  # (K, T, 2)
        pts = scale_trajectories(pts[:, start : start + self.frame_length], src_hw, self.sample_size)
        control = rasterize_host(
            pts, self.frame_length, self.sample_size,
            fidelity_bgr_swap=self.fidelity_bgr_swap, impl=self.rasterizer,
        ).astype(np.float32)

        sample = {
            "pixel_values": _normalize(frames),
            "trajectories": _normalize(control),
            "motion_values": np.float32(128.0),
            "img_key": f"{name}_{vid_idx}_{start}",
        }
        if self.return_cam:
            sample["cam_parameter"] = self._camera(name, start, rng)
        return sample


class WebVidDataset:
    """CSV-driven video-file loader (the reference's legacy WebVid10M path,
    dataset.py:30-128): rows of (videoid, ...) resolved against a video folder
    plus parallel condition/motion folders. Videos are decoded with imageio
    (the reference uses decord); a random frame_length window is sampled."""

    def __init__(
        self,
        csv_path: str,
        video_folder: str,
        condition_folder: Optional[str] = None,
        motion_folder: Optional[str] = None,
        sample_size: Tuple[int, int] = (320, 576),
        frame_length: int = 14,
        seed: Optional[int] = None,
    ):
        import csv

        with open(csv_path) as f:
            self.rows = [r for r in csv.DictReader(f)]
        self.video_folder = video_folder
        self.condition_folder = condition_folder
        self.motion_folder = motion_folder
        self.sample_size = sample_size
        self.frame_length = frame_length
        self.seed = 0 if seed is None else seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.rows)

    def _read_video(self, path: str) -> np.ndarray:
        import imageio.v3 as iio

        frames = iio.imread(path, plugin="pyav") if path.endswith((".mp4", ".webm")) else iio.imread(path)
        return np.asarray(frames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        row = self.rows[index]
        vid = row.get("videoid") or row.get("video_id") or row.get("id")
        video = self._read_video(os.path.join(self.video_folder, f"{vid}.mp4"))
        if len(video) < self.frame_length:
            raise ValueError(f"{vid}: too short ({len(video)} frames)")
        start = _sample_rng(self.seed, self._epoch, index).randint(
            0, len(video) - self.frame_length
        )
        window = video[start : start + self.frame_length]
        window = np.stack(
            [
                np.asarray(
                    Image.fromarray(fr).resize((self.sample_size[1], self.sample_size[0]), Image.BILINEAR),
                    np.float32,
                )
                for fr in window
            ]
        )
        motion = np.float32(127.0)
        if self.motion_folder:
            mpath = os.path.join(self.motion_folder, f"{vid}.txt")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    motion = np.float32(float(f.read().strip()))
        sample = {
            "pixel_values": _normalize(window),
            "motion_values": motion,
            "img_key": str(vid),
        }
        if self.condition_folder:
            cond = self._read_video(os.path.join(self.condition_folder, f"{vid}.mp4"))
            cond = cond[start : start + self.frame_length]
            cond = np.stack(
                [
                    np.asarray(
                        Image.fromarray(fr).resize(
                            (self.sample_size[1], self.sample_size[0]), Image.BILINEAR
                        ),
                        np.float32,
                    )
                    for fr in cond
                ]
            )
            sample["trajectories"] = _normalize(cond)
        return sample


class ResilientDataset:
    """Wrapper: on a failed __getitem__, resample a random index (the
    reference's dataset-level fault handling, dataset.py:83-94)."""

    def __init__(self, dataset, max_retries: int = 8, seed: int = 0):
        self.dataset = dataset
        self.max_retries = max_retries
        self.seed = seed

    def __len__(self):
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __getitem__(self, index: int):
        # Resample sequence is a pure function of (seed, index): concurrent
        # loads of different indices cannot perturb each other's retries.
        rng = _sample_rng(self.seed, 0, index)
        for _ in range(self.max_retries):
            try:
                return self.dataset[index]
            except Exception:
                index = rng.randrange(len(self.dataset))
        return self.dataset[index]  # surface the error after max_retries


class PrefetchLoader:
    """Multi-worker prefetching batch loader.

    The equivalent of the reference's
    `DataLoader(num_workers=8, batch_size=...)` (train...blender_14.py:1042-1049):
    sample loading (PIL decode, cv2 rasterization) runs in a thread pool and up
    to `prefetch_batches` assembled batches are kept in flight, so host IO
    overlaps the compiled device step instead of starving it. Identical batch
    order/content to batch_iterator for the same seed at ANY worker count
    (same shuffle, same remainder wrap-padding, same `skip_batches` resume
    fast-forward): each sample's randomness is a pure function of
    (dataset.seed, epoch-seed, index) via dataset.set_epoch + _sample_rng, so
    thread scheduling cannot change content (tests/test_torch_data.py).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        shuffle: bool = True,
        drop_keys: Sequence[str] = ("img_key",),
        process_index: int = 0,
        process_count: int = 1,
    ):
        from concurrent.futures import ThreadPoolExecutor

        assert batch_size % process_count == 0, (batch_size, process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch_batches = prefetch_batches
        self.shuffle = shuffle
        self.drop_keys = drop_keys
        # Multi-process: every process derives the SAME global shuffle from
        # the seed, then loads only its contiguous slice of each global
        # batch.
        self.process_index = process_index
        self.process_count = process_count
        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def __len__(self) -> int:
        return epoch_batches(len(self.dataset), self.batch_size)

    def epoch(self, seed: int = 0, skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        import collections

        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(seed)
        order = list(range(len(self.dataset)))
        rng = random.Random(seed)
        if self.shuffle:
            rng.shuffle(order)
        batches: List[List[int]] = []
        for bi, i in enumerate(range(0, len(order), self.batch_size)):
            if bi < skip_batches:
                continue
            idxs = order[i : i + self.batch_size]
            if len(idxs) < self.batch_size:
                idxs = idxs + order[: self.batch_size - len(idxs)]
            per_proc = self.batch_size // self.process_count
            batches.append(idxs[self.process_index * per_proc : (self.process_index + 1) * per_proc])

        pending: collections.deque = collections.deque()
        it = iter(batches)

        def submit() -> None:
            idxs = next(it, None)
            if idxs is not None:
                pending.append([self._pool.submit(self.dataset.__getitem__, j) for j in idxs])

        for _ in range(self.prefetch_batches + 1):
            submit()
        while pending:
            futures = pending.popleft()
            samples = [f.result() for f in futures]
            submit()  # refill before yielding so workers stay busy during the step
            yield _collate(samples, self.drop_keys)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


def epoch_batches(n_samples: int, batch_size: int) -> int:
    """Batches yielded per epoch by batch_iterator/PrefetchLoader (remainder
    padded, not dropped) — used for resume fast-forward bookkeeping."""
    return (n_samples + batch_size - 1) // batch_size


def _collate(samples, drop_keys) -> Dict[str, np.ndarray]:
    batch = {}
    for k in samples[0]:
        if k in drop_keys:
            continue
        batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    return batch


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_keys: Sequence[str] = ("img_key",),
    skip_batches: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch iterator collating dict samples into stacked batches.

    Remainder handling: the reference DataLoader keeps the final partial batch
    (drop_last=False, train...blender_14.py:1042-1049); a shape change would
    capture the trainer's CUDA graph anew, so the final batch is padded by wrapping
    to the epoch's first indices — every sample is still seen once per epoch
    and shapes stay static.

    `skip_batches` fast-forwards consumed batches after a resume WITHOUT
    loading their samples (the reference's skip loop,
    train...blender_14.py:1209-1212) while keeping the epoch's shuffle order
    identical to an uninterrupted run.
    """
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(seed)
    order = list(range(len(dataset)))
    rng = random.Random(seed)
    if shuffle:
        rng.shuffle(order)
    for bi, i in enumerate(range(0, len(order), batch_size)):
        if bi < skip_batches:
            continue
        idxs = order[i : i + batch_size]
        if len(idxs) < batch_size:
            idxs = idxs + order[: batch_size - len(idxs)]
        yield _collate([dataset[j] for j in idxs], drop_keys)
