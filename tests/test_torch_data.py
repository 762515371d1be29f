"""The port's data layer against the JAX package, on the CPU at small sizes:
the trajectory helpers, the rasterizers (cv2, the host C++ library, the
torch device rasterizer against rasterize_video_xla), the blender contract,
both dataset classes, WebVidDataset, ResilientDataset, the loaders, the
exporters, the metrics and MetricsLogger. One JAX compile: the device
rasterizer's jit, both modes in one program.

Tolerances:
* readers, loaders, exporters (file bytes), the cv2 and host rasterizers,
  the metrics: bitwise / equal.
* rasterize_video vs rasterize_video_xla: gaussian within 1e-5 absolute;
  hard equal except on pixels whose least squared distance lies within
  NEAR = 1e-4 of a threshold (where float rounding may fall either side),
  and those at most HARD_BOUND = 1e-3 of the pixels. chip_smoke.py phase
  10(a) holds the card against the CPU by the same rule.
* the host library vs the device hard mode (fidelity_bgr_swap=False): they
  differ only where a line and an end-point circle overlap (the library
  draws in trajectory order, so a later line covers an earlier circle; the
  device draws every circle on top) or near a threshold, and on at most
  HOST_BOUND = 0.1 of those pixels.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_data import _make_blender_fixture, _make_vipseg_fixture

NEAR = 1e-4
HARD_BOUND = 1e-3
HOST_BOUND = 0.1
LINE_THR, CIRCLE_THR = 1.5**2, 3.0**2


def _tracks(seed, k, f, h, w, integer=False):
    rng = np.random.RandomState(seed)
    start = rng.rand(k, 1, 2) * [w, h]
    steps = rng.randn(k, f, 2).cumsum(axis=1) * 4.0
    t = (start + steps).astype(np.float32)
    return np.floor(t) if integer else t


# ---------------------------------------------------------------------------
# Trajectories and rasterizers
# ---------------------------------------------------------------------------


def test_trajectory_helpers_match_jax(tmp_path):
    from posetraj_tpu.data import trajectories as jt
    from posetraj_torch.data import trajectories as pt

    tj = {"3": [[10.5, 20], [30, 40], [1, 2]], "1": [[1, 2], [3, 4]], "7": [[5, 6], [7, 8.25], [9, 1]]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(tj))
    assert pt.load_cotracker_json(str(path)) == jt.load_cotracker_json(str(path))
    a, b = pt.trajectories_to_array(tj), jt.trajectories_to_array(tj)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(pt.trajectories_to_array({}), jt.trajectories_to_array({}))
    assert pt.num_frames(tj) == jt.num_frames(tj) == 3
    assert np.array_equal(pt.scale_to_target(a, (100, 200), (57, 93)), jt.scale_to_target(b, (100, 200), (57, 93)))


@pytest.mark.parametrize("swap", [True, False])
def test_cv2_and_host_rasterizers_match_jax(swap):
    from posetraj_tpu.ops import rasterize as jr
    from posetraj_torch.ops import rasterize as pr

    pts = _tracks(0, 6, 5, 48, 80, integer=True)
    assert np.array_equal(pr.scale_trajectories(pts, (48, 80), (40, 64)), jr.scale_trajectories(pts, (48, 80), (40, 64)))
    want = jr.rasterize_cv2(pts, 5, (48, 80), fidelity_bgr_swap=swap)
    assert np.array_equal(pr.rasterize_cv2(pts, 5, (48, 80), fidelity_bgr_swap=swap), want)
    assert np.array_equal(pr.rasterize_host(pts, 5, (48, 80), fidelity_bgr_swap=swap, impl="cv2"), want)
    with pytest.raises(ValueError):
        pr.rasterize_host(pts, 5, (48, 80), impl="opencl")


@pytest.mark.parametrize("swap", [True, False])
def test_host_library_matches_jax_native(swap):
    """The port's own copy of the C++ rasterizer, built here with g++ into
    build/host/, against the JAX package's native library: bitwise."""
    from posetraj_tpu import native
    from posetraj_torch.ops import host_rasterize, rasterize as pr

    assert host_rasterize.is_available()
    assert host_rasterize.lib_path().parent == Path(__file__).resolve().parents[1] / "build" / "host"
    for integer in (True, False):
        pts = _tracks(1, 9, 6, 40, 72, integer=integer)
        got = host_rasterize.rasterize_trajectory_video_native(pts, 6, (40, 72), fidelity_bgr_swap=swap)
        want = native.rasterize_trajectory_video_native(pts, 6, (40, 72), fidelity_bgr_swap=swap)
        assert np.array_equal(got, want)
        assert np.array_equal(pr.rasterize_host(pts, 6, (40, 72), fidelity_bgr_swap=swap, impl="native"), want)
        assert np.array_equal(pr.rasterize_host(pts, 6, (40, 72), fidelity_bgr_swap=swap, impl="auto"), want)
    corners = _tracks(2, 8, 4, 40, 72).transpose(1, 0, 2).copy()
    assert np.array_equal(host_rasterize.rasterize_bbox_video_native(corners, 4, (40, 72)),
                          native.rasterize_bbox_video_native(corners, 4, (40, 72)))


def _near(d_line, d_circle):
    return ((d_line - LINE_THR).abs() <= NEAR) | ((d_circle - CIRCLE_THR).abs() <= NEAR)


@pytest.fixture(scope="module")
def xla_case():
    """One program: rasterize_video_xla in both modes (the one JAX compile),
    on float tracks with two invalid trajectories."""
    import jax

    from posetraj_tpu.ops.rasterize import rasterize_video_xla

    f, h, w, k = 5, 40, 72, 24
    tracks = _tracks(3, k, f, h, w)
    valid = np.ones((k,), bool)
    valid[[4, 17]] = False
    run = jax.jit(lambda t, v: (rasterize_video_xla(t, v, f, h, w, "hard"),
                                rasterize_video_xla(t, v, f, h, w, "gaussian", sigma=2.5)))
    hard, gauss = run(tracks, valid)
    return dict(f=f, h=h, w=w, tracks=tracks, valid=valid, hard=np.asarray(hard), gauss=np.asarray(gauss))


def test_device_rasterizer_matches_xla(xla_case):
    from posetraj_torch.ops import rasterize as pr

    c = xla_case
    tracks, valid = torch.from_numpy(c["tracks"]), torch.from_numpy(c["valid"])
    gauss = pr.rasterize_video(tracks, valid, c["f"], c["h"], c["w"], "gaussian", sigma=2.5).numpy()
    assert gauss.shape == c["gauss"].shape == (c["f"], c["h"], c["w"], 3)
    assert np.abs(gauss - c["gauss"]).max() <= 1e-5
    hard = pr.rasterize_video(tracks, valid, c["f"], c["h"], c["w"], "hard").numpy()
    assert not hard[-1].any() and set(np.unique(hard)) <= {0.0, 1.0}
    differ = (hard != c["hard"]).any(-1)
    assert not differ[-1].any()
    near = torch.stack([_near(*pr.min_distances(tracks[:, t], tracks[:, t + 1], valid, c["h"], c["w"], 4))
                        for t in range(c["f"] - 1)]).numpy()
    # Every disagreement lies on a near-threshold pixel, and there are few.
    assert not (differ[:-1] & ~near).any()
    assert differ.sum() <= HARD_BOUND * differ.size, differ.sum()
    # The hard masks do light pixels where the XLA ones do.
    assert c["hard"][..., 0].sum() > 50 and c["hard"][..., 1].sum() > 50


@pytest.mark.parametrize("mode", ["hard", "gaussian"])
def test_chunked_rasterizer_is_bitwise_one_shot(xla_case, mode):
    from posetraj_torch.ops import rasterize as pr

    c = xla_case
    tracks, valid = torch.from_numpy(c["tracks"]), torch.from_numpy(c["valid"])
    px = c["h"] * c["w"] * 4
    assert pr.chunk_size(c["h"], c["w"], px) == 1
    one = pr.rasterize_video(tracks, valid, c["f"], c["h"], c["w"], mode, chunk_bytes=1 << 40)
    for chunk in (1, 5):
        got = pr.rasterize_video(tracks, valid, c["f"], c["h"], c["w"], mode, chunk_bytes=chunk * 8 * px)
        assert torch.equal(got, one)


def test_host_library_vs_device_hard_mode():
    """The bound chip_smoke.py phase 10(a) holds the library to against the
    card's hard mode: disagreements only on line-circle overlaps or near a
    threshold, and on at most HOST_BOUND of those pixels."""
    from posetraj_torch.ops import host_rasterize, rasterize as pr

    f, h, w, k = 6, 48, 80, 48
    tracks = _tracks(4, k, f, h, w, integer=True)
    host = host_rasterize.rasterize_trajectory_video_native(tracks, f, (h, w))
    t = torch.from_numpy(tracks)
    valid = torch.ones(k, dtype=torch.bool)
    dev = (pr.rasterize_video(t, valid, f, h, w, "hard").numpy() * 255).astype(np.uint8)
    differ = (host != dev).any(-1)
    allowed = np.zeros_like(differ)
    for i in range(f - 1):
        d_line, d_circle = pr.min_distances(t[:, i], t[:, i + 1], valid, h, w, 16)
        line, circle = pr.masks(d_line, d_circle, "hard", 3, 3, 3.0)
        allowed[i] = ((line * circle).bool() | _near(d_line, d_circle)).numpy()
    assert not (differ & ~allowed).any()
    assert 0 < differ.sum() <= HOST_BOUND * allowed.sum(), (differ.sum(), allowed.sum())
    assert not host[-1].any()


def test_blender_contract_matches_jax(tmp_path):
    from posetraj_tpu.data import blender_contract as jb
    from posetraj_torch.data import blender_contract as pb

    traj = np.random.RandomState(0).rand(10, 2).astype(np.float64) * 50
    bbox = np.random.RandomState(1).rand(10, 8, 2) * 60
    np.save(tmp_path / "traj.npy", traj)
    np.save(tmp_path / "bbox.npy", bbox)
    for fn in ("load_traj_npy", "load_bbox_npy"):
        name = "traj.npy" if "traj" in fn else "bbox.npy"
        a, b = getattr(pb, fn)(str(tmp_path / name)), getattr(jb, fn)(str(tmp_path / name))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    r, t = np.random.RandomState(2).rand(3, 3), np.random.RandomState(3).rand(3)
    assert np.array_equal(pb.camera_rt_vector(r, t), jb.camera_rt_vector(r, t))
    for src in (None, (80, 96)):
        assert np.array_equal(pb.rasterize_bbox_video(bbox, 6, (40, 64), source_hw=src),
                              jb.rasterize_bbox_video(bbox, 6, (40, 64), source_hw=src))
    (tmp_path / "writed.txt").write_text("a\n\nb\n")
    assert pb.read_render_bookkeeping(str(tmp_path)) == jb.read_render_bookkeeping(str(tmp_path)) == (["a", "b"], [])


# ---------------------------------------------------------------------------
# Datasets and loaders
# ---------------------------------------------------------------------------


def _assert_samples_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    """test_data.py's Blender fixture with bbox/ frames and bbox_2d.py."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("blender"))
    _make_blender_fixture(root, n_videos=2, n_frames=8)
    for v in range(2):
        vdir = os.path.join(root, f"obj_{v}_circle")
        os.makedirs(os.path.join(vdir, "bbox"))
        for i in range(9):
            arr = (np.random.RandomState(500 + v * 10 + i).rand(48, 80, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(vdir, "bbox", f"{i:04d}.png"))
        np.save(os.path.join(vdir, "bbox_2d.npy"), np.asarray([[8 + v, 12], [40, 60 - v]]))
        os.rename(os.path.join(vdir, "bbox_2d.npy"), os.path.join(vdir, "bbox_2d.py"))
    return root


def test_blender_dataset_matches_jax(blender_root):
    from posetraj_tpu.data import TrajectoryBlenderDataset as J
    from posetraj_torch.data import TrajectoryBlenderDataset as P

    kw = dict(sample_size=(32, 64), frame_length=4, seed=11, return_rot=True, return_bbox=True, mask_initial=True)
    for opts in (kw, dict(sample_size=(24, 40), frame_length=3, seed=2, images_bbox=False, repeat_times=3)):
        p, j = P(blender_root, **opts), J(blender_root, **opts)
        assert len(p) == len(j) and p.vids == j.vids and p.vid_lengths == j.vid_lengths
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(p)):
                _assert_samples_equal(p[i], j[i])


@pytest.fixture(scope="module")
def vipseg_root(tmp_path_factory):
    """test_data.py's VIPSeg fixture (vid_a) plus vid_b with three tracks and
    cameras for both, vid_b's translation holding a NaN."""
    from PIL import Image

    root, split = _make_vipseg_fixture(str(tmp_path_factory.mktemp("vipseg")), n_frames=7)
    os.makedirs(os.path.join(root, "imgs", "vid_b"))
    for i in range(8):
        arr = (np.random.RandomState(70 + i).rand(50, 90, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "imgs", "vid_b", f"{i:04d}.jpg"))
    tracks = _tracks(9, 3, 8, 50, 90)
    with open(os.path.join(root, "trajectory_CoTracker_all", "vid_b.json"), "w") as f:
        json.dump({str(k): tracks[k].tolist() for k in range(3)}, f)
    with open(split, "a") as f:
        f.write("vid_b\nvid_missing\n")
    cams = os.path.join(root, "cams")
    for v, n, nan in (("vid_a", 7, False), ("vid_b", 8, True)):
        rng = np.random.RandomState(len(v) + n)
        t = rng.randn(n, 3).astype(np.float32)
        if nan:
            t[2, 1] = np.nan
        os.makedirs(os.path.join(cams, v))
        np.save(os.path.join(cams, v, "camera.npy"), {"pred_cam_R": rng.randn(n, 3, 3), "pred_cam_T": t})
    return root, split, cams


@pytest.mark.parametrize("opts", [
    dict(return_cam=True, cam_mask_ratio=0.5, cam_norm=True),
    dict(return_cam=True, cam_mask_ratio=0.0, cam_norm=False, fidelity_bgr_swap=False),
    dict(return_cam=False, rasterizer="native"),
], ids=["cam_mask_norm", "cam_no_swap", "native"])
def test_vipseg_dataset_matches_jax(vipseg_root, opts):
    from posetraj_tpu.data import TrajectoryVIPSegDataset as J
    from posetraj_torch.data import TrajectoryVIPSegDataset as P

    root, split, cams = vipseg_root
    kw = dict(sample_size=(24, 40), frame_length=5, repeat_times=3, seed=4, camera_path=cams, **opts)
    p, j = P(root, split, **kw), J(root, split, **kw)
    assert len(p) == len(j) == 6 and p.vids == j.vids == ["vid_a", "vid_b"]
    masked = 0
    for epoch in (0, 3):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(p)):
            s = p[i]
            _assert_samples_equal(s, j[i])
            if "cam_parameter" in s:
                assert np.isfinite(s["cam_parameter"]).all()
                masked += not s["cam_parameter"].any()
    if opts.get("cam_mask_ratio"):
        assert 0 < masked < 12  # the coin flip both ways over 12 samples


def test_webvid_dataset_matches_jax(tmp_path, monkeypatch):
    """WebVidDataset on GIF videos. The JAX class decodes .mp4 with pyav,
    which this host lacks, so both classes read the files through imageio's
    Pillow plugin here; the window, the resize, the motion file and the
    condition video are the classes' own."""
    import imageio.v3 as iio

    from posetraj_tpu.data.datasets import WebVidDataset as J
    from posetraj_torch.data.datasets import WebVidDataset as P

    for folder, seed in (("videos", 0), ("cond", 1)):
        os.makedirs(tmp_path / folder)
        for v in ("a1", "b2"):
            frames = (np.random.RandomState(seed * 10 + len(v)).rand(7, 30, 44, 3) * 255).astype(np.uint8)
            iio.imwrite(tmp_path / folder / f"{v}.mp4", frames, extension=".gif")
    os.makedirs(tmp_path / "motion")
    (tmp_path / "motion" / "a1.txt").write_text("42.5\n")
    (tmp_path / "rows.csv").write_text("videoid,name\na1,x\nb2,y\n")
    read = lambda self, path: np.asarray(iio.imread(path, extension=".gif"))[..., :3]
    monkeypatch.setattr(J, "_read_video", read)
    monkeypatch.setattr(P, "_read_video", read)
    kw = dict(condition_folder=str(tmp_path / "cond"), motion_folder=str(tmp_path / "motion"),
              sample_size=(16, 24), frame_length=4, seed=3)
    p = P(str(tmp_path / "rows.csv"), str(tmp_path / "videos"), **kw)
    j = J(str(tmp_path / "rows.csv"), str(tmp_path / "videos"), **kw)
    for epoch in (0, 1):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(p)):
            _assert_samples_equal(p[i], j[i])


def test_resilient_dataset_matches_jax():
    from posetraj_tpu.data.datasets import ResilientDataset as J
    from posetraj_torch.data.datasets import ResilientDataset as P

    class Flaky:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            if i % 3 == 0:
                raise IOError("corrupt sample")
            return {"x": np.float32(i)}

    p, j = P(Flaky(), seed=5), J(Flaky(), seed=5)
    for i in range(1, 9):
        assert p[i] == j[i]
    for i in (0, 3, 6):
        assert p[i] == j[i]
    with pytest.raises(IOError):
        P(Flaky(), max_retries=0)[3]


def test_loaders_match_jax(blender_root):
    """batch_iterator and PrefetchLoader (4 workers, prefetch 3): the JAX
    package's batches in the same order, with skip_batches and per-process
    slices."""
    from posetraj_tpu.data import TrajectoryBlenderDataset as JD
    from posetraj_tpu.data import datasets as jd
    from posetraj_torch.data import TrajectoryBlenderDataset as PD
    from posetraj_torch.data import datasets as pd

    kw = dict(sample_size=(16, 32), frame_length=4, seed=5, repeat_times=3)
    p, j = PD(blender_root, **kw), JD(blender_root, **kw)
    assert pd.epoch_batches(len(p), 4) == jd.epoch_batches(len(j), 4) == 2

    def same(got, want):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _assert_samples_equal(a, b)

    same(pd.batch_iterator(p, 4, seed=7, skip_batches=1), jd.batch_iterator(j, 4, seed=7, skip_batches=1))
    same(pd.batch_iterator(p, 4, shuffle=False, seed=1), jd.batch_iterator(j, 4, shuffle=False, seed=1))
    loaders = [(pd.PrefetchLoader(p, 4, num_workers=4, prefetch_batches=3, process_index=r, process_count=n),
                jd.PrefetchLoader(j, 4, num_workers=2, process_index=r, process_count=n))
               for r, n in ((0, 1), (1, 2))]
    try:
        for pl, jl in loaders:
            assert len(pl) == len(jl)
            for seed, skip in ((100, 0), (101, 1)):
                same(pl.epoch(seed=seed, skip_batches=skip), jl.epoch(seed=seed, skip_batches=skip))
    finally:
        for pl, jl in loaders:
            pl.close()
            jl.close()


# ---------------------------------------------------------------------------
# Exporters, metrics, logging
# ---------------------------------------------------------------------------


def test_exporters_write_the_jax_files(tmp_path):
    """Bitwise files from numpy frames, and from tensors (float32, bf16,
    uint8) the same files as from their numpy values."""
    from posetraj_tpu.data import export as je
    from posetraj_torch.data import export as pe

    frames = np.random.RandomState(0).rand(3, 16, 20, 3).astype(np.float32)
    frames[0, 0, 0] = [-0.5, 1.5, 0.5]
    u8 = (frames.clip(0, 1) * 255).astype(np.uint8)
    vids = np.stack([frames, frames[::-1], frames * 0.5])

    def files(mod, out, fr, vs):
        mod.export_to_images(fr, str(out / "imgs"), prefix="p")
        mod.export_to_gif(fr, str(out / "a.gif"), fps=5)
        mod.save_side_by_side_gif([fr, u8], str(out / "b.gif"))
        mod.save_videos_grid(vs, str(out / "c.gif"), n_rows=2)
        return {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*")) if p.is_file()}

    want = files(je, tmp_path / "jax", frames, vids)
    assert len(want) == 6
    assert files(pe, tmp_path / "port", frames, vids) == want
    assert files(pe, tmp_path / "tensor", torch.from_numpy(frames), torch.from_numpy(vids)) == want
    bf = torch.from_numpy(frames).bfloat16()
    assert files(pe, tmp_path / "bf16", bf, torch.stack([bf, bf.flip(0), bf * 0.5])) == files(
        je, tmp_path / "jax_bf16", bf.float().numpy(), torch.stack([bf, bf.flip(0), bf * 0.5]).float().numpy())
    pe.export_to_images(torch.from_numpy(u8), str(tmp_path / "u8"))
    je.export_to_images(u8, str(tmp_path / "u8j"))
    assert [p.read_bytes() for p in sorted((tmp_path / "u8").iterdir())] == [
        p.read_bytes() for p in sorted((tmp_path / "u8j").iterdir())]


def test_metrics_match_jax():
    from posetraj_tpu.data import metrics as jm
    from posetraj_torch.data import metrics as pm

    rng = np.random.RandomState(0)
    a = rng.rand(3, 14, 13, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    assert pm.psnr(a, b) == jm.psnr(a, b) and pm.psnr(a, a) == jm.psnr(a, a)
    for fn in ("ssim", "ssim_global"):
        assert getattr(pm, fn)(a[0], b[0]) == getattr(jm, fn)(a[0], b[0])
    assert pm.ssim(a[0, :6, :5, 0], b[0, :6, :5, 0]) == jm.ssim(a[0, :6, :5, 0], b[0, :6, :5, 0])
    t, g = rng.rand(4, 5, 2) * 30, rng.rand(4, 5, 2) * 30
    assert pm.objmc(t, g) == jm.objmc(t, g)
    assert pm.video_psnr_ssim(a, b) == jm.video_psnr_ssim(a, b)


def test_metrics_logger_writes_the_jax_lines(tmp_path, monkeypatch):
    """The same JSONL lines apart from the time field; the port reads its
    tensor metrics in one copy. TensorBoard is blocked here (its import is
    slow); the JSONL does not depend on it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from posetraj_tpu.utils.metrics import MetricsLogger as J
    from posetraj_torch.utils.metrics import MetricsLogger as P

    steps = [{"loss": np.float32(0.1234567), "grad_norm": np.float32(3.5), "lr": 1e-5},
             {"loss": np.float32(2.0) / 3, "sigma_mean": np.float32(7.25), "lr": 0}]
    for cls, name, tensors in ((J, "j", False), (P, "p", False), (P, "t", True)):
        log = cls(str(tmp_path), run_name=name)
        for i, m in enumerate(steps):
            log.log(i + 1, {k: torch.tensor(v) if tensors and isinstance(v, np.float32) else v
                            for k, v in m.items()})
        log.close()

    def lines(name):
        out = [json.loads(x) for x in (tmp_path / f"{name}.metrics.jsonl").read_text().splitlines()]
        for x in out:
            assert isinstance(x.pop("time"), float)
        return out

    assert lines("p") == lines("j") == lines("t") and len(lines("j")) == 2


def test_port_modules_import_without_readers():
    """The card host has no PIL, cv2, imageio, safetensors or tensorboard:
    every port module imports with them blocked, and nothing of JAX or the
    JAX package comes in."""
    code = (
        "import pkgutil, sys\n"
        "for m in ('PIL', 'cv2', 'imageio', 'safetensors', 'tensorboard', 'torch.utils.tensorboard'):\n"
        "    sys.modules[m] = None\n"
        "import posetraj_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(posetraj_torch.__path__, 'posetraj_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'posetraj_tpu'))\n"
        "need = {'posetraj_torch.inference', 'posetraj_torch.train.cli', 'posetraj_torch.data.datasets',\n"
        "        'posetraj_torch.data.export', 'posetraj_torch.tools.convert_weights', 'posetraj_torch.utils.metrics'}\n"
        "print(len(names), bad, sorted(need - set(names)))\n"
        "sys.exit(1 if bad or need - set(names) else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stdout + res.stderr
