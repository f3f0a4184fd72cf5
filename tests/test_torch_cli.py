"""The port's command-line mapper, writers and checkpoints held against the
JAX package's.

  - both CLIs over one 6-image dataset with pre-filled feature caches (the
    JAX one by tests/conftest.py's write_cached_cli_dataset, the port's by
    its own FeatureCache under its fingerprint, which also holds
    min_per_cell): the same registered images, point counts within 10 %;
  - the writers on one map carried across (interop.map_store_from_jax):
    byte-identical point files; the files made from float32 rotations
    (camera poses) with the same lines and numbers within 1e-5, since
    XLA's and PyTorch's float32 sin/cos may differ in the last bit;
  - checkpoints written by either package load in the other;
  - the CLI from rendered PNG images (detector, cache, mapper, writers);
  - the debug dumps' names and formats, as tests/test_pipeline.py checks
    the JAX package's;
  - --parallel-segments 2 writes its outputs from one merged map;
  - the CLI refuses to run on the CPU unless --device cpu is given (--mesh
    runs: tests/test_torch_parallel.py);
  - --pipeline-chains, the JAX CLI's speculative chain pipelining, is
    refused with argparse's usage error (the port leaves it out);
  - --matcher-backend xla (the plain PyTorch matcher) writes the outputs
    of the default run.
"""

import copy
import os
import re

import numpy as np
import pytest
import torch

from mavmap_tpu.cli import main as jax_cli
from mavmap_tpu.features import ArrayFeatureProvider as JProvider
from mavmap_tpu.sfm import SequentialMapper as JMapper
from mavmap_tpu.sfm import outputs as jout
from mavmap_tpu.utils import checkpoint as jckpt
from mavmap_tpu.utils.io import read_image_data as j_read_image_data
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features
from tests.conftest import write_cached_cli_dataset

from mavmap_tpu_torch import cli as tcli
from mavmap_tpu_torch.features import ArrayFeatureProvider, FeatureCache
from mavmap_tpu_torch.interop import map_store_from_jax
from mavmap_tpu_torch.sfm import SequentialMapper
from mavmap_tpu_torch.sfm import outputs as tout
from mavmap_tpu_torch.sfm import pipeline as tpipe
from mavmap_tpu_torch.utils import checkpoint as tckpt
from mavmap_tpu_torch.utils.imageio import write_png
from mavmap_tpu_torch.utils.io import read_image_data
from mavmap_tpu_torch.utils.synthetic import ate_rmse
from mavmap_tpu_torch.utils.synthetic import make_uav_scene as t_scene
from mavmap_tpu_torch.utils.synthetic import render_images

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 6
FLAGS = ["--max-features", "1024", "--min-track-len", "2", "--tri-min-angle", "1.0",
         "--init-tri-min-angle", "4.0", "--quiet"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs over the same cached dataset, each saving its map."""
    tmp = tmp_path_factory.mktemp("cli")
    scene = make_uav_scene(num_images=N, num_points=1500, relief=10.0, rows=1, seed=6)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=10, seed=6)
    data, jcache = write_cached_cli_dataset(tmp, feats, N)
    tcache = tmp / "tcache"
    args = tcli.build_parser().parse_args(["--input-path", "x", "--output-path", "y"] + FLAGS)
    fc = FeatureCache(str(tcache), tcli.detector_params(args), detector=lambda i: feats[i],
                      capacity=1024)
    for i in range(N):
        fc.query(i, f"img{i}")
    base = ["--input-path", str(data)] + FLAGS
    assert jax_cli(base + ["--cache-path", str(jcache), "--output-path", str(tmp / "jout"),
                           "--save-map", str(tmp / "jmap.npz")]) == 0
    run = tcli.run(base + ["--cache-path", str(tcache), "--output-path", str(tmp / "tout"),
                           "--save-map", str(tmp / "tmap.npz"), "--device", "cpu"])
    assert run.rc == 0
    return tmp, scene, feats, run


def _rows(path):
    return [[v.strip() for v in line.split(",")]
            for line in path.read_text().splitlines() if not line.startswith("#")]


def test_cli_matches_jax_on_cached_features(cli_runs):
    """The same images registered (imagedataout.txt's names) and point
    counts within 10 %; every output file of the JAX CLI is written."""
    tmp, _, _, run = cli_runs
    jo, to = tmp / "jout", tmp / "tout"
    assert sorted(os.listdir(to)) == sorted(os.listdir(jo))
    assert [r[0] for r in _rows(to / "imagedataout.txt")] == \
        [r[0] for r in _rows(jo / "imagedataout.txt")] == [f"img{i}" for i in range(N)]
    nt, nj = len(_rows(to / "points3D.txt")), len(_rows(jo / "points3D.txt"))
    assert abs(nt - nj) <= 0.1 * nj and nt > 100
    assert run.result.main_mapper.num_proc_images == N


def _jax_mapper(feats, path):
    scene = make_uav_scene(num_images=N, num_points=1500, relief=10.0, rows=1, seed=6)
    m = JMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                JProvider(feats, capacity=1024), store_backend="python")
    return jckpt.load_map(m, str(path))


def _port_mapper(feats):
    scene = t_scene(num_images=N, num_points=1500, relief=10.0, rows=1, seed=6)
    return SequentialMapper(scene.image_cameras, scene.cam_models, scene.cam_params,
                            ArrayFeatureProvider(feats, capacity=1024), device=CPU)


_NUM = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _same_text(a, b, exact):
    if exact:
        assert a.read_bytes() == b.read_bytes(), a.name
        return
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    assert len(la) == len(lb), a.name
    for x, y in zip(la, lb):
        assert _NUM.sub("#", x) == _NUM.sub("#", y), (a.name, x, y)
        np.testing.assert_allclose([float(v) for v in _NUM.findall(x)],
                                   [float(v) for v in _NUM.findall(y)], rtol=1e-5, atol=1e-5)


def test_writers_on_one_map_match_jax(cli_runs, tmp_path):
    """Every writer on the JAX CLI's map, carried into the port with
    map_store_from_jax: the point files byte for byte (colors from the same
    image reader included); imagedataout.txt, cameras.wrl and
    connections.wrl line for line with their numbers within 1e-5."""
    tmp, _, feats, _ = cli_runs
    mj = _jax_mapper(feats, tmp / "jmap.npz")
    mt = _port_mapper(feats)
    mt.store = map_store_from_jax(mj.store)
    for k in ("image_idx_to_id", "image_id_to_idx", "pair_graph", "num_proc_images"):
        setattr(mt, k, copy.deepcopy(getattr(mj, k)))
    data = tmp / "data" / "imagedata.txt"
    rec_t, rec_j = read_image_data(str(data)), j_read_image_data(str(data))
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (600, 800, 3), dtype=np.uint8) for _ in range(N)]
    (tmp_path / "t").mkdir(), (tmp_path / "j").mkdir()
    for pkg, out, m, rec in (("t", tout, mt, rec_t), ("j", jout, mj, rec_j)):
        d = tmp_path / pkg
        out.write_image_data(m, rec, str(d / "imagedataout.txt"))
        out.write_point_cloud_data(m, str(d / "points3D.txt"))
        out.write_point_cloud_data(m, str(d / "points3D-color.txt"),
                                   image_reader=lambda i: imgs[i])
        out.write_point_cloud_ply(m, str(d / "points3D.ply"), max_error=2.0)
        out.write_camera_models_vrml(m, str(d / "cameras.wrl"))
        out.write_point_cloud_vrml(m, str(d / "points3D.wrl"), min_track_len=3, max_error=0.8)
        out.write_point_cloud_vrml(m, str(d / "points3D-all.wrl"), min_track_len=0)
        out.write_camera_connections_vrml(m, str(d / "connections.wrl"))
    for name in sorted(os.listdir(tmp_path / "t")):
        _same_text(tmp_path / "t" / name, tmp_path / "j" / name,
                   exact=name not in ("imagedataout.txt", "cameras.wrl", "connections.wrl"))


def _same_store(a, b):
    for f in ("image_rvecs", "image_tvecs", "image_registered", "point2D_point3D",
              "point3D_xyz", "point3D_valid", "camera_params"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)
    assert {k: list(v) for k, v in a.tracks.items()} == {k: list(v) for k, v in b.tracks.items()}


def test_checkpoints_load_across_packages(cli_runs):
    """A map saved by the JAX CLI loads in the port, and the port's in the
    JAX package, to the same stores, image tables and pair graphs."""
    tmp, _, feats, run = cli_runs
    mj = _jax_mapper(feats, tmp / "jmap.npz")
    mt = tckpt.load_map(_port_mapper(feats), str(tmp / "jmap.npz"))
    _same_store(mt.store, mj.store)
    assert (mt.image_idx_to_id, mt.pair_graph, mt.num_proc_images) == \
        (mj.image_idx_to_id, mj.pair_graph, mj.num_proc_images)
    assert mt._store_cam_ids == {0: 0}  # the camera table is rebuilt (a port repair)
    mj2 = _jax_mapper(feats, tmp / "tmap.npz")
    saved = run.result.main_mapper
    _same_store(mj2.store, saved.store)
    assert mj2.image_idx_to_id == saved.image_idx_to_id
    assert mj2.pair_graph == saved.pair_graph


def test_cli_from_rendered_images(tmp_path):
    """Pixels to poses at a reduced image size (400x300, focal 350): PNGs
    written by utils/imageio.py, detection, the feature cache, the mapper
    and the writers; at least 5 of 6 frames, the trajectory within 1 m
    after a similarity fit (tests/test_pipeline.py's bounds), and the point
    colors read through utils/imageio.py."""
    scene = t_scene(num_images=6, num_points=1500, relief=10.0, rows=1, seed=21,
                    image_size=(400, 300), focal=350.0)
    data = tmp_path / "data"
    data.mkdir()
    lines = ["# imagedata"]
    for i, im in enumerate(render_images(scene, texture_contrast=0.25, seed=21)):
        write_png(str(data / f"img{i}.png"), im)
        cam_def = ", 1, PINHOLE, 350.0, 350.0, 200.0, 150.0" if i == 0 else ""
        lines.append(f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0{cam_def}")
    (data / "imagedata.txt").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    run = tcli.run(["--input-path", str(data), "--output-path", str(out), "--max-features",
                    "1024", "--min-track-len", "2", "--tri-min-angle", "1.0",
                    "--init-tri-min-angle", "2.0", "--ransac-min-inlier-threshold", "15",
                    "--surf-hessian-threshold", "1000", "--quiet", "--device", "cpu"])
    assert run.rc == 0 and run.detection_s > 0
    rows = _rows(out / "imagedataout.txt")
    assert len(rows) >= 5
    est = np.array([[float(v) for v in r[8:11]] for r in rows])
    idx = [int(r[0][3:]) for r in rows]
    assert ate_rmse(est, scene.camera_centers()[idx]) < 1.0
    header = (out / "points3D.txt").read_text().splitlines()[0]
    assert header == "# X, Y, Z, R, G, B, TRACK_LEN, MEAN_RESIDUAL"
    assert len(os.listdir(out / "cache")) == 6


def test_debug_dumps(tmp_path):
    """debug + debug_path write the per-pair match tables, track-length logs
    and per-step VRML scenes with the reference's names and formats
    (tests/test_pipeline.py's checks of the JAX package's dumps)."""
    from mavmap_tpu_torch.utils.synthetic import render_features as t_render

    scene = t_scene(num_images=5, num_points=1200, relief=10.0, rows=1, seed=9)
    feats, _ = t_render(scene, pixel_noise=0.3, clutter=10, seed=9)
    cap = int(np.ceil(max(len(k) for k, _ in feats) / 256)) * 256
    dbg = tmp_path / "dbg"
    opts = tpipe.PipelineOptions(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0,
                                 min_track_len=2, loop_detection=False, debug=True,
                                 debug_path=str(dbg))
    res = tpipe.run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                             ArrayFeatureProvider(feats, capacity=cap), opts, device=CPU)
    assert res.main_mapper.num_proc_images >= 4
    names = os.listdir(dbg)
    assert all(re.fullmatch(r"\d+-\d+-\d+-[a-z-]+\.(txt|log|wrl)", n) for n in names), names
    all_m = [n for n in names if n.endswith("matches-all.txt")]
    inl_m = [n for n in names if n.endswith("matches-inlier.txt")]
    logs = [n for n in names if n.endswith("track-length.log")]
    scenes = [n for n in names if n.endswith("scene.wrl")]
    assert len(all_m) >= 3 and len(inl_m) >= 3
    assert len(logs) >= 2 and len(scenes) >= 2
    rows = np.loadtxt(dbg / sorted(all_m)[0], comments="#")
    assert rows.shape[1] == 5 and len(rows) > 10
    inl = np.loadtxt(dbg / sorted(inl_m)[0], comments="#")
    assert set(inl[:, 4]) <= {0.0, 1.0} and 0 < inl[:, 4].sum() <= len(inl)
    txt = (dbg / sorted(scenes)[0]).read_text()
    assert txt.startswith("#VRML V2.0 utf8")
    npts = txt.split("point [\n")[1].split("]")[0].strip().count("\n") + 1
    ncol = txt.split("color [\n")[1].split("]")[0].strip().count("\n") + 1
    assert npts == ncol > 5
    log = (dbg / sorted(logs)[0]).read_text()
    assert "Point 3D-ID:" in log and "Track-length:" in log


def test_cli_refuses_the_cpu_unless_asked(cli_runs, monkeypatch, capsys):
    """Without --device the CLI runs on the card; where there is none it
    exits 1 naming --device cpu, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp = cli_runs[0]
    rc = tcli.main(["--input-path", str(tmp / "data"), "--output-path",
                    str(tmp / "refused")] + FLAGS)
    assert rc == 1 and "--device cpu" in capsys.readouterr().err
    assert not (tmp / "refused").exists()


def test_cli_parallel_segments_writes_one_map(cli_runs):
    """--parallel-segments 2 maps two overlapping segments and merges them:
    the outputs come from one map of every image."""
    tmp = cli_runs[0]
    out = tmp / "segments"
    run = tcli.run(["--input-path", str(tmp / "data"), "--output-path", str(out),
                    "--cache-path", str(tmp / "tcache"), "--device", "cpu",
                    "--parallel-segments", "2", "--segment-overlap", "3"] + FLAGS)
    assert run.rc == 0
    assert len(run.result.mappers) == 1
    assert "merge" in run.result.timings
    assert [r[0] for r in _rows(out / "imagedataout.txt")] == [f"img{i}" for i in range(N)]
    assert len(_rows(out / "points3D.txt")) > 100


def test_cli_matcher_backend_xla_writes_the_default_outputs(cli_runs):
    """--matcher-backend xla runs the plain PyTorch matcher through the
    whole CLI: the mapper records it, and the outputs name the default
    run's images with the same poses (1e-5) and as many points."""
    tmp, _, _, default = cli_runs
    out = tmp / "xla"
    run = tcli.run(["--input-path", str(tmp / "data"), "--output-path", str(out),
                    "--cache-path", str(tmp / "tcache"), "--device", "cpu",
                    "--matcher-backend", "xla"] + FLAGS)
    assert run.rc == 0
    assert run.result.main_mapper.matcher_backend_resolved == "xla"
    assert default.result.main_mapper.matcher_backend_resolved == "pallas"
    got, ref = _rows(out / "imagedataout.txt"), _rows(tmp / "tout" / "imagedataout.txt")
    assert [r[0] for r in got] == [r[0] for r in ref]
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in ref], float), rtol=0, atol=1e-5)
    assert len(_rows(out / "points3D.txt")) == len(_rows(tmp / "tout" / "points3D.txt"))


def test_cli_rejects_pipeline_chains(tmp_path, capsys):
    """The JAX CLI's --pipeline-chains is not a flag of the port: argparse
    exits 2 naming it, before any work."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["--input-path", str(tmp_path), "--output-path", str(tmp_path / "out"),
                   "--device", "cpu", "--pipeline-chains"] + FLAGS)
    assert e.value.code == 2
    assert "unrecognized arguments: --pipeline-chains" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_fingerprint_holds_every_detector_parameter():
    """Repair of the JAX CLI (cli.py:250-253): min_per_cell enters the
    cache fingerprint also at its default 0."""
    p = tcli.build_parser()
    a0 = p.parse_args(["--input-path", "x", "--output-path", "y"])
    a5 = p.parse_args(["--input-path", "x", "--output-path", "y",
                       "--surf-adaptive-min-per-cell", "5"])
    d0, d5 = tcli.detector_params(a0), tcli.detector_params(a5)
    assert d0["min_per_cell"] == 0 and d5["min_per_cell"] == 5
    assert set(d0) == {"hessian_threshold", "num_octaves", "num_octave_layers", "upright",
                       "grid_size", "max_features", "min_per_cell"}
