"""The harness finds every configuration, traffic mix, scene and metric
that BENCHMARK.json names, by name."""

import json
import os

import pytest

from portbench import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(workload):
    spec = harness.cell_spec(BENCH, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    for key in ("scene", "scene_params", "camera", "settings", "source",
                "reduced", "assumed"):
        assert key in cfg, key
    assert callable(harness.load_module("scenes", cfg["scene"]).build)
    assert set(cfg["settings"]) <= set(_settings_catalog())
    for key in ("amplitude_rad", "rad_per_frame", "warm", "frames_in_flight",
                "trace_frames"):
        assert key in traffic, key
    assert traffic["frames_in_flight"] == 3
    assert {m["name"] for m in spec["end_to_end"]} >= {"frame_ms",
                                                       "peak_mem_gib",
                                                       "setup_s"}
    assert spec["per_layer"]


def _settings_catalog():
    from basicrenderer_tpu_torch.utils.settings import make_default_settings
    return make_default_settings().to_dict()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_module(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    mod = harness.load_module("metrics", metric)
    assert mod.MOVES == entry["moves"] == "frame_ms"
    assert callable(mod.read)
    if getattr(mod, "CAPTURE", None):
        assert callable(mod.bound_ms)


def test_config_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and os.path.exists(
            os.path.join(harness.ROOT, f))


def test_camera_paths_periodic():
    orbit = harness.load_json(os.path.join(harness.HERE, "traffic",
                                           "full-orbit.json"))
    assert orbit["amplitude_rad"] == 0.0
    assert harness.camera_angle(orbit, 157) == pytest.approx(3.14)
    sweep = {"rad_per_frame": 0.008, "amplitude_rad": 0.2}
    angles = [harness.camera_angle(sweep, n) for n in range(201)]
    assert max(angles) == pytest.approx(0.2)
    assert min(angles) == pytest.approx(-0.2)
    assert harness.camera_angle(sweep, 100) == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 3 * 10 ** 9])
def test_scene_same_sizes_every_seed(seed):
    """Every seed gives the same meshes (and so the same work), objects
    placed otherwise; triangles run counter-clockwise about their
    normals."""
    import numpy as np
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "courtyard-soup.json"))
    a = harness.build_scene(cfg, seed)
    b = harness.build_scene(cfg, seed + 1)
    assert [m["indices"].shape for m in a["meshes"]] == \
        [m["indices"].shape for m in b["meshes"]]
    assert a["objects"][1]["position"] != b["objects"][1]["position"]
    for m in a["meshes"][:4]:
        p, i = m["positions"], m["indices"]
        g = np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]])
        assert (np.sum(g * m["normals"][i].sum(1), 1) > 0).all()


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_near_clip_budget_covers_orbit(seed):
    """No frame of the orbit has more triangles crossing the camera plane
    (w = 1e-3, as the port's near clip counts them) than the
    configuration's near-clip budget, whatever the seed."""
    import numpy as np
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "courtyard-soup.json"))
    orbit = harness.load_json(os.path.join(harness.HERE, "traffic",
                                           "full-orbit.json"))
    desc = harness.build_scene(cfg, seed)
    corners = []
    for ob in desc["objects"]:
        m = desc["meshes"][ob["mesh"]]
        c, s = np.cos(ob["yaw"]), np.sin(ob["yaw"])
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        p = m["positions"].astype(np.float64) * ob["scale"] @ rot.T
        corners.append((p + ob["position"])[m["indices"]])
    corners = np.concatenate(corners)                     # (T, 3, 3)
    period = round(2 * np.pi / orbit["rad_per_frame"]) + 1
    most = 0
    for n in range(period):
        pos, target = harness.camera_pose(cfg["camera"], orbit, n)
        fwd = np.subtract(target, pos)
        inside = ((corners - pos) @ (fwd / np.linalg.norm(fwd)) > 1e-3).sum(1)
        most = max(most, int(((inside >= 1) & (inside <= 2)).sum()))
    assert 0 < most <= cfg["frame_config"]["near_clip_tris"]
