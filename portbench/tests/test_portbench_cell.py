"""A tiny soup cell runs end to end on the CPU (the harness's look for a
card skipped), and the check fails a run whose timed path is broken
underneath."""

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import check, harness
from portbench.reference import Reference
from portbench.tests.tiny import tiny_spec


def run(spec, trace=False, seed=2 ** 31 + 11):
    import time
    return harness.run_cell(spec, seed, 0.5, trace, time.perf_counter(),
                            device="cpu")


def test_tiny_cell_end_to_end():
    res = run(tiny_spec())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "peak_mem_gib", "setup_s"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(check.LIMITS)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_tiny_cell_traced():
    res = run(tiny_spec(), trace=True)
    assert res["correct"] is True
    assert {"frame_ms_p95", "scene_update_ms",
            "dispatch_ms"} <= set(res["metrics"])
    assert "breakdown" in res and "busy_s" in res["device"]
    assert list(res)[-1] == "checks"


def test_frame_config_reaches_renderer():
    """The configuration's `frame_config` fields are set on the
    FrameConfig that the Renderer builds."""
    spec = tiny_spec()
    cfg = spec["config"]
    r, _scene = harness.build_program(
        cfg, harness.build_scene(cfg, 3), "cpu")
    for k, v in cfg["frame_config"].items():
        assert getattr(r.current_config(), k) == v
    assert r.current_config().width == cfg["settings"]["renderResolution"][0]


def test_run_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "courtyard-soup-orbit", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def _broken(monkeypatch, fault):
    """The port's frame function, broken underneath by `fault(out,
    kwargs)`."""
    from basicrenderer_tpu_torch.graph import frame
    build = frame.build_frame_fn

    def build_broken(config):
        fn = build(config)

        def broken(*a, **kw):
            out = fn(*a, **kw)
            fault(out, kw)
            return out
        return broken
    monkeypatch.setattr(frame, "build_frame_fn", build_broken)


def _frozen(out, kw, first={}):
    """The frame is no longer rendered: every call returns the first
    call's outputs."""
    first.setdefault("out", {k: v.clone() for k, v in out.items()
                             if hasattr(v, "clone")})
    out.update(first["out"])


def _half_left_out(out, kw):
    h = out["hdr"].shape[0]
    for k in ("vis", "depth", "hdr", "image"):
        out[k] = out[k].clone()
        out[k][h // 2:] = 0


def _answer_altered(out, kw):
    out["vis"] = out["vis"].clone()
    out["vis"][8:40, 16:48] += 1


@pytest.mark.parametrize("fault", [_frozen, _half_left_out, _answer_altered],
                         ids=["frame_unchanged", "half_left_out",
                              "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault is _frozen:
        fault = functools.partial(_frozen, first={})
    _broken(monkeypatch, fault)
    res = run(tiny_spec())
    assert res["correct"] is False, res["checks"]


def test_control_is_not_correct():
    """The control (the reference with its matrix products in TF32) in the
    program's place fails the check at the cell's own size: its scene,
    1920x1080, a frame of its camera path."""
    spec = harness.cell_spec(json.load(
        open(os.path.join(harness.ROOT, "BENCHMARK.json"))),
        "courtyard-soup-orbit")
    cfg = spec["config"]
    w, h = cfg["settings"]["renderResolution"]
    desc = harness.build_scene(cfg, 2 ** 31 + 5)
    pos, target = harness.camera_pose(cfg["camera"], spec["traffic"], 40)
    cam = (pos, target, cfg["camera"]["fov_y"], cfg["camera"]["near"])
    want = Reference(desc, w, h, cfg["settings"], "cpu").frame(*cam)
    got = Reference(desc, w, h, cfg["settings"], "cpu", "tf32").frame(*cam)
    ctl = check.compare(got, want)
    assert any(ctl[k] > check.LIMITS[k] for k in check.LIMITS), ctl


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_tiny_cell_on_card(card):
    """The tiny cell on the card: the port's kernels against the plain
    reference, and the TF32 control read beside them."""
    import time
    res = harness.run_cell(tiny_spec(), 5, 0.5, False, time.perf_counter(),
                           device="cuda", controls=("tf32",))
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert set(res["controls"]["tf32"]) == set(res["checks"])
