"""The port's settings registry and frame telemetry (utils/settings.py,
utils/telemetry.py): tests/test_settings.py on the port, the catalog
against the JAX package's, and the telemetry's lazy counters."""

import json

import pytest
import torch

from basicrenderer_tpu.utils.settings import \
    make_default_settings as j_make_default_settings
from basicrenderer_tpu_torch.utils.settings import make_default_settings
from basicrenderer_tpu_torch.utils.telemetry import FrameTelemetry


def test_catalog_matches_jax():
    """Names, defaults, types and structural flags equal to the JAX
    package's make_default_settings(), in the same order."""
    ps, js = make_default_settings(), j_make_default_settings()
    assert list(ps._settings) == list(js._settings)
    for name, j in js._settings.items():
        p = ps._settings[name]
        assert (p.value, p.dtype, p.structural) == \
            (j.value, j.dtype, j.structural), name
    assert ps.structural_key() == js.structural_key()


def test_set_unknown_key_raises():
    s = make_default_settings()
    with pytest.raises(KeyError, match="unknown setting"):
        s.set("textureDownscale", 2)   # the historical typo


def test_set_registered_key_works():
    s = make_default_settings()
    s.set("exposure", 2.0)
    assert s.get("exposure") == 2.0


def test_structural_generation_bumps():
    s = make_default_settings()
    g0 = s.generation
    s.set("enableGTAO", True)
    assert s.generation == g0 + 1
    s.set("exposure", 3.0)       # value-only: no bump
    assert s.generation == g0 + 1


def test_subscribers_see_changes():
    s = make_default_settings()
    seen = []
    s.subscribe("bloomIntensity", seen.append)
    s.set("bloomIntensity", 0.5)
    s.set("bloomIntensity", 0.5)  # unchanged: no callback
    assert seen == [0.5]


def test_load_json_skips_unknown_keys(tmp_path):
    s = make_default_settings()
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"exposure": 4.0, "staleKeyFromOldBuild": 1}))
    s.load_json(str(p))
    assert s.get("exposure") == 4.0
    assert not s.registered("staleKeyFromOldBuild")


def test_save_load_roundtrip(tmp_path):
    s = make_default_settings()
    s.set("exposure", 1.5)
    p = str(tmp_path / "cfg.json")
    s.save_json(p)
    s2 = make_default_settings()
    s2.load_json(p)
    assert s2.get("exposure") == 1.5


def test_telemetry_keeps_tensors_and_reads_them_on_dump(tmp_path):
    """record_frame_outputs keeps the counters as tensors (no read in the
    frame); dump_json reads them then; stages and averages add up."""
    t = FrameTelemetry(history=2)
    for k in range(3):
        t.begin_frame()
        with t.stage("dispatch"):
            pass
        t.counter("custom", k)
        t.record_frame_outputs({"num_pairs": torch.tensor(7 + k),
                                "bin_overflow": torch.tensor(0),
                                "image": torch.zeros(2)})
        t.end_frame()
    last = t.last()
    assert isinstance(last["counters"]["num_pairs"], torch.Tensor)
    assert "image" not in last["counters"]
    assert len(t.history) == 2 and t.frame_index == 3
    avg = t.averages()
    assert set(avg) == {"frame_ms", "stage.dispatch"}
    p = tmp_path / "telemetry.json"
    t.dump_json(str(p))
    frames = json.loads(p.read_text())
    assert [f["frame"] for f in frames] == [1, 2]
    assert frames[-1]["counters"] == {"custom": 2, "num_pairs": 9,
                                      "bin_overflow": 0}
