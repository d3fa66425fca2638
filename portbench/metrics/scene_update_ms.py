"""The Renderer's host scene sync: telemetry "scene_update" +
"scene_commit", host ms, mean a frame over the measured window."""

MOVES = "frame_ms"


def read(rec):
    st = rec["stages_ms"]
    if "scene_update" not in st and "scene_commit" not in st:
        return None
    return (st.get("scene_update", 0.0) + st.get("scene_commit", 0.0)) \
        / rec["frames"]
