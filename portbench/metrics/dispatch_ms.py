"""Frame dispatch: telemetry "dispatch" (the frame function's enqueue,
with the frame's own host reads), host ms, mean a frame over the measured
window."""

MOVES = "frame_ms"


def read(rec):
    st = rec["stages_ms"]
    return st["dispatch"] / rec["frames"] if "dispatch" in st else None
