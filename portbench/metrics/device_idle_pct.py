"""The device's idle share of the profiled frames: 100 x (1 - the merged
kernel, memcpy and memset intervals over the profiled span)."""

MOVES = "frame_ms"


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
