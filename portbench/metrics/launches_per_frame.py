"""Device operations a frame: the kernel, memcpy and memset events of the
profiled frames over their count."""

MOVES = "frame_ms"


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["events"]:
        return None
    return len(tr["events"]) / tr["frames"]
