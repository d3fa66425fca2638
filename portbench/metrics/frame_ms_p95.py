"""Stutter: the 95th percentile of the intervals between consecutive
frames' completion (CUDA events recorded after each render), over every
frame of the measured window."""

import numpy as np

MOVES = "frame_ms"


def read(rec):
    iv = rec["intervals_ms"]
    return float(np.percentile(iv, 95)) if len(iv) else None
