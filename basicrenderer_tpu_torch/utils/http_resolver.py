"""Remote asset resolver with a local cache.

Port of basicrenderer_tpu/utils/http_resolver.py. `resolve(uri)` returns a
local file path: local paths pass through; a remote URL is downloaded
once into the cache directory (keyed by the URL's hash) and read from
there after. The cache is the port's own, under
basicrenderer_tpu_torch/_build/assets/, and may be seeded by hand so that
a machine without network access resolves URLs from it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request
from pathlib import Path

CACHE_DIR = str(Path(__file__).resolve().parents[1] / "_build" / "assets")


def resolve(uri: str, timeout: float = 30.0) -> str:
    """URL or path -> local file path (downloads + caches URLs)."""
    if not (uri.startswith("http://") or uri.startswith("https://")):
        return uri
    os.makedirs(CACHE_DIR, exist_ok=True)
    name = hashlib.sha1(uri.encode()).hexdigest()[:20]
    ext = os.path.splitext(uri.split("?")[0])[1][:8]
    path = os.path.join(CACHE_DIR, name + ext)
    if os.path.exists(path):
        return path
    tmp = path + ".part"
    with urllib.request.urlopen(uri, timeout=timeout) as r, \
            open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, path)
    return path
