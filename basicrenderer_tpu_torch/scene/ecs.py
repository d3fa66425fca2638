"""Minimal flecs-style ECS world.

Host-side stand-in for the reference's flecs dependency (reference:
BasicScene/include/BasicScene/SceneWorldManager.h:10-31 and the render-world
usage in BasicRenderer/src/Managers/Singletons/RendererECSManager.*).

Entities are integer ids; components are arbitrary Python values stored in
per-type dicts (sparse-set style). Supports tags, pair-less relationships via
a dedicated parent component, deferred operations (the reference queues
thread-unsafe world ops — Renderer.cpp:242-370), and simple queries.

This is the *host-side* scene database. Nothing here is traced; the render
bridge (scene/bridge.py) packs component data into fixed-shape device arrays
each frame, which is where PyTorch takes over.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple, Type


class World:
    def __init__(self):
        self._next_id = 1
        self._alive: Set[int] = set()
        # component type -> {entity: value}
        self._stores: Dict[type, Dict[int, Any]] = {}
        self._tags: Dict[str, Set[int]] = {}
        self._deferred: List[Callable[[], None]] = []
        self._lock = threading.RLock()
        self._main_thread = threading.get_ident()
        # observers: component type -> list of (event, fn(entity, value))
        self._observers: Dict[type, List[Tuple[str, Callable[[int, Any], None]]]] = {}

    # -- entity lifecycle --------------------------------------------------
    def entity(self) -> int:
        with self._lock:
            eid = self._next_id
            self._next_id += 1
            self._alive.add(eid)
            return eid

    def destroy(self, eid: int) -> None:
        with self._lock:
            self._alive.discard(eid)
            for store in self._stores.values():
                store.pop(eid, None)
            for members in self._tags.values():
                members.discard(eid)

    def is_alive(self, eid: int) -> bool:
        return eid in self._alive

    def __len__(self) -> int:
        return len(self._alive)

    # -- components --------------------------------------------------------
    def set(self, eid: int, value: Any, ctype: Optional[type] = None) -> None:
        t = ctype or type(value)
        with self._lock:
            store = self._stores.setdefault(t, {})
            is_new = eid not in store
            store[eid] = value
        for event, fn in self._observers.get(t, []):
            if event == ("add" if is_new else "set") or event == "set":
                fn(eid, value)

    def get(self, eid: int, ctype: Type) -> Any:
        return self._stores.get(ctype, {}).get(eid)

    def has(self, eid: int, ctype: Type) -> bool:
        return eid in self._stores.get(ctype, {})

    def remove(self, eid: int, ctype: Type) -> None:
        with self._lock:
            self._stores.get(ctype, {}).pop(eid, None)

    # -- tags ---------------------------------------------------------------
    def add_tag(self, eid: int, tag: str) -> None:
        with self._lock:
            self._tags.setdefault(tag, set()).add(eid)

    def remove_tag(self, eid: int, tag: str) -> None:
        with self._lock:
            self._tags.get(tag, set()).discard(eid)

    def has_tag(self, eid: int, tag: str) -> bool:
        return eid in self._tags.get(tag, set())

    def with_tag(self, tag: str) -> Set[int]:
        return set(self._tags.get(tag, set()))

    def clear_tag(self, tag: str) -> None:
        """Remove a tag from every entity (reference clears
        RenderTransformUpdated each frame, Renderer.cpp:1891-1895)."""
        with self._lock:
            self._tags.get(tag, set()).clear()

    # -- queries -------------------------------------------------------------
    def query(self, *ctypes: Type, tag: Optional[str] = None) -> Iterator[Tuple[int, tuple]]:
        """Iterate (entity, (comp0, comp1, ...)) for entities having all ctypes."""
        if not ctypes:
            return
        stores = [self._stores.get(t, {}) for t in ctypes]
        base = min(stores, key=len)
        tagset = self._tags.get(tag) if tag else None
        for eid in list(base.keys()):
            if eid not in self._alive:
                continue
            if tagset is not None and eid not in tagset:
                continue
            vals = []
            ok = True
            for st in stores:
                v = st.get(eid)
                if v is None and eid not in st:
                    ok = False
                    break
                vals.append(v)
            if ok:
                yield eid, tuple(vals)

    def count(self, ctype: Type) -> int:
        return len(self._stores.get(ctype, {}))

    # -- observers -----------------------------------------------------------
    def observe(self, ctype: Type, event: str, fn: Callable[[int, Any], None]) -> None:
        self._observers.setdefault(ctype, []).append((event, fn))

    # -- deferred ops (thread-safe entity create/destroy from workers) -------
    def defer(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._deferred.append(fn)

    def flush_deferred(self) -> None:
        with self._lock:
            ops, self._deferred = self._deferred, []
        for fn in ops:
            fn()
