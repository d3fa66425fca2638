"""Input events: action mapping + per-frame pump.

Host-only copy of basicrenderer_tpu/utils/input.py.

Reference analogue: the input stack (reference:
BasicRenderer/include/Input/InputAction.h — the action set,
InputContext.h — WASD/orbital contexts triggering registered action
handlers from raw window messages). The framework is headless, so raw
events arrive from any producer (the UI server's /input endpoint, a test,
an embedding app) into a thread-safe queue; `InputPump.pump(dt)` drains
them on the frame thread, the active context translates events to
actions, and registered handlers fire — the same
context/action/handler shape, with the Win32 message loop replaced by
the queue.

Held keys fire their movement actions every pump with magnitude dt
(frame-rate-independent motion, like the reference's per-frame key
state scan)."""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class InputAction(enum.Enum):
    MOVE_FORWARD = "move_forward"
    MOVE_BACKWARD = "move_backward"
    MOVE_RIGHT = "move_right"
    MOVE_LEFT = "move_left"
    MOVE_UP = "move_up"
    MOVE_DOWN = "move_down"
    ROTATE_CAMERA = "rotate_camera"
    ZOOM_IN = "zoom_in"
    ZOOM_OUT = "zoom_out"
    RESET = "reset"


@dataclass
class InputEvent:
    kind: str                 # key_down | key_up | mouse_move | wheel
    key: str = ""
    dx: float = 0.0
    dy: float = 0.0
    wheel: float = 0.0
    buttons: int = 0          # bitmask: 1 = left, 2 = right


class InputContext:
    """Action-handler registry (reference: InputContext::SetActionHandler /
    TriggerAction)."""

    def __init__(self):
        self._handlers: Dict[InputAction, List[Callable]] = {}

    def on(self, action: InputAction, handler: Callable[[float, InputEvent],
                                                        None]):
        self._handlers.setdefault(action, []).append(handler)
        return self

    def trigger(self, action: InputAction, magnitude: float,
                event: InputEvent):
        for h in self._handlers.get(action, ()):
            h(magnitude, event)

    # Subclasses implement:
    def process(self, event: InputEvent):
        raise NotImplementedError

    def tick(self, dt: float):
        """Per-frame held-state actions (movement)."""


_WASD_KEYS = {
    "w": InputAction.MOVE_FORWARD, "s": InputAction.MOVE_BACKWARD,
    "d": InputAction.MOVE_RIGHT, "a": InputAction.MOVE_LEFT,
    "e": InputAction.MOVE_UP, "q": InputAction.MOVE_DOWN,
}


class WASDContext(InputContext):
    """Fly-camera bindings (reference: WASDContext). Held WASD/QE keys
    fire movement actions each tick with magnitude dt; mouse motion with
    the right button held rotates; 'r' resets."""

    def __init__(self):
        super().__init__()
        self.pressed: set = set()

    def process(self, event: InputEvent):
        if event.kind == "key_down":
            k = event.key.lower()
            if k == "r":
                self.trigger(InputAction.RESET, 1.0, event)
            else:
                self.pressed.add(k)
        elif event.kind == "key_up":
            self.pressed.discard(event.key.lower())
        elif event.kind == "mouse_move" and (event.buttons & 2):
            self.trigger(InputAction.ROTATE_CAMERA, 1.0, event)
        elif event.kind == "wheel":
            self.trigger(InputAction.ZOOM_IN if event.wheel > 0
                         else InputAction.ZOOM_OUT,
                         abs(event.wheel), event)

    def tick(self, dt: float):
        for k in self.pressed:
            a = _WASD_KEYS.get(k)
            if a is not None:
                self.trigger(a, dt, InputEvent("held", key=k))


class OrbitContext(InputContext):
    """Orbit-camera bindings (reference: the orbital InputMode): left-drag
    orbits, wheel zooms."""

    def process(self, event: InputEvent):
        if event.kind == "mouse_move" and (event.buttons & 1):
            self.trigger(InputAction.ROTATE_CAMERA, 1.0, event)
        elif event.kind == "wheel":
            self.trigger(InputAction.ZOOM_IN if event.wheel > 0
                         else InputAction.ZOOM_OUT,
                         abs(event.wheel), event)


class InputPump:
    """Thread-safe event queue + per-frame dispatch (the message-loop
    analogue). Producers call `push` from any thread; the frame thread
    calls `pump(dt)` once per frame."""

    def __init__(self, context: Optional[InputContext] = None):
        self._lock = threading.Lock()
        self._events: List[InputEvent] = []
        self.context = context or WASDContext()

    def push(self, event: InputEvent):
        with self._lock:
            self._events.append(event)

    def push_raw(self, kind: str, **kw):
        self.push(InputEvent(kind, **kw))

    def pump(self, dt: float) -> int:
        """Drain queued events into the active context, then tick held
        state. Returns the number of events processed."""
        with self._lock:
            batch, self._events = self._events, []
        for e in batch:
            self.context.process(e)
        self.context.tick(dt)
        return len(batch)


def attach_fly(pump: InputPump, cam):
    """Wire a WASDContext to a utils.camera.FlyCamera (speeds live on the
    camera: move_speed units/s, look_speed radians/px)."""
    ctx = pump.context
    ctx.on(InputAction.MOVE_FORWARD, lambda dt, e: cam.move(dt, forward=1.0))
    ctx.on(InputAction.MOVE_BACKWARD,
           lambda dt, e: cam.move(dt, forward=-1.0))
    ctx.on(InputAction.MOVE_RIGHT, lambda dt, e: cam.move(dt, strafe=1.0))
    ctx.on(InputAction.MOVE_LEFT, lambda dt, e: cam.move(dt, strafe=-1.0))
    ctx.on(InputAction.MOVE_UP, lambda dt, e: cam.move(dt, up=1.0))
    ctx.on(InputAction.MOVE_DOWN, lambda dt, e: cam.move(dt, up=-1.0))
    ctx.on(InputAction.ROTATE_CAMERA, lambda m, e: cam.look(e.dx, e.dy))
    return ctx


def attach_orbit(pump: InputPump, cam):
    """Wire an OrbitContext to a utils.camera.OrbitCamera."""
    ctx = pump.context
    ctx.on(InputAction.ROTATE_CAMERA, lambda m, e: cam.orbit(e.dx, e.dy))
    ctx.on(InputAction.ZOOM_IN, lambda m, e: cam.zoom(m))
    ctx.on(InputAction.ZOOM_OUT, lambda m, e: cam.zoom(-m))
    return ctx
