"""Host-side publish/subscribe event bus (a copy of
invesalius3_tpu/events.py: same topics, same kwargs; the port keeps its
own process-wide ``bus``).

The reference glues GUI <-> control <-> data <-> navigation through a
process-wide PyPubSub wrapper (reference invesalius/pubsub/pub.py:25-89)
with an optional global send hook used to mirror every event to a remote
Socket.IO server.  This is a dependency-free re-implementation with the
same surface: ``subscribe`` / ``unsubscribe`` / ``send_message`` /
``send_message_no_hook`` / ``add_send_message_hook`` plus topic
hierarchies ("a.b.c" listeners fire for "a.b.c.d") and ALL_TOPICS.

Device work never rides the bus — only host-side state notifications.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

ALL_TOPICS = "__all_topics__"
AUTO_TOPIC = object()  # sentinel: listener wants the topic name injected


class Publisher:
    """A tiny synchronous topic-string pub/sub bus (thread-safe)."""

    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable[..., Any]]] = defaultdict(list)
        self._hook: Optional[Callable[[str, dict], None]] = None
        self._lock = threading.RLock()

    # -- subscription ------------------------------------------------------
    def subscribe(self, listener: Callable[..., Any], topic: str) -> Callable[..., Any]:
        with self._lock:
            if listener not in self._listeners[topic]:
                self._listeners[topic].append(listener)
        return listener

    def unsubscribe(self, listener: Callable[..., Any], topic: str) -> None:
        with self._lock:
            try:
                self._listeners[topic].remove(listener)
            except ValueError:
                pass

    def clear(self, topic: Optional[str] = None) -> None:
        with self._lock:
            if topic is None:
                self._listeners.clear()
            else:
                self._listeners.pop(topic, None)

    # -- publish -----------------------------------------------------------
    def _targets(self, topic: str) -> List[Callable[..., Any]]:
        """Listeners of the topic, its ancestors ('a.b' hears 'a.b.c'), and
        ALL_TOPICS."""
        with self._lock:
            out = list(self._listeners.get(topic, ()))
            parts = topic.split(".")
            for i in range(len(parts) - 1, 0, -1):
                out.extend(self._listeners.get(".".join(parts[:i]), ()))
            out.extend(self._listeners.get(ALL_TOPICS, ()))
        return out

    def send_message_no_hook(self, topic: str, **kwargs: Any) -> None:
        for listener in self._targets(topic):
            wants_topic = getattr(listener, "_wants_topic", False)
            if wants_topic:
                listener(topic=topic, **kwargs)
            else:
                listener(**kwargs)

    def send_message(self, topic: str, **kwargs: Any) -> None:
        self.send_message_no_hook(topic, **kwargs)
        hook = self._hook
        if hook is not None:
            hook(topic, kwargs)

    # -- global hook (remote-control mirror seam) ---------------------------
    def add_send_message_hook(self, hook: Callable[[str, dict], None]) -> None:
        self._hook = hook

    def remove_send_message_hook(self) -> None:
        self._hook = None


def wants_topic(listener: Callable[..., Any]) -> Callable[..., Any]:
    """Decorator: deliver the topic name as a ``topic=`` kwarg (AUTO_TOPIC
    analog)."""
    listener._wants_topic = True  # type: ignore[attr-defined]
    return listener


# Process-wide default bus (the reference uses a module-level Publisher).
bus = Publisher()

subscribe = bus.subscribe
unsubscribe = bus.unsubscribe
send_message = bus.send_message
send_message_no_hook = bus.send_message_no_hook
add_send_message_hook = bus.add_send_message_hook
remove_send_message_hook = bus.remove_send_message_hook
