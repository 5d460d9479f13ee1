"""Network serve front door: wire protocol, TCP server, client (the port
of libskylark_tpu/net/).

The delivery path for the serve stack (docs/networking): a
deterministic pickle-free framed protocol
(:mod:`~libskylark_tpu_torch.net.wire`), a threaded TCP server adapting
connections onto a router or an executor
(:mod:`~libskylark_tpu_torch.net.server`), and a retry-safe blocking
client with the same future-shaped surface as ``Router.submit``
(:mod:`~libskylark_tpu_torch.net.client`). Everything above the socket —
QoS admission, single-flight coalescing, caching, sessions, training
— is the existing in-process stack; the net tier only moves frames.
"""

from __future__ import annotations

from libskylark_tpu_torch.net.client import NetClient
from libskylark_tpu_torch.net.server import NetServer, net_stats
from libskylark_tpu_torch.net.wire import PeerClosed

__all__ = ["NetClient", "NetServer", "PeerClosed", "net_stats"]
