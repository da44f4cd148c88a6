"""Hierarchical Resource Graph (paper §7, "Topology-Aware Resource
Coordination"): server (GPU mem, PCIe) → rack (network) → cluster (storage)
levels with scaling-event markers, so concurrent scale-ups route away from
recently contended paths.  Ported from ``repro/core/hrg.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.launch.roofline import H100_SXM


@dataclass
class Node:
    name: str
    level: str                          # server | rack | cluster
    capacity: float                     # bytes/s on the bottleneck resource
    inflight: float = 0.0               # currently reserved bandwidth
    recent_events: list = field(default_factory=list)   # (t, bytes)
    children: list = field(default_factory=list)
    parent: "Node | None" = None

    def pressure(self, now: float, horizon: float = 10.0) -> float:
        """Contention score: reserved + recent-event traffic / capacity."""
        recent = sum(b for t, b in self.recent_events if now - t < horizon)
        return (self.inflight + recent / horizon) / max(self.capacity, 1.0)


class HierarchicalResourceGraph:
    def __init__(self):
        self.cluster = Node("cluster", "cluster", capacity=400e9)
        self.racks: dict[str, Node] = {}
        self.servers: dict[str, Node] = {}

    def add_rack(self, name: str, net_bw: float = 100e9 / 8) -> Node:
        r = Node(name, "rack", capacity=net_bw, parent=self.cluster)
        self.cluster.children.append(r)
        self.racks[name] = r
        return r

    def add_server(self, rack: str, name: str,
                   pcie_bw: float = H100_SXM.host_bw) -> Node:
        s = Node(name, "server", capacity=pcie_bw, parent=self.racks[rack])
        self.racks[rack].children.append(s)
        self.servers[name] = s
        return s

    def path(self, server: str) -> list[Node]:
        n = self.servers[server]
        out = [n]
        while n.parent is not None:
            n = n.parent
            out.append(n)
        return out

    def path_pressure(self, server: str, now: float) -> float:
        """Max contention along server→rack→cluster (the bottleneck)."""
        return max(n.pressure(now) for n in self.path(server))

    def least_contended(self, servers: list[str], now: float) -> str:
        # tie-break path pressure on the server-local level so co-racked
        # candidates still discriminate
        return min(servers, key=lambda s: (self.path_pressure(s, now),
                                           self.servers[s].pressure(now)))

    def reserve(self, server: str, byte_rate: float) -> None:
        for n in self.path(server):
            n.inflight += byte_rate

    def release(self, server: str, byte_rate: float) -> None:
        for n in self.path(server):
            n.inflight = max(0.0, n.inflight - byte_rate)

    def mark_event(self, server: str, now: float, nbytes: float) -> None:
        """Annotate a scaling event on the path (the paper's markers)."""
        for n in self.path(server):
            n.recent_events.append((now, nbytes))
            if len(n.recent_events) > 512:
                del n.recent_events[:256]

    def transfer_time(self, server: str, nbytes: float, now: float) -> float:
        """Load time along the path given current contention."""
        t = 0.0
        for n in self.path(server):
            eff = max(n.capacity - n.inflight, n.capacity * 0.05)
            t = max(t, nbytes / eff)
        return t
