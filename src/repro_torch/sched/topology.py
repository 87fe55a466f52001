"""Fleet topology: reconfigurable cores within sockets within hosts.

PyTorch port of `repro.sched.topology` (pure Python, copied as it is).

The flat core pool the placement layer started with prices every
migration identically — fine for 3 cores on one board, wrong at
datacenter scale, where *where* a bitstream is warm decides what a move
costs.  LUTstructions (PAPERS.md) prices reconfiguration as self-loading
instruction cost, and that cost tiers naturally by distance:

  * **intra-socket** — the mover's warm state sits one reconfiguration
    port away; the only cost is the *measured* warm-resume delta the
    online layer already probes (`OnlineReplacer.migration_penalty`);
  * **cross-socket** — the destination must re-load every one of the
    mover's resident bitstreams across the socket interconnect: the
    probe cost plus `resident_tags x bs_miss_extra x
    cross_socket_reload` modelled re-load cycles;
  * **cross-host**  — the bitstreams transit the network; same model
    with the (larger) `cross_host_reload` multiplier.

`Topology` is pure geometry + the tier multipliers: core indices are
dense `[0, num_cores)`, laid out host-major then socket-major, so
`core // cores_per_socket` is the global socket and
`core // cores_per_host` the host.  `Topology.flat(n)` (one host, one
socket) reproduces the pre-topology behaviour bit-for-bit: every
distance is intra-socket and every reload multiplier is zero, which is
what keeps the historical churn/chaos anchors unchanged.

The *placement domain* — the scope inside which the per-epoch re-solve
runs its greedy + swap search — is the host: swap search inside a host
may cross sockets (and pays the tier surcharge when it does), while
cross-host moves only happen through arrival placement and fault
evacuation, mirroring how real schedulers treat rack-level migration.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DISTANCES", "Topology"]

# near-to-far move distances the penalty model tiers by; "intra_core"
# is the degenerate src == dst case (no move, no cost)
DISTANCES = ("intra_core", "intra_socket", "cross_socket", "cross_host")


@dataclass(frozen=True)
class Topology:
    """Core geometry plus the LUTstructions re-load tier multipliers.

    `cross_socket_reload` / `cross_host_reload` scale the per-bitstream
    re-load cost (`bs_miss_extra` cycles is the intra-socket baseline the
    measured probe already charges): a cross-socket move pays an *extra*
    `resident_tags x bs_miss_extra x cross_socket_reload` cycles on top
    of the probe, a cross-host move the `cross_host_reload` variant.
    """

    num_hosts: int = 1
    sockets_per_host: int = 1
    cores_per_socket: int = 1
    cross_socket_reload: float = 4.0
    cross_host_reload: float = 16.0

    def __post_init__(self):
        for name in ("num_hosts", "sockets_per_host", "cores_per_socket"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        if self.cross_socket_reload < 0 or self.cross_host_reload < 0:
            raise ValueError(
                f"reload multipliers must be >= 0, got "
                f"cross_socket_reload={self.cross_socket_reload}, "
                f"cross_host_reload={self.cross_host_reload}")
        if self.cross_host_reload < self.cross_socket_reload:
            raise ValueError(
                f"cross_host_reload ({self.cross_host_reload}) must be >= "
                f"cross_socket_reload ({self.cross_socket_reload}) — a "
                f"network re-load cannot be cheaper than a socket one")

    # ------------------------------------------------------------------
    @classmethod
    def flat(cls, num_cores: int) -> "Topology":
        """One host, one socket, `num_cores` cores — the pre-topology
        pool.  Every move is intra-socket, every reload surcharge zero."""
        return cls(num_hosts=1, sockets_per_host=1,
                   cores_per_socket=num_cores)

    # ------------------------------------------------------------------
    @property
    def cores_per_host(self) -> int:
        return self.sockets_per_host * self.cores_per_socket

    @property
    def num_sockets(self) -> int:
        return self.num_hosts * self.sockets_per_host

    @property
    def num_cores(self) -> int:
        return self.num_hosts * self.cores_per_host

    def _check(self, core: int) -> int:
        if not 0 <= core < self.num_cores:
            raise ValueError(
                f"core {core} outside [0, {self.num_cores}) for {self}")
        return core

    def socket_of(self, core: int) -> int:
        """Global socket index of a core."""
        return self._check(core) // self.cores_per_socket

    def host_of(self, core: int) -> int:
        return self._check(core) // self.cores_per_host

    def cores_of_host(self, host: int) -> range:
        if not 0 <= host < self.num_hosts:
            raise ValueError(
                f"host {host} outside [0, {self.num_hosts})")
        lo = host * self.cores_per_host
        return range(lo, lo + self.cores_per_host)

    # ------------------------------------------------------------------
    def distance(self, src: int, dst: int) -> str:
        """Move distance tier between two cores (one of `DISTANCES`)."""
        self._check(src), self._check(dst)
        if src == dst:
            return "intra_core"
        if self.socket_of(src) == self.socket_of(dst):
            return "intra_socket"
        if self.host_of(src) == self.host_of(dst):
            return "cross_socket"
        return "cross_host"

    def reload_multiplier(self, distance: str) -> float:
        """Per-resident-bitstream re-load surcharge multiplier (on
        `bs_miss_extra`) for a move of the given distance.  Zero within
        a socket: the measured warm-resume probe already prices that
        tier."""
        if distance not in DISTANCES:
            raise ValueError(
                f"unknown distance {distance!r}, expected one of "
                f"{DISTANCES}")
        if distance in ("intra_core", "intra_socket"):
            return 0.0
        return (self.cross_socket_reload if distance == "cross_socket"
                else self.cross_host_reload)

    def geometry(self) -> tuple[int, int, int]:
        """(hosts, sockets/host, cores/socket) — the snapshot identity
        a `restore` validates against."""
        return (self.num_hosts, self.sockets_per_host,
                self.cores_per_socket)
