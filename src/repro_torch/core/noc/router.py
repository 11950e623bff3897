"""Router / network configuration and energy constants.

Timing parameters follow the paper's Table III exactly.  Energy constants are
Orion-3.0-style per-event energies (45 nm-class, pJ); the paper reports power
*ratios*, which are insensitive to the absolute scale — see EXPERIMENTS.md for
the calibration note.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


from typing import Optional


@dataclass(frozen=True)
class NocConfig:
    # ---- Table III timing ---------------------------------------------------
    n: int = 8                      # mesh width W in columns (8x8 square)
    router_cycles: int = 4          # router pipeline depth
    link_cycles: int = 1            # link traversal
    flit_bits: int = 128            # flit size
    vcs: int = 2                    # virtual channels (separate port resources)
    buffer_depth: int = 4           # flits per VC buffer
    gather_payload_bits: int = 32   # per-result payload in a gather packet

    # ---- NI / PE timing (eject->add->inject path, Fig. 4a) ------------------
    ni_cycles: int = 2              # network interface traversal (each direction)
    pe_add_cycles: int = 1          # local psum add (paper: comparable to INA add)
    mac_per_cycle: int = 1          # MACs per PE per cycle

    # ---- streaming architecture [12] ----------------------------------------
    # Two-way row streaming buses; each direction moves one flit per cycle.
    stream_buses_per_row: int = 2
    # Effective input-activation reuse on the streaming bus (row broadcast x
    # sliding-window overlap x cross-filter sharing).  Applies to WS and OS.
    ws_input_reuse: float = 64.0
    # OS weight reuse on the bus: weights are NOT stationary, so a streamed
    # weight word is only reused across the PEs of one assignment wave,
    # vs. the WS case where it is reused across all O^2 pixels.
    os_weight_reuse: float = 1.5
    # OS streaming concurrency (flits/cycle/row): [12] streams weights/inputs
    # through all row links in parallel (pipelined drop-off), so OS streaming
    # bandwidth exceeds a single bus lane.
    os_stream_bw: float = 28.0
    # How the WS-without-INA baseline returns finished results to the port:
    # "shared_gather" (one column gather packet, as with INA) or
    # "per_chain_unicast" (each chain tail ships its own result packet).
    baseline_collection: str = "shared_gather"

    # ---- Orion-3.0-style per-event energies (pJ) -----------------------------
    e_buf_write: float = 1.2        # per flit, input buffer write (per router)
    e_buf_read: float = 1.0         # per flit, input buffer read (per router)
    e_xbar: float = 0.6             # per flit, crossbar traversal (per router)
    e_arb: float = 0.2              # per packet-hop, switch/VC arbitration
    e_link: float = 2.0             # per flit, inter-router link
    e_ni: float = 4.0               # per flit, NI traversal (eject or inject)
    e_pkt_overhead: float = 6.0     # per packet (dis)assembly in the NI/PE
    e_add32: float = 0.1            # 32-bit digital add (router INA block / PE ALU)
    e_stream_bus: float = 1.6       # per flit-segment on the streaming bus (wire)
    e_mac: float = 0.8              # per MAC in the PE (common to all modes)

    # ---- mesh shape (mapper search space; DESIGN.md S9) ----------------------
    # Mesh height H in rows; None keeps the paper's square N x N.  The WS
    # placement puts chains in columns (height) and streams over rows (width),
    # so rectangular meshes trade chain capacity against column count.
    rows: Optional[int] = None

    @property
    def width(self) -> int:
        """Mesh width W (columns)."""
        return self.n

    @property
    def height(self) -> int:
        """Mesh height H (rows); equals ``n`` for the paper's square mesh."""
        return self.rows if self.rows is not None else self.n

    @property
    def num_nodes(self) -> int:
        return self.width * self.height

    @property
    def e_router_flit(self) -> float:
        return self.e_buf_write + self.e_buf_read + self.e_xbar

    def payload_flits(self, payload_bits: float) -> int:
        """Flits needed for a payload (excluding the header flit).

        Ceils on the *float* bit count: reuse-scaled payloads are fractional,
        and truncating before the ceiling division undercounts (128.5 bits
        must occupy 2 flits of 128, not 1).
        """
        return max(1, math.ceil(payload_bits / self.flit_bits))

    def unicast_flits(self, e_pes: int) -> int:
        """Unicast psum packet: header + E psum words (Table III: 2-3 flits)."""
        return 1 + self.payload_flits(e_pes * self.gather_payload_bits)

    def gather_flits(self, results: int) -> int:
        """Gather packet: header + collected results (Table III: 3/5/9 flits)."""
        return 1 + self.payload_flits(results * self.gather_payload_bits)


def cached_field_hash(self):
    """Hash of the field tuple, computed once per instance.

    ``NocConfig`` is a member of every window-cache key, so the generated
    dataclass ``__hash__`` (re-hashing 20+ fields per lookup) showed up in
    sweep profiles.  The cache lives outside the field set: invisible to
    ``repr``/``asdict``/``replace``/``__eq__``, and valid in one process
    only: a string's hash differs between processes, so a pickled copy
    (a spawned pool worker's key, :mod:`repro_torch.exec.pool`) leaves the
    cache behind (:func:`state_without_hash`).
    """
    h = self.__dict__.get("_hash_cache")
    if h is None:
        h = hash(tuple(self.__dict__[f] for f in self.__dataclass_fields__))
        object.__setattr__(self, "_hash_cache", h)
    return h


def state_without_hash(self) -> dict:
    """Pickled state of a :func:`cached_field_hash` instance: its fields,
    never the cached hash, which the receiving process computes anew."""
    return {k: v for k, v in self.__dict__.items() if k != "_hash_cache"}


NocConfig.__hash__ = cached_field_hash
NocConfig.__getstate__ = state_without_hash


@dataclass
class EnergyLedger:
    """Event-count energy accumulator (the Orion model is event-based)."""

    flit_routers: float = 0   # flit x router traversals (buffers + crossbar)
    flit_links: float = 0     # flit x link traversals
    packet_hops: float = 0    # per-hop arbitration events
    ni_flits: float = 0       # flit x NI crossings (eject or inject direction)
    packets_built: float = 0  # packet (dis)assembly events
    router_adds: float = 0    # INA-block additions
    pe_adds: float = 0        # local PE additions (baseline path)
    stream_flit_segments: float = 0   # streaming-bus flit x segment
    macs: float = 0

    def network_energy_pj(self, cfg: NocConfig) -> float:
        """NoC energy: routers + links + NI + packetization + adders."""
        return (self.flit_routers * cfg.e_router_flit
                + self.flit_links * cfg.e_link
                + self.packet_hops * cfg.e_arb
                + self.ni_flits * cfg.e_ni
                + self.packets_built * cfg.e_pkt_overhead
                + self.router_adds * cfg.e_add32
                + self.pe_adds * cfg.e_add32)

    def energy_pj(self, cfg: NocConfig) -> float:
        """Network + streaming-bus + MAC energy."""
        return (self.network_energy_pj(cfg)
                + self.stream_flit_segments * cfg.e_stream_bus
                + self.macs * cfg.e_mac)

    def add(self, other: "EnergyLedger") -> None:
        """Add ``other``'s counts into this ledger."""
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def copy(self) -> "EnergyLedger":
        """Cheap exact copy."""
        return EnergyLedger(**self.__dict__)

    def as_tuple(self) -> tuple:
        """Field values in declaration order (persistent-store payload)."""
        return tuple(self.__dict__[f] for f in self.__dataclass_fields__)

    @classmethod
    def from_tuple(cls, values) -> "EnergyLedger":
        return cls(**dict(zip(cls.__dataclass_fields__, values)))

    def scaled(self, k: float) -> "EnergyLedger":
        out = EnergyLedger()
        for f in self.__dataclass_fields__:
            setattr(out, f, getattr(self, f) * k)
        return out
