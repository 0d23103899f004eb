"""Memory tier descriptions for heterogeneous memory systems.

The paper pairs a fast-small tier (DRAM) with a slow-big tier (NVM).  On a
CUDA card the same structure appears twice: HBM vs. pinned host memory at
the runtime level and shared memory vs. HBM at the kernel level.  ``TierSpec`` describes one tier;
``MachineProfile`` describes a two-tier machine plus the copy engine between
the tiers (the paper's ``mem_copy_bw``).

Bandwidths are bytes/second, latencies are seconds.  Profiles named after
Table 1 of the paper reproduce its DRAM/STT-RAM/PCRAM/ReRAM numbers;
``H100_HBM_HOST`` is the production target of this package (the TPU
profiles stay so that plans can be compared with the reference package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

GB = 1024 ** 3
MB = 1024 ** 2
NS = 1e-9


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier.

    ``memory_kind`` names where a real payload lives (``device`` = HBM,
    ``pinned_host`` = page-locked host memory); ``None`` means
    simulation-only.
    """

    name: str
    capacity_bytes: int
    read_bw: float          # bytes/s
    write_bw: float         # bytes/s
    read_lat: float         # s
    write_lat: float        # s
    memory_kind: Optional[str] = None

    @property
    def bw(self) -> float:
        """Symmetric effective bandwidth used by Eq. (2)."""
        return min(self.read_bw, self.write_bw)

    @property
    def lat(self) -> float:
        """Symmetric effective latency used by Eq. (3)."""
        return max(self.read_lat, self.write_lat)


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """A two-tier machine: ``fast`` (paper: DRAM) and ``slow`` (paper: NVM)."""

    name: str
    fast: TierSpec
    slow: TierSpec
    copy_bw: float                  # fast<->slow memory copy bandwidth, bytes/s
    cacheline_bytes: int = 64
    sample_rate_hz: float = 2.4e6   # counter sampling rate (1000 cyc @ 2.4 GHz)
    # Peak *measured* bandwidth of the slow tier (paper: STREAM on NVM).
    # Defaults to the spec sheet number when not separately calibrated.
    slow_bw_peak: Optional[float] = None

    @property
    def bw_peak(self) -> float:
        return self.slow_bw_peak if self.slow_bw_peak is not None else self.slow.bw

    def scaled(self, *, bw_scale: float = 1.0, lat_scale: float = 1.0,
               name: Optional[str] = None) -> "MachineProfile":
        """Derive a profile whose slow tier is scaled relative to the fast
        tier — the paper's ``1/2 DRAM bandwidth`` / ``4x DRAM latency``
        emulation knobs (Figs 2-3)."""
        slow = dataclasses.replace(
            self.slow,
            read_bw=self.fast.read_bw * bw_scale,
            write_bw=self.fast.write_bw * bw_scale,
            read_lat=self.fast.read_lat * lat_scale,
            write_lat=self.fast.write_lat * lat_scale,
        )
        return dataclasses.replace(
            self, name=name or f"{self.name}[bw={bw_scale},lat={lat_scale}]",
            slow=slow, slow_bw_peak=None)


def _dram(capacity=256 * MB) -> TierSpec:
    # Sustained per-socket DRAM characteristics of the paper's Platform A
    # (2x E5-2630); Table 1's random-access numbers are captured by the
    # per-technology profiles below via scaled() knobs.
    return TierSpec("DRAM", capacity, 12e9, 10e9, 90 * NS, 90 * NS,
                    memory_kind="device")


def _nvm(read_bw, write_bw, read_lat, write_lat, capacity=16 * GB) -> TierSpec:
    return TierSpec("NVM", capacity, read_bw, write_bw, read_lat, write_lat,
                    memory_kind="pinned_host")


# --- machine profiles (paper's emulated platforms) --------------------------
# Default NVM: 1/2 DRAM bandwidth, 2x DRAM latency (mid-range PCM-like).
PAPER_DRAM_NVM = MachineProfile(
    name="paper-generic", fast=_dram(),
    slow=_nvm(6e9, 5e9, 180 * NS, 180 * NS),
    copy_bw=10e9)

# Table-1 relative profiles (slow tier scaled from the measured DRAM).
STT_RAM = MachineProfile(
    name="stt-ram", fast=_dram(),
    slow=_nvm(12e9 * 0.8, 10e9 * 0.6, 6 * 90 * NS, 8 * 90 * NS), copy_bw=10e9)

PCRAM = MachineProfile(
    name="pcram", fast=_dram(),
    slow=_nvm(12e9 * 0.5, 10e9 * 0.45, 10 * 90 * NS, 100 * 90 * NS),
    copy_bw=10e9)

RERAM = MachineProfile(
    name="reram", fast=_dram(),
    slow=_nvm(12e9 * 0.06, 10e9 * 0.005, 50 * 90 * NS, 100 * 90 * NS),
    copy_bw=10e9)

# --- TPU v5e production target ---------------------------------------------
# fast = HBM (16 GB, 819 GB/s), slow = host DRAM behind PCIe.  A v5e host
# feeds 4 chips; we budget 32 GB/s/chip optimistic, and the tier model's
# latency reflects PCIe+driver round trip.
TPU_V5E = MachineProfile(
    name="tpu-v5e", fast=TierSpec("HBM", 16 * GB, 819e9, 819e9,
                                  400 * NS, 400 * NS, memory_kind="device"),
    slow=TierSpec("HOST", 64 * GB, 32e9, 32e9, 2000 * NS, 2000 * NS,
                  memory_kind="pinned_host"),
    copy_bw=32e9, cacheline_bytes=512)

# Kernel-level tiers on one v5e core: fast = VMEM, slow = HBM.
TPU_V5E_VMEM = MachineProfile(
    name="tpu-v5e-vmem",
    fast=TierSpec("VMEM", 128 * MB, 20e12, 20e12, 30 * NS, 30 * NS),
    slow=TierSpec("HBM", 16 * GB, 819e9, 819e9, 400 * NS, 400 * NS),
    copy_bw=819e9, cacheline_bytes=512)

# --- NVIDIA H100 SXM: HBM fast tier, pinned host memory slow tier ----------
# HBM capacity and bandwidth: NVIDIA's H100 SXM data sheet (80 GB at
# 3.35 TB/s).  The rest was measured by ``chip_smoke.py`` (runtime phase)
# on an "NVIDIA H100 80GB HBM3, 700.00 W" card:
# * copy rates between pinned host memory and HBM, 1 GiB on one copy
#   stream (2 and 4 streams gave no more); the host tier's read and write
#   rates are these, since a phase reaches host memory only over that link;
# * latencies: the event-timed duration of one 128-byte copy (one cacheline
#   of this profile), device to device for HBM, pinned host to device for
#   the host tier -- an upper bound that includes the copy engine's set-up;
# * host capacity: the machine's physical memory.
_H100_H2D_BW = 52.09e9
_H100_D2H_BW = 54.68e9
_H100_COPY_BW = 52.09e9      # the slower direction
_H100_HBM_LAT = 5.2e-6
_H100_HOST_LAT = 6.0e-6
_H100_HOST_CAP = 108_447_924_224
H100_HBM_HOST = MachineProfile(
    name="h100-hbm-host",
    fast=TierSpec("HBM", 80 * 10 ** 9, 3.35e12, 3.35e12,
                  _H100_HBM_LAT, _H100_HBM_LAT, memory_kind="device"),
    slow=TierSpec("HOST", _H100_HOST_CAP, _H100_H2D_BW, _H100_D2H_BW,
                  _H100_HOST_LAT, _H100_HOST_LAT, memory_kind="pinned_host"),
    copy_bw=_H100_COPY_BW, cacheline_bytes=128)

PROFILES = {p.name: p for p in
            [PAPER_DRAM_NVM, STT_RAM, PCRAM, RERAM, TPU_V5E, TPU_V5E_VMEM,
             H100_HBM_HOST]}

# Roofline hardware constants for TPU v5e (per chip).
V5E_PEAK_FLOPS_BF16 = 197e12
V5E_HBM_BW = 819e9
V5E_ICI_BW = 50e9
