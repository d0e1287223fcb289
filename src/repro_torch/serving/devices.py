"""Edge-device and network profiles (paper §IV setup).

The port's own copy of the edge half of ``repro.serving.devices``: the
network profiles and the edge boards' drafting-rate tables that a
``ServeSpec`` names and validates against (llama.cpp-style decode tokens/s
for the paper's draft models on RPi 4B/5 and Jetson Orin Nano, from the
JAX package's table).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class NetProfile:
    """Edge<->server link characteristics (paper §IV service-area network).

    One profile drives BOTH the discrete-event simulator's RTT model and the
    transport runtime's SimulatedLink (transport/links.py), so predictions and
    measurements share a single network configuration.
    """

    name: str
    rtt_mean: float          # seconds, full round trip
    rtt_jitter: float        # gaussian sigma on the round trip
    bandwidth_bps: float     # per-direction serialization rate
    drop_prob: float = 0.0   # per-frame loss -> exercises §III-A fallback

    @property
    def one_way(self) -> float:
        return self.rtt_mean / 2


ETHERNET = NetProfile("ethernet", rtt_mean=0.001, rtt_jitter=0.0001, bandwidth_bps=1e9)
WLAN = NetProfile("wlan", rtt_mean=0.020, rtt_jitter=0.005, bandwidth_bps=100e6)
LTE = NetProfile("lte", rtt_mean=0.050, rtt_jitter=0.015, bandwidth_bps=20e6, drop_prob=0.005)
LOSSY_WLAN = NetProfile(
    "lossy-wlan", rtt_mean=0.020, rtt_jitter=0.005, bandwidth_bps=100e6, drop_prob=0.05
)

NETS = {n.name: n for n in (ETHERNET, WLAN, LTE, LOSSY_WLAN)}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    price_usd: float
    power_w: float
    # decode tokens/s by (draft model, bits)
    draft_rate: Dict[Tuple[str, int], float]
    # how this device class reaches the edge server (paper testbed: WLAN)
    net: NetProfile = WLAN

    def rate(self, model: str = "llama-1b-draft", bits: int = 4) -> float:
        try:
            return self.draft_rate[(model, bits)]
        except KeyError:
            combos = ", ".join(
                f"({m!r}, {b})" for m, b in sorted(self.draft_rate)
            )
            raise KeyError(
                f"device class {self.name!r} has no draft rate for "
                f"(model={model!r}, bits={bits}); available combos: {combos}"
            ) from None


RPI4B = DeviceProfile(
    name="rpi4b", price_usd=55.0, power_w=6.0,
    draft_rate={
        ("llama-1b-draft", 16): 0.9, ("llama-1b-draft", 8): 1.7,
        ("llama-1b-draft", 4): 3.1,
        ("llama-3b-draft", 16): 0.3, ("llama-3b-draft", 8): 0.6,
        ("llama-3b-draft", 4): 1.1,
    },
)

RPI5 = DeviceProfile(
    name="rpi5", price_usd=80.0, power_w=8.0,
    draft_rate={
        ("llama-1b-draft", 16): 2.3, ("llama-1b-draft", 8): 4.4,
        ("llama-1b-draft", 4): 8.2,
        ("llama-3b-draft", 16): 0.9, ("llama-3b-draft", 8): 1.8,
        ("llama-3b-draft", 4): 3.4,
    },
)

JETSON_ORIN_NANO = DeviceProfile(
    name="jetson-orin-nano", price_usd=249.0, power_w=15.0,
    draft_rate={
        ("llama-1b-draft", 16): 6.5, ("llama-1b-draft", 8): 12.0,
        ("llama-1b-draft", 4): 21.0,
        ("llama-3b-draft", 16): 2.4, ("llama-3b-draft", 8): 4.6,
        ("llama-3b-draft", 4): 8.8,
    },
)

DEVICES = {d.name: d for d in (RPI4B, RPI5, JETSON_ORIN_NANO)}
