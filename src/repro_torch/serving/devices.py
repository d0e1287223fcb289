"""Edge-device, network and server profiles (paper §IV setup).

The port's own copy of ``repro.serving.devices``: the network profiles and
the edge boards' drafting-rate tables that a ``ServeSpec`` names and
validates against (llama.cpp-style decode tokens/s for the paper's draft
models on RPi 4B/5 and Jetson Orin Nano), and the server profiles that the
simulator, the cost model and the tuner price a verify step with. Power
and price numbers follow the paper's cost model sources: RPi 5 at $80 [34]
drawing 8 W [35], industrial electricity at 0.083 $/kWh [36], 3-year
amortisation at 70% utilisation [32].

``A100_X4`` (the paper's testbed) and ``V5E_16`` (the JAX package's TPU
slice) are the JAX package's numbers, kept as data; ``H100`` is the card
this package serves on.
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


@dataclasses.dataclass(frozen=True)
class ServerProfile:
    name: str
    price_usd: float
    power_w: float
    peak_flops: float       # aggregate
    hbm_bw: float           # aggregate bytes/s
    launch_overhead_s: float  # fixed per-batch overhead (host and kernel launches)

    def verify_latency(self, target_params: float, batch: int, k1: int,
                       cache_tokens: int = 1024, kv_bytes_per_tok: float = 2 * 8 * 128 * 2,
                       bits: int = 16) -> float:
        """One batched verification forward: max(weight stream, compute, kv).

        Weight-streaming dominates at small batch (the reason batching pays:
        Fig. 4's rising WSTGR); compute takes over at large batch x K. As in
        the JAX package, ``kv_bytes_per_tok`` counts one layer's K and V per
        cached token (ROADMAP.md Queue C); the tuner's measured
        ``server_latency_scale`` absorbs the difference.
        """
        wbytes = target_params * bits / 8
        t_mem = wbytes / self.hbm_bw + batch * cache_tokens * kv_bytes_per_tok / self.hbm_bw
        t_compute = 2.0 * target_params * batch * k1 / self.peak_flops
        return self.launch_overhead_s + max(t_mem, t_compute)

    def decode_latency(self, target_params: float, batch: int, **kw) -> float:
        """Centralized autoregressive decoding: one token per request."""
        return self.verify_latency(target_params, batch, 1, **kw)


A100_X4 = ServerProfile(
    name="a100x4", price_usd=60_000.0, power_w=2_200.0,
    peak_flops=4 * 312e12, hbm_bw=4 * 2.0e12, launch_overhead_s=0.004,
)

# TPU v5e 16-chip slice (1 row of the pod): the JAX package's constants
V5E_16 = ServerProfile(
    name="v5e-16", price_usd=40_000.0, power_w=16 * 200.0,
    peak_flops=16 * 197e12, hbm_bw=16 * 819e9, launch_overhead_s=0.002,
)

# one NVIDIA H100 SXM: dense bf16 peak and HBM rate from NVIDIA's data
# sheet; power_w is the power limit nvidia-smi reported on the cards this
# package was measured on. launch_overhead_s: the eager verify step of the
# full-width llama-11b-target at batch 1 (47.241 ms, median of 5 in
# chip_smoke.py's calibrate h100 phase) less this profile's memory term at
# the config's param_count() (5.837 ms), on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Most of it is the host issuing ~3,050 kernels a step
# (experiments/torch_verify_profile.py). price_usd is an assumption, not a
# quote: a round figure for one SXM card; set your own.
H100 = ServerProfile(
    name="h100", price_usd=30_000.0, power_w=700.0,
    peak_flops=989e12, hbm_bw=3.35e12, launch_overhead_s=0.041403,
)

SERVERS = {s.name: s for s in (A100_X4, V5E_16, H100)}

ELECTRICITY_USD_PER_KWH = 0.083  # EIA industrial rate [36]
