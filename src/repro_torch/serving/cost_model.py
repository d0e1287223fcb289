"""Paper Eq. 2: $ per 1K generated tokens from CAPEX + OPEX.

    Cost = 1000/(3600 R) * ( P_device/(3*8760*0.70) + P_avg/1000 * 0.083 )

R = tokens/s, P_device = purchase price, P_avg = watts; 3-year amortisation
at 70% utilisation; electricity 0.083 $/kWh.  Applies uniformly to edge
devices and the shared server (server cost is divided across the devices it
serves, proportional to their verification usage). The port's copy of
``repro.serving.cost_model``.
"""
from __future__ import annotations

from repro_torch.serving.devices import ELECTRICITY_USD_PER_KWH, DeviceProfile, ServerProfile

AMORT_HOURS = 3 * 8760 * 0.70


def hourly_cost(price_usd: float, power_w: float) -> float:
    return price_usd / AMORT_HOURS + power_w / 1000.0 * ELECTRICITY_USD_PER_KWH


def cost_per_1k_tokens(rate_tok_s: float, price_usd: float, power_w: float) -> float:
    """Eq. 2 verbatim."""
    if rate_tok_s <= 0:
        return float("inf")
    return 1000.0 / (3600.0 * rate_tok_s) * (
        price_usd / AMORT_HOURS + power_w / 1000.0 * ELECTRICITY_USD_PER_KWH
    )


def sled_cost_per_1k(device_rate: float, device: DeviceProfile,
                     server: ServerProfile, server_share: float) -> float:
    """SLED: device cost + the device's share of the shared server.

    ``server_share`` = fraction of server capacity this device consumes
    (verification-only — the SLED cost advantage the paper claims: devices
    pay for verification cycles, not full generation).
    """
    if device_rate <= 0:
        return float("inf")
    dev = hourly_cost(device.price_usd, device.power_w)
    srv = hourly_cost(server.price_usd, server.power_w) * server_share
    return 1000.0 / (3600.0 * device_rate) * (dev + srv)


def fleet_cost_per_1k(
    class_rates: list, server: ServerProfile, *, server_busy_frac: float = 1.0
) -> float:
    """Eq. 2 over a heterogeneous fleet: ``class_rates`` is
    ``[(count, committed_tok_s_per_device, DeviceProfile), ...]`` — one
    entry per device class.  Device hours are paid per class; the ONE
    shared server's hourly cost (scaled by how busy verification keeps it)
    is spread over every token the fleet commits, which is what makes
    packing slow cheap devices next to fast ones pay off."""
    total_rate = sum(n * r for n, r, _ in class_rates)
    if total_rate <= 0:
        return float("inf")
    dev_hourly = sum(n * hourly_cost(p.price_usd, p.power_w) for n, _, p in class_rates)
    srv_hourly = hourly_cost(server.price_usd, server.power_w) * server_busy_frac
    return 1000.0 / (3600.0 * total_rate) * (dev_hourly + srv_hourly)
