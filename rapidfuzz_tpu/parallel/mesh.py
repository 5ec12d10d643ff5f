"""Mesh helpers."""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def data_mesh(n_devices: int | None = None, platform: str | None = None
              ) -> Mesh:
    """1-D ``("data",)`` mesh over the first ``n_devices`` devices.

    ``platform`` may pin "cpu" (virtual multi-device testing via
    ``--xla_force_host_platform_device_count``) or "gpu".
    """
    devs = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} "
                f"({[d.platform for d in devs[:3]]}...)")
        devs = devs[:n_devices]
    return Mesh(devs, ("data",))
