"""Device meshes of the multi-device engines: lists of torch devices."""

from __future__ import annotations

import torch


def make_mesh(n_devices: int | None = None,
              device: str = "cuda") -> list[torch.device]:
    """The devices of a 1-D mesh (``bsmap_tpu.parallel.mesh.make_mesh``'s
    "dp" axis).  Under ``cuda``: the visible cards, or the first
    ``n_devices`` of them; asking for more than are visible raises
    ValueError.  Under ``cpu``: ``n_devices`` (default 1) entries of the
    CPU, the counterpart of XLA's forced host device count.  The engines
    also take an explicit list, which may repeat a device: several shards
    then share one card."""
    if device == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if device != "cuda":
        raise ValueError(f"unknown device kind {device!r} (cuda or cpu)")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        if have == 0:
            raise RuntimeError("CUDA device requested but torch sees no "
                               "CUDA device")
        n_devices = have
    elif have < n_devices:
        raise ValueError(f"need {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]
