"""Device probe: which card is there, and is it answering?

Counterpart of `parseable_tpu/utils/devicecheck.py`. The JAX package probes
its accelerator and quietly degrades queries to the CPU engine when the
probe fails. This port reports and never reroutes: a query that asks for
the GPU engine runs on the card or raises.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested CUDA device is missing or not answering."""


def probe(device: torch.device | str = "cuda") -> dict:
    """Report on `device`: availability, name, count and a tiny computation
    that must come back right. Never raises."""
    device = torch.device(device)
    report: dict = {"device": str(device), "available": device.type == "cpu"}
    if device.type != "cuda":
        return report
    report["available"] = torch.cuda.is_available()
    if not report["available"]:
        report["error"] = "torch.cuda.is_available() is False"
        return report
    try:
        index = device.index if device.index is not None else torch.cuda.current_device()
        report["name"] = torch.cuda.get_device_name(index)
        report["count"] = torch.cuda.device_count()
        got = torch.ones(8, device=device).sum().item()
        report["healthy"] = got == 8.0
    except RuntimeError as e:  # a driver or launch failure surfaces as RuntimeError
        report["healthy"] = False
        report["error"] = str(e)
    return report


def require_device(device: torch.device | str | None = None) -> torch.device:
    """The device a GPU query runs on: `device`, default `cuda`. Raises
    DeviceUnavailable when a CUDA device is asked for and none is there."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"GPU engine asked for {device} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the kernels' plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {device}")
    return device
