"""The CUDA device, or an error.

Counterpart of ``webaudio_modem_tpu/utils/platform.py``.  The port's
entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; ``resolve_device`` refuses a CUDA request where there is
no card, and a measurement or smoke run that needs the card calls
``require_cuda`` and fails where there is none.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Tuple

import torch


def gpu_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card,
    or a note saying why it could not be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises ``RuntimeError`` for a CUDA
    device when PyTorch sees no card (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


def require_cuda() -> Tuple[torch.device, str]:
    """Return ``(torch.device("cuda", 0), nvidia-smi name/power line)``.

    Raises ``RuntimeError`` when PyTorch sees no CUDA device; there is
    no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda})")
    return torch.device("cuda", 0), gpu_name_and_power()
