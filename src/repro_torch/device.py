"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Without a
card and without ``device="cpu"`` they raise — a measurement never falls
back to the host silently.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda", local_rank=None) -> torch.device:
    """-> a ``torch.device``; raises when CUDA is asked for but absent.

    ``local_rank`` (a rank's index on its host, as ``torchrun`` sets it)
    picks the card ``cuda:<local_rank>``.  On CUDA, TF32 is switched off
    for matmuls and cuDNN so f32 runs keep full f32 products (the parity
    the tests and the chip check rely on).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the host")
        if local_rank is not None:
            dev = torch.device("cuda", local_rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


def card_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a
    card below its maximum power runs slower under load, so every timing
    is kept beside this)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return (f"{torch.cuda.get_device_name(device)}, power limit not "
                f"read ({type(e).__name__})")
    return out.stdout.strip()
