"""PyTorch/CUDA port of the FlowPrefill serving system.

The JAX package `repro` stays the reference; this package mirrors its layout
(`core`, `configs`, `kernels`, `models`, `serving`, `launch`) and imports
neither JAX nor `repro`. Framework-free modules under `core/` and `configs/`
are verbatim copies of the reference with their imports rewritten. Every
entry point takes an explicit ``device`` that defaults to ``"cuda"`` and
raises when no card is present; the CPU runs only where a caller asks for it.
"""
import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA device without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
