"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for an entry point's ``device=`` argument.

    ``"cuda"`` (every entry point's default) requires a CUDA device and
    raises without one — the port never carries on quietly on the CPU.
    ``"cpu"`` is the explicit request the tests make."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this entry point runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
