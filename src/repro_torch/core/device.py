"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. ``None`` and ``"cuda"`` mean the
    GPU and raise when there is none: nothing carries on silently on the CPU,
    which runs only when asked for by name (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
