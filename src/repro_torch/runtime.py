"""Device policy shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; with no
    card this raises rather than quietly running on the CPU, which a caller
    must ask for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # "cuda" means the current card, as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
