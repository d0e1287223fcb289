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


# the draw streams of sampling mode: drafting (a device's, a lock-step
# loop's) and a verify round's acceptance and corrections
DRAFT_STREAM, VERIFY_STREAM = 0, 1
_M64 = (1 << 64) - 1


def seeded_generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for ``seed`` in draw stream ``stream``. The
    pair is mixed (splitmix64) into one 32-bit seed: a CPU generator keeps
    only the low 32 bits of its seed, so tagging a seed with an offset would
    give a verify round the draws of a draft generator seeded alike."""
    x = (((stream << 32) | (int(seed) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    gen = torch.Generator(device=device)
    gen.manual_seed((x ^ (x >> 31)) >> 32)
    return gen
