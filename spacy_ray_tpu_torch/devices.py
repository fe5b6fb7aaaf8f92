"""Device selection for the port's entry points.

The card is the default. The CPU runs only when the caller asks for it
(``device="cpu"``, ``--device cpu``), as the tests do; with no card present
and no request for the CPU, an entry point raises instead of running
somewhere the caller did not ask for.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when ``cuda`` is asked for (or
    defaulted to) and no card is present. On ``cuda`` it keeps float32
    matmuls and convolutions in full float32 (TF32 off)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: spacy_ray_tpu_torch runs on the "
                "card by default and does not fall back to the CPU — pass "
                "device='cpu' (--device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev
