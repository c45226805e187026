"""PyTorch/CUDA port of the GEE reproduction (``repro``), for one NVIDIA H100.

The layout mirrors ``repro/``: each module names the reference module it is
held against.  The package imports torch, numpy and scipy only -- never jax
and nothing of ``repro`` -- so it runs on a host that has only PyTorch.

Entry points (``GEEEmbedder``, the graph constructors) run on the card
unless the caller passes ``device="cpu"``; with no GPU present and no
explicit device they raise instead of carrying on quietly on the host.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card (``cuda``, with the current device's index);
    anything else as given.

    Raises ``RuntimeError`` when the card is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        if dev.index is None:      # tensors report cuda:N, never bare cuda
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["resolve_device"]
