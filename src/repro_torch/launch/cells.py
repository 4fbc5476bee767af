"""The assigned (architecture × input shape) grid with documented skips:
the torch counterpart of ``repro.launch.cells``, over the port's config
registry (the same ten architectures)."""
from __future__ import annotations

from repro_torch.configs.base import list_archs

__all__ = ["LONG_OK", "NO_DECODE", "cell_list", "cell_skips"]

# long_500k needs sub-quadratic attention: run for SSM/hybrid/
# mostly-local archs, skip pure full-attention archs (DESIGN.md §4)
LONG_OK = {"recurrentgemma-2b", "rwkv6-1.6b", "gemma3-12b"}
# encoder-only archs have no autoregressive decode step
NO_DECODE = {"hubert-xlarge"}


def cell_list() -> list:
    """All runnable (arch, shape_name) cells."""
    cells = []
    for arch in list_archs():
        for shape in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
            if shape in ("decode_32k", "long_500k") and arch in NO_DECODE:
                continue
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            cells.append((arch, shape))
    return cells


def cell_skips() -> list:
    """Documented skips with reasons."""
    skips = []
    for arch in list_archs():
        if arch in NO_DECODE:
            skips.append((arch, "decode_32k", "encoder-only: no decode step"))
            skips.append((arch, "long_500k", "encoder-only: no decode step"))
        elif arch not in LONG_OK:
            skips.append((arch, "long_500k",
                          "pure full-attention arch (per assignment spec)"))
    return skips
