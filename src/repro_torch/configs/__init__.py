"""repro_torch.configs — one module per ported architecture.

``get_arch(name)`` returns the ArchSpec of ``dti-llama``, ``minicpm3-4b``
or one of the four recsys architectures (``din``, ``mind``, ``sasrec``,
``xdeepfm``).
The reference's other architectures are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchSpec, ShapeSpec

from repro_torch.configs import (din, dti_llama, mind, minicpm3_4b, sasrec,
                                 xdeepfm)

_MODULES = {"mind": mind, "xdeepfm": xdeepfm, "din": din, "sasrec": sasrec,
            "dti-llama": dti_llama, "minicpm3-4b": minicpm3_4b}

#: the reference's architectures that the port does not have yet
NOT_PORTED = {
    "minicpm-2b": "ROADMAP A9 (the rest of configs/)",
    "qwen2-1.5b": "ROADMAP A9 (the rest of configs/)",
    "qwen2-moe-a2.7b": "ROADMAP A5 (MoE) and A9",
    "deepseek-v2-236b": "ROADMAP A5 (MLA and MoE) and A9",
    "gin-tu": "ROADMAP A9 (models/gnn.py)",
}

ALL: List[str] = list(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{NOT_PORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].spec()


__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "ALL", "NOT_PORTED"]
