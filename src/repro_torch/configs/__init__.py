"""repro_torch.configs — one module per ported architecture.

``get_arch(name)`` returns the ArchSpec of one of the LM architectures
(``dti-llama``, ``minicpm-2b``, ``qwen2-1.5b``, ``minicpm3-4b``,
``qwen2-moe-a2.7b``), one of the four recsys architectures (``din``,
``mind``, ``sasrec``, ``xdeepfm``) or the GNN (``gin-tu``). The
reference's last one, ``deepseek-v2-236b``, is not ported yet and raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchSpec, ShapeSpec

from repro_torch.configs import (din, dti_llama, gin_tu, mind, minicpm3_4b,
                                 minicpm_2b, qwen2_1_5b, qwen2_moe_a2_7b,
                                 sasrec, xdeepfm)

_MODULES = {"minicpm-2b": minicpm_2b, "qwen2-1.5b": qwen2_1_5b,
            "minicpm3-4b": minicpm3_4b, "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
            "mind": mind, "xdeepfm": xdeepfm, "din": din, "sasrec": sasrec,
            "gin-tu": gin_tu, "dti-llama": dti_llama}

#: the reference's architectures that the port does not have yet
NOT_PORTED = {
    "deepseek-v2-236b": "ROADMAP A5 (MLA + MoE at Dqk 192 / Dv 128 and the "
                        "576 / 512 latent decode: queue B items 1-2)",
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
