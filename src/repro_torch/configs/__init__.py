"""Architecture registry of the port: the 10 assigned archs (``--arch <id>``).

The shape grid's abstract inputs (``repro.configs.shapes``) wait for the
dry-run slice (ROADMAP Queue 1, entry 15d); ``all_cells`` needs only the
grid's names and its one applicability rule, kept here."""
from __future__ import annotations

import importlib

_MODULES = {
    "yi-6b": "yi_6b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "glm4-9b": "glm4_9b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-large": "musicgen_large",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = tuple(_MODULES)

#: the shape grid's names (train_4k, prefill_32k, decode_32k, long_500k)
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


def shape_applicable(cfg, shape: str) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def all_cells():
    """Every (arch, shape) cell; inapplicable cells flagged (not dropped)."""
    return [(a, s, shape_applicable(get_config(a), s))
            for a in ARCH_IDS for s in SHAPE_NAMES]


__all__ = ["ARCH_IDS", "SHAPE_NAMES", "get_config", "shape_applicable", "all_cells"]
