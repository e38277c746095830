"""Architecture registry of the port: the 10 assigned archs (``--arch <id>``)
and the shape grid (``shapes``)."""
from __future__ import annotations

import importlib

from .shapes import SHAPES, ShapeCase, concrete_inputs, input_specs, shape_applicable

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


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_cells():
    """Every (arch, shape) cell; inapplicable cells flagged (not dropped)."""
    return [(a, s, shape_applicable(get_config(a), s))
            for a in ARCH_IDS for s in SHAPES]


__all__ = ["SHAPES", "ShapeCase", "input_specs", "concrete_inputs", "shape_applicable",
           "ARCH_IDS", "get_config", "all_cells"]
