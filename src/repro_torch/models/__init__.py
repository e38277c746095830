"""Model zoo of the port: the decoder blocks and stack that serve the dense
architectures (the other block kinds wait for ROADMAP entry 15b)."""
from . import layers, transformer
from .transformer import (ModelConfig, Transformer, decode_state_init,
                          forward_prefill, init_params, serve_step)

__all__ = ["layers", "transformer", "ModelConfig", "Transformer", "init_params",
           "forward_prefill", "decode_state_init", "serve_step"]
