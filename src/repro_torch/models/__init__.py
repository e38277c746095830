"""Model zoo of the port: the decoder blocks (dense, local, MoE, RG-LRU,
RWKV6) and the stack that trains and serves every architecture of the
registry."""
from . import layers, moe, rglru, rwkv6, transformer
from .transformer import (ModelConfig, Transformer, decode_state_init, decode_state_specs,
                          forward_prefill, forward_train, init_params, loss_fn,
                          serve_step)

__all__ = ["layers", "moe", "rglru", "rwkv6", "transformer", "ModelConfig", "Transformer",
           "init_params", "forward_train", "loss_fn", "forward_prefill", "decode_state_init",
           "decode_state_specs", "serve_step"]
