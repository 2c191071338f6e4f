"""The LM stack of the port: prefill, decode and the training forward and
loss of the dense, MoE, RWKV-6, RG-LRU hybrid and encoder-decoder families
and the frontend stubs, in PyTorch (``lm.py``, ``attention.py``,
``moe.py``, ``rwkv6.py``, ``rglru.py``, ``decode.py``)."""
from repro_torch.models.common import abstract_params, init_params, logical_specs
from repro_torch.models.decode import decode_step, init_decode_cache, prefill
from repro_torch.models.lm import ModelConfig, forward, loss_fn, param_specs

__all__ = [
    "ModelConfig",
    "forward",
    "loss_fn",
    "param_specs",
    "abstract_params",
    "init_params",
    "logical_specs",
    "decode_step",
    "init_decode_cache",
    "prefill",
]
