"""Serve small LMs with batched requests on the PyTorch port: prefill a
batch of prompts, then decode tokens greedily through the stacked decode
cache, for the four families of the JAX example (``examples/serve_lm.py``):
dense granite, MoE mixtral, RWKV-6 and the RG-LRU hybrid, each at its
reduced config.

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

It runs on the card unless ``--device cpu`` is given, and raises where CUDA
is missing.
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import decode_step, init_params, param_specs, prefill

ARCHS = ["granite_3_2b", "mixtral_8x7b", "rwkv6_7b", "recurrentgemma_2b"]
B, PROMPT, NEW = 4, 64, 16

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="torch device (default: the card)")
dev = resolve_device(ap.parse_args().device)

for arch in ARCHS:
    cfg = get_reduced(arch)
    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    batch = make_train_batch(cfg, batch=B, seq_len=PROMPT, seed=0, device=dev)
    max_len = PROMPT + NEW

    logits, cache, pos = prefill(cfg, params, batch, max_len=max_len)
    token = torch.argmax(logits[:, : cfg.vocab_size], -1)
    out_tokens = [token]
    t0 = time.perf_counter()
    for i in range(NEW - 1):
        logits, cache = decode_step(cfg, params, cache, pos + i, token)
        token = torch.argmax(logits[:, : cfg.vocab_size], -1)
        out_tokens.append(token)
    seqs = torch.stack(out_tokens, dim=1).cpu()  # waits for the device
    dt = (time.perf_counter() - t0) / (NEW - 1) * 1000
    assert seqs.shape == (B, NEW)
    assert torch.isfinite(logits).all()
    print(f"{arch:22s} family={cfg.family:7s} {dt:7.1f} ms/token on {dev} "
          f"first-request tokens: {seqs[0][:8].tolist()}")
print("OK")
