"""Batched serving, the twin of ``examples/serve_batched.py``: prefill a
batch of prompts, then decode new tokens greedily, one step at a time,
against the KV/SSM cache. On the card unless ``--device cpu`` is given;
the reduced configuration unless ``--full`` is given, ``--layers N`` keeps
the first N layers (a depth cut at full width, so a configuration fits a
card):

  PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu \
      --arch mamba2-780m

As in the example, the prefill sizes the cache to the prompt (no
``max_len``), so every decoded token is written into the cache's last slot
(a sliding-window model's oldest); the continuations are the reference's.
Weights, prompts and frontend embeddings are drawn from seeded
``torch.Generator``s, not jax's keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models.frontends import fake_frontend_embeds
from repro_torch.models.transformer import init_model


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, prompts, frontend, new_tokens):
    """Prefill ``prompts`` [B, P] (with ``frontend`` embeddings or None),
    then decode greedily -> (tokens [B, new_tokens], the last logits,
    prefill seconds, decode seconds per step)."""
    dev = prompts.device
    prefill_step, decode = build_prefill_step(cfg), build_decode_step(cfg)
    _wait(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompts, frontend)
    tok = logits[:, -1:].argmax(-1)
    _wait(dev)
    prefill_s = time.perf_counter() - t0
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1)
        generated.append(tok)
    _wait(dev)
    step_s = (time.perf_counter() - t0) / max(new_tokens - 1, 1)
    return torch.cat(generated, dim=1), logits, prefill_s, step_s


def run(arch, batch=8, prompt_len=48, new_tokens=16, device=None, full=False,
        layers=None):
    """Serve ``arch`` as the example does and print its lines -> dict of
    the prefill seconds, the decode ms per step, the generated tokens
    [batch, new_tokens] (on the CPU), the last logits and the peak device
    memory in GB (None on the CPU)."""
    dev = resolve(device)
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    fe = None
    if cfg.frontend != "none":
        fe = fake_frontend_embeds(torch.Generator().manual_seed(2), cfg, batch).to(dev)

    gen, logits, prefill_s, step_s = serve(cfg, params, prompts, fe, new_tokens)
    print(f"[serve] prefill {batch}x{prompt_len}: {prefill_s:.2f}s", flush=True)
    gen = gen.cpu()
    if gen.shape != (batch, new_tokens):
        raise AssertionError(f"generated {tuple(gen.shape)}, want "
                             f"{(batch, new_tokens)}")
    if torch.isnan(logits.float()).any():
        raise AssertionError("NaN logits")
    print(f"[serve] decoded {new_tokens} tokens/seq: {step_s * 1e3:.1f} ms/step",
          flush=True)
    print(f"[serve] sample continuation (seq 0): {gen[0, :12].numpy()}", flush=True)
    print("serve_batched OK", flush=True)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)
    return {"prefill_s": prefill_s, "decode_ms_per_step": step_s * 1e3,
            "tokens": gen, "logits": logits, "peak_gb": peak,
            "layers": cfg.num_layers}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_batched")
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the configuration's full width (default: reduced)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, args.batch, args.prompt_len, args.new_tokens,
               device=args.device, full=args.full, layers=args.layers)


if __name__ == "__main__":
    main()
