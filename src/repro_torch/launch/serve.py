"""Serving launcher of the port: seeded weights, seeded ragged requests,
served through ``ContinuousBatcher``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --mesh device --slots 8 --max-len 1024 --requests 16

``--mesh host`` reduces the configuration (``configs.reduce_for_smoke``),
as the reference does; ``--mesh device`` runs the full configuration on the
one card, standing in for the reference's ``pod``/``multipod`` meshes until
the SPMD slice (ROADMAP A11).  The run is on CUDA unless ``--device cpu``.
Prompt lengths and new-token counts are drawn from the given ranges with
``--seed``.  The default arch is the reference's, ``zamba2-1.2b`` (the
hybrid; ``xlstm-1.3b`` runs the ssm family, ``qwen3-moe-30b-a3b`` the moe
family, 61 GB of bf16 weights at full width).  Prints the decode batch's
RMSNorm plan (and, for a hybrid or an xlstm, the Mamba2's or the mLSTM's
gated norm's over (slots, d_inner)), then requests, generated tokens,
seconds and tokens/s.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--mesh", choices=["host", "device"], default="host")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 16),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--gen", type=int, nargs=2, default=(4, 16),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--kv-cache", choices=["dense", "paged"], default="paged")
    ap.add_argument("--prefill-chunk", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_requests(n: int, vocab: int, prompt_len, gen, seed: int):
    """``n`` requests, prompt lengths and new-token counts drawn uniformly
    from the inclusive ranges, token ids from [1, vocab), by ``seed``."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(1, vocab, size=plen).tolist(),
            max_new_tokens=int(rng.integers(gen[0], gen[1] + 1))))
    return reqs


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from repro_torch import api
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels.util import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatcher

    device = resolve_device(args.device)
    # fp32 matmuls in full precision, never TF32 (the reduced configs are fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.mesh == "host":
        cfg = reduce_for_smoke(cfg)
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    reqs = make_requests(args.requests, cfg.vocab_size, args.prompt_len,
                         args.gen, args.seed)
    print(api.explain("rmsnorm", (args.slots, cfg.d_model), cfg.adtype))
    if cfg.family in ("hybrid", "ssm"):   # the Mamba2's or the mLSTM's
        d_inner = (cfg.ssm_expand if cfg.family == "hybrid" else 2) * (
            cfg.d_model)
        print(api.explain("rmsnorm.gated", (args.slots, d_inner),
                          cfg.adtype))
    batcher = ContinuousBatcher(model, params, slots=args.slots,
                                max_len=args.max_len, kv_cache=args.kv_cache,
                                prefill_chunk=args.prefill_chunk,
                                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = batcher.run(reqs)
    secs = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    page = batcher.geometry.page_len if batcher.geometry else None
    print(f"{args.arch} on {device}: {len(out)} requests, {tokens} tokens in "
          f"{secs:.2f} s ({tokens / secs:.1f} tok/s), {batcher.ticks} ticks, "
          f"{batcher.micro_steps} decode steps, page {page}")
    print("request 0:", out[0][:16])
    return {"requests": len(out), "tokens": tokens, "seconds": secs,
            "ticks": batcher.ticks, "completed": out}


if __name__ == "__main__":
    main()
