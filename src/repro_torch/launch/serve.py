"""Serving launcher of the port: seeded weights, seeded ragged requests,
served through ``ContinuousBatcher``; an encoder-decoder as a static batch.

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

``--arch whisper-tiny`` (the encdec family) takes the reference's
static-batch path instead (``serve_static``): ``--slots`` rows, each with
seeded frames (``--mesh host``: 16 of them; the config's 1,500 at full
width) and a seeded prompt of the top of ``--prompt-len``'s range; the
encoder runs once (``prefill_cross`` fills the cache's cross K/V), the
prompt is fed one token a step through ``make_decode_step``, then the top
of ``--gen``'s range of greedy tokens.  The continuous batcher does not
serve this family (ROADMAP §C).
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


def static_inputs(cfg, rows: int, prompt_len: int, seed: int):
    """Seeded numpy inputs of the static batch: frames (rows, n_frames,
    d_model) fp32 and prompts (rows, prompt_len) int32 in [1, vocab)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((rows, cfg.n_frames, cfg.d_model),
                                 dtype=np.float32)
    prompts = rng.integers(1, cfg.vocab_size, size=(rows, prompt_len))
    return frames, prompts.astype(np.int32)


def serve_static(model, params, frames, prompts, gen: int):
    """Greedy generation of a static batch of an encoder-decoder: the
    encoder once (``prefill_cross`` into the cache's cross K/V), the
    prompts (B, P) fed one token a step, then ``gen`` greedy tokens a row.
    Returns the (B, gen) int32 tokens; the cache (every leaf zeros)
    is made on the frames' device, max_len P + gen."""
    import torch

    from repro_torch.models.params import init_params
    from repro_torch.parallel.steps import make_decode_step

    rows, plen = prompts.shape
    with torch.inference_mode():
        cache = init_params(0, model.cache_defs(rows, plen + gen),
                            device=frames.device)
        cache["cross_k"], cache["cross_v"] = model.prefill_cross(params,
                                                                 frames)
        decode = make_decode_step(model)
        for t in range(plen):
            tok, cache = decode(params, cache, prompts[:, t:t + 1])
        outs = [tok]
        for _ in range(gen - 1):
            tok, cache = decode(params, cache, outs[-1])
            outs.append(tok)
        return torch.cat(outs, dim=1)


def _main_static(args, model, params, device) -> dict:
    """The encdec path of ``main``: one static batch of ``--slots`` rows."""
    import torch

    cfg = model.cfg
    plen, gen = args.prompt_len[1], args.gen[1]
    frames, prompts = static_inputs(cfg, args.slots, plen, args.seed)
    frames = torch.from_numpy(frames).to(device)
    prompts = torch.from_numpy(prompts).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = serve_static(model, params, frames, prompts, gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    steps = plen + gen - 1
    tokens = out.numel()
    print(f"{args.arch} on {device}: static batch of {args.slots} rows, "
          f"{cfg.n_frames} frames, {plen} prompt and {gen} new tokens a row: "
          f"{tokens} tokens in {secs:.2f} s ({tokens / secs:.1f} tok/s), "
          f"{steps} decode steps")
    print("request 0:", out[0, :16].tolist())
    completed = {i: row for i, row in enumerate(out.tolist())}
    return {"requests": args.slots, "tokens": tokens, "seconds": secs,
            "ticks": steps, "completed": completed}


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
    if cfg.family == "encdec":
        return _main_static(args, model, params, device)
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
