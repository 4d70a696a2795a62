"""The two readings that place phase 3l's replay bound
(``chip_smoke.REPLAY_ULPS`` bf16 ulps of a step's largest |logit|), on one
card.  From the root of a checkout, on a machine with a CUDA card:

    python3 scripts/replay_bound.py

Qwen3-4B at full width, ``SERVE_LAYERS`` of its layers, bf16, seed-0
weights, and phase 3l's replay streams (the first ``SERVE_SLOTS`` of phase
3b's requests, their first ``REPLAY_STEPS`` tokens, all prompt tokens), fed
one token a step through a dense cache (``serve.teacher_forced_logits``)
on one device as the port runs it (the reference), and again in variants,
each step's logits held to the reference's in bf16 ulps of the step's
largest reference |logit| (``chip_smoke.bf16_ulp``), as phase 3l holds
the mesh's:

  * ``again``: the reference run once more (the card's own repeatability);
  * ``rounded twice`` (the lower reading): every attention and MLP down
    projection computed as the two partial products of a mesh's two model
    ranks (the first and second half of the heads, or of the MLP's
    columns, each half of the MLP computed from its own column block),
    each rounded to bf16, and their sum rounded again, as the row-parallel
    sum rounds them on the mesh;
  * planted faults (the upper reading), each a fault one rank of a model
    axis of 2 could make, in the first or the last layer alone: the
    attention's or the MLP's second partial dropped (a rank whose sum never
    arrives), and the second half of the query heads reading the first
    half's KV heads (a rank holding the wrong KV-head shard).

Prints a line a variant: the largest and the median over the steps of the
step's error in ulps, and how many steps exceed the bound; then how many of
the reference's greedy decisions have a top-2 gap above 1, 2, 4, 8 and 16
ulps (the decisions phase 3l's greedy gate checks at such a bound).  About
a minute on an H100 after the kernels' build."""
import dataclasses
import statistics
import sys
import time

sys.path[:0] = ["src", "."]

# the layer a fault is planted in, and the layers
FAULT_LAYERS = ("first", "last")


def main():
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_requests, teacher_forced_logits
    from repro_torch.models import blocks, build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line())
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(get_config(cs.SERVE_ARCH),
                              n_layers=cs.SERVE_LAYERS)
    model = build_model(cfg)
    params = model.init(cs.SEED)
    reqs = make_requests(cs.SERVE_REQUESTS, cfg.vocab_size, cs.SERVE_PROMPT,
                         cs.SERVE_GEN, cs.SEED)[:cs.SERVE_SLOTS]
    if min(len(r.prompt) for r in reqs) < cs.REPLAY_STEPS:
        raise SystemExit("a replay stream would need served tokens")
    streams = torch.tensor([r.prompt[:cs.REPLAY_STEPS] for r in reqs],
                           dtype=torch.int32, device="cuda")

    def replay():
        return teacher_forced_logits(model, params, streams).float().cpu()

    want = replay()
    ulp = torch.tensor([cs.bf16_ulp(float(want[t].abs().max()))
                        for t in range(want.shape[0])])

    out_proj, mlp, attend = (blocks._out_proj, blocks.apply_mlp,
                             blocks._decode_attend)
    calls = {"attn": 0, "mlp": 0, "kv": 0}

    def at(kind, where):
        """Whether this call of ``kind`` is in the layer ``where`` names
        (the layers run in order, once a decode step)."""
        layer = calls[kind] % cfg.n_layers
        calls[kind] += 1
        return where == "every" or layer == (
            0 if where == "first" else cfg.n_layers - 1)

    def twice(ctx, wo, tp=(None, ()), drop=None):
        h = ctx.shape[2] // 2
        a = torch.einsum("bqhd,hdm->bqm", ctx[:, :, :h], wo[:h])
        b = torch.einsum("bqhd,hdm->bqm", ctx[:, :, h:], wo[h:])
        return a if drop else a + b

    def mlp_twice(p, x, cfg_, drop=None):
        f = p["wi"].shape[1] // 2
        parts = []
        for cols in (slice(0, f), slice(f, None)):
            h = torch.matmul(x, p["wi"][:, cols])
            g = torch.matmul(x, p["wg"][:, cols])
            act = (F.silu(g) if cfg_.act == "silu"
                   else F.gelu(g, approximate="tanh"))
            parts.append(torch.matmul(act * h, p["wo"][cols]))
        return parts[0] if drop else parts[0] + parts[1]

    def wrong_kv(p, q, kv_k, kv_v, *a, **k):
        half = kv_k.shape[2] // 2
        kv_k = torch.cat([kv_k[:, :, :half]] * 2, dim=2)
        kv_v = torch.cat([kv_v[:, :, :half]] * 2, dim=2)
        return attend(p, q, kv_k, kv_v, *a, **k)

    def variant(attn=None, mlp_fn=None, kv=None):
        """The replay with ``_out_proj``, ``apply_mlp`` and
        ``_decode_attend`` replaced where given (each ``(fn, where)``: the
        replacement in the layers ``where`` names, the port's elsewhere)."""
        for k in calls:
            calls[k] = 0

        def pick(kind, spec, orig):
            if spec is None:
                return orig
            fn, where = spec
            return lambda *a, **k: (fn if at(kind, where) else orig)(*a, **k)

        blocks._out_proj = pick("attn", attn, out_proj)
        blocks.apply_mlp = pick("mlp", mlp_fn, mlp)
        blocks._decode_attend = pick("kv", kv, attend)
        try:
            return replay()
        finally:
            blocks._out_proj, blocks.apply_mlp = out_proj, mlp
            blocks._decode_attend = attend

    def drop(fn):
        return lambda *a, **k: fn(*a, drop=True, **k)

    variants = {"again": {},
                "rounded twice": dict(attn=(twice, "every"),
                                      mlp_fn=(mlp_twice, "every"))}
    for where in FAULT_LAYERS:
        variants[f"fault: {where} layer's wo partial dropped"] = dict(
            attn=(drop(twice), where))
        variants[f"fault: {where} layer's MLP partial dropped"] = dict(
            mlp_fn=(drop(mlp_twice), where))
        variants[f"fault: {where} layer's second heads on the first KV "
                 f"heads"] = dict(kv=(wrong_kv, where))
    print(f"replay: {cs.SERVE_ARCH} bf16 {cfg.n_layers} layers, "
          f"{tuple(streams.shape)} streams, one device; each step's error "
          f"in bf16 ulps of its largest |logit|, the bound "
          f"{cs.REPLAY_ULPS}")
    for name, kw in variants.items():
        got = variant(**kw)
        err = [float((got[t] - want[t]).abs().max() / ulp[t])
               for t in range(want.shape[0])]
        over = sum(e > cs.REPLAY_ULPS for e in err)
        print(f"reading: {name}: largest {max(err):.4g} ulps, median "
              f"{statistics.median(err):.4g}, smallest {min(err):.4g}; "
              f"{over} of {len(err)} steps over {cs.REPLAY_ULPS}")
    top = torch.topk(want, 2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]) / ulp[:, None]
    print("gaps: decisions whose top-2 gap exceeds "
          + ", ".join(f"{u} ulps: {int((gap > u).sum())}"
                      for u in (1, 2, 4, 8, 16))
          + f" (of {gap.numel()})")


if __name__ == "__main__":
    main()
