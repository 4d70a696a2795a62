"""Where the xlstm-1.3b (1, 2) mesh's step-0 gradient norm leaves one
device's at 2 x 512 tokens (ROADMAP §C Open 2).  From the root of a
checkout, on a machine with a CUDA card:

    python3 scripts/xlstm_norm_gap.py [--seqs 512 1024] [--cpu]

xlstm-1.3b at full width, fp32, ``chip_smoke.RECURRENT_TP_LAYERS`` (8) of
its layers, the seed-0 weights ``model.init`` draws on the card, batch 0 of
``DataConfig(50304, seq, 2)``: ``steps.value_and_grad`` on one device and
``launch.mesh_checks.seeded_grads`` on a (1, 2) mesh of two ranks of the
card (the launchers' rules: a rank's heads and columns, the norms split),
as ``chip_smoke.full_width_backward_check`` holds them.  Each run is made
as the port runs it and again with kernels swapped for their plain
versions (on the card tensors they are given), in every process:

  * ``as is``;
  * ``plain norms``: B9 and B10, one-pass and split, plain;
  * ``plain xent``: B11 and B12 plain;
  * ``all plain``: both.

Prints a line a run: the loss and the norm of each side, their relative
gap, and the leaves whose rank block lies farthest from the one-device
block (max |diff| over the leaf's largest one-device |gradient|), with how
many leaves exceed ``chip_smoke.FULL_LEAF_ATOL`` of their scale.  With
``--cpu`` it also carries the card's weights to the CPU and runs both
sides there through the plain versions (gloo ranks, 4 threads each);
with ``--cpu-drawn`` (and ``CUDA_VISIBLE_DEVICES=`` empty) both sides run
on the CPU from the weights drawn there instead.

Then the split passes against their plain versions at a rank's rows of
both token counts: B10's on the mLSTM's (rows, 2048) and B9's on the
sLSTM's (rows, 1024) fp32 blocks.  About 5-8 minutes on an H100 with
``--cpu``."""
import argparse
import dataclasses
import sys
import time

sys.path[:0] = ["src", ".", "scripts"]

VARIANTS = ("as is", "plain norms", "plain xent", "all plain", "no remat")
ARCH, LAYERS, BATCH = "xlstm-1.3b", 8, 2
# leaves printed a run, farthest first
SHOWN = 6


def patch(variant: str) -> None:
    """Swap kernels for their plain versions in this process."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.xent import kernel as xk

    if variant in ("plain norms", "all plain"):
        rk._cuda_ready = lambda *a, **k: False
    if variant in ("plain xent", "all plain"):
        xk.xent_nll = (lambda logits, labels, *, logical_v, brows=None:
                       xk.plain(logits, labels, logical_v))
        xk.xent_partials = (
            lambda logits, labels, *, vl, off, logical_v, brows=None:
            xk.plain_partials(logits, labels, vl=vl, off=off,
                              logical_v=logical_v))


def config(seq: int, variant: str = "as is"):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig

    cfg = dataclasses.replace(get_config(ARCH), dtype="float32",
                              n_layers=LAYERS,
                              remat=variant != "no remat")
    return cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=BATCH, d_model=cfg.d_model)


def card_weights(cfg):
    """The seed-0 weights drawn on the card, moved to the CPU."""
    from repro_torch.models import build_model
    from repro_torch.models.params import map_leaves

    return map_leaves(lambda t: t.cpu(), build_model(cfg).init(0,
                                                               device="cuda"))


def rank_job(mesh, variant: str, seq: int, on_cpu: bool) -> dict:
    """One rank's loss, gradient blocks and norm (``seeded_grads``), the
    kernels of ``variant`` swapped; on the CPU from the card's weights."""
    import torch

    from repro_torch.launch import mesh_checks
    from repro_torch.models import build_model
    from repro_torch.parallel import specs as specs_lib
    from repro_torch.parallel import steps

    patch(variant)
    cfg, data = config(seq, variant)
    if not on_cpu:
        return mesh_checks.seeded_grads(mesh, cfg, 0, data)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.parallel import rules as rules_lib

    torch.set_num_threads(4)
    rules = mesh_checks.mesh_rules(mesh, None, cfg)
    specs = specs_lib.param_specs(build_model(cfg).param_defs(), rules,
                                  mesh.axis_sizes)
    params = specs_lib.shard_tree(card_weights(cfg), specs, mesh)
    sharding = specs_lib.NamedSharding(mesh, rules_lib.spec(
        "batch", None, rules=rules, axis_sizes=mesh.axis_sizes,
        shape=(data.global_batch, data.seq_len)))
    grad_fn = steps.make_grad_fn(build_model(cfg), mesh=mesh, rules=rules)
    loss0, grads0, gnorm0 = grad_fn(params, make_batch(data, 0, sharding,
                                                        device="cpu"))
    return {"loss0": float(loss0), "grads0": grads0, "gnorm0": float(gnorm0),
            "specs": specs}


def compare(label, loss, norm, grads, ranks) -> None:
    import chip_smoke as cs
    from repro_torch.models.params import leaves
    from repro_torch.parallel import specs as specs_lib

    sizes = {"data": 1, "model": 2}
    rows = []
    for r, (res,) in enumerate(ranks):
        for path, g in leaves(grads):
            scale = float(g.abs().max())
            spec_ = res["specs"]
            got = res["grads0"]
            for k in path:
                spec_, got = spec_[k], got[k]
            block = specs_lib.shard_leaf(g, spec_, sizes, rank=r)
            err = float((got.float() - block.float()).abs().max())
            rows.append((err / scale if scale else float("inf"), r,
                         "/".join(path)))
    rows.sort(reverse=True)
    over = sum(1 for e, *_ in rows if e > cs.FULL_LEAF_ATOL)
    g0 = ranks[0][0]["gnorm0"]
    print(f"gap: {label}: loss {ranks[0][0]['loss0']!r} vs {loss!r}; norm "
          f"{g0!r} vs {norm!r} (relative {abs(g0 - norm) / norm:.3g}); "
          f"{over} of {len(rows)} rank blocks over {cs.FULL_LEAF_ATOL} of "
          f"scale; farthest: " + ", ".join(
              f"{name} r{r} {e:.3g}" for e, r, name in rows[:SHOWN]),
          flush=True)


def one_device(cfg, data, params, device):
    import torch

    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.params import map_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import steps

    loss, grads = steps.value_and_grad(build_model(cfg), params,
                                       make_batch(data, 0, device=device))
    norm = float(global_norm(grads))
    grads = map_leaves(lambda g: g.cpu(), grads)
    if device == "cuda":
        torch.cuda.empty_cache()
    return float(loss), norm, grads


def split_passes(seqs) -> None:
    """B9's and B10's split passes against their plain versions at a
    (1, 2) rank's rows of each token count."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel as rk

    g = torch.Generator(device="cuda").manual_seed(0)
    for seq in seqs:
        rows = BATCH * seq
        for name, width, gated in (("mLSTM B10", 2048, True),
                                   ("sLSTM B9", 1024, False)):
            x = torch.randn((rows, width), generator=g, device="cuda")
            z = (torch.randn((rows, width), generator=g, device="cuda")
                 if gated else None)
            scale = torch.randn((width,), generator=g, device="cuda")
            if gated:
                ss = rk.gated_sumsq2d(x, z, d_logical=width)
                y = rk.gated_apply2d(x, z, scale, ss, d_logical=width,
                                     d_total=2 * width)
            else:
                ss = rk.sumsq2d(x, d_logical=width)
                y = rk.apply2d(x, scale, ss, d_logical=width,
                               d_total=2 * width)
            ss_p = rk.plain_sumsq(x, width, z)
            y_p = rk.plain(x, scale, width, 1e-6, z, ss=ss_p,
                           d_total=2 * width)
            e_ss = float(((ss - ss_p).abs() / ss_p.abs()).max())
            e_y = float((y - y_p).abs().max() / y_p.abs().max())
            print(f"split: {name} ({rows}, {width}) fp32: stats max relative "
                  f"{e_ss:.3g}, apply max |diff| {e_y:.3g} of scale (block "
                  f"rows {rk.block_rows(rows)})", flush=True)


def main(argv=None) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib

    import xlstm_norm_gap as me

    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cpu-drawn", action="store_true",
                    help="only both sides on the CPU from the weights drawn "
                         "on the CPU (run it with CUDA_VISIBLE_DEVICES= "
                         "set empty: remat's checkpoint refuses a device "
                         "initialised inside its forward)")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--layers", action="store_true",
                    help="compare each layer's output and its gradient, "
                         "and each mLSTM chunk's, card against CPU")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    if args.cpu_drawn:
        return cpu_drawn(args.seqs[0])
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if args.layers:
        return layers(args.seqs[0])
    split_passes(args.seqs)
    for seq in args.seqs:
        for variant in (args.variants if seq == args.seqs[0]
                        else VARIANTS[:1]):
            cfg, data = config(seq, variant)
            t0 = time.perf_counter()
            saved = me._saved()
            patch(variant)
            loss, norm, grads = one_device(
                cfg, data, build(cfg), "cuda")
            me._restore(saved)
            ranks = mesh_lib.spawn(me.mesh_checks_run, (1, 2), device="cuda",
                                   args=(variant, seq, False))
            compare(f"{BATCH} x {seq} on the card, {variant}", loss, norm,
                    grads, ranks)
            print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
            del grads, ranks
            torch.cuda.empty_cache()
    if args.cpu:
        seq = args.seqs[0]
        cfg, data = config(seq)
        t0 = time.perf_counter()
        torch.set_num_threads(8)
        loss, norm, grads = one_device(cfg, data, card_weights(cfg), "cpu")
        ranks = mesh_lib.spawn(me.mesh_checks_run, (1, 2), device="cpu",
                               args=("as is", seq, True))
        compare(f"{BATCH} x {seq} on the CPU from the card's weights", loss,
                norm, grads, ranks)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def layers(seq: int) -> None:
    """One device, card against CPU on the card's weights: each layer's
    output and the gradient reaching it, in the order the backward meets
    them, then each mLSTM chunk's input gradients, recomputed on the CPU
    in fp32 and fp64 from the card's own inputs and output gradients."""
    import torch

    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model, transformer, xlstm
    from repro_torch.models.params import map_leaves
    from repro_torch.parallel import steps

    cfg, data = config(seq)
    model = build_model(cfg)
    params = build(cfg)
    seen = {}
    real_apply, real_chunk = transformer.apply_layer, xlstm._chunk

    def apply_layer(cfg_, body, *args):
        out = real_apply(cfg_, body, *args)
        i = len(seen.setdefault("layers", [])) % (cfg.n_layers + 1)
        rec = {"out": out[0].detach().cpu(), "i": i}
        seen["layers"].append(rec)
        out[0].register_hook(lambda g: rec.__setitem__("grad", g.cpu()))
        return out

    def chunk(*args):
        out = real_chunk(*args)
        if torch.is_grad_enabled() and out[3].requires_grad:
            rec = {"args": [a.detach().cpu() for a in args]}
            seen.setdefault("chunks", []).append(rec)
            for j, t in enumerate(out):
                if t.requires_grad:
                    t.register_hook(
                        lambda g, j=j: rec.setdefault("grads", {}).__setitem__(
                            j, g.cpu()))
        return out

    runs = {}
    transformer.apply_layer = apply_layer
    xlstm._chunk = chunk
    try:
        for dev, p in (("cuda", params),
                       ("cpu", map_leaves(lambda t: t.cpu(), params))):
            seen.clear()
            if dev == "cpu":
                torch.set_num_threads(8)
            steps.value_and_grad(model, p, make_batch(data, 0, device=dev))
            runs[dev] = dict(seen)
    finally:
        transformer.apply_layer, xlstm._chunk = real_apply, real_chunk
    card, cpu = runs["cuda"]["layers"], runs["cpu"]["layers"]
    print(f"layers: {len(card)} layer calls a run ({cfg.n_layers} layers; "
          f"with remat the recomputation's are not hooked)", flush=True)
    for a, b in list(zip(card, cpu))[::-1]:
        print(f"layer {a['i']}: output card vs CPU {_rel(a['out'], b['out']):.3g}"
              f", its gradient {_rel(a['grad'], b['grad']):.3g}"
              if "grad" in a and "grad" in b else
              f"layer {a['i']}: output {_rel(a['out'], b['out']):.3g}",
              flush=True)
    names = ("c0", "n0", "m0", "q", "k", "v", "li", "bcum")
    for n, rec in enumerate(runs["cuda"].get("chunks", [])):
        if "grads" not in rec:
            continue
        got = {}
        for where, dt in (("card", None), ("cpu32", torch.float32),
                          ("cpu64", torch.float64)):
            args = [a.cuda() if where == "card" else
                    (a.to(dt) if a.is_floating_point() else a)
                    for a in rec["args"]]
            args = [a.requires_grad_(True) if a.is_floating_point() else a
                    for a in args]
            out = real_chunk(*args)
            outs = [out[j] for j in rec["grads"]]
            gs = [rec["grads"][j].to(o.device, o.dtype) for j, o in
                  zip(rec["grads"], outs)]
            live = [a for a in args[:8] if a.requires_grad]
            got[where] = [g.cpu().double() for g in torch.autograd.grad(
                outs, live, gs, allow_unused=True, materialize_grads=True)]
        line = ", ".join(
            f"{nm} card {_rel(c, t):.2g} cpu {_rel(f, t):.2g}"
            for nm, c, f, t in zip(names, got["card"], got["cpu32"],
                                   got["cpu64"]))
        print(f"chunk {n}: input gradients against fp64: {line}",
              flush=True)
    ties(runs)


def _branches(args):
    """The chunk's two max decisions, from its inputs in fp64: whether
    the carry ``m0`` wins the stabiliser's ``max`` (u) at each (row,
    position, head), whether the floor ``exp(-m)`` wins ``max(|den|,
    exp(-m))``, and that max's relative gap."""
    import torch

    c0, n0, m0, qi, ki, vi, lii, bci, causal = (
        a.double() if a.is_floating_point() else a for a in args)
    run = torch.cummax(lii - bci, dim=1).values
    carry = m0[:, None, :] > run
    m = bci + torch.maximum(m0[:, None, :], run)
    dmat = (bci[:, :, None, :] - bci[:, None, :, :] + lii[:, None, :, :]
            - m[:, :, None, :])
    w = torch.exp(torch.where(causal[None, :, :, None], dmat,
                              float("-inf")))
    den_intra = torch.einsum("bijh,bjhp->bihp", w, ki)
    winter = torch.exp(bci + m0[:, None, :] - m)
    den = torch.einsum("bihp,bihp->bih", qi,
                       den_intra + n0[:, None, :, :] * winter[..., None])
    floor = torch.exp(-m)
    gap = (den.abs() - floor).abs() / torch.maximum(den.abs(), floor)
    return carry, floor > den.abs(), gap, den


def ties(runs) -> None:
    """Each mLSTM chunk's max decisions from the card's inputs against
    the CPU's (the same chunk of the same layer, inputs that differ by
    the two devices' rounding), and the chunk's input gradients, in
    fp64, from the one set of inputs against the other under the same
    output gradients: a decision that flips between them is a near-tie,
    and the gradient jumps there."""
    import torch

    card = [r for r in runs["cuda"].get("chunks", []) if "grads" in r]
    cpu = [r for r in runs["cpu"].get("chunks", []) if "grads" in r]
    for n, (a, b) in enumerate(zip(card, cpu)):
        ca, fa, ga, da = _branches(a["args"])
        cb, fb, gb, db = _branches(b["args"])
        grads = []
        for rec in (a, b):
            args = [x.double().requires_grad_(True) if x.is_floating_point()
                    else x for x in rec["args"]]
            out = xlstm_chunk()(*args)
            outs = [out[j] for j in b["grads"]]
            gs = [b["grads"][j].double() for j in b["grads"]]
            grads.append(torch.autograd.grad(
                outs, args[:8], gs, allow_unused=True,
                materialize_grads=True))
        jump = max(_rel(x, y) for x, y in zip(*grads) if y.abs().max() > 0)
        print(f"tie: chunk {n}: carry flips {int((ca != cb).sum())}, floor "
              f"wins {int(fa.sum())} (card) {int(fb.sum())} (CPU), floor "
              f"flips {int((fa != fb).sum())}, den sign flips "
              f"{int(((da > 0) != (db > 0)).sum())}, smallest floor gap "
              f"{float(torch.minimum(ga, gb).min()):.3g}; fp64 input "
              f"gradients, card inputs against CPU inputs: {jump:.3g}",
              flush=True)


def xlstm_chunk():
    from repro_torch.models import xlstm

    return xlstm._chunk


def cpu_drawn(seq: int) -> None:
    """One device and the (1, 2) mesh (``seeded_grads``, gloo ranks of 4
    threads) on the CPU from the weights drawn there."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model

    import xlstm_norm_gap as me

    cfg, data = config(seq)
    t0 = time.perf_counter()
    torch.set_num_threads(8)
    loss, norm, grads = one_device(cfg, data, build_model(cfg).init(
        0, device="cpu"), "cpu")
    ranks = mesh_lib.spawn(me.cpu_drawn_rank, (1, 2), device="cpu",
                           args=(seq,))
    compare(f"{BATCH} x {seq} on the CPU from the CPU's weights", loss, norm,
            grads, ranks)
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


def cpu_drawn_rank(mesh, seq):
    import torch

    from repro_torch.launch import mesh_checks

    torch.set_num_threads(4)
    cfg, data = config(seq)
    return [mesh_checks.seeded_grads(mesh, cfg, 0, data)]


def build(cfg):
    from repro_torch.models import build_model

    return build_model(cfg).init(0, device="cuda")


def mesh_checks_run(mesh, variant, seq, on_cpu):
    import xlstm_norm_gap as me

    return [me.rank_job(mesh, variant, seq, on_cpu)]


def _saved():
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.xent import kernel as xk

    return (rk._cuda_ready, xk.xent_nll, xk.xent_partials)


def _restore(saved):
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.xent import kernel as xk

    rk._cuda_ready, xk.xent_nll, xk.xent_partials = saved


if __name__ == "__main__":
    main()
