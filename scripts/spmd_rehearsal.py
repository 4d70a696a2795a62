"""Phase 3d of ``chip_smoke.py`` alone on the card: the B12 checks, the
(2, 2) backward checks, the full-width fp32 backward, the Qwen2-0.5B
(1, 2) launcher run and its replay (``spmd_phase``), and whisper-tiny's
two meshes (``whisper_mesh_phase``), each held against one-device forwards
of the same seeded weights, which stand in for phases 3c's and 3h's
training runs (step 0's rate is 0 under warmup, so a run's first two
losses are forwards).  From the root of a checkout, on a machine with a
CUDA card:

    python3 scripts/spmd_rehearsal.py

It prints the phases' ``check:``, ``spmd:`` and ``profile:`` lines and
their seconds (about 5 minutes on an H100).  ``python3
scripts/spmd_rehearsal.py 3j`` runs phase 3j alone instead
(``recurrent_tp_phase``: zamba2-1.2b and xlstm-1.3b tensor-parallel on
``1x2``, about 2 minutes); ``python3 scripts/spmd_rehearsal.py 3k`` runs
the (2, 2) backward checks (``mesh_backward_checks``, the FSDP jobs among
them) and phase 3k (``fsdp_phase``: qwen3-14b under FSDP on ``2x1``);
``python3 scripts/spmd_rehearsal.py 3l`` runs phase 3b (``serving_phase``,
whose one-device streams and logits phase 3l replays), phase 3l
(``serve_mesh_phase``: Qwen3-4B served on ``2x2``) and the (2, 2) checks
with their serving jobs; ``python3 scripts/spmd_rehearsal.py 3m`` runs
phase 3m (``serve_flash_phase``: Qwen2-0.5B served on ``1x4``, the cache's
positions cut four ways) and the (2, 2) checks with their masked-loss and
flash-decoding jobs; ``python3 scripts/spmd_rehearsal.py obs`` runs the
phases that stream to the obs bus (ROADMAP A7.1) and their gates: phase
1's obs smoke, 3b, 3c, 3d and the report over their streams (about 8
minutes); ``python3 scripts/spmd_rehearsal.py measure`` runs what the
measure phase (ROADMAP A7.2-A7.5) touches: ``python -m
repro_torch.measure.validate --all`` and ``.sweep --all`` on the card
(their reports under ``build/``), the CLI's comm census on a (2, 1)
mesh, ``measure_phase``, phase 3d with its ``--plan-profile``, phase 3i
with its comm census, and the report over the 3d and measure streams
(about 7 minutes)."""
import dataclasses
import sys
import time

sys.path[:0] = ["src", "."]


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line())
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")

    def forwards(arch, data, n, layers=0):
        cfg = get_config(arch)
        model = build_model(dataclasses.replace(cfg, n_layers=layers)
                            if layers else cfg)
        params = model.init(cs.SEED)
        with torch.no_grad():
            out = [{"loss": float(model.loss(params, make_batch(data, i))),
                    "grad_norm": float("nan")} for i in range(n)]
        del model, params
        torch.cuda.empty_cache()
        return out

    if sys.argv[1:] == ["3k"]:
        t0 = time.perf_counter()
        cs.mesh_backward_checks()
        print(f"the (2, 2) backward checks {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.fsdp_phase()
        print(f"phase 3k {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["3l"]:
        t0 = time.perf_counter()
        _, one = cs.serving_phase()
        print(f"phase 3b {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.serve_mesh_phase(one)
        print(f"phase 3l {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.mesh_backward_checks()
        print(f"the (2, 2) backward and serving checks "
              f"{time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["3m"]:
        t0 = time.perf_counter()
        cs.serve_flash_phase()
        print(f"phase 3m {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.mesh_backward_checks()
        print(f"the (2, 2) backward, masked-loss and serving checks "
              f"{time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["obs"]:
        import shutil

        shutil.rmtree(cs.OBS_DIR, ignore_errors=True)
        cs.OBS_DIR.mkdir(parents=True)
        seconds = {}
        for name, fn in (("1 obs", cs.phase1_obs), ("3b", cs.serving_phase),
                         ("3c", cs.training_phase)):
            t0 = time.perf_counter()
            out = fn()
            seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        cs.spmd_phase(out[1])
        seconds["3d"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        cs.obs_report()
        seconds["obs report"] = round(time.perf_counter() - t0, 1)
        print(f"seconds a phase {seconds}")
        return
    if sys.argv[1:] == ["measure"]:
        import os
        import shutil
        import subprocess

        from repro_torch.measure import sweep, validate

        shutil.rmtree(cs.OBS_DIR, ignore_errors=True)
        cs.OBS_DIR.mkdir(parents=True)
        seconds = {}
        for name, argv, fn in (
                ("validate", ["--all", "--out",
                              "build/validation.json"], validate.main),
                ("sweep", ["--all", "--out", "build/profile.json"],
                 sweep.main),
                ("comm", ["--comm", "--exposed", "--mesh", "2x1", "--out",
                          "build/validation_comm.json"],
                 validate.main)):
            t0 = time.perf_counter()
            print(f"{name}: exit {fn(argv)}")
            seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        cs.measure_phase()
        seconds["measure"] = round(time.perf_counter() - t0, 1)
        q = get_config(cs.TRAIN_ARCH)
        train = forwards(cs.TRAIN_ARCH, DataConfig(
            vocab_size=q.vocab_size, seq_len=cs.TRAIN_SEQ,
            global_batch=cs.TRAIN_BATCH), cs.SPMD_STEPS, cs.TRAIN_LAYERS)
        for name, fn, args in (("3d", cs.spmd_phase, (train,)),
                               ("3i", cs.halo_phase, ())):
            t0 = time.perf_counter()
            fn(*args)
            seconds[name] = round(time.perf_counter() - t0, 1)
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report",
             "--fail-on-validation"]
            + [str(cs.OBS_DIR / f"{n}.jsonl") for n in ("spmd", "measure")],
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH="src"))
        print(out.stdout, out.stderr, f"report exit {out.returncode}")
        print(f"seconds a phase {seconds}")
        return
    if sys.argv[1:] == ["3j"]:
        t0 = time.perf_counter()
        cs.recurrent_tp_phase()
        print(f"phase 3j {time.perf_counter() - t0:.1f} s")
        return

    q = get_config(cs.TRAIN_ARCH)
    train = forwards(cs.TRAIN_ARCH, DataConfig(
        vocab_size=q.vocab_size, seq_len=cs.TRAIN_SEQ,
        global_batch=cs.TRAIN_BATCH), cs.SPMD_STEPS, cs.TRAIN_LAYERS)
    w = get_config(cs.ENCDEC_ARCH)
    whisper = forwards(cs.ENCDEC_ARCH, DataConfig(
        vocab_size=w.vocab_size, seq_len=cs.ENCDEC_TRAIN_SEQ,
        global_batch=cs.ENCDEC_TRAIN_BATCH, n_frames=w.n_frames,
        d_model=w.d_model), 2)
    print("one-device forwards", train, whisper)
    t0 = time.perf_counter()
    cs.spmd_phase(train)
    print(f"phase 3d {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.whisper_mesh_phase(whisper)
    print(f"phase 3d's whisper part {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
