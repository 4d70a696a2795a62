"""The port's first slice end to end, and the import rule that keeps the
port apart from the JAX package.

The quickstart flow (diagnose -> plan -> launch -> explain, as
examples/quickstart.py runs it) goes through ``repro_torch`` on the CPU and
through ``repro`` with Pallas in interpret mode, on the same numpy inputs.
The conflict model's numbers must be equal; kernel results are held to the
fp32 tolerance of tests/test_kernels.py (rtol 1e-5, atol 1e-6), since both
sides round each product and sum in fp32.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.aliasing import InterleavedMemoryModel as JModel
from repro.core.aliasing import Stream as JStream
from repro.core.autotune import StreamSignature as JSig
from repro.core.autotune import plan_streams as jplan_streams
from repro.kernels.jacobi import ops as jjops
from repro.kernels.lbm import ops as jlops
from repro.kernels.triad import ops as jtops
from repro_torch import api, interop
from repro_torch.core.aliasing import InterleavedMemoryModel, Stream
from repro_torch.core.autotune import StreamSignature, plan_streams
from repro_torch.kernels.jacobi import ops as jops
from repro_torch.kernels.lbm import ops as lops
from repro_torch.kernels.triad import ops as tops

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FP32 = dict(rtol=1e-5, atol=1e-6)


def test_quickstart_flow_matches_reference():
    # 1. diagnose: all arrays page-aligned collapse to one controller
    aligned = [Stream(0, "write")] + [Stream(0, "read")] * 3
    jaligned = [JStream(0, "write")] + [JStream(0, "read")] * 3
    balance = InterleavedMemoryModel().balance(aligned)
    assert balance == JModel().balance(jaligned) == 0.25
    # 2. the closed-form skew plan: 128/256/384 B
    plan = plan_streams(StreamSignature(n_read=3, n_write=1),
                        InterleavedMemoryModel())
    jplan = jplan_streams(JSig(n_read=3, n_write=1), JModel())
    assert plan.offsets_bytes == jplan.offsets_bytes == (0, 128, 256, 384)
    assert plan.predicted_balance == jplan.predicted_balance > balance
    # 3. the kernel under the layout, through the one launch path
    n = 100_000
    x = [np.linspace(lo, lo + 1, n, dtype=np.float32) for lo in range(3)]
    t = [interop.to_torch(v, device="cpu") for v in x]
    j = [jnp.asarray(v) for v in x]
    out = api.launch("triad", *t)
    np.testing.assert_allclose(interop.to_numpy(out),
                               np.asarray(japi.launch("triad", *j)), **FP32)
    report = api.explain("triad", (n,), torch.float32)
    assert report.startswith(f"plan[triad] logical=({n},) float32")
    assert "offsets=(0, 128, 256, 384)B" in report
    phases = tuple(o // 8 for o in plan.offsets_bytes[1:])
    np.testing.assert_allclose(
        interop.to_numpy(tops.vector_triad_phased(*t, phases=phases)),
        np.asarray(jtops.vector_triad_phased(*j, phases=phases)), **FP32)


def test_every_ported_kernel_matches_reference():
    rng = np.random.default_rng(5)
    vecs = [rng.standard_normal(5000).astype(np.float32) for _ in range(3)]
    t = [interop.to_torch(v, device="cpu") for v in vecs]
    j = [jnp.asarray(v) for v in vecs]
    calls = {"stream.copy": (1, {}), "stream.scale": (1, {"s": 2.5}),
             "stream.add": (2, {}), "stream.triad": (2, {"s": 2.5}),
             "triad": (3, {})}
    # the split norm's passes are held to the reference's whole-row norm
    # in tests/test_torch_rmsnorm_split.py
    split = ["rmsnorm.sumsq", "rmsnorm.apply", "rmsnorm.gated.sumsq",
             "rmsnorm.gated.apply"]
    assert sorted([*calls, "jacobi", "lbm.soa", "lbm.ivjk", "rmsnorm",
                   "rmsnorm.gated", "xent", *split]) == api.list_kernels()
    for name, (arity, kw) in calls.items():
        np.testing.assert_allclose(
            interop.to_numpy(api.launch(name, *t[:arity], **kw)),
            np.asarray(japi.launch(name, *j[:arity], **kw)), **FP32)
    grid = rng.random((50, 77), dtype=np.float32)
    np.testing.assert_allclose(
        interop.to_numpy(jops.jacobi_sweeps(interop.to_torch(grid, device="cpu"),
                                            5)),
        np.asarray(jjops.jacobi_sweeps(jnp.asarray(grid), 5)), **FP32)
    x, z = (rng.standard_normal((3, 7, 96)).astype(np.float32)
            for _ in range(2))
    scale = rng.standard_normal(96).astype(np.float32) + 1
    np.testing.assert_allclose(
        interop.to_numpy(api.launch("rmsnorm", *(interop.to_torch(a, device="cpu")
                                                 for a in (x, scale)))),
        np.asarray(japi.launch("rmsnorm", jnp.asarray(x), jnp.asarray(scale))),
        **FP32)
    np.testing.assert_allclose(
        interop.to_numpy(api.launch("rmsnorm.gated",
                                    *(interop.to_torch(a, device="cpu")
                                      for a in (x, z, scale)))),
        np.asarray(japi.launch("rmsnorm.gated", jnp.asarray(x), jnp.asarray(z),
                               jnp.asarray(scale))), **FP32)
    logits = 3 * rng.standard_normal((37, 501)).astype(np.float32)
    labels = rng.integers(0, 480, size=37).astype(np.int32)
    np.testing.assert_allclose(
        float(api.launch("xent", interop.to_torch(logits, device="cpu"),
                         interop.to_torch(labels, device="cpu"),
                         logical_v=480)),
        float(japi.launch("xent", jnp.asarray(logits), jnp.asarray(labels),
                          logical_v=480)), **FP32)
    lattice = np.asarray(jlops.init_equilibrium(10, jnp.float32))
    for layout in ("soa", "ivjk"):
        np.testing.assert_allclose(
            interop.to_numpy(lops.lbm_run(
                interop.to_torch(lattice, device="cpu"), 1.2, 2, layout=layout)),
            np.asarray(jlops.lbm_run(jnp.asarray(lattice), 1.2, 2,
                                     layout=layout)),
            rtol=2e-4, atol=1e-6)


def test_interop_carries_bf16_like_jax():
    x = np.random.default_rng(6).standard_normal(257).astype(np.float32)
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    from_f32 = interop.to_torch(x, device="cpu", dtype="bfloat16")
    from_bf16 = interop.to_torch(np.asarray(jb), device="cpu")
    assert from_f32.dtype == from_bf16.dtype == torch.bfloat16
    assert torch.equal(from_f32, from_bf16)
    np.testing.assert_array_equal(interop.to_numpy(from_f32),
                                  np.asarray(jb, np.float32))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_reference(path):
    """No file of the port, nor chip_smoke.py, imports jax or repro."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch import api\n"
        "api.list_kernels()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_entry_points_without_a_device_raise_on_a_cpu_only_box():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.to_torch(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        jops.init_grid(4, 4)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
