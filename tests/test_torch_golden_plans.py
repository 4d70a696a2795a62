"""Golden snapshot of the port's Hopper planner (ROADMAP A7.5).

Every registry kernel x {fp32, bf16} x one odd and one even logical shape
is planned under the H100 data sheet's limits (232,448 B of shared memory
a CTA, 132 SMs) and compared field by field against
``tests/golden/torch_plans.json``, beside the reference's
``tests/golden/plans.json``; so are the reference's per-shard
``SPMD_LOCAL_CELLS`` with their ``predicted_comm_bytes``.  Any planner
change that moves a padded shape, a block, the waste or the predicted
traffic shows up as a readable per-cell diff; deliberate changes are
blessed with:

    pytest tests/test_torch_golden_plans.py --update-golden
"""
import json
import os

import pytest

from test_golden_plans import SHAPES as REFERENCE_SHAPES
from test_golden_plans import SPMD_LOCAL_CELLS

from repro_torch import api
from repro_torch.core import layout

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "torch_plans.json")

# (odd, even) logical shapes a kernel: the reference's for its eleven, the
# one-pass norms' for the split passes
SHAPES = dict(REFERENCE_SHAPES)
SHAPES.update({k: REFERENCE_SHAPES["rmsnorm"] for k in (
    "rmsnorm.sumsq", "rmsnorm.gated.sumsq", "rmsnorm.apply",
    "rmsnorm.gated.apply")})
DTYPES = ("float32", "bfloat16")
LIMITS = dict(smem_budget=layout.H100_SMEM_PER_CTA,
              sm_count=layout.H100_SM_COUNT)


def snapshot_plan(plan) -> dict:
    return {
        "padded_shape": list(plan.padded_shape),
        "block_shape": list(plan.block_shape),
        "grid": list(plan.grid),
        "minor_unit": plan.minor_unit,
        "waste_bytes": plan.waste_bytes,
        "predicted_hbm_bytes": plan.predicted_hbm_bytes,
        "predicted_logical_bytes": plan.predicted_logical_bytes,
        "predicted_comm_bytes": plan.predicted_comm_bytes,
        "predicted_balance": round(plan.predicted_balance, 4),
        "naive_balance": round(plan.naive_balance, 4),
    }


def current_snapshot() -> dict:
    # every shipped kernel is snapshotted (kernels registered ad hoc by
    # other tests are not); a shipped kernel missing from SHAPES fails
    shipped = [k for k in api.list_kernels()
               if api.resolve(k).body.__module__.startswith("repro_torch.")]
    missing = set(shipped) - set(SHAPES)
    assert not missing, f"add golden shapes for new kernels: {sorted(missing)}"
    out = {}
    with api.plan_context(**LIMITS):
        for kernel in shipped:
            for shape in SHAPES[kernel]:
                for dtype in DTYPES:
                    key = f"{kernel}|{'x'.join(map(str, shape))}|{dtype}"
                    out[key] = snapshot_plan(api.plan_for(kernel, shape,
                                                          dtype))
        for kernel, shape, dtype, mesh in SPMD_LOCAL_CELLS:
            tag = ".".join(f"{a}{s}" for a, s in mesh)
            key = (f"{kernel}|{'x'.join(map(str, shape))}|{dtype}"
                   f"|local@{tag}")
            with api.plan_context(mesh=dict(mesh)):
                out[key] = snapshot_plan(
                    api.plan_for(kernel, shape, dtype, local=True))
    return out


def test_plans_match_golden(request):
    current = current_snapshot()
    if request.config.getoption("--update-golden"):
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        with open(GOLDEN_PATH, "w") as f:
            json.dump(current, f, indent=1, sort_keys=True)
        pytest.skip(f"regenerated {GOLDEN_PATH} ({len(current)} plans)")
    if not os.path.exists(GOLDEN_PATH):
        pytest.fail(f"{GOLDEN_PATH} missing; generate it with "
                    f"`pytest {__file__} --update-golden`")
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    lines = []
    for key in sorted(set(golden) | set(current)):
        if key not in golden:
            lines.append(f"  + {key}: new cell (not in golden)")
            continue
        if key not in current:
            lines.append(f"  - {key}: golden cell no longer planned")
            continue
        for field in sorted(set(golden[key]) | set(current[key])):
            g, c = golden[key].get(field), current[key].get(field)
            if g != c:
                lines.append(f"  ~ {key}.{field}: golden {g} -> current {c}")
    if lines:
        pytest.fail(
            "planner output drifted from tests/golden/torch_plans.json "
            "(bless deliberate changes with --update-golden):\n"
            + "\n".join(lines), pytrace=False)


def test_golden_covers_every_kernel_dtype_and_local_cell():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    kernels = {k.split("|")[0] for k in golden}
    assert len(kernels) == 15
    assert sum("|local@" in k for k in golden) == len(SPMD_LOCAL_CELLS)
    assert len(golden) == 15 * 2 * len(DTYPES) + len(SPMD_LOCAL_CELLS)
    # the communicating local cells price their collectives
    comm = {k: v["predicted_comm_bytes"] for k, v in golden.items()
            if "|local@" in k}
    assert all(v > 0 for k, v in comm.items()
               if not k.startswith("rmsnorm")), comm
