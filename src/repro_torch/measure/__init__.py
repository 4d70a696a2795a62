"""Measured-vs-predicted validation for the port's layout planner.

Counterpart of ``repro.measure``.  The paper derives padding and skew
analytically and *validates* the claim by measuring bandwidth against the
model; this package is that loop for the port on the card:

  * ``validate`` -- time every registry kernel's body at its plan with CUDA
    events against ``KernelPlan.predicted_hbm_bytes`` at the data sheet's
    memory rate, within per-family envelopes (a timed check, not a byte
    census: the port has no compiled program to read), and hold the
    collectives a mesh of ranks issues against ``predicted_comm_bytes``;
  * ``sweep`` -- sweep the planner's shared-memory budget and SM count per
    (kernel, shape, dtype) cell around the analytic choice, time each
    distinct geometry on the card, emit a profile;
  * ``profile`` -- the versioned profile format plus ``load_profile`` /
    ``save_profile``, so ``PlanContext.from_profile(path)`` (a launcher's
    ``--plan-profile``) replays a measured sweep;
  * ``timing`` -- the CUDA-event timer and the data-sheet rates.
"""
from repro_torch.measure.profile import (
    PROFILE_FORMAT,
    PROFILE_VERSION,
    audit_profile,
    entry_from_plan,
    load_profile,
    profile_key,
    save_profile,
)
from repro_torch.measure.timing import DATASHEET, datasheet, time_ms

__all__ = [
    "PROFILE_FORMAT", "PROFILE_VERSION",
    "entry_from_plan", "load_profile", "profile_key", "save_profile",
    "audit_profile", "DATASHEET", "datasheet", "time_ms",
]
