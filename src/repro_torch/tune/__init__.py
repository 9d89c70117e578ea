"""Self-tuning serving: the recall-SLO autotuner and per-query escalation.

* :mod:`.autotune`: offline, sweep the
  :data:`~repro_torch.api.index.KNOB_LADDER` on held-out queries, fit the
  Pareto :class:`OperatingCurve` (recall against ``distance_evals`` and
  QPS), persist it keyed by ``index.fingerprint()``. The serving engine
  maps ``target_recall`` through it to the cheapest operating point.
* :mod:`.escalate`: online, the top-k margin-stability signal
  (:func:`topk_margin`) and :class:`EscalationPolicy`; the engine re-runs
  only unstable queries one ladder rung up.
"""
from ..api.index import KNOB_LADDER, SearchParams, next_rung, snap_knob
from .autotune import (
    OperatingCurve,
    OperatingPoint,
    candidate_params,
    curve_path,
    load_curve,
    pareto,
    save_curve,
    sweep,
)
from .escalate import EscalationPolicy, topk_margin, unstable_rows

__all__ = [
    "EscalationPolicy",
    "KNOB_LADDER",
    "OperatingCurve",
    "OperatingPoint",
    "SearchParams",
    "candidate_params",
    "curve_path",
    "load_curve",
    "next_rung",
    "pareto",
    "save_curve",
    "snap_knob",
    "sweep",
    "topk_margin",
    "unstable_rows",
]
