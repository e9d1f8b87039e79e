"""Evaluation metrics + small report helpers (paper §4.1 Metrics): a copy
of ``repro.cluster.metrics`` for the port, held to it by the tests."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.cluster.simulator import SimResult


def summarize(result: SimResult) -> Dict[str, float]:
    return {
        "throughput_samples_per_sec": result.avg_throughput,
        "avg_jct_sec": result.avg_jct,
        "p50_jct_sec": _pct(result.jct_cdf(), 50),
        "p95_jct_sec": _pct(result.jct_cdf(), 95),
        "utilization": result.utilization,
        "completion_rate": result.completion_rate,
        "makespan_sec": result.makespan,
    }


def _pct(arr: np.ndarray, q: float) -> float:
    return float(np.percentile(arr, q)) if len(arr) else float("inf")


def jct_stats(jcts: Sequence[float]) -> Dict[str, float]:
    """Distribution summary for MEASURED job-completion times (the trace
    harness's wall-clock JCTs — same shape as ``summarize``'s simulated
    block, so measured and simulated runs compare side by side)."""
    arr = np.asarray(list(jcts), float)
    if arr.size == 0:
        return {"avg_jct_s": 0.0, "p50_jct_s": 0.0, "p95_jct_s": 0.0,
                "max_jct_s": 0.0}
    return {"avg_jct_s": float(arr.mean()),
            "p50_jct_s": _pct(arr, 50),
            "p95_jct_s": _pct(arr, 95),
            "max_jct_s": float(arr.max())}


def recovery_stats(failures: Sequence) -> Dict[str, float]:
    """Aggregate recovery metrics over a run's ``FailureRecord``s."""
    fails = list(failures)
    if not fails:
        return {"faults": 0, "recovered": 0, "max_detect_latency_s": 0.0,
                "max_restore_s": 0.0, "max_steps_lost": 0,
                "total_steps_lost": 0}
    lost = [max(list(f.steps_lost.values()) or [0]) for f in fails]
    return {"faults": len(fails),
            "recovered": sum(1 for f in fails if f.recovered),
            "max_detect_latency_s": max(f.detect_latency_s for f in fails),
            "max_restore_s": max(f.restore_s for f in fails),
            "max_steps_lost": int(max(lost)),
            "total_steps_lost": int(sum(sum(f.steps_lost.values())
                                        for f in fails))}


def compare(results: Dict[str, SimResult],
            baseline: str = "mlora") -> Dict[str, Dict[str, float]]:
    """Relative improvements vs a baseline system (throughput x, JCT x,
    utilization delta) — the headline numbers of §4.2."""
    base = summarize(results[baseline])
    out = {}
    for name, res in results.items():
        s = summarize(res)
        out[name] = {
            **s,
            "throughput_x": s["throughput_samples_per_sec"]
            / max(base["throughput_samples_per_sec"], 1e-12),
            "jct_speedup_x": base["avg_jct_sec"] / max(s["avg_jct_sec"], 1e-12),
            "utilization_delta": s["utilization"] - base["utilization"],
        }
    return out


def size_terciles(results: SimResult) -> Dict[str, Tuple[float, float]]:
    """Fig. 6b: grouping ratio by job compute-cost tercile."""
    logs = list(results.logs.values())
    costs = np.array([l.spec.rank * l.spec.batch_size * l.spec.seq_len
                      for l in logs], float)
    lo, hi = np.percentile(costs, [33, 66])
    out = {}
    for name, sel in (("small", costs <= lo),
                      ("medium", (costs > lo) & (costs <= hi)),
                      ("large", costs > hi)):
        sub = [l for l, s in zip(logs, sel) if s]
        ratio = float(np.mean([l.grouping_ratio for l in sub])) if sub else 0.0
        out[name] = (ratio, len(sub))
    return out


def format_table(rows: Sequence[Dict], cols: Sequence[str],
                 title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"## {title}")
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows))
              for c in cols}
    lines.append(" | ".join(c.ljust(widths[c]) for c in cols))
    lines.append("-|-".join("-" * widths[c] for c in cols))
    for r in rows:
        lines.append(" | ".join(_fmt(r.get(c)).ljust(widths[c])
                                for c in cols))
    return "\n".join(lines)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0 or 1e-3 <= abs(v) < 1e5:
            return f"{v:.3f}".rstrip("0").rstrip(".")
        return f"{v:.3e}"
    return str(v)
