"""Execution-backed simulation: real fused train steps inside the
discrete-event simulator (port of ``repro.cluster.execution``; paper
§4.1 methodology, closed-loop variant).

The analytic simulator prices every group step with the throughput
oracle (core/throughput).  ``ExecutionBackend`` closes the loop: at each
scheduling horizon it mirrors the simulator's grouping decisions onto a
live ``ClusterController`` (one ``ElasticEngine`` per group — adapters
and optimizer state migrating losslessly as groups change), runs a few
*real* fused train steps per group on ``device`` (the GPU unless the
caller asks for the CPU), and feeds the measured step time back as the
simulated step time.  Every (predicted, measured) pair is recorded AND
fed to the attached ``OnlineCalibrator``, so the scheduler's oracle is
not just validated against execution — it is re-fitted from it online
(StepRecord.predicted vs .predicted_cal tracks the improvement).

The backend is a measurement instrument: it executes
``steps_per_measure`` real steps per (group, horizon), not the full
simulated step count.  The executable config is whatever the simulator
passes (the reduced variant, or the full-width one with
``reduced_models=False``).

Which base models execute is registry-driven: any registered config
small enough to step on one device qualifies (``executable_models``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.controller import (ClusterController, ModelView,
                                            effective_grad_sync)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import throughput as tp


def executable_models(max_params: float = 2e9) -> Tuple[str, ...]:
    """Registry-driven discovery of host-executable base models.

    A model qualifies when it offers a reduced variant and its FULL
    backbone stays under *max_params* parameters — small enough that
    real fused steps on a host CPU/single chip finish inside a test
    horizon.  Replaces the old hardcoded allowlist: registering a new
    small config makes it executable with no edit here.
    """
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        try:
            cfg.reduced()
        except Exception:               # no reduced variant -> not runnable
            continue
        if tp.param_counts(cfg)[0] <= max_params:
            out.append(arch)
    return tuple(out)


# evaluated once at import: the default allowlist (currently
# smollm-360m + tinyllama-1.1b, and any future config under the cap)
EXECUTABLE_MODELS = executable_models()


@dataclass
class StepRecord:
    """One measured-vs-predicted observation at a scheduling horizon."""
    t: float                       # simulated time of the horizon
    base_model: str
    job_ids: Tuple[str, ...]
    chips: int
    predicted: float               # analytic oracle step time (s), uncal
    measured: float                # wall-clock fused step time (s)
    predicted_cal: float = -1.0    # calibrated oracle at observation time
    #                                (-1 while the bucket is uncalibrated)

    @property
    def error(self) -> float:
        """Relative prediction error of the uncalibrated oracle."""
        return abs(self.predicted - self.measured) / max(self.measured,
                                                         1e-12)

    @property
    def error_cal(self) -> float:
        """Relative error of the calibrated oracle (falls back to the
        uncalibrated prediction while the bucket has no fit)."""
        p = self.predicted_cal if self.predicted_cal >= 0 else self.predicted
        return abs(p - self.measured) / max(self.measured, 1e-12)


class ExecutionBackend:
    """Mirrors simulator grouping onto a live ClusterController and
    measures real step times, feeding the online calibrator."""

    def __init__(self, *, steps_per_measure: int = 2,
                 models: Optional[Sequence[str]] = None,
                 impl: str = "cuda", block_t: int = 128, lr: float = 1e-3,
                 remat: bool = True, quantize: Optional[str] = None,
                 mesh=None, data_axis: str = "data",
                 grad_sync: str = "gather", tp_mode: str = "dp",
                 aimd_max_n: int = 16, nano_order: str = "job",
                 devices: Optional[Sequence] = None,
                 calibrator: Optional[tp.OnlineCalibrator] = None,
                 calibration_path: Optional[str] = None,
                 hw: tp.HardwareSpec = tp.V5E,
                 seed: int = 0, device="cuda"):
        assert steps_per_measure >= 2, \
            "need >=2 steps so min() discards the first step's warm-up"
        self.steps_per_measure = steps_per_measure
        self.models = tuple(models) if models is not None \
            else EXECUTABLE_MODELS
        grad_sync = effective_grad_sync(impl, mesh, grad_sync)
        # the effective measurement config, for introspection/tests
        self._engine_kwargs = dict(impl=impl, block_t=block_t, lr=lr,
                                   remat=remat, quantize=quantize,
                                   seed=seed, mesh=mesh,
                                   data_axis=data_axis,
                                   grad_sync=grad_sync, tp_mode=tp_mode)
        # the dtype bucket every measurement files under: int8 and bf16
        # runs of the same (model, chips, K) never share a fit
        self.backbone_dtype = "int8" if quantize == "int8" else "bf16"
        # warm-start: a table persisted by a previous backend run
        # restores this machine's fits before the first measurement
        if calibrator is None and calibration_path is not None \
                and os.path.exists(calibration_path):
            calibrator = tp.OnlineCalibrator.load(calibration_path)
        self.calibration_path = calibration_path
        self.calibrator = calibrator if calibrator is not None \
            else tp.OnlineCalibrator(hw)
        # controller modes: an explicit device pool partitions into
        # per-group submeshes (concurrent measurement); an explicit mesh
        # pins every group to it; neither = the meshless measurement
        # instrument (single-device semantics)
        self.controller = ClusterController(
            self._cfg_of, devices=devices, fixed_mesh=mesh,
            partition=devices is not None and mesh is None,
            calibrator=self.calibrator,
            calibration_path=calibration_path,
            concurrency="sequential", impl=impl, block_t=block_t, lr=lr,
            remat=remat, quantize=quantize,
            chunk_size=1, data_axis=data_axis,
            grad_sync=grad_sync, tp_mode=tp_mode,
            aimd_max_n=aimd_max_n, nano_order=nano_order, seed=seed,
            device=device)
        self._cfgs: Dict[str, ModelConfig] = {}
        self.records: List[StepRecord] = []

    def _cfg_of(self, base_model: str) -> ModelConfig:
        """The executable config is whatever the simulator passes to
        ``observe`` (usually the reduced variant)."""
        return self._cfgs[base_model]

    @property
    def regroup_events(self) -> int:
        """Live-state migrations executed across all groups."""
        return self.controller.regroup_events

    def save_calibration(self, path: Optional[str] = None):
        """Persist the fitted tables (step-time buckets + regroup-cost
        terms) so the next backend run on this machine warm-starts."""
        self.calibrator.save(path or self.calibration_path)

    def engine(self, base_model: str) -> Optional[ModelView]:
        """Per-model aggregate view (job ids, finished, step counts)."""
        if base_model not in self._cfgs:
            return None
        return self.controller.model_view(base_model)

    def observe(self, cfg: ModelConfig, group, predicted: float,
                now: float) -> Optional[float]:
        """Execute *group* for a few real steps; return measured step time
        (None if the model is not in the executable allowlist)."""
        base = group.jobs[0].spec.base_model
        if self.models and base not in self.models:
            return None
        self._cfgs[base] = cfg
        self.controller.register_cfg(base, cfg)
        known = set(self.controller.active_job_ids) \
            | set(self.controller.finished)
        for spec in group.specs:
            if spec.job_id not in known:
                self.controller.submit(spec)
        rt = self.controller.ensure_group(group.job_ids, chips=group.chips)
        # calibrated prediction BEFORE this observation updates the fit —
        # the honest "what would the calibrated oracle have said" number
        pred_cal = self.calibrator.predict(
            cfg, group.specs, group.chips,
            backbone_dtype=self.backbone_dtype) \
            if self.calibrator.calibrated else -1.0
        # chunk_size=1: per-step wall times are the signal, so keep
        # step-at-a-time granularity rather than chunk means; a rebuilt
        # group's first step (its step closures, tile tables and first
        # staging) is the window's outlier, which min() discards.  On a
        # pool the group's ranks step it and its first rank's time is
        # the one every rank records (the simulator decides by it).
        measured = None
        if rt is not None:
            rt.run(self.steps_per_measure, chunk_size=1)
            measured = rt.report.measured_step_time(self.steps_per_measure)
        measured = self.controller.first_rank_value(group.job_ids,
                                                    measured)
        self.calibrator.observe(cfg, group.specs, group.chips, measured,
                                backbone_dtype=self.backbone_dtype)
        self.records.append(StepRecord(
            t=now, base_model=base, job_ids=tuple(group.job_ids),
            chips=group.chips, predicted=predicted, measured=measured,
            predicted_cal=pred_cal))
        return measured

    # ------------------------------------------------------------ report
    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {"observations": 0, "regroup_events": 0}
        errs = [r.error for r in self.records]
        errs_cal = [r.error_cal for r in self.records]
        return {
            "observations": len(self.records),
            "regroup_events": self.regroup_events,
            "mean_predicted_s": sum(r.predicted for r in self.records)
            / len(self.records),
            "mean_measured_s": sum(r.measured for r in self.records)
            / len(self.records),
            "mean_rel_error": sum(errs) / len(errs),
            "max_rel_error": max(errs),
            "mean_rel_error_cal": sum(errs_cal) / len(errs_cal),
        }
