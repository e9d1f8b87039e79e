"""Adapter Scheduler — Algorithm 1 (paper §3.4): a copy of
``repro.core.scheduler`` for the port over its throughput copy, held to
it by the tests.

Online, residual-capacity-aware grouping:

  * sort active jobs by urgency (desc) then residual capacity (asc);
  * seed with the most constrained job; binary-cut search the residual-
    sorted tail for the cutoff where adding members stops improving the
    predicted joint throughput;
  * enforce per-job progress: reject any merge that pushes a member past
    its bounded-slowdown constraint Δ_j(G) ≤ Δ_j^max;
  * hierarchical tiers (node → cross-node → rank): merges that span a
    wider tier pay the wider tier's bandwidth in the cost model, pruning
    the combinatorial space bottom-up;
  * pack-and-reinsert until no beneficial merge remains: O(K log K).

The throughput oracle T̂(G) is core/throughput.group_throughput — the same
three-term roofline model the dry-run §Roofline uses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import JobRuntimeState, LoRAJobSpec
from repro_torch.core import throughput as tp


@dataclass
class Group:
    """A (possibly singleton) set of co-located jobs with pooled chips.

    ``stages`` > 1 marks a group the scheduler could only fit by
    stage-partitioning the scanned layer stack (tp_mode="pipeline",
    DESIGN.md §15): each chip then keeps 1/stages of the stack instead
    of a full replica, at the price of the pipeline bubble."""
    jobs: List[JobRuntimeState]
    chips: int
    spans_nodes: bool = False
    stages: int = 1

    @property
    def specs(self) -> List[LoRAJobSpec]:
        return [j.spec for j in self.jobs]

    @property
    def job_ids(self) -> Tuple[str, ...]:
        return tuple(j.spec.job_id for j in self.jobs)

    def urgency(self) -> float:
        return max(j.urgency() for j in self.jobs)

    def residual(self, cfg: ModelConfig, hw: tp.HardwareSpec,
                 ragged_kernels: bool = True) -> float:
        cost = tp.group_step_cost(cfg, self.specs, self.chips, hw=hw,
                                  spans_nodes=self.spans_nodes,
                                  ragged_kernels=ragged_kernels)
        return max(0.0, 1.0 - cost.useful_fraction)


@dataclass
class SchedulerConfig:
    hw: tp.HardwareSpec = tp.V5E
    kernel_fused: bool = True
    ragged_kernels: bool = True   # price true per-adapter padded ranks
    #                               (False = legacy K·r_max masked cost,
    #                               which over-penalizes mixed-rank merges)
    min_gain: float = 1.02        # merge must beat sum-of-parts by ≥2%
    max_group: int = 8            # SSM stack width cap (K)
    # backbone storage mode the groups will actually run with: None =
    # bf16, "int8" = quantized frozen backbone (models/quant).  Prices
    # the weight-streaming floor, min_chips, the memory gate, and picks
    # the calibrator's dtype bucket.
    quantize: Optional[str] = None
    # remat flag the runtimes will train with — the memory gate's
    # activation high-water depends on it (see elastic/runtime.py for
    # the speed/memory tradeoff discussion).
    remat: bool = True
    # HBM fraction the memory gate may fill (rest: fragmentation +
    # collective buffers)
    mem_headroom: float = 0.9
    # residency model the memory gate prices (throughput.
    # group_memory_bytes): "tp" = ideally tensor-sharded params (the
    # historical gate), "dp" = the fully-manual data-parallel step's
    # replicated params — the mode whose failures the pipeline
    # fallback rescues
    mem_tp_mode: str = "tp"

    @property
    def backbone_dtype(self) -> str:
        return "int8" if self.quantize == "int8" else "bf16"

    @property
    def priced_hw(self) -> tp.HardwareSpec:
        """`hw` repriced for the configured backbone storage dtype."""
        return tp.with_backbone_dtype(self.hw, self.backbone_dtype)


class AdapterScheduler:
    """Hierarchical incremental grouping (Algorithm 1, lines 4-16).

    With a ``calibrator`` (core/throughput.OnlineCalibrator) every
    oracle probe — joint throughput, slowdown feasibility, residual
    capacity, elastic shrink — is priced with MEASURED effective
    hardware constants for this model at the probed chip count, so
    grouping decisions track how groups actually run (paper §3.4's
    online scheduling, closed-loop)."""

    def __init__(self, cfg: ModelConfig,
                 sched: Optional[SchedulerConfig] = None,
                 calibrator: Optional[tp.OnlineCalibrator] = None):
        self.cfg = cfg
        self.sched = sched or SchedulerConfig()
        self.calibrator = calibrator

    # ------------------------------------------------------------ oracle
    def hw_for(self, chips: int, k: int = 1) -> tp.HardwareSpec:
        """Hardware constants used to price a K-job group on *chips* —
        the calibrated fit for the configured backbone dtype when one
        exists, the static (dtype-repriced) config otherwise."""
        if self.calibrator is None:
            return self.sched.priced_hw
        return self.calibrator.hw_for(self.cfg.name, chips, k,
                                      self.sched.backbone_dtype)

    def throughput(self, group: Group) -> float:
        return tp.group_throughput(self.cfg, group.specs, group.chips,
                                   hw=self.hw_for(group.chips,
                                                  len(group.jobs)),
                                   spans_nodes=group.spans_nodes,
                                   kernel_fused=self.sched.kernel_fused,
                                   ragged_kernels=self.sched.ragged_kernels)

    def _merged(self, a: Group, b: Group, spans: bool) -> Group:
        return Group(a.jobs + b.jobs, a.chips + b.chips,
                     spans_nodes=a.spans_nodes or b.spans_nodes or spans)

    def _group_time(self, g: Group) -> float:
        if g.stages > 1:
            return tp.pipeline_step_cost(
                self.cfg, g.specs, g.chips, stages=g.stages,
                hw=self.hw_for(g.chips, len(g.jobs)),
                spans_nodes=g.spans_nodes,
                kernel_fused=self.sched.kernel_fused,
                ragged_kernels=self.sched.ragged_kernels).total
        return tp.group_step_cost(self.cfg, g.specs, g.chips,
                                  hw=self.hw_for(g.chips, len(g.jobs)),
                                  spans_nodes=g.spans_nodes,
                                  kernel_fused=self.sched.kernel_fused,
                                  ragged_kernels=self.sched.ragged_kernels
                                  ).total

    # ------------------------------------------------- transition pricing
    def transition_cost(self) -> float:
        """One-time cost (s) of rebuilding a live group: pause + migrate
        + compile + resume.  Measured stalls via the calibrator when the
        control plane has observed any; ``hw.regroup_overhead``
        otherwise."""
        if self.calibrator is not None:
            return self.calibrator.regroup_cost(self.cfg.name)
        return self.sched.hw.regroup_overhead

    def filter_transitions(self, proposed: List[Group],
                           current: Sequence[Group]) -> List[Group]:
        """Reject regroups whose payback horizon exceeds the affected
        jobs' residual time.

        *current* is the set of LIVE groups (training state that a
        rebuild would interrupt).  Proposed groups are clustered into
        connected components with the current groups they touch; a
        component whose projected residual-time saving does not cover
        its transition cost keeps the status quo (surviving current
        groups + singletons for members those don't cover).  Components
        of entirely new jobs, and proposed groups identical to a live
        group (runtime + compiled step reused), are free.
        """
        if not current or not proposed:
            return list(proposed)
        cur_sets = {frozenset(g.job_ids) for g in current}
        home = {jid: i for i, g in enumerate(proposed) for jid in g.job_ids}
        parent = list(range(len(proposed)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for cg in current:
            idxs = sorted({home[jid] for jid in cg.job_ids if jid in home})
            for a, b in zip(idxs, idxs[1:]):
                parent[find(a)] = find(b)
        comps: Dict[int, List[Group]] = {}
        for i, g in enumerate(proposed):
            comps.setdefault(find(i), []).append(g)
        cur_by_root: Dict[int, List[Group]] = {}
        for cg in current:
            idxs = {home[jid] for jid in cg.job_ids if jid in home}
            if idxs:
                cur_by_root.setdefault(find(next(iter(idxs))), []).append(cg)

        def horizon(gs: Sequence[Group]) -> float:
            # chip-seconds to drain the residual work: each group holds
            # its chips until the slowest member's budget runs out.
            # This is the quantity elastic sharing improves — a merge
            # that frees chips at equal step time shows its saving here,
            # while job-wall-seconds would hide it.
            return sum(max((max(j.spec.steps_budget - j.steps_done, 0)
                            for j in g.jobs), default=0)
                       * self._group_time(g) * max(g.chips, 1)
                       for g in gs)

        out: List[Group] = []
        cost1 = self.transition_cost()
        for root, news in comps.items():
            olds = cur_by_root.get(root, [])
            rebuilt = [g for g in news
                       if frozenset(g.job_ids) not in cur_sets]
            if not olds or not rebuilt:
                out.extend(news)
                continue
            # status quo: current groups whose members all survive, plus
            # singletons for everyone else in the component
            jobs_by_id = {j.spec.job_id: j for g in news for j in g.jobs}
            quo, placed = [], set()
            for cg in olds:
                if all(jid in jobs_by_id for jid in cg.job_ids):
                    quo.append(Group([jobs_by_id[jid]
                                      for jid in cg.job_ids],
                                     cg.chips, cg.spans_nodes))
                    placed.update(cg.job_ids)
            for g in news:
                quo.extend(Group([j], max(j.spec.gpus, 1)) for j in g.jobs
                           if j.spec.job_id not in placed)
            benefit = horizon(quo) - horizon(news)
            # cost in chip-seconds as well: every rebuilt group's chips
            # sit idle for one measured stall window
            cost = cost1 * sum(max(g.chips, 1) for g in rebuilt)
            out.extend(news if benefit > cost else quo)
        return out

    def pipeline_depth(self, g: Group) -> Optional[int]:
        """Smallest pipeline depth P >= 2 that makes *g* fit per-chip
        HBM when its flat placement does not, or None when no legal
        depth rescues it.  Legal depths are divisors of the scanned
        stack's repeat count (ssm.pipeline_legal_stages) that also
        divide the group's chips into equal stage sub-slices — the
        same legality the runtime enforces (launch/mesh.stage_mesh)."""
        from repro_torch.core.ssm import pipeline_legal_stages
        for P in pipeline_legal_stages(self.cfg):
            if P < 2 or g.chips % P:
                continue
            if tp.memory_feasible(self.cfg, g.specs, g.chips,
                                  hw=self.sched.priced_hw,
                                  remat=self.sched.remat,
                                  headroom=self.sched.mem_headroom,
                                  tp_mode="pipeline", stages=P):
                return P
        return None

    def annotate_stages(self, g: Group) -> Group:
        """Stamp the pipeline depth a final group must run with: 1 when
        its flat placement fits, else the smallest rescuing depth."""
        if tp.memory_feasible(self.cfg, g.specs, g.chips,
                              hw=self.sched.priced_hw,
                              remat=self.sched.remat,
                              headroom=self.sched.mem_headroom,
                              tp_mode=self.sched.mem_tp_mode):
            g.stages = 1
        else:
            g.stages = self.pipeline_depth(g) or 1
        return g

    def _feasible(self, g: Group) -> bool:
        if len(g.jobs) > self.sched.max_group:
            return False
        if len({j.spec.seq_len for j in g.jobs}) != 1:
            return False       # fused batch layout requires shared seq_len
        # explicit per-group memory budget: backbone shard + per-job
        # adapter/Adam state + activation high-water under the group's
        # remat flag must fit per-chip HBM.  This is the K-per-device
        # capacity gate — int8 backbones halve the dominant term, which
        # is how quantization raises packable K.
        if not tp.memory_feasible(self.cfg, g.specs, g.chips,
                                  hw=self.sched.priced_hw,
                                  remat=self.sched.remat,
                                  headroom=self.sched.mem_headroom,
                                  tp_mode=self.sched.mem_tp_mode):
            # last resort before rejecting: stage-partition the stack.
            # A pipeline group trades the bubble for 1/P backbone
            # residency per chip — the configs this rescues are exactly
            # the ones where no flat placement fits at all.
            if self.pipeline_depth(g) is None:
                return False
        deltas = tp.slowdowns(self.cfg, g.specs, g.chips,
                              hw=self.hw_for(g.chips, len(g.jobs)),
                              spans_nodes=g.spans_nodes,
                              kernel_fused=self.sched.kernel_fused,
                              ragged_kernels=self.sched.ragged_kernels)
        return all(deltas[j.spec.job_id] <= j.spec.max_slowdown
                   for j in g.jobs)

    # --------------------------------------------------------- binary cut
    def _binary_cut(self, seed: Group, tail: List[Group], spans: bool,
                    pressure: bool = False) -> int:
        """Largest prefix of *tail* whose cumulative merge keeps improving
        predicted efficiency: O(log n) probes over a unimodal gain curve.

        Under queue pressure the objective is throughput PER CHIP of the
        elastically shrunk group (freed chips admit queued jobs); otherwise
        plain joint throughput vs independent execution."""
        def eff(k: int) -> float:
            g = seed
            for cand in tail[:k]:
                g = self._merged(g, cand, spans)
            if k and not self._feasible(g):
                return -1.0
            parts = [seed] + tail[:k]
            if pressure:
                gs = self.shrink(g) if len(g.jobs) > 1 else g
                base = sum(self.throughput(c) for c in parts) \
                    / max(sum(c.chips for c in parts), 1)
                return (self.throughput(gs) / max(gs.chips, 1)) \
                    / max(base, 1e-12)
            base = sum(self.throughput(c) for c in parts)
            return self.throughput(g) / max(base, 1e-12)

        lo, hi = 0, len(tail)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if eff(mid) >= eff(mid - 1) and eff(mid) > 0:
                lo = mid
            else:
                hi = mid - 1
        # require net gain over independent execution
        return lo if lo and eff(lo) >= self.sched.min_gain - 1e-9 else 0

    # ------------------------------------------------------------ shrink
    def shrink(self, g: Group, margin: float = 0.95) -> Group:
        """Elastic contribution (§3.4): a fused group shares ONE backbone
        copy, so under queue pressure it can release chips as long as every
        member stays within (margin x) its slowdown bound.  Freed chips let
        the cluster admit more jobs — the capacity story behind the paper's
        JCT gains."""
        floor = max(tp.min_chips(self.cfg, hw=self.sched.priced_hw), 1)

        def ok(c: int) -> bool:
            # shrinking concentrates the group onto fewer chips — the
            # per-chip memory high-water must keep fitting
            if not tp.memory_feasible(self.cfg, g.specs, c,
                                      hw=self.sched.priced_hw,
                                      remat=self.sched.remat,
                                      headroom=self.sched.mem_headroom,
                                      tp_mode=self.sched.mem_tp_mode):
                return False
            deltas = tp.slowdowns(self.cfg, g.specs, c,
                                  hw=self.hw_for(c, len(g.jobs)),
                                  spans_nodes=g.spans_nodes,
                                  kernel_fused=self.sched.kernel_fused,
                                  ragged_kernels=self.sched.ragged_kernels)
            return all(deltas[j.spec.job_id] <= margin * j.spec.max_slowdown
                       for j in g.jobs)

        # slowdown is monotone in chips -> bisect the smallest feasible c
        lo, hi = floor, g.chips
        if ok(lo):
            return Group(g.jobs, lo, g.spans_nodes)
        while lo < hi:
            mid = (lo + hi) // 2
            if ok(mid):
                hi = mid
            else:
                lo = mid + 1
        return Group(g.jobs, hi, g.spans_nodes)

    # ---------------------------------------------------------- schedule
    def schedule(self, jobs: Sequence[JobRuntimeState],
                 node_of: Optional[Callable[[str], int]] = None,
                 pressure: bool = False,
                 current_groups: Optional[Sequence[Group]] = None,
                 pool_chips: Optional[int] = None
                 ) -> List[Group]:
        """One scheduling round: runnable jobs -> final groups.

        pressure: jobs are queueing — shrink group allocations to free
        chips (elastic contribution).

        current_groups: the LIVE groups this round would transition away
        from — when given, proposals are gated on transition payback
        (``filter_transitions``), so a regroup whose one-time cost
        exceeds its residual-time benefit is never emitted.

        pool_chips: residual capacity of the pool that will realize this
        assignment (the controller passes its AVAILABLE device count —
        quarantined devices excluded).  Assignments exceeding it are cut
        down by ``fit_pool`` so the scheduler never hands out chips the
        pool no longer has."""
        singles = [Group([j], max(j.spec.gpus, 1)) for j in jobs]
        node_of = node_of or (lambda job_id: 0)

        # tier 1: within-node; tier 2: across nodes (wider bandwidth cost)
        finals: List[Group] = []
        by_node: Dict[int, List[Group]] = {}
        for g in singles:
            by_node.setdefault(node_of(g.job_ids[0]), []).append(g)
        tier1 = [self._pack(gs, spans=False, pressure=pressure)
                 for gs in by_node.values()]
        lifted = [g for gs in tier1 for g in gs]
        finals = self._pack(lifted, spans=True, pressure=pressure) \
            if len(by_node) > 1 else lifted
        if pressure:
            finals = [self.shrink(g) if len(g.jobs) > 1 else g
                      for g in finals]
        if pool_chips is not None:
            finals = self.fit_pool(finals, pool_chips)
        if current_groups:
            finals = self.filter_transitions(finals, current_groups)
        return [self.annotate_stages(g) for g in finals]

    def fit_pool(self, groups: List[Group], pool_chips: int
                 ) -> List[Group]:
        """Cut an assignment down to the pool's residual capacity.

        When the total demand exceeds *pool_chips* (a failure shrank the
        pool, or demand simply outgrew it), chips are re-assigned by
        weighted max-min fair share over the demanded widths — the same
        rule the controller's device allocator applies — with a floor of
        one abstract chip per group, so every group stays schedulable
        (an over-subscribed pool time-multiplexes meshless groups rather
        than dropping them)."""
        if pool_chips <= 0 or not groups:
            return groups
        demand = [max(g.chips, 1) for g in groups]
        if sum(demand) <= pool_chips:
            # within capacity: only clamp single groups wider than the
            # whole pool (a demand no partition could ever satisfy)
            return [Group(g.jobs, min(g.chips, pool_chips), g.spans_nodes)
                    if g.chips > pool_chips else g for g in groups]
        from repro_torch.launch.mesh import device_shares
        shares = device_shares(demand, pool_chips)
        return [Group(g.jobs, max(s, 1), g.spans_nodes)
                for g, s in zip(groups, shares)]

    def _pack(self, queue: List[Group], spans: bool,
              pressure: bool = False) -> List[Group]:
        """Incremental pack-and-reinsert loop within one tier."""
        # sort: urgency desc, residual asc (Algorithm 1 line 5) — the
        # residual signal uses measured (calibrated) throughput when the
        # feedback loop is closed
        queue = sorted(queue,
                       key=lambda g: (-g.urgency(),
                                      g.residual(self.cfg,
                                                 self.hw_for(g.chips,
                                                             len(g.jobs)),
                                                 self.sched.ragged_kernels)))
        finals: List[Group] = []
        while queue:
            seed = queue.pop(0)
            # candidates sorted by residual DESC: most slack first — they
            # are the complementary partners for a constrained seed.
            tail = sorted(queue,
                          key=lambda g: -g.residual(
                              self.cfg,
                              self.hw_for(g.chips, len(g.jobs)),
                              self.sched.ragged_kernels))
            cut = self._binary_cut(seed, tail, spans, pressure=pressure)
            if cut == 0:
                finals.append(seed)
                continue
            g = seed
            for cand in tail[:cut]:
                g = self._merged(g, cand, spans)
                queue.remove(cand)
            # re-insert the merged group for further packing (line 12)
            queue.insert(0, g)
            if len(g.jobs) >= self.sched.max_group:
                queue.remove(g)
                finals.append(g)
        return finals
