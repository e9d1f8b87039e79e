"""Roofline of one rank's step on an NVIDIA H100 (port of the reference's
``launch/roofline.py``, which prices a TPU v5e).

The three terms price what ``launch/step_analysis`` counted on fake
tensors at the H100 SXM5 80GB data sheet's peaks.  They are a model of
the step, not a measurement: no term here was timed on a card.

    compute    = bf16 FLOPs / 989 TFLOP/s + f32 FLOPs / 67 TFLOP/s
    memory     = eager bytes / 3.35 TB/s
    collective = Σ over the step's groups of operand bytes / link rate

The f32 FLOPs are priced at the card's float32 rate outside the tensor
cores (torch leaves TF32 off for matmuls by default), where the
reference prices every FLOP at its bf16 peak and reports the f32 share
beside it.  The eager bytes are every op's inputs and outputs: an upper
bound on the HBM traffic of an eager step.  A collective group whose
ranks all lie in one node of ``NODE_GPUS`` consecutive ranks (a DGX or
HGX H100) rides NVLink 4 at 450 GB/s a direction; a group that spans
nodes is priced at one 400 Gb/s InfiniBand NDR port a GPU, 50 GB/s.  On
the production meshes (16 x 16 and 2 x 16 x 16, 8 ranks a node) every
"model" group spans two nodes and every "data" group sixteen, so all of
their collectives take the network rate.

``fits`` holds the analysis's peak bytes a rank against the 80 GB of the
card ``nvidia-smi`` names ``CARD``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# ----------------------------------------------------------- constants
# NVIDIA H100 SXM5 80GB data sheet peaks (dense, no sparsity), at the
# card's full 700 W power limit
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
F32_FLOPS = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # NVLink 4 bytes/s a direction, inside a node
NETWORK_BW = 50e9            # 400 Gb/s InfiniBand NDR a GPU, across nodes
NODE_GPUS = 8                # GPUs a node (DGX / HGX H100)
CARD = "NVIDIA H100 80GB HBM3"   # nvidia-smi's name of the card priced


def collective_time(coll_bytes: Dict[str, float]) -> float:
    """Seconds to move *coll_bytes* ({link: bytes}) at the links' rates."""
    return (coll_bytes.get("nvlink", 0.0) / NVLINK_BW
            + coll_bytes.get("network", 0.0) / NETWORK_BW)


def link_of(ranks: Tuple[int, ...]) -> str:
    """"nvlink" for a group inside one node, else "network"."""
    return ("nvlink" if len({r // NODE_GPUS for r in ranks}) <= 1
            else "network")


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                  # per rank
    flops_f32: float              # subset on f32 operands
    eager_bytes: float            # per rank
    coll_bytes: Dict[str, float]  # per rank, by link ("nvlink", "network")
    model_flops: float            # 6·N_active·D (train) or 2·N_active·D
    peak_bytes: float             # per rank
    resident_bytes: float = 0.0   # per rank: params, adapters, state
    collectives: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return ((self.flops - self.flops_f32) / PEAK_FLOPS
                + self.flops_f32 / F32_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.eager_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return collective_time(self.coll_bytes)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips · per-rank FLOPs)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """The dominant term's share of the three terms' sum."""
        terms = [self.t_compute, self.t_memory, self.t_collective]
        tot = sum(terms)
        return max(terms) / tot if tot else 0.0

    @property
    def fits(self) -> bool:
        return self.peak_bytes <= HBM_BYTES

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "mem_gb_per_device": self.peak_bytes / 1e9,
            "resident_gb_per_device": self.resident_bytes / 1e9,
            "fits": self.fits, "card": CARD,
            "priced_at": "H100 SXM5 data sheet peaks (a model, not a "
                         "measurement)",
        }


def model_flops_estimate(cfg, shape, training: bool) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D for inference."""
    from repro_torch.core.throughput import param_counts
    _, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch * 1            # one decode step
    return 2.0 * active * tokens
