"""Common building blocks (port of ``repro.models.layers``).  Params are
plain nested dicts of tensors; backbone weights live in ``cfg.dtype``,
norms accumulate in f32.

Two activations follow JAX's definitions, not PyTorch's defaults:
``gelu`` is the tanh form (``jax.nn.gelu``'s default; ``F.gelu``'s
default is the erf form), and ``softplus`` is the exact log(1 + e^x)
(``jax.nn.softplus``), where ``F.softplus`` returns x itself above 20.
In float32 the two softplus forms agree above 20 (log1p(e^-20) < 2.1e-9
is under half an ulp of 20, and so is the gradient's 1 - sigmoid); below
it they differ by rounding only.

Tensor parallelism (``tp_mode="auto"``): ``ModelAxis`` is this rank's
place on the mesh's "model" axis, and its collectives are the
Megatron-LM region operators, each an autograd Function over the model
group.  ``column`` and ``row`` are the base projections: a column block
of the weight on the replicated input (its input cotangent summed over
the axis) and a row block on this rank's input columns (the partial
products summed over the axis).  Both sums run on f32 partials
(``mm_f32``: the storage-dtype products accumulated in f32 and not
rounded before the sum), so a split product rounds once, as the whole
one does, and a rank's activations are the meshless ones up to the f32
order of one sum.  ``enter`` (identity; the cotangents summed) and
``sum`` (the f32 sum of partials; the cotangent passes through) serve
the MoE's expert-parallel dispatch, ``gather`` (the ranks' column blocks
side by side; the cotangent's own block back) and ``columns`` (this
rank's column block; the cotangent's blocks gathered) the LoRA deltas.
Where the axis is wider than the kv heads (m a multiple of KV: every
production mesh's 16 ranks over 4 or 8 kv heads), m / KV ranks hold the
same kv head whole (``kv_head``, ``kv_replicas``): ``kv_columns`` cuts
the k/v LoRA deltas to it, and its backward sums the replicas'
cotangents, each covering only its own query heads.  ``whole`` gathers
a vocab-split head's logits for serving.  Every rank computes the
replicated parts of the model identically, so a loss is counted once,
not once a rank.  ``swiglu(..., tp=)`` is the
column/row-parallel MLP and ``vocab_cross_entropy`` the cross entropy
over a vocab-split head."""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.quant import QuantTensor, get_dequant_impl, qdot

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------- init
def dense_init(d_in: int, d_out: int, dtype, *, generator: torch.Generator,
               device="cuda", layers: int = 1) -> torch.Tensor:
    """(layers, d_in, d_out) weights ~ N(0, 1/d_in), drawn in f32."""
    w = torch.randn((layers, d_in, d_out), generator=generator, device=device)
    return (w * (1.0 / d_in) ** 0.5).to(dtype)


def embed_init(vocab: int, d: int, dtype, *, generator: torch.Generator,
               device="cuda") -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``gamma`` is stored as (gamma - 1), so zeros == identity scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs     # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- dense
def dense(x: torch.Tensor, w: Any,
          row_block: Optional[int] = None) -> torch.Tensor:
    """``qdot(x, w)``.  With *row_block* (the serving decode path on the
    card), a plain tensor's product runs on that many rows of x at a
    time: cuBLAS picks its algorithm, and with it a row's summation
    order, by the row count, so blocks of a solo batch's row count give
    a fused batch's rows the solo bits.  The int8 kernel's order does not
    depend on the row count: a QuantTensor's product runs whole."""
    x2 = x.reshape(-1, x.shape[-1])
    if (row_block is None or isinstance(w, QuantTensor)
            or x2.shape[0] <= row_block):
        return qdot(x, w)
    y = torch.empty((x2.shape[0], w.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for i in range(0, x2.shape[0], row_block):
        torch.mm(x2[i:i + row_block], w, out=y[i:i + row_block])
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------- mlp
def swiglu_init(d: int, d_ff: int, dtype, *, generator: torch.Generator,
                device="cuda", layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    return {"gate": dense_init(d, d_ff, dtype, **kw),
            "up": dense_init(d, d_ff, dtype, **kw),
            "down": dense_init(d_ff, d, dtype, **kw)}


def swiglu(params: dict, x: torch.Tensor,
           row_block: Optional[int] = None,
           tp: Optional["ModelAxis"] = None,
           partial: bool = False) -> torch.Tensor:
    """gate/up -> SiLU(gate) * up -> down.  With *tp* (given by a caller
    whose hidden width the model axis divides) the rank holds the column
    blocks of gate and up and the row block of down (the runtime specs):
    its partial product is summed over the axis (``ModelAxis.sum``), or,
    with *partial*, returned as it is in f32 for the caller to sum with
    others (the MoE's shared experts beside its expert combine)."""
    if tp is not None:
        g = tp.column(x, params["gate"], row_block)
        u = tp.column(x, params["up"], row_block)
        h = F.silu(g.float()).to(x.dtype) * u
        return _RowPartial.apply(h, params["down"], row_block) if partial \
            else tp.row(h, params["down"], row_block)
    # qdot: fused int8 dequant when the FFN mats are QuantTensors
    g = dense(x, params["gate"], row_block)
    u = dense(x, params["up"], row_block)
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(h, params["down"], row_block)


def gelu_mlp_init(d: int, d_ff: int, dtype, *, generator: torch.Generator,
                  device="cuda", layers: int = 1) -> dict:
    kw = dict(generator=generator, device=device, layers=layers)
    return {"up": dense_init(d, d_ff, dtype, **kw),
            "down": dense_init(d_ff, d, dtype, **kw)}


def gelu_mlp(params: dict, x: torch.Tensor,
             row_block: Optional[int] = None) -> torch.Tensor:
    """up -> tanh GELU in f32 -> down (no config of the registry uses it;
    the reference's module has it)."""
    h = dense(x, params["up"], row_block)
    h = gelu(h.float()).to(x.dtype)
    return dense(h, params["down"], row_block)


# ---------------------------------------------------------- activations
def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Exact log(1 + e^x) (``jax.nn.softplus``)."""
    return torch.logaddexp(x, x.new_zeros(()))


# ------------------------------------------------------------- grad cast
class _GradCast(torch.autograd.Function):
    """Identity whose cotangent is cast to the input's dtype (the
    reference's ``grad_cast`` custom VJP: an f32 cotangent chain must not
    force f32 backward products or storage)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    return _GradCast.apply(x)


# ---------------------------------------------------------------- losses
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Token-level CE in f32. logits (..., V); labels (...,) int.

    Returns the per-token loss (...,), zero where ``mask`` is 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - picked
    if mask is not None:
        loss = loss * mask.float()
    return loss


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        tp: "ModelAxis", mask=None) -> torch.Tensor:
    """``cross_entropy`` of logits whose vocab dim is split over the
    model axis (this rank's contiguous block of ``tp.size``): the
    per-token loss (...,), the same on every rank."""
    lead = logits.shape[:-1]
    loss = _VocabCE.apply(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1), tp).reshape(lead)
    if mask is not None:
        loss = loss * mask.float()
    return loss


# ------------------------------------------------ tensor parallelism
@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the "model" axis of a tensor-parallel mesh:
    the axis's process group, its size m and this rank's index.  A leaf
    the runtime specs split over the axis holds this rank's contiguous
    block of one dim; ``splits`` is the specs' divisibility rule."""
    group: object
    size: int
    index: int

    def splits(self, n: int) -> bool:
        return n > 0 and n % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of a dim of *n* (whole) entries."""
        w = n // self.size
        return slice(self.index * w, (self.index + 1) * w)

    # ---- kv heads: split (KV % m == 0) or shared (m % KV == 0)
    def kv_local(self, kv_heads: int) -> int:
        """The kv heads this rank holds: KV/m where the axis divides
        them, else the one head its m / KV replicas share."""
        return kv_heads // self.size if self.splits(kv_heads) else 1

    def kv_replicas(self, kv_heads: int) -> int:
        """How many ranks hold each of this rank's kv heads (1 where the
        axis divides KV)."""
        if self.splits(kv_heads):
            return 1
        if self.size % kv_heads:
            raise ValueError(f"a model axis of {self.size} neither divides "
                             f"nor is divided by {kv_heads} kv heads")
        return self.size // kv_heads

    def kv_head(self, kv_heads: int) -> int:
        """The first kv head this rank holds: rank i's block of KV/m heads,
        or under replication head i // (m / KV)."""
        r = self.kv_replicas(kv_heads)
        return (self.index // r if r > 1
                else self.index * (kv_heads // self.size))

    def kv_block(self, n: int, kv_heads: int) -> slice:
        """This rank's columns of a dim of *n* entries laid out as
        *kv_heads* heads: its kv heads' columns, whole heads."""
        hd = n // kv_heads
        lo = self.kv_head(kv_heads) * hd
        return slice(lo, lo + self.kv_local(kv_heads) * hd)

    def column(self, x: torch.Tensor, w: torch.Tensor,
               row_block: Optional[int] = None) -> torch.Tensor:
        """x·w for this rank's column block *w* of a weight, x replicated:
        its columns of the whole product; x's cotangent is the f32 sum
        over the axis of the ranks' ``mm_f32`` partials.  *row_block*:
        rows per product (``dense``; the serving decode)."""
        return _Column.apply(x, w, self.group, row_block)

    def row(self, h: torch.Tensor, w: torch.Tensor,
            row_block: Optional[int] = None) -> torch.Tensor:
        """h·w for this rank's input columns *h* and row block *w*: the
        f32 sum over the axis of the ranks' ``mm_f32`` partials, in h's
        dtype; the cotangent passes through to every rank's partial.
        *row_block*: rows per product and per sum (``sum``)."""
        return self.sum(_RowPartial.apply(h, w, row_block), h.dtype,
                        row_block)

    def enter(self, *xs: torch.Tensor):
        out = _Enter.apply(self.group, *xs)
        return out[0] if len(xs) == 1 else out

    def sum(self, x: torch.Tensor, dtype=None,
            row_block: Optional[int] = None) -> torch.Tensor:
        """The f32 sum over the axis of the ranks' *x*, in *dtype*.  An
        all-reduce adds an element's m addends in an order that follows
        the element's place in the buffer (gloo's and NCCL's ring cut the
        buffer into chunks), so above m = 2 a row's sum depends on the
        rows around it; *row_block*: there, one all-reduce of that many
        rows at a time, so a fused batch's rows and a solo batch's sum
        alike (the serving path, ROADMAP C1).  Two addends sum the same
        in either order: at m = 2 one all-reduce."""
        return _Sum.apply(x, self.group, dtype or x.dtype,
                          row_block if self.size > 2 else None)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherCols.apply(x, self.group, self.size, self.index)

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        return _Columns.apply(x, self.group, self.size, self.index)

    def cut(self, x: torch.Tensor, cols: tuple) -> torch.Tensor:
        """The columns *cols* (slices, taken side by side: this rank's
        entries of a layout the even blocks do not describe, such as
        SSD's segment-wise in-projection) of a tensor every rank holds
        whole.  The whole cotangent is every rank's in its place, zeros
        elsewhere, summed over the axis: columns two ranks both hold (a
        shared group, a replicated segment) add up."""
        return _KVColumns.apply(x, self.group, cols)

    def kv_columns(self, x: torch.Tensor, kv_heads: int) -> torch.Tensor:
        """This rank's kv heads' columns (``kv_block``) of a tensor every
        rank holds whole, laid out as *kv_heads* heads.  Where the axis
        divides the heads it is ``columns``.  Under replication each of a
        head's m / KV replicas gets a cotangent covering only its own
        query heads: the backward writes it into the whole width, zeros
        elsewhere, and one all-reduce sums the replicas and places the
        heads."""
        if self.splits(kv_heads):
            return self.columns(x)
        return self.cut(x, (self.kv_block(x.shape[-1], kv_heads),))

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' column blocks side by side, no gradient (a
        vocab-split head's logits on the serving path)."""
        return _all_gather_last(x, self.group, self.size)


# The flash kernel's stand-in while a step runs on meta tensors as the
# card would run it (``meta_as_card``); a context variable, so no other
# thread sees it.
_META_FLASH: ContextVar = ContextVar("meta_flash", default=None)


@contextlib.contextmanager
def meta_as_card(flash: Callable):
    """Within, in this thread: a meta tensor takes the card's branches
    (``on_card``) and *flash* stands in for the flash kernel's wrapper
    (``meta_flash``).  The dry run's analysis (``launch/step_analysis``)
    counts the card's path so; any other tensor is as it was."""
    token = _META_FLASH.set(flash)
    try:
        yield
    finally:
        _META_FLASH.reset(token)


def meta_flash() -> Optional[Callable]:
    """The flash kernel's stand-in under ``meta_as_card``, else None."""
    return _META_FLASH.get()


def on_card(t: torch.Tensor) -> bool:
    """Whether products on *t* take the card's path: a CUDA tensor, or a
    meta tensor under ``meta_as_card``."""
    return t.is_cuda or (t.is_meta and _META_FLASH.get() is not None)


def mm_f32(x: torch.Tensor, w: torch.Tensor,
           row_block: Optional[int] = None) -> torch.Tensor:
    """(..., K) x (K, N) -> (..., N) f32: the products of the operands'
    values accumulated in f32, the output not rounded to their dtype
    (a bf16 GEMM with an f32 result on the card; f32 copies elsewhere,
    which hold bf16 values exactly); *row_block* rows of x a product
    (``dense``).  A ``QuantTensor`` *w* takes the int8 dequant-matmul
    with its f32 output (``kernels/ops.dequant_matmul_f32``), whole: its
    rows do not depend on the row count."""
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantTensor):
        from repro_torch.kernels import ops
        y = ops.dequant_matmul_f32(x2, w.q, w.scale, get_dequant_impl())
        return y.reshape(*x.shape[:-1], w.shape[-1])
    if on_card(x) and x.dtype == w.dtype and x.dtype != torch.float32:
        mm = lambda a: torch.mm(a, w, out_dtype=torch.float32)
    else:
        wf = w.float()
        mm = lambda a: a.float() @ wf
    if row_block is None or x2.shape[0] <= row_block:
        y = mm(x2)
    else:
        y = torch.cat([mm(x2[i:i + row_block])
                       for i in range(0, x2.shape[0], row_block)])
    return y.reshape(*x.shape[:-1], w.shape[-1])


def mm_t_f32(g: torch.Tensor, w: Any) -> torch.Tensor:
    """g·wᵀ in f32, not rounded: the input cotangent of x·w for the
    output cotangent *g*.  A ``QuantTensor`` *w* takes the int8 kernel's
    dx (``kernels/ops.dequant_dx_f32``, the meshless backward's
    expression with its f32 output)."""
    if isinstance(w, QuantTensor):
        from repro_torch.kernels import ops
        g2 = g.reshape(-1, g.shape[-1])
        y = ops.dequant_dx_f32(g2, w.q, w.scale, get_dequant_impl())
        return y.reshape(*g.shape[:-1], w.shape[-2])
    return mm_f32(g, w.T)


def _save_weight(ctx, w: Any) -> None:
    """Save a frozen weight for the backward, an int8 ``QuantTensor`` as
    its codes and scales (saved tensors: under remat the recomputation
    then runs through the product, as the meshless product's)."""
    ctx.quant = isinstance(w, QuantTensor)
    ctx.save_for_backward(*((w.q, w.scale) if ctx.quant else (w,)))


def _saved_weight(ctx) -> Any:
    t = ctx.saved_tensors
    return QuantTensor(*t) if ctx.quant else t[0]


class _RowPartial(torch.autograd.Function):
    """A rank's f32 partial of a row-parallel product, h·w by
    ``mm_f32``; the backward returns h's cotangent g·wᵀ in h's dtype (the
    whole product's cotangent columns for this rank's rows)."""

    @staticmethod
    def forward(ctx, h, w, row_block=None):
        _save_weight(ctx, w)
        ctx.dtype = h.dtype
        return mm_f32(h, w, row_block)

    @staticmethod
    def backward(ctx, g):
        w = _saved_weight(ctx)
        if isinstance(w, QuantTensor):
            return mm_t_f32(g.to(ctx.dtype), w).to(ctx.dtype), None, None
        return dense(g.to(ctx.dtype), w.T), None, None


class _Column(torch.autograd.Function):
    """x·w on a column block w of a weight, x the same on every rank;
    the backward sums the ranks' f32 partials g·wᵀ over the axis and
    rounds once to x's dtype.  Under kv replication the ranks sharing a
    kv head each add their partial for it: the sum is the whole dx."""

    @staticmethod
    def forward(ctx, x, w, group, row_block=None):
        _save_weight(ctx, w)
        ctx.group, ctx.dtype = group, x.dtype
        return dense(x, w, row_block)

    @staticmethod
    def backward(ctx, g):
        dx = mm_t_f32(g, _saved_weight(ctx)).contiguous()
        dist.all_reduce(dx, group=ctx.group)
        return dx.to(ctx.dtype), None, None, None


def _all_gather_last(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """The ranks' (..., w) blocks as (..., m·w), in rank order."""
    x = x.contiguous()
    buf = x.new_empty((m * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(buf, x, group=group)
    return buf.reshape((m,) + tuple(x.shape)).movedim(0, -2).reshape(
        *x.shape[:-1], m * x.shape[-1])


class _Enter(torch.autograd.Function):
    """Identity forward; backward sums each cotangent over the model
    axis, in f32, all in one all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None,) + tuple(out)


class _Sum(torch.autograd.Function):
    """The f32 sum of the ranks' partials, cast to *dtype*; the
    cotangent passes through to every rank's partial."""

    @staticmethod
    def forward(ctx, x, group, dtype, row_block=None):
        ctx.dtype = x.dtype
        s = x.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        if row_block is None or s.numel() <= row_block * s.shape[-1]:
            dist.all_reduce(s, group=group)
        else:
            rows = s.view(-1, s.shape[-1])
            for i in range(0, rows.shape[0], row_block):
                dist.all_reduce(rows[i:i + row_block], group=group)
        return s.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None


class _GatherCols(torch.autograd.Function):
    """The ranks' column blocks side by side; the cotangent, the same on
    every rank (what reads the gathered tensor is replicated), gives
    each rank its own block back."""

    @staticmethod
    def forward(ctx, x, group, m, index):
        ctx.w, ctx.index = x.shape[-1], index
        return _all_gather_last(x, group, m)

    @staticmethod
    def backward(ctx, g):
        w, i = ctx.w, ctx.index
        return g[..., i * w:(i + 1) * w].contiguous(), None, None, None


class _Columns(torch.autograd.Function):
    """This rank's column block of a tensor every rank holds whole; the
    whole cotangent is the ranks' block cotangents gathered."""

    @staticmethod
    def forward(ctx, x, group, m, index):
        ctx.group, ctx.m = group, m
        w = x.shape[-1] // m
        return x[..., index * w:(index + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group, ctx.m), None, None, None


class _KVColumns(torch.autograd.Function):
    """The columns *sl* (slices side by side: this rank's kv heads, or
    ``ModelAxis.cut``'s) of a tensor every rank holds whole; the whole
    cotangent is every rank's block cotangent in its place, zeros
    elsewhere, summed over the axis: the replicas of a head add up, and
    the heads land side by side."""

    @staticmethod
    def forward(ctx, x, group, sl):
        ctx.group, ctx.sl, ctx.n = group, sl, x.shape[-1]
        return torch.cat([x[..., s] for s in sl], dim=-1)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(*g.shape[:-1], ctx.n, dtype=torch.float32)
        at = 0
        for s in ctx.sl:
            w = s.stop - s.start
            full[..., s] += g[..., at:at + w]
            at += w
        dist.all_reduce(full, group=ctx.group)
        return full.to(g.dtype), None, None


class _VocabCE(torch.autograd.Function):
    """Per-token cross entropy of (N, V/m) logit blocks: each rank's
    block log-sum-exp and picked logit (the label's, 0 off the block)
    gathered in one all-gather, the row's log-sum-exp taken over the
    ranks' and the picked logit summed; the backward is local, softmax
    minus one-hot of the block, scaled by the cotangent."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        lf = logits.float()
        V = lf.shape[-1]
        lo = tp.index * V
        lab = labels.long() - lo
        inside = (lab >= 0) & (lab < V)
        lab = torch.where(inside, lab, 0)
        lse_b = torch.logsumexp(lf, dim=-1)
        picked = torch.where(inside, lf.gather(-1, lab[:, None])[:, 0], 0.0)
        parts = torch.stack([lse_b, picked])                    # (2, N)
        buf = parts.new_empty((tp.size * 2, parts.shape[1]))
        dist.all_gather_into_tensor(buf, parts.contiguous(), group=tp.group)
        buf = buf.reshape(tp.size, 2, -1)
        lse = torch.logsumexp(buf[:, 0], dim=0)
        ctx.save_for_backward(lf, lse, lab, inside)
        ctx.dtype = logits.dtype
        return lse - buf[:, 1].sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        lf, lse, lab, inside = ctx.saved_tensors
        d = torch.exp(lf - lse[:, None])
        d[torch.arange(d.shape[0], device=d.device), lab] -= inside.float()
        return (d * g.float()[:, None]).to(ctx.dtype), None, None
