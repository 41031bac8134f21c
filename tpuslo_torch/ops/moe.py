"""Mixture-of-experts MLP (PyTorch port of ``tpuslo/ops/moe.py``).

The Mixtral family's MoE block on one device: top-k routing over f32
router logits, per-expert capacity buffers, a stacked SwiGLU over the
experts, and the combine back to the tokens.  The routing is the JAX
module's exactly:

* the top-k gates are a softmax renormalised over the k chosen logits;
* a token's place in its expert's buffer is given greedily in GShard
  priority, all first choices ahead of all second choices, tokens in
  order; a place at or past the capacity is dropped, and a dropped
  choice adds nothing to its token's output (the residual carries it).

What differs, and why:

* JAX dispatches and combines with one-hot ``(T, E, C)`` einsums; here
  each expert's buffer is gathered by index (the buffer's empty places
  read a zero row) and each token's k expert outputs are read back by
  index.  The function is the same.
* The expert products keep f32 outputs, as ``dot_general(...,
  preferred_element_type=f32)`` does, and a token's k terms are summed in
  f32 in a fixed k order.
* On the card every product runs at one shape whatever the batch: the
  f32 router product as :data:`~tpuslo_torch.models.llama.GEMM_ROWS`-row
  pieces (the Llama family's ``_matmul``), each expert product as a
  batched product over ``(E, GEMM_ROWS, ...)`` pieces, each piece a fresh
  tensor.  A token's output bits then do not depend on the other tokens
  of its batch, as long as nothing is dropped.

Training differentiates the block as JAX's ``top_k`` gather does: the
gates carry the gradient back to the router through the sorted logits,
the gathers scatter it back to the tokens, and the card's f32-output
expert products (``torch.bmm(..., out_dtype=torch.float32)``, which
PyTorch does not differentiate) take their gradient from
:func:`f32_product_backward`.

Expert parallelism (``moe_mlp_sharded``, ``moe_params_specs``,
``place_moe_params``) belongs to the multi-device slice and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from tpuslo_torch.device import resolve_device
from tpuslo_torch.models.llama import GEMM_ROWS, _matmul

Params = dict[str, Any]

_NOT_PORTED = (
    "expert-parallel MoE (mesh=, the ep axis) belongs to the multi-device "
    "slice (ROADMAP item 13b) and is not ported yet; the port serves on one device"
)


@dataclass(frozen=True)
class MoEConfig:
    dim: int = 64
    ffn_dim: int = 128
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    dtype: torch.dtype = torch.bfloat16

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity for a local batch of ``n_tokens``."""
        cap = int(self.capacity_factor * self.top_k * n_tokens / self.n_experts)
        return max(cap, 1)


def init_moe_params(
    rng: torch.Generator | int, cfg: MoEConfig, device: str | torch.device = "cuda"
) -> Params:
    """Router (f32) + expert-stacked SwiGLU weights (leading expert axis),
    normal draws scaled by ``fan_in ** -0.5`` from a seeded generator on
    ``device`` (``rng``: a ``torch.Generator`` there or an integer seed)."""
    dev = resolve_device(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(rng))
    E, D, F_ = cfg.n_experts, cfg.dim, cfg.ffn_dim

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w * fan_in**-0.5

    # The router stays f32: routing is precision-sensitive (a bf16 tie
    # flips an expert between backends).
    return {
        "router": normal((D, E), D),
        "w1": normal((E, D, F_), D).to(cfg.dtype),
        "w3": normal((E, D, F_), D).to(cfg.dtype),
        "w2": normal((E, F_, D), F_).to(cfg.dtype),
    }


def router_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 router logits (T, E) for tokens x: (T, D)."""
    return _matmul(x.float(), params["router"])


def load_balancing_loss(logits: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary loss ``E * sum_e f_e * P_e``: ``f_e``
    the share of tokens whose top-1 choice is expert e, ``P_e`` the mean
    router probability of e.  1.0 at uniform routing."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = logits.argmax(dim=-1)
    f = F.one_hot(top1, n_experts).float().mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * (f * p).sum()


class Routing(NamedTuple):
    """Each token's k choices, all ``(T, K)``: ``experts`` (int64),
    ``gates`` (f32, renormalised over the k), ``positions`` in the
    expert's buffer (int64) and ``kept`` (position < capacity)."""

    experts: torch.Tensor
    gates: torch.Tensor
    positions: torch.Tensor
    kept: torch.Tensor


def _routing(logits: torch.Tensor, cfg: MoEConfig, capacity: int) -> Routing:
    """Top-k choices, gates and GShard-priority buffer positions from the
    router logits (T, E).  Equal logits pick the lower expert first (a
    stable sort), as ``lax.top_k`` does."""
    T = logits.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    values, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_vals, experts = values[:, :K], order[:, :K]
    gates = torch.softmax(gate_vals, dim=-1)
    # (K*T, E) one-hot, k-major: every first choice ahead of every second.
    flat = F.one_hot(experts.T.reshape(K * T), E)
    before = flat.cumsum(dim=0) - flat
    positions = (before * flat).sum(dim=-1).reshape(K, T).T
    return Routing(experts, gates, positions, positions < capacity)


def _f32_product(piece: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``piece @ w`` accumulated and returned in f32 (batched over the
    leading expert axis)."""
    if piece.device.type == "cuda" and piece.dtype != torch.float32:
        if torch.is_grad_enabled() and (piece.requires_grad or w.requires_grad):
            return _F32Product.apply(piece, w)
        return torch.bmm(piece, w, out_dtype=torch.float32)
    return torch.matmul(piece.float(), w.float())


def f32_product_backward(
    piece: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d piece, d w) of ``piece @ w`` taken in f32 for the f32 cotangent
    ``g``: f32 products cast to each input's dtype, the gradient autograd
    gives the CPU's ``piece.float() @ w.float()``."""
    d_piece = torch.matmul(g, w.float().transpose(-1, -2)).to(piece.dtype)
    d_w = torch.matmul(piece.float().transpose(-1, -2), g).to(w.dtype)
    return d_piece, d_w


class _F32Product(torch.autograd.Function):
    """``torch.bmm(..., out_dtype=torch.float32)`` has no derivative in
    PyTorch: this gives it :func:`f32_product_backward`."""

    @staticmethod
    def forward(ctx, piece, w):
        ctx.save_for_backward(piece, w)
        return torch.bmm(piece, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        piece, w = ctx.saved_tensors
        return f32_product_backward(piece, w, g)


def _expert_ffn(params: Params, xe: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Stacked SwiGLU over the leading expert axis: xe (E, C, D) in the
    model dtype -> f32 (E, C, D)."""

    def ffn(x):
        gate = F.silu(_f32_product(x, params["w1"]))
        up = _f32_product(x, params["w3"])
        return _f32_product((gate * up).to(cfg.dtype), params["w2"])

    if xe.device.type != "cuda":
        return ffn(xe)
    E, C, D = xe.shape
    pieces = []
    for c0 in range(0, C, GEMM_ROWS):
        piece = xe[:, c0:c0 + GEMM_ROWS]
        n = piece.shape[1]
        if n < GEMM_ROWS:
            piece = F.pad(piece, (0, 0, 0, GEMM_ROWS - n))
        pieces.append(ffn(piece.contiguous())[:, :n])
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def moe_mlp(params: Params, x: torch.Tensor, cfg: MoEConfig, return_aux: bool = False):
    """Single-device MoE MLP.  x: (T, D) -> (T, D) in x's dtype.

    ``return_aux=True`` also returns the :func:`load_balancing_loss` of
    this block's routing."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    capacity = cfg.capacity(T)
    logits = router_logits(params, x)
    r = _routing(logits, cfg, capacity)
    dev = x.device
    tokens = torch.arange(T, device=dev).expand(K, T).T  # (T, K)
    # Each expert's buffer lists its tokens by position; a dropped choice
    # writes the spare column C, and every empty place reads token T, a
    # zero row.
    table = torch.full((E, capacity + 1), T, dtype=torch.long, device=dev)
    slot = torch.where(r.kept, r.positions, capacity)
    table.index_put_((r.experts.reshape(-1), slot.reshape(-1)), tokens.reshape(-1))
    xz = torch.cat([x.to(cfg.dtype), x.new_zeros((1, D), dtype=cfg.dtype)])
    out = _expert_ffn(params, xz[table[:, :capacity]], cfg)  # (E, C, D) f32
    flat = torch.cat([out.reshape(E * capacity, D), out.new_zeros((1, D))])
    index = torch.where(r.kept, r.experts * capacity + r.positions, E * capacity)
    y = None
    for k in range(K):  # the combine: f32, in k order
        term = r.gates[:, k, None] * flat[index[:, k]]
        y = term if y is None else y + term
    y = y.to(x.dtype)
    if return_aux:
        return y, load_balancing_loss(logits, E)
    return y


def moe_params_specs(axis_name: str = "ep"):
    raise NotImplementedError(_NOT_PORTED)


def moe_mlp_sharded(params, x, cfg, mesh, axis_name: str = "ep"):
    raise NotImplementedError(_NOT_PORTED)


def place_moe_params(params, mesh, axis_name: str = "ep"):
    raise NotImplementedError(_NOT_PORTED)
