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

Over a mesh, where JAX's GSPMD and ``shard_map`` insert collectives the
port calls them through the counted wrappers of
:mod:`tpuslo_torch.parallel.mesh`, every rank the same calls in the same
order:

* :func:`moe_mlp_sharded` is JAX's token-sharded expert exchange
  (``_moe_shard_body``): each rank routes its own rows against the whole
  router, with the capacity of its rows (so tokens drop where JAX's do),
  sends each expert's buffer to the rank that holds the expert
  (``all_to_all`` in the model dtype), runs its local experts, sends the
  outputs back (a second ``all_to_all``, in the model dtype too) and
  combines them in f32.  :func:`moe_params_specs` is its layout table and
  :func:`place_moe_params` cuts a rank's shard.
* :func:`moe_mlp_serve` is the MoE block of the serving engines, whose
  tokens every rank holds whole: under ``tp`` each rank runs every expert
  on its columns of the hidden axis and one f32 ``all_reduce`` sums the
  ``w2`` partials before the combine (where XLA puts the psum of JAX's
  f32-output contraction); under ``ep`` each rank runs its own experts'
  buffers, combines them in f32 in k order (another rank's expert reads
  a zero row) and one f32 ``all_reduce`` sums the partial outputs (JAX's
  one psum at the combine einsum).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from tpuslo_torch.device import resolve_device
from tpuslo_torch.models.bridge import split_part
from tpuslo_torch.models.llama import GEMM_ROWS, _matmul
from tpuslo_torch.parallel import mesh as mesh_mod

Params = dict[str, Any]


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


def _dispatch(params: Params, x: torch.Tensor, cfg: MoEConfig, capacity: int,
              experts: slice = slice(None), x_experts: torch.Tensor | None = None):
    """(router logits, :class:`Routing`, the buffers (E', C, D) of the
    ``experts`` slice in the model dtype) for tokens x: (T, D); the buffers
    read ``x_experts`` (default x: the same values, another autograd
    path)."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
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
    src = x if x_experts is None else x_experts
    xz = torch.cat([src.to(cfg.dtype), src.new_zeros((1, D), dtype=cfg.dtype)])
    return logits, r, xz[table[experts, :capacity]]


def _combine(r: Routing, out: torch.Tensor, first: int = 0) -> torch.Tensor:
    """f32 (T, D): each token's k expert outputs times its gates, summed in
    k order.  ``out`` (E', C, D) f32 holds experts ``first`` to ``first +
    E' - 1``; a dropped choice, or one of another expert, reads a zero
    row."""
    E_out, C, D = out.shape
    flat = torch.cat([out.reshape(E_out * C, D), out.new_zeros((1, D))])
    held = r.kept & (r.experts >= first) & (r.experts < first + E_out)
    index = torch.where(held, (r.experts - first) * C + r.positions, E_out * C)
    y = None
    for k in range(r.experts.shape[1]):
        term = r.gates[:, k, None] * flat[index[:, k]]
        y = term if y is None else y + term
    return y


def moe_mlp(params: Params, x: torch.Tensor, cfg: MoEConfig, return_aux: bool = False):
    """Single-device MoE MLP.  x: (T, D) -> (T, D) in x's dtype.

    ``return_aux=True`` also returns the :func:`load_balancing_loss` of
    this block's routing."""
    logits, r, xe = _dispatch(params, x, cfg, cfg.capacity(x.shape[0]))
    y = _combine(r, _expert_ffn(params, xe, cfg)).to(x.dtype)
    if return_aux:
        return y, load_balancing_loss(logits, cfg.n_experts)
    return y


def moe_mlp_serve(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh, axis: str
                  ) -> torch.Tensor:
    """The MoE block of a serving rank: x (T, D), the same on every rank of
    ``mesh``'s ``axis``, -> (T, D) in x's dtype, the whole output on every
    rank.  ``params``: the rank's shard, under ``"tp"`` every expert's
    columns of the hidden axis (``w1``/``w3`` ``(E, D, F / tp)``, ``w2``
    ``(E, F / tp, D)``), under ``"ep"`` whole experts (``(E / ep, ...)``,
    the rank's in rank order); the router whole on both.  See the module
    docstring for the collectives."""
    capacity = cfg.capacity(x.shape[0])
    if axis == "tp":
        _, r, xe = _dispatch(params, x, cfg, capacity)
        out = mesh_mod.all_reduce(_expert_ffn(params, xe, cfg), mesh, "tp")
        return _combine(r, out).to(x.dtype)
    if axis != "ep":
        raise ValueError(f"a serving MoE block shards over 'tp' or 'ep', not {axis!r}")
    n_local = params["w1"].shape[0]
    first = mesh.rank("ep") * n_local
    _, r, xe = _dispatch(params, x, cfg, capacity, slice(first, first + n_local))
    y = _combine(r, _expert_ffn(params, xe, cfg), first)
    return mesh_mod.all_reduce(y, mesh, "ep").to(x.dtype)


def moe_mlp_train(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh, axis: str = "ep",
                  data_axis: str = "dp") -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE block of a training rank over a ``(dp, ep)`` mesh: x (T, D)
    the rank's tokens, the same on every rank of its ``axis`` group,
    ``params`` its whole experts (``(E / ep, ...)``, the rank's in rank
    order) and the whole router -> (output in x's dtype, the
    :func:`load_balancing_loss` of the whole batch).

    The forward is :func:`moe_mlp_serve`'s ep arithmetic: each rank runs
    its own experts' buffers, combines them in f32 in k order (another
    rank's expert reads a zero row), and Megatron's ``g`` sums the partial
    outputs over ``axis`` (at top 2 the sum of two exact products is the
    one-device combine, bit for bit).  The backward keeps every rank's
    gradients whole over ``axis``: ``f`` sums the tokens' gradient from
    the expert buffers and the gates' gradient from the combine over the
    ranks, so the router, and everything before the block, get the one
    gradient the single device gets, on every rank.

    The loss-balancing term needs the whole batch's expert shares and
    mean probabilities: each is this rank's mean summed over
    ``data_axis`` (the probabilities' sum under autograd is ``psum``, its
    gradient summed back: the objective is the ranks' shares summed) and
    divided by its size.  The capacity is this rank's tokens'; routing
    drops nothing only where the config is drop-free, as every shipped
    config is (``capacity_factor >= n_experts / top_k``): a droppy config
    would drop per data rank where JAX drops over the whole batch, so it
    is refused over more than one data rank."""
    ep, n_dp = mesh.shape[axis], mesh.shape.get(data_axis, 1)
    if n_dp > 1 and cfg.capacity_factor < cfg.n_experts / cfg.top_k:
        raise ValueError(
            f"the dp x ep MoE step routes each data rank's tokens on their own: it needs "
            f"drop-free routing, capacity_factor >= n_experts/top_k = "
            f"{cfg.n_experts / cfg.top_k}, got {cfg.capacity_factor}")
    n_local = params["w1"].shape[0]
    first = mesh.rank(axis) * n_local
    capacity = cfg.capacity(x.shape[0])
    x_experts = mesh_mod.copy_to(x, mesh, axis) if ep > 1 else x
    logits, r, xe = _dispatch(params, x, cfg, capacity, slice(first, first + n_local),
                              x_experts)
    if ep > 1:
        r = r._replace(gates=mesh_mod.copy_to(r.gates, mesh, axis))
    y = _combine(r, _expert_ffn(params, xe, cfg), first)
    if ep > 1:
        y = mesh_mod.reduce_from(y, mesh, axis)
    probs = torch.softmax(logits.float(), dim=-1).mean(dim=0)
    share = F.one_hot(logits.argmax(dim=-1), cfg.n_experts).float().mean(dim=0)
    if n_dp > 1:
        probs = mesh_mod.all_reduce(probs, mesh, data_axis) / n_dp
        share = mesh_mod.all_reduce(share, mesh, data_axis) / n_dp
    return y.to(x.dtype), cfg.n_experts * (share * probs).sum()


def moe_params_specs(axis_name: str = "ep") -> dict[str, int | None]:
    """The layout of :func:`init_moe_params`' tree under expert sharding:
    the dim each leaf splits over the mesh axis (``None``: replicated), as
    JAX's PartitionSpecs name ``axis_name`` at those dims.  The router is
    replicated; ``w1``, ``w3`` and ``w2`` split their expert axis."""
    return {"router": None, "w1": 0, "w3": 0, "w2": 0}


def place_moe_params(params: Params, mesh, axis_name: str = "ep") -> Params:
    """This rank's shard of a whole :func:`init_moe_params` tree under
    :func:`moe_params_specs` (fresh tensors): the router copied, ``E /
    ep`` experts of ``w1``, ``w3`` and ``w2``, rank r's the r-th run of
    them (JAX's ``addressable_shards[r].data``)."""
    n, rank = mesh.shape[axis_name], mesh.rank(axis_name)
    specs = moe_params_specs(axis_name)
    return {name: split_part(leaf, specs[name], n, rank) for name, leaf in params.items()}


def _moe_shard_body(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh,
                    axis_name: str) -> torch.Tensor:
    """JAX's ``shard_map`` body on one rank: x (T_local, D) the rank's
    rows, ``params`` its expert shard (``E_local`` experts), the router
    whole."""
    ep = mesh.shape[axis_name]
    D = x.shape[1]
    n_local = params["w1"].shape[0]
    # Routing is local, against the whole router; the capacity is per
    # expert per source shard, so the buffers keep one shape.
    capacity = cfg.capacity(x.shape[0])
    _, r, xe = _dispatch(params, x, cfg, capacity)  # (E, C, D), the model dtype
    # Grouped by the rank that owns each expert; after the exchange the
    # leading axis is the source rank.
    xe = mesh_mod.all_to_all(xe.reshape(ep, n_local, capacity, D), mesh, axis_name)
    xe = xe.transpose(0, 1).reshape(n_local, ep * capacity, D)
    out = _expert_ffn(params, xe, cfg)  # (E_local, ep * C, D) f32
    out = out.to(cfg.dtype).reshape(n_local, ep, capacity, D).transpose(0, 1)
    # The return hop, in the model dtype too: each source's rows back.
    out = mesh_mod.all_to_all(out, mesh, axis_name).reshape(cfg.n_experts, capacity, D)
    return _combine(r, out.float()).to(x.dtype)


def moe_mlp_sharded(params: Params, x: torch.Tensor, cfg: MoEConfig, mesh,
                    axis_name: str = "ep") -> torch.Tensor:
    """Expert-parallel MoE MLP over the mesh axis ``axis_name``, tokens
    sharded over it as JAX's ``P(axis_name, None)``.

    Every rank passes the whole x (T, D) and ``params`` whole or as its
    :func:`place_moe_params` shard; each returns the output of its own
    rows, ``x[r * T / ep:(r + 1) * T / ep]`` on rank r, so that an
    ``all_gather`` over the axis gives JAX's whole output.
    ``cfg.n_experts`` and T must be divisible by the axis's size."""
    ep = mesh.shape[axis_name]
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={ep}"
        )
    if x.shape[0] % ep:
        raise ValueError(f"tokens={x.shape[0]} not divisible by ep={ep}")
    if ep > 1 and params["w1"].shape[0] == cfg.n_experts:
        params = place_moe_params(params, mesh, axis_name)
    rows = x.shape[0] // ep
    me = mesh.rank(axis_name)
    return _moe_shard_body(params, x[me * rows:(me + 1) * rows], cfg, mesh, axis_name)
