"""Block-sparse paged decode attention (PyTorch port of
``tpuslo/ops/paged_attention.py``).

One decode query per lane attends to that lane's own blocks of the
physical KV pool, found through its page table.
:func:`paged_decode_attention` takes the JAX module's layout (q
``(B, H, HD)``; pools ``(N, BS, KV, HD)`` or int8 ``{"q", "s"}``; page
table ``(B, MB)`` int32 with 0 the null block; lengths ``(B,)``; the
step's token at position ``lengths[b]`` already written and visible) and
routes by the device of its inputs alone:

* a CPU tensor runs :func:`paged_decode_attention_reference`, the plain
  PyTorch version of the kernel's arithmetic (the CPU tests hold it to
  the Pallas kernel in interpret mode);
* a CUDA tensor launches one of two hand-written Hopper kernels (built
  with nvcc at first use, see :mod:`tpuslo_torch.ops._build`), chosen by
  :func:`kernel_route` from the dtypes and the head dim alone: K2
  (``csrc/paged_attention.cu``, scores on ``mma.sync``) for a bf16 q over
  bf16 or int8 pools at head dims 64 and 128 with a bf16 or f32 output,
  K2-f32 (``csrc/attention_f32.cu``, f32 FFMA products) for every other
  input the Pallas kernel takes in the repo's configs: an f32, bf16 or
  f16 q over f32, bf16, f16 or int8 pools at head dims
  :data:`F32_HEAD_DIMS` (head dim 24 over f32 and bf16 pools only), an
  f32, bf16 or f16 output (mixed types are read
  as f32, exactly, as the Pallas kernel casts).  Anything else raises,
  naming it: another dtype or head dim, a group size outside
  :data:`GROUP_SIZES`, a page table or lengths that are not int32, a
  layout the kernel does not read, a failed build or a refused launch.
  There is no fallback from the card to the plain version.

Both kernels split each lane's walk over its blocks into spans of at
most :data:`SPAN` positions (flash-decoding): :func:`split_plan` sizes
the spans, the grid and the f32 scratch of partial results from shapes
alone, and :func:`paged_decode_attention_split` is the plain PyTorch
model of that split-then-combine arithmetic (the CPU tests hold it to
the reference and to the Pallas kernel).

``paged_decode_attention.launches`` counts wrapper calls that launched
K2 (one per call, though a call launches a split and a combine kernel)
and ``paged_decode_attention.f32_launches`` those that launched K2-f32
(likewise a split and a combine kernel), so that a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tpuslo_torch.ops import _build, launch_counts

HEAD_DIMS = (64, 128)  # the head dims K2 is built for
F32_HEAD_DIMS = (16, 24, 32, 64, 128, 256)  # the head dims K2-f32 is built for
#: Head dims K2-f32 is built at for some pool types only: at head dim 24
#: (the serving bench's measured target) f32 and bf16 caches; an int8 row
#: is no whole 16-byte pieces there, and the f16 build spills registers.
F32_POOLS_AT_HEAD_DIM = {24: (torch.float32, torch.bfloat16)}
GROUP_SIZES = (1, 2, 3, 4, 8)  # query heads per kv head both are built for
MAX_BLOCK_SIZE = 1024  # the largest pool block the kernels are built for
SPAN = 64  # logical positions one CTA of the kernels holds at most
MAX_SPLITS = 65535  # spans per lane: the kernels' grid z limit
ROUTE_SPLIT = "split"  # K2: bf16 q over bf16 or int8 pools, HD 64/128
ROUTE_F32 = "f32"  # K2-f32: every other input it is built for
#: q and output dtypes K2-f32 reads and writes (code passed to the kernel).
F32_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Pool element types K2-f32 reads (int8: codes with f32 scales).
F32_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}


def kernel_route(q_dtype: torch.dtype, pool_dtype: torch.dtype, int8_pool: bool,
                 head_dim: int, out_dtype: torch.dtype | None = None) -> str:
    """Which CUDA kernel serves a q of ``q_dtype`` over pools of
    ``pool_dtype`` (the codes' dtype for an int8 ``{q, s}`` pool) at
    ``head_dim``, writing ``out_dtype`` (default q's): :data:`ROUTE_SPLIT`
    (K2) for a bf16 q over bf16 or int8 pools at a head dim in
    :data:`HEAD_DIMS` with a bf16 or f32 output, else :data:`ROUTE_F32`
    (K2-f32).  Raises ``ValueError``, naming it, for what neither kernel
    is built for."""
    out_dtype = out_dtype or q_dtype
    if int8_pool != (pool_dtype == torch.int8):
        raise ValueError(
            f"no CUDA kernel takes {'int8 ' if int8_pool else 'dense '}pools of "
            f"{pool_dtype}: int8 pools hold int8 codes with f32 scales"
        )
    if (q_dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16, torch.int8)
            and head_dim in HEAD_DIMS and out_dtype in (torch.bfloat16, torch.float32)):
        return ROUTE_SPLIT
    for what, dtype, table in (("q", q_dtype, F32_DTYPES), ("pool", pool_dtype, F32_POOL_DTYPES),
                               ("output", out_dtype, F32_DTYPES)):
        if dtype not in table:
            raise ValueError(
                f"no CUDA kernel takes a {dtype} {what}: K2-f32 takes "
                f"{sorted(str(d) for d in table)}"
            )
    if head_dim not in F32_HEAD_DIMS:
        raise ValueError(
            f"no CUDA kernel is built for head dim {head_dim}: K2 takes head dims "
            f"{HEAD_DIMS}, K2-f32 head dims {F32_HEAD_DIMS}"
        )
    pools = F32_POOLS_AT_HEAD_DIM.get(head_dim)
    if pools is not None and pool_dtype not in pools:
        raise ValueError(
            f"no CUDA kernel takes {pool_dtype} pools at head dim {head_dim}: K2-f32 "
            f"is built there for {sorted(str(d) for d in pools)} pools"
        )
    return ROUTE_F32


@dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts one lane's walk, from shapes alone.

    Span ``i`` covers ``blocks_per_split`` whole pool blocks starting at
    logical block ``(i // chunks_per_block) * blocks_per_split`` and, in
    each, positions ``[c * chunk, min(BS, (c + 1) * chunk))`` with
    ``c = i % chunks_per_block``.  ``scratch_shape`` is the f32 scratch
    of partials ``(B, KV, n_split, n_rep, HD + 2)``: per span and query
    row the span's max (log2 units), its sum and its accumulator.
    """

    blocks_per_split: int
    chunks_per_block: int
    chunk: int
    n_split: int
    scratch_shape: tuple[int, int, int, int, int]


def split_plan(batch: int, kv_heads: int, n_rep: int, head_dim: int,
               block_size: int, max_blocks: int) -> SplitPlan:
    """Spans of at most :data:`SPAN` positions: ``SPAN // BS`` whole
    blocks when a block is smaller, else ``ceil(BS / SPAN)`` chunks of
    each block."""
    if not 1 <= block_size <= MAX_BLOCK_SIZE or max_blocks < 1:
        raise ValueError(f"no split plan for block_size {block_size}, "
                         f"{max_blocks} blocks per lane")
    if block_size < SPAN:
        bps, cps, chunk = SPAN // block_size, 1, block_size
    else:
        bps, cps, chunk = 1, -(-block_size // SPAN), SPAN
    n_split = -(-max_blocks // bps) * cps
    if n_split > MAX_SPLITS:
        raise ValueError(f"{max_blocks} blocks of {block_size} positions make {n_split} "
                         f"spans per lane; the kernel's grid takes {MAX_SPLITS}")
    return SplitPlan(bps, cps, chunk, n_split,
                     (batch, kv_heads, n_split, n_rep, head_dim + 2))


def _pool_leaves(pool):
    """(codes or values, scales or None) of a pool side."""
    if isinstance(pool, dict):
        return pool["q"], pool["s"]
    return pool, None


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pool,
    v_pool,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    block_size: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's f32 arithmetic.

    Gathers each lane's blocks ``pool[page_table]``, dequantizes int8
    codes times their per-(position, kv head) scale in f32, scores every
    logical position ``j * BS + s`` against the lane's query rows (head
    h reads kv head ``h // n_rep``), masks positions past ``lengths``
    with ``-inf``, and takes the softmax with an ``l == 0`` guard.  A
    length past the table's last position keeps every block visible, as
    the Pallas kernel does.  Output in ``out_dtype`` (default q's).
    """
    B, H, HD = q.shape
    kq, ks = _pool_leaves(k_pool)
    vq, vs = _pool_leaves(v_pool)
    KV = kq.shape[2]
    n_rep = H // KV
    MB = page_table.shape[1]
    if block_size != kq.shape[1]:
        raise ValueError(f"block_size {block_size} != pool block {kq.shape[1]}")
    idx = page_table.long()
    k = kq[idx].float()  # (B, MB, BS, KV, HD)
    v = vq[idx].float()
    if ks is not None:
        k = k * ks[idx].float()[..., None]
        v = v * vs[idx].float()[..., None]
    T = MB * block_size
    k = k.reshape(B, T, KV, HD)
    v = v.reshape(B, T, KV, HD)
    qg = q.float().reshape(B, KV, n_rep, HD)
    s = torch.einsum("bgrd,btgd->bgrt", qg, k) * HD**-0.5
    pos = torch.arange(T, device=q.device)
    visible = pos[None, :] <= lengths.to(q.device).long()[:, None]  # (B, T)
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    out = torch.einsum("bgrt,btgd->bgrd", p, v) / denom
    return out.reshape(B, H, HD).to(out_dtype or q.dtype)


def _split_of_position(plan: SplitPlan, block_size: int, T: int) -> torch.Tensor:
    """Which span each logical position ``t < T`` falls in."""
    t = torch.arange(T)
    j, s = t // block_size, t % block_size
    return (j // plan.blocks_per_split) * plan.chunks_per_block + s // plan.chunk


def paged_decode_attention_split(
    q: torch.Tensor,
    k_pool,
    v_pool,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    block_size: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch model of the kernel's split-then-combine arithmetic.

    Each span of :func:`split_plan` gives per query row its max ``m``
    (over visible positions; ``-inf`` if none), its sum ``l`` of
    ``exp(s - m)`` and its accumulator; the spans are merged with
    weights ``exp(m - M)`` (0 for ``m == -inf``) and divided by the
    merged sum with the ``l == 0`` guard.  A page-table entry outside
    ``[0, N)`` makes its block invisible, as in the kernel, so a lane
    whose entries all lie outside returns zeros.  Otherwise equal to
    :func:`paged_decode_attention_reference` up to f32 rounding.
    """
    B, H, HD = q.shape
    kq, ks = _pool_leaves(k_pool)
    vq, vs = _pool_leaves(v_pool)
    N, BS, KV, _ = kq.shape
    if block_size != BS:
        raise ValueError(f"block_size {block_size} != pool block {BS}")
    n_rep = H // KV
    MB = page_table.shape[1]
    plan = split_plan(B, KV, n_rep, HD, BS, MB)
    in_pool = (page_table >= 0) & (page_table < N)
    idx = torch.where(in_pool, page_table, torch.zeros_like(page_table)).long()
    k = kq[idx].float()  # (B, MB, BS, KV, HD)
    v = vq[idx].float()
    if ks is not None:
        k = k * ks[idx].float()[..., None]
        v = v * vs[idx].float()[..., None]
    T = MB * BS
    k = k.reshape(B, T, KV, HD)
    v = v.reshape(B, T, KV, HD)
    qg = q.float().reshape(B, KV, n_rep, HD)
    s = torch.einsum("bgrd,btgd->bgrt", qg, k) * HD**-0.5
    pos = torch.arange(T, device=q.device)
    visible = (pos[None, :] <= lengths.to(q.device).long()[:, None]) & in_pool.to(
        q.device
    ).repeat_interleave(BS, dim=1)
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    # Per span: max, sum and accumulator of its visible positions.
    onehot = (
        _split_of_position(plan, BS, T)[:, None] == torch.arange(plan.n_split)[None, :]
    ).to(q.device)  # (T, n_split)
    spans = s[..., None].masked_fill(~onehot, float("-inf"))  # (B, KV, R, T, n_split)
    m = spans.amax(dim=-2)  # (B, KV, R, n_split)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(spans - m_safe[..., None, :])  # exp(-inf) = 0
    part_l = p.sum(dim=-2)
    part_acc = torch.einsum("bgrts,btgd->bgrsd", p, v)
    # Combine.
    M = m.amax(dim=-1, keepdim=True)
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - M))
    L = (w * part_l).sum(dim=-1)
    O = torch.einsum("bgrs,bgrsd->bgrd", w, part_acc)
    out = O / torch.where(L == 0.0, torch.ones_like(L), L)[..., None]
    return out.reshape(B, H, HD).to(out_dtype or q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("paged_attention")
    fn = lib.tpuslo_paged_decode_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 12
        + [ctypes.c_longlong] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_f32():
    lib = _build.load("attention_f32")
    fn = lib.tpuslo_paged_decode_attention_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 14
        + [ctypes.c_longlong] * 11
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, kq, ks, vq, vs, page_table, lengths, block_size, out_dtype) -> str:
    """Check what the kernels read and return the route
    (:func:`kernel_route`); raise ``ValueError`` on anything else."""
    if q.ndim != 3:
        raise ValueError(f"q must be (B, H, HD), got {tuple(q.shape)}")
    B, H, HD = q.shape
    if kq.ndim != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"pools must be (N, BS, KV, HD) and alike, got {tuple(kq.shape)} "
            f"and {tuple(vq.shape)}"
        )
    N, BS, KV, pool_hd = kq.shape
    tensors = {"q": q, "k_pool": kq, "v_pool": vq, "page_table": page_table,
               "lengths": lengths}
    if ks is not None:
        tensors.update(k_scales=ks, v_scales=vs)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if vq.dtype != kq.dtype:
        raise ValueError("k and v pools must share one dtype")
    if pool_hd != HD:
        raise ValueError(f"q has head dim {HD}, the pool {pool_hd}")
    route = kernel_route(q.dtype, kq.dtype, ks is not None, HD, out_dtype)
    if ks is not None:
        if ks.dtype != torch.float32 or ks.shape != (N, BS, KV) or vs.shape != ks.shape:
            raise ValueError("int8 pools need f32 scales of shape (N, BS, KV)")
        if ks.stride() != vs.stride():
            raise ValueError("k and v scales must share one layout")
    if H % KV or H // KV not in GROUP_SIZES:
        raise ValueError(
            f"{H} query heads over {KV} kv heads: the kernels take "
            f"{GROUP_SIZES} query heads per kv head"
        )
    if block_size != BS or not 1 <= BS <= MAX_BLOCK_SIZE:
        raise ValueError(
            f"block_size {block_size} must equal the pool's {BS} and lie in "
            f"1..{MAX_BLOCK_SIZE}"
        )
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(
            f"page table and lengths must be int32, got {page_table.dtype} "
            f"and {lengths.dtype}"
        )
    if page_table.ndim != 2 or page_table.shape[0] != B or page_table.stride(-1) != 1:
        raise ValueError("page table must be (B, MB) with unit inner stride")
    if lengths.shape != (B,) or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous ({B},) tensor")
    if kq.stride() != vq.stride():
        raise ValueError("k and v pools must share one layout")
    # K2 loads 8 elements at a time (16 bytes of bf16, 8 of int8 codes) from
    # q and the pools; K2-f32 copies pool rows 16 bytes at a time and reads
    # q element by element.
    checked = (("q", q, 8), ("k_pool", kq, 8), ("v_pool", vq, 8)) if route == ROUTE_SPLIT else (
        ("k_pool", kq, 16 // kq.element_size()), ("v_pool", vq, 16 // vq.element_size()))
    for name, t, elems in checked:
        align = elems * t.element_size()
        if t.stride(-1) != 1 or any((s * t.element_size()) % align for s in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs a unit inner stride and rows aligned to "
                f"{align} bytes, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.stride(-1) != 1:
        raise ValueError(f"q needs a unit inner stride, got strides {q.stride()}")
    return route


def paged_decode_attention(
    q: torch.Tensor,
    k_pool,
    v_pool,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    block_size: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One decode query per lane against its own pool blocks.

    q: ``(B, H, HD)``; pools: ``(N, BS, KV, HD)`` tensors or int8
    ``{"q": (N, BS, KV, HD), "s": (N, BS, KV) f32}``; page_table:
    ``(B, MB)`` int32 physical block indices (0 = null block); lengths:
    ``(B,)`` current positions (the step's token sits at ``lengths[b]``
    and is visible).  Returns ``(B, H, HD)`` in ``out_dtype`` (default
    q's).

    On the CPU this is :func:`paged_decode_attention_reference`.  On
    CUDA it launches, on the current stream, K2 or K2-f32 as
    :func:`kernel_route` says, with an int32 page table and lengths, and
    raises on anything neither kernel is built for.  It reads the lengths
    and the page table on the device and sizes its grid and scratch from
    shapes alone: the call never waits for the card, and it can be
    captured in a CUDA graph and replayed after the lengths and the table
    change in place.
    """
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, page_table, lengths,
            block_size=block_size, out_dtype=out_dtype,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not {q.device}")
    kq, ks = _pool_leaves(k_pool)
    vq, vs = _pool_leaves(v_pool)
    if (ks is None) != (vs is None):
        raise ValueError("k and v pools must both be int8 or both dense")
    route = _check_kernel_inputs(q, kq, ks, vq, vs, page_table, lengths, block_size, out_dtype)
    B, H, HD = q.shape
    N, BS, KV, _ = kq.shape
    MB = page_table.shape[1]
    plan = split_plan(B, KV, H // KV, HD, BS, MB)
    out = torch.empty((B, H, HD), dtype=out_dtype, device=q.device)
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=q.device)
    scale_strides = ks.stride() if ks is not None else (0, 0, 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        pointers = (
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(),
        )
        geometry = (B, KV, H // KV, HD, N, BS, MB)
        split = (plan.n_split, plan.blocks_per_split, plan.chunks_per_block, plan.chunk)
        strides = (*q.stride()[:2], *kq.stride()[:3], *scale_strides,
                   page_table.stride(0), *out.stride()[:2])
        if route == ROUTE_F32:
            err = _kernel_f32()(
                *pointers, F32_DTYPES[q.dtype], F32_POOL_DTYPES[kq.dtype],
                F32_DTYPES[out_dtype], *geometry, *split, *strides, HD**-0.5, stream,
            )
        else:
            err = _kernel()(
                *pointers, *geometry, int(ks is not None), *split, *strides,
                HD**-0.5, int(out_dtype == torch.float32), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention {'f32 ' if route == ROUTE_F32 else ''}kernel "
            f"launch failed: CUDA error {err}"
        )
    if route == ROUTE_F32:
        paged_decode_attention.f32_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.f32_launches = 0
launch_counts.register(paged_decode_attention, "launches", "f32_launches")
