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
* a CUDA tensor launches the hand-written Hopper kernel in
  ``csrc/paged_attention.cu`` (built with nvcc at first use, see
  :mod:`tpuslo_torch.ops._build`), or the call raises: on a pool that is
  neither bf16 nor int8, a page table or lengths that are not int32, a
  head dim other than 64 or 128, a layout the kernel does not read, a
  failed build or a refused launch.  There is no fallback from the card
  to the plain version.

``paged_decode_attention.launches`` counts kernel launches, so that a
run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuslo_torch.ops import _build

HEAD_DIMS = (64, 128)  # the head dims the kernel is built for
GROUP_SIZES = (1, 2, 3, 4, 8)  # query heads per kv head it is built for
MAX_BLOCK_SIZE = 1024  # scores of one block live in shared memory


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


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("paged_attention")
    fn = lib.tpuslo_paged_decode_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, kq, ks, vq, vs, page_table, lengths, block_size, out_dtype):
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
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes a bf16 q; q is {q.dtype}")
    if ks is None and kq.dtype != torch.bfloat16:
        raise ValueError(
            f"the CUDA kernel takes bf16 or int8 {{q, s}} pools; the pool is {kq.dtype}"
        )
    if ks is not None:
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise ValueError("int8 pools need int8 codes")
        if ks.dtype != torch.float32 or ks.shape != (N, BS, KV) or vs.shape != ks.shape:
            raise ValueError("int8 pools need f32 scales of shape (N, BS, KV)")
        if ks.stride() != vs.stride():
            raise ValueError("k and v scales must share one layout")
    if vq.dtype != kq.dtype:
        raise ValueError("k and v pools must share one dtype")
    if pool_hd != HD or HD not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernel is built for head dims {HEAD_DIMS}; q has {HD}, "
            f"the pool {pool_hd}"
        )
    if H % KV or H // KV not in GROUP_SIZES:
        raise ValueError(
            f"{H} query heads over {KV} kv heads: the kernel takes "
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
    # Loads of 8 elements: 16 bytes of bf16, 8 bytes of int8 codes.
    for name, t in (("q", q), ("k_pool", kq), ("v_pool", vq)):
        align = 8 * t.element_size()
        if t.stride(-1) != 1 or any((s * t.element_size()) % align for s in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs a unit inner stride and rows aligned to "
                f"{align} bytes, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel writes bf16 or f32, not {out_dtype}")


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
    and is visible).  Returns ``(B, H, HD)`` in ``out_dtype``.

    On the CPU this is :func:`paged_decode_attention_reference`.  On
    CUDA it launches the Hopper kernel on the current stream (bf16 q,
    bf16 or int8 pools, int32 page table and lengths, head dim 64 or
    128) and raises on anything else.  It reads the lengths and the page
    table on the device: the call never waits for the card.
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
    _check_kernel_inputs(q, kq, ks, vq, vs, page_table, lengths, block_size, out_dtype)
    B, H, HD = q.shape
    N, BS, KV, _ = kq.shape
    out = torch.empty((B, H, HD), dtype=out_dtype, device=q.device)
    scale_strides = ks.stride() if ks is not None else (0, 0, 0)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, KV, H // KV, HD, N, BS, page_table.shape[1], int(ks is not None),
            *q.stride()[:2], *kq.stride()[:3], *scale_strides,
            page_table.stride(0), *out.stride()[:2],
            HD**-0.5, int(out_dtype == torch.float32), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
