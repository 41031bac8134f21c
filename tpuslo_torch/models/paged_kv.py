"""Block-paged KV cache (PyTorch port of ``tpuslo/models/paged_kv.py``).

The dense continuous-batching cache reserves ``max_seq_len`` KV rows per
slot; this engine decouples the slot count from it:

* one physical **block pool** ``(L, n_blocks, block_size, KV, HD)``
  shared by every slot, the only KV memory the engine allocates;
* a per-slot **page table** ``(slots, max_blocks_per_row)`` of int32
  physical-block indices on the engine's device (logical block
  ``t // block_size`` of a row lives at ``page_table[row, t //
  block_size]``);
* a host-side free list; admission takes exactly the blocks a request
  can ever touch (prompt + token budget), completion and cancellation
  return them.  Admission and release write one page-table row from the
  host, a copy to the device that never reads back.

Block 0 is the null block: unallocated page-table entries point at it.
Released lanes keep decoding every step (the batch has a fixed shape),
and their KV writes land in the null block through their zeroed page
tables, which is why no live request is ever mapped to it.

Requests that name a shared ``prefix`` share the prefix's *full* blocks
read-only (block-granular copy-on-write): the first installer populates
them, later requests point their page tables at them and pay only their
private blocks.  Decode writes target position ``>= total_len >
n_shared * block_size``, always a private block.  Idle (refcount-0)
prefixes stay warm and are evicted LRU-first under admission pressure.
int8 pools compose with all of it.

Attention over the pool takes one of two routes, selected per engine by
``pallas_attention`` (the JAX engine's name, kept so that callers pass
it through unchanged): off, the plain :func:`_pool_attention` over the
whole physical pool with a per-lane ownership mask; on, kernel K2
(:func:`tpuslo_torch.ops.paged_attention.paged_decode_attention`), which
on a CUDA device is the hand-written Hopper kernel reading only each
lane's own blocks, and on the CPU its plain version.

What differs from the JAX module: a Python loop over layers writes the
pool in place where JAX scans and donates; JAX's jitted ``_shared_*``
compile caches have no counterpart.  Under a tp mesh (``mesh=``) each
rank's pool holds its ``n_kv_heads / tp`` heads and the page table is
every rank's alike (the free list is host-side and decides from the
gathered tokens alone).  The JAX engine turns K2 off under a mesh and
attends through XLA over the physical pool; the port runs K2 (or the
plain pool attention) on each rank's own kv heads, the same function
per head.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from tpuslo_torch.device import resolve_device
from tpuslo_torch.models import kv_cache as kvc
from tpuslo_torch.models.batching import ContinuousBatchingEngine, _copy_length, _Request
from tpuslo_torch.models.llama import (
    LlamaConfig,
    _at,
    _dense_mlp,
    _embed_lookup,
    _layer,
    _logits,
    _matmul,
    _reduce,
    apply_rope,
    llama_tiny,
    local_heads,
    rms_norm,
    rope_frequencies,
    tp_mesh_of,
)
from tpuslo_torch.ops.paged_attention import paged_decode_attention

State = dict[str, Any]


def init_paged_pool(
    cfg: LlamaConfig, n_blocks: int, block_size: int, slots: int,
    kv_dtype: str = "bf16", device: str | torch.device = "cuda", tp: int = 1,
) -> State:
    """Pool + page table + per-slot lengths.  ``n_blocks`` includes the
    reserved null block 0.  ``tp``: one tp rank's pool, holding its
    ``n_kv_heads / tp`` heads (the page table is every rank's alike)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads // tp, cfg.head_dim)
    max_blocks = -(-cfg.max_seq_len // block_size)
    return {
        "k": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "v": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "page_table": torch.zeros((slots, max_blocks), dtype=torch.int32, device=dev),
        "length": torch.zeros((slots,), dtype=torch.long, device=dev),
    }


def paged_pool_bytes(
    cfg: LlamaConfig, n_blocks: int, block_size: int, kv_dtype: str = "bf16"
) -> int:
    """Device bytes the pool pins: the capacity arithmetic for sizing."""
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return 2 * kvc.kv_bytes(shape, cfg.dtype, kv_dtype)


def inject_prompt_block(
    state: State, row_kv: State, start: int, phys: int, cfg: LlamaConfig,
    block_size: int,
) -> State:
    """Copy the ``block_size`` window at ``start`` of a single-row cache
    (``row_kv`` = {"k", "v"} of shape (L, 1, S, KV, HD)) into physical
    block ``phys``, in place.  Raises if the window runs past the row
    (JAX's ``dynamic_slice`` would clamp it and copy a shifted window)."""
    start, phys = int(start), int(phys)
    for side in ("k", "v"):
        for pool, row in kvc.kv_leaf_pairs(state[side], row_kv[side]):
            if start < 0 or start + block_size > row.shape[2]:
                raise ValueError(
                    f"block window {start}..{start + block_size} runs past "
                    f"the row ({row.shape[2]} positions)"
                )
            pool[:, phys] = row[:, 0, start : start + block_size]
    return state


def pool_visibility_mask(
    page_table: torch.Tensor, lengths: torch.Tensor, n_blocks: int,
    block_size: int,
) -> torch.Tensor:
    """Per-lane ownership and causality mask over the physical pool.

    ``(B, n_blocks * block_size)`` bool: pool slot (n, s) is visible to
    lane b iff lane b owns physical block n as logical block j and the
    position ``j * block_size + s`` is at or before the lane's length.
    Ownership is scattered through the page table; every unallocated
    entry points at null block 0, so column 0 collects duplicates whose
    winner is arbitrary, and is reset to -1 after the scatter.
    """
    B, MB = page_table.shape
    dev = page_table.device
    logical = torch.arange(MB, dtype=torch.int32, device=dev).expand(B, MB).contiguous()
    inv = torch.full((B, n_blocks), -1, dtype=torch.int32, device=dev)
    inv.scatter_(1, page_table.long(), logical)
    inv[:, 0] = -1
    offs = torch.arange(block_size, dtype=torch.int32, device=dev)
    abs_pos = inv[:, :, None] * block_size + offs[None, None, :]  # (B, N, BS)
    visible = (inv[:, :, None] >= 0) & (abs_pos <= lengths.to(dev)[:, None, None])
    return visible.reshape(B, n_blocks * block_size)


def _pool_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, visible: torch.Tensor,
    n_rep: int,
) -> torch.Tensor:
    """GQA attention of one query per lane over the PHYSICAL pool.

    q: (B, H, HD); k/v: (N, BS, KV, HD); visible: (B, N*BS).  The pool is
    read once for every lane and ownership lives in the mask.  Logits
    are f32 products masked with ``-1e30``; the softmax weights are cast
    to v's dtype before the second product, which again accumulates in
    f32 (the JAX module's arithmetic).
    """
    B, H, HD = q.shape
    KV = k.shape[2]
    t = k.shape[0] * k.shape[1]
    k2 = k.reshape(t, KV, HD)
    v2 = v.reshape(t, KV, HD)
    qg = q.float().reshape(B, KV, n_rep, HD)
    logits = torch.einsum("bkrd,tkd->bkrt", qg, k2.float()) * HD**-0.5
    logits = logits.masked_fill(~visible[:, None, None, :], -1e30)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,tkd->bkrd", weights.to(v2.dtype).float(), v2.float())
    return out.reshape(B, H, HD).to(q.dtype)


def paged_decode_step(
    params, token: torch.Tensor, state: State, cfg: LlamaConfig,
    block_size: int, pallas: bool = False, mlp_fn=None,
) -> tuple[torch.Tensor, State]:
    """One decode token for every slot against the paged pool.

    The vector-length path of :func:`tpuslo_torch.models.llama.decode_step`
    over the pool: each lane's KV write lands in place at (physical
    block, offset) resolved through its page table, and attention runs
    over the pool, through the plain :func:`_pool_attention` or, with
    ``pallas=True``, through kernel K2.  Released lanes keep stepping:
    their logical block is clamped to the table's last column so the
    lookup stays in range, and resolves to their zeroed entry, the null
    block.  ``mlp_fn(layer, x)`` swaps the dense MLP for another block
    body (the MoE family's hook).
    """
    B = token.shape[0]
    pos = state["length"]  # (B,)
    pt = state["page_table"]  # (B, MB) int32
    MB = pt.shape[1]
    blk = torch.clamp(pos // block_size, max=MB - 1)
    phys = pt.gather(1, blk[:, None].long())[:, 0].long()
    off = pos % block_size

    h = _embed_lookup(params, token[:, None], cfg.dtype)
    cos, sin = rope_frequencies(cfg, pos[:, None])
    (H, KV), HD = local_heads(cfg, params["layers"]), cfg.head_dim
    mesh = tp_mesh_of(params)
    n_blocks = (state["k"]["q"] if isinstance(state["k"], dict) else state["k"]).shape[1]
    if pallas:
        lengths32 = pos.to(torch.int32)  # once per step, for every layer
    else:
        visible = pool_visibility_mask(pt, pos, n_blocks, block_size)

    def write(pool, new: torch.Tensor) -> None:
        # new: (B, KV, HD) -> one (phys, off) slot per lane, in place.
        if isinstance(pool, dict):
            qs = kvc.quantize_kv(new)
            pool["q"][phys, off] = qs["q"]
            pool["s"][phys, off] = qs["s"]
        else:
            pool[phys, off] = new

    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        k_pool = _at(state["k"], i)
        v_pool = _at(state["v"], i)
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = _matmul(x, layer["wq"]).reshape(B, 1, H, HD)
        k = _matmul(x, layer["wk"]).reshape(B, 1, KV, HD)
        v = _matmul(x, layer["wv"]).reshape(B, 1, KV, HD)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        write(k_pool, k[:, 0])
        write(v_pool, v[:, 0])
        if pallas:
            attn = paged_decode_attention(
                q[:, 0], k_pool, v_pool, pt, lengths32,
                block_size=block_size, out_dtype=cfg.dtype,
            )
        else:
            attn = _pool_attention(
                q[:, 0], kvc.kv_load(k_pool, cfg.dtype),
                kvc.kv_load(v_pool, cfg.dtype), visible, H // KV,
            )
        h = h + _reduce(_matmul(attn.reshape(B, 1, H * HD), layer["wo"]), mesh)
        x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
        h = h + (_dense_mlp(cfg, layer, x, mesh=mesh) if mlp_fn is None else mlp_fn(layer, x))
    state = {**state, "length": pos + 1}
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h[:, 0, :], _matmul), state


# ---- block-granular park/resume (the paged front door) ----------------
#
# These move only the blocks a slot has touched between a dense decode
# cache and the physical pool, so a preemption costs the blocks touched,
# not max_seq_len.  Positions past the parked window are never attended.


def _index(phys, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(phys, dtype=torch.long).to(device)


def park_slot_blocks(
    pool: State, cache: State, slot: int, phys, cfg: LlamaConfig,
    block_size: int, bucket: int,
) -> State:
    """Copy the first ``bucket`` aligned blocks of ``slot``'s dense cache
    row into the pool blocks listed in ``phys`` (``(bucket,)``; pad
    entries point at null block 0, whose contents nothing reads).  The
    pool is written in place; the dense cache is only read."""
    slot = int(slot)
    for side in ("k", "v"):
        for pool_leaf, cache_leaf in kvc.kv_leaf_pairs(pool[side], cache[side]):
            L = cache_leaf.shape[0]
            src = cache_leaf[:, slot, : bucket * block_size]
            blocks = src.reshape((L, bucket, block_size) + tuple(cache_leaf.shape[3:]))
            pool_leaf[:, _index(phys, pool_leaf.device)] = blocks
    return pool


def resume_slot_blocks(
    cache: State, pool: State, slot: int, phys, frontier,
    cfg: LlamaConfig, block_size: int, bucket: int,
) -> State:
    """Copy a parked request's pool blocks back into ``slot`` of the
    dense decode cache and set its length to ``frontier`` (the inverse
    of :func:`park_slot_blocks`).  The cache is written in place; the
    pool is only read."""
    slot = int(slot)
    for side in ("k", "v"):
        for cache_leaf, pool_leaf in kvc.kv_leaf_pairs(cache[side], pool[side]):
            if bucket * block_size > cache_leaf.shape[2]:
                raise ValueError(
                    f"{bucket} blocks of {block_size} exceed the cache row "
                    f"({cache_leaf.shape[2]} positions)"
                )
            blocks = pool_leaf[:, _index(phys, pool_leaf.device)]  # (L, bucket, BS, ...)
            L = blocks.shape[0]
            window = blocks.reshape((L, bucket * block_size) + tuple(blocks.shape[3:]))
            cache_leaf[:, slot, : bucket * block_size] = window
    _copy_length(cache["length"], slot, frontier)
    return cache


def gather_parked_row(
    pool: State, phys, frontier, cfg: LlamaConfig, block_size: int,
) -> State:
    """A parked request's single-row dense cache reassembled from its
    pool blocks (``phys``: ``(max_blocks,)``, pad entries 0 give the null
    block's contents), with ``length`` as a 0-d tensor: the drain path
    a sibling engine's ``_inject_row`` can install."""

    def take(pool_leaf: torch.Tensor) -> torch.Tensor:
        blocks = pool_leaf[:, _index(phys, pool_leaf.device)]  # (L, MB, BS, ...)
        L = blocks.shape[0]
        flat = blocks.reshape((L, blocks.shape[1] * block_size) + tuple(blocks.shape[3:]))
        return flat[:, None]

    device = (pool["k"]["q"] if isinstance(pool["k"], dict) else pool["k"]).device
    return {
        "k": kvc.kv_map(take, pool["k"]),
        "v": kvc.kv_map(take, pool["v"]),
        "length": torch.as_tensor(frontier, dtype=torch.long).to(device),
    }


def _table_row(values: Sequence[int], width: int, device: torch.device) -> torch.Tensor:
    """A page-table row built on the host, zero-padded to ``width``; in
    pinned memory when it goes to a card, so that the copy is
    asynchronous and the host does not wait."""
    row = torch.zeros((width,), dtype=torch.int32)
    row[: len(values)] = torch.tensor(list(values), dtype=torch.int32)
    return row.pin_memory() if device.type == "cuda" else row


@dataclass
class _SharedPrefix:
    """Registry entry for one shared prompt prefix's pool blocks.

    ``blocks`` are the prefix's FULL blocks only (the ragged tail block
    also holds per-request prompt tokens).  ``refs`` counts live slots
    whose page tables point at them; eviction is legal only at zero.
    ``populated`` flips once the first installer has copied the prefix KV
    in.
    """

    key: str
    blocks: list[int] = field(default_factory=list)
    refs: int = 0
    populated: bool = False
    last_use: int = 0


class PagedBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged pool.

    Same external API and per-request outputs as the dense engine;
    ``n_blocks`` bounds *live* KV tokens, not per-slot reservations.
    A request whose blocks are not free waits at the queue head until a
    completion releases some.

    ``pallas_attention`` selects the attention route (see the module
    docstring): ``None`` reads the opt-in ``TPUSLO_PAGED_PALLAS=1``, and
    the default is the plain :func:`_pool_attention`, as in the JAX
    engine.  On a CUDA device the switch selects the hand-written CUDA
    kernel K2.  ``paged_step_fn`` is the family extension point: another
    family supplies its own paged decode step and inherits the
    allocator, scheduler and sharing.
    """

    @staticmethod
    def validate_block_geometry(cfg, block_size: int) -> None:
        """Refuse block geometries the prompt-KV splice cannot honor:
        a block larger than the context, or a context that is not a
        block multiple (the last window would be copied shifted)."""
        if block_size > cfg.max_seq_len:
            raise ValueError(
                f"block_size={block_size} exceeds max_seq_len={cfg.max_seq_len}"
            )
        if cfg.max_seq_len % block_size != 0:
            raise ValueError(
                f"max_seq_len={cfg.max_seq_len} must be a multiple "
                f"of block_size={block_size}: the prompt-KV splice copies "
                "aligned windows and a ragged tail would be copied shifted"
            )

    def __init__(
        self,
        cfg: LlamaConfig | None = None,
        params=None,
        max_slots: int = 4,
        n_blocks: int | None = None,
        block_size: int = 64,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128, 256),
        quantize: bool = False,
        kv_dtype: str = "bf16",
        mesh=None,
        pallas_attention: bool | None = None,
        share_prefixes: bool = True,
        ingest=None,
        paged_step_fn=None,
        device: str | torch.device = "cuda",
    ):
        if pallas_attention is None:
            pallas_attention = os.environ.get("TPUSLO_PAGED_PALLAS", "") == "1"
        self.pallas_attention = bool(pallas_attention)
        self.block_size = block_size
        c = cfg if cfg is not None else llama_tiny(max_seq_len=512)
        self.validate_block_geometry(c, block_size)
        # Default pool: half the dense reservation.
        if n_blocks is None:
            n_blocks = 1 + max_slots * (-(-c.max_seq_len // block_size)) // 2
        self.n_blocks = n_blocks
        self._free: list[int] = []
        self._slot_blocks: list[list[int]] = []
        self.share_prefixes = share_prefixes
        self._shared_prefixes: dict[str, _SharedPrefix] = {}
        self._slot_prefix: list[str | None] = []
        self._prefix_len_cache: dict[str, int] = {}
        self._prefix_clock = 0
        #: admissions that reused an already-populated shared prefix
        self.prefix_reuse_hits = 0
        step = (
            paged_step_fn
            if paged_step_fn is not None
            else functools.partial(
                paged_decode_step, cfg=c, block_size=block_size,
                pallas=self.pallas_attention,
            )
        )
        super().__init__(
            cfg=cfg, params=params, max_slots=max_slots, rng_seed=rng_seed,
            prefill_buckets=prefill_buckets, quantize=quantize,
            kv_dtype=kv_dtype, mesh=mesh, ingest=ingest, step_fn=step, device=device,
        )

    # -- hooks -----------------------------------------------------------

    def _init_decode_state(self) -> State:
        state = init_paged_pool(
            self.cfg, self.n_blocks, self.block_size, self.max_slots,
            kv_dtype=self.kv_dtype, device=self.device, tp=self.tp,
        )
        # Block 0 is the null target of unallocated page-table entries.
        self._free = list(range(1, self.n_blocks))
        self._slot_blocks = [[] for _ in range(self.max_slots)]
        self._shared_prefixes = {}
        self._slot_prefix = [None] * self.max_slots
        return state

    def _blocks_needed(self, total_len: int, max_new: int) -> int:
        # A request can touch positions [0, total_len + max_new).
        return -(-(total_len + max_new) // self.block_size)

    def _prefix_full_blocks(self, prefix: str) -> int:
        """FULL blocks of the tokenized prefix (the shareable span), from
        the ingest engine's own prefix entry, memoized per prefix text in
        a bounded FIFO."""
        n = self._prefix_len_cache.get(prefix)
        if n is None:
            n = len(self._ingest.cache_prefix(prefix).ids)
            while len(self._prefix_len_cache) >= 64:
                self._prefix_len_cache.pop(next(iter(self._prefix_len_cache)))
            self._prefix_len_cache[prefix] = n
        return n // self.block_size

    def _evict_idle_prefixes(self, need: int, keep: str | None = None) -> None:
        """Reclaim refcount-0 shared prefixes, LRU-first, until ``need``
        free blocks exist.  Referenced prefixes and ``keep`` (the prefix
        the current admission reuses) are never touched; if even every
        eligible prefix cannot reach ``need``, nothing is evicted."""
        idle = [
            s for s in self._shared_prefixes.values()
            if s.refs == 0 and s.key != keep
        ]
        if len(self._free) + sum(len(s.blocks) for s in idle) < need:
            return
        idle.sort(key=lambda s: s.last_use)
        for victim in idle:
            if len(self._free) >= need:
                break
            self._free.extend(victim.blocks)
            del self._shared_prefixes[victim.key]

    def _install_row(self, slot: int, row_cache: State, req: _Request) -> bool:
        total_len = int(row_cache["length"])
        plain_need = self._blocks_needed(total_len, req.max_new_tokens)
        # A request always needs plain_need pool blocks in total (shared
        # blocks occupy the pool too), so this is exactly the
        # never-admittable condition, with or without a prefix.
        if plain_need > self.n_blocks - 1:
            raise ValueError(
                f"request needs {plain_need} blocks but the pool only has "
                f"{self.n_blocks - 1}; raise n_blocks or lower "
                "max_new_tokens/prompt length"
            )
        share: _SharedPrefix | None = None
        n_shared = 0
        if self.share_prefixes and req.prefix:
            n_full = self._prefix_full_blocks(req.prefix)
            if n_full > 0:
                share = self._shared_prefixes.get(req.prefix)
                n_shared = n_full
        private_need = plain_need - n_shared
        need = private_need if (share is not None and share.populated) else plain_need
        if need > len(self._free):
            self._evict_idle_prefixes(
                need, keep=share.key if share is not None else None
            )
            if need > len(self._free):
                return False  # backpressure: wait for a release
        populate_shared = n_shared > 0 and (share is None or not share.populated)
        if n_shared > 0 and share is None:
            share = _SharedPrefix(
                key=req.prefix, blocks=[self._free.pop() for _ in range(n_shared)]
            )
            self._shared_prefixes[req.prefix] = share
        blocks = [self._free.pop() for _ in range(private_need)]
        self._slot_blocks[slot] = blocks
        if share is not None:
            share.refs += 1
            self._prefix_clock += 1
            share.last_use = self._prefix_clock
            self._slot_prefix[slot] = share.key
            if share.populated:
                self.prefix_reuse_hits += 1
        table = (share.blocks if share is not None else []) + blocks
        pt = self._cache["page_table"]
        pt[slot].copy_(_table_row(table, pt.shape[1], self.device), non_blocking=True)
        self._cache["length"][slot] = total_len
        # Copy the prompt's KV block by block; already-populated shared
        # blocks are skipped (the admission-bandwidth half of sharing).
        row_kv = {"k": row_cache["k"], "v": row_cache["v"]}
        for i in range(-(-total_len // self.block_size)):
            if i < n_shared and not populate_shared:
                continue
            inject_prompt_block(
                self._cache, row_kv, i * self.block_size, table[i], self.cfg,
                self.block_size,
            )
        if populate_shared:
            share.populated = True
        return True

    def _release_slot(self, slot: int) -> None:
        self._free.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        key = self._slot_prefix[slot]
        if key is not None:
            self._slot_prefix[slot] = None
            share = self._shared_prefixes.get(key)
            if share is not None:
                # Stays registered at refs 0, warm for the next request.
                share.refs = max(0, share.refs - 1)
        # Point the empty slot at the null block and park its position at
        # 0: every lane writes one slot each step, and a stale table would
        # write through freed blocks after they are handed to another
        # request.
        self._cache["page_table"][slot].zero_()
        self._cache["length"][slot] = 0

    # -- telemetry -------------------------------------------------------

    def stats(self) -> dict[str, int | float]:
        out = super().stats()
        live = (self.n_blocks - 1) - len(self._free)
        shared = sum(len(s.blocks) for s in self._shared_prefixes.values())
        out.update(
            {
                "pool_blocks": self.n_blocks - 1,
                "blocks_live": live,
                "block_utilization": live / max(1, self.n_blocks - 1),
                "shared_prefix_blocks": shared,
                "shared_prefixes": len(self._shared_prefixes),
                "prefix_reuse_hits": self.prefix_reuse_hits,
            }
        )
        return out
