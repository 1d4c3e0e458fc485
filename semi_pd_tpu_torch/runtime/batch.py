"""Host-side batch assembly (trimmed port of semi_pd_tpu/runtime/batch.py).

All bookkeeping is numpy on the controller; batches pad to static buckets.
``HostBatch.pack()`` concatenates every per-step array into ONE int32 and
ONE float32 vector (two host->device copies per step); the runner's
``_unpack_fb`` re-slices them with the same layout (``pack_len``). The
speculative verify batches (``build_spec_verify_batch``,
``build_tree_verify_batch``) pack too, a logits row per verify row and a
tree's slot-order positions and window starts included: a round graph's
static buffers take them in two copies (runtime/cuda_graph_runner.py);
an eager round takes ``to_device``'s tensors, one copy per array.

The image path (JAX batch.py:280-311, :374-383): an extend batch splices
the rows of its chunk that a request's ``mm_positions`` name (each image
straddling chunks is spliced in each), as ``embed_rows`` (flat row
indices) and ``embed_vals`` (those rows of the requests' ``mm_embeds``,
slices of the device tensors the towers made), where the JAX batch uploads
a dense [T, H] float32 override and a mask; an M-RoPE batch carries
``mrope_pos`` [T, 3]: a Qwen-VL request's own rows in its prompt, ``pos +
mrope_delta`` past it (decode). ``pack(mrope=True)`` (a runner whose model
ropes by M-RoPE) appends ``mrope_pos``, or ``q_pos`` on all three
components where the batch has none, before the request count, so every
decode step of such a runner packs alike and one decode graph per key
replays the shifted position. LoRA batches are a later slice (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from semi_pd_tpu_torch.ops.sampling import SamplingArrays
from semi_pd_tpu_torch.runtime.forward_batch import (
    ForwardArrays,
    ForwardMode,
    build_attn_meta,
    make_attn_meta_host,
)
from semi_pd_tpu_torch.runtime.req import Req


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class HostBatch:
    mode: ForwardMode
    reqs: List[Req]
    extend_lens: Optional[List[int]] = None  # tokens prefilled per req (EXTEND)
    input_ids: np.ndarray = None
    q_req_idx: np.ndarray = None
    q_pos: np.ndarray = None
    out_slots: np.ndarray = None
    page_table: np.ndarray = None
    kv_lens: np.ndarray = None
    logits_idx: np.ndarray = None
    sampling: SamplingArrays = None
    T: int = 0
    B: int = 0
    maxP: int = 0
    mask_pos: np.ndarray = None  # [T] slot-order positions (tree verify)
    win_base: np.ndarray = None  # [B] tree window start
    # [B] slot-order position of each request's first row, where it is not
    # kv_lens - q_lens (a verify's rows past a short draft)
    q_start: np.ndarray = None
    # the image path (module docstring)
    mrope_pos: np.ndarray = None  # [T, 3] i32
    embed_rows: np.ndarray = None  # [n] i64
    embed_vals: object = None  # [n, H] device tensor

    def q_lens(self) -> np.ndarray:
        q_lens = np.zeros(self.B, np.int32)
        if self.mode == ForwardMode.DECODE:
            q_lens[: len(self.reqs)] = 1
        else:
            q_lens[: len(self.reqs)] = self.extend_lens
        return q_lens

    def q_starts(self) -> np.ndarray:
        return self.kv_lens - self.q_lens() if self.q_start is None else self.q_start

    def to_device(self, device) -> ForwardArrays:
        import torch

        t = lambda a: torch.as_tensor(a, device=device)
        opt = lambda a: None if a is None else t(a)
        s = self.sampling
        return ForwardArrays(
            input_ids=t(self.input_ids), q_req_idx=t(self.q_req_idx),
            q_pos=t(self.q_pos), out_slots=t(self.out_slots),
            page_table=t(self.page_table), kv_lens=t(self.kv_lens),
            logits_idx=t(self.logits_idx),
            sampling=SamplingArrays(*[t(a) for a in s]),
            num_reqs=len(self.reqs),
            attn_meta=build_attn_meta(self.q_lens(), self.kv_lens, self.T, device,
                                      self.q_starts()),
            all_greedy=bool(np.all(s.temperature[: len(self.reqs)] <= 0.0)),
            mask_pos=opt(self.mask_pos), win_base=opt(self.win_base),
            mrope_pos=opt(self.mrope_pos), **self.splice(device),
        )

    def splice(self, device) -> dict:
        """The ForwardArrays fields of the batch's splice (``embed_rows``,
        ``embed_vals`` on ``device``); none where it splices nothing."""
        if self.embed_rows is None:
            return {}
        import torch

        return dict(embed_rows=torch.from_numpy(self.embed_rows).to(device, non_blocking=True),
                    embed_vals=self.embed_vals.to(device))

    def rope_rows(self) -> np.ndarray:
        """The M-RoPE positions [T, 3]: ``mrope_pos``, or ``q_pos`` on all
        three components."""
        if self.mrope_pos is not None:
            return self.mrope_pos
        return np.repeat(self.q_pos[:, None], 3, axis=1)

    def pack(self, mrope: bool = False
             ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int, int]]:
        """Pack every per-step array into ONE int32 vector and ONE float32
        vector (layout of the JAX package's HostBatch.pack; a tree batch's
        ``mask_pos`` and ``win_base`` after ``top_k``, with ``mrope`` the
        M-RoPE positions [T, 3] (``rope_rows``), and the request count
        last). The runner re-slices them with the static layout (T, B,
        maxP, NQB; ``pack_len``)."""
        T = self.T
        q_lens = self.q_lens()
        bs, br, bq = make_attn_meta_host(q_lens, T)
        s = self.sampling
        tree = [] if self.mask_pos is None else [self.mask_pos, self.win_base]
        rope = [self.rope_rows().reshape(-1)] if mrope else []
        ints = np.concatenate([
            self.input_ids, self.q_req_idx, self.q_pos, self.out_slots,
            self.page_table.reshape(-1), self.kv_lens, self.logits_idx,
            q_lens, self.q_starts(), bs, br, bq, s.top_k, *tree, *rope,
            np.array([len(self.reqs)], np.int32),
        ]).astype(np.int32)
        floats = np.concatenate([
            s.temperature, s.top_p, s.min_p, s.presence_penalty,
            s.frequency_penalty, s.repetition_penalty,
        ]).astype(np.float32)
        return ints, floats, (T, self.B, self.maxP, len(bs))


def pack_len(T: int, B: int, maxP: int, NQB: int, n_logits: Optional[int] = None,
             tree: bool = False, mrope: bool = False) -> int:
    """Length of ``HostBatch.pack()``'s int vector: ``n_logits`` logits
    rows (B by default; a verify batch's T), with ``tree`` the tree's
    ``mask_pos`` [T] and ``win_base`` [B], with ``mrope`` the M-RoPE
    positions [T, 3]."""
    n_logits = B if n_logits is None else n_logits
    return (4 * T + B * maxP + n_logits + 4 * B + 3 * NQB + 1 + (T + B if tree else 0)
            + (3 * T if mrope else 0))


def _sampling_arrays_np(reqs: List[Req], B: int) -> SamplingArrays:
    def arr(f, dtype, pad):
        a = np.full(B, pad, dtype=dtype)
        for i, r in enumerate(reqs):
            a[i] = f(r.sampling_params)
        return a

    return SamplingArrays(
        temperature=arr(lambda s: s.temperature, np.float32, 0.0),
        top_k=arr(lambda s: s.top_k, np.int32, 0),
        top_p=arr(lambda s: s.top_p, np.float32, 1.0),
        min_p=arr(lambda s: s.min_p, np.float32, 0.0),
        presence_penalty=arr(lambda s: s.presence_penalty, np.float32, 0.0),
        frequency_penalty=arr(lambda s: s.frequency_penalty, np.float32, 0.0),
        repetition_penalty=arr(lambda s: s.repetition_penalty, np.float32, 1.0),
    )


def _page_table_block(
    reqs: List[Req], B: int, maxP: int, page_table_host: np.ndarray
) -> np.ndarray:
    pt = np.zeros((B, maxP), dtype=np.int32)
    for i, r in enumerate(reqs):
        row = page_table_host[r.req_slot]
        n = min(maxP, len(r.pages))
        pt[i, :n] = row[:n]
    return pt


def build_extend_batch(
    admitted: List[Tuple[Req, int]],
    page_table_host: np.ndarray,
    page_size: int,
    t_buckets: Sequence[int],
    b_buckets: Sequence[int],
    p_buckets: Sequence[int],
) -> HostBatch:
    """Admitted = [(req, n_extend_tokens)]; page lists in req.pages already
    cover prefilled_len + n_extend (the scheduler ran the allocator)."""
    reqs = [r for r, _ in admitted]
    lens = [n for _, n in admitted]
    T = bucket_of(sum(lens), t_buckets)
    B = bucket_of(len(reqs), b_buckets)
    need_pages = max(
        ((r.prefilled_len + n + page_size - 1) // page_size
         for r, n in admitted),
        default=1,
    )
    maxP = bucket_of(need_pages, p_buckets)

    input_ids = np.zeros(T, np.int32)
    q_req_idx = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    out_slots = np.zeros(T, np.int32)
    kv_lens = np.zeros(B, np.int32)
    logits_idx = np.zeros(B, np.int32)
    mrope = None
    if any(r.mrope_pos is not None for r in reqs):
        mrope = np.zeros((T, 3), np.int32)
    rows, vals = [], []

    t = 0
    for i, (r, n) in enumerate(admitted):
        start = r.prefilled_len
        if mrope is not None:
            mrope[t : t + n] = _mrope_rows(r, start, n)
        if r.mm_embeds is not None:
            # the rows of this chunk's positions [start, start + n) that the
            # request splices: a slice of its rows (mm_positions is sorted)
            lo, hi = np.searchsorted(r.mm_positions, [start, start + n])
            if hi > lo:
                rows.append(t + r.mm_positions[lo:hi] - start)
                vals.append(r.mm_embeds[lo:hi])
        input_ids[t : t + n] = r.input_ids[start : start + n]
        q_req_idx[t : t + n] = i
        q_pos[t : t + n] = np.arange(start, start + n, dtype=np.int32)
        # slot = page[pos // P] * P + pos % P
        pos = np.arange(start, start + n)
        pages_arr = np.asarray(r.pages, dtype=np.int32)
        out_slots[t : t + n] = pages_arr[pos // page_size] * page_size + pos % page_size
        kv_lens[i] = start + n
        logits_idx[i] = t + n - 1
        t += n

    return HostBatch(
        mode=ForwardMode.EXTEND, reqs=reqs, extend_lens=lens,
        input_ids=input_ids, q_req_idx=q_req_idx, q_pos=q_pos,
        out_slots=out_slots,
        page_table=_page_table_block(reqs, B, maxP, page_table_host),
        kv_lens=kv_lens, logits_idx=logits_idx,
        sampling=_sampling_arrays_np(reqs, B), T=T, B=B, maxP=maxP, mrope_pos=mrope,
        **_splice_fields(rows, vals),
    )


def _mrope_rows(r: Req, start: int, n: int) -> np.ndarray:
    """The M-RoPE positions [n, 3] of ``r``'s positions [start, start + n):
    its ``mrope_pos`` rows inside the prompt, ``pos + mrope_delta`` past it."""
    pos = np.arange(start, start + n)
    out = np.repeat((pos + r.mrope_delta)[:, None], 3, axis=1)
    mp = r.mrope_pos
    if mp is not None:
        inside = pos < len(mp)
        out[inside] = mp[pos[inside]]
    return out


def _splice_fields(rows: list, vals: list) -> dict:
    """HostBatch's ``embed_rows`` / ``embed_vals`` of the requests' parts."""
    if not rows:
        return {}
    import torch

    return dict(embed_rows=np.concatenate(rows).astype(np.int64),
                embed_vals=vals[0] if len(vals) == 1 else torch.cat(vals))


def build_decode_batch(
    reqs: List[Req],
    page_table_host: np.ndarray,
    page_size: int,
    b_buckets: Sequence[int],
    p_buckets: Sequence[int],
    lag: int = 0,
) -> HostBatch:
    """One new token per request; the token to embed is the last sampled one.

    ``lag=1`` builds the batch one step ahead of host bookkeeping (overlap
    scheduling: the previous step's sampled tokens are still on the device
    and replace the input_ids placeholders there)."""
    B = bucket_of(len(reqs), b_buckets)
    T = B
    need_pages = max(
        ((r.kv_len + lag + page_size) // page_size for r in reqs),
        default=1,
    )
    maxP = bucket_of(need_pages, p_buckets)

    input_ids = np.zeros(T, np.int32)
    q_req_idx = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    out_slots = np.zeros(T, np.int32)
    kv_lens = np.zeros(B, np.int32)
    logits_idx = np.arange(B, dtype=np.int32)
    mrope = None
    if any(r.mrope_pos is not None for r in reqs):
        mrope = np.zeros((T, 3), np.int32)

    for i, r in enumerate(reqs):
        pos = r.kv_len + lag  # writing token at this index (0-based)
        if mrope is not None:  # the rope's position; the kernels keep q_pos
            mrope[i] = pos + r.mrope_delta
        if lag == 0:
            input_ids[i] = r.output_ids[-1] if r.output_ids else r.input_ids[-1]
        q_req_idx[i] = i
        q_pos[i] = pos
        out_slots[i] = r.pages[pos // page_size] * page_size + pos % page_size
        kv_lens[i] = pos + 1

    return HostBatch(
        mode=ForwardMode.DECODE, reqs=list(reqs),  # snapshot: caller's list mutates
        input_ids=input_ids, q_req_idx=q_req_idx, q_pos=q_pos,
        out_slots=out_slots,
        page_table=_page_table_block(reqs, B, maxP, page_table_host),
        kv_lens=kv_lens, logits_idx=logits_idx,
        sampling=_sampling_arrays_np(reqs, B), T=T, B=B, maxP=maxP, mrope_pos=mrope,
    )


def build_spec_verify_batch(
    reqs: List[Req],
    drafts: List[List[int]],
    gamma: int,
    page_table_host: np.ndarray,
    page_size: int,
    b_buckets: Sequence[int],
    p_buckets: Sequence[int],
) -> Tuple[HostBatch, np.ndarray, np.ndarray]:
    """Speculative verify batch: each request contributes exactly gamma+1
    query rows = [last sampled token, draft_1..draft_d, padding...]. Returns
    (HostBatch, drafts_padded [B, gamma], draft_lens [B]). Padding rows write
    to the dump page and their outputs are ignored on device. The work
    list's q_start is each request's kv_len (its row 0's slot), not kv_lens
    - (gamma + 1): a draft shorter than gamma would otherwise hide the
    newest positions, the row's own among them, from every row."""
    B = bucket_of(len(reqs), b_buckets)
    W = gamma + 1
    T = B * W
    need_pages = max(
        (r.kv_len + 1 + len(d) + page_size - 1) // page_size + 1
        for r, d in zip(reqs, drafts)
    )
    maxP = bucket_of(need_pages, p_buckets)

    input_ids = np.zeros(T, np.int32)
    q_req_idx = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    out_slots = np.zeros(T, np.int32)
    kv_lens = np.zeros(B, np.int32)
    logits_idx = np.arange(T, dtype=np.int32)
    q_start = np.zeros(B, np.int32)
    drafts_padded = np.full((B, gamma), -1, np.int32)
    draft_lens = np.zeros(B, np.int32)

    for i, (r, d) in enumerate(zip(reqs, drafts)):
        base = i * W
        last_tok = r.output_ids[-1] if r.output_ids else r.input_ids[-1]
        window = [last_tok] + list(d)
        start_pos = r.kv_len
        for j in range(W):
            row = base + j
            q_req_idx[row] = i
            if j < len(window):
                input_ids[row] = window[j]
                pos = start_pos + j
            else:
                input_ids[row] = 0
                pos = start_pos + len(window) - 1  # harmless duplicate pos
            q_pos[row] = pos
            out_slots[row] = (
                r.pages[pos // page_size] * page_size + pos % page_size
                if j < len(window) else 0  # dump page
            )
        kv_lens[i] = start_pos + len(window)
        q_start[i] = start_pos
        drafts_padded[i, : len(d)] = d
        draft_lens[i] = len(d)

    hb = HostBatch(
        mode=ForwardMode.EXTEND, reqs=list(reqs),
        extend_lens=[W] * len(reqs),
        input_ids=input_ids, q_req_idx=q_req_idx, q_pos=q_pos,
        out_slots=out_slots,
        page_table=_page_table_block(reqs, B, maxP, page_table_host),
        kv_lens=kv_lens, logits_idx=logits_idx,
        sampling=_sampling_arrays_np(reqs, B), T=T, B=B, maxP=maxP, q_start=q_start,
    )
    return hb, drafts_padded, draft_lens


def build_tree_verify_batch(
    reqs: List[Req],
    tree,  # speculative.tree.TreeTemplate
    page_table_host: np.ndarray,
    page_size: int,
    b_buckets: Sequence[int],
    p_buckets: Sequence[int],
) -> HostBatch:
    """EAGLE-tree verify batch: every request contributes N rows, one per
    tree node in BFS order. Node i occupies KV slot (kv_len + i) but its
    ROPE position is (kv_len + depth(i)): q_pos carries rope, mask_pos the
    slot order, win_base the window start; the work list's q_start (kv_lens
    - N = kv_len) is the slot-order start the kernels' causal test compares.
    Pages covering kv_len + N positions must already be allocated.
    input_ids row 0 holds the last committed token; the other rows are
    substituted by the round's draft phase (speculative/eagle.py
    eagle_tree_round)."""
    N = tree.num_nodes
    B = bucket_of(len(reqs), b_buckets)
    T = B * N
    need_pages = max(
        (r.kv_len + N + page_size - 1) // page_size + 1 for r in reqs
    )
    maxP = bucket_of(need_pages, p_buckets)

    input_ids = np.zeros(T, np.int32)
    q_req_idx = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    mask_pos = np.zeros(T, np.int32)
    out_slots = np.zeros(T, np.int32)
    kv_lens = np.zeros(B, np.int32)
    win_base = np.zeros(B, np.int32)
    logits_idx = np.arange(T, dtype=np.int32)

    for i, r in enumerate(reqs):
        rbase = i * N
        start = r.kv_len
        input_ids[rbase] = r.output_ids[-1] if r.output_ids else r.input_ids[-1]
        for j in range(N):
            row = rbase + j
            q_req_idx[row] = i
            q_pos[row] = start + int(tree.depths[j])
            mask_pos[row] = start + j
            pos = start + j
            out_slots[row] = (
                r.pages[pos // page_size] * page_size + pos % page_size
            )
        kv_lens[i] = start + N
        win_base[i] = start

    return HostBatch(
        mode=ForwardMode.EXTEND, reqs=list(reqs),
        extend_lens=[N] * len(reqs),
        input_ids=input_ids, q_req_idx=q_req_idx, q_pos=q_pos,
        out_slots=out_slots,
        page_table=_page_table_block(reqs, B, maxP, page_table_host),
        kv_lens=kv_lens, logits_idx=logits_idx,
        sampling=_sampling_arrays_np(reqs, B), T=T, B=B, maxP=maxP,
        mask_pos=mask_pos, win_base=win_base,
    )
