"""Device-side batch representation (port of
semi_pd_tpu/runtime/forward_batch.py).

One ragged layout serves both phases: query tokens of all requests
concatenated to a flat, bucket-padded [T]; per-token arrays map tokens to
requests and absolute positions. A decode batch is the special case
T == B with one token per request.

The extend work list (``make_attn_meta_host`` / ``num_q_blocks``, moved
here from the JAX package's ``rpa_common.py``) is built with
``EXTEND_Q_BLOCK``, the constant the extend kernels are compiled with, so
the list and the kernels cannot disagree on the block height.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from semi_pd_tpu_torch.ops.attention.ragged_paged_attention import EXTEND_Q_BLOCK
from semi_pd_tpu_torch.ops.sampling import SamplingArrays


class ForwardMode(enum.Enum):
    EXTEND = "extend"  # prefill / chunked prefill continuation
    DECODE = "decode"


class AttnMeta(NamedTuple):
    """Ragged-attention metadata (int32 tensors). q_lens/q_start: per
    sequence [B] — new (query) tokens and the absolute position of the first
    one. block_*: the query-block work list [NQB] (padded with seq -1)."""

    q_lens: torch.Tensor
    q_start: torch.Tensor
    block_seq: torch.Tensor
    block_row: torch.Tensor
    block_qofs: torch.Tensor


class ForwardArrays(NamedTuple):
    """Everything one step needs, as tensors on the step's device.

    Padding convention: padded token rows have q_req_idx 0 and q_pos 0
    (outputs ignored) and out_slots inside the dump page (page 0), so the KV
    scatter is harmless. Padded batch rows have kv_lens 0.
    """

    input_ids: torch.Tensor  # [T] i32
    q_req_idx: torch.Tensor  # [T] i32 — batch row of each token
    q_pos: torch.Tensor  # [T] i32 — absolute position in its request
    out_slots: torch.Tensor  # [T] i32 — KV slot this token's K/V is written to
    page_table: torch.Tensor  # [B, maxP] i32
    kv_lens: torch.Tensor  # [B] i32 — total kv length incl. this step's tokens
    logits_idx: torch.Tensor  # [B] i32 — index into [T] of each request's last token
    sampling: SamplingArrays  # per-request [B]
    num_reqs: int  # actual (unpadded) request count
    attn_meta: AttnMeta  # extend work list
    all_greedy: bool = False  # every live row samples greedily (host-known)
    # [L, 2] f32 per-layer fp8-KV (k_scale, v_scale), stamped by the runner
    # when it loaded a scales file (layers/attention.py applies them)
    kv_scales: Optional[torch.Tensor] = None
    # Speculation-tree batches (speculative/tree.py): slot-order positions
    # (q_pos keeps the ROPE position, base + depth; the work list's q_start
    # is the slot-order start) and the window start per request; spec_anc,
    # the tree's static ancestor masks, is carried here in place of the JAX
    # layer's spec_tree_context global. None outside tree rounds.
    mask_pos: Optional[torch.Tensor] = None  # [T] i32
    win_base: Optional[torch.Tensor] = None  # [B] i32
    spec_anc: Optional[tuple] = None  # [W] python ints
    # The image path (the JAX embed_override / embed_mask / mrope_pos): the
    # flat rows whose embedding is replaced, and their rows (image features
    # or input_embeds, on the device, cast to the model dtype at the
    # splice); Qwen2-VL's (t, h, w) rope positions. None outside it.
    embed_rows: Optional[torch.Tensor] = None  # [n] i64
    embed_vals: Optional[torch.Tensor] = None  # [n, H]
    mrope_pos: Optional[torch.Tensor] = None  # [T, 3] i32


def num_q_blocks(T: int, B: int) -> int:
    """Static upper bound on work-list length: every sequence contributes at
    most one partial block; full blocks are bounded by T // EXTEND_Q_BLOCK."""
    qb = EXTEND_Q_BLOCK
    return min(T // qb + B, (T + qb - 1) // qb + B)


def make_attn_meta_host(q_lens: np.ndarray, T: int):
    """Build the work list on the host (numpy), in blocks of EXTEND_Q_BLOCK
    rows. Returns (block_seq, block_row, block_qofs) padded to
    ``num_q_blocks(T, B)``."""
    B = len(q_lens)
    nqb = num_q_blocks(T, B)
    block_seq = np.full(nqb, -1, np.int32)
    block_row = np.zeros(nqb, np.int32)
    block_qofs = np.zeros(nqb, np.int32)
    i = 0
    row = 0
    for b in range(B):
        n = int(q_lens[b])
        for ofs in range(0, n, EXTEND_Q_BLOCK):
            block_seq[i] = b
            block_row[i] = row + ofs
            block_qofs[i] = ofs
            i += 1
        row += n
    return block_seq, block_row, block_qofs


def build_attn_meta(q_lens_np: np.ndarray, kv_lens_np: np.ndarray, T: int,
                    device="cpu", q_start_np: Optional[np.ndarray] = None) -> AttnMeta:
    """Numpy -> AttnMeta on ``device``. ``q_start_np`` defaults to kv_lens -
    q_lens: a sequence's query rows are its last positions."""
    bs, br, bq = make_attn_meta_host(q_lens_np, T)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    if q_start_np is None:
        q_start_np = np.asarray(kv_lens_np) - np.asarray(q_lens_np)
    return AttnMeta(
        q_lens=t(q_lens_np),
        q_start=t(q_start_np),
        block_seq=t(bs), block_row=t(br), block_qofs=t(bq),
    )
