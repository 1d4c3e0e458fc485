"""EAGLE speculative decoding: the draft model, chain rounds and tree rounds
(port of semi_pd_tpu/speculative/eagle.py).

A round, as the JAX package's fused program computes it:

  1. draft: the one-layer draft runs gamma times (chain; greedy, each
     step's token and hidden feeding the next) or level by level over a
     static token tree (``eagle_tree_round``), writing the draft KV pool;
  2. target verify over the [B * (gamma + 1)] window (the tree's B * N
     nodes) with the drafted tokens substituted;
  3. acceptance (runtime/speculative.py verify_and_accept; greedy over the
     tree) and the target hidden state at the accepted row, which seeds
     the next round's draft;
  4. with ``refresh``, the accepted rows of the draft KV rewritten from the
     target's hidden states (the reference's draft-extend after decode).

The JAX round is one jitted program; here the runner replays a round from
a CUDA graph per round key (runtime/cuda_graph_runner.py ``RoundGraphs``),
so both rounds hold to what a capture needs: no host sync and no shape
that depends on data (the tree's levels are static, its tables
``device_tables`` made before any round, the compaction an index copy,
each acceptance a device op). The rounds take any draft with ``step`` and ``pre_head`` (``DraftModel``): the llama
EAGLE draft below, or DeepSeek's NextN (speculative/nextn.py). Which
kernel each step takes on the card: the verify goes to the target pool's
extend (with the tree's ``spec_anc`` for a tree, and unmasked for a
chain); the draft pool is one layer of the target's slot space:
- EAGLE (every target but DeepSeek's): the 5D layout at the target's
  head_dim, so a chain draft or refresh step (decode-shaped) takes the
  pool's packed decode and a tree draft step (decode-shaped, with
  ``spec_anc``) its extend: ``rpa_decode_merged`` / ``rpa_extend_merged``
  at head_dim 64, ``rpa_decode_aligned_256`` / ``rpa_extend_aligned_256``
  at Gemma-2's 256;
- NextN (a DeepSeek target, MiniCPM3 included): the latent layout ``[1,
  1, S, 1, Dlat]``, so a chain draft or refresh step takes the latent
  decode of the pool's width (``rpa_decode_mla``, ``rpa_decode_mla_288``)
  and a tree draft step its extend with the tree's masks, as the target's
  tree verify does.

Unified storage extends to the draft: the draft pool uses the SAME slot
space and page table as the target pool, so allocation, retraction and
radix bookkeeping stay single-owner.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol

import numpy as np
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.layers.attention import paged_attention
from semi_pd_tpu_torch.layers.linear import apply_linear
from semi_pd_tpu_torch.models.llama import DTYPES
from semi_pd_tpu_torch.models.params import TreeParams
from semi_pd_tpu_torch.ops.elementwise import rms_norm, silu_and_mul
from semi_pd_tpu_torch.ops.rope import RotaryEmbedding
from semi_pd_tpu_torch.runtime.forward_batch import AttnMeta, ForwardArrays
from semi_pd_tpu_torch.runtime.speculative import verify_and_accept


class DraftModel(Protocol):
    """What the rounds need of a draft: one step over its pool, and the
    map from its hidden state to the shared lm_head's input."""

    def step(self, tok_embed, hidden_feed, draft_kv, positions, out_slots, page_table,
             kv_lens, attn_meta, mask_positions=None, win_base=None, spec_anc=None,
             attention=None) -> torch.Tensor: ...

    def pre_head(self, h: torch.Tensor) -> torch.Tensor: ...


class EagleDraftModel(TreeParams):
    """One llama decoder layer + fc([embed; hidden] -> hidden). Shares the
    target's embedding and lm_head. Its leaves are the JAX draft's
    parameter tree (``init_params(seed)`` draws the JAX numbers; the
    runners seed it with the server seed + 1). It is the same plain llama
    layer for every target, as in JAX: on a Gemma-2 target it takes the
    target's widths (head_dim 256, its intermediate size) with a SiLU MLP,
    plain RMSNorms, the scale ``head_dim ** -0.5``, no softcap and no
    window, the raw (unscaled) embedding rows and the tied head, and no
    final softcap on its logits."""

    def __init__(self, config: ModelConfig, device):
        super().__init__()
        c = self.config = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.q_size = self.num_heads * self.head_dim
        self.kv_size = self.num_kv_heads * self.head_dim
        self.scale = self.head_dim ** -0.5
        self.dtype = DTYPES[c.dtype]
        self.rope = RotaryEmbedding(
            head_dim=self.head_dim, max_position=c.context_length,
            theta=c.rope_theta, rope_scaling=c.rope_scaling,
        ).to(device)
        self.page_size = 16  # set by the runner: a property of the pool
        for path, shape in self.param_specs():
            setattr(self, path.split(".")[0], torch.nn.Parameter(
                torch.zeros(shape, dtype=self.dtype, device=device), requires_grad=False))

    def param_specs(self):
        """(JAX tree path, shape) of every leaf, in jax.tree order (sorted
        dict keys)."""
        c = self.config
        H, I = c.hidden_size, c.intermediate_size
        return [
            ("down.w", (I, H)),
            ("fc.w", (2 * H, H)),
            ("gate_up.w", (H, 2 * I)),
            ("input_norm", (H,)),
            ("o_proj.w", (self.q_size, H)),
            ("post_norm", (H,)),
            ("qkv_proj.w", (H, self.q_size + 2 * self.kv_size)),
        ]

    def leaf(self, path: str) -> torch.nn.Parameter:
        return getattr(self, path.split(".")[0])

    def step(
        self,
        tok_embed: torch.Tensor,  # [B, H] embedding of the input token
        hidden_feed: torch.Tensor,  # [B, H] previous hidden (target or draft)
        draft_kv: torch.Tensor,  # [1, 2, S, Hkv, D], updated in place
        positions: torch.Tensor,  # [B] ROPE position being written
        out_slots: torch.Tensor,  # [B] slot of this position
        page_table: torch.Tensor,
        kv_lens: torch.Tensor,  # [B] = mask position + 1
        attn_meta: AttnMeta,
        mask_positions: Optional[torch.Tensor] = None,  # [B] slot-order positions
        win_base: Optional[torch.Tensor] = None,  # [B] tree window start
        spec_anc: Optional[tuple] = None,  # the tree's ancestor masks
        attention=None,  # routing over the draft pool (default: its kernels)
    ) -> torch.Tensor:
        """One draft decode step. Returns the hidden state [B, H]."""
        c = self.config
        B = tok_embed.shape[0]
        x = apply_linear(torch.cat([tok_embed, hidden_feed.to(tok_embed.dtype)], -1), self.fc)
        attn_in = rms_norm(x, self.input_norm, c.rms_norm_eps)
        qkv = apply_linear(attn_in, self.qkv_proj)
        q, k, v = qkv.split([self.q_size, self.kv_size, self.kv_size], dim=-1)
        q = q.reshape(B, self.num_heads, self.head_dim)
        k = k.reshape(B, self.num_kv_heads, self.head_dim)
        v = v.reshape(B, self.num_kv_heads, self.head_dim)
        q, k = self.rope(positions, q, k)
        i32 = dict(dtype=torch.int32, device=tok_embed.device)
        fb_like = ForwardArrays(
            input_ids=torch.zeros(B, **i32), q_req_idx=torch.arange(B, **i32),
            q_pos=positions, out_slots=out_slots, page_table=page_table, kv_lens=kv_lens,
            logits_idx=torch.arange(B, **i32), sampling=None, num_reqs=B,
            attn_meta=attn_meta, mask_pos=mask_positions, win_base=win_base,
            spec_anc=spec_anc,
        )
        attn = paged_attention(q, k, v, draft_kv, 0, fb_like, page_size=self.page_size,
                               scale=self.scale, attention=attention)
        h = x + apply_linear(attn.reshape(B, self.q_size), self.o_proj)
        y = rms_norm(h, self.post_norm, c.rms_norm_eps)
        return h + apply_linear(silu_and_mul(apply_linear(y, self.gate_up)), self.down)

    def pre_head(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden -> lm_head input (identity: the EAGLE llama draft feeds the
        shared head directly)."""
        return h


def load_token_map(path: str) -> np.ndarray:
    """FR-Spec hot-token map: a list of token ids in a .json, .npy or
    torch-saved file. Returns int32 [Vh]."""
    if path.endswith(".json"):
        import json

        with open(path) as f:
            ids = json.load(f)
    elif path.endswith(".npy"):
        ids = np.load(path)
    else:
        ids = torch.load(path, map_location="cpu", weights_only=True)
        ids = ids.tolist() if hasattr(ids, "tolist") else ids
    return np.asarray(ids, dtype=np.int32)


def _hot_head(head: torch.Tensor, hot_ids: torch.Tensor) -> torch.Tensor:
    """The lm_head [H, V] sliced to the hot vocabulary [H, Vh]: the draft's
    head product shrinks, and its argmax / top-k indices map back through
    ``hot_ids``."""
    return head.index_select(1, hot_ids.long()).contiguous()


class RoundResult(NamedTuple):
    """What a round gives the runner: accept_len [B] i32, next_tok [B] i32,
    tokens [B, gamma] (the chain's drafts; a tree's accepted path tokens
    [B, depth]), next_hidden [B, H], and what its verify saw: the window's
    tokens [B, W] (W = gamma + 1, or the tree's N nodes) and the float32
    logits [B * W, V]."""

    accept_len: torch.Tensor
    next_tok: torch.Tensor
    tokens: torch.Tensor
    next_hidden: torch.Tensor
    window: torch.Tensor
    logits: torch.Tensor


def _draft_head(target, hot_ids, hot_head):
    head = target.head()
    if hot_ids is None:
        return head, None
    return (hot_head if hot_head is not None else _hot_head(head, hot_ids)), hot_ids.long()


def _decode_meta(q_start: torch.Tensor) -> AttnMeta:
    """A decode-shaped work list (one row per request) at positions
    ``q_start``."""
    n = q_start.shape[0]
    i32 = dict(dtype=torch.int32, device=q_start.device)
    return AttnMeta(q_lens=torch.ones(n, **i32), q_start=q_start.to(torch.int32),
                    block_seq=torch.arange(n, **i32), block_row=torch.arange(n, **i32),
                    block_qofs=torch.zeros(n, **i32))


@torch.inference_mode()
def eagle_round(
    target,
    draft: DraftModel,
    kv: torch.Tensor,  # the target pool, updated in place
    draft_kv: torch.Tensor,  # the one-layer draft pool, updated in place
    fb: ForwardArrays,  # spec-verify batch (B*(gamma+1) rows; input_ids row 0 = last token)
    prev_hidden: torch.Tensor,  # [B, H] target hidden seeding the draft
    gamma: int,
    generator: torch.Generator,
    refresh: bool = True,
    threshold_single: float = 1.0,
    threshold_acc: float = 1.0,
    hot_ids: Optional[torch.Tensor] = None,  # [Vh] FR-Spec hot vocab
    hot_head: Optional[torch.Tensor] = None,  # pre-sliced hot lm_head
    attention=None,  # the target pool's routing (default: its kernels)
    draft_attention=None,  # the draft pool's routing (default: its kernels)
) -> RoundResult:
    """The EAGLE chain round. ``refresh``: after the verify, rewrite window
    rows 1..gamma of the draft KV from the TARGET hidden of the previous
    row (the drafts used draft hiddens); rows past accept_len land beyond
    kv_len and are never attended, so all of them are rewritten."""
    B = fb.page_table.shape[0]
    W = gamma + 1
    embed = target.embed
    draft_head, hot_map = _draft_head(target, hot_ids, hot_head)

    win_slots = fb.out_slots.reshape(B, W)
    win_pos = fb.q_pos.reshape(B, W)
    base_kv = fb.kv_lens - W + 1  # kv length as of the window's first row
    window = fb.input_ids.reshape(B, W).clone()
    tok, hfeed = window[:, 0], prev_hidden
    for j in range(gamma):
        positions = win_pos[:, 0] + j  # the draft for position j+1 is written at row j's pos
        h = draft.step(embed[tok.long()], hfeed, draft_kv, positions, win_slots[:, j],
                       fb.page_table, positions + 1, _decode_meta(positions),
                       attention=draft_attention)
        logits = apply_linear(draft.pre_head(h), draft_head).float()
        nxt = torch.argmax(logits, -1)
        if hot_map is not None:
            nxt = hot_map[nxt]  # hot-vocab index -> real token id
        tok, hfeed = nxt.to(torch.int32), h
        window[:, j + 1] = tok
    drafts = window[:, 1:]

    # target verify with the drafts substituted in
    fb = fb._replace(input_ids=window.reshape(B * W))
    logits, hidden = target(fb, kv, attention=attention, return_hidden=True)
    draft_lens = torch.clamp(fb.kv_lens - base_kv, 0, gamma)  # gamma for real rows
    accept_len, next_tok = verify_and_accept(
        logits, drafts, draft_lens, fb.sampling, generator, gamma,
        threshold_single=threshold_single, threshold_acc=threshold_acc)
    h_rows = hidden.reshape(B, W, -1)
    ar = torch.arange(B, device=h_rows.device)
    next_hidden = h_rows[ar, accept_len.long()]

    if refresh:
        for j in range(1, gamma + 1):
            positions = win_pos[:, 0] + j
            draft.step(embed[window[:, j].long()], h_rows[:, j - 1].to(prev_hidden.dtype),
                       draft_kv, positions, win_slots[:, j], fb.page_table, positions + 1,
                       _decode_meta(positions), attention=draft_attention)
    return RoundResult(accept_len, next_tok, drafts, next_hidden, window, logits)


@torch.inference_mode()
def eagle_tree_round(
    target,
    draft: DraftModel,
    kv: torch.Tensor,
    draft_kv: torch.Tensor,
    fb: ForwardArrays,  # tree-verify batch (B*N rows; runtime/batch.py build_tree_verify_batch)
    prev_hidden: torch.Tensor,  # [B, H]
    tree,  # speculative.tree.TreeTemplate
    refresh: bool = True,
    hot_ids: Optional[torch.Tensor] = None,
    hot_head: Optional[torch.Tensor] = None,
    attention=None,
    draft_attention=None,
) -> RoundResult:
    """The EAGLE top-k TREE round. Greedy acceptance only: the scheduler
    takes chain rounds when a running request samples.

      1. draft, level by level: the draft runs on every node of the level
         (B * n rows of q_len 1, the page table tiled n times, the tree's
         masks with each request's window), writing draft KV at the node's
         slot; the top-k of each node's logits gives its children's tokens
         by the template's ranks;
      2. the target verifies all B * N tree rows in ONE extend forward
         under the tree's masks;
      3. a node is accepted iff its parent is and its token equals the
         target's argmax at the parent; the deepest accepted node wins (the
         first in BFS order among equals), and the bonus token is the
         target's argmax there;
      4. both pools copy the accepted path's rows into slot order
         [base+1 .. base+accept_len] (tree slots are BFS order, not path
         order); with ``refresh`` the path's draft rows are rewritten from
         the target's hidden states, outside the tree's masks."""
    N = tree.num_nodes
    B = fb.page_table.shape[0]
    embed = target.embed
    draft_head, hot_map = _draft_head(target, hot_ids, hot_head)
    anc = tuple(int(a) for a in tree.anc_bits)
    dev = fb.page_table.device

    win_slots = fb.out_slots.reshape(B, N)
    rope_pos = fb.q_pos.reshape(B, N)  # base + depth(node)
    mask_pos = fb.mask_pos.reshape(B, N)  # base + node
    base = mask_pos[:, 0].contiguous()  # window start per request

    node_tokens = {0: fb.input_ids.reshape(B, N)[:, 0]}
    node_hidden = {}
    # ---- 1. draft, level by level
    for d, level in enumerate(tree.level_nodes):
        n = len(level)
        toks = torch.cat([node_tokens[j] for j in level])  # [B n]
        hfeed = (prev_hidden if d == 0
                 else torch.cat([node_hidden[int(tree.parents[j])] for j in level]))
        slots = torch.cat([win_slots[:, j] for j in level])
        rpos = torch.cat([rope_pos[:, j] for j in level])
        mpos = torch.cat([mask_pos[:, j] for j in level]).contiguous()
        h = draft.step(embed[toks.long()], hfeed, draft_kv, rpos, slots,
                       fb.page_table.repeat(n, 1), mpos + 1, _decode_meta(mpos),
                       mask_positions=mpos, win_base=base.repeat(n), spec_anc=anc,
                       attention=draft_attention)
        for li, j in enumerate(level):
            node_hidden[j] = h[li * B : (li + 1) * B]
        if d < tree.depth:
            logits = apply_linear(draft.pre_head(h), draft_head).float()  # [B n, V or Vh]
            topk_idx = torch.topk(logits, tree.branching[d], dim=-1).indices
            if hot_map is not None:
                topk_idx = hot_map[topk_idx]  # -> real ids
            for li, j in enumerate(level):
                rows = topk_idx[li * B : (li + 1) * B]  # [B, k_d]
                for child in range(N):
                    if tree.parents[child] == j:
                        node_tokens[child] = rows[:, int(tree.ranks[child])].to(torch.int32)

    # ---- 2. target verify over the whole tree
    window = torch.stack([node_tokens[i] for i in range(N)], dim=1)  # [B, N]
    fb = fb._replace(input_ids=window.reshape(B * N), spec_anc=anc)
    logits, hidden = target(fb, kv, attention=attention, return_hidden=True)

    # ---- 3. greedy acceptance over the tree
    g = torch.argmax(logits.reshape(B, N, -1).float(), dim=-1).to(torch.int32)  # [B, N]
    acc = [torch.ones(B, dtype=torch.bool, device=dev)]
    for j in range(1, N):
        p = int(tree.parents[j])
        acc.append(acc[p] & (window[:, j] == g[:, p]))
    acc = torch.stack(acc, dim=1)  # [B, N]
    depths, anc_at_depth = tree.device_tables(dev)
    score = torch.where(acc, depths[None, :], torch.full_like(acc, -1, dtype=torch.int64))
    best = torch.argmax(score, dim=1)  # the first deepest accepted
    ar = torch.arange(B, device=dev)
    accept_len = torch.clamp(score[ar, best], min=0).to(torch.int32)
    next_tok = g[ar, best]

    # the accepted path: the ancestor of `best` at each depth
    path_nodes = anc_at_depth[best]  # [B, D+1]; column 0 = root
    path_tokens = window.gather(1, path_nodes[:, 1:])

    # ---- 4. KV compaction: path node -> slot order (both pools)
    D_ = tree.depth
    d_idx = torch.arange(1, D_ + 1, device=dev)[None, :].expand(B, D_)  # [B, D]
    on_path = d_idx <= accept_len[:, None]
    src_nodes = torch.where(on_path, path_nodes[:, 1:], d_idx)  # a no-op off the path
    src = win_slots.gather(1, src_nodes).reshape(-1).long()
    dst = win_slots[:, 1 : D_ + 1].reshape(-1).long()
    _compact_slots(kv, src, dst)
    _compact_slots(draft_kv, src, dst)

    h_rows = hidden.reshape(B, N, -1)
    next_hidden = h_rows[ar, best]

    if refresh:
        path_slots = win_slots[:, 1 : D_ + 1]
        for d in range(1, D_ + 1):
            pos = rope_pos[:, 0] + d
            draft.step(embed[path_tokens[:, d - 1].long()],
                       h_rows[ar, path_nodes[:, d - 1]].to(prev_hidden.dtype), draft_kv,
                       pos, path_slots[:, d - 1], fb.page_table, pos + 1, _decode_meta(pos),
                       attention=draft_attention)
    return RoundResult(accept_len, next_tok, path_tokens, next_hidden, window, logits)


def _compact_slots(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy KV rows src -> dst on the slot axis, in place (every source row
    read before any is written). Pool layouts: 5D [L, C, S, H, D] (slot axis
    2; the latent pool [L, 1, S, 1, Dlat] among them) or the chunked
    [L, S, CT, 128] (axis 1)."""
    if pool.dim() == 5:
        pool[:, :, dst] = pool[:, :, src]
    else:
        pool[:, dst] = pool[:, src]
