"""The speculation-tree mask (``spec_anc`` / ``win_base``) of the port's
extend kernels, against the JAX package on the CPU with the same numpy
inputs:

- the tree templates (speculative/tree.py), field for field, over a grid of
  branchings and of (topk, gamma);
- the plain masked extend (what ``rpa_extend``, ``rpa_extend_aligned`` and
  ``rpa_extend_merged`` are held to on the card) against the TPU kernels in
  interpret mode: _rpa_kernel_chunked (the chunked pool), _rpa_kernel_merged
  (``force_merged``: the 5D pool at head_dim 64, Hkv 2, 4 and 8) and
  _rpa_kernel's GQA branch (head_dim 128), on a tree verify (N rows per
  request, windows crossing pages, shuffled pages) and a tree draft step
  (decode-shaped: B * n rows of q_len 1, the page table tiled), float32 and
  bf16; the port's pool has NaN in every slot no live position holds (C2);
- the routing: a decode-shaped batch with ``spec_anc`` takes the extend,
  never the packed or the streaming decode; the MLA pool refuses an
  ill-formed tree and takes a well-formed one;
- the reference attention against the JAX reference with slot-order
  positions;
- the warpgroup kernel's per-tile mask decision, replayed: a tile it leaves
  unmasked is visible whole to every row of the warp under the tree.

Tolerances: float32 2e-5 (both sides in float32: an online softmax against
a full one); bf16 1e-2 (both compute in float32 from the same bf16 inputs
and round the output to bf16, whose step is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_pd_tpu.ops.attention.ragged_paged_attention import AttnMeta as JaxMeta
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention_chunked as jax_chunked,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.speculative import tree as jax_tree

from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_common
from semi_pd_tpu_torch.ops.attention.reference import ragged_paged_attention_reference
from semi_pd_tpu_torch.runtime.forward_batch import AttnMeta, build_attn_meta
from semi_pd_tpu_torch.speculative import tree as port_tree

PS, L = 16, 2
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TREE = jax_tree.default_tree_template(4, 4)  # branching (4, 2, 1, 1), 29 nodes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast alone and
    keeps the many small ops from stalling when the test workers share the
    CPU (8 threads each ran them up to 10x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- templates
def _fields(t):
    return dict(branching=t.branching, parents=t.parents.tolist(),
                depths=t.depths.tolist(), ranks=t.ranks.tolist(), anc_bits=t.anc_bits,
                anc_at_depth=t.anc_at_depth.tolist(), level_nodes=t.level_nodes,
                num_nodes=t.num_nodes, depth=t.depth)


@pytest.mark.parametrize("branching", [(1,), (3,), (2, 2), (3, 2), (4, 2, 1, 1), (1, 1, 1),
                                       (5, 1, 1, 1, 1), (2, 2, 2, 1)])
def test_tree_template_matches_jax(branching):
    assert _fields(port_tree.build_tree_template(branching)) == \
        _fields(jax_tree.build_tree_template(branching))


@pytest.mark.parametrize("topk,gamma", [(1, 1), (1, 4), (2, 3), (3, 3), (4, 4), (8, 6),
                                        (16, 2), (4, 8)])
def test_default_tree_template_matches_jax(topk, gamma):
    t = port_tree.default_tree_template(topk, gamma)
    assert _fields(t) == _fields(jax_tree.default_tree_template(topk, gamma))
    assert t.num_nodes <= port_tree.MAX_TREE_NODES
    # every node sees itself and the root: the checks the wrappers make
    rpa_common.check_spec(t.anc_bits, torch.zeros(1, dtype=torch.int32), 1)
    assert t == port_tree.default_tree_template(topk, gamma)


def test_tree_cap_and_spec_checks():
    with pytest.raises(AssertionError, match="cap"):
        port_tree.build_tree_template((4, 4, 4))
    wb = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        rpa_common.check_spec(TREE.anc_bits, None, 2)
    with pytest.raises(ValueError, match="1 to 31"):
        rpa_common.check_spec(tuple(range(1, 40)), wb, 2)
    with pytest.raises(ValueError, match="bit 1"):
        rpa_common.check_spec((1, 1), wb, 2)  # node 1 must see itself
    with pytest.raises(ValueError, match="int32"):
        rpa_common.check_spec(TREE.anc_bits, wb.long(), 2)


# ----------------------------------------------------------------- kernels
def _pages(rng, lens):
    """A shuffled page table for requests of ``lens`` positions (page 0 is
    the dump page) and the pool's slot count."""
    n_pages = [-(-k // PS) + 1 for k in lens]
    total = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((len(lens), max(n_pages)), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    return pt, total * PS


def _tree_case(seed, prefix, hq, hkv, d, layout, draft_level=None, dtype="float32"):
    """A tree round's attention inputs: requests with ``prefix`` committed
    positions, each followed by the window of TREE's N nodes (slot-order
    positions prefix + j). Without ``draft_level``: the verify (N rows per
    request, q_start = prefix). With it: that level's draft step, B * n rows
    of q_len 1 (the page table tiled n times, kv_len = slot + 1). Returns
    both sides' inputs and the set of live slots."""
    rng = np.random.default_rng(seed)
    N = TREE.num_nodes
    B = len(prefix)
    pt, S = _pages(rng, [p + N for p in prefix])
    if layout == "chunked":
        pool = rng.normal(size=(L, S, 2 * hkv * d // 128, 128)).astype(np.float32)
    else:
        pool = rng.normal(size=(L, 2, S, hkv, d)).astype(np.float32)
    live = set()
    for b, p in enumerate(prefix):
        for pos in range(p + N):
            live.add(int(pt[b, pos // PS]) * PS + pos % PS)
    win_base = np.asarray(prefix, np.int32)
    if draft_level is None:
        q_lens = np.full(B, N, np.int64)
        kv_lens = np.asarray(prefix, np.int64) + N
        T = B * N
        jm = jax_meta(q_lens, kv_lens, T)
        pm = build_attn_meta(q_lens, kv_lens, T)
        table, wb = pt, win_base
    else:
        level = TREE.level_nodes[draft_level]
        n = len(level)
        mpos = np.concatenate([np.asarray(prefix) + j for j in level]).astype(np.int32)
        T = B * n
        ar = np.arange(T, dtype=np.int32)
        kv_lens = mpos.astype(np.int64) + 1
        jm = JaxMeta(q_lens=jnp.ones(T, jnp.int32), q_start=jnp.asarray(mpos),
                     block_seq=jnp.asarray(ar), block_row=jnp.asarray(ar),
                     block_qofs=jnp.zeros(T, jnp.int32))
        one = torch.ones(T, dtype=torch.int32)
        pm = AttnMeta(q_lens=one, q_start=torch.from_numpy(mpos), block_seq=torch.from_numpy(ar),
                      block_row=torch.from_numpy(ar), block_qofs=torch.zeros(T, dtype=torch.int32))
        table, wb = np.tile(pt, (n, 1)), np.tile(win_base, n)
    q = rng.normal(size=(T, hq, d)).astype(np.float32)
    # the port's pool: NaN in every slot no live position holds
    port_pool = pool.copy()
    dead = np.ones(S, bool)
    dead[sorted(live)] = False
    if layout == "chunked":
        port_pool[:, dead] = np.nan
    else:
        port_pool[:, :, dead] = np.nan
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return dict(
        jq=jnp.asarray(q, jdt), jpool=jnp.asarray(pool, jdt),
        tq=torch.from_numpy(q).to(tdt), tpool=torch.from_numpy(port_pool).to(tdt),
        pt=table, kv_lens=kv_lens.astype(np.int32), win_base=wb.astype(np.int32),
        jmeta=jm, pmeta=pm, T=T)


def _jax(c, layout, hkv, d, anc=TREE.anc_bits):
    kw = dict(page_size=PS, scale=d ** -0.5, interpret=True, spec_anc=anc,
              win_base=jnp.asarray(c["win_base"]))
    args = (c["jq"], c["jpool"], 1, jnp.asarray(c["pt"]), jnp.asarray(c["kv_lens"]), c["jmeta"])
    if layout == "chunked":
        out = jax_chunked(*args, num_kv_heads=hkv, head_dim=d, **kw)
    else:
        out = jax_rpa(*args, force_merged=d == 64, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(c, layout, hkv, d, anc=TREE.anc_bits):
    kw = dict(page_size=PS, scale=d ** -0.5, spec_anc=anc,
              win_base=torch.from_numpy(c["win_base"]))
    args = (c["tq"], c["tpool"], 1, torch.from_numpy(c["pt"]), torch.from_numpy(c["kv_lens"]),
            c["pmeta"])
    if layout == "chunked":
        out = rpa.ragged_paged_attention_chunked(*args, num_kv_heads=hkv, head_dim=d, **kw)
    else:
        out = rpa.ragged_paged_attention(*args, **kw)
    return out.float().numpy()


# (layout, Hq, Hkv, D, prefix lengths, draft level, dtype): prefixes put the
# windows across page boundaries (a window of 29 from 40 covers pages 2-4)
MASK_CASES = {
    "chunked_verify": ("chunked", 16, 8, 64, [40, 17, 3], None, "float32"),
    "chunked_verify_bf16": ("chunked", 16, 8, 64, [40, 17, 3], None, "bfloat16"),
    "chunked_draft_level2": ("chunked", 16, 8, 64, [40, 17, 3], 2, "float32"),
    "merged_hkv2_verify": ("aligned", 16, 2, 64, [40, 17, 3], None, "float32"),
    "merged_hkv4_verify": ("aligned", 16, 4, 64, [23, 50], None, "float32"),
    # Hkv 8: the draft pool's; its G 4 (Hq 32) on the draft step, G 2 elsewhere
    "merged_hkv8_verify": ("aligned", 16, 8, 64, [23, 50], None, "float32"),
    "merged_hkv8_draft_level1": ("aligned", 32, 8, 64, [23, 50], 1, "float32"),
    "merged_hkv8_draft_level4_bf16": ("aligned", 16, 8, 64, [23, 50], 4, "bfloat16"),
    "aligned_d128_verify": ("aligned", 8, 2, 128, [40, 17, 3], None, "float32"),
    "aligned_d128_draft_level2": ("aligned", 8, 2, 128, [40, 17], 2, "float32"),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_plain_masked_extend_matches_jax_kernel(case):
    layout, hq, hkv, d, prefix, level, dtype = MASK_CASES[case]
    c = _tree_case(7, prefix, hq, hkv, d, layout, level, dtype)
    want = _jax(c, layout, hkv, d)
    got = _port(c, layout, hkv, d)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    # the mask matters: a chain of the same window (every node sees all
    # before it) gives another answer
    chain = tuple((1 << (j + 1)) - 1 for j in range(TREE.num_nodes))
    other = _port(c, layout, hkv, d, anc=chain)
    assert np.abs(other - got).max() > 1e-3


def test_decode_shaped_tree_batch_takes_the_extend(monkeypatch):
    """A tree draft step (T == B with spec_anc) goes to the extend on every
    GQA pool, streaming or not; without the tree the same batch decodes."""
    def refuse(*a, **k):
        raise AssertionError("a tree batch reached a decode")

    for name in ("ragged_paged_attention_chunked_packed", "ragged_paged_attention_packed",
                 "ragged_paged_attention_chunked_stream", "ragged_paged_attention_stream"):
        monkeypatch.setattr(rpa, name, refuse)
    for layout, hq, hkv, d in (("chunked", 16, 8, 64), ("aligned", 32, 8, 64),
                               ("aligned", 8, 2, 128)):
        c = _tree_case(3, [23, 50], hq, hkv, d, layout, draft_level=1)
        kw = dict(page_size=PS, scale=d ** -0.5, spec_anc=TREE.anc_bits,
                  win_base=torch.from_numpy(c["win_base"]), stream=True)
        args = (c["tq"], c["tpool"], 1, torch.from_numpy(c["pt"]),
                torch.from_numpy(c["kv_lens"]), c["pmeta"])
        if layout == "chunked":
            out = rpa.ragged_paged_attention_chunked(*args, num_kv_heads=hkv, head_dim=d, **kw)
        else:
            out = rpa.ragged_paged_attention(*args, **kw)
        want = rpa.extend_attention_plain(
            *args, page_size=PS, num_kv_heads=hkv, head_dim=d, scale=d ** -0.5,
            spec_anc=TREE.anc_bits, win_base=torch.from_numpy(c["win_base"]))
        assert out.shape[0] == c["pt"].shape[0]  # decode-shaped
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        kw.pop("spec_anc"), kw.pop("win_base")
        with pytest.raises(AssertionError, match="reached a decode"):
            if layout == "chunked":
                rpa.ragged_paged_attention_chunked(*args, num_kv_heads=hkv, head_dim=d, **kw)
            else:
                rpa.ragged_paged_attention(*args, **kw)


def test_latent_pool_refuses_a_tree():
    """The latent pool refuses an ill-formed tree in its routing, its plain
    routing and its extend (spec_anc without win_base, more than 31 nodes,
    a node that does not see itself, win_base of another length) and takes
    a well-formed one: a decode-shaped batch with the tree goes to the MLA
    extend's plain version (NextN's tree draft step; the JAX reference is
    held to it in test_torch_nextn.py)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 16, 576)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(1, 1, 64, 1, 576)).astype(np.float32))
    pt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    kvl = torch.tensor([20, 9], dtype=torch.int32)
    meta = AttnMeta(q_lens=torch.ones(2, dtype=torch.int32),
                    q_start=torch.tensor([19, 8], dtype=torch.int32),
                    block_seq=torch.arange(2, dtype=torch.int32),
                    block_row=torch.arange(2, dtype=torch.int32),
                    block_qofs=torch.zeros(2, dtype=torch.int32))
    wb = torch.tensor([18, 7], dtype=torch.int32)
    kw = dict(page_size=PS, scale=0.1, v_dim=512)
    bad = [((1, 3), None, "together"), (tuple(range(1, 40)), wb, "1 to 31"),
           ((1, 1), wb, "bit 1"), ((1, 3), wb[:1], "int32")]
    fns = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_plain,
           rpa.ragged_paged_attention_extend)
    for fn in fns:
        for anc, base, msg in bad:
            with pytest.raises(ValueError, match=msg):
                fn(q, pool, 0, pt, kvl, meta, spec_anc=anc, win_base=base, **kw)
    # a two-node chain window at [18, 20) and [7, 9): each row's node 1 sees
    # its root and itself
    outs = [fn(q, pool, 0, pt, kvl, meta, spec_anc=(1, 3), win_base=wb, **kw) for fn in fns]
    want = rpa.extend_attention_plain(q, pool, 0, pt, kvl, meta, page_size=PS,
                                      num_kv_heads=1, head_dim=576, scale=0.1, v_dim=512,
                                      spec_anc=(1, 3), win_base=wb)
    for out in outs:
        assert out.shape == (2, 16, 512)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    # the mask matters: a node 1 that does not see its root sees another set
    other = rpa.ragged_paged_attention(q, pool, 0, pt, kvl, meta, spec_anc=(1, 2),
                                       win_base=wb, **kw)
    assert (other - want).abs().max() > 1e-3


@pytest.mark.parametrize("level", [None, 3])
def test_reference_matches_jax_reference(level):
    """The reference attention with slot-order positions (the JAX layer
    passes fb.mask_pos) and the tree, on the 5D pool."""
    c = _tree_case(11, [40, 17, 3], 8, 2, 64, "aligned", level)
    if level is None:
        B, N = 3, TREE.num_nodes
        qri = np.repeat(np.arange(B), N).astype(np.int32)
        mpos = (np.asarray([40, 17, 3])[:, None] + np.arange(N)[None]).reshape(-1)
    else:  # a draft step: row i is its own request row of the tiled table
        qri = np.arange(c["T"], dtype=np.int32)
        mpos = c["kv_lens"] - 1
    pool = np.array(c["jpool"])
    kw = dict(page_size=PS, scale=0.125, spec_anc=TREE.anc_bits)
    want = np.asarray(jax_reference(
        c["jq"], c["jpool"], 1, jnp.asarray(c["pt"]), jnp.asarray(qri),
        jnp.asarray(mpos.astype(np.int32)), jnp.asarray(c["kv_lens"]),
        win_base=jnp.asarray(c["win_base"]), **kw))
    got = ragged_paged_attention_reference(
        c["tq"], torch.from_numpy(pool), 1, torch.from_numpy(c["pt"]),
        torch.from_numpy(qri), torch.from_numpy(mpos.astype(np.int32)),
        torch.from_numpy(c["kv_lens"]), win_base=torch.from_numpy(c["win_base"]),
        **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    # and the plain extend agrees with the reference on the same rows
    plain = _port(c, "aligned", 2, 64)
    np.testing.assert_allclose(plain, got, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("tk,G,prefix", [(128, 4, 100), (128, 1, 127), (64, 4, 60),
                                         (64, 8, 200), (128, 2, 0),
                                         # the _256 build: 32-position tiles, G 2
                                         (32, 2, 100), (32, 2, 31), (32, 2, 0),
                                         # the MLA extends' packed rows at Hq 40
                                         # (the 288 build), 48-position tiles
                                         (48, 40, 100), (48, 40, 47), (48, 40, 0)])
def test_warp_mask_decision_covers_the_tree(tk, G, prefix):
    """csrc/rpa_extend.cu, rpa_extend_wgmma_kernel: a warp's 16 packed rows
    span query positions wq_lo .. wq_hi; a tile at st is left unmasked only
    if no causal, length or window test can fail AND it does not meet the
    tree's window [wb, wb + W). Replayed for a tree verify: every tile the
    decision leaves unmasked is visible whole to every row of the warp. The
    MLA extends (csrc/rpa_extend_mla.cu) decide alike over packed rows
    m = r Hq + g, G = Hq: at Hq 40 a warp's 16 rows lie within one or two
    tokens, and a 64-row tile may start and end inside a token."""
    N = TREE.num_nodes
    limit = prefix + N
    rows = [prefix + j for j in range(N)]  # slot-order positions of the entry's rows
    anc = TREE.anc_bits
    for w0 in range(0, N * G, 16):  # a warp's packed rows
        wq = sorted({rows[m // G] for m in range(w0, min(w0 + 16, N * G))})
        wq_lo, wq_hi = wq[0], wq[-1]
        for st in range(0, limit, tk):
            masked = (st + tk > limit or st + tk - 1 > wq_lo
                      or (st < prefix + N and st + tk > prefix))
            if masked:
                continue
            for q in wq:
                bits = anc[q - prefix]
                for pos in range(st, st + tk):
                    wk = pos - prefix
                    assert pos <= q and (wk < 0 or wk >= N or (bits >> wk) & 1)


def _csrc(source: str) -> str:
    from pathlib import Path

    return (Path(rpa.__file__).resolve().parents[2] / source).read_text()


def _c_entry_types(source: str):
    """The ctypes of the parameters of ``extern "C" int RPA_ENTRY(...)`` in a
    csrc file: pointers c_void_p, int c_int, float c_float."""
    import ctypes
    import re

    text = _csrc(source)
    params = re.search(r'extern "C" int RPA_ENTRY\(([^)]*)\)', text).group(1).split(",")
    kinds = []
    for prm in params:
        prm = " ".join(prm.split())
        kinds.append(ctypes.c_void_p if "*" in prm else
                     ctypes.c_float if prm.startswith("float") else ctypes.c_int)
    return kinds


@pytest.mark.parametrize("name", ["rpa_extend", "rpa_extend_aligned", "rpa_extend_merged",
                                  "rpa_extend_mla", "rpa_extend_aligned_256",
                                  "rpa_extend_mla_288"])
def test_extend_entry_argtypes_match_the_c_signature(name):
    """The ctypes argtypes of each extend build, parameter for parameter, as
    its C entry declares them: the tree's count, host table and win_base
    sit between the types and ALiBi's slopes, the slopes before the stream,
    where the wrapper passes them (a pointer in an int's place would be cut
    to 32 bits)."""
    from semi_pd_tpu_torch.kernels import KERNELS

    k = KERNELS[name]
    assert k.argtypes == _c_entry_types(k.source_rel.split("/", 1)[1])
    assert len(k.argtypes) == 28 and k.argtypes[-5] is __import__("ctypes").c_int
    # the kernels' parameter struct holds as many masks as a tree has nodes
    import re

    cap = re.search(r"constexpr int SPEC_MAX_NODES = (\d+);", _csrc("csrc/rpa_common.cuh"))
    assert int(cap.group(1)) == port_tree.MAX_TREE_NODES
