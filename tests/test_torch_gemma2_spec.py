"""EAGLE speculation over a chain and a tree on a Gemma-2 target, the port
against the JAX package on the CPU, with the same numpy inputs and weights:

- the plain masked extend at head_dim 256 on the 5D pool (what
  ``rpa_extend_aligned_256``'s TREE instantiations are held to on the
  card) against _rpa_kernel's GQA branch in interpret mode with
  ``spec_anc`` / ``win_base``: a tree verify (b3 x N 29 rows, Hq 4 / Hkv 2)
  with softcap 1.0 and a window of 24 whose edge falls inside the tree
  (node i of a request whose tree starts at b sees positions above b + i -
  24, so the deepest nodes lose their root), and tree draft levels (no cap,
  no window: the draft pool's), float32, bf16 and fp8_e4m3 KV under
  float32 and bf16 q; every dead slot of the port's pool NaN;
- the warpgroup kernel's per-tile mask decision at head_dim 256 (32-position
  tiles, G 2) with the window inside the tree, replayed;
- the target's tree verify (each layer's window and cap with the tree) and
  its ``return_hidden`` (the final-normed hidden state) against the JAX
  Gemma2ForCausalLM's;
- ``eagle_round`` and ``eagle_tree_round`` with the llama EAGLE draft at
  Gemma-2's geometry (head_dim 256, plain norms, SiLU, no softcap, no
  window, the raw embedding and the tied head) on 5D pools: tokens, accept
  lengths, next hidden states and both pools, with and without the refresh;
- the Engine: greedy tokens and ``n_spec_accepted`` equal to the JAX
  Engine's for EAGLE chain and tree, colocated and semi-PD (a prompt
  chunk-prefilling beside the speculating requests, with a fixed prefill
  chunk budget so that both schedule alike), the tree larger than the
  window, and the port's tokens equal to its own non-speculating serve.

The weights are made predictive (the target's final norm (1 + w) at w = 0
and its embedding, so its tied head too, times 4; the draft's fc passing
the token embedding through, with 0.01 of the fed hidden state), so that
rounds accept some drafts and reject others; both packages get the same
numbers.

Model: tests/test_torch_gemma2.py's tiny Gemma-2 (3 layers, hidden 64, Hq 4,
Hkv 2, head_dim 256, window 8 on the even layers, query_pre_attn_scalar 64,
softcaps 0.05 / 0.5), float32, vocab 128. Tolerances: float32 2e-5 (the same
float32 products in another order; logits 1e-4 as the model test's), bf16
1e-2 (both compute in float32 from the same bf16 inputs and round the output
to bf16); tokens and accept lengths exact.
"""

import dataclasses
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.layers.attention import spec_tree_context
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.ops.attention.ragged_paged_attention import AttnMeta as JaxMeta
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.runtime import batch as jax_batch
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.runtime.req import Req as JaxReq
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from semi_pd_tpu.speculative import eagle as jax_eagle
from semi_pd_tpu.speculative.tree import build_tree_template as jax_build_tree

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.gemma2 import Gemma2ForCausalLM
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention.rpa_common import pick_kernel
from semi_pd_tpu_torch.runtime import batch as port_batch
from semi_pd_tpu_torch.runtime.cuda_graph_runner import RoundGraphs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from semi_pd_tpu_torch.speculative import eagle as port_eagle
from semi_pd_tpu_torch.speculative.eagle import EagleDraftModel
from semi_pd_tpu_torch.speculative.tree import default_tree_template
from test_torch_round_graphs import EagerRounds

PS = 16
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TREE = default_tree_template(4, 4)  # branching (4, 2, 1, 1), 29 nodes
# the rounds' and the Engine's tree: branching (3, 1, 1), 10 nodes, longer
# than the tiny model's window of 8, so that its deepest nodes lose the root
# on the windowed layers
ROUND_TREE = default_tree_template(3, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast alone and
    keeps the many small ops from stalling when the test workers share the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------- the masked extend at head_dim 256
HQ, HKV, D = 4, 2, 256
SCALE = D ** -0.5
CAP, WINDOW = 1.0, 24  # the window is shorter than the 29-node tree
KV = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
      "fp8_e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}


def _cast(a: np.ndarray, name: str):
    """``a`` in dtype ``name``: numpy for JAX, torch holding the same bytes."""
    np_t, torch_t = KV[name]
    x = a.astype(np_t)
    if name == "float32":
        return x, _t(x)
    bits = np.uint16 if name == "bfloat16" else np.uint8
    return x, _t(x.view(bits)).view(torch_t)


def _tree_case(seed, prefix, level, kv, q_dtype):
    """A tree round's attention over a one-layer 5D pool [1, 2, S, 2, 256]:
    requests with ``prefix`` committed positions, each followed by TREE's
    window (slot-order positions prefix + j), on shuffled pages. Without
    ``level``: the verify (N rows a request); with it: that draft level,
    B * n rows of q_len 1 over the tiled page table. The port's pool has
    NaN in every slot no live position holds; scores reach a few units, so
    that CAP bites."""
    rng = np.random.default_rng(seed)
    N, B = TREE.num_nodes, len(prefix)
    n_pages = [-(-(p + N) // PS) + 1 for p in prefix]
    total = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(n_pages)), np.int32)
    used, live = 0, set()
    for b, (p, m) in enumerate(zip(prefix, n_pages)):
        pt[b, :m] = perm[used:used + m]
        used += m
        live.update(int(pt[b, pos // PS]) * PS + pos % PS for pos in range(p + N))
    S = total * PS
    pool = (rng.normal(size=(1, 2, S, HKV, D)) * 0.5).astype(np.float32)
    win_base = np.asarray(prefix, np.int32)
    if level is None:
        q_lens = np.full(B, N, np.int64)
        kv_lens = np.asarray(prefix, np.int64) + N
        T = B * N
        jm, pm = jax_meta(q_lens, kv_lens, T), build_attn_meta(q_lens, kv_lens, T)
        table, wb = pt, win_base
    else:
        nodes = TREE.level_nodes[level]
        mpos = np.concatenate([np.asarray(prefix) + j for j in nodes]).astype(np.int32)
        T = len(mpos)
        ar = np.arange(T, dtype=np.int32)
        kv_lens = mpos.astype(np.int64) + 1
        jm = JaxMeta(q_lens=jnp.ones(T, jnp.int32), q_start=jnp.asarray(mpos),
                     block_seq=jnp.asarray(ar), block_row=jnp.asarray(ar),
                     block_qofs=jnp.zeros(T, jnp.int32))
        pm = port_eagle._decode_meta(_t(mpos))
        table, wb = np.tile(pt, (len(nodes), 1)), np.tile(win_base, len(nodes))
    q = rng.normal(size=(T, HQ, D)).astype(np.float32)
    port_pool = pool.copy()
    dead = np.ones(S, bool)
    dead[sorted(live)] = False
    port_pool[:, :, dead] = np.nan
    jpool, _ = _cast(pool, kv)
    _, tpool = _cast(port_pool, kv)
    jq, tq = _cast(q, q_dtype)
    return dict(jq=jnp.asarray(jq), jpool=jnp.asarray(jpool), tq=tq, tpool=tpool, pt=table,
                kv_lens=kv_lens.astype(np.int32), wb=wb.astype(np.int32), jmeta=jm, pmeta=pm)


def _port(c, anc=TREE.anc_bits, **kw):
    return rpa.ragged_paged_attention(
        c["tq"], c["tpool"], 0, _t(c["pt"]), _t(c["kv_lens"]), c["pmeta"], page_size=PS,
        scale=SCALE, spec_anc=tuple(anc), win_base=_t(c["wb"]), **kw).float().numpy()


# (prefixes, draft level, KV, q dtype, capped and windowed): prefixes put the
# windows across page boundaries, shuffled pages
MASK_CASES = {
    "verify_f32": ([40, 17, 3], None, "float32", "float32", True),
    "verify_bf16": ([40, 17, 3], None, "bfloat16", "bfloat16", True),
    "verify_e4m3_q_f32": ([23, 50], None, "fp8_e4m3", "float32", True),
    "verify_e4m3_q_bf16": ([23, 50], None, "fp8_e4m3", "bfloat16", True),
    "draft_level1_f32": ([40, 17, 3], 1, "float32", "float32", False),
    "draft_level3_bf16": ([23, 50], 3, "bfloat16", "bfloat16", False),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_plain_masked_extend_at_256_matches_jax_kernel(case):
    """The 5D pool's routing at head_dim 256 with a tree (the plain extend,
    which rpa_extend_aligned_256 is held to) against _rpa_kernel's GQA
    branch in interpret mode with the same tree, softcap and window; the
    tree and the window each change the answer."""
    prefix, level, kv, q_dtype, bites = MASK_CASES[case]
    c = _tree_case(7, prefix, level, kv, q_dtype)
    kw = dict(logit_cap=CAP, sliding_window=WINDOW) if bites else {}
    want = np.asarray(jax_rpa(
        c["jq"], c["jpool"], 0, jnp.asarray(c["pt"]), jnp.asarray(c["kv_lens"]), c["jmeta"],
        page_size=PS, scale=SCALE, interpret=True, spec_anc=TREE.anc_bits,
        win_base=jnp.asarray(c["wb"]), **kw).astype(jnp.float32))
    assert pick_kernel(rpa.EXTEND_KERNELS, c["tpool"]).name == "rpa_extend_aligned_256"
    got = _port(c, **kw)
    assert got.shape == (len(c["kv_lens"]) if level else len(prefix) * TREE.num_nodes, HQ, D)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[q_dtype], rtol=TOL[q_dtype])
    chain = tuple((1 << (j + 1)) - 1 for j in range(TREE.num_nodes))
    assert np.abs(_port(c, anc=chain, **kw) - got).max() > 1e-3
    if bites:  # the window's edge inside the tree cuts the deepest nodes' roots
        assert np.abs(_port(c, logit_cap=CAP) - got).max() > 1e-3


@pytest.mark.parametrize("prefix", [100, 31, 0, 4100])
def test_warp_mask_decision_with_the_window_inside_the_tree(prefix):
    """csrc/rpa_extend.cu, rpa_extend_wgmma_kernel at head_dim 256 (TK 32,
    G 2: Gemma-2-9B's 16 / 8 heads): a tile at st is left unmasked only if
    no causal, length or window test can fail (the window against the
    warp's highest slot-order position) and it does not meet the tree's
    window [wb, wb + W). Replayed for a tree verify with windows of 24
    (inside the 29-node tree) and 4096: every tile the decision leaves
    unmasked is visible whole to every row of the warp, and the walk's
    first tile (from the entry's lowest position) holds every position any
    row sees."""
    tk, G, N = 32, 2, TREE.num_nodes
    limit = prefix + N
    rows = [prefix + j for j in range(N)]
    anc = TREE.anc_bits
    for window in (24, 4096):
        lo = max(rows[0] - window + 1, 0)
        for q in rows:  # nothing a row sees lies before the walk's start
            assert max(q - window + 1, 0) >= lo
        for w0 in range(0, N * G, 16):
            wq = sorted({rows[m // G] for m in range(w0, min(w0 + 16, N * G))})
            wq_lo, wq_hi = wq[0], wq[-1]
            for st in range(lo, limit, tk):
                masked = (st + tk > limit or st + tk - 1 > wq_lo or st <= wq_hi - window
                          or (st < prefix + N and st + tk > prefix))
                if masked:
                    continue
                for q in wq:
                    bits = anc[q - prefix]
                    for pos in range(st, st + tk):
                        wk = pos - prefix
                        assert pos <= q and pos > q - window
                        assert wk < 0 or wk >= N or (bits >> wk) & 1


# ------------------------------------------------------------------ models
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=256,
            max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6)
GEMMA = dict(query_pre_attn_scalar=64, sliding_window=8, attn_logit_softcapping=0.05,
             final_logit_softcapping=0.5)
H = TINY["hidden_size"]


def _jax_cfg():
    hf = types.SimpleNamespace(architectures=["Gemma2ForCausalLM"],
                               hidden_act="gelu_pytorch_tanh", attention_bias=False,
                               tie_word_embeddings=True, **TINY, **GEMMA)
    return JaxModelConfig.from_hf_config(hf, dtype="float32")


def _cfg():
    return ModelConfig(architecture="Gemma2ForCausalLM", hidden_act="gelu_pytorch_tanh",
                       context_length=TINY["max_position_embeddings"], dtype="float32",
                       query_pre_attn_scalar=GEMMA["query_pre_attn_scalar"],
                       sliding_window=GEMMA["sliding_window"],
                       attn_logit_softcap=GEMMA["attn_logit_softcapping"],
                       logit_softcap=GEMMA["final_logit_softcapping"], **TINY)


# the embedding's gain in _predictive: Gemma-2's sandwich norms give every
# branch unit scale, so at gain 1 the last token decides the target's
# argmax in served contexts but seldom over the rounds' random pools
GAIN = 4.0


def _predictive(params, draft):
    """Make EAGLE accept some drafts (in place, numpy trees): the target's
    final norm (1 + w) at w = 0, its embedding (and so its tied head) times
    GAIN; the draft's fc passing the token embedding through, with 0.01 of
    the fed hidden state."""
    params["final_norm"] = np.zeros_like(params["final_norm"])
    params["embed"]["w"] = params["embed"]["w"] * GAIN
    fc = np.array(draft["fc"]["w"])
    fc[:H] = np.eye(H, dtype=fc.dtype)
    fc[H:] *= 0.01
    draft["fc"]["w"] = fc


_MODELS = {}


def _models():
    """The JAX Gemma-2 target and EAGLE draft (the JAX init_params numbers,
    made predictive) and the port's modules holding the same numbers."""
    if not _MODELS:
        jm = jax_create_model(_jax_cfg())
        jm.page_size = PS
        jd = jax_eagle.EagleDraftModel(_jax_cfg())
        params = jax.tree.map(np.array, jm.init_params(0))
        draft = jax.tree.map(np.array, jd.init_params(1))
        tm = Gemma2ForCausalLM(_cfg(), "cpu")
        tm.page_size = PS
        td = EagleDraftModel(_cfg(), "cpu")
        td.page_size = PS
        td.init_params(1)  # the JAX draft's numbers at Gemma-2's geometry
        jax.tree.map(np.testing.assert_array_equal, td.params_tree(), draft)
        _predictive(params, draft)
        tm.load_jax_params(params)
        td.load_jax_params(draft)
        _MODELS.update(jax=(jm, jd, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, draft)), port=(tm, td))
    return _MODELS


def _req_pair(i, kv_len, pages, slot, out=2):
    ids = [(3 + 5 * j + i) % 128 for j in range(kv_len - out + 1)]
    reqs = []
    for R, SP in ((Req, SamplingParams), (JaxReq, JaxSamplingParams)):
        r = R(rid=f"r{i}", input_ids=list(ids), sampling_params=SP(temperature=0.0))
        r.prefilled_len = len(ids)
        r.output_ids = [7 + i] * out
        r.pages, r.req_slot = list(pages), slot
        reqs.append(r)
    return reqs


def _round_state(tree=None, gamma=3, seed=5):
    """The same 5D pools, weights and requests for both packages: a random
    target pool [3, 2, S, 2, 256] and draft pool [1, 2, S, 2, 256] at the
    scale of the model's own K and V, requests of 20-50 committed positions
    (past the window) on shuffled pages, random hidden states, and the
    verify batch of a chain (gamma) or of a tree."""
    rng = np.random.default_rng(seed)
    n = tree.num_nodes if tree else gamma + 1
    kv_lens = [20, 47, 31]
    need = [-(-(k + n + 1) // PS) for k in kv_lens]
    perm = rng.permutation(np.arange(1, sum(need) + 1))
    table = np.zeros((8, 16), np.int32)
    port, jaxr, used = [], [], 0
    for i, (k, m) in enumerate(zip(kv_lens, need)):
        pages = perm[used:used + m].tolist()
        used += m
        table[i + 1, :m] = pages
        tr, jr = _req_pair(i, k, pages, i + 1)
        port.append(tr)
        jaxr.append(jr)
    args = (table, PS, [1, 2, 4, 8], [8, 16])
    if tree:
        hb = port_batch.build_tree_verify_batch(port, tree, *args)
        jb = jax_batch.build_tree_verify_batch(jaxr, jax_build_tree(tree.branching), *args)
    else:
        hb, _, _ = port_batch.build_spec_verify_batch(port, [[0] * gamma] * 3, gamma, *args)
        jb, _, _ = jax_batch.build_spec_verify_batch(jaxr, [[0] * gamma] * 3, gamma, *args)
    S = (sum(need) + 1) * PS
    L = TINY["num_hidden_layers"]
    kv = rng.normal(size=(L, 2, S, HKV, D)).astype(np.float32) * 0.2
    dkv = rng.normal(size=(1, 2, S, HKV, D)).astype(np.float32) * 0.2
    prev = rng.normal(size=(hb.B, H)).astype(np.float32)
    return dict(**_models(), hb=hb, jb=jb, kv=kv, dkv=dkv, prev=prev)


def test_tree_verify_and_hidden_match_jax():
    """The Gemma-2 target's tree verify (every layer's window of 8 and cap
    with the tree's masks; the tree of 10 nodes outgrows the window) gives
    the JAX model's logits within 1e-4 and, with ``return_hidden``, its
    final-normed hidden states within 2e-5; the tree changes the logits."""
    st = _round_state(tree=ROUND_TREE)
    (jm, _, jp, _), (tm, _) = st["jax"], st["port"]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, size=st["hb"].T).astype(np.int32)
    anc = tuple(int(a) for a in ROUND_TREE.anc_bits)
    jb = st["jb"].to_device(jax.random.PRNGKey(0))._replace(input_ids=jnp.asarray(ids))
    with spec_tree_context(anc):
        jl, _, jh = jm.forward(jp, jb, (jnp.asarray(st["kv"]),), return_hidden=True)
    fb = st["hb"].to_device("cpu")._replace(input_ids=_t(ids), spec_anc=anc)
    tl, th = tm(fb, _t(st["kv"].copy()), return_hidden=True)
    n = 3 * ROUND_TREE.num_nodes  # the real requests' rows
    np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(th.numpy()[:n], np.asarray(jh)[:n], rtol=2e-5, atol=2e-5)
    chain = tuple((1 << (j + 1)) - 1 for j in range(ROUND_TREE.num_nodes))
    other = tm(fb._replace(spec_anc=chain), _t(st["kv"].copy()))
    assert (other[:n] - tl[:n]).abs().max() > 1e-5


def _check_round(got, want, kv, dkv, jkv, jdkv):
    for a, b in zip(got[:3], want[:3]):  # accept_len, next_tok, tokens
        np.testing.assert_array_equal(a.numpy()[:3], np.asarray(b)[:3])
    np.testing.assert_allclose(got[3].numpy()[:3], np.asarray(want[3])[:3], atol=2e-5,
                               rtol=2e-5)
    # both pools, compaction and refresh included, but the dump page (slots
    # 0-15): the padded request's rows all write its slot 0, a scatter with
    # repeated indices whose winner neither package defines
    np.testing.assert_allclose(kv.numpy()[:, :, 16:], np.asarray(jkv)[:, :, 16:], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(dkv.numpy()[:, :, 16:], np.asarray(jdkv)[:, :, 16:],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_eagle_round_on_gemma2_matches_jax(kind, refresh):
    """eagle_round (gamma 3) and eagle_tree_round (the (3, 1, 1) tree) with
    the EAGLE draft at Gemma-2's geometry on 5D pools at head_dim 256,
    against JAX's rounds."""
    tree = ROUND_TREE if kind == "tree" else None
    st = _round_state(tree=tree)
    (jm, jd, jp, jdp), (tm, td) = st["jax"], st["port"]
    kv, dkv = _t(st["kv"].copy()), _t(st["dkv"].copy())
    fb, prev = st["hb"].to_device("cpu"), _t(st["prev"])
    jargs = (jm, jd, jp, jdp, (jnp.asarray(st["kv"]),), jnp.asarray(st["dkv"]),
             st["jb"].to_device(jax.random.PRNGKey(0)), jnp.asarray(st["prev"]))
    if kind == "tree":
        got = port_eagle.eagle_tree_round(tm, td, kv, dkv, fb, prev, tree, refresh=refresh)
        want = jax_eagle.eagle_tree_round(*jargs, jax_build_tree(tree.branching),
                                          refresh=refresh)
    else:
        got = port_eagle.eagle_round(tm, td, kv, dkv, fb, prev, 3,
                                     torch.Generator().manual_seed(0), refresh=refresh)
        want = jax_eagle.eagle_round(*jargs, 3, refresh=refresh)
    _check_round(got, want, kv, dkv, want[5][0], want[6])
    assert int(got.accept_len[:3].sum()) > 0  # drafts were accepted (and compacted)


# ------------------------------------------------------------------ engine
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=32,
             decode_bs_buckets=[4])
ALGOS = {"chain": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=3),
         "tree": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=3,
                      speculative_eagle_topk=3)}


def _engines(algo):
    """A JAX and a port Engine for ``algo`` holding the same predictive
    weights; the port's draft drew the JAX draft's numbers itself."""
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               dtype="float32", **SERVE, **ALGOS[algo]),
                     model_config=_jax_cfg())
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **ALGOS[algo]),
                  _cfg(), device="cpu")
    jr, tr = jeng.runner, teng.runner
    assert isinstance(tr.model, Gemma2ForCausalLM) and isinstance(tr.draft_model, EagleDraftModel)
    assert isinstance(jr.draft_model, jax_eagle.EagleDraftModel)
    # the draft pool: one layer of the target's 5D pool at head_dim 256
    assert tuple(tr.draft_kv.buffer.shape) == (1, 2, tr.kv_cache.buffer.shape[2], HKV, D)
    params = jax.tree.map(np.array, jr.params)
    draft = jax.tree.map(np.array, jr.draft_params)
    jax.tree.map(np.testing.assert_array_equal, tr.draft_model.params_tree(), draft)
    _predictive(params, draft)
    jr.params = jax.tree.map(jnp.asarray, params)
    jr.draft_params = jax.tree.map(jnp.asarray, draft)
    tr.model.load_jax_params(params)
    tr.draft_model.load_jax_params(draft)
    tr.set_spec_thresholds()
    return jeng, teng


@pytest.fixture(scope="module")
def pairs():
    """Engine pairs built once per algorithm (the JAX engine's compiled
    programs are most of a test's time); each test gives them fresh
    schedulers (``_serve``)."""
    cache = {}

    def get(algo):
        if algo not in cache:
            cache[algo] = _engines(algo)
        return cache[algo]

    yield get
    cache.clear()


def _serve(pair, semi_pd=False):
    """Fresh schedulers on both engines of a pair, colocated or semi-PD
    (with a fixed prefill chunk budget, so that both schedule alike)."""
    from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler

    from semi_pd_tpu_torch.runtime.scheduler import Scheduler

    for eng, sched in zip(pair, (JaxScheduler, Scheduler)):
        assert eng.flush_cache()
        args = dataclasses.replace(eng.server_args, enable_semi_pd=semi_pd,
                                   prefill_chunk_budget_tokens=32 if semi_pd else None)
        eng.server_args, eng.scheduler = args, sched(args, eng.runner)
    return pair


def _prompts():
    rng = np.random.default_rng(7)
    short = [rng.integers(0, 128, size=n).tolist() for n in (10, 23)]
    return short + [rng.integers(0, 128, size=66).tolist()]  # three chunks of 32


SP = dict(max_new_tokens=16, temperature=0.0, ignore_eos=True)


# the rounds run eagerly, or replayed from round graphs ("-graphs")
@pytest.mark.parametrize("semi_pd,rounds", [(False, "eager"), (True, "eager"),
                                            (False, "graphs"), (True, "graphs")],
                         ids=["colocated", "semi_pd", "colocated-graphs", "semi_pd-graphs"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_engine_tokens_and_acceptance_match_jax(algo, semi_pd, rounds, pairs):
    """The port's Engine gives the JAX Engine's greedy tokens and accepted
    drafts, its rounds run eagerly or replayed from round graphs (the
    ``EagerRounds`` double of tests/test_torch_round_graphs.py)."""
    jeng, teng = _serve(pairs(algo), semi_pd)
    teng.runner.round_graphs = (RoundGraphs(teng.runner, EagerRounds())
                                if rounds == "graphs" else None)
    counts0 = dict(teng.runner.step_counts), dict(teng.runner.spec_counts)
    jout = jeng.generate(input_ids=_prompts(), sampling_params=JaxSamplingParams(**SP))
    tout = teng.generate(input_ids=_prompts(), sampling_params=SamplingParams(**SP))
    got = [o["output_ids"] for o in tout]
    assert got == [o["output_ids"] for o in jout]
    s, js = teng.scheduler, jeng.scheduler
    assert s.n_spec_steps == js.n_spec_steps > 0
    assert s.n_spec_accepted == js.n_spec_accepted > 0
    # some drafts were rejected too: the rounds ran both outcomes
    assert s.n_spec_accepted < s.n_spec_steps * (teng.runner.tree_template.depth
                                                 if algo == "tree" else s.spec_gamma)
    assert teng.runner.step_counts["decode"] == counts0[0]["decode"]  # every tick speculated
    spec = teng.runner.spec_counts
    if algo == "tree":
        assert teng.runner.tree_template.num_nodes == ROUND_TREE.num_nodes
        assert ROUND_TREE.num_nodes > GEMMA["sliding_window"]  # the window cuts inside it
        assert spec["draft_tree"] > counts0[1]["draft_tree"]
    else:
        assert spec["draft_decode"] > counts0[1]["draft_decode"]
    if rounds == "graphs":  # every round replayed, a capture per key
        rg = teng.runner.round_graphs
        assert rg.stats["replays"] == spec["verify"] - counts0[1]["verify"]
        assert rg.stats["captures"] == len(rg.graphs) >= 1
    assert teng.flush_cache() and jeng.flush_cache()  # check_memory() inside
    # the same engine without speculation gives the same greedy tokens
    s.spec_gamma = 0
    plain = teng.generate(input_ids=_prompts(), sampling_params=SamplingParams(**SP))
    assert [o["output_ids"] for o in plain] == got and teng.flush_cache()
