"""The port's NextN speculative decoding (DeepSeek's multi-token-prediction
draft over the one-layer latent draft pool) against the JAX package on the
CPU, with the same numpy inputs and weights:

- ``NextNDraftModel``: its leaves in the JAX tree's order and its
  ``init_params(seed)`` drawing the JAX numbers; one ``step`` against JAX's
  step, decode-shaped and as a tree's draft level (``spec_anc`` /
  ``win_base``), hidden state and draft pool;
- the plain MLA extend with a speculation tree (what ``rpa_extend_mla``'s
  TREE instantiations are held to on the card) against _rpa_kernel's MLA
  branch in interpret mode with ``spec_anc`` / ``win_base`` and against the
  JAX reference attention (and the port's reference, ``v_dim`` and
  ``spec_anc`` together, against JAX's): a tree verify (N = 29 rows a request, at most
  64, the rows the JAX MLA extend writes: ROADMAP C1) and tree draft
  levels, bf16 and float32 q, bf16, float32 and fp8_e4m3 rows, every dead
  slot of the port's pool NaN;
- the routing: a decode-shaped tree batch on the latent pool takes the
  extend, never the packed or the streaming decode;
- ``_compact_slots`` on the latent pool;
- ``eagle_round`` and ``eagle_tree_round`` with the NextN draft on latent
  pools: tokens, accept lengths, next hidden states and both pools, with
  and without the refresh;
- the Engine: greedy tokens and ``n_spec_accepted`` equal to the JAX
  Engine's for NEXTN chain and tree, colocated and semi-PD (a prompt
  chunk-prefilling beside the speculating requests, with a fixed prefill
  chunk budget so that both engines schedule alike), and the port's tokens
  equal to its own non-speculating serve; EAGLE on the DeepSeek target
  selects NextN; the draft pool in the target's fp8 dtype, released and
  re-made; an FR-Spec head sliced from the untied lm_head.

The weights are made predictive (the target's final norm ones; the draft's
norms ones and its eh_proj passing the normed embedding, blurred by a
fixed random matrix so that some drafts are rejected), so that rounds
accept some drafts and reject others; both packages get the same numbers.

Model: the JAX NextN test's tiny DeepSeek-V2 (hidden 48, 4 heads, latent
row kv_lora 32 + rope 8 = 40, a dense first layer and an MoE second one of
4 experts top-2 with a shared expert, so the draft layer is MoE), float32,
vocab 64. Tolerances: float32 2e-5 (the same float32 products in another
order), bf16 1e-2 (both compute in float32 from the same bf16 inputs and
round the output to bf16); tokens and accept lengths exact.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.layers.attention import spec_tree_context
from semi_pd_tpu.models.deepseek_v2 import DeepseekV2ForCausalLM as JaxDeepseek
from semi_pd_tpu.ops.attention.ragged_paged_attention import AttnMeta as JaxMeta
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.runtime import batch as jax_batch
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.runtime.req import Req as JaxReq
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from semi_pd_tpu.speculative import eagle as jax_eagle
from semi_pd_tpu.speculative.nextn import NextNDraftModel as JaxNextN
from semi_pd_tpu.speculative.tree import build_tree_template as jax_build_tree

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention.reference import ragged_paged_attention_reference
from semi_pd_tpu_torch.runtime import batch as port_batch
from semi_pd_tpu_torch.runtime.cuda_graph_runner import RoundGraphs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from semi_pd_tpu_torch.speculative import eagle as port_eagle
from semi_pd_tpu_torch.speculative.nextn import NextNDraftModel
from semi_pd_tpu_torch.speculative.tree import default_tree_template
from test_torch_round_graphs import EagerRounds

PS = 16
CFG = dict(architecture="DeepseekV2ForCausalLM", vocab_size=64, hidden_size=48,
           intermediate_size=64, moe_intermediate_size=32, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=None,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, num_experts=4,
           num_experts_per_tok=2, num_shared_experts=1, first_k_dense_replace=1,
           moe_layer_freq=1, max_position_embeddings=512, context_length=512,
           tie_word_embeddings=False, dtype="float32", use_mla=True)
H, DLAT = CFG["hidden_size"], CFG["kv_lora_rank"] + CFG["qk_rope_head_dim"]
# one decode bucket and one prefill bucket: few distinct shapes for the JAX
# engine to compile
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=32,
             decode_bs_buckets=[4])
ALGOS = {"chain": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=3),
         "tree": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=4,
                      speculative_eagle_topk=4)}
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TREE = default_tree_template(4, 4)  # branching (4, 2, 1, 1), 29 nodes
# the direct rounds' tree: branching (3, 1, 1), 10 nodes, cheaper for the
# JAX reference to run
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


def _predictive(params, draft):
    """Make NextN accept some drafts (in place, numpy trees): the target's
    final norm ones, so its argmax is the head's over its last hidden state,
    which the last token's embedding dominates; the draft's norms ones and
    its eh_proj passing the normed embedding through a fixed blur (identity
    plus 0.5 of a random matrix), with 0.01 of the fed hidden state, so that
    the draft's head mostly, not always, agrees with the target's."""
    params["final_norm"] = np.ones_like(params["final_norm"])
    for k in ("enorm", "hnorm", "head_norm"):
        draft[k] = np.ones_like(draft[k])
    w = np.array(draft["eh_proj"]["w"])
    w[:H] = np.eye(H) + 0.5 * np.random.default_rng(0).normal(size=(H, H)) / np.sqrt(H)
    w[H:] *= 0.01
    draft["eh_proj"]["w"] = w.astype(np.float32)


# ----------------------------------------------------------------- the draft
def test_init_params_match_jax():
    """The draft's leaves in the JAX tree's order and its init_params(seed)
    numbers, leaf for leaf; its layer mirrors the target's last (MoE)."""
    jm = JaxDeepseek(JaxModelConfig(**CFG))
    jparams = JaxNextN(jm).init_params(3)
    td = NextNDraftModel(DeepseekV2ForCausalLM(ModelConfig(**CFG), "cpu"), "cpu")
    td.init_params(3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        "".join(f"['{k}']" for k in path.split(".")) for path, _ in td.param_specs()]
    jax.tree.map(np.testing.assert_array_equal, td.params_tree(),
                 jax.tree.map(np.asarray, jparams))
    paths = [p for p, _ in td.param_specs()]
    assert paths[:4] == ["eh_proj.w", "enorm", "head_norm", "hnorm"]
    assert "layer.experts.gate_up" in paths and "layer.shared.down.w" in paths
    # the draft holds its own leaves only, not the target's
    assert sum(1 for _ in td.parameters()) == len(paths)


_MODELS = {}


def _models():
    """The JAX target and NextN draft (float32, the JAX init_params numbers,
    made predictive) and the port's modules holding the same numbers; built
    once for the direct tests."""
    if not _MODELS:
        jm = JaxDeepseek(JaxModelConfig(**CFG))
        jm.page_size = PS
        jd = JaxNextN(jm)
        params = jax.tree.map(np.array, jm.init_params(0))
        draft = jax.tree.map(np.array, jd.init_params(1))
        _predictive(params, draft)
        tm = DeepseekV2ForCausalLM(ModelConfig(**CFG), "cpu")
        tm.page_size = PS
        tm.load_jax_params(params)
        td = NextNDraftModel(tm, "cpu")
        td.load_jax_params(draft)
        _MODELS.update(jax=(jm, jd, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, draft)), port=(tm, td))
    return _MODELS


def _req_pair(i, kv_len, pages, slot, out=2):
    ids = list(range(3, 3 + kv_len - out + 1))
    reqs = []
    for R, SP in ((Req, SamplingParams), (JaxReq, JaxSamplingParams)):
        r = R(rid=f"r{i}", input_ids=list(ids), sampling_params=SP(temperature=0.0))
        r.prefilled_len = len(ids)
        r.output_ids = [7 + i] * out
        r.pages, r.req_slot = list(pages), slot
        reqs.append(r)
    return reqs


def _round_state(tree=None, gamma=3, seed=5):
    """The same latent pools, weights and requests for both packages: a
    random target pool [2, 1, S, 1, 40] and draft pool [1, 1, S, 1, 40] at
    the scale of the model's own rows, requests of 20-50 committed positions
    on shuffled pages, random hidden states, and the verify batch of a
    chain (gamma) or of a tree."""
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
    kv = rng.normal(size=(2, 1, S, 1, DLAT)).astype(np.float32) * 0.1
    dkv = rng.normal(size=(1, 1, S, 1, DLAT)).astype(np.float32) * 0.1
    prev = rng.normal(size=(hb.B, H)).astype(np.float32)
    return dict(**_models(), hb=hb, jb=jb, kv=kv, dkv=dkv, prev=prev)


def _level_inputs(st, level):
    """A tree draft level's step inputs, as eagle_tree_round builds them:
    B * n rows of q_len 1 at the nodes' slot-order positions, the page
    table tiled n times, each request's window start."""
    hb, nodes = st["hb"], TREE.level_nodes[level]
    B, N = hb.B, TREE.num_nodes
    cat = lambda a: np.concatenate([a.reshape(B, N)[:, j] for j in nodes]).astype(np.int32)
    mpos = cat(hb.mask_pos)
    return dict(rpos=cat(hb.q_pos), slots=cat(hb.out_slots), mpos=mpos,
                pt=np.tile(hb.page_table, (len(nodes), 1)),
                wb=np.tile(hb.mask_pos.reshape(B, N)[:, 0], len(nodes)).astype(np.int32))


@pytest.mark.parametrize("level", [None, 1], ids=["decode", "tree_level1"])
def test_draft_step_matches_jax(level):
    """One NextN step: decode-shaped over the latent draft pool (a chain's
    draft step), or a tree's draft level with the tree's masks; the hidden
    state and the pool after the step's latent write."""
    st = _round_state(tree=TREE)
    (_, jd, _, jdp), (_, td) = st["jax"], st["port"]
    if level is None:
        pos = np.array([20, 47, 31, 5], np.int32)
        slots = st["hb"].out_slots.reshape(st["hb"].B, -1)[:, 0].astype(np.int32)
        x = dict(rpos=pos, slots=slots, mpos=pos, pt=st["hb"].page_table, wb=None)
    else:
        x = _level_inputs(st, level)
    T = len(x["mpos"])
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(T, H)).astype(np.float32) * 0.02
    hid = rng.normal(size=(T, H)).astype(np.float32)
    ar = np.arange(T, dtype=np.int32)
    jm = JaxMeta(jnp.ones(T, jnp.int32), jnp.asarray(x["mpos"]), jnp.asarray(ar),
                 jnp.asarray(ar), jnp.zeros(T, jnp.int32))
    tree = level is not None
    with spec_tree_context(TREE.anc_bits if tree else None):
        jh, jdkv = jd.step(
            jdp, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(st["dkv"]),
            jnp.asarray(x["rpos"]), jnp.asarray(x["slots"]), jnp.asarray(x["pt"]),
            jnp.asarray(x["mpos"] + 1), jm,
            mask_positions=jnp.asarray(x["mpos"]) if tree else None,
            win_base=jnp.asarray(x["wb"]) if tree else None)
    dkv = _t(st["dkv"].copy())
    th = td.step(_t(emb), _t(hid), dkv, _t(x["rpos"]), _t(x["slots"]), _t(x["pt"]),
                 _t(x["mpos"] + 1), port_eagle._decode_meta(_t(x["mpos"])),
                 mask_positions=_t(x["mpos"]) if tree else None,
                 win_base=_t(x["wb"]) if tree else None,
                 spec_anc=tuple(TREE.anc_bits) if tree else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(jdkv), atol=2e-5, rtol=2e-5)


# --------------------------------------------------- the masked MLA extend
HQ, LORA, ROPE, DPAD, L = 4, 128, 64, 256, 2
WIDTH = LORA + ROPE


def _pad(a):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, DPAD - a.shape[-1])])


def _mla_tree_case(seed, prefix, level, dtype, rows):
    """A tree round's attention over a latent pool [L, 1, S, 1, 192]:
    requests with ``prefix`` committed positions, each followed by TREE's
    window (slot-order positions prefix + j), on shuffled pages. Without
    ``level``: the verify (N rows a request); with it: that draft level,
    B * n rows of q_len 1 over the tiled page table. The port's pool has
    NaN in every slot no live position holds; ``rows``: the latent rows'
    dtype (an fp8 pool holds the same bytes on both sides)."""
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
    pool = (rng.normal(size=(L, 1, S, 1, WIDTH)) * 0.5).astype(np.float32)
    win_base = np.asarray(prefix, np.int32)
    if level is None:
        q_lens = np.full(B, N, np.int64)
        kv_lens = np.asarray(prefix, np.int64) + N
        T = B * N
        jm, pm = jax_meta(q_lens, kv_lens, T), build_attn_meta(q_lens, kv_lens, T)
        q_req = np.repeat(np.arange(B), N)
        mpos = (np.asarray(prefix)[:, None] + np.arange(N)[None]).reshape(-1)
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
        q_req = ar
        table, wb = np.tile(pt, (len(nodes), 1)), np.tile(win_base, len(nodes))
    q = (rng.normal(size=(T, HQ, WIDTH)) * 0.5).astype(np.float32)
    port_pool = pool.copy()
    dead = np.ones(S, bool)
    dead[sorted(live)] = False
    port_pool[:, :, dead] = np.nan
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    if rows == "fp8_e4m3":
        jpool = _pad(pool.astype(ml_dtypes.float8_e4m3fn))
        tpools = [_t(a.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)).view(torch.float8_e4m3fn)
                  for a in (port_pool, pool)]
    else:
        rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[rows]
        jpool = jnp.asarray(_pad(pool), rdt)
        tpools = [_t(a).to({"float32": torch.float32, "bfloat16": torch.bfloat16}[rows])
                  for a in (port_pool, pool)]
    # ref_pool: the finite pool, for the reference attention, which reads
    # every slot of a request's pages (and 0 x NaN is NaN)
    return dict(jq=jnp.asarray(_pad(q), jdt), jpool=jnp.asarray(jpool), tq=_t(q).to(tdt),
                tpool=tpools[0], ref_pool=tpools[1], pt=table, kv_lens=kv_lens.astype(np.int32), wb=wb.astype(np.int32),
                jmeta=jm, pmeta=pm, q_req=q_req.astype(np.int32), mpos=mpos.astype(np.int32))


def _port_mla(c, anc=TREE.anc_bits, fn=rpa.ragged_paged_attention, **kw):
    return fn(c["tq"], c["tpool"], 1, _t(c["pt"]), _t(c["kv_lens"]), c["pmeta"],
              page_size=PS, scale=WIDTH ** -0.5, v_dim=LORA, spec_anc=tuple(anc),
              win_base=_t(c["wb"]), **kw).float().numpy()


# (prefixes, draft level, q dtype, latent rows): windows across page
# boundaries, shuffled pages
MLA_TREE_CASES = {
    "verify_f32": ([40, 17, 3], None, "float32", "float32"),
    "verify_bf16": ([40, 17, 3], None, "bfloat16", "bfloat16"),
    "verify_bf16_e4m3": ([23, 50], None, "bfloat16", "fp8_e4m3"),
    "verify_f32_e4m3": ([23, 50], None, "float32", "fp8_e4m3"),
    "draft_level1_f32": ([40, 17, 3], 1, "float32", "float32"),
    "draft_level2_bf16_e4m3": ([23, 50], 2, "bfloat16", "fp8_e4m3"),
    "draft_level4_bf16": ([40, 17, 3], 4, "bfloat16", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(MLA_TREE_CASES))
def test_plain_masked_mla_extend_matches_jax_kernel(case):
    """The latent pool's routing with a tree (the plain MLA extend) against
    _rpa_kernel's MLA branch in interpret mode (its pool and q zero-padded
    to 256) and against the JAX reference attention with slot-order
    positions; a chain of the same window gives another answer."""
    prefix, level, dtype, rows = MLA_TREE_CASES[case]
    c = _mla_tree_case(7, prefix, level, dtype, rows)
    want = np.asarray(jax_rpa(
        c["jq"], c["jpool"], 1, jnp.asarray(c["pt"]), jnp.asarray(c["kv_lens"]), c["jmeta"],
        page_size=PS, scale=WIDTH ** -0.5, v_dim=LORA, interpret=True,
        spec_anc=TREE.anc_bits, win_base=jnp.asarray(c["wb"])).astype(jnp.float32))
    got = _port_mla(c)
    assert got.shape == (len(c["mpos"]), HQ, LORA) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    ref = np.asarray(jax_reference(
        c["jq"], c["jpool"], 1, jnp.asarray(c["pt"]), jnp.asarray(c["q_req"]),
        jnp.asarray(c["mpos"]), jnp.asarray(c["kv_lens"]), page_size=PS,
        scale=WIDTH ** -0.5, v_dim=LORA, spec_anc=TREE.anc_bits,
        win_base=jnp.asarray(c["wb"])).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])
    # the port's reference attention (v_dim and spec_anc together) is JAX's
    mine = ragged_paged_attention_reference(
        c["tq"], c["ref_pool"], 1, _t(c["pt"]), _t(c["q_req"]), _t(c["mpos"]), _t(c["kv_lens"]),
        page_size=PS, scale=WIDTH ** -0.5, v_dim=LORA, spec_anc=TREE.anc_bits,
        win_base=_t(c["wb"])).float().numpy()
    np.testing.assert_allclose(mine, ref, atol=TOL[dtype], rtol=TOL[dtype])
    chain = tuple((1 << (j + 1)) - 1 for j in range(TREE.num_nodes))
    assert np.abs(_port_mla(c, anc=chain) - got).max() > 1e-3


def test_decode_shaped_tree_batch_on_the_latent_pool_takes_the_extend(monkeypatch):
    """A NextN tree draft step (T == B with spec_anc) on the latent pool
    goes to the MLA extend, streaming asked or not; without the tree the
    same batch decodes."""
    def refuse(*a, **k):
        raise AssertionError("a tree batch reached a decode")

    for name in ("ragged_paged_attention_packed", "ragged_paged_attention_stream"):
        monkeypatch.setattr(rpa, name, refuse)
    c = _mla_tree_case(3, [23, 50], 1, "float32", "float32")
    for stream in (False, True):
        got = _port_mla(c, stream=stream)
        want = _port_mla(c, fn=rpa.ragged_paged_attention_extend_plain)
        assert got.shape[0] == c["pt"].shape[0]  # decode-shaped
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError, match="reached a decode"):
        rpa.ragged_paged_attention(c["tq"], c["tpool"], 1, _t(c["pt"]), _t(c["kv_lens"]),
                                   c["pmeta"], page_size=PS, scale=0.1, v_dim=LORA)


def test_compact_slots_on_the_latent_pool():
    """The tree's KV compaction on the 5D latent pool [L, 1, S, 1, Dlat]:
    each destination slot gets its source's row as it was before the copy
    (sources and destinations overlap), other slots unchanged."""
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(3, 1, 64, 1, DLAT)).astype(np.float32)
    src = np.array([9, 12, 5, 20, 21])
    dst = np.array([5, 6, 7, 20, 9])
    want = pool.copy()
    want[:, :, dst] = pool[:, :, src]
    got = _t(pool.copy())
    port_eagle._compact_slots(got, _t(src), _t(dst))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ rounds
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
def test_nextn_round_matches_jax(kind, refresh):
    """eagle_round (gamma 3) and eagle_tree_round (the (3, 1, 1) tree) with
    the NextN draft on latent pools, against JAX's rounds."""
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
def _engines(algo, **extra):
    """A JAX and a port Engine for ``algo`` holding the same predictive
    weights; the port's draft drew the JAX draft's numbers itself."""
    spec = dict(ALGOS[algo], **extra)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               **SERVE, **spec),
                     model_config=JaxModelConfig(**CFG))
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **spec),
                  ModelConfig(**CFG), device="cpu")
    jr, tr = jeng.runner, teng.runner
    assert isinstance(jr.draft_model, JaxNextN) and isinstance(tr.draft_model, NextNDraftModel)
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
    short = [rng.integers(0, 64, size=n).tolist() for n in (10, 23)]
    return short + [rng.integers(0, 64, size=66).tolist()]  # three chunks of 32


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
        assert teng.runner.tree_template.num_nodes == 29
        assert spec["draft_tree"] > counts0[1]["draft_tree"]
    else:
        assert spec["draft_decode"] > counts0[1]["draft_decode"]
    if rounds == "graphs":  # every round replayed, a capture per key
        rg = teng.runner.round_graphs
        assert rg.stats["replays"] == teng.runner.spec_counts["verify"] - counts0[1]["verify"]
        assert rg.stats["captures"] == len(rg.graphs) >= 1
    assert teng.flush_cache() and jeng.flush_cache()  # check_memory() inside
    # the same engine without speculation gives the same greedy tokens
    s.spec_gamma = 0
    plain = teng.generate(input_ids=_prompts(), sampling_params=SamplingParams(**SP))
    assert [o["output_ids"] for o in plain] == got and teng.flush_cache()


def test_eagle_on_the_deepseek_target_selects_nextn(pairs):
    """EAGLE on a DeepSeek target drafts with NextN over a one-layer latent
    pool, as the JAX runner picks it (the scheduler takes NEXTN as EAGLE):
    the same draft, tokens and acceptance as the NEXTN engine's."""
    _, teng = _serve(pairs("chain"))
    eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE,
                            **dict(ALGOS["chain"], speculative_algorithm="EAGLE")),
                 ModelConfig(**CFG), device="cpu")
    r = eng.runner
    assert isinstance(r.draft_model, NextNDraftModel)
    assert tuple(r.draft_kv.buffer.shape) == (1, 1, r.kv_cache.buffer.shape[2], 1, DLAT)
    assert eng.scheduler.spec_algo == teng.scheduler.spec_algo == "EAGLE"
    r.model.load_jax_params(teng.runner.model.params_tree())
    r.draft_model.load_jax_params(teng.runner.draft_model.params_tree())
    want = teng.generate(input_ids=_prompts()[:2], sampling_params=SamplingParams(**SP))
    got = eng.generate(input_ids=_prompts()[:2], sampling_params=SamplingParams(**SP))
    assert [o["output_ids"] for o in got] == [o["output_ids"] for o in want]
    assert eng.scheduler.n_spec_accepted == teng.scheduler.n_spec_accepted > 0
    assert eng.flush_cache() and teng.flush_cache()


def test_draft_pool_fp8_release_resume_and_fr_spec(tmp_path):
    """The draft pool takes the target's fp8 dtype and latent width, one
    layer; it goes and comes back with the target's; an FR-Spec map slices
    the untied lm_head; the tree serves on fp8 rows with drafts accepted."""
    tmap = tmp_path / "hot.json"
    tmap.write_text(str(list(range(0, 64, 2))))
    eng = Engine(ServerArgs(random_weights=True, device="cpu", kv_cache_dtype="fp8_e4m3",
                            speculative_token_map=str(tmap), **SERVE, **ALGOS["tree"]),
                 ModelConfig(**CFG), device="cpu")
    r = eng.runner
    S = r.kv_cache.buffer.shape[2]
    assert r.draft_kv.buffer.dtype == r.kv_cache.buffer.dtype == torch.float8_e4m3fn
    assert tuple(r.draft_kv.buffer.shape) == (1, 1, S, 1, DLAT)
    assert torch.equal(r.spec_hot_head, r.model.leaf("lm_head.w")[:, 0::2])
    assert eng.release_memory_occupation()
    assert r.kv_cache.buffer is None and r.draft_kv.buffer is None
    assert eng.resume_memory_occupation()
    assert tuple(r.draft_kv.buffer.shape) == (1, 1, S, 1, DLAT)
    params, draft = r.model.params_tree(), r.draft_model.params_tree()
    _predictive(params, draft)
    r.model.load_jax_params(params)
    r.draft_model.load_jax_params(draft)
    r.set_spec_thresholds()
    out = eng.generate(input_ids=_prompts()[:2], sampling_params=SamplingParams(**SP))
    assert all(len(o["output_ids"]) == 16 for o in out)
    assert eng.scheduler.n_spec_accepted > 0 and r.spec_counts["draft_tree"] > 0
    assert eng.flush_cache()


def test_pool_sizing_counts_the_draft(monkeypatch):
    """On the card the runner sizes the target pool from free memory after
    the draft's weights are made, and counts the draft pool's layer in each
    token's bytes: the V2-Lite geometry's 27 + 1 latent rows of 576 bf16."""
    import types

    from semi_pd_tpu_torch.runtime.model_runner import ModelRunner

    cfg = ModelConfig(**dict(CFG, num_hidden_layers=27, kv_lora_rank=512,
                             qk_rope_head_dim=64, dtype="bfloat16"))
    free = 40 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 * 2 ** 30))
    for draft, layers in ((None, 27), (object(), 28)):
        stub = types.SimpleNamespace(
            model_config=cfg, device=torch.device("cuda"), _graphs_on=False, draft_model=draft,
            server_args=ServerArgs(random_weights=True, mem_fraction_static=0.5))
        got = ModelRunner._profile_kv_tokens(stub, torch.bfloat16)
        assert got == int(free * 0.5 // (layers * 576 * 2))
