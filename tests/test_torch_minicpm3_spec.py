"""NextN speculation over a chain and a tree on a MiniCPM3 target, the port
against the JAX package on the CPU, with the same numpy inputs and weights:

- the plain masked latent extend at MiniCPM3-4B's attention geometry
  (latent 288, v_dim 256, 40 query heads: what ``rpa_extend_mla_288``'s
  TREE instantiations are held to on the card) against _rpa_kernel's MLA
  branch in interpret mode with ``spec_anc`` / ``win_base``, over the pool
  and q zero-padded to 512 as the JAX runner pads them: a tree verify (N 29
  rows a request, at most 64 an entry: the rows the JAX MLA extend writes,
  ROADMAP C1) and tree draft levels, float32, bf16 and fp8_e4m3 rows under
  float32 and bf16 q; every dead slot of the port's pool NaN;
- ``NextNDraftModel`` on the MiniCPM3 target: its leaves and
  ``init_params(seed)`` the JAX draft's, and one ``step``, decode-shaped and
  as a tree's draft level, against JAX's (the target's own layer code: the
  dense SiLU MLP, the residual scaling, the NeoX longrope pe rope);
- ``eagle_round`` and ``eagle_tree_round`` with the NextN draft on latent
  pools: tokens, accept lengths, next hidden states and both pools, with
  and without the refresh;
- the Engine: greedy tokens and ``n_spec_accepted`` equal to the JAX
  Engine's for NEXTN chain and tree, colocated and semi-PD (a prompt
  chunk-prefilling beside the speculating requests, with a fixed prefill
  chunk budget so that both schedule alike), and the port's tokens equal to
  its own non-speculating serve.

The weights are made predictive (the target's final norm ones; the draft's
norms ones and its eh_proj passing the normed embedding through a fixed
blur, with 0.01 of the fed hidden state), as tests/test_torch_nextn.py
makes them, so that rounds accept some drafts and reject others.

Model: tests/test_torch_minicpm3.py's tiny MiniCPM3 (2 layers, hidden 64, 4
heads, q_lora 48, kv_lora 32 + rope 8 = a 40-wide latent row, scale_emb 4,
scale_depth 1.4, dim_model_base 32), float32, vocab 128; for the draft
steps and the rounds with longrope on the pe head (original 128 of a 256
context, so both factor lists and mscale > 1; the JAX model is given the
rope its wrapper builds, ``_jax_longrope_model``), for the Engines without.
Tolerances: float32 2e-5 (the same float32 products in another order),
bf16 1e-2 (both compute in float32 from the same bf16 inputs and round the
output to bf16); tokens and accept lengths exact.
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
from semi_pd_tpu.speculative.nextn import NextNDraftModel as JaxNextN
from semi_pd_tpu.speculative.tree import build_tree_template as jax_build_tree

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.minicpm3 import MiniCPM3ForCausalLM
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention.rpa_common import pick_kernel
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
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TREE = default_tree_template(4, 4)  # branching (4, 2, 1, 1), 29 nodes
# the direct rounds' tree: branching (3, 1, 1), 10 nodes
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


# ------------------------------------------------ the masked latent extend at 288
HQ, LORA, ROPE = 40, 256, 32
WIDTH, JAX_W = LORA + ROPE, 512  # the JAX runner pads the latent row to a multiple of 256
SCALE = (64 + ROPE) ** -0.5  # MiniCPM3-4B's (qk_nope + qk_rope) ** -0.5
ROWS = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
        "fp8_e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}


def _cast(a: np.ndarray, name: str):
    """``a`` in dtype ``name``: numpy for JAX, torch holding the same bytes."""
    np_t, torch_t = ROWS[name]
    x = a.astype(np_t)
    if name == "float32":
        return x, _t(x)
    bits = np.uint16 if name == "bfloat16" else np.uint8
    return x, _t(x.view(bits)).view(torch_t)


def _pad(a, width=JAX_W):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _mla_tree_case(seed, prefix, level, rows, q_dtype):
    """A tree round's attention over a one-layer latent pool [1, 1, S, 1,
    288]: requests with ``prefix`` committed positions, each followed by
    TREE's window (slot-order positions prefix + j), on shuffled pages.
    Without ``level``: the verify (N rows a request); with it: that draft
    level, B * n rows of q_len 1 over the tiled page table. The port's pool
    has NaN in every slot no live position holds; JAX gets the finite pool
    and q zero-padded to 512."""
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
    pool = (rng.normal(size=(1, 1, S, 1, WIDTH)) * 0.5).astype(np.float32)
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
    q = (rng.normal(size=(T, HQ, WIDTH)) * 0.5).astype(np.float32)
    port_pool = pool.copy()
    dead = np.ones(S, bool)
    dead[sorted(live)] = False
    port_pool[:, :, dead] = np.nan
    jpool, _ = _cast(_pad(pool), rows)
    _, tpool = _cast(port_pool, rows)
    jq, _ = _cast(_pad(q), q_dtype)
    _, tq = _cast(q, q_dtype)
    return dict(jq=jnp.asarray(jq), jpool=jnp.asarray(jpool), tq=tq, tpool=tpool, pt=table,
                kv_lens=kv_lens.astype(np.int32), wb=wb.astype(np.int32), jmeta=jm, pmeta=pm)


def _port(c, anc=TREE.anc_bits):
    return rpa.ragged_paged_attention(
        c["tq"], c["tpool"], 0, _t(c["pt"]), _t(c["kv_lens"]), c["pmeta"], page_size=PS,
        scale=SCALE, v_dim=LORA, spec_anc=tuple(anc), win_base=_t(c["wb"])).float().numpy()


# (prefixes, draft level, latent rows, q dtype): windows across page
# boundaries, shuffled pages
MLA_TREE_CASES = {
    "verify_f32": ([40, 17, 3], None, "float32", "float32"),
    "verify_bf16": ([40, 17, 3], None, "bfloat16", "bfloat16"),
    "verify_e4m3_q_f32": ([23, 50], None, "fp8_e4m3", "float32"),
    "verify_e4m3_q_bf16": ([23, 50], None, "fp8_e4m3", "bfloat16"),
    "draft_level1_f32": ([40, 17, 3], 1, "float32", "float32"),
    "draft_level2_bf16_e4m3": ([23, 50], 2, "fp8_e4m3", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(MLA_TREE_CASES))
def test_plain_masked_mla_extend_at_288_matches_jax_kernel(case):
    """The latent pool's routing at 288 / 256 with a tree (the plain MLA
    extend, which rpa_extend_mla_288 is held to) against _rpa_kernel's MLA
    branch in interpret mode at Hq 40 with the same tree; a chain of the
    same window gives another answer."""
    prefix, level, rows, q_dtype = MLA_TREE_CASES[case]
    c = _mla_tree_case(7, prefix, level, rows, q_dtype)
    want = np.asarray(jax_rpa(
        c["jq"], c["jpool"], 0, jnp.asarray(c["pt"]), jnp.asarray(c["kv_lens"]), c["jmeta"],
        page_size=PS, scale=SCALE, v_dim=LORA, interpret=True, spec_anc=TREE.anc_bits,
        win_base=jnp.asarray(c["wb"])).astype(jnp.float32))
    assert pick_kernel(rpa.EXTEND_KERNELS, c["tpool"]).name == "rpa_extend_mla_288"
    got = _port(c)
    assert got.shape == (len(c["kv_lens"]) if level else len(prefix) * TREE.num_nodes, HQ,
                         LORA)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[q_dtype], rtol=TOL[q_dtype])
    chain = tuple((1 << (j + 1)) - 1 for j in range(TREE.num_nodes))
    assert np.abs(_port(c, anc=chain) - got).max() > 1e-3


# ------------------------------------------------------------------ models
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=48,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=False, rope_scaling=None)
KNOBS = dict(scale_emb=4.0, scale_depth=1.4, dim_model_base=32)
H, DLAT = TINY["hidden_size"], TINY["kv_lora_rank"] + TINY["qk_rope_head_dim"]
# MiniCPM3's longrope over the 8-dim pe head: its factor lists hold
# qk_rope_head_dim / 2 entries
LONGROPE = dict(type="longrope", original_max_position_embeddings=128,
                short_factor=[1.0, 1.5, 2.0, 3.0], long_factor=[1.2, 2.5, 4.0, 6.0])


def _jax_cfg():
    hf = types.SimpleNamespace(architectures=["MiniCPM3ForCausalLM"], hidden_act="silu",
                               attention_bias=False, **TINY, **KNOBS)
    return JaxModelConfig.from_hf_config(hf, dtype="float32")


def _jax_longrope_model():
    """The JAX MiniCPM3 with longrope. Its wrapper builds the pe head's
    rope from the config's rope_scaling (llama_variants.py:365-369), but
    only after the base class has built a rope over the whole 24-dim head,
    which a longrope list sized for the 8-dim pe head does not fit: so the
    model is built without it and given the rope its wrapper builds."""
    from semi_pd_tpu.ops.rope import RotaryEmbedding as JaxRotary

    jm = jax_create_model(_jax_cfg())
    dr = TINY["qk_rope_head_dim"]
    jm.rope = JaxRotary(head_dim=dr, rotary_dim=dr, max_position=TINY["max_position_embeddings"],
                        theta=TINY["rope_theta"], rope_scaling=dict(LONGROPE),
                        is_neox_style=True)
    return jm


def _cfg(rope_scaling=None):
    t = TINY
    return ModelConfig(
        architecture="MiniCPM3ForCausalLM", vocab_size=t["vocab_size"],
        hidden_size=t["hidden_size"], intermediate_size=t["intermediate_size"],
        num_hidden_layers=t["num_hidden_layers"],
        num_attention_heads=t["num_attention_heads"],
        num_key_value_heads=t["num_key_value_heads"],
        head_dim=t["qk_nope_head_dim"] + t["qk_rope_head_dim"], rms_norm_eps=t["rms_norm_eps"],
        max_position_embeddings=t["max_position_embeddings"],
        context_length=t["max_position_embeddings"], rope_theta=t["rope_theta"],
        rope_scaling=rope_scaling, use_mla=True, q_lora_rank=t["q_lora_rank"],
        kv_lora_rank=t["kv_lora_rank"], qk_nope_head_dim=t["qk_nope_head_dim"],
        qk_rope_head_dim=t["qk_rope_head_dim"], v_head_dim=t["v_head_dim"],
        dtype="float32", **KNOBS)


def _predictive(params, draft):
    """Make NextN accept some drafts (in place, numpy trees), as
    tests/test_torch_nextn.py does: the target's final norm ones; the
    draft's norms ones and its eh_proj passing the normed embedding through
    a fixed blur (identity plus 0.5 of a random matrix), with 0.01 of the
    fed hidden state."""
    params["final_norm"] = np.ones_like(params["final_norm"])
    for k in ("enorm", "hnorm", "head_norm"):
        draft[k] = np.ones_like(draft[k])
    w = np.array(draft["eh_proj"]["w"])
    w[:H] = np.eye(H) + 0.5 * np.random.default_rng(0).normal(size=(H, H)) / np.sqrt(H)
    w[H:] *= 0.01
    draft["eh_proj"]["w"] = w.astype(np.float32)


_MODELS = {}


def _models():
    """The JAX MiniCPM3 target and its NextN draft (the JAX init_params
    numbers, made predictive) and the port's modules holding the same
    numbers; the port's draft drew the JAX draft's numbers itself."""
    if not _MODELS:
        jm = _jax_longrope_model()
        jm.page_size = PS
        jd = JaxNextN(jm)
        params = jax.tree.map(np.array, jm.init_params(0))
        draft = jax.tree.map(np.array, jd.init_params(1))
        tm = MiniCPM3ForCausalLM(_cfg(dict(LONGROPE)), "cpu")
        np.testing.assert_array_equal(tm.rope.cos.numpy(), np.asarray(jm.rope.cos))
        assert tm.rope.mscale == jm.rope.mscale > 1.0
        tm.page_size = PS
        td = NextNDraftModel(tm, "cpu")
        td.init_params(1)
        jax.tree.map(np.testing.assert_array_equal, td.params_tree(), draft)
        _predictive(params, draft)
        tm.load_jax_params(params)
        td.load_jax_params(draft)
        _MODELS.update(jax=(jm, jd, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, draft)), port=(tm, td))
    return _MODELS


def test_draft_mirrors_the_dense_last_layer():
    """The NextN draft's leaves on MiniCPM3 are the JAX draft's, in its
    tree order: eh_proj, the three norms, then the target's last layer,
    which is dense (a SiLU gate_up / down, no router and no experts); the
    draft holds its own leaves only."""
    (_, jd, _, _), (tm, td) = _models()["jax"], _models()["port"]
    flat, _ = jax.tree_util.tree_flatten_with_path(jd.init_params(1))
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        "".join(f"['{k}']" for k in path.split(".")) for path, _ in td.param_specs()]
    paths = [p for p, _ in td.param_specs()]
    assert paths[:4] == ["eh_proj.w", "enorm", "head_norm", "hnorm"]
    assert "layer.gate_up.w" in paths and not any("expert" in p or "router" in p
                                                  for p in paths)
    assert sum(1 for _ in td.parameters()) == len(paths)
    assert tm.residual_mult is not None and tm.rope.is_neox_style


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
    L = TINY["num_hidden_layers"]
    kv = rng.normal(size=(L, 1, S, 1, DLAT)).astype(np.float32) * 0.1
    dkv = rng.normal(size=(1, 1, S, 1, DLAT)).astype(np.float32) * 0.1
    prev = rng.normal(size=(hb.B, H)).astype(np.float32)
    return dict(**_models(), hb=hb, jb=jb, kv=kv, dkv=dkv, prev=prev)


def _level_inputs(st, level):
    """A tree draft level's step inputs, as eagle_tree_round builds them."""
    hb, nodes = st["hb"], ROUND_TREE.level_nodes[level]
    B, N = hb.B, ROUND_TREE.num_nodes
    cat = lambda a: np.concatenate([a.reshape(B, N)[:, j] for j in nodes]).astype(np.int32)
    return dict(rpos=cat(hb.q_pos), slots=cat(hb.out_slots), mpos=cat(hb.mask_pos),
                pt=np.tile(hb.page_table, (len(nodes), 1)),
                wb=np.tile(hb.mask_pos.reshape(B, N)[:, 0], len(nodes)).astype(np.int32))


@pytest.mark.parametrize("level", [None, 1, 3], ids=["decode", "tree_level1", "tree_level3"])
def test_draft_step_matches_jax(level):
    """One NextN step on the MiniCPM3 target: decode-shaped over the latent
    draft pool (a chain's draft step), or a tree's draft level with the
    tree's masks; the hidden state and the pool after the step's latent
    write, at rope positions past the longrope's original length."""
    st = _round_state(tree=ROUND_TREE)
    (_, jd, _, jdp), (_, td) = st["jax"], st["port"]
    if level is None:
        pos = np.array([20, 47, 31, 200], np.int32)
        slots = st["hb"].out_slots.reshape(st["hb"].B, -1)[:, 0].astype(np.int32)
        x = dict(rpos=pos, slots=slots, mpos=pos, pt=st["hb"].page_table, wb=None)
    else:
        x = _level_inputs(st, level)
    T = len(x["mpos"])
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(T, H)).astype(np.float32) * 0.02
    hid = rng.normal(size=(T, H)).astype(np.float32)
    ar = np.arange(T, dtype=np.int32)
    jmeta = JaxMeta(jnp.ones(T, jnp.int32), jnp.asarray(x["mpos"]), jnp.asarray(ar),
                    jnp.asarray(ar), jnp.zeros(T, jnp.int32))
    tree = level is not None
    with spec_tree_context(ROUND_TREE.anc_bits if tree else None):
        jh, jdkv = jd.step(
            jdp, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(st["dkv"]),
            jnp.asarray(x["rpos"]), jnp.asarray(x["slots"]), jnp.asarray(x["pt"]),
            jnp.asarray(x["mpos"] + 1), jmeta,
            mask_positions=jnp.asarray(x["mpos"]) if tree else None,
            win_base=jnp.asarray(x["wb"]) if tree else None)
    dkv = _t(st["dkv"].copy())
    th = td.step(_t(emb), _t(hid), dkv, _t(x["rpos"]), _t(x["slots"]), _t(x["pt"]),
                 _t(x["mpos"] + 1), port_eagle._decode_meta(_t(x["mpos"])),
                 mask_positions=_t(x["mpos"]) if tree else None,
                 win_base=_t(x["wb"]) if tree else None,
                 spec_anc=tuple(ROUND_TREE.anc_bits) if tree else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(jdkv), atol=2e-5, rtol=2e-5)


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
def test_nextn_round_on_minicpm3_matches_jax(kind, refresh):
    """eagle_round (gamma 3) and eagle_tree_round (the (3, 1, 1) tree) with
    the NextN draft on the MiniCPM3 target's latent pools, against JAX's
    rounds."""
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
ALGOS = {"chain": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=3),
         "tree": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=3,
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
    assert isinstance(jr.draft_model, JaxNextN) and isinstance(tr.draft_model, NextNDraftModel)
    assert isinstance(tr.model, MiniCPM3ForCausalLM)
    # the draft pool: one layer of the target's exactly-40-wide latent pool
    assert tuple(tr.draft_kv.buffer.shape) == (1, 1, tr.kv_cache.buffer.shape[2], 1, DLAT)
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
