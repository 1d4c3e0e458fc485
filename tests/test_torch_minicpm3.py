"""The port's MiniCPM3 path against the JAX package on the CPU, with the
same numpy inputs:

- longrope (``semi_pd_tpu/ops/rope.py:118-145``): the cos/sin tables bit for
  bit, with short = long factor lists, with a table that reaches past
  ``original_max_position_embeddings`` (both lists used, mscale > 1), and
  with explicit ``short_mscale`` / ``long_mscale``; the NeoX rotation of
  the pe head within 1e-6;
- the model (``semi_pd_tpu/models/llama_variants.py:343``) at the tiny
  config of tests/test_minicpm3.py (scale_emb 4, scale_depth 1.4,
  dim_model_base 32, float32): parameters drawn leaf for leaf as JAX draws
  them, logits of an extend step and two decode steps within 1e-4 of the
  JAX model's, and the greedy tokens of the JAX Engine, colocated and
  semi-PD;
- DeepSeek-V2 unchanged: its scalings stay off and its logits are the ones
  a config carrying MiniCPM3's fields gives (bitwise), within 1e-4 of JAX;
- the plain latent decode, stream and extend at MiniCPM3-4B's attention
  geometry (latent 288, v_dim 256, 40 query heads; one layer, B 2-4, kv <=
  64, entries of at most 64 rows, ROADMAP C1) against the TPU kernels'
  MLA branches in interpret mode, over the pool zero-padded to 512 as the
  JAX runner pads it and q zero-padded as ``layers/attention.py:192-201``
  pads it: float32 rows (2e-5), bf16 rows under bf16 q (1e-2: both sides
  compute in float32 and round the output to bf16, so they differ by at
  most a bf16 step at these magnitudes) and fp8_e4m3 rows under float32
  q (2e-5) and bf16 q (1e-2);
- the refusal of a latent width without a build (naming ROADMAP B9.4), and
  a speculation tree on the 288 extend taking its routing and equalling
  the TPU kernel's (the rest of the tree's tests are in
  tests/test_torch_minicpm3_spec.py).
"""

import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.models.deepseek_v2 import DeepseekV2ForCausalLM as JaxDeepseek
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.ops import rope as jax_rope
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import ForwardArrays as JaxFB
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM
from semi_pd_tpu_torch.models.minicpm3 import MiniCPM3ForCausalLM
from semi_pd_tpu_torch.ops import rope
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.ops.attention.rpa_common import check_cuda, pick_kernel
from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

PS = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ longrope
def _factors(seed, n):
    return (1.0 + np.random.default_rng(seed).random(n) * 3.0).tolist()


LONGROPE = {
    # max_position == original_max: only the short list, mscale 1
    "same_lists": (dict(rope_type="longrope", original_max_position_embeddings=256,
                        short_factor=_factors(1, 16), long_factor=_factors(1, 16)), 256),
    # the table reaches past orig: both lists, mscale sqrt(1 + ln 4 / ln 256)
    "past_orig": (dict(type="longrope", original_max_position_embeddings=256,
                       short_factor=_factors(2, 16), long_factor=_factors(3, 16)), 1024),
    # explicit per-position scales (Phi-3-small's spelling "su")
    "explicit_mscale": (dict(type="su", original_max_position_embeddings=128,
                             short_factor=_factors(4, 16), long_factor=_factors(5, 16),
                             short_mscale=1.1, long_mscale=1.3), 512),
}


@pytest.mark.parametrize("case", sorted(LONGROPE))
def test_longrope_tables_equal_jax(case):
    """The port's cos/sin tables and mscale equal semi_pd_tpu/ops/rope.py's
    bit for bit (both in float64 numpy, cast to float32), and the NeoX
    rotation of a 32-wide pe head matches within 1e-6."""
    scaling, max_pos = LONGROPE[case]
    kw = dict(head_dim=32, rotary_dim=32, max_position=max_pos, theta=10000.0,
              rope_scaling=scaling, is_neox_style=True)
    ours = rope.RotaryEmbedding(**kw)
    ref = jax_rope.RotaryEmbedding(**kw)
    np.testing.assert_array_equal(ours.cos.numpy(), np.asarray(ref.cos))
    np.testing.assert_array_equal(ours.sin.numpy(), np.asarray(ref.sin))
    assert ours.mscale == ref.mscale
    orig = scaling["original_max_position_embeddings"]
    assert (ours.mscale > 1.0) == (max_pos > orig)
    if case != "same_lists":  # the long list is used past orig
        assert not np.allclose(ours.cos.numpy()[orig + 1], ours.cos.numpy()[orig - 1])
    rng = np.random.default_rng(0)
    pos = rng.integers(0, max_pos, size=9).astype(np.int32)
    q = rng.normal(size=(9, 4, 32)).astype(np.float32)
    k = rng.normal(size=(9, 1, 32)).astype(np.float32)
    oq, ok = ours(_t(pos), _t(q), _t(k))
    rq, rk = ref(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), rtol=1e-6, atol=1e-6)


def test_rope_still_refuses_linear_and_mrope():
    """m-rope stays unported (ROADMAP A14); linear, refused here until the
    GLM / Llama-variant slice ported it, now gives the JAX table bitwise
    (the frequencies divided by the factor)."""
    with pytest.raises(NotImplementedError, match="A14"):
        rope.RotaryEmbedding(32, rope_scaling=dict(type="mrope"))
    scaling = dict(type="linear", factor=2.0)
    ours = rope.RotaryEmbedding(32, max_position=64, rope_scaling=scaling)
    ref = jax_rope.RotaryEmbedding(32, max_position=64, rope_scaling=scaling)
    np.testing.assert_array_equal(ours.cos.numpy(), np.asarray(ref.cos))
    np.testing.assert_array_equal(ours.sin.numpy(), np.asarray(ref.sin))
    base = rope.RotaryEmbedding(32, max_position=64)
    np.testing.assert_array_equal(ours.cos.numpy()[10], base.cos.numpy()[5])


# ------------------------------------------------------------------ model
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=48,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            max_position_embeddings=256, rope_theta=10000.0, rope_scaling=None,
            rms_norm_eps=1e-6, tie_word_embeddings=False)
KNOBS = dict(scale_emb=4.0, scale_depth=1.4, dim_model_base=32)


def _jax_cfg(arch, knobs=KNOBS):
    """tests/test_minicpm3.py's tiny config, through the JAX package's HF
    parsing."""
    hf = types.SimpleNamespace(architectures=[arch], hidden_act="silu", attention_bias=False,
                               **TINY, **knobs)
    return JaxModelConfig.from_hf_config(hf, dtype="float32")


def _cfg(arch="MiniCPM3ForCausalLM", knobs=KNOBS):
    """The same config for the port, built directly as an MLA config."""
    t = TINY
    return ModelConfig(
        architecture=arch, vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"], num_hidden_layers=t["num_hidden_layers"],
        num_attention_heads=t["num_attention_heads"],
        num_key_value_heads=t["num_key_value_heads"],
        head_dim=t["qk_nope_head_dim"] + t["qk_rope_head_dim"], rms_norm_eps=t["rms_norm_eps"],
        max_position_embeddings=t["max_position_embeddings"],
        context_length=t["max_position_embeddings"], rope_theta=t["rope_theta"],
        use_mla=True, q_lora_rank=t["q_lora_rank"], kv_lora_rank=t["kv_lora_rank"],
        qk_nope_head_dim=t["qk_nope_head_dim"], qk_rope_head_dim=t["qk_rope_head_dim"],
        v_head_dim=t["v_head_dim"], dtype="float32", **knobs)


def _jax_fb(hb):
    from semi_pd_tpu.ops.sampling import SamplingArrays as JaxSamplingArrays

    return JaxFB(
        input_ids=jnp.asarray(hb.input_ids), q_req_idx=jnp.asarray(hb.q_req_idx),
        q_pos=jnp.asarray(hb.q_pos), out_slots=jnp.asarray(hb.out_slots),
        page_table=jnp.asarray(hb.page_table), kv_lens=jnp.asarray(hb.kv_lens),
        logits_idx=jnp.asarray(hb.logits_idx),
        sampling=JaxSamplingArrays(*[jnp.asarray(a) for a in hb.sampling]),
        rng_key=jax.random.PRNGKey(0), num_reqs=jnp.asarray(len(hb.reqs), jnp.int32),
        attn_meta=jax_meta(hb.q_lens().astype(np.int64), hb.kv_lens.astype(np.int64), hb.T),
    )


def _logits_match(jm, tm, seed):
    """Parameters drawn leaf for leaf as JAX draws them, then one extend
    step (a prompt spanning two work-list entries) and two decode steps:
    the port's logits within 1e-4 of the JAX model's (its reference
    attention, float32 both sides). Returns the port's logits per step."""
    jm.page_size = tm.page_size = PS
    jparams = jm.init_params(seed=seed)
    tm.init_params(seed=seed)
    jax.tree.map(np.testing.assert_array_equal, tm.params_tree(),
                 jax.tree.map(np.asarray, jparams))
    Lm, dl = tm.config.num_hidden_layers, tm.kv_lora + tm.dr
    S = 40 * PS
    jpool = jnp.zeros((Lm, 1, S, 1, dl), jnp.float32)
    tpool = torch.zeros((Lm, 1, S, 1, dl))
    rng = np.random.default_rng(5)
    page_table = np.zeros((4, 16), np.int32)
    reqs = []
    for i, (n, first_page) in enumerate(((150, 1), (37, 20))):
        r = Req(rid=str(i), input_ids=rng.integers(0, 128, size=n).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = i
        r.pages = list(range(first_page, first_page + 12))
        page_table[i, :12] = r.pages
        reqs.append(r)
    hb = build_extend_batch([(r, r.prompt_len) for r in reqs], page_table, PS,
                            [256], [4], [16])
    out = []
    for step in range(3):
        jl, (jpool,) = jm.forward(jparams, _jax_fb(hb), (jpool,))
        tl = tm(hb.to_device("cpu"), tpool)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        out.append(tl[:2].clone())
        for r, tok in zip(reqs, np.asarray(jl)[:2].argmax(-1)):
            if step == 0:
                r.prefilled_len = r.prompt_len
            r.output_ids.append(int(tok))
        hb = build_decode_batch(reqs, page_table, PS, [4], [16])
    return out


def test_minicpm3_logits_match_jax():
    """The port's MiniCPM3ForCausalLM (a DeepseekV2ForCausalLM with
    scale_emb, residuals x scale_depth / sqrt(L), logits / (hidden /
    dim_model_base) and NeoX pe rope) gives the JAX MiniCPM3's logits
    within 1e-4; its scalings and rope style are JAX's."""
    jm = jax_create_model(_jax_cfg("MiniCPM3ForCausalLM"))
    tm = MiniCPM3ForCausalLM(_cfg(), device="cpu")
    assert ARCHITECTURES["MiniCPM3ForCausalLM"] is MiniCPM3ForCausalLM
    assert tm.rope.is_neox_style and jm.rope.is_neox_style
    assert (tm.embed_scale, tm.logits_div) == (jm.embed_scale, jm.logits_div) == (4.0, 2.0)
    assert tm.residual_mult == pytest.approx(jm.residual_mult, rel=1e-7)
    assert tm.scale == jm.scale
    _logits_match(jm, tm, seed=11)


def test_deepseek_v2_is_unchanged_by_the_scalings():
    """A DeepSeek-V2 config keeps its scalings off and its rope interleaved,
    also when the config carries MiniCPM3's fields (only MiniCPM3's wrapper
    reads them): its logits are bitwise the same either way, and within
    1e-4 of the JAX DeepseekV2ForCausalLM's."""
    plain = DeepseekV2ForCausalLM(_cfg("DeepseekV2ForCausalLM", {}), device="cpu")
    knobs = DeepseekV2ForCausalLM(_cfg("DeepseekV2ForCausalLM"), device="cpu")
    for m in (plain, knobs):
        assert (m.embed_scale, m.residual_mult, m.logits_div) == (None, None, None)
        assert not m.rope.is_neox_style
    jcfg = _jax_cfg("DeepseekV2ForCausalLM", {})
    a = _logits_match(JaxDeepseek(jcfg), plain, seed=3)
    b = _logits_match(JaxDeepseek(jcfg), knobs, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


SERVE = dict(page_size=4, max_total_tokens=1024, chunked_prefill_size=64)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax(semi_pd):
    """The port's Engine serving the tiny MiniCPM3 on its exact 40-wide
    latent pool, with the JAX Engine's parameters (its pool padded to 256),
    gives the JAX Engine's greedy tokens exactly."""
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, dtype="float32",
                                               **SERVE),
                     model_config=_jax_cfg("MiniCPM3ForCausalLM"))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE), _cfg(), device="cpu")
    assert isinstance(teng.runner.model, MiniCPM3ForCausalLM)
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert buf.shape[1:2] == (1,) and buf.shape[3:] == (1, 40)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (9, 17, 70)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert teng.flush_cache() and jeng.flush_cache()


# ------------------------------------------------- the latent kernels at 288
HQ, LORA, ROPE = 40, 256, 32
DLAT, JAX_W = LORA + ROPE, 512  # the JAX runner pads the latent row to a multiple of 256
SCALE = (64 + ROPE) ** -0.5  # MiniCPM3-4B's (qk_nope + qk_rope) ** -0.5
ROWS = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
        "fp8_e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
# (rows, q dtype, tolerance)
PAIRS = [("float32", "float32", 2e-5), ("bfloat16", "bfloat16", 1e-2),
         ("fp8_e4m3", "float32", 2e-5), ("fp8_e4m3", "bfloat16", 1e-2)]
PAIR_IDS = [f"{r}-q_{q}" for r, q, _ in PAIRS]


def _cast(a: np.ndarray, name: str):
    """``a`` in the dtype ``name`` for JAX (numpy of the ml_dtypes type) and
    for torch (the same bytes)."""
    np_t, torch_t = ROWS[name]
    x = a.astype(np_t)
    if name == "float32":
        return x, _t(x)
    bits = np.uint16 if name == "bfloat16" else np.uint8
    return x, _t(x.view(bits)).view(torch_t)


def _pad(a, width=JAX_W):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _setup(seed, q_lens, kv_lens, rows, q_dtype, pad_T=0, pad_B=0):
    """A one-layer latent pool [1, 1, S, 1, 288] in ``rows``, queries [T,
    40, 288] in ``q_dtype`` (both also zero-padded to 512 for JAX), a
    shuffled page table and the lengths, with optional bucket padding."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens) + pad_B
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(max(n_pages), 1) + 1), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    pool = (rng.normal(size=(1, 1, total * PS, 1, DLAT)) * 0.5).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = (rng.normal(size=(T, HQ, DLAT)) * 0.5).astype(np.float32)
    jpool, tpool = _cast(_pad(pool), rows)
    jq, tq = _cast(_pad(q), q_dtype)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    return dict(jq=jnp.asarray(jq), tq=tq[..., :DLAT].contiguous(), jpool=jnp.asarray(jpool),
                tpool=tpool[..., :DLAT].contiguous(), pt=pt, q_lens=ql, kv_lens=kl, T=T)


def _close(out: torch.Tensor, ref, rows, tol):
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(jnp.asarray(ref, jnp.float32))[rows],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,q_dtype,tol", PAIRS, ids=PAIR_IDS)
def test_plain_decode_matches_jax_packed_kernel_at_288(rows, q_dtype, tol):
    """The port's plain latent decode (what rpa_decode_mla_288 is held to)
    against _rpa_kernel_packed's MLA branch in interpret mode, Hq 40, a
    padded row (kv_len 0 writes zeros)."""
    kv_lens = [33, 0, 64, 17]
    d = _setup(3, [1] * 4, kv_lens, rows, q_dtype)
    kvl = np.asarray(kv_lens, np.int32)
    ref = jax_packed(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                     page_size=PS, scale=SCALE, v_dim=LORA, rpb=2, kv_block=32,
                     interpret=True)
    out = rpa_packed.ragged_paged_attention_packed(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=SCALE, v_dim=LORA)
    assert out.shape == (4, HQ, LORA) and out.dtype == d["tq"].dtype
    _close(out, ref, kvl > 0, tol)
    assert not out[1].any(), "rows with kv_len == 0 must be zeros"


@pytest.mark.parametrize("rows,q_dtype,tol", PAIRS, ids=PAIR_IDS)
def test_plain_stream_matches_jax_stream_kernel_at_288(rows, q_dtype, tol, monkeypatch):
    """The port's streaming route (plain on the CPU: the decode's, what
    rpa_decode_stream_mla_288 is held to) against _rpa_kernel_stream's MLA
    branch (RPA_DECODE_STREAM=1 on the JAX call only), Hq 40."""
    kv_lens = [33, 0, 50]
    d = _setup(5, [1] * 3, kv_lens, rows, q_dtype)
    kvl = np.asarray(kv_lens, np.int32)
    meta = (np.ones(3, np.int64), kvl.astype(np.int64), 3)
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        m.setenv("RPA_STREAM_NBUF", "3")
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jax_meta(*meta), page_size=PS, scale=SCALE, v_dim=LORA, kv_block=16,
                      interpret=True)
    out = rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), build_attn_meta(*meta), page_size=PS,
        scale=SCALE, v_dim=LORA, stream=True)
    _close(out, ref, kvl > 0, tol)
    assert not out[1].any()


@pytest.mark.parametrize("rows,q_dtype,tol", PAIRS, ids=PAIR_IDS)
def test_plain_extend_matches_jax_kernel_at_288(rows, q_dtype, tol):
    """The port's plain latent extend (what rpa_extend_mla_288 is held to)
    against _rpa_kernel's MLA branch in interpret mode, Hq 40: prefix + new
    tokens, entries of at most 64 rows (the rows the JAX MLA extend writes,
    ROADMAP C1), a padded batch row and padded token rows."""
    q_lens, kv_lens = [20, 1, 7], [60, 9, 30]
    d = _setup(4, q_lens, kv_lens, rows, q_dtype, pad_T=5, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                  jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=SCALE,
                  v_dim=LORA, interpret=True)
    out = rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl),
        build_attn_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=SCALE,
        v_dim=LORA)
    assert out.shape == (T, HQ, LORA)
    n = sum(q_lens)
    _close(out, ref, slice(0, n), tol)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


# ---------------------------------------------------------------- refusals
def test_latent_widths_without_a_build_are_refused():
    """check_cuda (what every wrapper runs before a launch) takes the two
    built geometries, 576 / 512 and 288 / 256, and names ROADMAP B9.4 for
    another width or a v_dim the width's build does not have."""
    ints = (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    for width, v_dim in ((576, 512), (288, 256)):
        pool = torch.zeros((1, 1, 4 * PS, 1, width), dtype=torch.bfloat16)
        check_cuda(torch.zeros((2, HQ, width), dtype=torch.bfloat16), pool, *ints, v_dim=v_dim)
    for width, v_dim in ((320, 256), (288, 128), (576, 256)):
        pool = torch.zeros((1, 1, 4 * PS, 1, width), dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="ROADMAP B9.4"):
            check_cuda(torch.zeros((2, HQ, width), dtype=torch.bfloat16), pool, *ints,
                       v_dim=v_dim)


def test_a_tree_on_the_288_extend_is_refused():
    """No longer refused: a speculation tree on the 288 pool takes the
    latent extend's routing (rpa_extend_mla_288, its TREE instantiations on
    the card; the plain masked extend here) and equals _rpa_kernel's MLA
    branch in interpret mode at Hq 40 with the same tree; the 576 build's
    plain route takes the same tree."""
    d = _setup(7, [3, 2], [10, 6], "float32", "float32")
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    assert pick_kernel(rpa.EXTEND_KERNELS, d["tpool"]).name == "rpa_extend_mla_288"
    assert "RPA_NO_TREE" not in rpa.EXTEND_MLA_288_KERNEL.defines
    wb = np.array([7, 3], np.int32)
    out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                     page_size=PS, scale=SCALE, v_dim=LORA,
                                     spec_anc=(1, 3, 5), win_base=_t(wb))
    ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                  jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=SCALE,
                  v_dim=LORA, interpret=True, spec_anc=(1, 3, 5), win_base=jnp.asarray(wb))
    _close(out, ref, slice(0, 5), 2e-5)
    causal = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                        page_size=PS, scale=SCALE, v_dim=LORA)
    assert (out - causal).abs().max() > 1e-3
    wide = torch.zeros((1, 1, d["tpool"].shape[2], 1, 576))
    q = torch.zeros((T, HQ, 576))
    out = rpa.ragged_paged_attention(q, wide, 0, _t(d["pt"]), _t(kvl), meta, page_size=PS,
                                     scale=SCALE, v_dim=512, spec_anc=(1, 3, 5),
                                     win_base=_t(wb))
    assert out.shape == (T, HQ, 512)
