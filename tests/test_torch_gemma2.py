"""The port's Gemma-2 path against the JAX package on the CPU, with the same
numpy inputs:

- GELU's tanh approximation (``gelu_and_mul``, registered as "gelu" and
  "gelu_pytorch_tanh") and Gemma's (1 + w) RMSNorm (``gemma_rms``) against
  ``semi_pd_tpu/ops/elementwise.py`` and ``semi_pd_tpu/models/gemma2.py``;
- the model (``semi_pd_tpu/models/gemma2.py:35 Gemma2ForCausalLM``) at a
  tiny config at head_dim 256 (3 layers, hidden 64, Hq 4, Hkv 2, window 8
  on the even layers, ``query_pre_attn_scalar`` 64 so that the scale is
  not head_dim's, softcaps that bite, float32): parameters drawn leaf for
  leaf as JAX draws them, logits of an extend step (prompts past the
  window) and two decode steps within 1e-4 of the JAX model's, and the
  greedy tokens of the JAX Engine, colocated and semi-PD;
- a Gemma-2 config without the optional fields takes the JAX model's
  defaults (scale head_dim ** -0.5, softcaps 50 / 30, window 4096 on the
  even layers);
- the plain decode, stream and extend at head_dim 256 on the 5D pool (what
  the three ``_256`` builds are held to on the card) against the TPU
  kernels' GQA branches in interpret mode, with a softcap and a window
  that cuts (the stream has no window), bf16 and fp8_e4m3 KV at the
  tolerances of tests/test_torch_minicpm3.py's PAIRS;
- the routing: ``pick_kernel`` gives the ``_256`` builds; under
  ``decode_stream`` a windowed batch stays on the packed decode and equals
  the JAX router's (``_rpa_kernel``, RPA_DECODE_STREAM=1); head_dim 512 is
  refused; a speculation tree on the 256 extend takes its routing and
  equals the TPU kernel's (the rest of the tree's tests are in
  tests/test_torch_gemma2_spec.py).
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
from semi_pd_tpu.models import gemma2 as jax_gemma2
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.ops import elementwise as jax_elementwise
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
from semi_pd_tpu_torch.models.gemma2 import Gemma2ForCausalLM, gemma_rms
from semi_pd_tpu_torch.ops import elementwise
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream
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


# ------------------------------------------------------------ elementwise
def test_gelu_and_gemma_rms_match_jax():
    """gelu_and_mul (tanh approximation, under both HF names) and
    gemma_rms (float32, times 1 + w, then cast) within 1e-6 of JAX's in
    float32 (GELU's products of up to 16 within 1e-5); gemma_rms in bf16
    bitwise the JAX cast's."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(7, 2 * 48)) * 3).astype(np.float32)
    want = np.asarray(jax_elementwise.gelu_and_mul(jnp.asarray(x)))
    for name in ("gelu", "gelu_pytorch_tanh"):
        assert elementwise.ACT2FN[name] is elementwise.gelu_and_mul
        assert jax_elementwise.ACT2FN[name] is jax_elementwise.gelu_and_mul
        np.testing.assert_allclose(elementwise.ACT2FN[name](_t(x)).numpy(), want,
                                   rtol=1e-6, atol=1e-5)
    h = (rng.normal(size=(5, 64)) * 4).astype(np.float32)
    w = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(gemma_rms(_t(h), _t(w), 1e-6).numpy(),
                               np.asarray(jax_gemma2._gemma_rms(jnp.asarray(h), jnp.asarray(w),
                                                                1e-6)),
                               rtol=1e-6, atol=1e-6)
    hb = h.astype(ml_dtypes.bfloat16)
    ours = gemma_rms(_t(hb.view(np.uint16)).view(torch.bfloat16), _t(w), 1e-6)
    ref = np.asarray(jax_gemma2._gemma_rms(jnp.asarray(hb), jnp.asarray(w), 1e-6))
    np.testing.assert_array_equal(ours.view(torch.uint16).numpy(), ref.view(np.uint16))


# ------------------------------------------------------------------ model
# a tiny Gemma-2 at head_dim 256; the window (8) is shorter than the
# prompts, query_pre_attn_scalar is not head_dim, and the softcaps bite at
# these magnitudes
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=256,
            max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6)
GEMMA = dict(query_pre_attn_scalar=64, sliding_window=8, attn_logit_softcapping=0.05,
             final_logit_softcapping=0.5)


def _jax_cfg(gemma=GEMMA):
    """The tiny config through the JAX package's HF parsing; Gemma-2 reads
    its own fields from the SimpleNamespace with getattr."""
    hf = types.SimpleNamespace(architectures=["Gemma2ForCausalLM"],
                               hidden_act="gelu_pytorch_tanh", attention_bias=False,
                               tie_word_embeddings=True, **TINY, **gemma)
    return JaxModelConfig.from_hf_config(hf, dtype="float32")


def _cfg(gemma=GEMMA):
    """The same config for the port, built directly."""
    g = dict(query_pre_attn_scalar=gemma.get("query_pre_attn_scalar"),
             sliding_window=gemma.get("sliding_window"),
             attn_logit_softcap=gemma.get("attn_logit_softcapping"),
             logit_softcap=gemma.get("final_logit_softcapping"))
    return ModelConfig(architecture="Gemma2ForCausalLM", hidden_act="gelu_pytorch_tanh",
                       context_length=TINY["max_position_embeddings"], dtype="float32",
                       **TINY, **g)


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


def test_gemma2_logits_match_jax():
    """The port's Gemma2ForCausalLM draws the JAX parameters leaf for leaf
    (the unread post_norm leaf kept), resolves the same scale, softcaps and
    per-layer windows, and gives the JAX model's logits within 1e-4 over an
    extend step (a 150-token prompt past the window, spanning two work-list
    entries, and a 37-token one) and two decode steps, on the 5D pool at
    head_dim 256 (float32, the JAX reference attention)."""
    jm = jax_create_model(_jax_cfg())
    tm = Gemma2ForCausalLM(_cfg(), device="cpu")
    assert ARCHITECTURES["Gemma2ForCausalLM"] is Gemma2ForCausalLM
    assert tm.scale == jm.scale == 64 ** -0.5
    assert tm.layer_windows == [8, None, 8]
    assert [w is not None for w in tm.layer_windows] == jm.layer_sliding
    assert (tm.config.attn_logit_softcap, tm.config.logit_softcap) == (
        jm.config.attn_logit_softcap, jm.config.logit_softcap) == (0.05, 0.5)
    assert tm.config.tie_word_embeddings and tm.lm_head is None
    jm.page_size = tm.page_size = PS
    jparams = jm.init_params(seed=7)
    tm.init_params(seed=7)
    assert [p for p, _ in tm.param_specs()] == [
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    jax.tree.map(np.testing.assert_array_equal, tm.params_tree(),
                 jax.tree.map(np.asarray, jparams))
    L, Hkv, D = TINY["num_hidden_layers"], TINY["num_key_value_heads"], TINY["head_dim"]
    S = 40 * PS
    jpool = jnp.zeros((L, 2, S, Hkv, D), jnp.float32)
    tpool = torch.zeros((L, 2, S, Hkv, D))
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
    for step in range(3):
        jl, (jpool,) = jm.forward(jparams, _jax_fb(hb), (jpool,))
        tl = tm(hb.to_device("cpu"), tpool)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        assert np.abs(tl.numpy()[:2]).max() <= 0.5  # the final softcap
        for r, tok in zip(reqs, np.asarray(jl)[:2].argmax(-1)):
            if step == 0:
                r.prefilled_len = r.prompt_len
            r.output_ids.append(int(tok))
        hb = build_decode_batch(reqs, page_table, PS, [4], [16])


def test_gemma2_defaults_are_the_jax_models():
    """Without query_pre_attn_scalar, softcaps, window or layer_types the
    port takes what the JAX model reads as defaults: head_dim's scale,
    softcaps 50 / 30, a 4096 window on the even layers; layer_types, where
    given, pick the windowed layers."""
    jm = jax_create_model(_jax_cfg({}))
    tm = Gemma2ForCausalLM(_cfg({}), device="cpu")
    assert tm.scale == jm.scale == 256 ** -0.5
    assert (tm.config.attn_logit_softcap, tm.config.logit_softcap) == (
        jm.config.attn_logit_softcap, jm.config.logit_softcap) == (50.0, 30.0)
    assert tm.layer_windows == [4096, None, 4096] and jm._sliding_window == 4096
    assert [w is not None for w in tm.layer_windows] == jm.layer_sliding
    types_ = ["full_attention", "sliding_attention", "sliding_attention"]
    cfg = _cfg()
    cfg.layer_types = types_
    jcfg = _jax_cfg(dict(GEMMA, layer_types=types_))
    assert [w is not None for w in Gemma2ForCausalLM(cfg, device="cpu").layer_windows] == \
        jax_create_model(jcfg).layer_sliding == [False, True, True]


def test_device_init_draws_the_sandwich_norms():
    """The runner's random weights (device_init_params) fill every leaf of
    Gemma-2's tree, the three sandwich norms included, each from its own
    generator (no two leaves alike), at 0.02 N(0, 1) a layer at a time; the
    same seed draws the same numbers."""
    from semi_pd_tpu_torch.model_loader.loader import device_init_params

    a, b = (Gemma2ForCausalLM(_cfg(), device="cpu") for _ in range(2))
    device_init_params(a, seed=3)
    device_init_params(b, seed=3)
    seen = []
    for path, shape in a.param_specs():
        x = a.leaf(path)
        assert x.shape == shape and torch.equal(x, b.leaf(path)), path
        assert 0.015 < float(x.std()) < 0.025, path
        seen.append(x.flatten()[:8])
    assert len({tuple(v.tolist()) for v in seen}) == len(seen)
    assert not torch.equal(a.post_ffw_norm[0], a.post_ffw_norm[1])


SERVE = dict(page_size=4, max_total_tokens=1024, chunked_prefill_size=64)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax(semi_pd):
    """The port's Engine serving the tiny Gemma-2 on its 5D pool at head_dim
    256, with the JAX Engine's parameters, gives the JAX Engine's greedy
    tokens exactly; prompts and outputs run past the window."""
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, dtype="float32",
                                               **SERVE),
                     model_config=_jax_cfg())
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE), _cfg(), device="cpu")
    assert isinstance(teng.runner.model, Gemma2ForCausalLM)
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    buf = teng.runner.kv_cache.buffer
    assert buf.shape[1] == 2 and buf.shape[3:] == (2, 256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (9, 17, 70)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert teng.flush_cache() and jeng.flush_cache()


# --------------------------------------------- the GQA kernels at head_dim 256
HQ, HKV, D = 4, 2, 256
SCALE = D ** -0.5  # Gemma-2-9B's query_pre_attn_scalar 256
CAP, WINDOW = 1.0, 24
KV = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
      "fp8_e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
# (KV, q dtype, tolerance): tests/test_torch_minicpm3.py's PAIRS
PAIRS = [("float32", "float32", 2e-5), ("bfloat16", "bfloat16", 1e-2),
         ("fp8_e4m3", "float32", 2e-5), ("fp8_e4m3", "bfloat16", 1e-2)]
PAIR_IDS = [f"{k}-q_{q}" for k, q, _ in PAIRS]


def _cast(a: np.ndarray, name: str):
    """``a`` in the dtype ``name`` for JAX (numpy of the ml_dtypes type) and
    for torch (the same bytes)."""
    np_t, torch_t = KV[name]
    x = a.astype(np_t)
    if name == "float32":
        return x, _t(x)
    bits = np.uint16 if name == "bfloat16" else np.uint8
    return x, _t(x.view(bits)).view(torch_t)


def _setup(seed, q_lens, kv_lens, kv, q_dtype, pad_T=0, pad_B=0):
    """A one-layer 5D pool [1, 2, S, 2, 256] in ``kv``, queries [T, 4, 256]
    in ``q_dtype``, a shuffled page table and the lengths, with optional
    bucket padding. Scores reach a few units, so that CAP bites."""
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
    pool = (rng.normal(size=(1, 2, total * PS, HKV, D)) * 0.5).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, HQ, D)).astype(np.float32)
    jpool, tpool = _cast(pool, kv)
    jq, tq = _cast(q, q_dtype)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    return dict(jq=jnp.asarray(jq), tq=tq, jpool=jnp.asarray(jpool), tpool=tpool, pt=pt,
                q_lens=ql, kv_lens=kl, T=T)


def _close(out: torch.Tensor, ref, rows, tol):
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(jnp.asarray(ref, jnp.float32))[rows],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kv,q_dtype,tol", PAIRS, ids=PAIR_IDS)
def test_plain_decode_matches_jax_packed_kernel_at_256(kv, q_dtype, tol):
    """The port's plain decode (what rpa_decode_aligned_256 is held to)
    against _rpa_kernel_packed's GQA branch in interpret mode at head_dim
    256, with softcap 1.0 and a window of 24 that cuts the longer rows,
    and a padded row (kv_len 0 writes zeros)."""
    kv_lens = [33, 0, 64, 17, 50]
    d = _setup(3, [1] * 5, kv_lens, kv, q_dtype)
    kvl = np.asarray(kv_lens, np.int32)
    kw = dict(logit_cap=CAP, sliding_window=WINDOW)
    ref = jax_packed(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                     page_size=PS, scale=SCALE, rpb=2, kv_block=32, interpret=True, **kw)
    out = rpa_packed.ragged_paged_attention_packed(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=SCALE, **kw)
    assert out.shape == (5, HQ, D) and out.dtype == d["tq"].dtype
    _close(out, ref, kvl > 0, tol)
    assert not out[1].any(), "rows with kv_len == 0 must be zeros"
    # the window and the cap change the result: both are applied
    plain = rpa_packed.ragged_paged_attention_packed(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=SCALE)
    assert (out - plain).float().abs().max() > 10 * tol


@pytest.mark.parametrize("kv,q_dtype,tol", PAIRS, ids=PAIR_IDS)
def test_plain_stream_matches_jax_stream_kernel_at_256(kv, q_dtype, tol, monkeypatch):
    """The port's streaming route (plain on the CPU: the decode's, what
    rpa_decode_stream_aligned_256 is held to) against _rpa_kernel_stream's
    GQA branch (RPA_DECODE_STREAM=1 on the JAX call only) at head_dim 256,
    with softcap 1.0 (the stream has no window)."""
    kv_lens = [33, 0, 50]
    d = _setup(5, [1] * 3, kv_lens, kv, q_dtype)
    kvl = np.asarray(kv_lens, np.int32)
    meta = (np.ones(3, np.int64), kvl.astype(np.int64), 3)
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        m.setenv("RPA_STREAM_NBUF", "3")
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jax_meta(*meta), page_size=PS, scale=SCALE, logit_cap=CAP, kv_block=16,
                      interpret=True)
    out = rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), build_attn_meta(*meta), page_size=PS,
        scale=SCALE, logit_cap=CAP, stream=True)
    _close(out, ref, kvl > 0, tol)
    assert not out[1].any()


EXTEND_256 = {
    # prefix + new tokens, a padded batch row and padded token rows
    "prefix": ([20, 1, 7], [60, 9, 30], 0),
    # q_len > 128: two work-list entries, the window cutting the prefix
    "two_entries": ([140, 3], [150, 40], 5),
}


# every pair on the prefix case; the two-entry case (interpret mode's
# longest) in float32
EXTEND_RUNS = [(*p, "prefix") for p in PAIRS] + [(*PAIRS[0], "two_entries")]


@pytest.mark.parametrize("kv,q_dtype,tol,case", EXTEND_RUNS,
                         ids=[f"{c}-{k}-q_{q}" for k, q, _, c in EXTEND_RUNS])
def test_plain_extend_matches_jax_kernel_at_256(kv, q_dtype, tol, case):
    """The port's plain extend (what rpa_extend_aligned_256 is held to)
    against _rpa_kernel's GQA branch in interpret mode at head_dim 256,
    softcap 1.0 and a window of 24 that cuts every long row."""
    q_lens, kv_lens, pad_T = EXTEND_256[case]
    d = _setup(4, q_lens, kv_lens, kv, q_dtype, pad_T=pad_T or 5, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    kw = dict(logit_cap=CAP, sliding_window=WINDOW)
    ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                  jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=SCALE,
                  interpret=True, **kw)
    out = rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl),
        build_attn_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=SCALE, **kw)
    assert out.shape == (T, HQ, D)
    n = sum(q_lens)
    _close(out, ref, slice(0, n), tol)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


# ------------------------------------------------------------------ routing
def test_the_256_pool_picks_the_256_builds():
    """pick_kernel gives the _256 builds for a head_dim-256 5D pool and the
    128 builds for a head_dim-128 one; check_cuda takes 256 and refuses
    512, naming the ROADMAP items."""
    p256 = torch.zeros((1, 2, 4 * PS, HKV, 256), dtype=torch.bfloat16)
    p128 = torch.zeros((1, 2, 4 * PS, HKV, 128), dtype=torch.bfloat16)
    for table, name in ((rpa_packed.DECODE_KERNELS, "rpa_decode_aligned"),
                        (rpa.EXTEND_KERNELS, "rpa_extend_aligned"),
                        (rpa_stream.STREAM_KERNELS, "rpa_decode_stream_aligned")):
        assert pick_kernel(table, p256).name == name + "_256"
        assert pick_kernel(table, p128).name == name
        assert "RPA_HEAD_DIM=256" in pick_kernel(table, p256).defines
    ints = (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    check_cuda(torch.zeros((2, HQ, 256), dtype=torch.bfloat16), p256, *ints)
    p512 = torch.zeros((1, 2, 4 * PS, HKV, 512), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP A9 .*B9.4"):
        check_cuda(torch.zeros((2, HQ, 512), dtype=torch.bfloat16), p512, *ints)


def test_a_windowed_decode_stays_packed_under_stream(monkeypatch):
    """With decode_stream a windowed decode batch takes the packed decode
    (the stream has no window), and its output equals the JAX router's,
    which runs _rpa_kernel for it (RPA_DECODE_STREAM=1); a batch without a
    window takes the stream."""
    kv_lens = [33, 0, 64, 50]
    d = _setup(9, [1] * 4, kv_lens, "float32", "float32")
    kvl = np.asarray(kv_lens, np.int32)
    meta = (np.ones(4, np.int64), kvl.astype(np.int64), 4)
    assert not rpa._streams(True, d["tpool"], WINDOW) and rpa._streams(True, d["tpool"], None)
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jax_meta(*meta), page_size=PS, scale=SCALE, logit_cap=CAP,
                      sliding_window=WINDOW, interpret=True)
    out = rpa.ragged_paged_attention(
        d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), build_attn_meta(*meta), page_size=PS,
        scale=SCALE, logit_cap=CAP, sliding_window=WINDOW, stream=True)
    _close(out, ref, kvl > 0, 2e-5)
    calls = []
    monkeypatch.setattr(rpa, "ragged_paged_attention_stream",
                        lambda *a, **k: calls.append("stream") or out)
    monkeypatch.setattr(rpa, "ragged_paged_attention_packed",
                        lambda *a, **k: calls.append("packed") or out)
    for window in (WINDOW, None):
        rpa.ragged_paged_attention(
            d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), build_attn_meta(*meta),
            page_size=PS, scale=SCALE, logit_cap=CAP, sliding_window=window, stream=True)
    assert calls == ["packed", "stream"]


def test_a_tree_on_the_256_extend_is_refused():
    """No longer refused: a speculation tree on the 256 pool takes the
    extend's routing (rpa_extend_aligned_256, its TREE instantiations on the
    card; the plain masked extend here) and equals _rpa_kernel's GQA branch
    in interpret mode with the same tree, softcap and window; the tree
    changes the answer."""
    d = _setup(7, [3, 2], [10, 6], "float32", "float32")
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    assert pick_kernel(rpa.EXTEND_KERNELS, d["tpool"]).name == "rpa_extend_aligned_256"
    assert "RPA_NO_TREE" not in rpa.EXTEND_ALIGNED_256_KERNEL.defines
    wb = np.array([7, 3], np.int32)
    kw = dict(page_size=PS, scale=SCALE, logit_cap=CAP, sliding_window=WINDOW)
    out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                     spec_anc=(1, 3, 5), win_base=_t(wb), **kw)
    ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                  jax_meta(d["q_lens"], d["kv_lens"], T), interpret=True, spec_anc=(1, 3, 5),
                  win_base=jnp.asarray(wb), **kw)
    _close(out, ref, slice(0, 5), 2e-5)
    causal = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                        **kw)
    assert (out - causal).abs().max() > 1e-3
