"""The port's streaming decode (``ServerArgs.decode_stream``, the JAX
package's ``RPA_DECODE_STREAM=1``) against the JAX package on the CPU,
with the same numpy inputs:

- the plain stream decode (the decode's plain version) on the chunked pool
  against _rpa_kernel_chunked_stream (``stream=True``, ``kv_block=16``),
  and on the aligned and the latent pool against _rpa_kernel_stream's GQA
  and MLA branches (``RPA_DECODE_STREAM=1``, ``RPA_STREAM_NBUF=3``, set on
  the JAX call only), all in interpret mode: kv_lens that straddle the
  16-position blocks, a kv_len-0 row, and a batch of one;
- the routing: decode batches take each pool's stream kernel, except with
  a sliding window (the packed decode) and on the 5D pool below head_dim
  128 (the merged decode), as the JAX routing decides;
- the Engine with ``decode_stream`` against the JAX Engine's greedy tokens.

Geometry: GQA Hq 8, Hkv 4, page 16 (D 64 on the chunked pool, 128 on the
aligned one); MLA Hq 4 with a 128 + 64 latent row (the JAX kernels get it
zero-padded to 256, which leaves every score unchanged).

Tolerances: attention outputs 2e-5 (float32 both sides: an online softmax
against a full one), 2e-4 on the latent pool (the JAX MLA stream splits
each score over two 128-wide halves of the padded row); greedy tokens
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
    ragged_paged_attention_chunked as jax_rpa_chunked,
)
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.layers.attention import pool_attention
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

HQ, HKV, PS, L = 8, 4, 16, 2
HQ_MLA, LORA, ROPE, DPAD = 4, 128, 64, 256
DLAT = LORA + ROPE


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(seed, kv_lens, width, hq=HQ, pool="5d"):
    """A decode batch: queries [B, hq, width], a shuffled page table and a
    pool: "5d" [L, 2, S, HKV, width], "chunked" (the same numbers as
    [L, S, 2*HKV*width/128, 128], K chunks then V chunks) or "latent"
    [L, 1, S, 1, width]."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(max(n_pages), 1) + 1), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    S = total * PS
    if pool == "latent":
        kv5 = (rng.normal(size=(L, 1, S, 1, width)) * 0.5).astype(np.float32)
    else:
        kv5 = rng.normal(size=(L, 2, S, HKV, width)).astype(np.float32)
    q = rng.normal(size=(B, hq, width)).astype(np.float32) * (0.5 if pool == "latent" else 1)
    kvl = np.asarray(kv_lens, np.int32)
    meta_np = (np.ones(B, np.int64), kvl.astype(np.int64), B)
    tpool = _t(kv5)
    if pool == "chunked":
        tpool = _t(np.swapaxes(kv5, 1, 2).reshape(L, S, 2 * HKV * width // 128, 128))
    return dict(q=q, kv5=kv5, tpool=tpool, pt=pt, kvl=kvl, meta_np=meta_np)


STREAM_CASES = {
    "straddling": [33, 5, 16, 48, 9],
    "zero_row": [33, 0, 70, 17],
    "batch_of_one": [77],
}


def _live(d, out, ref, tol):
    live = d["kvl"] > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=tol, atol=tol)
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_chunked_stream_matches_jax_chunked_stream_kernel(case):
    """The chunked pool's stream decode against _rpa_kernel_chunked_stream."""
    d = _setup(1, STREAM_CASES[case], 64, pool="chunked")
    ref = np.asarray(jax_rpa_chunked(
        jnp.asarray(d["q"]), jnp.asarray(d["tpool"].numpy()), 1, jnp.asarray(d["pt"]),
        jnp.asarray(d["kvl"]), jax_meta(*d["meta_np"]), page_size=PS, num_kv_heads=HKV,
        head_dim=64, scale=0.125, logit_cap=5.0, interpret=True, kv_block=16, stream=True))
    out = rpa.ragged_paged_attention_chunked(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(d["kvl"]), build_attn_meta(*d["meta_np"]),
        page_size=PS, num_kv_heads=HKV, head_dim=64, scale=0.125, logit_cap=5.0,
        stream=True).numpy()
    _live(d, out, ref, 2e-5)


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_aligned_stream_matches_jax_stream_kernel(case, monkeypatch):
    """The aligned pool's stream decode (head_dim 128) against
    _rpa_kernel_stream's GQA branch."""
    d = _setup(2, STREAM_CASES[case], 128)
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        m.setenv("RPA_STREAM_NBUF", "3")
        ref = np.asarray(jax_rpa(
            jnp.asarray(d["q"]), jnp.asarray(d["kv5"]), 1, jnp.asarray(d["pt"]),
            jnp.asarray(d["kvl"]), jax_meta(*d["meta_np"]), page_size=PS, scale=0.125,
            kv_block=16, interpret=True))
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(d["kvl"]), build_attn_meta(*d["meta_np"]),
        page_size=PS, scale=0.125, stream=True).numpy()
    _live(d, out, ref, 2e-5)


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_latent_stream_matches_jax_stream_kernel(case, monkeypatch):
    """The latent pool's stream decode (the port's pool exactly 192 wide)
    against _rpa_kernel_stream's MLA branch over the zero-padded pool."""
    d = _setup(3, STREAM_CASES[case], DLAT, hq=HQ_MLA, pool="latent")
    pad = [(0, 0)] * 4 + [(0, DPAD - DLAT)]
    with monkeypatch.context() as m:
        m.setenv("RPA_DECODE_STREAM", "1")
        m.setenv("RPA_STREAM_NBUF", "3")
        ref = np.asarray(jax_rpa(
            jnp.asarray(np.pad(d["q"], pad[2:])), jnp.asarray(np.pad(d["kv5"], pad)), 1,
            jnp.asarray(d["pt"]), jnp.asarray(d["kvl"]), jax_meta(*d["meta_np"]),
            page_size=PS, scale=DLAT ** -0.5, v_dim=LORA, kv_block=16, interpret=True))
    out = rpa.ragged_paged_attention(
        _t(d["q"]), d["tpool"], 1, _t(d["pt"]), _t(d["kvl"]), build_attn_meta(*d["meta_np"]),
        page_size=PS, scale=DLAT ** -0.5, v_dim=LORA, stream=True).numpy()
    assert out.shape == (len(d["kvl"]), HQ_MLA, LORA)
    _live(d, out, ref, 2e-4)


def test_stream_routing_and_exceptions(monkeypatch):
    """Decode batches take each pool's stream kernel; a sliding window keeps
    the packed decode and the 5D pool at head_dim 64 its merged decode (the
    JAX routing's exceptions, not fallbacks); extend batches never stream;
    the stream wrapper itself refuses a window and a pool with no stream
    build."""
    seen = []

    def record(kernel, q, *a, **k):
        seen.append(kernel.name)
        return q

    monkeypatch.setattr(rpa_packed, "decode_with", record)
    monkeypatch.setattr(rpa_stream, "decode_with", record)
    monkeypatch.setattr(rpa, "_extend", record)
    kvl = [33, 5, 16]
    cases = [("chunked", _setup(4, kvl, 64, pool="chunked"), {}),
             ("aligned", _setup(4, kvl, 128), {}),
             ("merged", _setup(4, kvl, 64), {}),
             ("latent", _setup(4, kvl, DLAT, hq=HQ_MLA, pool="latent"), {"v_dim": LORA})]
    for name, d, extra in cases:
        heads = (dict(num_kv_heads=HKV, head_dim=64) if name == "chunked" else {})
        for window in (None, 24):
            attn = pool_attention(d["tpool"], stream=True)
            attn(_t(d["q"]), d["tpool"], 0, _t(d["pt"]), _t(d["kvl"]),
                 build_attn_meta(*d["meta_np"]), page_size=PS, scale=0.1,
                 sliding_window=window, **heads, **extra)
    assert seen == ["rpa_decode_stream", "rpa_decode",
                    "rpa_decode_stream_aligned", "rpa_decode_aligned",
                    "rpa_decode_merged", "rpa_decode_merged",
                    "rpa_decode_stream_mla", "rpa_decode_mla"]
    d = _setup(4, [9, 20], 128)
    q = np.concatenate([d["q"], d["q"]])  # T = 4 != B = 2: an extend batch
    meta = build_attn_meta(np.asarray([2, 2]), d["kvl"].astype(np.int64), 4)
    pool_attention(d["tpool"], stream=True)(
        _t(q), d["tpool"], 0, _t(d["pt"]), _t(d["kvl"]), meta, page_size=PS, scale=0.1)
    assert seen[-1] == "rpa_extend_aligned"
    assert pool_attention(d["tpool"], plain=True, stream=True) is rpa.ragged_paged_attention_plain
    merged = _setup(4, kvl, 64)
    with pytest.raises(NotImplementedError, match="merged"):
        rpa_stream.ragged_paged_attention_stream(
            _t(merged["q"]), merged["tpool"], 0, _t(merged["pt"]), _t(merged["kvl"]),
            page_size=PS, scale=0.1)
    with pytest.raises(TypeError):
        rpa_stream.ragged_paged_attention_stream(
            _t(d["q"]), d["tpool"], 0, _t(d["pt"]), _t(d["kvl"]), page_size=PS, scale=0.1,
            sliding_window=24)


CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=8, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=PS, max_total_tokens=2048, chunked_prefill_size=64)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_with_decode_stream_matches_jax(semi_pd):
    """The Engine with ``decode_stream`` on the chunked pool (Hkv 8, D 64)
    passes the switch to its attention routing and gives the JAX Engine's
    greedy tokens."""
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE),
                     model_config=JaxModelConfig(**CFG))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             decode_stream=True, **SERVE), ModelConfig(**CFG), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    assert teng.runner.attention.keywords == {"stream": True}
    assert teng.runner.kv_cache.buffer.dim() == 4  # the chunked pool
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    assert teng.flush_cache() and jeng.flush_cache()
