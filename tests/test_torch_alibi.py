"""The plain attention of the Llama-variant slice against the JAX package on
the CPU, with the same numpy inputs: what the card's kernels are held to.

- ALiBi: the plain decode and extend with ``alibi_slopes`` (the ALiBi
  instantiations' plain versions) against the JAX reference attention
  with ``alibi_slopes`` (semi_pd_tpu/ops/attention/reference.py, where the
  JAX layer sends ALiBi), at one and four query heads per KV head, bf16
  and float32, with a softcap on one case (the bias comes after it), a
  chunk of a prompt behind a cached prefix and a padded row;
- the aligned builds at the head groups new to this slice, G = 6
  (InternLM2-20B's and Grok-1's 48 / 8) and G = 16 (ChatGLM3-6B's and
  GLM-4-9B's 32 / 2): the plain decode, stream and extend against
  _rpa_kernel_packed, _rpa_kernel_stream (RPA_DECODE_STREAM=1 on the JAX
  call only) and _rpa_kernel in interpret mode, bf16 and float32;
- the merged builds at Hkv 36 (MiniCPM-2B's 36 heads at head_dim 64, G =
  1) against _rpa_kernel_merged in interpret mode (``force_merged=True``);
- what takes slopes: the aligned head_dim-128 decode and extend alone have
  an ALiBi instantiation (``alibi_build``), the streaming decode and a
  speculation tree refuse them.

Tolerances: float32 2e-5 (an online softmax against a full one, the same
float32 arithmetic otherwise); bf16 1e-2 (both sides compute in float32
from the same bf16 inputs and round the output to bf16).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_pd_tpu.models.llama_variants import alibi_slopes as jax_alibi_slopes
from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.ops.attention.rpa_common import alibi_build, pick_kernel
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta

PS = 16
TYPES = {"float32": (np.float32, torch.float32, 2e-5),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(seed, q_lens, kv_lens, hq, hkv, D, dtype, pad_T=0, pad_B=0):
    """A one-layer 5D pool [1, 2, S, hkv, D] and queries [T, hq, D] in
    ``dtype`` (both sides rounded from the same float32 numbers), a shuffled
    page table, the lengths, and each query row's request and position."""
    np_t, torch_t, _ = TYPES[dtype]
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
    pool = (rng.normal(size=(1, 2, total * PS, hkv, D))).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = (rng.normal(size=(T, hq, D))).astype(np.float32)
    ql = np.zeros(B, np.int64)
    ql[: len(q_lens)] = q_lens
    kl = np.zeros(B, np.int64)
    kl[: len(kv_lens)] = kv_lens
    req = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)  # padding rows see nothing
    t = 0
    for b, (n, k) in enumerate(zip(q_lens, kv_lens)):
        req[t:t + n] = b
        pos[t:t + n] = k - n + np.arange(n)
        t += n
    return dict(jq=jnp.asarray(q, np_t), tq=_t(q).to(torch_t), jpool=jnp.asarray(pool, np_t),
                tpool=_t(pool).to(torch_t), pt=pt, q_lens=ql, kv_lens=kl, T=T, req=req,
                pos=pos)


def _close(out, ref, rows, tol):
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(jnp.asarray(ref, jnp.float32))[rows],
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ ALiBi
ALIBI_CASES = [(kind, G, dt, cap) for kind in ("decode", "extend") for G in (1, 4)
               for dt in TYPES for cap in (None, 5.0) if cap is None or (G == 4 and
                                                                           dt == "float32")]


@pytest.mark.parametrize("kind,G,dtype,cap", ALIBI_CASES,
                         ids=[f"{k}-G{g}-{d}" + ("-softcap" if c else "")
                              for k, g, d, c in ALIBI_CASES])
def test_plain_alibi_matches_jax_reference(kind, G, dtype, cap):
    """The plain decode and extend with ALiBi's slopes of 4 query heads
    (Hkv 4 / G, head_dim 128) against the JAX reference attention with the
    same slopes: the query of a decode at kv_len - 1, an extend's rows at
    their own positions (a chunk behind a cached prefix, a fresh prompt of
    two work-list entries); padded rows give zeros."""
    HQ, D = 4, 128
    HKV = HQ // G
    scale = D ** -0.5
    tol = TYPES[dtype][2]
    if kind == "decode":
        q_lens, kv_lens = [1] * 4, [33, 0, 64, 17]
        d = _setup(11, q_lens, kv_lens, HQ, HKV, D, dtype)
    else:
        q_lens, kv_lens = [9, 132], [40, 132]
        d = _setup(12, q_lens, kv_lens, HQ, HKV, D, dtype, pad_T=5, pad_B=1)
    slopes = jax_alibi_slopes(HQ)
    kvl = d["kv_lens"].astype(np.int32)
    ref = jax_reference(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(d["req"]),
                        jnp.asarray(d["pos"]), jnp.asarray(kvl), PS, scale, logit_cap=cap,
                        alibi_slopes=jnp.asarray(slopes))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                     page_size=PS, scale=scale, logit_cap=cap,
                                     alibi_slopes=_t(slopes))
    n = sum(q_lens)
    live = np.zeros(d["T"], bool)
    live[:n] = d["pos"][:n] >= 0
    _close(out, ref, live, tol)
    assert not out[~torch.from_numpy(live)].any(), "padded rows must be zeros"
    # the bias shows: without it the output moves past the tolerance
    plain = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                       page_size=PS, scale=scale, logit_cap=cap)
    assert (plain.float() - out.float()).abs().max() > 10 * tol


def test_alibi_takes_the_aligned_builds_alibi_instantiations():
    """The aligned head_dim-128 decode and extend map to their ALiBi
    instantiations (in the aligned build's own library, launched by its
    entry when given the slopes, counted apart); every other build refuses
    slopes, naming ROADMAP B9.6, and the streaming decode and a tree refuse
    them on any device."""
    pool = torch.zeros((1, 2, 64, 8, 128))
    dec = pick_kernel(rpa_packed.DECODE_KERNELS, pool)
    ext = pick_kernel(rpa.EXTEND_KERNELS, pool)
    assert alibi_build(dec, rpa_packed.DECODE_ALIBI).name == "rpa_decode_aligned_alibi"
    assert alibi_build(ext, rpa.EXTEND_ALIBI).name == "rpa_extend_aligned_alibi"
    for k in ("rpa_decode_aligned_alibi", "rpa_extend_aligned_alibi"):
        base = KERNELS[k.replace("_alibi", "")]
        assert KERNELS[k].library is base and KERNELS[k].lib_path() == base.lib_path()
        assert (KERNELS[k].symbol, KERNELS[k].argtypes) == (base.symbol, base.argtypes)
        assert KERNELS[k] is not base and KERNELS[k].start_build() is None
    for other in ("rpa_decode", "rpa_decode_merged", "rpa_decode_aligned_256", "rpa_decode_mla",
                  "rpa_extend", "rpa_extend_merged", "rpa_extend_aligned_256"):
        builds = rpa_packed.DECODE_ALIBI if "decode" in other else rpa.EXTEND_ALIBI
        with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
            alibi_build(KERNELS[other], builds)
    d = _setup(13, [1] * 2, [20, 9], 8, 8, 128, "float32")
    kvl = _t(d["kv_lens"].astype(np.int32))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    slopes = _t(jax_alibi_slopes(8))
    with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
        rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), kvl, meta,
                                   page_size=PS, scale=0.1, stream=True, alibi_slopes=slopes)
    with pytest.raises(NotImplementedError, match="ROADMAP B9.6"):
        rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), kvl, meta,
                                   page_size=PS, scale=0.1, spec_anc=(1,),
                                   win_base=_t(np.array([19, 8], np.int32)),
                                   alibi_slopes=slopes)
    with pytest.raises(ValueError, match="alibi_slopes must be float32"):
        rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), kvl, meta,
                                   page_size=PS, scale=0.1, alibi_slopes=slopes[:4])


# ------------------------------------------- the head groups G = 6 and 16
def _kernels_case(kind, d, D, scale, monkeypatch):
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    jmeta = jax_meta(d["q_lens"], d["kv_lens"], T)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    if kind == "decode":
        ref = jax_packed(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                         page_size=PS, scale=scale, rpb=2, kv_block=32, interpret=True)
        out = rpa_packed.ragged_paged_attention_packed(
            d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=scale)
    elif kind == "stream":
        with monkeypatch.context() as m:
            m.setenv("RPA_DECODE_STREAM", "1")
            m.setenv("RPA_STREAM_NBUF", "3")
            ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                          jmeta, page_size=PS, scale=scale, kv_block=16, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale, stream=True)
    else:
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jmeta, page_size=PS, scale=scale, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale)
    return out, ref


HEADS_CASES = [(G, kind, dt) for G in (6, 16) for kind in ("decode", "stream", "extend")
               for dt in TYPES]


@pytest.mark.parametrize("G,kind,dtype", HEADS_CASES,
                         ids=[f"G{g}-{k}-{t}" for g, k, t in HEADS_CASES])
def test_plain_attention_at_new_head_groups(G, kind, dtype, monkeypatch):
    """The plain decode, stream and extend at G = 6 (12 / 2 heads) and G =
    16 (32 / 2) on the 5D pool at head_dim 128 against the TPU kernels'
    GQA branches in interpret mode: a packed extend row m = r * G + g of a
    query row r cut across the kernels' 16-row warp tiles at G = 6; padded
    rows zero."""
    HQ, HKV, D = 2 * G, 2, 128
    scale = D ** -0.5
    tol = TYPES[dtype][2]
    if kind == "extend":
        q_lens, kv_lens = [20, 1, 7], [60, 9, 30]
        d = _setup(14, q_lens, kv_lens, HQ, HKV, D, dtype, pad_T=5, pad_B=1)
    else:
        q_lens, kv_lens = [1] * 4, [33, 0, 64, 17]
        d = _setup(15, q_lens, kv_lens, HQ, HKV, D, dtype)
    out, ref = _kernels_case(kind, d, D, scale, monkeypatch)
    assert out.shape == (d["T"], HQ, D)
    if kind == "extend":
        n = sum(q_lens)
        _close(out, ref, slice(0, n), tol)
        assert not out[n:].any()
    else:
        kvl = d["kv_lens"]
        _close(out, ref, kvl > 0, tol)
        assert not out[1].any()


MERGED_CASES = [("decode", "float32"), ("extend", "bfloat16")]


@pytest.mark.parametrize("kind,dtype", MERGED_CASES, ids=[f"{k}-{t}" for k, t in MERGED_CASES])
def test_plain_merged_at_36_kv_heads(kind, dtype):
    """The merged pool at MiniCPM-2B's 36 KV heads (head_dim 64, G = 1: a
    slot row of 2 * 36 * 64 = 4608 elements, no multiple of 1024, so the 5D
    pool) against _rpa_kernel_merged in interpret mode."""
    HQ = HKV = 36
    D = 64
    scale = D ** -0.5
    tol = TYPES[dtype][2]
    if kind == "extend":
        q_lens, kv_lens = [12, 5], [40, 20]
        d = _setup(16, q_lens, kv_lens, HQ, HKV, D, dtype, pad_T=3)
    else:
        q_lens, kv_lens = [1] * 3, [33, 0, 40]
        d = _setup(17, q_lens, kv_lens, HQ, HKV, D, dtype)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                  jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS, scale=scale,
                  interpret=True, force_merged=True)
    out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl),
                                     build_attn_meta(d["q_lens"], d["kv_lens"], T),
                                     page_size=PS, scale=scale)
    rows = slice(0, sum(q_lens)) if kind == "extend" else kvl > 0
    _close(out, ref, rows, tol)
