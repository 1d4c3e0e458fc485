"""Port attention (semi_pd_tpu_torch.ops.attention) against the JAX package.

The same numpy inputs go through the JAX function and the port's
counterpart. On the CPU the port's kernel wrappers run their plain versions;
the JAX Pallas kernels run in interpret mode, as tests/test_rpa_kernel.py
runs them. Geometry: Hq 8, Hkv 2, D 64 (G = 4 as on the main path), page 16,
chunked pool [L, S, CT=2, 128]. The kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the references are both float32 full softmaxes with the same
summation structure (1e-5); kernel vs plain compares an online softmax with
a full one, which differ in summation order (2e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention_chunked as jax_chunked,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_chunked_packed as jax_packed,
)
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta

from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed
from semi_pd_tpu_torch.ops.attention.reference import (
    chunked_to_5d,
    ragged_paged_attention_reference,
)
from semi_pd_tpu_torch.runtime.forward_batch import (
    EXTEND_Q_BLOCK,
    build_attn_meta,
    make_attn_meta_host,
    num_q_blocks,
)

HQ, HKV, D, PS, L = 8, 2, 64, 16, 2
CT = 2 * HKV * D // 128
SCALE = 0.125


def _setup(seed, q_lens, kv_lens, pad_T=0, pad_B=0, shuffle=True):
    """Numpy inputs: chunked pool, queries, fragmented page table and the
    per-token arrays, with optional bucket padding of T and B."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens) + pad_B
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total)) if shuffle else np.arange(1, total)
    maxP = max(n_pages) + 1
    pt = np.zeros((B, maxP), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    S = total * PS
    pool = rng.normal(size=(L, S, CT, 128)).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, HQ, D)).astype(np.float32)
    qri = np.zeros(T, np.int32)
    qpos = np.zeros(T, np.int32)
    t = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        qri[t:t + ql] = b
        qpos[t:t + ql] = np.arange(kl - ql, kl)
        t += ql
    ql_all = np.zeros(B, np.int64)
    ql_all[: len(q_lens)] = q_lens
    kl_all = np.zeros(B, np.int64)
    kl_all[: len(kv_lens)] = kv_lens
    return dict(pool=pool, q=q, pt=pt, qri=qri, qpos=qpos, q_lens=ql_all,
                kv_lens=kl_all, T=T, B=B)


def _pool5(pool):
    Lp, S = pool.shape[:2]
    return np.swapaxes(pool.reshape(Lp, S, 2, HKV, D), 1, 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


REF_CASES = {
    "decode": ([1, 1, 1, 1], [33, 5, 160, 9], {}),
    "extend_prefix": ([40, 130, 7], [90, 130, 57], {}),
    "softcap": ([20, 1], [70, 18], {"logit_cap": 5.0}),
    "window": ([60, 1], [60, 50], {"sliding_window": 16}),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_matches_jax_reference(case):
    q_lens, kv_lens, kw = REF_CASES[case]
    d = _setup(1, q_lens, kv_lens, pad_T=5, pad_B=1)
    pool5 = _pool5(d["pool"])
    kvl = d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_reference(
        jnp.asarray(d["q"]), jnp.asarray(pool5), 1, jnp.asarray(d["pt"]),
        jnp.asarray(d["qri"]), jnp.asarray(d["qpos"]), jnp.asarray(kvl),
        page_size=PS, scale=SCALE, **kw))
    out = ragged_paged_attention_reference(
        _t(d["q"]), chunked_to_5d(_t(d["pool"]), HKV, D), 1, _t(d["pt"]),
        _t(d["qri"]), _t(d["qpos"]), _t(kvl), page_size=PS, scale=SCALE, **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_reference_rejects_unported_features():
    d = _setup(2, [1], [5])
    args = (_t(d["q"]), chunked_to_5d(_t(d["pool"]), HKV, D), 0, _t(d["pt"]),
            _t(d["qri"]), _t(d["qpos"]), _t(d["kv_lens"].astype(np.int32)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ragged_paged_attention_reference(*args, page_size=PS, scale=SCALE,
                                         alibi_slopes=torch.ones(HQ))
    # speculation trees are served: a one-node tree whose window starts at
    # the row's own position leaves the causal answer unchanged
    plain = ragged_paged_attention_reference(*args, page_size=PS, scale=SCALE)
    tree = ragged_paged_attention_reference(*args, page_size=PS, scale=SCALE, spec_anc=(1,),
                                            win_base=_t(d["qpos"]))
    assert torch.equal(plain, tree)


DECODE_CASES = {
    "ragged_padded_row": ([33, 5, 0, 64, 17, 160, 9], {}),
    "softcap": ([70, 18, 3, 41], {"logit_cap": 5.0}),
    "window": ([70, 18, 3, 41], {"sliding_window": 24}),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_packed_kernel(case):
    """The port's plain decode against the TPU decode kernel (interpret)."""
    kv_lens, kw = DECODE_CASES[case]
    B = len(kv_lens)
    d = _setup(3, [1] * B, kv_lens)
    kvl = np.asarray(kv_lens, np.int32)
    ref = np.asarray(jax_packed(
        jnp.asarray(d["q"]), jnp.asarray(d["pool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), page_size=PS, num_kv_heads=HKV, head_dim=D,
        scale=SCALE, rpb=2, kv_block=32, interpret=True, **kw))
    out = rpa_packed.ragged_paged_attention_chunked_packed(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(kvl), page_size=PS,
        num_kv_heads=HKV, head_dim=D, scale=SCALE, **kw).numpy()
    live = kvl > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    assert not out[~live].any(), "rows with kv_len == 0 must be zeros"


EXTEND_CASES = {
    # q_len > 128 spans two work-list blocks; prefix + new tokens; a padded
    # batch row and padded token rows
    "multi_block_prefix": ([140, 20, 1, 7], [140, 60, 9, 30], {}),
    "softcap": ([40, 130, 7], [90, 130, 57], {"logit_cap": 5.0}),
    "window": ([60, 33, 129], [60, 50, 200], {"sliding_window": 16}),
}


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_extend_plain_matches_jax_chunked_kernel(case):
    """The port's plain extend against the TPU extend kernel (interpret,
    blocked schedule) on the same work list shape (q-block 128)."""
    q_lens, kv_lens, kw = EXTEND_CASES[case]
    d = _setup(4, q_lens, kv_lens, pad_T=9, pad_B=1)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    ref = np.asarray(jax_chunked(
        jnp.asarray(d["q"]), jnp.asarray(d["pool"]), 1, jnp.asarray(d["pt"]),
        jnp.asarray(kvl), jax_meta(d["q_lens"], d["kv_lens"], T), page_size=PS,
        num_kv_heads=HKV, head_dim=D, scale=SCALE, interpret=True,
        force_blocked=True, **kw))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    out = rpa.ragged_paged_attention_chunked(
        _t(d["q"]), _t(d["pool"]), 1, _t(d["pt"]), _t(kvl), meta, page_size=PS,
        num_kv_heads=HKV, head_dim=D, scale=SCALE, **kw).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(out[:n], ref[:n], rtol=2e-5, atol=2e-5)
    assert not out[n:].any(), "bucket-padding rows must stay zero"


def test_routing_decode_when_T_equals_B():
    """T == B goes to the decode path, exactly as the JAX driver decides."""
    d = _setup(5, [1, 1, 1], [12, 40, 7])
    kvl = _t(d["kv_lens"].astype(np.int32))
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], d["T"])
    kw = dict(page_size=PS, num_kv_heads=HKV, head_dim=D, scale=SCALE)
    a = rpa.ragged_paged_attention_chunked(_t(d["q"]), _t(d["pool"]), 0, _t(d["pt"]),
                                           kvl, meta, **kw)
    b = rpa_packed.decode_attention_plain(
        _t(d["q"]), _t(d["pool"]), 0, _t(d["pt"]), kvl, **kw)
    e = rpa.extend_attention_plain(
        _t(d["q"]), _t(d["pool"]), 0, _t(d["pt"]), kvl, meta, **kw)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,q_lens", [(300, [140, 20, 1, 7]), (16, [3, 5]),
                                      (512, [128, 256, 1])])
def test_work_list_matches_jax(T, q_lens):
    """The work list uses the kernel's q-block and matches the JAX
    package's work list at the same block height."""
    from semi_pd_tpu.ops.attention.rpa_common import (
        make_attn_meta_host as jax_host, num_q_blocks as jax_nqb)

    ql = np.asarray(q_lens + [0], np.int32)
    ours = make_attn_meta_host(ql, T)
    theirs = jax_host(ql, T, EXTEND_Q_BLOCK)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert num_q_blocks(T, len(ql)) == jax_nqb(T, len(ql), EXTEND_Q_BLOCK)


def test_wrappers_reject_bad_inputs():
    d = _setup(6, [1, 1], [12, 40])
    kvl = _t(d["kv_lens"].astype(np.int32))
    kw = dict(page_size=PS, num_kv_heads=HKV, head_dim=D, scale=SCALE)
    q, pool, pt = _t(d["q"]), _t(d["pool"]), _t(d["pt"])
    with pytest.raises(ValueError, match="dtype"):
        rpa_packed.ragged_paged_attention_chunked_packed(q.double(), pool, 0, pt, kvl, **kw)
    with pytest.raises(ValueError, match="int32"):
        rpa_packed.ragged_paged_attention_chunked_packed(q, pool, 0, pt.long(), kvl, **kw)
    with pytest.raises(ValueError, match="layer"):
        rpa_packed.ragged_paged_attention_chunked_packed(q, pool, 5, pt, kvl, **kw)
    with pytest.raises(ValueError, match="Hkv"):
        rpa_packed.ragged_paged_attention_chunked_packed(
            q, pool, 0, pt, kvl, **dict(kw, num_kv_heads=3))
    with pytest.raises(ValueError, match="go together"):  # a tree needs its window starts
        rpa.ragged_paged_attention_chunked(q, pool, 0, pt, kvl, None, spec_anc=(1,), **kw)
    with pytest.raises(RuntimeError, match="no decode kernel"):
        rpa_packed.ragged_paged_attention_chunked_packed(
            q.to("meta"), pool.to("meta"), 0, pt.to("meta"), kvl.to("meta"), **kw)
