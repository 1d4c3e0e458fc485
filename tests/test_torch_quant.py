"""Quantized weights in the port (ops/quant, model_loader/quantize.py,
layers/linear.py, the quantized leaves of models/params.py, quantized
expert stacks in ops/moe.py) against the JAX package on the CPU, with the
same numpy inputs:

- the fp8 / int8 / AWQ quantizers bit for bit at shapes whose din and dout
  are not multiples of 128 (blockwise fp8's padded tails; AWQ's group
  halved until it divides din);
- ``unpack_awq_int32`` and ``awq_to_linear_params`` exactly;
- the plain ``apply_linear`` against JAX ``apply_linear`` for the four
  leaf kinds, float32 within rtol 1e-5 and bf16 within one bf16 ulp of the
  output's scale;
- ``quantize_params`` on tiny Llama, Qwen2 (qkv bias), DeepSeek-V2 (with
  and without q_lora), Qwen2-MoE (shared expert, expert stacks) and
  Gemma-2: the JAX quantized tree's paths, dtypes and bits, by the port's
  ``quantize_params`` on the same tree, by a quantized model loading the
  JAX quantized tree (``load_jax_params``, ``params_tree``), and by one
  loading the unquantized tree and quantizing it itself; the Qwen2.5-VL
  tower, which the JAX rule would quantize, stays unquantized in the port;
- quantized ``moe_ffn`` against JAX's;
- greedy Engine tokens equal to the JAX Engine's for the four methods on
  a float32 tiny Llama, and for ``blockwise_fp8`` on a tiny DeepSeek-V2;
- the awq_int4 KV-dtype rule, and ``weight_bytes`` counting the
  quantized leaves.
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
from semi_pd_tpu.layers.linear import apply_linear as jax_apply_linear
from semi_pd_tpu.model_loader.quantize import _quant_one
from semi_pd_tpu.model_loader.quantize import quantize_params as jax_quantize_params
from semi_pd_tpu.models.registry import create_model as jax_create_model
from semi_pd_tpu.ops import moe as jax_moe
from semi_pd_tpu.ops.quant import fp8 as jax_fp8
from semi_pd_tpu.ops.quant import int4 as jax_int4
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.layers.linear import QuantWeight, apply_linear
from semi_pd_tpu_torch.model_loader import quantize as tq
from semi_pd_tpu_torch.model_loader.loader import device_init_params
from semi_pd_tpu_torch.ops import moe
from semi_pd_tpu_torch.ops.quant import fp8 as tfp8
from semi_pd_tpu_torch.ops.quant import int4 as tint4
from semi_pd_tpu_torch.ops.quant import wo_gemm
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

METHODS = ["fp8", "int8", "blockwise_fp8", "awq_int4"]
# jitted, as the JAX quantize_params runs it (XLA then divides by a constant
# through its float32 reciprocal; op by op JAX divides)
jax_quant_one = jax.jit(_quant_one, static_argnums=(1, 2))
# din and dout off 128: blockwise tails; AWQ din 200 -> group 8, 136 -> 8
SHAPES = [(200, 300), (2, 136, 260), (256, 384)]


def _np(x):
    """A JAX or torch leaf as numpy of its own dtype (fp8 as ml_dtypes')."""
    if torch.is_tensor(x):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
        return x.numpy()
    return np.asarray(x)


def _bits(a):
    a = _np(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _assert_same_leaves(got, want):
    """Two trees of the same paths, dtypes and bits."""
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        assert _np(g).dtype == _np(w).dtype and _np(g).shape == _np(w).shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _weight(shape, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w.flat[::97] *= 9.0  # outliers: per-block absmax varies
    return w


# ------------------------------------------------------------------ quantizers
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("method", METHODS)
def test_quant_one_bitwise(method, shape):
    """``_quant_one`` gives JAX's quantized leaves bit for bit (from the
    bf16-rounded weight, as the runner quantizes a bf16 model's)."""
    w = _weight(shape, seed=len(shape))
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tq._quant_one(wb, method)
    want = jax_quant_one(jnp.asarray(w, jnp.bfloat16), method)
    assert len(got) == len(want) == (3 if method == "awq_int4" else 2)
    for g, j in zip(got, want):
        assert _np(g).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(_bits(g), _bits(j))
    shapes = tq.quant_shapes(shape, method)
    assert [tuple(t.shape) for t in got] == [s for s, _ in shapes.values()]
    assert [t.dtype for t in got] == [d for _, d in shapes.values()]


def test_fp8_module_functions_bitwise():
    """fp8.py's quantizers, per channel, blockwise (tails) and per token,
    and FP8_MAX, as JAX's (jitted)."""
    assert tfp8.FP8_MAX == jax_fp8.FP8_MAX
    w = _weight((200, 300), seed=3)
    for fn in ("quantize_fp8_per_channel", "quantize_fp8_blockwise", "quantize_fp8_per_token"):
        got = getattr(tfp8, fn)(torch.from_numpy(w))
        want = jax.jit(getattr(jax_fp8, fn))(jnp.asarray(w))
        for g, j in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(j))


def test_awq_unpack_exact():
    """``unpack_awq_int32`` and ``awq_to_linear_params`` equal JAX's."""
    rng = np.random.default_rng(2)
    qweight = rng.integers(-2 ** 31, 2 ** 31, size=(64, 16), dtype=np.int64).astype(np.int32)
    qzeros = rng.integers(-2 ** 31, 2 ** 31, size=(2, 16), dtype=np.int64).astype(np.int32)
    scales = rng.random((2, 128)).astype(np.float16)
    assert tint4.AWQ_ORDER == jax_int4.AWQ_ORDER
    np.testing.assert_array_equal(tint4.unpack_awq_int32(qweight),
                                  jax_int4.unpack_awq_int32(qweight))
    got = tint4.awq_to_linear_params(qweight, qzeros, scales, 32)
    want = jax_int4.awq_to_linear_params(qweight, qzeros, scales, 32)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


# ------------------------------------------------------------------ apply_linear
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
def test_apply_linear_plain_matches_jax(method, dtype):
    """The plain quantized linear (with a bias) against JAX apply_linear
    on the same leaves and input: float32 within rtol 1e-5; bf16 within
    one bf16 ulp of the output's largest magnitude (the two sum in other
    orders before the last rounding)."""
    w = _weight((200, 300), seed=4)
    leaves = jax_quant_one(jnp.asarray(w), method)
    names = ("w", "ws", "wz")[:len(leaves)]
    jp = dict(zip(names, leaves))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 200)).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32) * 0.1
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_apply_linear(dict(jp, b=jnp.asarray(b, jdt)),
                                       jnp.asarray(x, jdt)).astype(jnp.float32))
    tp = {n: torch.from_numpy(np.array(_bits(a))).view(
        torch.float8_e4m3fn) if np.asarray(a).dtype == ml_dtypes.float8_e4m3fn
        else torch.from_numpy(np.array(a)) for n, a in jp.items()}
    tdt = getattr(torch, dtype)
    got = apply_linear(torch.from_numpy(x).to(tdt), tp, torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp
    # the same leaves held as a QuantWeight (a model's) give the same output
    qw = QuantWeight(tp, tq.leaf_method("linear", method))
    np.testing.assert_array_equal(
        apply_linear(torch.from_numpy(x).to(tdt), qw, torch.from_numpy(b).to(tdt)).float(),
        got)


def test_wrappers_refuse_other_devices_and_split_k():
    """A wrapper takes the plain version only for a CPU tensor and raises
    for a tensor on another device than the CPU or the card (a meta
    tensor; the card's refusals of float32 activations and e5m2 weights
    are tests/test_torch_cuda.py's); the K splits of decode- and
    extend-sized products."""
    x = torch.zeros(4, 64, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(64, 64, device="meta", dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="CUDA tensors or the CPU"):
        wo_gemm.wo_gemm(x, w, torch.zeros(64, device="meta"))
    assert wo_gemm.split_k(64, 4096, 14336, 132) == 5  # the 8B's down at B 64
    assert wo_gemm.split_k(64, 28672, 4096, 132) == 1  # its gate_up: 448 tiles
    assert wo_gemm.split_k(4096, 4096, 4096, 132) == 1


# ------------------------------------------------------------------ the trees
def hf(arch, **kw):
    return {**dict(architectures=[arch], vocab_size=128, hidden_size=64,
                   intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=128, max_position_embeddings=256,
                   rope_theta=10000.0, rms_norm_eps=1e-6, hidden_act="silu",
                   tie_word_embeddings=False), **kw}


DS = dict(architectures=["DeepseekV2ForCausalLM"], vocab_size=128, hidden_size=128,
          intermediate_size=192, num_hidden_layers=3, num_attention_heads=4,
          num_key_value_heads=4, max_position_embeddings=256, rope_theta=10000.0,
          rms_norm_eps=1e-6, hidden_act="silu", tie_word_embeddings=False, q_lora_rank=None,
          kv_lora_rank=128, qk_nope_head_dim=64, qk_rope_head_dim=64, v_head_dim=64,
          n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=48,
          n_shared_experts=1, first_k_dense_replace=1, topk_method="greedy",
          moe_layer_freq=1)
TREES = {
    "llama": hf("LlamaForCausalLM"),
    "qwen2": hf("Qwen2ForCausalLM", num_key_value_heads=4),
    "deepseek_v2": DS,
    "deepseek_v2_q_lora": dict(DS, q_lora_rank=96),
    "qwen2_moe": hf("Qwen2MoeForCausalLM", num_key_value_heads=4, num_experts=8,
                    num_experts_per_tok=2, moe_intermediate_size=32,
                    shared_expert_intermediate_size=64, norm_topk_prob=False),
    "gemma2": hf("Gemma2ForCausalLM", head_dim=256, hidden_act="gelu_pytorch_tanh",
                 tie_word_embeddings=True, query_pre_attn_scalar=64, sliding_window=8,
                 attn_logit_softcapping=50.0, final_logit_softcapping=30.0),
}


def _models(name, method):
    """The JAX model's init_params tree (numpy) and a quantized port model."""
    jcfg = JaxModelConfig.from_hf_config(types.SimpleNamespace(**TREES[name]),
                                         dtype="float32")
    tcfg = ModelConfig.from_hf_config(TREES[name], dtype="float32", quantization=method)
    jparams = jax.tree.map(np.asarray, jax_create_model(jcfg).init_params(seed=3))
    return jparams, ARCHITECTURES[tcfg.architecture](tcfg, device="cpu")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", list(TREES))
def test_quantize_params_matches_jax(name, method):
    """The JAX ``quantize_params`` tree of a tiny model, three ways: the
    port's ``quantize_params`` of the same tree; a quantized port model
    loading the JAX quantized tree (``load_jax_params`` bit for bit,
    ``params_tree`` giving it back, ``tree_specs`` naming its paths and
    dtypes); the same model loading the unquantized tree and quantizing it
    itself. Expert stacks become per-channel fp8 / int8 {"w", "ws"}."""
    jparams, tm = _models(name, method)
    jq = jax.tree.map(np.asarray, jax_quantize_params(jparams, method))
    ported = tq.quantize_params(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams),
                                method)
    _assert_same_leaves(ported, jq)
    tm.load_jax_params(jq)
    got = tm.params_tree()
    _assert_same_leaves(got, jq)
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert [(p, s) for p, s, _ in tm.tree_specs()] == [
        (".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), a.shape)
        for path, a in flat]
    assert [str(d).split(".")[-1] for _, _, d in tm.tree_specs()] == [
        a.dtype.name for _, a in flat]
    kinds = {tq.quant_kind(p, len(s)) for p, s in tm.param_specs()}
    moe_tree = name in ("deepseek_v2", "deepseek_v2_q_lora", "qwen2_moe")
    assert "linear" in kinds and ("experts" in kinds) == moe_tree
    _, tm2 = _models(name, method)
    tm2.load_jax_params(jparams)
    _assert_same_leaves(tm2.params_tree(), jq)


def test_qwen25_vl_tower_stays_unquantized():
    """The JAX rule quantizes every ``gate_up`` / ``down`` node, the
    Qwen2.5-VL tower's ``vision.blocks.gate_up`` too, whose JAX tower
    multiplies ``y @ bp["gate_up"]["w"]`` without its scale; the port
    quantizes the language model's linears only and keeps the tower (and
    LLaVA's CLIP tower and projector) in the model dtype."""
    from semi_pd_tpu_torch.models.qwen2_vl import Qwen2_5_VLForConditionalGeneration
    from test_torch_multimodal import qwen_config

    assert tq.quant_kind("vision.blocks.gate_up.w", 3) == "linear"  # the JAX rule
    cfg = ModelConfig.from_hf_config(qwen_config(v25=True), dtype="float32",
                                     quantization="fp8")
    tm = Qwen2_5_VLForConditionalGeneration(cfg, device="cpu")
    specs = {p: d for p, _, d in tm.tree_specs()}
    assert specs["layers.qkv_proj.w"] == torch.float8_e4m3fn
    assert "layers.qkv_proj.ws" in specs
    assert specs["vision.blocks.gate_up.w"] == torch.float32
    assert not any(p.startswith("vision.") and p.endswith((".ws", ".wz")) for p in specs)


# ------------------------------------------------------------------ moe
@pytest.mark.parametrize("method", ["fp8", "int8"])
def test_moe_ffn_quantized_matches_jax(method):
    """Quantized expert stacks through ``moe_ffn`` (bf16 rows, the stack
    dequantized to bf16) against JAX's ``moe_ffn`` on the same leaves, a
    float32 input: within 2 bf16 ulps of the output's scale."""
    rng = np.random.default_rng(8)
    T, E, d, F, K = 13, 8, 48, 24, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    jw, jidx = jax_moe.route_topk(jnp.asarray(logits), K)
    stacks = [(rng.standard_normal(s) * 0.2).astype(np.float32)
              for s in ((E, d, 2 * F), (E, F, d))]
    jq = [dict(zip(("w", "ws"), jax_quant_one(jnp.asarray(s), method))) for s in stacks]
    want = np.asarray(jax_moe.moe_ffn(jnp.asarray(x), jq[0], jq[1], jw, jidx))
    tqs = [{"w": torch.from_numpy(np.array(_bits(p["w"]))).view(torch.float8_e4m3fn)
            if method == "fp8" else torch.from_numpy(np.array(p["w"])),
            "ws": torch.from_numpy(np.array(p["ws"]))} for p in jq]
    w, idx = torch.from_numpy(np.array(jw)), torch.from_numpy(np.array(jidx))
    got = moe.moe_ffn(torch.from_numpy(x), tqs[0], tqs[1], w, idx)
    assert got.dtype == torch.float32
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.numpy() - want).max() <= 2 * ulp
    held = QuantWeight(tqs[0], method), QuantWeight(tqs[1], method)
    np.testing.assert_array_equal(moe.moe_ffn(torch.from_numpy(x), *held, w, idx).numpy(),
                                  got.numpy())


# ------------------------------------------------------------------ engines
LLAMA = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
             intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
             context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=64)


def _engine_pair(jcfg, tcfg, method, **serve):
    if method == "awq_int4":  # float32 KV: its rule would give a float32 model bf16 KV
        serve = dict(serve, kv_cache_dtype="float32")
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               quantization=method, **serve),
                     model_config=jcfg)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", quantization=method, **serve),
                  tcfg, device="cpu")
    # the JAX runner's tree is quantized already: carried bit for bit
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    return jeng, teng


def _same_tokens(jeng, teng, vocab, lens=(20, 100, 37), max_new=6):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in lens]
    sp = dict(max_new_tokens=max_new, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=prompts, sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]


@pytest.mark.parametrize("method", METHODS)
def test_engine_tokens_match_jax_llama(method):
    """``ServerArgs(quantization=m)`` serves a float32 tiny Llama with the
    JAX Engine's greedy tokens (both quantize their linears; the port's
    leaves are the JAX runner's, carried over)."""
    jeng, teng = _engine_pair(JaxModelConfig(**LLAMA), ModelConfig(**LLAMA), method, **SERVE)
    qkv = teng.runner.model.qkv_proj
    assert isinstance(qkv, QuantWeight) and qkv.method == method
    assert teng.runner.model_config.quantization == method
    _same_tokens(jeng, teng, LLAMA["vocab_size"])


def test_engine_tokens_match_jax_deepseek_blockwise():
    """``blockwise_fp8`` on a tiny DeepSeek-V2: its dense linears blockwise,
    its expert stacks per-channel fp8; the JAX Engine's greedy tokens."""
    jcfg = JaxModelConfig.from_hf_config(types.SimpleNamespace(**DS), dtype="float32")
    tcfg = ModelConfig.from_hf_config(DS, dtype="float32")
    jeng, teng = _engine_pair(jcfg, tcfg, "blockwise_fp8", page_size=16, max_total_tokens=2048,
                              chunked_prefill_size=64)
    m = teng.runner.model
    assert m.leaf("layers.1.kv_a.w").method == "blockwise_fp8"
    assert m.leaf("layers.1.experts.gate_up").method == "fp8"
    assert not isinstance(m.leaf("layers.1.router.w"), QuantWeight)
    _same_tokens(jeng, teng, DS["vocab_size"])


def test_awq_int4_kv_rule():
    """awq_int4 with kv_cache_dtype "auto" serves bf16 KV, as JAX's
    ServerArgs rules; other methods keep "auto"; "none" opts out; an
    unknown method is refused; the port refuses the bf16 KV the rule gives
    a float32 model (the pools hold KV in q's dtype or fp8) when it makes
    its pool."""
    for method, kv in (("awq_int4", "bfloat16"), ("fp8", "auto"), (None, "auto")):
        assert ServerArgs(quantization=method).kv_cache_dtype == kv
        assert JaxServerArgs(quantization=method).kv_cache_dtype == kv
    assert ServerArgs(quantization="awq_int4", kv_cache_dtype="fp8_e4m3").kv_cache_dtype == \
        "fp8_e4m3"
    assert ServerArgs(quantization="none").quantization is None
    with pytest.raises(ValueError, match="quantization"):
        ServerArgs(quantization="gguf")
    with pytest.raises(NotImplementedError, match="B9.8"):
        Engine(ServerArgs(random_weights=True, device="cpu", quantization="awq_int4", **SERVE),
               ModelConfig(**LLAMA), device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_weight_bytes_counts_quantized_leaves(method):
    """``weight_bytes`` is the bytes of the leaves as held: the quantized
    ones at their own width (1 byte a weight, 4 a scale, 1 a zero), the
    embedding, lm_head and norms at the model dtype; random weights drawn
    layer by layer are quantized as they are drawn."""
    teng = Engine(ServerArgs(random_weights=True, device="cpu", quantization=method, **SERVE),
                  ModelConfig(**dict(LLAMA, dtype="bfloat16")), device="cpu")
    m = teng.runner.model
    want = 0
    for path, shape in m.param_specs():
        n = int(np.prod(shape))
        if tq.quant_kind(path, len(shape)):
            want += sum(int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
                        for s, d in tq.quant_shapes(shape, method).values())
        else:
            want += 2 * n
    assert teng.runner.weight_bytes == want
    full = sum(2 * int(np.prod(s)) for _, s in m.param_specs())
    assert want < full
    # the drawn weights are quantized where they were drawn: a layer's
    # quantized leaves equal _quant_one of the bf16 weight drawn again
    ref = ARCHITECTURES["LlamaForCausalLM"](ModelConfig(**dict(LLAMA, dtype="bfloat16")),
                                            device="cpu")
    device_init_params(ref, 0, "cpu")
    res = tq._quant_one(ref.qkv_proj[1], method)
    for got, t in zip(m.qkv_proj[1].values(), res):
        np.testing.assert_array_equal(_bits(got), _bits(t))
