"""The port's Engine against the JAX Engine on the CPU, and the port's
isolation rules.

Both engines hold the same weights (the JAX engine's random parameters are
carried into the port with ``load_jax_params``) and serve the same greedy
requests: the output token ids must be identical, colocated and semi-PD,
with a chunked-prefill size below the longest prompt and one prompt that
hits the radix cache, at two head_dim-64 geometries: Hkv 8 (the chunked
pool, as Llama-3.2-1B) and Hkv 2 (the 5D pool and its merged kernels' path:
the JAX runner's layout rule wants a slot row of 8 chunks of 128).
``check_memory()`` passes afterwards.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=64)


def _prompts():
    rng = np.random.default_rng(0)
    first = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37)]
    # second wave: shares the first 48 tokens (3 pages) of prompt 1 -> radix hit
    second = [first[1][:48] + rng.integers(0, 512, size=30).tolist()]
    return first, second


@pytest.mark.parametrize("num_kv_heads,pool_dims", [(2, 5), (8, 4)], ids=["5d", "chunked"])
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_greedy_tokens_match_jax(semi_pd, num_kv_heads, pool_dims):
    cfg = dict(CFG, num_key_value_heads=num_kv_heads)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_semi_pd=semi_pd, **SERVE),
                     model_config=JaxModelConfig(**cfg))
    teng = Engine(ServerArgs(random_weights=True, enable_semi_pd=semi_pd, device="cpu",
                             **SERVE), ModelConfig(**cfg), device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    assert teng.runner.kv_cache.buffer.dim() == pool_dims

    first, second = _prompts()
    sp = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)
    for wave in (first, second):
        jout = jeng.generate(input_ids=wave, sampling_params=JaxSamplingParams(**sp))
        tout = teng.generate(input_ids=wave, sampling_params=SamplingParams(**sp),
                             return_logprob=True)
        assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
        assert [o["meta_info"]["cached_tokens"] for o in tout] == \
            [o["meta_info"]["cached_tokens"] for o in jout]
        assert all(len(o["meta_info"]["output_logprobs"]) == 6 for o in tout)
        assert set(tout[0]) == set(jout[0])
        assert set(tout[0]["meta_info"]) <= set(jout[0]["meta_info"])
    assert tout[0]["meta_info"]["cached_tokens"] == 48  # the radix hit
    info = teng.get_server_info()
    assert info["is_semi_pd"] == semi_pd and info["finished"] == 4
    assert teng.flush_cache() and jeng.flush_cache()  # check_memory() inside


def test_engine_refuses_unported_sampling():
    """The requests this test once saw refused (a repetition penalty, a
    regex, a logit_bias processor, top-k log-probs) are served, each beside
    a plain request, with the JAX Engine's tokens, log-probs (1e-4) and
    top-k ids; no request is refused for its sampling any more."""
    from test_torch_constrained import CharTokenizer

    tok = CharTokenizer(512)
    serve = dict(SERVE, disable_outlines_disk_cache=True)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True, **serve),
                     model_config=JaxModelConfig(**CFG), tokenizer=tok)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **serve), ModelConfig(**CFG),
                  tokenizer=tok, device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    first, _ = _prompts()
    for kw, k in (({"repetition_penalty": 1.2}, 0), ({"regex": "a+"}, 0),
                  ({"custom_logit_processor": "logit_bias",
                    "custom_params": {"logit_bias": {"65": 5.0}}}, 0), ({}, 2)):
        sp = dict(max_new_tokens=6, temperature=0.0, **kw)
        outs = []
        for eng, SP in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
            reqs = [eng.make_request(input_ids=first[0], sampling_params=SP(**sp),
                                     return_logprob=True, top_logprobs_num=k),
                    eng.make_request(input_ids=first[2], sampling_params=SP(max_new_tokens=4, temperature=0.0),
                                     return_logprob=True)]
            with eng._lock:
                for r in reqs:
                    eng.scheduler.add_request(r)
                eng._run_until_done(reqs)
            outs.append([eng._to_output(r) for r in reqs])
        jout, tout = outs
        assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
        for j, t in zip(jout, tout):
            np.testing.assert_allclose(t["meta_info"]["output_logprobs"],
                                       j["meta_info"]["output_logprobs"], atol=1e-4)
            jt, tt = j["meta_info"]["output_top_logprobs"], t["meta_info"]["output_top_logprobs"]
            assert (tt is None) == (jt is None)
            assert [ids for _, ids in tt or []] == [ids for _, ids in jt or []]
        if "regex" in kw:
            assert set(tout[0]["output_ids"]) <= {ord("a") - 32, 95}  # "a"s, then EOS
    assert teng.flush_cache() and jeng.flush_cache()


def test_engine_without_device_needs_cuda():
    """Entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(ServerArgs(random_weights=True, **SERVE), ModelConfig(**CFG))
    from semi_pd_tpu_torch.runtime.model_runner import ModelRunner

    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner(ServerArgs(random_weights=True, **SERVE), ModelConfig(**CFG))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("target", ["package", "chip_smoke", "serve_witness",
                                    "fidelity_witness", "decode_trace", "extend_shapes",
                                    "mla_decode_plans", "mla_extend_compare",
                                    "semi_pd_tpu_torch/runtime/cuda_graph_runner",
                                    "semi_pd_tpu_torch/utils/warmup",
                                    "semi_pd_tpu_torch/bench_one_batch",
                                    "semi_pd_tpu_torch/constrained/grammar",
                                    "semi_pd_tpu_torch/constrained/regex_dfa",
                                    "semi_pd_tpu_torch/constrained/json_schema",
                                    "semi_pd_tpu_torch/constrained/ebnf",
                                    "semi_pd_tpu_torch/constrained/structural_tag",
                                    "semi_pd_tpu_torch/sampling/logit_processor",
                                    "semi_pd_tpu_torch/ops/sampling",
                                    "semi_pd_tpu_torch/config/model_config",
                                    "semi_pd_tpu_torch/models/llama",
                                    "semi_pd_tpu_torch/models/gemma2",
                                    "semi_pd_tpu_torch/models/qwen2_moe",
                                    "semi_pd_tpu_torch/models/llama_variants",
                                    "semi_pd_tpu_torch/models/glm",
                                    "semi_pd_tpu_torch/models/phi3",
                                    "semi_pd_tpu_torch/models/granite",
                                    "semi_pd_tpu_torch/models/grok"])
def test_port_imports_no_jax(target):
    """No file of the port (the decode graphs, the warmup registry,
    bench_one_batch, the constrained-decoding copies, the logit processors,
    the sampler, the config parser and the Llama, Gemma, MoE and
    Llama-variant family modules named on their own; the classifiers'
    models/classify.py, the CLIP tower's models/vision.py, models/llava.py
    and models/qwen2_vl.py with their towers, and ops/rope.py's
    MRotaryEmbedding), and none of its card
    scripts (chip_smoke.py, serve_witness.py, fidelity_witness.py,
    decode_trace.py, extend_shapes.py, mla_decode_plans.py,
    mla_extend_compare.py), imports jax or anything of the JAX package."""
    files = (sorted((ROOT / "semi_pd_tpu_torch").rglob("*.py")) if target == "package"
             else [ROOT / f"{target}.py"])
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "semi_pd_tpu"), f"{f}: imports {mod}"


def test_kernel_registry_and_sources():
    """The nineteen kernels (decode and extend on the chunked, the aligned,
    the merged and the latent pool, and the three streaming decodes; the
    latent pool's three again at MiniCPM3's 288 / 256, the aligned pool's
    three again at Gemma-2's head_dim 256; the aligned decode and extend
    again as their ALiBi instantiations, in the aligned builds' libraries)
    are registered with a source in the checkout, the TPU kernel they
    replace (a function that reaches pl.pallas_call), a build library (the
    seventeen builds' own), the
    entry point the build names and a launch count; every extend kernel is
    built with the work list's q-block; the 5D pool's builds (aligned and
    merged) are -DRPA_ALIGNED, the merged ones at head_dim 64, the _256
    ones at 256; the merged
    and every MLA build keep P in float32 (-DRPA_P_F32), as
    _rpa_kernel_merged and the MLA branches of the TPU kernels compute;
    the _288 builds name their latent geometry."""
    from semi_pd_tpu_torch.kernels import KERNELS
    import semi_pd_tpu_torch.ops.attention.ragged_paged_attention  # noqa: F401

    assert set(KERNELS) == {"rpa_decode", "rpa_extend", "rpa_decode_aligned",
                            "rpa_extend_aligned", "rpa_decode_mla", "rpa_extend_mla",
                            "rpa_decode_merged", "rpa_extend_merged", "rpa_decode_stream",
                            "rpa_decode_stream_aligned", "rpa_decode_stream_mla",
                            "rpa_decode_mla_288", "rpa_extend_mla_288",
                            "rpa_decode_stream_mla_288", "rpa_decode_aligned_256",
                            "rpa_extend_aligned_256", "rpa_decode_stream_aligned_256",
                            "rpa_decode_aligned_alibi", "rpa_extend_aligned_alibi"}
    for k in KERNELS.values():
        assert k.source.exists() and k.source.suffix == ".cu"
        path, line = k.replaces.split()[0].split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {k.replaces.split()[1]}(")
        flags = " ".join(k.flags())
        assert "sm_90a" in flags and f"-DRPA_ENTRY={k.symbol}" in flags
        five_d = k.name.endswith(("_aligned", "_merged", "_aligned_256", "_aligned_alibi"))
        assert (k.library is not None) == k.name.endswith("_alibi")
        assert ("-DRPA_ALIGNED" in k.flags()) == five_d
        assert ("-DRPA_P_F32" in k.flags()) == (k.name.endswith("_merged") or "_mla" in k.name)
        assert ("-DRPA_MLA_DL=288" in k.flags()) == k.name.endswith("_288")
        assert ("-DRPA_HEAD_DIM=256" in k.flags()) == k.name.endswith("_256")
    assert len({k.lib_path() for k in KERNELS.values()}) == 17
    for name in ("rpa_extend", "rpa_extend_aligned", "rpa_extend_mla", "rpa_extend_merged",
                 "rpa_extend_mla_288", "rpa_extend_aligned_256", "rpa_extend_aligned_alibi"):
        assert "EXTEND_QBLK=128" in " ".join(KERNELS[name].flags())
    for name in ("rpa_decode_merged", "rpa_extend_merged"):
        assert "-DRPA_HEAD_DIM=64" in KERNELS[name].flags()
        assert "_rpa_kernel_merged" in KERNELS[name].replaces
    assert KERNELS["rpa_decode_stream"].replaces.endswith("_rpa_kernel_chunked_stream")
    for name in ("rpa_decode_stream_mla", "rpa_decode_stream_mla_288"):
        assert "-DRPA_MLA" in KERNELS[name].flags()
