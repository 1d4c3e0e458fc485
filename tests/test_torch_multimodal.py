"""The image path of the port against the JAX package on the CPU, with the
same numpy inputs, float32:

- LLaVA, Yi-VL, LLaVA-Vid (models/llava.py, the CLIP tower of
  models/vision.py) and Qwen2-VL / Qwen2.5-VL (models/qwen2_vl.py) at the
  tiny widths of tests/test_llava.py, test_yivl_llavavid.py,
  test_qwen2_vl.py and test_qwen25_vl.py (2 layers), their text configs
  at head_dim 128 (the 5D pool the port's kernels serve; the JAX tests'
  16 has no pool in the port) and Qwen's ``mrope_section`` at the
  published [16, 24, 24] (its rotary half): the parameter trees leaf for
  leaf against the JAX ``param_specs`` and ``init_params(seed)``; the
  CLIP tower at ``select_layer`` -2 and 1 and both Qwen towers (a
  non-square grid; Qwen2.5's windows padded at the grid's edge) within
  1e-5; ``MRotaryEmbedding``, ``patchify`` and ``get_mrope_positions``
  (two images) exactly;
- the Engine's greedy tokens equal to the JAX Engine's with
  ``image_data``, colocated and semi-PD, each model on one engine pair:
  prompts with an image across a prefill chunk boundary (chunks of 16),
  one with two images (LLaVA-Vid: its 16 frames), and ``input_embeds``;
  Qwen2-VL's decode steps also through the decode graphs' packed M-RoPE
  positions (the CPU's eager stand-in for a capture);
- ROADMAP C19: the JAX Engine serves a second image on the same ids from
  the first image's cached KV; the port gives the fresh engine's tokens;
- the refusals: encoded images, the mllama / MiniCPM-V / Janus strings,
  speculation on a vision-language model, the JAX ``input_embeds``
  errors.

The weights are the JAX ``init_params``' with every norm weight at 1
(``lift_norms``) and the projector's last weight x 50
(``lift_features``), both sides, so that the attention and the image
move the tokens: at 0.02 N(0, 1) the features are about the projector's
bias, the same for every image.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.ops.rope import MRotaryEmbedding as JaxMRope
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.ops.rope import MRotaryEmbedding
from semi_pd_tpu_torch.runtime.cuda_graph_runner import DecodeGraphs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.model_runner import ARCHITECTURES
from semi_pd_tpu_torch.runtime.scheduler import Scheduler
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

from test_torch_cuda_graph import EagerGraphs

IMG = 100
SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=16,
             decode_bs_buckets=[4])
GREEDY = dict(max_new_tokens=6, temperature=0.0, ignore_eos=True)


# ------------------------------------------------------------------ configs
def _text(**kw):
    from transformers import LlamaConfig

    return LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=512, tie_word_embeddings=False,
                       head_dim=128, **kw)


def llava_config(arch="LlavaForConditionalGeneration", **extra):
    from transformers import CLIPVisionConfig, LlavaConfig

    vision = CLIPVisionConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                              num_attention_heads=4, image_size=32, patch_size=16,
                              projection_dim=32)
    cfg = LlavaConfig(vision_config=vision, text_config=_text(), image_token_index=IMG,
                      vision_feature_layer=-2)
    cfg.architectures = [arch]
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def qwen_config(v25=False):
    from transformers import Qwen2_5_VLConfig, Qwen2VLConfig

    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=512, tie_word_embeddings=False,
                  image_token_id=IMG, video_token_id=101, vision_start_token_id=102,
                  vision_end_token_id=103,
                  rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]})
    if v25:
        vision = {"hidden_size": 32, "intermediate_size": 64, "depth": 2, "num_heads": 2,
                  "patch_size": 4, "temporal_patch_size": 2, "spatial_merge_size": 2,
                  "in_channels": 3, "out_hidden_size": 64, "window_size": 16,
                  "fullatt_block_indexes": [1]}
        cfg = Qwen2_5_VLConfig(vision_config=vision, **common)
        cfg.architectures = ["Qwen2_5_VLForConditionalGeneration"]
    else:
        vision = {"embed_dim": 32, "depth": 2, "num_heads": 2, "mlp_ratio": 2,
                  "patch_size": 4, "temporal_patch_size": 2, "spatial_merge_size": 2,
                  "in_channels": 3, "hidden_size": 64}
        cfg = Qwen2VLConfig(vision_config=vision, **common)
        cfg.architectures = ["Qwen2VLForConditionalGeneration"]
    cfg.text_config.head_dim = 128
    return cfg


MODELS = {
    "llava": lambda: llava_config(),
    "yivl": lambda: llava_config("YiVLForCausalLM"),
    "llavavid": lambda: llava_config("LlavaVidForCausalLM", num_frames=16,
                                     mm_spatial_pool_stride=2),
    "qwen2vl": lambda: qwen_config(),
    "qwen25vl": lambda: qwen_config(v25=True),
}


def jax_config(hf):
    """The JAX ModelConfig of ``hf``, as the JAX tests make it."""
    mc = JaxModelConfig.from_hf_config(hf, dtype="float32")
    mc.architecture = hf.architectures[0]
    mc.is_multimodal = True
    mc.hf_config = hf
    return mc


def jax_paths(tree):
    return [".".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def lift_norms(tree, path=""):
    """Every norm weight of a JAX parameter tree at 1 (in place): the
    language model's, the towers' and Yi-VL's projector LayerNorms."""
    for k, v in tree.items():
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            lift_norms(v, p)
        elif ("norm" in p or ".ln" in p or p.startswith("ln") or "ln_q" in p) and (
                not p.endswith(".b")):
            tree[k] = np.ones_like(v)
    return tree


def lift_features(tree, gain=50.0):
    """The projector's (the merger's) last weight times ``gain`` (in
    place): at 0.02 N(0, 1) the features are about its bias, the same for
    every image."""
    last = tree["proj"]["fc2"] if "proj" in tree else tree["vision"]["merger"]["fc2"]
    last["w"] = last["w"] * gain
    return tree


def image(rng, h=32, w=32):
    """A random normalized image (LLaVA's tiny tower: 32 x 32; Qwen's take
    any multiple of 8)."""
    return rng.normal(size=(3, h, w)).astype(np.float32)


def qimage(rng, h=16, w=16):
    return image(rng, h, w)


@pytest.fixture(scope="module")
def engines():
    """One (JAX Engine, port Engine) pair per model, on the same lifted
    weights, shared by the module's tests; each serve gets fresh
    schedulers."""
    cache = {}

    def get(name):
        if name not in cache:
            hf = MODELS[name]()
            jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                                       dtype="float32", **SERVE),
                             model_config=jax_config(hf))
            tree = lift_features(lift_norms(jax.tree.map(np.asarray, jeng.runner.params)))
            jeng.runner.params = jax.tree.map(jnp.asarray, tree)
            teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
                          ModelConfig.from_hf_config(hf, dtype="float32"), device="cpu")
            teng.runner.model.load_jax_params(tree)
            cache[name] = (jeng, teng)
        return cache[name]

    yield get
    cache.clear()


def fresh(pair, semi_pd=False, graphs=False):
    """Fresh schedulers on both engines, colocated or semi-PD; ``graphs``:
    the port's decode steps through DecodeGraphs (EagerGraphs)."""
    for eng, sched in zip(pair, (JaxScheduler, Scheduler)):
        assert eng.flush_cache()
        args = dataclasses.replace(eng.server_args, enable_semi_pd=semi_pd)
        eng.server_args, eng.scheduler = args, sched(args, eng.runner)
    runner = pair[1].runner
    runner.graphs = DecodeGraphs(runner, EagerGraphs()) if graphs else None


def requests(name, rng):
    """(input_ids, image_data) of three requests: an image across the
    16-token chunk boundary, two images in one prompt (LLaVA-Vid: its
    frames), and a short one."""
    if name.startswith("qwen"):
        return ([list(range(3, 16)) + [IMG] + [7, 8],
                 [5, IMG, 6, 7, IMG, 9, 10],
                 [5, 6, IMG, 30]],
                [qimage(rng), [qimage(rng, 16, 24), qimage(rng)], qimage(rng, 24, 16)])
    if name == "llavavid":
        frames = lambda: [image(rng) for _ in range(16)]
        return ([list(range(3, 10)) + [IMG, 7, 8], [5, IMG, 6], [9, 8, IMG, 30, 31]],
                [frames(), frames(), frames()])
    return ([list(range(3, 17)) + [IMG, 7, 8], [5, IMG, 6, 7, IMG, 9], [5, 6, IMG, 30]],
            [image(rng), [image(rng), image(rng)], image(rng)])


def serve(pair, ids, images, **kw):
    jeng, teng = pair
    jout = jeng.generate(input_ids=ids, image_data=images,
                         sampling_params=JaxSamplingParams(**GREEDY), **kw)
    tout = teng.generate(input_ids=ids, image_data=images,
                         sampling_params=SamplingParams(**GREEDY), **kw)
    return [o["output_ids"] for o in jout], [o["output_ids"] for o in tout]


# ----------------------------------------------------------- the parameters
@pytest.mark.parametrize("name", list(MODELS))
def test_param_trees_match_jax(name, engines):
    """Each model's tree, leaf for leaf in the JAX order, and the JAX
    ``init_params(seed)`` numbers."""
    jeng, teng = engines(name)
    jm = jeng.runner.model
    jtree = jm.init_params(5)
    tm = ARCHITECTURES[name_arch(name)](teng.runner.model_config, device="cpu")
    specs = tm.param_specs()
    assert [p for p, _ in specs] == jax_paths(jtree)
    tm.init_params(5)
    for (path, shape), leaf in zip(specs, jax.tree.leaves(jtree)):
        assert tuple(leaf.shape) == shape, path
        np.testing.assert_array_equal(tm.leaf(path).numpy(), np.asarray(leaf), err_msg=path)


def name_arch(name):
    return MODELS[name]().architectures[0]


# ---------------------------------------------------------------- the towers
@pytest.mark.parametrize("select_layer", [-2, 1])
def test_clip_tower_matches_jax(select_layer, engines):
    jeng, teng = engines("llava")
    rng = np.random.default_rng(1)
    px = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jeng.runner.model.tower.forward(jeng.runner.params["vision"],
                                                      jnp.asarray(px), select_layer))
    got = teng.runner.model.tower(torch.from_numpy(px), select_layer).numpy()
    assert got.shape == want.shape == (2, 4, 48)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen2vl", "qwen25vl"])
def test_qwen_towers_match_jax(name, engines):
    """A 16 x 24 image (a 4 x 6 patch grid, 2 x 3 merged: Qwen2.5's windows
    of 2 x 2 merged tokens padded at the edge) and a square one."""
    jeng, teng = engines(name)
    jm, tm = jeng.runner.model, teng.runner.model
    rng = np.random.default_rng(2)
    for h, w in ((16, 24), (16, 16)):
        patches, grid = tm.patchify(qimage(rng, h, w))
        want = np.asarray(jm.encode_images(jeng.runner.params, patches, grid))
        got = tm.encode_images(torch.from_numpy(patches), grid).numpy()
        assert got.shape == want.shape == (h * w // 64, 64)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- M-RoPE
def test_mrotary_embedding_matches_jax():
    """[T, 3] positions and [T] ones, the published section, exactly."""
    kw = dict(head_dim=128, rotary_dim=128, max_position=512, theta=1000000.0,
              mrope_section=[16, 24, 24])
    jr, tr = JaxMRope(dtype=jnp.float32, **kw), MRotaryEmbedding(**kw)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(9, 4, 128)).astype(np.float32)
    k = rng.normal(size=(9, 2, 128)).astype(np.float32)
    for pos in (rng.integers(0, 500, size=(9, 3)), rng.integers(0, 500, size=9)):
        jq, jk = jr(jnp.asarray(pos, jnp.int32), jnp.asarray(q), jnp.asarray(k))
        tq, tk = tr(torch.from_numpy(pos), torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_patchify_and_mrope_positions_match_jax(engines):
    jeng, teng = engines("qwen2vl")
    jm, tm = jeng.runner.model, teng.runner.model
    rng = np.random.default_rng(4)
    a, b = qimage(rng, 16, 24), qimage(rng, 24, 16)
    grids = []
    for img in (a, b):
        jp, jg = jm.patchify(img)
        tp, tg = tm.patchify(img)
        np.testing.assert_array_equal(tp, jp)
        assert tg == jg
        grids.append(tg)
    ids = [5, 6] + [IMG] * tm.n_image_tokens_for(grids[0]) + [7] + \
        [IMG] * tm.n_image_tokens_for(grids[1]) + [8, 9]
    jpos, jd = jm.get_mrope_positions(ids, grids)
    tpos, td = tm.get_mrope_positions(ids, grids)
    np.testing.assert_array_equal(tpos, jpos)
    assert td == jd and td < 0


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("name", list(MODELS))
def test_engine_tokens_match_jax(name, semi_pd, engines):
    """Three requests with images (one across the chunk boundary, one with
    two images) through both Engines: the same greedy tokens; Qwen2-VL's
    port decode steps through the decode graphs' packed rope positions."""
    pair = engines(name)
    fresh(pair, semi_pd, graphs=name == "qwen2vl")
    ids, images = requests(name, np.random.default_rng(5))
    want, got = serve(pair, ids, images)
    assert got == want
    if name == "qwen2vl":
        assert pair[1].runner.graphs.stats["replays"] > 0
    fresh(pair)


def test_images_move_the_tokens(engines):
    """The lifted weights see the image: another image, other tokens (on
    both engines, with nothing cached)."""
    pair = engines("llava")
    rng = np.random.default_rng(6)
    ids = [5, 6, IMG, 7, 8]
    a = image(rng)
    outs = []
    for img in (a, -a):
        fresh(pair)
        outs.append(serve(pair, [ids], [img]))
    assert outs[0][0] == outs[0][1] and outs[1][0] == outs[1][1]
    assert outs[0][0] != outs[1][0]


def test_input_embeds_match_jax(engines):
    """A prompt given as its embedding rows gives the tokens of the same
    ids, on both Engines (no splice of images: the whole prompt)."""
    pair = engines("llava")
    fresh(pair)
    jeng, teng = pair
    ids = list(range(3, 40))
    rows = np.asarray(jeng.runner.params["lm"]["embed"]["w"])[ids]
    by_ids = [o["output_ids"] for o in teng.generate(
        input_ids=[ids], sampling_params=SamplingParams(**GREEDY))]
    jout = jeng.generate(input_embeds=[rows], sampling_params=JaxSamplingParams(**GREEDY))
    tout = teng.generate(input_embeds=[rows], sampling_params=SamplingParams(**GREEDY))
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout] == by_ids
    single = teng.generate(input_embeds=rows, sampling_params=SamplingParams(**GREEDY))
    assert single["output_ids"] == by_ids[0]
    assert teng.flush_cache()


def test_c19_second_image_on_cached_ids(engines):
    """ROADMAP C19: the prompt [5, 6, <image>, 7 ... 20] (20 tokens with
    the image's 4: one full page of 16, the image inside), two images one
    after the other. The JAX Engine reuses the first image's cached page
    for the second and gives the first image's tokens; the port keeps
    spliced prompts out of the radix cache and gives a fresh engine's
    tokens."""
    pair = engines("llava")
    jeng, teng = pair
    rng = np.random.default_rng(7)
    ids = [5, 6, IMG] + list(range(7, 21))
    a = image(rng)
    fresh(pair)
    sp = lambda cls: cls(**GREEDY)
    j1 = jeng.generate(input_ids=ids, image_data=a, sampling_params=sp(JaxSamplingParams))
    j2 = jeng.generate(input_ids=ids, image_data=-a, sampling_params=sp(JaxSamplingParams))
    t1 = teng.generate(input_ids=ids, image_data=a, sampling_params=sp(SamplingParams))
    t2 = teng.generate(input_ids=ids, image_data=-a, sampling_params=sp(SamplingParams))
    fresh(pair)
    j_fresh = jeng.generate(input_ids=ids, image_data=-a, sampling_params=sp(JaxSamplingParams))
    assert j2["meta_info"]["cached_tokens"] == 16 and t2["meta_info"]["cached_tokens"] == 0
    assert j2["output_ids"] == j1["output_ids"] != j_fresh["output_ids"]  # the hazard
    assert t1["output_ids"] == j1["output_ids"]
    assert t2["output_ids"] == j_fresh["output_ids"]
    assert teng.flush_cache()


# ----------------------------------------------------------------- refusals
def test_refusals(engines):
    jeng, teng = engines("llava")
    fresh((jeng, teng))
    sp = SamplingParams(**GREEDY)
    for encoded in (b"\x89PNG", "aGVsbG8="):
        with pytest.raises(NotImplementedError, match="A13"):
            teng.generate(input_ids=[5, IMG], image_data=encoded, sampling_params=sp)
    rows = np.zeros((4, 64), np.float32)
    cases = [(dict(input_embeds=rows, image_data=image(np.random.default_rng(0))),
              "exclusive"),
             (dict(input_embeds=rows, input_ids=[1, 2]), "replaces the prompt"),
             (dict(input_embeds=np.zeros((0, 64), np.float32)), "num_tokens, hidden"),
             (dict(input_embeds=np.zeros((4, 32), np.float32)), "hidden size")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jeng.make_request(**kw)
        with pytest.raises(ValueError, match=msg):
            teng.make_request(kw.pop("input_ids", None), **kw)
    with pytest.raises(ValueError, match="not multimodal"):
        text = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE),
                      ModelConfig.from_hf_config(_text().to_dict() | {
                          "architectures": ["LlamaForCausalLM"]}, dtype="float32"),
                      device="cpu")
        text.generate(input_ids=[5, IMG], image_data=image(np.random.default_rng(0)),
                      sampling_params=sp)
    for arch in ("MllamaForConditionalGeneration", "MiniCPMV", "MiniCPMVForCausalLM",
                 "JanusForConditionalGeneration", "MultiModalityCausalLM"):
        with pytest.raises(NotImplementedError, match="A14"):
            ModelConfig.from_hf_config({"architectures": [arch]}, dtype="float32")
    with pytest.raises(NotImplementedError, match="A11"):
        Engine(ServerArgs(random_weights=True, device="cpu", speculative_algorithm="NGRAM",
                          **SERVE),
               ModelConfig.from_hf_config(llava_config(), dtype="float32"), device="cpu")
    assert teng.flush_cache()


def test_from_hf_config_matches_jax():
    """The port reads each vision-language config (a transformers object)
    as the JAX package does: the text config's fields, the outer
    architecture, ``is_multimodal``."""
    fields = ("architecture", "vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads", "num_key_value_heads", "head_dim",
              "rms_norm_eps", "tie_word_embeddings", "max_position_embeddings", "rope_theta",
              "context_length")
    for make in MODELS.values():
        hf = make()
        j = JaxModelConfig.from_hf_config(hf, dtype="float32")
        t = ModelConfig.from_hf_config(hf, dtype="float32")
        assert t.is_multimodal and t.hf_config is hf
        assert t.architecture == hf.architectures[0]
        for f in fields[1:]:
            assert getattr(t, f) == getattr(j, f), f
