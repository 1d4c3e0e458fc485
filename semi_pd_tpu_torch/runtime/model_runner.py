"""ModelRunner: device, model + weights, KV pool sizing, the step (port of
semi_pd_tpu/runtime/model_runner.py for the main path).

The runner exposes the surface the scheduler calls: ``page_allocator``,
``req_pool``, ``max_context_len``, ``max_running_requests``,
``model_config``, ``step_packed`` / ``step_packed_raw`` (with chained
``prev_tokens``), ``step_host`` (a grammar mask or logit bias, penalties),
``step_topk_host`` (top-k log-probs too), ``score_step_host`` /
``score_topk_host`` (teacher-forced input log-probs), ``encode_step_host``
(pooled embeddings) and ``read_results``. A step decodes the
two packed host vectors of ``HostBatch.pack()`` (one host->device copy
each), runs the model over the shared KV pool (updated in place: prefill
and decode are two shapes of one step on one pool), samples on the device
and returns device tensors without waiting for them. ``read_results``
brings a whole flush of steps back in one device->host copy.

The model class follows the architecture (``ARCHITECTURES``: the Llama
family's five strings, Mistral, Xverse, Qwen2 with its qkv bias and Qwen3
with its q/k norms among them; Gemma-1 and Gemma-2 at head_dim 256, the
latter with per-layer windows and softcaps; the GQA MoE families Mixtral,
Qwen2-MoE, Qwen3-MoE and OLMoE; DeepSeek-V2/V3 with MLA + MoE; MiniCPM3,
MLA with a dense MLP, whose 288-wide latent rows take the latent kernels'
_288 builds; the Llama-computation variants InternLM2 and its reward
model, ExaOne, Baichuan (ALiBi at Baichuan2-13B's hidden 5120, refused
with ``decode_stream``, speculation or another pool than the 5D one at
head_dim 128: ROADMAP B9.6), QWen v1, MiniCPM, XverseMoe, DeepSeek-V1,
the GLM family, Phi-3, Granite and Grok-1; the LayerNorm families
StableLM, Starcoder2, Phi, Cohere, OLMo-2, Phi-3-small, GPT-2, GPT-BigCode,
OLMo-1, Falcon and DBRX, with GPT-2's context held to its learned
positions and Falcon's new decoder architecture and ALiBi refused, as the
JAX classes refuse them; the sequence classifiers and the embedding
trunks, served through ``encode_step``; the vision-language models LLaVA,
Yi-VL, LLaVA-Vid, Qwen2-VL and Qwen2.5-VL, whose towers ``encode_images``
/ ``encode_images_patches`` run on the step device, their features
spliced into the prefill (``HostBatch.splice``), the Qwen models' M-RoPE
positions packed into every step, ``mrope``, and refused with
speculation, ROADMAP A11). The KV pool's layout
follows the model's geometry (``kv_pool_layout``, the JAX runner's rule):
the chunked pool for head_dim 64 when a slot row holds a multiple of 8
chunks of 128 (e.g. Llama-3.2-1B's 8 KV heads), the 5D pool otherwise
(head_dim 128 and 256, whose GQA kernels have a build each, and head_dim
64 with fewer KV heads, e.g. TinyLlama's 4), the latent pool for MLA
models. Every pool holds KV in the model dtype or in fp8 (e4m3, e5m2;
``ServerArgs.kv_cache_dtype``); calibrated per-layer KV scales
(``quantization_param_path``) apply to the GQA pools and are refused for
MLA, as in JAX. ``ServerArgs.decode_stream`` sends decode batches to the
pool's streaming decode. Random weights are drawn on the step device
(model_loader/loader.py::device_init_params).

On a CUDA device every decode step (T == B) of ``step_packed_raw``,
``step_host`` and ``step_topk_host`` is replayed from a CUDA graph, one per
decode shape key and step variant (a mask or a bias, penalties, a top-k),
and every
speculating round from a CUDA graph, one per round key (``RoundShape``),
each captured at the key's first use (runtime/cuda_graph_runner.py), as
the JAX runner compiles one program per static shape and one per round
(``_eagle_jit``, ``_eagle_tree_jit``, ``_spec_step_jit``);
``decode_graphs=False`` runs both eagerly, to hold replays against the
eager step and round. The round graphs are dropped wherever the JAX runner
rebuilds its round or a tensor they captured changes: new acceptance
thresholds (constants of its trace), a re-sliced hot head, another routing
of either pool, the pools released or re-made. Extend steps, score and
encode steps and every step and round of a CPU runner run eagerly.

Speculative decoding (``ServerArgs.speculative_algorithm``): NGRAM verifies
host-drafted chains (``spec_step``); EAGLE and NEXTN (``_init_draft_model``,
``_init_eagle``) add the one-layer draft model, drawn from the seed + 1 as
the JAX runner draws it, by the target's architecture as the JAX runner
picks it: DeepSeek's NextN head (speculative/nextn.py) for a DeepSeek
target under either name (MiniCPM3 among them), the llama EAGLE draft for
every other target (Gemma-2 among them). Its draft pool is one layer of
the target pool's layout, sharing the target's slot space, page table and
KV dtype: the 5D pool for an EAGLE draft (at head_dim 64 the merged
kernels serve it, at 256 the ``_256`` builds), the latent pool ``[1, 1, S,
1, Dlat]`` for a NextN draft (its chain draft and refresh steps take the
latent decode of the pool's width, its tree draft steps the latent
extend with the tree's masks); it is re-made with the target pool
(``resume_kv_memory``).
The draft's weights are made, and its pool's bytes per token counted,
before the target pool is sized from free memory, less the graphs' pool
(the rounds' verify logits). ``eagle_step`` runs a chain round and
``eagle_tree_step`` a tree round (speculative/eagle.py), ``spec_step``
NGRAM's verify, each through its round graph on a CUDA runner;
``step_with_hidden`` is the extend step that also returns the hidden
state seeding the draft.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.layers.attention import pool_attention
from semi_pd_tpu_torch.mem.pool import KVCache, KVCacheSpec, PageAllocator, ReqToPagePool
from semi_pd_tpu_torch.model_loader.loader import device_init_params
from semi_pd_tpu_torch.models.classify import (
    Gemma2ForSequenceClassification, LlamaForSequenceClassification, Qwen2ForRewardModel,
)
from semi_pd_tpu_torch.models.deepseek_v2 import DeepseekV2ForCausalLM
from semi_pd_tpu_torch.models.gemma2 import Gemma2ForCausalLM, GemmaForCausalLM
from semi_pd_tpu_torch.models.glm import ChatGLMForCausalLM, Glm4ForCausalLM, GlmForCausalLM
from semi_pd_tpu_torch.models.gpt2 import GPT2LMHeadModel, GPTBigCodeForCausalLM
from semi_pd_tpu_torch.models.granite import GraniteForCausalLM
from semi_pd_tpu_torch.models.grok import Grok1ForCausalLM
from semi_pd_tpu_torch.models.layernorm_families import (
    CohereForCausalLM, Olmo2ForCausalLM, Phi3SmallForCausalLM, PhiForCausalLM,
    StableLmForCausalLM, Starcoder2ForCausalLM,
)
from semi_pd_tpu_torch.models.llama import DTYPES, LlamaForCausalLM
from semi_pd_tpu_torch.models.llava import (
    LlavaForConditionalGeneration, LlavaVidForCausalLM, YiVLForCausalLM,
)
from semi_pd_tpu_torch.models.llama_variants import (
    BaichuanForCausalLM, DeepseekForCausalLM, ExaoneForCausalLM, InternLM2ForCausalLM,
    InternLM2ForRewardModel, MiniCPMForCausalLM, QWenLMHeadModel, XverseMoeForCausalLM,
)
from semi_pd_tpu_torch.models.minicpm3 import MiniCPM3ForCausalLM
from semi_pd_tpu_torch.models.olmo_falcon_dbrx import (
    DbrxForCausalLM, FalconForCausalLM, OlmoForCausalLM,
)
from semi_pd_tpu_torch.models.phi3 import Phi3ForCausalLM
from semi_pd_tpu_torch.models.qwen2_moe import (
    MixtralForCausalLM, OlmoeForCausalLM, Qwen2MoeForCausalLM, Qwen3MoeForCausalLM,
)
from semi_pd_tpu_torch.models.qwen2_vl import (
    Qwen2_5_VLForConditionalGeneration, Qwen2VLForConditionalGeneration,
)
from semi_pd_tpu_torch.ops.sampling import (
    PENALTY_HIST, PenaltyArrays, SamplingArrays, compute_logprobs, sample, top_logprobs,
)
from semi_pd_tpu_torch.runtime.batch import HostBatch, pack_len
from semi_pd_tpu_torch.runtime.cuda_graph_runner import (
    CudaGraphBackend, DecodeGraphs, RoundGraphs, RoundShape,
)
from semi_pd_tpu_torch.runtime.forward_batch import (
    AttnMeta, ForwardArrays, ForwardMode, num_q_blocks,
)
from semi_pd_tpu_torch.runtime.speculative import verify_and_accept
from semi_pd_tpu_torch.speculative.tree import default_tree_template

logger = logging.getLogger(__name__)

# the JAX registry's classes for these strings (semi_pd_tpu/models/registry.py)
ARCHITECTURES = {
    # the five strings of one Llama class: Qwen2's bias and Qwen3's q/k
    # norms follow from the config and the string (models/llama.py)
    "LlamaForCausalLM": LlamaForCausalLM,
    "MistralForCausalLM": LlamaForCausalLM,
    "Qwen2ForCausalLM": LlamaForCausalLM,
    "Qwen3ForCausalLM": LlamaForCausalLM,
    "XverseForCausalLM": LlamaForCausalLM,
    "GemmaForCausalLM": GemmaForCausalLM,
    "Gemma2ForCausalLM": Gemma2ForCausalLM,
    "MixtralForCausalLM": MixtralForCausalLM,
    "Qwen2MoeForCausalLM": Qwen2MoeForCausalLM,
    "Qwen3MoeForCausalLM": Qwen3MoeForCausalLM,
    "OlmoeForCausalLM": OlmoeForCausalLM,
    "DeepseekV2ForCausalLM": DeepseekV2ForCausalLM,
    "DeepseekV3ForCausalLM": DeepseekV2ForCausalLM,
    "MiniCPM3ForCausalLM": MiniCPM3ForCausalLM,
    # the Llama-computation variants (registry.py:72-84, :94-101, :118-119)
    "InternLM2ForCausalLM": InternLM2ForCausalLM,
    "InternLM2ForRewardModel": InternLM2ForRewardModel,
    "ExaoneForCausalLM": ExaoneForCausalLM,
    "BaichuanForCausalLM": BaichuanForCausalLM,
    "BaiChuanForCausalLM": BaichuanForCausalLM,
    "QWenLMHeadModel": QWenLMHeadModel,
    "MiniCPMForCausalLM": MiniCPMForCausalLM,
    "XverseMoeForCausalLM": XverseMoeForCausalLM,
    "DeepseekForCausalLM": DeepseekForCausalLM,
    "Grok1ForCausalLM": Grok1ForCausalLM,
    "Grok1ModelForCausalLM": Grok1ForCausalLM,
    "GlmForCausalLM": GlmForCausalLM,
    "Glm4ForCausalLM": Glm4ForCausalLM,
    "ChatGLMModel": ChatGLMForCausalLM,
    "ChatGLMForConditionalGeneration": ChatGLMForCausalLM,
    "ChatGLMForCausalLM": ChatGLMForCausalLM,
    "Phi3ForCausalLM": Phi3ForCausalLM,
    "GraniteForCausalLM": GraniteForCausalLM,
    # the LayerNorm families (registry.py:140-152, :170-173)
    "Phi3SmallForCausalLM": Phi3SmallForCausalLM,
    "StableLmForCausalLM": StableLmForCausalLM,
    "StableLmEpochForCausalLM": StableLmForCausalLM,
    "Starcoder2ForCausalLM": Starcoder2ForCausalLM,
    "PhiForCausalLM": PhiForCausalLM,
    "CohereForCausalLM": CohereForCausalLM,
    "Olmo2ForCausalLM": Olmo2ForCausalLM,
    "GPT2LMHeadModel": GPT2LMHeadModel,
    "GPTBigCodeForCausalLM": GPTBigCodeForCausalLM,
    "OlmoForCausalLM": OlmoForCausalLM,
    "FalconForCausalLM": FalconForCausalLM,
    "RWForCausalLM": FalconForCausalLM,
    "DbrxForCausalLM": DbrxForCausalLM,
    # the sequence classifiers (registry.py:154-162) and the embedding
    # trunks the JAX registry sends to its Llama (:190-195)
    "LlamaForSequenceClassification": LlamaForSequenceClassification,
    "Gemma2ForSequenceClassification": Gemma2ForSequenceClassification,
    "Qwen2ForRewardModel": Qwen2ForRewardModel,
    "LlamaEmbeddingModel": LlamaForCausalLM,
    "MistralModel": LlamaForCausalLM,
    "LlamaModel": LlamaForCausalLM,
    # the vision-language models (registry.py:174-186, :196-203)
    "LlavaForConditionalGeneration": LlavaForConditionalGeneration,
    "LlavaLlamaForCausalLM": LlavaForConditionalGeneration,
    "YiVLForCausalLM": YiVLForCausalLM,
    "LlavaVidForCausalLM": LlavaVidForCausalLM,
    "Qwen2VLForConditionalGeneration": Qwen2VLForConditionalGeneration,
    "Qwen2_5_VLForConditionalGeneration": Qwen2_5_VLForConditionalGeneration,
}

KV_DTYPES = {**DTYPES, "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
# the graphs' memory left out of the KV pool, in float32 logits of the
# largest decode bucket (the runner reports what the pool took:
# ``graphs.pool_bytes()``); a speculating runner's, in float32 logits of
# its round's verify at that bucket (B x W rows): the verify's logits, the
# model-dtype product they are cast from, a final softcap's copies and
# verify_and_accept's (scaled, softmax); 2.4 to 4.3 such copies on an H100
# (the 1B-class tree verify to Gemma-2-9B's softcapped one). The decode
# rows: 8.6 on an H100 with every decode step variant of Meta-Llama-3-8B
# captured at B 64 (a mask, a bias, penalties, a top-k: chip_smoke.py's
# phase 4c)
GRAPH_POOL_LOGITS = 9
ROUND_POOL_LOGITS = 5


def _load_kv_cache_scales(path: str, num_layers: int) -> np.ndarray:
    """Parse a kv-cache-scales JSON (copy of the JAX package's parser, the
    vLLM schema): either {"kv_cache": {"scaling_factor": {"0": {"0": s,
    ...}}}} (per-TP-rank) or a flat {"0": s, ...}; per-layer dicts
    {"k_scale": x, "v_scale": y} are also accepted. Returns float32 [L, 2]
    (k_scale, v_scale)."""
    with open(path) as f:
        doc = json.load(f)
    sf = doc.get("kv_cache", {}).get("scaling_factor", doc)
    if sf and all(isinstance(v, dict) and all(k.isdigit() for k in v)
                  for v in sf.values()):
        sf = sf.get("0") or next(iter(sf.values()))  # TP-rank level
    out = np.ones((num_layers, 2), np.float32)
    for k, v in sf.items():
        li = int(k)
        if li >= num_layers:
            continue
        if isinstance(v, dict):
            out[li, 0] = float(v.get("k_scale", 1.0))
            out[li, 1] = float(v.get("v_scale", 1.0))
        else:
            out[li, :] = float(v)
    return out


def kv_pool_layout(num_kv_heads: int, head_dim: int, use_mla: bool = False) -> str:
    """The KV pool layout of a geometry, the JAX runner's rule
    (model_runner.py:306-314) without its backend clause, so the CPU runs
    the card's layout: "latent" for MLA models (one latent row of head_dim
    = kv_lora_rank + qk_rope_head_dim per slot); "chunked" iff D % 128 != 0,
    128 % D == 0 and (2*Hkv*D) % 1024 == 0 (a slot row of a multiple of 8
    chunks of 128); otherwise "aligned", the 5D pool [L, 2, S, Hkv, D].
    Below head_dim 128 the 5D pool runs the merged kernels, the
    counterparts of _rpa_kernel_merged, Hkv*D == 128 included (the JAX
    layer sends those to its reference attention for a TPU tiling limit
    that has no meaning on the card). The KV dtype does not enter the rule:
    fp8 KV takes the layout of the model dtype. At head_dim 128 and 256
    the 5D pool's GQA kernels have a build each (Gemma-2's 256: the _256
    builds). Raises for the geometries the port has no kernels for (ROADMAP
    A9, B9.4)."""
    D, Hkv = head_dim, num_kv_heads
    if use_mla:
        return "latent"
    if D % 128 and 128 % D == 0 and (2 * Hkv * D) % 1024 == 0:
        return "chunked"
    if D not in (64, 128, 256):
        raise NotImplementedError(
            f"head_dim {D} on the 5D pool: its kernels are built for 128, 256 and (merged) "
            f"64; other head dims are ROADMAP A9 (their kernel builds B9.4)")
    return "aligned"


def resolve_device(device: Optional[str]) -> torch.device:
    """The step device: "cuda" unless the caller passes "cpu". No quiet
    fallback: asking for CUDA without a GPU raises."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "semi_pd_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class ModelRunner:
    def __init__(
        self,
        server_args: ServerArgs,
        model_config: ModelConfig,
        device: Optional[str] = None,
        decode_graphs: bool = True,
    ):
        """``decode_graphs``: on a CUDA device, replay decode steps and
        speculating rounds from CUDA graphs (False: run them eagerly, for
        comparisons)."""
        self.server_args = server_args
        self.device = resolve_device(device or server_args.device)
        self._graphs_on = decode_graphs and self.device.type == "cuda"
        if model_config.architecture not in ARCHITECTURES:
            raise NotImplementedError(
                f"{model_config.architecture}: the port serves {sorted(ARCHITECTURES)}; "
                f"other families are ROADMAP A14")
        if server_args.context_length:
            model_config.context_length = server_args.context_length
        # weight quantization (JAX: ModelConfig(quantization=server_args.quantization));
        # the model makes its quantized leaves from the config
        model_config.quantization = server_args.quantization
        self.model_config = model_config
        mc = model_config
        if mc.quantization and mc.dtype == "float32" and self.device.type == "cuda":
            raise NotImplementedError(
                f"quantization {mc.quantization} on a float32 model: the weight-only dequant "
                f"kernels take bf16 activations; float32 quantized linears on the card are "
                f"ROADMAP B9.8 (the CPU serves them)")
        # refused before any weight is made: a geometry without kernels (A9),
        # a context past learned positions
        kv_pool_layout(mc.num_kv_heads_total, mc.kv_head_dim, mc.use_mla)
        if getattr(ARCHITECTURES[mc.architecture], "POS_EMBED", False) and (
                mc.context_length > mc.max_position_embeddings):
            # GPT-2's learned positions end at n_positions: no checkpoint has
            # a row for a later position, so no item of the ROADMAP lifts this
            raise ValueError(
                f"context_length {mc.context_length} past the {mc.max_position_embeddings} "
                f"learned positions of {mc.architecture} (n_positions); serve it at "
                f"context_length <= {mc.max_position_embeddings}")
        if server_args.speculative_algorithm and getattr(
                ARCHITECTURES[mc.architecture], "is_multimodal", False):
            raise NotImplementedError(
                f"speculative_algorithm {server_args.speculative_algorithm} on the multimodal "
                f"{mc.architecture}: the drafts take no image features (ROADMAP A11)")
        self.model = ARCHITECTURES[mc.architecture](mc, device=self.device)
        self.model.page_size = server_args.page_size
        # the M-RoPE models' steps pack their [T, 3] rope positions
        self.mrope = bool(getattr(self.model, "uses_mrope", False))
        if getattr(self.model, "alibi_slopes", None) is not None:
            self._check_alibi()
        self.kv_scales = None
        if model_config.use_mla and server_args.quantization_param_path:
            # as the JAX runner refuses them (model_runner.py:161-165): the
            # latent pool holds K and V in one row, so a separate k_scale and
            # v_scale do not apply (fp8 latent rows are served, unscaled)
            raise ValueError(
                "per-layer KV scales (quantization_param_path) are not supported for "
                "MLA models: the latent pool holds K and V in one row")
        if server_args.quantization_param_path:
            self.kv_scales = torch.as_tensor(
                _load_kv_cache_scales(server_args.quantization_param_path,
                                      model_config.num_hidden_layers),
                device=self.device)
            logger.info("fp8-KV scales loaded for %d layers", len(self.kv_scales))
        self._load_weights()
        # the draft's weights before the target pool is sized from what is free
        self.draft_model = None
        self.draft_kv = None
        self.tree_template = None
        if server_args.speculative_algorithm in ("EAGLE", "NEXTN"):
            self._init_draft_model()
        self._init_memory_pool()
        # what every layer runs over the pool after its KV write: the pool's
        # routing to the kernels, decode batches streamed on request
        self.attention = pool_attention(self.kv_cache.buffer, stream=server_args.decode_stream)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(server_args.seed)
        self._chain_tokens = None  # last decode step's device tokens
        # steps run, by the attention route they took (T == B: decode),
        # replayed ones included
        self.step_counts = {"decode": 0, "extend": 0}
        # speculative rounds' steps: target verifies (the pool's extend),
        # decode-shaped draft steps (chain drafts and refreshes: the draft
        # pool's decode) and tree draft steps (the draft pool's extend)
        self.spec_counts = {"verify": 0, "draft_decode": 0, "draft_tree": 0}
        # the decode graphs and, speculating, the round graphs, on one
        # backend and its memory pool (None: decode steps and rounds run
        # eagerly)
        backend = CudaGraphBackend(self.device, self.generator) if self._graphs_on else None
        self.graphs = DecodeGraphs(self, backend) if backend else None
        self.round_graphs = (RoundGraphs(self, backend)
                             if backend and server_args.speculative_algorithm else None)
        if self.draft_model is not None:
            self._init_eagle()

    @property
    def attention(self):
        """What every layer runs over the pool after its KV write; setting
        it to another routing drops the decode and the round graphs, which
        captured the old one's launches."""
        return self._attention

    @attention.setter
    def attention(self, fn) -> None:
        self._set_routing("_attention", fn, "graphs", "round_graphs")

    @property
    def draft_attention(self):
        """The draft pool's routing; setting it to another drops the round
        graphs."""
        return self._draft_attention

    @draft_attention.setter
    def draft_attention(self, fn) -> None:
        self._set_routing("_draft_attention", fn, "round_graphs")

    def _set_routing(self, name: str, fn, *caches: str) -> None:
        def routing(f):  # a function, or a partial of one (the stream's)
            return getattr(f, "func", f), sorted(getattr(f, "keywords", {}).items())

        old = getattr(self, name, None)
        setattr(self, name, fn)
        if routing(old) != routing(fn):
            self._drop_graphs(*caches)

    def _drop_graphs(self, *caches: str) -> None:
        """Drop the graphs of the named caches ("graphs", "round_graphs")."""
        for c in caches:
            if getattr(self, c, None) is not None:
                getattr(self, c).clear()

    def _check_alibi(self) -> None:
        """ALiBi (Baichuan2-13B) runs on the 5D pool at head_dim 128, whose
        decode and extend have an ALiBi instantiation; the streaming decodes
        and the speculation tree have none, and other pools no build
        (ROADMAP B9.6)."""
        mc, args = self.model_config, self.server_args
        if kv_pool_layout(mc.num_kv_heads_total, mc.kv_head_dim, mc.use_mla) != "aligned" or (
                mc.head_dim != 128):
            raise NotImplementedError(
                f"ALiBi at head_dim {mc.head_dim} with {mc.num_key_value_heads} KV heads: the "
                f"ALiBi instantiation is built for the 5D pool at head_dim 128; other pools "
                f"are ROADMAP B9.6")
        if args.decode_stream:
            raise NotImplementedError("ALiBi with decode_stream: the streaming decodes take "
                                      "no slopes (ROADMAP B9.6)")
        if args.speculative_algorithm:
            raise NotImplementedError(
                f"ALiBi with speculative_algorithm {args.speculative_algorithm}: the ALiBi "
                f"instantiation has no speculation tree and the drafts no slopes "
                f"(ROADMAP B9.6)")

    # ------------------------------------------------------------- weights
    def _load_weights(self) -> None:
        """Random weights drawn on the device; with ``quantization`` (fp8,
        int8, blockwise_fp8, awq_int4) the model's quantized leaves are
        quantized as each layer is drawn, as the JAX runner quantizes
        whatever it loaded (semi_pd_tpu/runtime/model_runner.py:240-249).
        ``weight_bytes`` counts the leaves as held, quantized ones included,
        so the KV pool is sized from what they leave free."""
        t0 = time.monotonic()
        if self.server_args.model_path and not self.server_args.random_weights:
            raise NotImplementedError("checkpoint loading is ROADMAP A13; use "
                                      "random_weights or load_jax_params")
        device_init_params(self.model, self.server_args.seed, self.device)
        self.weight_bytes = sum(p.numel() * p.element_size()
                                for p in self.model.parameters())
        logger.info("weights ready: %.2f GiB (quantization %s) in %.1fs",
                    self.weight_bytes / 2**30, self.model_config.quantization,
                    time.monotonic() - t0)

    # ------------------------------------------------------------- memory
    def _init_memory_pool(self) -> None:
        args, mc = self.server_args, self.model_config
        page_size = args.page_size
        kv_dtype = KV_DTYPES[mc.dtype if args.kv_cache_dtype == "auto" else args.kv_cache_dtype]
        if mc.dtype == "float32" and kv_dtype == torch.bfloat16:
            # what awq_int4's rule gives a float32 model under "auto"; the
            # pools hold KV in q's dtype or in fp8
            raise NotImplementedError(
                "bf16 KV under a float32 model (awq_int4 with kv_cache_dtype 'auto'): the "
                "attention takes KV in q's dtype or fp8; pass kv_cache_dtype='float32' "
                "(ROADMAP B9.8)")
        layout = kv_pool_layout(mc.num_kv_heads_total, mc.kv_head_dim, mc.use_mla)
        num_tokens = args.max_total_tokens or self._profile_kv_tokens(kv_dtype)
        num_pages = max(num_tokens // page_size, 8) + 1  # +1 dump page
        max_context = min(mc.context_length, num_tokens)
        self.max_running_requests = args.max_running_requests or min(
            max(num_tokens // 512, 16), 512)
        self.kv_spec = KVCacheSpec(
            num_layers=mc.num_hidden_layers, num_pages=num_pages,
            page_size=page_size, num_kv_heads=mc.num_kv_heads_total,
            head_dim=mc.kv_head_dim, dtype=kv_dtype, layout=layout,
        )
        self.kv_cache = KVCache(self.kv_spec, self.device)
        self.page_allocator = PageAllocator(num_pages, page_size)
        self.req_pool = ReqToPagePool(self.max_running_requests, max_context, page_size)
        self.max_context_len = max_context
        logger.info("KV pool: %s, %d pages x %d tokens (%.2f GiB, %s), max_running=%d",
                    layout, num_pages, page_size, self.kv_spec.bytes_total() / 2**30,
                    kv_dtype, self.max_running_requests)

    def _profile_kv_tokens(self, kv_dtype: torch.dtype) -> int:
        """Size the KV pool from free device memory, less the graphs' pool
        (``_graph_pool_reserve``, sized before any graph exists). A
        speculating runner's draft weights are already made (they are not
        free), and its draft pool, one more layer of the target's per slot,
        is counted in each token's bytes."""
        mc = self.model_config
        layers = mc.num_hidden_layers + (1 if self.draft_model is not None else 0)
        per_token = (layers * mc.num_kv_heads_total * mc.kv_head_dim
                     * kv_dtype.itemsize * (1 if mc.use_mla else 2))
        if self.device.type != "cuda":
            return 32768  # CPU: a small pool for tests
        free, _ = torch.cuda.mem_get_info(self.device)
        if self._graphs_on:
            free -= self._graph_pool_reserve()
        frac = self.server_args.mem_fraction_static or 0.9
        return max(int(free * frac // per_token), 4096)

    def _graph_pool_reserve(self) -> int:
        """Bytes of the graphs' shared pool, in float32 logits of the
        largest decode bucket B: GRAPH_POOL_LOGITS x B rows, the sampler's
        copies of a decode step's logits (with a mask and penalties) being
        the largest tensors a decode step makes; speculating, at least
        ROUND_POOL_LOGITS of the round's verify, B x W rows (W: gamma + 1,
        or the tree's nodes). The pool holds the largest capture's
        transients, each capture reusing what the earlier ones freed. Then
        the masked steps' static inputs, shared by the keys of a bucket: a
        float32 bias and a bool mask [B, V] and the penalty histogram [B,
        PENALTY_HIST] (two int32 arrays and a bool one), for every decode
        bucket."""
        args = self.server_args
        V = self.model_config.vocab_size
        B = max(args.decode_bs_buckets)
        rows = GRAPH_POOL_LOGITS * B
        if args.speculative_algorithm:
            n = args.speculative_num_draft_tokens
            tree = args.speculative_algorithm != "NGRAM" and args.speculative_eagle_topk > 1
            W = default_tree_template(args.speculative_eagle_topk, n).num_nodes if tree else n + 1
            rows = max(rows, ROUND_POOL_LOGITS * B * W)
        static = sum(args.decode_bs_buckets) * (V * (4 + 1) + PENALTY_HIST * (4 + 4 + 1))
        return rows * V * 4 + static

    def release_kv_memory(self) -> None:
        """Free the KV pool's (and the draft pool's) device memory between
        rollout phases; the caller has flushed every request. The decode
        and the round graphs captured the old pools and go with them."""
        self._drop_graphs("graphs", "round_graphs")
        self.kv_cache.buffer = None
        if self.draft_kv is not None:
            self.draft_kv.buffer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def resume_kv_memory(self) -> None:
        """Re-make the pools ``release_kv_memory`` freed (zeros), the draft
        pool with the target's."""
        if self.kv_cache.buffer is not None:
            return  # not released
        self._drop_graphs("graphs", "round_graphs")
        self.kv_cache = KVCache(self.kv_spec, self.device)
        if self.draft_model is not None:
            self._init_draft_pool()

    # ------------------------------------------------------------- speculation
    def _init_draft_model(self) -> None:
        """The draft net of EAGLE or NEXTN, by the target's architecture as
        the JAX runner's _init_eagle picks it
        (semi_pd_tpu/runtime/model_runner.py:997-1004):
        NextN (DeepSeek's multi-token-prediction head, a layer mirroring the
        target's last) for a DeepSeek target, MiniCPM3 included, and the
        llama EAGLE draft at the target's geometry for every other target,
        Gemma-2 included; drawn from the seed + 1."""
        from semi_pd_tpu_torch.speculative.eagle import EagleDraftModel
        from semi_pd_tpu_torch.speculative.nextn import NextNDraftModel

        args, mc = self.server_args, self.model_config
        if args.speculative_draft_model_path:
            raise NotImplementedError("a draft checkpoint needs checkpoint loading "
                                      "(ROADMAP A13); the draft draws random weights")
        if isinstance(self.model, DeepseekV2ForCausalLM):
            self.draft_model = NextNDraftModel(self.model, self.device)
        else:
            self.draft_model = EagleDraftModel(mc, self.device)
        self.draft_model.page_size = args.page_size
        self.draft_model.init_params(args.seed + 1)
        self.draft_weight_bytes = sum(p.numel() * p.element_size()
                                      for p in self.draft_model.parameters())
        logger.info("%s draft ready: %.2f GiB", type(self.draft_model).__name__,
                    self.draft_weight_bytes / 2**30)

    def _init_eagle(self) -> None:
        """The draft KV pool sharing the target's slot space, the rounds'
        options and the tree (speculative/eagle.py), the rest of the JAX
        runner's _init_eagle."""
        from semi_pd_tpu_torch.speculative.eagle import load_token_map

        args, mc = self.server_args, self.model_config
        self._init_draft_pool()
        self.spec_refresh = not args.speculative_disable_draft_refresh
        self.spec_hot_ids = None
        self.spec_hot_head = None
        if args.speculative_token_map:
            # FR-Spec: the draft head runs over the hot-vocab subset only
            hot = load_token_map(args.speculative_token_map)
            self.spec_hot_ids = torch.as_tensor(hot, device=self.device)
            logger.info("FR-Spec hot vocab: %d of %d tokens", hot.size, mc.vocab_size)
        self._slice_hot_head()
        if args.speculative_eagle_topk > 1:
            self.tree_template = default_tree_template(
                args.speculative_eagle_topk, args.speculative_num_draft_tokens)
            self.tree_template.device_tables(self.device)  # made here, not in a round

    def _init_draft_pool(self) -> None:
        """The draft pool: one layer of the target pool's geometry, slots
        and dtype (fp8 included), in the latent layout for a latent target
        and the 5D layout otherwise (at head_dim 64 the merged kernels'
        pool)."""
        layout = "latent" if self.kv_spec.layout == "latent" else "aligned"
        spec = dataclasses.replace(self.kv_spec, num_layers=1, layout=layout)
        self.draft_kv = KVCache(spec, self.device)
        self.draft_attention = pool_attention(self.draft_kv.buffer)

    def _slice_hot_head(self) -> None:
        """Slice the lm_head to the FR-Spec hot vocab ONCE (a gather inside
        every round would re-read the whole [H, V] head); again after the
        target's weights change, as the JAX runner re-slices when it
        rebuilds its round. A new slice is a new tensor: the round graphs
        captured the old one and go."""
        from semi_pd_tpu_torch.speculative.eagle import _hot_head

        self._drop_graphs("round_graphs")
        self.spec_hot_head = (None if self.spec_hot_ids is None
                              else _hot_head(self.model.head(), self.spec_hot_ids))

    def set_spec_thresholds(self, single=None, acc=None) -> None:
        """Update the relaxed-acceptance thresholds and re-slice the hot
        head, as the JAX runner's rebuild of its round does: a round reads
        the thresholds when it is run or captured (constants of the JAX
        round's trace), so the round graphs go."""
        if single is not None:
            self.server_args.speculative_accept_threshold_single = float(single)
        if acc is not None:
            self.server_args.speculative_accept_threshold_acc = float(acc)
        self._drop_graphs("round_graphs")
        if self.draft_model is not None:
            self._slice_hot_head()

    def _stamp(self, fb: ForwardArrays) -> ForwardArrays:
        """This runner's own fp8-KV scales on a target step's batch."""
        return fb if self.kv_scales is None else fb._replace(kv_scales=self.kv_scales)

    # ------------------------------------------------------------- rounds
    def eagle_step(self, fb: ForwardArrays, prev_hidden, gamma: int):
        """EAGLE chain round. Returns device (accept_len [B], next_tok [B],
        drafts [B, gamma], next_hidden [B, H])."""
        out = self._round(self._round_shape("chain", fb, gamma), fb, prev_hidden)
        self.spec_counts["verify"] += 1
        self.spec_counts["draft_decode"] += gamma * (2 if self.spec_refresh else 1)
        return out

    def eagle_tree_step(self, fb: ForwardArrays, prev_hidden):
        """EAGLE tree round over ``tree_template``. Returns device
        (accept_len [B], next_tok [B], path_tokens [B, depth], next_hidden
        [B, H])."""
        tree = self.tree_template
        out = self._round(self._round_shape("tree", fb, tree.branching), fb, prev_hidden)
        self.spec_counts["verify"] += 1
        self.spec_counts["draft_tree"] += len(tree.level_nodes)
        self.spec_counts["draft_decode"] += tree.depth if self.spec_refresh else 0
        return out

    def spec_step(self, fb: ForwardArrays, drafts, draft_lens, gamma: int):
        """Speculative verify step (runtime/speculative.py). Returns device
        (accept_len [B], next_token [B])."""
        out = self._round(self._round_shape("ngram", fb, gamma), fb, drafts=drafts,
                          draft_lens=draft_lens)
        self.spec_counts["verify"] += 1
        return out

    # host-batch forms of the four (a round graph's two packed copies, or
    # eagerly one copy per array, as step_host)
    def step_with_hidden_host(self, hb, vocab_mask=None):
        mask = None if vocab_mask is None else self._upload(vocab_mask)
        return self.step_with_hidden(hb.to_device(self.device), mask)

    def eagle_step_host(self, hb, prev_hidden, gamma: int):
        return self.eagle_step(hb, prev_hidden, gamma)

    def eagle_tree_step_host(self, hb, prev_hidden):
        return self.eagle_tree_step(hb, prev_hidden)

    def spec_step_host(self, hb, drafts, draft_lens, gamma: int):
        return self.spec_step(hb, drafts, draft_lens, gamma)

    def _round_shape(self, kind: str, batch, spec) -> RoundShape:
        """The round key of a verify batch (a HostBatch, or ForwardArrays
        on the device): its packed shapes and all_greedy, ``spec`` (gamma
        or the tree's branching), and the draft's refresh, hot vocabulary
        and hidden width."""
        if isinstance(batch, HostBatch):
            T, B, maxP = batch.T, batch.B, batch.maxP
            all_greedy = bool(np.all(batch.sampling.temperature[: len(batch.reqs)] <= 0.0))
        else:
            T, B = batch.input_ids.shape[0], batch.page_table.shape[0]
            maxP, all_greedy = batch.page_table.shape[1], batch.all_greedy
        draft = kind != "ngram"
        return RoundShape(kind, T, B, maxP, num_q_blocks(T, B), all_greedy, spec,
                          refresh=draft and self.spec_refresh,
                          hot=draft and self.spec_hot_ids is not None,
                          hidden=self.model_config.hidden_size if draft else 0)

    def _round(self, shape: RoundShape, batch, prev_hidden=None, drafts=None,
               draft_lens=None):
        """One round of ``shape.kind`` over ``batch`` (a HostBatch, or
        ForwardArrays on the device), ``prev_hidden`` [B, H] seeding the
        draft (NGRAM: ``drafts`` [B, gamma] and ``draft_lens`` [B]):
        replayed from the key's round graph, or with graphs off run eagerly
        over ``to_device``'s tensors."""
        if self.round_graphs is None:
            fb = batch.to_device(self.device) if isinstance(batch, HostBatch) else batch
            dev = lambda a: None if a is None else torch.as_tensor(a, device=self.device)
            return self._round_body(shape, fb, dev(prev_hidden), dev(drafts), dev(draft_lens))

        def fill(ints, floats):
            if isinstance(batch, HostBatch):  # two host->device copies
                pi, pf, _ = batch.pack()
                tail = ([np.asarray(drafts, np.int32).reshape(-1),
                         np.asarray(draft_lens, np.int32)] if shape.kind == "ngram" else [])
                ints.copy_(torch.from_numpy(np.concatenate([pi, *tail])), non_blocking=True)
                if shape.hidden:
                    pf = np.concatenate([pf, np.asarray(prev_hidden, np.float32).reshape(-1)])
                floats.copy_(torch.from_numpy(pf), non_blocking=True)
                return
            views, prev, d, lens = self._unpack_round(ints, floats, shape)
            for dst, src in _batch_arrays(views, batch):
                dst.copy_(src)
            for dst, src in ((prev, prev_hidden), (d, drafts), (lens, draft_lens)):
                if dst is not None:
                    dst.copy_(torch.as_tensor(src).reshape(dst.shape))

        def body(ints, floats):
            return self._round_body(shape, *self._unpack_round(ints, floats, shape))

        return self.round_graphs.round(shape, fill, body)

    def _unpack_round(self, ints: torch.Tensor, floats: torch.Tensor, shape: RoundShape):
        """A round's packed vectors as (ForwardArrays, prev_hidden [B, H],
        drafts [B, gamma], draft_lens [B]) of views, None where the kind
        has none."""
        T, B, tree = shape.T, shape.B, shape.kind == "tree"
        fb = self._unpack_fb(ints, floats, T, B, shape.maxP, shape.NQB, B, shape.all_greedy,
                             n_logits=T, tree=tree)
        if shape.kind == "ngram":
            o, g = pack_len(T, B, shape.maxP, shape.NQB, n_logits=T), shape.spec
            return fb, None, ints[o : o + B * g].view(B, g), ints[o + B * g : o + B * g + B]
        return fb, floats[6 * B :].view(B, shape.hidden), None, None

    def _round_body(self, shape: RoundShape, fb: ForwardArrays, prev_hidden, drafts,
                    draft_lens):
        """The eager round (and the body a round graph captures): the chain
        or tree round of speculative/eagle.py with this runner's draft,
        pools, routings and options, or NGRAM's verify and acceptance.
        Returns (accept_len, next_tok, tokens, next_hidden), NGRAM's first
        two."""
        from semi_pd_tpu_torch.speculative.eagle import eagle_round, eagle_tree_round

        args = self.server_args
        thresholds = dict(threshold_single=args.speculative_accept_threshold_single,
                          threshold_acc=args.speculative_accept_threshold_acc)
        fb = self._stamp(fb)
        with torch.inference_mode():
            if shape.kind == "ngram":
                logits = self.model(fb, self.kv_cache.buffer,
                                    attention=self.attention)  # logits_idx covers all rows
                return verify_and_accept(logits, drafts, draft_lens, fb.sampling,
                                         self.generator, shape.spec, **thresholds)
            pools = (self.model, self.draft_model, self.kv_cache.buffer, self.draft_kv.buffer,
                     fb, prev_hidden.to(self.model.dtype))
            opts = dict(refresh=self.spec_refresh, hot_ids=self.spec_hot_ids,
                        hot_head=self.spec_hot_head, attention=self.attention,
                        draft_attention=self.draft_attention)
            if shape.kind == "chain":
                res = eagle_round(*pools, shape.spec, self.generator, **thresholds, **opts)
            else:
                res = eagle_tree_round(*pools, self.tree_template, **opts)
        return res.accept_len, res.next_tok, res.tokens, res.next_hidden

    def step_with_hidden(self, fb: ForwardArrays, vocab_mask=None):
        """Like the step (``vocab_mask``: a grammar mask or a logit bias
        [B, V], on the device), and also returns the last tokens' hidden
        states [B, H] (seeding the EAGLE draft after a prefill)."""
        tokens, logprobs, hidden = self._step(fb, return_hidden=True, vocab_mask=vocab_mask)
        self._count(fb.input_ids.shape[0], fb.page_table.shape[0])
        return tokens, logprobs, hidden

    # ------------------------------------------------------------- step
    def _step(self, fb: ForwardArrays, return_hidden: bool = False, vocab_mask=None,
              penalties: Optional[PenaltyArrays] = None, top_k: int = 0):
        """The eager step (and the body a decode graph captures): (tokens,
        logprobs), then with ``return_hidden`` the rows' hidden states, then
        with ``top_k`` the top-k log-probs' values and ids. ``vocab_mask``
        (a bool mask or a float32 bias [B, V]) and ``penalties`` shape the
        sampling; the log-probs are those of the model's logits."""
        fb = self._stamp(fb)  # this runner's own scales, every step
        with torch.inference_mode():
            out = self.model(fb, self.kv_cache.buffer, attention=self.attention,
                             **({"return_hidden": True} if return_hidden else {}))
            logits, hidden = out if return_hidden else (out, None)
            tokens = sample(logits, fb.sampling, self.generator, fb.all_greedy,
                            vocab_mask, penalties)
            res = (tokens, compute_logprobs(logits, tokens))
            if return_hidden:
                res += (hidden,)
            if top_k:
                res += top_logprobs(logits, top_k)
        return res

    def _count(self, T: int, B: int) -> None:
        self.step_counts["decode" if T == B else "extend"] += 1

    def _unpack_fb(self, ints: torch.Tensor, floats: torch.Tensor, T: int, B: int,
                   maxP: int, NQB: int, num_reqs: int, all_greedy: bool,
                   input_override: Optional[torch.Tensor] = None,
                   n_logits: Optional[int] = None, tree: bool = False) -> ForwardArrays:
        """Inverse of HostBatch.pack(): static-offset slices (views).
        ``n_logits``: the logits rows (B; a verify batch's T); ``tree``: the
        batch carries a tree's ``mask_pos`` [T] and ``win_base`` [B]."""
        o = [0]

        def take(n):
            a = ints[o[0] : o[0] + n]
            o[0] += n
            return a

        input_ids = take(T)
        q_req_idx = take(T)
        q_pos = take(T)
        out_slots = take(T)
        page_table = take(B * maxP).reshape(B, maxP)
        kv_lens = take(B)
        logits_idx = take(B if n_logits is None else n_logits)
        q_lens = take(B)
        q_start = take(B)
        block_seq = take(NQB)
        block_row = take(NQB)
        block_qofs = take(NQB)
        top_k = take(B)
        mask_pos, win_base = (take(T), take(B)) if tree else (None, None)
        mrope_pos = take(3 * T).view(T, 3) if self.mrope else None
        f = [floats[i * B : (i + 1) * B] for i in range(6)]
        if input_override is not None:
            input_ids = input_override
        return ForwardArrays(
            input_ids=input_ids, q_req_idx=q_req_idx, q_pos=q_pos,
            out_slots=out_slots, page_table=page_table, kv_lens=kv_lens,
            logits_idx=logits_idx,
            sampling=SamplingArrays(
                temperature=f[0], top_k=top_k, top_p=f[1], min_p=f[2],
                presence_penalty=f[3], frequency_penalty=f[4],
                repetition_penalty=f[5],
            ),
            num_reqs=num_reqs,
            attn_meta=AttnMeta(q_lens=q_lens, q_start=q_start, block_seq=block_seq,
                               block_row=block_row, block_qofs=block_qofs),
            all_greedy=all_greedy, mask_pos=mask_pos, win_base=win_base,
            mrope_pos=mrope_pos,
        )

    def step_packed(self, hb, prev_tokens=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hot-loop step: two host->device copies total (the packed int and
        float vectors of HostBatch.pack()). ``prev_tokens`` chains the
        previous decode step's on-device tokens as this step's inputs
        (overlap scheduling). Returns device (tokens [B] i32, logprobs [B]
        f32); does not wait for the device."""
        return self.step_packed_raw(
            *hb.pack(mrope=self.mrope), chained=prev_tokens is not None,
            prev_tokens=prev_tokens, is_decode=hb.mode == ForwardMode.DECODE,
            splice=hb.splice(self.device),
        )

    def step_packed_raw(self, ints_np: np.ndarray, floats_np: np.ndarray, shapes,
                        chained: bool = False, prev_tokens=None,
                        is_decode: bool = False, splice: Optional[dict] = None):
        """A packed step; on a CUDA device a decode step (T == B) replays its
        key's graph. ``splice``: ``HostBatch.splice``'s rows of an image
        prompt's extend (such a step runs eagerly, also at T == B)."""
        T, B, maxP, NQB = shapes
        num_reqs = int(ints_np[-1])
        all_greedy = bool(np.all(floats_np[:num_reqs] <= 0.0))  # temperatures
        if chained and prev_tokens is None:
            prev_tokens = self._chain_tokens
        if self.graphs is not None and T == B and not splice:
            tok, lp = self.graphs.step(ints_np, floats_np, shapes, all_greedy,
                                       prev_tokens if chained else None)
        else:
            ints = torch.from_numpy(ints_np).to(self.device, non_blocking=True)
            floats = torch.from_numpy(floats_np).to(self.device, non_blocking=True)
            fb = self._unpack_fb(ints, floats, T, B, maxP, NQB, num_reqs, all_greedy,
                                 input_override=prev_tokens if chained else None)
            tok, lp = self._step(fb._replace(**(splice or {})))
        self._count(T, B)
        if is_decode:
            self._chain_tokens = tok
        return tok, lp

    def step_host(self, hb, vocab_mask=None, penalties=None):
        """Host-batch dispatch of a step with host arrays: ``vocab_mask``, a
        bool grammar mask or a float32 logit bias [B, V]; ``penalties``, a
        ``PenaltyArrays`` histogram [B, H]: two packed copies and one per
        array, as ``step_packed_raw``. A decode step replays its key's graph
        on a CUDA runner, an extend runs eagerly. Returns device (tokens
        [B], logprobs [B])."""
        return self._step_host(hb, vocab_mask, penalties, 0)

    def step_topk_host(self, hb, k: int, vocab_mask=None, penalties=None):
        """``step_host`` that also returns the top-k log-prob values and ids
        of each request's next-token distribution, for batches holding a
        request with top_logprobs_num > 0. Returns device (tokens [B],
        logprobs [B], tk_vals [B, k] f32, tk_ids [B, k] i32)."""
        return self._step_host(hb, vocab_mask, penalties, int(k))

    def _step_host(self, hb, vocab_mask, penalties, k: int):
        ints, floats, shapes = hb.pack(mrope=self.mrope)
        all_greedy = bool(np.all(hb.sampling.temperature[: len(hb.reqs)] <= 0.0))
        splice = hb.splice(self.device)
        if self.graphs is not None and hb.T == hb.B and not splice:
            out = self.graphs.step(ints, floats, shapes, all_greedy, vocab_mask=vocab_mask,
                                   penalties=penalties, top_k=k)
        else:
            dev = self._upload
            fb = self._unpack_fb(dev(ints), dev(floats), *shapes, len(hb.reqs), all_greedy)
            out = self._step(fb._replace(**splice),
                             vocab_mask=None if vocab_mask is None else dev(vocab_mask),
                             penalties=(None if penalties is None
                                        else PenaltyArrays(*map(dev, penalties))),
                             top_k=k)
        self._count(hb.T, hb.B)
        if hb.mode == ForwardMode.DECODE:
            self._chain_tokens = out[0]
        return out

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied without waiting on the host
        (``torch.as_tensor(a, device=...)`` synchronizes)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # ------------------------------------------------------------- score / encode
    def score_step(self, fb: ForwardArrays, targets) -> torch.Tensor:
        """Teacher-forced input log-probs: log p(targets[t] | tokens <= t)
        for every flat row t of an extend batch, [T] float32 (rows whose
        target is the next request's first token, or padding, are dropped
        on the host). Eager; writes the batch's KV."""
        return self._score(fb, targets, 0)[0]

    def score_step_host(self, hb, targets) -> torch.Tensor:
        return self.score_step(hb.to_device(self.device), targets)

    def score_topk_host(self, hb, targets, k: int):
        """Teacher-forced input log-probs with each row's top-k: (tok_lp
        [T], tk_vals [T, k], tk_ids [T, k])."""
        return self._score(hb.to_device(self.device), targets, int(k))

    def _score(self, fb: ForwardArrays, targets, k: int):
        targets = torch.as_tensor(np.asarray(targets), device=self.device).long()
        fb = self._stamp(fb)
        with torch.inference_mode():
            logits = self.model(fb, self.kv_cache.buffer, attention=self.attention,
                                all_logits=True)
            lp = torch.log_softmax(logits.float(), dim=-1)
            tok_lp = torch.gather(lp, 1, targets[:, None])[:, 0]
            res = (tok_lp,)
            if k:
                vals, idx = torch.topk(lp, k, dim=-1)
                res += (vals, idx.to(torch.int32))
        self._count(fb.input_ids.shape[0], fb.page_table.shape[0])
        return res

    def encode_step(self, fb: ForwardArrays) -> torch.Tensor:
        """Embedding forward: [B, H] float32 pooled embeddings, each
        request's last token's final-normed hidden state over its L2 norm
        (``forward_embedding``). Eager; writes the batch's KV."""
        if not hasattr(self.model, "forward_embedding"):
            raise NotImplementedError(
                f"{self.model_config.architecture} has no embedding forward (encode)")
        fb = self._stamp(fb)
        with torch.inference_mode():
            emb = self.model.forward_embedding(fb, self.kv_cache.buffer,
                                               attention=self.attention)
        self._count(fb.input_ids.shape[0], fb.page_table.shape[0])
        return emb

    def encode_step_host(self, hb) -> torch.Tensor:
        return self.encode_step(hb.to_device(self.device))

    # ------------------------------------------------------------- vision
    def encode_images(self, pixel_values: np.ndarray) -> torch.Tensor:
        """LLaVA's family: [N, 3, H, W] pixels -> projected patch features
        [N, n_patches, H] on the device (float32), left there for the
        splice (the JAX runner brings them to the host)."""
        px = torch.from_numpy(np.ascontiguousarray(pixel_values, np.float32)).to(self.device)
        with torch.inference_mode():
            return self.model.encode_images(px)

    def encode_images_patches(self, patches: np.ndarray, grid) -> torch.Tensor:
        """Qwen2-VL's variable-resolution patches [n, C * tp * ps * ps] of
        grid (t, h, w) -> merged features [n / merge^2, H] on the device, in
        the model dtype."""
        px = torch.from_numpy(np.ascontiguousarray(patches, np.float32)).to(self.device)
        with torch.inference_mode():
            return self.model.encode_images(px, tuple(int(g) for g in grid))

    @staticmethod
    def read_round(*arrays):
        """Read back a round's device tensors in ONE device->host copy:
        integer tensors as int32, floating ones as float32, each returned
        as a numpy array of its shape; anything else (a host array, None)
        is returned as it is."""
        dev = [a for a in arrays if isinstance(a, torch.Tensor)]
        bits = lambda a: (a.float().reshape(-1).view(torch.int32) if a.is_floating_point()
                          else a.reshape(-1).to(torch.int32))
        flat = torch.cat([bits(a) for a in dev]).cpu().numpy() if dev else None
        out, o = [], 0
        for a in arrays:
            if isinstance(a, torch.Tensor):
                x = flat[o : o + a.numel()].reshape(tuple(a.shape))
                o += a.numel()
                a = x.view(np.float32) if a.is_floating_point() else x
            out.append(a)
        return out

    def read_results(self, toks: List[torch.Tensor], lps: List[torch.Tensor],
                     want_logprobs: bool = True):
        """Read back N steps' (tokens, logprobs) in ONE device->host copy.
        Returns (list of np token vectors, list of np logprob vectors or
        Nones)."""
        lens = [int(t.shape[0]) for t in toks]
        flat_t = torch.cat([t.to(torch.int32) for t in toks])
        if want_logprobs:
            flat_l = torch.cat([l.float() for l in lps]).view(torch.int32)
            flat = torch.cat([flat_t, flat_l]).cpu().numpy()
            ti, li = flat[: sum(lens)], flat[sum(lens):].view(np.float32)
        else:
            ti, li = flat_t.cpu().numpy(), None
        out_t, out_l, o = [], [], 0
        for n in lens:
            out_t.append(ti[o : o + n])
            out_l.append(li[o : o + n] if li is not None else None)
            o += n
        return out_t, out_l


def _batch_arrays(dst: ForwardArrays, src: ForwardArrays):
    """(dst, src) pairs of the tensors of two batches of one shape: the
    packed arrays, the work list and the sampling arrays, and a tree's
    positions and window starts."""
    names = ("input_ids", "q_req_idx", "q_pos", "out_slots", "page_table", "kv_lens",
             "logits_idx", "mask_pos", "win_base")
    pairs = [(getattr(dst, n), getattr(src, n)) for n in names]
    pairs += list(zip(dst.attn_meta, src.attn_meta)) + list(zip(dst.sampling, src.sampling))
    return [(d, s) for d, s in pairs if d is not None]
