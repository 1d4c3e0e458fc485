#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (semi_pd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

It imports nothing of JAX or of the JAX package. Phases, one result line
each (any failure raises and exits non-zero):

1. setup   — the card, the toolchain, and the build of every CUDA kernel
             from semi_pd_tpu_torch/csrc/ (one nvcc per kernel, in parallel),
             with nvcc's register and spill lines and each library's count
             of tensor-core instructions (HMMA/HGMMA, from cuobjdump -sass):
             the bf16-q instantiations of every extend, of every decode and
             of every streaming decode must have some, their float32 pair
             none. Every extend runs bf16 q on Hopper's warpgroup tensor
             cores (wgmma; the chunked, the aligned and the merged build in
             one kernel, the latent build in its own): each warpgroup
             kernel's registers, spills and HGMMA count get a line, and it
             must have HGMMA instructions.
             The chunked, aligned and merged decodes run bf16 q on the tensor
             cores, split over warps and blocks by a plan the wrapper
             computes from shapes (the chunked and aligned ones with P
             rounded to bf16, the merged one with P kept float32); the two
             GQA streaming decodes run it on the same warp tile, each warp
             an equal share of the batch's KV tiles. The latent decodes
             (576 and 288 builds) run it on a block tile (up to 16 query
             heads as one m16 tile, groups of 16 with an uneven last one,
             the four warps of a block sharing each latent tile, P kept
             float32),
             each request walked in fixed chunks of 256 positions, the
             packed one a block per chunk, the streaming one each block an
             equal share of the batch's chunks, so that the two give the
             same bits; each of
             their kernels gets a line with its registers, spills and HMMA
             count, and must have HMMA and no spill. float32 q stays on the
             CUDA cores. The three _256 builds (Gemma-2's head_dim 256 on
             the 5D pool) are among them: the extend's HGMMA, the packed
             and the streaming decode's HMMA, with their registers and
             spills (the warpgroup extend gets a ``wgmma`` line). The _256
             and _288 extends hold the speculation tree's instantiations
             beside the unmasked ones, as every extend does: a
             ``tree_functions`` line per (q, KV) pair sets the TREE = false
             and TREE = true functions' registers, spills and HGMMA side
             by side; a TREE = false warpgroup function that spills, or a
             TREE = true one without HGMMA, fails the run. The
             aligned decode's and extend's libraries also hold their ALIBI
             instantiations (counted apart as rpa_decode_aligned_alibi and
             rpa_extend_aligned_alibi); an ``alibi_functions`` line per
             kind and (q, KV) pair sets their functions' registers,
             spills and tensor-core instructions beside the ALIBI = false
             ones.
2. kernels — each kernel's wrapper on the card against its plain PyTorch
             version on the same inputs, at the geometry of its path (page
             16; Hq 32, Hkv 8: chunked pool [1, S, 8, 128] at D 64, aligned
             pool [1, 2, S, 8, 128] at D 128 with bf16, float32 and fp8 KV;
             Hq 32, Hkv 4: TinyLlama's 5D pool [1, 2, S, 4, 64] for the
             merged kernels, with the same types; Hq 16: DeepSeek-V2-Lite's
             latent pool [1, 1, S, 1, 576], V its first 512; the streaming
             decodes on the chunked, aligned and latent pools; extend also
             at b2 x q2048 / kv2048, two fresh prompts of one chunked
             prefill step; then the latent decodes with softcap 1.0 and
             the packed one with window 512; last, bf16 q over fp8 KV on
             the chunked pool and over fp8 latent rows: e4m3 at every
             decode, stream and extend shape, e5m2 at b64 and under the
             b8 x q256 extend), with its
             time, the plain version's time, one PyTorch library call's
             time (scaled_dot_product_attention over pre-gathered dense KV,
             upcast to bf16 for fp8 KV; a yardstick the port never calls)
             and the least time the card could take (bytes or operations
             over the card's peak rates); beside each streaming decode's
             row, the packed decode's time on the same case
             (``packed_kernel_ms``) and, with bf16 q, its blocks per KV head.
             Then the speculation cases (``spec_tree`` in their rows): the
             tree verify (b64 x N = 29 rows of default_tree_template(4, 4),
             prefixes 520-1000 on shuffled pages, every dead slot NaN)
             through rpa_extend (bf16, float32) and rpa_extend_aligned
             (bf16, float32, e4m3 KV), the tree's level-1 draft step (b64 x
             4 rows of q_len 1 over the tiled page table) through
             rpa_extend_merged at the draft pool's Hq 32 / Hkv 8, and
             rpa_decode_merged at that geometry, b64 / kv1024; then NextN's
             on DeepSeek-V2-Lite's latent pool: the tree verify through
             rpa_extend_mla (bf16 and e4m3 rows under bf16 q, float32; its
             row also times the same inputs without the tree, the
             unmasked instantiation, as ``causal_ms``) and the level-1 draft
             step on the one-layer latent draft pool (bf16, float32); the
             library call of a masked case is SDPA with the boolean tree
             mask; then the _256 and _288 extends' tree instantiations:
             EAGLE's tree verify on Gemma-2-9B through
             rpa_extend_aligned_256 (Hq 16 / Hkv 8 / D 256, softcap 50;
             bf16, e4m3 and float32), again with the windowed layers' 4096
             window over prefixes of 4100-6000 (each row's window start its
             own slot-order position - 4095), and the level-1 draft step on
             the one-layer draft pool (no cap, no window), and NextN's on
             MiniCPM3-4B through rpa_extend_mla_288 (Hq 40): the tree
             verify (bf16 and e4m3 rows under bf16 q, float32) and the
             level-1 draft step, each row with its TREE = true function's
             registers and spills and ``causal_ms``, the TREE = false
             instantiation's time on the same inputs (the library call of
             a capped case SDPA uncapped). Last, the _288 builds at
             MiniCPM3-4B's geometry (latent
             pool [1, 1, S, 1, 288], V its first 256, Hq 40): decode b64 /
             kv1024 (packed and streamed) and extend b8 x q256 / kv2048,
             bf16, e4m3 and e5m2 rows under bf16 q and float32, every dead
             slot NaN, each row with its function's registers and spills.
             Then the _256 builds at Gemma-2-9B's geometry (5D pool [1, 2,
             S, 8, 256], Hq 16, scale 256 ** -0.5, every dead slot NaN):
             decode b64 / kv1024 (packed and streamed), extend b8 x q256 /
             kv2048 and b2 x q2048 / kv2048, bf16, e4m3 and e5m2 KV under
             bf16 q and float32; softcap 50 on all three; window 4096
             where it cuts, on the packed decode (b64, kv 4500-6000) and the
             extend (b2 x q2048 over kv 6000); each row with its
             function's registers and spills, and SDPA uncapped and
             unwindowed as its library time. Last, the aligned builds and
             the _256 builds at one query head per KV head (Hq = Hkv = 16:
             G = 1) and the aligned builds at eight (Hq 32 / Hkv 4: G =
             8), decode b64 / kv1024 (packed and streamed) and extend b8 x
             q256 / kv2048, bf16 and e4m3 KV under bf16 q, every dead slot
             NaN (``phase_kernels_heads``). Then the Llama variants'
             attention (``phase_kernels_variants``): the aligned builds
             at G = 6 (48 / 8) and 16 (32 / 2), decode, stream and
             extend, the merged builds at Hkv 36 (MiniCPM-2B's 36 / 36),
             bf16 and e4m3 KV, and the ALiBi instantiations at
             Baichuan2-13B's 40 / 40 with its slopes (bf16, e4m3 and
             float32; extend also b2 x q2048), SDPA taking the bias as a
             float mask as their library time. Then the LayerNorm
             families' attention (``phase_kernels_layernorm``), bf16 and
             e4m3 KV, each row with its head groups: StarCoder's 48 / 1
             (decode, stream, extend) and StarCoder2-7B's 36 / 4 (decode
             and extend, also with its 4096 window where it cuts) on the
             aligned builds, Falcon-7B's 71 / 1 and GPT-2-large's
             20 / 20 (decode, extend) on the merged builds,
             StableLM-2-1.6B's 32 / 32 (decode, stream, extend) on the
             chunked ones.
3. model   — the full-width models (random weights drawn on the card, seed
             0, 131072-token pool): the Llama-3.2-1B-class model on the
             chunked pool with bf16 KV, then with fp8_e4m3 KV, the
             Meta-Llama-3-8B geometry on the aligned pool with bf16 KV,
             then with fp8_e4m3 KV, DeepSeek-V2-Lite (MLA + MoE, 15.7 B
             parameters) on the latent pool with bf16 latent rows, then
             with fp8_e4m3 rows, MiniCPM3-4B (MLA, dense, 62 layers, 40
             heads; its longrope factor lists stand-ins, printed as such) on
             the 288-wide latent pool with bf16 rows, then with fp8_e4m3
             rows, TinyLlama-1.1B on the 5D pool at
             head_dim 64 with fp8_e4m3 KV, then with bf16 KV, and
             Gemma-2-9B (9.24 B parameters, 42 layers, the 5D pool at
             head_dim 256 through the _256 builds, softcaps 50 / 30, a
             window of 4096 on its even layers) with bf16 KV, then with
             fp8_e4m3 KV. One extend
             step and two decode steps each through the kernels, against
             the same layers run with the plain attention functions; after
             each path's serving but TinyLlama's (and the 8B bf16 one,
             which does not serve), once more with the streaming decode.
             Each step also runs with the attention's output zeroed and
             with twice its scale (``moves``: how far the logits move, in
             the gate's measure); on random weights, whose norms at 0.02
             N(0, 1) leave every head attending near-uniformly, a wrong
             scale hardly moves them, so every model's phase runs once
             more, with one of its KV dtypes at least, on
             ``make_attentive`` weights (the attention's norms at 1),
             where both moves must exceed the gate (ROADMAP C15). At the end, from the published
             config.json literals of ``PUBLISHED``, full width and depth:
             Qwen3-8B (per-head q/k norms, G = 4) with bf16 KV, then
             fp8_e4m3 KV (also streamed), Qwen1.5-MoE-A2.7B (qkv
             bias, 60 experts top-4 and a shared expert, G = 1), Gemma-7B
             (G = 1 at head_dim 256: the _256 builds) with bf16 KV on a
             65536-token pool, then fp8_e4m3 KV on 131072, OLMoE-1B-7B
             (full-width q/k norms, 64 experts top-8, G = 1), each served
             in both modes (phases 3g, 4); then phase 3 alone for
             Mistral-7B-v0.1 at 8 of 32 layers (prompts of 5000 and 4200
             tokens prefilled in 4096-token chunks: its 4096 window cuts),
             Mixtral-8x7B-v0.1 at
             4 of 32 layers, Qwen3-30B-A3B at 8 of 48 (G = 8) and Gemma-7B
             in float32 at 4 layers (gate 1e-3), each with its cut
             (``reduced``) in its line. Last, the Llama-computation
             variants from ``PUBLISHED``: ChatGLM3-6B (G = 16, half-dim
             interleaved rope), Baichuan2-13B (ALiBi through the ALiBi
             instantiations, bf16 KV on a 57344-token pool), MiniCPM-2B
             (the merged builds at 36 KV heads, context 2048) and
             deepseek-moe-16b (dense first layer, 64 experts top-6 and 2
             shared) through phases 3, 3g and 4 (each serve phase prints
             the log-prob gap at each request's first difference between
             the modes); InternLM2-7B-reward's rewards and input log-probs
             through the kernels against the plain attention, raw and
             attentive (``reward`` line); phase 3 alone for InternLM2-20B
             (G = 6), GLM-4-9B (then fp8_e4m3 KV with the streaming
             decode), EXAONE-3.0-7.8B, Qwen-7B, Baichuan2-7B,
             Phi-3-medium-4k (prompts past its 2047 window) and
             Granite-3.0-8B at a quarter of their depth and Grok-1 at 4 of
             64 layers.
             Then the LayerNorm families from ``PUBLISHED_LN`` (their
             aliases and class defaults read by ModelConfig's own table):
             StarCoder (multi-query G = 48 on the aligned pool, three head
             groups a KV head; phase 3 also with the streaming decode),
             Falcon-7B (G = 71 over one 64-element slot row on the merged
             pool, context 2048), StableLM-2-1.6B (the chunked pool at Hkv
             32; also streamed) and GPT-2-large (the merged pool at Hkv 20,
             1024 learned positions: context 1024, prompts under 960)
             through phases 3, 3g and 4; phase 3 alone for phi-1_5,
             aya-23-8B,
             OLMo-2-1124-7B, OLMo-1B, Phi-3-small-8k at full depth and
             DBRX at 4 of 40 layers. ``make_attentive`` lifts a LayerNorm's
             weight ``.w`` and keeps its bias.
3g. graphs — after each path's model phase (and its streaming one), at full
             width: one decode batch of 64 requests (kv 520-1000, shuffled
             pages) through the eager step (``decode_graphs`` off) and
             through a replay of its CUDA graph, then a second batch of the
             same key (other lengths and pages, input ids chained from the
             first step's tokens) the same way: tokens and log-probs must
             be bitwise equal in both, and the second must not capture
             again. One eager decode step and one replay run under
             ``torch.cuda.set_sync_debug_mode("error")`` (no host sync).
             One ``graphs`` line per decode path (fifteen): captures,
             capture seconds, the graph pool's bytes, and the eager and the
             replayed step's wall at B = 64 (20 steps per turn, turns
             eager, graph, graph, eager).
4. serve   — the Engine with the bench's server settings serves 32 greedy
             requests (prompts 256-3072 tokens, 64 new tokens each;
             TinyLlama's at most 1984 tokens, its context being 2048),
             colocated and semi-PD, with the 1B-class model (chunked pool,
             bf16 and fp8_e4m3 KV), the 8B model with fp8_e4m3 KV (aligned
             pool), DeepSeek-V2-Lite (latent pool, bf16 and fp8_e4m3 rows),
             MiniCPM3-4B (the 288 latent builds, bf16 and fp8_e4m3 rows)
             TinyLlama-1.1B (the merged kernels) and Gemma-2-9B (the _256
             builds, bf16 and fp8_e4m3 KV); every
             launch counter is set to 0 just before each run and read just
             after, and only the path's own two kernels may have launched,
             each L times per step of its kind (Gemma-2 with decode_stream:
             the stream on its 21 full-attention layers, the packed decode
             on its 21 windowed ones, per decode step). Every decode step is
             replayed from a CUDA graph (replays == decode steps; a replay
             counts its L launches, a capture none; graphs are kept from
             one serve to the next on one routing). The bf16 1B-class and
             DeepSeek-V2-Lite paths serve colocated a second time (their graphs
             captured), which must give the first run's tokens exactly,
             then once more with the decode steps run eagerly, which must
             give them too. Every path but TinyLlama's then serves
             colocated once more with ``decode_stream``
             (the streaming decode), on the same weights: their stream
             kernel launches L times per decode step and the packed decode
             never. DeepSeek-V2-Lite's and MiniCPM3-4B's must give the
             packed serve's tokens exactly, with bf16 and with fp8 rows:
             their two decodes give the same bits.

3s. spec model — the 1B-class model speculating (EAGLE, tree of topk 4 and
             4 draft tokens; the draft drawn from seed + 1): one tree round
             and one chain round over 4 prefilled requests through the
             kernels and again through the plain attention (target and
             draft pool), the target's logits within 5% on the rows both
             verified alike; accept_len and next_tok of both printed.
3r. round graphs — on that engine, after 3s, and on every speculating
             target's tree engine after its 3s: for each round kind it
             serves (the 1B-class model EAGLE tree, chain and NGRAM's
             verify; the 8B model and Gemma-2-9B EAGLE tree and chain;
             V2-Lite and MiniCPM3-4B NextN tree and chain), a round batch
             of 32 requests (prefixes 520-1000, pages from the allocator,
             prefix rows random, random hidden states) run eagerly
             (``decode_graphs`` off) and replayed from its round graph
             from the same pools and generator state, then a second batch
             of the same key: accept lengths, next tokens, tokens, hidden
             states and both pools' window rows bitwise equal, one
             capture, drafts accepted; one replay under
             ``torch.cuda.set_sync_debug_mode("error")``. One
             ``round_graphs`` line per (target, kind): captures, capture
             seconds, the graph pool's bytes, kernel launches per replay,
             and the eager and replayed round wall (5 rounds a turn, turns
             eager, graph, graph, eager).
4s. spec serve — that engine serves the 32 prompts (64 greedy tokens,
             the bench's settings, bf16 KV) with NGRAM, EAGLE chain and
             EAGLE tree, colocated and semi-PD, every round replayed from
             its round graph (replays == rounds, printed with the graphs'
             captures and pool): only the speculating
             path's builds launch (rpa_extend L times per prefill chunk
             and per verify; rpa_decode_merged once per chain draft or
             refresh step, rpa_extend_merged once per tree draft step;
             rpa_decode never); rounds, accepted tokens per round, tok/s,
             TTFT and ITL p50 and the prefill chunks printed. The tree
             serve runs again and must give its own tokens exactly, and
             once more with its rounds run eagerly, which must give them
             too. Then a
             non-speculating serve on the same weights; each speculating
             serve's share of requests with its tokens, and the log-prob
             gap at each first difference, are printed, not gated.
4a. 8B spec — Meta-Llama-3-8B at full width (16 of its 32 layers:
             SPEC_LAYERS) on the aligned pool with
             fp8_e4m3 KV speculating with the EAGLE draft (a llama layer at
             its geometry over a one-layer 5D pool at head_dim 128, fp8
             too), as 4e: 3s, 3r, then EAGLE tree and chain serving the 32
             prompts in both modes: rpa_extend_aligned (the verify, L
             times, and, in its TREE instantiation, the tree's verify and
             draft steps) and rpa_decode_aligned, nothing else; the tree
             engine (built with the 8B's tokenizer object) then serves 8
             requests, one under a regex, which take plain decode steps
             while it runs (``spec_fallback`` line: fallback decode steps,
             rounds, accepted drafts, the regex text); 4af, its float32
             gate at 4 layers, as 4mf.
4c. constrained — on the 8B fp8 engine after its Path S serve (the packed
             decode's routing again), built with ``SmokeTokenizer``, a
             tokenizer object over the 128256 ids made here (no
             download): each decode step variant (plain, a grammar's bool
             mask, a float32 logit bias, the penalty histogram, top-k 5)
             at B 32 and 64 eager and replayed from its own key's graph,
             bitwise, one capture a key, a replay without host sync, the
             walls (``constrained_steps`` lines); then 8 requests
             (prompts 256-1024, 48 new tokens) in one batch, MIX_4C: two
             penalized (repetition 1.2, frequency 0.5), two under a regex,
             one under a small JSON schema, one ``logit_bias``, one top-k
             5, one plain; served colocated and semi-PD on graphs,
             colocated once more with eager decode steps (the same tokens),
             and the same prompts served plain in both modes
             (``constrained_serve`` lines: ITL, tok/s, decode steps, jump
             tokens); every constrained output must match its grammar;
             ``score`` of the unconstrained requests' served tokens within
             1e-2 of the serve's log-probs, and ``encode`` of 4 prompts
             within 1e-3 of their last tokens' final-normed hidden states
             (``step_with_hidden``), normalized here; the grammar compiler's
             seconds at vocab 128256 (the token-string table, each DFA, the
             token-level state tables); only rpa_decode_aligned and
             rpa_extend_aligned launch, L times a step of their kind
             (``constrained_phase`` line).
4f. f32 gate — the 1B-class model in float32 (8 requests x 32 tokens)
             served with the EAGLE tree and without speculation: the tokens
             must be equal.
4n. nextn   — DeepSeek-V2-Lite at full width (14 of its 27 layers)
             speculating with its NextN
             draft (one MoE layer mirroring the last, drawn from seed + 1,
             over a one-layer latent pool [1, 1, S, 1, 576]): one tree and
             one chain round kernels vs plain attention (``spec_model``
             lines), then NEXTN chain and tree (topk 4, 4 draft tokens)
             serving the 32 prompts colocated and semi-PD, each on an
             Engine of its own on predictive weights (final norm ones,
             embedding x3, eh_proj passing the normed embedding, NextN's
             norms ones): rpa_extend_mla launches L times per prefill
             chunk and per verify and once per tree draft step,
             rpa_decode_mla once per chain draft or refresh step, nothing
             else; every serve fails if no draft was accepted. The tree
             serves colocated once more with its rounds run eagerly, which
             must give the same tokens.
4nf. nextn f32 gate — V2-Lite in float32 at 4 layers (8 requests x 32
             tokens) served with the NextN tree and without speculation:
             the tokens must be equal.
4l. long    — Gemma-2-9B (bf16 KV) serves 8 requests of 4500-7000 prompt
             tokens, 64 greedy new tokens each, colocated and semi-PD: the
             windowed layers cut in each prompt's second 4096-token
             prefill chunk and in decode; TTFT, ITL and tok/s per mode
             (``serve_long`` lines).
4g. gemma2 f32 gate — Gemma-2-9B in float32 at 4 layers (full widths;
             8 requests of 4500-6000 prompt tokens x 32 greedy tokens)
             through the _256 kernels, then on the same engine through the
             plain attention: the tokens must be equal.
4m. minicpm3 spec — MiniCPM3-4B at full width (31 of its 62 layers)
             speculating with its NextN
             draft (a dense layer mirroring the last, over a one-layer
             latent pool [1, 1, S, 1, 288]), as 4n: a tree and a chain
             round kernels vs plain, then NEXTN tree and chain serving the
             32 prompts colocated and semi-PD on predictive weights:
             rpa_extend_mla_288 launches L times per prefill chunk and per
             verify and once per tree draft step, rpa_decode_mla_288 once
             per chain draft or refresh step, nothing else; every serve
             fails if no draft was accepted. Each spec_serve line counts
             the extend's TREE = true launches (``tree_launches``).
4mf. its float32 gate — MiniCPM3-4B in float32 at 4 layers (8 requests x
             32 tokens) served with the NextN tree through the kernels,
             then on the same engine through the plain attention (target
             and draft pool): the tokens must be equal.
4e. gemma2 spec — Gemma-2-9B at full width (21 of its 42 layers)
             speculating with the EAGLE
             draft (a llama layer at its geometry over a one-layer 5D pool
             at head_dim 256), as 4m with EAGLE tree and chain:
             rpa_extend_aligned_256 (the verify with softcap 50 and the
             even layers' 4096 window, the tree draft steps without) and
             rpa_decode_aligned_256, nothing else.
4ef. its float32 gate — Gemma-2-9B in float32 at 4 layers, prompts of
             4500-6000 (the window cuts in the tree verify), as 4mf with
             the EAGLE tree.
4v. images  — after the families' phases (see the calls in ``main``), the
             image path from PUBLISHED_VLM: LLaVA-1.5-7B and Qwen2-VL-7B
             at full depth through phase 3 (three of its four prompts with
             an image, encoded and spliced; raw and attentive weights,
             Qwen2-VL also streamed), the image gate (``image_gate``: two
             images on one prompt must move the logits at its last row past
             the 5% gate on the attentive weights, where make_attentive
             also sets the towers' and projector's norms to 1), the tower's
             time a image (``tower``), 3g (Qwen2-VL's decode with its rope
             positions shifted, as images shift them, replayed bitwise) and
             4 (32 requests with an image each, both modes), then
             ``image_checks``: two images in a prompt, an input_embeds
             prompt giving its ids' tokens, and ROADMAP C19 (an image
             prompt's ids cached as text, then two images on them: the
             second gives its fresh-cache tokens and log-probs, nothing
             cached). Qwen2.5-VL-7B (the window tower) and Yi-VL-6B
             (ViT-H/14 at 448, 1024 tokens an image) through phase 3, the
             gate and the tower's time. Then the sequence classifiers
             (Skywork-Reward-Llama-3.1-8B, Skywork-Reward-Gemma-2-27B at 11
             of 46 layers, Qwen2.5-Math-RM-72B at 8 of 80): their scores
             through Engine.encode, kernels vs plain (``reward`` lines).
             Phase 2 holds G = 7 (28 / 4) and Gemma-2's 32 / 16 at
             head_dim 128 with softcap 50 and its 4096 window
             (``phase_kernels_vlm``).

Then one JSON line listing the kernels (the six extends with
``masked_max_abs_err``, the largest error of their masked cases), the
nvidia-smi name/power-limit line, and the result line {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PAGE = 16
# (Hq, Hkv, head_dim, V width) of each pool's path: the 1B-class model's,
# Llama-3-8B's, TinyLlama-1.1B's (the 5D pool at head_dim 64: the merged
# kernels), DeepSeek-V2-Lite's latent row (kv_lora 512 + rope 64) and
# MiniCPM3-4B's (kv_lora 256 + rope 32, 40 heads: the _288 builds)
GEOMETRY = {"chunked": (32, 8, 64, 64), "aligned": (32, 8, 128, 128),
            "merged": (32, 4, 64, 64), "latent": (16, 1, 576, 512),
            "latent288": (40, 1, 288, 256),
            # Gemma-2-9B's 5D pool at head_dim 256: the _256 builds
            "aligned256": (16, 8, 256, 256),
            # the 1B-class model's EAGLE draft pool: its 5D pool at head_dim
            # 64 with Hkv 8 takes the merged kernels
            "draft": (32, 8, 64, 64),
            # one query head per KV head (G = 1) at head_dim 128
            # (Qwen1.5-MoE-A2.7B's, OLMoE-1B-7B's 16 / 16) and 256 (Gemma-7B's
            # 16 / 16), and eight (G = 8, Qwen3-30B-A3B's 32 / 4): the aligned
            # and _256 builds at other head groups
            "aligned_g1": (16, 16, 128, 128), "aligned256_g1": (16, 16, 256, 256),
            "aligned_g8": (32, 4, 128, 128),
            # six (G = 6: InternLM2-20B's and Grok-1's 48 / 8) and sixteen (G =
            # 16: ChatGLM3-6B's and GLM-4-9B's 32 / 2) at head_dim 128, the
            # merged pool at MiniCPM-2B's 36 / 36 (head_dim 64), and
            # Baichuan2-13B's 40 / 40 with ALiBi (the aligned builds' ALiBi
            # instantiations)
            "aligned_g6": (48, 8, 128, 128), "aligned_g16": (32, 2, 128, 128),
            "merged_h36": (36, 36, 64, 64), "aligned_alibi": (40, 40, 128, 128),
            # the LayerNorm families: StarCoder's multi-query 48 / 1 at head_dim
            # 128 (three head groups of 16 a KV head) and StarCoder2-7B's 36 /
            # 4 (G = 9), Falcon-7B's 71 / 1 at 64 (a 64-element slot row on the
            # merged pool, five head groups) and GPT-2-large's 20 / 20 on the
            # merged pool, StableLM-2-1.6B's and phi-1_5's 32 / 32 at 64 on the
            # chunked pool (a 4096-element slot row)
            "aligned_g48": (48, 1, 128, 128), "aligned_g9": (36, 4, 128, 128),
            "merged_g71": (71, 1, 64, 64), "merged_h20": (20, 20, 64, 64),
            "chunked_h32": (32, 32, 64, 64),
            # the image path's and the classifiers' heads: Qwen2-VL-7B's 28 / 4
            # (G = 7) and Skywork-Reward-Gemma-2-27B's 32 / 16 at head_dim 128
            # (G = 2, softcap 50, a 4096 window on alternate layers)
            "aligned_g7": (28, 4, 128, 128), "aligned_g2": (32, 16, 128, 128)}
# the chunked pools of GEOMETRY
CHUNKED = ("chunked", "chunked_h32")

# the build each pool of GEOMETRY runs (kernel_name's suffix)
POOL_BUILD = {"chunked": "", "aligned": "_aligned", "merged": "_merged", "draft": "_merged",
              "latent": "_mla", "latent288": "_mla_288", "aligned256": "_aligned_256",
              "aligned_g1": "_aligned", "aligned_g8": "_aligned",
              "aligned256_g1": "_aligned_256", "aligned_g6": "_aligned",
              "aligned_g16": "_aligned", "merged_h36": "_merged",
              "aligned_alibi": "_aligned_alibi", "aligned_g48": "_aligned",
              "aligned_g9": "_aligned", "merged_g71": "_merged", "merged_h20": "_merged",
              "chunked_h32": "", "aligned_g7": "_aligned", "aligned_g2": "_aligned"}

# the latent pools' paths
LATENT = ("latent", "latent288")

# H100 SXM5 80GB dense peaks (NVIDIA H100 Tensor Core GPU data sheet):
# HBM3 bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor
# cores.
PEAKS = (3.35e12, 989e12, 67e12)

# Kernel vs plain version: float32 differs only in summation order (online
# vs full softmax); the chunked and aligned kernels with bf16 q also round P
# to bf16 before P.V, as the GQA branches of the TPU kernels do (the merged
# and the MLA kernels keep P in float32), and have read at most 3.9e-3 at
# these shapes on an H100 (1.6e-2 where |out| reaches 2-4, within the
# relative term). The limit goes by q's dtype: with fp8 KV both versions
# read the same fp8 bytes.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each function in an nvcc -Xptxas -v log,
    by mangled name."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds per call on the card. A spin kernel (~25 ms) holds the
    card while the host queues the timed calls, so a wrapper's host work
    (argument checks, the ctypes call) is not timed in place of a kernel
    shorter than it; calls that wait for the card inside are timed whole."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 2
def make_case(gen, rng, q_lens, kv_lens, dtype, pool, kv_dtype, nan_dead=False):
    """Random pool (``pool``: a key of GEOMETRY, in ``kv_dtype``), queries
    and a SHUFFLED page table for requests with the given new-token and
    total KV lengths (kv_len 0 = a padded row); with ``nan_dead`` every
    slot that no live position holds is NaN."""
    import torch

    from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta

    B = len(kv_lens)
    HQ, HKV, D, _ = GEOMETRY[pool]
    n_pages = [-(-k // PAGE) for k in kv_lens]
    maxP = max(max(n_pages), 1)
    total = sum(n_pages) + 1  # + dump page 0
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, maxP), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    dev = "cuda"
    if pool in CHUNKED:
        shape = (1, total * PAGE, 2 * HKV * D // 128, 128)
    elif pool in LATENT:
        shape = (1, 1, total * PAGE, 1, D)
    else:  # the 5D pools
        shape = (1, 2, total * PAGE, HKV, D)
    kv = torch.randn(shape, generator=gen, device=dev)
    if nan_dead:
        live = np.zeros(total * PAGE, bool)
        for b, n in enumerate(kv_lens):
            pos = np.arange(n)
            live[pt[b, pos // PAGE] * PAGE + pos % PAGE] = True
        dead = torch.as_tensor(~live, device=dev)
        if pool in CHUNKED:
            kv[:, dead] = float("nan")
        else:
            kv[:, :, dead] = float("nan")
    kv = kv.to(kv_dtype)
    T = int(sum(q_lens))
    q = torch.randn((T, HQ, D), generator=gen, device=dev).to(dtype)
    meta = build_attn_meta(np.asarray(q_lens), np.asarray(kv_lens), T, device=dev)
    return (q, kv, torch.as_tensor(pt, device=dev),
            torch.as_tensor(np.asarray(kv_lens, np.int32), device=dev), meta)


def dense_kv(kv, pt, kv_lens, pool, dtype):
    """[B, Hkv, kvmax, D] K and [B, Hkv, kvmax, Dv] V gathered in ``dtype``
    for the library yardstick."""
    import torch

    from semi_pd_tpu_torch.ops.attention.rpa_common import gather_kv, layer_kv

    _, HKV, D, DV = GEOMETRY[pool]
    k_layer, v_layer = layer_kv(kv, 0, HKV, D, DV if pool in LATENT else None)
    lens = kv_lens.tolist()
    kvmax = max(max(lens), 1)
    B = len(lens)
    K = torch.zeros((B, kvmax, HKV, D), device=kv.device, dtype=dtype)
    V = torch.zeros((B, kvmax, HKV, DV), device=kv.device, dtype=dtype)
    for b, n in enumerate(lens):
        if n:
            k, v = gather_kv(k_layer, v_layer, pt[b], n, PAGE)
            K[b, :n], V[b, :n] = k.to(dtype), v.to(dtype)
    return K.transpose(1, 2).contiguous(), V.transpose(1, 2).contiguous(), kvmax


def kernel_name(kind, pool):
    """kind: "decode", "extend" or "stream" (the streaming decode)."""
    base = "rpa_decode_stream" if kind == "stream" else f"rpa_{kind}"
    return base + POOL_BUILD[pool]


def dtype_name(dt):
    return str(dt).replace("torch.", "")


def run_kernel_case(name, kind, gen, rng, q_lens, kv_lens, dtype, pool="chunked",
                    kv_dtype=None, cap=None, window=None, beside=None, nan_dead=False,
                    library_always=False):
    """One case of phase 2; ``beside``: more fields for its printed row;
    ``nan_dead``: every dead slot of the pool NaN; ``library_always``: the
    library call's time also for a capped or windowed case, SDPA uncapped
    and unwindowed over the same inputs (else a capped case has none)."""
    import torch
    import torch.nn.functional as F

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
    from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream

    kv_dtype = kv_dtype or dtype
    HQ, HKV, D, DV = GEOMETRY[pool]
    scale = D ** -0.5
    q, kv, pt, kvl, meta = make_case(gen, rng, q_lens, kv_lens, dtype, pool, kv_dtype,
                                     nan_dead)
    kw = dict(page_size=PAGE, scale=scale, logit_cap=cap, sliding_window=window)
    slopes = None
    if pool == "aligned_alibi":  # Baichuan2-13B's slopes of its 40 heads
        from semi_pd_tpu_torch.models.llama_variants import alibi_slopes

        slopes = torch.from_numpy(alibi_slopes(HQ)).to("cuda")
        kw["alibi_slopes"] = slopes
    if pool in LATENT:
        kw.update(v_dim=DV)
    if kind == "stream":  # no sliding window: the routing keeps it on the packed decode
        kw.pop("sliding_window")
    if pool in CHUNKED:
        kw.update(num_kv_heads=HKV, head_dim=D)
        fns = {"decode": (rpa_packed.ragged_paged_attention_chunked_packed,
                          rpa_packed.decode_attention_plain),
               "stream": (rpa_stream.ragged_paged_attention_chunked_stream,
                          rpa_packed.decode_attention_plain),
               "extend": (rpa.ragged_paged_attention_chunked_extend,
                          rpa.extend_attention_plain)}
    else:
        fns = {"decode": (rpa_packed.ragged_paged_attention_packed,
                          rpa_packed.ragged_paged_attention_packed_plain),
               "stream": (rpa_stream.ragged_paged_attention_stream,
                          rpa_packed.ragged_paged_attention_packed_plain),
               "extend": (rpa.ragged_paged_attention_extend,
                          rpa.ragged_paged_attention_extend_plain)}
    kfn, pfn = fns[kind]
    args = (q, kv, 0, pt, kvl) if kind != "extend" else (q, kv, 0, pt, kvl, meta)
    kern = lambda: kfn(*args, **kw)
    plain = lambda: pfn(*args, **kw)
    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    err = (out_k.float() - out_p.float()).abs()
    tol = TOL[dtype_name(dtype)]
    ok = bool((err <= tol + tol * out_p.float().abs()).all()) and bool(torch.isfinite(out_k).all())
    max_err = float(err.max())
    if not ok:
        raise AssertionError(f"{name} {pool} {dtype_name(dtype)}/{dtype_name(kv_dtype)}: kernel "
                             f"disagrees with its plain version (max abs err {max_err:.3g}, "
                             f"tol {tol})")
    counter = KERNELS[kernel_name(kind, pool)]
    before = counter.launches
    ms = cuda_ms(kern, 20)
    launches = counter.launches - before + 1  # + the checked call
    plain_ms = cuda_ms(plain, 2)

    # least time: bytes (each input once, output once; KV at its own width)
    # vs operations
    lens = kvl.tolist()
    ql = meta.q_lens.tolist()
    qs = meta.q_start.tolist()
    if kind != "extend":  # the query sits at n - 1 and sees min(n, window) rows
        kv_rows = pairs = sum(min(n, window) if window else n for n in lens)
    else:
        pairs = kv_rows = 0
        for b in range(len(lens)):
            if not ql[b]:
                continue
            for r in range(ql[b]):
                p = qs[b] + r + 1  # positions visible to this row: [lo, p)
                pairs += p - (max(p - window, 0) if window else 0)
            first = max(qs[b] + 1 - window, 0) if window else 0
            kv_rows += min(lens[b], qs[b] + ql[b]) - first
    # scores over D and P.V over DV per (row, head, visible position); bytes:
    # q and the output once, each live KV row once (K and V, or the one
    # latent row), the page table and lengths
    flops = 2.0 * pairs * HQ * (D + DV)
    ncomp = 1 if pool in LATENT else 2
    nbytes = (q.numel() * q.element_size() + out_k.numel() * out_k.element_size()
              + kv_rows * ncomp * HKV * D * kv.element_size()
              + pt.numel() * 4 + kvl.numel() * 4)
    bw, bf16_peak, f32_peak = PEAKS
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / (bf16_peak if dtype == torch.bfloat16 else f32_peak) * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    library_ms, library = None, None
    if cap is None or library_always:
        # SDPA over dense KV in q's dtype (fp8 KV upcast to bf16 first)
        K, V, kvmax = dense_kv(kv, pt, kvl, pool, dtype)
        library = "sdpa" + ("_over_kv_upcast_to_bf16" if kv_dtype != dtype else "")
        if library_always and (cap or window):  # the yardstick uncapped and unwindowed
            library += "_uncapped_unwindowed"
            window = None
        if slopes is not None:  # ALiBi as a float mask: the bias, -inf where masked
            library += "_alibi_float_mask"
        B = len(lens)
        if kind != "extend":
            qd = q[:, :, None, :]  # [B, Hq, 1, D]
            pos = torch.arange(kvmax, device="cuda")[None, :]
            n = kvl[:, None].long()
            mask = pos < n
            if window:
                mask &= pos >= n - window
            mask = mask[:, None, None, :]
            if slopes is not None:
                bias = -slopes[None, :, None, None] * (n - 1 - pos).float()[:, None, None, :]
                mask = torch.where(mask, bias, torch.tensor(float("-inf"), device="cuda"))
                mask = mask.to(q.dtype)
        else:
            qmax = max(ql)
            qd = torch.zeros((B, HQ, qmax, D), device="cuda", dtype=q.dtype)
            rows = torch.arange(qmax, device="cuda")
            mask = torch.zeros((B, 1, qmax, kvmax), device="cuda", dtype=torch.bool)
            off = 0
            pos = torch.arange(kvmax, device="cuda")[None, :]
            for b in range(B):
                qd[b, :, : ql[b]] = q[off: off + ql[b]].transpose(0, 1)
                qa = qs[b] + rows[:, None]
                m = (pos <= qa) & (pos < lens[b]) & (rows[:, None] < ql[b])
                if window:
                    m &= pos > qa - window
                mask[b, 0] = m
                off += ql[b]
            if slopes is not None:
                qa = (torch.as_tensor(qs, device="cuda")[:, None]
                      + rows[None, :])[:, None, :, None]  # [B, 1, qmax, 1]
                bias = -slopes[None, :, None, None] * (qa - pos[None, None]).float()
                mask = torch.where(mask, bias, torch.tensor(float("-inf"), device="cuda"))
                mask = mask.to(q.dtype)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, K, V, attn_mask=mask, scale=scale, enable_gqa=True), 20)
    row = dict(case=name, kernel=counter.name, pool=pool, dtype=dtype_name(dtype),
               kv_dtype=dtype_name(kv_dtype), max_abs_err=max_err, kernel_ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, library=library,
               bound_ms=bound_ms, bound_by=bound_by, launches=launches)
    if slopes is not None:  # the build's ALIBI = false kernels on the same inputs
        kw.pop("alibi_slopes")
        row["without_alibi_ms"] = cuda_ms(kern, 20)
        row["alibi_over_without"] = ms / row["without_alibi_ms"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the tensor-core kernels' second grid dimension: KV heads, or the
    # latent pool's head groups
    groups = rpa_packed.head_groups(counter, HQ, HKV)
    if counter.name in rpa_packed.DECODE_SPLIT and dtype == torch.bfloat16:
        # the (n_split, split_len) the wrapper gave the tensor-core kernel
        row["split_plan"] = rpa_packed.decode_split_plan(
            counter.name, len(lens), groups, pt.shape[1] * PAGE, sms)
    if counter.name in rpa_stream.STREAM_TILE and dtype == torch.bfloat16:
        # the tensor-core stream's blocks per KV head (per head group)
        row["stream_blocks"] = rpa_stream.stream_blocks(
            counter.name, len(lens), groups, pt.shape[1] * PAGE, sms,
            fp8=kv.element_size() == 1)
    row.update(beside or {})
    print("kernel_case " + json.dumps(row), flush=True)
    del q, kv
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    rows = []

    def ragged(b, kv):
        lens = rng.integers(kv // 2, kv + 1, size=b)
        lens[0] = kv
        lens[-1] = 0  # one padded row
        return lens.tolist()

    ext = {"extend_b8_q256_kv2048": ([256] * 8, [2048] * 8),
           "extend_ragged_kv1024": ([512, 256, 128, 64, 384, 448, 192, 64], [1024] * 8)}
    # (pool, q dtype, KV dtype) of each path's cases, and its decode shapes
    types = {"chunked": [(bf, bf), (f32, f32)],
             "aligned": [(bf, bf), (f32, f32), (bf, e4m3)],
             "merged": [(bf, bf), (f32, f32), (bf, e4m3)],
             "latent": [(bf, bf), (f32, f32)]}
    decode_shapes = {"chunked": ((16, 8192), (64, 1024), (128, 2048)),
                     "aligned": ((16, 8192), (64, 1024), (128, 2048)),
                     "merged": ((16, 8192), (64, 1024), (128, 2048)),
                     "latent": ((64, 1024), (16, 4096), (128, 2048))}
    fp8_pools = ("aligned", "merged")
    for pool, pairs in types.items():
        for b, kv in decode_shapes[pool]:
            lens = ragged(b, kv)
            # the streaming decode on the pools that have one, same inputs' shapes
            # beside each stream row, the packed decode's time on the same case
            kinds = ("decode",) if pool == "merged" else ("decode", "stream")
            packed = {}
            for kind in kinds:
                cases = pairs + ([(bf, e5m2)] if pool in fp8_pools and b == 64 else [])
                for dt, kdt in cases:
                    beside = ({"packed_kernel_ms": packed[dt, kdt]} if kind == "stream"
                              else None)
                    rows.append(run_kernel_case(f"decode_b{b}_kv{kv}", kind, gen, rng,
                                                [1] * b, lens, dt, pool, kdt, beside=beside))
                    packed[dt, kdt] = rows[-1]["kernel_ms"]
        for name, (ql, kl) in ext.items():
            for dt, kdt in pairs:
                rows.append(run_kernel_case(name, "extend", gen, rng, ql, kl, dt, pool, kdt))
        if pool == "latent":  # its mask cases come after every other case, below
            continue
        # softcap 1.0: scores q.k * D**-0.5 have std ~1 here, so the cap bends
        # most of them (tanh(2) = 0.96) and a kernel that ignored it would fail
        dec = ("decode", [1] * 16, ragged(16, 2048), "decode_b16_kv2048")
        ext1 = ("extend", [256] * 8, [2048] * 8, "extend_b8_q256_kv2048")
        for kind, ql, kl, base in (dec, ext1):
            for dt in (bf, f32):
                rows.append(run_kernel_case(f"{base}_softcap1", kind, gen, rng, ql, kl, dt,
                                            pool, cap=1.0))
                rows.append(run_kernel_case(f"{base}_window512", kind, gen, rng, ql, kl, dt,
                                            pool, window=512))
    # after the cases above, so that those draw the same inputs as before:
    # one chunked-prefill step of two fresh 2048-token prompts, where tiles
    # above the diagonal are skipped, and e5m2 KV under the extend
    for pool, pairs in types.items():
        for dt, kdt in pairs:
            rows.append(run_kernel_case("extend_b2_q2048_kv2048", "extend", gen, rng,
                                        [2048] * 2, [2048] * 2, dt, pool, kdt))
        if pool in fp8_pools:
            rows.append(run_kernel_case("extend_b8_q256_kv2048", "extend", gen, rng,
                                        *ext["extend_b8_q256_kv2048"], bf, pool, e5m2))
    # after every case above: the latent decodes with softcap 1.0 and the
    # packed one with window 512 (the stream takes no window), whose low
    # edge falls inside the tensor-core decode's splits
    lens = ragged(16, 2048)
    for kind in ("decode", "stream"):
        for dt in (bf, f32):
            rows.append(run_kernel_case("decode_b16_kv2048_softcap1", kind, gen, rng, [1] * 16,
                                        lens, dt, "latent", cap=1.0))
            if kind == "decode":
                rows.append(run_kernel_case("decode_b16_kv2048_window512", kind, gen, rng,
                                            [1] * 16, lens, dt, "latent", window=512))
    # after every case above, so that those draw the same inputs as before:
    # fp8 KV on the chunked pool and fp8 latent rows, bf16 q, e4m3 at every
    # decode, stream and extend shape, e5m2 at b64 and under the b8 x q256
    # extend (as the aligned and merged pools take them above)
    for pool in ("chunked", "latent"):
        for b, kv in decode_shapes[pool]:
            lens = ragged(b, kv)
            packed = {}
            for kind in ("decode", "stream"):
                for kdt in (e4m3, e5m2) if b == 64 else (e4m3,):
                    beside = {"packed_kernel_ms": packed[kdt]} if kind == "stream" else None
                    rows.append(run_kernel_case(f"decode_b{b}_kv{kv}", kind, gen, rng,
                                                [1] * b, lens, bf, pool, kdt, beside=beside))
                    packed[kdt] = rows[-1]["kernel_ms"]
        for name, (ql, kl) in {**ext, "extend_b2_q2048_kv2048": ([2048] * 2,
                                                                 [2048] * 2)}.items():
            for kdt in (e4m3, e5m2) if name == "extend_b8_q256_kv2048" else (e4m3,):
                rows.append(run_kernel_case(name, "extend", gen, rng, ql, kl, bf, pool, kdt))
    return rows


# ------------------------------------------------------- phase 2, the tree
def tree_case(gen, rng, pool, dtype, kv_dtype, tree, draft_level=None, B=64,
              prefix_range=(520, 1001)):
    """A speculation tree's attention on the card: B requests of 520-1000
    (``prefix_range``) committed positions on SHUFFLED pages, each followed by the window of
    the tree's N nodes (slot-order positions prefix + j). Without
    ``draft_level``: the tree verify, N rows per request (q_start = prefix).
    With it: that level's draft step, B * n rows of q_len 1 over the page
    table tiled n times (kv_len = the node's slot + 1). Every slot no live
    position holds is NaN (C2). Returns the wrapper's arguments and what
    the bound and the library call need."""
    import torch

    from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta
    from semi_pd_tpu_torch.speculative.eagle import _decode_meta

    HQ, HKV, D, _ = GEOMETRY[pool]
    N = tree.num_nodes
    prefix = rng.integers(*prefix_range, size=B)
    lens = prefix + N
    n_pages = [-(-int(k) // PAGE) for k in lens]
    total = sum(n_pages) + 1
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(n_pages)), np.int32)
    live = np.zeros(total * PAGE, bool)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
        pos = np.arange(lens[b])
        live[pt[b, pos // PAGE] * PAGE + pos % PAGE] = True
    shape = ((1, total * PAGE, 2 * HKV * D // 128, 128) if pool == "chunked" else
             (1, 1, total * PAGE, 1, D) if pool in LATENT else (1, 2, total * PAGE, HKV, D))
    kv = torch.randn(shape, generator=gen, device="cuda")
    dead = torch.as_tensor(~live, device="cuda")
    if pool == "chunked":
        kv[:, dead] = float("nan")
    else:
        kv[:, :, dead] = float("nan")
    kv = kv.to(kv_dtype)
    if draft_level is None:
        q_lens = np.full(B, N)
        kv_lens = lens
        q_abs = (prefix[:, None] + np.arange(N)[None]).reshape(-1)
        meta = build_attn_meta(q_lens, kv_lens, B * N, device="cuda")
        req, win = np.repeat(np.arange(B), N), prefix
        window_rows = N
    else:
        level = tree.level_nodes[draft_level]
        # a draft step reads the window's nodes some row of its level sees:
        # the union of their ancestor masks (the root and the 4 nodes at level 1)
        window_rows = bin(int(np.bitwise_or.reduce([tree.anc_bits[j] for j in level]))).count("1")
        q_abs = np.concatenate([prefix + j for j in level])
        kv_lens = q_abs + 1
        meta = _decode_meta(torch.as_tensor(q_abs.astype(np.int32), device="cuda"))
        req, pt, win = np.tile(np.arange(B), len(level)), np.tile(pt, (len(level), 1)), \
            np.tile(prefix, len(level))
    T = len(q_abs)
    q = torch.randn((T, HQ, D), generator=gen, device="cuda").to(dtype)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    return dict(q=q, kv=kv, pt=t(pt), kvl=t(kv_lens), meta=meta, win_base=t(win),
                q_abs=q_abs, req=req, prefix=prefix,
                unique_rows=int(prefix.sum()) + B * window_rows)


def run_tree_case(name, gen, rng, pool, dtype, kv_dtype, tree, draft_level=None, cap=None,
                  window=None, prefix_range=(520, 1001), beside=None):
    """One masked case of phase 2: the extend of ``pool`` (a GQA build, or
    on a latent pool an MLA one) with the tree's masks (and ``cap`` /
    ``window``, a window tested against each row's slot-order position)
    against its plain version, timed beside the plain version, one
    scaled_dot_product_attention over pre-gathered KV with the boolean tree
    mask (the window in it, no softcap; upcast to bf16 for fp8 KV), and the
    bound; on the latent pools and at head_dim 256 also the same inputs
    without the tree (the unmasked instantiation: ``causal_ms``). Its row
    is a ``kernel_case`` line with ``spec_tree`` set; ``beside``: more
    fields for it."""
    import torch
    import torch.nn.functional as F

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
    from semi_pd_tpu_torch.ops.attention.rpa_common import spec_tree_mask

    HQ, HKV, D, DV = GEOMETRY[pool]
    c = tree_case(gen, rng, pool, dtype, kv_dtype, tree, draft_level, prefix_range=prefix_range)
    anc = tuple(int(a) for a in tree.anc_bits)
    kw = dict(page_size=PAGE, scale=D ** -0.5, spec_anc=anc, win_base=c["win_base"],
              logit_cap=cap, sliding_window=window)
    if pool in LATENT:
        kw["v_dim"] = DV
    args = (c["q"], c["kv"], 0, c["pt"], c["kvl"], c["meta"])
    if pool == "chunked":
        kern = lambda: rpa.ragged_paged_attention_chunked_extend(
            *args, num_kv_heads=HKV, head_dim=D, **kw)
        plain = lambda: rpa.extend_attention_plain(*args, num_kv_heads=HKV, head_dim=D, **kw)
    else:
        kern = lambda: rpa.ragged_paged_attention_extend(*args, **kw)
        plain = lambda: rpa.ragged_paged_attention_extend_plain(*args, **kw)
    counter = KERNELS[kernel_name("extend", pool)]
    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    err = (out_k.float() - out_p.float()).abs()
    tol = TOL[dtype_name(dtype)]
    max_err = float(err.max())
    if not (bool((err <= tol + tol * out_p.float().abs()).all())
            and bool(torch.isfinite(out_k).all())):
        raise AssertionError(f"{name} {pool} {dtype_name(dtype)}/{dtype_name(kv_dtype)}: the "
                             f"masked kernel disagrees with its plain version (max abs err "
                             f"{max_err:.3g}, tol {tol})")
    before = counter.launches
    ms = cuda_ms(kern, 20)
    launches = counter.launches - before + 1
    plain_ms = cuda_ms(plain, 2)
    beside = dict(beside or {})
    if pool in ("latent", "latent288", "aligned256"):  # the tree-less instantiation
        causal = lambda: rpa.ragged_paged_attention_extend(
            *args, **{k: v for k, v in kw.items() if k not in ("spec_anc", "win_base")})
        beside["causal_ms"] = cuda_ms(causal, 20)

    # the work these inputs need: each row sees the prefix before its window
    # and its ancestors in it (with ``window``, those above its slot-order
    # position - window); the KV rows some row sees, read once per request
    w = window or 1 << 30
    pairs = 0
    for r, qa in zip(c["req"], c["q_abs"]):
        p0 = int(c["prefix"][r])
        bits = anc[qa - p0]
        pairs += max(p0 - max(qa - w + 1, 0), 0) + sum(
            1 for j in range(len(anc)) if (bits >> j) & 1 and p0 + j > qa - w)
    unique_rows = c["unique_rows"]
    if window:  # a verify's: each request's rows from its first row's window start
        unique_rows -= int(np.maximum(c["prefix"] - window + 1, 0).sum())
    flops = 2.0 * pairs * HQ * (D + DV)
    q, kv = c["q"], c["kv"]
    ncomp = 1 if pool in LATENT else 2  # the latent row is K and V at once
    nbytes = (q.numel() * q.element_size() + q.shape[0] * HQ * DV * q.element_size()
              + unique_rows * ncomp * HKV * D * kv.element_size()
              + c["pt"].numel() * 4 + c["kvl"].numel() * 4 + c["win_base"].numel() * 4)
    bw, bf16_peak, f32_peak = PEAKS
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / (bf16_peak if dtype == torch.bfloat16 else f32_peak) * 1e3

    # library yardstick: SDPA over dense KV gathered per row group (a
    # request's N verify rows, or each draft row over its tiled table) with
    # the boolean causal-and-tree mask
    K, V, kvmax = dense_kv(kv, c["pt"], c["kvl"], pool, dtype)
    pos = torch.arange(kvmax, device="cuda")
    if draft_level is None:
        B, N = len(c["prefix"]), tree.num_nodes
        qd = q.reshape(B, N, HQ, D).transpose(1, 2)
        qa = torch.as_tensor(c["q_abs"], device="cuda").reshape(B, N, 1)
        wb = torch.as_tensor(c["prefix"], device="cuda")[:, None, None]
    else:
        qd = q[:, :, None, :]
        qa = torch.as_tensor(c["q_abs"], device="cuda")[:, None, None]
        wb = c["win_base"].long()[:, None, None]
    valid = (pos[None, None] <= qa) & (pos[None, None] < c["kvl"].long()[:, None, None])
    if window:
        valid &= pos[None, None] > qa - window
    mask = spec_tree_mask(valid, anc, wb, qa, pos[None, None])[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, K, V, attn_mask=mask, scale=D ** -0.5, enable_gqa=True), 20)
    row = dict(case=name, kernel=counter.name, pool=pool, dtype=dtype_name(dtype),
               kv_dtype=dtype_name(kv_dtype), spec_tree=list(tree.branching),
               draft_level=draft_level, rows=int(q.shape[0]), max_abs_err=max_err,
               kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               library="sdpa_tree_mask" + ("_uncapped" if cap else "")
               + ("_over_kv_upcast_to_bf16" if kv_dtype != dtype else ""),
               logit_cap=cap, sliding_window=window,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               launches=launches, **beside)
    print("kernel_case " + json.dumps(row), flush=True)
    del c, K, V, mask
    torch.cuda.empty_cache()
    return row


def phase_spec_kernels():
    """Phase 2's speculation cases, after every other case (so that those
    draw the inputs they drew before): the tree verify (b64 x N = 29,
    default_tree_template(4, 4)) through rpa_extend at the 1B-class
    geometry and through rpa_extend_aligned at the 8B's (bf16, float32 and
    e4m3 KV), the tree's level-1 draft step (b64 x 4 rows) through
    rpa_extend_merged at the draft pool's Hq 32 / Hkv 8, and rpa_decode_merged
    at that geometry (the chain's draft steps), b64 / kv1024; then, after
    those, NextN's on DeepSeek-V2-Lite's latent pool: the tree verify
    through rpa_extend_mla (bf16 and e4m3 rows under bf16 q, float32) and
    the tree's level-1 draft step on the one-layer draft pool (bf16,
    float32; its chain draft steps are phase 2's latent decode). Last, the
    TREE instantiations of the _256 and _288 extends: EAGLE's tree verify on
    Gemma-2-9B through rpa_extend_aligned_256 (Hq 16 / Hkv 8 / D 256,
    softcap 50, as every Gemma-2 layer; bf16, e4m3 and float32), again with
    the windowed layers' 4096 window over prefixes of 4100-6000 (each of a
    request's 29 rows its own window start, tested against its slot-order
    position; bf16 and float32), and its level-1 draft step on the
    one-layer draft pool (no cap, no window; bf16, float32); then NextN's on
    MiniCPM3-4B through rpa_extend_mla_288 (Hq 40 over the 288 latent row):
    the tree verify (bf16 and e4m3 rows under bf16 q, float32) and the
    level-1 draft step (bf16, float32). Each of these rows carries its TREE
    = true function's registers and spills and ``causal_ms``, the TREE =
    false instantiation on the same inputs."""
    import torch

    from semi_pd_tpu_torch.speculative.tree import default_tree_template

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rng = np.random.default_rng(14)
    tree = default_tree_template(4, 4)
    bf, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    rows = []
    for pool, pairs in (("chunked", [(bf, bf), (f32, f32)]),
                        ("aligned", [(bf, bf), (f32, f32), (bf, e4m3)])):
        for dt, kdt in pairs:
            rows.append(run_tree_case("tree_verify_b64_n29", gen, rng, pool, dt, kdt, tree))
    for dt in (bf, f32):
        rows.append(run_tree_case("tree_draft_b64x4", gen, rng, "draft", dt, dt, tree,
                                  draft_level=1))
    lens = rng.integers(512, 1025, size=64)
    lens[0] = 1024
    for dt in (bf, f32):
        rows.append(run_kernel_case("decode_b64_kv1024_draft", "decode", gen, rng, [1] * 64,
                                    lens.tolist(), dt, "draft"))
    for dt, kdt in ((bf, bf), (bf, e4m3), (f32, f32)):
        rows.append(run_tree_case("tree_verify_b64_n29", gen, rng, "latent", dt, kdt, tree))
    for dt in (bf, f32):
        rows.append(run_tree_case("tree_draft_b64x4", gen, rng, "latent", dt, dt, tree,
                                  draft_level=1))
    # after every case above, so that those draw the inputs they drew
    # before: the _256 and _288 extends' TREE instantiations
    k256, k288 = kernel_name("extend", "aligned256"), kernel_name("extend", "latent288")
    for dt, kdt in ((bf, bf), (bf, e4m3), (f32, f32)):
        rows.append(run_tree_case("tree_verify_b64_n29_softcap50", gen, rng, "aligned256", dt,
                                  kdt, tree, cap=50.0, beside=gqa_function_props(
                                      k256, "extend", dt, kdt, tree=True)))
    for dt in (bf, f32):
        rows.append(run_tree_case("tree_verify_b64_n29_softcap50_window4096", gen, rng,
                                  "aligned256", dt, dt, tree, cap=50.0, window=4096,
                                  prefix_range=(4100, 6001),
                                  beside=gqa_function_props(k256, "extend", dt, dt, tree=True)))
    for dt in (bf, f32):
        rows.append(run_tree_case("tree_draft_b64x4", gen, rng, "aligned256", dt, dt, tree,
                                  draft_level=1,
                                  beside=gqa_function_props(k256, "extend", dt, dt, tree=True)))
    for dt, kdt in ((bf, bf), (bf, e4m3), (f32, f32)):
        rows.append(run_tree_case("tree_verify_b64_n29", gen, rng, "latent288", dt, kdt, tree,
                                  beside=latent_function_props(k288, "extend", dt, kdt,
                                                               tree=True)))
    for dt in (bf, f32):
        rows.append(run_tree_case("tree_draft_b64x4", gen, rng, "latent288", dt, dt, tree,
                                  draft_level=1,
                                  beside=latent_function_props(k288, "extend", dt, dt,
                                                               tree=True)))
    return rows


# -------------------------------------------- phase 2, the latent 288 builds
# each (kind, q dtype)'s kernel function in the latent builds, and the
# mangled template arguments of its latent row type (the extends' TREE the
# last), to read its registers and spills from nvcc's log
LATENT_FUNCTIONS = {("decode", "bfloat16"): "rpa_decode_mla_mma_kernel",
                    ("stream", "bfloat16"): "rpa_stream_mla_mma_kernel",
                    ("extend", "bfloat16"): "rpa_extend_mla_wgmma_kernel",
                    ("decode", "float32"): "rpa_decode_mla_kernel",
                    ("stream", "float32"): "rpa_stream_mla_kernel",
                    ("extend", "float32"): "rpa_extend_mla_kernel"}
MANGLED_ROWS = {"bfloat16": "I13__nv_bfloat16", "float8_e4m3fn": "I13__nv_fp8_e4m3",
                "float8_e5m2": "I13__nv_fp8_e5m2", "float32": "Iff"}


def latent_function_props(kname, kind, dtype, kv_dtype, tree=False):
    """Registers and spill bytes (nvcc -Xptxas -v) of the function the
    latent build ``kname`` runs for ``kind`` with q ``dtype`` over rows of
    ``kv_dtype`` (an extend's TREE = ``tree`` instantiation)."""
    from semi_pd_tpu_torch.kernels import KERNELS

    fn = LATENT_FUNCTIONS[kind, dtype_name(dtype)]
    want = fn + MANGLED_ROWS[dtype_name(kv_dtype)] + (
        ("Lb1EE" if tree else "Lb0EE") if kind == "extend" else "E")
    props = ptxas_summary(KERNELS[kname].build_log)
    return next((dict(function=f, **p) for f, p in props.items() if want in f), {})


def phase_kernels_288():
    """Phase 2 at MiniCPM3-4B's attention geometry (the _288 builds: latent
    rows of 288, V their first 256, 40 query heads in head groups of 16 /
    16 / 8), after every other case (so that those draw the inputs they
    drew before): decode b64 / kv1024 through the packed and the streaming
    decode, extend b8 x q256 / kv2048, each with bf16 rows, e4m3 and e5m2
    rows under bf16 q, and float32, on shuffled pages with every dead slot
    NaN; each row with its function's registers and spills."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rng = np.random.default_rng(16)
    bf, f32 = torch.bfloat16, torch.float32
    pairs = [(bf, bf), (bf, torch.float8_e4m3fn), (bf, torch.float8_e5m2), (f32, f32)]
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    rows, packed = [], {}
    for kind, name, ql, kl in (("decode", "decode_b64_kv1024", [1] * 64, lens.tolist()),
                               ("stream", "decode_b64_kv1024", [1] * 64, lens.tolist()),
                               ("extend", "extend_b8_q256_kv2048", [256] * 8, [2048] * 8)):
        for dt, kdt in pairs:
            beside = latent_function_props(kernel_name(kind, "latent288"), kind, dt, kdt)
            if kind == "stream":
                beside["packed_kernel_ms"] = packed[dt, kdt]
            rows.append(run_kernel_case(name, kind, gen, rng, ql, kl, dt, "latent288", kdt,
                                        beside=beside, nan_dead=True))
            if kind == "decode":
                packed[dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# ---------------------------------------- phase 2, the head_dim-256 builds
# each (kind, q dtype)'s kernel function in the GQA builds (its mangled
# name holds the KV type after it with bf16 q; the extend's TREE the last
# template argument)
GQA_FUNCTIONS = {("decode", "bfloat16"): "rpa_decode_mma_kernel",
                 ("stream", "bfloat16"): "rpa_stream_mma_kernel",
                 ("extend", "bfloat16"): "rpa_extend_wgmma_kernel",
                 ("decode", "float32"): "rpa_decode_kernel",
                 ("stream", "float32"): "rpa_stream_kernel",
                 ("extend", "float32"): "rpa_extend_kernel"}


def gqa_function_props(kname, kind, dtype, kv_dtype, tree=False, groups=False):
    """Registers and spill bytes (nvcc -Xptxas -v) of the function the GQA
    kernel ``kname`` runs for ``kind`` with q ``dtype`` over ``kv_dtype`` (an
    extend's TREE = ``tree`` instantiation; a decode's and an extend's
    ALIBI = true one where ``kname`` is an ALiBi instantiation, else its
    ALIBI = false one; a bf16 decode's or stream's GROUPS = ``groups`` one,
    which cuts G > 16 query heads a KV head into head groups)."""
    from semi_pd_tpu_torch.kernels import KERNELS

    k = KERNELS[kname]
    fn = GQA_FUNCTIONS[kind, dtype_name(dtype)]
    # with bf16 q the KV type is the template's first argument
    want = fn + ("I" if dtype_name(dtype) == "float32" else MANGLED_ROWS[dtype_name(kv_dtype)])
    # the last template arguments: the extend's TREE, then ALIBI (decode and
    # extend), then the bf16 decode's and stream's GROUPS
    alibi, g = int(k.library is not None), int(groups)
    bf16 = dtype_name(dtype) == "bfloat16"
    tag = {"extend": f"Lb{int(tree)}ELb{alibi}EE",
           "decode": f"Lb{alibi}E" + (f"Lb{g}EE" if bf16 else "E"),
           "stream": f"Lb{g}EE" if bf16 else ""}[kind]
    props = ptxas_summary(k.build_log)
    return next((dict(function=f, **p) for f, p in props.items() if want in f and tag in f),
                {})


def phase_kernels_256():
    """Phase 2 at Gemma-2-9B's attention geometry (the _256 builds: the 5D
    pool [1, 2, S, 8, 256], 16 query heads, scale 256 ** -0.5, which its
    query_pre_attn_scalar of 256 gives), after every
    other case (so that those draw the inputs they drew before), every dead
    slot NaN: decode b64 / kv1024 through the packed and the streaming
    decode, extend b8 x q256 / kv2048 and b2 x q2048 / kv2048, each with
    bf16, e4m3 and e5m2 KV under bf16 q and float32; then softcap 50 on all
    three, and Gemma-2's window of 4096 where it cuts, on the packed decode
    (b64, kv 4500-6000) and the extend (b2 x q2048 over kv 6000: the second
    prefill chunk of two long prompts), bf16 and float32. Each row carries
    its function's registers and spills, and SDPA's time (uncapped and
    unwindowed) as the library's."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = np.random.default_rng(17)
    bf, f32 = torch.bfloat16, torch.float32
    pairs = [(bf, bf), (bf, torch.float8_e4m3fn), (bf, torch.float8_e5m2), (f32, f32)]
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    long_lens = rng.integers(4500, 6001, size=64)
    long_lens[0] = 6000
    dec = ("decode_b64_kv1024", [1] * 64, lens.tolist())
    ext = ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8)
    ext2 = ("extend_b2_q2048_kv2048", [2048] * 2, [2048] * 2)
    cases = [("decode", *dec, pairs, None, None), ("stream", *dec, pairs, None, None),
             ("extend", *ext, pairs, None, None), ("extend", *ext2, pairs, None, None)]
    for dt in (bf, f32):
        cases += [("decode", *dec, [(dt, dt)], 50.0, None),
                  ("stream", *dec, [(dt, dt)], 50.0, None),
                  ("extend", *ext, [(dt, dt)], 50.0, None),
                  ("decode", "decode_b64_kv4500_6000", [1] * 64, long_lens.tolist(), [(dt, dt)],
                   None, 4096),
                  ("extend", "extend_b2_q2048_kv6000", [2048] * 2, [6000] * 2, [(dt, dt)],
                   None, 4096)]
    rows, packed = [], {}
    for kind, name, ql, kl, prs, cap, window in cases:
        for dt, kdt in prs:
            beside = gqa_function_props(kernel_name(kind, "aligned256"), kind, dt, kdt)
            case = name + (f"_softcap{cap:g}" if cap else "") + (
                f"_window{window}" if window else "")
            if kind == "stream":
                beside["packed_kernel_ms"] = packed[case, dt, kdt]
            rows.append(run_kernel_case(case, kind, gen, rng, ql, kl, dt, "aligned256", kdt,
                                        cap=cap, window=window, beside=beside, nan_dead=True,
                                        library_always=True))
            if kind == "decode":
                packed[case, dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# --------------------------------------------- phase 2, other head groups
def phase_kernels_heads():
    """Phase 2 at the head groups the GQA builds had not run before, after
    every other case (so that those draw the inputs they drew before),
    every dead slot NaN: one query head per KV head (G = 1: Hq = Hkv = 16)
    at head_dim 128 through the three aligned builds and at 256 through the
    three _256 builds, and eight (G = 8: Hq 32 / Hkv 4) at head_dim 128
    through the aligned builds; decode b64 / kv1024 through the packed and
    the streaming decode and extend b8 x q256 / kv2048, each with bf16 and
    e4m3 KV under bf16 q. Each row carries its function's registers and
    spills and SDPA's time."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    pairs = [(bf, bf), (bf, torch.float8_e4m3fn)]
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    rows, packed = [], {}
    for pool in ("aligned_g1", "aligned256_g1", "aligned_g8"):
        for kind, name, ql, kl in (("decode", "decode_b64_kv1024", [1] * 64, lens.tolist()),
                                   ("stream", "decode_b64_kv1024", [1] * 64, lens.tolist()),
                                   ("extend", "extend_b8_q256_kv2048", [256] * 8, [2048] * 8)):
            for dt, kdt in pairs:
                beside = gqa_function_props(kernel_name(kind, pool), kind, dt, kdt)
                HQ, HKV = GEOMETRY[pool][:2]
                beside["G"] = HQ // HKV
                if kind == "stream":
                    beside["packed_kernel_ms"] = packed[pool, dt, kdt]
                rows.append(run_kernel_case(name, kind, gen, rng, ql, kl, dt, pool, kdt,
                                            beside=beside, nan_dead=True))
                if kind == "decode":
                    packed[pool, dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# ------------------------------- phase 2, the Llama variants' attention
def phase_kernels_variants():
    """Phase 2 at the attention of the Llama-variant slice, after every
    other case (so that those draw the inputs they drew before), every dead
    slot NaN: the aligned builds at six (G = 6: Hq 48 / Hkv 8) and sixteen
    (G = 16: Hq 32 / Hkv 2) query heads per KV head, decode b64 / kv1024
    through the packed and the streaming decode and extend b8 x q256 /
    kv2048, bf16 and e4m3 KV under bf16 q; the merged builds at 36 KV heads
    (Hq = Hkv = 36, head_dim 64), decode and extend, bf16 and e4m3; then
    the ALiBi instantiations at Baichuan2-13B's 40 / 40 with its 40 slopes,
    decode b64 / kv1024 and extend b8 x q256 / kv2048 (a prompt's last
    chunk over its cached prefix) with bf16, e4m3 and float32 KV (float32
    q for float32), and extend b2 x q2048 / kv2048 (two fresh prompts in
    one chunked-prefill step) in bf16. Each row carries its function's
    registers and spills, G, and SDPA's time (with ALiBi, SDPA takes the
    bias as a float mask over the pre-gathered KV); an ALiBi row also times
    the same inputs without the slopes (``without_alibi_ms``: the aligned
    build's ALIBI = false kernels) and their ratio."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    rng = np.random.default_rng(22)
    bf, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    dec = ("decode_b64_kv1024", [1] * 64, lens.tolist())
    ext = ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8)
    ext2 = ("extend_b2_q2048_kv2048", [2048] * 2, [2048] * 2)
    plan = [(pool, kind, *case, [(bf, bf), (bf, e4m3)])
            for pool, kinds in (("aligned_g6", ("decode", "stream", "extend")),
                                ("aligned_g16", ("decode", "stream", "extend")),
                                ("merged_h36", ("decode", "extend")))
            for kind in kinds for case in ((dec,) if kind != "extend" else (ext,))]
    plan += [("aligned_alibi", "decode", *dec, [(bf, bf), (bf, e4m3), (f32, f32)]),
             ("aligned_alibi", "extend", *ext, [(bf, bf), (bf, e4m3), (f32, f32)]),
             ("aligned_alibi", "extend", *ext2, [(bf, bf)])]
    rows, packed = [], {}
    for pool, kind, name, ql, kl, pairs in plan:
        for dt, kdt in pairs:
            beside = gqa_function_props(kernel_name(kind, pool), kind, dt, kdt)
            HQ, HKV = GEOMETRY[pool][:2]
            beside["G"] = HQ // HKV
            if kind == "stream":
                beside["packed_kernel_ms"] = packed[pool, dt, kdt]
            rows.append(run_kernel_case(name, kind, gen, rng, ql, kl, dt, pool, kdt,
                                        beside=beside, nan_dead=True))
            if kind == "decode":
                packed[pool, dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# -------------------------- phase 2, the LayerNorm families' attention
def phase_kernels_layernorm():
    """Phase 2 at the attention of the LayerNorm families, after every other
    case (so that those draw the inputs they drew before), every dead slot
    NaN, decode b64 / kv 512-1024 and extend b8 x q256 / kv2048, bf16 and
    e4m3 KV under bf16 q: StarCoder's multi-query 48 / 1 through the
    aligned packed and streaming decode (three head groups of 16 a KV head,
    each reading the KV head's tiles) and extend; StarCoder2-7B's 36 / 4
    through the aligned decode and extend, also with its 4096 window where
    it cuts (decode over kv 4500-6000, extend b2 x q2048 over 6000);
    Falcon-7B's 71 / 1 (five head groups over
    one 64-element slot row) and GPT-2-large's 20 / 20 through the merged
    decode and extend; StableLM-2-1.6B's 32 / 32 through the chunked
    decode, stream and extend. Each row carries its function's registers
    and spills, G, its head groups and SDPA's time."""
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.ops.attention import rpa_packed

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    rng = np.random.default_rng(23)
    bf, e4m3 = torch.bfloat16, torch.float8_e4m3fn
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    dec = ("decode_b64_kv1024", [1] * 64, lens.tolist())
    ext = ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8)
    plan = [(pool, kind, dec if kind != "extend" else ext, None) for pool, kinds in (
        ("aligned_g48", ("decode", "stream", "extend")), ("aligned_g9", ("decode", "extend")),
        ("merged_g71", ("decode", "extend")), ("merged_h20", ("decode", "extend")),
        ("chunked_h32", ("decode", "stream", "extend"))) for kind in kinds]
    # StarCoder2-7B's 4096 window where it cuts: the decode over kv
    # 4500-6000, the extend of two 2048-token chunks over 6000
    long_lens = rng.integers(4500, 6001, size=64)
    long_lens[0] = 6000
    plan += [("aligned_g9", "decode", ("decode_b64_kv4500_6000", [1] * 64, long_lens.tolist()),
              4096),
             ("aligned_g9", "extend", ("extend_b2_q2048_kv6000", [2048] * 2, [6000] * 2), 4096)]
    rows, packed = [], {}
    for pool, kind, (name, ql, kl), window in plan:
        if window:
            name += f"_window{window}"
        for dt, kdt in ((bf, bf), (bf, e4m3)):
            kname = kernel_name(kind, pool)
            HQ, HKV = GEOMETRY[pool][:2]
            beside = gqa_function_props(kname, kind, dt, kdt, groups=HQ // HKV > 16)
            beside["G"] = HQ // HKV
            beside["head_groups"] = rpa_packed.head_groups(KERNELS[kname], HQ, HKV)
            if kind == "stream":
                beside["packed_kernel_ms"] = packed[pool, dt, kdt]
            rows.append(run_kernel_case(name, kind, gen, rng, ql, kl, dt, pool, kdt,
                                        window=window, beside=beside, nan_dead=True,
                                        library_always=True))
            if kind == "decode":
                packed[pool, dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# ------------------- phase 2, the image path's and the classifiers' heads
def phase_kernels_vlm():
    """Phase 2 at the head groups of the image path and the classifiers,
    after every other case (so that those draw the inputs they drew
    before), every dead slot NaN, bf16 and e4m3 KV under bf16 q: Qwen2-VL-7B's
    28 / 4 (G = 7) through the aligned packed and streaming decode (b64 /
    kv 512-1024) and extend (b8 x q256 / kv2048); Skywork-Reward-Gemma-2-27B's
    32 / 16 at head_dim 128 with softcap 50 through the aligned decode and
    extend, then with its 4096 window where it cuts (decode over kv
    4500-6000, extend b2 x q2048 over 6000). Each row carries its
    function's registers and spills, G, and SDPA's time (uncapped and
    unwindowed where the case caps or windows)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    rng = np.random.default_rng(24)
    bf, e4m3 = torch.bfloat16, torch.float8_e4m3fn
    lens = rng.integers(512, 1025, size=64)
    lens[0], lens[-1] = 1024, 0  # one padded row
    dec = ("decode_b64_kv1024", [1] * 64, lens.tolist())
    ext = ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8)
    long_lens = rng.integers(4500, 6001, size=64)
    long_lens[0] = 6000
    plan = [("aligned_g7", kind, dec if kind != "extend" else ext, None, None)
            for kind in ("decode", "stream", "extend")]
    plan += [("aligned_g2", "decode", dec, 50.0, None), ("aligned_g2", "extend", ext, 50.0, None),
             ("aligned_g2", "decode", ("decode_b64_kv4500_6000", [1] * 64, long_lens.tolist()),
              50.0, 4096),
             ("aligned_g2", "extend", ("extend_b2_q2048_kv6000", [2048] * 2, [6000] * 2),
              50.0, 4096)]
    rows, packed = [], {}
    for pool, kind, (name, ql, kl), cap, window in plan:
        name += (f"_cap{cap:g}" if cap else "") + (f"_window{window}" if window else "")
        for dt, kdt in ((bf, bf), (bf, e4m3)):
            beside = gqa_function_props(kernel_name(kind, pool), kind, dt, kdt)
            HQ, HKV = GEOMETRY[pool][:2]
            beside["G"] = HQ // HKV
            if kind == "stream":
                beside["packed_kernel_ms"] = packed[pool, dt, kdt]
            rows.append(run_kernel_case(name, kind, gen, rng, ql, kl, dt, pool, kdt, cap=cap,
                                        window=window, beside=beside, nan_dead=True,
                                        library_always=True))
            if kind == "decode" and not window:
                packed[pool, dt, kdt] = rows[-1]["kernel_ms"]
    return rows


# --------------------------------------------------------------- phase 3/4
def llama_1b_config():
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_hidden_layers=16, num_attention_heads=32,
        num_key_value_heads=8, head_dim=64, max_position_embeddings=8192,
        context_length=8192, rope_theta=500000.0, dtype="bfloat16",
    )


def llama3_8b_config():
    """Meta-Llama-3-8B's published config.json geometry (8.03 B parameters)."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=8192, context_length=8192, dtype="bfloat16",
    )


def tinyllama_config():
    """TinyLlama-1.1B's published config.json (TinyLlama/TinyLlama-1.1B-Chat-v1.0:
    LlamaForCausalLM, 22 layers, hidden 2048, 32 query and 4 KV heads of 64,
    intermediate 5632, vocab 32000, rope theta 10000, rms eps 1e-5, untied
    embeddings, context 2048). Its 2 * 4 * 64 = 512-wide slot row is no
    multiple of 8 chunks of 128, so it is served from the 5D pool through
    the merged kernels."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    return ModelConfig(
        architecture="LlamaForCausalLM", vocab_size=32000, hidden_size=2048,
        intermediate_size=5632, num_hidden_layers=22, num_attention_heads=32,
        num_key_value_heads=4, head_dim=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=2048, context_length=2048, tie_word_embeddings=False,
        dtype="bfloat16",
    )


def deepseek_v2_lite_config(**kw):
    """DeepSeek-V2-Lite's published config.json (15.7 B parameters; MLA with
    kv_lora 512 + rope 64, one dense layer then 26 MoE layers of 64 routed
    experts, top-6 softmax greedy, and 2 shared experts; yarn x40); ``kw``
    overrides fields (the float32 gates' depth)."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    cfg = ModelConfig(
        architecture="DeepseekV2ForCausalLM", vocab_size=102400, hidden_size=2048,
        intermediate_size=10944, num_hidden_layers=27, num_attention_heads=16,
        num_key_value_heads=16, head_dim=192, rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                      "mscale_all_dim": 0.707},
        max_position_embeddings=163840, context_length=163840, use_mla=True,
        q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, num_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
        num_shared_experts=2, first_k_dense_replace=1, moe_layer_freq=1,
        topk_method="greedy", norm_topk_prob=False, routed_scaling_factor=1.0,
        scoring_func="softmax", tie_word_embeddings=False, dtype="bfloat16",
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


# Stand-ins for MiniCPM3-4B's two 16-entry longrope factor lists: the
# published lists are in openbmb/MiniCPM3-4B's config.json, which this
# repository does not hold. With max_position_embeddings equal to
# original_max_position_embeddings (32768) only the short list is used and
# the mscale is 1; no shape and no kernel depends on the values.
MINICPM3_STANDIN_SHORT = [round(1.0 + 0.05 * i, 2) for i in range(16)]
MINICPM3_STANDIN_LONG = [round(1.0 + 0.5 * i, 2) for i in range(16)]


def minicpm3_4b_config(**kw):
    """MiniCPM3-4B's published config.json widths (openbmb/MiniCPM3-4B:
    MiniCPM3ForCausalLM, vocab 73448, hidden 2560, intermediate 6400, 62
    layers, 40 attention and 40 KV heads, q_lora 768, kv_lora 256, qk_nope
    64, qk_rope 32, v_head 64, max_position 32768, rope theta 10000, rms eps
    1e-5, scale_emb 12, scale_depth 1.4, dim_model_base 256, untied
    embeddings, SiLU; about 4.26 B parameters). Its latent row is 256 + 32
    = 288 wide, V its first 256: the latent kernels' _288 builds. The rope
    is longrope with original_max_position_embeddings 32768 and two
    16-entry factor lists, which here are STAND-INS
    (MINICPM3_STANDIN_SHORT / _LONG), not the published values. ``kw``
    overrides fields (the float32 gate's)."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    cfg = dict(
        architecture="MiniCPM3ForCausalLM", vocab_size=73448, hidden_size=2560,
        intermediate_size=6400, num_hidden_layers=62, num_attention_heads=40,
        num_key_value_heads=40, head_dim=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        rope_scaling={"type": "longrope", "original_max_position_embeddings": 32768,
                      "short_factor": list(MINICPM3_STANDIN_SHORT),
                      "long_factor": list(MINICPM3_STANDIN_LONG)},
        max_position_embeddings=32768, context_length=32768, use_mla=True,
        q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64, scale_emb=12.0, scale_depth=1.4, dim_model_base=256.0,
        tie_word_embeddings=False, dtype="bfloat16")
    cfg.update(kw)
    return ModelConfig(**cfg)


def gemma2_9b_config(**kw):
    """Gemma-2-9B's published config.json widths (google/gemma-2-9b:
    Gemma2ForCausalLM, 42 layers, hidden 3584, intermediate 14336, 16 query
    and 8 KV heads of 256, query_pre_attn_scalar 256, vocab 256000, tied
    embeddings, sliding_window 4096 on the even layers, attn_logit_softcapping
    50, final_logit_softcapping 30, max_position 8192, rope theta 10000, rms
    eps 1e-6, gelu_pytorch_tanh; 9.24 B parameters, 18.5 GB in bf16). Its KV
    is 42 x 2 x 8 x 256 x 2 B = 344 KB a token: the 131072-token pool is
    45.1 GB in bf16. ``kw`` overrides fields (the float32 gate's depth)."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    cfg = dict(
        architecture="Gemma2ForCausalLM", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_hidden_layers=42, num_attention_heads=16,
        num_key_value_heads=8, head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0,
        max_position_embeddings=8192, context_length=8192, hidden_act="gelu_pytorch_tanh",
        tie_word_embeddings=True, sliding_window=4096, query_pre_attn_scalar=256,
        attn_logit_softcap=50.0, logit_softcap=30.0, dtype="bfloat16")
    cfg.update(kw)
    return ModelConfig(**cfg)


# The published config.json of each model this script serves or runs
# through phase 3 from the JAX package's Llama-family strings, Gemma-1,
# the GQA MoE families and the Llama-computation variants: every key that
# describes the model (those ModelConfig.from_hf_config reads among them;
# training-only keys such as dropout, initializer range and the router's
# loss coefficient, and the remote-code auto_map, left out). The Hugging
# Face repository of each is its key.
PUBLISHED = {
    "Qwen/Qwen3-8B": dict(
        architectures=["Qwen3ForCausalLM"], attention_bias=False, bos_token_id=151643,
        eos_token_id=151645, head_dim=128, hidden_act="silu", hidden_size=4096,
        intermediate_size=12288, max_position_embeddings=40960, max_window_layers=36,
        model_type="qwen3", num_attention_heads=32, num_hidden_layers=36,
        num_key_value_heads=8, rms_norm_eps=1e-6, rope_scaling=None, rope_theta=1000000,
        sliding_window=None, tie_word_embeddings=False, torch_dtype="bfloat16",
        use_sliding_window=False, vocab_size=151936),
    "Qwen/Qwen1.5-MoE-A2.7B": dict(
        architectures=["Qwen2MoeForCausalLM"], bos_token_id=151643, decoder_sparse_step=1,
        eos_token_id=151643, hidden_act="silu", hidden_size=2048, intermediate_size=5632,
        max_position_embeddings=8192, max_window_layers=21, model_type="qwen2_moe",
        moe_intermediate_size=1408, norm_topk_prob=False, num_attention_heads=16,
        num_experts=60, num_experts_per_tok=4, num_hidden_layers=24, num_key_value_heads=16,
        rms_norm_eps=1e-6, rope_theta=1000000.0, shared_expert_intermediate_size=5632,
        sliding_window=32768, tie_word_embeddings=False, torch_dtype="bfloat16",
        use_sliding_window=False, vocab_size=151936),
    "google/gemma-7b": dict(
        architectures=["GemmaForCausalLM"], attention_bias=False, bos_token_id=2,
        eos_token_id=1, head_dim=256, hidden_act="gelu", hidden_size=3072,
        intermediate_size=24576, max_position_embeddings=8192, model_type="gemma",
        num_attention_heads=16, num_hidden_layers=28, num_key_value_heads=16, pad_token_id=0,
        rms_norm_eps=1e-6, rope_scaling=None, rope_theta=10000.0, torch_dtype="bfloat16",
        vocab_size=256000),
    "allenai/OLMoE-1B-7B-0924": dict(
        architectures=["OlmoeForCausalLM"], attention_bias=False, clip_qkv=None,
        eos_token_id=50279, hidden_act="silu", hidden_size=2048, intermediate_size=1024,
        max_position_embeddings=4096, model_type="olmoe", norm_topk_prob=False,
        num_attention_heads=16, num_experts=64, num_experts_per_tok=8, num_hidden_layers=16,
        num_key_value_heads=16, pad_token_id=1, rms_norm_eps=1e-5, rope_scaling=None,
        rope_theta=10000.0, tie_word_embeddings=False, torch_dtype="float32",
        vocab_size=50304),
    "mistralai/Mistral-7B-v0.1": dict(
        architectures=["MistralForCausalLM"], bos_token_id=1, eos_token_id=2,
        hidden_act="silu", hidden_size=4096, intermediate_size=14336,
        max_position_embeddings=32768, model_type="mistral", num_attention_heads=32,
        num_hidden_layers=32, num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=4096, tie_word_embeddings=False, torch_dtype="bfloat16",
        vocab_size=32000),
    "mistralai/Mixtral-8x7B-v0.1": dict(
        architectures=["MixtralForCausalLM"], bos_token_id=1, eos_token_id=2,
        hidden_act="silu", hidden_size=4096, intermediate_size=14336,
        max_position_embeddings=32768, model_type="mixtral", num_attention_heads=32,
        num_experts_per_tok=2, num_hidden_layers=32, num_key_value_heads=8,
        num_local_experts=8, rms_norm_eps=1e-5, rope_theta=1000000.0, sliding_window=None,
        tie_word_embeddings=False, torch_dtype="bfloat16", vocab_size=32000),
    "Qwen/Qwen3-30B-A3B": dict(
        architectures=["Qwen3MoeForCausalLM"], attention_bias=False, bos_token_id=151643,
        decoder_sparse_step=1, eos_token_id=151645, head_dim=128, hidden_act="silu",
        hidden_size=2048, intermediate_size=6144, max_position_embeddings=40960,
        max_window_layers=48, mlp_only_layers=[], model_type="qwen3_moe",
        moe_intermediate_size=768, norm_topk_prob=True, num_attention_heads=32,
        num_experts=128, num_experts_per_tok=8, num_hidden_layers=48, num_key_value_heads=4,
        rms_norm_eps=1e-6, rope_scaling=None, rope_theta=1000000.0, sliding_window=None,
        tie_word_embeddings=False, torch_dtype="bfloat16", use_sliding_window=False,
        vocab_size=151936),
    # the Llama-computation variants (ROADMAP A14: the JAX package's
    # llama_variants.py, glm.py, phi3.py, granite.py, grok.py)
    "THUDM/chatglm3-6b": dict(
        architectures=["ChatGLMModel"], add_bias_linear=False, add_qkv_bias=True,
        apply_query_key_layer_scaling=True, apply_residual_connection_post_layernorm=False,
        attention_softmax_in_fp32=True, eos_token_id=2, ffn_hidden_size=13696,
        fp32_residual_connection=False, hidden_size=4096, kv_channels=128,
        layernorm_epsilon=1e-5, model_type="chatglm", multi_query_attention=True,
        multi_query_group_num=2, num_attention_heads=32, num_layers=28, original_rope=True,
        pad_token_id=0, padded_vocab_size=65024, post_layer_norm=True, rmsnorm=True,
        seq_length=8192, tie_word_embeddings=False, torch_dtype="float16"),
    "THUDM/glm-4-9b-chat": dict(
        architectures=["ChatGLMModel"], add_bias_linear=False, add_qkv_bias=True,
        apply_query_key_layer_scaling=True, apply_residual_connection_post_layernorm=False,
        attention_softmax_in_fp32=True, eos_token_id=[151329, 151336, 151338],
        ffn_hidden_size=13696, fp32_residual_connection=False, hidden_size=4096,
        kv_channels=128, layernorm_epsilon=1.5625e-07, model_type="chatglm",
        multi_query_attention=True, multi_query_group_num=2, num_attention_heads=32,
        num_hidden_layers=40, num_layers=40, original_rope=True, pad_token_id=151329,
        padded_vocab_size=151552, post_layer_norm=True, rmsnorm=True, rope_ratio=500,
        seq_length=131072, tie_word_embeddings=False, torch_dtype="bfloat16"),
    "baichuan-inc/Baichuan2-13B-Chat": dict(
        architectures=["BaichuanForCausalLM"], bos_token_id=1, eos_token_id=2,
        hidden_act="silu", hidden_size=5120, intermediate_size=13696, model_max_length=4096,
        model_type="baichuan", num_attention_heads=40, num_hidden_layers=40, pad_token_id=0,
        rms_norm_eps=1e-6, tie_word_embeddings=False, torch_dtype="bfloat16",
        vocab_size=125696),
    "baichuan-inc/Baichuan2-7B-Base": dict(
        architectures=["BaichuanForCausalLM"], bos_token_id=1, eos_token_id=2,
        hidden_act="silu", hidden_size=4096, intermediate_size=11008,
        max_position_embeddings=4096, model_max_length=4096, model_type="baichuan",
        num_attention_heads=32, num_hidden_layers=32, pad_token_id=0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, torch_dtype="bfloat16", vocab_size=125696),
    "openbmb/MiniCPM-2B-sft-bf16": dict(
        architectures=["MiniCPMForCausalLM"], bos_token_id=1, dim_model_base=256,
        eos_token_id=2, hidden_act="silu", hidden_size=2304, intermediate_size=5760,
        max_position_embeddings=2048, model_type="minicpm", num_attention_heads=36,
        num_hidden_layers=40, num_key_value_heads=36, rms_norm_eps=1e-5, rope_scaling=None,
        scale_depth=1.4, scale_emb=12, tie_word_embeddings=True, torch_dtype="bfloat16",
        vocab_size=122753),
    "deepseek-ai/deepseek-moe-16b-base": dict(
        architectures=["DeepseekForCausalLM"], attention_bias=False, bos_token_id=100000,
        eos_token_id=100001, first_k_dense_replace=1, hidden_act="silu", hidden_size=2048,
        intermediate_size=10944, max_position_embeddings=4096, model_type="deepseek",
        moe_intermediate_size=1408, moe_layer_freq=1, n_routed_experts=64, n_shared_experts=2,
        norm_topk_prob=False, num_attention_heads=16, num_experts_per_tok=6,
        num_hidden_layers=28, num_key_value_heads=16, rms_norm_eps=1e-6, rope_scaling=None,
        rope_theta=10000, scoring_func="softmax", tie_word_embeddings=False,
        torch_dtype="bfloat16", vocab_size=102400),
    "internlm/internlm2-20b": dict(
        architectures=["InternLM2ForCausalLM"], bias=False, bos_token_id=1, eos_token_id=2,
        hidden_act="silu", hidden_size=6144, intermediate_size=16384,
        max_position_embeddings=32768, model_type="internlm2", num_attention_heads=48,
        num_hidden_layers=48, num_key_value_heads=8, pad_token_id=2, rms_norm_eps=1e-5,
        rope_scaling={"type": "dynamic", "factor": 2.0}, rope_theta=1000000,
        tie_word_embeddings=False, torch_dtype="bfloat16", vocab_size=92544),
    "internlm/internlm2-7b-reward": dict(
        architectures=["InternLM2ForRewardModel"], bias=False, bos_token_id=1,
        eos_token_id=2, hidden_act="silu", hidden_size=4096, intermediate_size=14336,
        max_position_embeddings=32768, model_type="internlm2", num_attention_heads=32,
        num_hidden_layers=32, num_key_value_heads=8, pad_token_id=2, rms_norm_eps=1e-5,
        rope_scaling={"type": "dynamic", "factor": 2.0}, rope_theta=1000000,
        tie_word_embeddings=False, torch_dtype="bfloat16", vocab_size=92544),
    "LGAI-EXAONE/EXAONE-3.0-7.8B-Instruct": dict(
        activation_function="silu", architectures=["ExaoneForCausalLM"], bos_token_id=1,
        eos_token_id=361, head_dim=128, hidden_size=4096, intermediate_size=14336,
        layer_norm_epsilon=1e-5, max_position_embeddings=4096, model_type="exaone",
        num_attention_heads=32, num_key_value_heads=8, num_layers=32, pad_token_id=0,
        rope_scaling=None, rope_theta=500000.0, tie_word_embeddings=False,
        torch_dtype="float32", vocab_size=102400),
    "Qwen/Qwen-7B": dict(
        architectures=["QWenLMHeadModel"], bf16=False, fp16=False, fp32=False,
        hidden_size=4096, intermediate_size=22016, kv_channels=128, layer_norm_epsilon=1e-6,
        max_position_embeddings=32768, model_type="qwen", no_bias=True,
        num_attention_heads=32, num_hidden_layers=32, rotary_emb_base=10000, rotary_pct=1.0,
        scale_attn_weights=True, seq_length=8192, tie_word_embeddings=False,
        use_dynamic_ntk=True, use_logn_attn=True, vocab_size=151936),
    "microsoft/Phi-3-medium-4k-instruct": dict(
        architectures=["Phi3ForCausalLM"], attention_bias=False, bos_token_id=1,
        eos_token_id=32000, hidden_act="silu", hidden_size=5120, intermediate_size=17920,
        max_position_embeddings=4096, model_type="phi3", num_attention_heads=40,
        num_hidden_layers=40, num_key_value_heads=10, original_max_position_embeddings=4096,
        pad_token_id=32000, rms_norm_eps=1e-5, rope_scaling=None, rope_theta=10000.0,
        sliding_window=2047, tie_word_embeddings=False, torch_dtype="bfloat16",
        vocab_size=32064),
    "ibm-granite/granite-3.0-8b-instruct": dict(
        architectures=["GraniteForCausalLM"], attention_bias=False,
        attention_multiplier=0.0078125, bos_token_id=0, embedding_multiplier=12.0,
        eos_token_id=0, hidden_act="silu", hidden_size=4096, intermediate_size=12800,
        logits_scaling=16.0, max_position_embeddings=4096, mlp_bias=False,
        model_type="granite", num_attention_heads=32, num_hidden_layers=40,
        num_key_value_heads=8, pad_token_id=0, residual_multiplier=0.22, rms_norm_eps=1e-5,
        rope_scaling=None, rope_theta=10000.0, tie_word_embeddings=True,
        torch_dtype="bfloat16", vocab_size=49155),
    "xai-org/grok-1": dict(
        architectures=["Grok1ForCausalLM"], attn_output_multiplier=0.08838834764831845,
        bos_token_id=1, embedding_multiplier_scale=78.38367176906169, eos_token_id=2,
        hidden_size=6144, intermediate_size=32768, max_attn_value=30.0,
        max_position_embeddings=8192, model_type="grok-1", num_attention_heads=48,
        num_experts_per_tok=2, num_hidden_layers=64, num_key_value_heads=8,
        num_local_experts=8, output_multiplier_scale=0.5773502691896257, pad_token_id=0,
        rms_norm_eps=1e-5, torch_dtype="bfloat16", vocab_size=131072),
}

# The LayerNorm families (ROADMAP A14: the JAX package's
# layernorm_families.py, gpt2.py, olmo_falcon_dbrx.py), typed in as above.
# The JAX package reads these through transformers' config classes, whose
# aliases (GPT-2's n_embd, DBRX's d_model) and defaults a dict lacks:
# ModelConfig.from_hf_config keeps its own table of both
# (HF_ALIASES, HF_DEFAULTS). Phi-3-small's config (remote code, no
# transformers class) names its MLP width ff_intermediate_size, which
# neither package reads (ROADMAP C); its dummy_token_indices is a property
# of the remote class, not a key, so neither package masks them here.
PUBLISHED_LN = {
    "bigcode/starcoder": dict(
        activation_function="gelu", architectures=["GPTBigCodeForCausalLM"],
        attention_softmax_in_fp32=True, bos_token_id=0, eos_token_id=0,
        layer_norm_epsilon=1e-5, model_type="gpt_bigcode", multi_query=True, n_embd=6144,
        n_head=48, n_inner=24576, n_layer=40, n_positions=8192,
        scale_attention_softmax_in_fp32=True, scale_attn_weights=True,
        torch_dtype="float32", vocab_size=49152),
    "tiiuae/falcon-7b": dict(
        alibi=False, apply_residual_connection_post_layernorm=False,
        architectures=["FalconForCausalLM"], bias=False, bos_token_id=11, eos_token_id=11,
        hidden_size=4544, layer_norm_epsilon=1e-5, model_type="falcon", multi_query=True,
        new_decoder_architecture=False, num_attention_heads=71, num_hidden_layers=32,
        parallel_attn=True, torch_dtype="bfloat16", vocab_size=65024),
    "stabilityai/stablelm-2-1_6b": dict(
        architectures=["StableLmForCausalLM"], bos_token_id=100257, eos_token_id=100257,
        hidden_act="silu", hidden_size=2048, intermediate_size=5632, layer_norm_eps=1e-5,
        max_position_embeddings=4096, model_type="stablelm", num_attention_heads=32,
        num_hidden_layers=24, num_key_value_heads=32, partial_rotary_factor=0.25,
        qk_layernorm=False, rope_scaling=None, rope_theta=10000, tie_word_embeddings=False,
        torch_dtype="bfloat16", use_parallel_residual=False, use_qkv_bias=True,
        vocab_size=100352),
    "openai-community/gpt2-large": dict(
        activation_function="gelu_new", architectures=["GPT2LMHeadModel"],
        bos_token_id=50256, eos_token_id=50256, layer_norm_epsilon=1e-5, model_type="gpt2",
        n_ctx=1024, n_embd=1280, n_head=20, n_layer=36, n_positions=1024,
        vocab_size=50257),
    "bigcode/starcoder2-7b": dict(
        architectures=["Starcoder2ForCausalLM"], bos_token_id=0, eos_token_id=0,
        hidden_act="gelu_pytorch_tanh", hidden_size=4608, intermediate_size=18432,
        max_position_embeddings=16384, mlp_type="default", model_type="starcoder2",
        norm_epsilon=1e-5, norm_type="layer_norm", num_attention_heads=36,
        num_hidden_layers=32, num_key_value_heads=4, rope_theta=1000000,
        sliding_window=4096, torch_dtype="bfloat16", use_bias=True, vocab_size=49152),
    "microsoft/phi-1_5": dict(
        architectures=["PhiForCausalLM"], hidden_act="gelu_new", hidden_size=2048,
        intermediate_size=8192, layer_norm_eps=1e-5, max_position_embeddings=2048,
        model_type="phi", num_attention_heads=32, num_hidden_layers=24,
        num_key_value_heads=None, partial_rotary_factor=0.5, qk_layernorm=False,
        rope_scaling=None, rope_theta=10000.0, tie_word_embeddings=False,
        torch_dtype="float16", vocab_size=51200),
    "CohereForAI/aya-23-8B": dict(
        architectures=["CohereForCausalLM"], attention_bias=False, bos_token_id=5,
        eos_token_id=255001, hidden_act="silu", hidden_size=4096, intermediate_size=14336,
        layer_norm_eps=1e-5, logit_scale=0.0625, max_position_embeddings=8192,
        model_type="cohere", num_attention_heads=32, num_hidden_layers=32,
        num_key_value_heads=8, pad_token_id=0, rope_theta=10000, torch_dtype="float16",
        use_qk_norm=False, vocab_size=256000),
    "allenai/OLMo-2-1124-7B": dict(
        architectures=["Olmo2ForCausalLM"], attention_bias=False, eos_token_id=100257,
        hidden_act="silu", hidden_size=4096, intermediate_size=11008,
        max_position_embeddings=4096, model_type="olmo2", num_attention_heads=32,
        num_hidden_layers=32, num_key_value_heads=32, pad_token_id=100277,
        rms_norm_eps=1e-6, rope_scaling=None, rope_theta=500000,
        tie_word_embeddings=False, torch_dtype="float32", vocab_size=100352),
    "allenai/OLMo-1B-hf": dict(
        architectures=["OlmoForCausalLM"], attention_bias=False, clip_qkv=None,
        eos_token_id=50279, hidden_act="silu", hidden_size=2048, intermediate_size=8192,
        max_position_embeddings=2048, model_type="olmo", num_attention_heads=16,
        num_hidden_layers=16, num_key_value_heads=16, pad_token_id=1, rope_scaling=None,
        rope_theta=10000.0, tie_word_embeddings=True, torch_dtype="float32",
        vocab_size=50304),
    "microsoft/Phi-3-small-8k-instruct": dict(
        architectures=["Phi3SmallForCausalLM"], blocksparse_block_size=64,
        blocksparse_homo_head_pattern=False, blocksparse_num_local_blocks=16,
        blocksparse_triton_kernel_block_size=64, blocksparse_vert_stride=8,
        bos_token_id=100257, dense_attention_every_n_layers=2, eos_token_id=100257,
        ff_dim_multiplier=None, ff_intermediate_size=14336, gegelu_limit=20.0,
        gegelu_pad_to_256=True, hidden_act="gegelu", hidden_size=4096,
        layer_norm_epsilon=1e-5, max_position_embeddings=8192, model_type="phi3small",
        mup_attn_multiplier=1.0, mup_embedding_multiplier=10.0, mup_use_scaling=True,
        mup_width_multiplier=8.0, num_attention_heads=32, num_hidden_layers=32,
        num_key_value_heads=8, pad_sequence_to_multiple_of_64=True,
        rope_embedding_base=1000000, rope_position_scale=1.0, rope_scaling=None,
        torch_dtype="bfloat16", vocab_size=100352),
    "databricks/dbrx-base": dict(
        architectures=["DbrxForCausalLM"],
        attn_config=dict(clip_qkv=8, kv_n_heads=8, rope_theta=500000),
        d_model=6144,
        ffn_config=dict(ffn_hidden_size=10752, moe_jitter_eps=0, moe_num_experts=16,
                        moe_top_k=4),
        max_seq_len=32768, model_type="dbrx", n_heads=48, n_layers=40,
        tie_word_embeddings=False, torch_dtype="bfloat16", vocab_size=100352),
}


# The image path's models and the sequence classifiers (ROADMAP A14: the JAX
# package's llava.py, qwen2_vl.py, classify.py), typed in as above. A
# config.json of a LLaVA-style repository leaves the defaults of its
# text_config's and vision_config's classes out (llava-1.5-7b-hf's
# text_config gives only its vocabulary, length and eps): they are written
# out here (LlamaConfig's 4096 / 11008 / 32 layers / 32 heads; CLIP's eps
# 1e-5), as transformers' classes fill them in. Yi-VL-6B's config.json is
# flat (LlavaLlamaForCausalLM with mm_* keys and a path to its ViT-H/14 at
# 448 pixels); the JAX YiVLForCausalLM reads a text_config and a
# vision_config, so its literal is that structure with the published
# numbers (the language model's from its config.json, the tower's from
# the ViT's), and its image token is the vocabulary's last id (the
# repository marks images with -200, which no embedding row has).
_LLAMA2_TEXT = dict(architectures=["LlamaForCausalLM"], hidden_act="silu", hidden_size=4096,
                    intermediate_size=11008, num_attention_heads=32, num_hidden_layers=32,
                    num_key_value_heads=32, rope_theta=10000.0, tie_word_embeddings=False)
PUBLISHED_VLM = {
    "llava-hf/llava-1.5-7b-hf": dict(
        architectures=["LlavaForConditionalGeneration"], ignore_index=-100,
        image_token_index=32000, model_type="llava", pad_token_id=32001,
        projector_hidden_act="gelu",
        text_config=dict(_LLAMA2_TEXT, max_position_embeddings=4096, model_type="llama",
                         rms_norm_eps=1e-5, torch_dtype="float16", vocab_size=32064),
        tie_word_embeddings=False, torch_dtype="float16",
        vision_config=dict(hidden_size=1024, image_size=336, intermediate_size=4096,
                           layer_norm_eps=1e-5, model_type="clip_vision_model",
                           num_attention_heads=16, num_hidden_layers=24, patch_size=14,
                           projection_dim=768, vocab_size=32000),
        vision_feature_layer=-2, vision_feature_select_strategy="default", vocab_size=32064),
    "01-ai/Yi-VL-6B": dict(
        architectures=["YiVLForCausalLM"], image_token_index=63999, model_type="llava",
        text_config=dict(_LLAMA2_TEXT, num_key_value_heads=4, max_position_embeddings=4096,
                         rms_norm_eps=1e-5, rope_theta=5000000.0, vocab_size=64000),
        vision_config=dict(hidden_size=1280, image_size=448, intermediate_size=5120,
                           layer_norm_eps=1e-5, num_attention_heads=16, num_hidden_layers=32,
                           patch_size=14),
        vision_feature_layer=-2),
    "Qwen/Qwen2-VL-7B-Instruct": dict(
        architectures=["Qwen2VLForConditionalGeneration"], attention_dropout=0.0,
        bos_token_id=151643, eos_token_id=151645, vision_start_token_id=151652,
        vision_end_token_id=151653, vision_token_id=151654, image_token_id=151655,
        video_token_id=151656, hidden_act="silu", hidden_size=3584, intermediate_size=18944,
        max_position_embeddings=32768, max_window_layers=28, model_type="qwen2_vl",
        num_attention_heads=28, num_hidden_layers=28, num_key_value_heads=4,
        rms_norm_eps=1e-6, rope_theta=1000000.0, sliding_window=32768,
        tie_word_embeddings=False, torch_dtype="bfloat16", use_sliding_window=False,
        vision_config=dict(depth=32, embed_dim=1280, mlp_ratio=4, num_heads=16, in_chans=3,
                           hidden_size=3584, patch_size=14, spatial_merge_size=2,
                           spatial_patch_size=14, temporal_patch_size=2),
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]}, vocab_size=152064),
    "Qwen/Qwen2.5-VL-7B-Instruct": dict(
        architectures=["Qwen2_5_VLForConditionalGeneration"], attention_dropout=0.0,
        bos_token_id=151643, eos_token_id=151645, vision_start_token_id=151652,
        vision_end_token_id=151653, vision_token_id=151654, image_token_id=151655,
        video_token_id=151656, hidden_act="silu", hidden_size=3584, intermediate_size=18944,
        max_position_embeddings=128000, max_window_layers=28, model_type="qwen2_5_vl",
        num_attention_heads=28, num_hidden_layers=28, num_key_value_heads=4,
        rms_norm_eps=1e-6, rope_theta=1000000.0, sliding_window=32768,
        tie_word_embeddings=False, torch_dtype="bfloat16", use_sliding_window=False,
        vision_config=dict(depth=32, hidden_act="silu", hidden_size=1280,
                           intermediate_size=3420, num_heads=16, in_chans=3,
                           out_hidden_size=3584, patch_size=14, spatial_merge_size=2,
                           spatial_patch_size=14, window_size=112,
                           fullatt_block_indexes=[7, 15, 23, 31], tokens_per_second=2,
                           temporal_patch_size=2),
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]}, vocab_size=152064),
    "Skywork/Skywork-Reward-Llama-3.1-8B-v0.2": dict(
        architectures=["LlamaForSequenceClassification"], attention_bias=False,
        bos_token_id=128000, eos_token_id=128009, hidden_act="silu", hidden_size=4096,
        id2label={"0": "LABEL_0"}, intermediate_size=14336, label2id={"LABEL_0": 0},
        max_position_embeddings=131072, mlp_bias=False, model_type="llama",
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=8,
        pad_token_id=128256, rms_norm_eps=1e-5,
        rope_scaling=dict(factor=8.0, high_freq_factor=4.0, low_freq_factor=1.0,
                          original_max_position_embeddings=8192, rope_type="llama3"),
        rope_theta=500000.0, tie_word_embeddings=False, torch_dtype="bfloat16",
        vocab_size=128257),
    "Skywork/Skywork-Reward-Gemma-2-27B-v0.2": dict(
        architectures=["Gemma2ForSequenceClassification"], attention_bias=False,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0, head_dim=128,
        hidden_act="gelu_pytorch_tanh", hidden_activation="gelu_pytorch_tanh",
        hidden_size=4608, id2label={"0": "LABEL_0"}, intermediate_size=36864,
        label2id={"LABEL_0": 0}, max_position_embeddings=8192, model_type="gemma2",
        num_attention_heads=32, num_hidden_layers=46, num_key_value_heads=16, pad_token_id=0,
        query_pre_attn_scalar=144, rms_norm_eps=1e-6, rope_theta=10000.0,
        sliding_window=4096, torch_dtype="bfloat16", vocab_size=256000),
    "Qwen/Qwen2.5-Math-RM-72B": dict(
        architectures=["Qwen2ForRewardModel"], bos_token_id=151643, eos_token_id=151645,
        hidden_act="silu", hidden_size=8192, intermediate_size=29568,
        max_position_embeddings=4096, max_window_layers=80, model_type="qwen2",
        num_attention_heads=64, num_hidden_layers=80, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
        tie_word_embeddings=False, torch_dtype="bfloat16", use_sliding_window=False,
        vocab_size=152064),
}


def published_config(repo: str, context_length: int = 8192, **kw):
    """``repo``'s published config.json (PUBLISHED, PUBLISHED_LN or
    PUBLISHED_VLM) through
    ``ModelConfig.from_hf_config`` at ``context_length`` (the pool and the
    rope table need no more), bf16; ``kw`` overrides fields (a cut depth,
    the float32 gates)."""
    from semi_pd_tpu_torch.config.model_config import ModelConfig

    hf = next(t[repo] for t in (PUBLISHED, PUBLISHED_LN, PUBLISHED_VLM) if repo in t)
    cfg = ModelConfig.from_hf_config(hf, context_length=context_length)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def bench_server_args(semi_pd: bool, kv_cache_dtype: str = "auto",
                      decode_stream: bool = False, max_total_tokens: int = 131072):
    """The bench's server settings (bench.py make_server_args) with a
    131072-token pool (``max_total_tokens``)."""
    from semi_pd_tpu_torch.config.server_args import ServerArgs

    return ServerArgs(
        random_weights=True, seed=0, page_size=16, max_total_tokens=max_total_tokens,
        chunked_prefill_size=4096, enable_semi_pd=semi_pd, decode_slo_ms=50.0,
        max_running_requests=64, decode_bs_buckets=[8, 32, 64],
        prefill_token_buckets=[512, 2048, 4096], kv_cache_dtype=kv_cache_dtype,
        decode_stream=decode_stream,
    )


# the two kernels (decode, extend) each pool's path launches, and with
# decode_stream (a model's windowed layers keep the packed decode there:
# expected_launches)
PATH_KERNELS = {"chunked": ("rpa_decode", "rpa_extend"),
                "aligned": ("rpa_decode_aligned", "rpa_extend_aligned"),
                # Baichuan2-13B's ALiBi: the aligned builds' ALiBi instantiations
                "aligned_alibi": ("rpa_decode_aligned_alibi", "rpa_extend_aligned_alibi"),
                "aligned256": ("rpa_decode_aligned_256", "rpa_extend_aligned_256"),
                "merged": ("rpa_decode_merged", "rpa_extend_merged"),
                "latent": ("rpa_decode_mla", "rpa_extend_mla"),
                "latent288": ("rpa_decode_mla_288", "rpa_extend_mla_288")}
STREAM_PATH_KERNELS = {"chunked": ("rpa_decode_stream", "rpa_extend"),
                       "aligned": ("rpa_decode_stream_aligned", "rpa_extend_aligned"),
                       "aligned256": ("rpa_decode_stream_aligned_256",
                                      "rpa_extend_aligned_256"),
                       "latent": ("rpa_decode_stream_mla", "rpa_extend_mla"),
                       "latent288": ("rpa_decode_stream_mla_288", "rpa_extend_mla_288")}


def expected_launches(runner, pool, stream, steps):
    """Each kernel's launches in a serve of ``steps`` (decode and extend
    steps): the path's extend L times per extend step, its decode L times
    per decode step; with ``stream`` the streaming decode on the layers
    without a window and the packed decode on the windowed ones (Gemma-2's
    even layers: 21 + 21 of 42), as the routing keeps a windowed batch on
    the packed decode."""
    L = runner.model_config.num_hidden_layers
    dec, ext = PATH_KERNELS[pool]
    want = {ext: L * steps["extend"]}
    windowed = sum(w is not None for w in getattr(runner.model, "layer_windows", ()))
    if stream:
        want[STREAM_PATH_KERNELS[pool][0]] = (L - windowed) * steps["decode"]
        if windowed:
            want[dec] = windowed * steps["decode"]
    else:
        want[dec] = L * steps["decode"]
    return want


# the attention path's norm leaves (Llama's and the MoE classes' input and
# q/k norms, DeepSeek's and MiniCPM3's input, q and kv norms, and the
# sandwich norm on the attention's output of Glm4 and Grok-1, whose 0.02
# weights would hide the attention beside Grok-1's embedding x 78.5)
ATTN_NORMS = ("input_norm", "q_norm", "k_norm", "kv_norm", "post_attn_sandwich")
# the vision towers' and projectors' norms (CLIP's pre_ln, ln1, ln2; the
# Qwen towers' ln1, ln2 and merger ln_q; Yi-VL's projector ln1, ln2): at
# 0.02 their features are about the projector's bias, the same for every
# image, and the model cannot see the image (the image gate)
VISION_NORMS = ("pre_ln", "ln1", "ln2", "ln_q")
# (the LayerNorm families' {"w", "b"} norms: their weight ``.w`` is lifted,
# their bias kept)


def make_attentive(model):
    """Set the attention path's norms to the identity (1, or 0 under
    Gemma's (1 + w) convention) so that random weights give scores of
    about unit spread: at 0.02 N(0, 1) they shrink q and k so far that
    every head attends near-uniformly and a wrong scale or softcap leaves
    the logits where they were (ROADMAP C15). A model whose attention
    scale is below head_dim ** -0.5 (Granite's attention_multiplier of
    1/128, a ninth of it) gets its norms at sqrt(head_dim ** -0.5 /
    scale) instead: q and k grow by that, the scores by its square, to a
    Llama's spread. A model narrower than 2048 (GPT-2-large's 1280) gets
    them times sqrt(4096 / hidden): q and k sum 0.02 N(0, 1) weights over
    fewer inputs, and the scores' spread (hidden x 0.0004 at unit
    inputs) is that of a 4096-wide model again. A vision-language model's
    tower and projector norms (VISION_NORMS, under ``vision.`` / ``proj.``)
    go to 1 too, so that the features carry the image. Returns the
    leaves' old values for ``restore``."""
    gemma = type(model).__name__.startswith("Gemma")
    D, scale = getattr(model, "head_dim", None), getattr(model, "scale", None)
    level = math.sqrt(D ** -0.5 / scale) if D and scale and scale < D ** -0.5 else 1.0
    H = model.config.hidden_size
    if H < 2048:
        level *= math.sqrt(4096 / H)
    saved = {}
    for path, _ in model.param_specs():
        keys = path.split(".")
        if keys[-1] in ATTN_NORMS or (keys[-1] == "w" and keys[-2] in ATTN_NORMS):
            leaf = model.leaf(path)
            saved[path] = leaf.detach().clone()
            leaf.data.fill_(0.0 if gemma else level)
        elif keys[0] in ("vision", "proj") and (
                keys[-1] in VISION_NORMS or (keys[-1] == "w" and keys[-2] in VISION_NORMS)):
            leaf = model.leaf(path)
            saved[path] = leaf.detach().clone()
            leaf.data.fill_(1.0)
    return saved


def restore(model, saved):
    for path, old in saved.items():
        model.leaf(path).data.copy_(old)


# the model phase's gate: kernels vs plain within 5% of the logit range
MODEL_GATE = 0.05


def phase_model(eng, stream: bool = False, lens=(700, 300, 1500, 37), attentive=False,
                gate=MODEL_GATE, mm=None):
    """The prompts of ``lens`` tokens prefilled in extend steps of up to the
    largest token bucket (4096), then two decode steps, at full width,
    kernels (with ``stream`` the streaming decode) vs the same layers with
    the plain attention functions. Each step also runs the kernels with
    their output zeroed and with twice the scale, and reports how far the
    logits move (``moves``, in the gate's measure): a gate that the
    attention moves less than 5% cannot see a wrong scale or softcap
    (ROADMAP C15). With ``attentive`` the steps run on make_attentive's
    weights (restored after), and every step's moves must pass the
    gate. ``mm``: (input_ids, image_data) per request in place of
    ``lens``'s random prompts (a vision-language model: its images encoded
    and spliced, Qwen-VL's M-RoPE positions)."""
    import torch

    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch, build_extend_batch
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner = eng.runner
    sched = eng.scheduler
    vocab = runner.model_config.vocab_size
    rng = np.random.default_rng(1)
    reqs = []
    if callable(mm):  # made from the engine (its image token, its tower)
        mm = mm(eng)
    prompts = mm or [(rng.integers(0, vocab, size=n).tolist(), None) for n in lens]
    for i, (ids, images) in enumerate(prompts):
        r = eng.make_request(ids, SamplingParams(temperature=0.0), image_data=images)
        r.rid = f"m{i}"
        n = r.prompt_len
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(n + 8) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        reqs.append(r)
    pool = runner.kv_cache.buffer
    kernels = pool_attention(pool, stream=stream)
    plain = pool_attention(pool, plain=True)

    def zeroed(*a, **kw):
        return torch.zeros_like(kernels(*a, **kw))

    def scaled(*a, scale, **kw):
        return kernels(*a, scale=2.0 * scale, **kw)

    model = runner.model
    saved = make_attentive(model) if attentive else {}
    worst = 0.0
    steps = []
    # the extend steps: each request's prompt in chunks, up to the largest
    # token bucket a step
    todo = [r.prompt_len for r in reqs]
    batches = []
    while any(todo):
        budget, admitted = max(sched.t_buckets), []
        for i, r in enumerate(reqs):
            n = min(todo[i], budget)
            if n:
                admitted.append((i, n))
                budget -= n
        batches.append(admitted)
        for i, n in admitted:
            todo[i] -= n
    batches += [None, None]  # two decode steps
    try:
        with torch.inference_mode():
            for admitted in batches:
                if admitted:
                    rs = [reqs[i] for i, _ in admitted]
                    hb = build_extend_batch([(reqs[i], n) for i, n in admitted],
                                            runner.req_pool.page_table, PAGE, sched.t_buckets,
                                            sched.b_buckets, sched.p_buckets)
                else:
                    rs = reqs
                    hb = build_decode_batch(reqs, runner.req_pool.page_table, PAGE,
                                            sched.b_buckets, sched.p_buckets)
                fb = hb.to_device(runner.device)
                n = len(rs)
                lk = model(fb, pool, attention=kernels)[:n].float()
                lp = model(fb, pool, attention=plain)[:n].float()
                if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                    raise AssertionError(f"model step {len(steps)}: non-finite logits")
                span = lp.abs().max()
                rel = float((lk - lp).abs().max() / span)
                moves = {name: float((model(fb, pool, attention=fn)[:n].float() - lk).abs().max()
                                     / span) for name, fn in (("zero", zeroed),
                                                               ("scale2x", scaled))}
                agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
                # the plain logits' closest top-2 gap over the rows, in the
                # gate's measure: an argmax that rel_err can flip is a near tie
                top2 = lp.topk(2, dim=-1).values
                gap = float((top2[:, 0] - top2[:, 1]).min() / span)
                worst = max(worst, rel)
                steps.append(dict(mode=hb.mode.value, T=hb.T, B=n,
                                  kv_max=int(hb.kv_lens.max()), rel_err=rel,
                                  argmax_agree=agree, top2_gap=gap, moves=moves))
                toks = lk.argmax(-1).tolist()
                for i, (r, t) in enumerate(zip(rs, toks)):
                    if admitted:
                        r.prefilled_len += admitted[i][1]
                        if r.prefilled_len < r.prompt_len:
                            continue  # a chunk within the prompt: no token yet
                    r.output_ids.append(int(t))
        torch.cuda.synchronize()
    finally:
        restore(model, saved)
        for r in reqs:
            runner.page_allocator.free(np.asarray(r.pages, np.int32))
            runner.req_pool.free(r.req_slot)
    # bf16 tolerance: the two paths differ only in attention (the GQA kernels
    # of the chunked and aligned pools round P to bf16 before P.V, and every
    # kernel sums in another order); over 16 to 32
    # layers that stays within 5% of the logit range, and moves the argmax
    # of at most one of the 4 rows per step (a near tie among random logits)
    if worst > gate:
        raise AssertionError(f"full-width logits: kernels vs plain rel err {worst:.3g} > "
                             f"{gate}")
    if min(s["argmax_agree"] for s in steps) < 0.75:
        raise AssertionError(f"full-width argmax: kernels vs plain agree on fewer than 3 of "
                             f"4 rows in a step: {steps}")
    blind = [s for s in steps if min(s["moves"].values()) <= gate]
    if attentive and blind:
        raise AssertionError(f"the gate does not see the attention in these steps: {blind}")
    return dict(steps=steps, worst_rel_err=worst, attentive=attentive, gate=gate,
                min_moves={k: min(s["moves"][k] for s in steps) for k in ("zero", "scale2x")})


def graph_batch(eng, seed: int):
    """The packed decode step of 64 requests of 520-1000 KV positions
    (pages from the allocator, random last tokens), and the requests. On an
    M-RoPE runner (Qwen2-VL) each request's rope position is shifted as an
    image shifts it (``mrope_delta`` of -1 to -400, drawn after the rest),
    and the step's pack carries it; the same step unshifted is
    returned third (else None)."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, sched = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    vocab = runner.model_config.vocab_size
    reqs = []
    for i, n in enumerate(rng.integers(520, 1001, size=64)):
        r = Req(rid=f"g{seed}-{i}", input_ids=[1] * int(n),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 1) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, vocab)))
        reqs.append(r)
    if not runner.mrope:
        hb = build_decode_batch(reqs, runner.req_pool.page_table, PAGE, sched.b_buckets,
                                sched.p_buckets)
        return hb.pack(), reqs, None
    for r in reqs:
        r.mrope_pos = np.zeros((r.prompt_len, 3), np.int32)  # decode reads only the delta
        r.mrope_delta = -int(rng.integers(1, 401))
    hb = build_decode_batch(reqs, runner.req_pool.page_table, PAGE, sched.b_buckets,
                            sched.p_buckets)
    shifted = hb.pack(mrope=True)
    hb.mrope_pos = None  # the rope at q_pos
    return shifted, reqs, hb.pack(mrope=True)


def graph_phase(eng, label, pool, stream: bool = False):
    """Replay vs eager step on one decode path at full width (phase 3g):
    bitwise on two batches of one key, no host sync, and the step wall of
    each at B = 64."""
    import torch

    from semi_pd_tpu_torch.layers.attention import pool_attention

    t0 = time.monotonic()
    runner = eng.runner
    if not eng.flush_cache():
        raise AssertionError("engine not idle before the graph phase")
    runner.attention = pool_attention(runner.kv_cache.buffer, stream=stream)
    runner.graphs.clear()  # this phase counts its own capture
    graphs = runner.graphs
    stats0 = dict(graphs.stats)

    def eager(*args, **kw):
        runner.graphs = None
        try:
            return runner.step_packed_raw(*args, is_decode=True, **kw)
        finally:
            runner.graphs = graphs

    def graph(*args, **kw):
        return runner.step_packed_raw(*args, is_decode=True, **kw)

    results, reqs, steps = [], [], []
    shift_moves = None
    for seed in (1, 2):  # the second batch chained to the first's tokens
        step, batch, unshifted = graph_batch(eng, seed)
        if unshifted is not None and not results:
            # the shifted rope reaches the step: the same step at q_pos
            # gives other log-probs
            plain_rope = eager(*unshifted)
            torch.cuda.synchronize()
        kw = dict(chained=True, prev_tokens=results[0][0][0]) if results else {}
        want = eager(*step, **kw)
        got = graph(*step, **kw)
        torch.cuda.synchronize()
        if unshifted is not None and not results:
            shift_moves = float((want[1] - plain_rope[1]).abs().max())
        results.append((want, got))
        steps.append(step)
        reqs += batch
        for r in batch:  # the request slots go to the next batch; the pages stay
            runner.req_pool.free(r.req_slot)
        # unless the pool cannot hold a second batch (Gemma-7B's bf16 pool of
        # 65536 tokens): the second batch then takes the first one's pages
        if runner.page_allocator.available_pages() < 64 * (-(-1001 // PAGE)):
            for r in batch:
                runner.page_allocator.free(np.asarray(r.pages, np.int32))
            reqs = [r for r in reqs if r not in batch]
    step1, step2 = steps
    if step1[2] != step2[2]:
        raise AssertionError(f"the two graph batches have other keys: {step1[2]} {step2[2]}")
    checks = []
    for i, (want, got) in enumerate(results):
        same_t = bool(torch.equal(want[0], got[0]))
        same_l = bool(torch.equal(want[1], got[1]))
        checks.append(dict(batch=i + 1, tokens_bitwise=same_t, logprobs_bitwise=same_l,
                           tokens_agree=float((want[0] == got[0]).float().mean()),
                           logprob_max_abs_diff=float((want[1] - got[1]).abs().max())))
        if not torch.isfinite(got[1]).all():
            raise AssertionError(f"{label}: non-finite log-probs from a replay")
    captures = graphs.stats["captures"] - stats0["captures"]
    # no host sync in an eager decode step or a replay
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(*step2)
        graph(*step2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        fn = eager if mode == "eager" else graph
        fn(*step1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            fn(*step1)
        torch.cuda.synchronize()
        wall[mode].append(1e3 * (time.perf_counter() - t1) / 20)
    for r in reqs:
        runner.page_allocator.free(np.asarray(r.pages, np.int32))
    res = dict(model=label, pool=pool, decode_stream=stream, key=list(step1[2][1:]),
               checks=checks, captures=captures, mrope_shift_logprob_moves=shift_moves,
               capture_s=graphs.stats["capture_s"] - stats0["capture_s"],
               graph_pool_bytes=graphs.pool_bytes(),
               eager_step_ms=wall["eager"], graph_step_ms=wall["graph"],
               seconds=time.monotonic() - t0)
    print("graphs " + json.dumps(res), flush=True)
    bad = [c for c in checks if not (c["tokens_bitwise"] and c["logprobs_bitwise"])]
    if bad:
        raise AssertionError(f"{label}: replays differ from the eager step: {bad}")
    if captures != 1:
        raise AssertionError(f"{label}: {captures} captures for one key")
    if shift_moves is not None and not shift_moves > 0:
        raise AssertionError(f"{label}: the shifted M-RoPE position does not reach the step")
    return res


def prompts_for(vocab: int, max_len: int = 3072):
    """The 32 prompts a path serves: lengths 256-``max_len`` (3072 for
    every model whose context allows it), tokens drawn from the model's
    vocabulary."""
    rng = np.random.default_rng(0)
    lens = rng.integers(256, max_len + 1, size=32)
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]


def serve_mode(eng, semi_pd: bool, prompts, vocab, pool, stream: bool = False,
               eager: bool = False, images=None):
    """One serve of the 32 prompts; ``eager``: the decode steps run eagerly
    instead of replaying the runner's graphs; ``images``: each request's
    ``image_data`` (its images are encoded inside the serve)."""
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    args = bench_server_args(semi_pd, eng.server_args.kv_cache_dtype, stream,
                             eng.server_args.max_total_tokens)
    if not eng.flush_cache():
        raise AssertionError("engine not idle before serving")
    eng.server_args = args
    eng.scheduler = Scheduler(args, eng.runner)
    sp = SamplingParams(max_new_tokens=64, temperature=0.0, ignore_eos=True)
    runner = eng.runner
    # the same weights and pool, the runner's routing as decode_stream sets it
    runner.attention = pool_attention(runner.kv_cache.buffer, stream=stream)
    graphs = runner.graphs
    if eager:
        runner.graphs = None
    stats0 = dict(graphs.stats)
    runner.step_counts = {"decode": 0, "extend": 0}
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        outs = eng.generate(input_ids=prompts, sampling_params=sp, return_logprob=True,
                            image_data=images)
        torch.cuda.synchronize()
    finally:
        runner.graphs = graphs
    wall = time.monotonic() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    steps = dict(runner.step_counts)
    graph_run = {k: graphs.stats[k] - stats0[k] for k in stats0}
    if graph_run["replays"] != (0 if eager else steps["decode"]):
        raise AssertionError(f"{pool}: {graph_run['replays']} decode steps replayed of "
                             f"{steps['decode']} (eager: {eager})")
    reqs = [eng.scheduler.reqs_by_rid[o["rid"]] for o in outs]
    for o in outs:
        if o["meta_info"]["finish_reason"] != "length" or len(o["output_ids"]) != 64:
            raise AssertionError(f"request {o['rid']} did not complete: {o['meta_info']['finish_reason']}")
        lps = o["meta_info"]["output_logprobs"]
        if len(lps) != 64 or not all(math.isfinite(x) for x in lps):
            raise AssertionError(f"request {o['rid']}: missing or NaN logprobs")
        if not all(0 <= t < vocab for t in o["output_ids"]):
            raise AssertionError(f"request {o['rid']}: token out of range")
    want = expected_launches(runner, pool, stream, steps)
    if not steps["decode"] or not steps["extend"]:
        raise AssertionError(f"{pool}: a serve without decode or extend steps: {steps}")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{k} launches {launches[k]} != {n} ({steps} steps)")
    others = {k: n for k, n in launches.items() if k not in want and n}
    if others:
        raise AssertionError(f"the {pool} pool's path launched other kernels: {others}")
    if not eng.flush_cache():  # runs check_memory()
        raise AssertionError("engine not idle after serving")
    ttft = [r.first_token_time - r.queue_time for r in reqs]
    itl = [(r.finish_time - r.first_token_time) / (len(r.output_ids) - 1) for r in reqs]
    res = dict(pool=pool, kv_dtype=str(runner.kv_cache.buffer.dtype).replace("torch.", ""),
               mode="semi_pd" if semi_pd else "colocated", decode_stream=stream,
               decode_graphs=not eager, requests=len(outs),
               wall_s=wall, tok_s=len(outs) * 64 / wall,
               ttft_p50_s=statistics.median(ttft), itl_p50_ms=1e3 * statistics.median(itl),
               steps=steps, launches=launches, graphs=graph_run,
               retracted=eng.scheduler.n_retracted)
    return res, [o["output_ids"] for o in outs]


# ------------------------------------------------------- speculative decoding
SPEC_ALGOS = {"ngram": dict(speculative_algorithm="NGRAM", speculative_num_draft_tokens=4),
              "chain": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=4),
              "tree": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=4,
                           speculative_eagle_topk=4),
              # DeepSeek's NextN draft (the runner picks it for a DeepSeek target)
              "nextn_chain": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=4),
              "nextn_tree": dict(speculative_algorithm="NEXTN", speculative_num_draft_tokens=4,
                                 speculative_eagle_topk=4)}
# the 1B-class model's speculating serves (phase 4s)
LLAMA_SPEC_ALGOS = ("ngram", "chain", "tree")


def spec_server_args(semi_pd: bool, algo: str, **kw):
    """The bench's server settings with speculative decoding: NGRAM with 4
    draft tokens, EAGLE and NEXTN chains with 4, EAGLE and NEXTN trees with
    topk 4 and 4 draft tokens (default_tree_template(4, 4): branching (4, 2,
    1, 1), 29 nodes)."""
    return dataclasses.replace(bench_server_args(semi_pd), **SPEC_ALGOS[algo], **kw)


# the embedding's gain in make_predictive: a larger gain lets the last
# token decide more of the target's argmax, so more drafts are accepted,
# but hides more of attention from the token gates (too large, and a
# broken tree mask no longer changes a token); 1 leaves the 16-layer,
# 128256-token model's drafts seldom accepted. NGRAM drafts from a
# request's own repeats, which a gain of 3 breaks up (the target's greedy
# tokens then follow the last token alone, in no short loop), so its
# engine, and the plain one it is compared with, keep 1.
EMBED_GAIN = 3.0
SPEC_GAIN = {"ngram": 1.0, "chain": EMBED_GAIN, "tree": EMBED_GAIN}
# Meta-Llama-3-8B's: its 32 layers at hidden 4096 outweigh the embedding
# at 3 (its EAGLE serves accepted 0.008-0.041 drafts a round there, on an
# H100 80GB HBM3 at 700 W)
LLAMA3_8B_GAIN = 10.0
# the float32 V2-Lite gate's depth: its dense layer and three MoE layers
NEXTN_F32_LAYERS = 4
# the speculating phases' target depths (4n, 4a, 4m, 4e), half of each
# model's (their main paths serve at full depth): the script's whole run has
# to stay inside its time limit as the families grow
SPEC_LAYERS = {"deepseek": 14, "llama3_8b": 16, "minicpm3": 31, "gemma2": 21}


def make_predictive(runner, gain=EMBED_GAIN):
    """Make the random weights predictive, as the CPU tests do, so that
    EAGLE's and NextN's drafts are accepted and their rounds run their
    accepted paths (the compaction and the refresh after acceptance): the
    target's final norm ones, so its argmax is the head's over its last
    hidden state, which the last token's embedding (times ``gain``)
    dominates at the 0.02 init; the draft's fc (NextN: its eh_proj, behind
    its enorm and hnorm, then ones) passing the token embedding through
    (and 0.01 of the fed hidden state), and NextN's head norm ones, so the
    draft's head sees mostly that embedding. The untied lm_head stays: both
    the target and the draft read it from that embedding, so their argmaxes
    meet. Every engine whose tokens are compared with another's gets it,
    NGRAM's and the plain one's too.

    Gemma-2 reads its norms as (1 + w), so its final norm's "ones" is w = 0.
    Its head is the embedding (tied), so the gain scales the head too, and
    its final softcap (30 tanh(x / 30)) squeezes the logits; neither moves
    the argmax. Drafts are accepted there because the target's last hidden
    state is the token's embedding times gain x sqrt(hidden) plus 84
    sandwich-normed branches of unit scale in directions no embedding row
    shares: after the final norm the token's own row of the tied head
    scores far above every other, and the EAGLE draft (a plain llama layer,
    its norms drawn at 0.02, no softcap), passing the raw embedding through
    its fc, picks the same row. So the target repeats its last token and
    the drafts of it are accepted: the rounds run their accepted paths (the
    compaction and the refresh), while its tokens no longer depend on
    attention, which phase 2's tree cases and the spec_model rounds
    (logits, kernels against plain) check instead."""
    import torch

    from semi_pd_tpu_torch.models.gemma2 import Gemma2ForCausalLM
    from semi_pd_tpu_torch.speculative.nextn import NextNDraftModel

    H = runner.model_config.hidden_size
    with torch.no_grad():
        gemma = isinstance(runner.model, Gemma2ForCausalLM)
        runner.model.leaf("final_norm").fill_(0.0 if gemma else 1.0)
        runner.model.leaf("embed.w").mul_(gain)
        draft = runner.draft_model
        if draft is not None:
            nextn = isinstance(draft, NextNDraftModel)
            fc = draft.leaf("eh_proj.w" if nextn else "fc.w")
            fc[H:] *= 0.01
            fc[:H] = torch.eye(H, dtype=fc.dtype, device=fc.device)
            if nextn:
                for k in ("enorm", "hnorm", "head_norm"):
                    draft.leaf(k).fill_(1.0)
            runner.set_spec_thresholds()


def phase_spec_model(eng, label):
    """One tree round and one chain round of the speculating engine at full
    width through the kernels and again through the plain attention (target
    and draft pool), from the same state: 4 requests (700, 300, 1500 and 37
    prompt tokens) prefilled through the kernels with their hidden states.
    A verify row is compared where both runs verified the same tokens on
    its path (a draft's top-k may flip at a near tie); the target's logits
    there must stay within 5% of the logit range, and the root rows always
    compare."""
    import torch

    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.batch import (
        build_extend_batch, build_spec_verify_batch, build_tree_verify_batch,
    )
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
    from semi_pd_tpu_torch.speculative.eagle import eagle_round, eagle_tree_round

    t0 = time.monotonic()
    runner, sched = eng.runner, eng.scheduler
    if not eng.flush_cache():
        raise AssertionError("engine not idle before the speculation model phase")
    vocab = runner.model_config.vocab_size
    rng = np.random.default_rng(5)
    reqs = []
    for i, n in enumerate((700, 300, 1500, 37)):
        r = Req(rid=f"s{i}", input_ids=rng.integers(0, vocab, size=n).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(n + 40) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        reqs.append(r)
    hb = build_extend_batch([(r, r.prompt_len) for r in reqs], runner.req_pool.page_table,
                            PAGE, sched.t_buckets, sched.b_buckets, sched.p_buckets)
    tok, _, hidden = runner.step_with_hidden_host(hb)
    for i, r in enumerate(reqs):
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(tok[i]))
    prev = hidden.float()
    routes = {"kernels": (runner.attention, runner.draft_attention),
              "plain": (pool_attention(runner.kv_cache.buffer, plain=True),
                        pool_attention(runner.draft_kv.buffer, plain=True))}
    tree, g = runner.tree_template, sched.spec_gamma
    anc = np.array(tree.anc_bits)
    out = []
    for kind in ("tree", "chain"):
        if kind == "tree":
            hb = build_tree_verify_batch(reqs, tree, runner.req_pool.page_table, PAGE,
                                         sched.b_buckets, sched.p_buckets)
        else:
            hb, _, _ = build_spec_verify_batch(reqs, [[0] * g] * len(reqs), g,
                                               runner.req_pool.page_table, PAGE,
                                               sched.b_buckets, sched.p_buckets)
        res = {}
        for route, (att, datt) in routes.items():
            fb = hb.to_device(runner.device)
            kw = dict(attention=att, draft_attention=datt)
            if kind == "tree":
                res[route] = eagle_tree_round(runner.model, runner.draft_model,
                                              runner.kv_cache.buffer, runner.draft_kv.buffer,
                                              fb, prev[: hb.B], tree, **kw)
            else:
                res[route] = eagle_round(runner.model, runner.draft_model,
                                         runner.kv_cache.buffer, runner.draft_kv.buffer, fb,
                                         prev[: hb.B], g, runner.generator, **kw)
        torch.cuda.synchronize()
        k, p = res["kernels"], res["plain"]
        n, W = len(reqs), k.window.shape[1]
        wk, wp = k.window[:n].cpu().numpy(), p.window[:n].cpu().numpy()
        # row j compares where the tokens on its path agree: its ancestors
        # in the tree, the window's first j + 1 in the chain
        path = (np.array([[(a >> i) & 1 for i in range(W)] for a in anc], bool)
                if kind == "tree" else np.tril(np.ones((W, W), bool)))
        same = ~((wk != wp)[:, None, :] & path[None]).any(-1)  # [n, W]
        lk = k.logits.reshape(-1, W, vocab)[:n][torch.as_tensor(same, device="cuda")]
        lp = p.logits.reshape(-1, W, vocab)[:n][torch.as_tensor(same, device="cuda")]
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"{label} {kind} round: non-finite logits")
        rel = float((lk - lp).abs().max() / lp.abs().max())
        row = dict(model=label, round=kind, rows_compared=int(same.sum()), rows=n * W,
                   rel_err=rel, argmax_agree=float((lk.argmax(-1) == lp.argmax(-1)).float().mean()),
                   accept_len={r: x.accept_len[:n].tolist() for r, x in res.items()},
                   next_tok={r: x.next_tok[:n].tolist() for r, x in res.items()})
        print("spec_model " + json.dumps(row), flush=True)
        out.append(row)
        if not same[:, 0].all() or rel > 0.05:
            raise AssertionError(f"{label} {kind} round: kernels vs plain rel err {rel:.3g} "
                                 f"over {int(same.sum())} rows (root rows compared: "
                                 f"{bool(same[:, 0].all())})")
    for r in reqs:
        runner.page_allocator.free(np.asarray(r.pages, np.int32))
        runner.req_pool.free(r.req_slot)
    print("spec_model_phase " + json.dumps(dict(model=label, seconds=time.monotonic() - t0)),
          flush=True)
    return out


def round_call(eng, kind, seed):
    """A round batch of 32 requests of 520-1000 committed positions on
    pages from the allocator (shuffled by its state), their prefix rows in
    both pools random, random last tokens and hidden states: a function
    running the round of ``kind`` through the runner's host form (NGRAM:
    drafts of 0-4 tokens, the last token repeated for every other
    request), the requests, and the slots the round may write (each
    request's window; not the dump page)."""
    import torch

    from semi_pd_tpu_torch.runtime import batch as port_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, s = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    vocab, H = runner.model_config.vocab_size, runner.model_config.hidden_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    reqs, prefix = [], []
    for i, n in enumerate(rng.integers(520, 1001, size=32)):
        r = Req(rid=f"r{seed}-{i}", input_ids=rng.integers(0, vocab, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 32) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, vocab)))
        reqs.append(r)
        pos = np.arange(r.kv_len)
        prefix.append(pages[pos // PAGE] * PAGE + pos % PAGE)
    slots = torch.as_tensor(np.concatenate(prefix), device="cuda").long()
    n = len(slots)
    for buf in (runner.kv_cache.buffer, runner.draft_kv.buffer):
        shape = ((n, *buf.shape[2:]) if buf.dim() == 4
                 else (buf.shape[1], n, *buf.shape[3:]))
        for layer in range(buf.shape[0]):  # one layer at a time: no full-pool temporary
            noise = (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(buf.dtype)
            if buf.dim() == 4:
                buf[layer, slots] = noise
            else:
                buf[layer, :, slots] = noise
    table, gamma = runner.req_pool.page_table, s.spec_gamma
    if kind == "tree":
        hb = port_batch.build_tree_verify_batch(reqs, runner.tree_template, table, PAGE,
                                                s.b_buckets, s.p_buckets)
    else:
        drafts = [[0] * gamma] * len(reqs)
        if kind == "ngram":
            drafts = [[r.output_ids[-1]] * int(rng.integers(0, gamma + 1)) if i % 2 == 0
                      else rng.integers(0, vocab, size=int(rng.integers(0, gamma + 1))).tolist()
                      for i, r in enumerate(reqs)]
        hb, dp, dl = port_batch.build_spec_verify_batch(reqs, drafts, gamma, table, PAGE,
                                                        s.b_buckets, s.p_buckets)
    prev = rng.normal(size=(hb.B, H)).astype(np.float32)
    call = {"chain": lambda: runner.eagle_step_host(hb, prev, gamma),
            "tree": lambda: runner.eagle_tree_step_host(hb, prev),
            "ngram": lambda: runner.spec_step_host(hb, dp, dl, gamma)}[kind]
    window = hb.out_slots[: len(reqs) * (hb.T // hb.B)]
    return call, reqs, torch.as_tensor(window[window >= PAGE], device="cuda").long()


def window_rows(runner, slots):
    """Both pools' rows at ``slots``, as bytes."""
    import torch

    out = []
    for buf in (runner.kv_cache.buffer, runner.draft_kv.buffer):
        rows = buf[:, slots] if buf.dim() == 4 else buf[:, :, slots]
        out.append(rows.contiguous().view(torch.uint8))
    return out


def round_phase(eng, label, kinds):
    """Phase 3r on the speculating engine at full width, for each round
    kind: a round batch (``round_call``) run eagerly (``decode_graphs``
    off) and replayed from its round graph from the same pools and
    generator state, then a second batch of the same key the same way:
    accept lengths, next tokens, tokens, hidden states and both pools'
    window rows bitwise equal, no second capture; one replay under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); the eager
    and the replayed round's wall (5 rounds a turn, turns eager, graph,
    graph, eager). One ``round_graphs`` line per kind."""
    import torch

    runner = eng.runner
    if not eng.flush_cache():
        raise AssertionError("engine not idle before the round graph phase")
    graphs = runner.round_graphs

    def eager(call):
        runner.round_graphs = None
        try:
            return call()
        finally:
            runner.round_graphs = graphs

    out = []
    for kind in kinds:
        t0 = time.monotonic()
        graphs.clear()  # this phase counts its own capture
        stats0 = dict(graphs.stats)
        checks, all_reqs = [], []
        for seed in (11, 12):
            call, reqs, slots = round_call(eng, kind, seed)
            all_reqs += reqs
            start = window_rows(runner, slots)
            state = runner.generator.get_state()
            want = eager(call)
            want_rows = window_rows(runner, slots)
            for buf, rows in zip((runner.kv_cache.buffer, runner.draft_kv.buffer), start):
                dst = buf[:, slots] if buf.dim() == 4 else buf[:, :, slots]
                restored = rows.view(buf.dtype).reshape(dst.shape)
                if buf.dim() == 4:
                    buf[:, slots] = restored
                else:
                    buf[:, :, slots] = restored
            runner.generator.set_state(state)
            got = call()
            torch.cuda.synchronize()
            same = [bool(torch.equal(a.contiguous().view(torch.uint8),
                                     b.contiguous().view(torch.uint8)))
                    for a, b in zip(got, want)]
            pools = [bool(torch.equal(a, b)) for a, b in zip(window_rows(runner, slots),
                                                              want_rows)]
            checks.append(dict(batch=seed - 10, outputs_bitwise=same, pools_bitwise=pools,
                               accepted=int(got[0].sum())))
        captures = graphs.stats["captures"] - stats0["captures"]
        (key, g), = graphs.graphs.items()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            run = (lambda: eager(call)) if mode == "eager" else call
            run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            wall[mode].append(1e3 * (time.perf_counter() - t1) / 5)
        for r in all_reqs:
            runner.page_allocator.free(np.asarray(r.pages, np.int32))
            runner.req_pool.free(r.req_slot)
        res = dict(model=label, kind=kind, key=dict(B=key.B, maxP=key.maxP, T=key.T,
                                                    spec=key.spec, refresh=key.refresh),
                   checks=checks, captures=captures,
                   capture_s=graphs.stats["capture_s"] - stats0["capture_s"],
                   graph_pool_bytes=graphs.pool_bytes(), launches_per_replay=g.tally,
                   eager_round_ms=wall["eager"], graph_round_ms=wall["graph"],
                   seconds=time.monotonic() - t0)
        print("round_graphs " + json.dumps(res), flush=True)
        out.append(res)
        bad = [c for c in checks if not (all(c["outputs_bitwise"]) and all(c["pools_bitwise"]))]
        if bad:
            raise AssertionError(f"{label} {kind}: replayed rounds differ from the eager "
                                 f"round: {bad}")
        if captures != 1:
            raise AssertionError(f"{label} {kind}: {captures} captures for one key")
        if kind != "ngram" and not sum(c["accepted"] for c in checks):
            raise AssertionError(f"{label} {kind}: no draft accepted in the round batches")
    if not eng.flush_cache():
        raise AssertionError("engine not idle after the round graph phase")
    return out


def spec_serve(eng, algo, semi_pd, prompts, max_new=64, eager=False):
    """One speculating serve of ``prompts`` (greedy, ``max_new`` tokens) on
    ``eng``, an Engine built for ``algo`` (spec_server_args); launch
    counters set to 0 just before and read just after. Only the builds of
    the speculating path may launch, each L times per step of its kind: the
    target's extend per prefill chunk and per verify (L layers), the draft
    pool's decode per chain draft or refresh step and its extend per tree
    draft step (one layer); never the target's decode. Every round is
    replayed from its round graph (replays == rounds), or with ``eager``
    run eagerly (the runner's graphs off for this serve)."""
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner = eng.runner
    if not eng.flush_cache():
        raise AssertionError("engine not idle before a speculating serve")
    tree = algo.endswith("tree")
    if ((runner.draft_model is None) != (algo == "ngram")
            or (runner.tree_template is None) == tree):
        raise AssertionError(f"{algo} serve on an engine built for "
                             f"{eng.server_args.speculative_algorithm}")
    args = spec_server_args(semi_pd, algo, kv_cache_dtype=eng.server_args.kv_cache_dtype,
                            max_total_tokens=eng.server_args.max_total_tokens)
    eng.server_args = args
    eng.scheduler = Scheduler(args, runner)
    if runner.draft_kv is not None:
        # the draft attends its pool at the prompt's positions, which no
        # step writes (the JAX package's EAGLE and NextN, ROADMAP C12): what
        # earlier serves left there moves acceptance, so each serve starts
        # from a zeroed draft pool, as on a new engine
        runner.draft_kv.buffer.zero_()
    runner.step_counts = {"decode": 0, "extend": 0}
    runner.spec_counts = {k: 0 for k in runner.spec_counts}
    graphs = (runner.graphs, runner.round_graphs)
    if eager:
        runner.graphs = runner.round_graphs = None
    rounds0 = dict(graphs[1].stats)
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        outs = eng.generate(input_ids=prompts, sampling_params=SamplingParams(
            max_new_tokens=max_new, temperature=0.0, ignore_eos=True))
    finally:
        runner.graphs, runner.round_graphs = graphs
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    rounds = {k: graphs[1].stats[k] - rounds0[k] for k in rounds0}
    steps, spec = dict(runner.step_counts), dict(runner.spec_counts)
    s = eng.scheduler
    vocab = runner.model_config.vocab_size
    reqs = [s.reqs_by_rid[o["rid"]] for o in outs]
    for o in outs:
        if o["meta_info"]["finish_reason"] != "length" or len(o["output_ids"]) != max_new:
            raise AssertionError(f"{algo}: request {o['rid']} did not complete")
        if not all(0 <= t < vocab for t in o["output_ids"]):
            raise AssertionError(f"{algo}: request {o['rid']}: token out of range")
    L = runner.model_config.num_hidden_layers
    pool = path_kernels(runner.kv_cache.buffer)
    want = {pool[1]: L * (steps["extend"] + spec["verify"])}
    if algo != "ngram":
        # the draft pool's decode and extend: the merged builds for EAGLE's
        # 5D pool at head_dim 64, the _256 ones (shared with the target) at
        # Gemma-2's 256, the latent ones of the target's width (the extend
        # shared with the target) for NextN's latent pool
        draft_dec, draft_ext = path_kernels(runner.draft_kv.buffer)
        want[draft_dec] = want.get(draft_dec, 0) + spec["draft_decode"]
        want[draft_ext] = want.get(draft_ext, 0) + spec["draft_tree"]
    bad = {k: (n, want.get(k, 0)) for k, n in launches.items() if n != want.get(k, 0)}
    if (bad or steps["decode"] or not spec["verify"] or not steps["extend"]
            or (tree and not spec["draft_tree"])
            or (algo.endswith("chain") and (spec["draft_tree"] or not spec["draft_decode"]))):
        raise AssertionError(f"{algo} serve: launches (got, want) {bad}, steps {steps}, "
                             f"speculation steps {spec}")
    if not s.n_spec_accepted:  # the rounds' accepted paths must run
        raise AssertionError(f"{algo} serve: no draft accepted in {s.n_spec_steps} rounds")
    if rounds["replays"] != (0 if eager else spec["verify"]):
        raise AssertionError(f"{algo} serve: {rounds['replays']} round replays for "
                             f"{spec['verify']} rounds (eager: {eager})")
    if not eng.flush_cache():  # runs check_memory()
        raise AssertionError("engine not idle after a speculating serve")
    ttft = [r.first_token_time - r.queue_time for r in reqs]
    itl = [(r.finish_time - r.first_token_time) / (len(r.output_ids) - 1) for r in reqs]
    res = dict(algo=algo, mode="semi_pd" if semi_pd else "colocated", eager_rounds=eager,
               kv_dtype=str(runner.kv_cache.buffer.dtype).replace("torch.", ""),
               requests=len(outs), wall_s=wall, tok_s=len(outs) * max_new / wall,
               ttft_p50_s=statistics.median(ttft), itl_p50_ms=1e3 * statistics.median(itl),
               rounds=s.n_spec_steps, accepted=s.n_spec_accepted,
               accepted_per_round=s.n_spec_accepted / max(s.n_spec_steps, 1),
               prefill_chunks=steps["extend"], steps=steps, spec_steps=spec,
               round_graphs=dict(rounds, pool_bytes=graphs[1].pool_bytes()),
               launches={k: n for k, n in launches.items() if n},
               # the target's extend launches by instantiation: TREE = true
               # for a tree's verify layers and draft steps, TREE = false
               # for the prefill chunks (and a chain's verify)
               tree_launches=(L * spec["verify"] + spec["draft_tree"]) if tree else 0)
    return res, [o["output_ids"] for o in outs]


# ------------------------------------------- constrained sampling (phase 4c)
LLAMA3_EOS = 128001  # Meta-Llama-3's <|end_of_text|>
REGEX_4C = r"(ab|cd)=[0-9]{2,4};(x|yz)"
SCHEMA_4C = {"type": "object",
             "properties": {"ok": {"type": "boolean"},
                            "tag": {"type": "string", "enum": ["xy", "zz"]}},
             "required": ["ok", "tag"]}
# the JSON grammar's whitespace (constrained_json_whitespace_pattern): at
# most one space, so that the schema's longest text fits in 48 tokens
JSON_WS_4C = "[ ]?"
# absolute limits of the phase's card checks: ``score`` of the served
# tokens against the serve's log-probs (the same kernels and fp8 KV on
# both sides; 4.9e-4 measured on an H100), and ``encode``'s rows against
# the same prompts' final-normed hidden states, normalized here
SCORE_TOL_4C = 1e-2
ENCODE_TOL_4C = 1e-3
# the 8 requests of a phase-4c serve: sampling parameters and top-k
MIX_4C = [
    (dict(repetition_penalty=1.2, frequency_penalty=0.5, ignore_eos=True), 0),
    (dict(repetition_penalty=1.2, frequency_penalty=0.5, ignore_eos=True), 0),
    (dict(regex=REGEX_4C), 0),
    (dict(regex=REGEX_4C), 0),
    (dict(json_schema=json.dumps(SCHEMA_4C)), 0),
    (dict(custom_logit_processor="logit_bias", ignore_eos=True,
          custom_params={"logit_bias": {"33": 4.0, "66": 2.5, "1000": -100.0}}), 0),
    (dict(ignore_eos=True), 5),
    (dict(ignore_eos=True), 0),
]


class SmokeTokenizer:
    """A tokenizer object over ``n`` ids, built here (no download): id i <
    95 is the printable character chr(32 + i); the ids above are 2-4
    character strings over lower-case letters, digits and JSON punctuation
    drawn from a seed, so most tokens are several characters long, as in a
    BPE vocabulary; Llama-3's EOS id and its begin-of-text id decode to
    nothing."""

    ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789{}\":,[] _=;"

    def __init__(self, n: int, eos: int = LLAMA3_EOS, seed: int = 0):
        rng = np.random.default_rng(seed)
        lens = rng.integers(2, 5, size=n)
        picks = rng.integers(0, len(self.ALPHABET), size=(n, 4))
        self.strs = [chr(32 + i) if i < 95 else
                     "".join(self.ALPHABET[j] for j in picks[i, : lens[i]]) for i in range(n)]
        self.vocab_size = n
        self.eos_token_id = eos
        self.all_special_ids = [eos - 1, eos]
        for s in self.all_special_ids:
            self.strs[s] = ""

    def __len__(self):
        return self.vocab_size

    def decode(self, ids, **kw):
        return "".join(self.strs[i] for i in ids)


def grammar_ok(sp: dict, text: str) -> bool:
    """The text of a finished constrained request matches its grammar."""
    if "regex" in sp:
        return re.fullmatch(sp["regex"], text) is not None
    doc = json.loads(text)
    return (set(doc) == {"ok", "tag"} and isinstance(doc["ok"], bool)
            and doc["tag"] in ("xy", "zz"))


def variant_batch(eng, B: int, seed: int):
    """A decode batch of B requests of 520-1000 prompt tokens and 8 output
    tokens each (repetition 1.2, frequency 0.5: a full penalty histogram),
    pages from the allocator, and the requests."""
    from semi_pd_tpu_torch.runtime.batch import build_decode_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, sched = eng.runner, eng.scheduler
    vocab = runner.model_config.vocab_size
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(rng.integers(520, 1001, size=B)):
        r = Req(rid=f"v{seed}-{i}", input_ids=rng.integers(0, vocab, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=0.0, repetition_penalty=1.2,
                                               frequency_penalty=0.5))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 8) // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len - 7
        r.output_ids = rng.integers(0, vocab, size=8).tolist()
        reqs.append(r)
    hb = build_decode_batch(reqs, runner.req_pool.page_table, PAGE, sched.b_buckets,
                            sched.p_buckets)
    return hb, reqs


VARIANTS_4C = ("plain", "bool", "bias", "penalties", "top_k5")


def variant_steps(eng, label):
    """Each decode step variant at B 32 and 64 on the 8B's path: the step
    with the plain key, a grammar's bool mask, a float32 logit bias, the
    penalty histogram, top-k 5 log-probs; the replay bitwise against the
    eager step (tokens, log-probs, top-k), one capture a key, no host sync
    in a replay; the replayed and the eager step's wall (10 steps a turn,
    turns eager, graph, graph)."""
    import torch

    runner = eng.runner
    graphs = runner.graphs
    vocab = runner.model_config.vocab_size
    rows = []
    for B in (32, 64):
        hb, reqs = variant_batch(eng, B, seed=B)
        rng = np.random.default_rng(B)
        bool_mask = rng.random((hb.B, vocab)) < 0.2
        bias = rng.uniform(-4, 4, (hb.B, vocab)).astype(np.float32)
        bias[rng.random((hb.B, vocab)) < 0.3] = -np.inf
        pen = eng.scheduler._penalty_arrays(reqs, hb.B)
        steps = {"plain": lambda: runner.step_host(hb),
                 "bool": lambda: runner.step_host(hb, bool_mask),
                 "bias": lambda: runner.step_host(hb, bias),
                 "penalties": lambda: runner.step_host(hb, None, pen),
                 "top_k5": lambda: runner.step_topk_host(hb, 5)}
        for name in VARIANTS_4C:
            step = steps[name]
            cap0 = graphs.stats["captures"]
            runner.graphs = None
            try:
                want = step()
            finally:
                runner.graphs = graphs
            got = step()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
            torch.cuda.set_sync_debug_mode("error")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = {"eager": [], "graph": []}
            for mode in ("eager", "graph", "graph"):
                runner.graphs = None if mode == "eager" else graphs
                try:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    for _ in range(10):
                        step()
                    torch.cuda.synchronize()
                finally:
                    runner.graphs = graphs
                wall[mode].append(1e3 * (time.perf_counter() - t1) / 10)
            row = dict(model=label, B=B, variant=name, bitwise=bitwise,
                       captures=graphs.stats["captures"] - cap0,
                       eager_step_ms=wall["eager"], graph_step_ms=wall["graph"])
            print("constrained_steps " + json.dumps(row), flush=True)
            if not bitwise or row["captures"] != 1:
                raise AssertionError(f"{label} {name} B {B}: replay vs eager {row}")
            rows.append(row)
        for r in reqs:
            runner.page_allocator.free(np.asarray(r.pages, np.int32))
            runner.req_pool.free(r.req_slot)
    return rows


def constrained_serve(eng, semi_pd, prompts, mix, eager=False, max_new=48):
    """One serve of ``prompts`` with the per-request sampling of ``mix``
    ((sampling dict, top-k) each; greedy, ``max_new`` tokens) in one batch,
    as concurrent clients send them; ``eager``: the decode steps run
    eagerly. The constrained requests must end in their grammar, the others
    run to ``max_new`` with finite log-probs (top-k lists of their k)."""
    import torch

    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner = eng.runner
    args = dataclasses.replace(bench_server_args(semi_pd, eng.server_args.kv_cache_dtype),
                               constrained_json_whitespace_pattern=JSON_WS_4C,
                               disable_outlines_disk_cache=True)
    if not eng.flush_cache():
        raise AssertionError("engine not idle before a constrained serve")
    eng.server_args = args
    eng.scheduler = Scheduler(args, runner)
    from semi_pd_tpu_torch.layers.attention import pool_attention

    runner.attention = pool_attention(runner.kv_cache.buffer)
    graphs = runner.graphs
    stats0 = dict(graphs.stats)
    d0 = runner.step_counts["decode"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [eng.make_request(p, SamplingParams(max_new_tokens=max_new, temperature=0.0, **sp),
                             return_logprob=True, top_logprobs_num=k)
            for p, (sp, k) in zip(prompts, mix)]
    make_s = time.monotonic() - t0
    if eager:
        runner.graphs = None
    try:
        for r in reqs:
            eng.scheduler.add_request(r)
        eng._run_until_done(reqs)
        torch.cuda.synchronize()
    finally:
        runner.graphs = graphs
    wall = time.monotonic() - t0
    outs = [eng._to_output(r) for r in reqs]
    decode_steps = runner.step_counts["decode"] - d0
    replays = graphs.stats["replays"] - stats0["replays"]
    if replays != (0 if eager else decode_steps):
        raise AssertionError(f"{replays} decode steps replayed of {decode_steps}")
    tok = eng.tokenizer
    for (sp, k), o in zip(mix, outs):
        m = o["meta_info"]
        if "regex" in sp or "json_schema" in sp:
            text = tok.decode(o["output_ids"])
            if m["finish_reason"] != "stop_token" or not grammar_ok(sp, text):
                raise AssertionError(f"constrained output {text!r} ({m['finish_reason']}) does "
                                     f"not match its grammar {sp}")
        elif m["finish_reason"] != "length" or len(o["output_ids"]) != max_new:
            raise AssertionError(f"request {o['rid']} did not complete: {m['finish_reason']}")
        if not all(math.isfinite(x) for x in m["output_logprobs"]):
            raise AssertionError(f"request {o['rid']}: NaN log-probs")
        if k and not (len(m["output_top_logprobs"]) == max_new
                      and all(len(v) == k for v, _ in m["output_top_logprobs"])):
            raise AssertionError(f"request {o['rid']}: top-{k} log-probs missing")
    if not eng.flush_cache():  # runs check_memory()
        raise AssertionError("engine not idle after a constrained serve")
    itl = [(r.finish_time - r.first_token_time) / max(len(r.full_output_ids()) - 1, 1)
           for r in reqs]
    ttft = [r.first_token_time - r.queue_time for r in reqs]
    n_tok = sum(len(o["output_ids"]) for o in outs)
    res = dict(mode="semi_pd" if semi_pd else "colocated", decode_graphs=not eager,
               requests=len(outs), output_tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
               make_request_s=make_s, ttft_p50_s=statistics.median(ttft),
               itl_p50_ms=1e3 * statistics.median(itl), decode_steps=decode_steps,
               jump_tokens=eng.scheduler.n_jump_tokens,
               graph_keys=sorted({len(k) for k in graphs.graphs}))
    return res, outs


def constrained_phase(eng, label, main_launches, smi):
    """Phase 4c on the 8B's fp8 engine: the decode step variants replayed
    against eager ones (``variant_steps``), then the mixed batch of 8
    requests (MIX_4C: prompts 256-1024, 48 new tokens) served colocated and
    semi-PD on graphs, colocated once more with eager decode steps (the
    same tokens), and a plain serve of the same prompts in each mode (the
    ITL and tok/s they are compared with); ``score`` of the served tokens
    against the serves' log-probs, ``encode`` of 4 prompts against their
    final-normed hidden states from an extend, normalized; the grammar
    compile seconds at the 128256-token vocabulary; only the path's two
    kernels launch."""
    import torch

    from semi_pd_tpu_torch.constrained import grammar
    from semi_pd_tpu_torch.kernels import KERNELS

    from semi_pd_tpu_torch.layers.attention import pool_attention

    t0 = time.monotonic()
    runner = eng.runner
    vocab = runner.model_config.vocab_size
    if not eng.flush_cache():
        raise AssertionError("engine not idle before phase 4c")
    # the packed decode's routing (the streaming serve before set its own;
    # a new routing drops the graphs: every key of the phase is captured here)
    runner.attention = pool_attention(runner.kv_cache.buffer)
    runner.step_counts = {"decode": 0, "extend": 0}
    for k in KERNELS.values():
        k.launches = 0
    # host seconds of the token-level state tables (each walks the 128256
    # token strings once per DFA state reached)
    tables = {"s": 0.0, "states": 0}
    state_table = grammar.TokenDFA.state_table

    def timed(self, state):
        new = state not in self._cache
        t1 = time.perf_counter()
        out = state_table(self, state)
        if new:
            tables["s"] += time.perf_counter() - t1
            tables["states"] += 1
        return out

    grammar.TokenDFA.state_table = timed
    try:
        eng.server_args = dataclasses.replace(eng.server_args,
                                              constrained_json_whitespace_pattern=JSON_WS_4C,
                                              disable_outlines_disk_cache=True)
        t1 = time.monotonic()
        gc_ = eng._get_grammar_compiler()
        vocab_s = time.monotonic() - t1
        compile_s = {}
        for kind, spec in (("regex", REGEX_4C), ("json_schema", json.dumps(SCHEMA_4C))):
            t1 = time.monotonic()
            tdfa = gc_.compile(kind, spec)
            tdfa.state_table(0)
            compile_s[kind] = time.monotonic() - t1
        steps_rows = variant_steps(eng, label)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                   for n in rng.integers(256, 1025, size=len(MIX_4C))]
        plain_mix = [(dict(ignore_eos=True), 0)] * len(MIX_4C)
        serves, outs = {}, {}
        for semi, eager, mix in ((False, False, MIX_4C), (False, True, MIX_4C),
                                 (True, False, MIX_4C), (False, False, plain_mix),
                                 (True, False, plain_mix)):
            r, out = constrained_serve(eng, semi, prompts, mix, eager=eager)
            key = ("plain_" if mix is plain_mix else "mixed_") + r["mode"] + (
                "_eager" if eager else "")
            serves[key], outs[key] = r, out
            print("constrained_serve " + json.dumps(dict(r, model=label, serve=key, gpu=smi)),
                  flush=True)
    finally:
        grammar.TokenDFA.state_table = state_table
    same_eager = float(np.mean([a["output_ids"] == b["output_ids"] for a, b in zip(
        outs["mixed_colocated"], outs["mixed_colocated_eager"])]))
    # score: the served tokens' log-probs from one teacher-forced extend,
    # against the serve's (the unconstrained requests: a jumped token has no
    # log-prob of its own)
    score_diff = 0.0
    for p, (sp, _), o in zip(prompts, MIX_4C, outs["mixed_colocated"]):
        if "regex" in sp or "json_schema" in sp:
            continue
        got = [lp for lp, _ in eng.score(input_ids=p + o["output_ids"],
                                         logprob_start_len=len(p))]
        want = o["meta_info"]["output_logprobs"]
        if len(got) != len(want):
            raise AssertionError(f"score: {len(got)} log-probs for {len(want)} served")
        score_diff = max(score_diff, float(np.max(np.abs(np.subtract(got, want)))))
    # encode, against the last tokens' final-normed hidden states of an
    # extend of the same prompts (step_with_hidden), normalized here
    emb = np.asarray(eng.encode(input_ids=prompts[:4]))
    reqs, hb, _ = eng._prefill_whole(prompts[:4])
    hidden = runner.step_with_hidden_host(hb)[2][: len(reqs)].float().cpu().numpy()
    for r in reqs:
        eng.scheduler._free_req_memory(r)
    ref = hidden / np.linalg.norm(hidden, axis=-1, keepdims=True)
    encode_diff = float(np.max(np.abs(emb - ref)))
    torch.cuda.synchronize()
    steps = dict(runner.step_counts)
    launches = {name: k.launches for name, k in KERNELS.items()}
    for k, v in launches.items():
        main_launches[k] += v
    want = expected_launches(runner, "aligned", False, steps)
    bad = {k: (n, want.get(k, 0)) for k, n in launches.items() if n != want.get(k, 0)}
    res = dict(model=label, gpu=smi, vocab=vocab, tokenizer_table_s=vocab_s,
               grammar_compile_s=compile_s, state_tables=tables,
               eager_same_tokens=same_eager, score_max_abs_diff=score_diff,
               score_tolerance=SCORE_TOL_4C, encode_shape=list(emb.shape),
               encode_max_abs_diff=encode_diff, encode_tolerance=ENCODE_TOL_4C,
               graph_pool_bytes=runner.graphs.pool_bytes(),
               graph_pool_reserve_bytes=runner._graph_pool_reserve(),
               steps=steps, launches={k: n for k, n in launches.items() if n},
               seconds=time.monotonic() - t0)
    print("constrained_phase " + json.dumps(res), flush=True)
    if bad:
        raise AssertionError(f"phase 4c launches (got, want): {bad}, steps {steps}")
    if same_eager != 1.0:
        raise AssertionError(f"the eager masked serve gave other tokens ({same_eager:.3f})")
    if not score_diff <= SCORE_TOL_4C:
        raise AssertionError(f"score vs the serve's log-probs: {score_diff} > {SCORE_TOL_4C}")
    if not (emb.shape == hidden.shape and np.isfinite(emb).all()
            and encode_diff <= ENCODE_TOL_4C):
        raise AssertionError(f"encode {emb.shape} vs the normalized hidden states "
                             f"{hidden.shape}: {encode_diff} > {ENCODE_TOL_4C}")
    return res


def spec_fallback_serve(eng, algo, prompts, main_launches, smi, label, max_new=24):
    """A speculating serve with one regex request among plain ones (phase
    4a): while it runs each round falls back to a plain decode step (the
    target's decode launches), after it the rounds resume; the regex output
    matches; launches as spec_serve's plus the fallback decodes'."""
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.runtime.scheduler import Scheduler
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner = eng.runner
    if not eng.flush_cache():
        raise AssertionError("engine not idle before the fallback serve")
    args = spec_server_args(False, algo, kv_cache_dtype=eng.server_args.kv_cache_dtype,
                            max_total_tokens=eng.server_args.max_total_tokens,
                            disable_outlines_disk_cache=True)
    eng.server_args = args
    eng.scheduler = Scheduler(args, runner)
    runner.draft_kv.buffer.zero_()
    runner.step_counts = {"decode": 0, "extend": 0}
    runner.spec_counts = {k: 0 for k in runner.spec_counts}
    for k in KERNELS.values():
        k.launches = 0
    sps = [dict(regex=REGEX_4C)] + [dict(ignore_eos=True)] * (len(prompts) - 1)
    t0 = time.monotonic()
    reqs = [eng.make_request(p, SamplingParams(max_new_tokens=max_new, temperature=0.0, **sp))
            for p, sp in zip(prompts, sps)]
    for r in reqs:
        eng.scheduler.add_request(r)
    eng._run_until_done(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    text = eng.tokenizer.decode(reqs[0].full_output_ids())
    steps, spec = dict(runner.step_counts), dict(runner.spec_counts)
    launches = {name: k.launches for name, k in KERNELS.items()}
    for k, v in launches.items():
        main_launches[k] += v
    L = runner.model_config.num_hidden_layers
    dec, ext = path_kernels(runner.kv_cache.buffer)
    draft_dec, draft_ext = path_kernels(runner.draft_kv.buffer)
    want = {ext: L * (steps["extend"] + spec["verify"]), dec: L * steps["decode"]}
    want[draft_dec] = want.get(draft_dec, 0) + spec["draft_decode"]
    want[draft_ext] = want.get(draft_ext, 0) + spec["draft_tree"]
    bad = {k: (n, want.get(k, 0)) for k, n in launches.items() if n != want.get(k, 0)}
    s = eng.scheduler
    res = dict(model=label, algo=algo, gpu=smi, requests=len(reqs), wall_s=wall,
               fallback_decode_steps=steps["decode"], rounds=s.n_spec_steps,
               accepted=s.n_spec_accepted, regex_text=text,
               regex_finish=reqs[0].finish_reason.value,
               launches={k: n for k, n in launches.items() if n})
    print("spec_fallback " + json.dumps(res), flush=True)
    if bad or not steps["decode"] or not spec["verify"]:
        raise AssertionError(f"fallback serve: launches (got, want) {bad}, steps {steps}, "
                             f"speculation steps {spec}")
    if reqs[0].finish_reason.value != "stop_token" or not grammar_ok(sps[0], text):
        raise AssertionError(f"fallback serve: regex output {text!r}")
    if not eng.flush_cache():
        raise AssertionError("engine not idle after the fallback serve")
    return res


def reward_phase(label, cfg, main_launches, smi, scores=True, reduced=None):
    """InternLM2's reward model at full width (tied, with its v_head): the
    rewards of 4 prompts (700, 300, 1500 and 37 tokens; ``Engine.encode``,
    the v_head on each last final-normed hidden state) and their input
    log-probs (``Engine.score``) through the kernels, then through the plain
    attention on the same engine, on random and on ``make_attentive``
    weights: each within the model gate of the plain version (in the
    gate's measure: the largest difference over the largest plain value),
    the attentive rewards moved past the gate by a zeroed attention. Only
    rpa_extend_aligned launches (encode and score are extend steps). A
    sequence classifier (``scores`` False) has no logits: its scores
    alone."""
    import torch

    from semi_pd_tpu_torch.kernels import KERNELS
    from semi_pd_tpu_torch.layers.attention import pool_attention
    from semi_pd_tpu_torch.runtime.engine import Engine

    t0 = time.monotonic()
    eng = Engine(bench_server_args(False, max_total_tokens=65536), cfg)
    runner = eng.runner
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (700, 300, 1500, 37)]
    kernels = runner.attention
    plain = pool_attention(runner.kv_cache.buffer, plain=True)

    def zeroed(*a, **kw):
        return torch.zeros_like(kernels(*a, **kw))

    def run(attention):
        runner.attention = attention
        try:
            rewards = np.asarray(eng.encode(input_ids=prompts), np.float64)
            lps = (np.concatenate([[lp for lp, _ in r] for r in eng.score(input_ids=prompts)])
                   if scores else np.ones(1))
        finally:
            runner.attention = kernels
        return rewards, lps

    res = dict(model=label, gpu=smi, params=sum(p.numel() for p in runner.model.parameters()),
               reduced=reduced)
    launches = collections.Counter()
    for attentive in (False, True):
        saved = make_attentive(runner.model) if attentive else {}
        try:
            for k in KERNELS.values():
                k.launches = 0
            rk, lk = run(kernels)
            launches.update({n: k.launches for n, k in KERNELS.items() if k.launches})
            rp, lp = run(plain)
            rz, _ = run(zeroed)
        finally:
            restore(runner.model, saved)
        key = "attentive" if attentive else "raw"
        res[key] = dict(
            rewards=rk[:, 0].tolist(), reward_rel_err=float(np.abs(rk - rp).max()
                                                          / np.abs(rp).max()),
            logprob_rel_err=float(np.abs(lk - lp).max() / np.abs(lp).max()),
            zero_moves_reward=float(np.abs(rz - rk).max() / np.abs(rp).max()))
        if (res[key]["reward_rel_err"] > MODEL_GATE or res[key]["logprob_rel_err"] > MODEL_GATE
                or not np.isfinite(rk).all()):
            raise AssertionError(f"{label}: kernels vs plain {res[key]}")
        if attentive and res[key]["zero_moves_reward"] <= MODEL_GATE:
            raise AssertionError(f"{label}: the rewards do not see the attention {res[key]}")
    if set(launches) != {"rpa_extend_aligned"}:
        raise AssertionError(f"{label}: other kernels launched: {launches}")
    for n, v in launches.items():
        main_launches[n] += v
    del eng.scheduler, eng.runner
    gc.collect()
    torch.cuda.empty_cache()
    print("reward " + json.dumps(dict(res, launches=dict(launches), seconds=time.monotonic() - t0)),
          flush=True)


# ------------------------------------------------------------ the image path
def text_ids(ids, model):
    """Random text ids without the image token (each of its occurrences
    would take an image's placeholders, and the prompt another image)."""
    tok = model.image_token_index
    return [t - 1 if t == tok else t for t in ids]


def vlm_image(model, rng, h=None, w=None):
    """A random normalized image [3, H, W] at the model's resolution (LLaVA's
    and Yi-VL's tower size; Qwen-VL: ``h`` x ``w``, 448 x 448 by default: 256
    merged tokens)."""
    if hasattr(model, "patchify"):
        h, w = h or 448, w or 448
    else:
        h = w = model.tower.image_size
    return rng.standard_normal((3, h, w), dtype=np.float32)


def vlm_prompts(eng, seed=0, max_len=3072):
    """The 32 prompts of ``prompts_for`` with one ``<image>`` token each, at
    a random position, and their images (Qwen-VL: the 9th a 672 x 448
    image, the rest 448 x 448)."""
    model = eng.runner.model
    rng = np.random.default_rng(seed + 100)
    prompts, images = [], []
    for i, ids in enumerate(prompts_for(eng.runner.model_config.vocab_size, max_len)):
        ids = text_ids(ids, model)
        at = int(rng.integers(0, len(ids)))
        prompts.append(ids[:at] + [model.image_token_index] + ids[at:])
        images.append(vlm_image(model, rng, 672, 448) if i == 8 and hasattr(model, "patchify")
                      else vlm_image(model, rng))
    return prompts, images


def vlm_model_prompts(eng):
    """Phase 3's four prompts (700, 300, 1500, 37 text tokens) on a
    vision-language model: an image in the first three (the second's
    first token, the first's and third's in their middle), none in the
    last."""
    model = eng.runner.model
    rng = np.random.default_rng(11)
    vocab = eng.runner.model_config.vocab_size
    out = []
    for n, at in ((700, 350), (300, 0), (1500, 750), (37, None)):
        ids = text_ids(rng.integers(0, vocab, size=n).tolist(), model)
        if at is None:
            out.append((ids, None))
        else:
            out.append((ids[:at] + [model.image_token_index] + ids[at:], vlm_image(model, rng)))
    return out


def image_gate(eng, label, smi):
    """The image gate (as C15's attention gate): one prompt of 40 text
    tokens (an instruction's length) with an image in its middle, with two
    different images, through
    the kernels in one extend step; the largest move of the logits at the
    prompt's last row between the two images, over the largest logit, must
    pass MODEL_GATE on the model phase's attentive weights (make_attentive:
    the towers' and projector's norms at 1); on the raw weights it is
    printed. Returns the attentive move."""
    import torch

    from semi_pd_tpu_torch.runtime.batch import build_extend_batch
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, sched = eng.runner, eng.scheduler
    model = runner.model
    rng = np.random.default_rng(12)
    ids = text_ids(rng.integers(0, runner.model_config.vocab_size, size=40).tolist(), model)
    ids = ids[:20] + [model.image_token_index] + ids[20:]
    res = dict(model=label, gpu=smi)
    for attentive in (False, True):
        saved = make_attentive(model) if attentive else {}
        reqs = []
        try:
            for img in (vlm_image(model, rng), vlm_image(model, rng)):
                r = eng.make_request(ids, SamplingParams(temperature=0.0), image_data=img)
                r.req_slot = runner.req_pool.alloc()
                pages = runner.page_allocator.alloc(-(-r.prompt_len // PAGE))
                r.pages = pages.tolist()
                runner.req_pool.write(r.req_slot, 0, pages)
                reqs.append(r)
            hb = build_extend_batch([(r, r.prompt_len) for r in reqs], runner.req_pool.page_table,
                                    PAGE, sched.t_buckets, sched.b_buckets, sched.p_buckets)
            with torch.inference_mode():
                lg = model(hb.to_device(runner.device), runner.kv_cache.buffer,
                           attention=runner.attention)[:2].float()
            move = float((lg[0] - lg[1]).abs().max() / lg[0].abs().max())
        finally:
            restore(model, saved)
            for r in reqs:
                runner.page_allocator.free(np.asarray(r.pages, np.int32))
                runner.req_pool.free(r.req_slot)
        res["attentive" if attentive else "raw"] = move
    print("image_gate " + json.dumps(res), flush=True)
    if not res["attentive"] > MODEL_GATE:
        raise AssertionError(f"{label}: another image moves the logits {res['attentive']:.3g} "
                             f"<= {MODEL_GATE} on attentive weights: the gate cannot see it")
    return res["attentive"]


def tower_time(eng, label, smi):
    """The vision tower's (and projector's) time per image on the card:
    ``encode_images`` of one image, CUDA events over 5 calls after one
    warm-up; tokens per image beside it."""
    import torch

    runner, model = eng.runner, eng.runner.model
    rng = np.random.default_rng(13)
    img = vlm_image(model, rng)
    if hasattr(model, "patchify"):
        patches, grid = model.patchify(img)
        call = lambda: runner.encode_images_patches(patches, grid)
    else:
        call = lambda: runner.encode_images(img[None])
    out = call()
    ms = cuda_ms(call, 5)
    tokens = int(np.prod(out.shape[:-1]))
    res = dict(model=label, gpu=smi, tower_ms=ms, tokens_per_image=tokens,
               dtype=str(out.dtype).replace("torch.", ""),
               image=list(img.shape))
    print("tower " + json.dumps(res), flush=True)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite image features")
    return res


def vlm_checks(eng, label, smi):
    """On the model phase's attentive weights, colocated, 16 greedy tokens
    each: a request with two images; an ``input_embeds`` request whose rows
    are the embedding rows of an ``input_ids`` request, which must give its
    tokens; and ROADMAP C19: the ids of an image prompt served first as
    text (the radix tree now holds their pages), then with image A, then
    with image B: B must give the tokens and log-probs it gives on a
    flushed cache, with nothing cached, and A other log-probs than B (the
    image reaches the output)."""
    import torch

    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, model = eng.runner, eng.runner.model
    rng = np.random.default_rng(14)
    vocab = runner.model_config.vocab_size
    sp = SamplingParams(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    tok = model.image_token_index
    saved = make_attentive(model)
    try:
        if not eng.flush_cache():
            raise AssertionError("engine not idle before the image checks")
        ids = text_ids(rng.integers(0, vocab, size=400).tolist(), model)
        two = eng.generate(input_ids=ids[:100] + [tok] + ids[100:300] + [tok] + ids[300:],
                           image_data=[vlm_image(model, rng), vlm_image(model, rng)],
                           sampling_params=sp)
        text = text_ids(rng.integers(0, vocab, size=300).tolist(), model)
        by_ids = eng.generate(input_ids=text, sampling_params=sp)["output_ids"]
        rows = model.embed[torch.as_tensor(text, device=runner.device)].float().cpu().numpy()
        by_rows = eng.generate(input_embeds=rows, sampling_params=sp)["output_ids"]
        img_ids = ids[:150] + [tok] + ids[150:]
        expanded = eng._expand_image_tokens(img_ids, vlm_image(model, np.random.default_rng(1)))
        eng.generate(input_ids=expanded, sampling_params=sp)  # the ids' pages in the tree
        lp = dict(sampling_params=sp, return_logprob=True)
        a = eng.generate(input_ids=img_ids, image_data=vlm_image(model, rng), **lp)
        img_b = vlm_image(model, rng)
        b = eng.generate(input_ids=img_ids, image_data=img_b, **lp)
        if not eng.flush_cache():
            raise AssertionError("engine not idle after the image checks")
        b_fresh = eng.generate(input_ids=img_ids, image_data=img_b, **lp)
    finally:
        restore(model, saved)
    res = dict(model=label, gpu=smi, two_images_tokens=len(two["output_ids"]),
               input_embeds_same_tokens=by_rows == by_ids,
               c19=dict(cached_tokens=b["meta_info"]["cached_tokens"],
                        warm_equals_fresh=(b["output_ids"] == b_fresh["output_ids"] and
                                           b["meta_info"]["output_logprobs"]
                                           == b_fresh["meta_info"]["output_logprobs"]),
                        a_b_tokens_differ=a["output_ids"] != b["output_ids"],
                        a_b_logprob_max_diff=float(np.max(np.abs(
                            np.subtract(a["meta_info"]["output_logprobs"],
                                        b["meta_info"]["output_logprobs"]))))))
    print("image_checks " + json.dumps(res), flush=True)
    if len(two["output_ids"]) != 16 or not res["input_embeds_same_tokens"]:
        raise AssertionError(f"{label}: {res}")
    c = res["c19"]
    if c["cached_tokens"] or not c["warm_equals_fresh"] or not c["a_b_logprob_max_diff"] > 0:
        raise AssertionError(f"{label}: C19 {c}")


def path_kernels(kv_cache):
    """The (decode, extend) builds serving a pool (PATH_KERNELS), by its
    kernel family and, for the families with a build per width, its width:
    Gemma-2's head_dim 256, MiniCPM3's latent 288."""
    from semi_pd_tpu_torch.ops.attention.rpa_common import kernel_family

    family = kernel_family(kv_cache)
    width = {"aligned": 256, "latent": 288}.get(family)
    return PATH_KERNELS[family + (str(width) if kv_cache.shape[-1] == width else "")]


def first_diffs(eng, prompts, a_runs, b_runs):
    """Share of requests with identical tokens in two serves, and for each
    other request its first differing position and the target's log-prob
    gap there between the two picks, from one extend over the prompt and
    the shared tokens (the kernels' routing; serve_witness.py reads the
    gap from each serve's own log-probs, which a speculating serve does not
    keep)."""
    import torch

    from semi_pd_tpu_torch.runtime.batch import build_extend_batch
    from semi_pd_tpu_torch.runtime.req import Req
    from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

    runner, sched = eng.runner, eng.scheduler
    if not eng.flush_cache():
        raise AssertionError("engine not idle before the gap extends")
    diffs = []
    for i, (a, b) in enumerate(zip(a_runs, b_runs)):
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        r = Req(rid=f"gap{i}", input_ids=prompts[i] + a[:d],
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-r.prompt_len // PAGE))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        hb = build_extend_batch([(r, r.prompt_len)], runner.req_pool.page_table, PAGE,
                                sched.t_buckets, sched.b_buckets, sched.p_buckets)
        with torch.inference_mode():
            logits = runner.model(hb.to_device(runner.device), runner.kv_cache.buffer,
                                  attention=runner.attention)
        lp = torch.log_softmax(logits[0].float(), -1)
        diffs.append(dict(req=i, first_diff=d, logprob_gap=float(abs(lp[a[d]] - lp[b[d]]))))
        runner.page_allocator.free(pages)
        runner.req_pool.free(r.req_slot)
    return dict(same_requests=1 - len(diffs) / len(a_runs), diffs=diffs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from semi_pd_tpu_torch.kernels import KERNELS, build_all, find_nvcc, sass_mma_counts
    from semi_pd_tpu_torch.runtime.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 checks in full float32
    torch.backends.cudnn.allow_tf32 = False

    # 1. setup
    t0 = time.monotonic()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    build_s = build_all()
    # each library once (an ALiBi instantiation's is its build's)
    builds = {n: k for n, k in KERNELS.items() if k.library is None}
    for kname, k in builds.items():  # each function's registers and spills
        for ln in k.build_log.splitlines():
            if ("Function properties" in ln or "registers" in ln or "spill" in ln
                    or "wgmma" in ln):
                print(f"ptxas {kname} {ln.strip()}")
    # tensor-core instructions per kernel library and function
    with ThreadPoolExecutor(len(builds)) as ex:
        sass = dict(zip(builds, ex.map(sass_mma_counts, builds.values())))
    for kname, counts in sass.items():
        print("sass " + json.dumps(dict(kernel=kname, mma=sum(counts.values()),
                                        functions=counts)))
    # the warpgroup (wgmma) kernels: registers, spills and HGMMA count of
    # each instantiation
    for kname, wg_fn in (("rpa_extend", "rpa_extend_wgmma_kernel"),
                         ("rpa_extend_aligned", "rpa_extend_wgmma_kernel"),
                         ("rpa_extend_merged", "rpa_extend_wgmma_kernel"),
                         ("rpa_extend_mla", "rpa_extend_mla_wgmma_kernel"),
                         ("rpa_extend_mla_288", "rpa_extend_mla_wgmma_kernel"),
                         ("rpa_extend_aligned_256", "rpa_extend_wgmma_kernel")):
        hgmma = sass_mma_counts(KERNELS[kname], op="HGMMA")
        for fn, props in ptxas_summary(KERNELS[kname].build_log).items():
            if wg_fn in fn:
                print("wgmma " + json.dumps(dict(kernel=kname, function=fn, **props,
                                                 hgmma=hgmma.get(fn))))
        if not [n for f, n in hgmma.items() if wg_fn in f] or not all(
                n for f, n in hgmma.items() if wg_fn in f):
            raise AssertionError(f"{kname}: HGMMA per function {hgmma}")
    # the _256 and _288 extends' two instantiations side by side, per (q, KV)
    # pair: registers, spills and HGMMA of TREE = false and TREE = true; the
    # TREE = false warpgroup functions must not spill (they did not before
    # the tree's instantiations were built beside them)
    tree_pairs = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float8_e4m3fn),
                  (torch.bfloat16, torch.float8_e5m2), (torch.float32, torch.float32)]
    for kname, props_of in (("rpa_extend_aligned_256", gqa_function_props),
                            ("rpa_extend_mla_288", latent_function_props)):
        hgmma = sass_mma_counts(KERNELS[kname], op="HGMMA")
        for dt, kdt in tree_pairs:
            row = dict(kernel=kname, dtype=dtype_name(dt), kv_dtype=dtype_name(kdt))
            for tree in (False, True):
                p = props_of(kname, "extend", dt, kdt, tree=tree)
                if not p:
                    raise AssertionError(f"{kname}: no TREE = {tree} function for "
                                         f"{row['dtype']}/{row['kv_dtype']}")
                row["tree" if tree else "causal"] = dict(p, hgmma=hgmma.get(p["function"]))
            print("tree_functions " + json.dumps(row), flush=True)
            c = row["causal"]
            if dt == torch.bfloat16 and (c.get("spill_stores") or c.get("spill_loads")):
                raise AssertionError(f"{kname}: the TREE = false function spills: {c}")
            if dt == torch.bfloat16 and not row["tree"]["hgmma"]:
                raise AssertionError(f"{kname}: no HGMMA in the TREE = true function")
    # the aligned decode's and extend's ALIBI = true functions beside their
    # ALIBI = false ones, per kind and (q, KV) pair: registers, spills and
    # tensor-core instructions
    for kind in ("decode", "extend"):
        alibi, base = f"rpa_{kind}_aligned_alibi", f"rpa_{kind}_aligned"
        for dt, kdt in tree_pairs:
            row = dict(kernel=alibi, kind=kind, dtype=dtype_name(dt), kv_dtype=dtype_name(kdt))
            for key, kname in (("alibi", alibi), ("without", base)):
                p = gqa_function_props(kname, kind, dt, kdt)
                if not p:
                    raise AssertionError(f"{kname}: no {kind} function for "
                                         f"{row['dtype']}/{row['kv_dtype']}")
                row[key] = dict(p, mma=sass[base].get(p["function"]))
            print("alibi_functions " + json.dumps(row), flush=True)
            if dt == torch.bfloat16 and not row["alibi"]["mma"]:
                raise AssertionError(f"{alibi}: no tensor-core instruction in {row['alibi']}")
    # the latent decodes' block tile (mma.sync): registers, spills and HMMA
    # count of each instantiation; a spill fails the run
    for kname, mma_fn in (("rpa_decode_mla", "rpa_decode_mla_mma_kernel"),
                          ("rpa_decode_stream_mla", "rpa_stream_mla_mma_kernel"),
                          ("rpa_decode_mla_288", "rpa_decode_mla_mma_kernel"),
                          ("rpa_decode_stream_mla_288", "rpa_stream_mla_mma_kernel")):
        for fn, props in ptxas_summary(KERNELS[kname].build_log).items():
            if mma_fn in fn:
                print("mla_mma " + json.dumps(dict(kernel=kname, function=fn, **props,
                                                   hmma=sass[kname].get(fn))))
                if props.get("spill_stores") or props.get("spill_loads"):
                    raise AssertionError(f"{kname}: {fn} spills: {props}")
    # the tensor-core kernel of each library that has one: HMMA (HGMMA in the
    # warpgroup kernels) in each of its bf16-q instantiations, none in the
    # CUDA-core kernel's float32 pair
    for kname, mma_fn, core_fn in (
            ("rpa_extend", "rpa_extend_wgmma_kernel", "rpa_extend_kernel"),
            ("rpa_extend_aligned", "rpa_extend_wgmma_kernel", "rpa_extend_kernel"),
            ("rpa_extend_mla", "rpa_extend_mla_wgmma_kernel", "rpa_extend_mla_kernel"),
            ("rpa_extend_merged", "rpa_extend_wgmma_kernel", "rpa_extend_kernel"),
            ("rpa_decode", "rpa_decode_mma_kernel", "rpa_decode_kernel"),
            ("rpa_decode_aligned", "rpa_decode_mma_kernel", "rpa_decode_kernel"),
            ("rpa_decode_merged", "rpa_decode_mma_kernel", "rpa_decode_kernel"),
            ("rpa_decode_stream", "rpa_stream_mma_kernel", "rpa_stream_kernel"),
            ("rpa_decode_stream_aligned", "rpa_stream_mma_kernel", "rpa_stream_kernel"),
            ("rpa_decode_mla", "rpa_decode_mla_mma_kernel", "rpa_decode_mla_kernel"),
            ("rpa_decode_stream_mla", "rpa_stream_mla_mma_kernel", "rpa_stream_mla_kernel"),
            ("rpa_extend_mla_288", "rpa_extend_mla_wgmma_kernel", "rpa_extend_mla_kernel"),
            ("rpa_decode_mla_288", "rpa_decode_mla_mma_kernel", "rpa_decode_mla_kernel"),
            ("rpa_decode_stream_mla_288", "rpa_stream_mla_mma_kernel",
             "rpa_stream_mla_kernel"),
            ("rpa_extend_aligned_256", "rpa_extend_wgmma_kernel", "rpa_extend_kernel"),
            ("rpa_decode_aligned_256", "rpa_decode_mma_kernel", "rpa_decode_kernel"),
            ("rpa_decode_stream_aligned_256", "rpa_stream_mma_kernel", "rpa_stream_kernel")):
        mma = [n for f, n in sass[kname].items() if mma_fn in f]
        core = [n for f, n in sass[kname].items() if core_fn in f]
        if not mma or not all(mma) or any(core):
            raise AssertionError(f"{kname}: HMMA/HGMMA per function {sass[kname]}")
    print("setup " + json.dumps(dict(
        gpu=smi, kind=name, torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None,
        python=sys.version.split()[0], build_s=build_s,
        seconds=time.monotonic() - t0)), flush=True)

    # 2. kernels against their plain versions
    t0 = time.monotonic()
    rows = phase_kernels()
    # the speculation cases: every extend with the tree's masks (spec_rows)
    # and the draft pool's decode
    spec = phase_spec_kernels()
    spec_rows = [r for r in spec if "spec_tree" in r]
    rows += [r for r in spec if "spec_tree" not in r]
    # the _288 builds at MiniCPM3-4B's geometry
    rows += phase_kernels_288()
    # the _256 builds at Gemma-2-9B's geometry
    rows += phase_kernels_256()
    # the aligned and _256 builds at G = 1 and 8 query heads per KV head
    rows += phase_kernels_heads()
    # G = 6 and 16, the merged builds at Hkv 36, the ALiBi instantiations
    rows += phase_kernels_variants()
    # the LayerNorm families' heads: G = 48, 9 and 71 (head groups past 16),
    # the merged pool at Hkv 20, the chunked pool at Hkv 32
    rows += phase_kernels_layernorm()
    # the image path's G = 7 and the Gemma-2 classifier's 32 / 16 at head_dim 128
    rows += phase_kernels_vlm()
    print("kernels_phase " + json.dumps(dict(cases=len(rows) + len(spec_rows),
                                             seconds=time.monotonic() - t0)), flush=True)

    # 3 and 4: full-width models and serving. Each path's launch counts are
    # those of its own serving run, counters zeroed just before each mode
    main_launches = {k: 0 for k in KERNELS}

    def model_phase(label, cfg, kv_dtype, eng=None, stream=False, tokenizer=None,
                    tokens=131072, reduced=None, **kw):
        """A new engine (or ``eng``, on its weights) and its model phase;
        ``tokenizer``: the new engine's (its grammar compiler and EOS);
        ``tokens``: its pool's size; ``reduced``: the cut printed with the
        line; ``kw``: phase_model's (prompt lengths, attentive weights)."""
        t0 = time.monotonic()
        if eng is None:
            eng = Engine(bench_server_args(False, kv_dtype, max_total_tokens=tokens), cfg,
                         tokenizer=tokenizer)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        res = phase_model(eng, stream, **kw)
        runner = eng.runner
        params = sum(p.numel() for p in runner.model.parameters())
        print("model " + json.dumps(dict(
            res, model=label, kv_dtype=kv_dtype, init_s=init_s, decode_stream=stream,
            params=params, weight_gib=runner.weight_bytes / 2 ** 30,
            kv_pool_slots=runner.kv_spec.num_slots,
            kv_pool_gib=runner.kv_spec.bytes_total() / 2 ** 30, reduced=reduced,
            seconds=time.monotonic() - t0)), flush=True)
        return eng

    def serve_phase(eng, label, pool, repeat=False, max_len=3072, eager=False):
        """Both modes; with ``repeat`` colocated once more, which must give
        the first run's tokens exactly (serving is deterministic); with
        ``eager`` colocated once more with the decode steps run eagerly,
        which must give the graph serve's tokens exactly. Returns the
        colocated run's tokens."""
        t0 = time.monotonic()
        outputs = []
        vocab = eng.runner.model_config.vocab_size
        runs = [(False, False), (True, False)] + ([(False, False)] if repeat else [])
        for semi, run_eager in runs + ([(False, True)] if eager else []):
            r, out = serve_mode(eng, semi, prompts_for(vocab, max_len), vocab, pool,
                                eager=run_eager)
            outputs.append(out)
            for k, v in r["launches"].items():
                main_launches[k] += v
            print("serve " + json.dumps(dict(r, model=label, gpu=smi)), flush=True)
        same = np.mean([a == b for a, b in zip(outputs[0], outputs[1])])
        res = dict(model=label, modes_same_tokens=float(same))
        if same < 1.0:  # the log-prob gap of each first difference (C8: near ties)
            res["first_diffs"] = first_diffs(eng, prompts_for(vocab, max_len), outputs[0],
                                             outputs[1])["diffs"]
        if repeat:
            res["repeat_same_tokens"] = float(np.mean(
                [a == b for a, b in zip(outputs[0], outputs[2])]))
        if eager:
            res["eager_same_tokens"] = float(np.mean(
                [a == b for a, b in zip(outputs[0], outputs[-1])]))
        print("serve_phase " + json.dumps(dict(res, seconds=time.monotonic() - t0)),
              flush=True)
        if repeat and res["repeat_same_tokens"] != 1.0:
            raise AssertionError(f"{label}: colocated served twice gave different tokens "
                                 f"({res['repeat_same_tokens']:.3f} of requests the same)")
        if eager and res["eager_same_tokens"] != 1.0:
            raise AssertionError(f"{label}: the eager colocated serve gave other tokens than "
                                 f"the graph serve ({res['eager_same_tokens']:.3f} the same)")
        return outputs[0]

    def stream_phase(eng, label, pool, kv_dtype, packed_tokens):
        """Path S on the same weights: the model phase with the streaming
        decode, then one colocated serve with decode_stream; prints the
        share of requests whose tokens equal the packed colocated run's."""
        model_phase(label, None, kv_dtype, eng=eng, stream=True)
        graph_phase(eng, label, pool, stream=True)
        vocab = eng.runner.model_config.vocab_size
        r, out = serve_mode(eng, False, prompts_for(vocab), vocab, pool, stream=True)
        for k, v in r["launches"].items():
            main_launches[k] += v
        same = float(np.mean([a == b for a, b in zip(out, packed_tokens)]))
        print("serve " + json.dumps(dict(r, model=label, gpu=smi,
                                         same_tokens_as_packed=same)), flush=True)
        if pool in LATENT and same != 1.0:  # the two latent decodes give the same bits
            raise AssertionError(f"{label}: the streaming decode's serve gave other tokens than "
                                 f"the packed decode's ({same:.3f} of requests the same)")

    def release(eng):
        del eng.scheduler, eng.runner
        gc.collect()
        torch.cuda.empty_cache()

    def spec_engine(algo, cfg=None, gain=EMBED_GAIN, tokenizer=None, **kw):
        """An Engine of its own for ``algo`` (spec_server_args; None: the
        bench's settings without speculation) on predictive weights: every
        one draws the same target weights from the seed, and EAGLE's draft
        from the seed + 1."""
        args = (spec_server_args(False, algo, **kw) if algo
                else dataclasses.replace(bench_server_args(False), **kw))
        eng = Engine(args, cfg or llama_1b_config(), tokenizer=tokenizer)
        make_predictive(eng.runner, gain)
        return eng

    def spec_phase(label):
        """The speculating serves (phase 4s), each algorithm on an Engine
        built for it: NGRAM, EAGLE chain and EAGLE tree, colocated and
        semi-PD, the tree colocated once more (its own tokens exactly) and
        once with its rounds run eagerly (the same tokens; the tree engine
        first runs the speculation model phase and phase 3r, its three
        round kinds), then the non-speculating serve on an Engine of its
        own for each embedding gain (SPEC_GAIN), which the serves on its
        weights are compared with (printed, not gated)."""
        t0 = time.monotonic()
        vocab = llama_1b_config().vocab_size
        prompts = prompts_for(vocab)
        runs = {}
        for algo in LLAMA_SPEC_ALGOS:
            eng = spec_engine(algo, gain=SPEC_GAIN[algo])
            if algo == "tree":
                phase_spec_model(eng, label)
                round_phase(eng, label, ("tree", "chain", "ngram"))
            tree_runs = ((False, False), (True, False)) + (
                ((False, False), (False, True)) if algo == "tree" else ())
            for semi, eager in tree_runs:
                r, out = spec_serve(eng, algo, semi, prompts, eager=eager)
                for k, v in r["launches"].items():
                    main_launches[k] += v
                key = f"{algo}_{r['mode']}"
                print("spec_serve " + json.dumps(dict(r, model=label, gpu=smi,
                                                      embed_gain=SPEC_GAIN[algo],
                                                      repeat=key in runs)), flush=True)
                if eager:
                    eager_same = float(np.mean([a == b for a, b in zip(runs[key], out)]))
                elif key in runs:
                    again = float(np.mean([a == b for a, b in zip(runs[key], out)]))
                else:
                    runs[key] = out
            release(eng)
        witness = {}
        for gain in sorted(set(SPEC_GAIN.values())):
            eng = spec_engine(None, gain=gain)
            r, plain = serve_mode(eng, False, prompts, vocab, "chunked")
            for k, v in r["launches"].items():
                main_launches[k] += v
            print("serve " + json.dumps(dict(r, model=label + " (no speculation)", gpu=smi,
                                             embed_gain=gain)), flush=True)
            witness.update({k: first_diffs(eng, prompts, plain, out) for k, out in runs.items()
                            if SPEC_GAIN[k.split("_")[0]] == gain})
            release(eng)
        print("spec_serve_phase " + json.dumps(dict(
            model=label, tree_repeat_same_tokens=again, tree_eager_same_tokens=eager_same,
            same_as_plain={k: w["same_requests"] for k, w in witness.items()},
            first_diffs={k: w["diffs"] for k, w in witness.items()},
            seconds=time.monotonic() - t0)), flush=True)
        if again != 1.0:
            raise AssertionError(f"{label}: the tree serve repeated gave other tokens "
                                 f"({again:.3f} of requests the same)")
        if eager_same != 1.0:
            raise AssertionError(f"{label}: the tree serve with eager rounds gave other "
                                 f"tokens than on round graphs ({eager_same:.3f} the same)")

    def spec_f32_gate():
        """Phase 4f: the float32 1B-class model (8 requests x 32 tokens,
        prompts 256-1024) on predictive weights, served with the EAGLE tree
        (drafts accepted) and, on an Engine of its own, without
        speculation: the tokens must be equal."""
        from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

        t0 = time.monotonic()
        cfg = llama_1b_config()
        cfg.dtype = "float32"
        prompts = prompts_for(cfg.vocab_size, 1024)[:8]
        eng = spec_engine("tree", cfg, max_total_tokens=32768)
        r, spec_out = spec_serve(eng, "tree", False, prompts, max_new=32)
        for k, v in r["launches"].items():
            main_launches[k] += v
        release(eng)
        eng = spec_engine(None, cfg, max_total_tokens=32768)
        outs = eng.generate(input_ids=prompts, sampling_params=SamplingParams(
            max_new_tokens=32, temperature=0.0, ignore_eos=True))
        plain = [o["output_ids"] for o in outs]
        release(eng)
        same = float(np.mean([a == b for a, b in zip(spec_out, plain)]))
        print("spec_f32 " + json.dumps(dict(r, model="llama-3.2-1b-class float32", gpu=smi,
                                            same_as_plain=same,
                                            seconds=time.monotonic() - t0)), flush=True)
        if same != 1.0:
            raise AssertionError(f"float32: the tree serve's tokens differ from the plain "
                                 f"serve's ({same:.3f} of requests the same)")

    def target_spec_phase(phase, label, cfg, algos, eager=False, gain=EMBED_GAIN,
                          fallback_tokenizer=None, reduced=None, **kw):
        """A full-width target speculating with its draft (EAGLE's or
        NextN's, as the runner picks it), each algorithm of ``algos`` (the
        tree first) on an Engine of its own on predictive weights (the
        embedding x ``gain``; ``kw``: more server settings, the KV dtype):
        the tree engine first runs the
        speculation model phase (a tree and a chain round, kernels vs plain
        attention) and phase 3r (its tree and chain rounds replayed against
        eager ones), then each algorithm serves the 32 prompts colocated
        and semi-PD on round graphs, and with ``eager`` the tree colocated
        once more with its rounds run eagerly, which must give the same
        tokens; every serve fails if no draft was accepted. With
        ``fallback_tokenizer`` the tree engine (built with it) then serves 8
        requests, one of them under a regex, which falls back to plain
        decode steps while it runs (``spec_fallback_serve``). Ends with the
        line ``phase``."""
        t0 = time.monotonic()
        prompts = prompts_for(cfg.vocab_size)
        for algo in algos:
            t1 = time.monotonic()
            tree = algo.endswith("tree")
            eng = spec_engine(algo, cfg, gain=gain,
                              tokenizer=fallback_tokenizer if tree else None, **kw)
            torch.cuda.synchronize()
            init_s = time.monotonic() - t1
            if tree:
                phase_spec_model(eng, label)
                round_phase(eng, label, ("tree", "chain"))
            outs = []
            for semi, run_eager in ((False, False), (True, False)) + (
                    ((False, True),) if tree and eager else ()):
                r, out = spec_serve(eng, algo, semi, prompts, eager=run_eager)
                outs.append(out)
                for k, v in r["launches"].items():
                    main_launches[k] += v
                print("spec_serve " + json.dumps(dict(r, model=label, gpu=smi,
                                                      embed_gain=gain, init_s=init_s,
                                                      draft_gib=eng.runner.draft_weight_bytes
                                                      / 2 ** 30)), flush=True)
            if len(outs) == 3:
                same = float(np.mean([a == b for a, b in zip(outs[0], outs[2])]))
                print("spec_eager " + json.dumps(dict(model=label, algo=algo,
                                                      same_tokens=same)), flush=True)
                if same != 1.0:
                    raise AssertionError(f"{label} {algo}: the serve with eager rounds gave "
                                         f"other tokens than on round graphs ({same:.3f})")
            if tree and fallback_tokenizer is not None:
                spec_fallback_serve(eng, algo, prompts_for(cfg.vocab_size, 1024)[:8],
                                    main_launches, smi, label)
            release(eng)
        print(phase + " " + json.dumps(dict(model=label, reduced=reduced,
                                            seconds=time.monotonic() - t0)),
              flush=True)

    def nextn_phase():
        """Phase 4n: DeepSeek-V2-Lite at full width speculating with NextN
        (one MoE layer, its latent draft pool), NEXTN tree and chain."""
        target_spec_phase("nextn_phase", "deepseek-v2-lite nextn",
                          deepseek_v2_lite_config(num_hidden_layers=SPEC_LAYERS["deepseek"]),
                          ("nextn_tree", "nextn_chain"), eager=True,
                          reduced=f"{SPEC_LAYERS['deepseek']} of 27 layers")

    def spec_plain_gate(label, cfg, algo, prompts, max_total_tokens):
        """Phases 4af, 4mf and 4ef: a tree serve of ``prompts`` (32 greedy tokens
        each) on the float32 ``cfg`` at a small depth, on predictive
        weights, through the kernels (spec_serve: its launch checks, drafts
        accepted), then on the same engine and weights through the plain
        attention, target and draft pool: the tokens must be equal."""
        from semi_pd_tpu_torch.layers.attention import pool_attention
        from semi_pd_tpu_torch.runtime.scheduler import Scheduler
        from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

        t0 = time.monotonic()
        eng = spec_engine(algo, cfg, max_total_tokens=max_total_tokens)
        r, kern = spec_serve(eng, algo, False, prompts, max_new=32)
        for k, v in r["launches"].items():
            main_launches[k] += v
        runner = eng.runner
        runner.attention = pool_attention(runner.kv_cache.buffer, plain=True)
        runner.draft_attention = pool_attention(runner.draft_kv.buffer, plain=True)
        runner.graphs = runner.round_graphs = None  # the plain versions read the host
        eng.scheduler = Scheduler(eng.server_args, runner)
        outs = eng.generate(input_ids=prompts, sampling_params=SamplingParams(
            max_new_tokens=32, temperature=0.0, ignore_eos=True))
        plain = [o["output_ids"] for o in outs]
        plain_accepted = eng.scheduler.n_spec_accepted
        release(eng)
        same = float(np.mean([a == b for a, b in zip(kern, plain)]))
        print("spec_f32 " + json.dumps(dict(r, model=label, gpu=smi, same_as_plain=same,
                                            plain_accepted=plain_accepted,
                                            seconds=time.monotonic() - t0)), flush=True)
        if same != 1.0:
            raise AssertionError(f"{label}: the tree serve's tokens through the kernels differ "
                                 f"from the plain attention's ({same:.3f} of requests the same)")

    def nextn_f32_gate():
        """Phase 4nf: DeepSeek-V2-Lite in float32 at NEXTN_F32_LAYERS layers
        (8 requests x 32 tokens, prompts 256-1024) on predictive weights,
        served with the NextN tree (drafts accepted) and, on an Engine of
        its own, without speculation: the tokens must be equal."""
        from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

        t0 = time.monotonic()
        cfg = deepseek_v2_lite_config()
        cfg.dtype = "float32"
        cfg.num_hidden_layers = NEXTN_F32_LAYERS
        prompts = prompts_for(cfg.vocab_size, 1024)[:8]
        eng = spec_engine("nextn_tree", cfg, max_total_tokens=32768)
        r, spec_out = spec_serve(eng, "nextn_tree", False, prompts, max_new=32)
        for k, v in r["launches"].items():
            main_launches[k] += v
        release(eng)
        eng = spec_engine(None, cfg, max_total_tokens=32768)
        outs = eng.generate(input_ids=prompts, sampling_params=SamplingParams(
            max_new_tokens=32, temperature=0.0, ignore_eos=True))
        plain = [o["output_ids"] for o in outs]
        release(eng)
        same = float(np.mean([a == b for a, b in zip(spec_out, plain)]))
        print("spec_f32 " + json.dumps(dict(r, model=f"deepseek-v2-lite float32 "
                                            f"{NEXTN_F32_LAYERS} layers", gpu=smi,
                                            same_as_plain=same,
                                            seconds=time.monotonic() - t0)), flush=True)
        if same != 1.0:
            raise AssertionError(f"float32 V2-Lite: the NextN tree serve's tokens differ from "
                                 f"the plain serve's ({same:.3f} of requests the same)")

    def long_serve(eng, label):
        """Phase 4l: 8 requests of 4500-7000 prompt tokens, 64 greedy new
        tokens each, colocated and semi-PD: the prefill takes two chunks of
        up to 4096 a request, so the windowed layers cut in the second
        chunk and in every decode step; TTFT, ITL and tok/s per mode."""
        t0 = time.monotonic()
        vocab = eng.runner.model_config.vocab_size
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                   for n in rng.integers(4500, 7001, size=8)]
        outs = []
        for semi in (False, True):
            r, out = serve_mode(eng, semi, prompts, vocab, "aligned256")
            outs.append(out)
            for k, v in r["launches"].items():
                main_launches[k] += v
            print("serve_long " + json.dumps(dict(
                r, model=label, gpu=smi, prompt_tokens=[len(p) for p in prompts])), flush=True)
        same = float(np.mean([a == b for a, b in zip(*outs)]))
        print("serve_long_phase " + json.dumps(dict(model=label, modes_same_tokens=same,
                                                    seconds=time.monotonic() - t0)), flush=True)

    def gemma2_f32_gate():
        """Phase 4g: Gemma-2-9B in float32 at 4 layers, full widths (8
        requests x 32 greedy tokens, prompts of 4500-6000: the windowed
        layers cut in the second prefill chunk and in decode), served
        through the kernels (decode replayed from graphs), then on the same
        weights and engine through the plain attention (eagerly): the
        tokens must be equal."""
        from semi_pd_tpu_torch.layers.attention import pool_attention
        from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

        t0 = time.monotonic()
        cfg = gemma2_9b_config(num_hidden_layers=4, dtype="float32")
        eng = Engine(dataclasses.replace(bench_server_args(False), max_total_tokens=65536), cfg)
        runner = eng.runner
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(4500, 6001, size=8)]
        sp = SamplingParams(max_new_tokens=32, temperature=0.0, ignore_eos=True)
        for k in KERNELS.values():
            k.launches = 0
        outs = eng.generate(input_ids=prompts, sampling_params=sp)
        launches = {k: n.launches for k, n in KERNELS.items() if n.launches}
        for k, v in launches.items():
            main_launches[k] += v
        kern = [o["output_ids"] for o in outs]
        graphs = runner.graphs
        runner.attention = pool_attention(runner.kv_cache.buffer, plain=True)
        runner.graphs = None
        try:
            outs = eng.generate(input_ids=prompts, sampling_params=sp)
        finally:
            runner.graphs = graphs
        plain = [o["output_ids"] for o in outs]
        release(eng)
        same = float(np.mean([a == b for a, b in zip(kern, plain)]))
        print("gemma2_f32 " + json.dumps(dict(
            model="gemma-2-9b float32 4 layers", gpu=smi, launches=launches,
            same_as_plain=same, seconds=time.monotonic() - t0)), flush=True)
        if set(launches) != {"rpa_decode_aligned_256", "rpa_extend_aligned_256"}:
            raise AssertionError(f"float32 Gemma-2: other kernels launched: {launches}")
        if same != 1.0:
            raise AssertionError(f"float32 Gemma-2: the kernels' tokens differ from the plain "
                                 f"attention's ({same:.3f} of requests the same)")

    eng = model_phase("llama-3.2-1b-class", llama_1b_config(), "auto")
    # every path's gate once more on attentive weights (C15)
    model_phase("llama-3.2-1b-class", None, "auto", eng=eng, attentive=True)
    graph_phase(eng, "llama-3.2-1b-class", "chunked")
    packed = serve_phase(eng, "llama-3.2-1b-class", "chunked", repeat=True, eager=True)
    stream_phase(eng, "llama-3.2-1b-class", "chunked", "auto", packed)
    release(eng)
    # the speculating engines on the 1B-class model: NGRAM, EAGLE chain and
    # EAGLE tree (topk 4, 4 draft tokens), the draft drawn from the seed + 1
    spec_phase("llama-3.2-1b-class spec")
    spec_f32_gate()
    # the 1B-class model with fp8_e4m3 KV on the chunked pool
    label = "llama-3.2-1b-class fp8_e4m3"
    eng = model_phase(label, llama_1b_config(), "fp8_e4m3")
    graph_phase(eng, label, "chunked")
    packed = serve_phase(eng, label, "chunked")
    stream_phase(eng, label, "chunked", "fp8_e4m3", packed)
    release(eng)
    release(model_phase("meta-llama-3-8b", llama3_8b_config(), "bfloat16"))
    # the 8B engine gets a tokenizer object over its 128256 ids (phase 4c's
    # grammar compiler and EOS; the other serves ignore EOS)
    tok8b = SmokeTokenizer(llama3_8b_config().vocab_size)
    eng = model_phase("meta-llama-3-8b", llama3_8b_config(), "fp8_e4m3", tokenizer=tok8b)
    model_phase("meta-llama-3-8b", None, "fp8_e4m3", eng=eng, attentive=True)
    graph_phase(eng, "meta-llama-3-8b", "aligned")
    packed = serve_phase(eng, "meta-llama-3-8b", "aligned")
    stream_phase(eng, "meta-llama-3-8b", "aligned", "fp8_e4m3", packed)
    # constrained and penalized sampling, top-k, score and encode (4c)
    constrained_phase(eng, "meta-llama-3-8b fp8_e4m3", main_launches, smi)
    release(eng)  # the 8B model's 16 GB go before V2-Lite's 31 GB arrive
    # Meta-Llama-3-8B speculating with the EAGLE draft (a llama layer at its
    # geometry over a one-layer 5D pool at head_dim 128) on fp8_e4m3 KV, tree
    # and chain (phases 3s, 3r, 4a; the tree engine also serves a regex
    # request, which falls back to plain decode), then its float32 gate at 4
    # layers (4af)
    cfg = llama3_8b_config()
    cfg.num_hidden_layers = SPEC_LAYERS["llama3_8b"]
    target_spec_phase("llama3_8b_spec_phase", "meta-llama-3-8b eagle fp8_e4m3",
                      cfg, ("tree", "chain"), gain=LLAMA3_8B_GAIN,
                      fallback_tokenizer=tok8b, kv_cache_dtype="fp8_e4m3",
                      reduced=f"{SPEC_LAYERS['llama3_8b']} of 32 layers")
    cfg = llama3_8b_config()
    cfg.dtype, cfg.num_hidden_layers = "float32", 4
    spec_plain_gate("meta-llama-3-8b float32 4 layers eagle tree", cfg, "tree",
                    prompts_for(cfg.vocab_size, 1024)[:8], 32768)
    eng = model_phase("deepseek-v2-lite", deepseek_v2_lite_config(), "auto")
    model_phase("deepseek-v2-lite", None, "auto", eng=eng, attentive=True)
    graph_phase(eng, "deepseek-v2-lite", "latent")
    packed = serve_phase(eng, "deepseek-v2-lite", "latent", repeat=True, eager=True)
    stream_phase(eng, "deepseek-v2-lite", "latent", "auto", packed)
    release(eng)  # the bf16 latent pool and weights go before the fp8 twin's arrive
    # DeepSeek-V2-Lite with fp8_e4m3 latent rows, packed and streamed
    label = "deepseek-v2-lite fp8_e4m3"
    eng = model_phase(label, deepseek_v2_lite_config(), "fp8_e4m3")
    graph_phase(eng, label, "latent")
    packed = serve_phase(eng, label, "latent")
    stream_phase(eng, label, "latent", "fp8_e4m3", packed)
    release(eng)
    # MiniCPM3-4B on the 288-wide latent pool (the _288 builds), bf16 and
    # fp8_e4m3 rows, packed and streamed; its longrope factors are stand-ins
    print("minicpm3_rope " + json.dumps(dict(minicpm3_4b_config().rope_scaling,
                                             factor_lists="stand-ins")), flush=True)
    for kv_dtype in ("auto", "fp8_e4m3"):
        label = "minicpm3-4b" + ("" if kv_dtype == "auto" else f" {kv_dtype}")
        eng = model_phase(label, minicpm3_4b_config(), kv_dtype)
        if kv_dtype == "auto":
            model_phase(label, None, kv_dtype, eng=eng, attentive=True)
        graph_phase(eng, label, "latent288")
        packed = serve_phase(eng, label, "latent288")
        stream_phase(eng, label, "latent288", kv_dtype, packed)
        release(eng)
    # DeepSeek-V2-Lite speculating with its NextN draft (phases 4n, 4nf)
    nextn_phase()
    nextn_f32_gate()
    release(model_phase("tinyllama-1.1b", tinyllama_config(), "fp8_e4m3"))
    eng = model_phase("tinyllama-1.1b", tinyllama_config(), "auto")
    model_phase("tinyllama-1.1b", None, "auto", eng=eng, attentive=True)
    graph_phase(eng, "tinyllama-1.1b", "merged")
    serve_phase(eng, "tinyllama-1.1b", "merged", max_len=2048 - 64)
    release(eng)
    # Gemma-2-9B on the 5D pool at head_dim 256 (the _256 builds): bf16 KV
    # with its graphs, both modes, decode_stream and the long prompts; then
    # fp8_e4m3 KV; then the float32 gate at 4 layers
    label = "gemma-2-9b"
    eng = model_phase(label, gemma2_9b_config(), "auto")
    model_phase(label, None, "auto", eng=eng, attentive=True)
    graph_phase(eng, label, "aligned256")
    packed = serve_phase(eng, label, "aligned256")
    stream_phase(eng, label, "aligned256", "auto", packed)
    long_serve(eng, label)
    release(eng)
    label = "gemma-2-9b fp8_e4m3"
    eng = model_phase(label, gemma2_9b_config(), "fp8_e4m3")
    graph_phase(eng, label, "aligned256")
    serve_phase(eng, label, "aligned256")
    release(eng)
    gemma2_f32_gate()
    # speculation over a chain and a tree on the two targets whose tree
    # verify takes the _288 and the _256 extend's TREE instantiations: NextN
    # on MiniCPM3-4B (phases 4m, 4mf) and EAGLE on Gemma-2-9B (4e, 4ef); the
    # float32 gates at 4 layers, Gemma-2's with prompts past its window
    target_spec_phase("minicpm3_spec_phase", "minicpm3-4b nextn",
                      minicpm3_4b_config(num_hidden_layers=SPEC_LAYERS["minicpm3"]),
                      ("nextn_tree", "nextn_chain"),
                      reduced=f"{SPEC_LAYERS['minicpm3']} of 62 layers")
    cfg = minicpm3_4b_config(dtype="float32", num_hidden_layers=4)
    spec_plain_gate("minicpm3-4b float32 4 layers nextn tree", cfg, "nextn_tree",
                    prompts_for(cfg.vocab_size, 1024)[:8], 32768)
    target_spec_phase("gemma2_spec_phase", "gemma-2-9b eagle",
                      gemma2_9b_config(num_hidden_layers=SPEC_LAYERS["gemma2"]),
                      ("tree", "chain"), reduced=f"{SPEC_LAYERS['gemma2']} of 42 layers")
    rng = np.random.default_rng(6)
    spec_plain_gate("gemma-2-9b float32 4 layers eagle tree",
                    gemma2_9b_config(num_hidden_layers=4, dtype="float32"), "tree",
                    [rng.integers(0, 256000, size=int(n)).tolist()
                     for n in rng.integers(4500, 6001, size=8)], 65536)

    # the Llama-family strings, Gemma-1 and the GQA MoE families at full
    # width and depth, from their published config.json (PUBLISHED): phases
    # 3, 3g and 4, each model phase once more on attentive weights (C15)
    def family_path(label, cfg, kv_dtype, pool, tokens=131072, stream=False, max_len=3072,
                    lens=(700, 300, 1500, 37), model_stream=False):
        """Phases 3 (raw and attentive weights), 3g and 4; ``stream``: Path S
        too; ``model_stream``: phase 3 once more with decode_stream."""
        eng = model_phase(label, cfg, kv_dtype, tokens=tokens, lens=lens)
        model_phase(label, None, kv_dtype, eng=eng, attentive=True, lens=lens)
        if model_stream:
            model_phase(label, None, kv_dtype, eng=eng, stream=True, lens=lens)
        graph_phase(eng, label, pool)
        packed = serve_phase(eng, label, pool, max_len=max_len)
        if stream:
            stream_phase(eng, label, pool, kv_dtype, packed)
        release(eng)

    family_path("qwen3-8b", published_config("Qwen/Qwen3-8B"), "auto", "aligned")
    family_path("qwen3-8b fp8_e4m3", published_config("Qwen/Qwen3-8B"), "fp8_e4m3", "aligned",
                stream=True)
    family_path("qwen1.5-moe-a2.7b", published_config("Qwen/Qwen1.5-MoE-A2.7B"), "auto",
                "aligned")
    # Gemma-7B's KV is 448 KiB a token in bf16: 65536 tokens (28 GiB) beside
    # its 16 GiB of weights; 131072 in fp8_e4m3
    gemma7b = "google/gemma-7b"
    family_path("gemma-7b", published_config(gemma7b), "auto", "aligned256", tokens=65536)
    family_path("gemma-7b fp8_e4m3", published_config(gemma7b), "fp8_e4m3", "aligned256")
    family_path("olmoe-1b-7b", published_config("allenai/OLMoE-1B-7B-0924", context_length=4096),
                "auto", "aligned")

    # phase 3 alone at published widths and cut depths: Mistral-7B at 8 of 32
    # layers with prompts past its 4096 window (prefilled in chunks of 4096:
    # the window cuts in the second chunk and in decode), Mixtral-8x7B and
    # Qwen3-30B-A3B
    def model_only(label, cfg, reduced=None, lens=(700, 300, 1500, 37), gate=MODEL_GATE,
                   tokens=131072):
        eng = model_phase(label, cfg, "auto", reduced=reduced, lens=lens, gate=gate,
                          tokens=tokens)
        model_phase(label, None, "auto", eng=eng, reduced=reduced, lens=lens, attentive=True,
                    gate=gate)
        release(eng)

    model_only("mistral-7b-v0.1", published_config("mistralai/Mistral-7B-v0.1",
                                                   num_hidden_layers=8),
               lens=(5000, 4200, 1500, 37), reduced="8 of 32 layers")
    model_only("mixtral-8x7b-v0.1", published_config("mistralai/Mixtral-8x7B-v0.1",
                                                     num_hidden_layers=4),
               reduced="4 of 32 layers (the whole model is 93 GB in bf16)")
    model_only("qwen3-30b-a3b", published_config("Qwen/Qwen3-30B-A3B", num_hidden_layers=8),
               reduced="8 of 48 layers")
    # Gemma-7B's kernels vs plain in float32 (its bf16 gate reads the
    # largest error of any path, 3-3.5%): summation order alone
    model_only("gemma-7b float32", published_config(gemma7b, num_hidden_layers=4,
                                                    dtype="float32"),
               reduced="4 of 28 layers, float32", gate=1e-3)

    # the Llama-computation variants (the JAX package's llama_variants.py,
    # glm.py, phi3.py, granite.py, grok.py) from their published config.json
    # (PUBLISHED): ChatGLM3-6B (G = 16), Baichuan2-13B (ALiBi: the aligned
    # builds' ALiBi instantiations; its bf16 KV is 800 KiB a token, so a
    # 57344-token pool beside its 27.8 GB of weights), MiniCPM-2B (the
    # merged builds at 36 KV heads; context 2048) and deepseek-moe-16b
    # (dense first layer, 64 experts top-6 and 2 shared; every layer holds
    # both stacks) at full depth through phases 3, 3g and 4
    P = "baichuan-inc/Baichuan2-13B-Chat"
    family_path("chatglm3-6b", published_config("THUDM/chatglm3-6b"), "auto", "aligned")
    family_path("baichuan2-13b-chat", published_config(P, context_length=4096), "auto",
                "aligned_alibi", tokens=57344)
    family_path("minicpm-2b", published_config("openbmb/MiniCPM-2B-sft-bf16",
                                               context_length=2048), "auto", "merged",
                max_len=2048 - 64)
    family_path("deepseek-moe-16b", published_config("deepseek-ai/deepseek-moe-16b-base",
                                                     context_length=4096), "auto", "aligned",
                tokens=98304)
    # InternLM2-7B's reward model: its scores (encode) and input log-probs
    # (score) through the kernels against the plain attention
    reward_phase("internlm2-7b-reward", published_config("internlm/internlm2-7b-reward"),
                 main_launches, smi)
    # phase 3 alone at a quarter of their depth (the script's run has to stay
    # inside its time limit as the families grow): InternLM2-20B (G = 6),
    # GLM-4-9B (G = 16; then fp8_e4m3 KV through the streaming decode),
    # EXAONE-3.0-7.8B, Qwen-7B and Baichuan2-7B (multi-head: 512 KiB of bf16
    # KV a token, so 65536-token pools), Phi-3-medium-4k (prompts past its
    # 2047 window), Granite-3.0-8B (its four multipliers); Grok-1 at 4 of 64
    # layers
    def cut(repo, of, **kw):
        """``repo``'s published config at a quarter of its ``of`` layers."""
        return published_config(repo, num_hidden_layers=of // 4, **kw), f"{of // 4} of {of} layers"

    cfg, red = cut("internlm/internlm2-20b", 48)
    model_only("internlm2-20b", cfg, reduced=red, tokens=65536)
    glm4, red = cut("THUDM/glm-4-9b-chat", 40)
    model_only("glm-4-9b-chat", glm4, reduced=red)
    release(model_phase("glm-4-9b-chat fp8_e4m3", glm4, "fp8_e4m3", stream=True, reduced=red))
    model_only("exaone-3.0-7.8b", *cut("LGAI-EXAONE/EXAONE-3.0-7.8B-Instruct", 32))
    cfg, red = cut("Qwen/Qwen-7B", 32)
    model_only("qwen-7b", cfg, reduced=red, tokens=65536)
    cfg, red = cut("baichuan-inc/Baichuan2-7B-Base", 32, context_length=4096)
    model_only("baichuan2-7b", cfg, reduced=red, tokens=65536)
    cfg, red = cut("microsoft/Phi-3-medium-4k-instruct", 40, context_length=4096)
    model_only("phi-3-medium-4k", cfg, reduced=red, lens=(2600, 300, 1500, 37))
    model_only("granite-3.0-8b", *cut("ibm-granite/granite-3.0-8b-instruct", 40,
                                      context_length=4096))
    model_only("grok-1", published_config("xai-org/grok-1", num_hidden_layers=4),
               reduced="4 of 64 layers (one layer's experts are 9.7 GB in bf16)")

    # the LayerNorm families (the JAX package's layernorm_families.py,
    # gpt2.py, olmo_falcon_dbrx.py) from their published config.json
    # (PUBLISHED_LN), served at full depth through phases 3, 3g and 4:
    # StarCoder (multi-query G = 48 on the aligned pool: three head groups
    # a KV head; 31 GB of weights; phase 3 also with decode_stream),
    # Falcon-7B (G = 71 over one 64-element slot row on the merged pool,
    # parallel attention), StableLM-2-1.6B (the chunked pool at Hkv 32;
    # phase 3 also streamed), GPT-2-large (the merged pool at Hkv 20, its
    # 1024 learned positions: context 1024, prompts under it)
    family_path("starcoder", published_config("bigcode/starcoder"), "auto", "aligned",
                model_stream=True)
    family_path("falcon-7b", published_config("tiiuae/falcon-7b", context_length=2048),
                "auto", "merged", max_len=2048 - 64)
    family_path("stablelm-2-1.6b", published_config("stabilityai/stablelm-2-1_6b",
                                                    context_length=4096),
                "auto", "chunked", model_stream=True)
    family_path("gpt2-large", published_config("openai-community/gpt2-large",
                                               context_length=1024),
                "auto", "merged", max_len=1024 - 64, lens=(700, 300, 900, 37))
    # phase 3 alone, full depth: phi-1_5 (parallel block, chunked pool),
    # aya-23-8B (Cohere: 256000 vocab, tied, logit scale 1/16), OLMo-2-7B
    # (G = 1, full-width q/k norms; multi-head: 512 KiB of bf16 KV a token,
    # so a 65536-token pool), OLMo-1B, Phi-3-small-8k (muP, gegelu);
    # DBRX at 4 of 40 layers (16 experts top-4, clip_qkv 8, G = 6)
    model_only("phi-1_5", published_config("microsoft/phi-1_5", context_length=2048),
               lens=(700, 300, 1500, 37))
    model_only("aya-23-8b", published_config("CohereForAI/aya-23-8B"))
    model_only("olmo-2-1124-7b", published_config("allenai/OLMo-2-1124-7B",
                                                  context_length=4096), tokens=65536)
    model_only("olmo-1b", published_config("allenai/OLMo-1B-hf", context_length=2048))
    model_only("phi-3-small-8k", published_config("microsoft/Phi-3-small-8k-instruct"))
    model_only("dbrx-base", published_config("databricks/dbrx-base", num_hidden_layers=4),
               reduced="4 of 40 layers (one layer's experts are 6.3 GB in bf16)")

    # the image path (the JAX package's vision.py, llava.py, qwen2_vl.py) from
    # PUBLISHED_VLM at full depth: LLaVA-1.5-7B (CLIP ViT-L/14-336, 576
    # tokens an image, float32 tower; Llama-2-7B at 32 / 32 heads: 512 KiB of
    # bf16 KV a token, a 65536-token pool) and Qwen2-VL-7B (G = 7, M-RoPE;
    # its 32768 window never cuts at this context, and left out it lets
    # decode_stream reach the streaming decode, which the routing keeps off
    # a windowed layer) through phases 3 (raw, attentive, Qwen2-VL also
    # streamed), the image gate, the tower's time, 3g (Qwen2-VL's rope
    # positions shifted) and 4 (32 requests with an image each, both
    # modes), then the image checks (two images, input_embeds, C19)
    def vlm_path(label, cfg, pool, tokens, stream=False):
        eng = model_phase(label, cfg, "auto", tokens=tokens, mm=vlm_model_prompts)
        model_phase(label, None, "auto", eng=eng, mm=vlm_model_prompts, attentive=True)
        if stream:
            model_phase(label, None, "auto", eng=eng, mm=vlm_model_prompts, stream=True)
        image_gate(eng, label, smi)
        tower_time(eng, label, smi)
        graph_phase(eng, label, pool)
        t0 = time.monotonic()
        prompts, images = vlm_prompts(eng)
        outs = []
        for semi in (False, True):
            r, out = serve_mode(eng, semi, prompts, cfg.vocab_size, pool, images=images)
            outs.append(out)
            for k, v in r["launches"].items():
                main_launches[k] += v
            print("serve " + json.dumps(dict(r, model=label, gpu=smi, images=len(images))),
                  flush=True)
        same = float(np.mean([a == b for a, b in zip(*outs)]))
        print("serve_phase " + json.dumps(dict(model=label, modes_same_tokens=same,
                                               seconds=time.monotonic() - t0)), flush=True)
        vlm_checks(eng, label, smi)
        release(eng)

    def vlm_model_only(label, cfg, tokens=65536):
        """Phase 3 (raw and attentive), the image gate and the tower's time."""
        eng = model_phase(label, cfg, "auto", tokens=tokens, mm=vlm_model_prompts)
        model_phase(label, None, "auto", eng=eng, mm=vlm_model_prompts, attentive=True)
        image_gate(eng, label, smi)
        tower_time(eng, label, smi)
        release(eng)

    vlm_path("llava-1.5-7b", published_config("llava-hf/llava-1.5-7b-hf", context_length=4096),
             "aligned", tokens=65536)
    vlm_path("qwen2-vl-7b", published_config("Qwen/Qwen2-VL-7B-Instruct", sliding_window=None),
             "aligned", tokens=131072, stream=True)
    # phase 3 alone at full depth: Qwen2.5-VL-7B (the window tower) and
    # Yi-VL-6B (CLIP ViT-H/14 at 448 pixels: 1024 tokens an image; G = 8)
    vlm_model_only("qwen2.5-vl-7b", published_config("Qwen/Qwen2.5-VL-7B-Instruct",
                                                     sliding_window=None))
    vlm_model_only("yi-vl-6b", published_config("01-ai/Yi-VL-6B", context_length=4096))
    # the sequence classifiers (classify.py): their scores through
    # Engine.encode, kernels vs plain, raw and attentive (reward_phase)
    reward_phase("skywork-reward-llama-3.1-8b",
                 published_config("Skywork/Skywork-Reward-Llama-3.1-8B-v0.2"), main_launches,
                 smi, scores=False)
    reward_phase("skywork-reward-gemma-2-27b",
                 published_config("Skywork/Skywork-Reward-Gemma-2-27B-v0.2",
                                  num_hidden_layers=11), main_launches, smi, scores=False,
                 reduced="11 of 46 layers")
    reward_phase("qwen2.5-math-rm-72b",
                 published_config("Qwen/Qwen2.5-Math-RM-72B", context_length=4096,
                                  num_hidden_layers=8), main_launches, smi, scores=False,
                 reduced="8 of 80 layers (the whole model is 145 GB in bf16)")

    # 5. the kernels line: each kernel's case at its path's representative
    # shape and types (the 8B path serves with fp8_e4m3 KV); every kernel
    # must have launched in a serving run
    rep = {"rpa_decode": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend": ("extend_b8_q256_kv2048", "bfloat16"),
           "rpa_decode_aligned": ("decode_b64_kv1024", "float8_e4m3fn"),
           "rpa_extend_aligned": ("extend_b8_q256_kv2048", "float8_e4m3fn"),
           "rpa_decode_merged": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend_merged": ("extend_b8_q256_kv2048", "bfloat16"),
           "rpa_decode_mla": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend_mla": ("extend_b8_q256_kv2048", "bfloat16"),
           "rpa_decode_stream": ("decode_b64_kv1024", "bfloat16"),
           "rpa_decode_stream_aligned": ("decode_b64_kv1024", "float8_e4m3fn"),
           "rpa_decode_stream_mla": ("decode_b64_kv1024", "bfloat16"),
           "rpa_decode_mla_288": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend_mla_288": ("extend_b8_q256_kv2048", "bfloat16"),
           "rpa_decode_stream_mla_288": ("decode_b64_kv1024", "bfloat16"),
           "rpa_decode_aligned_256": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend_aligned_256": ("extend_b8_q256_kv2048", "bfloat16"),
           "rpa_decode_stream_aligned_256": ("decode_b64_kv1024", "bfloat16"),
           "rpa_decode_aligned_alibi": ("decode_b64_kv1024", "bfloat16"),
           "rpa_extend_aligned_alibi": ("extend_b8_q256_kv2048", "bfloat16")}
    idle = [k for k in KERNELS if not main_launches[k]]
    if idle:
        raise AssertionError(f"kernels no serving run launched: {idle}")
    kernels = []
    for kname, k in KERNELS.items():
        case, kv_dt = rep[kname]
        row = next(r for r in rows if r["kernel"] == kname and r["case"] == case
                   and r["dtype"] == "bfloat16" and r["kv_dtype"] == kv_dt)
        errs = [r["max_abs_err"] for r in rows if r["kernel"] == kname]
        kernels.append(dict(
            name=kname, route="cuda", source=k.source_rel, replaces=k.replaces,
            launches=main_launches[kname], max_abs_err=max(errs),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        masked = [r["max_abs_err"] for r in spec_rows if r["kernel"] == kname]
        if masked:  # every extend's cases with a speculation tree
            kernels[-1]["masked_max_abs_err"] = max(masked)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
