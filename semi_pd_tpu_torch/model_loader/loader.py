"""Random weights drawn on the model's device (port of
semi_pd_tpu/model_loader/loader.py::device_init_params).

The host-side init (``LlamaForCausalLM.init_params``, numpy, the JAX
``init_params`` numbers) draws every leaf in float32 on the host and copies
it over: at 8 B parameters that is minutes and a 15 GB host array for one
leaf. ``device_init_params`` draws ``0.02 * N(0, 1)`` in float32 where the
parameters live, one ``torch.Generator`` per leaf seeded from
``(seed, leaf index)`` as the JAX version folds the leaf index into its key,
and casts to the leaf's dtype. Leaves stacked on a leading layer axis
(Llama's ``layers.<name>``) are drawn one layer at a time, so the transient
float32 stays at one layer of a leaf (Gemma-2's sandwich norms,
``layers.post_attn_norm`` / ``post_ffw_norm`` / ``pre_ffw_norm``, and the
MoE classes' expert stacks, ``layers.experts.gate_up`` [L, E, H, 2F] and
``layers.experts.down``, are such leaves); per-layer leaves (DeepSeek's ``layers.<l>.<name>``) are one layer
already and are drawn whole; so are the stacks of a child's tree
(LLaVA's ``lm.layers.<name>``, the vision towers' ``layers`` and
``blocks``).

The numbers differ from ``jax.random``'s (and between a CUDA and a CPU
generator), as the JAX package's own ``device_init_params`` differs from
its ``init_params``: tests that compare the port with the JAX package load
the same parameters into both (``load_jax_params``).
"""

from __future__ import annotations

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 64-bit generator seed for leaf ``index`` of a model seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


@torch.no_grad()
def device_init_params(model: torch.nn.Module, seed: int, device=None) -> None:
    """Fill every parameter of ``model`` (a module with ``param_specs()``
    and ``leaf(path)``, models/params.py) with ``0.02 * N(0, 1)`` drawn on
    ``device`` (default: where the parameters live)."""
    for index, (path, _) in enumerate(model.param_specs()):
        param = model.leaf(path)
        dev = torch.device(device) if device is not None else param.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(leaf_seed(seed, index))
        keys = path.split(".")
        # a stack's key: "layers" (a tower's "blocks"), at the root or in a
        # child's tree (LLaVA's "lm.layers", "vision.layers")
        at = next((i for i, k in enumerate(keys[:-1]) if k in ("layers", "blocks")), None)
        stacked = at is not None and not keys[at + 1].isdigit()
        parts = param if stacked else param[None]
        for part in parts:  # one layer (or the whole leaf) at a time
            a = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=dev)
            part.copy_(a.mul_(0.02))
