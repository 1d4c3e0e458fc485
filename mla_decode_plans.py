#!/usr/bin/env python3
"""Times the latent pool's tensor-core decodes under other shapes and plans on one GPU.

    python3 mla_decode_plans.py                      # from the repo root; one CUDA card
    python3 mla_decode_plans.py --variants c512=MLA_MMA_CHUNK:512 s5=MLA_MMA_NST:5

The packed decode ``rpa_decode_mla`` and the streaming decode
``rpa_decode_stream_mla`` on chip_smoke.py's latent decode shapes (b64 x
kv1024, b16 x kv4096, b128 x kv2048; bf16 q and latent rows,
DeepSeek-V2-Lite's 16 heads, ragged kv_lens with one padded row, shuffled
pages, seed 0), through the kernels' C entry with the plan given by hand:
the packed decode split at the build's chunk (``MLA_MMA_CHUNK`` of
semi_pd_tpu_torch/csrc/rpa_mla_mma.cuh), the stream at several block
counts (the one ``rpa_stream.stream_blocks`` picks is marked ``chosen``).
A variant is a set of that header's constants: a copy of the sources with
those ``constexpr`` lines changed goes to
semi_pd_tpu_torch/_build/mla_variants/<name>/ and is built as both kernels
(one nvcc each, all started together). Every run's output is held against
the plain version at chip_smoke.py's bf16 tolerance, and every run is
timed twice, in order and then in reverse.

Prints the card's nvidia-smi name and power limit, then one ``plan_case``
JSON line per variant, kernel, shape and plan (kernel_ms of both passes,
bound_ms, max_abs_err). Exits 2 without a GPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "semi_pd_tpu_torch" / "csrc"
OUT = ROOT / "semi_pd_tpu_torch" / "_build" / "mla_variants"
SHAPES = ((64, 1024), (16, 4096), (128, 2048))
BLOCKS = (132, 264, 396)  # the stream's blocks: 1, 2 and 3 per SM on 132 SMs
KERNEL_NAMES = ("rpa_decode_mla", "rpa_decode_stream_mla")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def header_constants(csrc: Path) -> dict:
    """The chunk and the blocks per SM a copy of the sources builds with
    (the 576 geometry, the default of the latent builds these time)."""
    from semi_pd_tpu_torch.kernels import source_constants

    c = source_constants([csrc / "rpa_mla.cuh", csrc / "rpa_mla_mma.cuh"])
    return {k: c[k] for k in ("MLA_MMA_CHUNK", "MLA_MMA_BLOCKS_PER_SM")}


def variant_kernels(name: str, consts: dict):
    """The two latent kernels built from a copy of the sources with the
    given constexpr values (none: the checkout's own sources), and the
    chunk and blocks per SM they take."""
    from semi_pd_tpu_torch.kernels import KERNELS, CudaKernel

    csrc = CSRC
    if consts:
        csrc = OUT / name
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(CSRC, csrc)
        header = csrc / "rpa_mla_mma.cuh"
        text = header.read_text()
        for k, v in consts.items():
            text, n = re.subn(rf"^constexpr int {k} = [^;]+;", f"constexpr int {k} = {v};", text,
                              flags=re.M)
            if n != 1:
                raise SystemExit(f"no constexpr {k} in rpa_mla_mma.cuh")
        header.write_text(text)
    out = {}
    for kname in KERNEL_NAMES:
        k = KERNELS[kname]
        out[kname] = k if not consts else CudaKernel(
            name=f"{kname}_{name}", source=str(csrc / k.source.name), symbol=k.symbol,
            argtypes=k.argtypes, replaces=k.replaces, defines=k.defines)
    return out, header_constants(csrc)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=[],
                    help="NAME=CONST:VALUE,... (constants of rpa_mla_mma.cuh)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_decode_plans: needs a CUDA card", file=sys.stderr)
        return 2
    import semi_pd_tpu_torch.ops.attention.rpa_stream  # noqa: F401  (registers the kernels)
    from semi_pd_tpu_torch.kernels import cuda_stream_ptr
    from semi_pd_tpu_torch.ops.attention import rpa_common, rpa_packed

    print(cs.smi_line(), flush=True)
    variants = {"source": {}}
    for spec in args.variants:
        name, _, body = spec.partition("=")
        variants[name] = {k: int(v) for k, v in (kv.split(":") for kv in body.split(","))}
    built = {name: variant_kernels(name, c) for name, c in variants.items()}
    started = [(k, k.start_build()) for ks, _ in built.values() for k in ks.values()]
    for k, st in started:
        k.finish_build(st)

    hq, _, dl, dv = cs.GEOMETRY["latent"]
    scale = dl ** -0.5
    code = rpa_common.TYPE_CODES[torch.bfloat16]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    for b, kv in SHAPES:
        lens = rng.integers(kv // 2, kv + 1, size=b)
        lens[0], lens[-1] = kv, 0
        q, pool, pt, kvl, _ = cs.make_case(gen, rng, [1] * b, lens.tolist(), torch.bfloat16,
                                           "latent", torch.bfloat16)
        ref = rpa_packed.ragged_paged_attention_packed_plain(
            q, pool, 0, pt, kvl, page_size=cs.PAGE, scale=scale, v_dim=dv).float()
        k_ptr, v_ptr, row_stride = rpa_common.kv_planes(pool, 0, 1, dl)
        max_kv = pt.shape[1] * cs.PAGE
        nbytes = (q.numel() * 2 + b * hq * dv * 2 + int(kvl.sum()) * dl * 2
                  + pt.numel() * 4 + b * 4)
        out = torch.empty((b, hq, dv), device="cuda", dtype=torch.bfloat16)
        rows = []
        for vname, (kernels, consts) in built.items():
            chunk = consts["MLA_MMA_CHUNK"]
            n_chunk = cdiv(max_kv, chunk)
            scratch = torch.empty(n_chunk * b * hq * (dv + 2), device="cuda")
            chosen = min(consts["MLA_MMA_BLOCKS_PER_SM"] * sms, b * n_chunk)
            plans = [("rpa_decode_mla", dict(n_split=n_chunk, split_len=chunk),
                      (n_chunk, chunk, scratch.data_ptr(), None))]
            plans += [("rpa_decode_stream_mla", dict(n_blocks=n, chosen=n == chosen),
                       (n, scratch.data_ptr())) for n in sorted({*BLOCKS, chosen})]
            for kname, label, extra in plans:
                kernel = kernels[kname]

                def run(kernel=kernel, extra=extra):
                    kernel.launch(q.data_ptr(), k_ptr, v_ptr, pt.data_ptr(), kvl.data_ptr(),
                                  out.data_ptr(), b, hq, 1, dl, row_stride, pt.shape[1],
                                  cs.PAGE, scale, 0.0, 0, code, code, *extra,
                                  cuda_stream_ptr(q.device))

                out.fill_(float("nan"))  # a row the run leaves unwritten fails
                run()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs()
                tol = cs.TOL["bfloat16"]
                if not bool((err <= tol + tol * ref.abs()).all()):
                    raise AssertionError(f"{vname} {kname} {label} b{b} kv{kv}: max abs err "
                                         f"{err.max():.3g}")
                rows.append(dict(variant=vname, changed=variants[vname], **consts, kernel=kname,
                                 case=f"decode_b{b}_kv{kv}", **label,
                                 max_abs_err=float(err.max()),
                                 bound_ms=nbytes / cs.PEAKS[0] * 1e3, run=run, kernel_ms=[],
                                 keep=scratch))
        for order in (rows, rows[::-1]):
            for row in order:
                row["kernel_ms"].append(cs.cuda_ms(row["run"], 20))
        for row in rows:
            del row["run"], row["keep"]
            print("plan_case " + json.dumps(row), flush=True)
        del q, pool, rows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
