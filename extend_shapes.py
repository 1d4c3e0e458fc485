#!/usr/bin/env python3
"""Times block shapes of the warpgroup extend kernel at head_dim 64 or 256 on one GPU.

    python3 extend_shapes.py                 # the shapes below, from the repo root
    python3 extend_shapes.py --source parent=DIR   # and DIR's sources, as "parent"
    python3 extend_shapes.py --shapes a=NCW:3,TK:64 b=TK:128,STAGES:3
    python3 extend_shapes.py --shapes a+nocopy=TK:128   # a part removed
    python3 extend_shapes.py --head-dim 256  # the head_dim-256 block's shapes

A shape is a set of the ``WG64_*`` constants of
semi_pd_tpu_torch/csrc/rpa_extend.cu (the head_dim-64 block of
``rpa_extend_wgmma_kernel``; with ``--head-dim 256`` the ``WG256_*`` ones,
Gemma-2's block, whose S is m64nTKk16 with Q by descriptor, so TK is 32 or
48): NCW consumer warpgroups of 64 packed rows, TK
KV positions per tile, STAGES tiles in the ring, LAG (fp8: tiles copied
raw ahead of the one being widened), PRODUCER_REGS and CONSUMER_REGS (the
setmaxnreg split); a constant a shape leaves out keeps the source's value.
A shape name may add ``+PART`` for each part of the kernel to remove
(ABLATIONS below: the KV copies, the exp2, the proxy fence, the page
table lookups, the division branch of a lookup), to see what
that part costs; such a shape computes something else, so it is timed
and not checked.
For each shape a copy of the sources with those constants goes to
semi_pd_tpu_torch/_build/shapes/<shape>/ and is built as the chunked
(``rpa_extend``) and the merged (``rpa_extend_merged``) kernel (at head_dim
256: ``rpa_extend_aligned_256``), one nvcc each, all started together.
Then ``chip_smoke.py``'s phase-2 extend cases (b8 x q256 / kv2048, ragged
q 64-512 / kv1024, b2 x q2048 / kv2048; bf16 KV, and fp8 e4m3 for the
merged build; at head_dim 256 Gemma-2-9B's pool, bf16 and e4m3 KV) run
through the port's wrappers
with each shape's library loaded in turn, on the same inputs for every
shape, each held against its plain version at ``chip_smoke.py``'s
tolerance. Every case is timed twice, the shapes in order and then in
reverse; the plain version and the library call run once per case.
``--source NAME=DIR`` (any number) adds the sources of another checkout
(DIR/semi_pd_tpu_torch/csrc, unchanged) as the shape NAME.

Prints the card's nvidia-smi name and power limit, one ``shape_build``
JSON line per build (registers, spills and HGMMA count of each of its
warpgroup kernels, from ``nvcc -Xptxas -v`` and ``cuobjdump -sass``, and
its SASS instruction count) and
one ``shape_case`` line per shape and case (kernel_ms of both passes,
library_ms: one scaled_dot_product_attention on the same inputs, bound_ms,
max_abs_err). Exits 2 without a GPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "semi_pd_tpu_torch" / "csrc"
OUT = ROOT / "semi_pd_tpu_torch" / "_build" / "shapes"

# (NCW, TK, STAGES, LAG, PRODUCER_REGS, CONSUMER_REGS) by head_dim. At 64:
# two consumer warpgroups (384 threads, 168 registers a thread at launch) or
# three (512, 128), 64- or 128-position tiles, 3 to 8 stages. At 256 every
# shape must also fit fp8 KV's raw tiles beside Q's 64 KB (227 KB a block):
# 32-position tiles with 2 or 3 stages and a lag of 1 or 2, 48-position
# ones with 2 stages and a lag of 1
SHAPES = {
    64: {
        "w2_tk64_s4": (2, 64, 4, 2, 56, 224),
        "w2_tk64_s8": (2, 64, 8, 2, 56, 224),
        "w2_tk128_s3": (2, 128, 3, 2, 56, 224),
        "w2_tk128_s4": (2, 128, 4, 2, 56, 224),
        "w2_tk128_s5_lag1": (2, 128, 5, 1, 56, 224),
        "w3_tk64_s4": (3, 64, 4, 2, 32, 160),
        "w3_tk64_s6": (3, 64, 6, 2, 32, 160),
    },
    256: {
        "tk32_s3": (2, 32, 3, 2, 56, 224),
        "tk32_s3_lag1": (2, 32, 3, 1, 56, 224),
        "tk32_s2_lag1": (2, 32, 2, 1, 56, 224),
        "tk48_s2_lag1": (2, 48, 2, 1, 56, 224),
    },
}
KEYS = ("NCW", "TK", "STAGES", "LAG", "PRODUCER_REGS", "CONSUMER_REGS")
PREFIX = {64: "WG64_", 256: "WG256_"}
BUILDS = {64: ("rpa_extend", "rpa_extend_merged"), 256: ("rpa_extend_aligned_256",)}
# parts of rpa_extend_wgmma_kernel a shape may remove: (source text, what
# replaces it, times it occurs)
ABLATIONS = {
    # the bf16 producer arrives on the full barrier without copying
    "nocopy": [("cp_async16_zfill(st + off, src, ok);", ";", 1),
               ("cp_async16_zfill(st + Lay::TILE + off, src + v_off, ok);", ";", 1)],
    # p = the exponent itself (no MUFU)
    "noexp": [("fast_exp2(fmaf(sc[e], c, -mc[(e >> 1) & 1]))",
               "fmaf(sc[e], c, -mc[(e >> 1) & 1])", 1)],
    # the consumers' fence.proxy.async after each full barrier
    "nofence": [("      wg::fence_proxy_async();\n", "", 1)],
    # the producer reads slot pos, not the page table's (a contiguous walk)
    "nolookup": [("wg::slot_of(pt_row, pos, page_size, pshift)", "(int64_t)pos", 1)],
    # the page by a shift alone (page_size a power of two, as in the cases here)
    "pow2": [("wg::slot_of(pt_row, pos, page_size, pshift)",
              "((int64_t)pt_row[pos >> pshift] * page_size + (pos & (page_size - 1)))", 1)],
}


def parse_shapes(items):
    shapes = {}
    for item in items:
        name, _, spec = item.partition("=")
        shapes[name] = {k: int(v) for k, v in (kv.split(":") for kv in spec.split(",") if kv)}
    return shapes


def write_sources(name: str, src: Path, consts: dict, prefix: str = "WG64_") -> Path:
    """A copy of ``src``'s headers and rpa_extend.cu with the ``prefix``
    block's constants replaced and the name's ``+PART``s removed; returns
    the .cu's path."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    text = (src / "rpa_extend.cu").read_text()
    for part in name.split("+")[1:]:
        for old, new, n in ABLATIONS[part]:
            if text.count(old) != n:
                raise SystemExit(f"shape {name}: {old!r} is not {n} place(s) of the source")
            text = text.replace(old, new)
    for k, v in consts.items():
        text, n = re.subn(rf"^constexpr int {prefix}{k} = [^;]+;",
                          f"constexpr int {prefix}{k} = {v};", text, flags=re.M)
        if n != 1:
            raise SystemExit(f"shape {name}: {prefix}{k} is not one line of "
                             f"{src}/rpa_extend.cu")
    (d / "rpa_extend.cu").write_text(text)
    return d / "rpa_extend.cu"


def sass_sizes(kernel) -> dict:
    """SASS instructions per function of a built library (cuobjdump -sass)."""
    import os
    import subprocess

    from semi_pd_tpu_torch.kernels import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel.lib_path())], capture_output=True,
                          text=True, check=True).stdout
    sizes, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            sizes[fn] = 0
        elif fn is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[fn] += 1
    return sizes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", nargs="*", default=[],
                    help="NAME=DIR: another checkout, timed as shape NAME")
    ap.add_argument("--shapes", nargs="*", help="NAME=KEY:VALUE,... (default: the SHAPES table)")
    ap.add_argument("--head-dim", type=int, default=64, choices=sorted(SHAPES),
                    help="the block whose shapes are timed")
    args = ap.parse_args()
    hd = args.head_dim

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("extend_shapes: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from semi_pd_tpu_torch.kernels import KERNELS, CudaKernel, build_all, sass_mma_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    build_all()  # the tree's own libraries: the wrappers' defaults

    shapes = (parse_shapes(args.shapes) if args.shapes else
              {n: dict(zip(KEYS, v)) for n, v in SHAPES[hd].items()})
    sources = {n: write_sources(n, CSRC, c, PREFIX[hd]) for n, c in shapes.items()}
    for item in args.source:
        name, _, d = item.partition("=")
        sources[name] = write_sources(name, Path(d) / "semi_pd_tpu_torch" / "csrc", {})
    libs = {}  # (shape, build) -> CudaKernel
    for shape, src in sources.items():
        for build in BUILDS[hd]:
            base = KERNELS[build]
            libs[shape, build] = CudaKernel(f"{build}-{shape}", str(src), base.symbol,
                                            base.argtypes, base.replaces, base.defines)
    started = [(k, k.start_build()) for k in libs.values()]
    failed = set()
    for (key, k), (_, s) in zip(libs.items(), started):
        try:
            k.finish_build(s)
            k.fn()
        except RuntimeError as e:
            failed.add(key)
            print(f"shape_build_failed {key[0]} {key[1]}\n{e}", flush=True)
            continue
        for ln in k.build_log.splitlines():  # ptxas notes (serialized wgmma and the like)
            if "arning" in ln or "wgmma" in ln:
                print(f"shape_build_note {key[0]} {key[1]} {ln.strip()}", flush=True)
        hgmma = sass_mma_counts(k, op="HGMMA")
        size = sass_sizes(k)
        for fn, props in cs.ptxas_summary(k.build_log).items():
            if "wgmma" in fn or "mma_kernel" in fn:
                print("shape_build " + json.dumps(dict(shape=key[0], build=key[1], function=fn,
                                                       **props, hgmma=hgmma.get(fn),
                                                       sass=size.get(fn))),
                      flush=True)

    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa

    bf, e4m3 = torch.bfloat16, torch.float8_e4m3fn
    cases = [("extend_b8_q256_kv2048", [256] * 8, [2048] * 8),
             ("extend_ragged_kv1024", [512, 256, 128, 64, 384, 448, 192, 64], [1024] * 8),
             ("extend_b2_q2048_kv2048", [2048] * 2, [2048] * 2)]
    runs = {64: [("chunked", bf), ("merged", bf), ("merged", e4m3)],
            256: [("aligned256", bf), ("aligned256", e4m3)]}[hd]
    order = list(sources)
    tol = cs.TOL["bfloat16"]
    for ci, (case, ql, kl) in enumerate(cases):
        for pool, kdt in runs:
            build = cs.kernel_name("extend", pool)
            # the case's library call and bound, as chip_smoke.py reports them
            gen = torch.Generator(device="cuda")
            gen.manual_seed(ci)
            lib = cs.run_kernel_case(case, "extend", gen, np.random.default_rng(ci), ql, kl, bf,
                                     pool, kdt)
            # the same inputs again, for every shape
            gen.manual_seed(ci)
            q, kv, pt, kvl, meta = cs.make_case(gen, np.random.default_rng(ci), ql, kl, bf,
                                                pool, kdt)
            _, hkv, d, _ = cs.GEOMETRY[pool]
            kw = dict(page_size=cs.PAGE, scale=d ** -0.5)
            if pool == "chunked":
                kw.update(num_kv_heads=hkv, head_dim=d)
                kfn, pfn = rpa.ragged_paged_attention_chunked_extend, rpa.extend_attention_plain
            else:
                kfn = rpa.ragged_paged_attention_extend
                pfn = rpa.ragged_paged_attention_extend_plain
            ref = pfn(q, kv, 0, pt, kvl, meta, **kw).float()
            ms, errs = {}, {}
            for shape in order + order[::-1]:
                if (shape, build) in failed:
                    continue
                KERNELS[build]._fn = libs[shape, build].fn()
                call = lambda: kfn(q, kv, 0, pt, kvl, meta, **kw)  # noqa: E731
                try:
                    err = (call().float() - ref).abs()
                    torch.cuda.synchronize()
                    if "+" not in shape and not bool((err <= tol + tol * ref.abs()).all()):
                        raise AssertionError(f"max abs err {float(err.max()):.3g}")
                    ms.setdefault(shape, []).append(cs.cuda_ms(call, 20))
                except (AssertionError, RuntimeError) as e:
                    print(f"shape_case_failed {shape} {case} {pool} {kdt}: {e}", flush=True)
                    failed.add((shape, build))
                    continue
                errs[shape] = float(err.max())
            for shape, t in ms.items():
                print("shape_case " + json.dumps(dict(
                    shape=shape, case=case, build=build, kv_dtype=cs.dtype_name(kdt),
                    kernel_ms=t, library_ms=lib["library_ms"], bound_ms=lib["bound_ms"],
                    max_abs_err=errs[shape], checked="+" not in shape)), flush=True)
            KERNELS[build]._fn = None
            del q, kv, ref
            torch.cuda.empty_cache()
    print(cs.smi_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
