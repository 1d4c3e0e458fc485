#!/usr/bin/env python3
"""Times the latent pool's DeepSeek-V2 (576-wide) builds of this checkout
against other checkouts' on one GPU: the MLA extend (``rpa_extend_mla``),
and with ``--kernels`` the packed and the streaming latent decode, the
MiniCPM3 latent extend (``rpa_extend_mla_288``, Hq 40) and Gemma-2's
head_dim-256 extend (``rpa_extend_aligned_256``, Hq 16 / Hkv 8); and each
extend's tree-masked instantiation against its unmasked one.

    python3 mla_extend_compare.py                        # this checkout only
    python3 mla_extend_compare.py --source parent=DIR    # and DIR's sources
    python3 mla_extend_compare.py --source parent=DIR \
        --kernels rpa_extend_mla rpa_decode_mla rpa_decode_stream_mla
    python3 mla_extend_compare.py --source parent=DIR \
        --kernels rpa_extend_mla_288 rpa_extend_aligned_256
    python3 mla_extend_compare.py --ptxas --source parent=DIR [--kernels NAME ...]

Each source (this checkout as "this", and every ``--source NAME=DIR``: DIR's
semi_pd_tpu_torch/csrc, unchanged) is built as each kernel with the build's
own flags, one nvcc each, all started together; a source whose C entry
takes no speculation tree (an older extend) is called with its own
signature. ``chip_smoke.py``'s phase-2 cases then run through the
port's wrapper with each library loaded in turn, on the same inputs for
every source, each held against the plain version at ``chip_smoke.py``'s
tolerance: for each extend b8 x q256 / kv2048 with bf16, e4m3 and float32
rows (float32 q for float32 rows), and the ragged q 64-512 / kv1024 case
in bf16; for each decode b64 x kv1024 with bf16, e4m3 and float32 rows and
b16 x kv4096 in bf16. Every case is timed in the order of the sources,
then in reverse (this, parent, parent, this). Last, for each extend, on
this checkout alone, the tree verify (b64 x 29 rows of
default_tree_template(4, 4) over prefixes 520-1000 on shuffled pages) with
and without the tree, in bf16 and e4m3 (at head_dim 256 with Gemma-2's
softcap 50).

With ``--ptxas`` it times nothing and needs no GPU, only nvcc: every
build library (``semi_pd_tpu_torch.kernels.KERNELS`` less the ALiBi
instantiations, which live in their build's library; or those of
``--kernels``) is built anew with its own flags from this checkout's
sources and from each DIR's, all nvcc started together, and each function
is matched to the other side's by its mangled name up to its parameter
list (the part before the first ``Ev``), or, for a kernel that gained a
trailing ``bool`` template argument set false (ALIBI), by that name
without it. One ``ptxas_function`` line per (kernel, function) gives both
sides' registers and spill bytes and ``same``; one ``ptxas_summary`` line
per DIR the functions compared, changed, and those only one side has.

Prints the card's nvidia-smi name and power limit, one ``mla_build`` JSON
line per kernel, source and function (registers and spills from ``nvcc
-Xptxas -v``), one ``mla_case`` line per kernel, source and case
(kernel_ms of both passes, bound_ms and library_ms as chip_smoke.py
computes them, max_abs_err) and one ``mla_tree`` line per tree case
(tree_ms and causal_ms of both passes). Exits 2 without a GPU. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def entry_argtypes(source: Path):
    """The ctypes of the parameters of ``extern "C" int RPA_ENTRY(...)``."""
    params = re.search(r'extern "C" int RPA_ENTRY\(([^)]*)\)', source.read_text()).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        kinds.append(ctypes.c_void_p if "*" in prm else
                     ctypes.c_float if prm.startswith("float") else ctypes.c_int)
    return kinds


# each kernel's pool (chip_smoke.py's GEOMETRY key)
POOLS = {"rpa_extend_mla": "latent", "rpa_decode_mla": "latent",
         "rpa_decode_stream_mla": "latent", "rpa_extend_mla_288": "latent288",
         "rpa_extend_aligned_256": "aligned256"}
EXTENDS = ("rpa_extend_mla", "rpa_extend_mla_288", "rpa_extend_aligned_256")


# each kernel's kind (chip_smoke.py's) and its cases: (case, q_lens,
# kv_lens or the ragged batch's (B, kv), q dtype, latent row dtype)
def kernel_cases(kname, bf, f32, e4m3):
    if kname in EXTENDS:
        return "extend", [("extend_b8_q256_kv2048", [256] * 8, [2048] * 8, bf, bf),
                          ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8, bf, e4m3),
                          ("extend_b8_q256_kv2048", [256] * 8, [2048] * 8, f32, f32),
                          ("extend_ragged_kv1024", [512, 256, 128, 64, 384, 448, 192, 64],
                           [1024] * 8, bf, bf)]
    kind = "stream" if kname == "rpa_decode_stream_mla" else "decode"
    return kind, [("decode_b64_kv1024", [1] * 64, (64, 1024), bf, bf),
                  ("decode_b64_kv1024", [1] * 64, (64, 1024), bf, e4m3),
                  ("decode_b64_kv1024", [1] * 64, (64, 1024), f32, f32),
                  ("decode_b16_kv4096", [1] * 16, (16, 4096), bf, bf)]


def ptxas_compare(sources, kernels) -> int:
    """``--ptxas``: every build's registers and spills against each other
    checkout's (the module docstring)."""
    import chip_smoke as cs
    from semi_pd_tpu_torch.kernels import KERNELS, CudaKernel

    import semi_pd_tpu_torch.ops.attention.ragged_paged_attention  # noqa: F401
    import semi_pd_tpu_torch.ops.attention.rpa_packed  # noqa: F401
    import semi_pd_tpu_torch.ops.attention.rpa_stream  # noqa: F401

    builds = {n: k for n, k in KERNELS.items()
              if k.library is None and (not kernels or n in kernels)}
    twins = []  # (source name, kernel name, this checkout's build, the other's)
    for item in sources:
        name, _, d = item.partition("=")
        for kname, k in builds.items():
            src = Path(d).resolve() / "semi_pd_tpu_torch" / "csrc" / k.source.name
            if src.exists():
                twins.append((name, kname, k, CudaKernel(f"{kname}-{name}", str(src), k.symbol,
                                                         k.argtypes, k.replaces, k.defines)))
    libs = list(builds.values()) + [t for *_, t in twins]
    for k in libs:  # built anew, so that every build leaves its ptxas log
        k.lib_path().unlink(missing_ok=True)
    started = [(k, k.start_build()) for k in libs]
    for k, st in started:
        k.finish_build(st)
    key = lambda fn: fn.split("Ev", 1)[0]  # noqa: E731
    for name in dict.fromkeys(n for n, *_ in twins):
        compared = changed = 0
        only = []
        for _, kname, this, twin in (t for t in twins if t[0] == name):
            a = {key(f): (f, p) for f, p in cs.ptxas_summary(this.build_log).items()}
            b = {key(f): (f, p) for f, p in cs.ptxas_summary(twin.build_log).items()}
            matched = set()
            for fk, (fn, pa) in sorted(a.items()):
                bk = fk if fk in b else re.sub(r"Lb0E(E+)$", r"\1", fk)
                if bk not in b:
                    only.append(dict(kernel=kname, function=fn, side="this"))
                    continue
                matched.add(bk)
                pb = b[bk][1]
                compared += 1
                changed += pa != pb
                print("ptxas_function " + json.dumps(dict(kernel=kname, function=fn, this=pa,
                                                          **{name: pb}, same=pa == pb)))
            only += [dict(kernel=kname, function=f, side=name)
                     for bk, (f, _) in sorted(b.items()) if bk not in matched]
        print("ptxas_summary " + json.dumps(dict(source=name, kernels=len(builds),
                                                 compared=compared, changed=changed,
                                                 one_side_only=only)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", nargs="*", default=[],
                    help="NAME=DIR: another checkout's latent builds, timed as NAME")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help=f"timed: of {sorted(POOLS)} (default rpa_extend_mla); with --ptxas "
                         f"any build (default all)")
    ap.add_argument("--ptxas", action="store_true",
                    help="compare every build's registers and spills, time nothing")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.ptxas:
        return ptxas_compare(args.source, args.kernels)
    args.kernels = args.kernels or ["rpa_extend_mla"]
    if set(args.kernels) - set(POOLS):
        ap.error(f"--kernels: timed kernels are {sorted(POOLS)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mla_extend_compare: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from semi_pd_tpu_torch.kernels import KERNELS, CudaKernel, build_all
    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
    from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream
    from semi_pd_tpu_torch.speculative.tree import default_tree_template

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    build_all()  # this checkout's libraries: the wrappers' defaults
    bf, f32, e4m3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    wrappers = {"extend": (rpa.ragged_paged_attention_extend,
                           rpa.ragged_paged_attention_extend_plain),
                "decode": (rpa_packed.ragged_paged_attention_packed,
                           rpa_packed.ragged_paged_attention_packed_plain),
                "stream": (rpa_stream.ragged_paged_attention_stream,
                           rpa_packed.ragged_paged_attention_packed_plain)}
    failed = False
    for kname in args.kernels:
        base = KERNELS[kname]
        src_name = base.source.name
        libs = {"this": base}
        for item in args.source:
            name, _, d = item.partition("=")
            src = Path(d).resolve() / "semi_pd_tpu_torch" / "csrc" / src_name
            # an older checkout built its _288 and _256 extends without the
            # tree's instantiations (-DRPA_NO_TREE): built as it was
            old = (kname in ("rpa_extend_mla_288", "rpa_extend_aligned_256")
                   and "RPA_NO_TREE" in (src.parent / "rpa_common.cuh").read_text())
            libs[name] = CudaKernel(f"{kname}-{name}", str(src), base.symbol,
                                    entry_argtypes(src), base.replaces,
                                    base.defines + (("RPA_NO_TREE",) if old else ()))
        started = [(k, k.start_build()) for k in libs.values()]
        for k, st in started:
            k.finish_build(st)
        calls = {}
        for name, k in libs.items():
            fn = k.fn()
            n_own = len(k.argtypes)
            if n_own == len(base.argtypes):
                calls[name] = fn
            else:  # an entry without the tree's three arguments before the stream
                calls[name] = (lambda f, n: lambda *a: f(*a[:n - 1], a[-1]))(fn, n_own)
            for fname, props in cs.ptxas_summary(k.build_log).items():
                print("mla_build " + json.dumps(dict(kernel=kname, source=name, function=fname,
                                                     **props)), flush=True)

        order = list(libs)
        kind, cases = kernel_cases(kname, bf, f32, e4m3)
        kfn, pfn = wrappers[kind]
        try:
            for ci, (case, ql, kl, dt, kdt) in enumerate(cases):
                if kind != "extend":  # chip_smoke.py's ragged lengths, one padded row
                    b, kv = kl
                    lens = np.random.default_rng(50 + ci).integers(kv // 2, kv + 1, size=b)
                    lens[0], lens[-1] = kv, 0
                    kl = lens.tolist()
                gen = torch.Generator(device="cuda")
                gen.manual_seed(ci)
                pool = POOLS[kname]
                lib = cs.run_kernel_case(case, kind, gen, np.random.default_rng(ci), ql, kl, dt,
                                         pool, kdt)
                gen.manual_seed(ci)
                q, kv, pt, kvl, meta = cs.make_case(gen, np.random.default_rng(ci), ql, kl, dt,
                                                    pool, kdt)
                kw = dict(page_size=cs.PAGE, scale=cs.GEOMETRY[pool][2] ** -0.5)
                if pool in cs.LATENT:
                    kw["v_dim"] = cs.GEOMETRY[pool][3]
                a = (q, kv, 0, pt, kvl) + ((meta,) if kind == "extend" else ())
                ref = pfn(*a, **kw).float()
                t = cs.TOL[cs.dtype_name(dt)]
                ms, errs = {}, {}
                for name in order + order[::-1]:
                    base._fn = calls[name]
                    call = lambda: kfn(*a, **kw)
                    err = (call().float() - ref).abs()
                    torch.cuda.synchronize()
                    errs[name] = float(err.max())
                    if not bool((err <= t + t * ref.abs()).all()):
                        print(f"mla_case_failed {kname} {name} {case}: max abs err "
                              f"{errs[name]:.3g}", flush=True)
                        failed = True
                    ms.setdefault(name, []).append(cs.cuda_ms(call, 20))
                for name, v in ms.items():
                    print("mla_case " + json.dumps(dict(
                        kernel=kname, source=name, case=case, dtype=cs.dtype_name(dt),
                        kv_dtype=cs.dtype_name(kdt), kernel_ms=v, bound_ms=lib["bound_ms"],
                        library_ms=lib["library_ms"], max_abs_err=errs[name])), flush=True)
                del q, kv, ref
                torch.cuda.empty_cache()
        finally:
            base._fn = calls["this"]
    # each extend's tree verify against its unmasked instantiation on the
    # same inputs (this checkout's library)
    tree = default_tree_template(4, 4)
    anc = tuple(int(a) for a in tree.anc_bits)
    for kname in (k for k in EXTENDS if k in args.kernels):
        pool = POOLS[kname]
        for ci, kdt in enumerate((bf, e4m3)):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + ci)
            c = cs.tree_case(gen, np.random.default_rng(100 + ci), pool, bf, kdt, tree)
            args_ = (c["q"], c["kv"], 0, c["pt"], c["kvl"], c["meta"])
            kw = dict(page_size=cs.PAGE, scale=cs.GEOMETRY[pool][2] ** -0.5)
            if pool in cs.LATENT:
                kw["v_dim"] = cs.GEOMETRY[pool][3]
            else:  # Gemma-2's softcap, on every layer
                kw["logit_cap"] = 50.0
            fns = {"tree_ms": lambda: rpa.ragged_paged_attention_extend(
                       *args_, spec_anc=anc, win_base=c["win_base"], **kw),
                   "causal_ms": lambda: rpa.ragged_paged_attention_extend(*args_, **kw)}
            ms = {k: [] for k in fns}
            for k in list(fns) + list(fns)[::-1]:
                ms[k].append(cs.cuda_ms(fns[k], 20))
            print("mla_tree " + json.dumps(dict(kernel=kname, case="tree_verify_b64_n29",
                                                kv_dtype=cs.dtype_name(kdt),
                                                rows=int(c["q"].shape[0]), **ms)), flush=True)
            del c
            torch.cuda.empty_cache()
    print(cs.smi_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
