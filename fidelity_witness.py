#!/usr/bin/env python3
"""How close, bitwise, do the kernels that keep P in float32 come to their
plain versions? A witness for the merged and the MLA kernels.

    python3 fidelity_witness.py          # from the root of a checkout; one CUDA card
    python3 fidelity_witness.py --cpu    # the float32 / float64 part alone

It takes the inputs of tests/test_torch_cuda.py::
test_bf16_kernels_keep_p_float32 (bf16 q; the merged pool at G = 8 over
bf16 and fp8_e4m3 KV and at G = 4, the latent pool at G = 16; made with
numpy from the test's seed) and prints one line per case, each share the
share of bf16 output elements bitwise equal to the plain version's:
- ``kernel`` (on the card): the kernel's share and its largest difference;
- ``float64``: the plain version computed in float64, rounded to bf16 once:
  its share, and the largest distance in bf16 steps from the float32 plain
  version with the magnitude of that element (near zero, float32's own
  rounding moves an output by several steps);
- ``p_rounded``, ``p_hi_lo``, ``p_hi_mid_lo``: the plain version with its
  (normalized) P replaced by P rounded to bf16 (a kernel that rounds P), by
  the sum of its two bf16 parts (the merged kernels' hi + lo) and of three.
The same script runs on an older checkout whose tests hold these cases.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

# (kind, pool, query heads per KV head, KV dtype name)
CASES = [(kind, "merged", G, kv) for kind in ("decode", "extend")
         for G, kv in ((4, "bfloat16"), (8, "bfloat16"), (8, "float8_e4m3fn"))]
CASES += [(kind, "latent", 16, "bfloat16") for kind in ("decode", "extend")]


def steps(a, b):
    """How many bf16 values lie between a and b, element by element."""
    import torch

    def order(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (order(a) - order(b)).abs()


@contextlib.contextmanager
def patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def parts(n):
    """P -> the sum of its first n bf16 parts (each the bf16 rounding of
    what the earlier ones left)."""
    import torch

    def f(p):
        out, rest = torch.zeros_like(p), p
        for _ in range(n):
            h = rest.to(torch.bfloat16).float()
            out, rest = out + h, rest - h
        return out
    return f


def run_case(cases, kind, pool, G, kv, dev, on_card):
    import torch

    from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
    from semi_pd_tpu_torch.ops.attention import rpa_packed

    bf = torch.bfloat16
    make = cases._decode_case if kind == "decode" else cases._extend_case
    extra = {"latent": True} if pool == "latent" else {"merged": True, "hkv": cases.HQ // G}
    q, kvt, pt, kvl, meta = make(dev, bf, kv_dtype=getattr(torch, kv), **extra)
    kw = cases._opts("plain", (cases.DLAT if pool == "latent" else cases.D) ** -0.5)
    if pool == "latent":
        kw["v_dim"] = cases.V_DIM
    if kind == "decode":
        kern = lambda: rpa_packed.ragged_paged_attention_packed(q, kvt, 1, pt, kvl, **kw)
        plain = lambda: rpa_packed.ragged_paged_attention_packed_plain(q, kvt, 1, pt, kvl, **kw)
    else:
        kern = lambda: rpa.ragged_paged_attention_extend(q, kvt, 1, pt, kvl, meta, **kw)
        plain = lambda: rpa.ragged_paged_attention_extend_plain(q, kvt, 1, pt, kvl, meta, **kw)
    ref = plain()
    share = lambda out: float((out == ref).float().mean())
    row = dict(kind=kind, pool=pool, G=G, kv=kv, device=str(dev))
    if on_card:
        out = kern()
        torch.cuda.synchronize()
        row["kernel"] = dict(share=share(out),
                             max_abs_diff=float((out.float() - ref.float()).abs().max()))
    # every .float() of the plain version becomes float64: one rounding, at the end
    with patched(torch.Tensor, "float", torch.Tensor.double):
        f64 = plain()
    st = steps(f64, ref)
    worst = int(st.argmax())
    row["float64"] = dict(share=share(f64), max_steps=int(st.max()),
                          at_abs=float(ref.float().flatten()[worst].abs()))
    softmax = torch.softmax
    for name, n in (("p_rounded", 1), ("p_hi_lo", 2), ("p_hi_mid_lo", 3)):
        with patched(torch, "softmax", lambda x, dim, f=parts(n): f(softmax(x, dim=dim))):
            row[name] = dict(share=share(plain()))
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="no card: the plain versions alone")
    args = ap.parse_args()
    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print("fidelity_witness: needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 in full float32
    sys.path.insert(0, str(Path.cwd() / "tests"))
    import test_torch_cuda as cases  # the card tests' inputs

    dev = torch.device("cuda" if on_card else "cpu")
    for case in CASES:
        print("fidelity " + json.dumps(run_case(cases, *case, dev, on_card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
